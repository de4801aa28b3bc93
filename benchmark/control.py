"""The control of a cell's ``correct``: the plain reference computed in
bfloat16, one precision below the configurations' float32, put in the
program's place and judged as the program is.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, at the cell's
own size, and has the reference stand in for the program on as many of
them as a run checks: encode cells get bfloat16 files of sampled frames
(``reference.jpeg.BF16``), the decode cell bfloat16 reconstructions of
sampled files.  It prints the numbers compared, each beside its limit;
the control must come out not correct on every seed.  The benchmark's
own runs never run it.
"""
import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.reference import decode as D  # noqa: E402
from benchmark.reference import jpeg as R  # noqa: E402
from benchmark.synth import stamped, synthetic_batch  # noqa: E402


def control_numbers(cell, seed: int, device: str) -> tuple[dict, dict]:
    """(numbers, limits) of the control on seed ``seed``."""
    c, t = cell.config, cell.traffic
    ec = c["encode_config"]
    rng = np.random.default_rng(seed)
    draw = np.random.default_rng([seed, 1])
    if t["kind"] == "batch_decode":
        from benchmark.drivers.batch_decode import make_frames, make_pool
        pool = make_pool(cell, make_frames(cell, rng, device))
        picks = draw.choice(len(pool), t["check_images"], replace=False)
        parsed = [(pool[i][1], D.parse(pool[i][0])) for i in picks]
        numbers = check.decode_numbers(
            [(coefs, info, D.pixels(coefs, info, R.BF16))
             for coefs, info in parsed])
        return numbers, c["limits"]["decode"]
    B = t["batch"]
    n_pool = t["pool_batches"]
    pool = [synthetic_batch(rng, B, c["height"], c["width"], device)
            .cpu().numpy() for _ in range(n_pool)]
    samples = []
    for _ in range(t["check_files"]):
        i, j = int(draw.integers(0, 4 * n_pool)), int(draw.integers(0, B))
        rgb = stamped(pool, i, j)
        samples.append((rgb, R.encode(rgb, ec["huffman"], 0, R.BF16,
                                      ec.get("quality"))[0]))
    numbers = check.encode_numbers(samples, ec["huffman"], 0,
                                   ec.get("quality"))
    limits = c["limits"]["sharded" if "mesh" in c else "encode"]
    if "ranks_disagree" in limits:
        numbers["ranks_disagree"] = 0
    return numbers, limits


def main(argv=None, root: str = harness.ROOT, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = harness.load_cell(harness.load_spec(root), a.workload, root)
    if device == "cuda":
        harness.cards(1)
    wrong = 0
    for seed in a.seeds:
        numbers, limits = control_numbers(cell, seed, device)
        ok, lines = check.judge(numbers, limits)
        wrong += not ok
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": ok, "numbers": numbers}))
        for line in lines:
            print(f"  {line}", file=sys.stderr)
    print(f"{a.workload}: the control is not correct on {wrong} of "
          f"{len(a.seeds)} seeds", file=sys.stderr)
    return 0 if wrong == len(a.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
