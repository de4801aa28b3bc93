"""Run one cell of jpeg_tpu_torch's benchmark on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (kernels, pool, warm-up) is timed
from the start of this process; then the cell's entry point runs for
``--seconds``; then, with ``--trace 1``, a few profiled stretches; last
the plain reference judges a seeded sample of what the window produced.
The last line of standard output is the result as JSON, and the numbers
compared, each beside its limit, are the last lines of standard error.
Without the cards the cell asks for, or with a module of JAX or
``jpeg_tpu`` loaded, it exits non-zero and prints no result.
"""
import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = harness.load_cell(harness.load_spec(), a.workload)
    harness.cards(cell.chips)
    out = harness.driver(cell.traffic["kind"]).run(
        cell, a.seed, a.seconds, bool(a.trace), START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or jpeg_tpu loaded: {bad}", file=sys.stderr)
        return 3
    line = harness.result(cell, out, bool(a.trace))
    for note in out.notes:
        print(note, file=sys.stderr)
    for name, v in line["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
