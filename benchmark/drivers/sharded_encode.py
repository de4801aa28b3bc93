"""Sharded encode: ``ShardedEncoder.encode_batch`` over a mesh of ranks.

The benchmark starts one process a card (``launch.run_ranks``; they meet
through a ``FileStore`` in a temporary directory, NCCL with
``NCCL_SHM_DISABLE=1`` so nothing lands in ``/dev/shm``) and waits for
them.  Every rank takes the same global host batch, as the encoder's
contract asks, and gets every file.  A closed loop: rank 0's clock closes
the window, and before each call it tells every rank, over a gloo group,
whether to go on, so that all ranks make the same calls.  A call counts
once rank 0 holds its files inside the window; rank 0 reports, and every
rank's files of the sampled calls must equal rank 0's.

Run as a script, this module is one rank (``--rank``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

if __name__ == "__main__":  # a rank: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark import harness, launch  # noqa: E402
from benchmark.reference import check  # noqa: E402
from benchmark.synth import stamp, stamped, synthetic_batch  # noqa: E402

WARM_STAMP = 1 << 40
TRACE_STAMP = 1 << 41


def run(cell, seed: int, seconds: float, trace: bool, start: float,
        device: str = "cuda", worker: list[str] | None = None,
        root: str = harness.ROOT) -> harness.Outcome:
    """Start the ranks, wait for them, and gather rank 0's outcome.
    ``worker`` replaces the command of a rank (tests plant faults so)."""
    c, t = cell.config, cell.traffic
    world = c["mesh"]["data"] * c["mesh"]["space"]
    tmp = tempfile.mkdtemp(prefix="benchmark-ranks-")
    try:
        cmd = worker or [sys.executable, os.path.abspath(__file__)]
        args = ["--workload", cell.name, "--seed", str(seed),
                "--seconds", str(seconds), "--trace", str(int(trace)),
                "--world", str(world), "--dir", tmp, "--device", device,
                "--root", root]
        env = dict(os.environ, NCCL_SHM_DISABLE="1")
        launch.run_ranks([cmd + args + ["--rank", str(r)]
                          for r in range(world)], tmp,
                         seconds + t["rank_timeout_s"], env=env, cwd=root)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted({m for rk in ranks for m in rk["forbidden"]})
    if bad:
        raise SystemExit(f"a rank loaded modules of JAX or jpeg_tpu: {bad}")
    r0 = ranks[0]
    record = {"spans": {"sharded.call": r0["lat"]}, "steps": r0["done"],
              "launches": r0["launches"]}
    mem = max(rk["mem"] for rk in ranks)
    dev = harness.device_info(device, world, mem, r0.get("kind"))
    if trace and device == "cuda":
        record["trace"] = dict(r0["trace"])
        for key in ("busy_s", "window_s"):  # the mean over the cards
            record["trace"][key] = float(np.mean([rk["trace"][key]
                                                  for rk in ranks]))
    limits = c["limits"]["sharded"]
    ok, _ = check.judge(r0["numbers"], limits)
    rate = r0["done"] * t["batch"] * c["height"] * c["width"] / 1e6 / seconds
    return harness.Outcome(
        attempted=r0["done"], failed=r0["failed"],
        rates={t["rate_metric"]: rate}, setup_s=r0["t_window"] - start,
        numbers=r0["numbers"], limits=limits,
        correct=ok and r0["failed"] == 0 and r0["done"] > 0,
        device=dev, record=record,
        notes=[r0["bits"]])


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser()
    for name in ("--workload", "--dir", "--device", "--root"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--trace", "--world", "--rank"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    from jpeg_tpu_torch import EncodeConfig
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    from jpeg_tpu_torch.parallel.sharded import ShardedEncoder

    cell = harness.load_cell(harness.load_spec(a.root), a.workload, a.root)
    c, t = cell.config, cell.traffic
    h, w, B = c["height"], c["width"], t["batch"]
    cuda = a.device == "cuda"
    if cuda:
        torch.cuda.set_device(a.rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo", rank=a.rank, world_size=a.world,
        store=dist.FileStore(os.path.join(a.dir, "store"), a.world))
    ctrl = dist.new_group(backend="gloo")
    dev = torch.device("cuda", a.rank) if cuda else torch.device("cpu")
    mesh = make_mesh(data=c["mesh"]["data"], space=c["mesh"]["space"],
                     device=dev.type)
    enc = ShardedEncoder(mesh, h, w, EncodeConfig(**c["encode_config"]),
                         segs_per_device=c["mesh"]["segs_per_device"])
    # rank 0 makes the pool on its card; every rank gets the same bytes
    rng = np.random.default_rng(a.seed)
    shape = (t["pool_batches"] * B, h, w, 3)
    frames = (synthetic_batch(rng, shape[0], h, w, dev) if a.rank == 0
              else torch.empty(shape, dtype=torch.uint8, device=dev))
    dist.broadcast(frames, 0)
    pool = list(frames.cpu().numpy().reshape(t["pool_batches"], B, h, w, 3))
    del frames

    def call(i):
        b = pool[i % len(pool)]
        stamp(b, i)
        return enc.encode_batch(b)

    for i in range(t["warm_calls"]):
        call(WARM_STAMP + i)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    from jpeg_tpu_torch import kernels
    kernels.reset_launch_counts()
    sample = harness.Reservoir(t["check_files"],
                               np.random.default_rng([a.seed, 1]))
    pick = np.random.default_rng([a.seed, 2])
    lat, done, failed = [], 0, 0
    dist.barrier(group=ctrl)
    t_window = time.time()
    deadline = time.perf_counter() + a.seconds
    flag = torch.zeros(1, dtype=torch.int32)
    for i in range(1 << 62):
        flag[0] = int(time.perf_counter() >= deadline)
        dist.broadcast(flag, 0, group=ctrl)
        if flag[0]:
            break
        t1 = time.perf_counter()
        files = call(i)
        now = time.perf_counter()
        if now > deadline:
            continue  # ended after rank 0's window closed: not counted
        lat.append(now - t1)
        done += 1
        if len(files) != B:
            failed += 1
            continue
        j = int(pick.integers(0, B))
        sample.offer((i, j, files[j]))
    out = {"rank": a.rank, "t_window": t_window, "done": done,
           "failed": failed, "lat": lat, "launches": kernels.launch_counts(),
           "mem": torch.cuda.max_memory_allocated() if cuda else 0,
           "kind": torch.cuda.get_device_name(a.rank) if cuda else "cpu"}
    if a.trace and cuda:
        from benchmark import devtrace
        it = iter(range(TRACE_STAMP, 1 << 62))
        out["trace"] = devtrace.stretches(lambda: call(next(it)),
                                          t["trace_calls"], extra=0)
    del enc, mesh
    digest = hashlib.sha256(b"".join(
        d for _, _, d in sample.items)).hexdigest()
    digests = [None] * a.world
    dist.all_gather_object(digests, digest, group=ctrl)
    if a.rank == 0:
        ec, m = c["encode_config"], c["mesh"]
        segs = m["space"] * m["segs_per_device"]
        out["numbers"] = check.encode_numbers(
            [(stamped(pool, i, j), data) for i, j, data in sample.items],
            ec["huffman"], h // 16 // segs if segs > 1 else 0,
            ec.get("quality"))
        out["numbers"]["ranks_disagree"] = sum(d != digest for d in digests)
        out["bits"] = harness.bits_note(sample.items, h * w)
    dist.barrier(group=ctrl)
    dist.destroy_process_group()
    out["forbidden"] = harness.forbidden_modules()
    with open(os.path.join(a.dir, f"rank{a.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
