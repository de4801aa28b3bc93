"""Stream encode: ``FastBatchEncoder.encode_stream`` over u8 batches.

A closed loop: the stream keeps ``sync_depth`` batches in flight and
takes the next batch from the benchmark's iterator when it has room.
The batches come from a pool made at set-up from the seed, each stamped
with a running counter as it is handed over.  The mix's ``frames`` says
where the pool lies: "host" (the default; NumPy arrays, as frames come
from a camera or a file) or "device" (tensors on the card, as a renderer
or a decoder on the card leaves them).  A batch counts once its files
have been yielded inside the window; the rate is the input megapixels of
those batches over the window's seconds.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from .. import harness
from ..reference import check
from ..synth import stamp, stamped, synthetic_batch

WARM_STAMP = 1 << 40   # counters of the warm-up batches
TRACE_STAMP = 1 << 41  # counters of the profiled stretches' batches


def make_pool(cell, rng, device) -> list:
    """The mix's batches: NumPy arrays, or tensors on ``device`` where
    the mix's ``frames`` is "device"."""
    c, t = cell.config, cell.traffic
    pool = [synthetic_batch(rng, t["batch"], c["height"], c["width"], device)
            for _ in range(t["pool_batches"])]
    if t.get("frames", "host") == "device":
        return pool
    return [b.cpu().numpy() for b in pool]


def feed(pool, first: int, deadline: float | None = None, handed=None):
    """Pool batches stamped ``first``, ``first + 1``, ... until the
    deadline (host clock), noting when each is handed over."""
    for i in itertools.count(first):
        if deadline is not None and time.perf_counter() >= deadline:
            return
        b = pool[i % len(pool)]
        stamp(b, i)
        if handed is not None:
            handed.append(time.perf_counter())
        yield b


def run(cell, seed: int, seconds: float, trace: bool, start: float,
        device: str = "cuda") -> harness.Outcome:
    import torch
    from jpeg_tpu_torch import EncodeConfig, kernels
    from jpeg_tpu_torch.pipelines.fast import FastBatchEncoder
    c, t = cell.config, cell.traffic
    B, depth = t["batch"], t["sync_depth"]
    cuda = device == "cuda"
    marks = [time.time()]
    pool = make_pool(cell, np.random.default_rng(seed), device)
    marks.append(time.time())
    enc = FastBatchEncoder(c["height"], c["width"],
                           EncodeConfig(**c["encode_config"]), device=device)
    for _ in enc.encode_stream(itertools.islice(feed(pool, WARM_STAMP),
                                                depth + 2), sync_depth=depth):
        pass
    marks.append(time.time())
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sample = harness.Reservoir(t["check_files"],
                               np.random.default_rng([seed, 1]))
    pick = np.random.default_rng([seed, 2])
    handed, lat = [], []
    done = failed = 0
    setup_s = time.time() - start
    deadline = time.perf_counter() + seconds
    for i, files in enumerate(enc.encode_stream(
            feed(pool, 0, deadline, handed), sync_depth=depth)):
        now = time.perf_counter()
        if now > deadline:
            continue  # in flight when the window closed: not counted
        lat.append(now - handed[i])
        done += 1
        if len(files) != B:
            failed += 1
            continue
        j = int(pick.integers(0, B))
        sample.offer((i, j, files[j]))
    record = {"spans": {"encode.batch": lat},
              "launches": kernels.launch_counts(), "steps": done}
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    if trace and cuda:
        record["trace"] = traced(cell, enc, pool)
    del enc
    if cuda:
        torch.cuda.empty_cache()
    pool = [b if isinstance(b, np.ndarray) else b.cpu().numpy()
            for b in pool]
    ec = c["encode_config"]
    numbers = check.encode_numbers(
        [(stamped(pool, i, j), data) for i, j, data in sample.items],
        ec["huffman"], ec.get("restart_interval_mcu_rows", 0),
        ec.get("quality"))
    limits = c["limits"]["encode"]
    ok, _ = check.judge(numbers, limits)
    rate = done * B * c["height"] * c["width"] / 1e6 / seconds
    return harness.Outcome(
        attempted=done, failed=failed, rates={t["rate_metric"]: rate},
        setup_s=setup_s, numbers=numbers, limits=limits,
        correct=ok and failed == 0 and done > 0,
        device=harness.device_info(device, 1, mem), record=record,
        notes=[harness.setup_note(start, marks),
               harness.bits_note(sample.items, c["height"] * c["width"])])


def traced(cell, enc, pool) -> dict:
    """Profiled stretches of ``trace_batches`` steady batches of one
    stream (``devtrace.stretches``), with the work of their files."""
    from .. import devtrace, work
    c, t = cell.config, cell.traffic
    depth = t["sync_depth"]
    stream = enc.encode_stream(feed(pool, TRACE_STAMP), sync_depth=depth)
    for _ in range(depth + 1):  # the stream full before any stretch
        next(stream)
    dynamic = c["encode_config"]["huffman"] != "fixed"
    try:
        return devtrace.stretches(
            lambda: next(stream), t["trace_batches"],
            work=lambda steps: work.encode_work(
                (c["height"], c["width"]),
                [f for files in steps for f in files], dynamic))
    finally:
        stream.close()
