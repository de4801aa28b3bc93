"""Batch decode: ``decode_jpeg_batch`` of ``batch`` files a call.

A closed loop of one caller that waits for each call.  The files are a
pool the benchmark's own plain encoder (``reference.jpeg``) makes at
set-up: ``sources`` synthetic frames from the seed, each also mirrored
left-right, top-down and both in the coefficient domain, so ``pool``
distinct files for a quarter of the encodes.  The frames count as
set-up; the reference encoder's seconds do not, since no change to the
program moves them.  Each call takes ``batch`` of the files drawn from
the seed.  A call counts once its images are on the card inside the
window; the rate is the decoded megapixels of those calls over the
window's seconds.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from .. import harness
from ..reference import check
from ..reference import decode as D
from ..reference import jpeg as R
from ..synth import synthetic_batch

FLIPS = ((False, False), (True, False), (False, True), (True, True))


def make_frames(cell, rng, device) -> np.ndarray:
    """The pool's source frames [sources, H, W, 3] u8 on the host."""
    c, t = cell.config, cell.traffic
    return synthetic_batch(rng, t["sources"], c["height"], c["width"],
                           device).cpu().numpy()


def make_pool(cell, frames) -> list[tuple[bytes, tuple]]:
    """(file, its coefficients) for each pool file: the reference's
    plain encoder over ``frames`` and their mirrors."""
    c, t = cell.config, cell.traffic
    h, w = c["height"], c["width"]
    ec = c["encode_config"]
    pool = []
    for img in frames:
        coefs = R.forward(img, quality=ec.get("quality"))
        for hf, vf in FLIPS[:t["pool"] // t["sources"]]:
            cf = R.flipped(coefs, w, h, hf, vf)
            data = R.encode_coefs(*cf, w, h, ec["huffman"],
                                  ec.get("restart_interval_mcu_rows", 0),
                                  ec.get("quality"))
            pool.append((data, cf))
    return pool


def run(cell, seed: int, seconds: float, trace: bool, start: float,
        device: str = "cuda") -> harness.Outcome:
    import torch
    from jpeg_tpu_torch import decode_jpeg_batch, kernels
    c, t = cell.config, cell.traffic
    B = t["batch"]
    cuda = device == "cuda"
    marks = [time.time()]
    frames = make_frames(cell, np.random.default_rng(seed), device)
    marks.append(time.time())
    pool = make_pool(cell, frames)
    ref_s = time.time() - marks[-1]  # the reference's: not set-up
    draw = np.random.default_rng([seed, 3])
    calls = (draw.choice(len(pool), B, replace=False).tolist()
             for _ in itertools.count())

    def call(idx):
        out = decode_jpeg_batch([pool[i][0] for i in idx],
                                entropy_engine=t["entropy_engine"],
                                device=device)
        if cuda:
            torch.cuda.synchronize()
        return idx, out

    for _ in range(t["warm_calls"]):
        call(next(calls))
    marks.append(time.time() - ref_s)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sample = harness.Reservoir(t["check_images"],
                               np.random.default_rng([seed, 1]))
    pick = np.random.default_rng([seed, 2])
    lat, errors = [], []
    done = failed = 0
    setup_s = time.time() - start - ref_s
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        idx = next(calls)
        t1 = time.perf_counter()
        try:
            _, imgs = call(idx)
        except (RuntimeError, ValueError) as e:  # a call the port refused
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            continue
        now = time.perf_counter()
        if now > deadline:
            break  # ended after the window closed: not counted
        lat.append(now - t1)
        done += 1
        j = int(pick.integers(0, B))
        sample.offer((idx[j], imgs[j] if j < len(imgs) else None))
    record = {"spans": {"decode.call": lat},
              "launches": kernels.launch_counts(), "steps": done}
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    if trace and cuda:
        from .. import devtrace, work
        shapes = [(c["height"], c["width"])] * B
        record["trace"] = devtrace.stretches(
            lambda: call(next(calls)), t["trace_calls"],
            work=lambda steps: work.decode_work(
                [pool[i][0] for idx, _ in steps for i in idx],
                shapes * len(steps)))
    got = [(i, None if img is None else img.cpu().numpy())
           for i, img in sample.items]
    sample.items.clear()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.decode_numbers(
        [(pool[i][1], D.parse(pool[i][0]), img) for i, img in got])
    limits = c["limits"]["decode"]
    ok, _ = check.judge(numbers, limits)
    rate = done * B * c["height"] * c["width"] / 1e6 / seconds
    return harness.Outcome(
        attempted=done + failed, failed=failed,
        rates={t["rate_metric"]: rate}, setup_s=setup_s, numbers=numbers,
        limits=limits, correct=ok and failed == 0 and done > 0,
        device=harness.device_info(device, 1, mem), record=record,
        notes=[harness.setup_note(start, marks),
               f"reference pool (not in setup_s): {ref_s:.3f} s"]
        + errors[:3])
