"""The device timeline of a profiled stretch, read from torch.profiler.

A stretch is a fixed number of steady steps (batches or calls) run under
``torch.profiler`` after the measured window.  From its Chrome trace:

* device ops are the kernel, memcpy and memset events of every stream;
  the busy time is the length of their union (overlapping copies on side
  streams count once), and the idle share is one minus busy over the
  stretch's wall time;
* the compute time is the summed duration of the kernels other than
  NCCL's (no memcpy or memset: the PCIe upload is no HBM work);
* a user annotation on the device, such as c10d's ``nccl:all_gather``,
  is no device work of its own (as ``chip_smoke.py::device_profile``
  keeps it out); the union of the ``nccl:*`` ranges is the collectives'
  time.

``stretches`` runs several and keeps the good ones by the rule of
``chip_smoke.py::good_profiles`` (frozen copy): a profile counts if it
saw device time and every device op that all the other profiles saw.
``idle_gaps`` names the longest gaps between device ops by the program
function that a sampling thread found the host in during each gap.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import tempfile
import threading
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
EXTRA_PROFILES = 2  # profiles taken to replace dropped ones
PROGRAM = os.sep + "jpeg_tpu_torch" + os.sep
SAMPLE_S = 0.001


def op_name(name: str) -> str:
    """"(anonymous namespace)::place_kernel(unsigned int const*, ...)"
    -> "place_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0].strip() or name)[:120]


def union_us(intervals) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of [start, end) intervals, and the merged
    intervals in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def _trace_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class _Sampler:
    """A thread that notes, every millisecond, the innermost function of
    the program (else of the benchmark) the main thread is in."""

    def __init__(self):
        self.samples: list[tuple[float, str]] = []
        self._main = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            frame = sys._current_frames().get(self._main)
            name, ours = "python", None
            while frame is not None:
                path = frame.f_code.co_filename
                if PROGRAM in path:
                    mod = path.split(PROGRAM)[-1].removesuffix(".py")
                    name = f"{mod.replace(os.sep, '.')}.{frame.f_code.co_name}"
                    break
                if ours is None and os.sep + "benchmark" + os.sep in path:
                    ours = "benchmark." + frame.f_code.co_name
                frame = frame.f_back
            else:
                name = ours or name
            self.samples.append((time.perf_counter(), name))
            time.sleep(SAMPLE_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)


def profile_stretch(step, n: int, sample: bool = False, work=None) -> dict:
    """Run ``step()`` ``n`` times under the profiler (each ends with the
    work it asked for completed) -> the stretch's summary; ``work`` maps
    the steps' results to the (bytes, flops) they did."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    sampler = _Sampler() if sample else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if sampler:
            sampler.__enter__()
        with record_function("benchmark.stretch"):
            t0 = time.perf_counter()
            results = [step() for _ in range(n)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if sampler:
            sampler.__exit__()
    out = summarize(_trace_events(prof), wall, n, t0,
                    sampler.samples if sampler else [])
    out["work"] = work(results) if work else None
    return out


def summarize(events: list[dict], wall_s: float, n: int, t0: float,
              samples) -> dict:
    dev, nccl, by_name = [], [], collections.Counter()
    kernel_us = 0.0
    anchor = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((s, e))
            by_name[op_name(name)] += e - s
            if cat == "kernel" and not name.startswith("nccl"):
                kernel_us += e - s
        elif cat == "gpu_user_annotation" and name.startswith("nccl:"):
            nccl.append((s, e))
        elif cat == "user_annotation" and name == "benchmark.stretch":
            anchor = s
    busy_us, merged = union_us(dev)
    nccl_us, _ = union_us(nccl)
    out = {"steps": n, "window_s": wall_s, "busy_s": busy_us / 1e6,
           "kernel_s": kernel_us / 1e6, "nccl_s": nccl_us / 1e6,
           "ops": {k: v / 1e6 for k, v in by_name.items()},
           "gaps": []}
    if samples and anchor is not None and merged:
        out["gaps"] = idle_gaps(merged, anchor, wall_s, t0, samples)
    return out


def idle_gaps(merged, anchor_us: float, wall_s: float, t0: float,
              samples, top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest gaps between device ops in the stretch (its
    start and end included), each named by the function the host was
    sampled in most often during it."""
    end_us = anchor_us + wall_s * 1e6
    edges = [anchor_us] + [x for m in merged for x in m] + [end_us]
    gaps = [(max(a, anchor_us), min(b, end_us))
            for a, b in zip(edges[0::2], edges[1::2])]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    # host clock -> trace clock: the stretch's annotation opened at t0
    ts = [(anchor_us + (t - t0) * 1e6, name) for t, name in samples]
    out = []
    for a, b in gaps:
        names = collections.Counter(name for t, name in ts if a <= t < b)
        label = names.most_common(1)[0][0] if names else "not sampled"
        out.append((label, (b - a) / 1e6))
    return out


def good_profiles(profiles: list[dict]) -> list[int]:
    """Indices of the profiles that count: device time above 0, and every
    device op that all the other profiles saw (frozen copy of
    ``chip_smoke.py::good_profiles``)."""
    keep = []
    for i, p in enumerate(profiles):
        others = [set(q["ops"]) for j, q in enumerate(profiles)
                  if j != i and q["ops"]]
        seen_by_all = set.intersection(*others) if others else set()
        if p["busy_s"] > 0 and seen_by_all <= set(p["ops"]):
            keep.append(i)
    return keep


def stretches(step, n: int, attempts: int = 3, extra: int = EXTRA_PROFILES,
              work=None) -> dict:
    """``attempts`` good profiled stretches of ``n`` steps (up to
    ``extra`` more to replace dropped ones), then one more with the host
    sampler on for the idle gaps' names.  Returns the good stretch of
    median idle share, with ``gaps`` from the sampled one and
    ``kept``/``dropped`` counts; raises if none is good."""
    profiles = [profile_stretch(step, n, work=work) for _ in range(attempts)]
    while len(good_profiles(profiles)) < attempts and \
            len(profiles) < attempts + extra:
        profiles.append(profile_stretch(step, n, work=work))
    keep = good_profiles(profiles)
    if not keep:
        raise RuntimeError(f"none of {len(profiles)} profiles saw the "
                           "device work")
    idle = [1 - profiles[i]["busy_s"] / profiles[i]["window_s"]
            for i in keep]
    mid = keep[idle.index(statistics.median_low(idle))]
    out = dict(profiles[mid])
    out["gaps"] = profile_stretch(step, n, sample=True)["gaps"]
    out["kept"], out["dropped"] = len(keep), len(profiles) - len(keep)
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most
    time in the stretch, and its longest idle gaps by host function."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary["gaps"][:top]]}
