"""Observability: stage timers and encode metrics (the port of
``jpeg_tpu.utils.profiling``).

The reference's instrumentation is a gettimeofday stopwatch printing ms
per stage (``timer()``, ``utils/original.c:84-93``) plus log lines with
difference counts (``main/main.c:141-143``).  Here:

* ``StageTimer`` — wall-clock per named stage, draining the card
  (``torch.cuda.synchronize``) when the stage's outputs or the timer's
  device are on it, so that device work is attributed to its stage;
* ``encode_metrics`` — structured per-image results: bytes, bits/pixel,
  and PSNR against the source via the host decoder.

For kernel-level traces use ``torch.profiler`` around the step; these
helpers cover the everyday "where did the milliseconds go" need.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def _on_card(out) -> bool:
    """True if ``out`` (a tensor, or lists, tuples and dicts of them)
    holds a CUDA tensor."""
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (list, tuple)):
        return False
    return any(_on_card(o) for o in out)


class _StageOutputs:
    """Mutable holder for a stage's device outputs (see StageTimer.stage)."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = None


class StageTimer:
    """Accumulating per-stage stopwatch.

    ``device`` is where the timed work runs: on a CUDA device every stage
    ends in ``torch.cuda.synchronize()``; on the CPU only a stage whose
    outputs lie on the card does.  A failed synchronization raises (it
    reports a fault of the card's work).

    >>> t = StageTimer()
    >>> with t.stage("dct") as s:
    ...     s.out = step(batch)      # doctest: +SKIP
    >>> t.report()                   # doctest: +SKIP
    """

    def __init__(self, sync: bool = True,
                 device: str | torch.device = "cuda"):
        self.sync = sync
        self.device = torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _drain(self, out) -> None:
        if self.sync and (self.device.type == "cuda" or _on_card(out)):
            torch.cuda.synchronize()

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a block of work.  Yields a holder: set ``holder.out`` to the
        stage's outputs (``measure()`` does this for you); outputs on the
        card make the stage drain it even when the timer's device is the
        CPU.
        """
        holder = _StageOutputs()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            self._drain(holder.out)
            self._add(name, time.perf_counter() - t0)

    def measure(self, name: str, fn, *args, **kwargs):
        """Run fn under the stage timer, draining the card after it."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._drain(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> dict[str, dict]:
        return {k: {"total_ms": v * 1000.0,
                    "count": self.counts[k],
                    "mean_ms": v * 1000.0 / self.counts[k]}
                for k, v in self.totals.items()}

    def pretty(self) -> str:
        # same visual shape as the reference's per-stage prints
        lines = [f"{name:<42}{r['mean_ms']:10.3f} ms  (x{r['count']})"
                 for name, r in self.report().items()]
        return "\n".join(lines)


def encode_metrics(rgb, data: bytes, compute_psnr: bool = True) -> dict:
    """Structured per-image encode metrics: size, bpp, PSNR."""
    if torch.is_tensor(rgb):
        rgb = rgb.cpu().numpy()
    h, w = rgb.shape[:2]
    out = {"bytes": len(data), "bpp": 8.0 * len(data) / (h * w),
           "width": w, "height": h}
    if compute_psnr:
        from ..golden import decoder as gdec
        out["psnr_db"] = gdec.psnr(gdec.decode(data), np.asarray(rgb))
    return out
