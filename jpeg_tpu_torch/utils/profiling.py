"""Observability: spans on the profiler's clock, and encode metrics.

The reference's instrumentation is a gettimeofday stopwatch printing ms
per stage (``timer()``, ``utils/original.c:84-93``) plus log lines with
difference counts (``main/main.c:141-143``).  Here:

* ``span(name, key)`` marks a host stage of the program.  Tracing is on
  exactly while a torch profiler records (the profiler's own flag,
  ``torch.autograd.profiler._is_profiler_enabled``, read once as the span
  opens); otherwise ``span`` returns one shared no-op object.  An open
  span appends ``(name, key, parent, thread, t0_ns, t1_ns)`` to an
  in-memory list (``snapshot``, ``reset``) and opens
  ``torch.profiler.record_function("jpeg_tpu_torch." + name)``, so that
  its range lies in the profiler's trace on the clock of the kernels and
  copies.  The spans:

  - ``encode.submit``, ``encode.tables``, ``encode.finish`` and
    ``encode.wait`` (each host wait on a copy's event) in
    ``pipelines/fast.py::_StreamRun``, keyed by the stream's batch number;
  - ``assemble``: cutting kernel I's files apart on the host
    (``pipelines/fast.py::FastBatchEncoder._assemble``, inside
    ``encode.finish`` in the stream and in ``encode_batch``), and the host
    library's assembly (``native.assemble_interleaved``, which
    ``ShardedEncoder`` runs);
  - ``decode.call`` (``decode_jpeg_batch``, keyed by a running call
    number), ``decode.parse``, ``decode.lanes``, ``decode.fixpoint``,
    ``decode.round`` (one kernel H launch and its wait),
    ``decode.payload`` (kernel G and the stitch) and
    ``decode.reconstruct``.

* ``encode_metrics``: structured per-image results: bytes, bits/pixel,
  and PSNR against the source via the host decoder.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "jpeg_tpu_torch."
CAP = 65536  # records kept; later ones are dropped and counted

_records: list[list] = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span handed out while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One recorded span: its record and its ``record_function`` range."""

    __slots__ = ("name", "key", "_entry", "_range")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, key = None, self.key
        if stack:
            plist, pidx, prec = stack[-1]
            if plist is _records:
                parent = pidx
            if key is None:
                key = prec[1]
        rec = [self.name, key, parent, threading.get_ident(), 0, None]
        with _lock:
            records, idx = _records, len(_records)
            if idx < CAP:
                records.append(rec)
            else:
                _dropped += 1
                idx = None
        self._entry = (records, idx, rec)
        stack.append(self._entry)
        self._range = record_function(PREFIX + self.name)
        self._range.__enter__()
        rec[4] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self._entry[2]
        rec[5] = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _local.stack.pop()
        return False


def span(name: str, key=None):
    """A context manager around one host stage.  ``key`` is the batch or
    call number the spans of one request share; a span without one takes
    the key of the innermost span open on its thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, key)


def snapshot() -> tuple[list[tuple], int]:
    """The records so far, in the order the spans opened, each ``(name,
    key, parent, thread, t0_ns, t1_ns)`` (``parent`` the index of the
    innermost span open on the same thread, or None; ``t1_ns`` None while
    the span is open), and the number of spans dropped past ``CAP``."""
    with _lock:
        return [tuple(r) for r in _records], _dropped


def reset() -> None:
    """Forget every record and the dropped count."""
    global _records, _dropped
    with _lock:
        _records, _dropped = [], 0


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
