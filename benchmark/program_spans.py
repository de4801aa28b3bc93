"""The program's own spans (``jpeg_tpu_torch.utils.profiling``), as the
per-layer readers of ``metrics/`` take them.

The program records a span only while a torch profiler records, so in a
``--trace 1`` run the snapshot holds the spans of the profiled stretches
alone.  A program without spans (no ``snapshot``) gives no reading.
"""
from __future__ import annotations


def records() -> list[tuple] | None:
    """The program's closed spans, each ``(name, key, parent, thread,
    t0_ns, t1_ns)``, or None where the program records none."""
    try:
        from jpeg_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    recs, _dropped = snapshot()
    return [r for r in recs if r[5] is not None]


def ms_per(names, per: str) -> float | None:
    """Host ms in the spans named ``names`` (summed) for each top-level
    span named ``per`` (a batch or a call), or None where either is
    missing."""
    recs = records()
    if not recs:
        return None
    steps = sum(1 for r in recs if r[0] == per and r[2] is None)
    spans = [r[5] - r[4] for r in recs if r[0] in names]
    if not steps or not spans:
        return None
    return sum(spans) / steps / 1e6
