"""Surveillance monitor: the application control loop (reference F1), the
port of ``jpeg_tpu.pipelines.monitor``.

The counterpart of ``app_main``'s steady-state cycle
(``main/main.c:130-166``): for each incoming frame, subsample, compare
against the stored frame, and encode every difference region as an
independent JPEG.  Where the firmware wrote ``/sdcard/jpg-<i>`` files and
slept between frames, this class returns the encoded regions to the
caller (I/O policy belongs to the application) and is driven by whatever
frame source the caller has.

On a CUDA device each region is a ``JpegEncoder.encode_region`` on the
port's kernels: A in the 3-scan order, then E, F, C and D once for the Y
scan and once for the Cb + Cr scans (dynamic tables, the default), or B,
C and D under ``huffman="fixed"``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import EncodeConfig
from .diff import DEFAULT_THRESHOLD, FrameComparator
from .encode import JpegEncoder


# reference capture cadence (main/main.c:154-158,164): poll fast while
# motion is active, back off when the scene is idle
ACTIVE_DELAY_S = 1.0
IDLE_DELAY_S = 10.0


@dataclasses.dataclass
class FrameResult:
    """Outcome of one monitor cycle."""
    regions: list  # list[tuple[Area, bytes]]
    suggested_delay: float = IDLE_DELAY_S
    """Seconds until the next capture, mirroring the firmware's adaptive
    cadence (``main/main.c:154-158,164``: 1 s after a detected change,
    10 s idle).  Advisory — the caller owns the frame source and may
    pace however it likes."""

    @property
    def changed(self) -> bool:
        return bool(self.regions)


class ChangeMonitor:
    """Continuous compare-and-encode over a frame stream, on ``device`` (a
    CUDA device, which must exist, unless the caller passes ``"cpu"``)."""

    def __init__(self, height: int, width: int,
                 config: EncodeConfig | None = None,
                 threshold: int = DEFAULT_THRESHOLD,
                 snap_multiple: int | None = None,
                 active_delay: float = ACTIVE_DELAY_S,
                 idle_delay: float = IDLE_DELAY_S,
                 device: str | torch.device = "cuda"):
        self.comparator = FrameComparator(height, width, threshold=threshold,
                                          snap_multiple=snap_multiple,
                                          device=device)
        self.encoder = JpegEncoder(config, device=self.comparator.device)
        self.active_delay = active_delay
        self.idle_delay = idle_delay

    def process_frame(self, rgb) -> FrameResult:
        """One cycle: subsample, diff, ROI-encode each changed region.

        The frame goes to the device once; the comparator and every
        region's encode read it there.  The first frame only seeds the
        stored reference (the reference firmware does the same, modulo its
        first-frame artifact — SURVEY §7.3, which we deliberately do not
        reproduce).
        """
        x = self.comparator.to_device(rgb)
        areas = self.comparator.process(x)
        out = [(a, self.encoder.encode_region(x, a)) for a in areas]
        return FrameResult(
            regions=out,
            suggested_delay=self.active_delay if out else self.idle_delay)
