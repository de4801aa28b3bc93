"""The encode configuration and the window geometry.

The port's own copies of ``jpeg_tpu.core.types.EncodeConfig`` and
``Area``: the same fields, defaults and ``__post_init__`` messages, so a
configuration or a window means the same in both packages
(``tests/test_torch_host.py`` holds them equal).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class Area:
    """A window of a larger frame; w and h must be multiples of 16."""

    x: int
    y: int
    w: int
    h: int

    def __post_init__(self):
        if self.w % 16 or self.h % 16:
            raise ValueError(f"Area w/h must be multiples of 16, got {self.w}x{self.h}")
        if self.x < 0 or self.y < 0:
            raise ValueError(f"Area origin must be non-negative, got ({self.x},{self.y})")

    @property
    def num_pixels(self) -> int:
        return self.w * self.h

    @property
    def mcus_x(self) -> int:
        return self.w // 16

    @property
    def mcus_y(self) -> int:
        return self.h // 16


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Configuration for the encode pipelines.

    quality=None keeps the unscaled T.81 tables.

    scan_layout: "3scan" (three single-component scans) or "interleaved"
    (one Y/Cb/Cr scan; needed for restart segments in one scan).

    huffman:
      * "dynamic" — per-image K.2 tables from each image's symbol counts.
      * "fixed"   — T.81 Annex K.3 typical tables; no histogram sync.
      * "dynamic-sampled" — per-image K.2 tables from a 1/5-sampled symbol
                    histogram with a +1 floor on every possible symbol
                    (a symbol the sample missed still keeps a code).

    restart_interval_mcu_rows: if > 0, emit DRI and an RSTn marker every N
    MCU rows; each segment's DC prediction resets.

    engine: "pallas" or "xla" (``jpeg_tpu``'s entropy engines); "auto" is
    "pallas" on a CUDA device and "xla" on the CPU.  Both run the same
    kernels; in ``JpegEncoder``'s interleaved layout, "pallas" keeps
    "dynamic-sampled" sampled and "xla" builds exact tables, as in
    ``jpeg_tpu``.

    debug_checks: ``JpegEncoder`` first runs ``utils.guards``'s numeric
    sanitizers (quantizers >= 1, finite DCT, no coefficient clip).
    ``FastBatchEncoder`` reads neither field.
    """

    quality: int | None = None
    scan_layout: Literal["3scan", "interleaved"] = "3scan"
    huffman: Literal["dynamic", "fixed", "dynamic-sampled"] = "dynamic"
    subsampling: Literal["420", "422", "444"] = "420"
    restart_interval_mcu_rows: int = 0
    dtype: str = "float32"
    engine: Literal["auto", "xla", "pallas"] = "auto"
    debug_checks: bool = False

    def __post_init__(self):
        if self.quality is not None and not (1 <= self.quality <= 100):
            raise ValueError(f"quality must be in [1, 100], got {self.quality}")
        if self.scan_layout not in ("3scan", "interleaved"):
            raise ValueError(f"unknown scan_layout {self.scan_layout!r}")
        if self.huffman not in ("dynamic", "fixed", "dynamic-sampled"):
            raise ValueError(f"unknown huffman mode {self.huffman!r}")
        if self.subsampling not in ("420", "422", "444"):
            raise ValueError(f"unknown subsampling {self.subsampling!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.engine not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown engine {self.engine!r}")
