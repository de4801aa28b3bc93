"""The block sample of ``huffman="dynamic-sampled"``.

``jpeg_tpu`` histograms every 5th column of its stage-1 layout
(``pipelines/fast.py::_hist_src``).  On its front route
(``kernels/front.py::front_index``) an image is ``n_pseudo`` pseudo-images
of ``slabs`` 128-row slabs, and slab ``g`` of pseudo-image ``s`` holds
``slab_cols`` real blocks in MCU order, then phantom blocks up to the
padded width ``sc_p``.  Block ``j`` of that slab sits in column
``(s * slabs + g) * sc_p + j``.  Phantom and padded-row columns hold NULL
slots, whose bin is dropped, but they still shift which real blocks land
on a multiple of 5; so the port keeps the column of each real block and
samples those, not every 5th block.

Where the layout has no padding the column is the block index, which is
also ``jpeg_tpu``'s other route (``dct_index_segments`` over
``analyze_px``).  The two differ only at geometries past ``jpeg_tpu``'s
VMEM gates that are also padded (ROADMAP queue 3).

``slab_cols``, ``pick_slab_pad`` and ``aligned_segments`` are the port's
copies of the ``jpeg_tpu.kernels.front`` helpers (4:2:0).
"""
from __future__ import annotations

import numpy as np

from .color import PERIOD

SAMPLE_STRIDE = 5   # coprime to every MCU period (6, 4, 3)
_SLAB_ROWS = 128
_MCU = 16


def slab_cols(mx: int) -> int:
    """Real blocks of one 128-row slab of ``mx`` 4:2:0 MCU columns."""
    return 8 * PERIOD * mx


def pick_slab_pad(sc: int) -> tuple[int, int]:
    """(padded slab columns, chunk width): zero padding with the largest
    128-multiple chunk <= 2048 that divides ``sc``, else the smallest
    padding (<= max(128, sc // 8) phantom columns) that admits a large
    chunk."""
    for k in range(16, 0, -1):
        if sc % (128 * k) == 0:
            return sc, 128 * k
    for k in range(16, 0, -1):
        scp = -(-sc // (128 * k)) * (128 * k)
        if scp - sc <= max(128, sc // 8):
            return scp, 128 * k
    raise AssertionError("k = 1 always pads < 128")


def aligned_segments(height: int, n_segs_per_image: int) -> bool:
    """True when every restart segment is a whole number of 128-row slabs
    (one pseudo-image per image); otherwise each segment is its own
    pseudo-image, padded to whole slabs."""
    return (n_segs_per_image == 1 or
            (height % _SLAB_ROWS == 0 and
             (height // _SLAB_ROWS) % n_segs_per_image == 0))


def stage1_columns(height: int, width: int, n_segs: int) -> np.ndarray:
    """int64 [blocks per image]: the column of each real block (in the
    port's block order) in ``jpeg_tpu``'s per-image stage-1 layout."""
    sc = slab_cols(width // _MCU)
    sc_p, _ = pick_slab_pad(sc)
    n_pseudo = 1 if aligned_segments(height, n_segs) else n_segs
    rows = height // n_pseudo
    slabs = -(-rows // _SLAB_ROWS)
    per_pseudo = (rows // _MCU) * (width // _MCU) * PERIOD
    k = np.arange(n_pseudo * per_pseudo, dtype=np.int64)
    s, local = k // per_pseudo, k % per_pseudo
    g, j = local // sc, local % sc
    return (s * slabs + g) * sc_p + j


def sample_mask(height: int, width: int, n_segs: int) -> np.ndarray:
    """uint8 [blocks per image]: 1 where ``jpeg_tpu``'s sampled histogram
    counts the block."""
    cols = stage1_columns(height, width, n_segs)
    return (cols % SAMPLE_STRIDE == 0).astype(np.uint8)
