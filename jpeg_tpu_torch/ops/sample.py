"""The block sample of ``huffman="dynamic-sampled"``.

``jpeg_tpu`` histograms every 5th column of its stage-1 layout
(``pipelines/fast.py::_hist_src``), and that layout depends on which of
two stage-1 routes its ``FastBatchEncoder`` takes (``_front_index_ok``):

* the front route (``kernels/front.py::front_index``): an image is
  ``n_pseudo`` pseudo-images of ``slabs`` 128-row slabs, and slab ``g``
  of pseudo-image ``s`` holds ``slab_cols`` real blocks in MCU order, then
  phantom blocks up to the padded width ``sc_p``.  Block ``j`` of that
  slab sits in column ``(s * slabs + g) * sc_p + j``;
* the pixel route (``analyze_px`` + ``fused.dct_index_segments``), taken
  when the front's VMEM gates fail: each restart segment's blocks, in MCU
  order, padded to a multiple of 128 blocks, one segment after another.

Padded columns hold NULL slots, whose bin is dropped, but they still
shift which real blocks land on a multiple of 5; so the port keeps the
column of each real block and samples those, not every 5th block.
``front_index_route`` is the port's copy of the gate, as shape
arithmetic only: ``front_eligible``, the resident-words budget, and the
VMEM estimates ``mega_fits`` and ``analyze_fits`` of
``jpeg_tpu.kernels.front``, whose permutation-matrix sizes it computes
from their shapes, at each chroma subsampling.  A slab is 128 image rows:
8 MCU rows at 4:2:0, 16 at 4:2:2 and 4:4:4.  At 4:4:4 widths that are a
multiple of 8 but not of 16 the front is ineligible, so the sample is
the pixel route's.
"""
from __future__ import annotations

import numpy as np

from .color import SAMPLING_GEOMETRY
from ..kernels.pack import rows_per_segment

SAMPLE_STRIDE = 5   # coprime to every MCU period (6, 4, 3)
_SLAB_ROWS = 128
_MAX_W = 8192                       # kernels/front.py: per-slab VMEM bound
_STRIP_MCU = 64                     # kernels/front.py: strip width, MCUs
_VMEM_EST_LIMIT = 16 << 20          # kernels/front.py: scoped-VMEM budget
_RESIDENT_VMEM_BUDGET = 6 * 2 ** 20  # kernels/fused.py: resident words
_PX_TILE = 128                      # kernels/fused.py: _TB, segment pad


def slab_cols(mx: int, sampling: str = "420") -> int:
    """Real blocks of one 128-row slab of ``mx`` 16-px MCU columns."""
    return {"420": 48, "422": 64, "444": 96}[sampling] * mx


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


# -- the route gate (jpeg_tpu's FastBatchEncoder._front_index_ok) -----------


def front_eligible(height: int, width: int, n_segs: int,
                   sampling: str = "420") -> bool:
    """``kernels/front.py::front_eligible``: 16-px widths, MCU-row heights
    and segments."""
    mcu_h = SAMPLING_GEOMETRY[sampling][1]
    if width % 16 or height % mcu_h or width > _MAX_W:
        return False
    return n_segs == 1 or (height // mcu_h) % n_segs == 0


def _strip_plan(mx: int) -> list[int]:
    """Strip widths (MCUs) of ``mx`` MCU columns: uniform if a divisor
    >= 32 exists, else 64-wide strips plus the remainder."""
    if mx <= _STRIP_MCU:
        return [mx]
    kmin = -(-mx // _STRIP_MCU)
    for k in range(kmin, max(kmin, mx // 32) + 1):
        if mx % k == 0:
            return [mx // k] * k
    k, rem = divmod(mx, _STRIP_MCU)
    return [_STRIP_MCU] * k + ([rem] if rem else [])


def _const_bytes(mx: int, sampling: str = "420") -> int:
    """bf16 bytes of the per-strip permutation matrices of the front
    (``_consts_np``: sel, il8 and, by sampling, r1y, r1c, ps2, lc2, rny,
    rcb, rcr), from their shapes."""
    total = 0
    for m in set(_strip_plan(mx)):
        w = 16 * m
        n = 384 * 384 + 64 * 64 + w * w  # sel, il8, r1y
        if sampling == "420":
            n += (w // 2) ** 2 + w * (w // 2) + 64 * 128 \
                + 4 * m * 6 * m + 2 * m * 6 * m
        elif sampling == "422":
            n += (w // 2) ** 2 + w * (w // 2) + 2 * m * 4 * m \
                + 2 * m * 4 * m
        else:  # 444: rny, rcb, rcr over the 8-px MCU columns
            n += 3 * (2 * m) * (6 * m)
        total += 2 * n
    return total


def mega_vmem_bytes(mx: int, seg_rows: int, cbp: int,
                    sampling: str = "420") -> int:
    """Estimated scoped VMEM of one ``front_place`` grid step."""
    sc = slab_cols(mx, sampling)
    seg_rows_p = (seg_rows + 7) & ~7
    return (_const_bytes(mx, sampling) + 2 * 128 * 16 * mx * 3
            + 2 * 64 * sc * 4 + seg_rows_p * 128 * 4 + (128 + 2) * cbp * 4
            + 6 * 64 * cbp * 4)


def mega_fits(mx: int, seg_rows: int, sampling: str = "420") -> bool:
    """``pick_mega_layout``'s verdict: some 128-multiple chunk of the
    padded slab fits the VMEM estimate."""
    sc_p, cbp = pick_slab_pad(slab_cols(mx, sampling))
    while mega_vmem_bytes(mx, seg_rows, cbp, sampling) > _VMEM_EST_LIMIT:
        smaller = [c for c in range(cbp - 128, 0, -128) if sc_p % c == 0]
        if not smaller:
            return False
        cbp = smaller[0]
    return True


def analyze_fits(mx: int, sampling: str = "420") -> bool:
    """``analyze_fits(mx, sampling, n_outputs=1)`` (the index kernel)."""
    sc_p, cbp = pick_slab_pad(slab_cols(mx, sampling))
    est = (_const_bytes(mx, sampling) + 2 * 128 * 16 * mx * 3
           + 2 * 64 * sc_p * 4 + 2 * 64 * sc_p * 4 + 4 * 64 * cbp * 4)
    return est <= _VMEM_EST_LIMIT


def _blocks_per_segment(height: int, width: int, n_segs: int,
                        sampling: str) -> int:
    mcu_w, mcu_h, ypm = SAMPLING_GEOMETRY[sampling]
    return (height // mcu_h) * (width // mcu_w) // n_segs * (ypm + 2)


def front_index_route(height: int, width: int, n_segs: int,
                      sampling: str = "420") -> bool:
    """True where ``jpeg_tpu``'s dynamic stage 1 takes the front route
    (``_front_index_ok``), False where it takes the pixel route."""
    if not front_eligible(height, width, n_segs, sampling):
        return False
    seg_rows = rows_per_segment(
        _blocks_per_segment(height, width, n_segs, sampling) * 64)
    mx = width // 16
    return (((seg_rows + 7) & ~7) * 128 * 4 <= _RESIDENT_VMEM_BUDGET
            and mega_fits(mx, seg_rows, sampling)
            and analyze_fits(mx, sampling))


# -- the sample ---------------------------------------------------------------


def stage1_columns(height: int, width: int, n_segs: int,
                   sampling: str = "420") -> np.ndarray:
    """int64 [blocks per image]: the column of each real block (in the
    port's block order) in ``jpeg_tpu``'s per-image stage-1 layout, on the
    route ``front_index_route`` picks."""
    per_seg = _blocks_per_segment(height, width, n_segs, sampling)
    if not front_index_route(height, width, n_segs, sampling):
        k = np.arange(n_segs * per_seg, dtype=np.int64)
        seg_p = -(-per_seg // _PX_TILE) * _PX_TILE
        return k // per_seg * seg_p + k % per_seg
    sc = slab_cols(width // 16, sampling)
    sc_p, _ = pick_slab_pad(sc)
    n_pseudo = 1 if aligned_segments(height, n_segs) else n_segs
    rows = height // n_pseudo
    slabs = -(-rows // _SLAB_ROWS)
    per_pseudo = _blocks_per_segment(rows, width, 1, sampling)
    k = np.arange(n_pseudo * per_pseudo, dtype=np.int64)
    s, local = k // per_pseudo, k % per_pseudo
    g, j = local // sc, local % sc
    return (s * slabs + g) * sc_p + j


def sample_mask(height: int, width: int, n_segs: int,
                sampling: str = "420") -> np.ndarray:
    """uint8 [blocks per image]: 1 where ``jpeg_tpu``'s sampled histogram
    counts the block."""
    cols = stage1_columns(height, width, n_segs, sampling)
    return (cols % SAMPLE_STRIDE == 0).astype(np.uint8)
