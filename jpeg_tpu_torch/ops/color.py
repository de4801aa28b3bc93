"""Plain front: RGB -> YCbCr planes (4:2:0, 4:2:2 or 4:4:4) -> 8x8 blocks
in MCU order.

Port of ``jpeg_tpu.ops.color`` and the MCU interleave of
``jpeg_tpu.pipelines.fast`` (``SAMPLING_GEOMETRY``, ``mcu_reorder``,
``analyze_px``).  The f32 color conversion is exact fixed-point integer
arithmetic:
``floor(y_t / 1000)`` and ``floor((cb_t >> 6) / 15625)`` are what the
reference's f32 floor form computes, because every dividend is < 2^24 and
every remainder is far larger than an f32 ulp of the quotient.  The f64
conversion (exact mode) is the C reference's double expressions, one
separately rounded torch op per C operation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Layout(NamedTuple):
    """The block pattern of a scan's segments: ``period`` blocks repeat,
    and the first ``y_per_mcu`` of them are luma.  Each component's DC
    chain runs through its own blocks in segment order."""
    period: int
    y_per_mcu: int


# the interleaved MCUs: 4:2:0 Y00 Y01 Y10 Y11 Cb Cr; 4:2:2 Y0 Y1 Cb Cr;
# 4:4:4 Y Cb Cr
MCU_420 = Layout(6, 4)
MCU_422 = Layout(4, 2)
MCU_444 = Layout(3, 1)
# a single-component (non-interleaved) scan: one block per MCU, luma (Y)
# or chroma (Cb, Cr); its DC predecessor is the block before
SCAN_Y = Layout(1, 1)
SCAN_CHROMA = Layout(1, 0)

# per chroma subsampling: (MCU width, MCU height, Y blocks per MCU), as
# jpeg_tpu.pipelines.fast.SAMPLING_GEOMETRY; the MCU's block layout; and
# the Y component's (horizontal, vertical) sampling factors in SOF0
SAMPLING_GEOMETRY = {"420": (16, 16, 4), "422": (16, 8, 2), "444": (8, 8, 1)}
LAYOUTS = {"420": MCU_420, "422": MCU_422, "444": MCU_444}
Y_SAMPLING = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}


def rgb_to_ycbcr(rgb: torch.Tensor, sampling: str = "420",
                 dtype: torch.dtype = torch.float32):
    """[..., H, W, 3] uint8 -> (y, cb, cr) int32 planes of ``sampling``:
    chroma [.., H/2, W/2] (4:2:0, 2x2 truncating average), [.., H, W/2]
    (4:2:2, 1x2 truncating average) or [.., H, W] (4:4:4)."""
    y, cb, cr = rgb_to_ycbcr_444(rgb, dtype)
    avg = {"420": _avg2x2, "422": _avg1x2, "444": lambda p: p}[sampling]
    return y, avg(cb), avg(cr)


def rgb_to_ycbcr_420(rgb: torch.Tensor, dtype: torch.dtype = torch.float32):
    """[..., H, W, 3] uint8 -> (y [.., H, W], cb [.., H/2, W/2], cr) int32."""
    return rgb_to_ycbcr(rgb, "420", dtype)


def rgb_to_ycbcr_444(rgb: torch.Tensor, dtype: torch.dtype = torch.float32):
    """[..., H, W, 3] uint8 -> full-resolution (y, cb, cr) int32 planes.

    ``dtype=torch.float64``: ``jpeg_tpu``'s double expressions verbatim, in
    the C grouping (``utils/original.c:372-374``), each product and sum its
    own rounded op (eager torch never contracts them into an FMA), then
    floor; float32: the exact fixed-point form.
    """
    if dtype == torch.float64:
        x = rgb.to(torch.float64)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = (0.299 * r + 0.587 * g) + 0.114 * b
        cb = ((128.0 - 0.168736 * r) - 0.331264 * g) + 0.5 * b
        cr = ((128.0 + 0.5 * r) - 0.418688 * g) - 0.081312 * b
        return tuple(torch.floor(p).to(torch.int32) for p in (y, cb, cr))
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = torch.div(299 * r + 587 * g + 114 * b, 1000, rounding_mode="floor")
    cb_t = 128_000_000 + (-168736 * r - 331264 * g + 500000 * b)
    cr_t = 128_000_000 + (500000 * r - 418688 * g - 81312 * b)
    cb = torch.div(cb_t >> 6, 15625, rounding_mode="floor")
    cr = torch.div(cr_t >> 6, 15625, rounding_mode="floor")
    return y, cb, cr


def _avg1x2(plane: torch.Tensor) -> torch.Tensor:
    """1x2 (horizontal) integer-truncating average."""
    q = plane.reshape(*plane.shape[:-1], plane.shape[-1] // 2, 2)
    return (q[..., 0] + q[..., 1]) >> 1


def _avg2x2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 integer-truncating average (the planes are non-negative)."""
    h, w = plane.shape[-2], plane.shape[-1]
    q = plane.reshape(*plane.shape[:-2], h // 2, 2, w // 2, 2)
    s = q[..., 0, :, 0] + q[..., 0, :, 1] + q[..., 1, :, 0] + q[..., 1, :, 1]
    return s >> 2


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8 * W/8, 8, 8] in raster block order."""
    *lead, h, w = plane.shape
    return (plane.reshape(*lead, h // 8, 8, w // 8, 8)
            .transpose(-3, -2)
            .reshape(*lead, (h // 8) * (w // 8), 8, 8))


def mcu_blocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               sampling: str = "420"):
    """Planes of [B, ...] images -> [B, n_mcus * period, 64] f32 pixel
    blocks.

    Raster-flattened, un-level-shifted blocks in the interleaved MCU order
    of ``sampling`` (MCUs in raster order; in each, its Y blocks in raster
    order, then Cb and Cr).  Only 4:2:0 needs a Y relayout: at 4:2:2 and
    4:4:4 an MCU's Y blocks are raster-consecutive already.
    """
    mcu_w, mcu_h, ypm = SAMPLING_GEOMETRY[sampling]
    B, H, W = y.shape
    my, mx = H // mcu_h, W // mcu_w
    yb = to_blocks(y)
    if sampling == "420":
        yb = yb.reshape(B, my, 2, mx, 2, 64).transpose(2, 3)
    yb = yb.reshape(B, my * mx, ypm, 64)
    cbb = to_blocks(cb).reshape(B, my * mx, 1, 64)
    crb = to_blocks(cr).reshape(B, my * mx, 1, 64)
    out = torch.cat([yb, cbb, crb], dim=2)
    return out.reshape(B, my * mx * (ypm + 2), 64).to(torch.float32)


def scan_blocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """Planes of [B, ...] images -> [B * n_mcus * 6, 64] f32 pixel blocks
    in the 3-scan order: the Y blocks of every image (each image's in
    raster order), then per image its Cb blocks and its Cr blocks (raster
    order).  Every image's Y scan, and every image's Cb + Cr scans, are
    then contiguous runs of equal length."""
    B = y.shape[0]
    yb = to_blocks(y).reshape(-1, 64)
    cbb = to_blocks(cb).reshape(B, -1, 64)
    crb = to_blocks(cr).reshape(B, -1, 64)
    chroma = torch.cat([cbb, crb], dim=1).reshape(-1, 64)
    return torch.cat([yb, chroma]).to(torch.float32)
