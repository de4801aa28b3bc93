"""Plain 4:2:0 front: RGB -> YCbCr planes -> 8x8 blocks in MCU order.

Port of ``jpeg_tpu.ops.color`` and the MCU interleave of
``jpeg_tpu.pipelines.fast`` (``mcu_reorder``, ``analyze_px``).  The f32
color conversion is exact fixed-point integer arithmetic:
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


# the interleaved 4:2:0 MCU: Y00 Y01 Y10 Y11 Cb Cr
MCU_420 = Layout(6, 4)
# a single-component (non-interleaved) scan: one block per MCU, luma (Y)
# or chroma (Cb, Cr); its DC predecessor is the block before
SCAN_Y = Layout(1, 1)
SCAN_CHROMA = Layout(1, 0)

PERIOD, Y_PER_MCU = MCU_420


def rgb_to_ycbcr_420(rgb: torch.Tensor, dtype: torch.dtype = torch.float32):
    """[..., H, W, 3] uint8 -> (y [.., H, W], cb [.., H/2, W/2], cr) int32.

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
        y, cb, cr = (torch.floor(p).to(torch.int32) for p in (y, cb, cr))
        return y, _avg2x2(cb), _avg2x2(cr)
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = torch.div(299 * r + 587 * g + 114 * b, 1000, rounding_mode="floor")
    cb_t = 128_000_000 + (-168736 * r - 331264 * g + 500000 * b)
    cr_t = 128_000_000 + (500000 * r - 418688 * g - 81312 * b)
    cb = torch.div(cb_t >> 6, 15625, rounding_mode="floor")
    cr = torch.div(cr_t >> 6, 15625, rounding_mode="floor")
    return y, _avg2x2(cb), _avg2x2(cr)


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


def mcu_blocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """Planes of [B, ...] images -> [B, n_mcus * 6, 64] f32 pixel blocks.

    Raster-flattened, un-level-shifted blocks in the interleaved MCU order
    (MCUs in raster order; in each, Y00 Y01 Y10 Y11 Cb Cr).
    """
    B, H, W = y.shape
    my, mx = H // 16, W // 16
    yb = to_blocks(y).reshape(B, my, 2, mx, 2, 64).transpose(2, 3)
    yb = yb.reshape(B, my * mx, Y_PER_MCU, 64)
    cbb = to_blocks(cb).reshape(B, my * mx, 1, 64)
    crb = to_blocks(cr).reshape(B, my * mx, 1, 64)
    out = torch.cat([yb, cbb, crb], dim=2)
    return out.reshape(B, my * mx * PERIOD, 64).to(torch.float32)


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
