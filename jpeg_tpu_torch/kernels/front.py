"""Kernel A (``csrc/front_dct.cu``): u8 pixels -> quantized coefficients.

Ports the front half of ``jpeg_tpu.kernels.front.front_place``
(``_mega_place_kernel``), ``front_analyze`` (``_front_kernel``), the DCT
and quantize of ``jpeg_tpu.kernels.fused._dct_attach_kernel``, and the
XLA fronts of ``jpeg_tpu.pipelines.encode`` (``analyze_fn``'s 3-scan
blocks and ``_analyze_gray_fn``'s grayscale blocks).
"""
from __future__ import annotations

import torch

from ..ops import color, dct
from . import check_tensor, launch, on_cpu

# the output orders of kernel A's color mode, and its grayscale mode
ORDERS = {"mcu": 0, "scan": 1}
_GRAY = 2


def front_dct_plain(rgb_flat: torch.Tensor, m: torch.Tensor,
                    bias: torch.Tensor, ql: torch.Tensor, qc: torch.Tensor,
                    order: str = "mcu") -> torch.Tensor:
    """Plain twin of ``front_dct``, on any device."""
    B, H, W3 = rgb_flat.shape
    y, cb, cr = color.rgb_to_ycbcr_420(rgb_flat.reshape(B, H, W3 // 3, 3))
    if order == "mcu":
        return dct.dct_quantize(color.mcu_blocks(y, cb, cr), m, bias, ql, qc)
    px = color.scan_blocks(y, cb, cr)
    luma = torch.arange(px.shape[0], device=px.device) < y.numel() // 64
    return dct.dct_quantize(px, m, bias, ql, qc, luma)


def front_dct(rgb_flat: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
              ql: torch.Tensor, qc: torch.Tensor,
              order: str = "mcu") -> torch.Tensor:
    """[B, H, W*3] u8 -> int16 zig-zag coefficients of 4:2:0 blocks.

    ``order="mcu"``: [B, n_mcus * 6, 64] in the interleaved MCU order (Y00
    Y01 Y10 Y11 Cb Cr per MCU, MCUs in raster order).  ``order="scan"``:
    [B * n_mcus * 6, 64] in the 3-scan order of ``color.scan_blocks``
    (every image's Y blocks, then per image its Cb and its Cr blocks, each
    plane in raster block order).  ``m`` is the [64, 64] zig-zag flat DCT
    basis, ``bias`` its [64] level-shift bias, ``ql``/``qc`` the [64]
    zig-zag quantizers, all f32.
    """
    if order not in ORDERS:
        raise ValueError(f"front_dct: unknown order {order!r}")
    if on_cpu(rgb_flat, m, bias, ql, qc):
        return front_dct_plain(rgb_flat, m, bias, ql, qc, order)
    B, H, W3 = rgb_flat.shape
    if H % 16 or W3 % 48:
        raise ValueError(f"front_dct: {H}x{W3 // 3} is not a multiple of "
                         f"the 16x16 MCU")
    check_tensor("rgb", rgb_flat, torch.uint8, (B, H, W3))
    _check_consts(m, bias=bias, ql=ql, qc=qc)
    n_blocks = (H // 16) * (W3 // 48) * color.PERIOD
    shape = (B, n_blocks, 64) if order == "mcu" else (B * n_blocks, 64)
    out = torch.empty(shape, dtype=torch.int16, device=rgb_flat.device)
    launch("front_dct", rgb_flat.device, rgb_flat.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), qc.data_ptr(), out.data_ptr(), B,
           H, W3 // 3, ORDERS[order])
    return out


def front_dct_gray_plain(plane: torch.Tensor, m: torch.Tensor,
                         bias: torch.Tensor, ql: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``front_dct_gray``, on any device."""
    B = plane.shape[0]
    px = color.to_blocks(plane.to(torch.int32)).reshape(B, -1, 64)
    luma = torch.ones(px.shape[1], dtype=torch.bool, device=px.device)
    return dct.dct_quantize(px.to(torch.float32), m, bias, ql, ql, luma)


def front_dct_gray(plane: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                   ql: torch.Tensor) -> torch.Tensor:
    """Kernel A's grayscale mode: [B, H, W] u8 planes (H, W multiples of
    8) -> [B, H/8 * W/8, 64] int16 zig-zag coefficients of the raster 8x8
    blocks, quantized by ``ql``; no color conversion."""
    if on_cpu(plane, m, bias, ql):
        return front_dct_gray_plain(plane, m, bias, ql)
    B, H, W = plane.shape
    if H % 8 or W % 8:
        raise ValueError(f"front_dct_gray: {H}x{W} is not a multiple of "
                         f"the 8x8 block")
    check_tensor("plane", plane, torch.uint8, (B, H, W))
    _check_consts(m, bias=bias, ql=ql)
    out = torch.empty((B, (H // 8) * (W // 8), 64), dtype=torch.int16,
                      device=plane.device)
    launch("front_dct", plane.device, plane.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), ql.data_ptr(), out.data_ptr(), B,
           H, W, _GRAY)
    return out


def _check_consts(m: torch.Tensor, **vectors: torch.Tensor) -> None:
    check_tensor("m", m, torch.float32, (64, 64))
    for name, t in vectors.items():
        check_tensor(name, t, torch.float32, (64,))
