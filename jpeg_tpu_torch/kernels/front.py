"""Kernel A (``csrc/front_dct.cu``): u8 pixels -> quantized coefficients.

Ports the front half of ``jpeg_tpu.kernels.front.front_place``
(``_mega_place_kernel``), ``front_analyze`` (``_front_kernel``) and the DCT
and quantize of ``jpeg_tpu.kernels.fused._dct_attach_kernel``.
"""
from __future__ import annotations

import torch

from ..ops import color, dct
from . import check_tensor, launch, on_cpu


def front_dct_plain(rgb_flat: torch.Tensor, m: torch.Tensor,
                    bias: torch.Tensor, ql: torch.Tensor,
                    qc: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``front_dct``, on any device."""
    B, H, W3 = rgb_flat.shape
    y, cb, cr = color.rgb_to_ycbcr_420(rgb_flat.reshape(B, H, W3 // 3, 3))
    return dct.dct_quantize(color.mcu_blocks(y, cb, cr), m, bias, ql, qc)


def front_dct(rgb_flat: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
              ql: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """[B, H, W*3] u8 -> [B, n_mcus * 6, 64] int16 zig-zag coefficients.

    Blocks are in the interleaved MCU order (Y00 Y01 Y10 Y11 Cb Cr per
    MCU, MCUs in raster order).  ``m`` is the [64, 64] zig-zag flat DCT
    basis, ``bias`` its [64] level-shift bias, ``ql``/``qc`` the [64]
    zig-zag quantizers, all f32.
    """
    if on_cpu(rgb_flat, m, bias, ql, qc):
        return front_dct_plain(rgb_flat, m, bias, ql, qc)
    B, H, W3 = rgb_flat.shape
    if H % 16 or W3 % 48:
        raise ValueError(f"front_dct: {H}x{W3 // 3} is not a multiple of "
                         f"the 16x16 MCU")
    check_tensor("rgb", rgb_flat, torch.uint8, (B, H, W3))
    check_tensor("m", m, torch.float32, (64, 64))
    for name, t in (("bias", bias), ("ql", ql), ("qc", qc)):
        check_tensor(name, t, torch.float32, (64,))
    n_blocks = (H // 16) * (W3 // 48) * color.PERIOD
    out = torch.empty((B, n_blocks, 64), dtype=torch.int16,
                      device=rgb_flat.device)
    launch("front_dct", rgb_flat.device, rgb_flat.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), qc.data_ptr(), out.data_ptr(), B,
           H, W3 // 3)
    return out
