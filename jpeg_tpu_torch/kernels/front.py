"""Kernel A (``csrc/front_dct.cu``): pixels -> quantized coefficients.

Ports the front half of ``jpeg_tpu.kernels.front.front_place``
(``_mega_place_kernel``), ``front_index`` (``_mega_index_kernel``) and
``front_analyze`` (``_front_kernel``) at 4:2:0, 4:2:2 and 4:4:4, the DCT
and quantize of ``jpeg_tpu.kernels.fused._dct_attach_kernel``, and the
XLA fronts of ``jpeg_tpu.pipelines.encode`` (``analyze_fn``'s 3-scan
blocks and ``_analyze_gray_fn``'s grayscale blocks).  Its pixel-block
mode (``front_dct_px``, kernel ``front_dct_px``) is the DCT of
``fused.dct_attach_pack_segments`` (K7) and ``fused.dct_index_xt``
(K18a), from f32 pixel blocks.
"""
from __future__ import annotations

import torch

from ..ops import color, dct
from ..ops.color import SAMPLING_GEOMETRY, Layout
from . import aligned, check_tensor, launch, on_cpu

# the output orders of kernel A's color mode, and its grayscale mode
ORDERS = {"mcu": 0, "scan": 1}
_GRAY = 2
# the subsamplings of the color mode
SAMPLINGS = {"420": 0, "422": 1, "444": 2}


def front_dct_plain(rgb_flat: torch.Tensor, m: torch.Tensor,
                    bias: torch.Tensor, ql: torch.Tensor, qc: torch.Tensor,
                    order: str = "mcu", sampling: str = "420") -> torch.Tensor:
    """Plain twin of ``front_dct``, on any device."""
    B, H, W3 = rgb_flat.shape
    y, cb, cr = color.rgb_to_ycbcr(rgb_flat.reshape(B, H, W3 // 3, 3),
                                   sampling)
    if order == "mcu":
        return front_dct_px_plain(color.mcu_blocks(y, cb, cr, sampling), m,
                                  bias, ql, qc, color.LAYOUTS[sampling])
    px = color.scan_blocks(y, cb, cr)
    luma = torch.arange(px.shape[0], device=px.device) < y.numel() // 64
    return dct.dct_quantize(px, m, bias, ql, qc, luma)


def front_dct(rgb_flat: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
              ql: torch.Tensor, qc: torch.Tensor, order: str = "mcu",
              sampling: str = "420") -> torch.Tensor:
    """[B, H, W*3] u8 -> int16 zig-zag coefficients of ``sampling``'s
    blocks ("420", "422" or "444"; H and W multiples of its MCU: 16x16,
    16 wide x 8 high, 8x8).

    ``order="mcu"``: [B, n_mcus * period, 64] in the interleaved MCU order
    (MCUs in raster order; in each, its Y blocks in raster order, then Cb
    and Cr: period 6, 4 or 3).  ``order="scan"``: [B * n_mcus * period,
    64] in the 3-scan order of ``color.scan_blocks`` (every image's Y
    blocks, then per image its Cb and its Cr blocks, each plane in raster
    block order).  ``m`` is the [64, 64] zig-zag flat DCT basis, ``bias``
    its [64] level-shift bias, ``ql``/``qc`` the [64] zig-zag quantizers,
    all f32.
    """
    if order not in ORDERS:
        raise ValueError(f"front_dct: unknown order {order!r}")
    if sampling not in SAMPLINGS:
        raise ValueError(f"front_dct: unknown sampling {sampling!r}")
    if on_cpu(rgb_flat, m, bias, ql, qc):
        return front_dct_plain(rgb_flat, m, bias, ql, qc, order, sampling)
    B, H, W3 = rgb_flat.shape
    mcu_w, mcu_h, ypm = SAMPLING_GEOMETRY[sampling]
    if H % mcu_h or W3 % (3 * mcu_w):
        raise ValueError(f"front_dct: {H}x{W3 // 3} is not a multiple of "
                         f"the {mcu_w}x{mcu_h} MCU")
    check_tensor("rgb", rgb_flat, torch.uint8, (B, H, W3))
    _check_consts(m, bias=bias, ql=ql, qc=qc)
    rgb_flat = aligned(rgb_flat, 16)  # the kernel copies 16-byte pieces
    n_blocks = (H // mcu_h) * (W3 // (3 * mcu_w)) * (ypm + 2)
    shape = (B, n_blocks, 64) if order == "mcu" else (B * n_blocks, 64)
    out = torch.empty(shape, dtype=torch.int16, device=rgb_flat.device)
    launch("front_dct", rgb_flat.device, rgb_flat.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), qc.data_ptr(), out.data_ptr(), B,
           H, W3 // 3, ORDERS[order], SAMPLINGS[sampling])
    return out


def front_dct_px_plain(px: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                       ql: torch.Tensor, qc: torch.Tensor, layout: Layout,
                       transposed: bool = False) -> torch.Tensor:
    """Plain twin of ``front_dct_px``, on any device."""
    if transposed:
        px = px.T.reshape(1, -1, 64)
    luma = dct.is_luma_block(px.shape[1], px.device, layout)
    return dct.dct_quantize(px, m, bias, ql, qc, luma)


def front_dct_px(px: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                 ql: torch.Tensor, qc: torch.Tensor, layout: Layout,
                 transposed: bool = False) -> torch.Tensor:
    """Kernel A's pixel-block mode: f32 pixel blocks (color-converted,
    raster-flattened, un-level-shifted: the -128 is in ``bias``) ->
    int16 zig-zag coefficients.

    ``px`` is [S, nblk, 64], S segments of ``nblk`` blocks in the block
    pattern ``layout`` (a block is luma, quantized by ``ql``, when its
    position in its segment modulo the period is below ``y_per_mcu``);
    the result is [S, nblk, 64].  ``transposed``: ``px`` is the [64, n]
    transposed layout of jpeg_tpu's ``xt`` (one segment of ``n`` blocks),
    read as it lies; the result is [1, n, 64].
    """
    if on_cpu(px, m, bias, ql, qc):
        return front_dct_px_plain(px, m, bias, ql, qc, layout, transposed)
    if transposed:
        S, nblk = 1, px.shape[1]
        check_tensor("xt", px, torch.float32, (64, nblk))
    else:
        S, nblk = px.shape[0], px.shape[1]
        check_tensor("px", px, torch.float32, (S, nblk, 64))
    period, ypm = layout
    if not 0 <= ypm <= period or period < 1:
        raise ValueError(f"front_dct_px: bad layout {tuple(layout)}")
    _check_consts(m, bias=bias, ql=ql, qc=qc)
    px = aligned(px, 4 if transposed else 16)  # [N, 64]: 16-byte pieces
    out = torch.empty((S, nblk, 64), dtype=torch.int16, device=px.device)
    launch("front_dct_px", px.device, px.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), qc.data_ptr(), out.data_ptr(), S,
           nblk, period, ypm, int(transposed))
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
    plane = aligned(plane, 8)  # the kernel copies block rows of 8 bytes
    out = torch.empty((B, (H // 8) * (W // 8), 64), dtype=torch.int16,
                      device=plane.device)
    launch("front_dct", plane.device, plane.data_ptr(), m.data_ptr(),
           bias.data_ptr(), ql.data_ptr(), ql.data_ptr(), out.data_ptr(), B,
           H, W, _GRAY, 0)
    return out


def _check_consts(m: torch.Tensor, **vectors: torch.Tensor) -> None:
    check_tensor("m", m, torch.float32, (64, 64))
    for name, t in vectors.items():
        check_tensor(name, t, torch.float32, (64,))
