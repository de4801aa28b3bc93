"""Plain DCT chain: flat-basis DCT, quantize, DC differences.

Port of ``jpeg_tpu.ops.dct.dct_quantize_zigzag`` (f32) and of the DCT and
DC-chain math inside ``jpeg_tpu.kernels.fused._dct_symbolize_chunk_v``:

* ``zz = px @ M.T + bias`` with M the zig-zag-ordered flat DCT basis
  (``tables.dct_flat_basis``) and the -128 level shift folded into bias;
* an f32 divide by the zig-zag quantizer, trunc, clip to [-2048, 2047];
* per-component DC differences that reset at every segment start
  (``jpeg_tpu.ops.dct.diff_dc`` along each component's own blocks).

The matmul must run in full f32: callers on a card set
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` (``set_exact_matmul``).

The f64 exact mode (``dct_quantize_exact``) ports ``_dct_exact`` and the
``exact`` branch of ``dct_quantize_zigzag``: the reference's separable
DCT in its summation order, each product and sum one eagerly rounded
torch op (no matmul, ``addcmul`` or compile, which would fuse or reorder
them), then a tensor-by-tensor divide by the quantizer on the blocks'
device (a divide by a CPU scalar may become a multiply by its reciprocal
on CUDA), so it gives the golden encoder's coefficients on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T
from .color import MCU_420, Layout

COEF_MIN, COEF_MAX = -2048, 2047
SQRT1_2 = float(np.sqrt(0.5))
# blocks per pass of the exact DCT: bounds each f64 temporary to 32 MB
EXACT_CHUNK = 1 << 16


def set_exact_matmul() -> None:
    """Full-f32 matmuls on the card: no TF32 for the plain DCT."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def is_luma_block(n_blocks: int, device,
                  layout: Layout = MCU_420) -> torch.Tensor:
    """[n_blocks] bool: the luma blocks of ``layout``'s pattern."""
    pos = torch.arange(n_blocks, device=device) % layout.period
    return pos < layout.y_per_mcu


def dct_quantize(px: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                 ql: torch.Tensor, qc: torch.Tensor,
                 luma: torch.Tensor | None = None) -> torch.Tensor:
    """[..., n, 64] f32 pixel blocks -> int16 zig-zag coefs.

    ``luma`` ([n] bool) picks ``ql`` over ``qc`` per block; by default the
    blocks are in the interleaved 4:2:0 MCU order.
    """
    f = torch.matmul(px, m.T) + bias
    if luma is None:
        luma = is_luma_block(px.shape[-2], px.device)
    q = torch.where(luma[:, None], ql, qc)
    v = torch.trunc(f / q).clamp(COEF_MIN, COEF_MAX)
    return v.to(torch.int16)


def dct_exact(blocks: torch.Tensor) -> torch.Tensor:
    """[n, 8, 8] integer pixels -> f64 [n, 8, 8] DCT (rows y_f, columns
    x_f), the reference's order (``utils/original.c:428-456``): a column
    pass, then a row pass, each accumulating in index order from 0, then
    ``*= sqrt(0.5)`` on column 0 and on row 0, then ``/ 4.0`` (exact: a
    power of two)."""
    cos = torch.from_numpy(T.dct_cosine_table()).to(blocks.device)  # [t, f]
    x = blocks.to(torch.float64) - 128.0  # [n, y_t, x_t]
    inner = torch.zeros_like(x)  # [n, x_t, y_f]
    for y_t in range(8):
        inner += x[:, y_t, :, None] * cos[y_t, None, :]
    del x
    freq = torch.zeros_like(inner)  # [n, y_f, x_f]
    for x_t in range(8):
        freq += inner[:, x_t, :, None] * cos[x_t, None, :]
    freq[:, :, 0] *= SQRT1_2
    freq[:, 0, :] *= SQRT1_2
    return freq / 4.0


def dct_quantize_exact(blocks: torch.Tensor,
                       quantizer: np.ndarray) -> torch.Tensor:
    """[..., n, 8, 8] integer pixels -> int16 [..., n, 64] zig-zag coefs of
    the f64 exact mode: ``dct_exact``, ``trunc(freq / q)`` with ``q`` the
    [8, 8] quantizer as an f64 tensor on the blocks' device, the clip to
    [-2048, 2047], the zig-zag gather.  Runs ``EXACT_CHUNK`` blocks at a
    time."""
    dev = blocks.device
    q = torch.from_numpy(np.asarray(quantizer, np.float64).reshape(8, 8))
    q = q.to(dev)
    scan = torch.from_numpy(np.asarray(T.SCAN_ORDER, np.int64)).to(dev)
    flat = blocks.reshape(-1, 8, 8)
    out = torch.empty((flat.shape[0], 64), dtype=torch.int16, device=dev)
    for i in range(0, flat.shape[0], EXACT_CHUNK):
        freq = dct_exact(flat[i:i + EXACT_CHUNK])
        quant = torch.trunc(freq / q).clamp_(COEF_MIN, COEF_MAX)
        out[i:i + EXACT_CHUNK] = quant.reshape(-1, 64)[:, scan]
    return out.reshape(*blocks.shape[:-2], 64)


def dc_diff(coef: torch.Tensor, layout: Layout = MCU_420) -> torch.Tensor:
    """[S, nblk, 64] coefs -> [S, nblk] int32 per-component DC differences.

    Each segment restarts every component's prediction chain at 0; the Y
    blocks of ``layout`` form one chain, each chroma position its own.
    """
    S, nblk = coef.shape[0], coef.shape[1]
    period, ypm = layout
    dc = coef[..., 0].to(torch.int32).reshape(S, nblk // period, period)

    def diff(chain):  # [S, n] -> [S, n]
        prev = torch.nn.functional.pad(chain[:, :-1], (1, 0))
        return chain - prev

    parts = [diff(dc[..., :ypm].reshape(S, -1)).reshape(S, -1, ypm)] \
        if ypm else []
    parts += [diff(dc[..., c])[..., None] for c in range(ypm, period)]
    return torch.cat(parts, dim=-1).reshape(S, nblk)
