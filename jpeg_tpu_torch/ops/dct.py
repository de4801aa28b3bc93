"""Plain DCT chain: flat-basis DCT, quantize, DC differences.

Port of ``jpeg_tpu.ops.dct.dct_quantize_zigzag`` (f32) and of the DCT and
DC-chain math inside ``jpeg_tpu.kernels.fused._dct_symbolize_chunk_v``:

* ``zz = px @ M.T + bias`` with M the zig-zag-ordered flat DCT basis
  (``tables.dct_flat_basis``) and the -128 level shift folded into bias;
* an f32 divide by the zig-zag quantizer, trunc, clip to [-2048, 2047];
* per-component DC differences that reset at every segment start.

The matmul must run in full f32: callers on a card set
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` (``set_exact_matmul``).
"""
from __future__ import annotations

import torch

from .color import PERIOD, Y_PER_MCU

COEF_MIN, COEF_MAX = -2048, 2047


def set_exact_matmul() -> None:
    """Full-f32 matmuls on the card: no TF32 for the plain DCT."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def is_luma_block(n_blocks: int, device) -> torch.Tensor:
    """[n_blocks] bool: the interleaved MCU pattern Y Y Y Y Cb Cr."""
    pos = torch.arange(n_blocks, device=device) % PERIOD
    return pos < Y_PER_MCU


def dct_quantize(px: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                 ql: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """[..., n, 64] f32 pixel blocks in MCU order -> int16 zig-zag coefs."""
    f = torch.matmul(px, m.T) + bias
    luma = is_luma_block(px.shape[-2], px.device)[:, None]
    q = torch.where(luma, ql, qc)
    v = torch.trunc(f / q).clamp(COEF_MIN, COEF_MAX)
    return v.to(torch.int16)


def dc_diff(coef: torch.Tensor) -> torch.Tensor:
    """[S, nblk, 64] coefs -> [S, nblk] int32 per-component DC differences.

    Each segment restarts the Y, Cb and Cr prediction chains at 0.
    """
    S, nblk = coef.shape[0], coef.shape[1]
    dc = coef[..., 0].to(torch.int32).reshape(S, nblk // PERIOD, PERIOD)

    def diff(chain):  # [S, n] -> [S, n]
        prev = torch.nn.functional.pad(chain[:, :-1], (1, 0))
        return chain - prev

    y = diff(dc[..., :Y_PER_MCU].reshape(S, -1)).reshape(S, -1, Y_PER_MCU)
    cb = diff(dc[..., Y_PER_MCU])[..., None]
    cr = diff(dc[..., Y_PER_MCU + 1])[..., None]
    return torch.cat([y, cb, cr], dim=-1).reshape(S, nblk)
