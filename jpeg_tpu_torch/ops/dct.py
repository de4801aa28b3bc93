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
"""
from __future__ import annotations

import torch

from .color import MCU_420, Layout

COEF_MIN, COEF_MAX = -2048, 2047


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
