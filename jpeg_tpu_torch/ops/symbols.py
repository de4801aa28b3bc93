"""Plain run-length symbolization with ZRL and EOB, plus the LUT index.

Port of ``jpeg_tpu.kernels.fused._symbolize`` (T.81 F.1.2.2): slot 0
carries the DC difference as (magnitude class, amplitude); each nonzero
AC slot carries ``run << 4 | class`` and its amplitude; a zero slot that
ends a run of 16 before a later nonzero is a ZRL (0xF0); the slot after
the last nonzero AC is the EOB (0x00) unless that was slot 63.  Every
other slot is invalid and gets ``NULL_INDEX`` (zero bits).
``histogram_256`` is ``jpeg_tpu.ops.symbols``' symbol histogram.
"""
from __future__ import annotations

import torch

from ..kernels.lut import slot_index
from .color import MCU_420, Layout
from .dct import is_luma_block


def bit_length(a: torch.Tensor) -> torch.Tensor:
    """Magnitude class of non-negative ints < 2^24 (0 for 0)."""
    return torch.frexp(a.to(torch.float32)).exponent.to(torch.int32)


def symbolize(coef: torch.Tensor, dcd: torch.Tensor,
              layout: Layout = MCU_420):
    """[S, nblk, 64] coefs + [S, nblk] DC diffs -> (idx, extra, extra_n).

    All three are int32 [S, nblk, 64]; ``idx`` indexes the combined LUT,
    whose luma half ``layout``'s luma blocks use.
    """
    luma = is_luma_block(coef.shape[-2], coef.device, layout)
    return symbolize_explicit(coef, dcd,
                              luma.to(torch.int32).expand(dcd.shape))


def symbolize_explicit(coef: torch.Tensor, dcd: torch.Tensor,
                       is_luma: torch.Tensor):
    """``symbolize`` with each block's luma flag given: ``is_luma``
    [S, nblk] holds 1 (luma), 0 (chroma) or -1 (a padding block, whose
    every slot is invalid, DC included).  The DC slot of ``coef`` is
    ignored: slot 0 takes ``dcd``."""
    v = coef.to(torch.int32).clone()
    v[..., 0] = dcd
    a = v.abs()
    cls = bit_length(a)
    amp = torch.where(v < 0, v + (1 << cls) - 1, v)

    sub = torch.arange(64, device=v.device, dtype=torch.int32)
    zero = torch.zeros_like(v)
    ac_nz = (v != 0) & (sub >= 1)
    m = torch.cummax(torch.where(ac_nz, sub, zero), dim=-1).values
    last_nz = m[..., 63:64]
    prev_nz = torch.nn.functional.pad(m[..., :-1], (1, 0))

    run = (sub - prev_nz - 1) & 15
    sym = torch.where(ac_nz, (run << 4) | cls, zero)
    extra = torch.where(ac_nz, amp, zero)
    extra_n = torch.where(ac_nz, cls, zero)
    valid = ac_nz

    zrl = (~ac_nz & (sub >= 1) & (sub < last_nz)
           & (((sub - prev_nz) & 15) == 0))
    sym = torch.where(zrl, torch.full_like(sym, 0xF0), sym)
    valid = valid | zrl
    valid = valid | ((sub == last_nz + 1) & (last_nz < 63))

    is_dc = (sub == 0).expand_as(v)
    sym = torch.where(is_dc, cls, sym)
    extra = torch.where(is_dc, amp, extra)
    extra_n = torch.where(is_dc, cls, extra_n)
    valid = (valid | is_dc) & (is_luma >= 0)[..., None]

    luma = (is_luma == 1)[..., None].expand_as(v)
    idx = slot_index(sym, valid, is_dc, luma)
    extra = torch.where(valid, extra, zero)
    extra_n = torch.where(valid, extra_n, zero)
    return idx, extra, extra_n


def histogram_256(sym: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[256] int64 histogram of ``sym`` over the slots where ``valid``."""
    return torch.bincount(sym.reshape(-1)[valid.reshape(-1)].long(),
                          minlength=256)
