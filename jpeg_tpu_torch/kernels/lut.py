"""Combined Huffman LUT: one 1024-entry ``code | length << 16`` table.

Restates ``jpeg_tpu.kernels.lut`` (which imports jax): the index of a slot
is ``sym | is_dc << 8 | is_luma << 9``; index ``NULL_INDEX`` (never made by
a valid slot, since a DC symbol is a magnitude class <= 12) holds the
zero-bit entry that invalid slots look up.  ``attach`` (K14,
``_attach_kernel``) and ``attach_grouped`` (K18c,
``_attach_kernel_grouped``) are kernel F (``fused.attach_pf``) on the
slots' packed fields; the TPU's 1024-slot NULL padding becomes padding to
whole 64-slot blocks.  The tests hold all of them against the originals.
"""
from __future__ import annotations

import numpy as np
import torch

NULL_INDEX = 1023


def build_combined_lut(tables) -> np.ndarray:
    """Pack the 4 HuffmanTables of ``huffman.build`` into [1024] int32."""
    lut = np.zeros(1024, dtype=np.int32)
    for name, is_dc, is_luma in (("luma_ac", 0, 1), ("luma_dc", 1, 1),
                                 ("chroma_ac", 0, 0), ("chroma_dc", 1, 0)):
        t = tables[name]
        base = (is_dc << 8) | (is_luma << 9)
        code = np.where(t.code < 0, 0, t.code).astype(np.int64)
        length = t.length.astype(np.int64)
        lut[base:base + 256] = (code | (length << 16)).astype(np.int32)
    lut[NULL_INDEX] = 0
    return lut


def slot_index(sym: torch.Tensor, valid: torch.Tensor, is_dc: torch.Tensor,
               is_luma: torch.Tensor) -> torch.Tensor:
    """Combined LUT index per slot; invalid slots get ``NULL_INDEX``."""
    idx = sym | (is_dc.to(sym.dtype) << 8) | (is_luma.to(sym.dtype) << 9)
    return torch.where(valid, idx, torch.full_like(idx, NULL_INDEX))


def attach(lut: torch.Tensor, idx: torch.Tensor, extra: torch.Tensor,
           extra_n: torch.Tensor):
    """(value, nbits) int32 per slot from the [1024] int32 combined LUT.

    ``idx`` (in [0, 1024)), ``extra`` (non-negative, < 2^17) and
    ``extra_n`` (< 16) are int32 arrays of one shape; the outputs have it.
    """
    value, nbits = attach_grouped(lut[None], idx.reshape(1, -1),
                                  extra.reshape(1, -1),
                                  extra_n.reshape(1, -1))
    return value.reshape(idx.shape), nbits.reshape(idx.shape)


def attach_grouped(luts: torch.Tensor, idx: torch.Tensor,
                   extra: torch.Tensor, extra_n: torch.Tensor):
    """Per-group tables: luts [G, 1024]; idx/extra/extra_n [G, ...] int32
    -> (value, nbits) int32 of idx's shape; group g looks up ``luts[g]``.

    ``value`` is 0 wherever ``nbits`` is 0: kernel F leaves the value of
    such a slot unwritten (its fields contract), and the field is empty.
    On every LUT that ``build_combined_lut`` makes (entry 0 wherever the
    length is 0) this is the plain lookup's value, and ``jpeg_tpu``'s."""
    from . import fused  # fused imports ops.symbols, which imports this
    G, shape = luts.shape[0], idx.shape
    pf = fused.pack_fields(idx.reshape(G, -1), extra.reshape(G, -1),
                           extra_n.reshape(G, -1))
    n = pf.shape[1]
    pad = -n % 64  # NULL slots: no bits, value 0
    if pad:
        pf = torch.cat([pf, pf.new_full((G, pad), NULL_INDEX)], dim=1)
    value, nbits, _ = fused.attach_pf(pf.reshape(G, -1, 64).contiguous(),
                                      luts.contiguous())
    nbits = nbits.to(torch.int32).reshape(G, -1)[:, :n]
    value = torch.where(nbits > 0, value.view(torch.int32).reshape(G, -1)[
        :, :n], 0)
    return value.reshape(shape), nbits.reshape(shape)
