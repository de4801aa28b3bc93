"""Combined Huffman LUT: one 1024-entry ``code | length << 16`` table.

Restates ``jpeg_tpu.kernels.lut`` (which imports jax): the index of a slot
is ``sym | is_dc << 8 | is_luma << 9``; index ``NULL_INDEX`` (never made by
a valid slot, since a DC symbol is a magnitude class <= 12) holds the
zero-bit entry that invalid slots look up.  The tests hold both against
the originals.
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
