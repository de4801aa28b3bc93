"""Segment packing: the counterpart of ``jpeg_tpu.kernels.pack`` (K15).

``pack_segments`` packs S segments of Huffman fields into S independent
big-endian word streams.  ``jpeg_tpu`` does it with a per-block local pack,
bit shift and lane rotate into [2, 128]-word windows (``block_windows_t``
-> ``_pack_kernel_t``), then an XLA row scatter-add.  Here the same
function is kernel C (``segment_offsets``: the block bit offsets and the
segment totals) then kernel D (``place``: each stream word written once);
summing each block's 64 slot lengths before C is glue, skipped where the
caller already has B's or F's ``bits``.  No tile padding: a segment may
hold any number of blocks.
"""
from __future__ import annotations

import torch

from ..ops.pack import max_words_for_slots
from . import fused


def rows_per_segment(slots_per_segment: int) -> int:
    """Output rows (128 words each) per segment, with straddle slack."""
    return max_words_for_slots(slots_per_segment) // 128 + 2


def pack_segments(value: torch.Tensor, nbits: torch.Tensor, n_segments: int,
                  seg_rows: int, bits: torch.Tensor | None = None):
    """value/nbits [S, nblk, 64] (value uint32 or int32, nbits any integer
    type holding 0..30) -> (words uint32 [S, seg_rows * 128], total_bits
    int32 [S]).  Each segment's stream starts at bit 0 of its own words;
    ``bits`` (int32 [S, nblk]), if given, is each block's bit count."""
    S = value.shape[0]
    if n_segments != S:
        raise ValueError(f"n_segments={n_segments} != leading dim {S}")
    if value.dtype == torch.int32:
        value = value.view(torch.uint32)
    if nbits.dtype != torch.uint8:
        nbits = nbits.to(torch.uint8)
    if bits is None:
        bits = nbits.sum(dim=-1, dtype=torch.int32)
    offs, totals = fused.segment_offsets(bits)
    return fused.place(value, nbits, offs, totals, seg_rows * 128), totals
