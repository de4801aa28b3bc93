"""Words-buffer geometry, restated from ``jpeg_tpu.ops.pack`` and
``jpeg_tpu.kernels.pack`` (both import jax).

A segment's bit stream lives in ``seg_rows * 128`` big-endian uint32
words: bit ``i`` of the stream is bit ``31 - (i & 31)`` of word ``i >> 5``.
The buffer is sized for the worst case of ``MAX_FIELD_BITS`` per slot, so
``seg_rows`` equals ``jpeg_tpu``'s and ``native.assemble_interleaved``
takes the port's words unchanged.
"""
from __future__ import annotations

MAX_FIELD_BITS = 30


def max_words_for_slots(num_slots: int) -> int:
    return (num_slots * MAX_FIELD_BITS) // 32 + 2


def rows_per_segment(slots_per_segment: int) -> int:
    """Output rows (128 words each) per segment, with straddle slack."""
    return max_words_for_slots(slots_per_segment) // 128 + 2
