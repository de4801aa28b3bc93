"""Words-buffer geometry, the host packer and scan finalization, restated
from ``jpeg_tpu.ops.pack`` (which imports jax).

A segment's bit stream lives in ``seg_rows * 128`` big-endian uint32
words (``kernels.pack.rows_per_segment``): bit ``i`` of the stream is bit
``31 - (i & 31)`` of word ``i >> 5``.  The buffer is sized for the worst
case of ``MAX_FIELD_BITS`` per slot, so ``seg_rows`` equals ``jpeg_tpu``'s
and ``native.assemble_interleaved`` takes the port's words unchanged.
"""
from __future__ import annotations

import numpy as np

from .. import native

MAX_FIELD_BITS = 30


def max_words_for_slots(num_slots: int) -> int:
    return (num_slots * MAX_FIELD_BITS) // 32 + 2


def pack_fields_np(values, nbits, max_words: int | None = None):
    """Host numpy packer of bit fields into big-endian uint32 words.

    values: field bits, right-aligned, 0 where nbits is 0; nbits: field
    lengths (0..30).  Returns (words uint32 [max_words], total_bits).
    Bit i of the stream lives in word i // 32 at big-endian position
    i % 32.
    """
    v = np.asarray(values).reshape(-1).astype(np.int64) & 0xFFFFFFFF
    n = np.asarray(nbits).reshape(-1).astype(np.int64)
    if max_words is None:
        max_words = max_words_for_slots(v.shape[0])
    if v.size == 0:
        return np.zeros(max_words, np.uint32), 0
    ends = np.cumsum(n)
    total = int(ends[-1])
    offs = ends - n
    w = offs >> 5
    end_in = (offs & 31) + n
    hi = np.where(end_in <= 32,
                  v << np.clip(32 - end_in, 0, 31),
                  v >> np.clip(end_in - 32, 0, 31)) & 0xFFFFFFFF
    lo = np.where(end_in > 32,
                  v << np.clip(64 - end_in, 0, 31), 0) & 0xFFFFFFFF
    words = np.zeros(max_words, np.uint32)
    np.add.at(words, w, hi.astype(np.uint32))          # disjoint bits:
    np.add.at(words, w + 1, lo.astype(np.uint32))      # add == or
    return words, total


def finish_scan(words: np.ndarray, total_bits: int) -> bytes:
    """Host finalization of one scan: its bytes with 0xFF00 stuffing and
    the reference's ones-padded tail byte (``jpeg_tpu.ops.pack.finish_scan``
    semantics), through the port's native ``finish_scans``."""
    w = np.asarray(words, dtype=np.uint32).reshape(1, -1)
    return native.finish_scans(w, np.array([total_bits], np.int32))[0]
