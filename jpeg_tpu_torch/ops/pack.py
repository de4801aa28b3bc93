"""Words-buffer geometry and scan finalization, restated from
``jpeg_tpu.ops.pack`` (which imports jax).

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


def finish_scan(words: np.ndarray, total_bits: int) -> bytes:
    """Host finalization of one scan: its bytes with 0xFF00 stuffing and
    the reference's ones-padded tail byte (``jpeg_tpu.ops.pack.finish_scan``
    semantics), through the port's native ``finish_scans``."""
    w = np.asarray(words, dtype=np.uint32).reshape(1, -1)
    return native.finish_scans(w, np.array([total_bits], np.int32))[0]
