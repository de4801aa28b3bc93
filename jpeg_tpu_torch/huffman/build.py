"""Huffman table construction (ISO/IEC 10918-1 Annex K.2) and the fixed
Annex K.3 tables.

The port's own copy of ``jpeg_tpu.huffman.build``: ``HuffmanTable``, the
K.2 builder, ``table_from_spec``, ``fixed_tables``,
``build_tables_batch`` and ``build_tables_from_histograms``.
``build_tables_batch`` runs the port's native (C++) builder and raises if
that library is missing; the Python ``build_table`` stays as the oracle
the tests hold the native builder against, and the golden encoder's
``build_tables_from_histograms`` uses it.  Outputs equal ``jpeg_tpu``'s
field for field (``tests/test_torch_host.py``).

K.2 as the reference encoder does it: pairwise merge of the two least
frequent symbols (ascending scan, ``<=`` comparisons, so the highest index
among equal minima wins), a reserved symbol 256 of frequency 1 so no real
symbol gets the all-ones code, 16-bit length limiting by leaf lifting, and
canonical codes over the symbols sorted by pre-limit code length.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HuffmanTable:
    """A baseline JPEG Huffman table.

    bits[i]   — number of codes of length i, i in [1, 16] (bits[0] unused);
                this is the DHT "BITS" list.
    huffval   — symbols in code order (the DHT "HUFFVAL" list).
    code[s]   — canonical codeword for symbol s (0..255), -1 if absent.
    length[s] — codeword length for symbol s, 0 if absent.
    """

    bits: np.ndarray      # int32[17]
    huffval: np.ndarray   # int32[n]
    code: np.ndarray      # int32[256]
    length: np.ndarray    # int32[256]


def _derive_code_lengths(sym_freq: np.ndarray) -> np.ndarray:
    """Annex K.2 code-length derivation."""
    freq = sym_freq.astype(np.int64).copy()
    code_len = np.zeros(257, dtype=np.int64)
    nxt = np.full(257, -1, dtype=np.int64)

    while True:
        v1 = -1
        v2 = -1
        # Reference tie-breaking: ascending scan, `<=` updates, so the
        # largest index among equal minima is selected.
        for i in range(257):
            if freq[i] == 0:
                continue
            if v1 == -1 or freq[i] <= freq[v1]:
                v2 = v1
                v1 = i
            elif v2 == -1 or freq[i] <= freq[v2]:
                v2 = i
        if v2 == -1:
            break

        freq[v1] += freq[v2]
        freq[v2] = 0
        while True:
            code_len[v1] += 1
            if nxt[v1] == -1:
                break
            v1 = nxt[v1]
        nxt[v1] = v2
        while True:
            code_len[v2] += 1
            if nxt[v2] == -1:
                break
            v2 = nxt[v2]
    return code_len


def _limit_code_lengths(code_len_freq: np.ndarray) -> np.ndarray:
    """16-bit length limiting by leaf lifting.

    Mutates a copy of code_len_freq (index = length, up to 31) and returns it.
    The final step removes one leaf from the deepest layer — the reserved
    symbol 256's slot — so no real symbol is assigned the all-ones code.
    """
    clf = code_len_freq.astype(np.int64).copy()
    i = 31
    while True:
        if clf[i] > 0:
            j = i - 2
            while clf[j] <= 0:
                j -= 1
            clf[i] -= 2
            clf[i - 1] += 1
            clf[j + 1] += 2
            clf[j] -= 1
            continue
        i -= 1
        if i != 16:
            continue
        while clf[i] == 0:
            i -= 1
        clf[i] -= 1
        break
    return clf


def build_tables_batch(freqs: np.ndarray) -> list[HuffmanTable]:
    """Batch K.2 builds through the native builder: freqs [n, 257] -> n
    tables.  Raises if the native library failed to build, and on an
    empty histogram or a code length overflow."""
    from .. import native
    freqs = np.asarray(freqs, dtype=np.int64)
    bits, huffval, code, length = native.build_huff_tables(freqs)
    out = []
    for i in range(freqs.shape[0]):
        n = int(bits[i, 1:].sum())
        out.append(HuffmanTable(bits=bits[i], huffval=huffval[i, :n],
                                code=code[i], length=length[i]))
    return out


def build_table(sym_freq: np.ndarray) -> HuffmanTable:
    """Build one Huffman table from a 257-entry symbol frequency histogram
    in Python (the oracle of the native builder).

    The caller must already have set ``sym_freq[256] = 1`` (the reserved
    code point, main/encoder.c:367).
    """
    if sym_freq.shape != (257,):
        raise ValueError(f"sym_freq must have shape (257,), got {sym_freq.shape}")
    if sym_freq[256] != 1:
        raise ValueError("sym_freq[256] must be 1 (reserved code point)")
    if int(sym_freq[:256].sum()) == 0:
        raise ValueError("empty symbol histogram: nothing to encode "
                         "(zero-sized image?)")
    code_len = _derive_code_lengths(sym_freq)
    if int(code_len.max(initial=0)) >= 32:
        # the K.2 limiter assumes lengths < 32 (libjpeg raises
        # JERR_HUFF_CLEN_OVERFLOW for the same pathological histograms)
        raise ValueError("Huffman code length overflow (>= 32 bits)")

    code_len_freq = np.zeros(32, dtype=np.int64)
    for length in code_len[code_len != 0]:
        code_len_freq[length] += 1

    clf = _limit_code_lengths(code_len_freq)

    # Sort real symbols (0..255) by pre-limit code length, then index
    # .  Symbol 256 is excluded.
    sym_sorted: list[int] = []
    for length in range(1, 32):
        for sym in range(256):
            if code_len[sym] == length:
                sym_sorted.append(sym)

    # Assign (possibly shortened) lengths in sorted order
    # .  sum(clf[1:17]) == len(sym_sorted) because the
    # limiting step dropped exactly the one reserved leaf.
    length_of = np.zeros(256, dtype=np.int32)
    k = 0
    for length in range(1, 17):
        for _ in range(int(clf[length])):
            length_of[sym_sorted[k]] = length
            k += 1
    assert k == len(sym_sorted), (k, len(sym_sorted))

    # Canonical code assignment.
    code_of = np.full(256, -1, dtype=np.int32)
    code = 0
    prev_len = None
    for sym in sym_sorted:
        length = int(length_of[sym])
        if prev_len is None:
            prev_len = length
        code <<= length - prev_len
        prev_len = length
        code_of[sym] = code
        code += 1

    bits = np.zeros(17, dtype=np.int32)
    bits[1:17] = clf[1:17]
    return HuffmanTable(
        bits=bits,
        huffval=np.array(sym_sorted, dtype=np.int32),
        code=code_of,
        length=length_of,
    )


def table_from_spec(bits: np.ndarray, huffval: np.ndarray) -> HuffmanTable:
    """Reconstruct code/length arrays from a DHT-style (bits, huffval) spec.

    This is both the decoder-side table builder and the loader for the fixed
    Annex K.3 tables.
    """
    bits = np.asarray(bits, dtype=np.int32)
    huffval = np.asarray(huffval, dtype=np.int32)
    code_of = np.full(256, -1, dtype=np.int32)
    length_of = np.zeros(256, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(bits[length])):
            sym = int(huffval[k])
            code_of[sym] = code
            length_of[sym] = length
            code += 1
            k += 1
        code <<= 1
    return HuffmanTable(bits=bits.copy(), huffval=huffval.copy(),
                        code=code_of, length=length_of)


# --- T.81 Annex K.3 typical tables (public standard constants) -------------

_DC_LUMA_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUMA_VALS = list(range(12))

_DC_CHROMA_BITS = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHROMA_VALS = list(range(12))

_AC_LUMA_BITS = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]

_AC_CHROMA_BITS = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]


def fixed_tables() -> dict[str, HuffmanTable]:
    """The T.81 Annex K.3 typical tables, keyed luma_dc/luma_ac/chroma_dc/chroma_ac."""
    return {
        "luma_dc": table_from_spec(_DC_LUMA_BITS, _DC_LUMA_VALS),
        "luma_ac": table_from_spec(_AC_LUMA_BITS, _AC_LUMA_VALS),
        "chroma_dc": table_from_spec(_DC_CHROMA_BITS, _DC_CHROMA_VALS),
        "chroma_ac": table_from_spec(_AC_CHROMA_BITS, _AC_CHROMA_VALS),
    }


def build_tables_from_histograms(
    luma_dc_freq: np.ndarray,
    luma_ac_freq: np.ndarray,
    chroma_dc_freq: np.ndarray,
    chroma_ac_freq: np.ndarray,
) -> dict[str, HuffmanTable]:
    """Build the 4 per-image tables from 256-entry histograms (Python
    builder; the golden encoder's).

    Mirrors ``init_huffman`` (main/encoder.c:360-381): Cb and Cr statistics
    must already be combined into the chroma histograms by the caller.
    Appends the reserved symbol-256 frequency here.
    """
    out = {}
    for name, freq in (
        ("luma_dc", luma_dc_freq),
        ("luma_ac", luma_ac_freq),
        ("chroma_dc", chroma_dc_freq),
        ("chroma_ac", chroma_ac_freq),
    ):
        full = np.zeros(257, dtype=np.int64)
        full[:256] = np.asarray(freq, dtype=np.int64)
        full[256] = 1
        out[name] = build_table(full)
    return out
