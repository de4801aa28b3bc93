"""Constant tables for baseline JPEG (ITU-T T.81 / ISO 10918-1).

The port's own copy of ``jpeg_tpu.core.tables`` (the port imports nothing
of ``jpeg_tpu``); ``tests/test_torch_host.py`` holds it equal to the
original.

Capability parity with the reference's constant tables
(``main/encoder.c:8-46``, ``utils/original.c:475-502,544-560``): the ITU T.81
Annex K example quantizers, the zig-zag scan order, and the 8x8 DCT cosine
basis.  The reference stores the cosine table as int64 bit patterns
(``main/encoder.c:8-16``, generated by ``utils/lookup.c``); we compute the same
doubles directly — ``cos((2*t+1)*f*pi/16)`` — which reproduces those bit
patterns exactly on any IEEE-754 platform with a correctly-rounded ``cos``.
"""
from __future__ import annotations

import numpy as np

# ITU-T T.81 Annex K.1 example luminance quantization table
# (reference: main/encoder.c:18-26, utils/original.c:475-483).
LUMA_QUANTIZER = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

# ITU-T T.81 Annex K.1 example chrominance quantization table
# (reference: main/encoder.c:28-36, utils/original.c:488-496).
CHROMA_QUANTIZER = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)

# Zig-zag scan order: zigzagged[i] = raster[SCAN_ORDER[i]]
# (reference: main/encoder.c:38-46, utils/original.c:544-552).
SCAN_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# Inverse permutation: raster[i] = zigzagged[INV_SCAN_ORDER[i]].
INV_SCAN_ORDER = np.argsort(SCAN_ORDER).astype(np.int32)

# Quantized-coefficient clip range (reference: main/encoder.c:109,
# utils/original.c:521; include/define.h CLIP macro).
COEF_CLIP_MIN = -2048
COEF_CLIP_MAX = 2047

# BT.601 RGB -> YCbCr coefficients (reference: utils/original.c:372-374,
# main/encoder.c:133-135).  Row order: Y, Cb, Cr; column order R, G, B.
RGB_TO_YCBCR = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float64)
YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float64)


def dct_cosine_table() -> np.ndarray:
    """The reference's 8x8 cosine lookup: C[t, f] = cos((2t+1) f pi / 16).

    Identical values to ``utils/original.c:412-422`` (``init_dct_lookup``) and
    the int64 bit-pattern table in ``main/encoder.c:8-16``.
    """
    t = np.arange(8, dtype=np.float64)[:, None]
    f = np.arange(8, dtype=np.float64)[None, :]
    return np.cos((2.0 * t + 1.0) * f * np.pi / 16.0)


def dct_basis_orthonormal() -> np.ndarray:
    """Orthonormal DCT-II basis A with F = A @ X @ A.T.

    A[f, t] = c(f)/2 * cos((2t+1) f pi/16), c(0)=1/sqrt(2), else 1.
    Equivalent to the reference's two-pass transform + (1/sqrt2, /4) scaling
    (``utils/original.c:428-456``), as a single pair of matmuls — the
    MXU-friendly formulation the TPU kernels use.
    """
    c = dct_cosine_table().T  # [f, t]
    scale = np.full((8, 1), 0.5, dtype=np.float64)
    scale[0, 0] = 0.5 / np.sqrt(2.0)
    return c * scale


def dct_flat_basis() -> tuple[np.ndarray, np.ndarray]:
    """Flattened separable DCT as one [64, 64] matrix, zig-zag ordered.

    zz = M @ x_flat + bias, where x_flat is the raster-flattened 8x8 block
    (un-level-shifted u8 values) and bias folds in the -128 level shift:
    M = kron(A, A)[SCAN_ORDER], bias = -128 * M.sum(axis=1).

    Mathematically identical to ``dct_basis_orthonormal`` applied two-sided;
    preferred on TPU because a [N, 64] @ [64, 64] matmul maps onto the MXU
    with a contraction depth of 64 (vs 8), and — decisively — because
    XLA:TPU takes minutes to compile the batched-8x8 einsum form at scale
    (~120 s at 25k blocks) vs seconds for this one.
    """
    a = dct_basis_orthonormal()
    m = np.kron(a, a)[SCAN_ORDER]
    bias = -128.0 * m.sum(axis=1)
    return m, bias


def set_quality(quantizer: np.ndarray, quality: int) -> np.ndarray:
    """T.81 linear quality scaling, exactly as ``utils/original.c:504-509``:

    q' = CLIP(int((100 - quality)/50.0 * q), 1, 255)

    (int conversion truncates toward zero, matching the C assignment).
    Note the reference parses a quality CLI argument but ships with the
    ``set_quality`` call commented out (``utils/original.c:1157-1158``), so
    quality=None (no scaling) reproduces its actual output.
    """
    scaled = np.trunc((100 - quality) / 50.0 * quantizer.astype(np.float64))
    return np.clip(scaled, 1, 255).astype(np.int32)


def quant_tables(quality: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantizer pair, optionally quality-scaled."""
    if quality is None:
        return LUMA_QUANTIZER.copy(), CHROMA_QUANTIZER.copy()
    return set_quality(LUMA_QUANTIZER, quality), set_quality(CHROMA_QUANTIZER, quality)
