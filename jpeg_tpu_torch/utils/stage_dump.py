"""Stage-by-stage encoder dumps (the reference's myParts/hisParts tooling).

The port's own copy of ``jpeg_tpu.utils.stage_dump``, on the port's golden
encoder (``golden.encoder.encode_stages``, ``rgb_to_ycbcr``,
``subsample_chroma``); its files equal the original's.

Reproduces the golden-file test strategy of the reference (SURVEY §4):
``utils/original.c`` dumps every pipeline stage for Y/Cb/Cr into
``hisParts/`` (``utils/original.c:1184-1198,1212-1226,1245-1257,
1276-1288,1307-1319``), ``utils/func_tester.c`` dumps the same stages into
``myParts/``, and ``utils/dir-compare.c`` byte-compares the directories.

File set: ``{Y,Cb,Cr}-{Pre,Dct,Quant,ZigZag,Diff}``.  Formats match the
reference byte-for-byte for every *well-defined* file: ``%i``/``%f``
space-separated, newline at each row end (Y rows = width values, chroma
rows = width/2), DCT-onward arrays in block-major order.

Known reference defect not reproduced: its chroma Quant/ZigZag/Diff dumps
index ``dct_cb_quant[i]`` for i up to ``num_pixel`` stepping 4, but the
buffer only holds ``num_pixel/4`` entries (``utils/original.c:180-190`` vs
``:1249-1253``) — three quarters of those dumped values are out-of-bounds
heap reads.  We dump the actual ``num_pixel/4`` chroma entries instead.
"""
from __future__ import annotations

import os

import numpy as np

from ..golden import encoder as genc


def _fmt_int(values: np.ndarray, per_line: int) -> str:
    out = []
    v = values.reshape(-1)
    for i, x in enumerate(v):
        out.append(f"{int(x)}")
        out.append("\n" if i % per_line == per_line - 1 else " ")
    return "".join(out)


def _fmt_float(values: np.ndarray, per_line: int) -> str:
    out = []
    v = values.reshape(-1)
    for i, x in enumerate(v):
        out.append(f"{float(x):.6f}")         # printf("%f") = 6 decimals
        out.append("\n" if i % per_line == per_line - 1 else " ")
    return "".join(out)


def dump_stages(rgb: np.ndarray, outdir: str, quality: int | None = None) -> dict:
    """Encode ``rgb`` through the golden stages, dumping each to ``outdir``.

    Returns the stage dict from ``golden.encoder.encode_stages``.
    """
    os.makedirs(outdir, exist_ok=True)
    stages = genc.encode_stages(np.asarray(rgb), quality=quality)
    w = stages["width"]

    def write(name, text):
        with open(os.path.join(outdir, name), "w") as f:
            f.write(text)

    write("Y-Pre", _fmt_int(stages["y"], w))
    write("Cb-Pre", _fmt_int(stages["cb"], w // 2))
    write("Cr-Pre", _fmt_int(stages["cr"], w // 2))
    write("Y-Dct", _fmt_float(stages["y_dct"], w))
    write("Cb-Dct", _fmt_float(stages["cb_dct"], w // 2))
    write("Cr-Dct", _fmt_float(stages["cr_dct"], w // 2))
    write("Y-Quant", _fmt_int(stages["y_quant"], w))
    write("Cb-Quant", _fmt_int(stages["cb_quant"], w // 2))
    write("Cr-Quant", _fmt_int(stages["cr_quant"], w // 2))
    write("Y-ZigZag", _fmt_int(stages["y_zigzag"], w))
    write("Cb-ZigZag", _fmt_int(stages["cb_zigzag"], w // 2))
    write("Cr-ZigZag", _fmt_int(stages["cr_zigzag"], w // 2))
    write("Y-Diff", _fmt_int(stages["y_diff"], w))
    write("Cb-Diff", _fmt_int(stages["cb_diff"], w // 2))
    write("Cr-Diff", _fmt_int(stages["cr_diff"], w // 2))
    return stages


def channel_montage(rgb: np.ndarray) -> np.ndarray:
    """3x3 channel-visualization montage (``save_channels`` analog,
    ``utils/original.c:205-282``, the #ifdef INFO illustration path).

    Row 0: R/G/B as color tints; row 1: full-res Y/Cb/Cr grayscale;
    row 2: Y and the 2x2-subsampled Cb/Cr upsampled back (what the
    encoder actually consumes).  Illustration parity, not byte parity.
    """
    rgb = np.asarray(rgb)
    h, w = rgb.shape[:2]
    y, cb, cr = genc.rgb_to_ycbcr(rgb)
    cb_s, cr_s = genc.subsample_chroma(cb), genc.subsample_chroma(cr)
    up = lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1)
    gray = lambda p: np.stack([p, p, p], axis=-1).astype(np.uint8)
    zeros = np.zeros((h, w), np.uint8)
    out = np.empty((3 * h, 3 * w, 3), np.uint8)
    out[:h, :w] = np.stack([rgb[..., 0], zeros, zeros], -1)
    out[:h, w:2 * w] = np.stack([zeros, rgb[..., 1], zeros], -1)
    out[:h, 2 * w:] = np.stack([zeros, zeros, rgb[..., 2]], -1)
    out[h:2 * h, :w] = gray(np.clip(y, 0, 255))
    out[h:2 * h, w:2 * w] = gray(np.clip(cb, 0, 255))
    out[h:2 * h, 2 * w:] = gray(np.clip(cr, 0, 255))
    out[2 * h:, :w] = gray(np.clip(y, 0, 255))
    out[2 * h:, w:2 * w] = gray(np.clip(up(cb_s), 0, 255))
    out[2 * h:, 2 * w:] = gray(np.clip(up(cr_s), 0, 255))
    return out
