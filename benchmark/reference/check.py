"""The comparisons that decide ``correct``.

Each returns the numbers it compares, by name; ``judge`` sets them beside
their limits.  What is judged is the program's output only: its files or
its pixels.  The reference works everything else out again from the
inputs the benchmark made.
"""
from __future__ import annotations

import numpy as np

from . import decode as D
from . import jpeg as R


def encode_numbers(samples, huffman: str, restart_rows: int = 0,
                   quality: int | None = None) -> dict:
    """``samples``: (input [H, W, 3] u8, the file the program returned
    for it).  Numbers:

    * ``bad_files``: files that do not decode, are of another size, or
      are not exactly what the reference's own entropy coder, tables
      (K.3, or K.2 of the file's own symbol counts) and JFIF writer make
      of the coefficients they carry;
    * ``worst_coef_diff_share``: over the files, the largest share of
      quantized coefficients that differ from the reference's forward
      transform of the input (color, 4:2:0, DCT, quantization) in
      float64.
    """
    bad, worst = 0, 0.0
    for rgb, data in samples:
        ref = R.forward(rgb, quality=quality)
        h, w, _ = rgb.shape
        try:
            got, info = D.coefficients(data)
            if (info["width"], info["height"]) != (w, h):
                raise D.Corrupt("another size")
        except D.Corrupt:
            bad += 1
            worst = 1.0
            continue
        if R.encode_coefs(*got, w, h, huffman, restart_rows, quality) != data:
            bad += 1
        diff = sum(int((g != r).sum()) for g, r in zip(got, ref))
        worst = max(worst, diff / sum(r.size for r in ref))
    return {"bad_files": bad, "worst_coef_diff_share": worst}


def decode_numbers(samples) -> dict:
    """``samples``: (a file's coefficients and parsed header, as the
    benchmark's encoder made it; the image the program returned for it).
    Numbers:

    * ``bad_images``: images missing, or of another shape or type;
    * ``worst_px_over2_share``: over the images, the largest share of
      pixel values more than 2 away from the reference's reconstruction
      (dequantize, IDCT, upsample, color) in float64.  Not 1: where a
      flat chroma block's IDCT lands on an exact .5, float32 and float64
      round it apart, and the whole flat region's blue (1.772 x 1) and
      red (1.402 x 1) then differ by 2;
    * ``worst_mean_abs_diff``: over the images, the largest mean of
      |program - reference| over an image's values.  It catches what the
      share above lets through: a decoder off by 1 or 2 levels on every
      value (truncating where it should round, a +0.5 dropped).
    """
    bad, worst, worst_mean = 0, 0.0, 0.0
    for coefs, info, got in samples:
        want = D.pixels(coefs, info)
        if got is None or got.shape != want.shape or got.dtype != np.uint8:
            bad += 1
            worst = 1.0
            continue
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, float((diff > 2).mean()))
        worst_mean = max(worst_mean, float(diff.mean()))
    return {"bad_images": bad, "worst_px_over2_share": worst,
            "worst_mean_abs_diff": worst_mean}


def judge(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """Every number at or under its limit -> (correct, one line each:
    name, number, limit)."""
    lines, ok = [], True
    for name, value in numbers.items():
        limit = limits[name]
        ok &= value <= limit
        lines.append(f"{name} {value!r} limit {limit!r}")
    return ok, lines
