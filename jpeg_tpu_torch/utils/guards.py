"""Argument checks and numeric sanitizers: the port of
``jpeg_tpu.utils.guards`` (which runs the sanitizers through
``checkify``), plus the decode entry points' ``entropy_engine`` check.

* quantizer entries >= 1: a zero entry turns the quantize divide into
  inf/NaN and silently corrupts the stream;
* DCT outputs finite: catches NaN from a corrupted input or basis;
* pre-clip coefficient magnitude <= 2047: for 8-bit input the
  [-2048, 2047] clip must never engage (the largest DCT magnitude is
  255 * 8 = 2040 at quantizer 1).

Enabled by ``EncodeConfig(debug_checks=True)`` (one extra pass over the
image, in plain torch ops on the image's device, with full-f32 matmuls), or
called directly.  It is a sanitizer, not a stage of the encode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T
from ..ops import color
from ..ops.dct import set_exact_matmul

_MESSAGES = ("quantizer entries must be >= 1 (divide hazard)",
             "non-finite DCT coefficients",
             "coefficient overflow: the [-2048, 2047] clip engaged")


def validate_encode_inputs(rgb, luma_q, chroma_q,
                           sampling: str = "420") -> None:
    """Run the quant-path sanitizers on [..., H, W, 3] u8 ``rgb`` at chroma
    subsampling ``sampling`` ("420", "422" or "444"); raise ValueError
    with the message of the first check that fails (the checks run per
    component, Y then Cb then Cr, each in the order above)."""
    set_exact_matmul()
    rgb = torch.as_tensor(rgb)
    dev = rgb.device
    y, cb, cr = color.rgb_to_ycbcr(rgb.to(torch.uint8), sampling)
    m, bias = T.dct_flat_basis()
    md = torch.from_numpy(np.asarray(m, np.float32)).to(dev)
    bd = torch.from_numpy(np.asarray(bias, np.float32)).to(dev)
    scan = torch.from_numpy(np.asarray(T.SCAN_ORDER, np.int64)).to(dev)
    flags = []
    for plane, q in ((y, luma_q), (cb, chroma_q), (cr, chroma_q)):
        q = torch.as_tensor(np.asarray(q)).to(dev)
        blocks = color.to_blocks(plane)
        x = blocks.reshape(*blocks.shape[:-2], 64).to(torch.float32)
        freq = torch.matmul(x, md.T) + bd
        coef = torch.trunc(freq / q.reshape(64)[scan].to(torch.float32))
        flags += [(q >= 1).all(), torch.isfinite(freq).all(),
                  (coef.abs() <= float(T.COEF_CLIP_MAX)).all()]
    ok = torch.stack(flags).cpu().tolist()  # one sync for every check
    for i, passed in enumerate(ok):
        if not passed:
            raise ValueError(_MESSAGES[i % 3])


ENTROPY_ENGINES = ("auto", "host", "device")


def check_entropy_engine(entropy_engine: str) -> None:
    """Raise ValueError (``jpeg_tpu``'s message) for an unknown engine."""
    if entropy_engine not in ENTROPY_ENGINES:
        raise ValueError(f"unknown entropy_engine {entropy_engine!r}")
