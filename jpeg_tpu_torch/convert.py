"""Carry a ``jpeg_tpu`` encoder's state across to the port.

``constants_from_jax`` takes the constants of a
``jpeg_tpu.pipelines.fast.FastBatchEncoder`` as numpy arrays (fetch them
with ``np.asarray``; this module imports neither jax nor ``jpeg_tpu``) and
returns the tensors that ``jpeg_tpu_torch.FastBatchEncoder(constants=...)``
takes, so both encoders provably compute from the same tables.
``tables_from_jax`` turns ``jpeg_tpu``'s per-image Huffman tables into the
port's, so the two encoders' dynamic tables can be compared as state.
"""
from __future__ import annotations

import numpy as np
import torch

from .huffman.build import HuffmanTable

# jpeg_tpu attribute -> (port key, shape, dtype)
_FIELDS = {
    "_dct_m": ("m", (64, 64), np.float32),
    "_dct_bias": ("bias", (64,), np.float32),
    "_ql_zz": ("ql", (64,), np.float32),
    "_qc_zz": ("qc", (64,), np.float32),
    "_fixed_lut": ("lut", (1024,), np.int32),
}
# a dynamic-mode encoder has no fixed LUT
_OPTIONAL = ("_fixed_lut",)


def constants_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """{``_dct_m``, ``_dct_bias``, ``_ql_zz``, ``_qc_zz``[, ``_fixed_lut``]}
    numpy arrays -> {``m``, ``bias``, ``ql``, ``qc``[, ``lut``]} CPU
    tensors.

    ``_fixed_lut`` is absent for a dynamic-mode encoder, and then so is
    ``lut``.  Raises if another key is missing or an array has another
    shape or dtype.
    """
    out = {}
    for name, (key, shape, dtype) in _FIELDS.items():
        if name not in arrays:
            if name in _OPTIONAL:
                continue
            raise KeyError(f"missing jpeg_tpu constant {name!r}")
        a = np.asarray(arrays[name])
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype}{list(a.shape)}, expected "
                             f"{np.dtype(dtype)}{list(shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return out


def tables_from_jax(tables: dict) -> dict[str, HuffmanTable]:
    """One image's ``jpeg_tpu`` tables {luma_dc, luma_ac, chroma_dc,
    chroma_ac} (objects with numpy ``bits``, ``huffval``, ``code`` and
    ``length``) -> the port's ``HuffmanTable``s, as int32 copies."""
    return {name: HuffmanTable(
                **{f: np.asarray(getattr(t, f), dtype=np.int32).copy()
                   for f in ("bits", "huffval", "code", "length")})
            for name, t in tables.items()}
