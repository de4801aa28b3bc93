"""Carry a ``jpeg_tpu`` encoder's device constants across to the port.

``constants_from_jax`` takes the constants of a
``jpeg_tpu.pipelines.fast.FastBatchEncoder`` as numpy arrays (fetch them
with ``np.asarray``; this module never imports jax) and returns the
tensors that ``jpeg_tpu_torch.FastBatchEncoder(constants=...)`` takes, so
both encoders provably compute from the same tables.
"""
from __future__ import annotations

import numpy as np
import torch

# jpeg_tpu attribute -> (port key, shape, dtype)
_FIELDS = {
    "_dct_m": ("m", (64, 64), np.float32),
    "_dct_bias": ("bias", (64,), np.float32),
    "_ql_zz": ("ql", (64,), np.float32),
    "_qc_zz": ("qc", (64,), np.float32),
    "_fixed_lut": ("lut", (1024,), np.int32),
}


def constants_from_jax(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """{``_dct_m``, ``_dct_bias``, ``_ql_zz``, ``_qc_zz``, ``_fixed_lut``}
    numpy arrays -> {``m``, ``bias``, ``ql``, ``qc``, ``lut``} CPU tensors.

    Raises if a key is missing or an array has another shape or dtype.
    """
    out = {}
    for name, (key, shape, dtype) in _FIELDS.items():
        if name not in arrays:
            raise KeyError(f"missing jpeg_tpu constant {name!r}")
        a = np.asarray(arrays[name])
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype}{list(a.shape)}, expected "
                             f"{np.dtype(dtype)}{list(shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return out
