"""PyTorch / CUDA port of the jpeg_tpu batch encoder.

``FastBatchEncoder`` serves the f32, 4:2:0, interleaved-scan batch encode
with fixed (T.81 Annex K.3), dynamic and dynamic-sampled Huffman tables,
and gives byte-identical JPEG files to
``jpeg_tpu.pipelines.fast.FastBatchEncoder``.  On a CUDA device every step
from u8 pixels to packed words runs in the hand-written kernels under
``csrc/``; on the CPU the same steps run their plain PyTorch twins.

The package imports neither ``jax`` nor anything of ``jpeg_tpu``: it keeps
its own copies of the host code it needs (``core``, ``huffman``,
``bitstream``, ``golden`` and the C++ runtime under ``native``).
"""
from .core.types import EncodeConfig  # noqa: F401
from .pipelines.fast import FastBatchEncoder  # noqa: F401

__all__ = ["EncodeConfig", "FastBatchEncoder"]
