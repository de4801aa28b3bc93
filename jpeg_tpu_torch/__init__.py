"""PyTorch / CUDA port of the jpeg_tpu batch encoder.

``FastBatchEncoder`` serves the fixed-table (T.81 Annex K.3), f32, 4:2:0,
interleaved-scan batch encode and gives byte-identical JPEG files to
``jpeg_tpu.pipelines.fast.FastBatchEncoder``.  On a CUDA device every step
from u8 pixels to packed words runs in the hand-written kernels under
``csrc/``; on the CPU the same steps run their plain PyTorch twins.

The package never imports ``jax``: it reuses only the numpy host modules
of ``jpeg_tpu`` (tables, Huffman tables, JFIF headers, native assembly).
"""
from jpeg_tpu.core.types import EncodeConfig  # noqa: F401

from .pipelines.fast import FastBatchEncoder  # noqa: F401

__all__ = ["EncodeConfig", "FastBatchEncoder"]
