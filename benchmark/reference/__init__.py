"""The benchmark's plain reference: baseline JPEG in NumPy.

``jpeg`` encodes (color, subsampling, DCT, quantization, symbols, K.2 or
K.3 tables, packing, JFIF), ``decode`` parses and entropy-decodes a file
and reconstructs its pixels, and ``check`` holds what the program under
test produced against both.  The arithmetic is frozen copies of the
project's golden encoder and decoder (noted at each function); nothing
here imports ``jax``, ``jpeg_tpu`` or ``jpeg_tpu_torch``, and nothing
reads a table, a file or a tensor that the program made, except the
outputs being judged.
"""
