"""The work of a whole device encode or decode, and the card's peaks.

A roofline share here is the least time the card could take for the work
of the profiled calls, over the summed time of their compute kernels.
The work is counted from the cell's inputs and outputs alone, never per
kernel, so a change that fuses, splits or replaces kernels is read
against the same work:

* bytes: every input byte read once and every output byte written once.
  Encode reads the RGB frames and writes each segment's stream words and
  bit total, and in the dynamic modes each image's symbol histogram
  (1024 int32).  Decode reads the entropy-coded bytes and writes RGB.
* operations: the separable 8x8 DCT or IDCT, 8 x 8 x 8 multiply-adds a
  pass and two passes a block: 2048 a block.

The least time is the larger of bytes over the HBM rate and operations
over the float32 rate outside the tensor cores.
"""
from __future__ import annotations

import numpy as np

# NVIDIA's H100 SXM5 data sheet, at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flop_per_s": 67e12},
}
FLOPS_PER_BLOCK = 2 * 8 * 8 * 8 * 2
HIST_BYTES = 1024 * 4


def blocks_420(h: int, w: int) -> int:
    """8x8 blocks of a 4:2:0 frame: the Y plane's and two quarter-size
    chroma planes'."""
    return (h * w) // 64 * 3 // 2


def entropy_bytes(data: bytes) -> list[int]:
    """The entropy-coded bytes of each restart segment of a baseline file,
    without stuffing, markers, or the headers before SOS."""
    body = np.frombuffer(data, np.uint8)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + ((data[sos + 2] << 8) | data[sos + 3])
    body = body[start:]
    ff = np.nonzero(body[:-1] == 0xFF)[0]
    nxt = body[ff + 1]
    marks = ff[(nxt != 0x00) & (nxt != 0xFF)].tolist()
    stuffed = ff[nxt == 0x00]
    out, lo = [], 0
    for m in marks:
        out.append(m - lo - int(((stuffed >= lo) & (stuffed < m)).sum()))
        lo = m + 2
        if body[m + 1] == 0xD9:
            break
    return out


def encode_work(shape: tuple[int, int], files: list[bytes],
                dynamic: bool) -> tuple[int, int]:
    """(bytes, flops) of the device encode of ``files``' frames of
    ``shape`` (H, W)."""
    h, w = shape
    nbytes = flops = 0
    for data in files:
        segs = entropy_bytes(data)
        nbytes += h * w * 3 + sum(-(-n // 4) * 4 + 4 for n in segs)
        nbytes += HIST_BYTES if dynamic else 0
        flops += blocks_420(h, w) * FLOPS_PER_BLOCK
    return nbytes, flops


def decode_work(files: list[bytes], shapes: list[tuple[int, int]]
                ) -> tuple[int, int]:
    """(bytes, flops) of the device decode of ``files`` to RGB frames of
    ``shapes``."""
    nbytes = sum(sum(entropy_bytes(d)) for d in files)
    nbytes += sum(h * w * 3 for h, w in shapes)
    flops = sum(blocks_420(h, w) for h, w in shapes) * FLOPS_PER_BLOCK
    return nbytes, flops


def least_seconds(nbytes: int, flops: int, device: str) -> float | None:
    """The least time for this work on ``device``; None for a card the
    table does not hold."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    return max(nbytes / peak["hbm_bytes_per_s"],
               flops / peak["fp32_flop_per_s"])
