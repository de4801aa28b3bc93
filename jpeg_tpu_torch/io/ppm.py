"""PPM (P6) image I/O.

The port's own copy of ``jpeg_tpu.io.ppm`` (numpy only; the same parser
and writer, ``tests/test_torch_host.py`` holds them equal).  Capability
parity with the reference's PPM handling
(``utils/original.c:293-363`` read, ``utils/editimage.c:52-123`` read,
``main/brain.c:21`` write).  Returns/accepts HxWx3 uint8 RGB arrays.
"""
from __future__ import annotations

import io as _io

import numpy as np


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM with maxval 255 into an [H, W, 3] uint8 array.

    Accepts the same header shapes as the reference parser
    (``utils/original.c:293-331``): magic 'P6', optional '#' comment lines,
    'width height', then maxval.
    """
    with open(path, "rb") as f:
        data = f.read()
    return parse_ppm(data)


def parse_ppm(data: bytes) -> np.ndarray:
    f = _io.BytesIO(data)
    magic = f.readline().strip()
    if magic != b"P6":
        raise ValueError(f"not a P6 PPM (magic={magic!r})")

    def next_token_line() -> bytes:
        while True:
            line = f.readline()
            if not line:
                raise ValueError("truncated PPM header")
            if line.startswith(b"#") or not line.strip():
                continue
            return line

    fields: list[int] = []
    while len(fields) < 3:
        fields.extend(int(tok) for tok in next_token_line().split())
    width, height, maxval = fields[:3]
    if maxval != 255:
        raise ValueError(f"only maxval 255 supported (got {maxval})")
    raw = f.read(3 * width * height)
    if len(raw) != 3 * width * height:
        raise ValueError("truncated PPM pixel data")
    return np.frombuffer(raw, dtype=np.uint8).reshape(height, width, 3).copy()


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 RGB array as binary P6."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {image.shape}")
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(image.tobytes())
