"""Image resize/pad utility (reference U5, ``utils/editimage.c``).

The port's own copy of ``jpeg_tpu.io.editimage`` (numpy only; outputs
equal the original's, ``tests/test_torch_host.py``).  The encoders' errors
for dimensions off whole MCUs point here (or at ``encode_any``).

Crops or white-pads (0xFF, ``utils/editimage.c:165-183``) an RGB image to
target dimensions — the tool the reference uses to make fixtures whose
dims are multiples of 16 (the encoder's window constraint,
``utils/original.c:327-331``).
"""
from __future__ import annotations

import numpy as np

PAD_VALUE = 0xFF


def resize_pad(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Crop and/or pad ``image`` to exactly [height, width, 3].

    Content is anchored at the top-left, padding is white — matching
    ``createImmage`` (``utils/editimage.c:154-186``).
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    out = np.full((height, width, 3), PAD_VALUE, dtype=np.uint8)
    ch, cw = min(h, height), min(w, width)
    out[:ch, :cw] = image[:ch, :cw]
    return out


def pad_to_multiple(image: np.ndarray, multiple: int = 16) -> np.ndarray:
    """Pad up to the next multiple of ``multiple`` in both dims."""
    h, w = image.shape[:2]
    return resize_pad(image,
                      -(-w // multiple) * multiple,
                      -(-h // multiple) * multiple)


def pad_replicate(image: np.ndarray, multiple: int = 16) -> np.ndarray:
    """Edge-replicating pad to the next ``multiple`` in both dims.

    The standard JPEG treatment of partial MCUs (the replicated content
    compresses to almost nothing and never shows: the SOF dims stay at the
    true size, so decoders crop it).  The reference has no equivalent —
    it simply rejects non-multiple dims (``utils/original.c:327-331``).
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if not (ph or pw):
        return image
    return np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
