"""Kernel D's contract, witnessed on the CPU: every consumer of the words
buffer reads only each segment's stream.

On the card ``fused.place`` writes the words ``[0, ceil(totals / 32))``
of each segment and leaves the rest of its worst-case buffer as it found
it; its plain twin gives 0s there.  Here ``fused.place`` is wrapped so
that every word past each stream is 0xFFFFFFFF, and each encoder that
packs through D (``FastBatchEncoder`` fixed and dynamic, with restart
segments; the 3-scan ``JpegEncoder.encode``; ``encode_gray``; the f64
exact mode's K13 route) must give the same files as without the wrapper.
No jax here."""
import numpy as np
import pytest
import torch

from jpeg_tpu_torch import (EncodeConfig, FastBatchEncoder, JpegEncoder,
                            encode_gray)
from jpeg_tpu_torch.kernels import fused

H = W = 64


def _images(seed: int) -> np.ndarray:
    """[2, 64, 64, 3] u8: a gradient, a block and noise per image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.empty((2, H, W, 3), np.uint8)
    for i in range(2):
        img = np.stack([xx * 3 + 20 * i, yy * 3, (xx + yy) * 2], -1)
        img[10:30, 20:50] = rng.integers(0, 256, 3)
        img = img + rng.normal(0, 8, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def _poison_past_streams(monkeypatch) -> list[int]:
    """Wrap ``fused.place`` so that the words past every stream are all
    ones; returns the list of the words each call poisoned."""
    real = fused.place
    poisoned = []

    def place(value, nbits, offs, totals, seg_words, out=None):
        words = real(value, nbits, offs, totals, seg_words, out)
        n = (totals.to(torch.int64) + 31) // 32
        past = torch.arange(seg_words)[None] >= n[:, None]
        words.view(torch.int32)[past] = -1
        poisoned.append(int(past.sum()))
        return words

    monkeypatch.setattr(fused, "place", place)
    return poisoned


def _interleaved(huffman: str, dtype: str = "float32"):
    cfg = EncodeConfig(scan_layout="interleaved", huffman=huffman,
                       dtype=dtype, restart_interval_mcu_rows=2)
    return lambda imgs: FastBatchEncoder(H, W, cfg,
                                         device="cpu").encode_batch(imgs)


def _3scan(huffman: str):
    cfg = EncodeConfig(huffman=huffman)
    return lambda imgs: [JpegEncoder(cfg, device="cpu").encode(img)
                         for img in imgs]


def _gray(huffman: str):
    cfg = EncodeConfig(huffman=huffman)
    return lambda imgs: [encode_gray(np.ascontiguousarray(img[..., 1]), cfg,
                                     device="cpu") for img in imgs]


@pytest.mark.parametrize("encode", [
    pytest.param(_interleaved("fixed"), id="fast-fixed"),
    pytest.param(_interleaved("dynamic"), id="fast-dynamic"),
    pytest.param(_3scan("dynamic"), id="3scan-dynamic"),
    pytest.param(_3scan("fixed"), id="3scan-fixed"),
    pytest.param(_gray("dynamic"), id="gray"),
    pytest.param(_interleaved("fixed", "float64"), id="f64-k13"),
])
def test_files_ignore_words_past_the_streams(monkeypatch, encode):
    imgs = _images(61)
    want = encode(imgs)
    poisoned = _poison_past_streams(monkeypatch)
    got = encode(imgs)
    assert poisoned and min(poisoned) > 0  # every call had words past
    assert got == want
