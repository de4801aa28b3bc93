"""Seeded synthetic frames, made in bulk on the device.

The content model is a frozen copy of ``chip_smoke.py::synthetic_batch``
(smooth gradients, six hard-edged flat shapes, light noise): each frame's
frequencies, phases, rectangles and colors are drawn by the same NumPy
calls.  The pixel arithmetic runs in torch on ``device``, and the noise
comes from a ``torch.Generator`` seeded from that NumPy generator, so a
batch of 1920x1280 frames takes milliseconds on the card where the
original takes half a second a frame on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def synthetic_batch(rng: np.random.Generator, b: int, h: int, w: int,
                    device) -> torch.Tensor:
    """[b, h, w, 3] uint8 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    yy, xx = torch.meshgrid(torch.arange(h, device=device,
                                         dtype=torch.float32),
                            torch.arange(w, device=device,
                                         dtype=torch.float32),
                            indexing="ij")
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(b):
        f = rng.uniform(20.0, 90.0, 3)
        ph = rng.uniform(0.0, 6.3, 3)
        img = torch.stack([
            128 + 90 * torch.sin(xx / f[0] + ph[0]) * torch.cos(yy / f[1]),
            128 + 90 * torch.cos((xx + yy) / f[2] + ph[1]),
            255 * (xx + yy) / (w + h),
        ], dim=-1)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 16)
            y1 = min(h, y0 + rng.integers(16, h // 2))
            x1 = min(w, x0 + rng.integers(16, w // 2))
            img[y0:y1, x0:x1] = torch.as_tensor(
                rng.uniform(0, 255, 3), dtype=torch.float32, device=device)
        img += 2.0 * torch.randn(img.shape, generator=gen, device=device)
        out[i] = img.clamp_(0, 255).to(torch.uint8)
    return out


def stamp(batch, counter: int) -> None:
    """Write ``counter`` (and each image's index after it) into the first
    eight bytes of every image of a [B, H, W, 3] batch, so that no two
    batches of a run are equal.  A batch on the card is written by a copy
    on the current stream, so it lands after the work already enqueued
    there that reads the batch."""
    b = batch.shape[0]
    marks = (np.arange(b, dtype=np.int64) + counter * b).view(
        np.uint8).reshape(b, 8)
    if isinstance(batch, np.ndarray):
        batch.reshape(b, -1)[:, :8] = marks
    else:
        batch.view(b, -1)[:, :8].copy_(torch.from_numpy(marks))


def stamped(pool: list[np.ndarray], i: int, j: int) -> np.ndarray:
    """Image ``j`` of batch ``i`` of a stamped cycle over ``pool``, as it
    was handed over."""
    b = pool[i % len(pool)].copy()
    stamp(b, i)
    return b[j]
