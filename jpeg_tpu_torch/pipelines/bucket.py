"""Mixed-resolution batch encoding by geometry buckets: the port of
``jpeg_tpu.pipelines.bucket``.

A mixed list is grouped by (height, width): one cached
``FastBatchEncoder`` per geometry, each group encoded as one batch.
``encode`` takes images that are whole MCUs of the sampling;
``encode_any`` pads any image to its MCU grid by edge replication and
declares the true size in the SOF.  Files come back in input order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bitstream import jfif
from ..core.types import EncodeConfig
from ..ops.color import SAMPLING_GEOMETRY
from .encode import _device
from .fast import FastBatchEncoder


class BucketedEncoder:
    """Encode lists of same-or-mixed-resolution images.

    ``device`` is where the work runs: a CUDA device launches the kernels
    (and must exist), ``"cpu"`` runs their plain twins.
    """

    def __init__(self, config: EncodeConfig | None = None,
                 segs_per_image: int | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or EncodeConfig(scan_layout="interleaved",
                                             huffman="fixed")
        self.segs_per_image = segs_per_image
        self.device = _device(device)
        self._encoders: dict[tuple[int, int], FastBatchEncoder] = {}

    def _encoder(self, h: int, w: int) -> FastBatchEncoder:
        if (h, w) not in self._encoders:
            segs = self.segs_per_image
            if segs is None:
                # the config's restart rows, if they divide the MCU rows
                my = h // SAMPLING_GEOMETRY[self.config.subsampling][1]
                rows = self.config.restart_interval_mcu_rows or my
                segs = my // rows if my % rows == 0 else 1
            # jpeg_tpu's rule, kept byte for byte: it counts 16-px rows at
            # every sampling, so at 4:2:2 and 4:4:4 it can cut the
            # segments the config asked for
            while (h // 16) % segs:
                segs -= 1
            self._encoders[h, w] = FastBatchEncoder(
                h, w, config=self.config, segs_per_image=segs,
                device=self.device)
        return self._encoders[h, w]

    def encode(self, images) -> list[bytes]:
        """Encode a mixed-geometry list of [H, W, 3] u8 images; output
        order matches input."""
        mcu_w, mcu_h, _ = SAMPLING_GEOMETRY[self.config.subsampling]
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            if h % mcu_h or w % mcu_w:
                raise ValueError(
                    f"image {i} is {w}x{h}; pad with io.editimage first, "
                    "or use encode_any")
            buckets.setdefault((h, w), []).append(i)

        out: list[bytes | None] = [None] * len(images)
        for (h, w), idxs in buckets.items():
            batch = np.stack([_host(images[i]) for i in idxs])
            files = self._encoder(h, w).encode_batch(batch)
            for i, data in zip(idxs, files):
                out[i] = data
        return out  # type: ignore[return-value]

    def encode_any(self, images) -> list[bytes]:
        """Ragged list: arbitrary dims, padded and bucketed.

        Each image is edge-replicated up to its minimal MCU grid and its
        SOF declares the true size (decoders crop, T.81 A.2.1); images
        that share an MCU grid share one encoder.  Padding cannot go past
        the minimal grid: T.81 A.2 derives the coded MCU count from the
        SOF dims.  Output order matches input.
        """
        mcu_w, mcu_h, _ = SAMPLING_GEOMETRY[self.config.subsampling]
        padded, dims = [], []
        for img in images:
            img = _host(img)
            h, w = img.shape[:2]
            if h == 0 or w == 0:
                raise ValueError("image has zero pixels")
            ph, pw = -(-h // mcu_h) * mcu_h, -(-w // mcu_w) * mcu_w
            dims.append((h, w, ph, pw))
            if (ph, pw) != (h, w):
                img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)),
                             mode="edge")
            padded.append(img)
        out = self.encode(padded)
        return [jfif.patch_sof_dims(data, w, h) if (ph, pw) != (h, w)
                else data
                for data, (h, w, ph, pw) in zip(out, dims)]


def _host(img) -> np.ndarray:
    """An image as a host array (a tensor is copied from its device)."""
    return img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
