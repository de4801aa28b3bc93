"""Batched interleaved encoder: the port of ``jpeg_tpu.pipelines.fast``.

``FastBatchEncoder`` serves the fixed-table, f32, 4:2:0 interleaved batch
encode.  The device step is four kernels (``kernels.front`` A,
``kernels.fused`` B, C, D): u8 pixels -> coefficients -> Huffman fields ->
block bit offsets -> packed words.  Then the host fetches the used word
prefix and ``jpeg_tpu.native.assemble_interleaved`` writes the files.

A restart segment is a contiguous range of MCU rows, so a batch of
``B`` images with ``S`` segments each is ``B * S`` segments in a row; the
TPU's slab padding, pseudo-segments and phantom blocks have no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu import native
from jpeg_tpu.bitstream import jfif
from jpeg_tpu.core import tables as T
from jpeg_tpu.core.types import EncodeConfig
from jpeg_tpu.huffman.build import fixed_tables

from ..kernels import fused, front
from ..kernels.lut import build_combined_lut
from ..ops import pack as ops_pack
from ..ops.color import PERIOD

_MCU = 16  # 4:2:0 MCUs are 16x16 pixels


def host_constants(quality: int | None) -> dict[str, np.ndarray]:
    """The encode's tables, as ``jpeg_tpu``'s FastBatchEncoder builds them.

    ``m``/``bias``: the zig-zag flat DCT basis and its level-shift bias;
    ``ql``/``qc``: the zig-zag luma/chroma quantizers; ``lut``: the
    combined fixed-table Huffman LUT.
    """
    luma_q, chroma_q = T.quant_tables(quality)
    scan = np.asarray(T.SCAN_ORDER)
    m, bias = T.dct_flat_basis()
    return {"m": m.astype(np.float32), "bias": bias.astype(np.float32),
            "ql": luma_q.reshape(64)[scan].astype(np.float32),
            "qc": chroma_q.reshape(64)[scan].astype(np.float32),
            "lut": build_combined_lut(fixed_tables())}


class FastBatchEncoder:
    """Single-device batched interleaved encoder on four CUDA kernels.

    ``device`` is where the step runs: a CUDA device launches the kernels,
    ``"cpu"`` runs their plain twins.  ``constants`` (optional) replaces
    the tables built from ``config`` with those of another encoder (see
    ``convert.constants_from_jax``); its quantizers must match the
    config's, since the file headers carry the config's tables.
    """

    def __init__(self, height: int, width: int,
                 config: EncodeConfig | None = None,
                 segs_per_image: int | None = None,
                 device: str | torch.device = "cuda",
                 constants: dict[str, torch.Tensor] | None = None):
        self.config = config or EncodeConfig(scan_layout="interleaved",
                                             huffman="fixed")
        if self.config.scan_layout != "interleaved":
            raise ValueError("FastBatchEncoder is interleaved-only")
        if self.config.subsampling != "420":
            raise NotImplementedError(
                f"subsampling={self.config.subsampling!r} is not ported yet "
                f"(ROADMAP queue 1 item 3, main-path geometries: 4:2:2 and "
                f"4:4:4)")
        if self.config.huffman != "fixed":
            raise NotImplementedError(
                f"huffman={self.config.huffman!r} is not ported yet "
                f"(ROADMAP queue 1 item 4, dynamic tables)")
        if self.config.dtype != "float32":
            raise NotImplementedError(
                f"dtype={self.config.dtype!r} is not ported yet "
                f"(ROADMAP queue 1 item 5, f64 exact mode)")
        if height % _MCU or width % _MCU:
            raise ValueError(f"dimensions must be multiples of "
                             f"{_MCU}x{_MCU}, got {width}x{height}")
        self.height, self.width = height, width
        self.mcus_x, self.mcus_y = width // _MCU, height // _MCU
        nm = self.mcus_x * self.mcus_y
        if segs_per_image is None:
            rows = self.config.restart_interval_mcu_rows or self.mcus_y
            if self.mcus_y % rows:
                raise ValueError(
                    f"restart_interval_mcu_rows={rows} must divide "
                    f"MCU rows {self.mcus_y}")
            segs_per_image = self.mcus_y // rows
        if nm % segs_per_image or (self.mcus_y % segs_per_image):
            raise ValueError(f"segs_per_image={segs_per_image} must divide "
                             f"MCU rows {self.mcus_y}")
        self.n_segs = segs_per_image
        self.mcus_per_segment = nm // segs_per_image
        self.blocks_per_seg = self.mcus_per_segment * PERIOD
        self.seg_rows = ops_pack.rows_per_segment(self.blocks_per_seg * 64)
        if self.seg_rows * 128 * 32 >= 2 ** 31:
            raise ValueError("segment space exceeds int32 bit offsets")
        self.device = torch.device(device)

        self._luma_q, self._chroma_q = T.quant_tables(self.config.quality)
        host = host_constants(self.config.quality)
        if constants is not None:
            for key in ("ql", "qc"):
                if not np.array_equal(constants[key].cpu().numpy(),
                                      host[key]):
                    raise ValueError(f"constants[{key!r}] does not match "
                                     f"quality={self.config.quality}")
            consts = {k: constants[k].to(self.device) for k in host}
        else:
            consts = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}
        self._m, self._bias = consts["m"], consts["bias"]
        self._ql, self._qc = consts["ql"], consts["qc"]
        self._lut = consts["lut"]
        interval = self.mcus_per_segment if self.n_segs > 1 else 0
        self._header = jfif.headers(
            self.width, self.height, self._luma_q, self._chroma_q,
            fixed_tables(), restart_interval=interval, y_sampling=(2, 2)
        ) + jfif.sos_header_interleaved()

    # -- public API ----------------------------------------------------------

    def step(self, rgbs):
        """Device step: batch -> (words [B, S, seg_rows*128] uint32,
        total_bits [B, S] int32), both on ``self.device``."""
        x = self._check_batch(rgbs)
        B, S = x.shape[0], self.n_segs
        coef = front.front_dct(x, self._m, self._bias, self._ql, self._qc)
        coef = coef.view(B * S, self.blocks_per_seg, 64)
        value, nbits, bits = fused.symbolize_bits(coef, self._lut)
        offs, totals = fused.segment_offsets(bits)
        words = fused.place(value, nbits, offs, self.seg_rows * 128)
        return words.view(B, S, -1), totals.view(B, S)

    def encode_batch(self, rgbs) -> list[bytes]:
        """Batch of [B, H, W, 3] (or [B, H, W*3]) u8 images -> JPEG files."""
        words, totals = self.step(rgbs)
        totals_np = totals.cpu().numpy()
        # fetch only the used prefix of every segment's words
        used = (int(totals_np.max(initial=0)) + 31) // 32 + 1
        cap = min(used, words.shape[-1])
        words_np = words[:, :, :cap].cpu().numpy()
        B = words_np.shape[0]
        files = native.assemble_interleaved(
            words_np.reshape(B * self.n_segs, cap), totals_np.reshape(-1),
            [self._header] * B, self.n_segs)
        if files is None:
            raise RuntimeError("jpeg_tpu.native is unavailable (its host "
                               "library failed to build); the port has no "
                               "other file assembly")
        return files

    # -- helpers -------------------------------------------------------------

    def _check_batch(self, rgbs) -> torch.Tensor:
        """Validate a [B, H, W, 3] or [B, H, W*3] batch -> [B, H, W*3] u8
        contiguous on ``self.device``."""
        if isinstance(rgbs, np.ndarray):
            rgbs = torch.from_numpy(np.ascontiguousarray(rgbs))
        rgbs = torch.as_tensor(rgbs)
        if rgbs.dtype != torch.uint8:
            rgbs = rgbs.to(torch.uint8)
        flat = (self.height, self.width * 3)
        if tuple(rgbs.shape[1:]) != flat:
            if tuple(rgbs.shape[1:]) != (self.height, self.width, 3):
                raise ValueError(f"batch shape {tuple(rgbs.shape)} != "
                                 f"{self.height}x{self.width}")
            rgbs = rgbs.reshape(rgbs.shape[0], *flat)
        return rgbs.to(self.device).contiguous()
