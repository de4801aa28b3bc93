"""Reusable and one-shot encoders: the port of ``jpeg_tpu.pipelines.encode``.

``JpegEncoder`` (``encode``, ``encode_batch``, ``encode_any``,
``encode_region``), ``encode_jpeg`` and ``encode_gray`` serve 4:2:0, 4:2:2
and 4:4:4 (``encode_gray``: one component) in both scan layouts, with
fixed, dynamic and dynamic-sampled tables, any quality and restart
intervals, in f32 and in the f64 exact mode, and give ``jpeg_tpu``'s bytes
(f64: those of ``jpeg_tpu``'s un-jitted f64 path, at 4:2:0 the golden
encoder's too).  Images are whole MCUs of the sampling (16x16, 16 wide x
8 high, 8x8); ``encode_any`` pads to them.

* ``"3scan"`` (the reference's three single-component scans): kernel A
  writes the coefficients in the 3-scan order (``front_dct(order="scan")``),
  so a batch's Y scans are one run of uniform segments and its Cb + Cr
  scans another.  Each stage then runs once per group, B and E with the
  group's single-component layout (``SCAN_Y``, ``SCAN_CHROMA``).
  - fixed tables: A -> B -> C -> D (``kernels.pack.pack_segments``);
  - dynamic tables: A -> E (packed fields; the Cb + Cr launch adds its
    chroma counts to the Y launch's per-image histogram rows) -> one
    histogram fetch -> the native K.2 builds -> LUT upload -> F -> C -> D.
  Then the used words come to the host, ``native.finish_scans`` finalizes
  every segment and ``jfif.assemble_3scan(_restarts)`` writes each file.
  ``"dynamic-sampled"`` builds exact tables here, as in ``jpeg_tpu``.
* ``"interleaved"``: the port's ``FastBatchEncoder``, one per (h, w).  With
  ``engine="xla"`` (the CPU's "auto") ``"dynamic-sampled"`` builds exact
  tables, as ``jpeg_tpu``'s XLA engine does; with ``"pallas"`` (the card's
  "auto") it samples, as its Pallas engine does.

``encode_batch`` runs a whole batch through one launch per stage and group;
its files equal the per-image ``encode`` loop's, since every image keeps
its own tables.

f64 (``dtype="float64"``): the coefficients come from eager torch f64 ops
on the device (``pipelines.fast.exact_coefs``, in the golden encoder's
order) instead of kernel A, in the same 3-scan order; the stages after
them are f32's.  "auto" resolves to the "xla" engine, as in ``jpeg_tpu``,
so "dynamic-sampled" builds exact tables in both layouts; the interleaved
layout runs ``FastBatchEncoder``'s exact mode.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..bitstream import jfif
from ..core import tables as T
from ..core.types import Area, EncodeConfig
from ..huffman.build import build_tables_batch, fixed_tables
from ..kernels import front, fused
from ..kernels import pack as kpack
from ..kernels.lut import build_combined_lut
from ..ops import color, dct
from ..ops import pack as ops_pack
from ..ops.color import SAMPLING_GEOMETRY, SCAN_CHROMA, SCAN_Y, Y_SAMPLING
from .fast import FastBatchEncoder, exact_coefs, host_constants


def _device(device: str | torch.device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (nothing falls
    back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run on the "
                           "card; pass device='cpu' for the plain twins")
    return dev


class _ScanGeometry(NamedTuple):
    """The restart segments of an image's three scans."""
    n_y: int         # blocks per Y segment
    segs_y: int      # Y segments per image
    n_c: int         # blocks per Cb (and per Cr) segment
    segs_c: int      # Cb (and Cr) segments per image
    interval_y: int  # DRI restart interval of the Y scan (0: no DRI)
    interval_c: int  # ... of the Cb and Cr scans


def _scan_geometry(h: int, w: int, rows: int,
                   sampling: str = "420") -> _ScanGeometry:
    """``restart_interval_mcu_rows=rows`` counts 8-px block rows of each
    component's own grid (0: one segment per scan); the chroma grid is
    the Y grid over the sampling factors."""
    fh, fv = Y_SAMPLING[sampling]
    ch, cw = h // (8 * fv), w // (8 * fh)
    comps = (("y", h // 8, w // 8), ("cb", ch, cw), ("cr", ch, cw))
    for name, bh, _ in comps:
        if rows and bh % rows:
            raise ValueError(
                f"restart_interval_mcu_rows={rows} must divide the "
                f"{name} component's {bh} block rows (3-scan layout)")
    (_, bhy, bwy), (_, bhc, bwc), _ = comps
    ry, rc = rows or bhy, rows or bhc
    segs_y, segs_c = bhy // ry, bhc // rc
    return _ScanGeometry(ry * bwy, segs_y, rc * bwc, segs_c,
                         ry * bwy if segs_y > 1 else 0,
                         rc * bwc if segs_c > 1 else 0)


class JpegEncoder:
    """Reusable encoder on the port's kernels.

    ``device`` is where the work runs: a CUDA device launches the kernels
    (and must exist), ``"cpu"`` runs their plain twins.
    """

    def __init__(self, config: EncodeConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or EncodeConfig()
        self.device = _device(device)
        self._luma_q, self._chroma_q = T.quant_tables(self.config.quality)
        self._fixed = (fixed_tables() if self.config.huffman == "fixed"
                       else None)
        host = host_constants(self.config.quality)
        self._c = {k: torch.from_numpy(v).to(self.device)
                   for k, v in host.items()}
        self._fast_cache: dict[tuple[int, int], FastBatchEncoder] = {}
        self._any_encoder: JpegEncoder | None = None

    # -- helpers -------------------------------------------------------------

    def _resolve_engine(self) -> str:
        """"auto" -> "xla" in f64 exact mode, else "pallas" on a CUDA
        device and "xla" on the CPU (as ``jpeg_tpu``: pallas on its
        accelerator, xla elsewhere)."""
        if self.config.engine != "auto":
            return self.config.engine
        if self.config.dtype == "float64":
            return "xla"
        return "pallas" if self.device.type == "cuda" else "xla"

    def _on_device(self, rgb) -> torch.Tensor:
        if isinstance(rgb, np.ndarray):
            rgb = torch.from_numpy(np.ascontiguousarray(rgb))
        rgb = torch.as_tensor(rgb)
        if rgb.dtype != torch.uint8:
            rgb = rgb.to(torch.uint8)
        return rgb.to(self.device)

    def _mcu(self) -> tuple[int, int]:
        """(width, height) of the sampling's MCU."""
        return SAMPLING_GEOMETRY[self.config.subsampling][:2]

    def _check(self, x: torch.Tensor) -> None:
        """Validate the [..., H, W, 3] image(s) ``x`` as ``encode`` does."""
        h, w = x.shape[-3], x.shape[-2]
        if h == 0 or w == 0:
            raise ValueError("image has zero pixels")
        mcu_w, mcu_h = self._mcu()
        if h % mcu_h or w % mcu_w:
            raise ValueError(
                f"dimensions must be multiples of {mcu_w}x{mcu_h}, got "
                f"{w}x{h}; pad with jpeg_tpu.io.editimage, or use encode_any")
        if self.config.debug_checks:
            from ..utils.guards import validate_encode_inputs
            validate_encode_inputs(x, self._luma_q, self._chroma_q,
                                   sampling=self.config.subsampling)

    def _encode_device(self, x: torch.Tensor) -> list[bytes]:
        """[B, H, W, 3] u8 on ``self.device`` -> B files."""
        B, h, w, _ = x.shape
        x = x.reshape(B, h, w * 3).contiguous()
        if self.config.scan_layout == "interleaved":
            return self._interleaved(h, w).encode_batch(x)
        return self._encode_3scan(x, h, w)

    def _interleaved(self, h: int, w: int) -> FastBatchEncoder:
        """The cached interleaved encoder of an h x w image."""
        if (h, w) not in self._fast_cache:
            cfg = self.config
            xla = self._resolve_engine() == "xla"
            if cfg.huffman == "dynamic-sampled" and xla:
                cfg = dataclasses.replace(cfg, huffman="dynamic")
            rows = cfg.restart_interval_mcu_rows
            my = h // 8
            if xla and cfg.subsampling != "420" and rows and my % rows:
                # the message of jpeg_tpu's XLA engine at 4:2:2 and 4:4:4
                raise ValueError(f"restart_interval_mcu_rows={rows} must "
                                 f"divide 8px MCU rows {my}")
            self._fast_cache[h, w] = FastBatchEncoder(h, w, cfg,
                                                      device=self.device)
        return self._fast_cache[h, w]

    # -- the 3-scan layout ---------------------------------------------------

    def _encode_3scan(self, x: torch.Tensor, h: int, w: int) -> list[bytes]:
        """[B, H, W*3] u8 -> B files of three single-component scans."""
        rows = self.config.restart_interval_mcu_rows
        sampling = self.config.subsampling
        g = _scan_geometry(h, w, rows, sampling)
        B, c = x.shape[0], self._c
        if self.config.dtype == "float64":
            zz_y, zz_cb, zz_cr = exact_coefs(x.view(B, h, w, 3),
                                             self._luma_q, self._chroma_q,
                                             sampling)
            coef = torch.cat([zz_y.reshape(-1, 64),
                              torch.cat([zz_cb, zz_cr], 1).reshape(-1, 64)])
        else:
            coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                                   order="scan", sampling=sampling)
        n_y = B * g.segs_y * g.n_y
        groups = ((coef[:n_y].view(B * g.segs_y, g.n_y, 64), SCAN_Y),
                  (coef[n_y:].view(B * 2 * g.segs_c, g.n_c, 64), SCAN_CHROMA))
        if self._fixed is not None:
            tables = [self._fixed] * B
            fields = [fused.symbolize_bits(cf, c["lut"], layout)
                      for cf, layout in groups]
        else:
            pfs, hist = [], None
            for cf, layout in groups:
                pf, hist = fused.symbolize_fields(cf, B, layout=layout,
                                                  hist=hist)
                pfs.append(pf)
            tables, luts = FastBatchEncoder._build_tables_batch(
                hist.cpu().numpy())
            luts = torch.from_numpy(luts).to(self.device)
            fields = [fused.attach_pf(pf, luts) for pf in pfs]
        scans = []
        for (cf, _), (value, nbits, bits) in zip(groups, fields):
            seg_rows = kpack.rows_per_segment(cf.shape[1] * 64)
            words, totals = kpack.pack_segments(value, nbits, cf.shape[0],
                                                seg_rows, bits)
            scans.append(native.finish_scans(
                *FastBatchEncoder._fetch(words, totals)))
        y_segs, c_segs = scans
        files = []
        for b in range(B):
            header = jfif.headers(w, h, self._luma_q, self._chroma_q,
                                  tables[b], y_sampling=Y_SAMPLING[sampling])
            ys = y_segs[b * g.segs_y:(b + 1) * g.segs_y]
            cb = c_segs[2 * b * g.segs_c:(2 * b + 1) * g.segs_c]
            cr = c_segs[(2 * b + 1) * g.segs_c:(2 * b + 2) * g.segs_c]
            if rows:
                files.append(jfif.assemble_3scan_restarts(
                    header, [(g.interval_y, ys), (g.interval_c, cb),
                             (g.interval_c, cr)]))
            else:
                files.append(jfif.assemble_3scan(header, ys[0], cb[0],
                                                 cr[0]))
        return files

    # -- public API ----------------------------------------------------------

    def encode(self, rgb) -> bytes:
        """Encode one [H, W, 3] uint8 RGB image to baseline JFIF bytes."""
        x = self._on_device(rgb)
        self._check(x)
        return self._encode_device(x[None])[0]

    def encode_batch(self, rgbs) -> list[bytes]:
        """Encode a [B, H, W, 3] uint8 batch (one shared shape)."""
        x = self._on_device(rgbs)
        if x.shape[0] == 0:
            return []
        self._check(x)
        return self._encode_device(x)

    def encode_any(self, rgb) -> bytes:
        """Encode an image of arbitrary dimensions.

        Pads to full MCUs by edge replication and declares the true size in
        SOF0 (decoders crop, T.81 A.2.1).  When padding is needed the
        interleaved layout is used whatever ``scan_layout`` says, with
        restarts off: non-interleaved scans must carry exactly
        ceil(component_dim / 8) blocks per row (T.81 A.2.2), not the
        MCU-padded count, so a padded 3-scan stream would desync standard
        decoders.
        """
        if not torch.is_tensor(rgb):
            rgb = np.asarray(rgb)
        h, w = rgb.shape[0], rgb.shape[1]
        mcu_w, mcu_h = self._mcu()
        if h % mcu_h == 0 and w % mcu_w == 0:
            return self.encode(rgb)
        enc = self
        if self.config.scan_layout != "interleaved":
            if self._any_encoder is None:
                cfg = dataclasses.replace(self.config,
                                          scan_layout="interleaved",
                                          restart_interval_mcu_rows=0)
                self._any_encoder = JpegEncoder(cfg, device=self.device)
            enc = self._any_encoder
        padded = rgb.cpu().numpy() if torch.is_tensor(rgb) else rgb
        padded = np.pad(padded, ((0, -h % mcu_h), (0, -w % mcu_w), (0, 0)),
                        mode="edge")
        return jfif.patch_sof_dims(enc.encode(padded), w, h)

    def encode_region(self, rgb, area: Area) -> bytes:
        """Encode an ``Area`` window of a larger [H, W, 3] frame as its own
        JPEG; the window is sliced on the device."""
        x = self._on_device(rgb)
        h, w = x.shape[0], x.shape[1]
        if area.x + area.w > w or area.y + area.h > h:
            raise ValueError(f"area {area} exceeds frame {w}x{h}")
        return self.encode(x[area.y:area.y + area.h, area.x:area.x + area.w])


def encode_gray(plane, config: EncodeConfig | None = None,
                device: str | torch.device = "cuda") -> bytes:
    """Encode an [H, W] uint8 grayscale plane as a 1-component JPEG.

    Arbitrary dims are padded to whole 8x8 blocks by edge replication, with
    the true size in SOF0.  The plane is the Y channel as it is (no color
    conversion).  Device path: kernel A's gray mode (f64: the exact DCT in
    torch ops), then B (fixed) or E, the K.2 builds and F (dynamic;
    "dynamic-sampled" builds exact tables), then C and D.
    """
    cfg = config or EncodeConfig()
    dev = _device(device)
    arr = plane.cpu().numpy() if torch.is_tensor(plane) else np.asarray(plane)
    if arr.ndim != 2:
        raise ValueError(f"expected [H, W] grayscale, got shape {arr.shape}")
    h, w = arr.shape
    if h == 0 or w == 0:
        raise ValueError("image has zero pixels")
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    if (ph, pw) != (h, w):
        arr = np.pad(arr, ((0, ph - h), (0, pw - w)), mode="edge")

    luma_q, _ = T.quant_tables(cfg.quality)
    host = host_constants(cfg.quality)
    c = {k: torch.from_numpy(host[k]).to(dev) for k in ("m", "bias", "ql")}
    x = torch.from_numpy(np.ascontiguousarray(arr, np.uint8))[None].to(dev)
    if cfg.dtype == "float64":
        coef = dct.dct_quantize_exact(color.to_blocks(x), luma_q)
    else:
        coef = front.front_dct_gray(x, c["m"], c["bias"], c["ql"])
    if cfg.huffman == "fixed":
        tables = fixed_tables()
        value, nbits, bits = fused.symbolize_bits(
            coef, torch.from_numpy(host["lut"]).to(dev), SCAN_Y)
    else:
        pf, hist = fused.symbolize_fields(coef, 1, layout=SCAN_Y)
        hist = hist.cpu().numpy()[0]
        # the luma AC and DC bins of the combined index; NULL (1023) is
        # never counted
        freqs = np.ones((2, 257), np.int64)
        freqs[0, :256] = hist[768:]
        freqs[1, :256] = hist[512:768]
        dc, ac = build_tables_batch(freqs)
        tables = {"luma_dc": dc, "luma_ac": ac}
        lut = build_combined_lut({**tables, "chroma_dc": dc, "chroma_ac": ac})
        value, nbits, bits = fused.attach_pf(
            pf, torch.from_numpy(lut[None]).to(dev))
    seg_rows = kpack.rows_per_segment(coef.shape[1] * 64)
    words, totals = kpack.pack_segments(value, nbits, 1, seg_rows, bits)
    words_np, totals_np = FastBatchEncoder._fetch(words, totals)
    payload = ops_pack.finish_scan(words_np[0], int(totals_np[0]))
    header = jfif.headers_gray(pw, ph, luma_q, tables)
    data = b"".join([header, jfif.sos_header_single(1, 0, 0), payload,
                     jfif.EOI])
    if (ph, pw) != (h, w):
        data = jfif.patch_sof_dims(data, w, h)
    return data


def encode_jpeg(rgb, config: EncodeConfig | None = None,
                device: str | torch.device = "cuda") -> bytes:
    """One-shot encode of an [H, W, 3] uint8 RGB image."""
    return JpegEncoder(config, device=device).encode(rgb)
