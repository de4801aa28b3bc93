"""Batched interleaved encoder: the port of ``jpeg_tpu.pipelines.fast``.

``FastBatchEncoder`` serves the interleaved batch encode at 4:2:0, 4:2:2
and 4:4:4 (``EncodeConfig.subsampling``) with fixed, dynamic and
dynamic-sampled Huffman tables, in f32, and in the f64 exact mode with
fixed and dynamic tables.  The sampling sets the MCU (16x16 of 6 blocks,
16 wide x 8 high of 4, 8x8 of 3: ``ops.color.SAMPLING_GEOMETRY``), kernel
A's color mode and the block layout B and E read; restart intervals
count rows of that MCU.

* Fixed tables: the device step is four kernels (``kernels.front`` A,
  ``kernels.fused`` B, C, D): u8 pixels -> coefficients -> Huffman fields
  -> block bit offsets -> packed words.
* Dynamic tables (per image, as the reference's ``init_huffman``): stage
  1 is A then E (packed symbol fields + per-image histograms); the host
  fetches the histograms (one sync, 4 KB per image) and runs the K.2
  builds; stage 2 is F (attach through each image's LUT) then C and D.

* f64 exact mode (``dtype="float64"``): ``analyze_zz`` (eager torch f64
  ops on the device, in the golden encoder's order) gives the un-diffed
  interleaved coefficients, their DC differences and luma flags; then
  ``kernels.fused.analyze_attach_pack_segments`` (B explicit, C, D) for
  fixed tables, or ``symbolize_segments`` (E explicit) -> the K.2 builds
  -> F, C, D for dynamic ones.  Its bytes equal the golden encoder's.

Then kernel I (``kernels.files.write_files``) writes the files on the
device, each with its own header, back to back in one buffer; the host
fetches their bytes and cuts them apart.

A restart segment is a contiguous range of MCU rows, so a batch of
``B`` images with ``S`` segments each is ``B * S`` segments in a row; the
TPU's slab padding, pseudo-segments and phantom blocks have no
counterpart here.  Nor has its pixel route: where ``jpeg_tpu`` cannot
take its Pallas front (4:4:4 widths that are a multiple of 8 but not of
16), kernel A reads the pixels all the same, with the same bytes.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from ..bitstream import jfif
from ..core import tables as T
from ..core.types import EncodeConfig
from ..huffman.build import HuffmanTable, build_tables_batch, fixed_tables
from ..kernels import files as kfiles
from ..kernels import front, fused
from ..kernels import pack as kpack
from ..kernels.lut import NULL_INDEX, build_combined_lut
from ..ops import color, dct
from ..ops.color import LAYOUTS, SAMPLING_GEOMETRY, Y_SAMPLING
from ..ops.sample import sample_mask
from ..utils.profiling import span


def _possible_symbols():
    """(dc, ac) 0/1 masks of the symbols a baseline stream can emit given
    the [-2048, 2047] coefficient clip: DC classes 0..12 and AC
    (run << 4 | size) with size 1..11, plus EOB (0x00) and ZRL (0xF0)."""
    dc = np.zeros(256, np.int64)
    dc[:13] = 1
    ac = np.zeros(256, np.int64)
    ac[0] = ac[0xF0] = 1
    for run in range(16):
        for size in range(1, 12):
            ac[(run << 4) | size] = 1
    return dc, ac


_DC_POSSIBLE, _AC_POSSIBLE = _possible_symbols()


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


def exact_coefs(rgb: torch.Tensor, luma_q: np.ndarray,
                chroma_q: np.ndarray, sampling: str = "420"):
    """[B, H, W, 3] u8 -> the f64 exact mode's int16 zig-zag coefs of each
    component, (y [B, H/8 * W/8, 64], cb [B, n_chroma_blocks, 64], cr),
    every component's blocks in raster order (the golden encoder's
    stages, at ``sampling``'s chroma grid)."""
    y, cb, cr = color.rgb_to_ycbcr(rgb, sampling, dtype=torch.float64)
    return tuple(dct.dct_quantize_exact(color.to_blocks(plane), q)
                 for plane, q in ((y, luma_q), (cb, chroma_q),
                                  (cr, chroma_q)))


def analyze_zz(rgb: torch.Tensor, luma_q: np.ndarray, chroma_q: np.ndarray,
               mcus_x: int, mcus_y: int, n_segs: int,
               sampling: str = "420"):
    """[B, H, W, 3] u8 -> the f64 exact mode's un-diffed interleaved
    coefficients (the port of ``jpeg_tpu.pipelines.fast.analyze_zz``).

    Returns seq [B * S, nblk, 64] int16 in the interleaved MCU order of
    ``sampling`` (Y blocks, Cb, Cr), dc_diff [B * S, nblk] int32 (each
    component's DC chain restarts in every segment) and is_luma [B * S,
    nblk] int32.
    """
    zz_y, zz_cb, zz_cr = exact_coefs(rgb, luma_q, chroma_q, sampling)
    B, S = zz_y.shape[0], n_segs
    mps = mcus_x * mcus_y // n_segs
    period, ypm = LAYOUTS[sampling]
    y_mcu = zz_y
    if sampling == "420":  # at 4:2:2, 4:4:4 raster order is MCU order
        y_mcu = zz_y.reshape(B, mcus_y, 2, mcus_x, 2, 64).transpose(2, 3)
    parts = [y_mcu.reshape(B, S, mps, ypm, 64),
             zz_cb.reshape(B, S, mps, 1, 64),
             zz_cr.reshape(B, S, mps, 1, 64)]

    def dc_diff_of(part):  # [B, S, mps, k, 64] -> [B, S, mps, k]
        dc = part[..., 0].to(torch.int32).reshape(B, S, -1)
        prev = torch.nn.functional.pad(dc[..., :-1], (1, 0))
        return (dc - prev).reshape(part.shape[:-1])

    seq = torch.cat(parts, dim=3).reshape(B * S, mps * period, 64)
    dc_diff = torch.cat([dc_diff_of(p) for p in parts], dim=3)
    pattern = torch.tensor([1] * ypm + [0] * (period - ypm),
                           dtype=torch.int32, device=seq.device)
    is_luma = pattern.repeat(B * S, mps)
    return seq, dc_diff.reshape(B * S, mps * period), is_luma


class FastBatchEncoder:
    """Single-device batched interleaved encoder on hand-written CUDA
    kernels.

    ``device`` is where the work runs: a CUDA device launches the kernels,
    ``"cpu"`` runs their plain twins.  ``constants`` (optional) replaces
    the tables built from ``config`` with those of another encoder (see
    ``convert.constants_from_jax``); its quantizers must match the
    config's, since the file headers carry the config's tables.  Dynamic
    modes need no ``lut`` in it.
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
        self.sampling = self.config.subsampling
        mcu_w, mcu_h, _ = SAMPLING_GEOMETRY[self.sampling]
        self.layout = LAYOUTS[self.sampling]
        if height % mcu_h or width % mcu_w:
            raise ValueError(f"dimensions must be multiples of "
                             f"{mcu_w}x{mcu_h}, got {width}x{height}")
        self.height, self.width = height, width
        self.mcus_x, self.mcus_y = width // mcu_w, height // mcu_h
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
        self.blocks_per_seg = self.mcus_per_segment * self.layout.period
        self.seg_rows = kpack.rows_per_segment(self.blocks_per_seg * 64)
        if self.seg_rows * 128 * 32 >= 2 ** 31:
            raise ValueError("segment space exceeds int32 bit offsets")
        self.device = torch.device(device)

        self._luma_q, self._chroma_q = T.quant_tables(self.config.quality)
        self._fixed = (fixed_tables() if self.config.huffman == "fixed"
                       else None)
        host = host_constants(self.config.quality)
        if self._fixed is None:
            del host["lut"]
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
        self._lut = consts.get("lut")
        # "dynamic-sampled": the histogram counts jpeg_tpu's sample of
        # blocks (ops.sample), and every possible symbol gets a +1 floor
        self._sampled = self.config.huffman == "dynamic-sampled"
        self._exact = self.config.dtype == "float64"
        if self._sampled and self._exact:
            raise ValueError("dynamic-sampled requires the f32 fast path"
                             " (exact mode exists for byte parity — "
                             "sampling would defeat it)")
        self._mask = (torch.from_numpy(sample_mask(
            self.height, self.width, self.n_segs, self.sampling))
            .to(self.device) if self._sampled else None)
        self._interval = self.mcus_per_segment if self.n_segs > 1 else 0
        self._header = (self._file_header(self._fixed)
                        if self._fixed is not None else None)
        # kernel I's copy of the fixed tables' header, uploaded once
        self._header_dev = (torch.tensor(list(self._header), dtype=torch.uint8,
                                         device=self.device)
                            if self._header is not None else None)

    # -- public API ----------------------------------------------------------

    def step(self, rgbs):
        """Fixed-table device step: batch -> (words [B, S, seg_rows*128]
        uint32, total_bits [B, S] int32), both on ``self.device``."""
        if self._fixed is None:
            raise ValueError("step() requires huffman='fixed'")
        return self._step(self._check_batch(rgbs))

    def _step(self, x: torch.Tensor):
        """``step`` of a checked [B, H, W*3] batch on ``self.device``."""
        return self._fixed_pack(self._analysis(x), x.shape[0])

    def _analysis(self, x: torch.Tensor):
        """A checked [B, H, W*3] batch -> its coefficients: kernel A's
        [B*S, nblk, 64] int16, or in exact mode ``analyze_zz``'s (seq,
        dc_diff, is_luma)."""
        return self._analyze_zz(x) if self._exact else self._coefs(x)

    def _fixed_pack(self, coefs, B: int):
        """Fixed tables: ``_analysis``' output of B images -> (words
        [B, S, seg_rows*128], totals [B, S]); kernels B, C and D, or B
        explicit, C and D."""
        S = self.n_segs
        if self._exact:
            words, totals = fused.analyze_attach_pack_segments(
                self._lut, *coefs, B * S, self.seg_rows)
        else:
            value, nbits, bits = fused.symbolize_bits(coefs, self._lut,
                                                      self.layout)
            words, totals = kpack.pack_segments(value, nbits, B * S,
                                                self.seg_rows, bits)
        return words.view(B, S, -1), totals.view(B, S)

    def _symbolize(self, coefs, B: int):
        """``_analysis``' output of B images -> (packed fields [B*S, nblk,
        64] int32, per-image histograms [B, 1024] int32): kernel E, or E
        explicit (``symbolize_segments``) in exact mode."""
        if self._exact:
            return fused.symbolize_segments(*coefs, B * self.n_segs, B)
        return fused.symbolize_fields(coefs, B, self._mask, self.layout)

    def dynamic_pack(self, rgbs):
        """Dynamic-table path: batch -> (words [B, S, seg_rows*128] uint32,
        totals [B, S] int32, per-image tables).

        One histogram sync per batch, host K.2 builds, then the
        per-image-LUT pack; words and totals stay on ``self.device``.
        """
        if self._fixed is not None:
            raise ValueError("dynamic_pack() requires a dynamic huffman "
                             "mode")
        pf, hist = self._analyze_hist(self._check_batch(rgbs))
        tables, luts = self._build_tables_batch(hist.cpu().numpy(),
                                                smooth=self._sampled)
        words, totals = self._pack_only(pf, torch.from_numpy(luts)
                                        .to(self.device))
        return words, totals, tables

    def encode_batch(self, rgbs) -> list[bytes]:
        """Batch of [B, H, W, 3] (or [B, H, W*3]) u8 images -> JPEG files."""
        if self._fixed is not None:
            words, totals = self.step(rgbs)
            headers = None
        else:
            words, totals, tables = self.dynamic_pack(rgbs)
            headers = tuple(torch.from_numpy(a).to(self.device)
                            for a in self._headers(tables))
        data, bounds = self._write(words, totals, headers)
        bounds_np = bounds.cpu().numpy()
        return self._assemble(data[:int(bounds_np[-1])].cpu().numpy(),
                              bounds_np)

    def encode_stream(self, batches, sync_depth: int = 4):
        """Pipelined multi-batch encode: yields, for each batch of
        ``batches`` in turn, the list of files ``encode_batch`` gives it.

        On the card, the device work of later batches is enqueued before
        the host fetches and assembles an earlier one: fixed tables enqueue
        a batch's ``step`` (A, B, C, D) whole; dynamic tables enqueue its
        A and E, and the host runs the previous batch's K.2 builds and
        LUTs while they run, then enqueues that batch's F, C and D behind
        them.  Kernel I (``kernels.files.write_files``) follows D and
        writes the batch's files on the card.  Inputs, LUTs and per-image
        headers go up from pinned host buffers (``non_blocking``); the
        histograms, the files' bounds and each batch's files come down on
        two side streams into pinned buffers, each copy ordered after the
        compute by an event, and the host waits on those events alone,
        then cuts the files apart.  All kernels run on the stream
        current when the first batch arrives, so kernels C and E keep one
        cached workspace each (``kernels.fused._workspace``) and no launch
        reads a workspace that another is still re-zeroing.

        Depth: at most ``sync_depth`` batches are in flight (enqueued and
        not yet yielded).  Each needs about its worst-case words buffer,
        twice that for its files (``kernels.files.capacity``), its input
        and 16 bytes a coefficient slot of intermediate fields (32 a slot
        more in the f64 exact mode) on the card; the depth is
        cut to the number of such batches that fit in the card's free
        memory (``torch.cuda.mem_get_info``) when the batch is enqueued,
        and is never below 1 (``sync_depth=1`` runs batches one by one).

        On the CPU the same order of stages runs without streams or pinned
        buffers.  Not carried over from ``jpeg_tpu`` (answers to a TPU
        link's round trips and a 16 GB chip): the caps prediction and its
        ratchet (``_pred_caps``, ``_caps_of``' headroom), ``_CAP_BUCKET``,
        ``_SLICE_CACHE_MAX``, the jitted ``_flat_slice`` executables and
        ``_split_flat``, the background histogram thread, and
        ``_STREAM_BUDGET_BYTES``: the files are fetched after their
        bounds, per batch, on a copy stream that overlaps later batches'
        kernels.
        """
        run = _StreamRun(self)
        analyzed, packed = [], []  # oldest first
        for rgbs in batches:
            x = flat_batch(rgbs, self.height, self.width)
            depth = self._stream_depth(x.shape[0], sync_depth)
            while len(analyzed) + len(packed) >= depth:
                if not packed:
                    packed.append(run.pack(analyzed.pop(0)))
                yield run.finish(packed.pop(0))
            job = run.submit(x)
            if self._fixed is not None:
                packed.append(job)
                continue
            analyzed.append(job)
            if len(analyzed) > 1:
                packed.append(run.pack(analyzed.pop(0)))
        packed += [run.pack(job) for job in analyzed]
        for job in packed:
            yield run.finish(job)

    def _stream_depth(self, n_images: int, sync_depth: int) -> int:
        """``encode_stream``'s depth for a batch of ``n_images`` (see its
        docstring)."""
        depth = max(sync_depth, 1)
        if self.device.type != "cuda":
            return depth
        slots = self.n_segs * self.blocks_per_seg * 64
        seg_words = self.seg_rows * 128
        per_image = (self.n_segs * seg_words * 4
                     + kfiles.capacity(1, self.n_segs, seg_words, 0)
                     + self.height * self.width * 3
                     + slots * (48 if self._exact else 16))
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(1, min(depth, free // (n_images * per_image)))

    @staticmethod
    def _fetch(words: torch.Tensor, totals: torch.Tensor):
        """Device words [..., seg_words] and totals [...] -> host (words
        [..., cap] uint32, totals int32), fetching only the used prefix of
        every segment's words."""
        totals_np = totals.cpu().numpy()
        cap = _used_words(totals_np, words.shape[-1])
        return words[..., :cap].cpu().numpy(), totals_np

    def _write(self, words: torch.Tensor, totals: torch.Tensor,
               headers: tuple[torch.Tensor, torch.Tensor] | None = None):
        """Kernel I: words [B, S, seg_words] and totals [B, S] -> the
        batch's files (data uint8, bounds int64 [B + 1]) on the same
        device; ``headers`` are ``_headers``' (bytes, offsets) there, None
        the fixed tables' header."""
        B, S, W = words.shape
        header, offs = (self._header_dev, None) if headers is None \
            else headers
        return kfiles.write_files(words.view(B * S, W), totals.view(B * S),
                                  header, offs, S)

    def _headers(self, tables: list) -> tuple[np.ndarray, np.ndarray]:
        """Per-image Huffman tables -> their file headers as (bytes uint8,
        offsets int32 [B + 1]) for kernel I."""
        heads = [self._file_header(t) for t in tables]
        offs = np.zeros(len(heads) + 1, np.int32)
        np.cumsum([len(h) for h in heads], out=offs[1:])
        return np.frombuffer(b"".join(heads), np.uint8).copy(), offs

    def _assemble(self, data_np: np.ndarray,
                  bounds_np: np.ndarray) -> list[bytes]:
        """The host copy of kernel I's files and their bounds -> the files,
        one copy each."""
        with span("assemble"):
            return [data_np[a:b].tobytes()
                    for a, b in zip(bounds_np[:-1], bounds_np[1:])]

    # -- dynamic-table stages ------------------------------------------------

    def _analyze_hist(self, x: torch.Tensor):
        """Stage 1: [B, H, W*3] u8 -> (packed fields [B*S, nblk, 64] int32,
        per-image histograms [B, 1024] int32): kernels A and E, or in exact
        mode ``analyze_zz`` and E explicit (``symbolize_segments``)."""
        return self._symbolize(self._analysis(x), x.shape[0])

    @staticmethod
    def _build_tables_batch(h_np: np.ndarray, smooth: bool = False):
        """Per-image K.2 builds + combined LUTs from [B, 1024] histograms.

        The histogram's group order is that of the LUT index (``sym |
        is_dc << 8 | is_luma << 9``): chroma AC, chroma DC, luma AC, luma
        DC; bin 1023 (NULL) is dropped.  ``smooth`` ("dynamic-sampled")
        adds 1 to every symbol that can occur, so a symbol the sample
        missed still gets a code.  Returns (tables, luts [B, 1024] int32).
        """
        B = h_np.shape[0]
        hb = h_np.reshape(B, 4, 256)
        ldc = hb[:, 3].copy()
        ldc[:, NULL_INDEX & 255] = 0
        freqs = np.ones((B, 4, 257), np.int64)
        freqs[:, 0, :256] = ldc
        freqs[:, 1, :256] = hb[:, 2]  # luma_ac
        freqs[:, 2, :256] = hb[:, 1]  # chroma_dc
        freqs[:, 3, :256] = hb[:, 0]  # chroma_ac
        if smooth:
            freqs[:, 0, :256] += _DC_POSSIBLE
            freqs[:, 2, :256] += _DC_POSSIBLE
            freqs[:, 1, :256] += _AC_POSSIBLE
            freqs[:, 3, :256] += _AC_POSSIBLE
        tabs = build_tables_batch(freqs.reshape(B * 4, 257))
        tables = []
        luts = np.empty((B, 1024), np.int32)
        for b in range(B):
            t = {"luma_dc": tabs[4 * b], "luma_ac": tabs[4 * b + 1],
                 "chroma_dc": tabs[4 * b + 2], "chroma_ac": tabs[4 * b + 3]}
            tables.append(t)
            luts[b] = build_combined_lut(t)
        return tables, luts

    def _pack_only(self, pf: torch.Tensor, luts: torch.Tensor):
        """Stage 2: packed fields + per-image LUTs -> (words [B, S, ...],
        totals [B, S]), kernels F, C and D."""
        B, S = luts.shape[0], self.n_segs
        value, nbits, bits = fused.attach_pf(pf, luts)
        words, totals = kpack.pack_segments(value, nbits, B * S,
                                            self.seg_rows, bits)
        return words.view(B, S, -1), totals.view(B, S)

    # -- helpers -------------------------------------------------------------

    def _coefs(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel A: [B, H, W*3] u8 -> [B*S, nblk, 64] int16 coefficients."""
        coef = front.front_dct(x, self._m, self._bias, self._ql, self._qc,
                               sampling=self.sampling)
        return coef.view(x.shape[0] * self.n_segs, self.blocks_per_seg, 64)

    def _analyze_zz(self, x: torch.Tensor):
        """Exact mode: [B, H, W*3] u8 -> ``analyze_zz``'s (seq, dc_diff,
        is_luma) of the batch's B * S segments."""
        rgb = x.view(x.shape[0], self.height, self.width, 3)
        return analyze_zz(rgb, self._luma_q, self._chroma_q, self.mcus_x,
                          self.mcus_y, self.n_segs, self.sampling)

    def _file_header(self, tables: dict[str, HuffmanTable]) -> bytes:
        """SOI .. SOS header of one file with these Huffman tables."""
        return jfif.headers(
            self.width, self.height, self._luma_q, self._chroma_q, tables,
            restart_interval=self._interval,
            y_sampling=Y_SAMPLING[self.sampling]
        ) + jfif.sos_header_interleaved()

    def _check_batch(self, rgbs) -> torch.Tensor:
        """Validate a [B, H, W, 3] or [B, H, W*3] batch -> [B, H, W*3] u8
        contiguous on ``self.device``."""
        x = flat_batch(rgbs, self.height, self.width)
        return x.to(self.device).contiguous()


def flat_batch(rgbs, height: int, width: int,
               differs: str = "!=") -> torch.Tensor:
    """Validate a [B, H, W, 3] or [B, H, W*3] batch of an encoder of
    ``height`` x ``width`` -> [B, H, W*3] u8, where it lies.  A batch of
    another shape raises "batch shape (..) {differs} {H}x{W}", worded as
    ``jpeg_tpu``'s encoder of the caller words it."""
    if isinstance(rgbs, np.ndarray):
        rgbs = torch.from_numpy(np.ascontiguousarray(rgbs))
    rgbs = torch.as_tensor(rgbs)
    if rgbs.dtype != torch.uint8:
        rgbs = rgbs.to(torch.uint8)
    flat = (height, width * 3)
    if tuple(rgbs.shape[1:]) != flat:
        if tuple(rgbs.shape[1:]) != (height, width, 3):
            raise ValueError(f"batch shape {tuple(rgbs.shape)} {differs} "
                             f"{height}x{width}")
        rgbs = rgbs.reshape(rgbs.shape[0], *flat)
    return rgbs


def _used_words(totals_np: np.ndarray, seg_words: int) -> int:
    """The words of every segment that come to the host: those of the
    longest stream, and one more."""
    used = (int(totals_np.max(initial=0)) + 31) // 32 + 1
    return min(used, seg_words)


class _Batch:
    """One batch of ``encode_stream`` on its way through the card: its
    device tensors, the host copies that are under way, the events they
    wait on and the pinned buffers lent to it."""

    def __init__(self, key: int):
        self.key = key         # the batch's number in its stream
        self.pf = self.files = None  # files: kernel I's (data, bounds)
        self.computed = None   # event after the batch's last kernel so far
        self.hist = self.bounds_host = None  # (host tensor, event)
        self.bufs: list[torch.Tensor] = []


class _PinnedPool:
    """Page-locked host buffers of ``encode_stream``.  A buffer is lent to
    one batch and comes back only when that batch is finished, after the
    host has waited on the events of every copy that read or wrote it; so
    no buffer is refilled while a copy still reads it."""

    def __init__(self):
        self._free: list[torch.Tensor] = []

    def take(self, job: _Batch, nbytes: int) -> torch.Tensor:
        """A uint8 buffer of at least ``nbytes``, lent to ``job``."""
        fits = [i for i, b in enumerate(self._free) if b.numel() >= nbytes]
        if fits:
            buf = self._free.pop(min(fits,
                                     key=lambda i: self._free[i].numel()))
        else:
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                              pin_memory=True)
        job.bufs.append(buf)
        return buf

    def give_back(self, job: _Batch) -> None:
        self._free += job.bufs
        job.bufs = []


class _StreamRun:
    """The stages of one ``FastBatchEncoder.encode_stream``.  On a CUDA
    device the kernels run on the stream current at the start
    (``compute``); the histograms and the files' bounds come down on
    ``meta``, the files on ``fetch``, so that a file copy, which the host
    enqueues only once it has the bounds, never queues behind a copy that
    waits for later kernels.  On the CPU every copy is a plain one."""

    def __init__(self, enc: FastBatchEncoder):
        self.enc = enc
        self.cuda = enc.device.type == "cuda"
        self.batches = itertools.count()
        self.meta = self.fetch = None
        if self.cuda:
            self.compute = torch.cuda.current_stream(enc.device)
            self.meta = torch.cuda.Stream(enc.device)
            self.fetch = torch.cuda.Stream(enc.device)
            self.pool = _PinnedPool()

    def _on_compute(self):
        return (torch.cuda.stream(self.compute) if self.cuda
                else contextlib.nullcontext())

    def _upload(self, job: _Batch, host: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device: on the card, through a pinned
        buffer, enqueued on the compute stream."""
        if not self.cuda or host.is_cuda:
            return host.to(self.enc.device).contiguous()
        n = host.numel() * host.element_size()
        staged = self.pool.take(job, n)[:n].view(host.dtype).view(host.shape)
        staged.copy_(host)
        return staged.to(self.enc.device, non_blocking=True)

    def _mark(self, job: _Batch) -> None:
        """Record the event after the work enqueued so far for ``job``."""
        if self.cuda:
            job.computed = torch.cuda.Event()
            job.computed.record(self.compute)

    def _download(self, job: _Batch, t: torch.Tensor, stream):
        """Enqueue the copy of device tensor ``t`` to the host after
        ``job.computed`` -> (host tensor, its event); read the host tensor
        only after ``_wait``."""
        if not self.cuda:
            return t.cpu(), None
        stream.wait_event(job.computed)
        t.record_stream(stream)  # the allocator must not reuse it early
        n = t.numel() * t.element_size()
        host = self.pool.take(job, n)[:n].view(t.dtype).view(t.shape)
        with torch.cuda.stream(stream):
            host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return host, done

    @staticmethod
    def _wait(copy) -> np.ndarray:
        host, done = copy
        with span("encode.wait"):
            if done is not None:
                done.synchronize()
            return host.numpy()

    def submit(self, x: torch.Tensor) -> _Batch:
        """Enqueue a checked batch's first device stage: fixed tables its
        whole ``step``, kernel I and the bounds' copy; dynamic ones A and E
        and the histograms' copy."""
        job, enc = _Batch(next(self.batches)), self.enc
        with span("encode.submit", job.key):
            with self._on_compute():
                x = self._upload(job, x.contiguous())
                if enc._fixed is not None:
                    job.files = enc._write(*enc._step(x))
                else:
                    job.pf, hist = enc._analyze_hist(x)
            self._mark(job)
            if enc._fixed is not None:
                job.bounds_host = self._download(job, job.files[1],
                                                 self.meta)
            else:
                job.hist = self._download(job, hist, self.meta)
        return job

    def pack(self, job: _Batch) -> _Batch:
        """Dynamic tables: the batch's K.2 builds, LUTs and headers on the
        host, then F, C, D and I enqueued and the bounds' copy."""
        enc = self.enc
        with span("encode.tables", job.key):
            tables, luts = enc._build_tables_batch(
                self._wait(job.hist), smooth=enc._sampled)
            headers = enc._headers(tables)
            with self._on_compute():
                luts = self._upload(job, torch.from_numpy(luts))
                headers = tuple(self._upload(job, torch.from_numpy(a))
                                for a in headers)
                job.files = enc._write(*enc._pack_only(job.pf, luts),
                                       headers)
            job.pf = None
            self._mark(job)
            job.bounds_host = self._download(job, job.files[1], self.meta)
        return job

    def finish(self, job: _Batch) -> list[bytes]:
        """Wait for the batch's file bounds, fetch its files' bytes, and
        cut them apart."""
        with span("encode.finish", job.key):
            bounds_np = self._wait(job.bounds_host)
            data = job.files[0][:int(bounds_np[-1])]
            data_np = self._wait(self._download(job, data, self.fetch))
            files = self.enc._assemble(data_np, bounds_np)
            if self.cuda:
                self.pool.give_back(job)
        return files
