"""Progressive (SOF2) encode: the port of ``jpeg_tpu.pipelines.progressive``.

Two engines, each giving ``jpeg_tpu``'s bytes:

* ``encode_progressive`` (the default spectral-selection script): one
  interleaved DC scan (Ss=Se=0) with per-component DC prediction, then one
  AC band scan (1..63) per component, Ah=Al=0.  The coefficients come from
  kernel A in the 3-scan order (f32; ``jpeg_tpu``'s ``analyze``), or from
  the f64 exact ops (``pipelines.fast.exact_coefs``); the DC differences
  and the AC slots are torch ops on the device.  With dynamic tables the
  AC slots come to the host, where end-of-band runs collapse into EOBn
  symbols (``_apply_eob_runs``, numpy, as in ``jpeg_tpu``) and the four
  tables are built from the scans' histograms; fixed tables keep one EOB a
  block (Annex K.3 has no EOBn codes) and never leave the device.  Then
  the four scans attach their codes in one launch of kernel F's one-LUT
  mode (``kernels.lut.attach``, K14) and each packs in one launch of C
  and one of D (``kernels.pack.pack_segments``, K15).  D takes
  fields of up to 32 bits, so the 30-bit EOBn fields that kept
  ``jpeg_tpu`` on its XLA packer need no other path.
* ``encode_progressive_script`` (any scan script, with successive
  approximation, T.81 G.1.2.3; ``SUCCESSIVE_SCRIPT`` by default): the
  same coefficients, brought to the host, where the scans' fields are
  built (the AC refinement scans by the native coder
  ``native.ac_refine_fields``), per-scan tables built in dynamic mode, and
  each scan packed by ``ops.pack.pack_fields_np``, as ``jpeg_tpu`` does.

Both run on the card unless the caller passes ``device="cpu"``, where the
kernels' plain twins run.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..bitstream import jfif
from ..core import tables as T
from ..core.types import EncodeConfig
from ..huffman.build import (build_tables_batch, build_tables_from_histograms,
                             fixed_tables)
from ..kernels import front
from ..kernels import lut as klut
from ..kernels import pack as kpack
from ..kernels.lut import NULL_INDEX, build_combined_lut
from ..ops import pack as ops_pack
from ..ops.color import LAYOUTS, SAMPLING_GEOMETRY, Y_SAMPLING
from ..ops.symbols import bit_length, histogram_256, symbolize_explicit
from .encode import _device
from .fast import FastBatchEncoder, exact_coefs, host_constants

_MAX_EOB_RUN = 32767  # EOBn caps at n=14: run < 2^15 (T.81 G.1.2.2)


def _apply_eob_runs(slots) -> dict:
    """Collapse per-block EOBs into cross-block EOBn run symbols.

    T.81 G.1.2.2: a block whose remaining band is all zero contributes an
    end-of-band; consecutive end-of-bands (the first possibly trailing a
    content block, the rest whole-empty blocks) accumulate into one EOBn
    symbol with n = floor(log2(run)) and n appended bits (run - 2^n),
    emitted at the stream position of the run's first EOB.  Runs longer
    than 32767 are split.  ``slots``: numpy sym, extra, extra_n and valid
    of [n, w] slots whose DC slot is invalid.
    """
    sym = np.asarray(slots["sym"]).copy()
    extra = np.asarray(slots["extra"]).copy()
    extra_n = np.asarray(slots["extra_n"]).copy()
    valid = np.asarray(slots["valid"]).copy()

    # an EOB slot is the only valid AC slot with symbol 0 (real AC symbols
    # have cls >= 1, ZRL is 0xF0); DC slots are already invalid here
    is_eob = valid & (sym == 0)
    has_eob = is_eob.any(axis=1)
    eob_pos = np.argmax(is_eob, axis=1)           # defined where has_eob
    content = (valid & ~is_eob).any(axis=1)

    n = sym.shape[0]
    prev_has_eob = np.concatenate([[False], has_eob[:-1]])
    start = has_eob & (content | ~prev_has_eob)

    run_starts = np.flatnonzero(start)
    # member count per run: blocks with an EOB until the next content block
    boundaries = np.append(run_starts, n)
    for i, s in enumerate(run_starts):
        end = boundaries[i + 1]
        # the run covers s plus the following *empty* blocks before end
        members = [s]
        b = s + 1
        while b < end and not content[b]:
            members.append(b)
            b += 1
        # split into <= _MAX_EOB_RUN chunks
        off = 0
        while off < len(members):
            chunk = members[off:off + _MAX_EOB_RUN]
            run = len(chunk)
            r = run.bit_length() - 1              # floor(log2(run))
            head = chunk[0]
            p = eob_pos[head]
            sym[head, p] = r << 4
            extra[head, p] = run - (1 << r)
            extra_n[head, p] = r
            for m in chunk[1:]:
                valid[m, eob_pos[m]] = False
            off += run

    out = dict(slots)
    out["sym"] = np.where(valid, sym, 0)
    out["extra"] = np.where(valid, extra, 0)
    out["extra_n"] = np.where(valid, extra_n, 0)
    out["valid"] = valid
    return out


# ---------------------------------------------------------------------------
# Scan-script engine with successive approximation (T.81 G.1.2).

# libjpeg's classic 10-scan semi-progressive script: coarse DC, coarse
# low-frequency luma, full chroma at half precision, then refinements.
# Entries are (component | "dc", Ss, Se, Ah, Al); "dc" scans interleave
# all three components.
SUCCESSIVE_SCRIPT = [
    ("dc", 0, 0, 0, 1),
    (0, 1, 5, 0, 2),
    (1, 1, 63, 0, 1),
    (2, 1, 63, 0, 1),
    (0, 6, 63, 0, 2),
    (0, 1, 63, 2, 1),
    ("dc", 0, 0, 1, 0),
    (1, 1, 63, 1, 0),
    (2, 1, 63, 1, 0),
    (0, 1, 63, 1, 0),
]

_MAX_REFINE_BUFFER = 1000  # flush cap for buffered correction bits


def _bit_class_np(v):
    """Magnitude bit length of int array (exact; |v| < 2^52)."""
    a = np.abs(v).astype(np.int64)
    _, e = np.frexp(a.astype(np.float64))
    return np.where(a > 0, e, 0).astype(np.int64)


class _Fields:
    """Ordered emission stream: Huffman symbols and raw bit fields.

    sym >= 0: codeword for ``sym`` (resolved later) followed by
    ``extra_n`` appended bits of ``extra``; sym == -1: raw bits only.
    ``tid`` selects the scan's table when a scan uses several (the
    interleaved DC scan: 0 = luma, 1 = chroma).
    """

    def __init__(self):
        self.sym: list[int] = []
        self.extra: list[int] = []
        self.extra_n: list[int] = []
        self.tid: list[int] = []

    def append_sym(self, sym, extra, extra_n, tid=0):
        self.sym.append(int(sym))
        self.extra.append(int(extra))
        self.extra_n.append(int(extra_n))
        self.tid.append(int(tid))

    def append_bits(self, value, n):
        self.sym.append(-1)
        self.extra.append(int(value))
        self.extra_n.append(int(n))
        self.tid.append(0)

    def arrays(self):
        return (np.asarray(self.sym, np.int64),
                np.asarray(self.extra, np.int64),
                np.asarray(self.extra_n, np.int64),
                np.asarray(self.tid, np.int64))


class _ArrayFields:
    """Array-backed emission stream (same protocol as ``_Fields``)."""

    def __init__(self, sym, extra, extra_n, tid=0):
        self.sym = np.asarray(sym, np.int64).reshape(-1)
        self.extra = np.asarray(extra, np.int64).reshape(-1)
        self.extra_n = np.asarray(extra_n, np.int64).reshape(-1)
        t = np.asarray(tid, np.int64)
        self.tid = (np.broadcast_to(t, self.sym.shape).copy()
                    if t.ndim == 0 else t.reshape(-1))

    def arrays(self):
        return self.sym, self.extra, self.extra_n, self.tid


def _dc_scan_fields(dc_walks, counts, ah, al):
    """Interleaved DC scan fields (first scan or refinement).

    dc_walks: per-component quantized DC values in MCU walk order;
    counts: blocks per MCU per component (e.g. [4, 1, 1] for 4:2:0).
    """
    nmcu = len(dc_walks[0]) // counts[0]
    if ah == 0:
        diffs = []
        for dcw in dc_walks:
            pt = dcw >> al  # arithmetic shift (G.1.2.1 point transform)
            diffs.append((pt - np.concatenate([[0], pt[:-1]])
                          ).reshape(nmcu, -1))
        inter = np.concatenate(diffs, axis=1)          # [nmcu, p]
        cls = _bit_class_np(inter)
        amp = np.where(inter < 0, inter + (1 << cls) - 1, inter)
        tid_row = np.concatenate(
            [np.full(c, 0 if i == 0 else 1, np.int64)
             for i, c in enumerate(counts)])
        tids = np.broadcast_to(tid_row, inter.shape)
        return _ArrayFields(cls.reshape(-1), amp.reshape(-1),
                            cls.reshape(-1), tids.reshape(-1).copy())
    bits = [((dcw >> al) & 1).reshape(nmcu, -1) for dcw in dc_walks]
    inter = np.concatenate(bits, axis=1)
    ones = np.ones(inter.size, np.int64)
    return _ArrayFields(np.full(inter.size, -1, np.int64),
                        inter.reshape(-1), ones, 0)


def _ac_first_fields(zz, ss, se, al, allow_eobn):
    """First AC scan of a band (Ah=0): band symbolization with the
    G.1.2.2 point transform, then optional cross-block EOBn runs."""
    band = zz[:, ss:se + 1].astype(np.int64)
    mag = np.abs(band) >> al
    tv = np.where(band < 0, -mag, mag)
    n, w = tv.shape
    pos = np.arange(w, dtype=np.int64)
    nz = tv != 0
    m = np.maximum.accumulate(np.where(nz, pos, -1), axis=1)
    prev = np.concatenate([np.full((n, 1), -1, np.int64), m[:, :-1]], axis=1)
    last = m[:, -1]
    cls = _bit_class_np(tv)
    amp = np.where(tv < 0, tv + (1 << cls) - 1, tv)
    run = (pos[None] - prev - 1) % 16
    sym = np.where(nz, (run << 4) | cls, 0)
    extra = np.where(nz, amp, 0)
    extra_n = np.where(nz, cls, 0)
    valid = nz.copy()
    zrl = (~nz) & (pos[None] < last[:, None]) & \
        ((pos[None] - prev) % 16 == 0)
    sym = np.where(zrl, 0xF0, sym)
    valid |= zrl
    valid |= pos[None] == last[:, None] + 1  # EOB slot (sym 0)

    slots = {"sym": np.where(valid, sym, 0),
             "extra": np.where(valid, extra, 0),
             "extra_n": np.where(valid, extra_n, 0),
             "valid": valid}
    if allow_eobn:
        slots = _apply_eob_runs(slots)
    mask = slots["valid"].reshape(-1)
    return _ArrayFields(slots["sym"].reshape(-1)[mask],
                        slots["extra"].reshape(-1)[mask],
                        slots["extra_n"].reshape(-1)[mask], 0)


def _ac_refine_fields(zz, ss, se, ah, al, allow_eobn):
    """AC refinement scan (G.1.2.3) by the native coder: one correction
    bit per nonzero-history coefficient, newly-significant coefficients
    as run-coded +-1, correction bits buffered across EOB runs (the
    libjpeg encode_mcu_AC_refine flow, which decoders reverse per Figure
    G.10).  ``ac_refine_fields_plain`` is its plain version."""
    band = zz[:, ss:se + 1].astype(np.int64)
    return _ArrayFields(*native.ac_refine_fields(
        band, al, 0x7FFF if allow_eobn else 1, _MAX_REFINE_BUFFER), tid=0)


def ac_refine_fields_plain(zz, ss, se, ah, al, allow_eobn):
    """The Python loop of ``_ac_refine_fields`` (``jpeg_tpu``'s fallback),
    kept as the plain version the tests hold the native coder to."""
    band = zz[:, ss:se + 1].astype(np.int64)
    absv = np.abs(band) >> al
    positive = band > 0
    n, w = absv.shape
    has_any = (absv > 0).any(axis=1)
    newly = absv == 1
    last_new = np.where(newly.any(axis=1),
                        w - 1 - np.argmax(newly[:, ::-1], axis=1), -1)
    max_run = 0x7FFF if allow_eobn else 1

    f = _Fields()
    eobrun = 0
    be: list[int] = []  # correction bits buffered across the EOB run

    def flush_eobrun():
        nonlocal eobrun
        if eobrun == 0:
            return
        r = eobrun.bit_length() - 1
        f.append_sym(r << 4, eobrun - (1 << r), r)
        for b in be:
            f.append_bits(b, 1)
        be.clear()
        eobrun = 0

    for blk in range(n):
        if not has_any[blk]:
            eobrun += 1
            if eobrun == max_run:
                flush_eobrun()
            continue
        a = absv[blk]
        eob = last_new[blk]
        r = 0
        br: list[int] = []
        for k in range(w):
            t = a[k]
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                flush_eobrun()
                r -= 16
                f.append_sym(0xF0, 0, 0)
                for b in br:
                    f.append_bits(b, 1)
                br.clear()
            if t > 1:
                br.append(int(t & 1))
                continue
            flush_eobrun()
            f.append_sym((r << 4) | 1, 1 if positive[blk, k] else 0, 1)
            for b in br:
                f.append_bits(b, 1)
            br.clear()
            r = 0
        if r > 0 or br:
            eobrun += 1
            be.extend(br)
            if eobrun == max_run or len(be) > _MAX_REFINE_BUFFER:
                flush_eobrun()
    flush_eobrun()
    return f


def _resolve_fields(fields, tables_by_tid):
    sym, extra, extra_n, tid = fields.arrays()
    code = np.zeros(sym.shape, np.int64)
    clen = np.zeros(sym.shape, np.int64)
    for t, tab in tables_by_tid.items():
        m = (sym >= 0) & (tid == t)
        s = sym[m]
        code[m] = tab.code[s]
        clen[m] = tab.length[s]
    values = np.where(sym >= 0, (code << extra_n) | extra, extra)
    nbits = np.where(sym >= 0, clen + extra_n, extra_n)
    return values.astype(np.int64), nbits.astype(np.int64)


def _scan_histograms(fields, n_tids):
    sym, _, _, tid = fields.arrays()
    out = []
    for t in range(n_tids):
        h = np.zeros(257, np.int64)
        m = (sym >= 0) & (tid == t)
        np.add.at(h, sym[m].astype(np.int64), 1)
        h[256] = 1
        out.append(h)
    return out


def _has_syms(fields) -> bool:
    return bool(np.any(np.asarray(fields.sym) >= 0))


# ---------------------------------------------------------------------------
# Shared front: the image and its coefficients.

def _image(rgb, cfg: EncodeConfig, dev: torch.device) -> torch.Tensor:
    """Validate an [H, W, 3] image -> u8 on ``dev``."""
    if not torch.is_tensor(rgb):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb))
    x = rgb.to(dev, torch.uint8)
    h, w = x.shape[0], x.shape[1]
    mcu_w, mcu_h, _ = SAMPLING_GEOMETRY[cfg.subsampling]
    if h == 0 or w == 0:
        raise ValueError("image has zero pixels")
    if h % mcu_h or w % mcu_w:
        raise ValueError(f"dimensions must be multiples of {mcu_w}x{mcu_h}, "
                         f"got {w}x{h}; pad with "
                         f"jpeg_tpu_torch.io.editimage")
    return x


def _coefficients(x: torch.Tensor, cfg: EncodeConfig, luma_q: np.ndarray,
                  chroma_q: np.ndarray) -> list[torch.Tensor]:
    """[H, W, 3] u8 -> the zig-zag quantized coefficients of Y, Cb and Cr,
    each int16 [n_c, 64] in raster block order: kernel A in the 3-scan
    order (f32), or the f64 exact ops."""
    h, w = x.shape[0], x.shape[1]
    if cfg.dtype == "float64":
        return [z[0] for z in exact_coefs(x[None], luma_q, chroma_q,
                                          cfg.subsampling)]
    host = host_constants(cfg.quality)
    m, bias, ql, qc = (torch.from_numpy(host[k]).to(x.device)
                       for k in ("m", "bias", "ql", "qc"))
    coef = front.front_dct(x.reshape(1, h, w * 3).contiguous(), m, bias, ql,
                           qc, order="scan", sampling=cfg.subsampling)
    n_y = (h // 8) * (w // 8)
    n_c = (coef.shape[0] - n_y) // 2
    return [coef[:n_y], coef[n_y:n_y + n_c], coef[n_y + n_c:]]


def _mcu_walk(dc_y, w: int, h: int, sampling: str):
    """Y's raster blocks -> their MCU walk order (4:2:0: the 2x2 blocks of
    each MCU; 4:2:2 and 4:4:4: raster order is the walk)."""
    if sampling != "420":
        return dc_y
    my, mx = h // 16, w // 16
    return dc_y.reshape(my, 2, mx, 2).swapaxes(1, 2).reshape(-1)


def encode_progressive_script(rgb, config: EncodeConfig | None = None,
                              scan_script=None,
                              device: str | torch.device = "cuda") -> bytes:
    """Encode with an explicit progressive scan script (SA-capable).

    ``scan_script`` entries are (component | "dc", Ss, Se, Ah, Al);
    defaults to ``SUCCESSIVE_SCRIPT``.  Dynamic mode builds optimal
    Huffman tables per scan and emits them in per-scan DHT segments.
    """
    cfg = config or EncodeConfig()
    script = scan_script or SUCCESSIVE_SCRIPT
    x = _image(rgb, cfg, _device(device))
    h, w = x.shape[0], x.shape[1]
    for comp, ss, se, ah, al in script:
        if not (comp == "dc" or comp in (0, 1, 2)):
            raise ValueError(f"bad scan component {comp!r}")
        if comp == "dc" and (ss, se) != (0, 0):
            raise ValueError("DC scans must have Ss=Se=0")
        if comp != "dc" and ss == 0:
            raise ValueError("AC scans must not include coefficient 0")
        if not (0 <= al <= 13 and (ah == 0 or ah == al + 1)):
            raise ValueError(f"bad successive approximation Ah={ah} Al={al}")

    luma_q, chroma_q = T.quant_tables(cfg.quality)
    zz = [z.cpu().numpy().astype(np.int64)
          for z in _coefficients(x, cfg, luma_q, chroma_q)]
    ypm = SAMPLING_GEOMETRY[cfg.subsampling][2]
    counts = [ypm, 1, 1]
    dc_walks = [_mcu_walk(zz[0][:, 0], w, h, cfg.subsampling),
                zz[1][:, 0], zz[2][:, 0]]

    dynamic = cfg.huffman != "fixed"
    fixed = fixed_tables()

    scans = []  # (scan_spec, fields)
    for spec in script:
        comp, ss, se, ah, al = spec
        if comp == "dc":
            fields = _dc_scan_fields(dc_walks, counts, ah, al)
        elif ah == 0:
            fields = _ac_first_fields(zz[comp], ss, se, al,
                                      allow_eobn=dynamic)
        else:
            fields = _ac_refine_fields(zz[comp], ss, se, ah, al,
                                       allow_eobn=dynamic)
        scans.append((spec, fields))

    header = jfif.headers(w, h, luma_q, chroma_q, fixed, progressive=True,
                          y_sampling=Y_SAMPLING[cfg.subsampling],
                          include_dht=not dynamic)
    out = [header]
    for (comp, ss, se, ah, al), fields in scans:
        if comp == "dc":
            if ah == 0:
                if dynamic:
                    hists = _scan_histograms(fields, 2)
                    t0, t1 = build_tables_batch(np.stack(hists))
                    out.append(jfif.dht_segment(0x00, t0))
                    out.append(jfif.dht_segment(0x01, t1))
                else:
                    t0, t1 = fixed["luma_dc"], fixed["chroma_dc"]
                tabs = {0: t0, 1: t1}
            else:
                tabs = {}  # refinement: raw bits only
            sos = jfif.sos_header_progressive_dc(ah=ah, al=al)
        else:
            tid = 0 if comp == 0 else 1
            if ah == 0 or _has_syms(fields):
                if dynamic:
                    (hist,) = _scan_histograms(fields, 1)
                    (tab,) = build_tables_batch(hist[None])
                    out.append(jfif.dht_segment(0x10 | tid, tab))
                else:
                    tab = fixed["luma_ac" if tid == 0 else "chroma_ac"]
                tabs = {0: tab}
            else:
                tabs = {}
            sos = jfif.sos_header_progressive_ac(comp + 1, tid, ss, se,
                                                 ah=ah, al=al)
        values, nbits = _resolve_fields(fields, tabs)
        mw = int(nbits.sum()) // 32 + 2
        words, total = ops_pack.pack_fields_np(values, nbits,
                                               max_words=max(mw, 2))
        out.append(sos)
        out.append(ops_pack.finish_scan(words, int(total)))
    out.append(jfif.EOI)
    return b"".join(out)


# ---------------------------------------------------------------------------
# The default spectral-selection engine.

def _dc_slots(zz: list[torch.Tensor], w: int, h: int, sampling: str):
    """The DC scan's fields in interleaved MCU order, each component's DC
    predicted from its previous block: (idx, extra, extra_n) int32 [n]
    (every slot valid; idx the combined LUT's DC entry of its component)
    and the luma flags."""
    period, ypm = LAYOUTS[sampling]
    dc = [z[:, 0].to(torch.int32) for z in zz]
    dc[0] = _mcu_walk(dc[0], w, h, sampling)
    nm = dc[1].numel()
    diff = [(d - torch.nn.functional.pad(d[:-1], (1, 0))).view(nm, -1)
            for d in dc]
    inter = torch.cat(diff, dim=1).reshape(-1)
    cls = bit_length(inter.abs())
    amp = torch.where(inter < 0, inter + (1 << cls) - 1, inter)
    luma = torch.tensor([1] * ypm + [0] * (period - ypm), dtype=torch.int32,
                        device=inter.device).repeat(nm)
    return (cls | (1 << 8) | (luma << 9), amp, cls), luma.bool()


def _ac_slots(z: torch.Tensor, luma: int):
    """One component's AC band (1..63) slots: (idx, extra, extra_n) int32
    [n, 64], the DC slot empty (``NULL_INDEX``)."""
    n = z.shape[0]
    zero = torch.zeros((1, n), dtype=torch.int32, device=z.device)
    idx, extra, extra_n = (f[0] for f in symbolize_explicit(
        z[None], zero, zero + luma))
    idx[:, 0] = NULL_INDEX
    extra[:, 0] = 0
    extra_n[:, 0] = 0
    return idx, extra, extra_n


def _eob_run_slots(fields, dev: torch.device):
    """Dynamic tables: one component's AC slots with their end-of-band
    runs collapsed on the host -> (the slots on ``dev``, host sym and
    valid for its histogram)."""
    idx, extra, extra_n = (f.cpu().numpy() for f in fields)
    valid = idx != NULL_INDEX
    slots = _apply_eob_runs({"sym": np.where(valid, idx & 255, 0),
                             "extra": extra, "extra_n": extra_n,
                             "valid": valid})
    valid = slots["valid"]
    idx = np.where(valid, slots["sym"] | (idx & (1 << 9)), NULL_INDEX)
    out = tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (idx, slots["extra"], slots["extra_n"]))
    return out, slots["sym"], valid


def _pack_scans(lut: torch.Tensor, scans) -> list[bytes]:
    """Each scan's (idx, extra, extra_n) slots -> its stuffed payload:
    kernel F's one-LUT mode over all of them (each scan padded with empty
    slots to whole 64-slot blocks), then C and D on each scan, one
    segment at its own length: a run of empty blocks after a stream's
    last word costs D a walk of the run in one CTA (``csrc/place.cu``'s
    read-ahead), so no scan is padded to another's length."""
    sizes = [-(-s[0].numel() // 64) for s in scans]  # blocks of each scan
    fields = []
    for k, fill in enumerate((NULL_INDEX, 0, 0)):
        parts = []
        for s, n in zip(scans, sizes):
            f = s[k].reshape(-1)
            parts += [f, f.new_full((n * 64 - f.numel(),), fill)]
        fields.append(torch.cat(parts))
    value, nbits = (f.view(-1, 64) for f in klut.attach(lut, *fields))
    payloads, start = [], 0
    for n in sizes:
        words, totals = kpack.pack_segments(
            value[None, start:start + n], nbits[None, start:start + n], 1,
            kpack.rows_per_segment(n * 64))
        payloads += native.finish_scans(*FastBatchEncoder._fetch(words,
                                                                 totals))
        start += n
    return payloads


def encode_progressive(rgb, config: EncodeConfig | None = None,
                       successive: bool = False, scan_script=None,
                       device: str | torch.device = "cuda") -> bytes:
    """Encode [H, W, 3] uint8 RGB as a progressive (SOF2) JPEG.

    Uses the config's quality, Huffman mode, chroma subsampling and dtype
    (``float64`` selects the exact analysis); ``config.engine`` is
    ignored.  ``successive=True`` (or an explicit ``scan_script``) routes
    to the scan-script engine with successive approximation, see
    ``encode_progressive_script``.
    """
    if successive or scan_script is not None:
        return encode_progressive_script(rgb, config, scan_script,
                                         device=device)
    cfg = config or EncodeConfig()
    dev = _device(device)
    x = _image(rgb, cfg, dev)
    h, w = x.shape[0], x.shape[1]
    luma_q, chroma_q = T.quant_tables(cfg.quality)
    zz = _coefficients(x, cfg, luma_q, chroma_q)

    dc, dc_luma = _dc_slots(zz, w, h, cfg.subsampling)
    ac = [_ac_slots(z, luma) for z, luma in zip(zz, (1, 0, 0))]
    if cfg.huffman == "fixed":
        tables = fixed_tables()
    else:
        # cross-block EOB runs need EOBn codes, which only built tables
        # have (Annex K.3 defines EOB0 alone); the histograms count the
        # scans as they are emitted
        runs = [_eob_run_slots(f, dev) for f in ac]
        ac = [slots for slots, _, _ in runs]
        ac_hist = [histogram_256(torch.from_numpy(sym),
                                 torch.from_numpy(valid))
                   for _, sym, valid in runs]
        dc_cls, dc_luma = dc[2].cpu(), dc_luma.cpu()
        tables = build_tables_from_histograms(
            histogram_256(dc_cls, dc_luma).numpy(), ac_hist[0].numpy(),
            histogram_256(dc_cls, ~dc_luma).numpy(),
            (ac_hist[1] + ac_hist[2]).numpy())
    lut = torch.from_numpy(build_combined_lut(tables)).to(dev)
    dc_pay, *ac_pay = _pack_scans(lut, [dc, *ac])
    header = jfif.headers(w, h, luma_q, chroma_q, tables, progressive=True,
                          y_sampling=Y_SAMPLING[cfg.subsampling])
    return jfif.assemble_progressive(
        header, dc_pay, [(1, 0, 1, 63, ac_pay[0]), (2, 1, 1, 63, ac_pay[1]),
                         (3, 1, 1, 63, ac_pay[2])])
