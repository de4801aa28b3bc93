"""Kernels G (``decode_segments``) and H (``scan_positions``): baseline
Huffman decode on the card, and the host parsing that prepares its inputs.

Baseline entropy decode is bit-serial within a restart segment, and the
segments are independent: the DC predictors reset at every RSTn (T.81
F.2.1.3.1).  Kernel G (``csrc/huffdec.cu``) computes
``jpeg_tpu.kernels.huffdec.decode_segments`` (``_hd_kernel``, K16): one
lane per row of bits, per-lane canonical tables, zig-zag coefficients
with the DC accumulated from 0 in each lane.  In restart mode each lane
is one segment; in the speculative mode (``entry``, ``phase``,
``phased``) each lane is a chunk of a scan that starts at its own entry
bit and, interleaved, its own MCU position.  Kernel H (same source)
computes ``jpeg_tpu.kernels.huffdec.scan_positions`` (``_scan_kernel``,
K17): the speculative decode's positions-only pass, which walks blocks
from each lane's entry bit to its limit and gives the exit bit, the
block count and a bad flag.  ``decode_segments_plain`` and
``scan_positions_plain`` are their plain twins.

The host half is the port's copy of ``jpeg_tpu.kernels.huffdec``'s
(which imports jax): ``canonical_tables``, ``parse_scan_structure``,
``parse_noninterleaved_scans``, ``split_segments``, ``unstuff_segments``,
``pack_streams`` and ``lane_tables``.  ``jpeg_tpu`` pads the lanes to
whole 128-lane groups and buckets the words to powers of two for its
compiler; the port packs exactly one row per lane and exactly the words
the longest one needs (the kernels read nothing past a row: bits there
read as zeros), and both kernels take either form.  The TPU kernels'
scheduling constants (``_LG``, ``_WNDW``, ``_SYM_GROUP``, ``_CHUNK``,
``_G_CANDS``, ``_PEEL_LUMA``, ``_PEEL_SCAN``, the ``peel_luma`` argument)
are answers for the TPU's lanes and compiler, and have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core import tables as T
from . import check_tensor, launch, on_cpu

# MCU pattern per sampling: (dc table row, ac table row, component) per
# block position; table rows index the stacked [4 x 16] canonical tables
# (0 = luma DC, 1 = luma AC, 2 = chroma DC, 3 = chroma AC).  "gray" is a
# single-component scan: the MCU is one 8x8 block (T.81 A.2, scans with
# one component are never interleaved).
_PATTERN = {
    "420": [(0, 1, 0)] * 4 + [(2, 3, 1), (2, 3, 2)],
    "422": [(0, 1, 0)] * 2 + [(2, 3, 1), (2, 3, 2)],
    "444": [(0, 1, 0), (2, 3, 1), (2, 3, 2)],
    "gray": [(0, 1, 0)],
}

# SOF sampling factors (Y, Cb, Cr as (h, v)) -> sampling mode
SAMPLING_OF_FACTORS = {
    ((2, 2), (1, 1), (1, 1)): "420",
    ((2, 1), (1, 1), (1, 1)): "422",
    ((1, 1), (1, 1), (1, 1)): "444",
}


def canonical_tables(bits: np.ndarray, huffval: np.ndarray):
    """DHT (BITS, HUFFVAL) -> (bound [16], delta [16], hv [256]).

    T.81 F.2.2.3 as monotone 16-bit-aligned boundaries:
    ``bound[l-1] = (maxcode_l + 1) << (16 - l)``, empty lengths carrying
    the running code forward.  A 16-bit peek's code length is the first
    ``l`` with ``peek < bound[l-1]`` (17, no match, past ``bound[15]``),
    and its symbol is ``hv[(peek >> (16 - l)) + delta[l-1]]``.
    """
    bound = np.zeros(16, np.int64)
    delta = np.zeros(16, np.int64)
    code = 0
    k = 0
    for l in range(1, 17):
        n = int(bits[l])
        if n:
            delta[l - 1] = k - code
        bound[l - 1] = (code + n) << (16 - l)
        code = (code + n) << 1
        k += n
    hv = np.zeros(256, np.int64)
    hv[:len(huffval)] = np.asarray(huffval, np.int64)
    return bound, delta, hv


# -- host-side preparation -------------------------------------------------

def parse_scan_structure(data: bytes, require_restarts: bool = True):
    """Light marker walk (no entropy decode) for device-decode routing.

    Returns None unless the stream is a single-scan BASELINE image with
    a restart interval, either 3-component interleaved or single-component
    grayscale.  Otherwise returns a dict with the geometry, per-table
    DHT specs, quantizers (raster order), and the entropy byte range.
    ``require_restarts=False`` also returns DRI-less streams (the
    speculative interleaved path, ``pipelines.speculative``).
    """
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    quant: dict[int, np.ndarray] = {}
    dht: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    comps: list[tuple[int, int, int, int]] = []  # (cid, h, v, qid)
    width = height = 0
    ri = 0
    scan = None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD9,):
            break
        if marker == 0xFF:
            pos -= 1
            continue
        seg_len = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xDB:
            p = 0
            while p < len(seg):
                if seg[p] >> 4:
                    return None  # 16-bit DQT
                zzq = np.frombuffer(seg[p + 1:p + 65],
                                    np.uint8).astype(np.int32)
                q = np.zeros(64, np.int32)
                q[T.SCAN_ORDER] = zzq
                quant[seg[p] & 15] = q
                p += 65
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = np.zeros(17, np.int32)
                bits[1:] = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                n = int(bits.sum())
                vals = np.frombuffer(seg[p + 17:p + 17 + n], np.uint8)
                dht[(tc, th)] = (bits, vals.astype(np.int32))
                p += 17 + n
        elif marker == 0xC0:
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                      seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(seg[5])]
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7):
            return None  # progressive / non-baseline
        elif marker == 0xDD:
            ri = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:
            ns = seg[0]
            if ns != len(comps) or ns not in (1, 3):
                return None
            tabs = {seg[1 + 2 * c]: (seg[2 + 2 * c] >> 4,
                                     seg[2 + 2 * c] & 15)
                    for c in range(ns)}
            ent_start = pos + seg_len
            scan = (tabs, ent_start)
            break
        pos += seg_len
    if scan is None or not width or (require_restarts and ri == 0):
        return None
    tabs, ent_start = scan
    ent_end = _entropy_end(data, ent_start)
    return {
        "width": width, "height": height, "comps": comps, "quant": quant,
        "dht": dht, "tabs": tabs, "restart_interval": ri,
        "entropy": data[ent_start:ent_end],
    }


def _entropy_end(data: bytes, start: int) -> int:
    """First non-stuffing, non-RSTn, non-fill marker at/after ``start``."""
    b = np.frombuffer(data, np.uint8)
    cand = np.where(b[start:-1] == 0xFF)[0] + start
    nxt = b[cand + 1]
    stop = cand[(nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    return int(stop[0]) if len(stop) else len(data)


def parse_noninterleaved_scans(data: bytes):
    """Marker walk for baseline streams whose every scan is a single
    component: grayscale images and the reference's 3-scan layout.

    These scans have no MCU phase (data units are bare 8x8 blocks through
    one DC/AC table pair), which makes them speculatively decodable
    without restart markers (``pipelines.speculative``).  Returns None
    for interleaved, progressive or restart streams; else a dict with the
    geometry, quantizers, and per-scan (cid, dc_spec, ac_spec, entropy
    bytes), the table specs taken at each SOS (DHT may be redefined
    between scans).
    """
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    quant: dict[int, np.ndarray] = {}
    dht: dict = {}
    comps: list[tuple[int, int, int, int]] = []
    width = height = 0
    scans = []
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker == 0xFF:
            pos -= 1
            continue
        seg_len = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xDB:
            p = 0
            while p < len(seg):
                if seg[p] >> 4:
                    return None
                zzq = np.frombuffer(seg[p + 1:p + 65],
                                    np.uint8).astype(np.int32)
                q = np.zeros(64, np.int32)
                q[T.SCAN_ORDER] = zzq
                quant[seg[p] & 15] = q
                p += 65
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = np.zeros(17, np.int32)
                bits[1:] = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                n = int(bits.sum())
                vals = np.frombuffer(seg[p + 17:p + 17 + n], np.uint8)
                dht[(tc, th)] = (bits, vals.astype(np.int32))
                p += 17 + n
        elif marker == 0xC0:
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                      seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(seg[5])]
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7):
            return None
        elif marker == 0xDD:
            if (seg[0] << 8) | seg[1]:
                return None  # restart streams: the segment path is better
        elif marker == 0xDA:
            if seg[0] != 1:
                return None  # interleaved scan
            cid = seg[1]
            tdc, tac = seg[2] >> 4, seg[2] & 15
            ent_start = pos + seg_len
            ent_end = _entropy_end(data, ent_start)
            try:
                scans.append(dict(cid=cid, dc_spec=dht[(0, tdc)],
                                  ac_spec=dht[(1, tac)],
                                  entropy=data[ent_start:ent_end]))
            except KeyError:
                return None
            pos = ent_end
            continue
        pos += seg_len
    if not scans or not width or not comps:
        return None
    if {s["cid"] for s in scans} != {c[0] for c in comps} \
            or len(scans) != len(comps):
        return None
    return dict(width=width, height=height, comps=comps, quant=quant,
                scans=scans)


def split_segments(entropy: bytes):
    """Entropy-coded bytes of one scan -> list of per-segment byte
    arrays split at RSTn markers, still stuffed (0xFF00 intact)."""
    b = np.frombuffer(entropy, np.uint8)
    if len(b) < 2:
        return [b]
    is_ff = b[:-1] == 0xFF
    nxt = b[1:]
    rst = np.where(is_ff & (nxt >= 0xD0) & (nxt <= 0xD7))[0]
    starts = np.concatenate([[0], rst + 2])
    ends = np.concatenate([rst, [len(b)]])
    return [b[s:e] for s, e in zip(starts, ends)]


def unstuff_segments(entropy: bytes, n_expected: int | None = None):
    """Entropy-coded bytes of one scan (RSTn-delimited) -> list of
    un-stuffed per-segment byte arrays."""
    segs = []
    for seg in split_segments(entropy):
        stuffed = np.where((seg[:-1] == 0xFF) & (seg[1:] == 0x00))[0]
        segs.append(np.delete(seg, stuffed + 1) if len(stuffed) else seg)
    if n_expected is not None and len(segs) != n_expected:
        raise ValueError(
            f"expected {n_expected} segments, found {len(segs)}")
    return segs


def pack_streams(segs: list[np.ndarray]):
    """Per-segment un-stuffed bytes -> ([S, max_words] int32 big-endian
    words, max_words): one row per segment, zero-padded to the words of
    the longest one."""
    max_words = max(1, -(-max(len(s) for s in segs) // 4))
    buf = np.zeros((len(segs), max_words * 4), np.uint8)
    for i, s in enumerate(segs):
        buf[i, :len(s)] = s
    words = buf.view(">u4").astype(np.uint32)
    return words.view(np.int32), max_words


def lane_tables(tables_per_seg):
    """Per-segment table specs -> stacked per-lane canonical arrays.

    ``tables_per_seg``: one entry per segment, each a 4-tuple of
    (bits [17], huffval) in table-row order (luma_dc, luma_ac,
    chroma_dc, chroma_ac); entries may repeat objects for shared
    tables.  Returns (maxc [64, S] i32 bounds, delt [64, S] i32 deltas,
    hvp [S, 256] i32 HUFFVAL, 4 bytes to a word, low byte first).
    """
    S = len(tables_per_seg)
    maxc = np.zeros((64, S), np.int64)
    delt = np.zeros((64, S), np.int64)
    hvb = np.zeros((S, 1024), np.int64)
    cache: dict = {}
    for s, quad in enumerate(tables_per_seg):
        for t, (bits, huffval) in enumerate(quad):
            key = (bytes(np.asarray(bits, np.int64).astype(np.uint8)),
                   bytes(np.asarray(huffval, np.int64).astype(np.uint8)))
            if key not in cache:
                cache[key] = canonical_tables(np.asarray(bits),
                                              np.asarray(huffval))
            mc, dl, hvv = cache[key]
            maxc[16 * t:16 * (t + 1), s] = mc
            delt[16 * t:16 * (t + 1), s] = dl
            hvb[s, 256 * t:256 * (t + 1)] = hvv
    hvp = (hvb.reshape(S, 256, 4)
           * (1 << (8 * np.arange(4, dtype=np.int64)))).sum(-1)
    return (maxc.astype(np.int32), delt.astype(np.int32),
            hvp.astype(np.uint32).view(np.int32).copy())


# -- G: decode_segments, H: scan_positions ----------------------------------


def _check_mode(sampling: str) -> None:
    if sampling not in _PATTERN:
        raise ValueError(f"unknown sampling {sampling!r}")


def _extend(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """T.81 F.2.2.1 EXTEND: ``size``-bit magnitude -> signed value."""
    half = torch.ones_like(size) << (size - 1).clamp(min=0)
    return torch.where((size > 0) & (v < half),
                       v - ((torch.ones_like(size) << size) - 1), v)


class _Lanes:
    """The plain twins' view of the kernels' inputs: every lane's bits
    and tables, read in lockstep over the lane axis."""

    def __init__(self, streams, maxc, delt, hvp, max_words: int,
                 sampling: str):
        Sp, dev = streams.shape[0], streams.device
        self.idx = torch.arange(Sp, device=dev)
        self.max_words = max_words
        # two zero words past each row: a peek there reads zeros
        self.words = torch.cat(
            [streams[:, :max_words].to(torch.int64) & 0xFFFFFFFF,
             torch.zeros((Sp, 2), dtype=torch.int64, device=dev)], dim=1)
        # lane-major [Sp, 4 tables, ...]
        self.bound = maxc.to(torch.int64).reshape(4, 16, Sp).permute(
            2, 0, 1).contiguous()
        self.delta = delt.to(torch.int64).reshape(4, 16, Sp).permute(
            2, 0, 1).contiguous()
        self.hv = ((hvp.to(torch.int64)[..., None]
                    >> (8 * torch.arange(4, device=dev))) & 0xFF
                   ).reshape(Sp, 4, 256)
        # (dc table row, ac table row, component) by MCU position
        self.pattern = torch.tensor(_PATTERN[sampling], dtype=torch.int64,
                                    device=dev)
        self.period = len(_PATTERN[sampling])

    def peek32(self, bp):
        """The 32 bits at each lane's bit position ``bp``."""
        w = (bp >> 5).clamp(max=self.max_words)[:, None]
        w01 = self.words.gather(1, torch.cat([w, w + 1], dim=1))
        s = bp & 31
        return ((w01[:, 0] << s) | (w01[:, 1] >> (32 - s))) & 0xFFFFFFFF

    def tables(self, t):
        """Each lane's table row ``t`` [Sp]: (bounds [Sp, 16], deltas
        [Sp, 16], HUFFVAL [Sp, 256])."""
        def row(a):
            return a.gather(1, t[:, None, None].expand(-1, 1, a.shape[2]))[:, 0]
        return row(self.bound), row(self.delta), row(self.hv)

    @staticmethod
    def symbol(peek, tables):
        """(symbol, code length; 17 = no match) per lane, each lane
        against its own ``tables``."""
        bound, delta, hv = tables
        p = peek >> 16
        ln = (p[:, None] >= bound).sum(1) + 1
        li = ln.clamp(max=16)
        v = (p >> (16 - li)) + delta.gather(1, (li - 1)[:, None])[:, 0]
        return hv.gather(1, v.clamp(0, 255)[:, None])[:, 0], ln

    @staticmethod
    def bits_after(peek, ln, size):
        """The ``size`` bits after the code, as a signed amplitude."""
        v = (peek << ln.clamp(max=16)) & 0xFFFFFFFF
        return _extend(torch.where(size > 0, v >> (32 - size), 0), size)

    def walk_ac(self, bp, done, act, out=None, b=0):
        """Every lane's AC symbols of one block from ``bp`` (table row
        ``act``), lanes in ``done`` idle: -> (bit position, bad: a code
        matched nothing).  Writes the coefficients into ``out[:, b]``
        when given."""
        act = self.tables(act)
        slot = torch.ones_like(bp)
        bad = torch.zeros_like(done)
        while not bool(done.all()):
            peek = self.peek32(bp)
            sym, ln = self.symbol(peek, act)
            run, size = sym >> 4, sym & 15
            nomatch = ln >= 17
            bad = bad | (~done & nomatch)
            live = ~done & ~nomatch
            eob = sym == 0
            zrl = sym == 0xF0
            bp = bp + torch.where(live, ln + size, 0)
            pos = slot + run
            if out is not None:
                wr = live & ~eob & ~zrl & (size > 0) & (pos <= 63)
                coef = self.bits_after(peek, ln, size)
                out[self.idx[wr], b, pos[wr]] = coef[wr].to(torch.int32)
            slot = torch.where(live, torch.where(zrl, slot + 16, pos + 1),
                               slot)
            done = done | ~live | eob | (slot > 63)
        return bp, bad


def _lane_row(t, Sp: int, device) -> torch.Tensor:
    """A [1, Sp] per-lane input (None: zeros) as an int64 [Sp] row."""
    if t is None:
        return torch.zeros(Sp, dtype=torch.int64, device=device)
    return t.reshape(-1).to(torch.int64)


def decode_segments_plain(streams: torch.Tensor, maxc: torch.Tensor,
                          delt: torch.Tensor, hvp: torch.Tensor,
                          nblk_lane: torch.Tensor, sampling: str,
                          nblk_seg: int, max_words: int, entry=None,
                          phase=None, phased: bool = False) -> torch.Tensor:
    """Plain twin of ``decode_segments``, on any device: every lane
    decodes in lockstep, one symbol step at a time over the lane axis,
    each lane masked by its own state."""
    _check_mode(sampling)
    Sp, dev = streams.shape[0], streams.device
    lanes = _Lanes(streams, maxc, delt, hvp, max_words, sampling)
    nblk = nblk_lane.reshape(-1).to(torch.int64)
    bp = _lane_row(entry, Sp, dev)
    first = _lane_row(phase if phased else None, Sp, dev)
    out = torch.zeros((Sp, nblk_seg, 64), dtype=torch.int32, device=dev)
    pred = torch.zeros((3, Sp), dtype=torch.int64, device=dev)
    for b in range(nblk_seg):
        live = b < nblk
        if not bool(live.any()):
            break
        dct, act, comp = lanes.pattern[(first + b) % lanes.period].T
        peek = lanes.peek32(bp)
        sym, ln = lanes.symbol(peek, lanes.tables(dct))
        ok = live & (ln < 17)
        size = sym & 15
        dc = pred.gather(0, comp[None])[0] + torch.where(
            ok, lanes.bits_after(peek, ln, size), 0)
        pred.scatter_(0, comp[None], dc[None])
        out[:, b, 0] = torch.where(ok, dc, 0).to(torch.int32)
        bp, _ = lanes.walk_ac(bp + torch.where(ok, ln + size, 0), ~ok, act,
                              out, b)
    return out


def _check_lanes(streams, maxc, delt, hvp, max_words: int, **rows) -> int:
    """The wrappers' checks of the lane inputs; returns the lane count."""
    Sp = streams.shape[0]
    check_tensor("streams", streams, torch.int32, (Sp, max_words))
    check_tensor("maxc", maxc, torch.int32, (64, Sp))
    check_tensor("delt", delt, torch.int32, (64, Sp))
    check_tensor("hvp", hvp, torch.int32, (Sp, 256))
    for name, t in rows.items():
        if t is not None:
            check_tensor(name, t, torch.int32, (1, Sp))
    return Sp


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def decode_segments(streams: torch.Tensor, maxc: torch.Tensor,
                    delt: torch.Tensor, hvp: torch.Tensor,
                    nblk_lane: torch.Tensor, sampling: str, nblk_seg: int,
                    max_words: int, entry=None, phase=None,
                    phased: bool = False) -> torch.Tensor:
    """[Sp, max_words] lane streams -> zz [Sp, nblk_seg, 64] int32.

    ``jpeg_tpu.kernels.huffdec.decode_segments``' arguments: ``streams``
    int32 big-endian words (one lane per row, zero padded; rows past the
    lanes are lanes with no blocks), ``maxc``/``delt`` [64, Sp] and
    ``hvp`` [Sp, 256] int32 per-lane tables (``lane_tables``),
    ``nblk_lane`` [1, Sp] int32 each lane's real block count (blocks past
    it are zeros and consume no bits), ``nblk_seg`` the blocks per lane.
    Block ``b`` of a lane uses the tables and DC predictor of position
    ``b % period`` of ``sampling``'s MCU; the DC terms are cumulative from
    0 in each lane, the slots in zig-zag order.  A code that matches no
    table entry ends its block without consuming bits; bits past a row
    read as zeros.  The speculative mode: ``entry`` [1, Sp] int32 (>= 0)
    sets each lane's first bit in its row (None: bit 0), and with
    ``phased=True`` block ``b`` takes position ``(phase + b) % period``
    (``phase`` [1, Sp] int32 >= 0, None: zeros).  ``jpeg_tpu``'s output
    is this with its blocks padded to whole grid steps; its ``peel_luma``
    (TPU scheduling only) has no counterpart.
    """
    _check_mode(sampling)
    if on_cpu(streams, maxc, delt, hvp, nblk_lane,
              *(t for t in (entry, phase) if t is not None)):
        return decode_segments_plain(streams, maxc, delt, hvp, nblk_lane,
                                     sampling, nblk_seg, max_words, entry,
                                     phase, phased)
    Sp = _check_lanes(streams, maxc, delt, hvp, max_words,
                      nblk_lane=nblk_lane, entry=entry, phase=phase)
    zz = torch.empty((Sp, nblk_seg, 64), dtype=torch.int32,
                     device=streams.device)
    pattern = _PATTERN[sampling]
    y_per_mcu = sum(c == 0 for _, _, c in pattern)
    launch("decode_segments", streams.device, streams.data_ptr(),
           maxc.data_ptr(), delt.data_ptr(), hvp.data_ptr(),
           nblk_lane.data_ptr(), _ptr(entry),
           _ptr(phase) if phased else None, zz.data_ptr(), Sp, max_words,
           nblk_seg, len(pattern), y_per_mcu)
    return zz


# the kernels of csrc/huffdec.cu by their code in jt_lane_layout
_LAYOUT_KERNELS = {"decode_segments": 0, "scan_positions": 1}


def lane_layout(kernel: str, max_words: int) -> tuple[int, bool]:
    """The shared-memory layout kernel G or H (``kernel``) takes for rows
    of ``max_words`` words, as its source chooses it (``lane_layout`` in
    ``csrc/huffdec.cu``): (lanes a CTA, whether the rows are staged in
    shared memory; else they are read from global memory)."""
    code = _build.library("huffdec").jt_lane_layout(
        max_words, _LAYOUT_KERNELS[kernel])
    return code >> 1, bool(code & 1)


def _scan_steps(cap_blocks: int) -> int:
    """Block steps of the positions pass: ``jpeg_tpu``'s grid runs
    ``cap_blocks`` rounded up to whole steps of 8 blocks."""
    return -(-cap_blocks // 8) * 8


def scan_positions_plain(streams: torch.Tensor, maxc: torch.Tensor,
                         delt: torch.Tensor, hvp: torch.Tensor,
                         entry: torch.Tensor, limit: torch.Tensor,
                         cap_blocks: int, max_words: int,
                         sampling: str = "gray", phase=None):
    """Plain twin of ``scan_positions``, on any device: every lane walks
    its blocks in lockstep, one block step at a time."""
    _check_mode(sampling)
    Sp, dev = streams.shape[0], streams.device
    lanes = _Lanes(streams, maxc, delt, hvp, max_words, sampling)
    bp = _lane_row(entry, Sp, dev)
    lim = _lane_row(limit, Sp, dev)
    # a period-1 pattern ("gray") always takes table rows 0 and 1
    first = _lane_row(phase if lanes.period > 1 else None, Sp, dev)
    counts = torch.zeros(Sp, dtype=torch.int64, device=dev)
    bad = torch.zeros(Sp, dtype=torch.bool, device=dev)
    for step in range(_scan_steps(cap_blocks)):
        live = (bp < lim) & ~bad
        if not bool(live.any()):
            break
        dct, act, _ = lanes.pattern[(first + step) % lanes.period].T
        sym, ln = lanes.symbol(lanes.peek32(bp), lanes.tables(dct))
        ok = live & (ln < 17)
        end, bad_ac = lanes.walk_ac(bp + torch.where(ok, ln + (sym & 15), 0),
                                    ~ok, act)
        whole = ok & ~bad_ac
        bp = torch.where(whole, end, bp)
        counts += whole
        bad |= (live & ~ok) | bad_ac
    return (bp.to(torch.int32), counts.to(torch.int32),
            bad.to(torch.int32))


def scan_positions(streams: torch.Tensor, maxc: torch.Tensor,
                   delt: torch.Tensor, hvp: torch.Tensor,
                   entry: torch.Tensor, limit: torch.Tensor,
                   cap_blocks: int, max_words: int, sampling: str = "gray",
                   phase=None):
    """Speculative positions pass -> (exits, counts, bad), each [Sp] int32.

    ``jpeg_tpu.kernels.huffdec.scan_positions``' arguments: the lane
    inputs of ``decode_segments``, ``entry`` and ``limit`` [1, Sp] int32
    bit offsets in each lane's row, ``phase`` [1, Sp] int32 (>= 0; None:
    zeros) each lane's MCU position of its first block (interleaved
    samplings; a period-1 ``sampling`` ignores it).  Each lane walks
    blocks from ``entry``, for at most ``cap_blocks`` rounded up to a
    multiple of 8 steps, stopping at the first block that starts at or
    past ``limit``.  A block whose DC or AC code matches nothing does not
    count, leaves the exit at its start and marks the lane bad, which
    stops it.  Nothing is written but the exit bit, the blocks walked
    and the bad flag; bits past a row read as zeros.  A lane still short
    of its limit after the cap has ``counts >= cap_blocks`` (the caller
    retries with a larger cap).
    """
    _check_mode(sampling)
    if on_cpu(streams, maxc, delt, hvp, entry, limit,
              *(() if phase is None else (phase,))):
        return scan_positions_plain(streams, maxc, delt, hvp, entry, limit,
                                    cap_blocks, max_words, sampling, phase)
    Sp = _check_lanes(streams, maxc, delt, hvp, max_words, entry=entry,
                      limit=limit, phase=phase)
    outs = torch.empty((3, Sp), dtype=torch.int32, device=streams.device)
    pattern = _PATTERN[sampling]
    launch("scan_positions", streams.device, streams.data_ptr(),
           maxc.data_ptr(), delt.data_ptr(), hvp.data_ptr(),
           entry.data_ptr(), limit.data_ptr(),
           _ptr(phase) if len(pattern) > 1 else None, outs.data_ptr(), Sp,
           max_words, _scan_steps(cap_blocks), len(pattern),
           sum(c == 0 for _, _, c in pattern))
    return outs[0], outs[1], outs[2]
