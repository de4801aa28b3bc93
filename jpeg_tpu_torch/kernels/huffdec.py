"""Kernel G, ``decode_segments``: baseline Huffman decode of restart
segments, and the host parsing that prepares its inputs.

Baseline entropy decode is bit-serial within a restart segment, and the
segments are independent: the DC predictors reset at every RSTn (T.81
F.2.1.3.1).  Kernel G (``csrc/huffdec.cu``) computes the restart mode of
``jpeg_tpu.kernels.huffdec.decode_segments`` (``_hd_kernel``, K16): one
segment per lane, per-lane canonical tables, zig-zag coefficients with
the DC accumulated from 0 in each lane.  ``decode_segments_plain`` is its
plain twin.

The host half is the port's copy of ``jpeg_tpu.kernels.huffdec``'s
(which imports jax): ``canonical_tables``, ``parse_scan_structure``,
``split_segments``, ``unstuff_segments``, ``pack_streams`` and
``lane_tables``.  ``jpeg_tpu`` pads the lanes to whole 128-lane groups and
buckets the words to powers of two for its compiler; the port packs
exactly one row per segment and exactly the words the longest one needs
(the kernel reads nothing past a row), and ``decode_segments`` takes
either form.  ``_hd_kernel``'s scheduling constants (``_LG``, ``_WNDW``,
``_SYM_GROUP``, ``_CHUNK``, ``_G_CANDS``, ``_PEEL_LUMA``, ``_PEEL_SCAN``)
are answers for the TPU's lanes and compiler, and have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

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

def parse_scan_structure(data: bytes):
    """Light marker walk (no entropy decode) for device-decode routing.

    Returns None unless the stream is a single-scan BASELINE image with
    a restart interval, either 3-component interleaved or single-component
    grayscale.  Otherwise returns a dict with the geometry, per-table
    DHT specs, quantizers (raster order), and the entropy byte range.
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
    if scan is None or not width or ri == 0:
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


# -- G: decode_segments ------------------------------------------------------


def _check_mode(sampling: str, entry, phase, phased: bool) -> None:
    if sampling not in _PATTERN:
        raise ValueError(f"unknown sampling {sampling!r}")
    if entry is not None or phase is not None or phased:
        raise NotImplementedError(
            "decode_segments: per-lane entry bits and MCU phases (the "
            "speculative decode) are not ported yet; restart segments only")


def _extend(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """T.81 F.2.2.1 EXTEND: ``size``-bit magnitude -> signed value."""
    half = torch.ones_like(size) << (size - 1).clamp(min=0)
    return torch.where((size > 0) & (v < half),
                       v - ((torch.ones_like(size) << size) - 1), v)


def decode_segments_plain(streams: torch.Tensor, maxc: torch.Tensor,
                          delt: torch.Tensor, hvp: torch.Tensor,
                          nblk_lane: torch.Tensor, sampling: str,
                          nblk_seg: int, max_words: int, entry=None,
                          phase=None, phased: bool = False) -> torch.Tensor:
    """Plain twin of ``decode_segments``, on any device: every lane
    decodes in lockstep, one symbol step at a time over the lane axis,
    each lane masked by its own state."""
    _check_mode(sampling, entry, phase, phased)
    Sp, dev = streams.shape[0], streams.device
    lanes = torch.arange(Sp, device=dev)
    # two zero words past each row: a peek there reads zeros
    words = torch.cat([streams[:, :max_words].to(torch.int64) & 0xFFFFFFFF,
                       torch.zeros((Sp, 2), dtype=torch.int64, device=dev)],
                      dim=1)
    bound = maxc.to(torch.int64).reshape(4, 16, Sp)
    delta = delt.to(torch.int64).reshape(4, 16, Sp)
    hv = ((hvp.to(torch.int64)[..., None] >> (8 * torch.arange(4, device=dev)))
          & 0xFF).reshape(Sp, 4, 256)
    nblk = nblk_lane.reshape(-1).to(torch.int64)

    def peek32(bp):
        w = (bp >> 5).clamp(max=max_words)
        s = bp & 31
        w0 = words[lanes, w]
        w1 = words[lanes, w + 1]
        return ((w0 << s) | (w1 >> (32 - s))) & 0xFFFFFFFF

    def symbol(peek, t):
        """(symbol, code length; 17 = no match) per lane, table row t."""
        p = peek >> 16
        ln = (p[None] >= bound[t]).sum(0) + 1
        li = ln.clamp(max=16)
        v = (p >> (16 - li)) + delta[t].gather(0, (li - 1)[None])[0]
        return hv[lanes, t, v.clamp(0, 255)], ln

    def bits_after(peek, ln, size):
        """The ``size`` bits after the code, as a signed amplitude."""
        v = (peek << ln.clamp(max=16)) & 0xFFFFFFFF
        return _extend(torch.where(size > 0, v >> (32 - size), 0), size)

    out = torch.zeros((Sp, nblk_seg, 64), dtype=torch.int32, device=dev)
    pred = torch.zeros((3, Sp), dtype=torch.int64, device=dev)
    bp = torch.zeros(Sp, dtype=torch.int64, device=dev)
    pattern = _PATTERN[sampling]
    for b in range(nblk_seg):
        live = b < nblk
        if not bool(live.any()):
            break
        dct, act, comp = pattern[b % len(pattern)]
        peek = peek32(bp)
        sym, ln = symbol(peek, dct)
        ok = live & (ln < 17)
        size = sym & 15
        pred[comp] += torch.where(ok, bits_after(peek, ln, size), 0)
        out[:, b, 0] = torch.where(ok, pred[comp], 0).to(torch.int32)
        bp = bp + torch.where(ok, ln + size, 0)
        slot = torch.ones_like(bp)
        done = ~ok
        while not bool(done.all()):
            peek = peek32(bp)
            sym, ln = symbol(peek, act)
            run, size = sym >> 4, sym & 15
            live = ~done & (ln < 17)
            eob = sym == 0
            zrl = sym == 0xF0
            bp = bp + torch.where(live, ln + size, 0)
            pos = slot + run
            wr = live & ~eob & ~zrl & (size > 0) & (pos <= 63)
            coef = bits_after(peek, ln, size)
            out[lanes[wr], b, pos[wr]] = coef[wr].to(torch.int32)
            slot = torch.where(live, torch.where(zrl, slot + 16, pos + 1),
                               slot)
            done = done | ~live | eob | (slot > 63)
    return out


def decode_segments(streams: torch.Tensor, maxc: torch.Tensor,
                    delt: torch.Tensor, hvp: torch.Tensor,
                    nblk_lane: torch.Tensor, sampling: str, nblk_seg: int,
                    max_words: int, entry=None, phase=None,
                    phased: bool = False) -> torch.Tensor:
    """[Sp, max_words] segment streams -> zz [Sp, nblk_seg, 64] int32.

    ``jpeg_tpu.kernels.huffdec.decode_segments``' arguments: ``streams``
    int32 big-endian words (one segment per row, zero padded; rows past
    the segments are lanes with no blocks), ``maxc``/``delt`` [64, Sp] and
    ``hvp`` [Sp, 256] int32 per-lane tables (``lane_tables``),
    ``nblk_lane`` [1, Sp] int32 each lane's real block count (blocks past
    it are zeros and consume no bits), ``nblk_seg`` the blocks per
    segment.  Block ``b`` of a lane uses the tables and DC predictor of
    position ``b % period`` of ``sampling``'s MCU; the DC terms are
    cumulative from 0 in each lane, the slots in zig-zag order.  A code
    that matches no table entry ends its block without consuming bits;
    bits past a row read as zeros.  ``jpeg_tpu``'s output is this with
    its blocks padded to whole grid steps.  ``entry``, ``phase`` and
    ``phased`` (the speculative decode) raise ``NotImplementedError``.
    """
    _check_mode(sampling, entry, phase, phased)
    if on_cpu(streams, maxc, delt, hvp, nblk_lane):
        return decode_segments_plain(streams, maxc, delt, hvp, nblk_lane,
                                     sampling, nblk_seg, max_words)
    Sp = streams.shape[0]
    check_tensor("streams", streams, torch.int32, (Sp, max_words))
    check_tensor("maxc", maxc, torch.int32, (64, Sp))
    check_tensor("delt", delt, torch.int32, (64, Sp))
    check_tensor("hvp", hvp, torch.int32, (Sp, 256))
    check_tensor("nblk_lane", nblk_lane, torch.int32, (1, Sp))
    zz = torch.empty((Sp, nblk_seg, 64), dtype=torch.int32,
                     device=streams.device)
    pattern = _PATTERN[sampling]
    y_per_mcu = sum(c == 0 for _, _, c in pattern)
    launch("decode_segments", streams.device, streams.data_ptr(),
           maxc.data_ptr(), delt.data_ptr(), hvp.data_ptr(),
           nblk_lane.data_ptr(), zz.data_ptr(), Sp, max_words, nblk_seg,
           len(pattern), y_per_mcu)
    return zz
