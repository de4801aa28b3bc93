"""Plain baseline JPEG decoder (interleaved 4:2:0) in NumPy.

``parse`` reads the markers, ``coefficients`` entropy-decodes the scan
symbol by symbol (a Python loop over 16-bit lookahead tables, restart
markers honoured), and ``pixels`` reconstructs RGB as the project's
golden decoder does (``jpeg_tpu_torch/golden/decoder.py``, frozen here:
dequantize, separable IDCT, round and clip each plane, libjpeg's
triangle 2x upsample, BT.601, round and clip), in float64 or, for the
control, in bfloat16.
"""
from __future__ import annotations

import numpy as np

from .jpeg import EXACT, SCAN_ORDER, Arith, Table, table_from_spec


class Corrupt(ValueError):
    """The file is not a baseline interleaved 4:2:0 JPEG this decoder
    reads, or its entropy data does not decode."""


def parse(data: bytes) -> dict:
    """Markers of a baseline 3-component 4:2:0 interleaved file -> its
    header fields and the entropy-coded bytes of each restart segment
    (stuffing still in); ``Corrupt`` for anything else, a truncated or
    malformed segment included."""
    try:
        return _parse(data)
    except (IndexError, ValueError, KeyError) as e:
        if isinstance(e, Corrupt):
            raise
        raise Corrupt(f"malformed header: {e}") from e


def _parse(data: bytes) -> dict:
    if data[:2] != b"\xff\xd8":
        raise Corrupt("no SOI")
    pos, info = 2, {"quant": {}, "huff": {}, "interval": 0}
    while True:
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise Corrupt(f"no marker at {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        n = (data[pos + 2] << 8) | data[pos + 3]
        seg = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDB:
            for p in range(0, len(seg), 65):
                if seg[p] >> 4:
                    raise Corrupt("16-bit DQT")
                q = np.zeros(64, np.int32)
                q[SCAN_ORDER] = np.frombuffer(seg[p + 1:p + 65], np.uint8)
                info["quant"][seg[p] & 15] = q
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                bits = list(seg[p + 1:p + 17])
                cnt = sum(bits)
                info["huff"][(seg[p] >> 4, seg[p] & 15)] = table_from_spec(
                    bits, seg[p + 17:p + 17 + cnt])
                p += 17 + cnt
        elif marker == 0xC0:
            info["height"] = (seg[1] << 8) | seg[2]
            info["width"] = (seg[3] << 8) | seg[4]
            if seg[5] != 3 or seg[7] != 0x22 or seg[10] != 0x11 \
                    or seg[13] != 0x11:
                raise Corrupt("not a 3-component 4:2:0 frame")
            info["qid"] = (seg[8], seg[11], seg[14])
        elif marker == 0xDD:
            info["interval"] = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:
            if seg[0] != 3:
                raise Corrupt("not an interleaved scan")
            info["tabs"] = [(seg[2 + 2 * c] >> 4, seg[2 + 2 * c] & 15)
                            for c in range(3)]
            break
        elif marker in (0xD8, 0xD9) or 0xC1 <= marker <= 0xCF:
            raise Corrupt(f"unexpected marker {marker:#x}")
    if "width" not in info:
        raise Corrupt("no SOF0")
    # entropy data up to EOI, split at RSTn; a marker is 0xFF followed by
    # neither 0x00 nor 0xFF
    body = np.frombuffer(data, np.uint8)[pos:]
    ff = np.nonzero(body[:-1] == 0xFF)[0]
    marks = ff[(body[ff + 1] != 0x00) & (body[ff + 1] != 0xFF)]
    segs, start = [], 0
    for m in marks.tolist():
        segs.append(body[start:m])
        if body[m + 1] == 0xD9:
            break
        if not 0xD0 <= body[m + 1] <= 0xD7:
            raise Corrupt(f"marker {body[m + 1]:#x} inside the scan")
        start = m + 2
    else:
        raise Corrupt("no EOI")
    info["segments"] = segs
    return info


def _lookahead(t: Table):
    """16-bit window -> (symbol, code length); length 0: no code."""
    sym = np.zeros(1 << 16, np.int64)
    ln = np.zeros(1 << 16, np.int64)
    for s in np.nonzero(t.length)[0]:
        n, c = int(t.length[s]), int(t.code[s])
        sym[c << (16 - n):(c + 1) << (16 - n)] = s
        ln[c << (16 - n):(c + 1) << (16 - n)] = n
    return sym, ln


def _windows(seg: np.ndarray) -> np.ndarray:
    """Un-stuffed bits of a segment -> the 16-bit window at every bit
    position (ones past the end)."""
    ff = np.nonzero(seg[:-1] == 0xFF)[0]
    keep = np.ones(len(seg), bool)
    keep[ff[seg[ff + 1] == 0x00] + 1] = False
    bits = np.concatenate([np.unpackbits(seg[keep]),
                           np.ones(16, np.uint8)]).astype(np.int64)
    n = len(bits) - 16
    win = np.zeros(n, np.int64)
    for j in range(16):
        win |= bits[j:j + n] << (15 - j)
    return win


def _decode_segment(seg, n_blocks: int, luts) -> np.ndarray:
    """One restart segment of ``n_blocks`` blocks in scan order (Y Y Y Y
    Cb Cr per MCU) -> [n_blocks, 64] zig-zag values, DC differenced."""
    win = _windows(seg)
    n = len(win)
    # per table kind (luma DC, luma AC, chroma DC, chroma AC): symbol and
    # code length at every bit position
    at = [(lut[0][win].tolist(), lut[1][win].tolist()) for lut in luts]
    where, size, dest = [], [], []
    p = 0
    try:
        for blk in range(n_blocks):
            g = 0 if blk % 6 < 4 else 2
            dsym, dlen = at[g]
            asym, alen = at[g + 1]
            ln = dlen[p]
            if not ln:
                raise Corrupt(f"no DC code at bit {p}")
            s = dsym[p]
            p += ln
            base = blk * 64
            if s:
                where.append(p)
                size.append(s)
                dest.append(base)
                p += s
            k = 1
            while k < 64:
                ln = alen[p]
                if not ln:
                    raise Corrupt(f"no AC code at bit {p}")
                s = asym[p]
                p += ln
                if not s & 15:
                    if s == 0xF0:
                        k += 16
                        continue
                    break  # EOB
                k += s >> 4
                if k > 63:
                    raise Corrupt(f"run past the block at bit {p}")
                where.append(p)
                size.append(s & 15)
                dest.append(base + k)
                p += s & 15
                k += 1
    except IndexError:
        raise Corrupt("entropy data ends inside a block") from None
    if p > n:
        raise Corrupt("entropy data ends inside a block")
    where, size = np.array(where, np.int64), np.array(size, np.int64)
    amp = win[where] >> (16 - size) if len(where) else where
    val = np.where(amp >= (np.int64(1) << (size - 1)), amp,
                   amp - (np.int64(1) << size) + 1)
    out = np.zeros(n_blocks * 64, np.int64)
    out[np.array(dest, np.int64)] = val
    return out.reshape(n_blocks, 64)


def coefficients(data: bytes, info: dict | None = None):
    """A file -> its quantized zig-zag planes (Y, Cb, Cr), each [blocks,
    64] int32 in raster block order, and the parsed header."""
    info = info or parse(data)
    w, h = info["width"], info["height"]
    if w % 16 or h % 16:
        raise Corrupt(f"{w}x{h} is not a multiple of 16")
    mx, my = w // 16, h // 16
    huff = info["huff"]
    try:
        luts = [_lookahead(huff[(0, info["tabs"][0][0])]),
                _lookahead(huff[(1, info["tabs"][0][1])]),
                _lookahead(huff[(0, info["tabs"][1][0])]),
                _lookahead(huff[(1, info["tabs"][1][1])])]
    except KeyError:
        raise Corrupt("a scan table is not defined") from None
    if info["tabs"][1] != info["tabs"][2]:
        raise Corrupt("Cb and Cr use different tables")
    per = info["interval"] or mx * my
    if per % mx or len(info["segments"]) != -(-(mx * my) // per):
        raise Corrupt("restart segments do not match the frame")
    seqs = []
    for i, seg in enumerate(info["segments"]):
        n_mcu = min(per, mx * my - i * per)
        seq = _decode_segment(seg, n_mcu * 6, luts)
        # undo each component's DC differences within the segment
        lum = (np.arange(len(seq)) % 6) < 4
        for sel in (lum, np.arange(len(seq)) % 6 == 4,
                    np.arange(len(seq)) % 6 == 5):
            seq[sel, 0] = np.cumsum(seq[sel, 0])
        seqs.append(seq)
    seq = np.concatenate(seqs)
    bw = w // 8
    y = np.empty((mx * my * 4, 64), np.int64)
    r, c, dv, dh = np.meshgrid(np.arange(my), np.arange(mx), np.arange(2),
                               np.arange(2), indexing="ij")
    y[((2 * r + dv) * bw + 2 * c + dh).reshape(-1)] = \
        seq.reshape(-1, 6, 64)[:, :4].reshape(-1, 64)
    return (y.astype(np.int32), seq[4::6].astype(np.int32),
            seq[5::6].astype(np.int32)), info


def _plane(zz: np.ndarray, q: np.ndarray, ph: int, pw: int,
           a: Arith) -> np.ndarray:
    """Dequantize, separable IDCT (x = A^T F A), +128, round and clip ->
    [ph, pw] (golden decoder's ``_idct_blocks``)."""
    coef = np.zeros(zz.shape, np.float64)
    coef[:, SCAN_ORDER] = zz
    f = a(a(coef * q.astype(np.float64))).reshape(-1, 8, 8)
    t = np.arange(8, dtype=np.float64)
    basis = np.cos((2.0 * t[None, :] + 1.0) * t[:, None] * np.pi / 16.0)
    basis[0] *= 1.0 / np.sqrt(2.0)
    basis = a(basis * 0.5)  # A[f, t]
    x = a(np.einsum("fy,nfg->nyg", basis, f))
    x = a(np.einsum("nyg,gx->nyx", x, basis))
    blocks = np.clip(np.round(a(x + 128.0)), 0, 255)
    return blocks.reshape(ph // 8, pw // 8, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(ph, pw)


def _up2(p: np.ndarray, a: Arith) -> np.ndarray:
    """Triangle 2x upsample along the last axis (3/4-1/4, edges
    replicated)."""
    left = np.concatenate([p[..., :1], p[..., :-1]], axis=-1)
    right = np.concatenate([p[..., 1:], p[..., -1:]], axis=-1)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],))
    out[..., 0::2] = a(a(0.75 * p) + a(0.25 * left))
    out[..., 1::2] = a(a(0.75 * p) + a(0.25 * right))
    return out


def pixels(coefs, info: dict, a: Arith = EXACT) -> np.ndarray:
    """(Y, Cb, Cr) planes of a parsed file -> [H, W, 3] uint8 RGB."""
    y_zz, cb_zz, cr_zz = coefs
    w, h = info["width"], info["height"]
    ql, qc = info["quant"][info["qid"][0]], info["quant"][info["qid"][1]]
    y = _plane(y_zz, ql, h, w, a)
    cb = _plane(cb_zz, qc, h // 2, w // 2, a)
    cr = _plane(cr_zz, qc, h // 2, w // 2, a)
    cb = a(_up2(_up2(cb.T, a).T, a) - 128.0)
    cr = a(_up2(_up2(cr.T, a).T, a) - 128.0)
    r = a(y + a(a(1.402) * cr))
    g = a(a(y - a(a(0.344136) * cb)) - a(a(0.714136) * cr))
    b = a(y + a(a(1.772) * cb))
    return np.clip(np.round(np.stack([r, g, b], axis=-1)), 0, 255) \
        .astype(np.uint8)
