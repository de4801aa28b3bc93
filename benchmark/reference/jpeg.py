"""Plain baseline JPEG encoder (interleaved 4:2:0) in NumPy.

Frozen copies of the project's golden encoder
(``jpeg_tpu_torch/golden/encoder.py``: color, subsampling, DCT, quantize,
zig-zag, symbols, packing), its tables (``core/tables.py``), its K.2
table construction (``huffman/build.py::build_table``) and its JFIF writer
(``bitstream/jfif.py``), as they stood when the benchmark was written.
The semantics are those of the reference C encoder (``utils/original.c``).

``Arith`` rounds every arithmetic result: ``EXACT`` keeps float64 (the
reference), ``BF16`` rounds to bfloat16 after each operation (the
control, one precision below the configurations' float32).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ITU-T T.81 Annex K.1 quantizers, raster order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int32)
# zig-zag: zz[i] = raster[SCAN_ORDER[i]]
SCAN_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)
COEF_MIN, COEF_MAX = -2048, 2047

# T.81 Annex K.3 typical tables: (BITS[1..16], HUFFVAL)
_K3 = {
    "luma_dc": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                bytes(range(12))),
    "chroma_dc": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                  bytes(range(12))),
    "luma_ac": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
                bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    "chroma_ac": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                  bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}


def quant_tables(quality: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantizers; ``quality`` scales them linearly as
    ``utils/original.c:504-509`` does (None: unscaled)."""
    if quality is None:
        return LUMA_Q, CHROMA_Q
    return tuple(np.clip(np.trunc((100 - quality) / 50.0 * q.astype(
        np.float64)), 1, 255).astype(np.int32) for q in (LUMA_Q, CHROMA_Q))


def _bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Arith:
    """How every intermediate result is rounded."""
    name: str
    rnd: object

    def __call__(self, x):
        return self.rnd(x)


EXACT = Arith("float64", lambda x: np.asarray(x, np.float64))
BF16 = Arith("bfloat16", _bf16)


@dataclasses.dataclass(frozen=True)
class Table:
    """A baseline Huffman table: DHT lists and per-symbol codes."""
    bits: np.ndarray     # [17], bits[0] unused
    huffval: np.ndarray  # symbols in code order
    code: np.ndarray     # [256], -1 where absent
    length: np.ndarray   # [256], 0 where absent


def table_from_spec(bits, huffval) -> Table:
    """Canonical codes of a DHT (BITS, HUFFVAL) pair (T.81 C.2)."""
    bits = np.concatenate([[0], np.asarray(bits, np.int32)[-16:]]) \
        if len(bits) == 16 else np.asarray(bits, np.int32)
    huffval = np.asarray(list(huffval), np.int32)
    code_of = np.full(256, -1, np.int32)
    length_of = np.zeros(256, np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(int(bits[length])):
            code_of[huffval[k]] = code
            length_of[huffval[k]] = length
            code += 1
            k += 1
        code <<= 1
    return Table(bits.astype(np.int32), huffval, code_of, length_of)


def fixed_tables() -> dict[str, Table]:
    return {k: table_from_spec(b, v) for k, (b, v) in _K3.items()}


def k2_table(freq256) -> Table:
    """T.81 Annex K.2 table of a 256-symbol histogram, as the reference
    encoder builds it: the reserved symbol 256 of count 1, pairwise merge
    of the two least frequent (ascending scan, ``<=``: the highest index
    among equal minima), 16-bit limit by leaf lifting, canonical codes
    over the symbols sorted by pre-limit length."""
    freq = np.zeros(257, np.int64)
    freq[:256] = freq256
    freq[256] = 1
    if freq[:256].sum() == 0:
        raise ValueError("empty histogram")
    f = freq.tolist()
    code_len = [0] * 257
    nxt = [-1] * 257
    while True:
        v1 = v2 = -1
        for i in range(257):
            if f[i] == 0:
                continue
            if v1 == -1 or f[i] <= f[v1]:
                v2, v1 = v1, i
            elif v2 == -1 or f[i] <= f[v2]:
                v2 = i
        if v2 == -1:
            break
        f[v1] += f[v2]
        f[v2] = 0
        while True:
            code_len[v1] += 1
            if nxt[v1] == -1:
                break
            v1 = nxt[v1]
        nxt[v1] = v2
        while True:
            code_len[v2] += 1
            if nxt[v2] == -1:
                break
            v2 = nxt[v2]
    if max(code_len) >= 32:
        raise ValueError("code length overflow")
    clf = [0] * 32
    for n in code_len:
        if n:
            clf[n] += 1
    i = 31
    while True:  # leaf lifting to 16 bits, then drop symbol 256's leaf
        if clf[i] > 0:
            j = i - 2
            while clf[j] <= 0:
                j -= 1
            clf[i] -= 2
            clf[i - 1] += 1
            clf[j + 1] += 2
            clf[j] -= 1
            continue
        i -= 1
        if i != 16:
            continue
        while clf[i] == 0:
            i -= 1
        clf[i] -= 1
        break
    order = [s for n in range(1, 32) for s in range(256) if code_len[s] == n]
    bits = np.zeros(17, np.int32)
    bits[1:17] = clf[1:17]
    return table_from_spec(bits, order)


# -- forward transform -------------------------------------------------------

def _cos() -> np.ndarray:
    t = np.arange(8, dtype=np.float64)[:, None]
    f = np.arange(8, dtype=np.float64)[None, :]
    return np.cos((2.0 * t + 1.0) * f * np.pi / 16.0)


def ycbcr(rgb: np.ndarray, a: Arith = EXACT):
    """BT.601 with truncation to int (utils/original.c:372-374)."""
    r, g, b = (a(rgb[..., i].astype(np.float64)) for i in range(3))
    c = {v: a(v) for v in (0.299, 0.587, 0.114, 0.168736, 0.331264, 0.5,
                          0.418688, 0.081312, 128.0)}
    y = a(a(a(c[0.299] * r) + a(c[0.587] * g)) + a(c[0.114] * b))
    cb = a(a(a(c[128.0] - a(c[0.168736] * r)) - a(c[0.331264] * g))
           + a(c[0.5] * b))
    cr = a(a(a(c[128.0] + a(c[0.5] * r)) - a(c[0.418688] * g))
           - a(c[0.081312] * b))
    return y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32)


def subsample(plane: np.ndarray) -> np.ndarray:
    """2x2 integer average, truncating (utils/original.c:393-404)."""
    h, w = plane.shape
    q = plane.reshape(h // 2, 2, w // 2, 2)
    return (q[:, 0, :, 0] + q[:, 0, :, 1] + q[:, 1, :, 0] + q[:, 1, :, 1]) // 4


def blocks_of(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H/8 * W/8, 8, 8], raster block order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)


def dct_quantize(blocks: np.ndarray, q: np.ndarray,
                 a: Arith = EXACT) -> np.ndarray:
    """Separable DCT in the reference's summation order, truncating
    quantization and clip (utils/original.c:428-456, 515-523) -> zig-zag
    [N, 64] int32."""
    cos = a(_cos()).tolist()
    # [y_t, block, x_t]: each accumulation below runs over whole
    # contiguous planes, in the reference's order of terms
    x = np.ascontiguousarray(a(blocks.astype(np.float64) - 128.0)
                             .transpose(1, 0, 2))
    inner = np.zeros((8,) + x.shape[1:])  # [y_f, block, x_t]
    for t in range(8):
        for f in range(8):
            inner[f] = a(inner[f] + a(x[t] * cos[t][f]))
    inner = np.ascontiguousarray(inner.transpose(2, 1, 0))  # [x_t, b, y_f]
    freq = np.zeros(inner.shape)  # [x_f, block, y_f]
    for t in range(8):
        for f in range(8):
            freq[f] = a(freq[f] + a(inner[t] * cos[t][f]))
    freq = freq.transpose(1, 2, 0).copy()  # [block, y_f, x_f]
    s = a(np.sqrt(0.5))
    freq[:, :, 0] = a(freq[:, :, 0] * s)
    freq[:, 0, :] = a(freq[:, 0, :] * s)
    freq = a(freq / 4.0)
    quant = np.trunc(a(freq.reshape(-1, 64) / q.astype(np.float64)))
    quant = np.clip(quant, COEF_MIN, COEF_MAX).astype(np.int32)
    return quant[:, SCAN_ORDER]


def forward(rgb: np.ndarray, a: Arith = EXACT, quality: int | None = None):
    """[H, W, 3] u8 -> quantized zig-zag coefficients (Y, Cb, Cr), each
    [blocks, 64] in its plane's raster block order."""
    h, w, _ = rgb.shape
    if h % 16 or w % 16:
        raise ValueError(f"{w}x{h} is not a multiple of 16")
    ql, qc = quant_tables(quality)
    y, cb, cr = ycbcr(rgb, a)
    return (dct_quantize(blocks_of(y), ql, a),
            dct_quantize(blocks_of(subsample(cb)), qc, a),
            dct_quantize(blocks_of(subsample(cr)), qc, a))


# -- interleaved MCU order ---------------------------------------------------

def luma_mcu_index(width: int, height: int) -> np.ndarray:
    """Raster Y-block index of each Y block in MCU order (TL, TR, BL,
    BR per 16x16 MCU)."""
    bw = width // 8
    r, c, dv, dh = np.meshgrid(np.arange(height // 16), np.arange(width // 16),
                               np.arange(2), np.arange(2), indexing="ij")
    return ((2 * r + dv) * bw + 2 * c + dh).reshape(-1)


def segments_of(height: int, restart_rows: int) -> list[tuple[int, int]]:
    """MCU-row ranges of the restart segments."""
    my = height // 16
    rows = restart_rows or my
    return [(r, min(r + rows, my)) for r in range(0, my, rows)]


def mcu_sequences(y, cb, cr, width: int, height: int, restart_rows: int):
    """Per segment: the blocks in scan order [n_mcu * 6, 64] with each
    component's DC differenced within the segment."""
    mx = width // 16
    ym = y[luma_mcu_index(width, height)]
    out = []
    for r0, r1 in segments_of(height, restart_rows):
        seq = np.empty(((r1 - r0) * mx * 6, 64), np.int32)
        ys = ym[r0 * mx * 4:r1 * mx * 4]
        for j in range(4):
            seq[j::6] = ys[j::4]
        seq[4::6] = cb[r0 * mx:r1 * mx]
        seq[5::6] = cr[r0 * mx:r1 * mx]
        dc = seq[:, 0].astype(np.int64).copy()
        lum = np.zeros(len(seq), bool)
        for j in range(4):
            lum[j::6] = True
        for sel in (lum, np.arange(len(seq)) % 6 == 4,
                    np.arange(len(seq)) % 6 == 5):
            d = dc[sel]
            seq[sel, 0] = np.diff(d, prepend=np.int64(0))
        out.append(seq)
    return out


# -- symbols and packing -----------------------------------------------------

_BITLEN = np.array([0] + [int(v).bit_length() for v in range(1, 4096)],
                   np.int64)


def symbols(seq: np.ndarray):
    """Blocks [N, 64] (zig-zag, DC differenced) -> their symbols in
    emission order (utils/original.c:748-784): per block the DC size, then
    for each nonzero AC a ZRL (0xF0) per 16 zeros before it and its
    run/size symbol, then EOB where the last nonzero is before 63.
    Returns (symbol, amplitude bits, their count, is DC, is luma)."""
    n = len(seq)
    v = seq.astype(np.int64)
    lum_row = (np.arange(n) % 6) < 4
    dc = v[:, 0]
    rows, cols = np.nonzero(v[:, 1:])
    cols = cols + 1
    first = np.ones(len(rows), bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = np.where(first, 0, np.concatenate([[0], cols[:-1]]))
    run = cols - prev - 1
    nzrl = run // 16
    last = np.zeros(n, np.int64)
    last[rows] = cols  # rows ascend, so the last write is the largest col
    eob = np.nonzero(last < 63)[0]
    zr = np.repeat(np.arange(len(rows)), nzrl)
    zj = np.arange(len(zr)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    vals = np.concatenate([dc, v[rows, cols], np.zeros(len(zr) + len(eob),
                                                       np.int64)])
    size = _BITLEN[np.abs(vals)]
    amp = np.where(vals < 0, vals + (np.int64(1) << size) - 1, vals)
    sym = np.concatenate([size[:n], ((run % 16) << 4) | size[n:n + len(rows)],
                          np.full(len(zr), 0xF0), np.zeros(len(eob), np.int64)])
    row = np.concatenate([np.arange(n), rows, rows[zr], eob])
    key = np.concatenate([np.zeros(n, np.int64), cols,
                          prev[zr] + 16 * (zj + 1), last[eob] + 1])
    order = np.argsort(row * 128 + key, kind="stable")
    is_dc = np.zeros(len(sym), bool)
    is_dc[:n] = True
    nb = np.where(np.arange(len(sym)) < n + len(rows), size, 0)
    return (sym[order], amp[order], nb[order], is_dc[order],
            lum_row[row[order]])


def pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """MSB-first packing, a 0x00 stuffed after each full 0xFF byte, and
    one ones-filled pad byte always appended, unstuffed
    (main/encoder.c:385-432)."""
    values = values.astype(np.int64)
    nbits = nbits.astype(np.int64)
    total = int(nbits.sum())
    nfull = total // 8
    bits = np.ones((nfull + 1) * 8, np.uint8)
    if total:
        field = np.repeat(np.arange(len(nbits)), nbits)
        start = np.cumsum(nbits) - nbits
        shift = nbits[field] - 1 - (np.arange(total) - start[field])
        bits[:total] = (values[field] >> shift) & 1
    by = np.packbits(bits)
    full, pad = by[:nfull], by[nfull]
    ff = full == 0xFF
    out = np.zeros(nfull + int(ff.sum()), np.uint8)
    out[np.arange(nfull) + np.cumsum(ff) - ff] = full
    return out.tobytes() + bytes([int(pad)])


def histograms(seqs):
    """(luma DC, luma AC, chroma DC, chroma AC) symbol counts over all
    segments; Cb and Cr counted together."""
    acc = np.zeros((4, 256), np.int64)
    for seq in seqs:
        sym, _, _, is_dc, lum = symbols(seq)
        group = np.where(lum, 0, 2) + (~is_dc)
        acc += np.bincount(group * 256 + sym, minlength=1024).reshape(4, 256)
    return acc


def tables_for(seqs, huffman: str) -> dict[str, Table]:
    if huffman == "fixed":
        return fixed_tables()
    if huffman != "dynamic":
        raise ValueError(f"the reference has no {huffman!r} tables")
    h = histograms(seqs)
    return {"luma_dc": k2_table(h[0]), "luma_ac": k2_table(h[1]),
            "chroma_dc": k2_table(h[2]), "chroma_ac": k2_table(h[3])}


_ORDER = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")


def segment_payload(seq: np.ndarray, tabs: dict[str, Table]) -> bytes:
    sym, amp, nb, is_dc, lum = symbols(seq)
    group = np.where(lum, 0, 2) + (~is_dc)
    codes = np.stack([tabs[k].code for k in _ORDER]).astype(np.int64)
    lens = np.stack([tabs[k].length for k in _ORDER]).astype(np.int64)
    code, clen = codes[group, sym], lens[group, sym]
    if np.any(clen == 0):
        raise ValueError("a symbol has no code in these tables")
    return pack_bits((code << nb) | amp, clen + nb)


# -- JFIF ---------------------------------------------------------------------

_APP0 = bytes.fromhex("ffe000104a46494600010100004800480000")


def _dqt(tid: int, q: np.ndarray) -> bytes:
    return bytes([0xFF, 0xDB, 0x00, 0x43, tid]) + bytes(
        int(v) for v in q[SCAN_ORDER])


def _dht(tc_th: int, t: Table) -> bytes:
    n = len(t.huffval)
    return bytes([0xFF, 0xC4, (19 + n) >> 8, (19 + n) & 0xFF, tc_th]) + \
        bytes(int(b) for b in t.bits[1:17]) + bytes(int(v) for v in t.huffval)


def headers(width: int, height: int, tabs: dict[str, Table],
            interval: int, quality: int | None = None) -> bytes:
    """SOI through the interleaved SOS header (bitstream/jfif.py)."""
    sof = bytes([0xFF, 0xC0, 0x00, 0x11, 0x08, height >> 8, height & 0xFF,
                 width >> 8, width & 0xFF, 0x03, 0x01, 0x22, 0x00,
                 0x02, 0x11, 0x01, 0x03, 0x11, 0x01])
    dri = (bytes([0xFF, 0xDD, 0x00, 0x04, interval >> 8, interval & 0xFF])
           if interval else b"")
    sos = bytes.fromhex("ffda000c03010002110311003f00")
    ql, qc = quant_tables(quality)
    return b"".join([b"\xff\xd8", _APP0, _dqt(0, ql), _dqt(1, qc),
                     _dht(0x00, tabs["luma_dc"]), _dht(0x10, tabs["luma_ac"]),
                     _dht(0x01, tabs["chroma_dc"]),
                     _dht(0x11, tabs["chroma_ac"]), sof, dri, sos])


def encode_coefs(y, cb, cr, width: int, height: int, huffman: str,
                 restart_rows: int = 0, quality: int | None = None) -> bytes:
    """Quantized zig-zag planes -> an interleaved 4:2:0 JFIF file."""
    seqs = mcu_sequences(y, cb, cr, width, height, restart_rows)
    tabs = tables_for(seqs, huffman)
    segs = segments_of(height, restart_rows)
    interval = (segs[0][1] - segs[0][0]) * (width // 16) \
        if len(segs) > 1 else 0
    out = [headers(width, height, tabs, interval, quality)]
    for i, seq in enumerate(seqs):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        out.append(segment_payload(seq, tabs))
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode(rgb: np.ndarray, huffman: str, restart_rows: int = 0,
           a: Arith = EXACT, quality: int | None = None):
    """[H, W, 3] u8 -> (file, (Y, Cb, Cr) coefficients)."""
    coefs = forward(rgb, a, quality)
    h, w, _ = rgb.shape
    return encode_coefs(*coefs, w, h, huffman, restart_rows, quality), coefs


def flipped(coefs, width: int, height: int, hflip: bool, vflip: bool):
    """The coefficients of the frame mirrored left-right and/or top-down,
    worked out in the coefficient domain: blocks reversed along the
    flipped axis, odd frequencies along it negated (truncating
    quantization is odd, so this is exact)."""
    u, v = SCAN_ORDER % 8, SCAN_ORDER // 8
    sign = np.where((u % 2 == 1) & hflip, -1, 1) * \
        np.where((v % 2 == 1) & vflip, -1, 1)
    out = []
    for plane, (ph, pw) in zip(coefs, ((height, width),) +
                               ((height // 2, width // 2),) * 2):
        g = plane.reshape(ph // 8, pw // 8, 64)
        g = g[::-1 if vflip else 1, ::-1 if hflip else 1] * sign
        out.append(np.ascontiguousarray(g.reshape(-1, 64), np.int32))
    return tuple(out)
