"""Baseline JPEG decoder (numpy, host side): the port's bitstream oracle.

The port's own copy of the baseline part of ``jpeg_tpu.golden.decoder``
(SOF0, 8-bit, 1 or 3 components, general sampling factors, interleaved
and single-component scans, DHT/DQT/DRI/RSTn, 0xFF00 stuffing), on its
pure-Python scan path only, plus ``psnr``.  ``chip_smoke.py`` decodes the
port's files with it; ``tests/test_torch_host.py`` holds it equal to the
original.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import tables as T
from ..huffman.build import HuffmanTable, table_from_spec


@dataclasses.dataclass
class _Component:
    comp_id: int
    h_samp: int
    v_samp: int
    quant_id: int
    dc_table: int = 0
    ac_table: int = 0
    # block-grid dims of the coefficient array, set by _decode_scan:
    # T.81 A.2.2 — non-interleaved scans carry ceil(comp_dim/8) blocks,
    # interleaved scans the MCU-padded count.
    bw: int = 0
    bh: int = 0


class _BitReader:
    """MSB-first bit reader with 0xFF00 de-stuffing and marker detection."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.nbits = 0
        self.marker: int | None = None  # marker encountered (e.g. RSTn, next segment)

    def _fill(self):
        while self.nbits <= 24:
            if self.marker is not None or self.pos >= len(self.data):
                # feed ones past the end (padding semantics)
                self.bitbuf = (self.bitbuf << 8) | 0xFF
                self.nbits += 8
                continue
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = self.data[self.pos + 1] if self.pos + 1 < len(self.data) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                    self.bitbuf = (self.bitbuf << 8) | 0xFF
                    self.nbits += 8
                    continue
                # genuine marker: stop consuming
                self.marker = nxt
                continue
            self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.nbits += 8

    def read_bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        return (self.bitbuf >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align_and_clear(self):
        self.bitbuf = 0
        self.nbits = 0

    def consume_marker(self) -> int:
        """Skip to and consume the pending marker; returns its code byte."""
        self.align_and_clear()
        # advance self.pos to the 0xFF: scan forward over fill bytes
        while self.pos < len(self.data) and self.data[self.pos] != 0xFF:
            self.pos += 1
        while self.pos + 1 < len(self.data) and self.data[self.pos + 1] == 0xFF:
            self.pos += 1  # 0xFF fill bytes before a marker
        code = self.data[self.pos + 1]
        self.pos += 2
        self.marker = None
        return code


def _decode_symbol(br: _BitReader, table: HuffmanTable) -> int:
    # canonical decode: extend code bit by bit, check against first-code table
    code = 0
    first = 0
    index = 0
    for length in range(1, 17):
        code = (code << 1) | br.read_bit()
        count = int(table.bits[length])
        if count and code - first < count:
            return int(table.huffval[index + (code - first)])
        index += count
        first = (first + count) << 1
    raise ValueError("invalid Huffman code in stream")


def _extend(v: int, nbits: int) -> int:
    """Amplitude decode: inverse of the ~abs negative encoding."""
    if nbits == 0:
        return 0
    if v < (1 << (nbits - 1)):
        return v - (1 << nbits) + 1
    return v


def _decode_block(br: _BitReader, dc_tab: HuffmanTable, ac_tab: HuffmanTable,
                  pred: int) -> tuple[np.ndarray, int]:
    zz = np.zeros(64, dtype=np.int32)
    cls = _decode_symbol(br, dc_tab)
    diff = _extend(br.read_bits(cls), cls)
    pred += diff
    zz[0] = pred
    k = 1
    while k < 64:
        sym = _decode_symbol(br, ac_tab)
        if sym == 0x00:  # EOB
            break
        if sym == 0xF0:  # ZRL
            k += 16
            continue
        run, size = sym >> 4, sym & 0x0F
        k += run
        if k > 63:
            raise ValueError("run past end of block")
        zz[k] = _extend(br.read_bits(size), size)
        k += 1
    return zz, pred


def _idct_blocks(zz: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """De-zigzag, dequantize, inverse DCT; returns pixel blocks [N, 8, 8]."""
    coef = np.zeros_like(zz)
    coef[:, T.SCAN_ORDER] = zz  # raster[SCAN_ORDER[i]] = zigzag[i]
    coef = coef.astype(np.float64) * quant.reshape(64).astype(np.float64)
    f = coef.reshape(-1, 8, 8)
    a = T.dct_basis_orthonormal()
    x = np.einsum("yf,nfg,gx->nyx", a.T, f, a, optimize=True)  # A.T @ F @ A
    return np.clip(np.round(x + 128.0), 0, 255)


def _upsample2x_h(p: np.ndarray) -> np.ndarray:
    """Horizontal 2x triangle-filter upsample (libjpeg "fancy": 3/4-1/4
    weights, centered chroma siting, edge replication)."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], p.shape[1] * 2), dtype=p.dtype)
    out[:, 0::2] = 0.75 * p + 0.25 * left
    out[:, 1::2] = 0.75 * p + 0.25 * right
    return out


def _upsample2x_v(p: np.ndarray) -> np.ndarray:
    return _upsample2x_h(p.T).T


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Triangle-filter for 2x factors, sample replication otherwise."""
    if fv == 2:
        plane = _upsample2x_v(plane)
    elif fv > 1:
        plane = np.repeat(plane, fv, axis=0)
    if fh == 2:
        plane = _upsample2x_h(plane)
    elif fh > 1:
        plane = np.repeat(plane, fh, axis=1)
    return plane


def _from_blocks(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return (blocks.reshape(h // 8, w // 8, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(h, w))


def decode(data: bytes) -> np.ndarray:
    """Decode baseline JFIF bytes to an [H, W, 3] uint8 RGB image."""
    return _reconstruct(*parse_coefficients(data))


def parse_coefficients(data: bytes):
    """Parse markers + entropy-decode all scans (the serial host stage).

    Returns (comps, coeffs, quant, width, height) — the zig-zagged
    quantized coefficient arrays per component, ready for
    ``_reconstruct``.  Baseline (SOF0) only.
    """
    if data[:2] != b"\xff\xd8":
        raise ValueError("missing SOI")
    pos = 2
    quant: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], HuffmanTable] = {}
    comps: list[_Component] = []
    width = height = 0
    restart_interval = 0
    # coefficient storage per component id
    coeffs: dict[int, np.ndarray] = {}

    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"expected marker at {pos}, got {data[pos]:#x}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker == 0xFF:  # fill byte
            pos -= 1
            continue
        seg_len = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                tid = seg[p] & 0x0F
                if seg[p] >> 4:
                    raise ValueError("16-bit DQT unsupported")
                zzq = np.frombuffer(seg[p + 1:p + 65], dtype=np.uint8).astype(np.int32)
                q = np.zeros(64, dtype=np.int32)
                q[T.SCAN_ORDER] = zzq
                quant[tid] = q
                p += 65
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0x0F
                bits = np.zeros(17, dtype=np.int32)
                bits[1:17] = np.frombuffer(seg[p + 1:p + 17], dtype=np.uint8)
                n = int(bits.sum())
                vals = np.frombuffer(seg[p + 17:p + 17 + n], dtype=np.uint8)
                huff[(tc, th)] = table_from_spec(bits, vals)
                p += 17 + n
        elif marker == 0xC0:  # SOF0 baseline
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            comps = []
            for c in range(ncomp):
                cid, samp, qid = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append(_Component(cid, samp >> 4, samp & 0x0F, qid))
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7):
            raise ValueError(f"unsupported SOF {marker:#x}")
        elif marker == 0xDD:  # DRI
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan_comps = []
            for c in range(ns):
                cid, tabs = seg[1 + 2 * c], seg[2 + 2 * c]
                comp = next(cc for cc in comps if cc.comp_id == cid)
                comp.dc_table, comp.ac_table = tabs >> 4, tabs & 0x0F
                scan_comps.append(comp)
            br = _BitReader(data, pos + seg_len)
            _decode_scan(br, scan_comps, comps, huff, coeffs, width,
                         height, restart_interval)
            # continue parsing at the marker the scan stopped on
            while br.pos < len(data) and data[br.pos] != 0xFF:
                br.pos += 1
            pos = br.pos
            continue
        pos += seg_len

    return comps, coeffs, quant, width, height


def _decode_scan(br, scan_comps, all_comps, huff, coeffs, width, height,
                 restart_interval):
    """Entropy-decode one scan; general baseline sampling factors.

    Component plane dims follow T.81 A.1.1: ceil(dim * samp / smax),
    padded to whole blocks; an interleaved MCU carries h x v blocks per
    component in raster order within the MCU.
    """
    hmax = max(c.h_samp for c in all_comps)
    vmax = max(c.v_samp for c in all_comps)
    true_width, true_height = width, height
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    mx = -(-width // mcu_w)
    my = -(-height // mcu_h)

    def plane_blocks(comp):
        # blocks per row/column of the component's padded plane
        return mx * comp.h_samp, my * comp.v_samp

    if len(scan_comps) == 1:
        # T.81 A.2.2: a non-interleaved scan carries ceil(cw/8) x ceil(ch/8)
        # blocks of the component's true (unpadded-to-MCU) plane
        comp = scan_comps[0]
        cw = -(-true_width * comp.h_samp // hmax)
        ch = -(-true_height * comp.v_samp // vmax)
        bw, bh = -(-cw // 8), -(-ch // 8)
        comp.bw, comp.bh = bw, bh
        nblocks = bw * bh
        out = np.zeros((nblocks, 64), dtype=np.int32)
        pred = 0
        dc_tab, ac_tab = huff[(0, comp.dc_table)], huff[(1, comp.ac_table)]
        count_since_rst = 0
        for b in range(nblocks):
            if restart_interval and count_since_rst == restart_interval:
                code = br.consume_marker()
                if not (0xD0 <= code <= 0xD7):
                    raise ValueError(f"expected RST, got {code:#x}")
                pred = 0
                count_since_rst = 0
            out[b], pred = _decode_block(br, dc_tab, ac_tab, pred)
            count_since_rst += 1
        coeffs[comp.comp_id] = out
        return

    data = {}
    preds = {}
    tabs = {}
    bws = {}
    for c in scan_comps:
        bw, bh = plane_blocks(c)
        c.bw, c.bh = bw, bh
        data[c.comp_id] = np.zeros((bw * bh, 64), dtype=np.int32)
        preds[c.comp_id] = 0
        tabs[c.comp_id] = (huff[(0, c.dc_table)], huff[(1, c.ac_table)])
        bws[c.comp_id] = bw
    count_since_rst = 0
    for r in range(my):
        for c in range(mx):
            if restart_interval and count_since_rst == restart_interval:
                code = br.consume_marker()
                if not (0xD0 <= code <= 0xD7):
                    raise ValueError(f"expected RST, got {code:#x}")
                preds = {k: 0 for k in preds}
                count_since_rst = 0
            for comp in scan_comps:
                for dv in range(comp.v_samp):
                    for dh in range(comp.h_samp):
                        bi = ((comp.v_samp * r + dv) * bws[comp.comp_id]
                              + comp.h_samp * c + dh)
                        data[comp.comp_id][bi], preds[comp.comp_id] = \
                            _decode_block(br, *tabs[comp.comp_id],
                                          preds[comp.comp_id])
            count_since_rst += 1
    for c in scan_comps:
        coeffs[c.comp_id] = data[c.comp_id]


def _reconstruct(comps, coeffs, quant, width, height) -> np.ndarray:
    """Planes -> image; general sampling, cropped to the SOF dims.

    1 component -> [H, W] grayscale; 3 components -> [H, W, 3] RGB via
    BT.601; 2x chroma factors use the libjpeg-style 3/4-1/4 triangle
    filter, other factors sample replication.
    """
    hmax = max(c.h_samp for c in comps)
    vmax = max(c.v_samp for c in comps)
    # target plane geometry: the max-sampling component's block grid
    # (MCU-padded for interleaved scans, ceil(dim/8) for non-interleaved)
    lead = next(c for c in comps if (c.h_samp, c.v_samp) == (hmax, vmax))
    if not lead.bw:  # fallback: MCU-padded geometry
        lead.bw = -(-width // (8 * hmax)) * hmax
        lead.bh = -(-height // (8 * vmax)) * vmax
    tw, th = lead.bw * 8, lead.bh * 8
    planes = {}
    for comp in comps:
        bw, bh = comp.bw, comp.bh
        if not bw:
            bw = -(-width // (8 * hmax)) * comp.h_samp
            bh = -(-height // (8 * vmax)) * comp.v_samp
        pix = _idct_blocks(coeffs[comp.comp_id], quant[comp.quant_id])
        plane = _from_blocks(pix, bh * 8, bw * 8)
        if comp.h_samp != hmax or comp.v_samp != vmax:
            plane = _upsample(plane, hmax // comp.h_samp, vmax // comp.v_samp)
        planes[comp.comp_id] = plane[:th, :tw]
    if len(comps) == 1:
        y = planes[comps[0].comp_id]
        return np.clip(np.round(y), 0, 255).astype(np.uint8)[:height, :width]
    y = planes[comps[0].comp_id]
    cb = planes[comps[1].comp_id] - 128.0
    cr = planes[comps[2].comp_id] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)[:height, :width]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two uint8 images."""
    diff = a.astype(np.float64) - b.astype(np.float64)
    mse = np.mean(diff * diff)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / mse))
