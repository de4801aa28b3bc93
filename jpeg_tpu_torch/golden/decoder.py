"""JPEG decoder (numpy, host side): the port's bitstream oracle.

The port's own copy of ``jpeg_tpu.golden.decoder``: SOF0 baseline and
SOF2 progressive (spectral selection, successive approximation, EOBn
runs), 8-bit, 1 or 3 components, general sampling factors, interleaved
and single-component scans, DHT/DQT/DRI/RSTn, 0xFF00 stuffing, plus
``psnr``.  Baseline scans decode in the port's native library
(``native.decode_scan``, RSTn segments on host threads); there is no
pure-Python baseline walk.  ``parse_coefficients`` is the host entropy
route of ``pipelines.decode``; ``chip_smoke.py`` decodes the port's files
with ``decode``; ``tests/test_torch_host.py`` holds it equal to the
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
    quantized coefficient arrays per component, ready for numeric
    reconstruction (host ``_reconstruct`` or the device decoder in
    ``pipelines.decode``).
    """
    if data[:2] != b"\xff\xd8":
        raise ValueError("missing SOI")
    pos = 2
    quant: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], HuffmanTable] = {}
    comps: list[_Component] = []
    width = height = 0
    restart_interval = 0
    progressive = False
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
        elif marker in (0xC0, 0xC2):  # SOF0 baseline / SOF2 progressive
            progressive = marker == 0xC2
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            comps = []
            for c in range(ncomp):
                cid, samp, qid = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append(_Component(cid, samp >> 4, samp & 0x0F, qid))
        elif marker in (0xC1, 0xC3, 0xC5, 0xC6, 0xC7):
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
            ss = seg[1 + 2 * ns]
            se = seg[2 + 2 * ns]
            ah_al = seg[3 + 2 * ns]
            br = _BitReader(data, pos + seg_len)
            if progressive:
                _decode_scan_progressive(
                    br, scan_comps, comps, huff, coeffs, width, height,
                    restart_interval, ss, se, ah_al >> 4, ah_al & 0x0F)
            else:
                _decode_scan_native(br, scan_comps, comps, huff, coeffs,
                                    width, height, restart_interval)
            # continue parsing at the marker the scan stopped on
            while br.pos < len(data) and data[br.pos] != 0xFF:
                br.pos += 1
            pos = br.pos
            continue
        pos += seg_len

    return comps, coeffs, quant, width, height


def _huff_specs(huff, tc):
    """[4, 273] int32 BITS+HUFFVAL spec block for the native decoder."""
    specs = np.zeros((4, 17 + 256), np.int32)
    for (cls, th), table in huff.items():
        if cls != tc or th > 3:
            continue
        specs[th, :17] = table.bits
        specs[th, 17:17 + len(table.huffval)] = table.huffval
    return specs


def _decode_scan_native(br, scan_comps, all_comps, huff, coeffs, width,
                        height, restart_interval) -> None:
    """Run one baseline scan through the port's C++ bit-walk (which
    builds at first use and raises if it cannot)."""
    from .. import native
    hmax = max(c.h_samp for c in all_comps)
    vmax = max(c.v_samp for c in all_comps)
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    mx = -(-width // mcu_w)
    my = -(-height // mcu_h)

    if len(scan_comps) == 1:
        comp = scan_comps[0]
        cw = -(-width * comp.h_samp // hmax)
        ch = -(-height * comp.v_samp // vmax)
        bw, bh = -(-cw // 8), -(-ch // 8)
        comp.bw, comp.bh = bw, bh
        pattern = [0]
        n_mcus = bw * bh
        comp_dc = [comp.dc_table]
        comp_ac = [comp.ac_table]
    else:
        pattern = []
        comp_dc, comp_ac = [], []
        for slot, comp in enumerate(scan_comps):
            comp.bw, comp.bh = mx * comp.h_samp, my * comp.v_samp
            pattern += [slot] * (comp.h_samp * comp.v_samp)
            comp_dc.append(comp.dc_table)
            comp_ac.append(comp.ac_table)
        n_mcus = mx * my

    out, end = native.decode_scan(br.data, br.pos, _huff_specs(huff, 0),
                                  _huff_specs(huff, 1), pattern, comp_dc,
                                  comp_ac, n_mcus, restart_interval)
    br.pos = end
    br.align_and_clear()

    if len(scan_comps) == 1:
        coeffs[scan_comps[0].comp_id] = out
        return
    # scatter emission-order blocks into component planes (vectorized)
    off = 0
    for comp in scan_comps:
        hv = comp.h_samp * comp.v_samp
        sel = (np.arange(n_mcus)[:, None] * len(pattern)
               + off + np.arange(hv)).reshape(-1)
        r = np.arange(my)[:, None, None, None]
        c = np.arange(mx)[None, :, None, None]
        dv = np.arange(comp.v_samp)[None, None, :, None]
        dh = np.arange(comp.h_samp)[None, None, None, :]
        bi = ((comp.v_samp * r + dv) * comp.bw
              + comp.h_samp * c + dh).reshape(-1)
        plane = np.zeros((comp.bw * comp.bh, 64), np.int32)
        plane[bi] = out[sel]
        coeffs[comp.comp_id] = plane
        off += hv


def _decode_scan_progressive(br, scan_comps, all_comps, huff, coeffs, width,
                             height, restart_interval, ss, se, ah, al):
    """Entropy-decode one progressive (SOF2) scan — T.81 Annex G.2.

    Coefficient arrays persist across scans on the MCU-padded grid;
    non-interleaved AC scans walk the component's true ceil(dim/8) grid
    (T.81 A.2.2) and write through a row-stride mapping.  Handles DC
    first/refinement (interleaved or single-component) and AC
    first/refinement with EOBn runs.
    """
    hmax = max(c.h_samp for c in all_comps)
    vmax = max(c.v_samp for c in all_comps)
    mx = -(-width // (8 * hmax))
    my = -(-height // (8 * vmax))

    def ensure(comp):
        bw, bh = mx * comp.h_samp, my * comp.v_samp
        comp.bw, comp.bh = bw, bh
        if comp.comp_id not in coeffs:
            coeffs[comp.comp_id] = np.zeros((bw * bh, 64), np.int32)
        return coeffs[comp.comp_id]

    def expect_rst():
        code = br.consume_marker()
        if not (0xD0 <= code <= 0xD7):
            raise ValueError(f"expected RST, got {code:#x}")

    if ss == 0:  # DC scan (interleaved or single-component)
        if se != 0:
            raise ValueError("progressive scan with Ss=0 must have Se=0")
        arrs = {c.comp_id: ensure(c) for c in scan_comps}
        preds = {c.comp_id: 0 for c in scan_comps}
        tabs = {c.comp_id: huff.get((0, c.dc_table)) for c in scan_comps}
        count = 0
        if len(scan_comps) == 1:
            comp = scan_comps[0]
            cw = -(-width * comp.h_samp // hmax)
            ch = -(-height * comp.v_samp // vmax)
            walk = [(comp, r, c) for r in range(-(-ch // 8))
                    for c in range(-(-cw // 8))]
        else:
            walk = [(comp, comp.v_samp * r + dv, comp.h_samp * c + dh)
                    for r in range(my) for c in range(mx)
                    for comp in scan_comps
                    for dv in range(comp.v_samp)
                    for dh in range(comp.h_samp)]
        mcu_blocks = (1 if len(scan_comps) == 1 else
                      sum(c.h_samp * c.v_samp for c in scan_comps))
        for i, (comp, r, c) in enumerate(walk):
            if restart_interval and i and i % (restart_interval * mcu_blocks) == 0:
                expect_rst()
                preds = {k: 0 for k in preds}
            bi = r * comp.bw + c
            if ah == 0:  # first DC scan: diff-coded, point-transformed
                cls = _decode_symbol(br, tabs[comp.comp_id])
                diff = _extend(br.read_bits(cls), cls)
                preds[comp.comp_id] += diff
                arrs[comp.comp_id][bi, 0] = preds[comp.comp_id] << al
            else:  # DC refinement: one raw bit per block
                if br.read_bit():
                    arrs[comp.comp_id][bi, 0] |= 1 << al
        return

    # AC scan: single component only (T.81 G.1.1.1.1)
    if len(scan_comps) != 1:
        raise ValueError("progressive AC scans must be non-interleaved")
    comp = scan_comps[0]
    arr = ensure(comp)
    ac_tab = huff[(1, comp.ac_table)]
    cw = -(-width * comp.h_samp // hmax)
    ch = -(-height * comp.v_samp // vmax)
    tbw, tbh = -(-cw // 8), -(-ch // 8)
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    count = 0
    for r in range(tbh):
        for c in range(tbw):
            if restart_interval and count == restart_interval:
                expect_rst()
                eobrun = 0
                count = 0
            count += 1
            zz = arr[r * comp.bw + c]
            if ah == 0:
                # first AC scan (G.2.2): values enter at magnitude << al
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    sym = _decode_symbol(br, ac_tab)
                    run, size = sym >> 4, sym & 0x0F
                    if size == 0:
                        if run == 15:  # ZRL
                            k += 16
                            continue
                        eobrun = (1 << run) - 1
                        if run:
                            eobrun += br.read_bits(run)
                        break
                    k += run
                    if k > se:
                        raise ValueError("AC run past end of band")
                    zz[k] = _extend(br.read_bits(size), size) << al
                    k += 1
            else:
                # AC refinement (G.2.3): a correction bit for every
                # nonzero-history coefficient passed over; newly-
                # significant coefficients enter as +-1 << al.  Mirrors
                # the decode flow of T.81 Figure G.10 (k resumes from the
                # EOB symbol's position into the EOB-run correction pass).
                k = ss
                if eobrun == 0:
                    while k <= se:
                        sym = _decode_symbol(br, ac_tab)
                        run, size = sym >> 4, sym & 0x0F
                        if size == 0:
                            if run != 15:
                                eobrun = 1 << run
                                if run:
                                    eobrun += br.read_bits(run)
                                break
                            newval = 0  # ZRL: 16 zero-history positions
                        else:
                            if size != 1:
                                raise ValueError("refinement size must be 1")
                            newval = p1 if br.read_bit() else m1
                        # advance over `run` zero-history positions,
                        # correcting nonzero-history coefficients en route
                        while k <= se:
                            if zz[k]:
                                if br.read_bit() and (zz[k] & p1) == 0:
                                    zz[k] += p1 if zz[k] >= 0 else m1
                            else:
                                if run == 0:
                                    if newval:
                                        zz[k] = newval
                                    break
                                run -= 1
                            k += 1
                        k += 1
                if eobrun > 0:
                    # end-of-band: correction bits for the remaining
                    # nonzero-history coefficients of this block
                    while k <= se:
                        if zz[k]:
                            if br.read_bit() and (zz[k] & p1) == 0:
                                zz[k] += p1 if zz[k] >= 0 else m1
                        k += 1
                    eobrun -= 1


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
