"""JFIF marker stream emission for baseline and progressive files.

The port's own copy of ``jpeg_tpu.bitstream.jfif``: SOI/APP0/DQT/DHT/
SOF0/DRI, the interleaved and single-component SOS headers, RSTn and EOI,
the grayscale header, the SOF size patch, the 3-scan and interleaved
assembly, and the progressive writers (SOF2, the DC and AC band SOS
headers, ``assemble_progressive``).  Bytes equal the original's
(``tests/test_torch_host.py``).
"""
from __future__ import annotations

import numpy as np

from ..core import tables as T
from ..huffman.build import HuffmanTable

SOI = b"\xff\xd8"
EOI = b"\xff\xd9"

# APP0 JFIF header: version 1.1, no units, 72x72 density, no thumbnail
APP0 = bytes([
    0xFF, 0xE0, 0x00, 0x10, 0x4A, 0x46, 0x49, 0x46, 0x00,
    0x01, 0x01, 0x00, 0x00, 0x48, 0x00, 0x48, 0x00, 0x00,
])


def dqt_segment(table_id: int, quantizer: np.ndarray) -> bytes:
    """DQT with the 64 entries in zig-zag order."""
    zz = quantizer.reshape(64)[T.SCAN_ORDER]
    return bytes([0xFF, 0xDB, 0x00, 0x43, table_id]) + bytes(int(v) for v in zz)


def dht_segment(tc_th: int, table: HuffmanTable) -> bytes:
    """DHT for one table; tc_th packs class (hi nibble: 0=DC, 1=AC) and id
    (lo nibble: 0=luma, 1=chroma)."""
    bits = [int(table.bits[i]) for i in range(1, 17)]
    vals = [int(v) for v in table.huffval]
    length = 19 + len(vals)
    return bytes([0xFF, 0xC4, (length >> 8) & 0xFF, length & 0xFF, tc_th]) + \
        bytes(bits) + bytes(vals)


def sof0_segment(width: int, height: int,
                 y_sampling: tuple[int, int] = (2, 2),
                 gray: bool = False) -> bytes:
    """Baseline SOF0: 3 components, Y sampling ``y_sampling``, chroma 1x1;
    gray=True emits a single-component frame."""
    ys = ((y_sampling[0] << 4) | y_sampling[1]) & 0xFF
    if gray:
        return bytes([
            0xFF, 0xC0, 0x00, 0x0B, 0x08,
            (height >> 8) & 0xFF, height & 0xFF,
            (width >> 8) & 0xFF, width & 0xFF,
            0x01,
            0x01, 0x11, 0x00,
        ])
    return bytes([
        0xFF, 0xC0, 0x00, 0x11, 0x08,
        (height >> 8) & 0xFF, height & 0xFF,
        (width >> 8) & 0xFF, width & 0xFF,
        0x03,
        0x01, ys, 0x00,
        0x02, 0x11, 0x01,
        0x03, 0x11, 0x01,
    ])


def dri_segment(restart_interval: int) -> bytes:
    """DRI: restart interval in MCUs (16-bit field, T.81 B.2.4.4)."""
    if not (0 < restart_interval <= 0xFFFF):
        raise ValueError(
            f"restart interval {restart_interval} exceeds the 16-bit DRI "
            "field; use more segments (smaller restart_interval_mcu_rows)")
    return bytes([0xFF, 0xDD, 0x00, 0x04,
                  (restart_interval >> 8) & 0xFF, restart_interval & 0xFF])


def sos_header_single(component_id: int, dc_table: int, ac_table: int) -> bytes:
    """Non-interleaved single-component SOS header."""
    return bytes([0xFF, 0xDA, 0x00, 0x08, 0x01, component_id,
                  ((dc_table << 4) | ac_table) & 0xFF, 0x00, 0x3F, 0x00])


def sos_header_interleaved() -> bytes:
    """Interleaved 3-component SOS header (Y->tables 0, Cb/Cr->tables 1)."""
    return bytes([0xFF, 0xDA, 0x00, 0x0C, 0x03,
                  0x01, 0x00, 0x02, 0x11, 0x03, 0x11,
                  0x00, 0x3F, 0x00])


def rst_marker(index: int) -> bytes:
    """RSTn marker, n = index mod 8."""
    return bytes([0xFF, 0xD0 + (index % 8)])


def headers(width: int, height: int, luma_q: np.ndarray,
            chroma_q: np.ndarray, tables: dict[str, HuffmanTable],
            restart_interval: int = 0,
            y_sampling: tuple[int, int] = (2, 2),
            progressive: bool = False,
            include_dht: bool = True) -> bytes:
    """Everything from SOI up to (excluding) the first SOS.

    ``progressive=True`` emits SOF2 instead of SOF0; ``include_dht=False``
    leaves out the table segments (per-scan DHTs follow instead).
    """
    sof = (sof2_segment if progressive else sof0_segment)(
        width, height, y_sampling=y_sampling)
    out = [
        SOI,
        APP0,
        dqt_segment(0, luma_q),
        dqt_segment(1, chroma_q),
    ]
    if include_dht:
        out += [
            dht_segment(0x00, tables["luma_dc"]),
            dht_segment(0x10, tables["luma_ac"]),
            dht_segment(0x01, tables["chroma_dc"]),
            dht_segment(0x11, tables["chroma_ac"]),
        ]
    out.append(sof)
    if restart_interval:
        out.append(dri_segment(restart_interval))
    return b"".join(out)


def headers_gray(width: int, height: int, luma_q, tables,
                 restart_interval: int = 0) -> bytes:
    """Single-component (grayscale) header: luma tables only."""
    out = [
        SOI,
        APP0,
        dqt_segment(0, luma_q),
        dht_segment(0x00, tables["luma_dc"]),
        dht_segment(0x10, tables["luma_ac"]),
        sof0_segment(width, height, gray=True),
    ]
    if restart_interval:
        out.append(dri_segment(restart_interval))
    return b"".join(out)


def sof2_segment(width: int, height: int,
                 y_sampling: tuple[int, int] = (2, 2)) -> bytes:
    """Progressive DCT SOF2 (same payload layout as SOF0)."""
    seg = bytearray(sof0_segment(width, height, y_sampling=y_sampling))
    seg[1] = 0xC2
    return bytes(seg)


def sos_header_progressive_dc(ah: int = 0, al: int = 0) -> bytes:
    """Interleaved 3-component DC scan (Ss=Se=0); Ah/Al for successive
    approximation (Ah=0 first scan, Ah=Al+1 refinement)."""
    return bytes([0xFF, 0xDA, 0x00, 0x0C, 0x03,
                  0x01, 0x00, 0x02, 0x11, 0x03, 0x11,
                  0x00, 0x00, ((ah & 0x0F) << 4) | (al & 0x0F)])


def sos_header_progressive_ac(component_id: int, ac_table: int,
                              ss: int = 1, se: int = 63,
                              ah: int = 0, al: int = 0) -> bytes:
    """Single-component AC band scan (progressive AC scans must be
    non-interleaved, T.81 G.1.1.1.1)."""
    return bytes([0xFF, 0xDA, 0x00, 0x08, 0x01, component_id,
                  (ac_table & 0x0F), ss, se,
                  ((ah & 0x0F) << 4) | (al & 0x0F)])


def assemble_progressive(header: bytes, dc_scan: bytes,
                         ac_scans: list[tuple[int, int, int, int, bytes]]
                         ) -> bytes:
    """SOF2 stream: one interleaved DC scan, then AC band scans.

    ``ac_scans`` entries are (component_id, ac_table, ss, se, payload).
    """
    out = [header, sos_header_progressive_dc(), dc_scan]
    for cid, tab, ss, se, payload in ac_scans:
        out.append(sos_header_progressive_ac(cid, tab, ss, se))
        out.append(payload)
    out.append(EOI)
    return b"".join(out)


def patch_sof_dims(data: bytes, width: int, height: int) -> bytes:
    """Rewrite the SOFn frame dimensions in an encoded stream.

    The image is encoded padded to full MCUs but declared at its true size
    (decoders discard samples beyond the SOF dims, T.81 A.2.1).  Recognizes
    SOF0/1/2 and stops at SOS, after which entropy data follows.
    """
    pos = 2  # skip SOI
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"expected marker at {pos}")
        marker = data[pos + 1]
        if marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2
            out = bytearray(data)
            out[pos + 5] = (height >> 8) & 0xFF
            out[pos + 6] = height & 0xFF
            out[pos + 7] = (width >> 8) & 0xFF
            out[pos + 8] = width & 0xFF
            return bytes(out)
        if marker == 0xDA:  # SOS: entropy data follows, no SOF seen
            raise ValueError("no SOFn marker before SOS")
        seg_len = (data[pos + 2] << 8) | data[pos + 3]
        pos += 2 + seg_len
    raise ValueError("no SOFn marker found")


def assemble_3scan(header: bytes, y_scan: bytes, cb_scan: bytes, cr_scan: bytes) -> bytes:
    """The reference's 3 non-interleaved scans."""
    return b"".join([
        header,
        sos_header_single(1, 0, 0), y_scan,
        sos_header_single(2, 1, 1), cb_scan,
        sos_header_single(3, 1, 1), cr_scan,
        EOI,
    ])


def assemble_3scan_restarts(header: bytes,
                            scans: list[tuple[int, list[bytes]]]) -> bytes:
    """Non-interleaved scans with per-scan restart intervals.

    ``scans`` is [(interval_blocks, segments), ...] in Y, Cb, Cr order.
    Each scan gets its own DRI (per-component block counts differ; T.81
    permits DRI between scans); RSTn markers separate the segments, with
    the RST counter reset per scan.
    """
    comp = [(1, 0, 0), (2, 1, 1), (3, 1, 1)]
    out = [header]
    for (interval, segments), (cid, dc, ac) in zip(scans, comp):
        if interval:
            out.append(dri_segment(interval))
        out.append(sos_header_single(cid, dc, ac))
        for i, seg in enumerate(segments):
            if i:
                out.append(rst_marker(i - 1))
            out.append(seg)
    out.append(EOI)
    return b"".join(out)


def assemble_interleaved(header: bytes, segments: list[bytes]) -> bytes:
    """One interleaved scan built from restart-delimited segments, with
    RSTn markers between consecutive segments."""
    out = [header, sos_header_interleaved()]
    for i, seg in enumerate(segments):
        if i:
            out.append(rst_marker(i - 1))
        out.append(seg)
    out.append(EOI)
    return b"".join(out)
