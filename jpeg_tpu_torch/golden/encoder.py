"""Golden NumPy baseline-JPEG encoder — the framework's numerical oracle.

The port's own copy of ``jpeg_tpu.golden.encoder`` (the port imports
nothing of ``jpeg_tpu``): the f64 exact mode's oracle where JAX is absent.
It reaches only the port's ``core``, ``huffman`` and ``bitstream`` copies;
``tests/test_torch_host.py`` holds its bytes equal to the original's.

Reproduces, stage by stage and bit-exactly, the semantics of the reference's
desktop golden encoder (``utils/original.c``), which is itself numerically
identical to the firmware encoder (``main/encoder.c``):

* RGB->YCbCr with BT.601 coefficients and double->int truncation
  (``utils/original.c:372-374``),
* 2x2 integer-average chroma subsampling (``utils/original.c:393-404``),
* separable 8x8 forward DCT in float64 with the reference's exact summation
  order (column pass then row pass, sequential accumulation —
  ``utils/original.c:428-456``) so results are bit-identical,
* quantization by double division with truncation toward zero and clip to
  [-2048, 2047] (``utils/original.c:515-523``),
* zig-zag scan, sequential DC differencing (``utils/original.c:544-572``),
* run-length symbolization with EOB/ZRL (``utils/original.c:748-784``),
* dynamic K.2 Huffman tables with combined Cb+Cr statistics
  (``utils/original.c:788-868``),
* MSB-first bit packing with 0xFF00 stuffing and the reference's
  always-emitted scan pad byte (``fill_last_byte`` writes one byte even on a
  byte boundary, producing 0xFF — ``utils/original.c:893-899``),
* the 3-scan non-interleaved JFIF layout (``utils/original.c:1042-1128``).

Everything is vectorized NumPy (no Python per-pixel loops); this module is
fast enough to act as the CPU baseline in benchmarks and as the oracle for
the TPU kernels, and it deliberately shares no code with the device path.
"""
from __future__ import annotations

import numpy as np

from ..bitstream import jfif
from ..core import tables as T
from ..huffman.build import HuffmanTable, build_tables_from_histograms, fixed_tables

SQRT1_2 = np.float64(np.sqrt(0.5))

# bit-length lookup for |v| in [0, 4095]: DC diffs span [-4095, 4095],
# ACs [-2048, 2047] (huff_class, utils/original.c:715-725).
_BITLEN = np.zeros(4096, dtype=np.int32)
for _v in range(1, 4096):
    _BITLEN[_v] = _v.bit_length()


# --------------------------------------------------------------------------
# Stage 1-2: color conversion + chroma subsampling
# --------------------------------------------------------------------------

def rgb_to_ycbcr(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BT.601 full-range conversion with double->int truncation.

    Expression grouping matches the C left-to-right evaluation
    (utils/original.c:372-374) for bit-exact float64 results.
    """
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = (0.299 * r + 0.587 * g) + 0.114 * b
    cb = ((128.0 - 0.168736 * r) - 0.331264 * g) + 0.5 * b
    cr = ((128.0 + 0.5 * r) - 0.418688 * g) - 0.081312 * b
    return (y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32))


def subsample_chroma(plane: np.ndarray) -> np.ndarray:
    """2x2 integer average (truncating), utils/original.c:393-404."""
    h, w = plane.shape
    q = plane.reshape(h // 2, 2, w // 2, 2)
    return ((q[:, 0, :, 0] + q[:, 0, :, 1] + q[:, 1, :, 0] + q[:, 1, :, 1]) // 4).astype(np.int32)


# --------------------------------------------------------------------------
# Stage 3-5: blocks, DCT, quantize, zigzag
# --------------------------------------------------------------------------

def to_blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H/8 * W/8, 8, 8] in raster block order (utils/original.c:465-471)."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8))


def dct_blocks(blocks: np.ndarray) -> np.ndarray:
    """Forward 8x8 DCT, float64, reference summation order (bit-exact).

    Column pass: inner[x_t, y_f] = sum_{y_t} (in[y_t, x_t]-128) * cos[y_t, y_f]
    Row pass:    freq[y_f, x_f]  = sum_{x_t} inner[x_t, y_f] * cos[x_t, x_f]
    then *= 1/sqrt(2) for x_f==0 and y_f==0, /= 4 (utils/original.c:428-456).
    The y_t / x_t accumulations run in index order, vectorized over blocks,
    so each output matches the C double arithmetic bit-for-bit.
    """
    cos = T.dct_cosine_table()  # [t, f]
    x = blocks.astype(np.float64) - 128.0
    n = x.shape[0]
    inner = np.zeros((n, 8, 8), dtype=np.float64)  # [block, x_t, y_f]
    for y_t in range(8):
        inner += x[:, y_t, :, None] * cos[y_t, None, :]
    freq = np.zeros((n, 8, 8), dtype=np.float64)  # [block, y_f, x_f]
    for x_t in range(8):
        freq += inner[:, x_t, :, None] * cos[x_t, None, :]
    freq[:, :, 0] *= SQRT1_2
    freq[:, 0, :] *= SQRT1_2
    freq /= 4.0
    return freq


def quantize(freq: np.ndarray, quantizer: np.ndarray) -> np.ndarray:
    """Truncating division + clip to [-2048, 2047] (utils/original.c:515-523)."""
    q = np.trunc(freq.reshape(-1, 64) / quantizer.reshape(64).astype(np.float64))
    return np.clip(q, T.COEF_CLIP_MIN, T.COEF_CLIP_MAX).astype(np.int32)


def zigzag(blocks64: np.ndarray) -> np.ndarray:
    """[..., 64] raster -> zig-zag order (utils/original.c:558-560)."""
    return blocks64[..., T.SCAN_ORDER]


def diff_dc(zz: np.ndarray) -> np.ndarray:
    """Sequential DC differencing over block order (utils/original.c:563-572)."""
    out = zz.copy()
    dc = zz[:, 0].astype(np.int64)
    out[:, 0] = np.diff(dc, prepend=np.int64(0)).astype(np.int32)
    return out


# --------------------------------------------------------------------------
# Stage 6: run-length symbolization (EOB/ZRL), vectorized
# --------------------------------------------------------------------------

def symbolize(zz: np.ndarray) -> dict[str, np.ndarray]:
    """Per-block symbol emission slots, one slot per coefficient position.

    Mirrors calc_dc_freq/calc_ac_freq/write_coefficients
    (utils/original.c:731-784, main/encoder.c:462-502): slot 0 is the DC
    symbol; an AC slot p holds either the run-length symbol for a nonzero
    coefficient, a ZRL emitted at the 16th consecutive zero, or the EOB
    emitted at position last_nonzero+1.  At most one symbol is emitted per
    position, so slot order == emission order.

    Returns arrays of shape [N, 64]: sym (uint8), extra (int64 amplitude
    bits), extra_n (int32 amplitude bit count), valid (bool).
    """
    n = zz.shape[0]
    pos = np.arange(64, dtype=np.int32)[None, :]
    v = zz.astype(np.int64)
    absv = np.abs(v)
    cls = _BITLEN[absv]
    # amplitude: negatives as ones'-complement of |v| on the low `cls` bits
    # (main/encoder.c:442-444)
    amp = np.where(v < 0, v + (np.int64(1) << cls) - 1, v)

    ac_nz = (v != 0)
    ac_nz[:, 0] = False
    # last nonzero AC position (0 if none) — write_coefficients:473-476
    m = np.maximum.accumulate(np.where(ac_nz, pos, 0), axis=1)
    last_nz = m[:, -1]
    # previous nonzero AC strictly before p (0 if none)
    prev_nz = np.concatenate([np.zeros((n, 1), np.int32), m[:, :-1]], axis=1)

    sym = np.zeros((n, 64), dtype=np.uint8)
    extra = np.zeros((n, 64), dtype=np.int64)
    extra_n = np.zeros((n, 64), dtype=np.int32)
    valid = np.zeros((n, 64), dtype=bool)

    # DC slot
    sym[:, 0] = cls[:, 0]
    extra[:, 0] = amp[:, 0]
    extra_n[:, 0] = cls[:, 0]
    valid[:, 0] = True

    # nonzero AC slots: run = zeros since previous nonzero, mod 16 after ZRLs
    run = (pos - prev_nz - 1) % 16
    sym_ac = ((run << 4) | cls).astype(np.uint8)
    np.copyto(sym, sym_ac, where=ac_nz)
    np.copyto(extra, amp, where=ac_nz)
    np.copyto(extra_n, cls, where=ac_nz)
    valid |= ac_nz

    # ZRL slots: 16th consecutive zero before the last nonzero
    # (write_coefficients:487-496)
    zero_run_incl = pos - prev_nz
    zrl = (~ac_nz) & (pos >= 1) & (pos < last_nz[:, None]) & (zero_run_incl % 16 == 0)
    np.copyto(sym, np.uint8(0xF0), where=zrl)
    valid |= zrl

    # EOB slot at last_nonzero + 1 when the block doesn't run to position 63
    eob_rows = np.nonzero(last_nz < 63)[0]
    eob_cols = last_nz[eob_rows] + 1
    sym[eob_rows, eob_cols] = 0x00
    extra[eob_rows, eob_cols] = 0
    extra_n[eob_rows, eob_cols] = 0
    valid[eob_rows, eob_cols] = True

    return {"sym": sym, "extra": extra, "extra_n": extra_n, "valid": valid}


def histogram_256(sym: np.ndarray, valid: np.ndarray) -> np.ndarray:
    return np.bincount(sym[valid].astype(np.int64), minlength=256)[:256]


# --------------------------------------------------------------------------
# Stage 7: bit packing (MSB-first, 0xFF00 stuffing, reference pad quirk)
# --------------------------------------------------------------------------

def pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Pack (value, nbits) fields MSB-first into a stuffed scan payload.

    Replicates write_byte/write_bits/fill_last_byte
    (main/encoder.c:385-432): a 0x00 is stuffed after every full 0xFF data
    byte, and one pad byte is ALWAYS appended (ones-filled; a bare 0xFF when
    the scan ends on a byte boundary) with no stuffing after it.
    """
    values = values.astype(np.int64)
    nbits = nbits.astype(np.int64)
    total = int(nbits.sum())
    nfull = total // 8
    bits = np.ones(((nfull + 1) * 8,), dtype=np.uint8)
    if len(nbits):
        offs = np.concatenate([[0], np.cumsum(nbits[:-1])])
        maxb = int(nbits.max())
        for b in range(maxb):
            sel = nbits > b
            shift = nbits[sel] - 1 - b
            bits[offs[sel] + b] = ((values[sel] >> shift) & 1).astype(np.uint8)
    by = np.packbits(bits)
    full, pad = by[:nfull], by[nfull]
    ff = full == 0xFF
    out = np.zeros(nfull + int(ff.sum()), dtype=np.uint8)
    out[np.arange(nfull) + np.concatenate([[0], np.cumsum(ff[:-1])])] = full
    return out.tobytes() + bytes([int(pad)])


def scan_payload(
    slots: dict[str, np.ndarray],
    dc_table: HuffmanTable,
    ac_table: HuffmanTable,
) -> bytes:
    """Entropy-coded payload for one scan from symbol slots."""
    sym = slots["sym"].astype(np.int64)
    is_dc = np.zeros_like(sym, dtype=bool)
    is_dc[:, 0] = True
    code = np.where(is_dc, dc_table.code[sym], ac_table.code[sym]).astype(np.int64)
    clen = np.where(is_dc, dc_table.length[sym], ac_table.length[sym]).astype(np.int64)
    valid = slots["valid"]
    if np.any((code[valid] < 0) | (clen[valid] == 0)):
        raise ValueError("symbol without a Huffman code (fixed tables too small?)")
    value = (code << slots["extra_n"]) | slots["extra"]
    nbits = clen + slots["extra_n"]
    return pack_bits(value[valid], nbits[valid])


# --------------------------------------------------------------------------
# Interleaved MCU ordering (for the restart-interval / sharded layout)
# --------------------------------------------------------------------------

def mcu_order_index(width: int, height: int) -> np.ndarray:
    """Index mapping raster Y-block order -> interleaved MCU order.

    In an interleaved scan each MCU emits its four Y blocks as
    (top-left, top-right, bottom-left, bottom-right).
    """
    bw = width // 8
    mx, my = width // 16, height // 16
    idx = np.empty(mx * my * 4, dtype=np.int64)
    k = 0
    for r in range(my):
        for c in range(mx):
            for dv in range(2):
                for dh in range(2):
                    idx[k] = (2 * r + dv) * bw + 2 * c + dh
                    k += 1
    return idx


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def encode_stages(rgb: np.ndarray, quality: int | None = None) -> dict:
    """Run all stages up to symbolization; returns every intermediate.

    This is the stage-dump tester of the reference (utils/func_tester.c)
    as a function: Pre / Dct / Quant / ZigZag / Diff for Y, Cb, Cr.
    """
    h, w, _ = rgb.shape
    if h % 16 or w % 16:
        raise ValueError(f"dimensions must be multiples of 16, got {w}x{h} "
                         "(utils/original.c:327-331); pad with io.editimage")
    luma_q, chroma_q = T.quant_tables(quality)
    y, cb, cr = rgb_to_ycbcr(rgb)
    cb_sub, cr_sub = subsample_chroma(cb), subsample_chroma(cr)
    stages: dict = {"y": y, "cb": cb_sub, "cr": cr_sub,
                    "luma_q": luma_q, "chroma_q": chroma_q,
                    "width": w, "height": h}
    for name, plane, q in (("y", y, luma_q), ("cb", cb_sub, chroma_q), ("cr", cr_sub, chroma_q)):
        blocks = to_blocks(plane)
        freq = dct_blocks(blocks)
        quant = quantize(freq, q)
        zz = zigzag(quant)
        stages[f"{name}_dct"] = freq
        stages[f"{name}_quant"] = quant
        stages[f"{name}_zigzag"] = zz
        stages[f"{name}_diff"] = diff_dc(zz)
    return stages


def encode(
    rgb: np.ndarray,
    quality: int | None = None,
    scan_layout: str = "3scan",
    restart_interval_mcu_rows: int = 0,
    huffman: str = "dynamic",
    return_stages: bool = False,
):
    """Encode an [H, W, 3] uint8 RGB image to baseline JFIF bytes."""
    stages = encode_stages(rgb, quality)
    w, h = stages["width"], stages["height"]

    if scan_layout == "3scan":
        slots_y = symbolize(stages["y_diff"])
        slots_cb = symbolize(stages["cb_diff"])
        slots_cr = symbolize(stages["cr_diff"])
        tables = _build_tables(huffman, (slots_y,), (slots_cb, slots_cr))
        header = jfif.headers(w, h, stages["luma_q"], stages["chroma_q"], tables)
        out = jfif.assemble_3scan(
            header,
            scan_payload(slots_y, tables["luma_dc"], tables["luma_ac"]),
            scan_payload(slots_cb, tables["chroma_dc"], tables["chroma_ac"]),
            scan_payload(slots_cr, tables["chroma_dc"], tables["chroma_ac"]),
        )
    elif scan_layout == "interleaved":
        out = _encode_interleaved(stages, restart_interval_mcu_rows, huffman)
    else:
        raise ValueError(f"unknown scan layout {scan_layout!r}")

    if return_stages:
        return out, stages
    return out


def _build_tables(huffman, luma_slot_groups, chroma_slot_groups):
    if huffman == "fixed":
        return fixed_tables()
    if huffman != "dynamic":
        raise ValueError(f"unknown huffman mode {huffman!r}")

    def hist(groups, col0):
        acc = np.zeros(256, dtype=np.int64)
        for s in groups:
            mask = s["valid"].copy()
            if col0 == "dc":
                mask[:, 1:] = False
            else:
                mask[:, 0] = False
            acc += histogram_256(s["sym"], mask)
        return acc

    return build_tables_from_histograms(
        hist(luma_slot_groups, "dc"), hist(luma_slot_groups, "ac"),
        hist(chroma_slot_groups, "dc"), hist(chroma_slot_groups, "ac"),
    )


def _encode_interleaved(stages, restart_interval_mcu_rows, huffman) -> bytes:
    w, h = stages["width"], stages["height"]
    mx, my = w // 16, h // 16
    rows_per_seg = restart_interval_mcu_rows or my
    n_segs = -(-my // rows_per_seg)

    y_mcu = stages["y_zigzag"][mcu_order_index(w, h)]  # [4*mx*my, 64] in MCU order
    cb = stages["cb_zigzag"]
    cr = stages["cr_zigzag"]

    # Per segment: interleave Y(4)/Cb/Cr per MCU, DC-diff per component
    # within the segment (prediction resets at restart markers).
    seg_slot_list = []
    for s in range(n_segs):
        r0, r1 = s * rows_per_seg, min((s + 1) * rows_per_seg, my)
        nm = (r1 - r0) * mx
        ys = diff_dc(y_mcu[r0 * mx * 4:(r1 * mx * 4)])
        cbs = diff_dc(cb[r0 * mx:r1 * mx])
        crs = diff_dc(cr[r0 * mx:r1 * mx])
        seq = np.empty((nm * 6, 64), dtype=np.int32)
        seq[0::6] = ys[0::4]
        seq[1::6] = ys[1::4]
        seq[2::6] = ys[2::4]
        seq[3::6] = ys[3::4]
        seq[4::6] = cbs
        seq[5::6] = crs
        slots = symbolize(seq)
        is_luma = np.zeros(nm * 6, dtype=bool)
        for j in range(4):
            is_luma[j::6] = True
        seg_slot_list.append((slots, is_luma))

    # tables over all segments
    luma_groups = [{k: v[il] for k, v in s.items()} for s, il in seg_slot_list]
    chroma_groups = [{k: v[~il] for k, v in s.items()} for s, il in seg_slot_list]
    tables = _build_tables(huffman, tuple(luma_groups), tuple(chroma_groups))

    segments = []
    for slots, is_luma in seg_slot_list:
        sym = slots["sym"].astype(np.int64)
        is_dc = np.zeros_like(sym, dtype=bool)
        is_dc[:, 0] = True
        lum = is_luma[:, None]
        code = np.where(
            is_dc,
            np.where(lum, tables["luma_dc"].code[sym], tables["chroma_dc"].code[sym]),
            np.where(lum, tables["luma_ac"].code[sym], tables["chroma_ac"].code[sym]),
        ).astype(np.int64)
        clen = np.where(
            is_dc,
            np.where(lum, tables["luma_dc"].length[sym], tables["chroma_dc"].length[sym]),
            np.where(lum, tables["luma_ac"].length[sym], tables["chroma_ac"].length[sym]),
        ).astype(np.int64)
        valid = slots["valid"]
        if np.any((code[valid] < 0) | (clen[valid] == 0)):
            raise ValueError("symbol without a Huffman code")
        value = (code << slots["extra_n"]) | slots["extra"]
        nbits = clen + slots["extra_n"]
        segments.append(pack_bits(value[valid], nbits[valid]))

    interval = rows_per_seg * mx if n_segs > 1 else 0
    header = jfif.headers(w, h, stages["luma_q"], stages["chroma_q"], tables,
                          restart_interval=interval)
    return jfif.assemble_interleaved(header, segments)
