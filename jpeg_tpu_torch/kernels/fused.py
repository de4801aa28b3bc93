"""Kernels B, C, D, E and F: coefficients -> Huffman fields -> packed
words, and the dynamic-table stages around the histogram.

* B ``symbolize_bits`` (``csrc/symbolize_bits.cu``): DC differences,
  run-length symbols and the LUT attach; ports the symbolize and attach of
  ``jpeg_tpu.kernels.fused._dct_attach_kernel`` and of the mega kernel.
* C ``segment_offsets`` (``csrc/segment_offsets.cu``): exclusive block bit
  offsets and segment totals; ports the ``carry_ref`` running sum of
  ``_place_body`` and the offset cumsum of ``_segment_place``.
* D ``place`` (``csrc/place.cu``): fields at their offsets in big-endian
  words; ports ``_place_tail_full``/``_rowacc_mxu`` and
  ``_place_acc_kernel`` plus its scatter-add.
* E ``symbolize_fields`` (``csrc/symbolize_fields.cu``): dynamic stage 1
  after the front: packed symbol fields and per-image histograms; ports
  ``front_index(emit_fields=True)``'s ``_mega_index_kernel`` after its
  front, ``dct_index_segments`` / ``dct_symbolize_segments`` and
  ``pipelines.fast.hist_1024_t``.
* F ``attach_pf`` (``csrc/attach_pf.cu``): dynamic stage 2: unpack the
  fields and attach each image's LUT, giving B's outputs for C and D;
  ports the attach of ``_pf_place_kernel`` and ``_attach_grouped_kernel``.

B and F share a fields contract (``symbolize_bits``): on the card they
write ``value`` only in the 16-byte groups of slots that hold a slot with
non-zero ``nbits``, the only groups D reads.

B and E take a segment ``layout`` (``ops.color.Layout``): the interleaved
4:2:0, 4:2:2 or 4:4:4 MCU, or one component's scan of the 3-scan layout
(``SCAN_Y``, ``SCAN_CHROMA``), which sets each block's luma flag and DC
predecessor.
Their explicit modes (the kernels ``symbolize_bits_explicit`` and
``symbolize_fields_explicit``: separate entry points of the same sources)
read each block's DC difference and luma flag (-1: a padding block, NULL
slots) from arrays instead, as the f64 exact path hands them over.  On
them sit the counterparts of three more ``jpeg_tpu.kernels.fused``
functions, with their signatures and semantics:

* ``analyze_attach_pack_segments`` (K13): B explicit, then C and D;
* ``symbolize_segments`` (K12, plus the ``hist_1024_t`` after it): E
  explicit; its fields are [S, nblk, 64] packed fields, not the TPU's
  transposed, 128-block-padded [64, n] ones, and it takes the number of
  images its histograms count;
* ``attach_pack_segments`` (K18b): F with one LUT, then C and D.

Two more sit on kernel A's pixel-block mode (``front.front_dct_px``):

* ``dct_attach_pack_segments`` (K7): A's pixel mode, then B, C and D;
* ``dct_index_xt`` (K18a): A's pixel mode on the transposed ``xt``
  layout, then E, giving the LUT index field only.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from ..ops import dct, symbols
from ..ops.color import MCU_420, Layout
from ..ops.pack import max_words_for_slots
from . import aligned, check_tensor, front, launch, on_cpu, stream_handle
from .lut import NULL_INDEX

# -- B: symbolize_bits -------------------------------------------------------


def _attach_plain(entry: torch.Tensor, extra: torch.Tensor,
                  extra_n: torch.Tensor):
    """LUT entries (code | length << 16) + amplitude fields -> (value
    uint32, nbits uint8, block bits int32)."""
    nb = (entry >> 16) + extra_n
    value = ((entry & 0xFFFF) << extra_n) | extra
    return (value.view(torch.uint32), nb.to(torch.uint8),
            nb.sum(dim=-1, dtype=torch.int32))


def _check_layout(name: str, nblk: int, layout: Layout) -> None:
    period, ypm = layout
    if not (1 <= period <= 6 and 0 <= ypm <= period) or nblk % period:
        raise ValueError(f"{name}: {nblk} blocks per segment are not whole "
                         f"MCUs of the layout {tuple(layout)}")


def symbolize_bits_plain(coef: torch.Tensor, lut: torch.Tensor,
                         layout: Layout = MCU_420):
    """Plain twin of ``symbolize_bits``, on any device."""
    idx, extra, extra_n = symbols.symbolize(coef, dct.dc_diff(coef, layout),
                                            layout)
    return _attach_plain(lut[idx], extra, extra_n)


def _fields_out(name: str, S: int, nblk: int, device: torch.device,
                out=None):
    """The (value, nbits, bits) buffers of kernel B or F: views of one
    fresh allocation (value first, so it starts where the allocation does,
    on a 16-byte boundary; then nbits, then bits), or the caller's ``out``
    triple once it has passed the kernels' checks: contiguous, of the
    fields' dtypes and shapes, on ``device``, ``value`` on a 16-byte
    boundary and ``nbits`` on a 4-byte one (the kernels' vector
    stores)."""
    if out is None:  # (as_strided: the fewest tensor ops on the host)
        n, rows = S * nblk, (nblk * 64, 64, 1)
        buf = torch.empty(n * 81, dtype=torch.int32, device=device)
        return (buf.view(torch.uint32).as_strided((S, nblk, 64), rows),
                buf.view(torch.uint8).as_strided((S, nblk, 64), rows,
                                                 n * 256),
                buf.as_strided((S, nblk), (nblk, 1), n * 80))
    value, nbits, bits = out
    check_tensor("out value", value, torch.uint32, (S, nblk, 64))
    check_tensor("out nbits", nbits, torch.uint8, (S, nblk, 64))
    check_tensor("out bits", bits, torch.int32, (S, nblk))
    if ({t.device for t in out} != {device} or value.data_ptr() % 16
            or nbits.data_ptr() % 4):
        raise ValueError(f"{name}: out must lie on the inputs' device, "
                         f"value 16-byte and nbits 4-byte aligned")
    return value, nbits, bits


def _plain_into(fields, out):
    """A plain twin's (value, nbits, bits), copied into ``out`` if given."""
    if out is None:
        return fields
    for dst, src in zip(out, fields):
        dst.copy_(src)
    return tuple(out)


def symbolize_bits(coef: torch.Tensor, lut: torch.Tensor,
                   layout: Layout = MCU_420, out=None):
    """[S, nblk, 64] int16 coefs -> (value, nbits, bits).

    ``value`` uint32 and ``nbits`` uint8 are [S, nblk, 64], one Huffman
    field (code then amplitude bits, right-aligned) per slot; ``bits`` is
    int32 [S, nblk], the bits of each block.  Each segment restarts the DC
    prediction.  ``lut`` is the [1024] int32 combined LUT; every segment
    has the block pattern ``layout``.

    The fields contract: ``nbits`` and ``bits`` are written whole;
    ``value`` is written in every 16-byte group (slots 4g..4g+3 of a
    block) that holds a slot with non-zero nbits, and on the card nowhere
    else: the other groups keep what the buffer held (kernel D, the one
    reader of ``value``, reads no other group).  The plain twin writes
    every slot (0 where NULL).  On the card the three outputs are views of
    one allocation; ``out``, a (value, nbits, bits) triple of contiguous
    buffers on the card (``value`` 16-byte and ``nbits`` 4-byte aligned),
    takes them in its place (the checks pre-fill it to show the groups
    left alone).
    """
    if on_cpu(coef, lut):
        return _plain_into(symbolize_bits_plain(coef, lut, layout), out)
    S, nblk, _ = coef.shape
    check_tensor("coef", coef, torch.int16, (S, nblk, 64))
    check_tensor("lut", lut, torch.int32, (1024,))
    _check_layout("symbolize_bits", nblk, layout)
    value, nbits, bits = _fields_out("symbolize_bits", S, nblk, coef.device,
                                     out)
    # 8-byte coefficient loads, 16-byte LUT loads (a copy where the data
    # start off that boundary)
    coef, lut = aligned(coef, 8), aligned(lut, 16)
    launch("symbolize_bits", coef.device, coef.data_ptr(), lut.data_ptr(),
           value.data_ptr(), nbits.data_ptr(), bits.data_ptr(), S, nblk,
           *layout)
    return value, nbits, bits


def _explicit_inputs(name: str, zz: torch.Tensor, dc_diff: torch.Tensor,
                     is_luma: torch.Tensor):
    """Check the explicit mode's inputs; int32 ``zz`` is narrowed to int16
    after a check that its AC slots fit (the DC slot is ignored)."""
    S, nblk, _ = zz.shape
    if zz.dtype == torch.int32:
        ac = zz[..., 1:]
        if ac.numel() and not bool(((ac >= -32768) & (ac <= 32767)).all()):
            raise ValueError(f"{name}: zz AC coefficients exceed int16")
        zz = zz.to(torch.int16)
    check_tensor("zz", zz, torch.int16, (S, nblk, 64))
    check_tensor("dc_diff", dc_diff, torch.int32, (S, nblk))
    check_tensor("is_luma", is_luma, torch.int32, (S, nblk))
    return zz


def symbolize_bits_explicit_plain(zz: torch.Tensor, dc_diff: torch.Tensor,
                                  is_luma: torch.Tensor, lut: torch.Tensor):
    """Plain twin of ``symbolize_bits_explicit``, on any device."""
    idx, extra, extra_n = symbols.symbolize_explicit(zz, dc_diff, is_luma)
    return _attach_plain(lut[idx], extra, extra_n)


def symbolize_bits_explicit(zz: torch.Tensor, dc_diff: torch.Tensor,
                            is_luma: torch.Tensor, lut: torch.Tensor,
                            out=None):
    """B's explicit mode: [S, nblk, 64] int16 (or int32) coefs, [S, nblk]
    int32 DC differences and luma flags (1, 0, -1: padding) -> B's
    (value, nbits, bits), under B's fields contract, ``out`` as B's.  The
    DC slot of ``zz`` is ignored."""
    if on_cpu(zz, dc_diff, is_luma, lut):
        return _plain_into(
            symbolize_bits_explicit_plain(zz, dc_diff, is_luma, lut), out)
    zz = _explicit_inputs("symbolize_bits_explicit", zz, dc_diff, is_luma)
    check_tensor("lut", lut, torch.int32, (1024,))
    S, nblk, _ = zz.shape
    value, nbits, bits = _fields_out("symbolize_bits_explicit", S, nblk,
                                     zz.device, out)
    zz, lut = aligned(zz, 8), aligned(lut, 16)
    launch("symbolize_bits_explicit", zz.device, zz.data_ptr(),
           dc_diff.data_ptr(), is_luma.data_ptr(), lut.data_ptr(),
           value.data_ptr(), nbits.data_ptr(), bits.data_ptr(), S, nblk)
    return value, nbits, bits


# -- C: segment_offsets ------------------------------------------------------


def segment_offsets_plain(bits: torch.Tensor):
    """Plain twin of ``segment_offsets``, on any device."""
    ends = torch.cumsum(bits, dim=-1, dtype=torch.int32)
    return ends - bits, ends[:, -1].contiguous()


# the workspaces of kernels C (its counters and a status word per tile)
# and E (a histogram row and a counter per image) by (device, stream):
# zeroed once here, and zeroed again by every launch's last CTA(s)
_offsets_work: dict = {}
_hist_work: dict = {}


def _workspace(store: dict, device: torch.device, numel: int,
               dtype: torch.dtype) -> int:
    """The address of a zeroed workspace of at least ``numel`` elements in
    ``store`` for ``device`` and PyTorch's current stream there."""
    key = (device.index, stream_handle(device.index))
    work = store.get(key)
    if work is None or work.numel() < numel:
        work = torch.zeros(max(numel, 1024), dtype=dtype, device=device)
        store[key] = work
    return work.data_ptr()


def _offsets_workspace(device: torch.device, words: int) -> int:
    """Kernel C's workspace: int64 counters and status words."""
    return _workspace(_offsets_work, device, words, torch.int64)


@functools.lru_cache(maxsize=None)
def _offsets_words(S: int, nblk: int) -> int:
    """The int64 words of kernel C's workspace at [S, nblk], as its source
    sizes it."""
    return _build.library("segment_offsets").jt_segment_offsets_words(
        S, nblk)


def segment_offsets(bits: torch.Tensor):
    """[S, nblk] int32 block bits -> (offsets [S, nblk], totals [S]) int32.

    Offsets are exclusive and restart at 0 in every segment.  On the card
    both outputs are views of one buffer (one allocation, the cheaper).
    """
    dev = bits.device
    if dev.type != "cuda" and on_cpu(bits):
        return segment_offsets_plain(bits)
    S, nblk = bits.shape
    check_tensor("bits", bits, torch.int32, (S, nblk))
    n = S * nblk
    out = bits.new_empty(n + S)
    ptr = out.data_ptr()
    launch("segment_offsets", dev, bits.data_ptr(), ptr, ptr + 4 * n,
           _offsets_workspace(dev, _offsets_words(S, nblk)), S, nblk)
    return out.as_strided((S, nblk), (nblk, 1)), out.as_strided((S,), (1,), n)


# -- D: place ----------------------------------------------------------------


def place_plain(value: torch.Tensor, nbits: torch.Tensor,
                offs: torch.Tensor, seg_words: int) -> torch.Tensor:
    """Plain twin of ``place``, on any device."""
    S = value.shape[0]
    nb = nbits.to(torch.int64)
    # a slot with no bits has no field, whatever its value holds (kernel
    # D reads no value there; B and F need not write one)
    v = torch.where(nb > 0, value.view(torch.int32).to(torch.int64), 0)
    o = offs.to(torch.int64)[..., None] + torch.cumsum(nb, dim=-1) - nb
    w = o >> 5
    e = (o & 31) + nb
    hi = torch.where(e <= 32, v << (32 - e).clamp(min=0),
                     v >> (e - 32).clamp(min=0))
    lo = torch.where(e > 32, (v << (64 - e).clamp(max=63)) & 0xFFFFFFFF,
                     torch.zeros_like(v))
    seg_base = (torch.arange(S, device=v.device) * seg_words)[:, None, None]
    # one spare word takes the (always zero) lo half past the last word
    flat = torch.zeros(S * seg_words + 1, dtype=torch.int64, device=v.device)
    # the fields' bit ranges are disjoint, so adding them is OR-ing them
    flat.index_add_(0, (seg_base + w).reshape(-1), hi.reshape(-1))
    flat.index_add_(0, (seg_base + w + 1).reshape(-1), lo.reshape(-1))
    words = flat[:-1].reshape(S, seg_words)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).view(torch.uint32)


def place(value: torch.Tensor, nbits: torch.Tensor, offs: torch.Tensor,
          totals: torch.Tensor, seg_words: int,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """Fields at their bit offsets -> words uint32 [S, seg_words].

    ``value``/``nbits`` are ``symbolize_bits``' fields (value < 2^nbits;
    a slot whose nbits is 0 has no field, and its value is not read),
    ``offs`` and ``totals`` the block offsets and segment totals of
    ``segment_offsets``.  Bit i of a segment's stream is bit ``31 - (i &
    31)`` of word ``i >> 5``.  The words ``[0, ceil(totals[s] / 32))`` of
    segment ``s`` hold its stream, the bits after ``totals[s]`` 0; the
    kernel does not write the words past them (the plain twin gives 0s
    there), and no consumer reads them.  ``out``, a contiguous [S,
    seg_words] uint32 buffer on the card, takes the words in place of a
    fresh one (the checks pre-fill it to show the words left alone).
    """
    if on_cpu(value, nbits, offs, totals):
        words = place_plain(value, nbits, offs, seg_words)
        return words if out is None else out.copy_(words)
    S, nblk, _ = value.shape
    check_tensor("value", value, torch.uint32, (S, nblk, 64))
    check_tensor("nbits", nbits, torch.uint8, (S, nblk, 64))
    check_tensor("offs", offs, torch.int32, (S, nblk))
    check_tensor("totals", totals, torch.int32, (S,))
    # the buffer must hold the worst case of every slot (so no stream runs
    # past its segment's words), and bit offsets must fit int32
    need = max_words_for_slots(nblk * 64)
    if seg_words < need or seg_words * 32 >= 2 ** 31:
        raise ValueError(f"place: seg_words={seg_words} must be in "
                         f"[{need}, 2^26) for {nblk} blocks per segment")
    if out is None:
        out = torch.empty((S, seg_words), dtype=torch.uint32,
                          device=value.device)
    else:
        check_tensor("out", out, torch.uint32, (S, seg_words))
        if out.device != value.device or out.data_ptr() % 16:
            raise ValueError("place: out must lie 16-byte aligned on the "
                             "fields' device")
    # 16-byte loads (a copy where the data start off that boundary)
    value, nbits = aligned(value, 16), aligned(nbits, 16)
    launch("place", value.device, value.data_ptr(), nbits.data_ptr(),
           offs.data_ptr(), totals.data_ptr(), out.data_ptr(), S, nblk,
           seg_words)
    return out


# -- E: symbolize_fields -----------------------------------------------------


def pack_fields(idx, extra, extra_n):
    """One int32 per slot: idx | extra_n << 10 | extra << 14 (all fields
    non-negative; ``jpeg_tpu.kernels.fused._pack_fields``)."""
    return idx | (extra_n << 10) | (extra << 14)


def unpack_fields(pf):
    """``pack_fields``' inverse -> (idx, extra, extra_n)."""
    return pf & 1023, pf >> 14, (pf >> 10) & 15


def _histograms(idx: torch.Tensor, n_images: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """[n_images, 1024] int32 counts of each image's non-NULL LUT indices
    (over the blocks whose ``mask`` byte is non-zero, if given)."""
    per_image = idx.reshape(n_images, -1, 64)
    keep = per_image != NULL_INDEX
    if mask is not None:
        keep &= mask.to(torch.bool)[None, :, None]
    image = torch.arange(n_images, device=idx.device)[:, None, None]
    flat = (image * 1024 + per_image)[keep].to(torch.int64)
    counts = torch.bincount(flat, minlength=n_images * 1024)
    return counts.to(torch.int32).view(n_images, 1024)


def symbolize_fields_plain(coef: torch.Tensor, n_images: int,
                           mask: torch.Tensor | None = None,
                           layout: Layout = MCU_420,
                           hist: torch.Tensor | None = None):
    """Plain twin of ``symbolize_fields``, on any device."""
    idx, extra, extra_n = symbols.symbolize(coef, dct.dc_diff(coef, layout),
                                            layout)
    counts = _histograms(idx, n_images, mask)
    if hist is not None:
        hist += counts
        counts = hist
    return pack_fields(idx, extra, extra_n), counts


def symbolize_fields(coef: torch.Tensor, n_images: int,
                     mask: torch.Tensor | None = None,
                     layout: Layout = MCU_420,
                     hist: torch.Tensor | None = None):
    """[S, nblk, 64] int16 coefs of ``n_images`` images -> (pf, hist).

    ``pf`` int32 [S, nblk, 64] holds each slot's ``pack_fields``; ``hist``
    int32 [n_images, 1024] counts each image's LUT indices over its slots,
    or over the slots of the blocks whose ``mask`` byte (uint8 [blocks per
    image], in block order) is non-zero.  NULL slots are not counted, so
    bin 1023 is 0.  Each image is ``S / n_images`` consecutive segments of
    the block pattern ``layout``, and each segment restarts the DC
    prediction.  Given ``hist`` (on the card: 16-byte aligned), the counts
    are added to it in place (a 3-scan image's Y scan and its Cb + Cr
    scans, whose bins are disjoint, count into one row) and it is
    returned.
    """
    tensors = [coef] + [t for t in (mask, hist) if t is not None]
    if on_cpu(*tensors):
        return symbolize_fields_plain(coef, n_images, mask, layout, hist)
    S, nblk, _ = coef.shape
    check_tensor("coef", coef, torch.int16, (S, nblk, 64))
    if n_images < 1 or S % n_images or n_images > 65535:
        raise ValueError(f"symbolize_fields: {S} segments are not "
                         f"{n_images} images")
    _check_layout("symbolize_fields", nblk, layout)
    if mask is not None:
        check_tensor("mask", mask, torch.uint8, (S // n_images * nblk,))
    dev = coef.device
    accumulate = hist is not None
    if accumulate:
        check_tensor("hist", hist, torch.int32, (n_images, 1024))
        if hist.data_ptr() % 16:
            raise ValueError("symbolize_fields: hist must start on a "
                             "16-byte boundary")
    else:
        hist = torch.empty((n_images, 1024), dtype=torch.int32, device=dev)
    pf = torch.empty((S, nblk, 64), dtype=torch.int32, device=dev)
    coef = aligned(coef, 8)  # 8-byte loads
    launch("symbolize_fields", dev, coef.data_ptr(),
           None if mask is None else mask.data_ptr(), pf.data_ptr(),
           hist.data_ptr(), _hist_workspace(dev, n_images), n_images,
           S // n_images, nblk, *layout, int(accumulate))
    return pf, hist


def _hist_workspace(device: torch.device, n_images: int) -> int:
    """Kernel E's workspace: a histogram row and a counter per image."""
    return _workspace(_hist_work, device, n_images * 1025, torch.int32)


# -- F: attach_pf ------------------------------------------------------------


def attach_pf_plain(pf: torch.Tensor, luts: torch.Tensor):
    """Plain twin of ``attach_pf``, on any device."""
    S = pf.shape[0]
    idx, extra, extra_n = unpack_fields(pf)
    image = torch.arange(S, device=pf.device) // (S // luts.shape[0])
    return _attach_plain(luts[image[:, None, None], idx], extra, extra_n)


def attach_pf(pf: torch.Tensor, luts: torch.Tensor, out=None):
    """Packed fields + per-image LUTs -> (value, nbits, bits).

    ``pf`` is ``symbolize_fields``' [S, nblk, 64] int32, ``luts`` the
    [n_images, 1024] int32 combined LUTs; segment ``s`` uses LUT
    ``s // (S // n_images)``.  The outputs, their fields contract and
    ``out`` are ``symbolize_bits``'.
    """
    if on_cpu(pf, luts):
        return _plain_into(attach_pf_plain(pf, luts), out)
    S, nblk, _ = pf.shape
    n_images = luts.shape[0]
    check_tensor("pf", pf, torch.int32, (S, nblk, 64))
    check_tensor("luts", luts, torch.int32, (n_images, 1024))
    if n_images < 1 or S % n_images or n_images > 65535:
        raise ValueError(f"attach_pf: {S} segments are not {n_images} "
                         f"images")
    value, nbits, bits = _fields_out("attach_pf", S, nblk, pf.device, out)
    pf, luts = aligned(pf, 16), aligned(luts, 16)  # 16-byte loads
    launch("attach_pf", pf.device, pf.data_ptr(), luts.data_ptr(),
           value.data_ptr(), nbits.data_ptr(), bits.data_ptr(), n_images,
           S // n_images, nblk)
    return value, nbits, bits


# -- the K12, K13 and K18b counterparts ---------------------------------------


def _pack(value, nbits, bits, n_segments: int, seg_rows: int):
    """C then D over S segments -> (words [S, seg_rows * 128] uint32,
    total_bits [S] int32)."""
    if n_segments != value.shape[0]:
        raise ValueError(f"n_segments={n_segments} != leading dim "
                         f"{value.shape[0]}")
    offs, totals = segment_offsets(bits)
    return place(value, nbits, offs, totals, seg_rows * 128), totals


def pack_plain(value, nbits, bits, seg_rows: int):
    """C then D as their plain twins (the composites' plain versions)."""
    offs, totals = segment_offsets_plain(bits)
    return place_plain(value, nbits, offs, seg_rows * 128), totals


def analyze_attach_pack_segments(lut: torch.Tensor, zz: torch.Tensor,
                                 dc_diff: torch.Tensor, is_luma: torch.Tensor,
                                 n_segments: int, seg_rows: int):
    """Fixed-LUT symbolize + attach + pack of S segments (the port of
    ``jpeg_tpu.kernels.fused.analyze_attach_pack_segments``, K13).

    zz [S, nblk, 64] int16/int32 un-diffed zig-zag coefs (slot 0 ignored),
    dc_diff [S, nblk] and is_luma [S, nblk] int32 (1 luma, 0 chroma, -1
    padding) -> (words [S, seg_rows * 128] uint32, total_bits [S] int32).
    Kernel B in its explicit mode, then C and D.
    """
    return _pack(*symbolize_bits_explicit(zz, dc_diff, is_luma, lut),
                 n_segments, seg_rows)


def symbolize_segments_plain(zz: torch.Tensor, dc_diff: torch.Tensor,
                             is_luma: torch.Tensor, n_segments: int,
                             n_images: int):
    """Plain twin of ``symbolize_segments``, on any device."""
    idx, extra, extra_n = symbols.symbolize_explicit(zz, dc_diff, is_luma)
    return pack_fields(idx, extra, extra_n), _histograms(idx, n_images)


def symbolize_segments(zz: torch.Tensor, dc_diff: torch.Tensor,
                       is_luma: torch.Tensor, n_segments: int,
                       n_images: int):
    """Symbolization pass of the f64 dynamic path (the port of
    ``jpeg_tpu.kernels.fused.symbolize_segments``, K12, and of the
    ``hist_1024_t`` after it): kernel E in its explicit mode.

    zz [S, nblk, 64] int16/int32 un-diffed zig-zag coefs (slot 0 ignored),
    dc_diff [S, nblk] and is_luma [S, nblk] int32 (1 luma, 0 chroma, -1
    padding) of ``n_images`` images (``S / n_images`` consecutive segments
    each) -> (pf [S, nblk, 64] int32 packed fields, hist [n_images, 1024]
    int32, NULL slots not counted).
    """
    S, nblk, _ = zz.shape
    if n_segments != S:
        raise ValueError(f"n_segments={n_segments} != leading dim {S}")
    if on_cpu(zz, dc_diff, is_luma):
        return symbolize_segments_plain(zz, dc_diff, is_luma, n_segments,
                                        n_images)
    zz = _explicit_inputs("symbolize_segments", zz, dc_diff, is_luma)
    if n_images < 1 or S % n_images or n_images > 65535:
        raise ValueError(f"symbolize_segments: {S} segments are not "
                         f"{n_images} images")
    dev = zz.device
    pf = torch.empty((S, nblk, 64), dtype=torch.int32, device=dev)
    hist = torch.empty((n_images, 1024), dtype=torch.int32, device=dev)
    zz = aligned(zz, 8)  # 8-byte loads
    launch("symbolize_fields_explicit", dev, zz.data_ptr(),
           dc_diff.data_ptr(), is_luma.data_ptr(), pf.data_ptr(),
           hist.data_ptr(), _hist_workspace(dev, n_images), n_images,
           S // n_images, nblk)
    return pf, hist


def attach_pack_segments(lut: torch.Tensor, idx: torch.Tensor,
                         extra: torch.Tensor, extra_n: torch.Tensor,
                         n_segments: int, seg_rows: int):
    """Fixed-LUT attach + pack over slot arrays (the port of
    ``jpeg_tpu.kernels.fused.attach_pack_segments``, K18b).

    idx/extra/extra_n [S, nblk, 64] int32 (``ops.symbols.symbolize``'s) and
    the [1024] int32 LUT -> (words [S, seg_rows * 128] uint32, total_bits
    [S] int32).  Kernel F with one LUT, then C and D.
    """
    pf = pack_fields(idx, extra, extra_n).contiguous()
    return _pack(*attach_pf(pf, lut[None].contiguous()), n_segments,
                 seg_rows)


# -- the K7 and K18a counterparts: kernel A's pixel-block mode ----------------


def dct_attach_pack_segments_plain(lut, m, bias, ql, qc, px,
                                   n_segments: int, period: int, ypm: int,
                                   seg_rows: int):
    """Plain twin of ``dct_attach_pack_segments``, on any device."""
    layout = Layout(period, ypm)
    coef = front.front_dct_px_plain(px, m, bias, ql, qc, layout)
    return pack_plain(*symbolize_bits_plain(coef, lut, layout), seg_rows)


def dct_attach_pack_segments(lut, m, bias, ql, qc, px, n_segments: int,
                             period: int, ypm: int, seg_rows: int):
    """Fixed-LUT DCT + quantize + zigzag + DC diff + symbolize + attach +
    pack over S segments of pixel blocks (the port of
    ``jpeg_tpu.kernels.fused.dct_attach_pack_segments``, K7).

    px [S, nblk, 64] f32 raster-flattened pixel blocks (color-converted,
    MCU-interleaved in the pattern of ``period`` blocks whose first
    ``ypm`` are luma, NOT level-shifted: the -128 is in ``bias``); ``lut``
    the [1024] int32 combined LUT; m/bias/ql/qc as kernel A's ->
    (words [S, seg_rows * 128] uint32, total_bits [S] int32).  Kernel A's
    pixel-block mode, then B, C and D.
    """
    S = n_segments
    if S != px.shape[0]:
        raise ValueError(f"n_segments={S} != leading dim {px.shape[0]}")
    if S * seg_rows * 128 * 32 >= 2 ** 31:
        raise ValueError("segment space exceeds int32 bit offsets")
    layout = Layout(period, ypm)
    coef = front.front_dct_px(px, m, bias, ql, qc, layout)
    return _pack(*symbolize_bits(coef, lut, layout), S, seg_rows)


def _xt_segments(xt: torch.Tensor, n_segments: int, period: int) -> int:
    """Blocks per segment of the [64, nblk] ``xt``: whole 128-block tiles
    (jpeg_tpu's contract) and whole MCUs."""
    nblk = xt.shape[1]
    nblk_seg = nblk // n_segments
    if nblk_seg % 128 or nblk % n_segments:
        raise ValueError(f"per-segment blocks {nblk_seg} not tile-aligned")
    if nblk_seg % period:
        raise ValueError(f"per-segment blocks {nblk_seg} are not whole "
                         f"MCUs of {period} blocks")
    return nblk_seg


def dct_index_xt_plain(m, bias, ql, qc, xt, n_segments: int, period: int,
                       ypm: int):
    """Plain twin of ``dct_index_xt``, on any device."""
    nblk_seg = _xt_segments(xt, n_segments, period)
    layout = Layout(period, ypm)
    coef = front.front_dct_px_plain(xt, m, bias, ql, qc, layout,
                                    transposed=True)
    pf, _ = symbolize_fields_plain(coef.view(n_segments, nblk_seg, 64), 1,
                                   layout=layout)
    return (pf & 1023).view(-1, 64).T.contiguous()


def dct_index_xt(m, bias, ql, qc, xt, n_segments: int, period: int,
                 ypm: int):
    """DCT -> symbolize emitting only the combined-LUT index field, from
    the [64, nblk] transposed pixel layout (the port of
    ``jpeg_tpu.kernels.fused.dct_index_xt``, K18a).

    xt [64, nblk] f32 holds S = ``n_segments`` segments of whole 128-block
    tiles and whole MCUs (``period`` blocks, the first ``ypm`` luma);
    each segment restarts the DC chains.  Returns idx [64, nblk] int32.
    Kernel A's pixel-block mode reading ``xt`` as it lies, then E (its
    histogram unused) and ``pf & 1023`` transposed back.
    """
    nblk_seg = _xt_segments(xt, n_segments, period)
    layout = Layout(period, ypm)
    coef = front.front_dct_px(xt, m, bias, ql, qc, layout, transposed=True)
    pf, _ = symbolize_fields(coef.view(n_segments, nblk_seg, 64), 1,
                             layout=layout)
    return (pf & 1023).view(-1, 64).T.contiguous()
