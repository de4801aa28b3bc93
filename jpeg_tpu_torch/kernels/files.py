"""Kernel I, ``write_files``: packed segment words -> whole JPEG files on
the card (``csrc/write_files.cu``).

It replaces no ``jpeg_tpu`` kernel: ``jpeg_tpu`` writes its files on the
host (``native.assemble_interleaved``), and the port keeps that library
for the callers whose words reach the host anyway (``ShardedEncoder``,
the 3-scan and progressive finishes).  The bytes are the host library's:
each file is its header, every segment's full bytes with a 0x00 after
each 0xFF and its padded tail byte, an RST marker before each segment
but the first, and EOI.  The files lie back to back, so the host fetches
one contiguous prefix and cuts it at ``bounds``.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from . import aligned, check_tensor, launch, on_cpu
from .fused import _workspace

_SHIFTS = (24, 16, 8, 0)  # the bytes of a big-endian word, first to last

# kernel I's workspace (its counters and a status word per item) by
# (device, stream): zeroed once here, and again by every launch's last CTA
_files_work: dict = {}


def capacity(n_images: int, n_segs: int, seg_words: int,
             header_bytes: int) -> int:
    """Bytes that ``n_images`` files of ``n_segs`` segments of
    ``seg_words`` words can take at most, with ``header_bytes`` of headers
    in all: every full byte stuffed, a tail byte and its stuffing a
    segment, the RST markers and EOI."""
    return header_bytes + n_images * n_segs * (8 * seg_words + 4)


def _images(n_segments: int, n_segs: int, header_offs) -> int:
    if n_segs < 1 or n_segments % n_segs:
        raise ValueError(f"{n_segments} segments are not whole images of "
                         f"{n_segs} segments")
    n = n_segments // n_segs
    if header_offs is not None and tuple(header_offs.shape) != (n + 1,):
        raise ValueError(f"header_offs: shape {tuple(header_offs.shape)}, "
                         f"expected ({n + 1},)")
    return n


def write_files_plain(words: torch.Tensor, totals: torch.Tensor,
                      header: torch.Tensor,
                      header_offs: torch.Tensor | None = None,
                      n_segs: int = 1):
    """Plain twin of ``write_files``, on any device; its ``data`` holds the
    files and nothing after them."""
    N, W = words.shape
    B, S, dev = _images(N, n_segs, header_offs), n_segs, words.device
    t = totals.to(torch.int64)
    nfull, rem = t >> 3, t & 7
    # every stream's full bytes, then its tail byte (past its last word
    # where the stream fills its words)
    nb = int(nfull.max()) + 1 if N else 1
    w = words[:, :min(W, -(-nb // 4))].view(torch.int32).to(torch.int64)
    shifts = torch.tensor(_SHIFTS, device=dev)
    byte = ((w[..., None] & 0xFFFFFFFF) >> shifts & 0xFF).reshape(
        N, 4 * w.shape[1])
    byte = torch.nn.functional.pad(byte, (0, max(nb - byte.shape[1], 0)))
    byte = byte[:, :nb]
    last = byte.gather(1, nfull[:, None])[:, 0]
    tail = torch.where(rem > 0, last | ((1 << (8 - rem)) - 1), 0xFF)
    byte = byte.scatter(1, nfull[:, None], tail[:, None])
    col = torch.arange(nb, device=dev)
    valid = col <= nfull[:, None]
    # a data byte 0xFF takes a 0x00 after it; so does a padded tail byte
    # that comes out 0xFF, but not the bare fill byte of a whole stream
    stuffed = valid & (byte == 0xFF) & ((col < nfull[:, None])
                                        | (rem > 0)[:, None])
    take = valid.to(torch.int64) + stuffed.to(torch.int64)
    seg_len = take.sum(1).view(B, S)
    if header_offs is None:
        hl = torch.full((B,), header.numel(), dtype=torch.int64, device=dev)
        h0 = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        offs = header_offs.to(torch.int64)
        hl, h0 = offs[1:] - offs[:-1], offs[:-1]
    # each file: header, segments with an RST marker before all but the
    # first, EOI
    bounds = torch.nn.functional.pad(
        torch.cumsum(hl + seg_len.sum(1) + 2 * S, 0), (1, 0))
    marks = 2 * torch.arange(S, device=dev)
    seg_start = (bounds[:-1, None] + hl[:, None]
                 + torch.cumsum(seg_len, 1) - seg_len + marks)
    out = torch.zeros(int(bounds[-1]), dtype=torch.uint8, device=dev)
    pos = seg_start.reshape(N, 1) + torch.cumsum(take, 1) - take
    out[pos[valid]] = byte[valid].to(torch.uint8)
    rst = seg_start[:, 1:] - 2
    out[rst] = 0xFF
    out[rst + 1] = (0xD0 + (torch.arange(S - 1, device=dev) & 7)).to(
        torch.uint8).expand_as(rst)
    out[bounds[1:] - 2] = 0xFF
    out[bounds[1:] - 1] = 0xD9
    img = torch.repeat_interleave(torch.arange(B, device=dev), hl)
    within = (torch.arange(img.numel(), device=dev)
              - (torch.cumsum(hl, 0) - hl)[img])
    out[bounds[img] + within] = header[h0[img] + within]
    return out, bounds


@functools.lru_cache(maxsize=None)
def _files_words(n_segments: int, seg_words: int) -> int:
    """The int64 words of kernel I's workspace, as its source sizes it."""
    return _build.library("write_files").jt_write_files_words(n_segments,
                                                              seg_words)


def write_files(words: torch.Tensor, totals: torch.Tensor,
                header: torch.Tensor, header_offs: torch.Tensor | None = None,
                n_segs: int = 1):
    """Segment streams -> (data uint8, bounds int64 [B + 1]): file ``b`` is
    ``data[bounds[b]:bounds[b + 1]]``, the files back to back from 0.

    ``words`` [B * n_segs, seg_words] uint32 and ``totals`` [B * n_segs]
    int32 are kernel D's streams and kernel C's bit totals (only each
    stream's words are read).  ``header`` uint8 holds the headers (SOI ..
    SOS header): one that every image shares where ``header_offs`` is
    None, else image ``b``'s is ``header[header_offs[b]:header_offs[b +
    1]]`` (int32 [B + 1]).  On the card ``data`` is the worst case long
    (``capacity``) and only its first ``bounds[-1]`` bytes are written.
    """
    if on_cpu(words, totals, header,
              *(() if header_offs is None else (header_offs,))):
        return write_files_plain(words, totals, header, header_offs, n_segs)
    N, W = words.shape
    B = _images(N, n_segs, header_offs)
    check_tensor("words", words, torch.uint32, (N, W))
    check_tensor("totals", totals, torch.int32, (N,))
    check_tensor("header", header, torch.uint8, (header.numel(),))
    if header_offs is not None:
        check_tensor("header_offs", header_offs, torch.int32, (B + 1,))
    if W % 4:  # the kernel reads 16-byte groups of each segment's words
        raise ValueError(f"write_files: seg_words={W} is not a multiple "
                         f"of 4")
    shared = header_offs is None
    dev = words.device
    out = torch.empty(capacity(B, n_segs, W, header.numel()
                               * (B if shared else 1)),
                      dtype=torch.uint8, device=dev)
    if N == 0:  # no files: nothing to launch
        return out, torch.zeros(1, dtype=torch.int64, device=dev)
    bounds = torch.empty(B + 1, dtype=torch.int64, device=dev)
    words = aligned(words, 16)
    launch("write_files", dev, words.data_ptr(), totals.data_ptr(),
           header.data_ptr(), None if shared else header_offs.data_ptr(),
           out.data_ptr(), bounds.data_ptr(),
           _workspace(_files_work, dev, _files_words(N, W), torch.int64),
           header.numel() if shared else 0, B, n_segs, W)
    return out, bounds
