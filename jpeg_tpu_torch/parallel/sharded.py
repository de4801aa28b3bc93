"""Sharded JPEG encoding over a (data, space) mesh (the port of
``jpeg_tpu.parallel.sharded``).

A batch of images is data-parallel over the ``data`` mesh axis, and each
image's MCU rows are spatially sharded over the ``space`` axis in
restart-delimited slabs.  Because the interleaved scan resets DC
prediction at every RSTn marker, each rank's entropy segments are fully
independent: no halo exchange is needed.  The only collective of the
encode proper is an ``all_reduce`` (sum) of each image's symbol
histograms over ``space`` (dynamic tables), over NCCL on the card's
tensors or gloo on the CPU's.

Each rank encodes its slab with a ``FastBatchEncoder`` built on the slab
geometry, ``segs_per_device`` restart segments a slab, running exactly
its stages:

* fixed tables: kernels A, B, C, D (f64 exact mode: ``analyze_zz``, then
  B explicit, C, D);
* dynamic tables: A and E (f64: ``analyze_zz`` and E explicit), the
  histograms' ``all_reduce`` over ``space``, the K.2 builds and LUTs on
  the host, then F, C and D.  ``"dynamic-sampled"`` is encoded as
  ``"dynamic"``: ``jpeg_tpu``'s sharded encoder counts every block and
  builds its tables with no +1 floor, and so does this one.

Then the ranks gather the totals and the used word prefix of every
segment (within ``space``, then across ``data``), and every rank writes
the files of the whole batch with the whole image's headers.

Not carried over from ``jpeg_tpu``: the engine switch (``_resolve_engine``:
on the port the device decides, kernels on a card and their plain twins
on the CPU), the minor-flattened ``W*3`` layout note (both [B, H, W, 3]
and [B, H, W*3] batches are accepted, as ``FastBatchEncoder`` accepts
them), ``jax.jit``/``shard_map``, and the Pallas engine's pixel route
(``analyze_px`` + ``dct_attach_pack_grouped`` + ``dct_index_segments``
for a slab outside its VMEM envelope): kernel A reads every slab's
pixels directly, with the same bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..bitstream import jfif
from ..core import tables as T
from ..core.types import EncodeConfig
from ..huffman.build import fixed_tables
from ..ops.color import SAMPLING_GEOMETRY, Y_SAMPLING
from ..pipelines.fast import FastBatchEncoder, _used_words, flat_batch
from .mesh import DATA_AXIS, SPACE_AXIS, all_gather_cat, axis_size

# the histogram groups of the LUT index (chroma AC, chroma DC, luma AC,
# luma DC) in jpeg_tpu's order (luma DC, luma AC, chroma DC, chroma AC)
_HIST_ORDER = [3, 2, 1, 0]


class ShardedEncoder:
    """Batch encoder over a (data, space) mesh for one image geometry.

    Per-rank slab height is ``height / space``; it must be a multiple of
    the MCU height times ``segs_per_device``.  Each segment becomes one
    restart interval.  Every rank of the mesh constructs it and calls
    ``encode_batch`` with the same global batch, and every rank gets the
    files of the whole batch.
    """

    def __init__(self, mesh, height: int, width: int,
                 config: EncodeConfig | None = None,
                 segs_per_device: int = 1):
        self.mesh = mesh
        self.config = config or EncodeConfig(scan_layout="interleaved")
        if self.config.scan_layout != "interleaved":
            raise ValueError("sharded encoding requires the interleaved layout "
                             "(restart markers delimit the shards)")
        self.sampling = self.config.subsampling
        mcu_w, mcu_h, self.y_per_mcu = SAMPLING_GEOMETRY[self.sampling]
        if height % mcu_h or width % mcu_w:
            raise ValueError(f"dimensions must be multiples of "
                             f"{mcu_w}x{mcu_h}, got {width}x{height}")
        self.height, self.width = height, width
        ns = axis_size(mesh, SPACE_AXIS)
        if height % (ns * mcu_h * segs_per_device):
            raise ValueError(
                f"height {height} not divisible into {ns} slabs of "
                f"{segs_per_device} segments with {mcu_h}-row granularity")
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.slab_h = height // ns
        self.segs_per_device = segs_per_device
        self.n_segments = ns * segs_per_device
        self.mcus_per_segment = ((self.slab_h // mcu_h // segs_per_device)
                                 * (width // mcu_w))
        self._n_data = axis_size(mesh, DATA_AXIS)
        self._d = mesh.get_local_rank(DATA_AXIS)
        self._s = mesh.get_local_rank(SPACE_AXIS)
        self._space = mesh.get_group(SPACE_AXIS)
        self._data = mesh.get_group(DATA_AXIS)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))

        self._fixed = (fixed_tables() if self.config.huffman == "fixed"
                       else None)
        huffman = ("dynamic" if self.config.huffman == "dynamic-sampled"
                   else self.config.huffman)
        self._slab = FastBatchEncoder(
            self.slab_h, width, dataclasses.replace(self.config,
                                                    huffman=huffman),
            segs_per_image=segs_per_device, device=self.device)
        self._luma_q, self._chroma_q = T.quant_tables(self.config.quality)
        self._interval = self.mcus_per_segment if self.n_segments > 1 else 0
        self._fixed_header = (self._header(self._fixed)
                              if self._fixed is not None else None)

    # -- public API ----------------------------------------------------------

    def step(self, rgbs):
        """The device step of fixed tables: global batch -> this rank's
        shard on ``self.device``: (words [B/data, segs_per_device,
        seg_words] uint32, totals [B/data, segs_per_device] int32, hists
        [B/data, 4, 256] int32 summed over ``space``; luma DC, luma AC,
        chroma DC, chroma AC, as ``jpeg_tpu``'s)."""
        if self._fixed is None:
            raise ValueError("step() requires huffman='fixed'")
        x = self._local(rgbs)
        coefs = self._slab._analysis(x)
        words, totals = self._slab._fixed_pack(coefs, x.shape[0])
        hist = self._slab._symbolize(coefs, x.shape[0])[1]
        dist.all_reduce(hist, group=self._space)
        return words, totals, hist.view(-1, 4, 256)[:, _HIST_ORDER]

    def encode_batch(self, rgbs) -> list[bytes]:
        """Encode a global [B, H, W, 3] (or [B, H, W*3]) uint8 batch ->
        the JFIF files of all B images, in order, on every rank."""
        x = self._local(rgbs)
        bl, slab = x.shape[0], self._slab
        coefs = slab._analysis(x)
        if self._fixed is not None:
            words, totals = slab._fixed_pack(coefs, bl)
            return self._assemble(words, totals, None)
        pf, hist = slab._symbolize(coefs, bl)
        dist.all_reduce(hist, group=self._space)
        hists = all_gather_cat(hist, self._data, 0).cpu().numpy()
        tables, luts = FastBatchEncoder._build_tables_batch(hists)
        mine = torch.from_numpy(luts[self._d * bl:(self._d + 1) * bl])
        words, totals = slab._pack_only(pf, mine.to(self.device))
        return self._assemble(words, totals, tables)

    # -- helpers -------------------------------------------------------------

    def _local(self, rgbs) -> torch.Tensor:
        """This rank's images and rows of a global batch -> [B/data,
        slab_h, W*3] uint8, contiguous on ``self.device``."""
        rgbs = flat_batch(rgbs, self.height, self.width,
                          "does not match encoder geometry")
        if rgbs.shape[0] % self._n_data:
            raise ValueError(f"batch {rgbs.shape[0]} not divisible by data "
                             f"axis {self._n_data}")
        bl = rgbs.shape[0] // self._n_data
        x = rgbs[self._d * bl:(self._d + 1) * bl,
                 self._s * self.slab_h:(self._s + 1) * self.slab_h]
        return x.to(self.device).contiguous()

    def _assemble(self, words: torch.Tensor, totals: torch.Tensor,
                  tables: list | None) -> list[bytes]:
        """This rank's words and totals -> the files of the whole batch.

        The totals of every segment come first, then only the used prefix
        of every segment's words (the longest stream's, and one word
        more), each gathered within ``space`` and then across ``data``;
        ``tables`` are the batch's per-image Huffman tables (None: fixed).
        """
        totals_np = self._gather_batch(totals).cpu().numpy()
        cap = _used_words(totals_np, words.shape[-1])
        prefix = words[..., :cap].contiguous().view(torch.int32)
        words_np = self._gather_batch(prefix).cpu().numpy().view(np.uint32)
        B, S = totals_np.shape
        headers = ([self._fixed_header] * B if tables is None
                   else [self._header(t) for t in tables])
        return native.assemble_interleaved(
            words_np.reshape(B * S, cap), totals_np.reshape(-1), headers, S)

    def _gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's [B/data, segs_per_device, ...] shard -> the whole
        batch's [B, n_segments, ...] (slabs within ``space``, then image
        groups across ``data``)."""
        return all_gather_cat(all_gather_cat(t, self._space, 1), self._data,
                              0)

    def _header(self, tables) -> bytes:
        """SOI .. SOS header of one whole-image file: its restart interval
        is a segment's MCUs whenever the image has more than one."""
        return jfif.headers(
            self.width, self.height, self._luma_q, self._chroma_q, tables,
            restart_interval=self._interval,
            y_sampling=Y_SAMPLING[self.sampling]
        ) + jfif.sos_header_interleaved()
