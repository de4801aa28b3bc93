"""PyTorch / CUDA port of the jpeg_tpu encoders and decoder.

* ``FastBatchEncoder``: the interleaved-scan batch encode at 4:2:0, 4:2:2
  and 4:4:4 with fixed (T.81 Annex K.3), dynamic and dynamic-sampled
  Huffman tables, in f32 and the f64 exact mode, byte-identical to
  ``jpeg_tpu.pipelines.fast.FastBatchEncoder``; its ``encode_stream``
  overlaps batches on CUDA streams with pinned host buffers.
* ``BucketedEncoder`` (``encode``, ``encode_any``): mixed resolutions, one
  ``FastBatchEncoder`` per geometry (``jpeg_tpu.pipelines.bucket``).
* ``encode_progressive`` and ``encode_progressive_script``: progressive
  (SOF2) files, spectral selection and successive approximation
  (``jpeg_tpu.pipelines.progressive``).
* ``JpegEncoder`` (``encode``, ``encode_batch``, ``encode_any``,
  ``encode_region``), ``encode_jpeg`` and ``encode_gray``: the one-shot
  API of ``jpeg_tpu.pipelines.encode`` in both scan layouts ("3scan", the
  default, and "interleaved"), byte-identical to ``jpeg_tpu``'s.
* ``decode_jpeg`` and ``decode_jpeg_batch``: ``jpeg_tpu.pipelines.decode``'s
  decode API (``pipelines/decode.py`` states the routes).  A baseline
  stream with restart markers decodes in kernel G, one lane a segment; a
  baseline stream without them (gray, the 3-scan layout, DRI-less
  interleaved color) takes the speculative decode: kernel H's positions
  fixpoint, then G's entry/phase mode, then a torch stitch on the card;
  anything else, or a stream whose fixpoint does not converge, decodes on
  the host (the port's native library), with a warning under
  ``entropy_engine="auto"``.  The reconstruction runs in torch on the
  same device.
* ``ChangeMonitor`` and ``FrameComparator`` (``pipelines/monitor.py``,
  ``pipelines/diff.py``): the frame-differencing monitor.  The subsample
  and the change mask run as torch ops on the device, the region growing
  on the host after one copy of the mask, and each changed region is a
  ``JpegEncoder.encode_region``; ``process_frame`` returns a
  ``FrameResult``.
* ``parallel``: the multi-device layer on ``torch.distributed`` (one
  process a device; NCCL on the card, gloo on the CPU): ``mesh.make_mesh``
  and ``distributed.initialize``/``global_mesh``/``process_batch_slice``,
  and ``sharded.ShardedEncoder``, restart-slab sharding over a (data,
  space) mesh whose files equal one device's.  ``decode_jpeg_batch`` and
  the speculative decodes take ``mesh=`` and share the lanes of kernels
  G and H over its ranks.
* Tooling: ``python -m jpeg_tpu_torch`` (the seven subcommands of
  ``jpeg_tpu``'s CLI, with ``--device``), ``io`` (PPM, resize/pad),
  ``utils.profiling`` (``StageTimer``, ``encode_metrics``),
  ``utils.stage_dump``, ``utils.dir_compare`` and ``utils.resilience``
  (``probe_device``, and ``ResilientEncoder``: the one, opt-in, host
  fallback, which records every event).

On a CUDA device every encode step from u8 pixels to packed words, and the
Huffman decode of the card's routes, runs in the hand-written kernels
under ``csrc/``; on the CPU the same steps run their plain PyTorch twins.
The entry points run on the card unless the caller passes
``device="cpu"``.

The package imports neither ``jax`` nor anything of ``jpeg_tpu``: it keeps
its own copies of the host code it needs (``core``, ``huffman``,
``bitstream``, ``golden``, ``io``, the host side of ``pipelines/diff.py``,
``utils`` and the C++ runtime under ``native``).
"""
from .core.types import Area, EncodeConfig  # noqa: F401
from .pipelines.bucket import BucketedEncoder  # noqa: F401
from .pipelines.decode import decode_jpeg, decode_jpeg_batch  # noqa: F401
from .pipelines.encode import JpegEncoder, encode_gray, encode_jpeg  # noqa: F401
from .pipelines.diff import FrameComparator  # noqa: F401
from .pipelines.fast import FastBatchEncoder  # noqa: F401
from .pipelines.monitor import ChangeMonitor, FrameResult  # noqa: F401
from .pipelines.progressive import (encode_progressive,  # noqa: F401
                                    encode_progressive_script)

__all__ = ["Area", "BucketedEncoder", "ChangeMonitor", "EncodeConfig",
           "FastBatchEncoder", "FrameComparator", "FrameResult",
           "JpegEncoder", "decode_jpeg", "decode_jpeg_batch", "encode_gray",
           "encode_jpeg", "encode_progressive", "encode_progressive_script"]
