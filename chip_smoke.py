#!/usr/bin/env python3
"""Drive the jpeg_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--runs N]

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   the build of the eleven CUDA kernels (seven sources) from
   ``jpeg_tpu_torch/csrc`` and of the port's native host library (g++);
2. every kernel against its plain PyTorch twin on the card, at the shapes
   of a 16x640x640 batch (E with and without the dynamic-sampled mask, F
   with each mode's LUTs), and in the layouts of the 3-scan path: A's
   3-scan order and its gray mode (1920x1280), B and E on the Y and the
   Cb + Cr scans (E adding both into one histogram), F with per-image
   LUTs, C on the 8 Y restart segments of 1920x1088 r17; D into a buffer
   pre-filled with 0xFFFFFFFF (no word past a stream may change; the
   streams' words compared) there, on a 38400-block Y scan, 4096
   one-block segments, explicit padding tiles, random 30-bit fields and
   streams ending on a word boundary; E on random coefficients in all
   five block patterns, with and without the mask, fresh and
   accumulating, and E explicit with padding blocks; B and E in
   their explicit modes (the f64 path's K13 and K12 counterparts; B with
   C and D as K13's whole function) and F + C + D over slot arrays (K18b;
   functions ending in D are compared on the streams' words)
   at the shapes of a 4x1920x1280 f64 batch; A's 4:2:2 and 4:4:4 modes
   (both orders), its pixel-block mode (rows and the transposed ``xt``),
   K7 (``dct_attach_pack_segments``: A's pixel mode, B, C, D) and K18a
   (``dct_index_xt``: A's pixel mode, E) at the shapes of a 4x1920x1280
   batch of each sampling; A again on uniform-random frames in every
   mode and order (every coefficient nonzero, truncation boundaries
   dense); then C again at the main paths' shapes and its edges (nblk of
   1 and its tile's 4096 +- 1, one segment of 57600 or 38400 blocks, 640
   segments), 200 launches back to back each; B, B explicit and F write
   into buffers pre-filled with all ones, are compared on the fields
   their contract defines (nbits and bits whole, value at every slot with
   non-zero nbits) and must leave every value group without bits as it
   was, at the main path's shapes and at their edges (every block
   pattern, segments of 1, 2 and 3 blocks past a multiple of four and a
   single block, all-zero blocks, blocks ending at slot 63, long ZRL
   runs, ACs of +-2047, DC differences of +-4094, explicit padding
   blocks, and a random LUT whose NULL entry is not empty), and D places
   B's own fields out of such a buffer; integer outputs must be exactly
   equal;
3. the main paths, each with the launch counts reset just before its run
   and read just after, every kernel of the path launched:
   a. ``FastBatchEncoder.encode_batch`` on 16x640x640, 4x1920x1280 and
      2x1920x1088 with 4 restart segments, once per Huffman mode ("fixed",
      "dynamic", "dynamic-sampled");
   b. ``JpegEncoder`` in the 3-scan layout: ``encode`` at 640x640,
      1920x1280 and 1920x1088 with restarts every 17 block rows, and
      ``encode_batch`` of 16x640x640, per Huffman mode; ``encode_region``
      of a 640x640 window of a 1920x1280 frame; ``encode_any`` at
      1919x1079; ``encode_gray`` at 1920x1280 (fixed and dynamic);
   c. the f64 exact mode (fixed and dynamic tables): ``FastBatchEncoder``
      at 16x640x640 and 4x1920x1280 (B or E explicit, F, C, D),
      ``JpegEncoder.encode`` 3-scan at 1920x1280 and 1920x1088 r17, and
      ``encode_gray`` at 1920x1280.  Bytes must equal the port's golden
      encoder's (``jpeg_tpu_torch.golden.encoder``, every image; it has no
      3-scan restarts and no gray mode) and, at 16x640x640, 1920x1088 r17
      and for gray, the CPU plain path's.
   d. 4:2:2 and 4:4:4, fixed and dynamic tables: ``FastBatchEncoder`` at
      16x640x640 and 4x1920x1280 of each, 4:2:2 4x1920x1080 (broadcast
      frames: 135 MCU rows of 8 px) and 2x1920x1080 with 5 restart
      segments, 4:4:4 4x1080x1080 (a width off a multiple of 16, where
      jpeg_tpu takes its pixel route); ``JpegEncoder.encode`` 3-scan at
      1920x1280 of each; and the f64 exact mode of that ``encode``.  Every
      file must equal the CPU plain path's.
   e. decode (``decode_jpeg_batch`` and ``decode_jpeg``, engine "device",
      so an ineligible stream raises): first kernel G against its plain
      twin on every lane of the 16x640x640 r1 batch, clean and corrupted,
      on the 8 long lanes of the r17 pair, and on 64 of the r1 lanes with
      rows padded into each of G's shared-memory layouts, with random bits
      and with tables off the lookahead step; then the port's own restart
      files, encoded on the card: 16x640x640 4:2:0
      r1 (640 segments), 4x1920x1280 r1, 2x1920x1088 r17 (4 segments per
      image, which jpeg_tpu sends to its host decoder), 4:2:2 2x1920x1080
      r27, 4:4:4 4x1080x1080 r1, the Y scan of a 3-scan 1920x1280 file
      with restarts (a gray stream), and one ``decode_jpeg`` of a
      1920x1280 r1 file.  Kernel G's coefficients must equal the native
      host decoder's exactly, and the pixels must be within jpeg_tpu's
      device-vs-host bound (max |diff| <= 2, > 99.9 % within 1) of the CPU
      path's reconstruction and of the golden decoder's.
   f. speculative decode of streams without restart markers (engine
      "device", then "auto" with warnings as errors): first kernel H
      (``scan_positions``) against its twin on every lane of a 3-scan
      1920x1280 file at the round-1 guesses and at the fixpoint, clean and
      corrupted, on 512 random (entry, phase) pairs over the DRI-less
      4:2:0 file's lanes, with a cap of 64, on lanes shorter than 32
      blocks, on rows padded to each of H's shared-memory layouts (four
      staged rows a CTA past 48 KB, two, one, and rows left in global
      memory) and on random bits with tables off the lookahead step, and
      G's speculative mode against its twin on the fixpoint's payload of
      a DRI-less 4:2:0 1920x1088 file and on 512 random (entry, phase)
      pairs over its lanes (its tables, and tables off the step); the
      fixpoint's decision on two corrupted copies of a 3-scan 640x640
      file against the CPU path's; then ``decode_jpeg`` of the port's
      default 3-scan files at 640x640 and 1920x1280, ``decode_jpeg_batch``
      of 16 at 640x640, ``decode_jpeg`` of DRI-less interleaved 4:2:0
      1920x1088, 4:2:2 1920x1080 and 4:4:4 1080x1080 files and of an
      ``encode_gray`` 1920x1280 file, and ``speculative_decode_restart``
      of 3e's r17 and r27 files.  Every case must converge (H and G
      launched; the rounds are printed), its zz must equal the native
      decoder's and its pixels be within jpeg_tpu's bound of the CPU path
      and the golden decoder.
   g. ``FastBatchEncoder.encode_stream`` (CUDA streams, pinned host
      buffers) of 8 batches of 16x640x640 and of 4x1920x1280, fixed and
      dynamic, at depths 4 and 2 (batch 5 uniform random, the last batch
      half the images): every batch's files must equal ``encode_batch``'s
      on the card, in order, and the heavy batch's first two the CPU
      path's; then ``BucketedEncoder.encode_any`` of 640x640, 1920x1280,
      1919x1079 and 640x640 images against the CPU path, each file
      decoded at its true size.
   h. progressive encode at 1920x1280: ``encode_progressive`` (A, F's
      one-LUT mode, C, D) fixed and dynamic, ``encode_progressive_script``
      (``SUCCESSIVE_SCRIPT``: A, then host fields and packing) fixed and
      dynamic, and ``encode_progressive`` f64 (dynamic): bytes equal to
      the CPU path's, an SOF2 marker, and the golden decoder's PSNR.
   i. the monitor: ``ChangeMonitor`` at 1920x1280 over 8 frames made from
      ``--seed`` (two rectangles moving each frame, a repeated frame, one
      with noise below the threshold, one with three more patches): every
      frame's areas, bytes and suggested delay equal to those of
      ``ChangeMonitor(..., device="cpu")``, A, E, F, C and D launched;
      ``compare_pairwise_batch`` of 16 such frames equal to the CPU's, its
      device peak under twice its input; a ``save`` on the card loaded on
      the CPU; the synthetic 640x640 pair of ``tests/conftest.py`` (rebuilt
      here); the CLI (``encode`` default, ``--fixed --interleaved
      --restart 4``, ``--progressive`` and ``--gray``, ``decode`` and
      ``diff``) on the card against ``--device cpu``: the same files byte
      for byte, the decoded PPM within the decode bound; and
      ``ResilientEncoder`` around a ``FastBatchEncoder`` on the card (no
      event, ``encode_batch``'s bytes) and around a stub that raises (the
      golden encoder's bytes, its events recorded).
   j. the multi-device layer (``jpeg_tpu_torch.parallel``): NCCL through
      ``initialize`` at world size 1 (the cards used: one), a 1x1 mesh;
      ``ShardedEncoder.encode_batch`` of 4x1920x1280 4:2:0 with 4 segments
      a slab (restarts every 20 MCU rows), fixed, dynamic,
      "dynamic-sampled" and f64 dynamic, and of 4:2:2 2x1920x1080 and
      4:4:4 4x1080x1080 dynamic with 5 (27 rows): every file equal to
      ``FastBatchEncoder``'s on the card with the same restart interval
      ("dynamic-sampled": the dynamic mode's, since jpeg_tpu's sharded
      encoder counts every block), to the CPU plain path's and (f64) to
      the golden encoder's; ``decode_jpeg_batch(mesh=...)`` of 3e's
      restart files and 3f's streams without restarts,
      ``speculative_decode(mesh=...)`` of 3f's single files and
      ``speculative_decode_restart(mesh=...)`` of its restart pairs, each
      equal to the call without a mesh; kernel G in both modes and H
      launched share by share as 2, 4 and an odd count of ranks would
      split their lanes (the last share padded with empty lanes), equal
      to one launch.  Where the machine has 2 (4) cards, a 1x2 (2x2)
      mesh of NCCL ranks (processes of this script, one a card): every
      rank decodes 3e's and 3f's cases (and a 5-lane file) over it,
      equal to the calls without it; the 4:2:0 cases run again on it (2
      segments a slab): every rank's files must equal the 1x1 mesh's,
      and their decode over the mesh the decode without one; each rank
      then times the fixed and dynamic ``encode_batch`` with the global
      batch on the host and on its card, with its device time, idle
      share and ops by name.  With one card a line says so.
   The JPEG bytes must equal those of the same call on the CPU (the plain
   twins; a batch of 3a-3c compares its first 4 images, since each
   image's tables are its own), the first file of each run must decode
   with the port's
   ``golden.decoder`` at PSNR > 28 dB, the dynamic files' DHT segments
   must differ from the fixed tables', and the restart files must carry
   DRI and RSTn markers (3-scan: a DRI per scan);
4. timings: on a 1x1 mesh brought up without ``initialize`` (an
   in-process store), ``ShardedEncoder.encode_batch`` of 3j's 4:2:0
   fixed and dynamic batch beside ``FastBatchEncoder.encode_batch`` of
   it with the same restart interval, in turns, each one's device time
   and idle share, and the collectives' device µs; the monitor's
   1920x1280 stream of 3i (ms a frame and the
   device idle share; on its five-region frame the upload, the device µs
   of subsample and mask, the mask's D2H, the host region pipeline and
   the regions' encode by kernel) and ``compare_pairwise_batch``'s ms a
   frame; per stream case of 3g, ms a batch streamed at each depth and
   as ``encode_batch`` on the same batches, in turns, with the device
   idle share over each, and each progressive case's call ms and idle
   share (a quarter of ``--runs`` each); the median of ``--runs`` warm
   runs of the device step (fixed)
   or ``dynamic_pack`` (dynamic) and of ``encode_batch`` per geometry and
   mode, the dynamic path's host split, ``JpegEncoder.encode`` per mode
   and geometry with its device time and idle share, the K.2 build of one
   image's tables, and each kernel next to its plain twin, its bound and,
   where one PyTorch call computes the same function, that call (plus F,
   and C + D, at the shapes of a 1920x1280 3-scan Y scan: the ports of
   K14 and K15), and each f64 case's call time, device time by kernel,
   idle share and the share of the device time spent in the f64
   analysis (the eager torch ops before the kernels); each 4:2:2 and
   4:4:4 case of 3d: its call ms, device time by kernel and idle share;
   each decode case of 3e: its call ms, device time, kernel G's part and
   idle share; kernel G alone at the 16x640x640 lanes with its bound, its
   twin on the same inputs, and the host entropy route on those files, G
   on the r17 pair's long lanes, its set-up's share of a launch and a
   fill of its output alone;
   each case of 3f: its call ms, device time, H's µs per round x rounds,
   G's payload µs, idle share and the host entropy route on its files
   (the restart cases beside kernel G's route on the same files); H and
   G's speculative mode alone, each beside its twin and bound; C at the
   main paths' three shapes in turns with its twin and ``torch.cumsum``,
   with the host's cost of C's wrapper and of its parts; every kernel's
   device µs per call (torch.profiler: the median of three good profiles,
   a profile that saw no device time or missed an op that every other
   one saw being dropped and replaced, up to four times; no good profile
   fails the run) beside its event
   ms, with the device ops its profiles saw, and its bound; E's traffic
   moved by PyTorch's own int16 -> int32 copy beside E and E explicit.
   The bounds count the words the streams hold, D's bytes the values of
   the non-NULL slots only, and B's and F's the value groups their
   contract writes (beside the count of every slot, as before it).

The line before the last is the ``kernels`` JSON record; the last line is
the JSON verdict.  Inputs are synthetic images (smooth gradients plus hard
edges) made with numpy from ``--seed``.  Needs one CUDA card, ``nvcc``
and ``g++``.
"""
from __future__ import annotations

import argparse
import collections
import functools
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from jpeg_tpu_torch import (Area, BucketedEncoder, ChangeMonitor,
                            EncodeConfig, FastBatchEncoder, JpegEncoder,
                            _build,
                            decode_jpeg, decode_jpeg_batch, encode_gray,
                            encode_progressive, encode_progressive_script,
                            native)
from jpeg_tpu_torch.bitstream import jfif
from jpeg_tpu_torch.golden import decoder as golden
from jpeg_tpu_torch.golden import encoder as golden_enc
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)
from jpeg_tpu_torch.kernels import huffdec as khd
from jpeg_tpu_torch.kernels import pack as kpack
from jpeg_tpu_torch.ops import color
from jpeg_tpu_torch.ops.color import (LAYOUTS, SAMPLING_GEOMETRY, SCAN_CHROMA,
                                      SCAN_Y)
from jpeg_tpu_torch.ops.dct import set_exact_matmul
from jpeg_tpu_torch.__main__ import main as cli_main
from jpeg_tpu_torch.io.ppm import read_ppm, write_ppm
from jpeg_tpu_torch.pipelines import decode as pdec
from jpeg_tpu_torch.pipelines import diff as pdiff
from jpeg_tpu_torch.pipelines import speculative as pspec
from jpeg_tpu_torch.parallel import distributed as pdist
from jpeg_tpu_torch.parallel.launch import run_ranks
from jpeg_tpu_torch.parallel.mesh import make_mesh
from jpeg_tpu_torch.parallel.sharded import ShardedEncoder
from jpeg_tpu_torch.pipelines.fast import analyze_zz
from jpeg_tpu_torch.utils.resilience import ResilientEncoder, probe_device

# (batch, height, width, restart_interval_mcu_rows)
GEOMETRIES = [(16, 640, 640, 0), (4, 1280, 1920, 0), (2, 1088, 1920, 17)]
MODES = ["fixed", "dynamic", "dynamic-sampled"]
CPU_IMAGES_DYNAMIC = 4  # images of a batch the dynamic modes check on the CPU
# the synthetic frames give 32-39 dB at full size and the unscaled tables
MIN_PSNR_DB = 28.0
# JpegEncoder.encode in the 3-scan layout: (height, width, restart rows)
SCAN_GEOMETRIES = [(640, 640, 0), (1280, 1920, 0), (1088, 1920, 17)]
FIXED_PATH = ("front_dct", "symbolize_bits", "segment_offsets", "place")
DYNAMIC_PATH = ("front_dct", "symbolize_fields", "attach_pf",
                "segment_offsets", "place")
# the f64 exact mode: FastBatchEncoder (batch, height, width); JpegEncoder
# 3-scan (height, width, restart rows); and the paths' kernels
F64_GEOMETRIES = [(16, 640, 640), (4, 1280, 1920)]
F64_SCAN_GEOMETRIES = [(1280, 1920, 0), (1088, 1920, 17)]
F64_FIXED_PATH = ("symbolize_bits_explicit", "segment_offsets", "place")
F64_DYNAMIC_PATH = ("symbolize_fields_explicit", "attach_pf",
                    "segment_offsets", "place")
F64_SCAN_PATHS = {"fixed": ("symbolize_bits", "segment_offsets", "place"),
                  "dynamic": ("symbolize_fields", "attach_pf",
                              "segment_offsets", "place")}
# 4:2:2 and 4:4:4: FastBatchEncoder runs (sampling, batch, height, width,
# restart rows), each in SAMPLING_MODES; the 3-scan encode and its f64
# exact mode at one 1920x1280 image of each; the batch of phase 2's checks
SAMPLING_GEOMETRIES = [
    ("422", 16, 640, 640, 0), ("422", 4, 1280, 1920, 0),
    ("422", 4, 1080, 1920, 0), ("422", 2, 1080, 1920, 27),
    ("444", 16, 640, 640, 0), ("444", 4, 1280, 1920, 0),
    ("444", 4, 1080, 1080, 0)]
SAMPLING_MODES = ["fixed", "dynamic"]
SAMPLING_KERNEL_BATCH = (4, 1280, 1920)
LABEL = {"420": "4:2:0", "422": "4:2:2", "444": "4:4:4", "gray": "gray"}
# decode (phase 3e): the port's interleaved restart files (sampling, batch,
# height, width, restart rows, Huffman mode), decoded by decode_jpeg_batch;
# the Y scan of a 3-scan JpegEncoder file (height, width, restart block
# rows) as a gray stream; one decode_jpeg of a 1920x1280 r1 file
DECODE_GEOMETRIES = [
    ("420", 16, 640, 640, 1, "dynamic"), ("420", 4, 1280, 1920, 1, "fixed"),
    ("420", 2, 1088, 1920, 17, "dynamic"), ("422", 2, 1080, 1920, 27, "fixed"),
    ("444", 4, 1080, 1080, 1, "dynamic")]
DECODE_GRAY = (1280, 1920, 4)
DECODE_ONE = ("420", 1, 1280, 1920, 1, "dynamic")
# speculative decode (phase 3f): the port's default 3-scan files (height,
# width) by decode_jpeg and a decode_jpeg_batch of 16 at 640x640; DRI-less
# interleaved files (sampling, height, width); an encode_gray file; and
# phase 3e's few-segment restart files (its cases 2 and 3) through
# speculative_decode_restart
SPEC_SCAN = [(640, 640), (1280, 1920)]
SPEC_BATCH = (16, 640, 640)
SPEC_INTERLEAVED = [("420", 1088, 1920), ("422", 1080, 1920),
                    ("444", 1080, 1080)]
SPEC_GRAY = (1280, 1920)
SPEC_RESTART_CASES = (2, 3)
SPEC_RNG_OFFSET = 6  # phase 3f's frames: default_rng(seed + 6)
# the frames of phase 3f (at --seed 0) where jpeg_tpu's own decode misses
# the bound below against the golden decoder (ROADMAP §3): (case label,
# image) -> its reading there, (max |diff|, share within 1 to six places),
# to which the card is held instead; tests/test_torch_golden_bound.py
# holds jpeg_tpu's decode of each frame to that reading
REFERENCE_GOLDEN_MISSES = {
    ("decode_jpeg_batch 3-scan 16x640x640", 0): (2, 0.996847),
    ("decode_jpeg_batch 3-scan 16x640x640", 2): (2, 0.980807),
    ("decode_jpeg DRI-less interleaved 4:2:0 1920x1088", 0): (2, 0.994635),
}
# jpeg_tpu's device-vs-host reconstruction bound (its
# tests/test_device_decode.py:18): f32 sums in another order
RGB_MAX_DIFF, RGB_WITHIN_1 = 2, 0.999
# the CUDA kernels by their names in a profile, and the copies
OWN_KERNELS = ("front_dct", "symbolize_bits_kernel", "segment_offsets",
               "place_kernel", "symbolize_fields_kernel", "attach_pf",
               "decode_segments_kernel", "scan_positions_kernel")

# kernel -> (source, the TPU kernels it replaces: file:line of pallas_call)
KERNEL_INFO = {
    "front_dct": ("jpeg_tpu_torch/csrc/front_dct.cu",
                  "jpeg_tpu/kernels/front.py:502 (K5); front half of "
                  "front.py:823 (K1) and front.py:916 (K2); DCT of "
                  "fused.py:576 (K6)"),
    "symbolize_bits": ("jpeg_tpu_torch/csrc/symbolize_bits.cu",
                       "jpeg_tpu/kernels/fused.py:576 (K6); symbolize + "
                       "attach of front.py:823 (K1) and fused.py:509 (K6r); "
                       "lut.py:120 (K14) on the fixed 3-scan path"),
    "symbolize_bits_explicit": ("jpeg_tpu_torch/csrc/symbolize_bits.cu",
                                "jpeg_tpu/kernels/fused.py:1459 (K13, "
                                "with C and D after it)"),
    "segment_offsets": ("jpeg_tpu_torch/csrc/segment_offsets.cu",
                        "jpeg_tpu/kernels/fused.py:1388 (K4), fused.py:1358 "
                        "(K4r); offsets of front.py:823 (K1), fused.py:642 "
                        "(K3) and pack.py:225 (K15)"),
    "place": ("jpeg_tpu_torch/csrc/place.cu",
              "jpeg_tpu/kernels/fused.py:1388 (K4), fused.py:1358 (K4r), "
              "pack.py:225 (K15) + its row scatter-add; place of "
              "front.py:823 (K1) and fused.py:642 (K3)"),
    "symbolize_fields": ("jpeg_tpu_torch/csrc/symbolize_fields.cu",
                         "jpeg_tpu/kernels/front.py:916 (K2, after its "
                         "front), fused.py:800 (K9), fused.py:829 (K10)"),
    "symbolize_fields_explicit": ("jpeg_tpu_torch/csrc/symbolize_fields.cu",
                                  "jpeg_tpu/kernels/fused.py:876 (K12) + "
                                  "pipelines/fast.py:108 (hist_1024_t)"),
    "attach_pf": ("jpeg_tpu_torch/csrc/attach_pf.cu",
                  "jpeg_tpu/kernels/fused.py:642 (K3, before its place), "
                  "fused.py:918 (K11), lut.py:120 (K14), lut.py:155 "
                  "(K18c)"),
    # K18b has no kernel of its own, and no caller in jpeg_tpu or on a
    # path of the port: launches stay 0
    "attach_pack_segments": ("jpeg_tpu_torch/csrc/attach_pf.cu + "
                             "segment_offsets.cu + place.cu (F + C + D, "
                             "kernels/fused.py::attach_pack_segments)",
                             "jpeg_tpu/kernels/fused.py:1509 (K18b)"),
    # kernel A's 4:2:2 and 4:4:4 modes: launches are front_dct's on the
    # paths of that sampling
    "front_dct 4:2:2": ("jpeg_tpu_torch/csrc/front_dct.cu "
                        "(front_dct_kernel<ColorMode<kS422>>)",
                        "jpeg_tpu/kernels/front.py:823 (K1), front.py:916 "
                        "(K2) and front.py:502 (K5) at sampling 422"),
    "front_dct 4:4:4": ("jpeg_tpu_torch/csrc/front_dct.cu "
                        "(front_dct_kernel<ColorMode<kS444>>)",
                        "jpeg_tpu/kernels/front.py:823 (K1), front.py:916 "
                        "(K2) and front.py:502 (K5) at sampling 444"),
    "front_dct_px": ("jpeg_tpu_torch/csrc/front_dct.cu "
                     "(front_dct_kernel<PxMode>)",
                     "the DCT of jpeg_tpu/kernels/fused.py:730 (K7) and "
                     "fused.py:688 (K18a)"),
    # K7 and K18a: A's pixel mode and B + C + D, or E; no caller on a path
    # of the port yet (the sharded pixel route): launches stay 0
    "dct_attach_pack_segments": ("jpeg_tpu_torch/csrc/front_dct.cu + "
                                 "symbolize_bits.cu + segment_offsets.cu + "
                                 "place.cu (A px + B + C + D, kernels/"
                                 "fused.py::dct_attach_pack_segments)",
                                 "jpeg_tpu/kernels/fused.py:730 (K7)"),
    "dct_index_xt": ("jpeg_tpu_torch/csrc/front_dct.cu + "
                     "symbolize_fields.cu (A px + E, kernels/fused.py::"
                     "dct_index_xt)", "jpeg_tpu/kernels/fused.py:688 (K18a)"),
    "decode_segments": ("jpeg_tpu_torch/csrc/huffdec.cu",
                        "jpeg_tpu/kernels/huffdec.py:853 (K16)"),
    # kernel G's speculative mode: launches are decode_segments' on the
    # speculative paths (phase 3f)
    "decode_segments speculative": ("jpeg_tpu_torch/csrc/huffdec.cu "
                                    "(decode_segments_kernel, entry and "
                                    "phase)",
                                    "jpeg_tpu/kernels/huffdec.py:853 (K16, "
                                    "entry=, phase=, phased=True)"),
    "scan_positions": ("jpeg_tpu_torch/csrc/huffdec.cu",
                       "jpeg_tpu/kernels/huffdec.py:761 (K17)"),
}

# the stream (phase 3g): (batch, height, width) of STREAM_BATCHES batches a
# run, streamed in each of STREAM_MODES at each of STREAM_DEPTHS; batch
# STREAM_HEAVY of each run is uniform random (the largest streams) and the
# last holds half the images; BucketedEncoder.encode_any on a mixed list
# of (height, width)
STREAM_GEOMETRIES = [(16, 640, 640), (4, 1280, 1920)]
STREAM_BATCHES = 8
STREAM_HEAVY = 5
STREAM_MODES = ["fixed", "dynamic"]
STREAM_DEPTHS = [4, 2]
BUCKET_LIST = [(640, 640), (1280, 1920), (1079, 1919), (640, 640)]
# progressive (phase 3h): (label, engine, Huffman mode, dtype) at
# PROGRESSIVE_SIZE; the kernels each engine's path launches
PROGRESSIVE_SIZE = (1280, 1920)
PROGRESSIVE_CASES = [
    ("spectral fixed", "spectral", "fixed", "float32"),
    ("spectral dynamic", "spectral", "dynamic", "float32"),
    ("script fixed (SUCCESSIVE_SCRIPT)", "script", "fixed", "float32"),
    ("script dynamic (SUCCESSIVE_SCRIPT)", "script", "dynamic", "float32"),
    ("spectral dynamic f64", "spectral", "dynamic", "float64")]
SPECTRAL_PATH = ("front_dct", "attach_pf", "segment_offsets", "place")
# the monitor (phase 3i): MONITOR_FRAMES frames of MONITOR_SIZE from --seed
# (a background; two rectangles moving each frame; the last frame again;
# noise below the threshold; three patches besides the rectangles), then
# compare_pairwise_batch over PAIRWISE_FRAMES frames of that size; the
# CLI's encode variants on a CLI_SIZE image (its restart interval divides
# the 40 MCU rows); ResilientEncoder around a FastBatchEncoder on a batch
# of RESILIENT_BATCH, and around a stub that raises (golden fallback, on
# RESILIENT_STUB images)
MONITOR_SIZE = (1280, 1920)
MONITOR_FRAMES = 8
MONITOR_QUIET = (3, 4)  # the frames that must give no region
MONITOR_PATCHES = 5     # the frame whose changes make more than two regions
# (y, x, height, width, dy, dx) per frame and a color: the moving rectangles
MONITOR_MOVERS = [((200, 150, 180, 240, 10, 40), (250, 30, 40)),
                  ((800, 1200, 150, 200, -20, 30), (20, 230, 60))]
MONITOR_PATCH_AT = [(40, 1700), (1150, 60), (560, 900)]  # 64x96 each
PAIRWISE_FRAMES = 16
CLI_SIZE = (640, 640)
CLI_ENCODES = {"default": [],
               "fixed interleaved r4": ["--fixed", "--interleaved",
                                        "--restart", "4"],
               "progressive": ["--progressive"], "gray": ["--gray"]}
RESILIENT_BATCH = (4, 640, 640)
RESILIENT_STUB = (2, 256, 256)
# a region's decode against its window: jpeg_tpu's own monitor bound
# (tests/test_diff.py::test_monitor_end_to_end); a window cuts hard edges
REGION_MIN_PSNR_DB = 20.0

# the multi-device layer (phase 3j): ShardedEncoder runs (label, sampling,
# batch, height, width, segments a slab on a 1x1 mesh, Huffman mode,
# dtype): restarts every 20 MCU rows at 4:2:0 (80 rows), 27 at 4:2:2 and
# 4:4:4 (135 rows of 8 px); the cases of one geometry share one batch
SHARDED_CASES = [
    ("4:2:0 fixed", "420", 4, 1280, 1920, 4, "fixed", "float32"),
    ("4:2:0 dynamic", "420", 4, 1280, 1920, 4, "dynamic", "float32"),
    ("4:2:0 dynamic-sampled", "420", 4, 1280, 1920, 4, "dynamic-sampled",
     "float32"),
    ("4:2:0 f64 dynamic", "420", 4, 1280, 1920, 4, "dynamic", "float64"),
    ("4:2:2 dynamic r27", "422", 2, 1080, 1920, 5, "dynamic", "float32"),
    ("4:4:4 dynamic r27", "444", 4, 1080, 1080, 5, "dynamic", "float32"),
]
SHARDED_RNG_OFFSET = 16
SHARDED_TIMED = ("4:2:0 fixed", "4:2:0 dynamic")
# the split over NCCL ranks, one a card, where the machine has the cards:
# (world, data, space); each run's time limit
SPLITS = [(2, 1, 2), (4, 2, 2)]
SPLIT_TIMEOUT_S = 300
SPLIT_RUNS = 5
# the lanes of a mesh decode split over ranks, emulated on one card: kernel
# G on 3e's 4:2:2 r27 pair (10 lanes), G's speculative mode and H on 3f's
# first DRI-less interleaved file, each over the shares of 2, 4 and the
# first count of ranks its lanes do not divide by
PADDED_DCASE = 3

# the kernels timed at the shapes of the f64 batch
F64_KERNELS = ("symbolize_bits_explicit", "symbolize_fields_explicit",
               "attach_pack_segments")

# NVIDIA's H100 SXM data sheet: HBM3 rate, FP32 rate outside the tensor
# cores (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def synthetic_batch(rng: np.random.Generator, b: int, h: int,
                    w: int) -> np.ndarray:
    """[b, h, w, 3] u8: smooth gradients, hard-edged shapes, light noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        f = rng.uniform(20.0, 90.0, 3)
        ph = rng.uniform(0.0, 6.3, 3)
        img = np.stack([
            128 + 90 * np.sin(xx / f[0] + ph[0]) * np.cos(yy / f[1]),
            128 + 90 * np.cos((xx + yy) / f[2] + ph[1]),
            255 * (xx + yy) / (w + h),
        ], axis=-1)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 16)
            y1 = min(h, y0 + rng.integers(16, h // 2))
            x1 = min(w, x0 + rng.integers(16, w // 2))
            img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
        img += rng.normal(0.0, 2.0, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def max_abs_err(got, want) -> int:
    """Largest |difference| over a tuple of integer outputs (shapes must
    agree)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {tuple(g.shape)} {g.dtype} != "
                                 f"plain {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((as_i64(g) - as_i64(w)).abs().max()))
    return err


def cuda_ms(fn, runs: int, inner: int = 10, warm: int = 3) -> float:
    """CUDA-event time of one call of ``fn``, in ms: the median over
    ``runs`` runs of ``inner`` back-to-back calls after ``warm`` calls,
    divided by ``inner`` (the calls queue on the stream, so the host's
    launch work overlaps the device's unless the device is the faster of
    the two)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, runs: int) -> float:
    """Median host-clock time of ``fn`` (which must end synchronized)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def config(mode: str, restart_rows: int = 0) -> EncodeConfig:
    return EncodeConfig(scan_layout="interleaved", huffman=mode,
                        restart_interval_mcu_rows=restart_rows)


def dht_segments(data: bytes) -> list[bytes]:
    """The DHT segments of a JPEG file's header, up to its SOS."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = (data[pos + 2] << 8) | data[pos + 3]
        if data[pos + 1] == 0xC4:
            out.append(data[pos:pos + 2 + n])
        pos += 2 + n
    return out


def stream_nbytes(totals: torch.Tensor) -> int:
    """The bytes of the words that the segments' streams hold:
    ceil(totals / 32) words each (kernel D writes those and no others)."""
    return int(((totals.to(torch.int64) + 31) // 32).sum()) * 4


def place_nbytes(nbits: torch.Tensor, totals: torch.Tensor) -> int:
    """The bytes kernel D must move on these fields: every nbits byte, the
    value of each non-NULL slot (a NULL slot's value is not needed), the
    block offsets and totals, and the stream words."""
    S, nblk, _ = nbits.shape
    return (nbits.numel() + 4 * int(torch.count_nonzero(nbits))
            + 4 * S * nblk + 4 * S + stream_nbytes(totals))


def bounds(B: int, H: int, W: int, n_segs: int, d_bytes: int,
           b_nbits: torch.Tensor, f_nbits: torch.Tensor):
    """kernel -> (bound_ms, bound_by): the least time the card could take
    for each kernel's work at this geometry, the larger of its bytes (each
    input read once, each output written once) over the HBM rate and its
    operations (A: the DCT's 64x64 FMAs per block) over the FP32 rate.
    D's bytes depend on the data: ``place_nbytes`` of its fields; so do
    B's and F's: ``fields_nbytes`` of their nbits (``b_nbits``,
    ``f_nbits``).  "<kernel> (per slot)" keys give B's and F's bounds as
    counted before their fields contract: every value slot written, 7 and
    9 bytes a slot."""
    nblocks = B * (H // 16) * (W // 16) * 6
    slots = nblocks * 64
    bytes_ = {
        "front_dct": B * H * W * 3 + slots * 2 + (64 * 64 + 3 * 64) * 4,
        "symbolize_bits": fields_nbytes(slots * 2, b_nbits, 1),
        "symbolize_bits (per slot)": slots * 2 + 4096 + slots * 5
        + nblocks * 4,
        "segment_offsets": nblocks * 4 * 2 + B * n_segs * 4,
        "place": d_bytes,
        "symbolize_fields": slots * 2 + slots * 4 + B * 4096,
        "attach_pf": fields_nbytes(slots * 4, f_nbits, B),
        "attach_pf (per slot)": slots * 4 + B * 4096 + slots * 5
        + nblocks * 4,
    }
    flops = {"front_dct": nblocks * 64 * 64 * 2}
    out = {}
    for name, nbytes in bytes_.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops.get(name, 0) / FP32_FLOP_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops > t_bytes
                     else (t_bytes, "bytes"))
    return out


def explicit_bounds(S: int, nblk: int, stream_bytes: int, n_images: int,
                    x_nbits: torch.Tensor):
    """bound_ms, bound_by of the f64 path's kernels and functions over S
    segments of nblk blocks (all bound by bytes: no arithmetic to speak
    of).  Inputs: zz int16, dc_diff and is_luma int32 per block, the LUT;
    K18b reads three int32 slot arrays; K13 and K18b write the streams'
    words (``stream_bytes``) and totals; B explicit its fields under their
    contract (``fields_nbytes`` of its nbits ``x_nbits``; "(per slot)":
    every value slot written, as counted before the contract)."""
    blocks, slots = S * nblk, S * nblk * 64
    words = stream_bytes + S * 4
    nbytes = {
        "symbolize_bits_explicit": fields_nbytes(slots * 2 + blocks * 8,
                                                 x_nbits, 1),
        "symbolize_bits_explicit (per slot)": slots * 2 + blocks * 8 + 4096
        + slots * 5 + blocks * 4,
        "symbolize_fields_explicit": slots * 2 + blocks * 8 + slots * 4
        + n_images * 4096,
        "attach_pack_segments": slots * 12 + 4096 + words,
        "K13": slots * 2 + blocks * 8 + 4096 + words,
    }
    return {k: (v / HBM_BYTES_PER_S * 1e3, "bytes")
            for k, v in nbytes.items()}


def sampling_bounds(B: int, H: int, W: int, sampling: str,
                    stream_bytes: int):
    """bound_ms, bound_by of A's color mode at ``sampling`` and of its
    pixel mode, K7 and K18a over that batch's blocks (one segment per
    image): the larger of their bytes over the HBM rate and the DCT's
    64x64 FMAs per block over the FP32 rate.  A px and K18a read f32
    pixel blocks; K18a writes int32 indices, K7 the streams' words
    (``stream_bytes``) and totals."""
    mcu_w, mcu_h, ypm = SAMPLING_GEOMETRY[sampling]
    nblocks = B * (H // mcu_h) * (W // mcu_w) * (ypm + 2)
    slots = nblocks * 64
    consts = (64 * 64 + 3 * 64) * 4
    nbytes = {
        f"front_dct {LABEL[sampling]}": B * H * W * 3 + slots * 2 + consts,
        "front_dct_px": slots * 4 + slots * 2 + consts,
        "dct_attach_pack_segments": slots * 4 + consts + 4096
        + stream_bytes + B * 4,
        "dct_index_xt": slots * 4 + consts + slots * 4,
    }
    t_ops = nblocks * 64 * 64 * 2 / FP32_FLOP_PER_S * 1e3
    out = {}
    for name, n in nbytes.items():
        t_bytes = n / HBM_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops > t_bytes
                     else (t_bytes, "bytes"))
    return out


def in_stream(words: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """[S, seg_words] bool: the words of each segment's stream, words
    [0, ceil(totals / 32)) (the words that kernel D's contract defines)."""
    n = (totals.to(torch.int64) + 31) // 32
    return (torch.arange(words.shape[-1], device=words.device)[None]
            < n[:, None])


def stream_words(words: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """[S, seg_words] words as int32, every word past each segment's
    stream set to 0."""
    return torch.where(in_stream(words, totals), words.view(torch.int32), 0)


def on_streams(fn):
    """``fn`` giving (words, totals) -> its (stream words, totals)."""
    def call():
        words, totals = fn()
        return stream_words(words, totals), totals
    return call


def place_checked(value, nbits, offs, totals, seg_words: int):
    """Kernel D into a buffer pre-filled with 0xFFFFFFFF, so that a word it
    forgets shows: raises if it wrote a word past a stream; returns (the
    stream words, totals)."""
    out = torch.full((value.shape[0], seg_words), -1, dtype=torch.int32,
                     device=value.device)
    fused.place(value, nbits, offs, totals, seg_words,
                out=out.view(torch.uint32))
    keep = in_stream(out, totals)
    past = int((out[~keep] != -1).sum())
    if past:
        raise AssertionError(f"kernel place wrote {past} words past the "
                             f"streams")
    return torch.where(keep, out, 0), totals


def place_plain_streams(value, nbits, offs, totals, seg_words: int):
    """``place_plain``'s stream words and the totals, as ``place_checked``
    gives them."""
    return (stream_words(fused.place_plain(value, nbits, offs, seg_words),
                         totals), totals)


def fields_nbytes(in_bytes: int, nbits: torch.Tensor, n_luts: int) -> int:
    """The bytes kernel B or F must move under the fields contract: its
    input (``in_bytes``), one nbits byte a slot, 16 bytes for each group
    of four slots that holds a slot with non-zero nbits (the values kernel
    D reads; the other groups are not written), 4 bytes of bits a block,
    and the LUTs."""
    S, nblk, _ = nbits.shape
    groups = int((nbits.view(S, nblk, 16, 4) != 0).any(-1).sum())
    return (in_bytes + nbits.numel() + 16 * groups + 4 * S * nblk
            + 4096 * n_luts)


def contract_fields(value, nbits, bits):
    """(value as int32, 0 at every slot whose nbits is 0; nbits; bits):
    what the fields contract of kernels B and F defines."""
    return torch.where(nbits > 0, value.view(torch.int32), 0), nbits, bits


def prefilled_fields(S: int, nblk: int, dev):
    """(value, nbits, bits) buffers for kernel B or F, every bit set."""
    return (torch.full((S, nblk, 64), -1, dtype=torch.int32,
                       device=dev).view(torch.uint32),
            torch.full((S, nblk, 64), 255, dtype=torch.uint8, device=dev),
            torch.full((S, nblk), -1, dtype=torch.int32, device=dev))


def fields_checked(kernel, *args, **kw):
    """Kernel B, B explicit or F (``kernel``, called on ``args``) into
    buffers pre-filled with all ones, so that a field it forgets shows:
    raises if it wrote a value group that holds no slot with non-zero
    nbits; returns ``contract_fields`` of its outputs."""
    S, nblk = args[0].shape[:2]
    out = prefilled_fields(S, nblk, args[0].device)
    got = kernel(*args, **kw, out=out)
    if any(g is not o for g, o in zip(got, out)):
        raise AssertionError(f"{kernel.__name__} did not return its out=")
    value, nbits, _ = out
    groups = (nbits.view(S, nblk, 16, 4) != 0).any(-1)
    touched = (value.view(torch.int32).view(S, nblk, 16, 4) != -1).any(-1)
    stray = int((touched & ~groups).sum())
    if stray:
        raise AssertionError(f"{kernel.__name__} wrote {stray} value groups "
                             f"without bits")
    return contract_fields(*out)


def fields_plain(plain, *args, **kw):
    """A plain twin's outputs as ``fields_checked`` gives them."""
    return contract_fields(*plain(*args, **kw))


def random_lut(rng: np.random.Generator, dev) -> torch.Tensor:
    """[1024] int32 combined LUT of random codes of 1-16 bits, its NULL
    entry too (the kernels must look it up, not assume it empty)."""
    length = rng.integers(1, 17, 1024)
    code = rng.integers(0, 1 << 16, 1024) & ((1 << length) - 1)
    return torch.from_numpy((code | (length << 16)).astype(np.int32)).to(dev)


def dynamic_split(e: FastBatchEncoder, xd: torch.Tensor,
                  runs: int) -> dict[str, float]:
    """Medians of the parts of one dynamic ``encode_batch``, each ended by
    a sync: stage 1 (A + E), the histogram fetch, the K.2 builds and LUTs,
    the LUT upload, stage 2 (F + C + D), the words fetch, the file
    assembly."""
    names = ("stage 1", "hist fetch", "K.2 builds + LUTs", "LUT upload",
             "stage 2", "words fetch", "assembly")
    parts: dict[str, list[float]] = {k: [] for k in names}
    for i in range(3 + runs):
        t = [time.perf_counter()]
        pf, hist = e._analyze_hist(e._check_batch(xd))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        hist = hist.cpu().numpy()
        t.append(time.perf_counter())
        tables, luts = e._build_tables_batch(hist, smooth=e._sampled)
        t.append(time.perf_counter())
        luts = torch.from_numpy(luts).to(e.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        words, totals = e._pack_only(pf, luts)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        host = e._fetch(words, totals)
        t.append(time.perf_counter())
        e._assemble(*host, tables)
        t.append(time.perf_counter())
        if i >= 3:  # three warm-up runs
            for k, a, b in zip(names, t, t[1:]):
                parts[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def path_of(cfg: EncodeConfig) -> tuple[str, ...]:
    return FIXED_PATH if cfg.huffman == "fixed" else DYNAMIC_PATH


def jpeg_cases(rng: np.random.Generator, scale: int = 1) -> list[dict]:
    """The ``JpegEncoder`` / ``encode_gray`` runs of phase 3b, at 1/scale of
    the full sizes (sides stay multiples of 16, the any-size case off them).

    Each case: ``label``; ``kernels`` its path must launch; ``call(dev)``
    -> the files of one run on ``dev``; ``ref()`` -> the files of the same
    call on the CPU (a batch: its first ``CPU_IMAGES_DYNAMIC`` images);
    ``original``: the pixels file 0 must decode to; ``restarts``: (DRI
    markers, RSTn markers) per file, or None.
    """
    def s(n):
        return n // scale
    cases = []
    for h, w, r in SCAN_GEOMETRIES:
        img = synthetic_batch(rng, 1, s(h), s(w))[0]
        rows = r  # 1088 / scale stays a multiple of 17 block rows
        for mode in MODES:
            cfg = EncodeConfig(huffman=mode, restart_interval_mcu_rows=rows)
            restarts = None
            if rows:
                y_segs, c_segs = s(h) // 8 // rows, s(h) // 16 // rows
                restarts = ((y_segs > 1) + 2 * (c_segs > 1),
                            (y_segs - 1) + 2 * (c_segs - 1))
            call = (lambda dev, cfg=cfg, img=img:
                    [JpegEncoder(cfg, device=dev).encode(img)])
            cases.append(dict(
                label=f"encode 3scan {mode} {s(w)}x{s(h)} restart_rows={rows}",
                kernels=path_of(cfg), original=img, restarts=restarts,
                call=call, ref=lambda call=call: call("cpu")))
    batch = synthetic_batch(rng, 16, s(640), s(640))
    for mode in MODES:
        cfg = EncodeConfig(huffman=mode)
        cases.append(dict(
            label=f"encode_batch 3scan {mode} 16x{s(640)}x{s(640)}",
            kernels=path_of(cfg), original=batch[0], restarts=None,
            call=lambda dev, cfg=cfg: JpegEncoder(
                cfg, device=dev).encode_batch(batch),
            ref=lambda cfg=cfg: JpegEncoder(cfg, device="cpu").encode_batch(
                batch[:CPU_IMAGES_DYNAMIC])))
    frame = synthetic_batch(rng, 1, s(1280), s(1920))[0]
    area = Area(s(640), s(320), s(640), s(640))
    call = lambda dev: [JpegEncoder(device=dev).encode_region(frame, area)]
    cases.append(dict(
        label=f"encode_region 3scan dynamic {area} of {s(1920)}x{s(1280)}",
        kernels=DYNAMIC_PATH, restarts=None,
        original=frame[area.y:area.y + area.h, area.x:area.x + area.w],
        call=call, ref=lambda call=call: call("cpu")))
    odd = frame[:s(1080) - 1, :s(1920) - 1]
    call = lambda dev: [JpegEncoder(device=dev).encode_any(odd)]
    cases.append(dict(
        label=f"encode_any dynamic {odd.shape[1]}x{odd.shape[0]} "
              f"(padded, interleaved)",
        kernels=DYNAMIC_PATH, original=odd, restarts=None, call=call,
        ref=lambda call=call: call("cpu")))
    plane = np.ascontiguousarray(frame[..., 1])
    for mode in ("fixed", "dynamic"):
        cfg = EncodeConfig(huffman=mode)
        call = (lambda dev, cfg=cfg:
                [encode_gray(plane, cfg, device=dev)])
        cases.append(dict(
            label=f"encode_gray {mode} {s(1920)}x{s(1280)}",
            kernels=path_of(cfg), original=plane, restarts=None, call=call,
            ref=lambda call=call: call("cpu")))
    return cases


def check_jpeg_case(case: dict, files: list[bytes], ref: list[bytes],
                    fixed_dht: list[bytes]) -> str:
    """Hold one phase-3b run against the CPU's files and the decoder;
    returns a summary line."""
    n = len(ref)
    same = sum(f == g for f, g in zip(files, ref))
    if same != n:
        raise AssertionError(f"{case['label']}: card and CPU bytes differ "
                             f"({same}/{n} equal)")
    return (f"{case['label']}: {same}/{n} files byte-identical to the CPU "
            f"plain path, " + check_files(case, files, fixed_dht))


def check_files(case: dict, files: list[bytes],
                fixed_dht: list[bytes]) -> str:
    """The tables, restart markers and golden decode of a run's files;
    returns a summary."""
    if "fixed" not in case["label"] and any(
            dht_segments(f) == fixed_dht for f in files):
        raise AssertionError(f"{case['label']}: a file carries the fixed "
                             f"tables")
    if case["restarts"] is not None:
        want = case["restarts"]
        for f in files:
            got = (f.count(b"\xff\xdd\x00\x04"),
                   sum(f.count(bytes([0xFF, 0xD0 + i])) for i in range(8)))
            if got != want:
                raise AssertionError(f"{case['label']}: (DRI, RSTn) markers "
                                     f"{got}, want {want}")
    dec = golden.decode(files[0])
    if dec.shape != case["original"].shape:
        raise AssertionError(f"{case['label']}: decoded shape {dec.shape} "
                             f"!= {case['original'].shape}")
    quality_db = golden.psnr(case["original"], dec)
    if not quality_db > MIN_PSNR_DB:
        raise AssertionError(f"{case['label']}: PSNR {quality_db:.2f} dB "
                             f"<= {MIN_PSNR_DB} dB")
    markers = (f"; (DRI, RSTn) per file {case['restarts']}"
               if case["restarts"] else "")
    return (f"{sum(map(len, files))} bytes, golden decode of file 0 PSNR "
            f"{quality_db:.2f} dB{markers}")


def f64_cases(rng: np.random.Generator, scale: int = 1) -> list[dict]:
    """The f64 exact-mode runs of phase 3c, at 1/scale of the full sizes.

    Each case: ``label``; ``kernels`` its path must launch; ``make(dev)``
    -> a zero-argument call of the entry point on input already on
    ``dev`` (for phase 4's timings too), giving the files; ``refs``: (what,
    files) thunks the files (or their first ones) must equal;
    ``original``: the pixels file 0 must decode to; ``restarts``: (DRI,
    RSTn) markers per file, or None.
    """
    def s(n):
        return n // scale
    cases = []
    for b, h, w in F64_GEOMETRIES:
        batch = synthetic_batch(rng, b, s(h), s(w))
        for mode in ("fixed", "dynamic"):
            kw = dict(scan_layout="interleaved", huffman=mode)
            cfg = EncodeConfig(dtype="float64", **kw)

            def make(dev, cfg=cfg, batch=batch):
                enc = FastBatchEncoder(batch.shape[1], batch.shape[2], cfg,
                                       device=dev)
                x = torch.from_numpy(batch).to(dev)
                return lambda: enc.encode_batch(x)
            refs = [("the golden encoder", lambda batch=batch, kw=kw: [
                golden_enc.encode(img, **kw) for img in batch])]
            if (b, h, w) == F64_GEOMETRIES[0]:
                n = b if mode == "fixed" else CPU_IMAGES_DYNAMIC
                refs.append((f"the CPU plain path (first {n})",
                             lambda make=make, batch=batch, n=n:
                             make("cpu", batch=batch[:n])()))
            cases.append(dict(
                label=f"f64 FastBatchEncoder.encode_batch {mode} "
                      f"{b}x{s(h)}x{s(w)}",
                kernels=(F64_FIXED_PATH if mode == "fixed"
                         else F64_DYNAMIC_PATH),
                make=make, refs=refs, original=batch[0], restarts=None))
    for h, w, rows in F64_SCAN_GEOMETRIES:
        img = synthetic_batch(rng, 1, s(h), s(w))[0]
        for mode in ("fixed", "dynamic"):
            cfg = EncodeConfig(dtype="float64", huffman=mode,
                               restart_interval_mcu_rows=rows)

            def make(dev, cfg=cfg, img=img):
                enc = JpegEncoder(cfg, device=dev)
                x = torch.from_numpy(img).to(dev)
                return lambda: [enc.encode(x)]
            if rows:  # the golden encoder has no 3-scan restarts
                y_segs, c_segs = s(h) // 8 // rows, s(h) // 16 // rows
                restarts = ((y_segs > 1) + 2 * (c_segs > 1),
                            (y_segs - 1) + 2 * (c_segs - 1))
                refs = [("the CPU plain path",
                         lambda make=make: make("cpu")())]
            else:
                restarts = None
                refs = [("the golden encoder", lambda img=img, mode=mode: [
                    golden_enc.encode(img, huffman=mode)])]
            cases.append(dict(
                label=f"f64 JpegEncoder.encode 3scan {mode} {s(w)}x{s(h)} "
                      f"restart_rows={rows}",
                kernels=F64_SCAN_PATHS[mode], make=make, refs=refs,
                original=img, restarts=restarts))
    plane = np.ascontiguousarray(
        synthetic_batch(rng, 1, s(1280), s(1920))[0, ..., 1])
    for mode in ("fixed", "dynamic"):
        cfg = EncodeConfig(dtype="float64", huffman=mode)

        def make(dev, cfg=cfg):
            x = torch.from_numpy(plane).to(dev)
            return lambda: [encode_gray(x, cfg, device=dev)]
        cases.append(dict(
            label=f"f64 encode_gray {mode} {s(1920)}x{s(1280)}",
            kernels=F64_SCAN_PATHS[mode], make=make,
            refs=[("the CPU plain path", lambda make=make: make("cpu")())],
            original=plane, restarts=None))
    return cases


def sampling_cases(rng: np.random.Generator) -> list[dict]:
    """The 4:2:2 and 4:4:4 runs of phase 3d, in ``f64_cases``' form (each
    also names its ``sampling``); every reference is the CPU plain path,
    on every image."""
    cases = []
    for sampling, b, h, w, rows in SAMPLING_GEOMETRIES:
        batch = synthetic_batch(rng, b, h, w)
        for mode in SAMPLING_MODES:
            cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                               subsampling=sampling,
                               restart_interval_mcu_rows=rows)

            def make(dev, cfg=cfg, batch=batch):
                enc = FastBatchEncoder(batch.shape[1], batch.shape[2], cfg,
                                       device=dev)
                x = torch.from_numpy(batch).to(dev)
                return lambda: enc.encode_batch(x)
            n_segs = h // 8 // rows if rows else 1
            cases.append(dict(
                label=f"{LABEL[sampling]} FastBatchEncoder.encode_batch "
                      f"{mode} {b}x{h}x{w} restart_rows={rows}",
                sampling=sampling, kernels=path_of(cfg), make=make,
                refs=[("the CPU plain path",
                       lambda make=make: make("cpu")())],
                original=batch[0],
                restarts=(1, n_segs - 1) if rows else None))
    for sampling in ("422", "444"):
        img = synthetic_batch(rng, 1, 1280, 1920)[0]
        for dtype in ("float32", "float64"):
            for mode in SAMPLING_MODES:
                cfg = EncodeConfig(huffman=mode, subsampling=sampling,
                                   dtype=dtype)

                def make(dev, cfg=cfg, img=img):
                    enc = JpegEncoder(cfg, device=dev)
                    x = torch.from_numpy(img).to(dev)
                    return lambda: [enc.encode(x)]
                f64 = dtype == "float64"
                cases.append(dict(
                    label=f"{LABEL[sampling]} {'f64 ' if f64 else ''}"
                          f"JpegEncoder.encode 3scan {mode} 1920x1280",
                    sampling=sampling,
                    kernels=F64_SCAN_PATHS[mode] if f64 else path_of(cfg),
                    make=make, refs=[("the CPU plain path",
                                      lambda make=make: make("cpu")())],
                    original=img, restarts=None))
    return cases


def check_f64_case(case: dict, files: list[bytes], fixed_dht) -> str:
    """Hold one phase-3c or 3d run against its references and the
    decoder; returns a summary line."""
    parts = []
    for what, ref in case["refs"]:
        want = ref()
        same = sum(f == g for f, g in zip(files, want))
        if same != len(want):
            raise AssertionError(f"{case['label']}: bytes differ from "
                                 f"{what} ({same}/{len(want)} equal)")
        parts.append(f"{same}/{len(want)} files byte-identical to {what}")
    return (f"{case['label']}: " + ", ".join(parts) + ", "
            + check_files(case, files, fixed_dht))


def stream_cases(rng: np.random.Generator) -> list[dict]:
    """The runs of phase 3g: per geometry, its ``batches`` (u8 host
    arrays; batch ``STREAM_HEAVY`` uniform random, the last with half the
    images) and ``label``."""
    cases = []
    for b, h, w in STREAM_GEOMETRIES:
        batches = [synthetic_batch(rng, b, h, w)
                   for _ in range(STREAM_BATCHES - 1)]
        batches[STREAM_HEAVY] = rng.integers(0, 256, (b, h, w, 3), np.uint8)
        batches.append(synthetic_batch(rng, b // 2, h, w))
        cases.append({"label": f"{STREAM_BATCHES} batches of {b}x{h}x{w}",
                      "geometry": (b, h, w), "batches": batches})
    return cases


def stream_phase(cases: list[dict], dev, launches: dict) -> list[tuple]:
    """Phase 3g: ``encode_stream`` of each case in each mode and depth,
    with the counts reset just before each stream, against
    ``encode_batch`` on the card (and the heavy batch's first two images
    against the CPU path); then ``BucketedEncoder.encode_any``.  Returns
    the runs phase 4 times: (label, encoder, batches)."""
    runs = []
    for case in cases:
        b, h, w = case["geometry"]
        batches = case["batches"]
        for mode in STREAM_MODES:
            enc = FastBatchEncoder(h, w, config(mode), device=dev)
            want = [enc.encode_batch(bt) for bt in batches]
            heavy = batches[STREAM_HEAVY][:2]
            ref = FastBatchEncoder(h, w, config(mode),
                                   device="cpu").encode_batch(heavy)
            if want[STREAM_HEAVY][:2] != ref:
                raise AssertionError(f"stream {case['label']} {mode}: the "
                                     f"heavy batch's card and CPU bytes "
                                     f"differ")
            for depth in STREAM_DEPTHS:
                label = f"encode_stream {mode} {case['label']} depth {depth}"
                torch.cuda.synchronize()
                reset_launch_counts()
                got = list(enc.encode_stream(iter(batches), depth))
                counts = launch_counts()
                print(f"main path {label}: launches {json.dumps(counts)}")
                for name in (FIXED_PATH if mode == "fixed"
                             else DYNAMIC_PATH):
                    if counts[name] <= 0:
                        raise AssertionError(f"kernel {name} was not "
                                             f"launched on {label}")
                for name, n in counts.items():
                    launches[name] += n
                same = sum(g == x for g, x in zip(got, want))
                if len(got) != len(want) or same != len(want):
                    raise AssertionError(f"{label}: {same} of {len(want)} "
                                         f"batches equal encode_batch's")
                print(f"  {label}: {same}/{len(want)} batches' files equal "
                      f"encode_batch's on the card, in order (batch "
                      f"{STREAM_HEAVY} uniform random, its first 2 files "
                      f"equal to the CPU path's; the last batch "
                      f"{len(batches[-1])} images), "
                      f"{sum(len(f) for fs in got for f in fs)} bytes")
            runs.append((f"{mode} {case['label']}", enc, batches))
    rng = np.random.default_rng(len(cases))
    imgs = [synthetic_batch(rng, 1, h, w)[0] for h, w in BUCKET_LIST]
    torch.cuda.synchronize()
    reset_launch_counts()
    files = BucketedEncoder(device=dev).encode_any(imgs)
    counts = launch_counts()
    label = ("BucketedEncoder.encode_any fixed "
             + ", ".join(f"{w}x{h}" for h, w in BUCKET_LIST))
    print(f"main path {label}: launches {json.dumps(counts)}")
    for name in FIXED_PATH:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on {label}")
    for name, n in counts.items():
        launches[name] += n
    if files != BucketedEncoder(device="cpu").encode_any(imgs):
        raise AssertionError(f"{label}: card and CPU bytes differ")
    for img, data in zip(imgs, files):
        dec = golden.decode(data)
        if dec.shape != img.shape or not golden.psnr(img, dec) > MIN_PSNR_DB:
            raise AssertionError(f"{label}: a {img.shape} file decodes to "
                                 f"{dec.shape} at {golden.psnr(img, dec)} dB")
    print(f"  {label}: {len(files)}/{len(files)} files byte-identical to the "
          f"CPU plain path, each decodes (golden) at its size above "
          f"{MIN_PSNR_DB} dB")
    return runs


def progressive_call(engine: str, mode: str, dtype: str, img, dev):
    """One progressive encode of ``img`` on ``dev`` -> its file."""
    fn = encode_progressive if engine == "spectral" else \
        encode_progressive_script
    return fn(img, EncodeConfig(huffman=mode, dtype=dtype), device=dev)


def progressive_phase(rng: np.random.Generator, dev,
                      launches: dict) -> list[tuple]:
    """Phase 3h: each progressive case on the card, its counts reset just
    before it, against the CPU path's bytes and the golden decoder.
    Returns the runs phase 4 times: (label, call)."""
    img = synthetic_batch(rng, 1, *PROGRESSIVE_SIZE)[0]
    runs = []
    for label, engine, mode, dtype in PROGRESSIVE_CASES:
        label = (f"progressive {label} {PROGRESSIVE_SIZE[1]}x"
                 f"{PROGRESSIVE_SIZE[0]}")
        torch.cuda.synchronize()
        reset_launch_counts()
        data = progressive_call(engine, mode, dtype, img, dev)
        counts = launch_counts()
        print(f"main path {label}: launches {json.dumps(counts)}")
        kernels = SPECTRAL_PATH if engine == "spectral" else ("front_dct",)
        for name in kernels:
            if dtype == "float64" and name == "front_dct":
                continue  # the f64 exact ops replace A
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"{label}")
        for name, n in counts.items():
            launches[name] += n
        if data != progressive_call(engine, mode, dtype, img, "cpu"):
            raise AssertionError(f"{label}: card and CPU bytes differ")
        if b"\xff\xc2" not in data:
            raise AssertionError(f"{label}: no SOF2 marker")
        dec = golden.decode(data)
        quality_db = golden.psnr(img, dec)
        if dec.shape != img.shape or not quality_db > MIN_PSNR_DB:
            raise AssertionError(f"{label}: golden decode {dec.shape} at "
                                 f"{quality_db:.2f} dB")
        print(f"  {label}: byte-identical to the CPU plain path, {len(data)} "
              f"bytes, {data.count(bytes([0xFF, 0xDA]))} scans, golden "
              f"decode (SOF2) PSNR {quality_db:.2f} dB")
        runs.append((label, functools.partial(progressive_call, engine, mode,
                                              dtype, img, dev)))
    return runs


def stream_timings(stream_runs, progressive_runs, card: str,
                   runs: int) -> None:
    """Phase 4 for 3g and 3h: per stream case, ms per batch streamed at
    each depth and as ``encode_batch`` (the same batches, same run), and
    the device idle share over each; each progressive case's call ms and
    idle share."""
    for label, enc, batches in stream_runs:
        n = len(batches)

        def batch_loop():
            return [enc.encode_batch(bt) for bt in batches]

        def streamed(depth):
            return lambda: list(enc.encode_stream(iter(batches), depth))
        fns = [("encode_batch", batch_loop)] + [
            (f"encode_stream depth {d}", streamed(d)) for d in STREAM_DEPTHS]
        # in turns (batch, streams, streams, batch), so drift hits alike
        first = [host_ms(fn, runs) for _, fn in fns]
        second = [host_ms(fn, runs) for _, fn in reversed(fns)][::-1]
        parts = []
        for (what, fn), a, b in zip(fns, first, second):
            idle = device_profile(fn, max(2, runs // 2))[1]
            parts.append(f"{what} {(a + b) / 2 / n:.4f} ms a batch "
                         f"({a / n:.4f}, {b / n:.4f}), idle share "
                         f"{idle:.4f}")
        print(f"timing stream {label} on [{card}]: " + "; ".join(parts)
              + f"; median of {runs} runs of {n} batches")
    for label, fn in progressive_runs:
        call_ms = host_ms(fn, runs)
        per_call, idle = device_profile(fn, max(2, runs // 2))
        print(f"timing {label} on [{card}]: {call_ms:.4f} ms a call; median "
              f"of {runs}; device µs per call (torch.profiler) "
              f"{sum(per_call.values()):.2f}, idle share {idle:.4f}; by name: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  per_call.items(), key=lambda kv: -kv[1])[:6]))


def monitor_frames(rng: np.random.Generator, n: int = MONITOR_FRAMES,
                   quiet: bool = True) -> np.ndarray:
    """[n, *MONITOR_SIZE, 3] u8 frames: a background (frame 0); the
    rectangles of MONITOR_MOVERS moving each frame; with ``quiet``, frame
    3 a copy of frame 2, frame 4 frame 2 with noise of at most 3 levels
    (far below the threshold) and MONITOR_PATCHES's frame with three more
    patches inverted (MONITOR_PATCH_AT)."""
    h, w = MONITOR_SIZE
    bg = synthetic_batch(rng, 1, h, w)[0]
    out = np.empty((n, h, w, 3), np.uint8)
    out[0] = bg
    t = 0
    for i in range(1, n):
        if quiet and i == MONITOR_QUIET[0]:
            out[i] = out[i - 1]
            continue
        if quiet and i == MONITOR_QUIET[1]:
            step = rng.integers(-3, 4, out[i - 1].shape)
            out[i] = np.clip(out[i - 1] + step, 0, 255)
            continue
        t += 1
        out[i] = bg
        for (y, x, hh, ww, dy, dx), color in MONITOR_MOVERS:
            out[i, y + t * dy:y + t * dy + hh, x + t * dx:x + t * dx + ww] \
                = color
        if quiet and i == MONITOR_PATCHES:
            for y, x in MONITOR_PATCH_AT:
                out[i, y:y + 64, x:x + 96] = 255 - out[i, y:y + 64, x:x + 96]
    return out


def monitor_results(mon: ChangeMonitor, frames) -> list[tuple]:
    """Each frame's (areas as tuples, region bytes, suggested delay)."""
    out = []
    for f in frames:
        res = mon.process_frame(f)
        out.append(([(a.x, a.y, a.w, a.h) for a, _ in res.regions],
                    [data for _, data in res.regions], res.suggested_delay))
    return out


def checkerboard(h: int, w: int, seed: int) -> np.ndarray:
    """``tests/conftest.py``'s synthetic frame (rebuilt here: the script
    imports no test)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 16 + xx // 16) % 2) * 180 + 40
    img = np.stack([base, 255 - base, (xx * 255 // max(w - 1, 1))], axis=-1)
    noise = rng.integers(-20, 21, size=img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def counted(label: str, fn, kernels, launches: dict,
            g_row: str = "decode_segments"):
    """Run ``fn`` with the launch counts reset just before it and read
    just after; every kernel of ``kernels`` must have launched.  Adds the
    counts to ``launches`` (kernel G's under ``g_row``); returns ``fn``'s
    result."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    counts = launch_counts()
    print(f"main path {label}: launches {json.dumps(counts)}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on {label}")
    for name, n in counts.items():
        launches[g_row if name == "decode_segments" else name] += n
    return out


class _Failing:
    """A batch encoder whose every call raises (ResilientEncoder's host
    fallback must take over)."""

    def encode_batch(self, batch):
        raise RuntimeError("synthetic device failure")


def cli_files(device: str, src: str, other: str, root: str) -> dict:
    """The CLI's runs of phase 3i on ``device`` in ``root``: each encode
    variant of CLI_ENCODES, ``decode`` of the default file and ``diff`` of
    ``src`` and ``other``.  Returns {label: bytes (or the decoded PPM's
    pixels)}."""
    out = {}
    for label, opts in CLI_ENCODES.items():
        dst = os.path.join(root, label.replace(" ", "_") + ".jpg")
        if cli_main(["--device", device, "encode", src, dst, *opts]):
            raise AssertionError(f"CLI encode {label} on {device} failed")
        with open(dst, "rb") as f:
            out[f"encode {label}"] = f.read()
    ppm = os.path.join(root, "decoded.ppm")
    if cli_main(["--device", device, "decode",
                 os.path.join(root, "default.jpg"), ppm]):
        raise AssertionError(f"CLI decode on {device} failed")
    out["decode"] = read_ppm(ppm)
    regions = os.path.join(root, "regions")
    if cli_main(["--device", device, "diff", src, other, regions]):
        raise AssertionError(f"CLI diff on {device} failed")
    for name in sorted(os.listdir(regions)):
        with open(os.path.join(regions, name), "rb") as f:
            out[f"diff {name}"] = f.read()
    return out


def monitor_phase(rng: np.random.Generator, dev, launches: dict) -> dict:
    """Phase 3i: the monitor over MONITOR_FRAMES frames, then
    ``compare_pairwise_batch``, save/load, the 640x640 pair, the CLI and
    ``ResilientEncoder``, each against the CPU path.  Returns what phase 4
    times."""
    h, w = MONITOR_SIZE
    frames = monitor_frames(rng)
    label = f"ChangeMonitor {w}x{h}, {len(frames)} frames"
    mon = ChangeMonitor(h, w, device=dev)
    got = counted(label, lambda: monitor_results(mon, frames), DYNAMIC_PATH,
                  launches)
    want = monitor_results(ChangeMonitor(h, w, device="cpu"), frames)
    for i, (g, x) in enumerate(zip(got, want)):
        if g != x:
            raise AssertionError(f"{label}: frame {i}: the card's areas "
                                 f"{g[0]}, delay {g[2]} ({len(g[1])} files) "
                                 f"differ from the CPU path's {x[0]}, "
                                 f"{x[2]}")
    counts = [len(g[0]) for g in got]
    if any(counts[i] for i in (0, *MONITOR_QUIET)) or \
            counts[MONITOR_PATCHES] <= 2:
        raise AssertionError(f"{label}: regions per frame {counts}")
    for i, (areas, files, _) in enumerate(got):
        for (x, y, aw, ah), data in zip(areas, files):
            dec = golden.decode(data)
            window = frames[i][y:y + ah, x:x + aw]
            if dec.shape != window.shape or \
                    not golden.psnr(window, dec) > REGION_MIN_PSNR_DB:
                raise AssertionError(f"{label}: frame {i} region "
                                     f"{(x, y, aw, ah)} decodes to "
                                     f"{dec.shape} at "
                                     f"{golden.psnr(window, dec):.2f} dB")
    print(f"  {label}: every frame's areas, bytes and suggested delay equal "
          f"the CPU path's; regions per frame {counts}, delays "
          f"{[g[2] for g in got]}, {sum(len(d) for g in got for d in g[1])} "
          f"bytes; every region decodes (golden) above "
          f"{REGION_MIN_PSNR_DB} dB")

    # compare_pairwise_batch: one subsample and one mask pass on the card
    many = monitor_frames(rng, PAIRWISE_FRAMES, quiet=False)
    comp = pdiff.FrameComparator(h, w, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pair = comp.compare_pairwise_batch(many)
    peak = torch.cuda.max_memory_allocated(dev) - base
    ref = pdiff.FrameComparator(h, w, device="cpu").compare_pairwise_batch(
        many)
    if pair != ref or not all(pair):
        raise AssertionError(f"compare_pairwise_batch {many.shape}: the "
                             f"card's areas differ from the CPU path's (or "
                             f"a pair gave none)")
    if peak > 2 * many.nbytes:
        raise AssertionError(f"compare_pairwise_batch: peak {peak} bytes "
                             f"over twice its input's {many.nbytes}")
    print(f"  compare_pairwise_batch {PAIRWISE_FRAMES}x{w}x{h}: "
          f"{len(pair)} pairs' areas equal the CPU path's "
          f"({sum(map(len, pair))} regions); device peak {peak / 1e6:.1f} MB "
          f"for an input of {many.nbytes / 1e6:.1f} MB")

    with tempfile.TemporaryDirectory() as root:
        # save on the card, load on the CPU
        path = os.path.join(root, "stored.npy")
        mon.comparator.save(path)
        back = pdiff.FrameComparator(h, w, device="cpu")
        back.load(path)
        if not torch.equal(back.stored, mon.comparator.stored.cpu()):
            raise AssertionError("save on the card, load on the CPU: the "
                                 "stored frames differ")
        print(f"  save (card) -> load (CPU): stored frame "
              f"{tuple(back.stored.shape)} equal")

        # the synthetic 640x640 pair of tests/conftest.py
        old = checkerboard(640, 640, seed=1)
        new = old.copy()
        new[100:180, 300:420] = 255 - new[100:180, 300:420]
        pair_areas = []
        for d in (dev, "cpu"):
            c = pdiff.FrameComparator(640, 640, device=d)
            c.store(c.subsample(old))
            pair_areas.append(c.compare(c.subsample(new)))
        if pair_areas[0] != pair_areas[1] or not pair_areas[0]:
            raise AssertionError(f"640x640 pair: card areas {pair_areas[0]} "
                                 f"vs CPU {pair_areas[1]}")
        print(f"  640x640 fixture pair: areas {pair_areas[0]} equal the "
              f"CPU path's")

        # the CLI, on the card and with --device cpu
        ch, cw = CLI_SIZE
        img = synthetic_batch(rng, 1, ch, cw)[0]
        moved = img.copy()
        moved[200:300, 100:260] = 255 - moved[200:300, 100:260]
        src, other = os.path.join(root, "a.ppm"), os.path.join(root, "b.ppm")
        write_ppm(src, img)
        write_ppm(other, moved)
        os.makedirs(os.path.join(root, "card"))
        os.makedirs(os.path.join(root, "cpu"))
        # the decode of the default (3-scan) file is speculative: H, then G
        card = counted("CLI encode (4 variants), decode, diff",
                       lambda: cli_files(dev.type, src, other,
                                         os.path.join(root, "card")),
                       ("front_dct", "symbolize_bits", "symbolize_fields",
                        "attach_pf", "segment_offsets", "place",
                        "scan_positions", "decode_segments"), launches,
                       g_row="decode_segments speculative")
        cpu = cli_files("cpu", src, other, os.path.join(root, "cpu"))
        if sorted(card) != sorted(cpu) or not any(
                k.startswith("diff") for k in card):
            raise AssertionError(f"CLI: the card wrote {sorted(card)}, the "
                                 f"CPU {sorted(cpu)}")
        for k in card:
            if k == "decode":
                print("  CLI decode: " + rgb_agreement(
                    torch.from_numpy(card[k]), cpu[k], "the CPU path's PPM"))
            elif card[k] != cpu[k]:
                raise AssertionError(f"CLI {k}: card and CPU bytes differ")
        print(f"  CLI: {len(card) - 1} files byte-identical to those of "
              f"--device cpu ({', '.join(k for k in card if k != 'decode')})")

    # ResilientEncoder: no event on a healthy card, the golden fallback
    # around a stub that raises
    if not probe_device(30.0, dev):
        raise AssertionError("probe_device: the card did not answer")
    b, rh, rw = RESILIENT_BATCH
    batch = synthetic_batch(rng, b, rh, rw)
    cfg = config("fixed")
    inner = FastBatchEncoder(rh, rw, cfg, device=dev)
    wrapped = ResilientEncoder(inner, config=cfg, device=dev)
    files = counted(f"ResilientEncoder(FastBatchEncoder) fixed {b}x{rh}x{rw}",
                    lambda: wrapped.encode_batch(batch), FIXED_PATH, launches)
    n_files = len(files)
    if wrapped.events or files != inner.encode_batch(batch):
        raise AssertionError(f"ResilientEncoder on a healthy card: events "
                             f"{wrapped.events}, or its bytes differ from "
                             f"encode_batch's")
    sb, sh, sw = RESILIENT_STUB
    stub_batch = synthetic_batch(rng, sb, sh, sw)
    fallback = ResilientEncoder(_Failing(), config=cfg, device=dev)
    files = fallback.encode_batch(stub_batch)
    want = [bytes(golden_enc.encode(im, scan_layout="interleaved",
                                    huffman="fixed")) for im in stub_batch]
    kinds = [e.kind for e in fallback.events]
    if files != want or kinds != ["device_error", "device_error", "fallback"]:
        raise AssertionError(f"ResilientEncoder around a failing stub: "
                             f"events {kinds}, or bytes not the golden "
                             f"encoder's")
    print(f"  ResilientEncoder: no event on the card, {n_files} files equal "
          f"encode_batch's; around a failing stub: events {kinds}, the "
          f"golden encoder's bytes ({len(files)} files)")
    return dict(mon=mon, frames=frames, many=many, comp=comp)


def monitor_timings(runs: dict, card: str, n: int) -> None:
    """Phase 4 for 3i on the MONITOR_SIZE stream: ms a frame; the device
    µs of subsample and mask, the mask's D2H, the host region pipeline's
    ms, the encode's ms and device µs by kernel on the frame with most
    regions; the device idle share over the stream; and
    ``compare_pairwise_batch``'s ms a frame."""
    mon, frames, many = runs["mon"], runs["frames"], runs["many"]
    comp = mon.comparator

    def stream():
        comp.store(None)  # frame 0 seeds the stored frame again
        return [mon.process_frame(f) for f in frames]
    frame_ms = host_ms(stream, n) / len(frames)
    idle = device_profile(stream, max(2, n // 2))[1]
    print(f"timing ChangeMonitor {MONITOR_SIZE[1]}x{MONITOR_SIZE[0]} stream "
          f"of {len(frames)} frames on [{card}]: {frame_ms:.4f} ms a frame "
          f"(median of {n} streams), device idle share {idle:.4f}")
    i = MONITOR_PATCHES
    x = comp.to_device(frames[i])
    comp.store(comp.subsample(frames[i - 3]))
    saved = comp.stored
    up = device_us(lambda: comp.to_device(frames[i]), n)
    diff_us = device_us(lambda: pdiff.change_mask(pdiff.subsample_4x4(x),
                                                  saved), n)
    mask = pdiff.change_mask(pdiff.subsample_4x4(x), saved)
    d2h = device_us(mask.cpu, n)
    d2h_ms = host_ms(mask.cpu, n)
    mask_np = mask.cpu().numpy()
    areas = comp.regions_from_mask(mask_np)
    host = host_ms(lambda: comp.regions_from_mask(mask_np), n)

    def encode():
        return [mon.encoder.encode_region(x, a) for a in areas]
    enc_ms = host_ms(encode, n)
    per_call, enc_idle = device_profile(encode, n)
    print(f"  frame {i} ({len(areas)} regions, "
          f"{sum(a.w * a.h for a in areas) / 1e6:.3f} MP): upload (H2D, "
          f"pageable) {device_text(up)}; subsample + mask {device_text(diff_us)}"
          f"; mask D2H ({mask_np.size} bools) {d2h_ms:.4f} ms host, "
          f"{device_text(d2h)}; host regions {host:.4f} ms; encode_region "
          f"x{len(areas)} {enc_ms:.4f} ms, device µs per frame "
          f"{sum(per_call.values()):.2f} (idle share {enc_idle:.4f}) by "
          f"name: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              per_call.items(), key=lambda kv: -kv[1])[:10])
          + f"; median of {n}")
    pair = runs["comp"]
    pair_ms = host_ms(lambda: pair.compare_pairwise_batch(many), n)
    per_call, idle = device_profile(
        lambda: pair.compare_pairwise_batch(many), max(2, n // 2))
    print(f"timing compare_pairwise_batch {len(many)}x{MONITOR_SIZE[1]}x"
          f"{MONITOR_SIZE[0]} on [{card}]: {pair_ms / len(many):.4f} ms a "
          f"frame ({pair_ms:.4f} ms a call, median of {n}); device µs per "
          f"call {sum(per_call.values()):.2f}, idle share {idle:.4f}; by "
          f"name: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              per_call.items(), key=lambda kv: -kv[1])[:6]))


def sharded_batches(seed: int, upto: tuple | None = None) -> dict:
    """Phase 3j's batches from ``seed``, one a geometry of SHARDED_CASES,
    in their order (stopping after ``upto``): (batch, height, width) ->
    [b, h, w, 3] u8.  Every rank of a split makes the same."""
    rng = np.random.default_rng(seed + SHARDED_RNG_OFFSET)
    out = {}
    for _, _, b, h, w, *_ in SHARDED_CASES:
        if (b, h, w) not in out:
            out[(b, h, w)] = synthetic_batch(rng, b, h, w)
        if (b, h, w) == upto:
            break
    return out


def sharded_config(samp: str, mode: str, dtype: str,
                   rows: int = 0) -> EncodeConfig:
    return EncodeConfig(scan_layout="interleaved", huffman=mode,
                        subsampling=samp, dtype=dtype,
                        restart_interval_mcu_rows=rows)


def sharded_path(mode: str, dtype: str) -> tuple[str, ...]:
    """The kernels a ShardedEncoder slab launches."""
    if dtype == "float64":
        return F64_FIXED_PATH if mode == "fixed" else F64_DYNAMIC_PATH
    return FIXED_PATH if mode == "fixed" else DYNAMIC_PATH


def split_cases() -> list[tuple]:
    """The SHARDED_CASES a ``space`` axis of 2 runs at the 1x1 mesh's
    restart interval: (case, segments a slab).  135 MCU rows do not
    halve."""
    return [(c, c[5] // 2) for c in SHARDED_CASES if c[5] % 2 == 0]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_phase(seed: int, dev, card: str, launches: dict, fixed_dht,
                  dcases: list[dict], scases: list[dict]) -> dict:
    """Phase 3j: NCCL through the port's ``initialize`` (world size 1 on
    one card), a 1x1 mesh; each SHARDED_CASES run of
    ``ShardedEncoder.encode_batch`` against ``FastBatchEncoder`` on the
    card with the same restart interval ("dynamic-sampled": the dynamic
    mode's files), the CPU plain path and (f64) the golden encoder; the
    decode of 3e's and 3f's files over the mesh against the decode
    without one; then the split over 2 and 4 cards where the machine has
    them.  Returns the batches phase 4 times."""
    t0 = time.perf_counter()
    addr = f"localhost:{free_port()}"
    pdist.initialize(coordinator_address=addr, num_processes=1,
                     process_id=0)
    pdist.initialize()  # already initialized: a no-op
    mesh = make_mesh()
    print(f"phase 3j: {dist.get_backend()} group of "
          f"{dist.get_world_size()} rank through initialize (tcp://{addr}),"
          f" a {tuple(mesh.shape)} (data, space) mesh on "
          f"{mesh.device_type}")
    batches = sharded_batches(seed)
    digests = {}
    for label, samp, b, h, w, spd, mode, dtype in SHARDED_CASES:
        batch = batches[(b, h, w)]
        enc = ShardedEncoder(mesh, h, w, sharded_config(samp, mode, dtype),
                             segs_per_device=spd)
        files = counted(f"ShardedEncoder.encode_batch {label} {b}x{h}x{w}",
                        lambda: enc.encode_batch(batch),
                        sharded_path(mode, dtype), launches)
        rows = h // SAMPLING_GEOMETRY[samp][1] // spd
        exact = "fixed" if mode == "fixed" else "dynamic"
        ref = sharded_config(samp, exact, dtype, rows)
        refs = [("FastBatchEncoder on the card", FastBatchEncoder(
                    h, w, ref, device=dev).encode_batch(
                    torch.from_numpy(batch).to(dev))),
                ("the CPU plain path", FastBatchEncoder(
                    h, w, ref, device="cpu").encode_batch(batch))]
        if dtype == "float64":
            refs.append(("the golden encoder", [bytes(golden_enc.encode(
                img, scan_layout="interleaved", huffman=exact,
                restart_interval_mcu_rows=rows)) for img in batch]))
        for what, want in refs:
            same = sum(f == g for f, g in zip(files, want))
            if same != b or len(files) != b:
                raise AssertionError(f"ShardedEncoder {label}: {same}/{b} "
                                     f"files equal {what}'s")
        summary = check_files(dict(label=label, original=batch[0],
                                   restarts=(1, spd - 1)), files, fixed_dht)
        digests[label] = [hashlib.sha256(f).hexdigest() for f in files]
        print(f"  ShardedEncoder {label} {b}x{h}x{w}, {spd} segments a slab"
              f" (restarts every {rows} MCU rows): {b}/{b} files "
              f"byte-identical to " + ", ".join(what for what, _ in refs)
              + f"; {summary}")
    mesh_decode_checks(mesh, dev, launches, dcases, scases)
    if dcases and scases:
        padded_lane_checks(dev, dcases[PADDED_DCASE], next(
            c for c in scases if "DRI-less" in c["label"]))
    split_runs(seed, digests, card)
    dist.destroy_process_group()
    print(f"phase 3j (multi-device) took {time.perf_counter() - t0:.1f} s")
    return batches


def mesh_decode_checks(mesh, dev, launches: dict, dcases: list[dict],
                       scases: list[dict]) -> None:
    """Phase 3j's decode: 3e's restart files through ``decode_jpeg_batch``
    over ``mesh``, 3f's streams without restarts through it (and
    ``speculative_decode``), 3f's restart pairs through
    ``speculative_decode_restart``; each must equal the call without a
    mesh."""
    for case in dcases:
        files = case["files"]
        got = counted(f"decode_jpeg_batch(mesh) of {case['label']}",
                      lambda: decode_jpeg_batch(files, "device", device=dev,
                                                mesh=mesh),
                      ("decode_segments",), launches)
        want = decode_jpeg_batch(files, "device", device=dev)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"{case['label']}: decode over the mesh "
                                 f"differs from the decode without one")
    for case in scases:
        files = case["files"]
        calls = {"decode_jpeg_batch": lambda m: decode_jpeg_batch(
            files, "device", device=dev, mesh=m)}
        if case["call"] == "one":
            calls["speculative_decode"] = lambda m: [pspec.speculative_decode(
                files[0], device=dev, mesh=m)]
        elif case["call"] == "restart":
            calls = {"speculative_decode_restart": lambda m: [
                pspec.speculative_decode_restart(f, device=dev, mesh=m)
                for f in files]}
        for name, call in calls.items():
            got = counted(f"{name}(mesh) of {case['label']}",
                          lambda: call(mesh),
                          ("scan_positions", "decode_segments"), launches,
                          g_row="decode_segments speculative")
            want = call(None)
            if any(g is None for g in got) or not all(
                    torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"{name} of {case['label']}: over the "
                                     f"mesh it differs from the call without"
                                     f" one")
    print(f"  decode over the {'x'.join(map(str, mesh.shape))} mesh: "
          f"{len(dcases)} restart cases of 3e and {len(scases)} cases of 3f"
          f" equal the calls without a mesh")


def padded_lane_checks(dev, dcase: dict, scase: dict) -> None:
    """Kernel G in both modes and kernel H on the lane shares that a mesh
    of several ranks gives them (``kernels.huffdec.lane_share``: equal
    contiguous shares, the last padded with empty lanes), every share
    launched on this card, against one launch over all the lanes: the
    real lanes must be equal.  A 1x1 mesh pads no share, so this is where
    the padding runs on one card.  These launches are not the main
    path's."""
    infos = [pdec._parse_device_eligible(f) for f in dcase["files"]]
    *arrays, samp, nblk_seg, max_words = pdec._lane_inputs(infos)
    s, mc, dl, hv, nb = (torch.from_numpy(a).to(dev) for a in arrays)
    p = pspec._parse_spec(scase["files"][0])
    lanes = pspec.scan_lanes(p["scan_list"], dev, None, p["sampling"])
    fx = pspec.fixpoint(lanes)
    if fx is None:
        raise AssertionError(f"{scase['label']}: no fixpoint")
    (ss, smc, sdl, shv, snb, ssamp, snblk, swords), kw = \
        pspec.payload_inputs(lanes, *fx)
    ep = pspec._put(dev, fx[0], fx[1])
    cap = pspec.first_cap(lanes)
    runs = {
        f"G on {dcase['label']}": (
            (s, hv), (mc, dl, nb), 0,
            lambda M, m: khd.decode_segments(M[0], m[0], m[1], M[1], m[2],
                                             samp, nblk_seg, max_words)),
        f"G speculative on {scase['label']}": (
            (ss, shv), (smc, sdl, snb, kw["entry"], kw["phase"]), 0,
            lambda M, m: khd.decode_segments(
                M[0], m[0], m[1], M[1], m[2], ssamp, snblk, swords,
                entry=m[3], phase=m[4], phased=kw["phased"])),
        f"H on {scase['label']}": (
            (lanes.streams, lanes.tables[2]),
            (lanes.tables[0], lanes.tables[1], ep[0:1], lanes.limits,
             ep[1:2]), 1,
            lambda M, m: torch.stack(khd.scan_positions(
                M[0], m[0], m[1], M[1], m[2], m[3], cap, lanes.max_words,
                sampling=lanes.sampling, phase=m[4])))}
    parts = []
    for label, (major, minor, dim, launch) in runs.items():
        n = major[0].shape[0]
        whole = launch(major, minor)
        worlds = sorted({2, 4, next(w for w in range(3, n + 4) if n % w)})
        for world in worlds:
            got = torch.cat([launch(*khd.lane_share(r, world, n, major,
                                                    minor))
                             for r in range(world)], dim).narrow(dim, 0, n)
            if not torch.equal(got, whole):
                raise AssertionError(f"{label}: the shares of {world} ranks"
                                     f" differ from one launch")
        parts.append(f"{label}: {n} lanes, shares of " + ", ".join(
            f"{w} ranks (pad {-n % w})" for w in worlds))
    print("  lanes split as over a mesh, each share a launch on the card, "
          "the last padded with empty lanes; the real lanes equal one "
          "launch over them all: " + "; ".join(parts))


def split_runs(seed: int, digests: dict, card: str) -> None:
    """The split of phase 3j over NCCL ranks, one a card: each of SPLITS
    the machine has the cards for; every rank's decode of 3e's and 3f's
    cases over the mesh must equal the calls without one (the rank fails
    otherwise), its files of ``split_cases`` the 1x1 mesh's
    (``digests``), and the mesh decode of them the decode without one.
    Prints the lanes of each decode case and each rank's
    ``encode_batch`` ms of the SHARDED_TIMED cases."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 3j: the split ran at world size 1 only: "
              f"torch.cuda.device_count() is {n}, and a 1x2 split needs 2 "
              f"cards (2x2: 4)")
        return
    for world, data, space in SPLITS:
        if n < world:
            print(f"phase 3j: no {data}x{space} split: it needs {world} "
                  f"cards, this machine has {n}")
            continue
        t0 = time.perf_counter()
        results = spawn_split(world, seed)
        for r, res in enumerate(results):
            for label, got in res["encode"].items():
                if got["digests"] != digests[label]:
                    raise AssertionError(f"{data}x{space} split, rank {r}: "
                                         f"{label} files differ from the 1x1"
                                         f" mesh's")
                if not got["decode_equal"]:
                    raise AssertionError(f"{data}x{space} split, rank {r}: "
                                         f"{label} decode over the mesh "
                                         f"differs")
        encoded = results[0]["encode"]
        print(f"phase 3j: {data}x{space} split over {world} NCCL ranks (one "
              f"a card): every rank's files of {list(encoded)} equal the "
              f"1x1 mesh's, and their decode over the mesh the decode "
              f"without one; launches on rank 0: " + json.dumps(
                  {k: v["launches"] for k, v in encoded.items()})
              + f"; not split: "
              f"{[c[0] for c in SHARDED_CASES if c[5] % 2]} (135 MCU rows "
              f"do not halve); {time.perf_counter() - t0:.1f} s")
        print(f"phase 3j: {data}x{space} split: on every rank the decode "
              f"over the mesh of 3e's restart cases and 3f's cases equals "
              f"the call without one; kernel G's lanes by case (over "
              f"{space} ranks of space; the other 3f cases not counted): "
              + "; ".join(f"{k}: {v}" + (f" (pad {-v % space})"
                                        if v % space else "")
                          for k, v in results[0]["decode"].items()
                          if v is not None))
        for label in SHARDED_TIMED:
            t = [res["encode"][label]["timing"] for res in results]
            print(f"timing ShardedEncoder.encode_batch {label} (mesh "
                  f"{data}x{space}, {world} cards) on [{card}]: ms a batch "
                  f"by rank, the global batch on the host: "
                  + ", ".join(f"{x['host_ms']:.4f}" for x in t)
                  + "; on each rank's card: "
                  + ", ".join(f"{x['card_ms']:.4f}" for x in t)
                  + f" (medians of {SPLIT_RUNS} after 3 warm calls); "
                  f"device µs per call (card batch, torch.profiler) by "
                  f"rank " + ", ".join(f"{x['device_us']:.2f}" for x in t)
                  + ", idle share " + ", ".join(f"{x['idle']:.4f}"
                                                for x in t)
                  + "; rank 0 by name: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in t[0]["by_name"])
                  + "; annotation spans (not counted): " + ", ".join(
                      f"{k} {v:.2f}" for k, v in t[0]["spans"].items()))


def spawn_split(world: int, seed: int) -> list[dict]:
    """Run ``split_worker`` in ``world`` processes of this script -> each
    rank's result.  All are killed, and the run fails with their stderr,
    if one fails or they do not all end within SPLIT_TIMEOUT_S."""
    addr = f"localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        run_ranks([[sys.executable, os.path.abspath(__file__), "--seed",
                    str(seed), "--rank", str(r), "--world", str(world),
                    "--coordinator", addr, "--out", outs[r]]
                   for r in range(world)], tmp, SPLIT_TIMEOUT_S)
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
    return results


def split_worker(args) -> int:
    """One rank of ``spawn_split``: NCCL through ``initialize``, a
    (world / 2) x 2 mesh; 3e's restart cases (and the first file of its
    4:2:2 pair: 5 lanes, which do not halve) and 3f's cases decoded over
    it against the calls without it (``mesh_decode_checks``, which raises
    on a difference); ``split_cases`` encoded over it, and their decode
    over the mesh against the decode without one; the result goes to
    ``args.out`` as JSON."""
    pdist.initialize(coordinator_address=args.coordinator,
                     num_processes=args.world, process_id=args.rank)
    pdist.initialize()
    mesh = make_mesh(data=args.world // 2, space=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    dcases = decode_cases(np.random.default_rng(args.seed + 5), dev)
    scases = spec_cases(np.random.default_rng(args.seed + SPEC_RNG_OFFSET),
                        dev, dcases)
    two = dcases[PADDED_DCASE]
    dcases.append(dict(two, label="the first file of " + two["label"],
                       files=two["files"][:1],
                       originals=two["originals"][:1]))
    mesh_decode_checks(mesh, dev, collections.defaultdict(int), dcases,
                       scases)
    decode = {c["label"]: lane_count(c, dev) for c in dcases + scases}
    geometry = SHARDED_CASES[0][2:5]
    batch = sharded_batches(args.seed, upto=geometry)[geometry]
    out = {"decode": decode, "encode": {}}
    for (label, samp, b, h, w, _, mode, dtype), spd in split_cases():
        enc = ShardedEncoder(mesh, h, w, sharded_config(samp, mode, dtype),
                             segs_per_device=spd)
        torch.cuda.synchronize()
        reset_launch_counts()
        files = enc.encode_batch(batch)
        counts = launch_counts()
        missing = [k for k in sharded_path(mode, dtype) if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} not launched")
        plain = decode_jpeg_batch(files, "device", device=dev)
        meshed = decode_jpeg_batch(files, "device", device=dev, mesh=mesh)
        out["encode"][label] = dict(
            timing=(split_timing(enc, batch, dev)
                    if label in SHARDED_TIMED else None),
            digests=[hashlib.sha256(f).hexdigest() for f in files],
            decode_equal=all(torch.equal(a, c) for a, c in zip(plain,
                                                              meshed)),
            launches={k: v for k, v in counts.items() if v})
    dist.barrier()
    dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


def lane_count(case: dict, dev) -> int | None:
    """The lanes kernel G decodes in a case of 3e (its restart segments)
    or in a one-file case of 3f (its speculative lanes); None for the
    other cases of 3f."""
    if "one" in case:
        files = case["files"][:1] if case["one"] else case["files"]
        return sum(len(pdec._parse_device_eligible(f)["segs"])
                   for f in files)
    if case["call"] != "one":
        return None
    p = pspec._parse_spec(case["files"][0])
    return len(pspec.scan_lanes(p["scan_list"], dev, None,
                                p["sampling"]).starts)


def split_timing(enc: ShardedEncoder, batch: np.ndarray, dev) -> dict:
    """One split rank's ``encode_batch`` ms with the global batch on the
    host and on its card, and its device µs per call, idle share and ops
    by name with the batch on the card.  Every rank makes the same calls
    (each ``encode_batch`` runs collectives)."""
    xd = torch.from_numpy(batch).to(dev)
    spans = {}
    per_call, idle = device_profile(lambda: enc.encode_batch(xd),
                                    SPLIT_RUNS, spans)
    return dict(host_ms=host_ms(lambda: enc.encode_batch(batch), SPLIT_RUNS),
                card_ms=host_ms(lambda: enc.encode_batch(xd), SPLIT_RUNS),
                device_us=sum(per_call.values()), idle=idle, spans=spans,
                by_name=sorted(per_call.items(),
                               key=lambda kv: -kv[1])[:8])


def sharded_timings(batches: dict, dev, card: str, runs: int) -> None:
    """Phase 4 for 3j: on a 1x1 mesh brought up without ``initialize`` (a
    world-size-1 NCCL group on an in-process store), each SHARDED_TIMED
    case's ``encode_batch`` ms beside ``FastBatchEncoder``'s on the same
    batch with the same restart interval (in turns), each one's device
    time and idle share, and the collectives' device µs."""
    mesh = make_mesh()
    for label, samp, b, h, w, spd, mode, dtype in SHARDED_CASES:
        if label not in SHARDED_TIMED:
            continue
        x = torch.from_numpy(batches[(b, h, w)]).to(dev)
        rows = h // SAMPLING_GEOMETRY[samp][1] // spd
        sharded = ShardedEncoder(mesh, h, w,
                                 sharded_config(samp, mode, dtype),
                                 segs_per_device=spd)
        fast = FastBatchEncoder(h, w, sharded_config(samp, mode, dtype, rows),
                                device=dev)
        f0, s0, s1, f1 = (host_ms(lambda e=e: e.encode_batch(x), runs)
                          for e in (fast, sharded, sharded, fast))
        spans = {}
        sper, sidle = device_profile(lambda: sharded.encode_batch(x), runs,
                                     spans)
        fper, fidle = device_profile(lambda: fast.encode_batch(x), runs)
        coll = {k: v for k, v in sper.items()
                if "nccl" in k.lower() or "DtoD" in k}
        print(f"timing ShardedEncoder.encode_batch {label} {b}x{h}x{w} "
              f"(mesh 1x1, {spd} segments, r{rows}) on [{card}]: "
              f"{(s0 + s1) / 2:.4f} ms ({s0:.4f}, {s1:.4f}) beside "
              f"FastBatchEncoder.encode_batch {(f0 + f1) / 2:.4f} ms "
              f"({f0:.4f}, {f1:.4f}) on the same batch; median of {runs}, "
              f"in turns")
        print(f"  device µs per call (torch.profiler, {runs} calls): sharded"
              f" {sum(sper.values()):.2f}, idle share {sidle:.4f}; "
              f"FastBatchEncoder {sum(fper.values()):.2f}, idle share "
              f"{fidle:.4f}; collectives' kernels and device copies: "
              + (", ".join(f"{k} {v:.2f}" for k, v in coll.items())
                 or "none seen") + "; annotation spans on the device "
              "(enclosing the collectives' ops and waits, not counted): "
              + (", ".join(f"{k} {v:.2f}" for k, v in spans.items())
                 or "none") + "; sharded by name: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      sper.items(), key=lambda kv: -kv[1])[:10]))
    dist.destroy_process_group()


def device_profile(fn, runs: int, spans: dict | None = None
                   ) -> tuple[dict[str, float], float]:
    """torch.profiler over ``runs`` warm calls of ``fn``: (device µs per
    call by kernel or copy name, the device's idle share of the wall
    time).  Empty names mean the profiler saw no device activity.  A user
    annotation's range on the device (such as c10d's "nccl:all_gather",
    which encloses a collective's device ops and the waits between them)
    is no device work of its own: it counts nowhere, or in ``spans``
    (µs per call by name) when given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_call = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        # "(anonymous namespace)::place_kernel(unsigned int const*, ...)"
        # -> "place_kernel"
        name = ev.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].strip() or ev.key
        if getattr(ev, "is_user_annotation", False):
            if spans is not None:
                spans[name] = spans.get(name, 0.0) + us / runs
            continue
        per_call[name] = per_call.get(name, 0.0) + us / runs
    busy = sum(per_call.values()) * runs
    return per_call, 1.0 - busy / wall_us


DEVICE_US_EXTRA = 4  # profiles device_us may add to replace dropped ones


def good_profiles(profiles: list[dict]) -> list[int]:
    """Indices of the profiles that count: device time above 0, and every
    device op that all the other profiles saw (a profile that lost
    activity records reads short, or 0)."""
    keep = []
    for i, p in enumerate(profiles):
        others = [set(q) for j, q in enumerate(profiles) if j != i and q]
        seen_by_all = set.intersection(*others) if others else set()
        if sum(p.values()) > 0 and seen_by_all <= set(p):
            keep.append(i)
    return keep


def device_us(fn, runs: int, attempts: int = 3,
              extra: int = DEVICE_US_EXTRA) -> tuple[float, list, list, int]:
    """Device µs per call of ``fn`` by torch.profiler: the median of
    ``attempts`` good profiles (``good_profiles``), taking up to ``extra``
    more profiles to replace dropped ones; the kept readings; the names of
    the device ops the kept profiles saw; and how many profiles were
    dropped.  Raises if no good profile remains."""
    profiles = [device_profile(fn, runs)[0] for _ in range(attempts)]
    while len(good_profiles(profiles)) < attempts and \
            len(profiles) < attempts + extra:
        profiles.append(device_profile(fn, runs)[0])
    keep = good_profiles(profiles)
    if not keep:
        raise AssertionError(
            f"device_us: none of {len(profiles)} profiles saw the device "
            f"work (readings " + ", ".join(
                f"{sum(p.values()):.2f}" for p in profiles) + ")")
    readings = [sum(profiles[i].values()) for i in keep]
    names = sorted(set().union(*(profiles[i] for i in keep)))
    return (statistics.median(readings), readings, names,
            len(profiles) - len(keep))


def device_text(us: tuple[float, list, list, int]) -> str:
    """``device_us``' result as printed."""
    return (f"device {us[0]:.2f} µs per call (torch.profiler, median of "
            f"{len(us[1])} profiles kept, {us[3]} dropped: "
            + ", ".join(f"{r:.2f}" for r in us[1]) + "; device ops: "
            + ", ".join(us[2]) + ")")


def scan_kernel_times(x: torch.Tensor, consts, lut: torch.Tensor,
                      card: str, runs: int) -> None:
    """The ports of K14 (F with one LUT: ``kernels.lut.attach``'s kernel)
    and K15 (C + D: ``kernels.pack.pack_segments``) at the shapes of the Y
    scan of one 3-scan ``encode`` of ``x`` ([1, H, W*3]): each held
    exactly against its plain twin, then timed in turns next to it, with
    its bound."""
    n = x.shape[1] * x.shape[2] // 3 // 64  # Y blocks
    cy = front.front_dct(x, *consts, order="scan")[:n].view(1, n, 64)
    pf, _ = fused.symbolize_fields(cy, 1, layout=SCAN_Y)
    lut1 = lut[None].contiguous()
    value, nbits, bits = fused.attach_pf(pf, lut1)
    seg_rows = kpack.rows_per_segment(n * 64)

    def pack_plain():
        offs, totals = fused.segment_offsets_plain(bits)
        return (fused.place_plain(value, nbits, offs, seg_rows * 128),
                totals)
    slots = n * 64
    cases = {
        # F compared on the fields its contract defines
        "K14 (F, one LUT)": (
            lambda: fused.attach_pf(pf, lut1),
            lambda: fused.attach_pf_plain(pf, lut1),
            fields_nbytes(slots * 4, nbits, 1),
            lambda out: contract_fields(*out),
            slots * 4 + 4096 + slots * 5 + n * 4),
        # C + D read what D reads, with C's bits in place of the offsets
        "K15 (C + D)": (
            lambda: kpack.pack_segments(value, nbits, 1, seg_rows, bits),
            pack_plain, place_nbytes(nbits, bits.sum(-1, dtype=torch.int32)),
            lambda out: (stream_words(*out), out[1]), None),
    }
    for label, (kernel, plain, nbytes, narrow, per_slot) in cases.items():
        err = max_abs_err(narrow(kernel()), narrow(plain()))
        if err:
            raise AssertionError(f"{label} disagrees with its plain twin: "
                                 f"max_abs_err {err}")
        p0, k0, k1, p1 = (cuda_ms(f, runs)
                          for f in (plain, kernel, kernel, plain))
        # one call's launches cost the host more than the card's work, so
        # the events above time the wrapper; the profiler gives the card's
        per_call, _ = device_profile(kernel, runs)
        print(f"timing {label} at the 3-scan Y scan [1, {n}, 64] of "
              f"{x.shape[2] // 3}x{x.shape[1]} on [{card}]: "
              f"{(k0 + k1) / 2:.4f} ms ({k0:.4f}, {k1:.4f}), plain twin "
              f"{(p0 + p1) / 2:.4f} ms ({p0:.4f}, {p1:.4f}), bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes"
              + (f"; {per_slot / HBM_BYTES_PER_S * 1e3:.5f} counted per "
                 f"slot" if per_slot else "") + "); "
              f"max_abs_err {err} (tolerance: exact); device µs per call "
              f"(torch.profiler): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(per_call.items(),
                                                    key=lambda kv: -kv[1])))


def y_scan_as_gray(data: bytes) -> bytes:
    """The Y scan of a 3-scan file as a gray JFIF of its own: the segments
    before its SOS (SOF0 rewritten to one component: the Y scan's blocks
    are in raster order of the Y grid either way), its SOS, its
    entropy-coded segments with their RSTn markers, and EOI."""
    out, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        n = (data[pos + 2] << 8) | data[pos + 3]
        seg = data[pos:pos + 2 + n]
        if data[pos + 1] == 0xC0:
            seg = jfif.sof0_segment((seg[7] << 8) | seg[8],
                                    (seg[5] << 8) | seg[6], gray=True)
        out.append(seg)
        pos += 2 + n
    n = (data[pos + 2] << 8) | data[pos + 3]
    out += [data[pos:khd._entropy_end(data, pos + 2 + n)], b"\xff\xd9"]
    return b"".join(out)


def decode_cases(rng: np.random.Generator, dev) -> list[dict]:
    """The decode runs of phase 3e: each ``label``, ``files`` (the port's
    restart files, encoded on ``dev``), ``originals`` (their pixels, or
    None) and ``one`` (decode_jpeg of one file instead of
    decode_jpeg_batch)."""
    cases = []
    for (samp, b, h, w, rows, mode), one in (
            [(g, False) for g in DECODE_GEOMETRIES] + [(DECODE_ONE, True)]):
        batch = synthetic_batch(rng, b, h, w)
        cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                           subsampling=samp, restart_interval_mcu_rows=rows)
        files = FastBatchEncoder(h, w, cfg, device=dev).encode_batch(
            torch.from_numpy(batch).to(dev))
        segs = len(pdec._parse_device_eligible(files[0])["segs"])
        cases.append(dict(
            label=f"{'decode_jpeg' if one else 'decode_jpeg_batch'} "
                  f"{LABEL[samp]} {mode} {b}x{h}x{w} r{rows} ({segs} "
                  f"segments per image)",
            files=files, originals=list(batch), one=one))
    h, w, rows = DECODE_GRAY
    frame = synthetic_batch(rng, 1, h, w)[0]
    data = JpegEncoder(EncodeConfig(restart_interval_mcu_rows=rows),
                       device=dev).encode(torch.from_numpy(frame).to(dev))
    cases.append(dict(
        label=f"decode_jpeg_batch gray: the Y scan of a 3-scan {w}x{h} "
              f"file, restarts every {rows} block rows",
        files=[y_scan_as_gray(data)], originals=None, one=False))
    return cases


def rgb_agreement(got: torch.Tensor, want: np.ndarray, what: str) -> str:
    """Hold decoded pixels to jpeg_tpu's device-vs-host bound; returns
    the max |diff| and the share within 1."""
    g = got.cpu().numpy().astype(np.int32)
    if g.shape != want.shape:
        raise AssertionError(f"{what}: shape {g.shape} != {want.shape}")
    diff = np.abs(g - want.astype(np.int32))
    share = float(np.mean(diff <= 1))
    if diff.max() > RGB_MAX_DIFF or not share > RGB_WITHIN_1:
        raise AssertionError(f"{what}: max |diff| {diff.max()}, share "
                             f"within 1 {share:.6f} (bound: max <= "
                             f"{RGB_MAX_DIFF}, share > {RGB_WITHIN_1})")
    return f"max |diff| {diff.max()}, within 1 {share:.6f}"


def check_decode_case(case: dict, imgs: list[torch.Tensor], dev) -> str:
    """Kernel G's coefficients against the native decoder's (exact), and
    the decoded pixels against the CPU path's reconstruction of those
    coefficients and the golden decoder's (jpeg_tpu's bound); returns a
    summary.  The extra kernel launch here is not the main path's."""
    files = case["files"][:1] if case["one"] else case["files"]
    infos = [pdec._parse_device_eligible(f) for f in files]
    zz = pdec._decode_lanes(infos, dev).cpu()
    off, parts = 0, []
    for i, (f, inf, img) in enumerate(zip(files, infos, imgs)):
        S = len(inf["segs"])
        planes = pdec._planes_of(zz[off:off + S], inf)
        off += S
        comps, coeffs, *_ = golden.parse_coefficients(f)
        for got, comp in zip(planes, comps):
            want = torch.from_numpy(coeffs[comp.comp_id])
            err = max_abs_err((got,), (want,))
            if err:
                raise AssertionError(f"{case['label']}: image {i}: kernel G "
                                     f"and the native decoder differ, "
                                     f"max_abs_err {err}")
        cpu = decode_jpeg(f, "host", device="cpu").numpy()
        parts.append(f"image {i}: vs the CPU path "
                     + rgb_agreement(img, cpu, f"{case['label']} image {i}")
                     + "; vs the golden decoder "
                     + rgb_agreement(img, golden.decode(f),
                                     f"{case['label']} image {i}"))
        if case["originals"] is not None:
            quality_db = golden.psnr(case["originals"][i], img.cpu().numpy())
            if not quality_db > MIN_PSNR_DB:
                raise AssertionError(f"{case['label']}: image {i}: PSNR "
                                     f"{quality_db:.2f} dB <= {MIN_PSNR_DB}")
            parts[-1] += f"; PSNR {quality_db:.2f} dB"
    return (f"{case['label']}: zz of {len(files)} image(s), "
            f"{zz.shape[0]} lanes, equal to the native decoder's "
            f"(max_abs_err 0); " + " | ".join(parts[:2])
            + (f" | ... ({len(parts)} images)" if len(parts) > 2 else ""))


def huff_bound(entropy_bytes: int, table_sets: int, lane_ints: int,
               out_bytes: int) -> float:
    """bound_ms of kernel G or H: the bytes the function must move over the
    HBM rate.  The un-stuffed entropy bytes read once (not the rows'
    padding, nor the slack a lane reads past its chunk), each table set
    (maxc, delt, hvp) once, although the kernels take a copy per lane,
    ``lane_ints`` int32 of per-lane inputs, and the outputs written once
    (for G, the zz of the true blocks, not the padded lanes)."""
    nbytes = entropy_bytes + table_sets * (64 * 4 * 2 + 256 * 4) \
        + lane_ints * 4 + out_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3


def decode_phase(dcases: list[dict], dev, launches: dict):
    """Phase 3e: kernel G against its twin on case 0's full kernel inputs
    (clean and corrupted) and beyond them (``decode_extra_checks``), then
    each case's main-path run with the launch counts reset just before it
    (added to ``launches``), checked by ``check_decode_case``.  Returns (the
    twin's max_abs_err, case 0's kernel inputs, its clean inputs on
    ``dev``, [(label, zero-argument call of the case)], the r17 lanes'
    kernel call, twin seconds, bound and label from
    ``decode_extra_checks``)."""
    g_in = pdec._lane_inputs([pdec._parse_device_eligible(f)
                              for f in dcases[0]["files"]])
    g_streams, g_maxc, g_delt, g_hvp, g_nblk, g_samp, g_seg, g_mw = g_in
    corrupt = g_streams.copy()
    corrupt[1, 5] ^= 1 << 11  # a flipped bit: lane 1 loses sync
    corrupt[2, 8:10] = -1     # 64 one-bits: no code matches (length 17)
    twin_in, twin_err = {}, 0
    for label, st in (("clean", g_streams), ("corrupted", corrupt)):
        a = [torch.from_numpy(x).to(dev)
             for x in (st, g_maxc, g_delt, g_hvp, g_nblk)]
        twin_in[label] = a
        got = khd.decode_segments(*a, g_samp, g_seg, g_mw)
        want = khd.decode_segments_plain(*a, g_samp, g_seg, g_mw)
        err = max_abs_err((got.cpu(),), (want.cpu(),))
        twin_err = max(twin_err, err)
        print(f"kernel decode_segments ({label}: every lane of "
              f"{dcases[0]['label']}): {tuple(got.shape)} {got.dtype}: "
              f"max_abs_err {err} (tolerance: exact)")
        if err:
            raise AssertionError(f"kernel decode_segments disagrees with its "
                                 f"plain twin: max_abs_err {err}")
    extra_err, r17 = decode_extra_checks(twin_in["clean"], g_in, dcases[2],
                                         dev, np.random.default_rng(9))
    twin_err = max(twin_err, extra_err)
    runs = []
    for case in dcases:
        def fn(files=case["files"], one=case["one"]):
            out = ([decode_jpeg(files[0], "device", device=dev)] if one
                   else decode_jpeg_batch(files, "device", device=dev))
            torch.cuda.synchronize()
            return out
        torch.cuda.synchronize()
        reset_launch_counts()
        imgs = fn()
        counts = launch_counts()
        print(f"main path {case['label']}: launches {json.dumps(counts)}")
        if counts["decode_segments"] <= 0:
            raise AssertionError(f"kernel decode_segments was not launched on "
                                 f"the path {case['label']}")
        for name, n in counts.items():
            launches[name] += n
        print("  " + check_decode_case(case, imgs, dev))
        runs.append((case["label"], fn))
    return twin_err, g_in, twin_in["clean"], runs, r17


def decode_extra_checks(g_dev: list, g_in, r17_case: dict, dev,
                        rng: np.random.Generator):
    """Kernel G against its twin beyond case 0's lanes: the 8 long lanes of
    the r17 pair (``r17_case``, about 12240 blocks and 16 KB a lane); 64
    lanes of case 0 with rows padded into each of G's shared-memory layouts
    (``LANE_LAYOUTS``, the layout asked of the source); the same lanes
    with random bits, on its tables and on tables off the lookahead step
    (``off_step``).  Returns (the max |error|, (the r17 lanes' kernel call,
    the seconds its twin took, its bound in ms, a label))."""
    *_, samp, nseg, mw = g_in
    streams, maxc, delt, hvp, nblk = g_dev
    streams, hvp = streams[:64].contiguous(), hvp[:64].contiguous()
    maxc, delt, nblk = (t[:, :64].contiguous() for t in (maxc, delt, nblk))
    r17_in = pdec._lane_inputs([pdec._parse_device_eligible(f)
                                for f in r17_case["files"]])
    a17 = [torch.from_numpy(x).to(dev) for x in r17_in[:5]]
    samp17, nseg17, mw17 = r17_in[5:]
    check_layout("decode_segments", mw17, (4, True))
    cases = [(f"the r17 pair's {a17[0].shape[0]} lanes of {nseg17} blocks, "
              f"{mw17} words", (*a17, samp17, nseg17, mw17))]
    for words, layout, what in LANE_LAYOUTS:
        check_layout("decode_segments", words, layout)
        cases.append((f"64 lanes, rows of {words} words: {what}", (
            torch.nn.functional.pad(streams, (0, words - mw)), maxc, delt,
            hvp, nblk, samp, nseg, words)))
    noise = random_rows(streams, rng)
    cases += [("64 lanes of random bits", (noise, maxc, delt, hvp, nblk,
                                            samp, nseg, mw)),
              ("64 lanes, tables off the lookahead step", (
                  streams, off_step(maxc), delt, hvp, nblk, samp, nseg, mw)),
              ("64 lanes of random bits, tables off the lookahead step", (
                  noise, off_step(maxc), delt, hvp, nblk, samp, nseg, mw))]
    err, twin_s = 0, []
    for label, args in cases:
        t0 = time.perf_counter()
        want = khd.decode_segments_plain(*args)
        torch.cuda.synchronize()
        twin_s.append(time.perf_counter() - t0)
        got = khd.decode_segments(*args)
        e = max_abs_err((got.cpu(),), (want.cpu(),))
        err = max(err, e)
        print(f"kernel decode_segments ({label}): {tuple(got.shape)} "
              f"{got.dtype}: max_abs_err {e} (tolerance: exact); nonzero "
              f"{int((want != 0).sum())}; the twin took {twin_s[-1]:.1f} s")
        if e:
            raise AssertionError(f"kernel decode_segments disagrees with its "
                                 f"plain twin ({label}): max_abs_err {e}")
    infos = [pdec._parse_device_eligible(f) for f in r17_case["files"]]
    bound17 = huff_bound(sum(len(seg) for info in infos
                             for seg in info["segs"]), len(infos),
                         a17[0].shape[0], int(a17[4].sum()) * 64 * 4)
    args17 = cases[0][1]
    return err, (lambda: khd.decode_segments(*args17), twin_s[0], bound17,
                 cases[0][0])


def g_timing_extras(g_full, g_dev: list, g_in, r17, card: str,
                    runs: int) -> None:
    """Phase 4, kernel G beyond its record row: on the r17 pair's long
    lanes, beside its twin and bound; at case 0's lanes, the share of its
    set-up (every lane's tables and row staged, no block walked, one block
    written) and a fill of its output alone (what a memset before it would
    cost)."""
    kernel, twin_s, bound17, label = r17
    k0, k1 = cuda_ms(kernel, 5, 3), cuda_ms(kernel, 5, 3)
    try:
        r17_us = device_text(device_us(kernel, 3))
    except AssertionError as e:
        # the profiler has lost this 5 ms launch's records in most
        # profiles of every card run so far; the event times above stand
        r17_us = f"device µs not measured ({e})"
    print(f"timing kernel decode_segments (G) at {label} on [{card}]: "
          f"{(k0 + k1) / 2:.4f} ms ({k0:.4f}, {k1:.4f}), {r17_us}, bound "
          f"{bound17:.5f} ms (bytes); plain twin {twin_s:.1f} s (one call, "
          f"phase 3e)")
    *_, samp, nseg, mw = g_in
    none = torch.zeros_like(g_dev[4])
    setup = device_us(lambda: khd.decode_segments(
        *g_dev[:4], none, samp, 1, mw), runs)
    full = device_us(g_full, runs)
    out = g_full()
    fill = device_us(out.zero_, runs)
    print(f"kernel decode_segments (G) at {g_dev[0].shape[0]} lanes on "
          f"[{card}]: set-up alone (no block walked, one written) "
          f"{device_text(setup)}, {setup[0] / full[0]:.4f} of the whole "
          f"launch's {full[0]:.2f} µs; a fill of its "
          f"{out.numel() * 4 / 1e6:.1f} MB output (zero_) "
          f"{device_text(fill)}")


def spec_cases(rng: np.random.Generator, dev, dcases: list[dict]):
    """The runs of phase 3f: each ``label``, ``files``, ``originals``
    (their pixels, or None), ``call`` ("one": decode_jpeg of the file,
    "batch": decode_jpeg_batch, "restart": speculative_decode_restart of
    each file) and ``kernels`` (those its main path must launch)."""
    path = ("scan_positions", "decode_segments")
    cases = []
    for h, w in SPEC_SCAN:
        frame = synthetic_batch(rng, 1, h, w)[0]
        cases.append(dict(
            label=f"decode_jpeg 3-scan {w}x{h} (JpegEncoder(EncodeConfig()))",
            files=[JpegEncoder(EncodeConfig(), device=dev).encode(
                torch.from_numpy(frame).to(dev))], originals=[frame],
            call="one", kernels=path))
    b, h, w = SPEC_BATCH
    batch = synthetic_batch(rng, b, h, w)
    cases.append(dict(
        label=f"decode_jpeg_batch 3-scan {b}x{w}x{h}",
        files=JpegEncoder(EncodeConfig(), device=dev).encode_batch(
            torch.from_numpy(batch).to(dev)), originals=list(batch),
        call="batch", kernels=path))
    for samp, h, w in SPEC_INTERLEAVED:
        frame = synthetic_batch(rng, 1, h, w)
        cfg = EncodeConfig(scan_layout="interleaved", subsampling=samp)
        data = FastBatchEncoder(h, w, cfg, device=dev).encode_batch(
            torch.from_numpy(frame).to(dev))[0]
        st = khd.parse_scan_structure(data, require_restarts=False)
        if st["restart_interval"] or b"\xff\xdd" in data[:data.index(
                b"\xff\xda")]:
            raise AssertionError(f"{samp} {w}x{h}: the file carries a DRI")
        cases.append(dict(
            label=f"decode_jpeg DRI-less interleaved {LABEL[samp]} {w}x{h}",
            files=[data], originals=list(frame), call="one", kernels=path))
    h, w = SPEC_GRAY
    plane = synthetic_batch(rng, 1, h, w)[0, ..., 0]
    cases.append(dict(
        label=f"decode_jpeg gray {w}x{h} (encode_gray, no restarts)",
        files=[encode_gray(torch.from_numpy(plane).to(dev), EncodeConfig(),
                           device=dev)], originals=None, call="one",
        kernels=path))
    for k in SPEC_RESTART_CASES:
        cases.append(dict(
            label="speculative_decode_restart of " + dcases[k]["label"],
            files=dcases[k]["files"], originals=dcases[k]["originals"],
            call="restart", kernels=path))
    return cases


def spec_call(case: dict, engine: str, dev):
    """The case's call on the card -> its images (synchronized)."""
    files = case["files"]
    if case["call"] == "one":
        out = [decode_jpeg(files[0], engine, device=dev)]
    elif case["call"] == "batch":
        out = decode_jpeg_batch(files, engine, device=dev)
    else:
        out = [pspec.speculative_decode_restart(f, device=dev) for f in files]
        if any(o is None for o in out):
            raise AssertionError(f"{case['label']}: no fixpoint")
    torch.cuda.synchronize()
    return out


def restart_lanes(data: bytes, dev) -> "pspec.SpecLanes":
    """The lanes ``speculative_decode_restart`` gives one restart file."""
    rst = pspec._restart_spec(data)
    return pspec.prepare_lanes(rst["chains"], dev, pspec._auto_lane_bytes(
        sum(map(len, rst["info"]["segs"]))), rst["sampling"])


def case_planes(case: dict, dev) -> list[list[torch.Tensor]]:
    """The speculative path's coefficients of each of the case's files,
    plane by plane, from the launches of the case's main path (one per
    file for the restart case; else one combined launch for all its
    files), run again."""
    files = case["files"]
    if case["call"] == "restart":  # each restart segment a chain
        out = []
        for f in files:
            got = pspec._spec_lanes(restart_lanes(f, dev))
            if got is None:
                raise AssertionError(f"{case['label']}: no fixpoint")
            info = pspec._restart_spec(f)["info"]
            em = torch.cat(got).reshape(info["mcus"], info["period"], 64)
            out.append([p for p in pdec._em_to_planes(
                em, info["samp"], info["mx"], info["my"]) if p is not None])
        return out
    got = pspec._spec_lanes(spec_lanes(files, dev))
    if got is None:
        raise AssertionError(f"{case['label']}: no fixpoint")
    out, off = [], 0
    for f in files:
        p = pspec._parse_spec(f)
        n = len(p["scan_list"])
        out.append([t for t in pspec._planes_spec(p, got[off:off + n])[1:4]
                    if t is not None])
        off += n
    return out


def golden_agreement(got: torch.Tensor, gold: np.ndarray, what: str,
                     known) -> str:
    """``rgb_agreement`` against the golden decoder; on a frame of
    ``REFERENCE_GOLDEN_MISSES`` (``known``: its reading, else None), where
    jpeg_tpu's own decode misses that bound, the card is held to that
    reading instead."""
    try:
        return rgb_agreement(got, gold, what)
    except AssertionError:
        if known is None:
            raise
    diff = np.abs(got.cpu().numpy().astype(np.int32) - gold.astype(np.int32))
    share = float(np.mean(diff <= 1))
    if diff.max() > known[0] or share < known[1]:
        raise AssertionError(f"{what}: max |diff| {diff.max()}, share within "
                             f"1 {share:.6f}; jpeg_tpu's decode of this "
                             f"frame: {known[0]}, {known[1]:.6f}")
    return (f"max |diff| {diff.max()}, within 1 {share:.6f} (a frame where "
            f"jpeg_tpu's decode misses the bound too: max |diff| {known[0]}, "
            f"within 1 {known[1]:.6f})")


def check_spec_case(case: dict, imgs: list[torch.Tensor], dev,
                    misses: dict) -> str:
    """The speculative path's coefficients, from the case's own launch
    layout, against the native decoder's (exact), the pixels against the
    CPU path's and the golden decoder's (jpeg_tpu's bound, or its reading
    on a frame of ``misses``) and, where there are originals, PSNR."""
    parts = []
    for i, (f, img, planes) in enumerate(zip(case["files"], imgs,
                                             case_planes(case, dev))):
        comps, coeffs, *_ = golden.parse_coefficients(f)
        for got, comp in zip(planes, comps):
            err = max_abs_err((got.cpu(),),
                              (torch.from_numpy(coeffs[comp.comp_id]),))
            if err:
                raise AssertionError(f"{case['label']}: image {i}: the "
                                     f"speculative zz and the native "
                                     f"decoder's differ, max_abs_err {err}")
        cpu = decode_jpeg(f, "host", device="cpu").numpy()
        what = f"{case['label']} image {i}"
        parts.append(f"image {i}: vs the CPU path "
                     + rgb_agreement(img, cpu, what)
                     + "; vs the golden decoder "
                     + golden_agreement(img, golden.decode(f), what,
                                        misses.get((case["label"], i))))
        if case["originals"] is not None:
            quality_db = golden.psnr(case["originals"][i], img.cpu().numpy())
            if not quality_db > MIN_PSNR_DB:
                raise AssertionError(f"{what}: PSNR {quality_db:.2f} dB <= "
                                     f"{MIN_PSNR_DB}")
            parts[-1] += f"; PSNR {quality_db:.2f} dB"
    return (f"zz of {len(case['files'])} image(s) equal to the native "
            f"decoder's (max_abs_err 0); " + " | ".join(parts[:2])
            + (f" | ... ({len(parts)} images)" if len(parts) > 2 else ""))


def spec_lanes(files: list[bytes], dev) -> "pspec.SpecLanes":
    """The lanes of one combined launch of ``decode_jpeg`` (one file) or
    ``decode_jpeg_batch`` (several of one sampling) on non-restart files."""
    ps = [pspec._parse_spec(f) for f in files]
    return pspec.scan_lanes([sc for p in ps for sc in p["scan_list"]], dev,
                            sampling=ps[0]["sampling"])


def spec_bound(lanes: "pspec.SpecLanes", out_bytes: int) -> float:
    """bound_ms of kernel H or G on these lanes (``huff_bound``): the
    chains' un-stuffed bytes, a table set per chain, three int32 inputs
    per lane (entry, phase, and the limit or the block count) and
    ``out_bytes``."""
    return huff_bound(int(lanes.limit_bits.sum()) // 8, len(lanes.need),
                      3 * len(lanes.starts), out_bytes)


def spec_kernel_phase(scan_file: bytes, il_file: bytes, dev):
    """Phase 3f (1): kernel H against its twin on every lane of the 3-scan
    file at the round-1 guesses and at the fixpoint, clean and corrupted;
    G's speculative mode against its twin on the DRI-less 4:2:0 file's
    payload at its fixpoint.  Returns (H's err, G's err, H's call and twin
    at the fixpoint, G's call and twin, H's bound, G's bound, labels)."""
    lanes = spec_lanes([scan_file], dev)
    S = lanes.streams.shape[0]
    cap = pspec.first_cap(lanes)
    fx = pspec.fixpoint(lanes)
    if fx is None:
        raise AssertionError("3-scan file: no fixpoint")
    corrupt = lanes.streams.clone()
    corrupt[1, 5] ^= 1 << 11  # a flipped bit: lane 1 loses sync
    corrupt[2, 8:10] = -1     # 64 one-bits: no code matches (length 17)
    h_err = 0
    calls = {}
    for label, streams, entries, phases in (
            ("round 1, clean", lanes.streams, np.zeros(S, np.int64),
             lanes.prior),
            ("round 1, corrupted", corrupt, np.zeros(S, np.int64),
             lanes.prior),
            ("fixpoint, clean", lanes.streams, fx[0], fx[1]),
            ("fixpoint, corrupted", corrupt, fx[0], fx[1])):
        ep = pspec._put(dev, entries, phases)
        args = (streams, *lanes.tables, ep[0:1], lanes.limits, cap,
                lanes.max_words, lanes.sampling, ep[1:2])
        got = khd.scan_positions(*args)
        want = khd.scan_positions_plain(*args)
        err = max_abs_err(tuple(g.cpu() for g in got),
                          tuple(w.cpu() for w in want))
        h_err = max(h_err, err)
        print(f"kernel scan_positions ({label}: all {S} lanes of the 3-scan "
              f"file, cap {cap}): 3 x {S} int32: "
              f"max_abs_err {err} (tolerance: exact); lanes bad "
              f"{int(got[2].sum())}, blocks {int(got[1].sum())}")
        if err:
            raise AssertionError(f"kernel scan_positions disagrees with its "
                                 f"plain twin: max_abs_err {err}")
        if label == "fixpoint, clean":
            calls["H"] = (lambda a=args: khd.scan_positions(*a),
                          lambda a=args: khd.scan_positions_plain(*a))
    il = spec_lanes([il_file], dev)
    gfx = pspec.fixpoint(il)
    if gfx is None:
        raise AssertionError("DRI-less 4:2:0 file: no fixpoint")
    h_err = max(h_err, scan_extra_checks(
        lanes, fx, il, dev, np.random.default_rng(SPEC_RNG_OFFSET + 100)))
    gargs, gkw = pspec.payload_inputs(il, *gfx)
    got = khd.decode_segments(*gargs, **gkw)
    want = khd.decode_segments_plain(*gargs, **gkw)
    g_err = max_abs_err((got.cpu(),), (want.cpu(),))
    print(f"kernel decode_segments speculative (the fixpoint's payload of "
          f"the DRI-less 4:2:0 file: {il.streams.shape[0]} lanes x "
          f"{gargs[6]} blocks, entry and phase): {tuple(got.shape)} "
          f"{got.dtype}: max_abs_err {g_err} (tolerance: exact)")
    if g_err:
        raise AssertionError(f"kernel decode_segments (speculative) "
                             f"disagrees with its plain twin: max_abs_err "
                             f"{g_err}")
    g_err = max(g_err, spec_g_random(il, np.random.default_rng(
        SPEC_RNG_OFFSET + 101)))
    calls["G"] = (lambda: khd.decode_segments(*gargs, **gkw),
                  lambda: khd.decode_segments_plain(*gargs, **gkw))
    bounds_ = {"scan_positions": (spec_bound(lanes, 3 * S * 4), "bytes"),
               "decode_segments speculative": (spec_bound(
                   il, sum(il.need) * 64 * 4), "bytes")}
    shapes = {"scan_positions": f"{S} lanes x cap {cap} of the 3-scan "
                                f"{SPEC_SCAN[1][1]}x{SPEC_SCAN[1][0]} file",
              "decode_segments speculative":
                  f"{il.streams.shape[0]} lanes x {gargs[6]} blocks of the "
                  f"DRI-less 4:2:0 {SPEC_INTERLEAVED[0][2]}x"
                  f"{SPEC_INTERLEAVED[0][1]} file"}
    return h_err, g_err, calls, bounds_, shapes


def spec_g_random(il: "pspec.SpecLanes", rng: np.random.Generator) -> int:
    """Kernel G's speculative mode against its twin on 512 random (entry,
    phase) pairs over the DRI-less 4:2:0 file's lanes (entries anywhere up
    to 64 bits past the limit, up to 256 blocks a lane), on the file's
    tables and on tables off the lookahead step.  Returns the max |error|."""
    n, nseg = 512, 256
    pick = rng.integers(0, il.streams.shape[0], n)
    idx = torch.from_numpy(pick).to(il.streams.device)
    entries, phases, nblk = pspec._put(
        il.streams.device, rng.integers(0, il.limit_bits[pick] + 64),
        rng.integers(0, 12, n), rng.integers(0, nseg + 1, n))
    maxc, delt, hvp = (il.tables[0][:, idx].contiguous(),
                       il.tables[1][:, idx].contiguous(),
                       il.tables[2][idx].contiguous())
    streams = il.streams[idx].contiguous()
    err = 0
    for label, mc in (("", maxc), (", tables off the lookahead step",
                                   off_step(maxc))):
        args = (streams, mc, delt, hvp, nblk[None], il.sampling, nseg,
                il.max_words)
        kw = dict(entry=entries[None], phase=phases[None], phased=True)
        got = khd.decode_segments(*args, **kw)
        want = khd.decode_segments_plain(*args, **kw)
        e = max_abs_err((got.cpu(),), (want.cpu(),))
        err = max(err, e)
        print(f"kernel decode_segments speculative (512 random (entry, "
              f"phase) over the DRI-less 4:2:0 lanes{label}): "
              f"{tuple(got.shape)} {got.dtype}: max_abs_err {e} (tolerance: "
              f"exact); nonzero {int((want != 0).sum())}")
        if e:
            raise AssertionError(f"kernel decode_segments (speculative) "
                                 f"disagrees with its plain twin{label}: "
                                 f"max_abs_err {e}")
    return err


# kernel C's shapes beyond the main paths': (label, S, nblk); its tile is
# 4096 blocks, so nblk of tile - 1, tile and tile + 1, and the one-segment
# scans of 4x1920x1280 (57600 blocks) and a 3-scan Y scan (38400)
OFFSETS_MAIN = [("16x640x640", 16, 9600), ("4x1920x1280", 4, 57600),
                ("3-scan 1920x1280 Y scan", 1, 38400)]
OFFSETS_EDGES = [("nblk 1", 3, 1), ("tile - 1", 2, 4095), ("tile", 2, 4096),
                 ("tile + 1", 2, 4097), ("S 1, 57600", 1, 57600),
                 ("S 1, 38400", 1, 38400), ("S 640", 640, 240)]
OFFSETS_REPEATS = 200  # back-to-back launches a shape: a fence or race fault


def offsets_checks(dev, rng: np.random.Generator) -> int:
    """Kernel C against its twin at the main paths' shapes and the edges,
    on random counts up to 1728 bits a block, each launched
    ``OFFSETS_REPEATS`` times back to back before one sync; every
    launch's outputs must equal the twin's.  Returns the max |error|."""
    err = 0
    for label, S, nblk in OFFSETS_MAIN + OFFSETS_EDGES:
        bits = torch.from_numpy(
            rng.integers(0, 1729, (S, nblk)).astype(np.int32)).to(dev)
        want = fused.segment_offsets_plain(bits)
        runs = [fused.segment_offsets(bits) for _ in range(OFFSETS_REPEATS)]
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want) for got in runs)
        err = max(err, e)
        print(f"kernel segment_offsets ({label}: [{S}, {nblk}], "
              f"{OFFSETS_REPEATS} launches back to back): max_abs_err {e} "
              f"(tolerance: exact)")
        if e:
            raise AssertionError(f"kernel segment_offsets disagrees with its "
                                 f"plain twin at {label}: max_abs_err {e}")
    return err


def offsets_timings(dev, rng: np.random.Generator, card: str,
                    runs: int) -> None:
    """Kernel C at the main paths' three shapes: its event ms in turns with
    its twin and ``torch.cumsum``, and its device µs by torch.profiler."""
    for label, S, nblk in OFFSETS_MAIN:
        bits = torch.from_numpy(
            rng.integers(0, 1729, (S, nblk)).astype(np.int32)).to(dev)

        def kernel():
            return fused.segment_offsets(bits)

        def plain():
            return fused.segment_offsets_plain(bits)

        def cumsum():
            return torch.cumsum(bits, dim=-1)
        p0, c0, k0, k1, c1, p1 = (cuda_ms(f, runs) for f in (
            plain, cumsum, kernel, kernel, cumsum, plain))
        print(f"timing kernel segment_offsets (C) at {label} [{S}, {nblk}] "
              f"on [{card}]: {(k0 + k1) / 2:.4f} ms ({k0:.4f}, {k1:.4f}), "
              f"torch.cumsum {(c0 + c1) / 2:.4f} ms ({c0:.4f}, {c1:.4f}), "
              f"plain twin {(p0 + p1) / 2:.4f} ms ({p0:.4f}, {p1:.4f}); "
              f"{device_text(device_us(kernel, runs))}")
        if label == OFFSETS_MAIN[0][0]:
            offsets_host_costs(bits, card)


def host_us(fn, n: int = 2000, reps: int = 5) -> float:
    """Host µs per call of ``fn``: the median over ``reps`` loops of ``n``
    calls, each loop ended by one sync (the host's cost wherever the
    device's work per call is the shorter)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def offsets_host_costs(bits: torch.Tensor, card: str) -> None:
    """The host's cost of kernel C's wrapper beside ``torch.cumsum``'s on
    the same input, and of the wrapper's parts: its check, its outputs
    (one buffer and two views of it; for comparison, two allocations),
    its workspace lookup and the launch itself."""
    from jpeg_tpu_torch import kernels
    S, nblk = bits.shape
    dev = bits.device
    offs, totals = fused.segment_offsets(bits)
    work = fused._offsets_workspace(dev, fused._offsets_words(S, nblk))
    one = torch.empty(S * nblk + S, dtype=torch.int32, device=dev)
    parts = {
        "the wrapper": lambda: fused.segment_offsets(bits),
        "torch.cumsum": lambda: torch.cumsum(bits, dim=-1),
        "check_tensor": lambda: kernels.check_tensor(
            "bits", bits, torch.int32, (S, nblk)),
        "its buffer (one new_empty)": lambda: bits.new_empty(S * nblk + S),
        "its two as_strided views": lambda: (
            one.as_strided((S, nblk), (nblk, 1)),
            one.as_strided((S,), (1,), S * nblk)),
        "two torch.empty instead": lambda: (
            torch.empty((S, nblk), dtype=torch.int32, device=dev),
            torch.empty(S, dtype=torch.int32, device=dev)),
        "workspace lookup": lambda: fused._offsets_workspace(
            dev, fused._offsets_words(S, nblk)),
        "launch (ctypes and the CUDA launch)": lambda: kernels.launch(
            "segment_offsets", dev, bits.data_ptr(), offs.data_ptr(),
            totals.data_ptr(), work, S, nblk),
    }
    print(f"host µs per call at [{S}, {nblk}] on [{card}] (loops of 2000 "
          f"calls, one sync each, median of 5): " + ", ".join(
              f"{k} {host_us(f):.2f}" for k, f in parts.items()))


# row sizes (words) that put kernels G and H in each of their shared-memory
# layouts (csrc/huffdec.cu, lane_layout: a lane's tables, G's block
# buffer and the staged row, at most four lanes and 200 KB a CTA): (words,
# (lanes a CTA, rows staged), what that is); the source is asked for each
LANE_LAYOUTS = [(8000, (4, True), "four staged lanes a CTA, past the 48 KiB "
                                  "default"),
                (20000, (2, True), "two staged lanes a CTA"),
                (40000, (1, True), "one staged lane a CTA"),
                (60000, (4, False), "rows left in global memory")]


def check_layout(kernel: str, words: int, want: tuple) -> None:
    """Raise unless the source lays out rows of ``words`` words as
    ``want`` (lanes a CTA, staged) for ``kernel``."""
    got = khd.lane_layout(kernel, words)
    if got != want:
        raise AssertionError(f"{kernel}: rows of {words} words take the "
                             f"layout {got}, not {want}")


def random_rows(streams: torch.Tensor, rng: np.random.Generator):
    """Uniform-random bits in the shape of ``streams``: codes longer than 9
    bits, codes that match nothing, runs past slot 63."""
    return torch.from_numpy(rng.integers(-2**31, 2**31, tuple(
        streams.shape), dtype=np.int64).astype(np.int32)).to(streams.device)


def off_step(maxc: torch.Tensor) -> torch.Tensor:
    """``maxc`` with every bound of the luma AC and chroma DC rows raised
    by one: still increasing, but no bound of a length up to 9 a multiple
    of its step, so those rows take no lookahead table (every code is
    searched)."""
    out = maxc.clone()
    out[16:48] += 1
    return out


def scan_extra_checks(scan: "pspec.SpecLanes", scan_fx, il: "pspec.SpecLanes",
                      dev, rng: np.random.Generator) -> int:
    """Kernel H against its twin beyond phase 3f's lanes: 512 random (entry,
    phase) pairs over the DRI-less 4:2:0 file's lanes (entries anywhere up
    to 64 bits past the limit: inside codes, past the limit); a cap of 64
    at the 3-scan fixpoint (every long lane stops at the cap); lanes
    shorter than 32 blocks (the limit 40-200 bits past the fixpoint's
    entry); the fixpoint with each row padded to ``LANE_LAYOUTS``' sizes,
    one for each of H's shared-memory layouts; random bits on tables off
    the lookahead step.  Returns the max |error|."""
    n = 512
    pick = torch.from_numpy(rng.integers(0, il.streams.shape[0], n)).to(dev)
    lim = il.limits[:, pick].contiguous()
    entries = torch.from_numpy(rng.integers(
        0, il.limit_bits[pick.cpu().numpy()] + 64).astype(np.int32)).to(dev)
    phases = torch.from_numpy(rng.integers(0, 12, n).astype(np.int32)).to(dev)
    maxc, delt, hvp = il.tables
    S = scan.streams.shape[0]
    ep = pspec._put(dev, scan_fx[0], scan_fx[1])
    short = pspec._put(dev, scan_fx[0] + rng.integers(40, 201, S))
    cases = [
        ("512 random (entry, phase) over the DRI-less 4:2:0 lanes",
         (il.streams[pick].contiguous(), maxc[:, pick].contiguous(),
          delt[:, pick].contiguous(), hvp[pick].contiguous(),
          entries[None], lim, pspec.first_cap(il), il.max_words,
          il.sampling, phases[None])),
        ("cap 64 at the 3-scan fixpoint",
         (scan.streams, *scan.tables, ep[0:1], scan.limits, 64,
          scan.max_words, scan.sampling, ep[1:2])),
        ("lanes shorter than 32 blocks",
         (scan.streams, *scan.tables, ep[0:1], short, pspec.first_cap(scan),
          scan.max_words, scan.sampling, ep[1:2])),
    ]
    for words, layout, what in LANE_LAYOUTS:
        check_layout("scan_positions", words, layout)
        cases.append((f"rows of {words} words: {what}", (
            torch.nn.functional.pad(scan.streams, (0, words - scan.max_words)),
            *scan.tables, ep[0:1], scan.limits, pspec.first_cap(scan), words,
            scan.sampling, ep[1:2])))
    cases.append(("random bits, tables off the lookahead step, 512 random "
                  "(entry, phase)", (
                      random_rows(cases[0][1][0], rng),
                      off_step(cases[0][1][1]), *cases[0][1][2:])))
    err = 0
    for label, args in cases:
        got = khd.scan_positions(*args)
        want = khd.scan_positions_plain(*args)
        e = max_abs_err(tuple(g.cpu() for g in got),
                        tuple(w.cpu() for w in want))
        err = max(err, e)
        print(f"kernel scan_positions ({label}): 3 x {got[0].shape[0]} "
              f"int32: max_abs_err {e} (tolerance: exact); lanes bad "
              f"{int(got[2].sum())}, capped {int((got[1] >= args[6]).sum())}"
              f", blocks {int(got[1].sum())}")
        if e:
            raise AssertionError(f"kernel scan_positions disagrees with its "
                                 f"plain twin ({label}): max_abs_err {e}")
    return err


def spec_decisions(data: bytes, dev) -> list[str]:
    """Corrupted copies of a 3-scan file (a run of one-bits a quarter into
    its Y scan; one flipped bit in its middle): the fixpoint's decision
    on the card must equal the CPU path's, and an accepted decode its
    coefficients."""
    p = pspec._parse_spec(data)
    ent = p["scan_list"][0][0]
    start = data.index(ent)
    cut = start + len(ent) // 4
    cut += data[cut - 1] == 0xFF
    mid = bytearray(data)
    pos = start + len(ent) // 2
    mid[pos] ^= 0x10 if mid[pos] != 0xEF else 0x01
    out = []
    for label, bad in (("a run of 48 one-bits",
                        data[:cut] + b"\xff\x00" * 6 + data[cut:]),
                       ("one flipped bit", bytes(mid))):
        q = pspec._parse_spec(bad)
        card = pspec._spec_scans(q["scan_list"], device=dev)
        cpu = pspec._spec_scans(q["scan_list"], device="cpu")
        if (card is None) != (cpu is None):
            raise AssertionError(f"corrupted copy ({label}): the card's "
                                 f"decision differs from the CPU path's")
        if card is not None:
            for a, b in zip(card, cpu):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"corrupted copy ({label}): "
                                         f"accepted, zz differ")
        what = ("host route (no fixpoint)" if card is None
                else "accepted, zz equal")
        out.append(f"{label}: {what} on the card and the CPU")
    return out


def case_lanes(case: dict, dev) -> str:
    """The lanes of the case's launches (one combined launch per call of
    decode_jpeg or decode_jpeg_batch; one per file for the restart case):
    their count and the average blocks a lane."""
    layouts = ([restart_lanes(f, dev) for f in case["files"]]
               if case["call"] == "restart" else [spec_lanes(case["files"],
                                                             dev)])
    return " + ".join(f"{len(ln.starts)} lanes, "
                      f"{sum(ln.need) // len(ln.starts)} blocks a lane on "
                      f"average" for ln in layouts)


def spec_phase(scases: list[dict], dev, launches: dict, misses: dict):
    """Phase 3f (2): each case through "device" with the launch counts
    reset just before it (added to ``launches``, kernel G's under its
    speculative row), checked by ``check_spec_case``, then again under
    "auto" with warnings as errors.  Returns [(label, zero-argument call,
    H launches per call)]."""
    import warnings
    runs = []
    for case in scases:
        torch.cuda.synchronize()
        reset_launch_counts()
        imgs = spec_call(case, "device", dev)
        counts = launch_counts()
        print(f"main path {case['label']}: launches {json.dumps(counts)}; "
              f"rounds (H launches) {counts['scan_positions']}; "
              f"{case_lanes(case, dev)}")
        for name in case["kernels"]:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"path {case['label']}")
        for name, n in counts.items():
            launches["decode_segments speculative" if name == "decode_segments"
                     else name] += n
        print("  " + check_spec_case(case, imgs, dev, misses))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            again = spec_call(case, "auto", dev)
        if not all(torch.equal(a, b) for a, b in zip(again, imgs)):
            raise AssertionError(f"{case['label']}: \"auto\" and \"device\" "
                                 f"differ")
        runs.append((case["label"],
                     lambda c=case: spec_call(c, "device", dev),
                     counts["scan_positions"]))
    return runs


def spec_timings(spec_runs, scases, spec_calls, spec_bounds, spec_shapes,
                 card: str, runs: int, decode_n: int, dev, times: dict,
                 bound: dict) -> None:
    """Phase 4 of the speculative decode: each case's call, device time, H's
    time per round x rounds, G's payload, idle share and the host entropy
    route on the same files; speculative_decode_restart beside kernel G's
    route; then H and G's speculative mode alone, in turns with their twins
    (filling ``times`` and ``bound``)."""
    t_spec = time.perf_counter()
    for label, fn, rounds in spec_runs:
        call_ms = host_ms(fn, decode_n)
        per_call, idle = device_profile(fn, decode_n)
        h_us = sum(v for k, v in per_call.items() if "scan_positions" in k)
        g_us = sum(v for k, v in per_call.items() if "decode_segments" in k)
        case = next(c for c in scases if c["label"] == label)
        host_route = host_ms(lambda: [golden.parse_coefficients(f)
                                      for f in case["files"]], decode_n)
        print(f"timing {label} on [{card}]: {call_ms:.4f} ms per call; "
              f"median of {decode_n}; host entropy route on the same files "
              f"(golden.parse_coefficients) {host_route:.4f} ms")
        print(f"  device µs per call (torch.profiler, {decode_n} calls): "
              f"total {sum(per_call.values()):.2f}, kernel H "
              f"{h_us:.2f} = {h_us / max(rounds, 1):.2f} per round x "
              f"{rounds} rounds, kernel G payload {g_us:.2f}; device idle "
              f"share {idle:.4f}; by name: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      per_call.items(), key=lambda kv: -kv[1])[:8]))
        if case["call"] == "restart":
            def g_route(files=case["files"]):
                out = [decode_jpeg(f, "device", device=dev) for f in files]
                torch.cuda.synchronize()
                return out
            g_ms = host_ms(g_route, decode_n)
            g_call, g_idle = device_profile(g_route, decode_n)
            g_only = sum(v for k, v in g_call.items()
                         if "decode_segments" in k)
            print(f"  kernel G's route (decode_jpeg, one lane a segment) on "
                  f"the same files: {g_ms:.4f} ms per call; device µs "
                  f"{sum(g_call.values()):.2f}, kernel G {g_only:.2f}; "
                  f"device idle share {g_idle:.4f}")
    for name, key in (("scan_positions", "H"),
                      ("decode_segments speculative", "G")):
        kernel, twin = spec_calls[key]
        p0, k0, k1, p1 = (cuda_ms(twin, 1, 1, 0), cuda_ms(kernel, runs),
                          cuda_ms(kernel, runs), cuda_ms(twin, 1, 1, 0))
        dus = device_us(kernel, runs)
        times[name] = ((k0 + k1) / 2, (p0 + p1) / 2, None, dus[0])
        bound[name] = spec_bounds[name]
        print(f"timing kernel {name} at {spec_shapes[name]} on [{card}]: "
              f"{times[name][0]:.4f} ms ({k0:.4f}, {k1:.4f}), "
              f"{device_text(dus)}, bound "
              f"{bound[name][0]:.5f} ms (bytes); plain twin on the same "
              f"inputs {times[name][1]:.4f} ms ({p0:.4f}, {p1:.4f}); median "
              f"of {runs} (twin: one call each)")
    print(f"the speculative decode timings took "
          f"{time.perf_counter() - t_spec:.1f} s")


def random_coefs(rng: np.random.Generator, S: int,
                 nblk: int) -> np.ndarray:
    """[S, nblk, 64] int16 zig-zag coefficients reaching every branch of
    the symbolizer: blocks all zero, sparse (zero runs past 16: ZRLs),
    dense (a nonzero slot 63: no EOB), DCs over their whole range."""
    density = rng.choice([0.0, 0.03, 0.3, 1.0], size=(S, nblk, 1))
    ac = rng.integers(-2047, 2048, (S, nblk, 64))
    zz = np.where(rng.random((S, nblk, 64)) < density, ac, 0)
    zz[..., 0] = rng.integers(-2048, 2048, (S, nblk))
    return zz.astype(np.int16)


# E's block patterns on random coefficients: (layout, blocks per segment),
# segments not whole groups of four blocks where the pattern allows; each
# of FIELDS_IMAGES images is FIELDS_SEGS segments
FIELDS_LAYOUTS = [(LAYOUTS["420"], 66), (LAYOUTS["422"], 68),
                  (LAYOUTS["444"], 69), (SCAN_Y, 77), (SCAN_CHROMA, 77)]
FIELDS_IMAGES, FIELDS_SEGS = 2, 3


def fields_cases(dev, rng: np.random.Generator,
                 layouts=FIELDS_LAYOUTS) -> list:
    """Kernel E's checks on random coefficients in every block pattern of
    ``layouts``, without and with the mask, fresh and accumulating into
    random rows: (label, kernel, plain)."""
    out = []
    n, segs = FIELDS_IMAGES, FIELDS_SEGS
    for layout, nblk in layouts:
        coef = torch.from_numpy(random_coefs(rng, n * segs, nblk)).to(dev)
        mask = torch.from_numpy(
            (rng.random(segs * nblk) < 0.5).astype(np.uint8)).to(dev)
        rows = torch.from_numpy(
            rng.integers(0, 1000, (n, 1024)).astype(np.int32)).to(dev)
        for m in (None, mask):
            for h in (None, rows):
                def run(fn, c=coef, m=m, h=h, layout=layout):
                    return lambda: fn(c, n, m, layout,
                                      None if h is None else h.clone())
                out.append((
                    f"random coefficients, layout {tuple(layout)}, {segs} "
                    f"segments of {nblk} blocks an image"
                    + (", mask" if m is not None else "")
                    + (", accumulating" if h is not None else ""),
                    run(fused.symbolize_fields),
                    run(fused.symbolize_fields_plain)))
    return out


# kernels B's and F's edge cases on random coefficients: (layout, blocks
# per segment, segments): every block pattern, nblk = 0, 1, 2 and 3 (mod
# 4), so that groups of four blocks straddle segments, and a single block
BITS_CASES = [(LAYOUTS["420"], 66, 6), (LAYOUTS["422"], 68, 6),
              (LAYOUTS["444"], 69, 6), (SCAN_Y, 77, 6), (SCAN_CHROMA, 79, 6),
              (LAYOUTS["444"], 75, 4), (SCAN_Y, 1, 1)]


def edge_coefs(rng: np.random.Generator, S: int, nblk: int) -> np.ndarray:
    """``random_coefs`` with the extremes planted: a block whose one AC is
    2047 at slot 63 (three ZRLs, then a run of 15, and no EOB), one with
    -2047 at slot 1 and 2047 at slot 62, and DCs alternating +-2047
    through the last segment (DC differences of +-4094: class 12)."""
    zz = random_coefs(rng, S, nblk)
    zz[0, 0, 1:] = 0
    zz[0, 0, 63] = 2047
    zz[-1, -1, 1:] = 0
    zz[-1, -1, 1], zz[-1, -1, 62] = -2047, 2047
    zz[-1, :, 0] = 2047 * (1 - 2 * (np.arange(nblk) % 2))
    return zz


def bits_cases(dev, rng: np.random.Generator, lut: torch.Tensor,
               cases=BITS_CASES) -> dict[str, list]:
    """Kernels B, F and B explicit against their twins under the fields
    contract (``fields_checked``, out of pre-filled buffers) on
    ``edge_coefs`` in every case of ``cases`` (F on E's fields of them,
    two images where the segments split evenly) and on explicit inputs
    with padding blocks, with ``lut`` and with a random LUT whose NULL
    entry is not empty: kernel -> [(label, kernel, plain)]."""
    rlut = random_lut(rng, dev)
    tables = (("its LUT", lut), ("a random LUT", rlut))
    out = {"symbolize_bits": [], "attach_pf": [],
           "symbolize_bits_explicit": []}
    for layout, nblk, S in cases:
        coef = torch.from_numpy(edge_coefs(rng, S, nblk)).to(dev)
        at = (f"edge coefficients, layout {tuple(layout)}, {S} segments of "
              f"{nblk} blocks")
        for name, t in tables:
            out["symbolize_bits"].append((
                f"{at}, {name}",
                functools.partial(fields_checked, fused.symbolize_bits, coef,
                                  t, layout),
                functools.partial(fields_plain, fused.symbolize_bits_plain,
                                  coef, t, layout)))
        n = 2 if S % 2 == 0 else 1
        pf = fused.symbolize_fields_plain(coef, n, layout=layout)[0]
        luts = torch.stack([rlut, lut][:n])
        out["attach_pf"].append((
            f"{at}, {n} images (a random LUT, then its LUT)",
            functools.partial(fields_checked, fused.attach_pf, pf, luts),
            functools.partial(fields_plain, fused.attach_pf_plain, pf,
                              luts)))
    ex = explicit_random(rng, dev)
    for name, t in tables:
        out["symbolize_bits_explicit"].append((
            f"random coefficients, padding blocks, "
            f"{tuple(ex[0].shape[:2])}, {name}",
            functools.partial(fields_checked, fused.symbolize_bits_explicit,
                              *ex, t),
            functools.partial(fields_plain,
                              fused.symbolize_bits_explicit_plain, *ex, t)))
    return out


# the explicit-mode inputs of random_explicit: segments, blocks, images
EXPLICIT_SHAPE, EXPLICIT_IMAGES = (6, 300), 3


def explicit_random(rng: np.random.Generator, dev):
    """Random explicit-mode inputs (zz int16, dc_diff, is_luma int32) with
    padding blocks: two whole tiles of kernel D's 64 blocks inside every
    segment, each segment's last 50 blocks, and all of segment 1."""
    S, nblk = EXPLICIT_SHAPE
    zz = random_coefs(rng, S, nblk)
    dcd = rng.integers(-4095, 4096, (S, nblk)).astype(np.int32)
    dcd[0, :2] = [4095, -4095]
    isl = rng.integers(0, 2, (S, nblk)).astype(np.int32)
    isl[:, 64:192] = -1
    isl[:, -50:] = -1
    isl[1] = -1
    return tuple(torch.from_numpy(a).to(dev) for a in (zz, dcd, isl))


def place_cases(fields, fields_r, gray_coef, lut, explicit,
                rng: np.random.Generator) -> list:
    """Kernel D's edge shapes: (label, (value, nbits, offs, totals,
    seg_words))."""
    cases = []

    def case(label, value, nbits, bits):
        offs, totals = fused.segment_offsets_plain(bits)
        seg_words = kpack.rows_per_segment(value.shape[1] * 64) * 128
        cases.append((label, (value, nbits, offs, totals, seg_words)))

    case("3-scan Y, 8 restart segments of 4080 blocks (1920x1088 r17)",
         *fields_r)
    case("one segment of 38400 blocks (a 1920x1280 Y scan)",
         *fused.symbolize_bits_plain(gray_coef, lut, SCAN_Y))
    n1 = 4096
    case(f"{n1} segments of one block",
         fields[0].reshape(-1, 1, 64)[:n1], fields[1].reshape(-1, 1, 64)[:n1],
         fields[2].reshape(-1, 1)[:n1])
    case(f"explicit padding blocks (no bits): {tuple(explicit[0].shape[:2])}",
         *fused.symbolize_bits_explicit_plain(*explicit, lut))
    S, nblk = 3, 500
    nb = rng.integers(0, 31, (S, nblk, 64))
    nb[rng.random((S, nblk, 64)) < 0.5] = 0
    val = rng.integers(0, 1 << 30, (S, nblk, 64)) & ((1 << nb) - 1)
    # the same, with the last two slots making every stream whole words
    nb2, val2 = nb.copy(), val.copy()
    nb2[:, -1, 62:] = 0
    pad = -nb2.sum(axis=(1, 2)) % 32
    nb2[:, -1, 62], nb2[:, -1, 63] = pad // 2, pad - pad // 2
    val2[:, -1, 62:] = (rng.integers(0, 1 << 16, (S, 2))
                        & ((1 << nb2[:, -1, 62:]) - 1))
    assert not (nb2.sum(axis=(1, 2)) % 32).any()
    dev = fields[0].device
    for label, n, v in (("random fields of 0-30 bits", nb, val),
                        ("random fields, streams ending on a word boundary",
                         nb2, val2)):
        nbits = torch.from_numpy(n.astype(np.uint8)).to(dev)
        case(label, torch.from_numpy(v.astype(np.int32)).to(dev).view(
            torch.uint32), nbits, nbits.to(torch.int32).sum(
                -1, dtype=torch.int32))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=20)
    # one rank of phase 3j's split (spawn_split starts them)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.rank is not None:
        return split_worker(args)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)

    # -- phase 1: the card and the builds ----------------------------------
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(cards)
    # the timing lines name the first card (one line per card above)
    card = cards.splitlines()[0]
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    set_exact_matmul()
    _build.entry("front_dct")
    print(f"build: {len(_build.SIGNATURES)} kernels from "
          f"{len(_build.SOURCES)} sources (nvcc, sm_90a, one process per "
          f"source) in {_build.build_seconds:.1f} s")
    native.load()
    print(f"build: native host library (g++) in "
          f"{native.build_seconds:.1f} s; host CPUs: "
          f"{len(os.sched_getaffinity(0))} usable of {os.cpu_count()}")

    # -- phase 2: every kernel against its plain twin ------------------------
    B, H, W, _ = GEOMETRIES[0]
    enc = FastBatchEncoder(H, W, config("fixed"), device=dev)
    mask = FastBatchEncoder(H, W, config("dynamic-sampled"), device=dev)._mask
    x = torch.from_numpy(synthetic_batch(rng, B, H, W)).to(dev)
    x = x.reshape(B, H, W * 3)
    consts = (enc._m, enc._bias, enc._ql, enc._qc)
    seg_words = enc.seg_rows * 128
    nblk = enc.blocks_per_seg
    coef = front.front_dct_plain(x, *consts).view(B, nblk, 64)
    fields = fused.symbolize_bits_plain(coef, enc._lut)
    offs = fused.segment_offsets_plain(fields[2])
    pf = fused.symbolize_fields_plain(coef, B)[0]
    luts = {}
    for mode, m in (("dynamic", None), ("dynamic-sampled", mask)):
        h = fused.symbolize_fields_plain(coef, B, m)[1]
        luts[mode] = torch.from_numpy(FastBatchEncoder._build_tables_batch(
            h.cpu().numpy(), smooth=m is not None)[1]).to(dev)
    calls = {
        "front_dct": (lambda: front.front_dct(x, *consts),
                      lambda: front.front_dct_plain(x, *consts)),
        "symbolize_bits": (lambda: fused.symbolize_bits(coef, enc._lut),
                           lambda: fused.symbolize_bits_plain(coef,
                                                              enc._lut)),
        "segment_offsets": (lambda: fused.segment_offsets(fields[2]),
                            lambda: fused.segment_offsets_plain(fields[2])),
        "place": (lambda: fused.place(fields[0], fields[1], *offs,
                                      seg_words),
                  lambda: fused.place_plain(fields[0], fields[1], offs[0],
                                            seg_words)),
        "symbolize_fields": (lambda: fused.symbolize_fields(coef, B),
                             lambda: fused.symbolize_fields_plain(coef, B)),
        "attach_pf": (lambda: fused.attach_pf(pf, luts["dynamic"]),
                      lambda: fused.attach_pf_plain(pf, luts["dynamic"])),
    }
    # the other modes and layouts of the kernels, checked but not timed;
    # their inputs come from a second generator, so the main path's images
    # stay those of earlier runs
    rng2 = np.random.default_rng(args.seed + 1)
    coef_s = front.front_dct_plain(x, *consts, order="scan")
    n_y = B * 4 * (H // 16) * (W // 16)
    cy = coef_s[:n_y].view(B, n_y // B, 64)         # one Y scan per image
    cc = coef_s[n_y:].view(2 * B, n_y // B // 4, 64)  # its Cb, its Cr scan

    def scan_fields(symbolize):
        """E on the Y scans, then on the Cb + Cr scans into the same
        histogram rows: (pf_y, pf_c, hist)."""
        pf_y, hist = symbolize(cy, B, layout=SCAN_Y)
        pf_c, hist = symbolize(cc, B, layout=SCAN_CHROMA, hist=hist)
        return pf_y, pf_c, hist

    pf_c, hist3 = scan_fields(fused.symbolize_fields_plain)[1:]
    luts3 = torch.from_numpy(FastBatchEncoder._build_tables_batch(
        hist3.cpu().numpy())[1]).to(dev)
    plane = torch.from_numpy(np.ascontiguousarray(
        synthetic_batch(rng2, 1, 1280, 1920)[..., 1])).to(dev)
    # the 8 Y restart segments of a 1920x1088 image, restarts every 17 rows
    x_r = torch.from_numpy(synthetic_batch(rng2, 1, 1088, 1920)).to(dev)
    cy_r = front.front_dct_plain(x_r.reshape(1, 1088, 1920 * 3), *consts,
                                 order="scan")[:136 * 240].view(8, 4080, 64)
    fields_r = fused.symbolize_bits_plain(cy_r, enc._lut, SCAN_Y)
    offs_r = fused.segment_offsets_plain(fields_r[2])
    # random explicit-mode inputs with padding blocks, for D and E
    ex_rand = explicit_random(np.random.default_rng(args.seed + 11), dev)
    # B's, F's and B explicit's edge cases, from a generator of their own
    edge = bits_cases(dev, np.random.default_rng(args.seed + 12), enc._lut)
    more_checks = {
        "front_dct": [
            ("3-scan order", lambda: front.front_dct(x, *consts,
                                                     order="scan"),
             lambda: front.front_dct_plain(x, *consts, order="scan")),
            ("gray, 1x1280x1920", lambda: front.front_dct_gray(
                plane, *consts[:3]),
             lambda: front.front_dct_gray_plain(plane, *consts[:3]))],
        "symbolize_bits": [
            (f"3-scan Y, {tuple(cy.shape)}",
             lambda: fields_checked(fused.symbolize_bits, cy, enc._lut,
                                    SCAN_Y),
             lambda: fields_plain(fused.symbolize_bits_plain, cy, enc._lut,
                                  SCAN_Y)),
            (f"3-scan Cb + Cr, {tuple(cc.shape)}",
             lambda: fields_checked(fused.symbolize_bits, cc, enc._lut,
                                    SCAN_CHROMA),
             lambda: fields_plain(fused.symbolize_bits_plain, cc, enc._lut,
                                  SCAN_CHROMA)),
            *edge["symbolize_bits"]],
        "symbolize_fields": [
            ("mask on", lambda: fused.symbolize_fields(coef, B, mask),
             lambda: fused.symbolize_fields_plain(coef, B, mask)),
            ("3-scan Y, then Cb + Cr into the same histogram rows",
             lambda: scan_fields(fused.symbolize_fields),
             lambda: scan_fields(fused.symbolize_fields_plain)),
            *fields_cases(dev, np.random.default_rng(args.seed + 10))],
        "attach_pf": [
            ("dynamic-sampled LUTs",
             lambda: fields_checked(fused.attach_pf, pf,
                                    luts["dynamic-sampled"]),
             lambda: fields_plain(fused.attach_pf_plain, pf,
                                  luts["dynamic-sampled"])),
            ("3-scan Cb + Cr, per-image LUTs",
             lambda: fields_checked(fused.attach_pf, pf_c, luts3),
             lambda: fields_plain(fused.attach_pf_plain, pf_c, luts3)),
            *edge["attach_pf"]],
        "segment_offsets": [
            ("3-scan Y, 8 restart segments of 1920x1088",
             lambda: fused.segment_offsets(fields_r[2]),
             lambda: fused.segment_offsets_plain(fields_r[2]))],
        "place": [
            (label, lambda a=a: place_checked(*a),
             lambda a=a: place_plain_streams(*a))
            for label, a in place_cases(
                fields, fields_r, front.front_dct_gray_plain(
                    plane, *consts[:3]), enc._lut, ex_rand,
                np.random.default_rng(args.seed + 9))],
    }
    # D placing B's own fields, written into a pre-filled buffer: the
    # value groups B leaves alone hold all ones, and D must not read them
    more_checks["place"].append((
        "kernel B's fields out of a pre-filled buffer",
        lambda: place_checked(*fused.symbolize_bits(
            coef, enc._lut, out=prefilled_fields(B, nblk, dev))[:2], *offs,
            seg_words),
        lambda: place_plain_streams(fields[0], fields[1], *offs,
                                    seg_words)))
    # D's words are compared on the streams only, and D alone writes into
    # a pre-filled buffer (its contract: the words past a stream are not
    # written); B and F into pre-filled buffers, compared on the fields
    # their contract defines; the kernels' first checks, then the
    # functions ending in D
    check_calls = {
        "place": (
            lambda: place_checked(fields[0], fields[1], *offs, seg_words),
            lambda: place_plain_streams(fields[0], fields[1], *offs,
                                        seg_words)),
        "symbolize_bits": (
            lambda: fields_checked(fused.symbolize_bits, coef, enc._lut),
            lambda: fields_plain(fused.symbolize_bits_plain, coef,
                                 enc._lut)),
        "attach_pf": (
            lambda: fields_checked(fused.attach_pf, pf, luts["dynamic"]),
            lambda: fields_plain(fused.attach_pf_plain, pf,
                                 luts["dynamic"]))}
    # the f64 path's kernels at the shapes of a 4x1920x1280 batch: the
    # exact analysis (torch ops) gives zz, dc_diff and is_luma; the inputs
    # come from a third generator
    rng3 = np.random.default_rng(args.seed + 2)
    b4, h4, w4 = F64_GEOMETRIES[1]
    x4 = torch.from_numpy(synthetic_batch(rng3, b4, h4, w4)).to(dev)
    seq, dcd, isl = analyze_zz(x4, enc._luma_q, enc._chroma_q, w4 // 16,
                               h4 // 16, 1)
    del x4
    s4, nblk4 = seq.shape[0], seq.shape[1]
    seg_rows4 = kpack.rows_per_segment(nblk4 * 64)
    slots4 = fused.unpack_fields(
        fused.symbolize_segments_plain(seq, dcd, isl, s4, b4)[0])
    lut1 = enc._lut[None].contiguous()
    calls["symbolize_bits_explicit"] = (
        lambda: fused.symbolize_bits_explicit(seq, dcd, isl, enc._lut),
        lambda: fused.symbolize_bits_explicit_plain(seq, dcd, isl, enc._lut))
    calls["symbolize_fields_explicit"] = (
        lambda: fused.symbolize_segments(seq, dcd, isl, s4, b4),
        lambda: fused.symbolize_segments_plain(seq, dcd, isl, s4, b4))
    calls["attach_pack_segments"] = (
        lambda: fused.attach_pack_segments(enc._lut, *slots4, s4, seg_rows4),
        lambda: fused.pack_plain(*fused.attach_pf_plain(fused.pack_fields(
            *slots4), lut1), seg_rows4))
    k13 = (lambda: fused.analyze_attach_pack_segments(
               enc._lut, seq, dcd, isl, s4, seg_rows4),
           lambda: fused.pack_plain(*fused.symbolize_bits_explicit_plain(
               seq, dcd, isl, enc._lut), seg_rows4))
    check_calls["attach_pack_segments"] = tuple(
        map(on_streams, calls["attach_pack_segments"]))
    more_checks["symbolize_fields_explicit"] = [(
        f"random coefficients, padding blocks, "
        f"{tuple(ex_rand[0].shape[:2])}, {EXPLICIT_IMAGES} images",
        lambda: fused.symbolize_segments(*ex_rand, len(ex_rand[0]),
                                         EXPLICIT_IMAGES),
        lambda: fused.symbolize_segments_plain(*ex_rand, len(ex_rand[0]),
                                               EXPLICIT_IMAGES))]
    check_calls["symbolize_bits_explicit"] = (
        lambda: fields_checked(fused.symbolize_bits_explicit, seq, dcd, isl,
                               enc._lut),
        lambda: fields_plain(fused.symbolize_bits_explicit_plain, seq, dcd,
                             isl, enc._lut))
    more_checks["symbolize_bits_explicit"] = [
        ("with C and D: K13's analyze_attach_pack_segments",
         *map(on_streams, k13)), *edge["symbolize_bits_explicit"]]
    # A's 4:2:2 and 4:4:4 modes, its pixel-block mode, K7 and K18a at the
    # shapes of a 4x1920x1280 batch of each sampling (one segment per
    # image); the inputs come from a fourth generator
    rng4 = np.random.default_rng(args.seed + 3)
    b5, h5, w5 = SAMPLING_KERNEL_BATCH
    x5 = torch.from_numpy(synthetic_batch(rng4, b5, h5, w5)).to(dev)
    x5f = x5.view(b5, h5, w5 * 3)
    px5 = {sp: color.mcu_blocks(*color.rgb_to_ycbcr(x5, sp), sp)
           for sp in ("422", "444")}
    xt5 = {sp: px.reshape(-1, 64).T.contiguous() for sp, px in px5.items()}
    seg_rows5 = {sp: kpack.rows_per_segment(px.shape[1] * 64)
                 for sp, px in px5.items()}
    at_of = {}
    for sp in ("422", "444"):
        name = f"front_dct {LABEL[sp]}"
        at_of[name] = f"{b5}x{h5}x{w5} {LABEL[sp]}"
        calls[name] = (
            lambda sp=sp: front.front_dct(x5f, *consts, sampling=sp),
            lambda sp=sp: front.front_dct_plain(x5f, *consts, sampling=sp))
        more_checks[name] = [
            ("3-scan order",
             lambda sp=sp: front.front_dct(x5f, *consts, order="scan",
                                           sampling=sp),
             lambda sp=sp: front.front_dct_plain(x5f, *consts, order="scan",
                                                 sampling=sp))]

    def px_mode(sp, plain=False, transposed=False):
        fn = front.front_dct_px_plain if plain else front.front_dct_px
        src = xt5[sp] if transposed else px5[sp]
        return lambda: fn(src, *consts, LAYOUTS[sp], transposed=transposed)

    def k7(sp, plain=False):
        fn = (fused.dct_attach_pack_segments_plain if plain
              else fused.dct_attach_pack_segments)
        return lambda: fn(enc._lut, *consts, px5[sp], b5, *LAYOUTS[sp],
                          seg_rows5[sp])

    def k18a(sp, plain=False):
        fn = fused.dct_index_xt_plain if plain else fused.dct_index_xt
        return lambda: fn(*consts, xt5[sp], b5, *LAYOUTS[sp])
    calls["front_dct_px"] = (px_mode("444"), px_mode("444", plain=True))
    more_checks["front_dct_px"] = [
        ("transposed xt", px_mode("444", transposed=True),
         px_mode("444", plain=True, transposed=True)),
        ("4:2:2 layout", px_mode("422"), px_mode("422", plain=True))]
    calls["dct_attach_pack_segments"] = (k7("444"), k7("444", plain=True))
    check_calls["dct_attach_pack_segments"] = tuple(
        map(on_streams, calls["dct_attach_pack_segments"]))
    more_checks["dct_attach_pack_segments"] = [
        ("4:2:2 layout", on_streams(k7("422")),
         on_streams(k7("422", plain=True)))]
    calls["dct_index_xt"] = (k18a("444"), k18a("444", plain=True))
    more_checks["dct_index_xt"] = [
        ("4:2:2 layout", k18a("422"), k18a("422", plain=True))]
    for name in ("front_dct_px", "dct_attach_pack_segments", "dct_index_xt"):
        at_of[name] = f"{b5}x{h5}x{w5} 4:4:4 pixel blocks"
    # A on uniform-random frames (every coefficient nonzero, truncation
    # boundaries dense) in every mode and order; from a fifth generator
    rng5 = np.random.default_rng(args.seed + 8)
    xr = torch.from_numpy(rng5.integers(0, 256, (B, H, W * 3),
                                        dtype=np.uint8)).to(dev)
    x5r = torch.from_numpy(rng5.integers(0, 256, (b5, h5, w5 * 3),
                                         dtype=np.uint8)).to(dev)
    plane_r = torch.from_numpy(rng5.integers(0, 256, (1, 1280, 1920),
                                             dtype=np.uint8)).to(dev)
    px5r = {sp: color.mcu_blocks(*color.rgb_to_ycbcr(
        x5r.view(b5, h5, w5, 3), sp), sp) for sp in ("422", "444")}
    random_checks = [
        ("front_dct", "", xr), (f"front_dct {LABEL['422']}", "422", x5r),
        (f"front_dct {LABEL['444']}", "444", x5r)]
    for name, sp, xx in random_checks:
        for order in ("mcu", "scan"):
            kw = dict(order=order, sampling=sp or "420")
            more_checks[name].append((
                f"{order} order, uniform-random frames",
                lambda xx=xx, kw=kw: front.front_dct(xx, *consts, **kw),
                lambda xx=xx, kw=kw: front.front_dct_plain(xx, *consts,
                                                           **kw)))
    more_checks["front_dct"].append((
        "gray, a uniform-random 1x1280x1920 plane",
        lambda: front.front_dct_gray(plane_r, *consts[:3]),
        lambda: front.front_dct_gray_plain(plane_r, *consts[:3])))
    for sp in ("422", "444"):
        for tr in (False, True):
            src = px5r[sp].reshape(-1, 64).T.contiguous() if tr else px5r[sp]
            more_checks["front_dct_px"].append((
                f"{LABEL[sp]} layout, {'transposed xt, ' if tr else ''}"
                f"uniform-random frames",
                lambda src=src, sp=sp, tr=tr: front.front_dct_px(
                    src, *consts, LAYOUTS[sp], transposed=tr),
                lambda src=src, sp=sp, tr=tr: front.front_dct_px_plain(
                    src, *consts, LAYOUTS[sp], transposed=tr)))
    # one PyTorch call computing the same function, where there is one:
    # C's offsets are a cumsum; E's histogram is one bincount (the image
    # offset folded into the index)
    image_base = torch.arange(B, device=dev)[:, None, None] * 1024
    library = {
        "segment_offsets": lambda: torch.cumsum(fields[2], dim=-1),
        "symbolize_fields": lambda: torch.bincount(
            (image_base + (pf & 1023).view(B, -1, 64)).view(-1),
            minlength=B * 1024),
    }
    errs = {}
    for name, (kernel, plain) in calls.items():
        checks = ([("", *check_calls.get(name, (kernel, plain)))]
                  + more_checks.get(name, []))
        errs[name] = 0
        for label, k_fn, p_fn in checks:
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max_abs_err(got, want)
            errs[name] = max(errs[name], err)
            shapes = ", ".join(f"{tuple(g.shape)} {g.dtype}" for g in got)
            print(f"kernel {name}{f' ({label})' if label else ''}: {shapes}: "
                  f"max_abs_err {err} (tolerance: exact)")
            if err:
                raise AssertionError(f"kernel {name} disagrees with its "
                                     f"plain twin: max_abs_err {err}")

    errs["segment_offsets"] = max(errs["segment_offsets"], offsets_checks(
        dev, np.random.default_rng(args.seed + 7)))

    # -- phase 3: the main path, through encode_batch, per mode --------------
    batches = [synthetic_batch(rng, b, h, w) for b, h, w, _ in GEOMETRIES]
    encoders = {mode: [FastBatchEncoder(h, w, config(mode, r), device=dev)
                       for _, h, w, r in GEOMETRIES] for mode in MODES}
    path_kernels = {"fixed": FIXED_PATH, "dynamic": DYNAMIC_PATH,
                    "dynamic-sampled": DYNAMIC_PATH}
    launches = dict.fromkeys([*calls, *launch_counts(),
                              "decode_segments speculative"], 0)
    fixed_dht = None
    for mode in MODES:
        torch.cuda.synchronize()
        reset_launch_counts()
        outputs = [e.encode_batch(bt)
                   for e, bt in zip(encoders[mode], batches)]
        counts = launch_counts()
        print(f"main path {mode}: launches {json.dumps(counts)}")
        for name in path_kernels[mode]:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"{mode} path")
        for name, n in counts.items():
            launches[name] += n
        for (b, h, w, r), bt, files in zip(GEOMETRIES, batches, outputs):
            n_ref = b if mode == "fixed" else min(b, CPU_IMAGES_DYNAMIC)
            ref = FastBatchEncoder(h, w, config(mode, r),
                                   device="cpu").encode_batch(bt[:n_ref])
            same = sum(f == g for f, g in zip(files, ref))
            print(f"{mode} {b}x{h}x{w} restart_rows={r}: {same}/{n_ref} "
                  f"files byte-identical to the CPU plain path (the first "
                  f"{n_ref} of {b}), {sum(map(len, files))} bytes")
            if same != n_ref:
                raise AssertionError(f"{mode} {b}x{h}x{w}: card and CPU "
                                     f"bytes differ")
            dhts = [dht_segments(f) for f in files]
            if mode == "fixed":
                fixed_dht = dhts[0]
            elif any(d == fixed_dht or len(d) != 4 for d in dhts):
                raise AssertionError(f"{mode} {b}x{h}x{w}: a file carries "
                                     f"the fixed tables")
            if r:
                n_segs = (h // 16) // r
                for f in files:
                    rst = sum(f.count(bytes([0xFF, 0xD0 + i]))
                              for i in range(8))
                    if b"\xff\xdd" not in f or rst != n_segs - 1:
                        raise AssertionError(f"restart file lacks DRI or has "
                                             f"{rst} RSTn, want {n_segs - 1}")
                print(f"  DRI present, {n_segs - 1} RSTn markers per file")
        img0 = batches[0][0]
        dec = golden.decode(outputs[0][0])
        if dec.shape != img0.shape:
            raise AssertionError(f"decoded shape {dec.shape} != {img0.shape}")
        quality_db = golden.psnr(img0, dec)
        print(f"{mode}: golden decode of image 0 ({H}x{W}): PSNR "
              f"{quality_db:.2f} dB")
        if not quality_db > MIN_PSNR_DB:
            raise AssertionError(f"PSNR {quality_db:.2f} dB <= "
                                 f"{MIN_PSNR_DB} dB")

    # -- phase 3b: JpegEncoder and encode_gray, each call its own path ------
    for case in jpeg_cases(rng2):
        torch.cuda.synchronize()
        reset_launch_counts()
        files = case["call"](dev)
        counts = launch_counts()
        print(f"main path {case['label']}: launches {json.dumps(counts)}")
        for name in case["kernels"]:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"path {case['label']}")
        for name, n in counts.items():
            launches[name] += n
        print("  " + check_jpeg_case(case, files, case["ref"](), fixed_dht))

    # -- phase 3c: the f64 exact mode, each call its own path ---------------
    f64_runs = []
    for case in f64_cases(rng3):
        fn = case["make"](dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        files = fn()
        counts = launch_counts()
        print(f"main path {case['label']}: launches {json.dumps(counts)}")
        for name in case["kernels"]:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"path {case['label']}")
        for name, n in counts.items():
            launches[name] += n
        print("  " + check_f64_case(case, files, fixed_dht))
        f64_runs.append((case["label"], fn))

    # -- phase 3d: 4:2:2 and 4:4:4, each call its own path -------------------
    sampling_runs = []
    for case in sampling_cases(np.random.default_rng(args.seed + 4)):
        fn = case["make"](dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        files = fn()
        counts = launch_counts()
        print(f"main path {case['label']}: launches {json.dumps(counts)}")
        for name in case["kernels"]:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"path {case['label']}")
        for name, n in counts.items():
            launches[name] += n
        launches[f"front_dct {LABEL[case['sampling']]}"] += counts["front_dct"]
        print("  " + check_f64_case(case, files, fixed_dht))
        sampling_runs.append((case["label"], fn))

    # -- phase 3e: decode: kernel G against its twin, then each case --------
    t_decode = time.perf_counter()
    dcases = decode_cases(np.random.default_rng(args.seed + 5), dev)
    errs["decode_segments"], g_in, g_dev, decode_runs, r17 = decode_phase(
        dcases, dev, launches)
    print(f"phase 3e (decode) took {time.perf_counter() - t_decode:.1f} s")

    # -- phase 3f: speculative decode: H and G against their twins, then
    # each case ---------------------------------------------------------------
    t_spec = time.perf_counter()
    scases = spec_cases(np.random.default_rng(args.seed + SPEC_RNG_OFFSET),
                        dev, dcases)
    (errs["scan_positions"], errs["decode_segments speculative"], spec_calls,
     spec_bounds, spec_shapes) = spec_kernel_phase(
        scases[1]["files"][0], scases[3]["files"][0], dev)
    for line in spec_decisions(scases[0]["files"][0], dev):
        print(f"decision on a corrupted copy of {scases[0]['label']}: {line}")
    spec_runs = spec_phase(scases, dev, launches,
                           REFERENCE_GOLDEN_MISSES if args.seed == 0 else {})
    print(f"phase 3f (speculative decode) took "
          f"{time.perf_counter() - t_spec:.1f} s")

    # -- phase 3g: encode_stream and BucketedEncoder, each stream its own
    # path ---------------------------------------------------------------------
    t_stream = time.perf_counter()
    stream_runs = stream_phase(
        stream_cases(np.random.default_rng(args.seed + 13)), dev, launches)
    print(f"phase 3g (stream) took {time.perf_counter() - t_stream:.1f} s")

    # -- phase 3h: progressive encode, each call its own path ----------------
    t_prog = time.perf_counter()
    progressive_runs = progressive_phase(
        np.random.default_rng(args.seed + 14), dev, launches)
    print(f"phase 3h (progressive) took {time.perf_counter() - t_prog:.1f} s")

    # -- phase 3i: the monitor, compare_pairwise_batch, the CLI and
    # ResilientEncoder, each run its own path ---------------------------------
    t_mon = time.perf_counter()
    monitor_runs = monitor_phase(np.random.default_rng(args.seed + 15), dev,
                                 launches)
    print(f"phase 3i (monitor, CLI, resilience) took "
          f"{time.perf_counter() - t_mon:.1f} s")

    # -- phase 3j: the multi-device layer, each run its own path ------------
    sharded_runs = sharded_phase(args.seed, dev, card, launches, fixed_dht,
                                 dcases, scases)

    # -- phase 4: timings ----------------------------------------------------
    t_sharded = time.perf_counter()
    sharded_timings(sharded_runs, dev, card, max(3, args.runs // 4))
    print(f"the multi-device timings took "
          f"{time.perf_counter() - t_sharded:.1f} s")
    t_mon = time.perf_counter()
    monitor_timings(monitor_runs, card, max(3, args.runs // 4))
    print(f"the monitor's timings took {time.perf_counter() - t_mon:.1f} s")
    stream_timings(stream_runs, progressive_runs, card, max(3, args.runs // 4))
    for mode in MODES:
        for (b, h, w, r), bt, e in zip(GEOMETRIES, batches, encoders[mode]):
            xd = torch.from_numpy(bt).to(dev)
            mp = b * h * w / 1e6
            if mode == "fixed":
                dev_ms = cuda_ms(lambda: e.step(xd), args.runs)
                what = "device step"
            else:
                def pack():
                    e.dynamic_pack(xd)
                    torch.cuda.synchronize()
                dev_ms = host_ms(pack, args.runs)
                what = "dynamic_pack"
            enc_ms = host_ms(lambda: e.encode_batch(xd), args.runs)
            print(f"timing {mode} {b}x{h}x{w} restart_rows={r} on [{card}]: "
                  f"{what} {dev_ms:.4f} ms ({mp / dev_ms * 1e3:.1f} MP/s), "
                  f"encode_batch {enc_ms:.4f} ms "
                  f"({mp / enc_ms * 1e3:.1f} MP/s); median of {args.runs}")
            if mode != "fixed":
                split = dynamic_split(e, xd, args.runs)
                print(f"  host split (ms, median of {args.runs}): " +
                      ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
            per_call, idle = device_profile(lambda: e.encode_batch(xd),
                                            args.runs)
            print(f"  device µs per encode_batch (torch.profiler, "
                  f"{args.runs} calls): " +
                  ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                      per_call.items(), key=lambda kv: -kv[1])) +
                  f"; total {sum(per_call.values()):.2f}; device idle "
                  f"share {idle:.4f}")
    # JpegEncoder in the 3-scan layout: encode of one image per geometry,
    # and encode_batch of the first geometry's batch
    runs_3scan = [(1, h, w, r, "encode") for h, w, r in SCAN_GEOMETRIES]
    runs_3scan.append((16, 640, 640, 0, "encode_batch"))
    for b, h, w, r, method in runs_3scan:
        xd = torch.from_numpy(synthetic_batch(rng2, b, h, w)).to(dev)
        xd = xd[0] if method == "encode" else xd
        for mode in MODES:
            e = JpegEncoder(EncodeConfig(huffman=mode,
                                         restart_interval_mcu_rows=r),
                            device=dev)
            call = getattr(e, method)
            enc_ms = host_ms(lambda: call(xd), args.runs)
            print(f"timing JpegEncoder.{method} 3scan {mode} {b}x{h}x{w} "
                  f"restart_rows={r} on [{card}]: {enc_ms:.4f} ms "
                  f"({b * h * w / 1e3 / enc_ms:.1f} MP/s); median of "
                  f"{args.runs}")
            per_call, idle = device_profile(lambda: call(xd), args.runs)
            print(f"  device µs per {method} (torch.profiler, {args.runs} "
                  f"calls): " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                      per_call.items(), key=lambda kv: -kv[1])) +
                  f"; total {sum(per_call.values()):.2f}; device idle "
                  f"share {idle:.4f}")
    one = hist3[:1].cpu().numpy()
    k2_ms = host_ms(lambda: FastBatchEncoder._build_tables_batch(one),
                    args.runs)
    print(f"timing K.2 builds + LUT of one image's 4 tables (host, the "
          f"fixed cost of a dynamic encode) on [{card}]: {k2_ms:.4f} ms; "
          f"median of {args.runs}")
    # the f64 cases: call time, device time by kernel, idle share, and the
    # share of the device time in the f64 analysis (every device op but
    # the port's kernels and the copies)
    for label, fn in f64_runs:
        call_ms = host_ms(fn, args.runs)
        per_call, idle = device_profile(fn, args.runs)
        total = sum(per_call.values())
        own = sum(v for k, v in per_call.items()
                  if any(n in k for n in OWN_KERNELS))
        copies = sum(v for k, v in per_call.items()
                     if "Memcpy" in k or "Memset" in k)
        print(f"timing {label} on [{card}]: {call_ms:.4f} ms; median of "
              f"{args.runs}")
        print(f"  device µs per call (torch.profiler, {args.runs} calls): "
              f"total {total:.2f}, kernels {own:.2f}, copies and memsets "
              f"{copies:.2f}, f64 analysis {total - own - copies:.2f} "
              f"(share {(total - own - copies) / total:.4f}); device idle "
              f"share {idle:.4f}; by name: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      per_call.items(), key=lambda kv: -kv[1])[:12]))
    # the 4:2:2 and 4:4:4 cases: call time, device time by kernel, idle
    for label, fn in sampling_runs:
        call_ms = host_ms(fn, args.runs)
        per_call, idle = device_profile(fn, args.runs)
        print(f"timing {label} on [{card}]: {call_ms:.4f} ms; median of "
              f"{args.runs}")
        print(f"  device µs per call (torch.profiler, {args.runs} calls): " +
              ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  per_call.items(), key=lambda kv: -kv[1])) +
              f"; total {sum(per_call.values()):.2f}; device idle share "
              f"{idle:.4f}")
    offsets_timings(dev, np.random.default_rng(args.seed + 8), card,
                    args.runs)
    x_big = torch.from_numpy(synthetic_batch(rng2, 1, 1280, 1920)).to(dev)
    scan_kernel_times(x_big.reshape(1, 1280, 1920 * 3), consts, enc._lut,
                      card, args.runs)
    # the bounds count the words the streams hold, D's bytes its data, and
    # B's and F's the value groups their contract writes
    bound = bounds(B, H, W, enc.n_segs, place_nbytes(fields[1], offs[1]),
                   fields[1], fused.attach_pf_plain(pf, luts["dynamic"])[1])
    bound.update(explicit_bounds(
        s4, nblk4, stream_nbytes(k13[0]()[1]), b4,
        fused.symbolize_bits_explicit_plain(seq, dcd, isl, enc._lut)[1]))
    for sp in ("422", "444"):  # A px, K7 and K18a: the 4:4:4 shapes
        bound.update(sampling_bounds(b5, h5, w5, sp,
                                     stream_nbytes(k7(sp)()[1])))
    times = {}
    for name, (kernel, plain) in calls.items():
        # in turns (plain, library call, kernel, kernel, library call,
        # plain), so drift hits all alike
        fns = [plain, *([library[name]] if name in library else []), kernel]
        first = [cuda_ms(f, args.runs) for f in fns]
        second = [cuda_ms(f, args.runs) for f in reversed(fns)][::-1]
        p0, k0, k1, p1 = first[0], first[-1], second[-1], second[0]
        lib = ((first[1] + second[1]) / 2 if name in library else None)
        dus = device_us(kernel, args.runs)
        times[name] = ((k0 + k1) / 2, (p0 + p1) / 2, lib, dus[0])
        at = at_of.get(name, f"{b4}x{h4}x{w4} f64" if name in
                       F64_KERNELS else f"{B}x{H}x{W}")
        old = bound.get(f"{name} (per slot)")
        print(f"timing kernel {name} at {at} on [{card}]: "
              f"{times[name][0]:.4f} ms ({k0:.4f}, {k1:.4f}), plain twin "
              f"{times[name][1]:.4f} ms ({p0:.4f}, {p1:.4f})"
              + (f", one PyTorch call {lib:.4f} ms ({first[1]:.4f}, "
                 f"{second[1]:.4f})" if lib is not None else "")
              + f"; {device_text(dus)}, every device op of the call; bound "
              f"{bound[name][0]:.5f} ms ({bound[name][1]}"
              + (f"; {old[0]:.5f} counted per slot" if old else "") + ")")
    # E's traffic (2 bytes in, 4 out a slot) moved by PyTorch's own int16
    # -> int32 copy of the same coefficients: what this card gives such a
    # write-heavy stream (a yardstick; the port never calls it)
    for name, src in (("symbolize_fields", coef),
                      ("symbolize_fields_explicit", seq)):
        dst = torch.empty(src.shape, dtype=torch.int32, device=dev)
        copy = functools.partial(dst.copy_, src)
        print(f"timing E's traffic at {tuple(src.shape)} on [{card}]: "
              f"PyTorch's int16 -> int32 copy_ {cuda_ms(copy, args.runs):.4f}"
              f" ms, {device_text(device_us(copy, args.runs))}; kernel "
              f"{name} {times[name][0]:.4f} ms, device "
              f"{times[name][3]:.2f} µs")
    p0, k0, k1, p1 = (cuda_ms(f, args.runs)
                      for f in (k13[1], k13[0], k13[0], k13[1]))
    print(f"timing K13 (B explicit + C + D: analyze_attach_pack_segments) "
          f"at {b4}x{h4}x{w4} f64 on [{card}]: {(k0 + k1) / 2:.4f} ms "
          f"({k0:.4f}, {k1:.4f}), plain {(p0 + p1) / 2:.4f} ms ({p0:.4f}, "
          f"{p1:.4f}), bound {bound['K13'][0]:.5f} ms (bytes)")

    # decode: each case's call, device time, kernel G's share and idle
    # share; kernel G alone at the 16x640x640 r1 lanes, its twin at the
    # reduced input, and the host entropy route on the same files
    t_decode = time.perf_counter()
    decode_n = max(3, args.runs // 2)
    for label, fn in decode_runs:
        call_ms = host_ms(fn, decode_n)
        per_call, idle = device_profile(fn, decode_n)
        g_us = sum(v for k, v in per_call.items() if "decode_segments" in k)
        print(f"timing {label} on [{card}]: {call_ms:.4f} ms per call; "
              f"median of {decode_n}")
        print(f"  device µs per call (torch.profiler, {decode_n} calls): "
              f"total {sum(per_call.values()):.2f}, kernel G {g_us:.2f}; "
              f"device idle share {idle:.4f}; by name: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      per_call.items(), key=lambda kv: -kv[1])[:8]))
    g_streams, _, _, _, g_nblk, g_samp, g_seg, g_mw = g_in

    def g_full():
        return khd.decode_segments(*g_dev, g_samp, g_seg, g_mw)

    def g_twin():
        return khd.decode_segments_plain(*g_dev, g_samp, g_seg, g_mw)
    # the twin takes seconds at this size and ran warm in phase 3e
    p0, k0, k1, p1 = (cuda_ms(g_twin, 1, 1, 0), cuda_ms(g_full, args.runs),
                      cuda_ms(g_full, args.runs), cuda_ms(g_twin, 1, 1, 0))
    host_route = host_ms(lambda: [golden.parse_coefficients(f)
                                  for f in dcases[0]["files"]], decode_n)
    g_dus = device_us(g_full, args.runs)
    times["decode_segments"] = ((k0 + k1) / 2, (p0 + p1) / 2, None,
                                g_dus[0])
    g_infos = [pdec._parse_device_eligible(f) for f in dcases[0]["files"]]
    bound["decode_segments"] = (huff_bound(
        sum(len(seg) for info in g_infos for seg in info["segs"]),
        len(g_infos), g_streams.shape[0], int(g_nblk.sum()) * 64 * 4),
        "bytes")
    print(f"timing kernel decode_segments (G) at {dcases[0]['label']} "
          f"({g_streams.shape[0]} lanes x {g_seg} blocks, {g_mw} words) on "
          f"[{card}]: {times['decode_segments'][0]:.4f} ms ({k0:.4f}, "
          f"{k1:.4f}), {device_text(g_dus)}, bound "
          f"{bound['decode_segments'][0]:.5f} ms (bytes); "
          f"plain twin on the same inputs "
          f"{times['decode_segments'][1]:.4f} ms ({p0:.4f}, "
          f"{p1:.4f}); host entropy route on the same "
          f"{len(dcases[0]['files'])} files "
          f"(golden.parse_coefficients: native decode_scan on host threads "
          f"+ plane scatter) {host_route:.4f} ms; median of {args.runs} "
          f"(twin: one call each); the decode timings took "
          f"{time.perf_counter() - t_decode:.1f} s")

    g_timing_extras(g_full, g_dev, g_in, r17, card, args.runs)
    spec_timings(spec_runs, scases, spec_calls, spec_bounds, spec_shapes,
                 card, args.runs, decode_n, dev, times, bound)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "device_us": times[name][3],
         "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": times[name][2]}
        for name in [*calls, "decode_segments",
                     "decode_segments speculative", "scan_positions"]]}
    zero = [k["name"] for k in record["kernels"] if not k["device_us"] > 0]
    if zero:
        raise AssertionError(f"device_us reads 0 for {zero}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
