#!/usr/bin/env python3
"""Drive the jpeg_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--runs N]

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of the four CUDA kernels from ``jpeg_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin on the card, at the shapes
   of a 16x640x640 batch; integer outputs must be exactly equal;
3. ``FastBatchEncoder.encode_batch`` on 16x640x640, 4x1920x1280 and
   2x1920x1088 with 4 restart segments: the launch counts are reset just
   before and read just after; the JPEG bytes must equal those of the same
   encoder on the CPU (the plain twins), one image must decode with
   ``jpeg_tpu.golden.decoder`` at a sane PSNR, and the restart files must
   carry DRI and RSTn markers;
4. CUDA-event timings: the median of ``--runs`` warm runs of the device
   step and of ``encode_batch`` per geometry, and of each kernel next to
   its plain twin.

The line before the last is the ``kernels`` JSON record; the last line is
the JSON verdict.  Inputs are synthetic images (smooth gradients plus hard
edges) made with numpy from ``--seed``.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from jpeg_tpu.golden import decoder as golden
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder, _build
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)
from jpeg_tpu_torch.ops.dct import set_exact_matmul

# (batch, height, width, restart_interval_mcu_rows)
GEOMETRIES = [(16, 640, 640, 0), (4, 1280, 1920, 0), (2, 1088, 1920, 17)]

KERNEL_INFO = {
    "front_dct": ("jpeg_tpu_torch/csrc/front_dct.cu",
                  "jpeg_tpu/kernels/front.py:502"),
    "symbolize_bits": ("jpeg_tpu_torch/csrc/symbolize_bits.cu",
                       "jpeg_tpu/kernels/fused.py:576"),
    "segment_offsets": ("jpeg_tpu_torch/csrc/segment_offsets.cu",
                        "jpeg_tpu/kernels/front.py:823"),
    "place": ("jpeg_tpu_torch/csrc/place.cu",
              "jpeg_tpu/kernels/fused.py:1388"),
}


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


def cuda_ms(fn, runs: int, inner: int = 10) -> float:
    """CUDA-event time of one call of ``fn``, in ms: the median over
    ``runs`` warm runs of ``inner`` back-to-back calls, divided by
    ``inner`` (the calls queue on the stream, so the host's launch work
    overlaps the device's unless the device is the faster of the two)."""
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    cfg = EncodeConfig(scan_layout="interleaved", huffman="fixed")
    dev = torch.device("cuda", 0)

    # -- phase 1: the card and the build -----------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    set_exact_matmul()
    _build.entry("front_dct")
    print(f"build: 4 kernels (nvcc, sm_90a) in {_build.build_seconds:.1f} s")

    # -- phase 2: every kernel against its plain twin ------------------------
    B, H, W, _ = GEOMETRIES[0]
    enc = FastBatchEncoder(H, W, cfg, device=dev)
    x = torch.from_numpy(synthetic_batch(rng, B, H, W)).to(dev)
    x = x.reshape(B, H, W * 3)
    consts = (enc._m, enc._bias, enc._ql, enc._qc)
    seg_words = enc.seg_rows * 128
    nblk = enc.blocks_per_seg
    coef = front.front_dct_plain(x, *consts).view(B, nblk, 64)
    fields = fused.symbolize_bits_plain(coef, enc._lut)
    offs = fused.segment_offsets_plain(fields[2])
    calls = {
        "front_dct": (lambda: front.front_dct(x, *consts),
                      lambda: front.front_dct_plain(x, *consts)),
        "symbolize_bits": (lambda: fused.symbolize_bits(coef, enc._lut),
                           lambda: fused.symbolize_bits_plain(coef,
                                                              enc._lut)),
        "segment_offsets": (lambda: fused.segment_offsets(fields[2]),
                            lambda: fused.segment_offsets_plain(fields[2])),
        "place": (lambda: fused.place(fields[0], fields[1], offs[0],
                                      seg_words),
                  lambda: fused.place_plain(fields[0], fields[1], offs[0],
                                            seg_words)),
    }
    errs = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[name] = max_abs_err(got, want)
        shapes = ", ".join(f"{tuple(g.shape)} {g.dtype}" for g in got)
        print(f"kernel {name}: {shapes}: max_abs_err {errs[name]} "
              f"(tolerance: exact)")
        if errs[name]:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"twin: max_abs_err {errs[name]}")

    # -- phase 3: the main path, through encode_batch ------------------------
    batches = [synthetic_batch(rng, b, h, w) for b, h, w, _ in GEOMETRIES]
    encoders = [FastBatchEncoder(
        h, w, EncodeConfig(scan_layout="interleaved", huffman="fixed",
                           restart_interval_mcu_rows=r), device=dev)
        for _, h, w, r in GEOMETRIES]
    torch.cuda.synchronize()
    reset_launch_counts()
    outputs = [e.encode_batch(bt) for e, bt in zip(encoders, batches)]
    launches = launch_counts()
    print(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    for (b, h, w, r), bt, files in zip(GEOMETRIES, batches, outputs):
        ref = FastBatchEncoder(
            h, w, EncodeConfig(scan_layout="interleaved", huffman="fixed",
                               restart_interval_mcu_rows=r),
            device="cpu").encode_batch(bt)
        same = sum(f == g for f, g in zip(files, ref))
        print(f"geometry {b}x{h}x{w} restart_rows={r}: {same}/{b} files "
              f"byte-identical to the CPU plain path, "
              f"{sum(map(len, files))} bytes")
        if same != b:
            raise AssertionError(f"{b}x{h}x{w}: card and CPU bytes differ")
        if r:
            n_segs = (h // 16) // r
            for f in files:
                rst = sum(f.count(bytes([0xFF, 0xD0 + i])) for i in range(8))
                if b"\xff\xdd" not in f or rst != n_segs - 1:
                    raise AssertionError(f"restart file lacks DRI or has "
                                         f"{rst} RSTn, want {n_segs - 1}")
            print(f"  DRI present, {n_segs - 1} RSTn markers per file")
    img0 = batches[0][0]
    dec = golden.decode(outputs[0][0])
    if dec.shape != img0.shape:
        raise AssertionError(f"decoded shape {dec.shape} != {img0.shape}")
    quality_db = golden.psnr(img0, dec)
    print(f"golden decode of image 0 ({H}x{W}): PSNR {quality_db:.2f} dB")
    # these synthetic images give about 32 dB at the unscaled T.81 tables
    if not quality_db > 28.0:
        raise AssertionError(f"PSNR {quality_db:.2f} dB <= 28 dB")

    # -- phase 4: timings ----------------------------------------------------
    for (b, h, w, r), bt, e in zip(GEOMETRIES, batches, encoders):
        xd = torch.from_numpy(bt).to(dev)
        step_ms = cuda_ms(lambda: e.step(xd), args.runs)
        enc_ms = host_ms(lambda: e.encode_batch(xd), args.runs)
        mp = b * h * w / 1e6
        print(f"timing {b}x{h}x{w} restart_rows={r} on [{card}]: device step "
              f"{step_ms:.4f} ms ({mp / step_ms * 1e3:.1f} MP/s), "
              f"encode_batch {enc_ms:.4f} ms ({mp / enc_ms * 1e3:.1f} MP/s); "
              f"median of {args.runs}")
    times = {}
    for name, (kernel, plain) in calls.items():
        # in turns (plain, kernel, kernel, plain), so drift hits both alike
        p0, k0, k1, p1 = (cuda_ms(f, args.runs)
                          for f in (plain, kernel, kernel, plain))
        times[name] = ((k0 + k1) / 2, (p0 + p1) / 2)
        print(f"timing kernel {name} at {B}x{H}x{W} on [{card}]: "
              f"{times[name][0]:.4f} ms ({k0:.4f}, {k1:.4f}), plain twin "
              f"{times[name][1]:.4f} ms ({p0:.4f}, {p1:.4f})")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in calls]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
