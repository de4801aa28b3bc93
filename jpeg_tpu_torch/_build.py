"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<source>.cu`` is compiled by its own ``nvcc`` process, all
started together, into ``_build/<source>-<hash>.so`` (a shared library
with a plain C interface; no PyTorch headers, so a build takes seconds).
A source may hold several kernels' entry points (``SIGNATURES``).  The
hash covers the source, the ``csrc/*.cuh`` headers it includes and the
flags, so an edited source or header rebuilds.

Only a CUDA tensor reaches this module: if ``nvcc`` is missing or a build
fails it raises, and nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
# kernel -> (its source in csrc/, its C entry point, argument types).
# Every entry returns the launch's cudaGetLastError() as an int.
SIGNATURES = {
    "front_dct": ("front_dct", "jt_front_dct",
                  [_VOID] * 6 + [_INT] * 5 + [_VOID]),
    "front_dct_px": ("front_dct", "jt_front_dct_px",
                     [_VOID] * 6 + [_INT] * 5 + [_VOID]),
    "symbolize_bits": ("symbolize_bits", "jt_symbolize_bits",
                       [_VOID] * 5 + [_INT] * 4 + [_VOID]),
    "symbolize_bits_explicit": ("symbolize_bits",
                                "jt_symbolize_bits_explicit",
                                [_VOID] * 7 + [_INT] * 2 + [_VOID]),
    "segment_offsets": ("segment_offsets", "jt_segment_offsets",
                        [_VOID] * 4 + [_INT] * 2 + [_VOID]),
    "place": ("place", "jt_place", [_VOID] * 5 + [_INT] * 3 + [_VOID]),
    "symbolize_fields": ("symbolize_fields", "jt_symbolize_fields",
                         [_VOID] * 5 + [_INT] * 6 + [_VOID]),
    "symbolize_fields_explicit": ("symbolize_fields",
                                  "jt_symbolize_fields_explicit",
                                  [_VOID] * 6 + [_INT] * 3 + [_VOID]),
    "attach_pf": ("attach_pf", "jt_attach_pf",
                  [_VOID] * 5 + [_INT] * 3 + [_VOID]),
    "decode_segments": ("huffdec", "jt_decode_segments",
                        [_VOID] * 8 + [_INT] * 5 + [_VOID]),
    "scan_positions": ("huffdec", "jt_scan_positions",
                       [_VOID] * 8 + [_INT] * 5 + [_VOID]),
    "write_files": ("write_files", "jt_write_files",
                    [_VOID] * 7 + [_INT] * 4 + [_VOID]),
}
# the sources to build, in SIGNATURES order
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # where the toolkit puts it off PATH

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists(CUDA_NVCC):
        path = CUDA_NVCC
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "jpeg_tpu_torch cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(source: str) -> list[str]:
    """``csrc/<source>.cu`` and the local headers it includes (directly or
    through another local header), in include order."""
    out = [os.path.join(SRC_DIR, source + ".cu")]
    for path in out:
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if dep not in out:
                    out.append(dep)
    return out


def _target(source: str) -> tuple[str, str]:
    srcs = sources(source)
    h = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return srcs[0], os.path.join(BUILD_DIR,
                                 f"{source}-{h.hexdigest()[:16]}.so")


def _build_all() -> None:
    """Compile every stale source in parallel, then load all of them."""
    global build_seconds
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for source in SOURCES:
        src, so = _target(source)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            jobs.append((proc, tmp, so, cmd))
    failed = []
    for proc, tmp, so, cmd in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{' '.join(cmd)}\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    libs = {source: ctypes.CDLL(_target(source)[1]) for source in SOURCES}
    for source, fn, argtypes in SIGNATURES.values():
        getattr(libs[source], fn).argtypes = argtypes
        getattr(libs[source], fn).restype = _INT
    _libs.update(libs)
    build_seconds = time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu``, building all kernels once."""
    with _lock:
        if not _libs:
            _build_all()
    return _libs[source]


def entry(name: str):
    """The C entry point of kernel ``name``, building all kernels once."""
    source, fn, _ = SIGNATURES[name]
    return getattr(library(source), fn)
