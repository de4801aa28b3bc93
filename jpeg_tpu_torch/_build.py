"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process, all
started together, into ``_build/<name>-<hash>.so`` (a shared library with
a plain C interface; no PyTorch headers, so a build takes seconds).  The
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
# C entry point of each source: (function, argument types).  Every entry
# returns the launch's cudaGetLastError() as an int.
SIGNATURES = {
    "front_dct": ("jt_front_dct", [_VOID] * 6 + [_INT] * 4 + [_VOID]),
    "symbolize_bits": ("jt_symbolize_bits",
                       [_VOID] * 5 + [_INT] * 4 + [_VOID]),
    "segment_offsets": ("jt_segment_offsets",
                        [_VOID] * 3 + [_INT] * 2 + [_VOID]),
    "place": ("jt_place", [_VOID] * 4 + [_INT] * 3 + [_VOID]),
    "symbolize_fields": ("jt_symbolize_fields",
                         [_VOID] * 4 + [_INT] * 6 + [_VOID]),
    "attach_pf": ("jt_attach_pf", [_VOID] * 5 + [_INT] * 3 + [_VOID]),
}

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


def sources(name: str) -> list[str]:
    """Kernel ``name``'s ``.cu`` file and the local headers it includes
    (directly or through another local header), in include order."""
    out = [os.path.join(SRC_DIR, name + ".cu")]
    for path in out:
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if dep not in out:
                    out.append(dep)
    return out


def _target(name: str) -> tuple[str, str]:
    srcs = sources(name)
    h = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    src = srcs[0]
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _build_all() -> None:
    """Compile every stale source in parallel, then load all of them."""
    global build_seconds
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in SIGNATURES:
        src, so = _target(name)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, so, cmd))
    failed = []
    for name, proc, tmp, so, cmd in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{' '.join(cmd)}\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name, (fn, argtypes) in SIGNATURES.items():
        lib = ctypes.CDLL(_target(name)[1])
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
        _libs[name] = lib
    build_seconds = time.perf_counter() - t0


def entry(name: str):
    """The C entry point of kernel ``name``, building all kernels once."""
    with _lock:
        if not _libs:
            _build_all()
    fn, _ = SIGNATURES[name]
    return getattr(_libs[name], fn)
