"""ctypes bindings of the port's host library (``native/host.cpp``).

``g++ -O2 -shared -fPIC -pthread`` builds it at first use into
``jpeg_tpu_torch/_build/libjt_host-<hash>.so`` (the hash covers the source
and the flags, so an edited source rebuilds).  There is no numpy
fallback: if the build fails, every entry point raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from ..utils.profiling import span

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
# C entry point -> argument types; every entry returns int64
_SIGNATURES = {
    "jt_finish_scan_max_out": [_I64],
    "jt_finish_scans": [_U32P, _I64, _I32P, _I64, _U8P, _I64P],
    "jt_assemble_interleaved": [_U32P, _I64, _I32P, _I64, _I64, _U8P,
                                _I64P, _U8P, _I64, _I64P, _I64],
    "jt_build_huff_tables": [_I64P, _I64, _I32P, _I32P, _I32P, _I32P],
    "jt_decode_scan_mt": [_U8P, _I64, _I64, _I32P, _I32P, _I32P, _I64, _I32P,
                          _I32P, _I64, _I64, _I64, _I64, _I32P],
    "jt_ac_refine_fields": [_I32P, _I64, _I64, _I64, _I64, _I64, _I32P,
                            _I32P, _I32P],
}


def _target() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libjt_host-{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The host library, built at first use; raises if the build fails."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = _target()
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = ["g++", *CXX_FLAGS, "-o", tmp, SRC]
                try:
                    out = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"the port's host library cannot be "
                                       f"built ({e})") from e
                if out.returncode:
                    raise RuntimeError(f"the port's host library failed to "
                                       f"build:\n{' '.join(cmd)}\n"
                                       f"{out.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I64
            _lib = lib
            build_seconds = time.perf_counter() - t0
        return _lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def finish_scans(words: np.ndarray, total_bits: np.ndarray) -> list[bytes]:
    """Batch finalization: words [S, stride] u32, total_bits [S] -> the
    stuffed scan payload of each segment."""
    lib = load()
    w = np.ascontiguousarray(words, dtype=np.uint32)
    tb = np.ascontiguousarray(total_bits, dtype=np.int32)
    s = w.shape[0]
    cap = sum(int(lib.jt_finish_scan_max_out(int(t))) for t in tb)
    out = np.empty(cap, np.uint8)
    offs = np.empty(s + 1, np.int64)
    offs[s] = lib.jt_finish_scans(_ptr(w, _U32P), w.shape[1],
                                  _ptr(tb, _I32P), s, _ptr(out, _U8P),
                                  _ptr(offs, _I64P))
    return [out[offs[i]:offs[i + 1]].tobytes() for i in range(s)]


def assemble_interleaved(words: np.ndarray, total_bits: np.ndarray,
                         headers: list[bytes], n_segs: int,
                         n_threads: int | None = None) -> list[bytes]:
    """Complete JPEG files for interleaved restart streams.

    ``words`` [n_images * n_segs, stride] u32, ``total_bits``
    [n_images * n_segs], ``headers`` one SOI..SOS-header byte string per
    image.  Each file is the header, the finalized segments with RSTn
    between them, and EOI; images assemble on host threads.
    """
    lib = load()
    with span("assemble"):
        w = np.ascontiguousarray(words, dtype=np.uint32)
        tb = np.ascontiguousarray(total_bits, dtype=np.int32)
        n = len(headers)
        if w.shape[0] != n * n_segs or tb.size != n * n_segs:
            raise ValueError(f"{w.shape[0]} word rows and {tb.size} totals "
                             f"for {n} images of {n_segs} segments")
        hdr = np.frombuffer(b"".join(headers), np.uint8)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(h) for h in headers], out=offs[1:])
        seg_caps = (2 * (tb.astype(np.int64) // 8) + 2).reshape(n, n_segs)
        stride = (int((seg_caps.sum(1) + np.diff(offs)).max())
                  + 2 * n_segs + 2)
        out = np.empty(n * stride, np.uint8)
        lens = np.empty(n, np.int64)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        lib.jt_assemble_interleaved(
            _ptr(w, _U32P), w.shape[1], _ptr(tb, _I32P), n, n_segs,
            _ptr(hdr, _U8P), _ptr(offs, _I64P), _ptr(out, _U8P), stride,
            _ptr(lens, _I64P), int(n_threads))
        return [out[i * stride:i * stride + lens[i]].tobytes()
                for i in range(n)]


def build_huff_tables(freqs: np.ndarray):
    """Batch Annex K.2 builds: freqs [n, 257] int64 (freq[256] == 1) ->
    (bits [n, 17], huffval [n, 256], code [n, 256], length [n, 256]) int32.

    Raises ValueError on an empty histogram or a code length overflow, as
    the Python builder does.
    """
    lib = load()
    f = np.ascontiguousarray(freqs, dtype=np.int64)
    n = f.shape[0]
    bits = np.empty((n, 17), np.int32)
    huffval = np.empty((n, 256), np.int32)
    code = np.empty((n, 256), np.int32)
    length = np.empty((n, 256), np.int32)
    rc = lib.jt_build_huff_tables(_ptr(f, _I64P), n, _ptr(bits, _I32P),
                                  _ptr(huffval, _I32P), _ptr(code, _I32P),
                                  _ptr(length, _I32P))
    if rc == 1:
        raise ValueError("empty symbol histogram: nothing to encode "
                         "(zero-sized image?)")
    if rc:
        raise ValueError("Huffman code length overflow (>= 32 bits)")
    return bits, huffval, code, length


def decode_scan(data: bytes, start: int, dc_specs: np.ndarray,
                ac_specs: np.ndarray, pattern, comp_dc, comp_ac,
                n_mcus: int, restart_interval: int):
    """Baseline scan decode (the serial Huffman bit-walk).

    dc_specs/ac_specs: [4, 273] int32, DHT BITS[17] + HUFFVAL[256] per
    table id.  pattern: the component slot of each block within an MCU.
    With restart markers, the RSTn-delimited segments decode in parallel
    on one host thread per CPU, at most 16.
    Returns (zz [n_mcus * len(pattern), 64] int32 in emission order,
    the offset past the scan's last entropy byte); raises ValueError on a
    malformed stream.
    """
    lib = load()
    buf = np.frombuffer(data, np.uint8)
    dc = np.ascontiguousarray(dc_specs, np.int32)
    ac = np.ascontiguousarray(ac_specs, np.int32)
    pat = np.ascontiguousarray(pattern, np.int32)
    cdc = np.ascontiguousarray(comp_dc, np.int32)
    cac = np.ascontiguousarray(comp_ac, np.int32)
    out = np.empty((n_mcus * pat.size, 64), np.int32)
    end = lib.jt_decode_scan_mt(
        _ptr(buf, _U8P), buf.size, start, _ptr(dc, _I32P), _ptr(ac, _I32P),
        _ptr(pat, _I32P), pat.size, _ptr(cdc, _I32P), _ptr(cac, _I32P),
        cdc.size, n_mcus, restart_interval, min(os.cpu_count() or 1, 16),
        _ptr(out, _I32P))
    if end < 0:
        raise ValueError("malformed entropy-coded segment")
    return out, int(end)


def ac_refine_fields(band: np.ndarray, al: int, max_run: int,
                     max_buffer: int):
    """Successive-approximation AC refinement coder (T.81 G.1.2.3).

    band: [n, w] band coefficients (not shifted).  Returns (sym, extra,
    extra_n) int32 arrays; sym -1 marks a raw correction bit.
    """
    lib = load()
    b = np.ascontiguousarray(band, dtype=np.int32)
    n, w = b.shape
    cap = n * (w + w // 16 + 2) + 8
    sym = np.empty(cap, np.int32)
    extra = np.empty(cap, np.int32)
    extra_n = np.empty(cap, np.int32)
    m = lib.jt_ac_refine_fields(_ptr(b, _I32P), n, w, int(al), int(max_run),
                                int(max_buffer), _ptr(sym, _I32P),
                                _ptr(extra, _I32P), _ptr(extra_n, _I32P))
    return sym[:m], extra[:m], extra_n[:m]
