"""Wrappers of the hand-written CUDA kernels, with their plain twins.

Every wrapper takes its plain PyTorch twin for CPU tensors only.  For a
CUDA tensor it launches its kernel (building the kernels at first use) or
raises; it never falls back.  Each launch adds one to the kernel's count,
so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from .. import _build

KERNELS = ("front_dct", "front_dct_px", "symbolize_bits",
           "symbolize_bits_explicit", "segment_offsets", "place",
           "symbolize_fields", "symbolize_fields_explicit", "attach_pf",
           "decode_segments", "scan_positions", "write_files")

_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in KERNELS:
        _launches[name] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the plain twins' domain).

    Raises for a mix of devices, and for any device but the CPU and CUDA.
    """
    devices = {t.device for t in tensors}
    kind = next(iter(devices)).type
    if len(devices) != 1 or kind not in ("cpu", "cuda"):
        raise ValueError(f"tensors must all be on the CPU or all on CUDA "
                         f"(one device), got {sorted(map(str, devices))}")
    return kind == "cpu"


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...]) -> None:
    """Raise unless ``t`` has this dtype, shape and a contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a fresh contiguous copy of it where its data does not start
    on an ``nbytes`` boundary (a kernel's vector copies need that)."""
    if t.data_ptr() % nbytes == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# kernel -> its C entry point, resolved once (the first lookup builds)
_entries: dict = {}

# PyTorch's raw queries of the current device and stream (CUDA builds; a
# CUDA tensor exists, so CUDA is initialized): no lazy-init check and no
# Stream object
_raw_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_device() -> int:
    """The index of PyTorch's current CUDA device."""
    if _raw_device is not None:
        return _raw_device()
    return torch.cuda.current_device()


def stream_handle(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device ``index``."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device`` and PyTorch's current stream
    there (building the kernels at first use); raise if the launch failed,
    else count it.  ``args`` are the C entry point's, without the stream.
    """
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = _build.entry(name)
    index, current = device.index, current_device()
    if index is None or index == current:
        rc = fn(*args, stream_handle(current))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream_handle(index))
    if rc:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    _launches[name] += 1
