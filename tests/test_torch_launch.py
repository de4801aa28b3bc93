"""The port's kernel launch path on the CPU, with fake C entry points.

``kernels.launch`` resolves each kernel's ctypes entry point once (the
first lookup builds every kernel), switches the CUDA device only when the
target is not the current one, raises on a non-zero return code without
counting, and counts one launch otherwise.  ``fused.segment_offsets``
hands kernel C its outputs and a zeroed workspace kept per (device,
stream), sized by the kernel's source.  No card and no nvcc are needed:
every CUDA call is faked.
No jax here."""
import contextlib

import pytest
import torch

from jpeg_tpu_torch import _build, kernels
from jpeg_tpu_torch.kernels import fused


class FakeEntry:
    """A C entry point returning ``rc``; records each call's arguments."""

    def __init__(self, rc: int = 0):
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_cuda(monkeypatch):
    """Current device 0, stream handle 77, device switches recorded, and
    the cache of entry points emptied; returns (lookups, switches)."""
    lookups, switches = [], []

    @contextlib.contextmanager
    def device(index):
        switches.append(index)
        yield

    monkeypatch.setattr(kernels, "_entries", {})
    monkeypatch.setattr(kernels, "stream_handle", lambda index: 77)
    monkeypatch.setattr(kernels, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", device)
    return lookups, switches


def _serve(monkeypatch, lookups, entry):
    def lookup(name):
        lookups.append(name)
        return entry
    monkeypatch.setattr(_build, "entry", lookup)


@pytest.mark.parametrize("rc", [1, 700])
def test_launch_raises_on_error_and_does_not_count(monkeypatch, fake_cuda,
                                                   rc):
    lookups, _ = fake_cuda
    _serve(monkeypatch, lookups, FakeEntry(rc))
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"cudaError {rc}"):
        kernels.launch("segment_offsets", torch.device("cuda", 0), 1, 2)
    assert kernels.launch_counts()["segment_offsets"] == 0


def test_launch_counts_once_and_passes_the_stream_last(monkeypatch,
                                                       fake_cuda):
    lookups, switches = fake_cuda
    entry = FakeEntry(0)
    _serve(monkeypatch, lookups, entry)
    kernels.reset_launch_counts()
    kernels.launch("place", torch.device("cuda", 0), 11, 12, 3)
    counts = kernels.launch_counts()
    assert counts["place"] == 1
    assert sum(counts.values()) == 1
    assert entry.calls == [(11, 12, 3, 77)]
    assert switches == []  # device 0 is already current


def test_launch_resolves_each_entry_point_once(monkeypatch, fake_cuda):
    lookups, _ = fake_cuda
    _serve(monkeypatch, lookups, FakeEntry(0))
    kernels.reset_launch_counts()
    for _ in range(3):
        kernels.launch("scan_positions", torch.device("cuda", 0))
        kernels.launch("place", torch.device("cuda", 0))
    assert lookups == ["scan_positions", "place"]
    assert kernels.launch_counts()["scan_positions"] == 3


def test_launch_switches_only_to_another_device(monkeypatch, fake_cuda):
    lookups, switches = fake_cuda
    _serve(monkeypatch, lookups, FakeEntry(0))
    kernels.launch("place", torch.device("cuda", 1))
    kernels.launch("place", torch.device("cuda", 0))
    kernels.launch("place", torch.device("cuda"))  # the current device
    assert switches == [1]


def test_build_entry_builds_at_first_use_only(monkeypatch):
    builds = []

    class Lib:
        pass

    def build_all():
        builds.append(1)
        libs = {}
        for source, fn, _ in _build.SIGNATURES.values():
            lib = libs.setdefault(source, Lib())
            setattr(lib, fn, FakeEntry(0))
        _build._libs.update(libs)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_build_all", build_all)
    first = _build.entry("segment_offsets")
    assert _build.entry("segment_offsets") is first
    _build.entry("scan_positions")
    assert _build.library("huffdec") is _build._libs["huffdec"]
    assert builds == [1]


@pytest.mark.parametrize("S,nblk", [(1, 1), (3, 4096), (2, 4097), (5, 100)])
def test_segment_offsets_hands_c_outputs_and_workspace(monkeypatch, S, nblk):
    """The wrapper's CUDA branch on CPU tensors: one fresh buffer a call
    holds the offsets, then the totals, returned as contiguous views of
    the documented shapes; the workspace is sized by the source's own rule
    (here a fake one: the counters, then a status word per tile of 4096
    blocks), zeroed once a (device, stream), grown when a launch needs
    more words."""
    seen = []

    def fake_launch(name, device, *args):
        seen.append((name, args))

    monkeypatch.setattr(fused, "on_cpu", lambda *t: False)
    monkeypatch.setattr(fused, "launch", fake_launch)
    monkeypatch.setattr(fused, "stream_handle", lambda index: 5)
    monkeypatch.setattr(fused, "_offsets_work", {})
    monkeypatch.setattr(fused, "_offsets_words",
                        lambda S, nblk: S * -(-nblk // 4096) + 1)
    bits = torch.ones((S, nblk), dtype=torch.int32)
    offs, totals = fused.segment_offsets(bits)
    offs2, _ = fused.segment_offsets(bits)
    assert [name for name, _ in seen] == ["segment_offsets"] * 2
    args = seen[0][1]
    assert args[:2] == (bits.data_ptr(), offs.data_ptr())
    assert args[2] == totals.data_ptr() == offs.data_ptr() + 4 * S * nblk
    assert args[4:] == (S, nblk)
    assert offs.shape == (S, nblk) and totals.shape == (S,)
    assert offs.is_contiguous() and totals.is_contiguous()
    assert offs.dtype == totals.dtype == torch.int32
    assert offs2.data_ptr() != offs.data_ptr()  # fresh outputs a call
    (key, work), = fused._offsets_work.items()
    assert key == (None, 5) and seen[1][1][3] == args[3] == work.data_ptr()
    assert work.dtype == torch.int64 and not work.any()
    assert work.numel() >= S * -(-nblk // 4096) + 1
    big = torch.ones((2000, 1), dtype=torch.int32)
    fused.segment_offsets(big)
    assert fused._offsets_work[key].numel() >= 2001


def test_offsets_words_asks_the_library(monkeypatch):
    """Kernel C's workspace size comes from its source's
    ``jt_segment_offsets_words``, asked once a shape."""
    asked = []

    class Lib:
        @staticmethod
        def jt_segment_offsets_words(S, nblk):
            asked.append((S, nblk))
            return 7 * S + nblk

    monkeypatch.setattr(_build, "library", lambda source: Lib)
    fused._offsets_words.cache_clear()
    try:
        assert fused._offsets_words(2, 3) == 17
        assert fused._offsets_words(2, 3) == 17
        assert fused._offsets_words(1, 1) == 8
    finally:
        fused._offsets_words.cache_clear()
    assert asked == [(2, 3), (1, 1)]
