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

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import _build, kernels
from jpeg_tpu_torch.kernels import files as kfiles
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


@pytest.mark.parametrize("nbytes", [4, 8, 16])
@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_aligned_copies_only_a_misaligned_tensor(nbytes, offset):
    """``kernels.aligned`` hands back the tensor itself when its data start
    on an ``nbytes`` boundary, else a fresh contiguous copy that does."""
    base = torch.arange(256, dtype=torch.uint8)
    t = base[offset:offset + 96].view(2, 48)
    got = kernels.aligned(t, nbytes)
    assert torch.equal(got, t) and got.is_contiguous()
    assert got.data_ptr() % nbytes == 0
    assert (got.data_ptr() == t.data_ptr()) == (t.data_ptr() % nbytes == 0)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data start one element past a
    16-byte boundary (the wrappers must not pass it to a kernel as is)."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    skip = next(i for i in range(1, 17)
                if (flat.data_ptr() + i * t.element_size()) % 16)
    out = flat[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# kernel A's wrappers: (entry point, its call on (pixels, consts), the
# alignment its kernel needs, the pixels' shape and dtype)
_A_MODES = {
    "420 mcu": ("front_dct", lambda f, x, c: f.front_dct(x, *c), 16,
                (2, 16, 48), torch.uint8),
    "420 scan": ("front_dct", lambda f, x, c: f.front_dct(
        x, *c, order="scan"), 16, (2, 16, 48), torch.uint8),
    "422 mcu": ("front_dct", lambda f, x, c: f.front_dct(
        x, *c, sampling="422"), 16, (2, 8, 48), torch.uint8),
    "444 scan": ("front_dct", lambda f, x, c: f.front_dct(
        x, *c, order="scan", sampling="444"), 16, (2, 8, 24), torch.uint8),
    "gray": ("front_dct", lambda f, x, c: f.front_dct_gray(x, *c[:3]), 8,
             (2, 8, 16), torch.uint8),
    "px rows": ("front_dct_px", lambda f, x, c: f.front_dct_px(
        x, *c, (3, 1)), 16, (2, 6, 64), torch.float32),
    "px transposed": ("front_dct_px", lambda f, x, c: f.front_dct_px(
        x, *c, (3, 1), transposed=True), 4, (64, 6), torch.float32),
}


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("mode", list(_A_MODES))
def test_front_wrappers_hand_kernel_a_aligned_pixels(monkeypatch, mode,
                                                     misaligned):
    """Kernel A copies its pixels in 16-byte (gray: 8-byte) pieces: each
    wrapper's CUDA branch (on CPU tensors here) passes the pixels' own
    address when it is aligned, else the address of an aligned copy of
    them, and launches once."""
    from jpeg_tpu_torch.kernels import front
    name, call, nbytes, shape, dtype = _A_MODES[mode]
    launched, copies = [], []
    real_aligned = kernels.aligned

    def spy(t, n):
        out = real_aligned(t, n)
        copies.append((t, n, out))
        return out

    monkeypatch.setattr(front, "on_cpu", lambda *t: False)
    monkeypatch.setattr(front, "launch",
                        lambda kname, device, *args: launched.append(
                            (kname, args)))
    monkeypatch.setattr(front, "aligned", spy)
    x = (torch.arange(int(np.prod(shape))) % 251).to(dtype).reshape(shape)
    if misaligned:
        x = _misaligned(x)
    consts = (torch.zeros(64, 64), torch.zeros(64), torch.ones(64),
              torch.ones(64))
    call(front, x, consts)
    (kname, args), = launched
    (given, n, passed), = copies
    assert kname == name and given is x and n == nbytes
    assert args[0] == passed.data_ptr() and passed.data_ptr() % nbytes == 0
    assert torch.equal(passed, x)
    assert (passed.data_ptr() == x.data_ptr()) == (not misaligned
                                                  or x.data_ptr() % n == 0)


@pytest.mark.parametrize("kernel,code", [("decode_segments", 0),
                                         ("scan_positions", 1)])
@pytest.mark.parametrize("answer,layout", [(9, (4, True)), (5, (2, True)),
                                           (3, (1, True)), (8, (4, False))])
def test_lane_layout_asks_the_source(monkeypatch, kernel, code, answer,
                                     layout):
    """``huffdec.lane_layout`` asks ``jt_lane_layout`` of the kernels'
    source (kernel G: 0, H: 1) and decodes its answer, lanes a CTA x 2 +
    1 where the rows are staged in shared memory."""
    from jpeg_tpu_torch.kernels import huffdec
    asked = []

    class Lib:
        @staticmethod
        def jt_lane_layout(words, k):
            asked.append((words, k))
            return answer

    monkeypatch.setattr(_build, "library", lambda source: Lib)
    assert huffdec.lane_layout(kernel, 20000) == layout
    assert asked == [(20000, code)]


@pytest.mark.parametrize("sampling,period,ypm", [
    ("420", 6, 4), ("422", 4, 2), ("444", 3, 1), ("gray", 1, 1)])
@pytest.mark.parametrize("mode", ["restart", "entry", "phased"])
def test_decode_segments_hands_kernel_g_its_mode(monkeypatch, sampling,
                                                 period, ypm, mode):
    """Kernel G's wrapper passes entry and phase pointers only in their
    mode (restart: neither; speculative: the entry, and the phase where
    phased), the MCU pattern's period and luma blocks, and a fresh output
    that the kernel covers whole (no zeroing on the host)."""
    from jpeg_tpu_torch.kernels import huffdec
    launched = []
    monkeypatch.setattr(huffdec, "on_cpu", lambda *t: False)
    monkeypatch.setattr(huffdec, "launch",
                        lambda name, device, *args: launched.append(
                            (name, args)))
    S, mw, nseg = 3, 5, 7
    streams = torch.zeros((S, mw), dtype=torch.int32)
    maxc = torch.zeros((64, S), dtype=torch.int32)
    hvp = torch.zeros((S, 256), dtype=torch.int32)
    rows = [torch.full((1, S), v, dtype=torch.int32) for v in (4, 9, 2)]
    nblk, entry, phase = rows
    kw = {} if mode == "restart" else dict(
        entry=entry, phase=phase, phased=mode == "phased")
    zz = huffdec.decode_segments(streams, maxc, maxc.clone(), hvp, nblk,
                                 sampling, nseg, mw, **kw)
    (name, args), = launched
    assert name == "decode_segments" and zz.shape == (S, nseg, 64)
    assert args[4] == nblk.data_ptr()
    assert args[5] == (None if mode == "restart" else entry.data_ptr())
    assert args[6] == (phase.data_ptr() if mode == "phased" else None)
    assert args[7] == zz.data_ptr()
    assert args[8:] == (S, mw, nseg, period, ypm)


@pytest.fixture
def fake_launch(monkeypatch):
    """``fused``'s launches recorded as (name, args), never run; stream
    handle 5; E's workspaces emptied."""
    launched = []
    monkeypatch.setattr(fused, "on_cpu", lambda *t: False)
    monkeypatch.setattr(fused, "launch",
                        lambda name, device, *args: launched.append(
                            (name, args)))
    monkeypatch.setattr(fused, "stream_handle", lambda index: 5)
    monkeypatch.setattr(fused, "_hist_work", {})
    return launched


@pytest.mark.parametrize("given_out", [False, True])
def test_place_hands_d_the_totals_and_its_output(fake_launch, given_out):
    """Kernel D's wrapper passes the fields, the offsets, C's totals and
    one output buffer (fresh, or the caller's ``out``), then S, the blocks
    a segment and the words a segment; no zeroing on the host."""
    S, nblk, sw = 3, 5, 384
    value = torch.zeros((S, nblk, 64), dtype=torch.int32).view(torch.uint32)
    nbits = torch.zeros((S, nblk, 64), dtype=torch.uint8)
    offs = torch.zeros((S, nblk), dtype=torch.int32)
    totals = torch.zeros(S, dtype=torch.int32)
    out = (torch.empty((S, sw), dtype=torch.int32).view(torch.uint32)
           if given_out else None)
    words = fused.place(value, nbits, offs, totals, sw, out=out)
    (name, args), = fake_launch
    assert name == "place" and words.shape == (S, sw)
    assert words.dtype == torch.uint32
    assert args == (value.data_ptr(), nbits.data_ptr(), offs.data_ptr(),
                    totals.data_ptr(), words.data_ptr(), S, nblk, sw)
    assert (words.data_ptr() == out.data_ptr()) if given_out else True


def test_place_refuses_bad_totals_buffers_and_out(fake_launch):
    """D's wrapper checks the totals and ``out``, and a words buffer below
    the worst case of 30 bits a slot, before any launch."""
    S, nblk = 2, 4
    value = torch.zeros((S, nblk, 64), dtype=torch.int32).view(torch.uint32)
    nbits = torch.zeros((S, nblk, 64), dtype=torch.uint8)
    offs = torch.zeros((S, nblk), dtype=torch.int32)
    totals = torch.zeros(S, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.place(value, nbits, offs, totals[:1], 384)
    with pytest.raises(ValueError):
        fused.place(value, nbits, offs, totals, 100)
    raw = torch.empty(S * 384 + 1, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        fused.place(value, nbits, offs, totals, 384,
                    out=raw[1:].view(S, 384))
    assert fake_launch == []


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_symbolize_fields_hands_e_its_workspace(fake_launch, masked,
                                                accumulate):
    """Kernel E's wrapper passes the coefficients, the mask (or None), its
    outputs (the caller's rows when accumulating), a workspace of a row
    and a counter per image kept zeroed per (device, stream) and grown on
    demand, then the images, segments an image, blocks a segment, the
    block pattern and the accumulate flag."""
    S, nblk, n = 4, 12, 2
    coef = torch.zeros((S, nblk, 64), dtype=torch.int16)
    mask = torch.ones(S // n * nblk, dtype=torch.uint8) if masked else None
    rows = torch.zeros((n, 1024), dtype=torch.int32) if accumulate else None
    pf, hist = fused.symbolize_fields(coef, n, mask, (4, 2), rows)
    (name, args), = fake_launch
    (key, work), = fused._hist_work.items()
    assert name == "symbolize_fields" and key == (None, 5)
    assert work.dtype == torch.int32 and not work.any()
    assert work.numel() >= n * 1025
    assert args == (coef.data_ptr(), mask.data_ptr() if masked else None,
                    pf.data_ptr(), hist.data_ptr(), work.data_ptr(), n,
                    S // n, nblk, 4, 2, int(accumulate))
    assert pf.shape == (S, nblk, 64) and hist.shape == (n, 1024)
    assert pf.is_contiguous() and hist.is_contiguous()
    assert (hist is rows) if accumulate else True
    many = torch.zeros((2000, 1, 64), dtype=torch.int16)
    fused.symbolize_fields(many, 2000, layout=(1, 1))
    assert fused._hist_work[key].numel() >= 2000 * 1025
    assert fake_launch[1][1][4] == fused._hist_work[key].data_ptr()


def test_symbolize_segments_hands_e_explicit_its_workspace(fake_launch):
    """E's explicit entry gets the coefficients, DC differences, luma
    flags, fresh outputs and the same workspace as E, then the images,
    segments an image and blocks a segment."""
    S, nblk, n = 6, 7, 3
    zz = torch.zeros((S, nblk, 64), dtype=torch.int16)
    dcd = torch.zeros((S, nblk), dtype=torch.int32)
    isl = torch.ones((S, nblk), dtype=torch.int32)
    pf, hist = fused.symbolize_segments(zz, dcd, isl, S, n)
    (name, args), = fake_launch
    (key, work), = fused._hist_work.items()
    assert name == "symbolize_fields_explicit"
    assert args == (zz.data_ptr(), dcd.data_ptr(), isl.data_ptr(),
                    pf.data_ptr(), hist.data_ptr(), work.data_ptr(), n,
                    S // n, nblk)
    assert pf.shape == (S, nblk, 64) and hist.shape == (n, 1024)
    assert work.numel() >= n * 1025 and not work.any()


def test_symbolize_fields_refuses_a_misaligned_hist(fake_launch):
    """E's last CTA adds to ``hist`` in 16-byte pieces: an accumulating
    ``hist`` off that boundary is refused before any launch."""
    coef = torch.zeros((2, 6, 64), dtype=torch.int16)
    raw = torch.zeros(2 * 1024 + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.symbolize_fields(coef, 2, hist=raw[1:].view(2, 1024))
    assert fake_launch == []


# kernels B, B explicit and F: (entry point, a call of the wrapper on
# zero inputs of [S, nblk] blocks with ``out``, the index of ``value``'s
# pointer among the entry point's arguments)
_FIELDS_WRAPPERS = {
    "symbolize_bits": (lambda S, nblk, out: fused.symbolize_bits(
        torch.zeros((S, nblk, 64), dtype=torch.int16),
        torch.zeros(1024, dtype=torch.int32), (3, 1), out=out), 2),
    "symbolize_bits_explicit": (lambda S, nblk, out:
                                fused.symbolize_bits_explicit(
        torch.zeros((S, nblk, 64), dtype=torch.int16),
        torch.zeros((S, nblk), dtype=torch.int32),
        torch.ones((S, nblk), dtype=torch.int32),
        torch.zeros(1024, dtype=torch.int32), out=out), 4),
    "attach_pf": (lambda S, nblk, out: fused.attach_pf(
        torch.zeros((S, nblk, 64), dtype=torch.int32),
        torch.zeros((S, 1024), dtype=torch.int32), out=out), 2),
}


def _fields_buffers(S: int, nblk: int, skip: int = 0):
    """A (value, nbits, bits) ``out`` triple; ``value`` starts ``skip``
    elements past the start of its own allocation."""
    value = torch.empty(S * nblk * 64 + skip, dtype=torch.int32)[skip:]
    return (value.view(torch.uint32).view(S, nblk, 64),
            torch.empty((S, nblk, 64), dtype=torch.uint8),
            torch.empty((S, nblk), dtype=torch.int32))


@pytest.mark.parametrize("given_out", [False, True])
@pytest.mark.parametrize("kernel", list(_FIELDS_WRAPPERS))
def test_fields_wrappers_hand_one_allocation_or_out(fake_launch, kernel,
                                                    given_out):
    """B's, B explicit's and F's wrappers hand their kernel value, nbits
    and bits as views of one fresh allocation (value first, 16-byte
    aligned, then nbits, then bits), or the caller's ``out`` triple as it
    is, then the shape arguments."""
    call, at = _FIELDS_WRAPPERS[kernel]
    S, nblk = 3, 6
    out = _fields_buffers(S, nblk) if given_out else None
    value, nbits, bits = call(S, nblk, out)
    (name, args), = fake_launch
    assert name == kernel
    assert args[at:at + 3] == (value.data_ptr(), nbits.data_ptr(),
                               bits.data_ptr())
    assert value.shape == nbits.shape == (S, nblk, 64)
    assert bits.shape == (S, nblk)
    assert (value.dtype, nbits.dtype, bits.dtype) == (
        torch.uint32, torch.uint8, torch.int32)
    assert value.data_ptr() % 16 == 0
    if given_out:
        assert all(a is b for a, b in zip((value, nbits, bits), out))
    else:
        base = value.untyped_storage().data_ptr()
        assert value.data_ptr() == base
        assert nbits.data_ptr() == base + 4 * S * nblk * 64
        assert bits.data_ptr() == base + 5 * S * nblk * 64
        assert nbits.untyped_storage().data_ptr() == base
        assert bits.untyped_storage().data_ptr() == base
        assert value.untyped_storage().nbytes() == 81 * 4 * S * nblk
    tail = args[at + 3:]
    assert tail == ({"symbolize_bits": (S, nblk, 3, 1),
                     "symbolize_bits_explicit": (S, nblk),
                     "attach_pf": (S, 1, nblk)}[kernel])


@pytest.mark.parametrize("fault", ["misaligned", "shape", "dtype",
                                   "strided"])
@pytest.mark.parametrize("kernel", list(_FIELDS_WRAPPERS))
def test_fields_wrappers_refuse_a_bad_out(fake_launch, kernel, fault):
    """A misaligned ``value`` (its 16-byte stores), a mis-shaped or
    mistyped buffer, or a strided one is refused before any launch."""
    call, _ = _FIELDS_WRAPPERS[kernel]
    S, nblk = 2, 4
    value, nbits, bits = _fields_buffers(
        S, nblk, skip=1 if fault == "misaligned" else 0)
    if fault == "shape":
        bits = torch.empty((S, nblk + 1), dtype=torch.int32)
    elif fault == "dtype":
        nbits = torch.empty((S, nblk, 64), dtype=torch.int32)
    elif fault == "strided":
        nbits = torch.empty((S, nblk, 128), dtype=torch.uint8)[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        call(S, nblk, (value, nbits, bits))
    assert fake_launch == []


@pytest.mark.parametrize("shared", [True, False])
def test_write_files_hands_i_outputs_and_workspace(monkeypatch, shared):
    """Kernel I's wrapper, its CUDA branch on CPU tensors: the pointers in
    the C entry point's order (no header offsets where every image shares
    one header, and then its length), a worst-case output buffer and int64
    bounds a call, the workspace sized by the source's rule (here a fake
    one) and zeroed once a (device, stream); bad inputs raise before any
    launch."""
    seen = []
    monkeypatch.setattr(kfiles, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kfiles, "launch",
                        lambda name, device, *args: seen.append((name, args)))
    monkeypatch.setattr(fused, "stream_handle", lambda index: 5)
    monkeypatch.setattr(kfiles, "_files_work", {})
    monkeypatch.setattr(kfiles, "_files_words", lambda n, w: 3 * n + 1)
    B, S, W = 3, 2, 8
    words = torch.zeros((B * S, W), dtype=torch.uint32)
    totals = torch.zeros(B * S, dtype=torch.int32)
    header = torch.arange(12, dtype=torch.uint8)
    offs = None if shared else torch.tensor([0, 4, 8, 12], dtype=torch.int32)
    data, bounds = kfiles.write_files(words, totals, header, offs, S)
    (name, args), = seen
    assert name == "write_files"
    assert args[:3] == (words.data_ptr(), totals.data_ptr(),
                        header.data_ptr())
    assert args[3] == (None if shared else offs.data_ptr())
    assert args[4:6] == (data.data_ptr(), bounds.data_ptr())
    assert args[7:] == ((12 if shared else 0), B, S, W)
    assert data.dtype == torch.uint8 and bounds.dtype == torch.int64
    assert bounds.shape == (B + 1,)
    assert data.numel() == kfiles.capacity(B, S, W, 12 * (B if shared else 1))
    (key, work), = kfiles._files_work.items()
    assert key == (None, 5) and args[6] == work.data_ptr()
    assert work.dtype == torch.int64 and not work.any()
    assert work.numel() >= 3 * B * S + 1
    for bad in (dict(words=words[:, :6].contiguous()),
                dict(words=words.view(torch.int32)),
                dict(totals=totals[:-1]),
                dict(n_segs=4),
                dict(header_offs=torch.zeros(B, dtype=torch.int32))):
        kw = dict(words=words, totals=totals, header=header,
                  header_offs=offs, n_segs=S) | bad
        with pytest.raises((TypeError, ValueError)):
            kfiles.write_files(**kw)
    assert len(seen) == 1
