"""The fields contract of kernels B and F, witnessed on the CPU: no
consumer reads the value of a slot whose nbits is 0.

On the card ``fused.symbolize_bits``, ``symbolize_bits_explicit`` and
``attach_pf`` write ``value`` only in the 16-byte groups that hold a slot
with non-zero nbits, and leave the other groups as the buffer had them;
their plain twins write 0 there.  Here the three wrappers are wrapped so
that every value slot whose nbits is 0 reads 0xFFFFFFFF, and each encoder
that packs through D (``FastBatchEncoder`` fixed and dynamic, with restart
segments; the 3-scan ``JpegEncoder.encode``, fixed and dynamic;
``encode_gray``; the f64 exact mode's K13 route and its dynamic route)
must give the same files as without the wrapper.  ``lut.attach`` and
``lut.attach_grouped``, which hand F's value to their callers, must still
equal the plain lookup.  No jax here."""
import numpy as np
import pytest
import torch

from jpeg_tpu_torch import (EncodeConfig, FastBatchEncoder, JpegEncoder,
                            encode_gray)
from jpeg_tpu_torch.kernels import fused, lut
from jpeg_tpu_torch.ops.color import SCAN_CHROMA, SCAN_Y
from jpeg_tpu_torch.pipelines.fast import host_constants

H = W = 64
WRAPPED = ("symbolize_bits", "symbolize_bits_explicit", "attach_pf")


def _images(seed: int) -> np.ndarray:
    """[2, 64, 64, 3] u8: a gradient, a block and noise per image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.empty((2, H, W, 3), np.uint8)
    for i in range(2):
        img = np.stack([xx * 3 + 20 * i, yy * 3, (xx + yy) * 2], -1)
        img[10:30, 20:50] = rng.integers(0, 256, 3)
        img = img + rng.normal(0, 8, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def _poison_null_values(monkeypatch) -> dict[str, list[int]]:
    """Wrap B, B explicit and F so that every value slot whose nbits is 0
    is all ones; returns each wrapper's list of the slots each call
    poisoned."""
    poisoned = {name: [] for name in WRAPPED}

    def wrap(name):
        real = getattr(fused, name)

        def call(*args, **kw):
            value, nbits, bits = real(*args, **kw)
            null = nbits == 0
            value.view(torch.int32)[null] = -1
            poisoned[name].append(int(null.sum()))
            return value, nbits, bits
        return call

    for name in WRAPPED:
        monkeypatch.setattr(fused, name, wrap(name))
    return poisoned


def _interleaved(huffman: str, dtype: str = "float32"):
    cfg = EncodeConfig(scan_layout="interleaved", huffman=huffman,
                       dtype=dtype, restart_interval_mcu_rows=2)
    return lambda imgs: FastBatchEncoder(H, W, cfg,
                                         device="cpu").encode_batch(imgs)


def _3scan(huffman: str):
    cfg = EncodeConfig(huffman=huffman)
    return lambda imgs: [JpegEncoder(cfg, device="cpu").encode(img)
                         for img in imgs]


def _gray(huffman: str):
    cfg = EncodeConfig(huffman=huffman)
    return lambda imgs: [encode_gray(np.ascontiguousarray(img[..., 1]), cfg,
                                     device="cpu") for img in imgs]


@pytest.mark.parametrize("encode,wrapper", [
    pytest.param(_interleaved("fixed"), "symbolize_bits", id="fast-fixed"),
    pytest.param(_interleaved("dynamic"), "attach_pf", id="fast-dynamic"),
    pytest.param(_3scan("fixed"), "symbolize_bits", id="3scan-fixed"),
    pytest.param(_3scan("dynamic"), "attach_pf", id="3scan-dynamic"),
    pytest.param(_gray("fixed"), "symbolize_bits", id="gray-fixed"),
    pytest.param(_gray("dynamic"), "attach_pf", id="gray-dynamic"),
    pytest.param(_interleaved("fixed", "float64"), "symbolize_bits_explicit",
                 id="f64-k13"),
    pytest.param(_interleaved("dynamic", "float64"), "attach_pf",
                 id="f64-dynamic"),
])
def test_files_ignore_values_of_null_slots(monkeypatch, encode, wrapper):
    imgs = _images(67)
    want = encode(imgs)
    poisoned = _poison_null_values(monkeypatch)
    got = encode(imgs)
    # the path went through the wrapper, and every call had NULL slots
    assert poisoned[wrapper] and min(poisoned[wrapper]) > 0
    assert got == want


def _scan_slots():
    """Slot arrays (idx, extra, extra_n) of the Y scans of two 64x64
    images, [2, 64 blocks * 64], and the images' dynamic LUTs."""
    from jpeg_tpu_torch.kernels import front
    c = {k: torch.from_numpy(v) for k, v in host_constants(None).items()}
    x = torch.from_numpy(_images(71)).reshape(2, H, W * 3)
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                           order="scan")
    pf, hist = fused.symbolize_fields(coef[:2 * 64].view(2, 64, 64), 2,
                                      layout=SCAN_Y)
    _, hist = fused.symbolize_fields(coef[2 * 64:].view(4, 16, 64), 2,
                                     layout=SCAN_CHROMA, hist=hist)
    _, luts = FastBatchEncoder._build_tables_batch(hist.numpy())
    return fused.unpack_fields(pf.view(2, -1)), torch.from_numpy(luts)


def _plain_lookup(table, idx, extra, extra_n):
    """The plain lookup of the LUT entries ``table`` [..., 1024] gathered
    at ``idx``: (value, nbits) int32."""
    entry = torch.gather(table, -1, idx)
    return (((entry & 0xFFFF) << extra_n) | extra,
            (entry >> 16) + extra_n)


@pytest.mark.parametrize("which", ["attach", "attach_grouped"])
def test_lut_attach_equals_plain_lookup(monkeypatch, which):
    """``lut.attach`` (one LUT) and ``lut.attach_grouped`` (a LUT per
    group) give the plain lookup's value and nbits, value 0 where nbits is
    0, with F's NULL values poisoned; on these LUTs (``build_combined_lut``
    gives entry 0 wherever the length is 0) that is the plain lookup
    itself."""
    (idx, extra, extra_n), luts = _scan_slots()
    fixed = torch.from_numpy(host_constants(None)["lut"])
    poisoned = _poison_null_values(monkeypatch)
    if which == "attach":
        tables = fixed.expand(2, 1024)
        value, nbits = lut.attach(fixed, idx, extra, extra_n)
    else:
        tables = luts
        value, nbits = lut.attach_grouped(luts, idx, extra, extra_n)
    assert poisoned["attach_pf"] and min(poisoned["attach_pf"]) > 0
    want_value, want_nbits = _plain_lookup(tables, idx, extra, extra_n)
    assert value.dtype == nbits.dtype == torch.int32
    assert torch.equal(nbits, want_nbits)
    assert torch.equal(value, want_value)
    assert not bool(value[nbits == 0].any())
