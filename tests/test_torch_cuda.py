"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip, with a reason, where no CUDA device is present; on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``; the
suite's conftest imports jax, which the card machine lacks) each kernel
must equal its plain twin exactly (in every layout and mode), and the
encoders' bytes must equal the CPU path's, in every Huffman mode.  ``chip_smoke.py`` runs the same
checks at full size.  No jax here."""
import numpy as np
import pytest
import torch

from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder, JpegEncoder
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)
from jpeg_tpu_torch.ops.color import SCAN_CHROMA, SCAN_Y
from jpeg_tpu_torch.ops.dct import set_exact_matmul

from chip_smoke import synthetic_batch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    set_exact_matmul()
    return torch.device("cuda", 0)


def _i32(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


@pytest.mark.parametrize("quality", [None, 75, 100])
def test_kernels_equal_plain_twins(dev, quality):
    cfg = EncodeConfig(scan_layout="interleaved", huffman="fixed",
                       quality=quality, restart_interval_mcu_rows=5)
    enc = FastBatchEncoder(160, 96, cfg, device=dev)
    imgs = synthetic_batch(np.random.default_rng(31), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    c = (enc._m, enc._bias, enc._ql, enc._qc)
    coef = front.front_dct(x, *c)
    assert torch.equal(coef, front.front_dct_plain(x, *c))
    coef = coef.view(4, -1, 64)
    fields = fused.symbolize_bits(coef, enc._lut)
    for a, b in zip(fields, fused.symbolize_bits_plain(coef, enc._lut)):
        assert torch.equal(_i32(a), _i32(b))
    offs = fused.segment_offsets(fields[2])
    for a, b in zip(offs, fused.segment_offsets_plain(fields[2])):
        assert torch.equal(a, b)
    sw = enc.seg_rows * 128
    assert torch.equal(
        _i32(fused.place(fields[0], fields[1], offs[0], sw)),
        _i32(fused.place_plain(fields[0], fields[1], offs[0], sw)))


@pytest.mark.parametrize("mode", ["dynamic", "dynamic-sampled"])
def test_dynamic_kernels_equal_plain_twins(dev, mode):
    cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                       restart_interval_mcu_rows=5)
    enc = FastBatchEncoder(160, 96, cfg, device=dev)
    imgs = synthetic_batch(np.random.default_rng(35), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    coef = front.front_dct(x, enc._m, enc._bias, enc._ql,
                           enc._qc).view(4, -1, 64)
    pf, hist = fused.symbolize_fields(coef, 2, enc._mask)
    want_pf, want_hist = fused.symbolize_fields_plain(coef, 2, enc._mask)
    assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    _, luts = enc._build_tables_batch(hist.cpu().numpy(),
                                      smooth=mode == "dynamic-sampled")
    luts = torch.from_numpy(luts).to(dev)
    for a, b in zip(fused.attach_pf(pf, luts),
                    fused.attach_pf_plain(pf, luts)):
        assert torch.equal(_i32(a), _i32(b))


@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_card_bytes_equal_cpu_bytes(dev, mode):
    imgs = synthetic_batch(np.random.default_rng(33), 2, 256, 160)
    cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                       restart_interval_mcu_rows=8)
    reset_launch_counts()
    got = FastBatchEncoder(256, 160, cfg, device=dev).encode_batch(imgs)
    path = (("symbolize_bits",) if mode == "fixed"
            else ("symbolize_fields", "attach_pf"))
    assert launch_counts() == {
        k: int(k in ("front_dct", "segment_offsets", "place") + path)
        for k in launch_counts()}
    want = FastBatchEncoder(256, 160, cfg, device="cpu").encode_batch(imgs)
    assert got == want
    assert np.all([len(f) > 0 for f in got])


def test_scan_layouts_and_gray_equal_plain_twins(dev):
    """A's 3-scan order and gray mode, and B and E in the single-component
    layouts (E accumulating the Cb + Cr counts into the Y launch's rows)."""
    enc = FastBatchEncoder(160, 96, EncodeConfig(scan_layout="interleaved",
                                                 huffman="fixed"), device=dev)
    c = (enc._m, enc._bias, enc._ql, enc._qc)
    imgs = synthetic_batch(np.random.default_rng(39), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    coef = front.front_dct(x, *c, order="scan")
    assert torch.equal(coef, front.front_dct_plain(x, *c, order="scan"))
    groups = ((coef[:480].view(2, 240, 64), SCAN_Y),
              (coef[480:].view(4, 60, 64), SCAN_CHROMA))
    hist = want_hist = None
    for cf, layout in groups:
        for a, b in zip(fused.symbolize_bits(cf, enc._lut, layout),
                        fused.symbolize_bits_plain(cf, enc._lut, layout)):
            assert torch.equal(_i32(a), _i32(b))
        pf, hist = fused.symbolize_fields(cf, 2, layout=layout, hist=hist)
        want_pf, want_hist = fused.symbolize_fields_plain(
            cf, 2, layout=layout, hist=want_hist)
        assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    plane = x[:, :, ::3].contiguous()
    assert torch.equal(front.front_dct_gray(plane, *c[:3]),
                       front.front_dct_gray_plain(plane, *c[:3]))


@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_3scan_encode_equals_cpu(dev, mode):
    img = synthetic_batch(np.random.default_rng(41), 1, 640, 640)[0]
    cfg = EncodeConfig(huffman=mode)
    reset_launch_counts()
    got = JpegEncoder(cfg, device=dev).encode(img)
    path = (("symbolize_bits",) if mode == "fixed"
            else ("symbolize_fields", "attach_pf"))
    assert launch_counts() == {
        k: 1 if k == "front_dct" else 2 * int(
            k in ("segment_offsets", "place") + path)
        for k in launch_counts()}
    reset_launch_counts()
    want = JpegEncoder(cfg, device="cpu").encode(img)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert got == want
