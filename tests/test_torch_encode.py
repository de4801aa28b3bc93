"""jpeg_tpu_torch.JpegEncoder, encode_jpeg and encode_gray against
jpeg_tpu.pipelines.encode on the CPU (the port through its kernels' plain
twins).  jpeg_tpu runs its "xla" engine, or its "pallas" engine, which
packs each scan with K14 (``lut.attach``) and K15 (``pack.pack_segments``)
in interpret mode.  Every comparison is exact equality: files are bytes,
fields and histograms integers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.core import tables as JT
from jpeg_tpu.core.types import Area as JaxArea
from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.kernels import lut as jlut
from jpeg_tpu.pipelines import encode as jencode
from jpeg_tpu_torch import (Area, EncodeConfig, JpegEncoder, encode_gray,
                            encode_jpeg)
from jpeg_tpu_torch.kernels import fused, front, launch_counts
from jpeg_tpu_torch.ops.color import SCAN_CHROMA, SCAN_Y
from jpeg_tpu_torch.pipelines.fast import host_constants
from jpeg_tpu_torch.utils.guards import validate_encode_inputs

from test_torch_ops import synthetic_images

MODES = ["fixed", "dynamic", "dynamic-sampled"]


@pytest.fixture(scope="module")
def jax_files():
    """jpeg_tpu's file per (what, H, W, config kwargs), cached."""
    cache = {}

    def get(what, h, w, seed=3, **kw):
        key = (what, h, w, seed, tuple(sorted(kw.items())))
        if key not in cache:
            if what == "gray":
                plane = synthetic_images(seed, 1, h, w)[0, :, :, 1]
                cache[key] = jencode.encode_gray(plane, JaxConfig(**kw))
            else:
                img = synthetic_images(seed, 1, h, w)[0]
                cache[key] = jencode.JpegEncoder(JaxConfig(**kw)).encode(img)
        return cache[key]
    return get


def _port(h, w, seed=3, **kw):
    img = synthetic_images(seed, 1, h, w)[0]
    return JpegEncoder(EncodeConfig(**kw), device="cpu").encode(img)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("quality", [None, 75])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h,w", [(64, 64), (160, 96)])
def test_3scan_matches(jax_files, h, w, mode, quality, engine):
    kw = dict(huffman=mode, quality=quality, engine=engine)
    got = _port(h, w, **kw)
    assert got == jax_files("rgb", h, w, **kw)
    assert got.count(b"\xff\xda") == 3  # three single-component scans


@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
@pytest.mark.parametrize("rows", [2, 4])
def test_3scan_restarts_match(jax_files, rows, mode):
    kw = dict(huffman=mode, restart_interval_mcu_rows=rows)
    got = _port(128, 128, **kw)
    assert got == jax_files("rgb", 128, 128, **kw)
    # per-scan DRI: Y has 16 / rows segments, Cb and Cr 8 / rows each
    n_dri = got.count(b"\xff\xdd\x00\x04")
    assert n_dri == (3 if rows < 8 else 1)
    rst = sum(got.count(bytes([0xFF, 0xD0 + i])) for i in range(8))
    assert rst == (16 // rows - 1) + 2 * (8 // rows - 1)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_interleaved_restarts_match(jax_files, mode, engine):
    kw = dict(scan_layout="interleaved", huffman=mode,
              restart_interval_mcu_rows=2, engine=engine)
    got = _port(128, 128, **kw)
    assert got == jax_files("rgb", 128, 128, **kw)


def test_interleaved_sampled_tables_follow_the_engine(jax_files):
    """The Pallas engine samples, the XLA engine builds exact tables."""
    kw = dict(scan_layout="interleaved", huffman="dynamic-sampled",
              restart_interval_mcu_rows=2)
    pallas = _port(128, 128, engine="pallas", **kw)
    xla = _port(128, 128, engine="xla", **kw)
    assert pallas != xla
    assert xla == _port(128, 128, **dict(kw, huffman="dynamic"))
    # "auto" is "xla" on the CPU
    assert _port(128, 128, **kw) == xla


@pytest.mark.parametrize("layout", ["3scan", "interleaved"])
def test_encode_any_matches(layout):
    img = synthetic_images(7, 1, 80, 112)[0, :75, :100]
    cfg = dict(scan_layout=layout, huffman="dynamic")
    want = jencode.JpegEncoder(JaxConfig(**cfg)).encode_any(img)
    enc = JpegEncoder(EncodeConfig(**cfg), device="cpu")
    got = enc.encode_any(img)
    assert got == want
    assert got.count(b"\xff\xda") == 1  # padded: the interleaved layout
    assert enc.encode_any(torch.from_numpy(img)) == want
    if layout == "3scan":
        assert enc._any_encoder.config.scan_layout == "interleaved"
        assert enc._any_encoder.config.restart_interval_mcu_rows == 0
    # an aligned image keeps the configured layout
    aligned = synthetic_images(7, 1, 64, 64)[0]
    assert enc.encode_any(aligned) == \
        jencode.JpegEncoder(JaxConfig(**cfg)).encode(aligned)


def test_encode_region_matches():
    frame = synthetic_images(9, 1, 128, 128)[0]
    cfg = dict(huffman="dynamic")
    want = jencode.JpegEncoder(JaxConfig(**cfg)).encode_region(
        frame, JaxArea(16, 32, 64, 48))
    got = JpegEncoder(EncodeConfig(**cfg), device="cpu").encode_region(
        frame, Area(16, 32, 64, 48))
    assert got == want


@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
@pytest.mark.parametrize("h,w", [(64, 64), (70, 45)])
def test_encode_gray_matches(jax_files, h, w, mode):
    plane = synthetic_images(3, 1, h, w)[0, :, :, 1]
    got = encode_gray(plane, EncodeConfig(huffman=mode), device="cpu")
    assert got == jax_files("gray", h, w, huffman=mode)
    assert got.count(b"\xff\xda") == 1


@pytest.mark.parametrize("layout", ["3scan", "interleaved"])
def test_encode_batch_matches_per_image_loop(layout):
    imgs = synthetic_images(11, 2, 64, 96)
    cfg = dict(scan_layout=layout, huffman="dynamic", quality=75)
    want = jencode.JpegEncoder(JaxConfig(**cfg)).encode_batch(imgs)
    enc = JpegEncoder(EncodeConfig(**cfg), device="cpu")
    assert enc.encode_batch(imgs) == want
    assert [enc.encode(i) for i in imgs] == want
    assert enc.encode_batch(imgs[:0]) == []


def test_encode_jpeg_matches():
    img = synthetic_images(13, 1, 64, 64)[0]
    assert encode_jpeg(img, device="cpu") == jencode.encode_jpeg(img)
    cfg = EncodeConfig(huffman="fixed", quality=50)
    assert encode_jpeg(img, cfg, device="cpu") == jencode.encode_jpeg(
        img, JaxConfig(huffman="fixed", quality=50))


def test_cpu_encoder_launches_no_kernel():
    from jpeg_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()
    _port(64, 64, huffman="dynamic", restart_interval_mcu_rows=2)
    encode_gray(np.zeros((16, 16), np.uint8), device="cpu")
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


# -- stage by stage: A -> B / E in the 3-scan layout, at 160x96 -------------


@pytest.mark.parametrize("quality", [None, 75])
def test_3scan_fields_and_histograms_match_analyze_fn(quality):
    """A (scan order) and E (single-component layouts) against
    ``analyze_fn``: each component's slots (sym, valid, extra, extra_n,
    mapped through slot_index) and the four histograms."""
    img = synthetic_images(17, 1, 160, 96)[0]
    lq, cq = JT.quant_tables(quality)
    slots, hists = jencode.analyze_fn(jnp.asarray(img), jnp.asarray(lq),
                                      jnp.asarray(cq))
    c = {k: torch.from_numpy(v) for k, v in host_constants(quality).items()}
    x = torch.from_numpy(img.reshape(1, 160, 96 * 3))
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                           order="scan")
    n_y = 20 * 12
    cy, cc = coef[:n_y].view(1, n_y, 64), coef[n_y:].view(2, n_y // 4, 64)
    pf_y, hist = fused.symbolize_fields(cy, 1, layout=SCAN_Y)
    pf_c, hist = fused.symbolize_fields(cc, 1, layout=SCAN_CHROMA, hist=hist)
    for pf, names, luma in ((pf_y, ("y",), True), (pf_c, ("cb", "cr"), False)):
        idx, extra, extra_n = (t.numpy() for t in fused.unpack_fields(pf))
        for i, name in enumerate(names):
            s = {k: np.asarray(v) for k, v in slots[name].items()}
            is_dc = np.zeros(s["sym"].shape, bool)
            is_dc[..., 0] = True
            want = np.asarray(jlut.slot_index(
                jnp.asarray(s["sym"]), jnp.asarray(s["valid"]),
                jnp.asarray(is_dc), jnp.full(is_dc.shape, luma)))
            np.testing.assert_array_equal(idx[i], want)
            np.testing.assert_array_equal(extra[i],
                                          np.where(s["valid"], s["extra"], 0))
            np.testing.assert_array_equal(
                extra_n[i], np.where(s["valid"], s["extra_n"], 0))
    h = hist.numpy()[0].reshape(4, 256)  # chroma AC, chroma DC, luma AC, DC
    for got, want in zip((h[3], h[2], h[1], h[0]), hists):
        np.testing.assert_array_equal(got, np.asarray(want))
    # B in the same layouts: its fields equal F's through the fixed LUT
    for cf, pf, layout in ((cy, pf_y, SCAN_Y), (cc, pf_c, SCAN_CHROMA)):
        b_out = fused.symbolize_bits(cf, c["lut"], layout)
        f_out = fused.attach_pf(pf, c["lut"][None])
        for a, b in zip(b_out, f_out):
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                               else a, b.view(torch.int32)
                               if b.dtype == torch.uint32 else b)


def test_gray_blocks_match_analyze_gray():
    plane = synthetic_images(19, 1, 64, 96)[0, :, :, 0]
    lq, _ = JT.quant_tables(None)
    slots, hists = jencode._analyze_gray_fn(jnp.asarray(plane),
                                            jnp.asarray(lq))
    c = {k: torch.from_numpy(v) for k, v in host_constants(None).items()}
    coef = front.front_dct_gray(torch.from_numpy(plane)[None], c["m"],
                                c["bias"], c["ql"])
    pf, hist = fused.symbolize_fields(coef, 1, layout=SCAN_Y)
    idx = fused.unpack_fields(pf)[0].numpy()[0]
    sym = idx & 255
    valid = np.asarray(slots["valid"])
    np.testing.assert_array_equal(idx == 1023, ~valid)
    np.testing.assert_array_equal(np.where(valid, sym, 0),
                                  np.where(valid, np.asarray(slots["sym"]), 0))
    h = hist.numpy()[0]
    np.testing.assert_array_equal(h[768:], np.asarray(hists[0]))
    np.testing.assert_array_equal(h[512:768], np.asarray(hists[1]))
    assert not h[:512].any()


# -- errors -------------------------------------------------------------------


def port_message(message: str) -> str:
    """jpeg_tpu's message as the port words it: the port's errors name its
    own copy of the padding tool."""
    return message.replace("jpeg_tpu.io.editimage",
                           "jpeg_tpu_torch.io.editimage")


def _both_raise(exc, jax_call, port_call):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == port_message(str(want.value))


@pytest.mark.parametrize("shape", [(72, 64, 3), (64, 40, 3), (0, 64, 3),
                                   (64, 0, 3)])
def test_shape_errors_match(shape):
    img = np.zeros(shape, np.uint8)
    _both_raise(ValueError, lambda: jencode.JpegEncoder().encode(img),
                lambda: JpegEncoder(device="cpu").encode(img))


@pytest.mark.parametrize("layout,rows,h", [("3scan", 3, 128),  # y: 16 rows
                                           ("3scan", 4, 96),   # cb: 6 rows
                                           ("interleaved", 3, 128)])
def test_restart_errors_match(layout, rows, h):
    img = np.zeros((h, 64, 3), np.uint8)
    kw = dict(scan_layout=layout, restart_interval_mcu_rows=rows)
    _both_raise(ValueError,
                lambda: jencode.JpegEncoder(JaxConfig(**kw)).encode(img),
                lambda: JpegEncoder(EncodeConfig(**kw),
                                    device="cpu").encode(img))


def test_area_errors_match():
    frame = np.zeros((128, 128, 3), np.uint8)
    _both_raise(ValueError,
                lambda: jencode.JpegEncoder().encode_region(
                    frame, JaxArea(96, 0, 64, 32)),
                lambda: JpegEncoder(device="cpu").encode_region(
                    frame, Area(96, 0, 64, 32)))
    for bad in ((0, 0, 24, 16), (-16, 0, 16, 16)):
        _both_raise(ValueError, lambda: JaxArea(*bad), lambda: Area(*bad))


def test_gray_shape_errors_match():
    for plane in (np.zeros((8, 8, 3), np.uint8), np.zeros((0, 8), np.uint8)):
        _both_raise(ValueError, lambda: jencode.encode_gray(plane),
                    lambda: encode_gray(plane, device="cpu"))


@pytest.mark.parametrize("kw", [dict(subsampling="422"),
                                dict(subsampling="444")])
def test_other_subsamplings_match_jax(kw):
    """4:2:2 and 4:4:4 through ``JpegEncoder`` and ``encode_jpeg`` (more
    in ``test_torch_sampling.py``)."""
    img = synthetic_images(27, 1, 32, 32)[0]
    want = jencode.JpegEncoder(JaxConfig(**kw)).encode(img)
    assert JpegEncoder(EncodeConfig(**kw), device="cpu").encode(img) == want
    assert encode_jpeg(img, EncodeConfig(**kw), device="cpu") == want
    # a grayscale plane has no chroma: subsampling plays no part
    gray = np.zeros((16, 16), np.uint8)
    assert encode_gray(gray, EncodeConfig(**kw), device="cpu") == \
        jencode.encode_gray(gray, JaxConfig(**kw))


def test_cuda_encoder_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JpegEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_gray(np.zeros((8, 8), np.uint8))


# -- debug_checks (utils.guards) ------------------------------------------------


def test_debug_checks_pass_on_a_clean_image():
    img = synthetic_images(21, 1, 64, 64)[0]
    cfg = dict(debug_checks=True, huffman="fixed")
    got = JpegEncoder(EncodeConfig(**cfg), device="cpu").encode(img)
    assert got == jencode.JpegEncoder(JaxConfig(**cfg)).encode(img)


def test_debug_check_messages_match():
    from jpeg_tpu.utils import guards as jguards
    from jpeg_tpu_torch.core import tables as T
    img = np.full((16, 16, 3), 255, np.uint8)
    lq, cq = T.quant_tables(None)
    zero_q = lq.copy()
    zero_q.reshape(-1)[0] = 0
    with pytest.raises(Exception) as want:
        jguards.validate_encode_inputs(img, zero_q, cq)
    with pytest.raises(ValueError) as got:
        validate_encode_inputs(img, zero_q, cq)
    assert str(got.value) == "quantizer entries must be >= 1 (divide hazard)"
    assert str(got.value) in str(want.value)


@pytest.mark.parametrize("scale,message", [
    (float("nan"), "non-finite DCT coefficients"),
    (4.0, "coefficient overflow: the [-2048, 2047] clip engaged")])
def test_debug_checks_raise(monkeypatch, scale, message):
    """A broken DCT basis (NaN, or scaled past the clip at quantizer 1)."""
    from jpeg_tpu_torch.core import tables as T
    basis = T.dct_flat_basis
    monkeypatch.setattr(T, "dct_flat_basis",
                        lambda: (basis()[0] * scale, basis()[1]))
    img = np.full((16, 16, 3), 255, np.uint8)
    ones = np.ones((8, 8), np.int32)
    with pytest.raises(ValueError) as got:
        validate_encode_inputs(img, ones, ones)
    assert str(got.value) == message
    cfg = EncodeConfig(debug_checks=True, quality=100)  # quantizers 1
    with pytest.raises(ValueError) as got:
        JpegEncoder(cfg, device="cpu").encode(img)
    assert str(got.value) == message
