"""The f64 exact mode of jpeg_tpu_torch against jpeg_tpu and the golden
encoder, on the CPU (the port through its kernels' plain twins).

* the f64 color planes and exact DCT coefficients against jpeg_tpu's
  ``rgb_to_ycbcr_420(dtype=float64)`` and ``dct_quantize_zigzag(exact=True)``
  run un-jitted, and against the golden encoder's stages;
* ``kernels.fused.analyze_attach_pack_segments`` (kernel B explicit, C, D)
  against jpeg_tpu's K13, ``symbolize_segments`` (E explicit) against K12
  and ``hist_1024_t``, and ``attach_pack_segments`` (F, C, D) against
  K18b, each jpeg_tpu kernel in interpret mode;
* ``FastBatchEncoder``, ``JpegEncoder``, ``encode_jpeg`` and
  ``encode_gray`` with ``dtype="float64"`` against the golden encoder and
  jpeg_tpu's un-jitted f64 ``JpegEncoder`` (jpeg_tpu's jitted f64
  ``FastBatchEncoder`` is no reference: XLA:CPU contracts its mul+add
  into FMAs, and on the probe batch below one Y and one Cb coefficient of
  image 0 differ from the golden encoder's).

Every comparison is exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.bitstream import jfif as jjfif
from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.golden import encoder as jgolden
from jpeg_tpu.kernels import fused as jfused
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.pipelines import encode as jencode
from jpeg_tpu.pipelines.fast import hist_1024_t
from jpeg_tpu_torch import (Area, EncodeConfig, FastBatchEncoder, JpegEncoder,
                            encode_gray, encode_jpeg)
from jpeg_tpu_torch.core import tables as T
from jpeg_tpu_torch.huffman.build import build_tables_batch
from jpeg_tpu_torch.kernels import fused, launch_counts, reset_launch_counts
from jpeg_tpu_torch.kernels.lut import NULL_INDEX, build_combined_lut
from jpeg_tpu_torch.kernels.pack import rows_per_segment
from jpeg_tpu_torch.ops import color, dct

from test_torch_ops import synthetic_images


def probe_batch():
    """The second (2, 64, 64, 3) u8 draw of ``default_rng(0)``: jpeg_tpu's
    jitted f64 FastBatchEncoder misses the golden bytes on its image 0."""
    rng = np.random.default_rng(0)
    rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


# -- (a) color planes and exact coefficients ----------------------------------


@pytest.mark.parametrize("quality", [None, 75])
def test_color_and_exact_dct_match(monkeypatch, quality):
    imgs = np.concatenate([synthetic_images(51, 1, 64, 64),
                           probe_batch()[:1]])
    monkeypatch.setattr(dct, "EXACT_CHUNK", 97)  # several ragged passes
    lq, cq = T.quant_tables(quality)
    got = color.rgb_to_ycbcr_420(torch.from_numpy(imgs), dtype=torch.float64)
    want = jcolor.rgb_to_ycbcr_420(jnp.asarray(imgs), dtype=jnp.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b, img in enumerate(imgs):
        y, cb, cr = jgolden.rgb_to_ycbcr(img)
        golden = (y, jgolden.subsample_chroma(cb),
                  jgolden.subsample_chroma(cr))
        for g, w in zip(got, golden):
            np.testing.assert_array_equal(g[b].numpy(), w)
    for plane, q in zip(got, (lq, cq, cq)):
        zz = dct.dct_quantize_exact(color.to_blocks(plane), q)
        assert zz.dtype == torch.int16 and zz.shape[-1] == 64
        want = jdct.dct_quantize_zigzag(
            jcolor.to_blocks(jnp.asarray(plane.numpy())), jnp.asarray(q),
            dtype=jnp.float64, exact=True)
        np.testing.assert_array_equal(zz.numpy(), np.asarray(want))
        for b in range(plane.shape[0]):
            blocks = jgolden.to_blocks(plane[b].numpy())
            golden = jgolden.zigzag(jgolden.quantize(
                jgolden.dct_blocks(blocks), q))
            np.testing.assert_array_equal(zz[b].numpy(), golden)


# -- (b, c) the K13, K12 and K18b counterparts --------------------------------

S, NBLK, N_IMAGES = 4, 150, 2  # 150 blocks: not a multiple of 128


def _full_lut():
    """A combined LUT with a code for every symbol (all-ones histograms),
    so DC class 12 (differences of +-2048..4095) has one too."""
    names = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
    return build_combined_lut(dict(zip(
        names, build_tables_batch(np.ones((4, 257), np.int64)))))


def _explicit_inputs(padding: bool):
    """Random in-range zz (sparse ACs, so runs, ZRL and EOB all occur; a
    garbage DC slot), DC differences including +-4095 and luma flags."""
    rng = np.random.default_rng(61 + padding)
    zz = rng.integers(-2048, 2048, (S, NBLK, 64), dtype=np.int32)
    keep = rng.random((S, NBLK, 64)) < rng.choice([0.03, 0.2, 0.9],
                                                  (S, NBLK, 1))
    zz = np.where(keep, zz, 0).astype(np.int32)
    zz[..., 0] = rng.integers(-3000, 3000, (S, NBLK))  # ignored
    zz[0, 3, 1:] = 0                       # DC only
    zz[0, 4, 1:] = 0
    zz[0, 4, 63] = -1                      # EOB absent, many ZRLs
    zz[1, 5, 1:] = 2047
    zz[1, 6, 1:] = -2048
    dcd = rng.integers(-4095, 4096, (S, NBLK)).astype(np.int32)
    dcd[:, :4] = [[4095, -4095, 0, -1]]
    isl = rng.integers(0, 2, (S, NBLK)).astype(np.int32)
    if padding:
        isl[1, 100:120] = -1
        isl[3, -7:] = -1
    return zz, dcd, isl


@pytest.fixture(scope="module")
def explicit_ref():
    """Inputs and jpeg_tpu's K13, K12 (+ hist_1024_t) outputs per case."""
    lut = _full_lut()
    seg_rows = rows_per_segment(NBLK * 64)
    cache = {}

    def get(padding):
        if padding not in cache:
            zz, dcd, isl = _explicit_inputs(padding)
            args = tuple(map(jnp.asarray, (zz, dcd, isl)))
            words, totals = jfused.analyze_attach_pack_segments(
                jnp.asarray(lut), *args, S, seg_rows, interpret=True)
            idx_t, extra_t, extran_t, npad = jfused.symbolize_segments(
                *args, S, interpret=True)
            hist = hist_1024_t(idx_t, N_IMAGES)

            def fields(t):  # [64, S * npad] -> [S, NBLK, 64]
                return np.asarray(t).T.reshape(S, npad, 64)[:, :NBLK]
            cache[padding] = dict(
                zz=zz, dcd=dcd, isl=isl, words=np.asarray(words),
                totals=np.asarray(totals), hist=np.asarray(hist),
                fields=tuple(map(fields, (idx_t, extra_t, extran_t))))
        return cache[padding]
    return lut, seg_rows, get


def _torch_inputs(ref, dtype=torch.int16):
    return (torch.from_numpy(ref["zz"]).to(dtype),
            torch.from_numpy(ref["dcd"]), torch.from_numpy(ref["isl"]))


def _used_words_equal(words, totals, want_words):
    for s, t in enumerate(totals):
        n = (int(t) + 31) // 32
        np.testing.assert_array_equal(words[s, :n], want_words[s, :n])


@pytest.mark.parametrize("zz_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("padding", [False, True], ids=["flags", "padding"])
def test_analyze_attach_pack_segments_matches_k13(explicit_ref, padding,
                                                  zz_dtype):
    lut, seg_rows, get = explicit_ref
    ref = get(padding)
    reset_launch_counts()
    words, totals = fused.analyze_attach_pack_segments(
        torch.from_numpy(lut), *_torch_inputs(ref, zz_dtype), S, seg_rows)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert words.dtype == torch.uint32 and words.shape == (S, seg_rows * 128)
    np.testing.assert_array_equal(totals.numpy(), ref["totals"])
    _used_words_equal(words.view(torch.int32).numpy().view(np.uint32),
                      ref["totals"], ref["words"])


@pytest.mark.parametrize("padding", [False, True], ids=["flags", "padding"])
def test_symbolize_segments_matches_k12_and_hist(explicit_ref, padding):
    _, _, get = explicit_ref
    ref = get(padding)
    pf, hist = fused.symbolize_segments(*_torch_inputs(ref), S, N_IMAGES)
    assert pf.shape == (S, NBLK, 64) and hist.shape == (N_IMAGES, 1024)
    for got, want in zip(fused.unpack_fields(pf), ref["fields"]):
        np.testing.assert_array_equal(got.numpy(), want)
    if padding:  # every slot of a padding block is NULL, DC included
        assert np.all(ref["fields"][0][ref["isl"] < 0] == NULL_INDEX)
    np.testing.assert_array_equal(hist.numpy()[:, :1023],
                                  ref["hist"][:, :1023])
    assert not hist[:, 1023].any()  # NULL slots are not counted
    # the explicit plain twins restate the layout twins where the flags
    # and differences follow the interleaved pattern
    coef = torch.from_numpy(ref["zz"]).to(torch.int16)
    dcd = dct.dc_diff(coef)
    isl = dct.is_luma_block(NBLK, "cpu").to(torch.int32).expand(S, NBLK)
    got = fused.symbolize_segments(coef, dcd, isl.contiguous(), S, 2)
    want = fused.symbolize_fields(coef, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_attach_pack_segments_matches_k18b(explicit_ref):
    lut, seg_rows, get = explicit_ref
    ref = get(True)
    idx, extra, extra_n = fused.unpack_fields(
        fused.symbolize_segments(*_torch_inputs(ref), S, N_IMAGES)[0])
    words, totals = fused.attach_pack_segments(
        torch.from_numpy(lut), idx, extra, extra_n, S, seg_rows)
    jwords, jtotals = jfused.attach_pack_segments(
        jnp.asarray(lut), *(jnp.asarray(t.numpy())
                            for t in (idx, extra, extra_n)),
        S, seg_rows, interpret=True)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jtotals))
    np.testing.assert_array_equal(totals.numpy(), ref["totals"])
    got = words.view(torch.int32).numpy().view(np.uint32)
    _used_words_equal(got, np.asarray(jtotals), np.asarray(jwords))
    _used_words_equal(got, ref["totals"], ref["words"])


def test_explicit_inputs_are_checked():
    zz = torch.zeros((2, 6, 64), dtype=torch.int32)
    dcd = torch.zeros((2, 6), dtype=torch.int32)
    isl = torch.ones((2, 6), dtype=torch.int32)
    zz[1, 2, 5] = 40000
    with pytest.raises(ValueError, match="exceed int16"):
        fused._explicit_inputs("k", zz, dcd, isl)
    zz[1, 2, 5] = 0
    zz[1, 2, 0] = 40000  # the DC slot is ignored
    assert fused._explicit_inputs("k", zz, dcd, isl).dtype == torch.int16
    with pytest.raises(TypeError, match="dc_diff"):
        fused._explicit_inputs("k", zz, dcd.to(torch.int64), isl)
    with pytest.raises(ValueError, match="n_segments=3"):
        fused.analyze_attach_pack_segments(
            torch.zeros(1024, dtype=torch.int32), zz, dcd, isl, 3, 2)
    with pytest.raises(ValueError, match="n_segments=3"):
        fused.symbolize_segments(zz, dcd, isl, 3, 1)


# -- (d) FastBatchEncoder -----------------------------------------------------


def _golden(img, **kw):
    return jgolden.encode(img, **kw)


def _jax_encode(img, **kw):
    return jencode.JpegEncoder(JaxConfig(dtype="float64", **kw)).encode(img)


@pytest.mark.parametrize("rows", [0, 2], ids=["1seg", "2seg"])
@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
def test_fast_batch_encoder_f64_matches(mode, rows):
    imgs = probe_batch()
    cfg = dict(scan_layout="interleaved", huffman=mode,
               restart_interval_mcu_rows=rows)
    enc = FastBatchEncoder(64, 64, EncodeConfig(dtype="float64", **cfg),
                           device="cpu")
    assert enc.n_segs == (2 if rows else 1)
    files = enc.encode_batch(imgs)
    for img, got in zip(imgs, files):
        assert got == _golden(img, **cfg)
        assert got == _jax_encode(img, **cfg)
    if mode == "fixed":
        words, totals = enc.step(imgs)
        assert words.shape == (2, enc.n_segs, enc.seg_rows * 128)
        assert totals.shape == (2, enc.n_segs)


def test_fast_batch_encoder_f64_synthetic_restarts():
    imgs = synthetic_images(53, 2, 128, 96)
    cfg = dict(scan_layout="interleaved", huffman="dynamic",
               restart_interval_mcu_rows=4)
    files = FastBatchEncoder(128, 96, EncodeConfig(dtype="float64", **cfg),
                             device="cpu").encode_batch(imgs)
    for img, got in zip(imgs, files):
        assert got == _golden(img, **cfg)


# -- (e) JpegEncoder, encode_jpeg, encode_gray --------------------------------


@pytest.mark.parametrize("kw", [
    dict(quality=None), dict(quality=75), dict(huffman="fixed"),
    dict(huffman="dynamic-sampled"),
    dict(scan_layout="interleaved"),
    dict(scan_layout="interleaved", huffman="dynamic-sampled"),
    dict(scan_layout="interleaved", restart_interval_mcu_rows=2),
    dict(restart_interval_mcu_rows=2),
], ids=["3scan", "3scan-q75", "3scan-fixed", "3scan-sampled", "interleaved",
        "interleaved-sampled", "interleaved-r2", "3scan-r2"])
def test_jpeg_encoder_f64_matches(kw):
    img = synthetic_images(55, 1, 64, 64)[0]
    got = JpegEncoder(EncodeConfig(dtype="float64", **kw),
                      device="cpu").encode(img)
    assert got == _jax_encode(img, **kw)
    golden_kw = dict(quality=kw.get("quality"),
                     scan_layout=kw.get("scan_layout", "3scan"),
                     restart_interval_mcu_rows=kw.get(
                         "restart_interval_mcu_rows", 0),
                     huffman="fixed" if kw.get("huffman") == "fixed"
                     else "dynamic")
    if golden_kw["scan_layout"] == "3scan" and \
            golden_kw["restart_interval_mcu_rows"]:
        assert got.count(b"\xff\xdd\x00\x04") == 3  # no golden 3-scan DRI
    else:
        assert got == _golden(img, **golden_kw)


def test_jpeg_encoder_f64_other_entry_points():
    cfg = EncodeConfig(dtype="float64")
    enc = JpegEncoder(cfg, device="cpu")
    imgs = synthetic_images(57, 2, 64, 64)
    assert enc.encode_batch(imgs) == [_golden(i) for i in imgs]
    assert encode_jpeg(imgs[1], cfg, device="cpu") == _golden(imgs[1])
    frame = synthetic_images(59, 1, 96, 128)[0]
    area = Area(32, 16, 64, 64)
    assert enc.encode_region(frame, area) == _golden(frame[16:80, 32:96])
    odd = frame[:60, :50]
    got = enc.encode_any(odd)
    assert got == jencode.JpegEncoder(JaxConfig(dtype="float64")) \
        .encode_any(odd)
    padded = np.pad(odd, ((0, 4), (0, 14), (0, 0)), mode="edge")
    assert got == jjfif.patch_sof_dims(
        _golden(padded, scan_layout="interleaved"), 50, 60)


@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
def test_encode_gray_f64_matches(mode):
    plane = synthetic_images(63, 1, 60, 60)[0, :, :, 2]
    cfg = dict(dtype="float64", huffman=mode)
    got = encode_gray(plane, EncodeConfig(**cfg), device="cpu")
    assert got == jencode.encode_gray(plane, JaxConfig(**cfg))
    # its coefficients are the golden encoder's stages
    padded = np.pad(plane, ((0, 4), (0, 4)), mode="edge")
    lq, _ = T.quant_tables(None)
    zz = dct.dct_quantize_exact(color.to_blocks(torch.from_numpy(padded)), lq)
    np.testing.assert_array_equal(zz.numpy(), jgolden.zigzag(jgolden.quantize(
        jgolden.dct_blocks(jgolden.to_blocks(padded)), lq)))


# -- (f) what stays refused ---------------------------------------------------


def test_f64_dynamic_sampled_batch_encoder_raises_like_jpeg_tpu():
    from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
    cfg = dict(scan_layout="interleaved", huffman="dynamic-sampled",
               dtype="float64")
    with pytest.raises(ValueError) as want:
        JaxEncoder(64, 64, JaxConfig(**cfg), interpret=True)
    with pytest.raises(ValueError) as got:
        FastBatchEncoder(64, 64, EncodeConfig(**cfg), device="cpu")
    assert str(got.value) == str(want.value)
    # the pallas engine hands the same config to the batch encoder
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError) as got:
        JpegEncoder(EncodeConfig(engine="pallas", **cfg),
                    device="cpu").encode(img)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sampling", ["422", "444"])
def test_f64_with_other_subsampling_matches(sampling):
    """f64 at 4:2:2 and 4:4:4 against jpeg_tpu's un-jitted f64
    ``JpegEncoder`` (the golden encoder is 4:2:0 only): ``JpegEncoder``
    and ``encode_jpeg`` in the 3-scan layout, and ``FastBatchEncoder``'s
    exact mode with a restart every MCU row against the interleaved
    layout."""
    img = synthetic_images(57, 1, 32, 32)[0]
    cfg = dict(dtype="float64", subsampling=sampling)
    want = jencode.JpegEncoder(JaxConfig(**cfg)).encode(img)
    assert JpegEncoder(EncodeConfig(**cfg), device="cpu").encode(img) == want
    assert encode_jpeg(img, EncodeConfig(**cfg), device="cpu") == want
    kw = dict(cfg, scan_layout="interleaved", restart_interval_mcu_rows=1)
    want = jencode.JpegEncoder(JaxConfig(**kw)).encode(img)
    got = FastBatchEncoder(32, 32, EncodeConfig(**kw),
                           device="cpu").encode_batch(img[None])
    assert got == [want]
