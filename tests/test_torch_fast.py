"""jpeg_tpu_torch.FastBatchEncoder against jpeg_tpu's FastBatchEncoder
(interpret mode on the CPU): ``step()`` words and totals and the JPEG
bytes must be identical, batch 2, in every case below.  The port runs on
the CPU here, i.e. through the plain twins of its CUDA kernels."""
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder
from jpeg_tpu_torch.convert import constants_from_jax
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)

from test_torch_ops import synthetic_images

# (H, W, restart_interval_mcu_rows)
GEOMETRIES = {
    "128x128": (128, 128, 0),     # baseline
    "160x96": (160, 96, 0),       # height not a slab multiple, width not
    #                               a multiple of 128
    "256x160-r8": (256, 160, 8),  # 2 slab-aligned restart segments
    "160x96-r5": (160, 96, 5),    # 2 pseudo-segments
}
QUALITIES = [None, 75]
CASES = [(g, q) for g in GEOMETRIES for q in QUALITIES]


def _config(rr, quality, cls=EncodeConfig):
    return cls(scan_layout="interleaved", huffman="fixed", quality=quality,
               restart_interval_mcu_rows=rr)


@pytest.fixture(scope="module")
def jax_ref():
    """Per case: (images, jax encoder, words, totals, files), cached."""
    cache = {}

    def get(geom, quality):
        if (geom, quality) not in cache:
            h, w, rr = GEOMETRIES[geom]
            imgs = synthetic_images(21, 2, h, w)
            enc = JaxEncoder(h, w, _config(rr, quality, JaxConfig),
                             interpret=True)
            words, totals = enc.step(imgs)
            cache[geom, quality] = (imgs, enc, np.asarray(words),
                                    np.asarray(totals),
                                    enc.encode_batch(imgs))
        return cache[geom, quality]
    return get


@pytest.mark.parametrize("geom,quality", CASES)
def test_step_words_and_totals_match_jax(jax_ref, geom, quality):
    imgs, _, words, totals, _ = jax_ref(geom, quality)
    h, w, rr = GEOMETRIES[geom]
    enc = FastBatchEncoder(h, w, _config(rr, quality), device="cpu")
    got_w, got_t = enc.step(imgs)
    assert got_w.dtype == torch.uint32 and got_t.dtype == torch.int32
    assert tuple(got_w.shape) == words.shape
    np.testing.assert_array_equal(got_t.numpy(), totals)
    np.testing.assert_array_equal(got_w.numpy(), words)


@pytest.mark.parametrize("geom,quality", CASES)
def test_jpeg_bytes_match_jax(jax_ref, geom, quality):
    imgs, _, _, _, files = jax_ref(geom, quality)
    h, w, rr = GEOMETRIES[geom]
    enc = FastBatchEncoder(h, w, _config(rr, quality), device="cpu")
    got = enc.encode_batch(imgs)
    assert len(got) == len(files)
    for g, f in zip(got, files):
        assert g == f


def test_constants_from_jax_give_the_same_bytes(jax_ref):
    imgs, jenc, _, _, files = jax_ref("160x96-r5", 75)
    arrays = {k: np.asarray(getattr(jenc, k))
              for k in ("_dct_m", "_dct_bias", "_ql_zz", "_qc_zz",
                        "_fixed_lut")}
    consts = constants_from_jax(arrays)
    assert set(consts) == {"m", "bias", "ql", "qc", "lut"}
    enc = FastBatchEncoder(160, 96, _config(5, 75), device="cpu",
                           constants=consts)
    assert enc.encode_batch(imgs) == files


def test_constants_from_jax_rejects_bad_arrays():
    arrays = {"_dct_m": np.zeros((64, 64), np.float32),
              "_dct_bias": np.zeros(64, np.float32),
              "_ql_zz": np.ones(64, np.float32),
              "_qc_zz": np.ones(64, np.float32),
              "_fixed_lut": np.zeros(1024, np.int64)}
    with pytest.raises(ValueError, match="_fixed_lut"):
        constants_from_jax(arrays)
    del arrays["_dct_m"]
    with pytest.raises(KeyError, match="_dct_m"):
        constants_from_jax(arrays)


def test_constants_must_match_the_config_quantizers():
    from jpeg_tpu_torch.pipelines.fast import host_constants
    consts = {k: torch.from_numpy(v) for k, v in host_constants(75).items()}
    with pytest.raises(ValueError, match="does not match"):
        FastBatchEncoder(128, 128, _config(0, 50), device="cpu",
                         constants=consts)


@pytest.mark.parametrize("args", [
    (100, 128, dict(scan_layout="interleaved", huffman="fixed"), None),
    (160, 96, dict(scan_layout="interleaved", huffman="fixed",
                   restart_interval_mcu_rows=3), None),
    (128, 128, dict(scan_layout="interleaved", huffman="fixed"), 3),
    (128, 128, dict(scan_layout="3scan", huffman="fixed"), None),
], ids=["non-mcu-dims", "restart-rows", "segs-per-image", "3scan"])
def test_constructor_errors_match_jax(args):
    h, w, cfg, segs = args
    with pytest.raises(ValueError) as want:
        JaxEncoder(h, w, JaxConfig(**cfg), segs_per_image=segs,
                   interpret=True)
    with pytest.raises(ValueError) as got:
        FastBatchEncoder(h, w, EncodeConfig(**cfg), segs_per_image=segs,
                         device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [dict(subsampling="422"),
                                 dict(subsampling="444"),
                                 dict(dtype="float64", subsampling="444")])
def test_other_subsamplings_match_jax_interleaved(cfg):
    """4:2:2, 4:4:4 and f64 4:4:4 against jpeg_tpu's interleaved
    ``JpegEncoder`` on its XLA engine (f64: un-jitted); the interpret-mode
    FastBatchEncoder cases are in ``test_torch_sampling.py``."""
    kw = dict(scan_layout="interleaved", huffman="fixed", **cfg)
    img = synthetic_images(29, 1, 32, 32)[0]
    want = JaxJpegEncoder(JaxConfig(engine="xla", **kw)).encode(img)
    enc = FastBatchEncoder(32, 32, EncodeConfig(**kw), device="cpu")
    assert enc.encode_batch(img[None]) == [want]


def test_batch_layouts_and_shape_errors(jax_ref):
    imgs, jenc, words, totals, _ = jax_ref("128x128", None)
    enc = FastBatchEncoder(128, 128, _config(0, None), device="cpu")
    flat = torch.from_numpy(imgs.reshape(2, 128, 128 * 3))
    got_w, got_t = enc.step(flat)
    np.testing.assert_array_equal(got_w.numpy(), words)
    np.testing.assert_array_equal(got_t.numpy(), totals)
    bad = np.zeros((2, 128, 64, 3), np.uint8)
    with pytest.raises(ValueError) as want:
        jenc.step(bad)
    with pytest.raises(ValueError) as got:
        enc.step(bad)
    assert str(got.value) == str(want.value)


def test_cpu_wrappers_run_the_plain_twins_and_launch_nothing():
    imgs = synthetic_images(23, 2, 128, 128)
    enc = FastBatchEncoder(128, 128, _config(4, None), device="cpu")
    reset_launch_counts()
    enc.encode_batch(imgs)
    x = torch.from_numpy(imgs.reshape(2, 128, 384))
    c = (enc._m, enc._bias, enc._ql, enc._qc)
    coef = front.front_dct(x, *c)
    assert torch.equal(coef, front.front_dct_plain(x, *c))
    coef = coef.view(4, -1, 64)
    fields = fused.symbolize_bits(coef, enc._lut)
    for a, b in zip(fields, fused.symbolize_bits_plain(coef, enc._lut)):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a,
                           b.view(torch.int32) if b.dtype == torch.uint32
                           else b)
    offs = fused.segment_offsets(fields[2])
    for a, b in zip(offs, fused.segment_offsets_plain(fields[2])):
        assert torch.equal(a, b)
    seg_words = enc.seg_rows * 128
    words = fused.place(fields[0], fields[1], *offs, seg_words)
    plain = fused.place_plain(fields[0], fields[1], offs[0], seg_words)
    assert torch.equal(words.view(torch.int32), plain.view(torch.int32))
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert set(launch_counts()) == {
        "front_dct", "front_dct_px", "symbolize_bits",
        "symbolize_bits_explicit",
        "segment_offsets", "place", "symbolize_fields",
        "symbolize_fields_explicit", "attach_pf", "decode_segments",
        "scan_positions", "write_files"}
