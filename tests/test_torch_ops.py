"""The port's plain stages (jpeg_tpu_torch.ops, kernels.lut) against the
jpeg_tpu functions they restate.  Every comparison is exact equality:
all compared outputs are integers, or f32 holding small integers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.core import tables as T
from jpeg_tpu.huffman.build import fixed_tables
from jpeg_tpu.kernels import lut as jlut
from jpeg_tpu.kernels import pack as jpack
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.pipelines import fast as jfast
from jpeg_tpu_torch.kernels import lut
from jpeg_tpu_torch.kernels import pack as kpack
from jpeg_tpu_torch.ops import color, dct, pack, symbols
from jpeg_tpu_torch.pipelines.fast import host_constants


def synthetic_images(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """[b, h, w, 3] u8 made with numpy: smooth gradients, flat patches,
    noisy patches, saturated colors and isolated pixels, so the symbols
    cover long zero runs (ZRL), EOB, full blocks and large amplitudes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        img = np.stack([xx * 255 // max(w - 1, 1),
                        128 + 100 * np.sin(yy / (7.0 + i) + xx / 23.0),
                        yy * 255 // max(h - 1, 1)], axis=-1).astype(np.float64)
        for _ in range(4):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            y1, x1 = y0 + rng.integers(8, h // 2), x0 + rng.integers(8, w // 2)
            kind = rng.integers(3)
            if kind == 0:
                img[y0:y1, x0:x1] = rng.choice([0, 255], 3)
            elif kind == 1:
                img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
            else:
                patch = img[y0:y1, x0:x1]
                patch += rng.normal(0, 60, patch.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
        # isolated inverted pixels: sparse high frequencies
        ys, xs = rng.integers(0, h, 40), rng.integers(0, w, 40)
        out[i, ys, xs] = 255 - out[i, ys, xs]
    return out


@pytest.fixture(scope="module")
def imgs():
    return synthetic_images(1, 2, 160, 96)


def _segments(a, n_segs):
    """Port layout [B, n_mcus * 6, ...] -> [B, S, nblk, ...]."""
    return a.reshape(a.shape[0], n_segs, -1, *a.shape[2:])


def _port_coefs(imgs, quality):
    c = {k: torch.from_numpy(v) for k, v in host_constants(quality).items()}
    y, cb, cr = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    px = color.mcu_blocks(y, cb, cr)
    return dct.dct_quantize(px, c["m"], c["bias"], c["ql"], c["qc"]), c


def test_color_planes_match_jax(imgs):
    want = jcolor.rgb_to_ycbcr_420(jnp.asarray(imgs), dtype=jnp.float32)
    got = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_color_planes_every_channel_value():
    """All 2^24 colors' fixed-point math on a strided sample of 2^18."""
    rgb = np.arange(0, 1 << 24, 64, dtype=np.int64)
    rgb = np.stack([rgb >> 16, (rgb >> 8) & 255, rgb & 255], -1)
    rgb = rgb.astype(np.uint8).reshape(1, 512, 512, 3)
    want = jcolor.rgb_to_ycbcr_420(jnp.asarray(rgb), dtype=jnp.float32)
    got = color.rgb_to_ycbcr_420(torch.from_numpy(rgb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_segs", [1, 2])
def test_mcu_blocks_match_analyze_px(imgs, n_segs):
    B, H, W, _ = imgs.shape
    want = jfast.analyze_px(jnp.asarray(imgs), W // 16, H // 16, n_segs)
    y, cb, cr = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    got = _segments(color.mcu_blocks(y, cb, cr), n_segs)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quality", [None, 75])
@pytest.mark.parametrize("n_segs", [1, 2])
def test_coefficients_and_dc_diff_match_analyze_zz(imgs, quality, n_segs):
    B, H, W, _ = imgs.shape
    lq, cq = T.quant_tables(quality)
    seq, dcd = jfast.analyze_zz(jnp.asarray(imgs), jnp.asarray(lq),
                                jnp.asarray(cq), W // 16, H // 16, n_segs)
    coef, _ = _port_coefs(imgs, quality)
    assert coef.dtype == torch.int16
    seg = coef.reshape(B * n_segs, -1, 64)
    np.testing.assert_array_equal(_segments(coef, n_segs).numpy(),
                                  np.asarray(seq))
    np.testing.assert_array_equal(
        dct.dc_diff(seg).reshape(B, n_segs, -1).numpy(), np.asarray(dcd))


@pytest.mark.parametrize("quality", [None, 75, 100])
@pytest.mark.parametrize("n_segs", [1, 2])
def test_symbols_match_analyze_symbols(imgs, quality, n_segs):
    B, H, W, _ = imgs.shape
    lq, cq = T.quant_tables(quality)
    want = jfast.analyze_symbols(jnp.asarray(imgs), jnp.asarray(lq),
                                 jnp.asarray(cq), W // 16, H // 16, n_segs)
    coef, _ = _port_coefs(imgs, quality)
    seg = coef.reshape(B * n_segs, -1, 64)
    idx, extra, extra_n = symbols.symbolize(seg, dct.dc_diff(seg))
    for got, key in ((idx, "idx"), (extra, "extra"), (extra_n, "extra_n")):
        np.testing.assert_array_equal(
            got.reshape(B, n_segs, -1, 64).numpy(), np.asarray(want[key]))
    # the inputs exercise every symbol kind
    sym = idx.numpy() & 255
    ac = (idx.numpy() >> 8 & 1) == 0
    assert ((sym == 0xF0) & ac).any(), "no ZRL"
    assert ((sym == 0x00) & ac).any(), "no EOB"
    if quality == 100:  # blocks whose slot 63 is nonzero (no EOB)
        assert (idx.numpy()[..., 63] != lut.NULL_INDEX).any()


def test_combined_lut_matches_jax():
    assert lut.NULL_INDEX == jlut.NULL_INDEX
    np.testing.assert_array_equal(lut.build_combined_lut(fixed_tables()),
                                  jlut.build_combined_lut(fixed_tables()))
    np.testing.assert_array_equal(host_constants(None)["lut"],
                                  jlut.build_combined_lut(fixed_tables()))


def test_slot_index_matches_jax():
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 256, 4096).astype(np.int32)
    valid, is_dc, is_luma = (rng.integers(0, 2, (3, 4096)) == 1)
    want = jlut.slot_index(jnp.asarray(sym), jnp.asarray(valid),
                           jnp.asarray(is_dc), jnp.asarray(is_luma))
    got = lut.slot_index(*(torch.from_numpy(a)
                           for a in (sym, valid, is_dc, is_luma)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("slots", [64 * 6, 64 * 6 * 5, 64 * 6 * 240,
                                   64 * 6 * 1600, 64 * 6 * 2040,
                                   64 * 6 * 9600])
def test_rows_per_segment_matches_jax(slots):
    from jpeg_tpu.ops import pack as jops_pack
    assert pack.MAX_FIELD_BITS == jops_pack.MAX_FIELD_BITS
    assert pack.max_words_for_slots(slots) == \
        jops_pack.max_words_for_slots(slots)
    assert kpack.rows_per_segment(slots) == jpack.rows_per_segment(slots)


def test_bit_length_is_magnitude_class():
    a = torch.arange(4096, dtype=torch.int32)
    want = [int(v).bit_length() for v in range(4096)]
    assert symbols.bit_length(a).tolist() == want


def test_host_constants_match_jax_encoder():
    """The tables the port builds equal the JAX encoder's device
    constants (its DCT basis, bias, zig-zag quantizers and LUT)."""
    from jpeg_tpu import EncodeConfig
    enc = jfast.FastBatchEncoder(
        128, 128, EncodeConfig(scan_layout="interleaved", huffman="fixed",
                               quality=75), interpret=True)
    host = host_constants(75)
    for key, attr in (("m", "_dct_m"), ("bias", "_dct_bias"),
                      ("ql", "_ql_zz"), ("qc", "_qc_zz"),
                      ("lut", "_fixed_lut")):
        want = np.asarray(getattr(enc, attr))
        assert host[key].dtype == want.dtype
        np.testing.assert_array_equal(host[key], want)
