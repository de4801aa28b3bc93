"""4:2:2 and 4:4:4 chroma: the port against jpeg_tpu on the CPU.

* Kernel A's plain twin, per sampling and output order, against
  jpeg_tpu's color conversion, ``to_blocks``, MCU interleave
  (``analyze_zz``, ``analyze_px``) and ``dct_quantize_zigzag``.
* ``FastBatchEncoder`` against jpeg_tpu's (interpret mode) in the three
  Huffman modes at 4:2:2 40x64 (a height off a multiple of 16) and 4:4:4
  48x56 (a width off a multiple of 16: jpeg_tpu's pixel route, K7 for
  fixed tables), plus a restart case; the dynamic-sampled cases compare
  the histograms too.  The route gate of the sampled mode equals
  jpeg_tpu's over a grid of geometries.
* K7 (``dct_attach_pack_segments``, both of its routes) and K18a
  (``dct_index_xt``) against the port's counterparts.
``JpegEncoder``, ``encode_jpeg`` and the f64 exact mode at 4:2:2 and
4:4:4 are in ``test_torch_sampling_encode.py`` (two files keep each one
under a minute).  Every comparison is exact equality: integer outputs
and bytes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.core import tables as JT
from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.kernels import fused as jfused
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.pipelines import fast as jfast
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder
from jpeg_tpu_torch.kernels import front, fused
from jpeg_tpu_torch.kernels.pack import rows_per_segment
from jpeg_tpu_torch.ops import color, sample
from jpeg_tpu_torch.pipelines.fast import host_constants

from test_torch_ops import synthetic_images

SAMPLINGS = ["422", "444"]
PERIOD = {"420": 6, "422": 4, "444": 3}
YPM = {"420": 4, "422": 2, "444": 1}


def _consts(quality=None):
    return {k: torch.from_numpy(v) for k, v in host_constants(quality).items()}


def _jnp(c, *names):
    return tuple(jnp.asarray(c[n].numpy()) for n in names)


# -- kernel A's plain twin ----------------------------------------------------

# (H, W) per sampling: 4:2:2 40x48 (height off 16), 4:4:4 40x56 (width off 16)
FRONT_SHAPES = {"422": (40, 48), "444": (40, 56)}


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_color_planes_match_jax(sampling, dtype):
    h, w = FRONT_SHAPES[sampling]
    imgs = synthetic_images(71, 2, h, w)
    convert = {"422": jcolor.rgb_to_ycbcr_422,
               "444": jcolor.rgb_to_ycbcr_444}[sampling]
    want = convert(jnp.asarray(imgs), dtype=getattr(jnp, dtype))
    got = color.rgb_to_ycbcr(torch.from_numpy(imgs), sampling,
                             dtype=getattr(torch, dtype))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("order", ["mcu", "scan"])
def test_front_plain_matches_jax(sampling, order):
    """A's plain twin (the CPU wrapper) against jpeg_tpu's stages: the
    interleaved order against ``analyze_zz``'s un-diffed sequence, the
    3-scan order against ``dct_quantize_zigzag`` per plane; the MCU's pixel
    blocks against ``analyze_px``."""
    h, w = FRONT_SHAPES[sampling]
    mcu_w, mcu_h, _ = color.SAMPLING_GEOMETRY[sampling]
    imgs = synthetic_images(73, 2, h, w)
    c = _consts(75)
    lq, cq = JT.quant_tables(75)
    x = torch.from_numpy(imgs.reshape(2, h, w * 3))
    got = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                          order=order, sampling=sampling)
    if order == "mcu":
        seq, _ = jfast.analyze_zz(jnp.asarray(imgs), jnp.asarray(lq),
                                  jnp.asarray(cq), w // mcu_w, h // mcu_h, 1,
                                  sampling=sampling)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(seq).reshape(2, -1, 64))
        px = jfast.analyze_px(jnp.asarray(imgs), w // mcu_w, h // mcu_h, 1,
                              sampling=sampling)
        planes = color.rgb_to_ycbcr(torch.from_numpy(imgs), sampling)
        np.testing.assert_array_equal(
            color.mcu_blocks(*planes, sampling).numpy(),
            np.asarray(px).reshape(2, -1, 64))
        return
    convert = {"422": jcolor.rgb_to_ycbcr_422,
               "444": jcolor.rgb_to_ycbcr_444}[sampling]
    zz = [np.asarray(jdct.dct_quantize_zigzag(jcolor.to_blocks(p), q))
          for p, q in zip(convert(jnp.asarray(imgs)), (lq, cq, cq))]
    want = np.concatenate([zz[0].reshape(-1, 64),
                           np.concatenate(zz[1:], 1).reshape(-1, 64)])
    np.testing.assert_array_equal(got.numpy(), want)


# -- FastBatchEncoder ---------------------------------------------------------

# (sampling, H, W, restart_interval_mcu_rows)
FAST_GEOMETRIES = {
    "422-40x64": ("422", 40, 64, 0),   # height 8 mod 16
    "444-48x56": ("444", 48, 56, 0),   # width 8 mod 16: jpeg_tpu's pixel
    #                                    route (K7 for fixed tables)
    "422-48x64-r2": ("422", 48, 64, 2),  # 3 restart segments of 2 MCU
    #                                      rows (pseudo-segments on the TPU)
}
MODES = ["fixed", "dynamic", "dynamic-sampled"]
FAST_CASES = [("422-40x64", m) for m in MODES] + \
    [("444-48x56", m) for m in MODES] + [("422-48x64-r2", "dynamic-sampled")]


def _fast_config(geom, mode, cls):
    sampling, _, _, rr = FAST_GEOMETRIES[geom]
    return cls(scan_layout="interleaved", huffman=mode, subsampling=sampling,
               restart_interval_mcu_rows=rr)


@pytest.fixture(scope="module")
def fast_ref():
    """Per case: (images, jpeg_tpu's stage-1 histograms or None, its
    files), cached."""
    cache = {}

    def get(geom, mode):
        if (geom, mode) not in cache:
            _, h, w, _ = FAST_GEOMETRIES[geom]
            imgs = synthetic_images(75, 1, h, w)
            enc = jfast.FastBatchEncoder(h, w, _fast_config(geom, mode,
                                                            JaxConfig),
                                         interpret=True)
            hist = None
            if mode != "fixed":
                hist = np.asarray(enc._analyze_hist(enc._check_batch(imgs))[1])
            cache[geom, mode] = (imgs, hist, enc.encode_batch(imgs))
        return cache[geom, mode]
    return get


@pytest.mark.parametrize("geom,mode", FAST_CASES)
def test_fast_batch_encoder_matches_jax(fast_ref, geom, mode):
    imgs, want_hist, want = fast_ref(geom, mode)
    _, h, w, _ = FAST_GEOMETRIES[geom]
    enc = FastBatchEncoder(h, w, _fast_config(geom, mode, EncodeConfig),
                           device="cpu")
    if want_hist is not None:
        _, hist = enc._analyze_hist(enc._check_batch(imgs))
        np.testing.assert_array_equal(hist.numpy()[:, :1023],
                                      want_hist[:, :1023])
    assert enc.encode_batch(imgs) == want


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_sampled_route_matches_front_index_ok(sampling):
    """The dynamic-sampled route gate at 4:2:2 and 4:4:4 equals jpeg_tpu's
    ``_front_index_ok`` over a grid of geometries (encoders built, nothing
    run), and the grid takes both routes."""
    cfg = JaxConfig(scan_layout="interleaved", huffman="dynamic-sampled",
                    subsampling=sampling)
    mcu_w = color.SAMPLING_GEOMETRY[sampling][0]
    routes = set()
    for height in (128, 520, 1080, 2048):
        for width in (264, 640, 1080, 1920, 2992, 4096, 8192):
            for n_segs in (1, 2, 4):
                if (height // 8) % n_segs or width % mcu_w:
                    continue
                enc = jfast.FastBatchEncoder(height, width, cfg,
                                             segs_per_image=n_segs,
                                             interpret=True)
                got = sample.front_index_route(height, width, n_segs,
                                               sampling)
                assert got == enc._front_index_ok, (height, width, n_segs)
                routes.add(got)
    assert routes == {True, False}


# -- K7 and K18a: kernel A's pixel-block mode ---------------------------------


@pytest.fixture(scope="module")
def px_444():
    """jpeg_tpu's ``analyze_px`` blocks of one 48x56 4:4:4 image (the K7
    route of its FastBatchEncoder), as f32: [1, 126, 64]."""
    imgs = synthetic_images(83, 1, 48, 56)
    px = jfast.analyze_px(jnp.asarray(imgs), 7, 6, 1, sampling="444")
    return np.asarray(px, np.float32).reshape(1, 126, 64)


@pytest.mark.parametrize("seg_rows", [None, 12300],
                         ids=["K6r-resident", "K7-dct-attach"])
def test_dct_attach_pack_segments_matches_k7(px_444, seg_rows):
    """K7 at the encoder's seg_rows (jpeg_tpu's resident ``_dct_place``
    route) and at 12300 rows, whose 6.3 MB of segment words exceed the
    6 MiB resident budget, so jpeg_tpu runs ``_dct_attach_kernel``
    (``fused.py:730``) and ``_segment_place``."""
    c = _consts(75)
    seg_rows = seg_rows or rows_per_segment(126 * 64)
    lut, m, bias, ql, qc = _jnp(c, "lut", "m", "bias", "ql", "qc")
    jw, jt = jfused.dct_attach_pack_segments(
        lut, m, bias, ql, qc, jnp.asarray(px_444), 1, 3, 1, seg_rows,
        interpret=True)
    words, totals = fused.dct_attach_pack_segments(
        c["lut"], c["m"], c["bias"], c["ql"], c["qc"],
        torch.from_numpy(px_444), 1, 3, 1, seg_rows)
    assert words.shape == (1, seg_rows * 128) and words.dtype == torch.uint32
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    plain = fused.dct_attach_pack_segments_plain(
        c["lut"], c["m"], c["bias"], c["ql"], c["qc"],
        torch.from_numpy(px_444), 1, 3, 1, seg_rows)
    assert torch.equal(plain[0].view(torch.int32), words.view(torch.int32))


# (sampling, H, W, segments): whole 128-block tiles and whole MCUs per
# segment (4:2:0 and 4:4:4: 384 blocks, 4:2:2: 128 blocks)
XT_CASES = {"420": ("420", 128, 128, 1), "422": ("422", 64, 128, 2),
            "444": ("444", 128, 128, 2)}


@pytest.mark.parametrize("case", XT_CASES)
def test_dct_index_xt_matches_k18a(case):
    sampling, h, w, n_segs = XT_CASES[case]
    mcu_w, mcu_h, _ = color.SAMPLING_GEOMETRY[sampling]
    imgs = synthetic_images(85, 1, h, w)
    px = jfast.analyze_px(jnp.asarray(imgs), w // mcu_w, h // mcu_h, n_segs,
                          sampling=sampling)
    xt = np.ascontiguousarray(np.asarray(px, np.float32).reshape(-1, 64).T)
    c = _consts(None)
    m, bias, ql, qc = _jnp(c, "m", "bias", "ql", "qc")
    want = jfused.dct_index_xt(m, bias, ql, qc, jnp.asarray(xt), n_segs,
                               PERIOD[sampling], YPM[sampling],
                               interpret=True)
    got = fused.dct_index_xt(c["m"], c["bias"], c["ql"], c["qc"],
                             torch.from_numpy(xt), n_segs, PERIOD[sampling],
                             YPM[sampling])
    assert got.dtype == torch.int32 and got.shape == xt.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="tile-aligned"):
        fused.dct_index_xt(c["m"], c["bias"], c["ql"], c["qc"],
                           torch.from_numpy(xt[:, :-PERIOD[sampling]]), 1,
                           PERIOD[sampling], YPM[sampling])


def test_pixel_mode_transposed_equals_rows(px_444):
    """A's pixel mode reads [N, 64] and the transposed [64, N] alike."""
    c = _consts(None)
    args = (c["m"], c["bias"], c["ql"], c["qc"], color.MCU_444)
    rows = front.front_dct_px(torch.from_numpy(px_444), *args)
    xt = torch.from_numpy(np.ascontiguousarray(px_444[0].T))
    assert torch.equal(front.front_dct_px(xt, *args, transposed=True), rows)
