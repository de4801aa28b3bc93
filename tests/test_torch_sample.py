"""The stage-1 route of ``huffman="dynamic-sampled"``: which blocks the
sample takes depends on the route jpeg_tpu's FastBatchEncoder takes
(``_front_index_ok``: the front_index layout, or analyze_px +
dct_index_segments).  The port copies the gate as shape arithmetic
(``ops.sample.front_index_route``) and samples the matching layout.

* The gate equals jpeg_tpu's over a grid of geometries (encoders built,
  nothing run).
* With the pixel route forced on both sides at two padded geometries, the
  sampled histograms, tables and bytes equal jpeg_tpu's (interpret mode).
Every comparison is exact equality."""
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder
from jpeg_tpu_torch.convert import tables_from_jax
from jpeg_tpu_torch.ops import sample

from test_torch_ops import synthetic_images

# heights: 1088 and 3008 pad to 128-row slabs, 1280 and 2048 do not; every
# height's MCU rows divide into 1, 2 and 4 segments
HEIGHTS = [1088, 1280, 2048, 3008]
WIDTHS = [640, 1920, 2992, 3520, 4096, 8192]
SEGMENTS = [1, 2, 4]
NAMES = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")


@pytest.mark.parametrize("width", WIDTHS)
def test_route_matches_front_index_ok(width):
    cfg = JaxConfig(scan_layout="interleaved", huffman="dynamic-sampled")
    for height in HEIGHTS:
        for n_segs in SEGMENTS:
            enc = JaxEncoder(height, width, cfg, segs_per_image=n_segs,
                             interpret=True)
            assert sample.front_index_route(height, width, n_segs) \
                == enc._front_index_ok, (height, width, n_segs)


def test_route_grid_takes_both_routes():
    """The grid above is not one-sided: 2992 wide (slab columns 8976, off
    a 128 multiple) fails the gate, 640 wide passes it."""
    assert not sample.front_index_route(2000, 2992, 1)
    assert sample.front_index_route(1088, 640, 4)


# (H, W, restart_interval_mcu_rows): 160x96 is one segment of 360 blocks
# (padded to 384 on the pixel route); 128x96 r4 is 2 segments of 144
# blocks, each padded to 256
FORCED = {"160x96": (160, 96, 0), "128x96-r4": (128, 96, 4)}


@pytest.mark.parametrize("geom", FORCED)
def test_forced_pixel_route_matches(monkeypatch, geom):
    h, w, rr = FORCED[geom]
    kw = dict(scan_layout="interleaved", huffman="dynamic-sampled",
              restart_interval_mcu_rows=rr)
    monkeypatch.setattr(JaxEncoder, "_front_index_ok",
                        property(lambda self: False))
    monkeypatch.setattr(sample, "front_index_route", lambda *args: False)
    imgs = synthetic_images(53, 2, h, w)
    jenc = JaxEncoder(h, w, JaxConfig(**kw), interpret=True)
    fields, jhist = jenc._analyze_hist(jenc._check_batch(imgs))
    assert fields[0].ndim == 3  # the pixel route's px handoff
    jtables, jluts = jenc._build_tables_batch(np.asarray(jhist), smooth=True)
    want = jenc.encode_batch(imgs)

    enc = FastBatchEncoder(h, w, EncodeConfig(**kw), device="cpu")
    _, hist = enc._analyze_hist(enc._check_batch(imgs))
    np.testing.assert_array_equal(hist.numpy()[:, :1023],
                                  np.asarray(jhist)[:, :1023])
    tables, luts = enc._build_tables_batch(hist.numpy(), smooth=True)
    np.testing.assert_array_equal(luts, jluts)
    for mine, theirs in zip(tables, jtables):
        converted = tables_from_jax(theirs)
        for name in NAMES:
            np.testing.assert_array_equal(mine[name].huffval,
                                          converted[name].huffval)
    assert enc.encode_batch(torch.from_numpy(imgs)) == want
