"""The port's ``ShardedEncoder`` (``jpeg_tpu_torch.parallel.sharded``) on a
2x2 mesh of four gloo ranks on the CPU, against ``jpeg_tpu``'s
``ShardedEncoder`` on its 2x2 CPU mesh (XLA engine for f32) and its
single-device ``JpegEncoder`` with the same restart interval: every
rank's files must equal both, byte for byte.

One module fixture spawns the four ranks once and runs every case there;
each case is then a parametrised comparison.  The single-process tests
run a 1x1 mesh in this process."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jpeg_tpu.parallel.sharded import ShardedEncoder as JaxSharded
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu_torch import EncodeConfig
from jpeg_tpu_torch.parallel.mesh import make_mesh
from jpeg_tpu_torch.parallel.sharded import ShardedEncoder
from jpeg_tpu_torch.utils.resilience import ResilientEncoder
from torch_parallel_worker import spawn_ranks

H, W, B = 128, 96, 4
BASE = dict(scan_layout="interleaved")
# name -> (config, segs_per_device, restart_interval_mcu_rows of the
# single-device encoder: a 64-row slab is 4 MCU rows of 16, 8 of 8;
# images: one or two a data rank)
CASES = {
    "dynamic f64": (dict(huffman="dynamic", dtype="float64"), 1, 4, 2),
    "fixed f32": (dict(huffman="fixed"), 1, 4, 4),
    "fixed f32 2 segments a slab": (dict(huffman="fixed"), 2, 2, 4),
    "4:2:2 dynamic f64": (dict(huffman="dynamic", dtype="float64",
                               subsampling="422"), 1, 8, 2),
    "4:4:4 dynamic f64": (dict(huffman="dynamic", dtype="float64",
                               subsampling="444"), 1, 8, 2),
    "dynamic-sampled": (dict(huffman="dynamic-sampled"), 1, 4, 4),
}
STEP = "step fixed f32"


def _checkerboard(h, w, seed):
    """``tests/conftest.py``'s synthetic image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 16 + xx // 16) % 2) * 180 + 40
    img = np.stack([base, 255 - base, (xx * 255 // max(w - 1, 1))], axis=-1)
    noise = rng.integers(-20, 21, size=img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _batch(b=B):
    """``tests/test_sharded.py``'s batch: the 128x96 checkerboard rolled."""
    img = _checkerboard(160, 96, seed=2)[:H, :W]
    return np.stack([np.roll(img, i * 7, axis=1) for i in range(b)])


def _jax_config(cfg: dict) -> JaxConfig:
    return JaxConfig(engine="xla", **BASE, **cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the four ranks: [rank] -> {name: files or step}."""
    cases = [dict(name=name, config={**BASE, **cfg}, spd=spd,
                  batch=_batch(b))
             for name, (cfg, spd, _, b) in CASES.items()]
    cases.append(dict(name=STEP, config={**BASE, "huffman": "fixed"}, spd=1,
                      batch=_batch(), step=True))
    return spawn_ranks("sharded", 4, tmp_path_factory.mktemp("sharded"),
                       {"cases": cases})


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(data=2, space=2)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_matches_jpeg_tpu_sharded(ranks, jax_mesh, name):
    cfg, spd, _, b = CASES[name]
    want = JaxSharded(jax_mesh, H, W, config=_jax_config(cfg),
                      segs_per_device=spd).encode_batch(_batch(b))
    want = [bytes(f) for f in want]
    for r, got in enumerate(ranks):
        assert len(got[name]) == b, r
        assert got[name] == want, f"rank {r}"


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jpeg_tpu_single_device(ranks, name):
    """Sharding is a parallel decomposition, not a format change: the
    files equal the single-device encoder's at the slab's restart
    interval (``"dynamic-sampled"``: the exact dynamic tables, as
    ``jpeg_tpu``'s sharded encoder counts every block)."""
    cfg, _, rows, b = CASES[name]
    if cfg["huffman"] == "dynamic-sampled":
        cfg = {**cfg, "huffman": "dynamic"}
    single = JaxJpegEncoder(JaxConfig(restart_interval_mcu_rows=rows,
                                      **BASE, **cfg))
    want = [bytes(single.encode(img)) for img in _batch(b)]
    assert ranks[0][name] == want


def test_step_shards_match_jpeg_tpu(ranks, jax_mesh):
    """``step``: each rank holds its two images' slab: the words of its
    segment streams, their bit counts, and the images' histograms summed
    over ``space``, equal to ``jpeg_tpu``'s ``step``."""
    enc = JaxSharded(jax_mesh, H, W, config=_jax_config(dict(huffman="fixed")))
    words, totals, hists = (np.asarray(t) for t in enc.step(_batch()))
    assert hists.shape == (B, 4, 256)
    for r, out in enumerate(ranks):
        d, s = divmod(r, 2)
        imgs = slice(2 * d, 2 * d + 2)
        w, t, h = out[STEP]
        assert w.shape[:2] == (2, 1) and w.dtype == np.uint32
        assert t.shape == (2, 1) and h.shape == (2, 4, 256)
        np.testing.assert_array_equal(t[:, 0], totals[imgs, s])
        np.testing.assert_array_equal(h, hists[imgs])
        for i in range(2):
            n = -(-int(t[i, 0]) // 32)
            np.testing.assert_array_equal(
                w[i, 0, :n], words[2 * d + i, s, :n])


# -- one process: a 1x1 mesh --------------------------------------------------


@pytest.fixture(scope="module")
def mesh11():
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("height,width,config,spd", [
    (48, 64, {}, 2),                           # 3 MCU rows into 2 segments
    (64, 64, dict(scan_layout="3scan"), 1),    # restart markers need one scan
    (50, 64, {}, 1),                           # not whole MCUs
    (64, 60, dict(subsampling="422"), 1),
])
def test_geometry_and_layout_errors(mesh11, height, width, config, spd):
    cfg = dict(BASE, **config)
    with pytest.raises(ValueError) as jax_err:
        JaxSharded(jax_make_mesh(), height, width, config=JaxConfig(**cfg),
                   segs_per_device=spd)
    with pytest.raises(ValueError) as err:
        ShardedEncoder(mesh11, height, width, config=EncodeConfig(**cfg),
                       segs_per_device=spd)
    assert str(err.value) == str(jax_err.value)


def test_batch_and_mode_errors(mesh11):
    enc = ShardedEncoder(mesh11, 64, 64)
    with pytest.raises(ValueError, match="does not match encoder geometry"):
        enc.encode_batch(np.zeros((1, 32, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="requires huffman='fixed'"):
        enc.step(np.zeros((1, 64, 64, 3), np.uint8))


@pytest.mark.parametrize("huffman", ["fixed", "dynamic"])
def test_one_rank_mesh_and_resilient_wrapper(mesh11, huffman):
    """A 1x1 mesh in a process that never called ``initialize`` (one
    segment: no DRI), wrapped in ``ResilientEncoder``: no event, and the
    files of ``jpeg_tpu``'s single-device encoder, from [B, H, W, 3] and
    [B, H, W*3] batches alike."""
    batch = _batch(2)
    cfg = dict(BASE, huffman=huffman)
    enc = ShardedEncoder(mesh11, H, W, config=EncodeConfig(**cfg))
    assert (enc.slab_h, enc.n_segments, enc.segs_per_device) == (H, 1, 1)
    wrapped = ResilientEncoder(enc, config=enc.config, device="cpu")
    got = wrapped.encode_batch(batch)
    assert wrapped.events == []
    single = JaxJpegEncoder(JaxConfig(**cfg))
    assert got == [bytes(single.encode(img)) for img in batch]
    assert enc.encode_batch(torch.from_numpy(batch).reshape(2, H, W * 3)) \
        == got
