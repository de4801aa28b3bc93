"""Decode over a mesh: ``decode_jpeg_batch(mesh=...)`` and
``speculative_decode_restart(mesh=...)`` of the port on a 1x4 space mesh
of four gloo ranks on the CPU.  Every rank's images must equal the
single-device port's decode of the same streams, and both must equal
``jpeg_tpu``'s decode of them: its host-entropy ``decode_jpeg`` run
un-jitted for every case (the standard ``tests/test_torch_decode.py``
holds the port to), and its own decode over its 1x4 CPU mesh for the
case whose lanes do not divide over the ranks.  Inputs are those of
``jpeg_tpu``'s own mesh decode tests (``test_huffdec.py``,
``test_speculative.py``)."""
import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from jpeg_tpu.pipelines import decode as jdec
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu_torch import decode_jpeg_batch
from jpeg_tpu_torch.kernels import huffdec as hd
from jpeg_tpu_torch.pipelines.decode import _parse_device_eligible
from jpeg_tpu_torch.pipelines.speculative import speculative_decode_restart
from torch_parallel_worker import spawn_ranks

RANKS = 4
LANE_BYTES = 128  # many short lanes a restart segment


def _img(h, w, seed):
    """``tests/test_huffdec.py``'s image: noise, half of it a ramp."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[:, :w // 2, 0] = ((yy * 2 + xx) % 256).astype(np.uint8)[:, :w // 2]
    return img


def _restart_files(shapes):
    cfg = JaxConfig(scan_layout="interleaved", huffman="fixed",
                    restart_interval_mcu_rows=1, engine="xla")
    return [bytes(JaxJpegEncoder(cfg).encode(_img(h, w, seed)))
            for seed, (h, w) in enumerate(shapes)]


def _restart_free_files():
    """``tests/test_speculative.py``'s: a 3-scan file of the engine and a
    DRI-less 4:2:0 PIL file."""
    rng = np.random.default_rng(6)
    datas = [bytes(JaxJpegEncoder(JaxConfig()).encode(
        rng.integers(0, 256, (192, 192, 3), dtype=np.uint8)))]
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (160, 160, 3), dtype=np.uint8),
                    "RGB").save(buf, "JPEG", quality=90, subsampling=2)
    return datas + [buf.getvalue()]


# name -> (kind, streams); "restart" 20 segments (5 a rank), "uneven" 14
# (the last rank's share padded with two empty lanes)
CASES = {
    "restart": ("batch", _restart_files([(96, 96), (128, 64), (96, 96)])),
    "uneven": ("batch", _restart_files([(96, 96), (128, 64)])),
    "restart-free": ("batch", _restart_free_files()),
    "speculative_decode_restart": ("restart-spec",
                                   _restart_files([(64, 128)])),
}


def _single(kind, datas):
    if kind == "restart-spec":
        return [speculative_decode_restart(d, device="cpu",
                                           target_lane_bytes=LANE_BYTES)
                for d in datas]
    return decode_jpeg_batch(datas, entropy_engine="device", device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spec = {"cases": [(name, kind, datas)
                      for name, (kind, datas) in CASES.items()],
            "lane_bytes": LANE_BYTES}
    return spawn_ranks("decode", RANKS, tmp_path_factory.mktemp("decode"),
                       spec)


def test_cases_spread_over_the_ranks():
    """The restart cases' segments do not divide evenly (or do) over the
    ranks, and the restart-spec case makes several lanes a segment."""
    def segs(data):
        return _parse_device_eligible(data)["segs"]
    assert [len(segs(d)) for d in CASES["restart"][1]] == [6, 8, 6]
    assert [len(segs(d)) for d in CASES["uneven"][1]] == [6, 8]
    one = segs(CASES["speculative_decode_restart"][1][0])
    assert len(one) == 4 and sum(map(len, one)) // LANE_BYTES > 2 * RANKS


@pytest.fixture(scope="module")
def singles():
    """name -> the single-device port's images of the case."""
    out = {}
    for name, (kind, datas) in CASES.items():
        out[name] = _single(kind, datas)
        assert all(w is not None for w in out[name])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_equals_single_device(ranks, singles, name):
    want = singles[name]
    for r, got in enumerate(ranks):
        assert len(got[name]) == len(want), r
        for i, (g, w) in enumerate(zip(got[name], want)):
            assert g is not None and np.array_equal(g, w.numpy()), \
                f"rank {r} image {i}"


@pytest.mark.parametrize("name", list(CASES))
def test_single_device_equals_jpeg_tpu(singles, name):
    """The images the ranks are held to are ``jpeg_tpu``'s: its
    host-entropy decode of every stream, un-jitted (jitted, XLA's fused
    multiply-adds flip one value of the restart-spec image)."""
    with jax.disable_jit():
        want = [np.asarray(jdec.decode_jpeg(d, entropy_engine="host"))
                for d in CASES[name][1]]
    for i, (g, w) in enumerate(zip(singles[name], want)):
        assert np.array_equal(g.numpy(), w), f"image {i}"


def test_uneven_equals_jpeg_tpu_mesh_decode(ranks):
    """Rank 3's share padded with two empty lanes, against ``jpeg_tpu``'s
    ``decode_jpeg_batch`` over its own 1x4 CPU mesh (its kernel G in
    interpret mode, its lanes padded to 128 a device)."""
    datas = CASES["uneven"][1]
    want = jdec.decode_jpeg_batch(datas, entropy_engine="device",
                                  interpret=True,
                                  mesh=jax_make_mesh(data=1, space=RANKS))
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got["uneven"], want)):
            assert np.array_equal(g, np.asarray(w)), f"rank {r} image {i}"


def test_shares_cover_every_lane():
    """``lane_share``'s split by hand at 14 lanes over 4 ranks: shares of
    4, the last two lanes of rank 3 zero (no blocks, no span)."""
    streams = torch.arange(14 * 3, dtype=torch.int32).reshape(14, 3)
    rows = torch.arange(1, 15, dtype=torch.int32)[None]
    shares = [hd.lane_share(r, RANKS, 14, (streams, None), (rows,))
              for r in range(RANKS)]
    assert torch.equal(torch.cat([s[0] for s, _ in shares])[:14], streams)
    assert torch.equal(torch.cat([w[0] for _, w in shares], 1)[:, :14],
                       rows)
    assert shares[3][1][0].tolist() == [[13, 14, 0, 0]]
    assert not shares[3][0][0][2:].any()
    assert all(s[1] is None for s, _ in shares)
