"""The port's decode (``jpeg_tpu_torch.pipelines.decode``, kernel G's plain
twin ``kernels.huffdec.decode_segments_plain``) against ``jpeg_tpu``'s.

* kernel G's twin against ``jpeg_tpu``'s K16 (``decode_segments`` in
  interpret mode) on the same ``pack_streams`` / ``lane_tables`` arrays:
  a 4:2:0 stream with one restart segment per MCU row, a corrupted copy
  of it (a flipped bit desynchronizes one lane; a run of one-bits, which
  no canonical code matches, stops another: the length-17 rule), and a
  4:4:4 stream with a short final segment;
* the device route's coefficients against the host decoder's at every
  sampling, with fixed and per-image tables;
* ``reconstruct*`` against ``jpeg_tpu``'s jitted CPU functions on the same
  coefficients, and ``decode_jpeg`` / ``decode_jpeg_batch`` against
  ``jpeg_tpu``'s host-entropy ``decode_jpeg``;
* the routing rules.

Every comparison is exact (see ``JIT_FMA_FLIPS`` for the one place where
``jpeg_tpu``'s jitted CPU decode differs from its own arithmetic).  Inputs
are 64x64 to 128x96.
"""
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.golden import decoder as jgolden
from jpeg_tpu.kernels import huffdec as jhd
from jpeg_tpu.pipelines import decode as jdec
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu_torch import decode_jpeg, decode_jpeg_batch
from jpeg_tpu_torch.kernels import huffdec as hd
from jpeg_tpu_torch.kernels import launch_counts, reset_launch_counts
from jpeg_tpu_torch.pipelines import decode as dec

from test_torch_ops import synthetic_images

PIL = pytest.importorskip("PIL.Image")


def _restart_file(samp, huffman, h=64, w=64, rows=1, seed=3):
    cfg = JaxConfig(scan_layout="interleaved", huffman=huffman,
                    restart_interval_mcu_rows=rows, engine="xla",
                    subsampling=samp)
    img = synthetic_images(seed, 1, h, w)[0]
    return bytes(JaxJpegEncoder(cfg).encode(img))


def _pil_file(img, **kw):
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _gray_file(optimize):
    """A gray restart stream (PIL; ``encode_gray`` writes no restarts):
    standard or per-image ("optimize") tables, 3 MCU rows per segment."""
    img = synthetic_images(7, 1, 64, 64)[0, ..., 1]
    return _pil_file(img, quality=90, restart_marker_rows=3,
                     optimize=optimize)


def _quad(st):
    tabs = st["tabs"]
    c0 = st["comps"][0][0]
    c1 = st["comps"][min(1, len(st["comps"]) - 1)][0]
    return (st["dht"][(0, tabs[c0][0])], st["dht"][(1, tabs[c0][1])],
            st["dht"][(0, tabs[c1][0])], st["dht"][(1, tabs[c1][1])])


def _k16_inputs(data, samp):
    """jpeg_tpu's arrays for its decode_segments: 128-lane padded,
    power-of-two words."""
    st = jhd.parse_scan_structure(data)
    info = jdec._parse_device_eligible(data)
    segs = jhd.unstuff_segments(st["entropy"])
    streams, active, max_words = jhd.pack_streams(segs)
    maxc, delt, hvp = jhd.lane_tables([_quad(st)] * len(segs))
    nblk_lane = np.zeros_like(active)
    nblk_lane[0, :len(segs)] = info["nblk"]
    return (streams, maxc, delt, hvp, nblk_lane, samp,
            info["ri"] * info["period"], max_words)


def _corrupt(args):
    """Lane 1: one flipped bit; lane 2: 64 one-bits mid-stream."""
    streams = args[0].copy()
    streams[1, 20] ^= 1 << 7
    streams[2, 30:32] = -1
    return (streams,) + args[1:]


@pytest.fixture(scope="module")
def k16_cases():
    """name -> (the K16 arguments, jpeg_tpu's interpret-mode output)."""
    base = _k16_inputs(_restart_file("420", "dynamic", seed=11), "420")
    img = synthetic_images(13, 1, 64, 64)[0]
    short = _k16_inputs(_pil_file(img, quality=90, subsampling=0,
                                  restart_marker_blocks=5), "444")
    cases = {}
    for name, args in (("420-r1", base), ("corrupted", _corrupt(base)),
                       ("444-short-final", short)):
        out = jhd.decode_segments(*(jnp.asarray(a) for a in args[:5]),
                                  *args[5:], interpret=True)
        cases[name] = (args, np.asarray(out))
    return cases


@pytest.mark.parametrize("name", ["420-r1", "corrupted", "444-short-final"])
def test_decode_segments_twin_matches_k16(k16_cases, name):
    args, want = k16_cases[name]
    nblk_seg = args[6]
    got = hd.decode_segments(*(torch.from_numpy(a) for a in args[:5]),
                             *args[5:]).numpy()
    assert got.shape == (want.shape[0], nblk_seg, 64)
    np.testing.assert_array_equal(got, want[:, :nblk_seg])
    assert not want[:, nblk_seg:].any()  # jpeg_tpu's grid padding
    if name == "corrupted":
        clean = k16_cases["420-r1"][1][:, :nblk_seg]
        assert (got[1] != clean[1]).any() and (got[2] != clean[2]).any()
        assert np.array_equal(got[[0, 3]], clean[[0, 3]])
        # lane 2 reached the one-bits in its block 19 and stopped there:
        # every later block, DC included, is zero (its clean ones are not)
        assert not got[2, 20:].any() and clean[2, 20:].any(axis=1).all()
    if name == "444-short-final":
        nblk = args[4][0]
        S = int((nblk > 0).sum())
        assert nblk[S - 1] < nblk_seg and not got[S - 1, nblk[S - 1]:].any()


def test_port_packing_decodes_the_same(k16_cases):
    """The port's exact packing (S rows, the words needed) gives the
    same coefficients as jpeg_tpu's padded arrays."""
    args, want = k16_cases["444-short-final"]
    data = _pil_file(synthetic_images(13, 1, 64, 64)[0], quality=90,
                     subsampling=0, restart_marker_blocks=5)
    info = dec._parse_device_eligible(data)
    zz = dec._decode_lanes([info], torch.device("cpu")).numpy()
    S = len(info["segs"])
    assert zz.shape == (S, args[6], 64)
    np.testing.assert_array_equal(zz, want[:S, :args[6]])


def _emission_oracle(data, samp):
    """jpeg_tpu's host coefficients (``parse_coefficients``) per plane."""
    comps, coeffs, *_ = jgolden.parse_coefficients(data)
    return [coeffs[c.comp_id] for c in comps]


DEVICE_STREAMS = {
    f"{samp}-{huff}": (lambda samp=samp, huff=huff:
                       _restart_file(samp, huff, rows=2 if samp == "420"
                                     else 1))
    for samp in ("420", "422", "444") for huff in ("fixed", "dynamic")}
DEVICE_STREAMS["gray-fixed"] = lambda: _gray_file(False)
DEVICE_STREAMS["gray-dynamic"] = lambda: _gray_file(True)


@pytest.mark.parametrize("name", sorted(DEVICE_STREAMS))
def test_device_entropy_zz_equals_host_coefficients(name):
    data = DEVICE_STREAMS[name]()
    dev = dec.device_entropy_zz(data, device="cpu")
    assert dev is not None
    y, cb, cr, ql, qc, dims, true_dims, samp = dev
    assert samp == name.split("-")[0]
    want = _emission_oracle(data, samp)
    got = [y] if samp == "gray" else [y, cb, cr]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def planes():
    """Host coefficients of one stream per sampling, and a second 4:2:0
    image for the batched functions."""
    out = {}
    for samp in ("420", "422", "444"):
        data = _restart_file(samp, "dynamic", seed=17)
        comps, coeffs, quant, w, h = jgolden.parse_coefficients(data)
        out[samp] = ([coeffs[c.comp_id] for c in comps],
                     quant[comps[0].quant_id], quant[comps[1].quant_id],
                     h, w)
    comps, coeffs, quant, w, h = jgolden.parse_coefficients(
        _restart_file("420", "fixed", seed=19))
    out["420b"] = ([coeffs[c.comp_id] for c in comps],
                   quant[comps[0].quant_id], quant[comps[1].quant_id], h, w)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("fn", ["reconstruct-420", "reconstruct-422",
                                "reconstruct-444", "reconstruct_420",
                                "reconstruct_gray", "reconstruct_batch",
                                "reconstruct_gray_batch"])
def test_reconstruct_matches_jax(planes, fn):
    name, _, samp = fn.partition("-")
    (y, cb, cr), ql, qc, h, w = planes[samp or "420"]
    if name == "reconstruct":
        want = jdec.reconstruct(y, cb, cr, ql, qc, h, w, samp=samp)
        got = dec.reconstruct(*_t(y, cb, cr), ql, qc, h, w, samp=samp)
    elif name == "reconstruct_420":
        want = jdec.reconstruct_420(y, cb, cr, ql, qc, h, w)
        got = dec.reconstruct_420(*_t(y, cb, cr, ql, qc), h, w)
    elif name == "reconstruct_gray":
        want = jdec.reconstruct_gray(y, ql, h, w)
        got = dec.reconstruct_gray(*_t(y, ql), h, w)
    else:
        (y2, cb2, cr2), ql2, qc2, _, _ = planes["420b"]
        ys, qls = np.stack([y, y2]), np.stack([ql, ql2])
        if name == "reconstruct_gray_batch":
            want = jdec.reconstruct_gray_batch(ys, qls, h, w)
            got = dec.reconstruct_gray_batch(*_t(ys, qls), h, w)
        else:
            args = (ys, np.stack([cb, cb2]), np.stack([cr, cr2]), qls,
                    np.stack([qc, qc2]))
            want = jdec.reconstruct_batch(*args, h, w, samp="420")
            got = dec.reconstruct_batch(*_t(*args), h, w, samp="420")
    want = np.asarray(want)
    assert got.dtype == torch.uint8
    diff = int((got.numpy() != want).sum())
    assert diff == 0, f"{fn}: {diff} of {want.size} values differ"


# Under jit, XLA:CPU contracts jpeg_tpu's color conversion (y + 1.772 * cb
# and the like) into FMAs, which its code does not write and its golden f64
# decoder does not do (ROADMAP §3).  Un-jitted, jpeg_tpu computes what it
# writes.  The port equals that exactly, and the jitted result everywhere
# but at these values (input -> count), where it agrees with the golden
# decoder.
JIT_FMA_FLIPS = {"batch stream 6: PIL progressive 64x64 q80, "
                 "synthetic_images(26)": 1,
                 "batch stream 7: jpeg_tpu 3-scan 64x64, "
                 "synthetic_images(27)": 1}


def _jax_host(data):
    """jpeg_tpu's host-entropy decode_jpeg: (un-jitted, jitted)."""
    with jax.disable_jit():
        eager = np.asarray(jdec.decode_jpeg(data, entropy_engine="host"))
    return eager, np.asarray(jdec.decode_jpeg(data, entropy_engine="host"))


def _check_against_jax(got, data, label):
    eager, jitted = _jax_host(data)
    got = got.numpy()
    assert got.shape == eager.shape == jitted.shape, label
    diff = int((got != eager).sum())
    assert diff == 0, f"{label}: {diff} of {eager.size} values differ"
    flips = got != jitted
    known = next((n for k, n in JIT_FMA_FLIPS.items()
                  if k.startswith(label + ":")), 0)
    assert int(flips.sum()) == known, \
        f"{label}: {int(flips.sum())} values differ from jpeg_tpu's jitted " \
        f"decode, {known} known"
    if flips.any():
        golden = jgolden.decode(data)
        assert np.array_equal(got[flips], golden[flips])
        assert (np.abs(got.astype(int) - jitted)[flips] == 1).all()
    return jitted


@pytest.mark.parametrize("name", ["420-dynamic", "422-fixed", "444-dynamic",
                                  "gray-dynamic"])
def test_decode_jpeg_matches_jax_host(name):
    data = DEVICE_STREAMS[name]()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an eligible stream never warns
        got = decode_jpeg(data, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = _check_against_jax(got, data, name)
    np.testing.assert_array_equal(
        decode_jpeg(data, entropy_engine="host", device="cpu").numpy(), want)


def test_decode_jpeg_batch_matches_jax_host():
    """Mixed samplings, geometries and table modes, a foreign (PIL)
    restart stream with a short final segment, a progressive stream and a
    non-restart 3-scan stream (the speculative route), in one batch."""
    datas = [_restart_file("420", "fixed", 128, 96, rows=2, seed=21),
             _restart_file("420", "dynamic", 64, 64, rows=1, seed=22),
             _restart_file("422", "fixed", 64, 96, rows=2, seed=23),
             _restart_file("444", "dynamic", 64, 64, rows=4, seed=24),
             _gray_file(True),
             _pil_file(synthetic_images(25, 1, 80, 96)[0], quality=85,
                       subsampling=2, restart_marker_rows=2),
             _pil_file(synthetic_images(26, 1, 64, 64)[0], quality=80,
                       progressive=True),
             bytes(JaxJpegEncoder(JaxConfig()).encode(
                 synthetic_images(27, 1, 64, 64)[0]))]
    host = {6}  # progressive: no device route
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = decode_jpeg_batch(datas, device="cpu")
    warned = sorted(int(str(w.message).split()[1].rstrip(":"))
                    for w in caught)
    assert warned == sorted(host)
    for i, (g, d) in enumerate(zip(got, datas)):
        _check_against_jax(g, d, f"batch stream {i}")
    with pytest.raises(ValueError, match="stream 6"):
        decode_jpeg_batch(datas, entropy_engine="device", device="cpu")


def test_device_engine_raises_on_non_restart_stream():
    """A stream no device route takes (progressive) raises jpeg_tpu's
    ValueError under "device" and warns under "auto"; a 3-scan stream
    without restarts decodes on the speculative route, with no warning."""
    prog = _pil_file(synthetic_images(31, 1, 64, 64)[0], quality=80,
                     progressive=True)
    with pytest.raises(ValueError) as want:
        jdec.decode_jpeg(prog, entropy_engine="device", interpret=True)
    with pytest.raises(ValueError) as got:
        decode_jpeg(prog, entropy_engine="device", device="cpu")
    assert str(got.value) == str(want.value)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decode_jpeg(prog, device="cpu")
    assert len(caught) == 1 and \
        str(caught[0].message) == dec._HOST_FALLBACK
    data = bytes(JaxJpegEncoder(JaxConfig()).encode(
        synthetic_images(31, 1, 64, 64)[0]))  # 3-scan, no restarts
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = decode_jpeg(data, device="cpu")
        dev = decode_jpeg(data, entropy_engine="device", device="cpu")
    assert torch.equal(out, dev)
    _check_against_jax(out, data, "3-scan 64x64")


class _CardMesh:
    """A stand-in for a mesh of CUDA ranks."""
    device_type = "cuda"


def test_argument_errors():
    data = _restart_file("420", "fixed")
    for fn in (decode_jpeg, decode_jpeg_batch):
        arg = data if fn is decode_jpeg else [data]
        with pytest.raises(ValueError, match="unknown entropy_engine 'x'"):
            fn(arg, entropy_engine="x", device="cpu")
    with pytest.raises(ValueError, match="a cuda mesh cannot decode on cpu"):
        decode_jpeg_batch([data], mesh=_CardMesh(), device="cpu")
    args = _t(*_k16_inputs(data, "420")[:5])
    with pytest.raises(ValueError, match="unknown sampling '411'"):
        hd.decode_segments(*args, "411", 12, args[0].shape[1])


def test_eligible_four_segment_stream_takes_kernel_g(monkeypatch):
    """A 4-segment stream (jpeg_tpu sends it to its host decoder under
    "auto", below its 48-segment threshold) decodes through kernel G's
    wrapper: on the CPU that is its plain twin, and nothing launches."""
    data = _restart_file("420", "fixed", 64, 64, rows=1)
    assert len(dec._parse_device_eligible(data)["segs"]) == 4
    calls = []
    twin = hd.decode_segments_plain

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return twin(*args, **kw)
    monkeypatch.setattr(hd, "decode_segments_plain", spy)
    reset_launch_counts()
    got = decode_jpeg(data, device="cpu")
    assert calls == [(4, calls[0][1])]
    got_b = decode_jpeg_batch([data, data], device="cpu")
    assert len(calls) == 2 and calls[1][0] == 8  # one launch, 8 lanes
    assert launch_counts()["decode_segments"] == 0
    for g in (got, *got_b):
        _check_against_jax(g, data, "4:2:0 64x64 r1")
