"""The port's speculative decode (``jpeg_tpu_torch.pipelines.speculative``,
kernel H's twin ``kernels.huffdec.scan_positions_plain`` and kernel G's twin
in its entry-bit and MCU-phase mode) against ``jpeg_tpu``'s.

* (a) H's twin against ``jpeg_tpu``'s K17 (``scan_positions`` in interpret
  mode) on the same arrays: a gray and a phased 4:2:0 input with true
  entries, entries inside a code, an entry past its limit, a capped lane
  and a lane on bits no code matches;
* (b) G's twin against ``jpeg_tpu``'s K16 in interpret mode with ``entry``
  (gray) and with ``entry``/``phase``/``phased`` (4:2:0);
* (c) the fixpoint: ``jpeg_tpu``'s own ``_spec_scans`` run on the port's
  twins (its kernel entry points monkeypatched to adapters) against the
  port's ``_spec_scans``: the same ``None`` decisions and coefficients on
  clean gray, 3-scan and DRI-less interleaved streams, four corrupt
  copies and a case that needs the block cap's retry;
* (d) the entry points end to end on the CPU: coefficients equal to the
  native decoder's, RGB equal to ``jpeg_tpu``'s host decode run un-jitted
  (its jitted decode contracts the color conversion into FMAs,
  ``test_torch_decode.JIT_FMA_FLIPS``);
* (e) the routes and the fallback rule.

The interpret-mode kernels run four times in all (module fixtures).
Inputs are 32x32 to 64x96 (the cap case adds 128x192 of flat gray).
"""
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.kernels import huffdec as jhd
from jpeg_tpu.pipelines import decode as jdec
from jpeg_tpu.pipelines import speculative as jspec
from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
from jpeg_tpu_torch import decode_jpeg, decode_jpeg_batch
from jpeg_tpu_torch.golden import decoder as golden
from jpeg_tpu_torch.kernels import huffdec as hd
from jpeg_tpu_torch.kernels import launch_counts, reset_launch_counts
from jpeg_tpu_torch.pipelines import decode as dec
from jpeg_tpu_torch.pipelines import speculative as spec

from test_torch_ops import synthetic_images

PIL = pytest.importorskip("PIL.Image")

LANE_BYTES = 128  # the fixpoint tests' explicit chunk size: several lanes


def _pil(img, **kw):
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _corrupt_copies(data):
    """``tests/test_speculative.py``'s corruption: 4 copies, each with 3
    random bytes of its second half replaced (``default_rng(7)``)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(4):
        d = bytearray(data)
        for _k in range(3):
            d[int(rng.integers(len(d) // 2, len(d) - 2))] = \
                int(rng.integers(0, 256))
        out.append(bytes(d))
    return out


@pytest.fixture(scope="module")
def streams():
    """name -> JPEG bytes: a gray PIL file, jpeg_tpu's 3-scan 4:2:0 file,
    DRI-less interleaved PIL files at 4:2:0, 4:2:2 and 4:4:4 (and wider
    gray and 4:2:0 ones for the kernels' lanes, which want more than 64
    blocks a scan), the four
    corrupt copies of the gray file, a copy with a run of one-bits, and a
    4-segment restart stream."""
    gray = _pil(synthetic_images(41, 1, 64, 64)[0, ..., 1], quality=90)
    out = {"gray": gray,
           "gray-wide": _pil(synthetic_images(51, 1, 64, 96)[0, ..., 1],
                             quality=90),
           "3scan": bytes(JaxJpegEncoder(JaxConfig()).encode(
               synthetic_images(45, 1, 48, 48)[0]))}
    for samp, pil_samp, (h, w) in (("420", 2, (48, 48)),
                                   ("420-wide", 2, (64, 64)),
                                   ("422", 1, (32, 48)),
                                   ("444", 0, (32, 32))):
        out[samp] = _pil(synthetic_images(47, 1, h, w)[0], quality=90,
                         subsampling=pil_samp)
    for k, d in enumerate(_corrupt_copies(gray)):
        out[f"corrupt{k}"] = d
    # 48 one-bits (stuffed) a quarter into the gray scan: no code matches
    # there, so that lane's chain breaks at any lane size
    ent = jhd.parse_noninterleaved_scans(gray)["scans"][0]["entropy"]
    cut = gray.index(ent) + len(ent) // 4
    cut += gray[cut - 1] == 0xFF  # not inside a stuffed pair
    out["ones"] = gray[:cut] + b"\xff\x00" * 6 + gray[cut:]
    cfg = JaxConfig(scan_layout="interleaved", huffman="dynamic",
                    restart_interval_mcu_rows=1, engine="xla")
    out["restart"] = bytes(JaxJpegEncoder(cfg).encode(
        synthetic_images(49, 1, 64, 64)[0]))
    return out


@pytest.fixture(scope="module")
def eager_host(streams):
    """name -> jpeg_tpu's host-entropy decode_jpeg, run un-jitted."""
    out = {}
    with jax.disable_jit():
        for name in ("gray", "3scan", "420", "422", "444", "restart"):
            out[name] = np.asarray(jdec.decode_jpeg(streams[name],
                                                    entropy_engine="host"))
    return out


# -- (a), (b): the kernels' twins against jpeg_tpu's interpret mode ----------

def _scan_of(data, sampling):
    """One scan's un-stuffed bytes and its table quad."""
    if sampling == "gray":
        sc = jhd.parse_noninterleaved_scans(data)["scans"][0]
        return (jhd.unstuff_segments(sc["entropy"])[0],
                (sc["dc_spec"], sc["ac_spec"], sc["dc_spec"], sc["ac_spec"]))
    st = jhd.parse_scan_structure(data, require_restarts=False)
    (c0, *_), (c1, *_), _ = st["comps"]
    (dc0, ac0), (dc1, ac1) = st["tabs"][c0], st["tabs"][c1]
    dht = st["dht"]
    return (jhd.unstuff_segments(st["entropy"])[0],
            (dht[(0, dc0)], dht[(1, ac0)], dht[(0, dc1)], dht[(1, ac1)]))


def _lane_case(data, sampling):
    """jpeg_tpu's arrays (128-lane padded) for K17 and K16 over one
    scan's chunks: (streams, maxc, delt, hvp, entry, limit, phase,
    max_words, lanes in use).

    Lanes 0-7 start at their chunk's byte: even lanes at the true entry
    bit and phase (from a walk of the whole scan), odd lanes inside a
    code (3 or 13 bits on) with phase 0.  Lane 8 starts past its limit;
    lane 9 walks the whole scan from bit 0 (capped at 64 blocks); lane 10
    is lane 0's row with 64 one-bits at its word 4 (no code matches)."""
    b, quad = _scan_of(data, sampling)
    period = len(jhd._PATTERN[sampling])
    n = 8
    o = np.linspace(0, len(b), n + 1).round().astype(np.int64)
    # true block boundaries: a lane over the whole scan stops at the first
    # block that starts at or past its limit
    whole, wmw = hd.pack_streams([b] * n)
    tabs = [torch.from_numpy(a) for a in hd.lane_tables([quad] * n)]
    ex, ct, _ = hd.scan_positions_plain(
        torch.from_numpy(whole), *tabs, torch.zeros((1, n), dtype=torch.int32),
        torch.from_numpy(8 * o[None, :n].astype(np.int32)), 1 << 14, wmw,
        sampling, torch.zeros((1, n), dtype=torch.int32))
    rows, entry, limit, phase = [], [], [], []
    for k, (s, e) in enumerate(zip(o[:-1], o[1:])):
        rows.append(b[s:min(e + 384, len(b))])
        limit.append(8 * (e - s))
        if k % 2 == 0:
            entry.append(int(ex[k]) - 8 * s)
            phase.append(int(ct[k]) % period)
        else:
            entry.append(3 if k % 4 == 1 else 13)
            phase.append(0)
    rows += [rows[1], b, rows[0].copy()]
    entry += [limit[1] + 5, 0, 0]
    limit += [limit[1], 8 * len(b), limit[0]]
    phase += [0, 0, 0]
    rows[10][16:24] = 0xFF
    S = len(rows)
    streams, _, mw = jhd.pack_streams(rows)
    maxc, delt, hvp = jhd.lane_tables([quad] * S)
    Sp = streams.shape[0]

    def row(v):
        r = np.zeros((1, Sp), np.int32)
        r[0, :S] = v
        return r
    return (streams, maxc, delt, hvp, row(entry), row(limit), row(phase),
            mw, S)


@pytest.fixture(scope="module")
def k17_cases(streams):
    """sampling -> (the lane case, jpeg_tpu's interpret-mode K17 output)."""
    out = {}
    for sampling, name in (("gray", "gray-wide"), ("420", "420-wide")):
        case = _lane_case(streams[name], sampling)
        st, mc, dl, hv, entry, limit, phase, mw, _ = case
        want = jhd.scan_positions(
            *(jnp.asarray(a) for a in (st, mc, dl, hv, entry, limit)),
            cap_blocks=64, max_words=mw, sampling=sampling,
            phase=jnp.asarray(phase), interpret=True)
        out[sampling] = (case, [np.asarray(w) for w in want])
    return out


@pytest.mark.parametrize("sampling", ["gray", "420"])
def test_scan_positions_twin_matches_k17(k17_cases, sampling):
    case, want = k17_cases[sampling]
    st, mc, dl, hv, entry, limit, phase, mw, S = case
    got = hd.scan_positions(*(torch.from_numpy(a) for a in
                              (st, mc, dl, hv, entry, limit)),
                            64, mw, sampling, torch.from_numpy(phase))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    exits, counts, bad = want
    lim = limit[0]
    # the lanes show every rule: true entries walk to their limit; an
    # entry past its limit walks nothing; the whole-scan lane stops at the
    # cap short of its limit; the one-bits stop their lane, marked bad
    assert (exits[0:8:2] >= lim[0:8:2]).all() and not bad[:8:2].any()
    assert exits[8] == entry[0, 8] and counts[8] == 0 and not bad[8]
    assert counts[9] == 64 and exits[9] < lim[9] and not bad[9]
    assert bad[10] and counts[10] < counts[0] and exits[10] < lim[10]
    # the port's exact packing (S rows, the words needed) agrees
    rows = [np.frombuffer(st[k].astype(">u4").tobytes(), np.uint8)
            for k in range(S)]
    words, pmw = hd.pack_streams(rows)
    again = hd.scan_positions_plain(
        torch.from_numpy(words), torch.from_numpy(mc[:, :S].copy()),
        torch.from_numpy(dl[:, :S].copy()), torch.from_numpy(hv[:S]),
        *(torch.from_numpy(a[:, :S].copy()) for a in (entry, limit)), 64,
        pmw, sampling, torch.from_numpy(phase[:, :S].copy()))
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g.numpy(), w[:S])


@pytest.fixture(scope="module")
def k16_spec_cases(k17_cases):
    """sampling -> (arguments, jpeg_tpu's interpret-mode K16 output): the
    K17 lanes with each one's block count from K17, from its entry (and
    phase, phased, for 4:2:0)."""
    out = {}
    for sampling in ("gray", "420"):
        (st, mc, dl, hv, entry, _, phase, mw, S), (_, counts, _) = \
            k17_cases[sampling]
        nblk = np.zeros_like(entry)
        nblk[0, :S] = counts[:S]
        nblk_seg = int(counts.max())
        phased = sampling != "gray"
        # peel_luma is TPU scheduling only (any value decodes alike); 0
        # halves the interpret-mode compile
        want = jhd.decode_segments(
            *(jnp.asarray(a) for a in (st, mc, dl, hv, nblk)), sampling,
            nblk_seg, mw, interpret=True, entry=jnp.asarray(entry),
            phase=jnp.asarray(phase) if phased else None, phased=phased,
            peel_luma=0)
        out[sampling] = ((st, mc, dl, hv, nblk, sampling, nblk_seg, mw,
                          entry, phase if phased else None, phased),
                         np.asarray(want))
    return out


@pytest.mark.parametrize("sampling", ["gray", "420"])
def test_decode_segments_speculative_twin_matches_k16(k16_spec_cases,
                                                      sampling):
    args, want = k16_spec_cases[sampling]
    st, mc, dl, hv, nblk, samp, nblk_seg, mw, entry, phase, phased = args
    got = hd.decode_segments(
        *(torch.from_numpy(a) for a in (st, mc, dl, hv, nblk)), samp,
        nblk_seg, mw, entry=torch.from_numpy(entry),
        phase=None if phase is None else torch.from_numpy(phase),
        phased=phased).numpy()
    np.testing.assert_array_equal(got, want[:, :nblk_seg])
    assert not want[:, nblk_seg:].any()  # jpeg_tpu's grid padding
    assert got[:8].any(axis=2).any(axis=1).all()  # every lane decoded
    if phased:  # the phase moves the tables: phase 0 everywhere differs
        flat = hd.decode_segments(
            *(torch.from_numpy(a) for a in (st, mc, dl, hv, nblk)), samp,
            nblk_seg, mw, entry=torch.from_numpy(entry)).numpy()
        assert (flat != got).any()


# -- (c): the fixpoint against jpeg_tpu's driver on the port's twins ---------

def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def jax_driver_on_twins(monkeypatch):
    """jpeg_tpu's ``_spec_scans`` with its kernels replaced by adapters
    over the port's twins; returns the caps its positions calls used."""
    caps = []

    def positions(streams, maxc, delt, hvp, entry, limit, cap_blocks,
                  max_words, sampling="gray", phase=None, interpret=False):
        caps.append(cap_blocks)
        got = hd.scan_positions_plain(
            *map(_t, (streams, maxc, delt, hvp, entry, limit)), cap_blocks,
            max_words, sampling, None if phase is None else _t(phase))
        return tuple(g.numpy() for g in got)

    def payload(streams, maxc, delt, hvp, nblk_lane, sampling, nblk_seg,
                max_words, interpret=False, entry=None, phase=None,
                phased=False, peel_luma=None):
        return hd.decode_segments_plain(
            *map(_t, (streams, maxc, delt, hvp, nblk_lane)), sampling,
            nblk_seg, max_words, None if entry is None else _t(entry),
            None if phase is None else _t(phase), phased).numpy()

    monkeypatch.setattr(jhd, "scan_positions", positions)
    monkeypatch.setattr(jhd, "decode_segments", payload)
    return caps


def _spec_case(streams, name):
    """(scan_list, sampling) of a fixpoint case, or None where the stream
    does not parse (both packages' parsers agree on that)."""
    if name == "cap-retry":
        # a flat scan (384 blocks in ~290 bytes: 2 lanes of 192 blocks)
        # beside a busy one (13 lanes of about 5 blocks): the first cap,
        # 128, is short for the flat lanes, the retry's 512 is not
        scans = []
        for img in (np.full((128, 192), 120, np.uint8),
                    synthetic_images(43, 1, 64, 64)[0, ..., 0]):
            p = spec._parse_spec(_pil(img, quality=90))
            scans += p["scan_list"]
        return scans, "gray"
    p = spec._parse_spec(streams[name])
    jp = jspec._parse_spec(streams[name])
    assert (p is None) == (jp is None)
    return None if p is None else (p["scan_list"], p["sampling"])


SPEC_CASES = ["gray", "3scan", "420", "422", "444", "corrupt0", "corrupt1",
              "corrupt2", "corrupt3", "cap-retry"]


@pytest.mark.parametrize("name", SPEC_CASES)
def test_fixpoint_matches_jax_driver(streams, jax_driver_on_twins, name):
    case = _spec_case(streams, name)
    if case is None:
        pytest.fail(f"{name}: the stream no longer parses")
    scan_list, sampling = case
    want = jspec._spec_scans(scan_list, target_lane_bytes=LANE_BYTES,
                             min_lanes=1, sampling=sampling)
    reset_launch_counts()
    got = spec._spec_scans(scan_list, device="cpu",
                           target_lane_bytes=LANE_BYTES, sampling=sampling)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert (got is None) == (want is None), name
    if name == "cap-retry":
        caps = jax_driver_on_twins
        assert caps[0] == 128 and caps[-1] == 4 * caps[0]
    if got is None:
        assert name.startswith("corrupt")
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    if name in ("gray", "3scan", "420", "422", "444"):
        # the native host decoder's coefficients, plane by plane
        comps, coeffs, *_ = golden.parse_coefficients(streams[name])
        if sampling == "gray":
            planes = [g for g in got]
        else:
            p = spec._parse_spec(streams[name])
            em = got[0].reshape(p["mx"] * p["my"], -1, 64)
            planes = dec._em_to_planes(em, sampling, p["mx"], p["my"])
        for plane, comp in zip(planes, comps):
            np.testing.assert_array_equal(plane.numpy(),
                                          coeffs[comp.comp_id])


def test_fixpoint_decisions_on_corrupt_copies(streams):
    """The four copies cover both decisions (None, and an accepted decode
    of the corrupt bits that keeps the block count), as in jpeg_tpu."""
    got = [spec._spec_scans(_spec_case(streams, f"corrupt{k}")[0],
                            device="cpu", target_lane_bytes=LANE_BYTES)
           for k in range(4)]
    assert any(g is None for g in got)
    assert any(g is not None and g[0].shape == (64, 64) for g in got)


# -- (d): the entry points end to end ----------------------------------------

def _equal_rgb(got: torch.Tensor, want: np.ndarray, label: str):
    assert got.dtype == torch.uint8 and got.device.type == "cpu", label
    got = got.numpy()
    assert got.shape == want.shape, label
    diff = int((got != want).sum())
    assert diff == 0, f"{label}: {diff} of {want.size} values differ"


@pytest.mark.parametrize("name", ["gray", "3scan", "420", "422", "444"])
def test_decode_jpeg_matches(streams, eager_host, name):
    """decode_jpeg's own lane split (one to a few lanes a scan here)."""
    data = streams[name]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the card's route: no warning
        _equal_rgb(decode_jpeg(data, device="cpu"), eager_host[name], name)


def test_speculative_decode_batch_salvages(streams, eager_host):
    """A corrupt stream that does not converge fails the combined call of
    its sampling; the others of that group are decoded one by one."""
    names = ["gray", "3scan", "ones", "420", "444"]
    reset_launch_counts()
    got = spec.speculative_decode_batch([streams[n] for n in names],
                                        device="cpu",
                                        target_lane_bytes=LANE_BYTES)
    for n, g in zip(names, got):
        if n == "ones":
            assert g is None
        else:
            _equal_rgb(g, eager_host[n], n)


def test_decode_jpeg_batch_mixed_routes(streams, eager_host):
    names = ["3scan", "restart", "gray", "422", "420", "3scan"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = decode_jpeg_batch([streams[n] for n in names], device="cpu")
    for n, g in zip(names, got):
        _equal_rgb(g, eager_host[n], n)


def test_speculative_decode_restart(streams, eager_host):
    """Each restart segment a chain of lanes, its DC base reset: the
    image equals kernel G's route and jpeg_tpu's."""
    data = streams["restart"]
    info = dec._parse_device_eligible(data)
    assert len(info["segs"]) == 4
    calls = []
    twin = hd.scan_positions_plain

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return twin(*args, **kw)
    hd.scan_positions_plain = spy
    try:
        got = spec.speculative_decode_restart(data, device="cpu",
                                              target_lane_bytes=64)
    finally:
        hd.scan_positions_plain = twin
    assert calls and calls[0] > len(info["segs"])  # segments split
    _equal_rgb(got, eager_host["restart"], "restart")


def test_speculative_scan_zz_matches_native(streams):
    sc = hd.parse_noninterleaved_scans(streams["gray"])["scans"][0]
    zz = spec.speculative_scan_zz(sc["entropy"], sc["dc_spec"],
                                  sc["ac_spec"], 64, device="cpu",
                                  target_lane_bytes=LANE_BYTES)
    comps, coeffs, *_ = golden.parse_coefficients(streams["gray"])
    np.testing.assert_array_equal(zz.numpy(), coeffs[comps[0].comp_id])


# -- (e): routes and the fallback rule ---------------------------------------

def test_dri_less_stream_takes_h_and_g(streams, monkeypatch):
    """Under "auto" a 3-scan stream goes through H's and G's wrappers (on
    the CPU their twins: nothing launches) and warns nothing."""
    calls = []
    for name in ("scan_positions_plain", "decode_segments_plain"):
        twin = getattr(hd, name)

        def spy(*args, _twin=twin, _name=name, **kw):
            calls.append(_name)
            return _twin(*args, **kw)
        monkeypatch.setattr(hd, name, spy)
    reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        decode_jpeg(streams["3scan"], device="cpu")
    assert calls.count("scan_positions_plain") >= 1
    assert calls[-1] == "decode_segments_plain"
    assert calls.count("decode_segments_plain") == 1
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


def test_non_converging_stream_warns_or_raises(streams, eager_host,
                                               monkeypatch):
    """A stream whose fixpoint does not converge (here: a one-round
    budget for a 3-lane gray scan) goes to the host under "auto", with
    jpeg_tpu's warning, and raises jpeg_tpu's ValueError under
    "device"."""
    monkeypatch.setattr(spec, "_MAX_ROUNDS", 1)
    data = streams["gray"]
    assert spec.speculative_decode(data, device="cpu") is None
    with pytest.warns(UserWarning) as caught:
        got = decode_jpeg(data, device="cpu")
    assert [str(w.message) for w in caught] == [dec._HOST_FALLBACK]
    _equal_rgb(got, eager_host["gray"], "gray on the host")
    with pytest.raises(ValueError, match="not eligible for device"):
        decode_jpeg(data, "device", device="cpu")
    # the 3-scan file's one-lane chains converge in one round: only the
    # gray stream goes to the host, after the salvage
    with pytest.warns(UserWarning, match="stream 1: speculative") as caught:
        got = decode_jpeg_batch([streams["3scan"], data], device="cpu")
    assert len(caught) == 1
    _equal_rgb(got[0], eager_host["3scan"], "3-scan in a batch")
    _equal_rgb(got[1], eager_host["gray"], "gray in a batch")


def test_corrupt_stream_is_refused_not_decoded(streams):
    """A corrupt copy whose chain breaks: "device" raises jpeg_tpu's
    ValueError; "auto" warns, and the host decoder then refuses it."""
    assert spec.speculative_decode(streams["ones"], device="cpu") is None
    with pytest.raises(ValueError, match="not eligible for device"):
        decode_jpeg(streams["ones"], "device", device="cpu")
    with pytest.warns(UserWarning, match="device entropy decode "
                                         "unavailable"):
        with pytest.raises(ValueError, match="malformed"):
            decode_jpeg(streams["ones"], device="cpu")


def test_kernel_errors_are_never_caught(streams, monkeypatch):
    """An exception of H or G propagates: no route catches it."""
    def broken(*args, **kw):
        raise RuntimeError("kernel failed")
    for name in ("scan_positions", "decode_segments"):
        with monkeypatch.context() as m:
            m.setattr(hd, name, broken)
            for call in (lambda: decode_jpeg(streams["3scan"], device="cpu"),
                         lambda: decode_jpeg_batch([streams["420"]],
                                                   device="cpu")):
                with pytest.raises(RuntimeError, match="kernel failed"):
                    call()


def test_mesh_and_sampling_errors(streams):
    card_mesh = type("CardMesh", (), {"device_type": "cuda"})()
    for call in (spec.speculative_decode_batch, spec.speculative_decode):
        arg = [streams["gray"]] if call is spec.speculative_decode_batch \
            else streams["gray"]
        with pytest.raises(ValueError, match="a cuda mesh cannot decode"):
            call(arg, device="cpu", mesh=card_mesh)
    with pytest.raises(ValueError, match="a cuda mesh cannot decode"):
        spec.speculative_decode_restart(streams["restart"], device="cpu",
                                        mesh=card_mesh)
    z = torch.zeros((1, 1), dtype=torch.int32)
    for fn in (lambda: hd.scan_positions(z, z, z, z, z, z, 8, 1, "411"),
               lambda: hd.decode_segments(z, z, z, z, z, "411", 1, 1)):
        with pytest.raises(ValueError, match="unknown sampling '411'"):
            fn()
