"""The port's own copies of jpeg_tpu's host modules against the originals:
tables, configuration, Huffman builders, JFIF headers, the native host
library, the golden decoder and the golden encoder.  Every comparison is
exact equality."""
import ast
import dataclasses

import numpy as np
import pytest

from jpeg_tpu import native as jnative
from jpeg_tpu.bitstream import jfif as jjfif
from jpeg_tpu.core import tables as JT
from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.golden import decoder as jgolden
from jpeg_tpu.golden import encoder as jgolden_enc
from jpeg_tpu.huffman import build as jbuild
from jpeg_tpu.ops import pack as jpack_ops
from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
from jpeg_tpu_torch import EncodeConfig, native
from jpeg_tpu_torch.bitstream import jfif
from jpeg_tpu_torch.core import tables as T
from jpeg_tpu_torch.golden import decoder as golden
from jpeg_tpu_torch.golden import encoder as golden_enc
from jpeg_tpu_torch.huffman import build

from test_torch_ops import synthetic_images


def _tables_equal(got, want):
    for f in ("bits", "huffval", "code", "length"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("quality", [None, 1, 50, 75, 100])
def test_quant_tables_match(quality):
    for got, want in zip(T.quant_tables(quality), JT.quant_tables(quality)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dct_basis_and_constants_match():
    for got, want in zip(T.dct_flat_basis(), JT.dct_flat_basis()):
        np.testing.assert_array_equal(got, want)
    for name in ("SCAN_ORDER", "INV_SCAN_ORDER", "LUMA_QUANTIZER",
                 "CHROMA_QUANTIZER", "RGB_TO_YCBCR", "YCBCR_OFFSET"):
        np.testing.assert_array_equal(getattr(T, name), getattr(JT, name))


def test_fixed_tables_match():
    got, want = build.fixed_tables(), jbuild.fixed_tables()
    assert set(got) == set(want)
    for name in want:
        _tables_equal(got[name], want[name])


def _histograms():
    """Seeded random histograms plus edge cases: one and two symbols,
    all equal, and one of powers of two, whose K.2 tree is a chain deeper
    than 16 bits (so the 16-bit length limiting runs)."""
    rng = np.random.default_rng(11)
    freqs = []
    for _ in range(24):
        f = np.zeros(257, np.int64)
        n_active = int(rng.integers(1, 200))
        idx = rng.choice(256, size=n_active, replace=False)
        f[idx] = rng.integers(1, 100000, size=n_active)
        f[256] = 1
        freqs.append(f)
    one = np.zeros(257, np.int64)
    one[[5, 256]] = [1000, 1]
    two = np.zeros(257, np.int64)
    two[[3, 200, 256]] = [7, 7, 1]
    deep = np.zeros(257, np.int64)
    deep[10:34] = 2 ** np.arange(24)
    deep[256] = 1
    return freqs + [one, two, np.ones(257, np.int64), deep]


def test_native_builder_matches_jpeg_tpu_and_python():
    freqs = np.stack(_histograms())
    deep = build._derive_code_lengths(freqs[-1])
    assert deep.max() > 16  # the limiter really runs
    got = build.build_tables_batch(freqs)
    want = jbuild.build_tables_batch(freqs)
    assert len(got) == len(want) == len(freqs)
    for f, g, w in zip(freqs, got, want):
        _tables_equal(g, w)
        _tables_equal(g, build.build_table(f))
        assert g.length.max() <= 16


def test_builders_reject_empty_histograms():
    empty = np.zeros(257, np.int64)
    empty[256] = 1
    for fn in (build.build_table, lambda f: build.build_tables_batch(f[None])):
        with pytest.raises(ValueError, match="empty symbol histogram"):
            fn(empty)


def test_table_from_spec_matches():
    t = jbuild.build_table(_histograms()[0], allow_native=False)
    _tables_equal(build.table_from_spec(t.bits, t.huffval),
                  jbuild.table_from_spec(t.bits, t.huffval))


@pytest.mark.parametrize("restart_interval", [0, 17], ids=["no-dri", "dri"])
@pytest.mark.parametrize("kind", ["fixed", "built"])
def test_jfif_headers_match(kind, restart_interval):
    if kind == "fixed":
        tables, jtables = build.fixed_tables(), jbuild.fixed_tables()
    else:
        hists = _histograms()[:4]
        names = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
        tables = dict(zip(names, build.build_tables_batch(np.stack(hists))))
        jtables = dict(zip(names, jbuild.build_tables_batch(np.stack(hists))))
    lq, cq = T.quant_tables(75)
    got = jfif.headers(1920, 1088, lq, cq, tables,
                       restart_interval=restart_interval)
    want = jjfif.headers(1920, 1088, lq, cq, jtables,
                         restart_interval=restart_interval)
    assert got == want
    assert jfif.sos_header_interleaved() == jjfif.sos_header_interleaved()
    segs = [b"\x12\x34", b"\xff\x00", b""]
    assert (jfif.assemble_interleaved(got, segs)
            == jjfif.assemble_interleaved(want, segs))


def test_jfif_dri_error_matches():
    with pytest.raises(ValueError) as want:
        jjfif.dri_segment(1 << 16)
    with pytest.raises(ValueError) as got:
        jfif.dri_segment(1 << 16)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_segs", [1, 4])
def test_native_assembly_matches(n_segs):
    rng = np.random.default_rng(5 + n_segs)
    B = 3
    words = rng.integers(0, 1 << 32, size=(B * n_segs, 40),
                         dtype=np.uint64).astype(np.uint32)
    words[:, ::3] |= 0xFF000000  # exercise the 0xFF00 stuffing
    totals = rng.integers(1, 1270, size=B * n_segs).astype(np.int32)
    totals[0] = 1024  # ends on a byte boundary
    heads = [b"\xff\xd8HDR%d" % i for i in range(B)]
    headers = [h + jfif.sos_header_interleaved() for h in heads]
    got = native.assemble_interleaved(words, totals, headers, n_segs)
    got_scans = native.finish_scans(words, totals)
    # jpeg_tpu's native library may be missing (its g++ build, racing with
    # other processes, can fail and then returns None): then its Python
    # fallback is the reference, as in jpeg_tpu's FastBatchEncoder
    want_scans = jnative.finish_scans(words, totals)
    if want_scans is None:
        want_scans = jpack_ops.finish_scans(words, totals)
    want = jnative.assemble_interleaved(words, totals, headers, n_segs)
    if want is None:
        want = [jjfif.assemble_interleaved(
            h, want_scans[i * n_segs:(i + 1) * n_segs])
            for i, h in enumerate(heads)]
    assert got_scans == want_scans
    assert got == want


def test_golden_decoder_matches_on_a_jpeg_tpu_file():
    imgs = synthetic_images(29, 1, 64, 96)
    cfg = JaxConfig(scan_layout="interleaved", huffman="fixed",
                    restart_interval_mcu_rows=2)
    data = JaxEncoder(64, 96, cfg, interpret=True).encode_batch(imgs)[0]
    got, want = golden.decode(data), jgolden.decode(data)
    assert got.shape == (64, 96, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert golden.psnr(imgs[0], got) == jgolden.psnr(imgs[0], want)
    assert golden.psnr(got, got) == float("inf")


def test_encode_config_matches():
    got = {f.name: f.default for f in dataclasses.fields(EncodeConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert got == want
    for bad in (dict(quality=0), dict(quality=101), dict(scan_layout="x"),
                dict(huffman="x"), dict(subsampling="411"),
                dict(dtype="float16"), dict(engine="x")):
        with pytest.raises(ValueError) as w:
            JaxConfig(**bad)
        with pytest.raises(ValueError) as g:
            EncodeConfig(**bad)
        assert str(g.value) == str(w.value)


def test_area_matches():
    from jpeg_tpu.core.types import Area as JaxArea
    from jpeg_tpu_torch import Area
    got = {f.name: f.default for f in dataclasses.fields(Area)}
    want = {f.name: f.default for f in dataclasses.fields(JaxArea)}
    assert got == want
    a, b = Area(16, 32, 64, 48), JaxArea(16, 32, 64, 48)
    assert repr(a) == repr(b)
    assert (a.num_pixels, a.mcus_x, a.mcus_y) == \
        (b.num_pixels, b.mcus_x, b.mcus_y) == (3072, 4, 3)
    for bad in ((0, 0, 24, 16), (0, 0, 16, 8), (-16, 0, 16, 16),
                (0, -1, 16, 16)):
        with pytest.raises(ValueError) as w:
            JaxArea(*bad)
        with pytest.raises(ValueError) as g:
            Area(*bad)
        assert str(g.value) == str(w.value)


@pytest.mark.parametrize("kind", ["fixed", "built"])
def test_jfif_3scan_and_gray_writers_match(kind):
    if kind == "fixed":
        tables, jtables = build.fixed_tables(), jbuild.fixed_tables()
    else:
        names = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
        hists = np.stack(_histograms()[4:8])
        tables = dict(zip(names, build.build_tables_batch(hists)))
        jtables = dict(zip(names, jbuild.build_tables_batch(hists)))
    lq, cq = T.quant_tables(50)
    for args in ((1, 0, 0), (2, 1, 1), (3, 1, 1)):
        assert jfif.sos_header_single(*args) == jjfif.sos_header_single(*args)
    for ri in (0, 40):
        assert jfif.headers_gray(72, 48, lq, tables, restart_interval=ri) \
            == jjfif.headers_gray(72, 48, lq, jtables, restart_interval=ri)
    assert jfif.sof0_segment(33, 17, gray=True) == \
        jjfif.sof0_segment(33, 17, gray=True)
    header = jfif.headers(640, 480, lq, cq, tables)
    assert header == jjfif.headers(640, 480, lq, cq, jtables)
    scans = [b"\x01\x02", b"\xff\x00\x03", b"\x04"]
    assert jfif.assemble_3scan(header, *scans) == \
        jjfif.assemble_3scan(header, *scans)
    restarts = [(80, [b"\x11", b"\x12", b"\x13"]), (40, [b"\x21", b"\x22"]),
                (0, [b"\x31"])]
    assert jfif.assemble_3scan_restarts(header, restarts) == \
        jjfif.assemble_3scan_restarts(header, restarts)
    data = jfif.assemble_3scan(header, *scans)
    assert jfif.patch_sof_dims(data, 630, 475) == \
        jjfif.patch_sof_dims(data, 630, 475)
    assert jfif.patch_sof_dims(data, 630, 475) != data


@pytest.mark.parametrize("data", [b"\xff\xd8\x00\x00\x00\x04",
                                  b"\xff\xd8\xff\xda\x00\x08",
                                  b"\xff\xd8\xff\xe0\x00\x02"])
def test_patch_sof_dims_errors_match(data):
    with pytest.raises(ValueError) as w:
        jjfif.patch_sof_dims(data, 8, 8)
    with pytest.raises(ValueError) as g:
        jfif.patch_sof_dims(data, 8, 8)
    assert str(g.value) == str(w.value)


def test_finish_scan_matches():
    from jpeg_tpu.ops import pack as jpack_ops
    from jpeg_tpu_torch.ops import pack as pack_ops
    rng = np.random.default_rng(71)
    words = rng.integers(0, 1 << 32, size=40, dtype=np.uint64).astype(
        np.uint32)
    words[::4] |= 0xFF000000
    for total in (0, 5, 64, 1000, 1273):
        assert pack_ops.finish_scan(words, total) == \
            jpack_ops.finish_scan(words, total)


@pytest.mark.parametrize("kw", [
    dict(), dict(quality=75), dict(huffman="fixed"),
    dict(scan_layout="interleaved"),
    dict(scan_layout="interleaved", huffman="fixed",
         restart_interval_mcu_rows=2),
    dict(scan_layout="interleaved", restart_interval_mcu_rows=1)],
    ids=["3scan", "3scan-q75", "3scan-fixed", "interleaved",
         "interleaved-fixed-r2", "interleaved-r1"])
def test_golden_encoder_matches(kw):
    for img in synthetic_images(73, 2, 64, 64):
        got, stages = golden_enc.encode(img, return_stages=True, **kw)
        want, jstages = jgolden_enc.encode(img, return_stages=True, **kw)
        assert got == want
        assert stages.keys() == jstages.keys()
        for key in ("y_zigzag", "cb_zigzag", "cr_zigzag", "y_dct"):
            np.testing.assert_array_equal(stages[key], jstages[key])


def test_golden_encoder_reaches_only_the_port_copies():
    import jpeg_tpu_torch.golden.encoder as mod
    tree = ast.parse(open(mod.__file__).read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            imported.add("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
    assert imported == {"__future__", "numpy", "..bitstream", "..core",
                        "..huffman.build"}
    assert mod.jfif is jfif and mod.T is T
    assert mod.build_tables_from_histograms is \
        build.build_tables_from_histograms


def _decode_streams():
    """Restart streams of every sampling (jpeg_tpu's interleaved encoder and
    PIL: a short final segment, gray with per-image tables), a 3-scan
    stream and a progressive one."""
    import io
    from PIL import Image
    from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
    out = {}
    for samp, rows, huff in (("420", 1, "dynamic"), ("422", 2, "fixed"),
                             ("444", 1, "dynamic")):
        cfg = JaxConfig(scan_layout="interleaved", huffman=huff,
                        restart_interval_mcu_rows=rows, engine="xla",
                        subsampling=samp)
        out[f"{samp}-r{rows}-{huff}"] = bytes(JaxJpegEncoder(cfg).encode(
            synthetic_images(81, 1, 64, 96)[0]))
    img = synthetic_images(83, 1, 72, 88)[0]
    for name, mode, kw in (
            ("pil-444-short-final", "RGB",
             dict(subsampling=0, restart_marker_blocks=5)),
            ("pil-gray-optimized", "L",
             dict(restart_marker_rows=2, optimize=True)),
            ("pil-progressive", "RGB", dict(progressive=True)),
            ("pil-progressive-444", "RGB",
             dict(progressive=True, subsampling=0))):
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(
            buf, "JPEG", quality=85, **kw)
        out[name] = buf.getvalue()
    out["3scan"] = bytes(JaxJpegEncoder(JaxConfig()).encode(
        synthetic_images(85, 1, 64, 64)[0]))
    return out


def test_golden_decoder_and_native_decode_scan_match_on_every_layout():
    """The port's golden decoder (its native baseline scans and the
    progressive scans) gives the original's coefficients and pixels."""
    for name, data in _decode_streams().items():
        comps, coeffs, quant, w, h = golden.parse_coefficients(data)
        jcomps, jcoeffs, jquant, jw, jh = jgolden.parse_coefficients(data)
        assert (w, h) == (jw, jh), name
        assert [(c.comp_id, c.h_samp, c.v_samp, c.quant_id, c.bw, c.bh)
                for c in comps] == [(c.comp_id, c.h_samp, c.v_samp,
                                     c.quant_id, c.bw, c.bh)
                                    for c in jcomps], name
        assert coeffs.keys() == jcoeffs.keys(), name
        for k in coeffs:
            np.testing.assert_array_equal(coeffs[k], jcoeffs[k], err_msg=name)
        for k in quant:
            np.testing.assert_array_equal(quant[k], jquant[k], err_msg=name)
        np.testing.assert_array_equal(golden.decode(data),
                                      jgolden.decode(data), err_msg=name)


@pytest.mark.parametrize("rows", [1, None])
def test_native_decode_scan_matches(rows):
    """``native.decode_scan`` on an interleaved stream's one scan, with
    restarts (segments on host threads) and without (one serial walk),
    against jpeg_tpu's coefficients in emission order; a malformed stream
    raises."""
    from jpeg_tpu.kernels import huffdec as jhd
    from jpeg_tpu.pipelines.encode import JpegEncoder as JaxJpegEncoder
    data = _decode_streams()["420-r1-dynamic"] if rows else bytes(
        JaxJpegEncoder(JaxConfig(scan_layout="interleaved", engine="xla",
                                 huffman="dynamic")).encode(
            synthetic_images(81, 1, 64, 96)[0]))
    st = jhd.parse_scan_structure(data, require_restarts=False)
    assert (st["restart_interval"] > 0) == bool(rows)
    start = data.index(st["entropy"])
    jcomps, jcoeffs, _, w, h = jgolden.parse_coefficients(data)
    huff = {}
    for (tc, th), (bits, vals) in st["dht"].items():
        huff[(tc, th)] = jbuild.table_from_spec(bits, vals)
    mx, my = w // 16, h // 16
    out, end = native.decode_scan(
        data, start, jgolden._huff_specs(huff, 0),
        jgolden._huff_specs(huff, 1), [0, 0, 0, 0, 1, 2],
        [st["tabs"][c[0]][0] for c in st["comps"]],
        [st["tabs"][c[0]][1] for c in st["comps"]], mx * my,
        st["restart_interval"])
    # past the last entropy byte: at the 0xFF of a fill byte or the EOI
    assert start < end <= start + len(st["entropy"]) and data[end] == 0xFF
    em = out.reshape(my, mx, 6, 64)
    y = em[:, :, :4].reshape(my, mx, 2, 2, 64).transpose(0, 2, 1, 3, 4)
    np.testing.assert_array_equal(y.reshape(-1, 64),
                                  jcoeffs[jcomps[0].comp_id])
    np.testing.assert_array_equal(em[:, :, 4].reshape(-1, 64),
                                  jcoeffs[jcomps[1].comp_id])
    np.testing.assert_array_equal(em[:, :, 5].reshape(-1, 64),
                                  jcoeffs[jcomps[2].comp_id])
    bad = bytearray(data)
    bad[start:start + 8] = b"\xff\xff\xff\xff\xff\xff\xff\xfe"  # no code
    with pytest.raises(ValueError, match="malformed"):
        native.decode_scan(bytes(bad), start, jgolden._huff_specs(huff, 0),
                           jgolden._huff_specs(huff, 1), [0, 0, 0, 0, 1, 2],
                           [0, 1, 1], [0, 1, 1], mx * my,
                           st["restart_interval"])


def test_huffdec_host_parsers_match():
    """The port's copies of jpeg_tpu.kernels.huffdec's host parsers; the
    port packs exactly S rows of the words needed where jpeg_tpu pads to
    128 lanes and power-of-two words (the padding is zeros)."""
    from jpeg_tpu.kernels import huffdec as jhd
    from jpeg_tpu_torch.kernels import huffdec as hd
    assert hd._PATTERN == jhd._PATTERN
    assert hd.SAMPLING_OF_FACTORS == jhd.SAMPLING_OF_FACTORS
    for name, data in _decode_streams().items():
        got = hd.parse_scan_structure(data)
        want = jhd.parse_scan_structure(data)
        assert (got is None) == (want is None), name
        if got is None:
            continue
        assert got.keys() == want.keys()
        for k in ("width", "height", "comps", "tabs",
                  "restart_interval", "entropy"):
            assert got[k] == want[k], (name, k)
        for k in want["quant"]:
            np.testing.assert_array_equal(got["quant"][k],
                                          want["quant"][k])
        for k in want["dht"]:
            for a, b in zip(got["dht"][k], want["dht"][k]):
                np.testing.assert_array_equal(a, b)
        ent = want["entropy"]
        assert hd._entropy_end(data, 0) == jhd._entropy_end(data, 0)
        for a, b in zip(hd.split_segments(ent),
                        jhd.split_segments(ent)):
            np.testing.assert_array_equal(a, b)
        segs = hd.unstuff_segments(ent)
        jsegs = jhd.unstuff_segments(ent)
        assert len(segs) == len(jsegs)
        for a, b in zip(segs, jsegs):
            np.testing.assert_array_equal(a, b)
        S = len(segs)
        words, mw = hd.pack_streams(segs)
        jwords, active, jmw = jhd.pack_streams(jsegs)
        assert words.shape == (S, mw) and words.dtype == np.int32
        assert mw == -(-max(len(s) for s in segs) // 4)
        np.testing.assert_array_equal(words, jwords[:S, :mw])
        assert not jwords[:S, mw:].any() and active[0, :S].all()
        dht = want["dht"]
        quads = [(dht[(0, i % 2)], dht[(1, i % 2)], dht[(0, 1)],
                  dht[(1, 1)]) for i in range(S)] \
            if (0, 1) in dht and (1, 1) in dht else \
            [(dht[(0, 0)], dht[(1, 0)])] * S
        for a, b in zip(hd.lane_tables(quads), jhd.lane_tables(quads)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(
                a, b[:, :S] if a.shape[0] == 64 else b[:S])
    with pytest.raises(ValueError) as want:
        jhd.unstuff_segments(b"\x01\x02", n_expected=2)
    with pytest.raises(ValueError) as got:
        hd.unstuff_segments(b"\x01\x02", n_expected=2)
    assert str(got.value) == str(want.value)
    bits = np.zeros(17, np.int64)
    bits[[2, 3, 9]] = [3, 1, 2]
    for a, b in zip(hd.canonical_tables(bits, np.arange(6)),
                    jhd.canonical_tables(bits, np.arange(6))):
        np.testing.assert_array_equal(a, b)


def test_speculative_parsers_match():
    """The port's ``parse_noninterleaved_scans`` and
    ``parse_scan_structure(require_restarts=False)`` equal jpeg_tpu's on
    restart, 3-scan, progressive, DRI-less interleaved and gray streams."""
    import io
    from PIL import Image
    from jpeg_tpu.kernels import huffdec as jhd
    from jpeg_tpu_torch.kernels import huffdec as hd
    datas = dict(_decode_streams())
    img = synthetic_images(87, 1, 48, 64)[0]
    for name, arr, kw in (("pil-420", img, dict(subsampling=2)),
                          ("pil-gray", img[..., 2], {})):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=80, **kw)
        datas[name] = buf.getvalue()

    def same(a, b, label):
        assert type(a) is type(b), label
        if isinstance(a, dict):
            assert a.keys() == b.keys(), label
            for k in a:
                same(a[k], b[k], (label, k))
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), label
            for x, y in zip(a, b):
                same(x, y, label)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=str(label))
        else:
            assert a == b, label
    found = {"scans": 0, "dri-less": 0}
    for name, data in datas.items():
        got = hd.parse_noninterleaved_scans(data)
        same(got, jhd.parse_noninterleaved_scans(data), (name, "scans"))
        found["scans"] += got is not None
        got = hd.parse_scan_structure(data, require_restarts=False)
        same(got, jhd.parse_scan_structure(data, require_restarts=False),
             (name, "structure"))
        found["dri-less"] += got is not None and not got["restart_interval"]
    assert found == {"scans": 2, "dri-less": 2}


def _refine_band():
    """``tests/test_progressive.py``'s refinement band: empty blocks, long
    zero runs, corrections and newly significant coefficients."""
    rng = np.random.default_rng(3)
    zz = rng.integers(-9, 10, size=(120, 64)).astype(np.int64)
    zz[rng.random((120, 64)) < 0.85] = 0
    zz[::7] = 0                      # whole-block EOB runs
    zz[5, 1:] = 0
    zz[5, 63] = 3                    # long run to a correction
    zz[9, 1:] = 0
    zz[9, 62] = 1                    # long run to a new one (ZRLs)
    return zz


@pytest.mark.parametrize("allow_eobn", [True, False], ids=["eobn", "eob1"])
@pytest.mark.parametrize("ss,se,ah,al", [(1, 63, 1, 0), (1, 63, 2, 1),
                                         (6, 63, 1, 0)])
def test_ac_refine_fields_match(ss, se, ah, al, allow_eobn):
    """The port's native refinement coder equals jpeg_tpu's and the port's
    plain loop (jpeg_tpu's Python fallback), element for element."""
    from jpeg_tpu.pipelines import progressive as jprog
    from jpeg_tpu_torch.pipelines import progressive as prog
    zz = _refine_band()
    band = zz[:, ss:se + 1]
    max_run = 0x7FFF if allow_eobn else 1
    got = native.ac_refine_fields(band, al, max_run, 1000)
    want = jnative.ac_refine_fields(band, al, max_run, 1000)
    assert want is not None, "jpeg_tpu's native library is unavailable"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    plain = prog.ac_refine_fields_plain(zz, ss, se, ah, al, allow_eobn)
    engine = prog._ac_refine_fields(zz, ss, se, ah, al, allow_eobn)
    ref = jprog._ac_refine_fields(zz, ss, se, ah, al, allow_eobn)
    for g, p, w in zip(engine.arrays(), plain.arrays(), ref.arrays()):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)


@pytest.mark.parametrize("kind", ["fixed", "built"])
def test_progressive_jfif_writers_match(kind):
    if kind == "fixed":
        tables, jtables = build.fixed_tables(), jbuild.fixed_tables()
    else:
        names = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
        hists = np.stack(_histograms()[:4])
        tables = dict(zip(names, build.build_tables_batch(hists)))
        jtables = dict(zip(names, jbuild.build_tables_batch(hists)))
    lq, cq = T.quant_tables(90)
    for ys in ((2, 2), (2, 1), (1, 1)):
        for dht in (True, False):
            assert (jfif.headers(48, 32, lq, cq, tables, y_sampling=ys,
                                 progressive=True, include_dht=dht)
                    == jjfif.headers(48, 32, lq, cq, jtables,
                                     y_sampling=ys, progressive=True,
                                     include_dht=dht))
        assert jfif.sof2_segment(1920, 1080, ys) == \
            jjfif.sof2_segment(1920, 1080, ys)
    for ah, al in ((0, 0), (0, 1), (2, 1), (1, 0)):
        assert jfif.sos_header_progressive_dc(ah, al) == \
            jjfif.sos_header_progressive_dc(ah, al)
        for cid, tab, ss, se in ((1, 0, 1, 5), (2, 1, 6, 63), (3, 1, 1, 63)):
            assert jfif.sos_header_progressive_ac(cid, tab, ss, se, ah, al) \
                == jjfif.sos_header_progressive_ac(cid, tab, ss, se, ah, al)
    header = jfif.headers(48, 32, lq, cq, tables, progressive=True)
    scans = [(1, 0, 1, 63, b"\x01\xff\x00"), (2, 1, 1, 63, b""),
             (3, 1, 1, 63, b"\x7f")]
    assert jfif.assemble_progressive(header, b"\x12", scans) == \
        jjfif.assemble_progressive(header, b"\x12", scans)


@pytest.mark.parametrize("n,max_words", [(0, None), (1, None), (777, None),
                                         (2000, 3000)])
def test_pack_fields_np_matches(n, max_words):
    from jpeg_tpu_torch.ops import pack as pack_ops
    rng = np.random.default_rng(n)
    nbits = rng.integers(0, 31, n)
    nbits[rng.random(n) < 0.3] = 0
    values = rng.integers(0, 1 << 30, n) & ((1 << nbits) - 1)
    got = pack_ops.pack_fields_np(values, nbits, max_words)
    want = jpack_ops.pack_fields_np(values, nbits, max_words)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# -- the tooling copies: io/, utils/, and the host side of pipelines/diff.py --


@pytest.mark.parametrize("header", [b"P6\n%d %d\n255\n",
                                    b"P6\n# a comment\n%d\n%d 255\n"])
def test_ppm_copy_matches(tmp_path, header):
    from jpeg_tpu.io import ppm as jppm
    from jpeg_tpu_torch.io import ppm
    img = synthetic_images(41, 1, 24, 40)[0]
    data = header % (40, 24) + img.tobytes()
    np.testing.assert_array_equal(ppm.parse_ppm(data), jppm.parse_ppm(data))
    np.testing.assert_array_equal(ppm.parse_ppm(data), img)
    ppm.write_ppm(str(tmp_path / "a.ppm"), img)
    jppm.write_ppm(str(tmp_path / "b.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    np.testing.assert_array_equal(ppm.read_ppm(str(tmp_path / "b.ppm")), img)
    for bad in (b"P5\n1 1\n255\n\x00", b"P6\n1 1\n65535\n\x00" * 2,
                b"P6\n2 2\n255\n\x00", b"P6\n"):
        with pytest.raises(ValueError) as w:
            jppm.parse_ppm(bad)
        with pytest.raises(ValueError) as g:
            ppm.parse_ppm(bad)
        assert str(g.value) == str(w.value)
    with pytest.raises(ValueError) as w:
        jppm.write_ppm(str(tmp_path / "c.ppm"), img[..., 0])
    with pytest.raises(ValueError) as g:
        ppm.write_ppm(str(tmp_path / "c.ppm"), img[..., 0])
    assert str(g.value) == str(w.value)


@pytest.mark.parametrize("h,w", [(20, 30), (16, 48), (33, 17)])
def test_editimage_copy_matches(h, w):
    from jpeg_tpu.io import editimage as jedit
    from jpeg_tpu_torch.io import editimage as edit
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
    for tw, th in ((40, 16), (w, h), (8, 64)):
        np.testing.assert_array_equal(edit.resize_pad(img, tw, th),
                                      jedit.resize_pad(img, tw, th))
    for m in (8, 16):
        np.testing.assert_array_equal(edit.pad_to_multiple(img, m),
                                      jedit.pad_to_multiple(img, m))
        np.testing.assert_array_equal(edit.pad_replicate(img, m),
                                      jedit.pad_replicate(img, m))
    assert edit.PAD_VALUE == jedit.PAD_VALUE


def test_dir_compare_copy_matches(tmp_path, capsys):
    from jpeg_tpu.utils import dir_compare as jdc
    from jpeg_tpu_torch.utils import dir_compare as dc
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        d.mkdir()
        (d / "same").write_bytes(b"\x00\x01")
        (d / "sub").mkdir()
    (a / "diff").write_bytes(b"x")
    (b / "diff").write_bytes(b"y")
    (a / "only_a").write_bytes(b"")
    assert dc.compare_dirs(str(a), str(b)) == jdc.compare_dirs(str(a), str(b))
    for argv in ([str(a), str(b)], [str(a), str(a)], [str(a)]):
        capsys.readouterr()
        rc = dc.main(argv)
        got = capsys.readouterr().out
        want_rc = jdc.main(argv)
        want = capsys.readouterr().out
        assert rc == want_rc
        assert got == want.replace("jpeg_tpu.", "jpeg_tpu_torch.")


@pytest.mark.parametrize("quality", [None, 60])
def test_stage_dump_copy_matches(tmp_path, quality):
    from jpeg_tpu.utils import stage_dump as jsd
    from jpeg_tpu_torch.utils import stage_dump as sd
    img = synthetic_images(43, 1, 32, 48)[0]
    sd.dump_stages(img, str(tmp_path / "port"), quality=quality)
    jsd.dump_stages(img, str(tmp_path / "jax"), quality=quality)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 15
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    np.testing.assert_array_equal(sd.channel_montage(img),
                                  jsd.channel_montage(img))


@pytest.mark.parametrize("seed", range(4))
def test_diff_host_regions_copy_matches(seed):
    """The host region stages of ``pipelines/diff.py`` on seeded masks:
    ``find_regions``, ``enlarge_adjust``, ``merge_adjusted``,
    ``filter_small`` and ``_align_area``."""
    from jpeg_tpu.pipelines import diff as JD
    from jpeg_tpu_torch.pipelines import diff as D
    rng = np.random.default_rng(seed)
    mask = rng.random((40, 40) if seed % 2 else (12, 8)) < (
        0.002, 0.01, 0.05, 0.2)[seed]
    got, want = D.find_regions(mask), JD.find_regions(mask)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    fh, fw = mask.shape[0] * 4, mask.shape[1] * 4
    ga = [D.enlarge_adjust(r, fw, fh) for r in got]
    wa = [JD.enlarge_adjust(r, fw, fh) for r in want]
    assert [repr(a) for a in ga] == [repr(a) for a in wa]
    ga, wa = D.merge_adjusted(ga, fw, fh), JD.merge_adjusted(wa, fw, fh)
    assert [repr(a) for a in ga] == [repr(a) for a in wa]
    assert [repr(a) for a in D.filter_small(ga)] == \
        [repr(a) for a in JD.filter_small(wa)]
    for m in (16, 64):
        for x, y, bw, bh in rng.integers(0, min(fh, fw), (8, 4)):
            args = (int(x), int(y), int(bw) + 1, int(bh) + 1, fw, fh, m)
            assert repr(D._align_area(*args)) == repr(JD._align_area(*args))
    assert (D.MAX_REGIONS, D.DEFAULT_THRESHOLD) == (JD.MAX_REGIONS,
                                                    JD.DEFAULT_THRESHOLD)


def test_padding_errors_name_the_ports_own_tool():
    from jpeg_tpu_torch import JpegEncoder, encode_progressive
    img = np.zeros((24, 40, 3), np.uint8)
    for call in (lambda: JpegEncoder(device="cpu").encode(img),
                 lambda: encode_progressive(img, device="cpu")):
        with pytest.raises(ValueError) as got:
            call()
        assert "jpeg_tpu_torch.io.editimage" in str(got.value)
        assert "jpeg_tpu." not in str(got.value)
