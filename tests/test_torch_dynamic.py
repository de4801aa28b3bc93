"""Dynamic Huffman tables (``huffman="dynamic"`` and ``"dynamic-sampled"``):
jpeg_tpu_torch.FastBatchEncoder against jpeg_tpu's FastBatchEncoder
(interpret mode on the CPU), batch 2, stage by stage: stage-1 packed
fields, per-image histograms, built tables and LUTs, ``dynamic_pack``
words and totals, JPEG bytes.  Every comparison is exact equality.  The
port runs on the CPU here, i.e. through the plain twins of its kernels.

jpeg_tpu's stage 1 at these geometries is ``front_index`` (K2), whose
[64, B * n] layout pads slabs and pseudo-segments; ``_columns`` maps the
port's blocks into it with jpeg_tpu's own helpers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.kernels import front as jfront
from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder
from jpeg_tpu_torch.convert import constants_from_jax, tables_from_jax
from jpeg_tpu_torch.ops.sample import sample_mask, stage1_columns

from test_torch_ops import synthetic_images

# (H, W, restart_interval_mcu_rows, quality), as test_torch_fast.py's
GEOMETRIES = {
    "128x128": (128, 128, 0, None),
    "160x96": (160, 96, 0, None),
    "256x160-r8": (256, 160, 8, None),
    "160x96-r5": (160, 96, 5, None),
    "160x96-r5-q75": (160, 96, 5, 75),
}
MODES = ["dynamic", "dynamic-sampled"]
CASES = [(g, m) for g in GEOMETRIES for m in MODES]
NAMES = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")


def _configs(geom, mode):
    h, w, rr, q = GEOMETRIES[geom]
    kw = dict(scan_layout="interleaved", huffman=mode, quality=q,
              restart_interval_mcu_rows=rr)
    return JaxConfig(**kw), EncodeConfig(**kw)


def _columns(h, w, n_segs):
    """(per-image column count, column of each real block) of jpeg_tpu's
    front_index layout, from jpeg_tpu's own helpers."""
    sc = jfront.slab_cols(w // 16, "420")
    sc_p, _ = jfront._pick_slab_pad(sc)
    pseudo = 1 if jfront.aligned_segments(h, n_segs) else n_segs
    rows = h // pseudo
    slabs = -(-rows // 128)
    blocks = (rows // 16) * (w // 16) * 6
    cols = [(s * slabs + g) * sc_p + j
            for s in range(pseudo) for g in range(slabs) for j in range(sc)
            if g * sc + j < blocks]
    return pseudo * slabs * sc_p, np.asarray(cols)


@pytest.fixture(scope="module")
def jax_ref():
    """Per case: jpeg_tpu's dynamic_pack stages and files, cached."""
    cache = {}

    def get(geom, mode):
        if (geom, mode) not in cache:
            h, w, _, _ = GEOMETRIES[geom]
            imgs = synthetic_images(37, 2, h, w)
            enc = JaxEncoder(h, w, _configs(geom, mode)[0], interpret=True)
            fields, hist = enc._analyze_hist(enc._check_batch(imgs))
            tables, luts = enc._build_tables_batch(np.asarray(hist),
                                                   smooth=enc._sampled)
            words, totals = enc._pack_only(fields, jnp.asarray(luts))
            files = enc._fetch_assemble(words, totals, tables)
            cache[geom, mode] = dict(
                imgs=imgs, enc=enc, pf=np.asarray(fields[0]),
                hist=np.asarray(hist), tables=tables, luts=luts,
                words=np.asarray(words), totals=np.asarray(totals),
                files=files)
        return cache[geom, mode]
    return get


@pytest.fixture(scope="module")
def port_ref():
    """Per case: the port's stages on the CPU, cached."""
    cache = {}

    def get(geom, mode, imgs):
        if (geom, mode) not in cache:
            h, w, _, _ = GEOMETRIES[geom]
            enc = FastBatchEncoder(h, w, _configs(geom, mode)[1],
                                   device="cpu")
            pf, hist = enc._analyze_hist(enc._check_batch(imgs))
            tables, luts = enc._build_tables_batch(hist.numpy(),
                                                   smooth=enc._sampled)
            words, totals = enc._pack_only(pf, torch.from_numpy(luts))
            cache[geom, mode] = dict(enc=enc, pf=pf, hist=hist,
                                     tables=tables, luts=luts, words=words,
                                     totals=totals)
        return cache[geom, mode]
    return get


def _both(jax_ref, port_ref, geom, mode):
    want = jax_ref(geom, mode)
    return port_ref(geom, mode, want["imgs"]), want


@pytest.mark.parametrize("geom,mode", CASES)
def test_stage1_fields_match_front_index(jax_ref, port_ref, geom, mode):
    got, want = _both(jax_ref, port_ref, geom, mode)
    h, w, _, _ = GEOMETRIES[geom]
    enc = got["enc"]
    n, cols = _columns(h, w, enc.n_segs)
    pf = want["pf"]
    assert pf.shape == (64, 2 * n)  # the front_index route
    jpf = pf.reshape(64, 2, n).transpose(1, 2, 0)   # [B, column, slot]
    port = got["pf"].numpy().reshape(2, -1, 64)     # [B, block, slot]
    np.testing.assert_array_equal(port, jpf[:, cols])
    # every other column is a phantom or padded-row block: NULL slots
    rest = np.setdiff1d(np.arange(n), cols)
    assert np.all(jpf[:, rest] == 1023)


@pytest.mark.parametrize("geom,mode", CASES)
def test_histograms_match(jax_ref, port_ref, geom, mode):
    got, want = _both(jax_ref, port_ref, geom, mode)
    hist = got["hist"].numpy()
    assert hist.shape == (2, 1024) and hist.dtype == np.int32
    np.testing.assert_array_equal(hist[:, :1023], want["hist"][:, :1023])
    assert not hist[:, 1023].any()


@pytest.mark.parametrize("geom,mode", CASES)
def test_tables_and_luts_match(jax_ref, port_ref, geom, mode):
    got, want = _both(jax_ref, port_ref, geom, mode)
    np.testing.assert_array_equal(got["luts"], want["luts"])
    for mine, theirs in zip(got["tables"], want["tables"]):
        assert set(mine) == set(theirs) == set(NAMES)
        converted = tables_from_jax(theirs)
        for name in NAMES:
            for f in ("bits", "huffval", "code", "length"):
                np.testing.assert_array_equal(getattr(mine[name], f),
                                              getattr(converted[name], f))


@pytest.mark.parametrize("geom,mode", CASES)
def test_dynamic_pack_words_and_totals_match(jax_ref, port_ref, geom, mode):
    got, want = _both(jax_ref, port_ref, geom, mode)
    words, totals, tables = got["enc"].dynamic_pack(want["imgs"])
    assert words.dtype == torch.uint32 and totals.dtype == torch.int32
    np.testing.assert_array_equal(totals.numpy(), want["totals"])
    np.testing.assert_array_equal(words.numpy(), want["words"])
    np.testing.assert_array_equal(got["words"].numpy(), want["words"])
    assert len(tables) == 2


@pytest.mark.parametrize("geom,mode", CASES)
def test_jpeg_bytes_match(jax_ref, port_ref, geom, mode):
    got, want = _both(jax_ref, port_ref, geom, mode)
    files = got["enc"].encode_batch(want["imgs"])
    assert files == want["files"]
    # per-image tables: the DHT segments differ from the fixed tables'
    fixed = FastBatchEncoder(*GEOMETRIES[geom][:2], EncodeConfig(
        scan_layout="interleaved", huffman="fixed"), device="cpu")
    assert len(dht_segments(files[0])) == 4
    assert dht_segments(files[0]) != dht_segments(fixed._header)


def dht_segments(data: bytes) -> list[bytes]:
    """The DHT segments of a JPEG file's header, up to its SOS."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = (data[pos + 2] << 8) | data[pos + 3]
        if data[pos + 1] == 0xC4:
            out.append(data[pos:pos + 2 + n])
        pos += 2 + n
    return out


# (H, W, restart_interval_mcu_rows) of the index-only sample-mask checks
SAMPLE_GEOMETRIES = {"128x128": (128, 128, 0), "160x96": (160, 96, 0),
                     "256x160-r8": (256, 160, 8), "160x96-r5": (160, 96, 5),
                     "1088x1920-r17": (1088, 1920, 17)}


@pytest.mark.parametrize("geom", SAMPLE_GEOMETRIES)
def test_sample_mask_matches_hist_src(geom):
    """The port's sample mask against jpeg_tpu's ``_hist_src`` run on an
    array of column numbers (index arrays only, no encode)."""
    h, w, rr = SAMPLE_GEOMETRIES[geom]
    cfg = JaxConfig(scan_layout="interleaved", huffman="dynamic-sampled",
                    restart_interval_mcu_rows=rr)
    enc = JaxEncoder(h, w, cfg, interpret=True)
    n, cols = _columns(h, w, enc.n_segs)
    B = 2
    kept = np.asarray(enc._hist_src(jnp.arange(B * n, dtype=jnp.int32)
                                    [None, :], B)).reshape(-1)
    for b in range(B):
        mine = kept[(kept >= b * n) & (kept < (b + 1) * n)] - b * n
        want = np.isin(cols, mine).astype(np.uint8)
        np.testing.assert_array_equal(sample_mask(h, w, enc.n_segs), want)
    np.testing.assert_array_equal(stage1_columns(h, w, enc.n_segs), cols)


def test_dynamic_encoder_takes_jax_constants(jax_ref):
    want = jax_ref("160x96-r5-q75", "dynamic")
    jenc = want["enc"]
    assert not hasattr(jenc, "_fixed_lut")
    consts = constants_from_jax({k: np.asarray(getattr(jenc, k))
                                 for k in ("_dct_m", "_dct_bias", "_ql_zz",
                                           "_qc_zz")})
    assert set(consts) == {"m", "bias", "ql", "qc"}
    enc = FastBatchEncoder(160, 96, _configs("160x96-r5-q75", "dynamic")[1],
                           device="cpu", constants=consts)
    assert enc.encode_batch(want["imgs"]) == want["files"]


def test_step_and_dynamic_pack_errors_match_jax(jax_ref):
    jenc = jax_ref("128x128", "dynamic")["enc"]
    enc = FastBatchEncoder(128, 128, _configs("128x128", "dynamic")[1],
                           device="cpu")
    imgs = np.zeros((1, 128, 128, 3), np.uint8)
    with pytest.raises(ValueError) as want:
        jenc.step(imgs)
    with pytest.raises(ValueError) as got:
        enc.step(imgs)
    assert str(got.value) == str(want.value)
    fixed = FastBatchEncoder(128, 128, EncodeConfig(
        scan_layout="interleaved", huffman="fixed"), device="cpu")
    with pytest.raises(ValueError, match="dynamic huffman mode"):
        fixed.dynamic_pack(imgs)
