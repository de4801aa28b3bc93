"""Each plain twin of the port's CUDA kernels against the jpeg_tpu Pallas
kernel it replaces, run in interpret mode on the CPU:

* kernel A's front against ``front_analyze`` (K5);
* the A -> B -> C -> D chain against ``front_place`` (K1, the mega kernel);
* the chain against the two-phase route ``dct_attach_pack_xt`` ->
  ``_dct_attach_kernel`` (K6) -> ``_place_acc_kernel`` + scatter-add (K4),
  and against its resident route ``_dct_place_kernel`` (K6r);
* C + D against ``_segment_place``'s ``_place_resident_kernel`` (K4r) and
  ``_place_acc_kernel`` (K4), fed with the port's own fields;
* dynamic tables: A + E against ``front_index(emit_fields=True)`` (K2),
  ``dct_index_segments`` (K9) and ``dct_symbolize_segments`` (K10); F + C
  + D against ``attach_pack_pf`` (K3) and ``attach_pack_grouped`` (K11);
* the 3-scan path: ``kernels.lut.attach`` (F) against ``lut.attach``
  (K14), ``attach_grouped`` against K18c, and ``kernels.pack.
  pack_segments`` (C + D) against ``pack.pack_segments`` (K15);
* C + D against the row-scattered windows of ``pack.block_windows``
  (K18d, the blocks-on-sublanes form of K15's kernel).

Every comparison is exact equality (integers, or f32 small integers)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.kernels import front as jfront
from jpeg_tpu.kernels import fused as jfused
from jpeg_tpu.kernels import lut as jlut
from jpeg_tpu.kernels import pack as jpack
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)
from jpeg_tpu_torch.kernels import lut as lut_port
from jpeg_tpu_torch.kernels import pack as pack_port
from jpeg_tpu_torch.ops import color
from jpeg_tpu_torch.kernels.pack import rows_per_segment
from jpeg_tpu_torch.ops.sample import sample_mask, stage1_columns
from jpeg_tpu_torch.pipelines.fast import FastBatchEncoder, host_constants

from test_torch_ops import synthetic_images


def _chain(x, c, n_segs, seg_rows):
    """The port's device step on [B, H, W*3] u8: words, totals."""
    B = x.shape[0]
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"])
    coef = coef.reshape(B * n_segs, -1, 64)
    value, nbits, bits = fused.symbolize_bits(coef, c["lut"])
    offs, totals = fused.segment_offsets(bits)
    return fused.place(value, nbits, offs, totals, seg_rows * 128), totals


def _consts(quality):
    return {k: torch.from_numpy(v) for k, v in host_constants(quality).items()}


def _jax_consts(c):
    return (jnp.asarray(c["lut"].numpy())[None], jnp.asarray(c["m"].numpy()),
            jnp.asarray(c["bias"].numpy()), jnp.asarray(c["ql"].numpy()),
            jnp.asarray(c["qc"].numpy()))


def test_front_matches_front_analyze():
    imgs = synthetic_images(7, 2, 128, 128)
    x = imgs.reshape(2, 128, 128 * 3)
    xt = jfront.front_analyze(jnp.asarray(x), 8, 8, "420", interpret=True)
    want = np.asarray(xt).T.reshape(2, -1, 64)
    y, cb, cr = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    np.testing.assert_array_equal(color.mcu_blocks(y, cb, cr).numpy(), want)


@pytest.mark.parametrize("h,w,n_segs,quality", [
    (128, 128, 1, None),   # one slab, one segment
    (160, 96, 1, 75),      # padded slab tail, phantom block columns
    (256, 128, 2, None),   # two slab-aligned segments
])
def test_chain_matches_front_place(h, w, n_segs, quality):
    imgs = synthetic_images(11, 2, h, w)
    x = imgs.reshape(2, h, w * 3)
    c = _consts(quality)
    seg_rows = rows_per_segment((h // 16) * (w // 16) // n_segs * 6 * 64)
    h_pad = -(-h // 128) * 128
    xp = np.pad(x, ((0, 0), (0, h_pad - h), (0, 0)))
    lut, m, bias, ql, qc = _jax_consts(c)
    jw, jt = jfront.front_place(jnp.asarray(xp), lut, m, bias, ql, qc,
                                w // 16, h_pad // 16, "420", seg_rows,
                                interpret=True, real_height=h, n_segs=n_segs)
    words, totals = _chain(torch.from_numpy(x), c, n_segs, seg_rows)
    assert words.dtype == torch.uint32 and totals.dtype == torch.int32
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


def test_chain_matches_two_phase_route(monkeypatch):
    """K6 ``_dct_attach_kernel`` -> K4 ``_place_acc_kernel`` + scatter:
    the route ``dct_attach_pack_xt`` takes for segments over its VMEM
    budget, forced here by a zero budget."""
    imgs = synthetic_images(13, 2, 128, 128)
    x = imgs.reshape(2, 128, 128 * 3)
    c = _consts(None)
    seg_rows = rows_per_segment(64 * 6 * 64)
    lut, m, bias, ql, qc = _jax_consts(c)
    xt = jfront.front_analyze(jnp.asarray(x), 8, 8, "420", interpret=True)
    monkeypatch.setattr(jfused, "_RESIDENT_VMEM_BUDGET", 0)
    jfused.dct_attach_pack_xt.clear_cache()
    try:
        jw, jt = jfused.dct_attach_pack_xt(lut, m, bias, ql, qc, xt, 2, 2,
                                           6, 4, seg_rows, interpret=True)
        jw, jt = np.asarray(jw), np.asarray(jt)
    finally:
        jfused.dct_attach_pack_xt.clear_cache()
    words, totals = _chain(torch.from_numpy(x), c, 1, seg_rows)
    np.testing.assert_array_equal(totals.numpy(), jt)
    np.testing.assert_array_equal(words.numpy(), jw)


def test_chain_matches_resident_dct_place():
    """K6r ``_place_from_xt`` -> ``_dct_place_kernel``: the route
    ``dct_attach_pack_xt`` takes when the segment fits its budget."""
    imgs = synthetic_images(17, 2, 128, 128)
    x = imgs.reshape(2, 128, 128 * 3)
    c = _consts(75)
    seg_rows = rows_per_segment(64 * 6 * 64)
    lut, m, bias, ql, qc = _jax_consts(c)
    xt = jfront.front_analyze(jnp.asarray(x), 8, 8, "420", interpret=True)
    jw, jt = jfused.dct_attach_pack_xt(lut, m, bias, ql, qc, xt, 2, 2, 6, 4,
                                       seg_rows, interpret=True)
    words, totals = _chain(torch.from_numpy(x), c, 1, seg_rows)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


@pytest.mark.parametrize("budget", [None, 0], ids=["K4r-resident",
                                                   "K4-tiles"])
def test_offsets_and_place_match_segment_place(budget, monkeypatch):
    """C + D against ``_segment_place`` fed with the port's own B fields:
    ``_place_resident_kernel`` (K4r) and, with a zero VMEM budget,
    ``_place_acc_kernel`` + scatter-add (K4)."""
    imgs = synthetic_images(19, 2, 128, 256)
    c = _consts(None)
    x = torch.from_numpy(imgs.reshape(2, 128, 256 * 3))
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"])
    value, nbits, bits = fused.symbolize_bits(coef, c["lut"])
    S, nblk = bits.shape
    seg_rows = rows_per_segment(nblk * 64)
    offs, totals = fused.segment_offsets(bits)
    words = fused.place(value, nbits, offs, totals, seg_rows * 128)

    def t(a):  # [S, nblk, 64] -> the TPU layout [64, S * nblk] int32
        return jnp.asarray(a.reshape(S * nblk, 64).T.astype(np.int32))
    if budget is not None:
        monkeypatch.setattr(jfused, "_RESIDENT_VMEM_BUDGET", budget)
    jw, jt = jfused._segment_place(
        t(value.view(torch.int32).numpy()), t(nbits.numpy()),
        jnp.asarray(bits.numpy().reshape(1, -1)), S, S * nblk, seg_rows,
        True)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


def _bit_string_words(value, nbits, seg_words):
    """Independent reference for ``place``: concatenate every segment's
    fields as a string of '0'/'1' and cut it into 32-bit words."""
    out = np.zeros((value.shape[0], seg_words), np.uint32)
    for s in range(value.shape[0]):
        bits = "".join(format(int(v), f"0{int(n)}b")
                       for v, n in zip(value[s].reshape(-1),
                                       nbits[s].reshape(-1)) if n)
        bits += "0" * (-len(bits) % 32)
        for i in range(0, len(bits), 32):
            out[s, i // 32] = int(bits[i:i + 32], 2)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_offsets_and_place_against_bit_string(seed):
    rng = np.random.default_rng(seed)
    S, nblk = 3, 12
    nbits = rng.integers(0, 28, (S, nblk, 64)).astype(np.uint8)
    nbits[rng.random((S, nblk, 64)) < 0.5] = 0
    value = (rng.integers(0, 1 << 27, (S, nblk, 64))
             & ((1 << nbits.astype(np.int64)) - 1)).astype(np.uint32)
    bits = torch.from_numpy(nbits.astype(np.int32).sum(-1, dtype=np.int32))
    offs, totals = fused.segment_offsets(bits)
    ends = np.cumsum(bits.numpy(), axis=-1)
    np.testing.assert_array_equal(offs.numpy(), ends - bits.numpy())
    np.testing.assert_array_equal(totals.numpy(), ends[:, -1])
    seg_words = int(ends.max()) // 32 + 3
    words = fused.place(torch.from_numpy(value), torch.from_numpy(nbits),
                        offs, totals, seg_words)
    np.testing.assert_array_equal(words.numpy(),
                                  _bit_string_words(value, nbits, seg_words))


@pytest.mark.parametrize("const_device", ["cpu", "meta"],
                         ids=["mixed", "not-cpu-or-cuda"])
def test_wrappers_reject_mixed_devices(const_device):
    x = torch.zeros((1, 16, 48), dtype=torch.uint8, device="meta")
    c = {k: v.to(const_device) for k, v in _consts(None).items()}
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"])


# -- dynamic tables: kernels E and F -----------------------------------------


def _stage1(imgs, n_segs, quality, mask=None):
    """The port's A + E on [B, H, W, 3] u8: (coef, pf, hist, luts)."""
    B, h, w, _ = imgs.shape
    c = _consts(quality)
    x = torch.from_numpy(imgs.reshape(B, h, w * 3))
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"])
    coef = coef.view(B * n_segs, -1, 64)
    pf, hist = fused.symbolize_fields(coef, B, mask)
    _, luts = FastBatchEncoder._build_tables_batch(hist.numpy())
    return coef, pf, hist, torch.from_numpy(luts)


def _place_pf(pf, luts, seg_rows):
    """The port's F + C + D: words, totals."""
    value, nbits, bits = fused.attach_pf(pf, luts)
    offs, totals = fused.segment_offsets(bits)
    return fused.place(value, nbits, offs, totals, seg_rows * 128), totals


def _transposed(pf):
    """[S, nblk, 64] -> the TPU layout [64, S * nblk] int32."""
    return jnp.asarray(pf.numpy().reshape(-1, 64).T)


@pytest.mark.parametrize("h,w,n_segs,quality", [
    (128, 128, 1, None),   # one slab, one segment
    (160, 96, 1, 75),      # padded slab tail, phantom block columns
    (256, 128, 2, None),   # two slab-aligned segments
])
def test_fields_match_front_index(h, w, n_segs, quality):
    """A + E against K2 ``front_index(emit_fields=True)``."""
    imgs = synthetic_images(41, 2, h, w)
    _, pf, _, _ = _stage1(imgs, n_segs, quality)
    h_pad = -(-h // 128) * 128
    xp = np.pad(imgs.reshape(2, h, w * 3), ((0, 0), (0, h_pad - h), (0, 0)))
    _, m, bias, ql, qc = _jax_consts(_consts(quality))
    jpf = jfront.front_index(jnp.asarray(xp), m, bias, ql, qc, w // 16,
                             h_pad // 16, "420", interpret=True,
                             real_height=h, n_segs=n_segs, emit_fields=True)
    jpf = np.asarray(jpf).reshape(64, 2, -1).transpose(1, 2, 0)
    cols = stage1_columns(h, w, n_segs)
    np.testing.assert_array_equal(pf.numpy().reshape(2, -1, 64),
                                  jpf[:, cols])


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_fields_match_dct_segments(kernel):
    """A + E against K9 ``dct_index_segments`` (index only) and K10
    ``dct_symbolize_segments`` (idx, extra, extra_n), whose segments pad
    to 128 blocks (180 real blocks here)."""
    imgs = synthetic_images(43, 2, 160, 96)
    _, pf, _, _ = _stage1(imgs, 2, 75)
    S, nblk, _ = pf.shape
    y, cb, cr = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    px = jnp.asarray(color.mcu_blocks(y, cb, cr).numpy().reshape(S, nblk, 64))
    _, m, bias, ql, qc = _jax_consts(_consts(75))
    if kernel == "K9":
        want = (jfused.dct_index_segments(m, bias, ql, qc, px, S, 6, 4,
                                          interpret=True),)
        got = (pf & 1023,)
    else:
        want = jfused.dct_symbolize_segments(m, bias, ql, qc, px, S, 6, 4,
                                             interpret=True)
        got = fused.unpack_fields(pf)
    for g, w_t in zip(got, want):
        w_t = np.asarray(w_t).reshape(64, S, -1)[:, :, :nblk]
        np.testing.assert_array_equal(g.numpy(), w_t.transpose(1, 2, 0))


def test_attach_place_matches_attach_pack_pf():
    """F + C + D against K3 ``attach_pack_pf`` (``_pf_place_kernel``) on
    the port's own fields and per-image LUTs."""
    imgs = synthetic_images(45, 2, 128, 256)
    _, pf, _, luts = _stage1(imgs, 2, None)
    S, nblk, _ = pf.shape
    seg_rows = rows_per_segment(nblk * 64)
    words, totals = _place_pf(pf, luts, seg_rows)
    jw, jt = jfused.attach_pack_pf(jnp.asarray(luts.numpy()),
                                   _transposed(pf), S, S // 2, seg_rows,
                                   interpret=True)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


def test_attach_place_matches_attach_pack_grouped():
    """F + C + D against K11 ``attach_pack_grouped`` fed with K10's
    fields (segments padded to 128 blocks, the pads NULL)."""
    imgs = synthetic_images(47, 2, 160, 96)
    _, pf, _, luts = _stage1(imgs, 2, None)
    S, nblk, _ = pf.shape
    seg_rows = rows_per_segment(nblk * 64)
    words, totals = _place_pf(pf, luts, seg_rows)
    y, cb, cr = color.rgb_to_ycbcr_420(torch.from_numpy(imgs))
    px = jnp.asarray(color.mcu_blocks(y, cb, cr).numpy().reshape(S, nblk, 64))
    _, m, bias, ql, qc = _jax_consts(_consts(None))
    idx, extra, extra_n = jfused.dct_symbolize_segments(
        m, bias, ql, qc, px, S, 6, 4, interpret=True)
    jw, jt = jfused.attach_pack_grouped(jnp.asarray(luts.numpy()), idx,
                                        extra, extra_n, S, S // 2, seg_rows,
                                        interpret=True)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


def test_dynamic_cpu_wrappers_run_the_plain_twins_and_launch_nothing():
    imgs = synthetic_images(49, 2, 160, 96)
    mask = torch.from_numpy(sample_mask(160, 96, 2))
    reset_launch_counts()
    coef, pf, hist, luts = _stage1(imgs, 2, None, mask)
    want_pf, want_hist = fused.symbolize_fields_plain(coef, 2, mask)
    assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    # the mask keeps a fifth of the blocks' slots out of the histogram
    full = fused.symbolize_fields(coef, 2)[1]
    assert 0 < int(hist.sum()) < int(full.sum())
    for a, b in zip(fused.attach_pf(pf, luts), fused.attach_pf_plain(pf,
                                                                     luts)):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a,
                           b.view(torch.int32) if b.dtype == torch.uint32
                           else b)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


# -- the 3-scan path: K14 (lut.attach), K18c (attach_grouped), K15 ----------


def _scan_fields(seed, quality=None):
    """The port's A (3-scan order) + E on one 160x96 image: (Y segment
    [1, 240, 64] coefs, Cb + Cr segments [2, 60, 64], their pf)."""
    imgs = synthetic_images(seed, 1, 160, 96)
    c = _consts(quality)
    x = torch.from_numpy(imgs.reshape(1, 160, 96 * 3))
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                           order="scan")
    cy, cc = coef[:240].view(1, 240, 64), coef[240:].view(2, 60, 64)
    pf_y, _ = fused.symbolize_fields(cy, 1, layout=color.SCAN_Y)
    pf_c, _ = fused.symbolize_fields(cc, 1, layout=color.SCAN_CHROMA)
    return cy, cc, pf_y, pf_c


@pytest.mark.parametrize("scan", ["Y", "Cb", "ragged"])
def test_attach_matches_lut_attach(scan):
    """K14 ``lut.attach`` -> ``_attach_kernel`` on a scan's slot arrays:
    the Y scan (240 blocks), the Cb scan (60 blocks: 3840 slots, which
    jpeg_tpu pads with NULL slots to 4096) and 999 slots (not whole
    blocks, which the port pads)."""
    _, _, pf_y, pf_c = _scan_fields(61)
    pf = {"Y": pf_y[0], "Cb": pf_c[0], "ragged": pf_c.reshape(-1)[:999]}[scan]
    idx, extra, extra_n = fused.unpack_fields(pf)
    lut = _consts(None)["lut"]
    value, nbits = lut_port.attach(lut, idx, extra, extra_n)
    jv, jn = jlut.attach(jnp.asarray(lut.numpy()), jnp.asarray(idx.numpy()),
                         jnp.asarray(extra.numpy()),
                         jnp.asarray(extra_n.numpy()), interpret=True)
    assert value.dtype == nbits.dtype == torch.int32
    assert value.shape == nbits.shape == idx.shape
    np.testing.assert_array_equal(value.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(jn))


def test_attach_grouped_matches_lut_attach_grouped():
    """K18c ``lut.attach_grouped`` with 3 groups, each its own LUT: the
    Y scans of 3 images and their per-image tables."""
    imgs = synthetic_images(63, 3, 64, 64)
    c = _consts(None)
    x = torch.from_numpy(imgs.reshape(3, 64, 64 * 3))
    coef = front.front_dct(x, c["m"], c["bias"], c["ql"], c["qc"],
                           order="scan")
    cy = coef[:3 * 64].view(3, 64, 64)
    pf, hist = fused.symbolize_fields(cy, 3, layout=color.SCAN_Y)
    pf_c, hist = fused.symbolize_fields(coef[3 * 64:].view(6, 16, 64), 3,
                                        layout=color.SCAN_CHROMA, hist=hist)
    _, luts = FastBatchEncoder._build_tables_batch(hist.numpy())
    assert len({luts[g].tobytes() for g in range(3)}) == 3
    idx, extra, extra_n = fused.unpack_fields(pf.view(3, -1))
    value, nbits = lut_port.attach_grouped(torch.from_numpy(luts), idx, extra,
                                           extra_n)
    jv, jn = jlut.attach_grouped(jnp.asarray(luts), jnp.asarray(idx.numpy()),
                                 jnp.asarray(extra.numpy()),
                                 jnp.asarray(extra_n.numpy()), interpret=True)
    np.testing.assert_array_equal(value.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(jn))


@pytest.mark.parametrize("n_segs", [1, 3])
def test_pack_segments_matches_kernel_pack(n_segs):
    """K15 ``pack.pack_segments`` -> ``block_windows_t`` ->
    ``_pack_kernel_t`` + row scatter-add, on the fields of B: one Cb scan
    (60 blocks), or three Y restart segments of 80 blocks."""
    cy, cc, _, _ = _scan_fields(65, quality=75)
    coef = cc[:1] if n_segs == 1 else cy.reshape(3, 80, 64)
    value, nbits, bits = fused.symbolize_bits(coef, _consts(75)["lut"],
                                              color.SCAN_CHROMA if n_segs == 1
                                              else color.SCAN_Y)
    seg_rows = rows_per_segment(coef.shape[1] * 64)
    words, totals = pack_port.pack_segments(value, nbits, n_segs, seg_rows)
    jw, jt = jpack.pack_segments(jnp.asarray(value.view(torch.int32).numpy()),
                                 jnp.asarray(nbits.numpy().astype(np.int32)),
                                 n_segs, seg_rows, interpret=True)
    jw, jt = np.asarray(jw), np.asarray(jt)
    np.testing.assert_array_equal(totals.numpy(), jt)
    assert words.shape == jw.shape and words.dtype == torch.uint32
    for s in range(n_segs):  # the words the stream covers
        n = (int(jt[s]) + 31) // 32
        np.testing.assert_array_equal(words.numpy()[s, :n], jw[s, :n])
    # B's bits, passed in, give the same words
    again, _ = pack_port.pack_segments(value, nbits, n_segs, seg_rows, bits)
    assert torch.equal(again.view(torch.int32), words.view(torch.int32))
    with pytest.raises(ValueError, match="n_segments"):
        pack_port.pack_segments(value, nbits, n_segs + 1, seg_rows)


@pytest.mark.parametrize("seed", [2, 3])
def test_offsets_and_place_match_block_windows(seed):
    """K18d ``pack.block_windows`` -> ``_pack_kernel`` on seeded fields of
    2 segments of 64 blocks: its (r0, r1) windows, row-scattered into the
    words as ``pack_segments`` scatters ``block_windows_t``'s, against C
    + D (``segment_offsets_plain``, ``place_plain``)."""
    rng = np.random.default_rng(seed)
    S, nblk = 2, 64
    nbits = rng.integers(0, 28, (S, nblk, 64)).astype(np.uint8)
    nbits[rng.random((S, nblk, 64)) < 0.6] = 0
    value = (rng.integers(0, 1 << 27, (S, nblk, 64))
             & ((1 << nbits.astype(np.int64)) - 1)).astype(np.uint32)
    bits = nbits.astype(np.int32).sum(-1, dtype=np.int32)
    seg_rows = rows_per_segment(nblk * 64)
    offs, totals = fused.segment_offsets_plain(torch.from_numpy(bits))
    words = fused.place_plain(torch.from_numpy(value),
                              torch.from_numpy(nbits), offs, seg_rows * 128)
    goff = (offs.numpy() + (np.arange(S) * seg_rows * 128 * 32)[:, None])
    r0, r1 = jpack.block_windows(jnp.asarray(value.reshape(-1, 64)),
                                 jnp.asarray(nbits.reshape(-1, 64)),
                                 jnp.asarray(goff.reshape(-1)),
                                 interpret=True)
    rows = goff.reshape(-1) >> 12
    want = np.zeros((S * seg_rows + 1, 128), np.uint32)
    np.bitwise_or.at(want, rows, np.asarray(r0).view(np.uint32))
    np.bitwise_or.at(want, rows + 1, np.asarray(r1).view(np.uint32))
    np.testing.assert_array_equal(totals.numpy(), bits.sum(-1))
    np.testing.assert_array_equal(
        words.numpy(), want[:S * seg_rows].reshape(S, seg_rows * 128))
