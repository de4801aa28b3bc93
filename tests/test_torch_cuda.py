"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

They skip, with a reason, where no CUDA device is present; on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``; the
suite's conftest imports jax, which the card machine lacks) each kernel
must equal its plain twin exactly (in every layout and mode, the explicit
modes of B and E too), and the encoders' bytes must equal the CPU path's,
in every Huffman mode and chroma subsampling (f64 exact mode: the golden
encoder's as well), and the monitor's areas, bytes and delays the CPU
path's.  ``chip_smoke.py`` runs the same checks at full size.  The two
tests of ``chip_smoke.device_us`` need no card and run anywhere.  No jax
here."""
import numpy as np
import pytest
import torch

from jpeg_tpu_torch import (BucketedEncoder, ChangeMonitor, EncodeConfig,
                            FastBatchEncoder, FrameComparator, JpegEncoder,
                            encode_gray, encode_progressive,
                            encode_progressive_script)
from jpeg_tpu_torch.golden import encoder as golden
from jpeg_tpu_torch.kernels import (fused, front, launch_counts,
                                    reset_launch_counts)
from jpeg_tpu_torch.ops import color
from jpeg_tpu_torch.ops.color import SCAN_CHROMA, SCAN_Y
from jpeg_tpu_torch.kernels.pack import rows_per_segment
from jpeg_tpu_torch.ops.dct import set_exact_matmul
from jpeg_tpu_torch.pipelines.fast import host_constants

from chip_smoke import (BITS_CASES, FIELDS_LAYOUTS, bits_cases,
                        edge_coefs, explicit_random, fields_cases,
                        fields_checked, fields_plain, place_checked,
                        place_plain_streams, prefilled_fields, random_coefs,
                        random_lut, stream_words, synthetic_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    set_exact_matmul()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("quality", [None, 75, 100])
def test_kernels_equal_plain_twins(dev, quality):
    cfg = EncodeConfig(scan_layout="interleaved", huffman="fixed",
                       quality=quality, restart_interval_mcu_rows=5)
    enc = FastBatchEncoder(160, 96, cfg, device=dev)
    imgs = synthetic_batch(np.random.default_rng(31), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    c = (enc._m, enc._bias, enc._ql, enc._qc)
    coef = front.front_dct(x, *c)
    assert torch.equal(coef, front.front_dct_plain(x, *c))
    coef = coef.view(4, -1, 64)
    # B under its fields contract, out of pre-filled buffers
    for a, b in zip(fields_checked(fused.symbolize_bits, coef, enc._lut),
                    fields_plain(fused.symbolize_bits_plain, coef, enc._lut)):
        assert torch.equal(a, b)
    fields = fused.symbolize_bits(coef, enc._lut)
    plain = fused.symbolize_bits_plain(coef, enc._lut)
    offs = fused.segment_offsets(fields[2])
    for a, b in zip(offs, fused.segment_offsets_plain(fields[2])):
        assert torch.equal(a, b)
    sw = enc.seg_rows * 128
    # D on the kernel's fields (value groups without bits unwritten)
    got = place_checked(fields[0], fields[1], *offs, sw)
    for a, b in zip(got, place_plain_streams(plain[0], plain[1], *offs,
                                             sw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["dynamic", "dynamic-sampled"])
def test_dynamic_kernels_equal_plain_twins(dev, mode):
    cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                       restart_interval_mcu_rows=5)
    enc = FastBatchEncoder(160, 96, cfg, device=dev)
    imgs = synthetic_batch(np.random.default_rng(35), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    coef = front.front_dct(x, enc._m, enc._bias, enc._ql,
                           enc._qc).view(4, -1, 64)
    pf, hist = fused.symbolize_fields(coef, 2, enc._mask)
    want_pf, want_hist = fused.symbolize_fields_plain(coef, 2, enc._mask)
    assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    _, luts = enc._build_tables_batch(hist.cpu().numpy(),
                                      smooth=mode == "dynamic-sampled")
    luts = torch.from_numpy(luts).to(dev)
    for a, b in zip(fields_checked(fused.attach_pf, pf, luts),
                    fields_plain(fused.attach_pf_plain, pf, luts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_card_bytes_equal_cpu_bytes(dev, mode):
    imgs = synthetic_batch(np.random.default_rng(33), 2, 256, 160)
    cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                       restart_interval_mcu_rows=8)
    reset_launch_counts()
    got = FastBatchEncoder(256, 160, cfg, device=dev).encode_batch(imgs)
    path = (("symbolize_bits",) if mode == "fixed"
            else ("symbolize_fields", "attach_pf"))
    assert launch_counts() == {
        k: int(k in ("front_dct", "segment_offsets", "place") + path)
        for k in launch_counts()}
    want = FastBatchEncoder(256, 160, cfg, device="cpu").encode_batch(imgs)
    assert got == want
    assert np.all([len(f) > 0 for f in got])


def test_scan_layouts_and_gray_equal_plain_twins(dev):
    """A's 3-scan order and gray mode, and B and E in the single-component
    layouts (E accumulating the Cb + Cr counts into the Y launch's rows)."""
    enc = FastBatchEncoder(160, 96, EncodeConfig(scan_layout="interleaved",
                                                 huffman="fixed"), device=dev)
    c = (enc._m, enc._bias, enc._ql, enc._qc)
    imgs = synthetic_batch(np.random.default_rng(39), 2, 160, 96)
    x = torch.from_numpy(imgs).to(dev).reshape(2, 160, 96 * 3)
    coef = front.front_dct(x, *c, order="scan")
    assert torch.equal(coef, front.front_dct_plain(x, *c, order="scan"))
    groups = ((coef[:480].view(2, 240, 64), SCAN_Y),
              (coef[480:].view(4, 60, 64), SCAN_CHROMA))
    hist = want_hist = None
    for cf, layout in groups:
        for a, b in zip(
                fields_checked(fused.symbolize_bits, cf, enc._lut, layout),
                fields_plain(fused.symbolize_bits_plain, cf, enc._lut,
                             layout)):
            assert torch.equal(a, b)
        pf, hist = fused.symbolize_fields(cf, 2, layout=layout, hist=hist)
        want_pf, want_hist = fused.symbolize_fields_plain(
            cf, 2, layout=layout, hist=want_hist)
        assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    plane = x[:, :, ::3].contiguous()
    assert torch.equal(front.front_dct_gray(plane, *c[:3]),
                       front.front_dct_gray_plain(plane, *c[:3]))


@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_3scan_encode_equals_cpu(dev, mode):
    img = synthetic_batch(np.random.default_rng(41), 1, 640, 640)[0]
    cfg = EncodeConfig(huffman=mode)
    reset_launch_counts()
    got = JpegEncoder(cfg, device=dev).encode(img)
    path = (("symbolize_bits",) if mode == "fixed"
            else ("symbolize_fields", "attach_pf"))
    assert launch_counts() == {
        k: 1 if k == "front_dct" else 2 * int(
            k in ("segment_offsets", "place") + path)
        for k in launch_counts()}
    reset_launch_counts()
    want = JpegEncoder(cfg, device="cpu").encode(img)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert got == want


def test_explicit_kernels_equal_plain_twins(dev):
    """B and E in their explicit modes (K13, K12) and F + C + D over slot
    arrays (K18b), on random coefficients, DC differences up to +-4095 and
    luma flags with padding blocks."""
    rng = np.random.default_rng(43)
    S, n = 4, 150
    zz = rng.integers(-2048, 2048, (S, n, 64))
    zz = np.where(rng.random((S, n, 64)) < 0.2, zz, 0)
    dcd = rng.integers(-4095, 4096, (S, n))
    dcd[0, :2] = [4095, -4095]
    isl = rng.integers(-1, 2, (S, n))
    cpu = [torch.from_numpy(a.astype(np.int32)) for a in (zz, dcd, isl)]
    cpu[0] = cpu[0].to(torch.int16)
    zz_d, dcd_d, isl_d = (t.to(dev) for t in cpu)
    lut_c = torch.from_numpy(host_constants(None)["lut"])
    lut = lut_c.to(dev)
    for a, b in zip(
            fields_checked(fused.symbolize_bits_explicit, zz_d, dcd_d, isl_d,
                           lut),
            fields_plain(fused.symbolize_bits_explicit_plain, zz_d, dcd_d,
                         isl_d, lut)):
        assert torch.equal(a, b)
    pf, hist = fused.symbolize_segments(zz_d, dcd_d, isl_d, S, 2)
    want_pf, want_hist = fused.symbolize_segments_plain(zz_d, dcd_d, isl_d,
                                                        S, 2)
    assert torch.equal(pf, want_pf) and torch.equal(hist, want_hist)
    seg_rows = rows_per_segment(n * 64)
    slots = fused.unpack_fields(pf)
    for got, want in (
            (fused.analyze_attach_pack_segments(lut, zz_d, dcd_d, isl_d, S,
                                                seg_rows),
             fused.analyze_attach_pack_segments(lut_c, *cpu, S, seg_rows)),
            (fused.attach_pack_segments(lut, *slots, S, seg_rows),
             fused.attach_pack_segments(lut_c, *(t.cpu() for t in slots), S,
                                        seg_rows))):
        # the words of each stream (the card leaves the rest unwritten)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(stream_words(*(t.cpu() for t in got)),
                           stream_words(*want))


@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
def test_f64_card_bytes_equal_golden_and_cpu(dev, mode):
    imgs = synthetic_batch(np.random.default_rng(45), 2, 128, 96)
    kw = dict(scan_layout="interleaved", huffman=mode,
              restart_interval_mcu_rows=4)
    cfg = EncodeConfig(dtype="float64", **kw)
    reset_launch_counts()
    got = FastBatchEncoder(128, 96, cfg, device=dev).encode_batch(imgs)
    path = (("symbolize_bits_explicit",) if mode == "fixed"
            else ("symbolize_fields_explicit", "attach_pf"))
    assert launch_counts() == {
        k: int(k in ("segment_offsets", "place") + path)
        for k in launch_counts()}
    assert got == [golden.encode(img, **kw) for img in imgs]
    assert got == FastBatchEncoder(128, 96, cfg,
                                   device="cpu").encode_batch(imgs)
    cfg3 = EncodeConfig(dtype="float64", huffman=mode)
    assert JpegEncoder(cfg3, device=dev).encode(imgs[0]) == \
        golden.encode(imgs[0], huffman=mode)
    plane = np.ascontiguousarray(imgs[1, :, :, 0])
    assert encode_gray(plane, cfg3, device=dev) == \
        encode_gray(plane, cfg3, device="cpu")


@pytest.mark.parametrize("sampling", ["422", "444"])
def test_sampling_kernels_equal_plain_twins(dev, sampling):
    """A's 4:2:2 / 4:4:4 color modes in both orders, its pixel-block mode
    in both layouts, and K7 (A px + B + C + D) and K18a (A px + E) at
    heights (4:2:2) and widths (4:4:4) off a multiple of 16."""
    h, w = (72, 128) if sampling == "422" else (48, 136)
    imgs = synthetic_batch(np.random.default_rng(47), 2, h, w)
    x = torch.from_numpy(imgs).to(dev).reshape(2, h, w * 3)
    c = {k: torch.from_numpy(v).to(dev)
         for k, v in host_constants(None).items()}
    consts = (c["m"], c["bias"], c["ql"], c["qc"])
    for order in ("mcu", "scan"):
        assert torch.equal(
            front.front_dct(x, *consts, order=order, sampling=sampling),
            front.front_dct_plain(x, *consts, order=order,
                                  sampling=sampling))
    layout = color.LAYOUTS[sampling]
    px = torch.from_numpy(imgs).to(dev)
    px = color.mcu_blocks(*color.rgb_to_ycbcr(px, sampling), sampling)
    coef = front.front_dct_px(px, *consts, layout)
    assert torch.equal(coef, front.front_dct_px_plain(px, *consts, layout))
    assert torch.equal(coef, front.front_dct(x, *consts, sampling=sampling))
    xt = px.reshape(-1, 64).T.contiguous()
    assert torch.equal(front.front_dct_px(xt, *consts, layout,
                                          transposed=True).view_as(coef), coef)
    seg_rows = rows_per_segment(px.shape[1] * 64)
    got = fused.dct_attach_pack_segments(c["lut"], *consts, px, 2, *layout,
                                         seg_rows)
    want = fused.dct_attach_pack_segments_plain(c["lut"], *consts, px, 2,
                                                *layout, seg_rows)
    # the words of each stream (the card leaves the rest unwritten)
    assert torch.equal(got[1], want[1])
    assert torch.equal(stream_words(*got), stream_words(*want))
    n = 128 * layout.period  # whole tiles and whole MCUs
    xt = xt[:, :n].contiguous()
    assert torch.equal(
        fused.dct_index_xt(*consts, xt, 1, *layout),
        fused.dct_index_xt_plain(*consts, xt, 1, *layout))


@pytest.mark.parametrize("sampling", ["422", "444"])
@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_sampling_card_bytes_equal_cpu(dev, sampling, mode):
    h, w = (40, 64) if sampling == "422" else (48, 56)
    imgs = synthetic_batch(np.random.default_rng(49), 2, h, w)
    cfg = EncodeConfig(scan_layout="interleaved", huffman=mode,
                       subsampling=sampling, restart_interval_mcu_rows=1)
    reset_launch_counts()
    got = FastBatchEncoder(h, w, cfg, device=dev).encode_batch(imgs)
    assert launch_counts()["front_dct"] == 1
    assert got == FastBatchEncoder(h, w, cfg, device="cpu").encode_batch(imgs)
    cfg3 = EncodeConfig(huffman=mode, subsampling=sampling)
    assert JpegEncoder(cfg3, device=dev).encode(imgs[0]) == \
        JpegEncoder(cfg3, device="cpu").encode(imgs[0])


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_decode_kernel_equals_twin_native_and_cpu(dev, sampling):
    """Kernel G's coefficients equal its twin's and the native host
    decoder's exactly, on a clean and a corrupted stream; the card's RGB
    is within jpeg_tpu's device-vs-host bound of the CPU path's."""
    from jpeg_tpu_torch import decode_jpeg, decode_jpeg_batch
    from jpeg_tpu_torch.golden import decoder as gdec
    from jpeg_tpu_torch.kernels import huffdec as hd
    from jpeg_tpu_torch.pipelines import decode as dec
    h, w = (64, 96) if sampling == "420" else (48, 64)
    imgs = synthetic_batch(np.random.default_rng(53), 2, h, w)
    cfg = EncodeConfig(scan_layout="interleaved", huffman="dynamic",
                       subsampling=sampling, restart_interval_mcu_rows=1)
    datas = FastBatchEncoder(h, w, cfg, device="cpu").encode_batch(imgs)
    info = dec._parse_device_eligible(datas[0])
    zz = dec._decode_lanes([info], dev)
    assert torch.equal(zz.cpu(), dec._decode_lanes([info], "cpu"))
    comps, coeffs, *_ = gdec.parse_coefficients(datas[0])
    for got, comp in zip(dec._planes_of(zz, info), comps):
        assert torch.equal(got.cpu(), torch.from_numpy(coeffs[comp.comp_id]))
    streams, mw = hd.pack_streams(info["segs"])
    streams[1, 3] ^= 1 << 9
    streams[2, 1:3] = -1
    tabs = hd.lane_tables([info["quad"]] * len(info["segs"]))
    args = [torch.from_numpy(a) for a in (streams, *tabs)]
    args.append(torch.tensor([info["nblk"]], dtype=torch.int32))
    nblk_seg = info["ri"] * info["period"]
    want = hd.decode_segments_plain(*args, sampling, nblk_seg, mw)
    reset_launch_counts()
    got = hd.decode_segments(*[a.to(dev) for a in args], sampling,
                             nblk_seg, mw)
    assert launch_counts()["decode_segments"] == 1
    assert torch.equal(got.cpu(), want)
    for card, cpu in zip(decode_jpeg_batch(datas, "device", device=dev),
                         decode_jpeg_batch(datas, "device", device="cpu")):
        diff = (card.cpu().to(torch.int32) - cpu.to(torch.int32)).abs()
        assert int(diff.max()) <= 2 and float((diff <= 1).double().mean()) \
            > 0.999
    one = decode_jpeg(datas[1], device=dev)
    assert one.device.type == "cuda" and one.shape == (h, w, 3)


@pytest.mark.parametrize("kind", ["3scan", "420", "gray"])
def test_speculative_kernels_equal_twins_native_and_cpu(dev, kind):
    """Kernel H equals its twin at the round-1 guesses and at the fixpoint,
    G's speculative mode at the fixpoint's payload; the card's speculative
    coefficients equal the native decoder's, and decode_jpeg on the card
    (through H and G) is within jpeg_tpu's bound of the CPU path."""
    from jpeg_tpu_torch import decode_jpeg
    from jpeg_tpu_torch.golden import decoder as gdec
    from jpeg_tpu_torch.kernels import huffdec as hd
    from jpeg_tpu_torch.pipelines import decode as dec
    from jpeg_tpu_torch.pipelines import speculative as spec
    h, w = 96, 128
    imgs = synthetic_batch(np.random.default_rng(61), 1, h, w)
    if kind == "3scan":
        data = JpegEncoder(EncodeConfig(), device="cpu").encode(imgs[0])
    elif kind == "420":
        data = FastBatchEncoder(h, w, EncodeConfig(scan_layout="interleaved"),
                                device="cpu").encode_batch(imgs)[0]
    else:
        data = encode_gray(imgs[0, ..., 0], device="cpu")
    p = spec._parse_spec(data)
    chains = [(hd.unstuff_segments(e)[0], q, n) for e, q, n in p["scan_list"]]
    lanes = spec.prepare_lanes(chains, dev, 128, p["sampling"])
    S, cap = lanes.streams.shape[0], spec.first_cap(lanes)
    fx = spec.fixpoint(lanes)
    assert fx is not None and S > len(chains)
    for entries, phases in ((np.zeros(S, np.int64), lanes.prior), fx[:2]):
        ep = spec._put(dev, entries, phases)
        args = (lanes.streams, *lanes.tables, ep[0:1], lanes.limits, cap,
                lanes.max_words, lanes.sampling, ep[1:2])
        for a, b in zip(hd.scan_positions(*args),
                        hd.scan_positions_plain(*args)):
            assert torch.equal(a, b)
    gargs, gkw = spec.payload_inputs(lanes, *fx)
    assert torch.equal(hd.decode_segments(*gargs, **gkw),
                       hd.decode_segments_plain(*gargs, **gkw))
    got = spec._spec_scans(p["scan_list"], device=dev,
                           target_lane_bytes=128, sampling=p["sampling"])
    comps, coeffs, *_ = gdec.parse_coefficients(data)
    if p["kind"] == "interleaved":
        em = got[0].reshape(p["mx"] * p["my"], -1, 64)
        got = dec._em_to_planes(em, p["sampling"], p["mx"], p["my"])
    for plane, comp in zip(got, comps):
        assert torch.equal(plane.cpu(),
                           torch.from_numpy(coeffs[comp.comp_id]))
    reset_launch_counts()
    card = decode_jpeg(data, "device", device=dev)
    counts = launch_counts()
    assert counts["scan_positions"] >= 1 and counts["decode_segments"] == 1
    cpu = decode_jpeg(data, "device", device="cpu")
    diff = (card.cpu().to(torch.int32) - cpu.to(torch.int32)).abs()
    assert int(diff.max()) <= 2 and float((diff <= 1).double().mean()) > 0.999


@pytest.mark.parametrize("S,nblk", [(3, 1), (2, 4095), (2, 4096), (2, 4097),
                                    (1, 57600), (1, 38400), (640, 240)])
def test_segment_offsets_edges_equal_twin(dev, S, nblk):
    """Kernel C's look-back scan at its tile's edges (4096 blocks), long
    single segments and many short ones, 50 launches back to back."""
    rng = np.random.default_rng(S * 100003 + nblk)
    bits = torch.from_numpy(
        rng.integers(0, 1729, (S, nblk)).astype(np.int32)).to(dev)
    want = fused.segment_offsets_plain(bits)
    runs = [fused.segment_offsets(bits) for _ in range(50)]
    torch.cuda.synchronize()
    for got in runs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["random", "cap64", "short", "rows8000",
                                  "rows20000", "rows40000", "rows60000"])
def test_scan_positions_edges_equal_twin(dev, case):
    """Kernel H against its twin off the fixpoint's path: random (entry,
    phase) pairs (entries inside codes and past the limit), a cap of 64,
    lanes shorter than 32 blocks, and rows padded into each shared-memory
    layout of ``jt_scan_positions``: four staged lanes a CTA past the 48 KiB
    default (8000 words), two (20000), one (40000), and rows left in
    global memory (60000)."""
    from jpeg_tpu_torch.kernels import huffdec as hd
    from jpeg_tpu_torch.pipelines import speculative as spec
    h, w = 96, 128
    imgs = synthetic_batch(np.random.default_rng(67), 1, h, w)
    if case == "random":
        data = FastBatchEncoder(h, w, EncodeConfig(scan_layout="interleaved"),
                                device="cpu").encode_batch(imgs)[0]
    else:
        data = JpegEncoder(EncodeConfig(), device="cpu").encode(imgs[0])
    p = spec._parse_spec(data)
    chains = [(hd.unstuff_segments(e)[0], q, n) for e, q, n in p["scan_list"]]
    lanes = spec.prepare_lanes(chains, dev, 128, p["sampling"])
    S, cap = lanes.streams.shape[0], spec.first_cap(lanes)
    rng = np.random.default_rng(71)
    streams, limits, mw = lanes.streams, lanes.limits, lanes.max_words
    if case == "random":
        pick = rng.integers(0, S, 256)
        entries = rng.integers(0, lanes.limit_bits[pick] + 64)
        phases = rng.integers(0, 12, 256)
        idx = torch.from_numpy(pick).to(dev)
        streams = streams[idx].contiguous()
        limits = limits[:, idx].contiguous()
        tables = (lanes.tables[0][:, idx].contiguous(),
                  lanes.tables[1][:, idx].contiguous(),
                  lanes.tables[2][idx].contiguous())
    else:
        fx = spec.fixpoint(lanes)
        assert fx is not None
        entries, phases, tables = fx[0], fx[1], lanes.tables
        if case == "cap64":
            cap = 64
        elif case == "short":
            limits = spec._put(dev, entries + rng.integers(40, 201, S))
        else:
            mw = int(case[4:])
            streams = torch.nn.functional.pad(
                streams, (0, mw - lanes.max_words))
    ep = spec._put(dev, entries, phases)
    args = (streams, *tables, ep[0:1], limits, cap, mw, lanes.sampling,
            ep[1:2])
    for a, b in zip(hd.scan_positions(*args), hd.scan_positions_plain(*args)):
        assert torch.equal(a, b)


def _g_lanes(dev):
    """Kernel G's inputs for a 2x64x96 r1 file pair (dynamic tables), on
    ``dev``: (streams, maxc, delt, hvp, nblk, sampling, nblk_seg, words)."""
    from jpeg_tpu_torch.pipelines import decode as dec
    imgs = synthetic_batch(np.random.default_rng(73), 2, 64, 96)
    cfg = EncodeConfig(scan_layout="interleaved", huffman="dynamic",
                       restart_interval_mcu_rows=1)
    datas = FastBatchEncoder(64, 96, cfg, device="cpu").encode_batch(imgs)
    *arrays, samp, nseg, mw = dec._lane_inputs(
        [dec._parse_device_eligible(d) for d in datas])
    return [torch.from_numpy(a).to(dev) for a in arrays] + [samp, nseg, mw]


@pytest.mark.parametrize("case", ["random_bits", "off_step",
                                  "random_bits_off_step", "rows8000",
                                  "rows20000", "rows40000", "rows60000",
                                  "speculative_random"])
def test_decode_segments_edges_equal_twin(dev, case):
    """Kernel G against its twin off the main path: random bits (codes
    longer than the 9-bit lookahead, codes that match nothing, runs past
    slot 63), tables whose bounds are off the lookahead step (every code
    searched), rows padded into each shared-memory layout of
    ``jt_decode_segments`` (four, two and one staged lanes a CTA, and rows
    left in global memory, as the source reports them), and random (entry,
    phase) pairs in the speculative mode."""
    from jpeg_tpu_torch.kernels import huffdec as hd
    streams, maxc, delt, hvp, nblk, samp, nseg, mw = _g_lanes(dev)
    rng = np.random.default_rng(79)
    noise = torch.from_numpy(rng.integers(
        -2**31, 2**31, tuple(streams.shape), dtype=np.int64).astype(
            np.int32)).to(dev)
    off = maxc.clone()
    off[16:48] += 1
    kw = {}
    if case.startswith("random_bits"):
        streams = noise
    if case.endswith("off_step"):
        maxc = off
    if case.startswith("rows"):
        words = int(case[4:])
        want = {8000: (4, True), 20000: (2, True), 40000: (1, True),
                60000: (4, False)}[words]
        assert hd.lane_layout("decode_segments", words) == want
        streams = torch.nn.functional.pad(streams, (0, words - mw))
        mw = words
    if case == "speculative_random":
        S = streams.shape[0]
        ep = torch.from_numpy(np.stack([
            rng.integers(0, 32 * mw + 64, S), rng.integers(0, 12, S),
            rng.integers(0, nseg + 1, S)]).astype(np.int32)).to(dev)
        nblk = ep[2:3]
        kw = dict(entry=ep[0:1], phase=ep[1:2], phased=True)
    args = (streams, maxc, delt, hvp, nblk, samp, nseg, mw)
    assert torch.equal(hd.decode_segments(*args, **kw),
                       hd.decode_segments_plain(*args, **kw))


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray", "px",
                                  "px_xt", "misaligned_420",
                                  "misaligned_gray", "misaligned_px"])
def test_front_dct_random_frames_equal_twin(dev, mode):
    """Kernel A against its twin on uniform-random frames (every
    coefficient nonzero, truncation boundaries dense) in each mode and
    both orders, and on pixels that start off the kernel's alignment (the
    wrapper hands it an aligned copy)."""
    rng = np.random.default_rng(83)
    c = {k: torch.from_numpy(v).to(dev)
         for k, v in host_constants(None).items()}
    consts = (c["m"], c["bias"], c["ql"], c["qc"])
    samp = {"422": "422", "444": "444"}.get(mode, "420")
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 48, 64, 3),
                                         dtype=np.uint8)).to(dev)

    def off_by_one(t):  # a copy of t whose data start one element late
        flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
        return flat[1:1 + t.numel()].view(t.shape).copy_(t)
    if mode in ("gray", "misaligned_gray"):
        plane = imgs[..., 0].contiguous()
        if mode == "misaligned_gray":
            plane = off_by_one(plane)
        assert torch.equal(front.front_dct_gray(plane, *consts[:3]),
                           front.front_dct_gray_plain(plane, *consts[:3]))
        return
    if mode in ("px", "px_xt", "misaligned_px"):
        for sp in ("422", "444"):
            px = color.mcu_blocks(*color.rgb_to_ycbcr(imgs, sp), sp)
            if mode == "px_xt":
                px = px.reshape(-1, 64).T.contiguous()
            if mode == "misaligned_px":
                px = off_by_one(px)
            tr = mode == "px_xt"
            layout = color.LAYOUTS[sp]
            assert torch.equal(
                front.front_dct_px(px, *consts, layout, transposed=tr),
                front.front_dct_px_plain(px, *consts, layout, transposed=tr))
        return
    x = imgs.reshape(3, 48, 192)
    if mode == "misaligned_420":
        x = off_by_one(x)
    for order in ("mcu", "scan"):
        assert torch.equal(
            front.front_dct(x, *consts, order=order, sampling=samp),
            front.front_dct_plain(x, *consts, order=order, sampling=samp))


def _random_fields(rng, S: int, nblk: int, max_bits: int, p_null: float):
    """Random D fields as numpy [S, nblk, 64]: nbits in [1, max_bits], 0
    (NULL) for a share p_null of the slots, and value < 2^nbits."""
    nb = rng.integers(1, max_bits + 1, (S, nblk, 64))
    nb[rng.random((S, nblk, 64)) < p_null] = 0
    val = rng.integers(0, 1 << 30, (S, nblk, 64)) & ((1 << nb) - 1)
    return nb, val


@pytest.mark.parametrize("case", ["one_block", "padding", "fields30",
                                  "word_boundary", "r17", "y_scan"])
def test_place_edges_equal_twin(dev, case):
    """Kernel D into a buffer pre-filled with 0xFFFFFFFF: each stream's
    words equal the twin's, the words past it stay untouched.  Segments of
    one block; explicit padding blocks (whole tiles with no bits, a
    segment with none at all); random fields of up to 30 bits; streams
    ending on a word boundary; segments of 4080 blocks (1920x1088 r17's Y
    scan) and of 38400 (a 1920x1280 Y scan)."""
    rng = np.random.default_rng(53)
    if case == "padding":
        lut = torch.from_numpy(host_constants(None)["lut"]).to(dev)
        value, nbits, bits = fused.symbolize_bits_explicit_plain(
            *explicit_random(rng, dev), lut)
        assert int(bits.sum(-1).min()) == 0
    else:
        S, nblk, max_bits, p_null = {
            "one_block": (700, 1, 16, 0.8), "fields30": (3, 500, 30, 0.5),
            "word_boundary": (5, 333, 30, 0.7), "r17": (2, 4080, 16, 0.93),
            "y_scan": (1, 38400, 16, 0.95)}[case]
        nb, val = _random_fields(rng, S, nblk, max_bits, p_null)
        if case == "word_boundary":  # the last two slots fill the word
            nb[:, -1, 62:] = val[:, -1, 62:] = 0
            pad = -nb.sum(axis=(1, 2)) % 32
            nb[:, -1, 62], nb[:, -1, 63] = pad // 2, pad - pad // 2
        nbits = torch.from_numpy(nb.astype(np.uint8)).to(dev)
        value = torch.from_numpy(val.astype(np.int32)).to(dev).view(
            torch.uint32)
        bits = nbits.to(torch.int32).sum(-1, dtype=torch.int32)
    offs, totals = fused.segment_offsets_plain(bits)
    if case == "word_boundary":
        assert not bool((totals % 32).any())
    sw = rows_per_segment(value.shape[1] * 64) * 128
    got = place_checked(value, nbits, offs, totals, sw)
    want = place_plain_streams(value, nbits, offs, totals, sw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout,nblk", FIELDS_LAYOUTS,
                         ids=["420", "422", "444", "scan_y", "scan_chroma"])
def test_symbolize_fields_layouts_equal_twin(dev, layout, nblk):
    """Kernel E on random coefficients in every block pattern, without and
    with the mask, fresh and accumulating into random histogram rows."""
    rng = np.random.default_rng(55 + nblk)
    for label, kernel, plain in fields_cases(dev, rng, [(layout, nblk)]):
        got, want = kernel(), plain()
        assert torch.equal(got[0], want[0]), label
        assert torch.equal(got[1], want[1]), label


def test_symbolize_segments_padding_equal_twin(dev):
    """E's explicit mode with padding blocks (whole tiles, segment ends, a
    segment of padding only) and DC differences of +-4095."""
    ex = explicit_random(np.random.default_rng(57), dev)
    S = ex[0].shape[0]
    got = fused.symbolize_segments(*ex, S, 3)
    want = fused.symbolize_segments_plain(*ex, S, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # launches back to back: each leaves E's workspace zeroed
    runs = [fused.symbolize_segments(*ex, S, 3) for _ in range(20)]
    coef = torch.from_numpy(random_coefs(np.random.default_rng(59), 4,
                                         96)).to(dev)
    runs2 = [fused.symbolize_fields(coef, 2) for _ in range(20)]
    want2 = fused.symbolize_fields_plain(coef, 2)
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got[1], want[1])
    for got in runs2:
        assert torch.equal(got[0], want2[0])
        assert torch.equal(got[1], want2[1])


@pytest.mark.parametrize("case", range(len(BITS_CASES) + 1),
                         ids=[f"{tuple(layout)}x{nblk}x{S}" for layout, nblk, S
                              in BITS_CASES] + ["explicit"])
def test_fields_kernels_edges_equal_twins(dev, case):
    """Kernels B and F (and B explicit, the last case) under their fields
    contract, out of pre-filled buffers, at their edges: every block
    pattern, nblk of 1, 2 and 3 (mod 4) and a single block, all-zero
    blocks, blocks ending at slot 63, long ZRL runs, ACs of +-2047 and DC
    differences of +-4094, explicit padding blocks, and a random LUT whose
    NULL entry is not empty; D placing B's own fields."""
    lut = torch.from_numpy(host_constants(None)["lut"]).to(dev)
    rng = np.random.default_rng(89 + case)
    picked = BITS_CASES[case:case + 1] or BITS_CASES[:1]
    checks = bits_cases(dev, rng, lut, picked)
    names = (["symbolize_bits_explicit"] if case == len(BITS_CASES)
             else ["symbolize_bits", "attach_pf"])
    for name in names:
        assert checks[name]
        for label, kernel, plain in checks[name]:
            for a, b in zip(kernel(), plain()):
                assert torch.equal(a, b), f"{name}: {label}"
    if case < len(BITS_CASES):
        # D on B's own fields, written over all ones (a random LUT)
        layout, nblk, S = BITS_CASES[case]
        coef = torch.from_numpy(edge_coefs(rng, S, nblk)).to(dev)
        rlut = random_lut(rng, dev)
        fields = fused.symbolize_bits_plain(coef, rlut, layout)
        got = fused.symbolize_bits(coef, rlut, layout,
                                   out=prefilled_fields(S, nblk, dev))
        offs = fused.segment_offsets_plain(fields[2])
        sw = rows_per_segment(nblk * 64) * 128
        want = place_plain_streams(*fields[:2], *offs, sw)
        for a, b in zip(place_checked(*got[:2], *offs, sw), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["fixed", "dynamic", "dynamic-sampled"])
def test_encode_stream_equals_encode_batch(dev, mode):
    """encode_stream on the card (streams, pinned buffers) gives
    encode_batch's files in order, at depths 1, 2 and 4, with a partial
    tail and a heavy random batch."""
    rng = np.random.default_rng(97)
    batches = [synthetic_batch(rng, 3, 64, 96) for _ in range(4)]
    batches.append(rng.integers(0, 256, (2, 64, 96, 3), np.uint8))
    enc = FastBatchEncoder(64, 96, EncodeConfig(
        scan_layout="interleaved", huffman=mode,
        restart_interval_mcu_rows=2), device=dev)
    want = [enc.encode_batch(b) for b in batches]
    for depth in (1, 2, 4):
        reset_launch_counts()
        assert list(enc.encode_stream(iter(batches), depth)) == want
        assert launch_counts()["place"] == len(batches)
    cpu = FastBatchEncoder(64, 96, enc.config, device="cpu")
    assert want[0][:2] == cpu.encode_batch(batches[0][:2])


def test_bucketed_encode_any_equals_cpu(dev):
    rng = np.random.default_rng(98)
    imgs = [synthetic_batch(rng, 1, h, w)[0]
            for h, w in ((64, 64), (37, 50), (64, 64), (100, 90))]
    got = BucketedEncoder(device=dev).encode_any(imgs)
    assert got == BucketedEncoder(device="cpu").encode_any(imgs)


@pytest.mark.parametrize("engine", ["spectral", "script"])
@pytest.mark.parametrize("mode", ["fixed", "dynamic"])
def test_progressive_equals_cpu(dev, engine, mode):
    img = synthetic_batch(np.random.default_rng(99), 1, 64, 96)[0]
    fn = encode_progressive if engine == "spectral" else \
        encode_progressive_script
    cfg = EncodeConfig(huffman=mode)
    reset_launch_counts()
    got = fn(img, cfg, device=dev)
    counts = launch_counts()
    kernels = (("front_dct", "attach_pf", "segment_offsets", "place")
               if engine == "spectral" else ("front_dct",))
    assert all(counts[k] > 0 for k in kernels)
    assert got == fn(img, cfg, device="cpu")


def _moving_frames(rng, n, h=256, w=160):
    """A background, then a rectangle moving each frame and, from frame 3
    on, a second one (frame 2 repeats frame 1)."""
    bg = synthetic_batch(rng, 1, h, w)[0]
    out = np.repeat(bg[None], n, axis=0)
    for i in range(1, n):
        t = i if i != 2 else 1
        out[i, 20 + 8 * t:70 + 8 * t, 10 + 6 * t:60 + 6 * t] = (240, 20, 30)
        if i >= 3:
            out[i, 190:240, 100:150] = 255 - bg[190:240, 100:150]
    return out


@pytest.mark.parametrize("mode", ["dynamic", "fixed"])
def test_monitor_equals_cpu(dev, mode):
    """ChangeMonitor on the card: every frame's areas, bytes and delay are
    the CPU path's, and the region encode launched its kernels."""
    frames = _moving_frames(np.random.default_rng(101), 5)
    cfg = EncodeConfig(huffman=mode)

    def run(device):
        mon = ChangeMonitor(256, 160, config=cfg, device=device)
        return [[((a.x, a.y, a.w, a.h), data) for a, data in r.regions]
                + [r.suggested_delay] for r in map(mon.process_frame, frames)]
    reset_launch_counts()
    got = run(dev)
    counts = launch_counts()
    path = (("symbolize_bits",) if mode == "fixed"
            else ("symbolize_fields", "attach_pf"))
    assert all(counts[k] > 0 for k in ("front_dct", "segment_offsets",
                                       "place", *path))
    assert got == run("cpu")
    assert [len(r) - 1 for r in got] == [0, 1, 0, 2, 1]


def test_pairwise_batch_equals_cpu(dev):
    frames = _moving_frames(np.random.default_rng(102), 16)
    got = FrameComparator(256, 160, device=dev)
    sub = got.subsample(frames)
    assert sub.is_cuda and sub.shape == (16, 64, 40, 3)
    want = FrameComparator(256, 160, device="cpu")
    assert torch.equal(sub.cpu(), want.subsample(frames))
    pairs = got.compare_pairwise_batch(frames)
    assert pairs == want.compare_pairwise_batch(frames)
    assert pairs[1] == [] and pairs[0]


@pytest.fixture(scope="module")
def card_mesh(dev):
    """A 1x1 mesh on the card: a world-size-1 NCCL group of this process."""
    import torch.distributed as dist
    from jpeg_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("mode,dtype", [("fixed", "float32"),
                                        ("dynamic", "float32"),
                                        ("dynamic-sampled", "float32"),
                                        ("dynamic", "float64")])
def test_sharded_one_rank_equals_fast_and_cpu(card_mesh, mode, dtype):
    """``ShardedEncoder`` at world size 1 on the card (NCCL): its files
    equal ``FastBatchEncoder``'s with the same restart interval on the
    card ("dynamic-sampled": the dynamic mode's, as jpeg_tpu's sharded
    encoder counts every block) and the CPU path's; then the mesh decode
    of them equals the decode without a mesh, and the coefficients kernel
    G gives over the mesh equal the golden decoder's (a decoder that
    shares no code with G)."""
    from jpeg_tpu_torch import decode_jpeg_batch
    from jpeg_tpu_torch.golden import decoder as golden_dec
    from jpeg_tpu_torch.parallel.sharded import ShardedEncoder
    from jpeg_tpu_torch.pipelines import decode as pdec
    imgs = synthetic_batch(np.random.default_rng(37), 2, 160, 96)
    cfg = dict(scan_layout="interleaved", dtype=dtype)
    enc = ShardedEncoder(card_mesh, 160, 96,
                         EncodeConfig(huffman=mode, **cfg), segs_per_device=5)
    got = enc.encode_batch(imgs)
    exact = "fixed" if mode == "fixed" else "dynamic"
    ref = EncodeConfig(huffman=exact, restart_interval_mcu_rows=2, **cfg)
    assert got == FastBatchEncoder(160, 96, ref, device=card_mesh.device_type
                                   ).encode_batch(imgs)
    assert got == FastBatchEncoder(160, 96, ref, device="cpu"
                                   ).encode_batch(imgs)
    if dtype == "float64":
        assert got == [golden.encode(img, scan_layout="interleaved",
                                     restart_interval_mcu_rows=2)
                       for img in imgs]
    plain = decode_jpeg_batch(got, entropy_engine="device")
    meshed = decode_jpeg_batch(got, entropy_engine="device", mesh=card_mesh)
    assert all(torch.equal(a, b) for a, b in zip(plain, meshed))
    infos = [pdec._parse_device_eligible(f) for f in got]
    zz = pdec._decode_lanes(infos, "cuda", card_mesh).cpu()
    off = 0
    for f, inf in zip(got, infos):
        planes = pdec._planes_of(zz[off:off + len(inf["segs"])], inf)
        off += len(inf["segs"])
        comps, coeffs, *_ = golden_dec.parse_coefficients(f)
        for plane, comp in zip(planes, comps):
            assert np.array_equal(plane.numpy(), coeffs[comp.comp_id])


def test_device_us_retries_then_raises(monkeypatch):
    """chip_smoke.device_us never reads 0: a profile that saw no device
    work is retried, and if none does, it raises.  Needs no card."""
    import chip_smoke
    calls = []

    def empty(fn, runs):
        calls.append(runs)
        return {}, 1.0
    monkeypatch.setattr(chip_smoke, "device_profile", empty)
    with pytest.raises(AssertionError, match="none of 7 profiles"):
        chip_smoke.device_us(lambda: None, 5)
    assert calls == [5] * (3 + chip_smoke.DEVICE_US_EXTRA)


def test_device_us_drops_short_profiles(monkeypatch):
    """A profile that lost a device op the others saw, or all of them, is
    dropped and replaced; the readings and the count of drops are kept."""
    import chip_smoke
    profiles = iter([{"A": 2.0, "copy": 1.0}, {"copy": 1.0}, {},
                     {"A": 2.5, "copy": 1.0}, {"A": 2.0, "copy": 1.5}])
    monkeypatch.setattr(chip_smoke, "device_profile",
                        lambda fn, runs: (next(profiles), 0.5))
    us = chip_smoke.device_us(lambda: None, 5)
    assert us == (3.5, [3.0, 3.5, 3.5], ["A", "copy"], 2)
    assert "3 profiles kept, 2 dropped" in chip_smoke.device_text(us)
