"""jpeg_tpu_torch's FastBatchEncoder.encode_stream and BucketedEncoder
against jpeg_tpu's (interpret mode on the CPU): the same files in the same
order, byte for byte.  The port runs on the CPU here, i.e. the same order
of stages through the plain twins of its CUDA kernels, without streams or
pinned buffers."""
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines.bucket import BucketedEncoder as JaxBucketed
from jpeg_tpu.pipelines.fast import FastBatchEncoder as JaxEncoder
from jpeg_tpu_torch import BucketedEncoder, EncodeConfig, FastBatchEncoder


def _batches(img):
    """``tests/test_fast_pipeline.py``'s stream inputs: three 64x64
    batches of 2, then five (a partial tail group at depth 2, and a heavy
    random batch)."""
    img = np.asarray(img)[:64, :64]
    batches = [np.stack([np.roll(img, 4 * i + j, axis=1) for j in range(2)])
               for i in range(3)]
    heavy = np.stack([
        np.random.default_rng(3).integers(0, 256, img.shape, np.uint8),
        img])
    return batches, batches + [np.stack([img, np.roll(img, 9, axis=0)]),
                               heavy]


# (Huffman mode, sampling, restart rows)
STREAM_CASES = {
    "fixed": ("fixed", "420", 0),
    "dynamic": ("dynamic", "420", 0),
    "dynamic-sampled": ("dynamic-sampled", "420", 0),
    "fixed-r2": ("fixed", "420", 2),
    "dynamic-422-r4": ("dynamic", "422", 4),
}
# (case, sync_depth, which batches): the default depth on three batches,
# depth 2 on five
RUNS = [("fixed", None, "three"), ("fixed", 2, "five"),
        ("dynamic", None, "three"), ("dynamic", 2, "five"),
        ("dynamic-sampled", 2, "five"), ("fixed-r2", 2, "five"),
        ("dynamic-422-r4", 2, "five")]


def _config(case, cls=EncodeConfig, **kw):
    huff, sampling, rows = STREAM_CASES[case]
    return cls(scan_layout="interleaved", huffman=huff, subsampling=sampling,
               restart_interval_mcu_rows=rows, **kw)


def _stream(enc, batches, depth):
    got = (enc.encode_stream(iter(batches)) if depth is None
           else enc.encode_stream(iter(batches), sync_depth=depth))
    return [[bytes(f) for f in files] for files in got]


@pytest.fixture(scope="module")
def jax_stream(img_synthetic_160):
    """Per (case, depth, which): jpeg_tpu's streamed files (one encoder a
    case, so each compiles once)."""
    three, five = _batches(img_synthetic_160)
    inputs = {"three": three, "five": five}
    encoders = {}

    def get(case, depth, which):
        if case not in encoders:
            encoders[case] = JaxEncoder(64, 64, config=_config(case,
                                                               JaxConfig),
                                        interpret=True)
        return inputs[which], _stream(encoders[case], inputs[which], depth)
    return get


@pytest.mark.parametrize("case,depth,which", RUNS)
def test_encode_stream_matches_jax(jax_stream, case, depth, which):
    batches, want = jax_stream(case, depth, which)
    enc = FastBatchEncoder(64, 64, _config(case), device="cpu")
    got = _stream(enc, batches, depth)
    assert got == want
    assert got == [enc.encode_batch(b) for b in batches]


@pytest.mark.parametrize("huffman", ["fixed", "dynamic"])
def test_encode_stream_f64_matches_encode_batch(img_synthetic_160, huffman):
    """f64 exact mode: the streamed files are encode_batch's (jpeg_tpu's
    jitted f64 encoder is not the reference here, ROADMAP §3)."""
    _, five = _batches(img_synthetic_160)
    enc = FastBatchEncoder(64, 64, EncodeConfig(
        scan_layout="interleaved", huffman=huffman, dtype="float64",
        restart_interval_mcu_rows=2), device="cpu")
    assert _stream(enc, five, 2) == [enc.encode_batch(b) for b in five]


@pytest.mark.parametrize("depth", [1, 3])
def test_encode_stream_takes_tensors_and_any_depth(img_synthetic_160,
                                                  depth):
    _, five = _batches(img_synthetic_160)
    enc = FastBatchEncoder(64, 64, _config("dynamic"), device="cpu")
    tensors = [torch.from_numpy(b).reshape(2, 64, 64 * 3) for b in five]
    assert _stream(enc, tensors, depth) == [enc.encode_batch(b)
                                            for b in five]


def test_stream_depth_is_cut_by_free_memory(monkeypatch):
    """The depth is the number of batches whose worst-case buffers (the
    words, kernel I's files, the input, the fields) fit in the card's free
    memory, at most sync_depth and at least 1."""
    enc = FastBatchEncoder(64, 64, _config("fixed"), device="cpu")
    assert enc._stream_depth(2, 4) == 4 and enc._stream_depth(2, 0) == 1
    seg_words = enc.seg_rows * 128
    per_image = (enc.n_segs * seg_words * 4
                 + enc.n_segs * (8 * seg_words + 4) + 64 * 64 * 3
                 + enc.n_segs * enc.blocks_per_seg * 64 * 16)
    enc.device = torch.device("cuda", 0)
    for free, want in ((100 * per_image, 4), (5 * per_image, 2),
                       (per_image, 1)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None, free=free: (free, 1 << 40))
        assert enc._stream_depth(2, 4) == want


@pytest.fixture(scope="module")
def bucket_images(img_synthetic_160):
    """``tests/test_quality_and_bucket.py``'s mixed and ragged lists."""
    big = np.asarray(img_synthetic_160)          # 160x96
    small = big[:64, :64]
    raggeds = [big[:37, :50], big[:64, :64], big[:61, :64], big[:100, :90]]
    return [big, small, big, small, small], raggeds


# (label, config keywords, segs_per_image)
BUCKET_CASES = {
    "fixed": (dict(huffman="fixed"), None),
    "dynamic-segs-2": (dict(huffman="dynamic"), 2),
    # 4:2:2 restarts every 8-px MCU row: jpeg_tpu's rule counts 16-px
    # rows, so a 48-px-high image gets 3 segments, not 6
    "422-r1": (dict(huffman="fixed", subsampling="422",
                    restart_interval_mcu_rows=1), None),
}


@pytest.fixture(scope="module")
def jax_bucketed():
    """jpeg_tpu's BucketedEncoder per case, cached, so that the lists'
    shared geometries compile once."""
    cache = {}

    def get(label):
        if label not in cache:
            kw, segs = BUCKET_CASES[label]
            cache[label] = JaxBucketed(
                JaxConfig(scan_layout="interleaved", **kw),
                segs_per_image=segs, interpret=True)
        return cache[label]
    return get


def _bucketed(label):
    kw, segs = BUCKET_CASES[label]
    return BucketedEncoder(EncodeConfig(scan_layout="interleaved", **kw),
                           segs_per_image=segs, device="cpu")


@pytest.mark.parametrize("label", list(BUCKET_CASES))
def test_bucketed_encode_matches_jax(bucket_images, jax_bucketed, label):
    imgs, _ = bucket_images
    if label == "422-r1":
        imgs = [imgs[0][:48], imgs[1][:48], imgs[0][:48]]
    enc = _bucketed(label)
    assert enc.encode(imgs) == jax_bucketed(label).encode(imgs)
    assert len(enc._encoders) == 2
    if label == "422-r1":
        assert all(e.n_segs == 3 for e in enc._encoders.values())


@pytest.mark.parametrize("label", ["fixed", "dynamic-segs-2"])
def test_bucketed_encode_any_matches_jax(bucket_images, jax_bucketed,
                                         label):
    _, raggeds = bucket_images
    enc = _bucketed(label)
    assert enc.encode_any(raggeds) == jax_bucketed(label).encode_any(raggeds)
    assert len(enc._encoders) == 3


def test_bucketed_errors_match_jax(bucket_images):
    imgs, _ = bucket_images
    with pytest.raises(ValueError, match="pad with io.editimage"):
        BucketedEncoder(device="cpu").encode([imgs[0][:37]])
    with pytest.raises(ValueError, match="zero pixels"):
        BucketedEncoder(device="cpu").encode_any(
            [np.zeros((0, 4, 3), np.uint8)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_a_card():
    """No entry point falls back to the CPU: without a card, the default
    device raises."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketedEncoder()
    with pytest.raises((RuntimeError, AssertionError)):
        FastBatchEncoder(64, 64)
