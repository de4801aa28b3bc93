"""The exceptions to ``chip_smoke.py``'s golden check in phase 3f.

Phase 3f holds the card's decode to jpeg_tpu's bound against the golden
decoder (max |diff| <= 2, > 99.9 % within 1; ``RGB_MAX_DIFF``,
``RGB_WITHIN_1``) except on the frames of ``REFERENCE_GOLDEN_MISSES``,
where it holds the card to the reading recorded there.  This file is the
witness for each exception, apart from the port's decoder: jpeg_tpu's own
host decode of the frame, un-jitted and jitted, gives that reading against
jpeg_tpu's golden decoder and misses the bound, in the blue channel only,
and the port's CPU decode gives jpeg_tpu's un-jitted pixels.  The frames
are phase 3f's at ``--seed 0``, drawn in ``spec_cases``' order; the files
are the port's CPU encodes, byte for byte its card encodes
(``chip_smoke.py`` phase 3).
"""
import jax
import numpy as np
import pytest
import torch

from jpeg_tpu.golden import decoder as jgolden
from jpeg_tpu.pipelines import decode as jdec
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder, JpegEncoder
from jpeg_tpu_torch import decode_jpeg

import chip_smoke as smoke


@pytest.fixture(scope="module")
def frames():
    """(case label, image) -> the port's file of that frame, for every
    3-scan batch image and DRI-less interleaved file of phase 3f."""
    rng = np.random.default_rng(0 + smoke.SPEC_RNG_OFFSET)
    for h, w in smoke.SPEC_SCAN:
        smoke.synthetic_batch(rng, 1, h, w)
    b, h, w = smoke.SPEC_BATCH
    batch = smoke.synthetic_batch(rng, b, h, w)
    wanted = set(smoke.REFERENCE_GOLDEN_MISSES)
    out = {}
    label = f"decode_jpeg_batch 3-scan {b}x{w}x{h}"
    enc = JpegEncoder(EncodeConfig(), device="cpu")
    for i in range(b):  # each image's tables are its own
        if (label, i) in wanted:
            out[label, i] = enc.encode(torch.from_numpy(batch[i]))
    for samp, h, w in smoke.SPEC_INTERLEAVED:
        frame = smoke.synthetic_batch(rng, 1, h, w)
        label = (f"decode_jpeg DRI-less interleaved {smoke.LABEL[samp]} "
                 f"{w}x{h}")
        if (label, 0) in wanted:
            cfg = EncodeConfig(scan_layout="interleaved", subsampling=samp)
            out[label, 0] = FastBatchEncoder(h, w, cfg, device="cpu") \
                .encode_batch(torch.from_numpy(frame))[0]
    return out


def _reading(img: np.ndarray, gold: np.ndarray) -> tuple[int, float]:
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    return int(diff.max()), float(np.mean(diff <= 1))


@pytest.mark.parametrize("key", sorted(smoke.REFERENCE_GOLDEN_MISSES))
def test_reference_misses_the_golden_bound_there(frames, key):
    assert key in frames, f"{key}: no such frame in phase 3f"
    data = frames[key]
    gold = jgolden.decode(data)
    with jax.disable_jit():
        eager = np.asarray(jdec.decode_jpeg(data, entropy_engine="host"))
    jitted = np.asarray(jdec.decode_jpeg(data, entropy_engine="host"))
    want_max, want_share = smoke.REFERENCE_GOLDEN_MISSES[key]
    for what, img in (("un-jitted", eager), ("jitted", jitted)):
        got_max, got_share = _reading(img, gold)
        assert (got_max, np.floor(got_share * 1e6) / 1e6) == \
            (want_max, want_share), f"{key}: jpeg_tpu {what}"
        assert got_max > smoke.RGB_MAX_DIFF or \
            not got_share > smoke.RGB_WITHIN_1, f"{key}: holds the bound"
    # every miss lies in the blue channel (Cb's weight there is 1.772)
    red_green = np.abs(eager[..., :2].astype(np.int32)
                       - gold[..., :2].astype(np.int32))
    assert red_green.max() <= 1, f"{key}: red or green off by more than 1"
    port = decode_jpeg(data, "host", device="cpu").numpy()
    np.testing.assert_array_equal(port, eager)
