"""The plain reference against the project's golden encoder and decoder
(the program's own oracles, read here only to hold the frozen copies to
them), and the bfloat16 control against the reference."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import check
from benchmark.reference import decode as D
from benchmark.reference import jpeg as R
from benchmark.synth import stamp, stamped, synthetic_batch

golden_encoder = pytest.importorskip("jpeg_tpu_torch.golden.encoder")
golden_decoder = pytest.importorskip("jpeg_tpu_torch.golden.decoder")
huffman_build = pytest.importorskip("jpeg_tpu_torch.huffman.build")


def frames(n: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    return synthetic_batch(np.random.default_rng(seed), n, h, w,
                           "cpu").numpy()


@pytest.mark.parametrize("huffman", ["fixed", "dynamic"])
@pytest.mark.parametrize("restart_rows", [0, 2])
@pytest.mark.parametrize("quality", [None, 75])
def test_encode_equals_the_golden_encoder(huffman, restart_rows, quality):
    for img in frames(2, 64, 96):
        want = golden_encoder.encode(img, quality=quality,
                                     scan_layout="interleaved",
                                     huffman=huffman,
                                     restart_interval_mcu_rows=restart_rows)
        assert R.encode(img, huffman, restart_rows,
                        quality=quality)[0] == want


def test_k2_equals_the_golden_tables():
    rng = np.random.default_rng(0)
    for _ in range(8):
        h = rng.integers(0, 60, 256) * (rng.random(256) < 0.4)
        h[int(rng.integers(0, 256))] += 1
        full = np.zeros(257, np.int64)
        full[:256], full[256] = h, 1
        a, b = huffman_build.build_table(full), R.k2_table(h)
        assert (a.bits == b.bits).all() and (a.code == b.code).all()


@pytest.mark.parametrize("restart_rows", [0, 1])
def test_decode_reads_back_the_coefficients(restart_rows):
    for img in frames(2, 48, 64):
        data, coefs = R.encode(img, "dynamic", restart_rows)
        got, info = D.coefficients(data)
        assert all((g == c).all() for g, c in zip(got, coefs))
        diff = np.abs(D.pixels(got, info).astype(int)
                      - golden_decoder.decode(data))
        assert diff.max() <= 1


def test_a_corrupt_file_is_refused():
    data, _ = R.encode(frames(1, 48, 48)[0], "fixed")
    with pytest.raises(D.Corrupt):
        D.coefficients(data[:len(data) // 2] + b"\xff\xd9")
    with pytest.raises(D.Corrupt):
        D.coefficients(b"\x00" + data[1:])


@pytest.mark.parametrize("hflip,vflip", [(1, 0), (0, 1), (1, 1)])
def test_flips_in_the_coefficient_domain_are_exact(hflip, vflip):
    img = frames(1, 64, 96)[0]
    mirrored = np.ascontiguousarray(img[::-1 if vflip else 1,
                                        ::-1 if hflip else 1])
    got = R.flipped(R.forward(img), 96, 64, hflip, vflip)
    assert all((g == w).all() for g, w in zip(got, R.forward(mirrored)))


def test_the_bfloat16_control_is_far_from_float64():
    img = frames(1, 128, 128)[0]
    data, _ = R.encode(img, "dynamic", a=R.BF16)
    numbers = check.encode_numbers([(img, data)], "dynamic")
    assert numbers["bad_files"] == 0  # a valid file of other coefficients
    assert numbers["worst_coef_diff_share"] > 1e-3
    data, coefs = R.encode(img, "fixed")
    info = D.parse(data)
    numbers = check.decode_numbers([(coefs, info,
                                     D.pixels(coefs, info, R.BF16))])
    assert numbers["worst_px_over2_share"] > 0


@pytest.mark.parametrize("how", ["floor", "minus_one"])
def test_a_decode_biased_by_a_level_is_not_correct(how):
    """A decoder that truncates where it should round, or is one level
    off everywhere, stays within 2 of the reference at every value; the
    mean absolute difference still fails it under the cell's limits."""
    import json
    import os
    img = frames(1, 128, 128)[0]
    data, coefs = R.encode(img, "fixed")
    info = D.parse(data)
    want = D.pixels(coefs, info)
    if how == "floor":
        biased = np.where(np.arange(want.size).reshape(want.shape) % 2,
                          np.maximum(want.astype(np.int16) - 1, 0), want)
    else:
        biased = np.maximum(want.astype(np.int16) - 1, 0)
    numbers = check.decode_numbers([(coefs, info, biased.astype(np.uint8))])
    assert numbers["worst_px_over2_share"] == 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "photo1920-fixed.json")) as f:
        limits = json.load(f)["limits"]["decode"]
    assert not check.judge(numbers, limits)[0]


def test_stamps_make_every_batch_distinct():
    pool = [frames(2, 48, 48, seed=s) for s in (1, 2)]
    seen = {stamped(pool, i, j).tobytes() for i in range(6)
            for j in range(2)}
    assert len(seen) == 12
    b = pool[0].copy()
    stamp(b, 4)
    assert (stamped(pool, 4, 1) == b[1]).all()
    assert (stamped(pool, 4, 1).reshape(-1)[8:]
            == pool[0][1].reshape(-1)[8:]).all()
