"""jpeg_tpu_torch's progressive (SOF2) encoders against jpeg_tpu's: the
same bytes, exactly.  The port runs on the CPU here, i.e. kernel A, F, C
and D's plain twins; each jpeg_tpu reference is computed once."""
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines import progressive as jprog
from jpeg_tpu_torch import (EncodeConfig, encode_progressive,
                            encode_progressive_script)
from jpeg_tpu_torch.golden import decoder as gdec
from jpeg_tpu_torch.kernels import launch_counts, reset_launch_counts
from jpeg_tpu_torch.pipelines import progressive as prog


def _img(h, w, seed=0):
    """``tests/test_progressive.py``'s test image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 16 + xx // 16) % 2) * 140 + 50
    img = np.stack([base, 255 - base, xx * 255 // max(w - 1, 1)], axis=-1)
    return np.clip(img + rng.integers(-10, 11, size=img.shape),
                   0, 255).astype(np.uint8)


# sampling -> (height, width) of the image
SIZES = {"420": (64, 64), "422": (32, 48), "444": (40, 48)}
# one custom band script: split luma bands, a refinement scan of each
BAND_SCRIPT = [("dc", 0, 0, 0, 0), (0, 1, 5, 0, 1), (0, 6, 63, 0, 0),
               (1, 1, 63, 0, 0), (2, 1, 63, 0, 0), (0, 1, 5, 1, 0)]
# (engine, Huffman mode, sampling, dtype, script)
CASES = {
    **{f"spectral-{h}-{s}": ("spectral", h, s, "float32", None)
       for h in ("fixed", "dynamic") for s in SIZES},
    "spectral-dynamic-420-f64": ("spectral", "dynamic", "420", "float64",
                                 None),
    "script-fixed": ("script", "fixed", "420", "float32", None),
    "script-dynamic": ("script", "dynamic", "420", "float32", None),
    "script-dynamic-422": ("script", "dynamic", "422", "float32", None),
    "script-band": ("script", "dynamic", "420", "float32", BAND_SCRIPT),
}


def _call(module, case, img, **kw):
    engine, huff, sampling, dtype, script = CASES[case]
    cfg = (JaxConfig if module is jprog else EncodeConfig)(
        huffman=huff, subsampling=sampling, dtype=dtype)
    if engine == "spectral":
        return module.encode_progressive(img, cfg, **kw)
    return module.encode_progressive_script(img, cfg, script, **kw)


@pytest.fixture(scope="module")
def jax_files():
    cache = {}

    def get(case):
        if case not in cache:
            img = _img(*SIZES[CASES[case][2]], seed=1)
            cache[case] = img, _call(jprog, case, img)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_bytes_match_jax(jax_files, case):
    img, want = jax_files(case)
    got = _call(prog, case, img, device="cpu")
    assert got == want
    assert b"\xff\xc2" in got
    assert gdec.decode(got).shape == img.shape


def test_default_engine_runs_the_kernel_twins(jax_files):
    """The spectral engine goes through A, F, C and D (here their twins:
    no launch is counted on the CPU), and its scans are one DC and three
    AC band scans."""
    img, want = jax_files("spectral-dynamic-420")
    reset_launch_counts()
    got = encode_progressive(torch.from_numpy(img),
                             EncodeConfig(huffman="dynamic"), device="cpu")
    assert got == want and got.count(b"\xff\xda") == 4
    assert not any(launch_counts().values())


def test_successive_flag_routes_to_the_script_engine(jax_files):
    img, want = jax_files("script-dynamic")
    assert encode_progressive(img, EncodeConfig(huffman="dynamic"),
                              successive=True, device="cpu") == want


@pytest.mark.parametrize("script,match", [
    ([("dc", 0, 1, 0, 0)], "Ss=Se=0"),
    ([(0, 0, 5, 0, 0)], "coefficient 0"),
    ([(3, 1, 5, 0, 0)], "bad scan component"),
    ([(0, 1, 5, 2, 0)], "successive approximation"),
])
def test_script_errors_match_jax(script, match):
    img = _img(16, 16)
    with pytest.raises(ValueError, match=match):
        jprog.encode_progressive_script(img, JaxConfig(), script)
    with pytest.raises(ValueError, match=match):
        encode_progressive_script(img, EncodeConfig(), script, device="cpu")


@pytest.mark.parametrize("shape", [(24, 24, 3), (0, 16, 3)])
def test_bad_dims_raise_as_jax(shape):
    img = np.zeros(shape, np.uint8)
    for fn in (encode_progressive, encode_progressive_script):
        with pytest.raises(ValueError):
            getattr(jprog, fn.__name__)(img)
        with pytest.raises(ValueError):
            fn(img, device="cpu")


def test_eob_runs_match_jax():
    """``_apply_eob_runs`` on sparse slots with long empty runs."""
    rng = np.random.default_rng(5)
    n = 300
    sym = np.zeros((n, 64), np.int64)
    valid = np.zeros((n, 64), bool)
    for b in range(n):
        if rng.random() < 0.3:
            k = rng.integers(1, 63)
            sym[b, k], valid[b, k] = 0x11, True
            valid[b, k + 1] = True          # its EOB
        else:
            valid[b, 1] = True              # an empty band: EOB alone
    slots = {"sym": sym, "extra": valid.astype(np.int64),
             "extra_n": valid.astype(np.int64), "valid": valid}
    got = prog._apply_eob_runs(slots)
    want = jprog._apply_eob_runs(slots)
    for k in ("sym", "extra", "extra_n", "valid"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_a_card():
    img = _img(16, 16)
    for fn in (encode_progressive, encode_progressive_script):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(img)
