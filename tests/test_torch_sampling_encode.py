"""4:2:2 and 4:4:4 chroma through ``JpegEncoder`` and ``encode_jpeg``:
the port against jpeg_tpu's ``JpegEncoder`` (its "xla" engine, the CPU's
"auto") in both scan layouts, with restarts, ``encode_batch``,
``encode_any`` at odd dimensions, ``encode_region``, the dimension and
restart errors, and the f64 exact mode against jpeg_tpu's un-jitted f64
``JpegEncoder``.  The kernels and ``FastBatchEncoder`` at these
samplings are in ``test_torch_sampling.py``.  Every comparison is exact
equality: files are bytes."""
import numpy as np
import pytest

from jpeg_tpu.core.types import Area as JaxArea
from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines import encode as jencode
from jpeg_tpu_torch import Area, EncodeConfig, JpegEncoder, encode_jpeg

from test_torch_encode import port_message
from test_torch_ops import synthetic_images

SAMPLINGS = ["422", "444"]


def _both(sampling, call, **kw):
    """call(encoder) on jpeg_tpu's JpegEncoder and the port's (CPU)."""
    jenc = jencode.JpegEncoder(JaxConfig(subsampling=sampling, **kw))
    enc = JpegEncoder(EncodeConfig(subsampling=sampling, **kw), device="cpu")
    return call(enc), call(jenc)


# (label, kw, H, W): 4:2:2 heights and 4:4:4 widths off 16
JPEG_CASES = [
    ("3scan", dict(), {"422": (40, 48), "444": (40, 56)}),
    ("3scan-fixed-r1", dict(huffman="fixed", restart_interval_mcu_rows=1),
     {"422": (24, 32), "444": (24, 40)}),
    ("interleaved", dict(scan_layout="interleaved"),
     {"422": (40, 48), "444": (40, 56)}),
    ("interleaved-fixed-r2", dict(scan_layout="interleaved", huffman="fixed",
                                  restart_interval_mcu_rows=2),
     {"422": (32, 32), "444": (32, 40)}),
]


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("case", JPEG_CASES, ids=[c[0] for c in JPEG_CASES])
def test_jpeg_encoder_matches_jax(sampling, case):
    _, kw, shapes = case
    h, w = shapes[sampling]
    img = synthetic_images(77, 1, h, w)[0]
    got, want = _both(sampling, lambda e: e.encode(img), **kw)
    assert got == want
    if kw.get("restart_interval_mcu_rows"):
        assert b"\xff\xdd" in got and b"\xff\xd0" in got


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_batch_any_and_region_match_jax(sampling):
    """``encode_batch`` (3-scan, two images), ``encode_any`` at odd
    dimensions (padded to the sampling's MCU, interleaved), the one-shot
    ``encode_jpeg`` and ``encode_region``."""
    frame = synthetic_images(79, 2, 40, 56)
    got, want = _both(sampling, lambda e: e.encode_batch(frame[:, :, :48]))
    assert got == want
    odd = frame[0, :37, :45]
    got, want = _both(sampling, lambda e: e.encode_any(odd))
    assert got == want
    cfg = dict(huffman="fixed", subsampling=sampling)
    assert encode_jpeg(frame[1, :32, :48], EncodeConfig(**cfg),
                       device="cpu") == \
        jencode.encode_jpeg(frame[1, :32, :48], JaxConfig(**cfg))
    got = JpegEncoder(EncodeConfig(**cfg), device="cpu").encode_region(
        frame[1], Area(16, 8, 32, 16))
    want = jencode.JpegEncoder(JaxConfig(**cfg)).encode_region(
        frame[1], JaxArea(16, 8, 32, 16))
    assert got == want


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_dimension_errors_match_jax(sampling):
    """Heights and widths off the sampling's MCU, and a restart interval
    that does not divide the 8-px MCU rows (interleaved, XLA engine)."""
    odd_w = {"422": 40, "444": 44}[sampling]
    for shape, kw in (((36, 48), {}), ((40, odd_w), {}),
                      ((40, 48), dict(scan_layout="interleaved",
                                      restart_interval_mcu_rows=3))):
        img = np.zeros((*shape, 3), np.uint8)
        with pytest.raises(ValueError) as want:
            jencode.JpegEncoder(JaxConfig(subsampling=sampling,
                                          **kw)).encode(img)
        with pytest.raises(ValueError) as got:
            JpegEncoder(EncodeConfig(subsampling=sampling, **kw),
                        device="cpu").encode(img)
        assert str(got.value) == port_message(str(want.value))


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("layout,mode", [("3scan", "dynamic"),
                                         ("interleaved", "fixed")])
def test_f64_matches_jax_unjitted(sampling, layout, mode):
    """f64 exact mode against jpeg_tpu's un-jitted f64 ``JpegEncoder``
    (its "xla" engine: ``analyze_fn`` / ``_analyze_interleaved_alt_fn``);
    the interleaved layout runs the port's ``FastBatchEncoder`` exact mode
    (B explicit, C, D), the 3-scan layout E and F."""
    img = synthetic_images(81, 1, 32, 48)[0]
    got, want = _both(sampling, lambda e: e.encode(img), dtype="float64",
                      scan_layout=layout, huffman=mode)
    assert got == want
