"""The port's ``utils.resilience`` against ``jpeg_tpu.utils.resilience``:
``jpeg_tpu``'s own cases (``tests/test_resilience.py``) with the same stub
encoders, on the CPU.  Bytes, event kinds and messages must be equal."""
import time

import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.golden.encoder import encode as jax_golden
from jpeg_tpu.utils import resilience as JR
from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder
from jpeg_tpu_torch.golden.encoder import encode as golden_encode
from jpeg_tpu_torch.utils import resilience as R
from jpeg_tpu_torch.utils.resilience import (FailureEvent, ResilientEncoder,
                                             probe_device)


def _img(h=32, w=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3)).astype(np.uint8)


class _Flaky:
    """Fails n times, then delegates to the golden encoder."""

    def __init__(self, fail_times):
        self.left = fail_times
        self.calls = 0

    def encode_batch(self, batch):
        self.calls += 1
        if self.left > 0:
            self.left -= 1
            raise RuntimeError("synthetic device failure")
        return [bytes(golden_encode(img)) for img in np.asarray(batch)]


def both(fail_times, batch, cfg=None, on_event=None, **kw):
    """The port's (with ``on_event``) and jpeg_tpu's wrappers around the
    same stub: (port output, port wrapper, jpeg_tpu output, jpeg_tpu
    wrapper)."""
    port = ResilientEncoder(_Flaky(fail_times), config=cfg and EncodeConfig(
        **cfg), probe_timeout_s=60.0, on_event=on_event, device="cpu", **kw)
    ref = JR.ResilientEncoder(_Flaky(fail_times), config=cfg and JaxConfig(
        **cfg), probe_timeout_s=60.0, **kw)
    return port.encode_batch(batch), port, ref.encode_batch(batch), ref


def kinds(enc):
    return [(e.kind, e.attempt, e.error) for e in enc.events]


def test_probe_device_healthy():
    assert probe_device(timeout_s=60.0, device="cpu")


def test_probe_without_a_card_returns_false(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_device(timeout_s=60.0) is False


@pytest.mark.parametrize("fault", ["hang", "error"])
def test_probe_deadline_and_errors(monkeypatch, fault):
    def touch(*args, **kw):
        if fault == "hang":
            time.sleep(3.0)
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(R.torch, "arange", touch)
    t0 = time.perf_counter()
    assert probe_device(timeout_s=0.2, device="cpu") is False
    assert time.perf_counter() - t0 < 2.0


def test_retry_then_success():
    batch = np.stack([_img(seed=1), _img(seed=2)])
    got, port, want, ref = both(1, batch, retries=2)
    assert got == want and [o[:2] for o in got] == [b"\xff\xd8"] * 2
    assert port.encoder.calls == ref.encoder.calls == 2
    assert kinds(port) == kinds(ref) and [e.kind for e in port.events] \
        == ["device_error"]


def test_fallback_matches_golden():
    events = []
    cfg = dict(scan_layout="interleaved", restart_interval_mcu_rows=1,
               huffman="fixed")
    batch = np.stack([_img(seed=3), _img(seed=4)])
    got, port, want, ref = both(99, batch, cfg, retries=1,
                                on_event=events.append)
    assert got == want == [bytes(jax_golden(
        img, quality=None, scan_layout="interleaved",
        restart_interval_mcu_rows=1, huffman="fixed")) for img in batch]
    assert kinds(port) == kinds(ref)
    assert [e.kind for e in port.events] == ["device_error"] * 2 + [
        "fallback"]
    assert events == port.events
    assert all(isinstance(e, FailureEvent) for e in events)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_fallback_accepts_flat_layout(as_tensor):
    img = _img(seed=5)
    flat = img.reshape(1, 32, 96)
    got, _, want, _ = both(99, torch.from_numpy(flat) if as_tensor else flat,
                           retries=0)
    assert got == want == [bytes(jax_golden(img))]


def test_fallback_rejects_non_420():
    cfg = dict(scan_layout="interleaved", subsampling="444")
    batch = np.stack([_img(seed=6)])
    with pytest.raises(RuntimeError, match="4:2:0 only") as got:
        ResilientEncoder(_Flaky(99), EncodeConfig(**cfg), retries=0,
                         device="cpu").encode_batch(batch)
    with pytest.raises(RuntimeError) as want:
        JR.ResilientEncoder(_Flaky(99), JaxConfig(**cfg),
                            retries=0).encode_batch(batch)
    assert str(got.value) == str(want.value)


def test_passthrough_with_real_encoder():
    """No failure -> the wrapped encoder's exact bytes, no events."""
    cfg = EncodeConfig(scan_layout="interleaved", huffman="fixed")
    inner = FastBatchEncoder(32, 32, cfg, device="cpu")
    enc = ResilientEncoder(inner, config=cfg, retries=1,
                           probe_timeout_s=60.0, device="cpu")
    batch = np.stack([_img(seed=7), _img(seed=8)])
    assert enc.encode_batch(batch) == inner.encode_batch(batch)
    assert enc.events == []


def test_fallback_maps_dynamic_sampled_to_exact():
    cfg = dict(scan_layout="interleaved", huffman="dynamic-sampled")
    img = _img(seed=7)
    got, port, want, ref = both(99, np.stack([img]), cfg, retries=0)
    assert got == want == [bytes(jax_golden(
        img, quality=None, scan_layout="interleaved",
        restart_interval_mcu_rows=0, huffman="dynamic"))]
    assert kinds(port) == kinds(ref)


def test_retries_fall_back_when_the_card_is_gone(monkeypatch):
    """Without a card the probe before a retry fails: the batch goes to
    the host at once, and the events say so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = ResilientEncoder(_Flaky(99), retries=3)
    img = _img(seed=9)
    assert enc.encode_batch(np.stack([img])) == [bytes(jax_golden(img))]
    assert kinds(enc) == [("device_error", 0, "synthetic device failure"),
                          ("fallback", 1, "device probe timeout")]
