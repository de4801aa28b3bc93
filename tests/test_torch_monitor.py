"""The port's ``ChangeMonitor`` (``jpeg_tpu_torch.pipelines.monitor``) against
``jpeg_tpu.pipelines.monitor`` on the CPU: over a 256x160 frame sequence,
every frame's areas, region bytes and suggested delay must be equal."""
import numpy as np
import pytest
import torch

from jpeg_tpu.core.types import EncodeConfig as JaxConfig
from jpeg_tpu.pipelines import monitor as JM
from jpeg_tpu_torch import ChangeMonitor, EncodeConfig, FrameResult
from jpeg_tpu_torch.golden import decoder as golden
from jpeg_tpu_torch.pipelines import monitor as M

CONFIGS = {"default": {}, "fixed q75": dict(huffman="fixed", quality=75)}


def frames(h=256, w=160, seed=5):
    """A background; a rectangle; the rectangle moved and a second one
    (two regions); the same frame again."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    bg = np.clip(bg + rng.integers(-8, 9, bg.shape), 0, 255).astype(np.uint8)
    f1 = bg.copy()
    f1[20:70, 16:80] = (240, 30, 40)
    f2 = bg.copy()
    f2[36:86, 40:104] = (240, 30, 40)
    f2[180:230, 100:150] = 255 - f2[180:230, 100:150]
    return [bg, f1, f2, f2.copy()]


def run(monitor, seq) -> list[tuple]:
    out = []
    for f in seq:
        res = monitor.process_frame(f)
        out.append(([(a.x, a.y, a.w, a.h) for a, _ in res.regions],
                    [data for _, data in res.regions],
                    res.suggested_delay, res.changed))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    seq = frames()
    return {k: run(JM.ChangeMonitor(256, 160, config=JaxConfig(**kw)), seq)
            for k, kw in CONFIGS.items()}


@pytest.mark.parametrize("label", list(CONFIGS))
def test_monitor_matches_jpeg_tpu(jax_runs, label):
    seq = frames()
    mon = ChangeMonitor(256, 160, config=EncodeConfig(**CONFIGS[label]),
                        device="cpu")
    got = run(mon, seq)
    assert got == jax_runs[label]
    assert [len(r[0]) for r in got] == [0, 1, 2, 0]
    assert [r[2] for r in got] == [M.IDLE_DELAY_S, M.ACTIVE_DELAY_S,
                                   M.ACTIVE_DELAY_S, M.IDLE_DELAY_S]
    for (x, y, w, h), data in zip(got[2][0], got[2][1]):
        rec = golden.decode(data)
        assert rec.shape == (h, w, 3)
        assert golden.psnr(rec, seq[2][y:y + h, x:x + w]) > 20.0


def test_monitor_takes_numpy_and_tensor_frames():
    seq = frames()
    a = run(ChangeMonitor(256, 160, device="cpu"), seq)
    b = run(ChangeMonitor(256, 160, device="cpu"),
            [torch.from_numpy(f) for f in seq])
    assert a == b


def test_constants_and_result_match():
    assert (M.ACTIVE_DELAY_S, M.IDLE_DELAY_S) == (JM.ACTIVE_DELAY_S,
                                                  JM.IDLE_DELAY_S)
    assert FrameResult([]).suggested_delay == \
        JM.FrameResult([]).suggested_delay
    assert not FrameResult([]).changed and FrameResult([(None, b"")]).changed


def test_monitor_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChangeMonitor(64, 64)
