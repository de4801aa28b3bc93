"""jpeg_tpu_torch's spans (``utils/profiling.py``): nothing recorded and
``record_function`` never entered while no profiler records; under a
profiler, the tree of the encode stream's and the batch decode's host
stages, each range in the profiler's trace; the same files and images
either way; the cap."""
import functools
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jpeg_tpu_torch import EncodeConfig, FastBatchEncoder, decode_jpeg_batch
from jpeg_tpu_torch.utils import profiling

H, W = 32, 48
N_BATCHES = 3


def _frames(n: int, seed: int) -> np.ndarray:
    """Smooth gradients with a little noise: a few hundred bytes a file."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([x * 5, y * 7, (x + y) * 3], -1)
    return np.stack([(base + rng.integers(0, 24, base.shape)) % 256
                     for _ in range(n)]).astype(np.uint8)


def _encode(huffman: str):
    enc = FastBatchEncoder(H, W, EncodeConfig(scan_layout="interleaved",
                                              huffman=huffman), device="cpu")
    batches = [_frames(2, seed) for seed in range(N_BATCHES)]
    return [[bytes(f) for f in files]
            for files in enc.encode_stream(iter(batches), sync_depth=2)]


@functools.cache
def _files() -> tuple:
    """Two DRI-less 4:2:0 files: each takes the speculative decode."""
    return tuple(_encode("fixed")[0])


def _decode(_):
    return [img.numpy().tobytes()
            for img in decode_jpeg_batch(list(_files()),
                                         entropy_engine="device",
                                         device="cpu")]


CASES = {"encode-fixed": (_encode, "fixed"),
         "encode-dynamic": (_encode, "dynamic"),
         "decode": (_decode, None)}


def _raise(*a, **k):
    raise AssertionError("record_function entered with no profiler on")


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """One case run with tracing off (``record_function`` patched to
    raise) and once under a CPU profiler: (case, output off, output on,
    records off, records and dropped on, the trace's events)."""
    fn, arg = CASES[request.param]
    _files()  # made before either run
    profiling.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "record_function", _raise)
        off = fn(arg)
    rec_off = profiling.snapshot()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = fn(arg)
    rec_on = profiling.snapshot()
    profiling.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return request.param, off, on, rec_off, rec_on, events


def test_off_records_nothing(runs):
    _, _, _, (records, dropped), _, _ = runs
    assert records == [] and dropped == 0


def test_outputs_equal_with_tracing_on_and_off(runs):
    _, off, on, *_ = runs
    assert off == on


def _children(records, i):
    return [j for j, r in enumerate(records) if r[2] == i]


def _inside(records):
    for name, key, parent, thread, t0, t1 in records:
        assert t1 is not None and t0 <= t1
        if parent is not None:
            p = records[parent]
            assert p[3] == thread and p[4] <= t0 and t1 <= p[5], name
            assert key == p[1]


def test_on_records_the_tree(runs):
    case, _, _, _, (records, dropped), _ = runs
    assert dropped == 0 and records
    _inside(records)
    names = [r[0] for r in records]
    top = [r for r in records if r[2] is None]
    if case.startswith("encode"):
        stages = ["encode.submit", "encode.finish"]
        if case == "encode-dynamic":
            stages.insert(1, "encode.tables")
        for key in range(N_BATCHES):
            mine = [r[0] for r in top if r[1] == key]
            assert sorted(mine) == sorted(stages)
        assert len(top) == len(stages) * N_BATCHES
        assert names.count("assemble") == N_BATCHES
        for i, r in enumerate(records):
            if r[0] == "encode.finish":
                kids = [records[j][0] for j in _children(records, i)]
                assert "assemble" in kids and "encode.wait" in kids
            elif r[0] in ("assemble", "encode.wait"):
                assert records[r[2]][0] in stages, r
        waits = {r[1] for r in records if r[0] == "encode.wait"}
        assert waits == set(range(N_BATCHES))
        return
    assert [r[0] for r in top] == ["decode.call"]
    call = names.index("decode.call")
    kids = [records[j][0] for j in _children(records, call)]
    # each DRI-less file is parsed twice: for the restart route, then for
    # the speculative decode
    assert kids == ["decode.parse"] * 4 + ["decode.lanes", "decode.fixpoint",
                                          "decode.payload",
                                          "decode.reconstruct"]
    fix = names.index("decode.fixpoint")
    rounds = [records[j][0] for j in _children(records, fix)]
    assert rounds and set(rounds) == {"decode.round"}
    assert len(names) == 1 + len(kids) + len(rounds)


def test_the_trace_holds_every_span_in_order(runs):
    _, _, _, _, (records, _), events = runs
    ranges = sorted((float(e["ts"]), -float(e.get("dur", 0)), e["name"])
                    for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.PREFIX))
    assert [n for *_, n in ranges] == [profiling.PREFIX + r[0]
                                       for r in records]
    assert not any(n.startswith("nccl:") or n == "benchmark.stretch"
                   for *_, n in ranges)


def _on():
    return profile(activities=[ProfilerActivity.CPU])


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    profiling.reset()
    with _on():
        for k in range(5):
            with profiling.span("outer", k):
                with profiling.span("inner"):
                    pass
    records, dropped = profiling.snapshot()
    profiling.reset()
    assert [(r[0], r[1], r[2]) for r in records] == [
        ("outer", 0, None), ("inner", 0, 0), ("outer", 1, None)]
    assert dropped == 7
    assert profiling.snapshot() == ([], 0)


def test_threads_keep_their_own_parents_and_keys():
    profiling.reset()
    with _on():
        with profiling.span("main", 1):
            done = []

            def work():
                with profiling.span("other"):
                    with profiling.span("leaf"):
                        done.append(1)
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive() and done
    records, _ = profiling.snapshot()
    profiling.reset()
    by = {r[0]: r for r in records}
    assert by["other"][2] is None and by["other"][1] is None
    assert records[by["leaf"][2]][0] == "other"
    assert by["other"][3] != by["main"][3]


def test_off_span_is_one_shared_object(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _raise)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("encode.wait"), profiling.span("decode.call", 7)
    assert a is b
    with a:
        pass
    assert profiling.snapshot() == ([], 0)
