"""The readers of the program's spans (``metrics/*_ms.*.py`` over
``program_spans``): hand-built snapshots give the hand-computed ms a
batch or call, and an empty one, or a program without spans, gives
None."""
from __future__ import annotations

import os

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns


def _rec(name, parent, t0_ms, t1_ms, key=0):
    return (name, key, parent, 1, t0_ms * MS, t1_ms * MS)


# two stretches' worth of an encode stream: 3 batches in all; a span
# still open (t1 None) counts for nothing
ENCODE = [
    _rec("encode.submit", None, 0, 0.5),                      # 0
    _rec("encode.finish", None, 1, 5),                        # 1
    _rec("encode.wait", 1, 1, 1.25),                          # 2
    _rec("encode.wait", 1, 1.5, 1.75),                        # 3
    _rec("assemble", 1, 2, 5),                                # 4
    _rec("encode.submit", None, 5, 5.25, key=1),              # 5
    _rec("encode.finish", None, 6, 9, key=1),                 # 6
    _rec("assemble", 6, 6, 8.5, key=1),                       # 7
    _rec("encode.finish", None, 10, 13, key=2),               # 8
    _rec("encode.wait", 8, 10, 10.5, key=2),                  # 9
    _rec("assemble", 8, 10.5, 12, key=2),                     # 10
    ("encode.submit", 3, None, 1, 14 * MS, None),             # 11
]
# two decode calls
DECODE = [
    _rec("decode.call", None, 0, 20),                         # 0
    _rec("decode.parse", 0, 0, 2),                            # 1
    _rec("decode.parse", 0, 2, 5),                            # 2
    _rec("decode.lanes", 0, 5, 11),                           # 3
    _rec("decode.fixpoint", 0, 11, 14),                       # 4
    _rec("decode.round", 4, 11, 12),                          # 5
    _rec("decode.round", 4, 12, 14),                          # 6
    _rec("decode.payload", 0, 14, 16),                        # 7
    _rec("decode.reconstruct", 0, 16, 19),                    # 8
    _rec("decode.call", None, 20, 30, key=1),                 # 9
    _rec("decode.parse", 9, 20, 21, key=1),                   # 10
    _rec("decode.lanes", 9, 21, 25, key=1),                   # 11
    _rec("decode.fixpoint", 9, 25, 26, key=1),                # 12
    _rec("decode.payload", 9, 26, 27, key=1),                 # 13
    _rec("decode.reconstruct", 9, 27, 29.5, key=1),           # 14
]
WANT = {
    "submit_ms.encode": (ENCODE, (0.5 + 0.25) / 3),
    "wait_ms.encode": (ENCODE, (0.25 + 0.25 + 0.5) / 3),
    "assemble_ms.encode": (ENCODE, (3 + 2.5 + 1.5) / 3),
    "parse_ms.decode": (DECODE, (2 + 3 + 1) / 2),
    "lanes_ms.decode": (DECODE, (6 + 4) / 2),
    "fixpoint_ms.decode": (DECODE, (3 + 1) / 2),
    "finish_ms.decode": (DECODE, (2 + 3 + 1 + 2.5) / 2),
}


def _reader(name):
    return harness.load_metric(BENCH, name).read


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_gives_the_hand_computed_ms(monkeypatch, name):
    from jpeg_tpu_torch.utils import profiling
    records, want = WANT[name]
    monkeypatch.setattr(profiling, "snapshot", lambda: (records, 0))
    assert _reader(name)({}, None) == pytest.approx(want, rel=1e-12)
    other = DECODE if records is ENCODE else ENCODE
    monkeypatch.setattr(profiling, "snapshot", lambda: (other, 0))
    assert _reader(name)({}, None) is None  # the other entry's spans


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_gives_none_without_spans(monkeypatch, name):
    from jpeg_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "snapshot", lambda: ([], 0))
    assert _reader(name)({}, None) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without spans
    assert _reader(name)({}, None) is None


def test_each_span_reader_has_its_entry():
    spec = harness.load_spec(os.path.dirname(BENCH))
    ours = {m["name"]: m for m in spec["per_layer"]
            if m["source"] == "program_span"}
    assert set(ours) == set(WANT)
    for m in ours.values():
        assert m["unit"] == "ms" and len(m["workloads"]) == 1
