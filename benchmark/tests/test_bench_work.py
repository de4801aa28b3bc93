"""The roofline's work counts and the trace arithmetic, by hand."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import devtrace, work
from benchmark.reference import jpeg as R


def _file(payloads: list[bytes]) -> bytes:
    """A header, an SOS and these restart segments, then EOI."""
    sos = bytes.fromhex("ffda000c03010002110311003f00")
    body = b"".join((bytes([0xFF, 0xD0 + i - 1]) if i else b"") + p
                    for i, p in enumerate(payloads))
    return b"\xff\xd8" + sos + body + b"\xff\xd9"


def test_entropy_bytes_drop_stuffing_and_markers():
    # 5 bytes, one of them a stuffed 0xFF 0x00; then 3 bytes after RST0
    data = _file([b"\x12\xff\x00\x34\x56", b"\x01\x02\x03"])
    assert work.entropy_bytes(data) == [4, 3]


def test_encode_work_of_a_tiny_batch_by_hand():
    # two 16x16 4:2:0 frames: 4 Y blocks + 2 chroma blocks each
    files = [_file([b"\x00" * 9]), _file([b"\x00" * 4, b"\x00" * 5])]
    nbytes, flops = work.encode_work((16, 16), files, dynamic=True)
    rgb = 2 * 16 * 16 * 3
    words = (12 + 4) + (4 + 4) + (8 + 4)  # each segment's words + total
    assert nbytes == rgb + words + 2 * 4096
    assert flops == 2 * 6 * 2048
    assert work.encode_work((16, 16), files, dynamic=False)[0] == \
        rgb + words


def test_decode_work_of_a_tiny_batch_by_hand():
    files = [_file([b"\x00" * 7]), _file([b"\x00" * 3])]
    nbytes, flops = work.decode_work(files, [(16, 32), (16, 16)])
    assert nbytes == 10 + 16 * 32 * 3 + 16 * 16 * 3
    assert flops == (12 + 6) * 2048


def test_work_of_a_real_file():
    rgb = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    data, _ = R.encode(rgb, "fixed")
    nbytes, flops = work.encode_work((32, 48), [data], dynamic=False)
    payload = work.entropy_bytes(data)[0]
    assert nbytes == 32 * 48 * 3 + -(-payload // 4) * 4 + 4
    assert flops == (24 + 12) * 2048


def test_least_seconds_takes_the_larger_bound():
    dev = "NVIDIA H100 80GB HBM3"
    assert work.least_seconds(3.35e12, 0, dev) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12, dev) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 2 * 67e12, dev) == pytest.approx(2.0)
    assert work.least_seconds(1, 1, "another card") is None


def test_union_counts_overlap_once():
    length, merged = devtrace.union_us([(0, 10), (5, 12), (20, 30),
                                        (25, 26)])
    assert length == 22
    assert merged == [(0, 12), (20, 30)]


def test_summarize_a_trace():
    ev = [  # a kernel, two overlapping copies, a nested NCCL range
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.stretch",
         "ts": 1000, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::"
         "place_kernel(unsigned int const*)", "ts": 1010, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1020,
         "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1040,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather",
         "ts": 1070, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nccl:all_gather",
         "ts": 1065, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1000,
         "dur": 5},
    ]
    samples = [(0.000095, "pipelines.fast._assemble")]
    s = devtrace.summarize(ev, 100e-6, 2, 0.0, samples)
    assert s["busy_s"] == pytest.approx(60e-6)   # 1010-1060, 1070-1080
    assert s["kernel_s"] == pytest.approx(20e-6)  # no copies, no NCCL
    assert s["nccl_s"] == pytest.approx(20e-6)
    assert s["ops"]["place_kernel"] == pytest.approx(20e-6)
    # gaps: 1080-1100 (20), 1000-1010 (10), 1060-1070 (10)
    assert s["gaps"][0] == ("pipelines.fast._assemble", pytest.approx(20e-6))
    assert [g for _, g in s["gaps"]] == pytest.approx([20e-6, 10e-6, 10e-6])
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.4)


def test_good_profiles_drop_those_that_lost_records():
    p = [{"busy_s": 1.0, "ops": {"a": 1, "b": 1}},
         {"busy_s": 1.0, "ops": {"a": 1, "b": 1}},
         {"busy_s": 0.5, "ops": {"a": 1}},
         {"busy_s": 0.0, "ops": {}}]
    assert devtrace.good_profiles(p) == [0, 1]
