"""The 95th percentile of the window's batch times of the stream: from
the benchmark's iterator handing a batch to ``encode_stream`` until its
files are yielded (host clock, every batch of the window)."""
from benchmark.harness import p95

UNIT, LAYER, MOVES = "ms", "stream entry", "encode_mp_s"


def read(record, cell):
    v = p95(record["spans"].get("encode.batch", []))
    return None if v is None else v * 1e3
