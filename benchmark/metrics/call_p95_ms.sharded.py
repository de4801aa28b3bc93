"""The 95th percentile of the window's ``ShardedEncoder.encode_batch``
call times on rank 0 (host clock, every call)."""
from benchmark.harness import p95

UNIT, LAYER, MOVES = "ms", "sharded entry", "sharded_encode_mp_s"


def read(record, cell):
    v = p95(record["spans"].get("sharded.call", []))
    return None if v is None else v * 1e3
