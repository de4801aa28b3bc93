"""The 95th percentile of the window's ``decode_jpeg_batch`` call times,
each up to its images being on the card (host clock, every call)."""
from benchmark.harness import p95

UNIT, LAYER, MOVES = "ms", "decode entry", "decode_mp_s"


def read(record, cell):
    v = p95(record["spans"].get("decode.call", []))
    return None if v is None else v * 1e3
