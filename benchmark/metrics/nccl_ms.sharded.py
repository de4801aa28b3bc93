"""Rank 0's device time a call inside c10d's ``nccl:*`` ranges (their
union) in the profiled stretch: the collectives, with their waits for
the slowest rank."""
UNIT, LAYER, MOVES = "ms", "collectives", "sharded_encode_mp_s"


def read(record, cell):
    tr = record.get("trace")
    if not tr or tr["nccl_s"] <= 0:
        return None
    return 1e3 * tr["nccl_s"] / tr["steps"]
