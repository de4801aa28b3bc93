"""The whole device decode's share of its roofline, in the profiled
stretch: the least time the card could take for the decode's work
(``work.decode_work``, counted from the inputs and outputs alone) over
the summed time of the compute kernels (no memcpy or memset)."""
from benchmark import work

UNIT, LAYER, MOVES = "%", "decode kernels and reconstruction", "decode_mp_s"


def read(record, cell):
    tr = record.get("trace")
    if not tr or not tr.get("work") or tr["kernel_s"] <= 0:
        return None
    least = work.least_seconds(*tr["work"], record["device"])
    return None if least is None else 100.0 * least / tr["kernel_s"]
