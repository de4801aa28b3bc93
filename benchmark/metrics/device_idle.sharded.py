"""The card's idle share of the profiled stretch: one minus the union of
the device ops' intervals (kernels and copies, every stream) over the
stretch's wall time, the mean over the cards."""
UNIT, LAYER, MOVES = "%", "device", "sharded_encode_mp_s"


def read(record, cell):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
