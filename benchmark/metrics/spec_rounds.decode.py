"""Kernel H (``scan_positions``) launches a call in the window, from
``jpeg_tpu_torch.kernels.launch_counts()``: the speculative fixpoint's
rounds (a count; one seed repeats it)."""
UNIT, LAYER, MOVES = "rounds/call", "speculative fixpoint", "decode_mp_s"


def read(record, cell):
    n = record.get("launches", {}).get("scan_positions", 0)
    return n / record["steps"] if n and record.get("steps") else None
