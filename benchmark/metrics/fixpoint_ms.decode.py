"""Host ms a call in ``decode.fixpoint`` spans (every round's kernel H
launch, the wait for its arrays and the host's update), over the
profiled stretches' ``decode.call`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "speculative fixpoint", "decode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("decode.fixpoint",), "decode.call")
