"""Host ms a call in ``decode.parse`` spans (each stream's parse, once for
the restart route's eligibility and once for the speculative decode),
over the profiled stretches' ``decode.call`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "decode host prep", "decode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("decode.parse",), "decode.call")
