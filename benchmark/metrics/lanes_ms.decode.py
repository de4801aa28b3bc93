"""Host ms a call in ``decode.lanes`` spans (un-stuffing, chunking, lane
tables, ``pack_streams`` and the host-to-card copies), over the profiled
stretches' ``decode.call`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "decode host prep", "decode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("decode.lanes",), "decode.call")
