"""Host ms a batch in the stream's ``encode.wait`` spans (each host wait
on a copy's event: histograms, totals, the used word prefix), over the
profiled stretches' ``encode.finish`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "stream entry", "encode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("encode.wait",), "encode.finish")
