"""Host ms a batch in ``assemble`` spans (``native.assemble_interleaved``:
the files written from the fetched words), over the profiled stretches'
``encode.finish`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "host assembly", "encode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("assemble",), "encode.finish")
