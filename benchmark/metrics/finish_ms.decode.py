"""Host ms a call in ``decode.payload`` (kernel G and the stitch) and
``decode.reconstruct`` spans, over the profiled stretches'
``decode.call`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "decode kernels and reconstruction", "decode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("decode.payload", "decode.reconstruct"),
                                "decode.call")
