"""Host ms a batch in the stream's ``encode.submit`` spans (the upload,
when frames are on the host, and the enqueue of the batch's kernels and
its totals' copy: with frames on the card, the launch wrappers' host
time), over the profiled stretches' ``encode.finish`` count."""
from benchmark import program_spans

UNIT, LAYER, MOVES = "ms", "stream entry", "encode_mp_s"


def read(record, cell):
    return program_spans.ms_per(("encode.submit",), "encode.finish")
