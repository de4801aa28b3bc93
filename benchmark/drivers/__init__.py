"""One driver per kind of traffic: ``stream_encode``
(``FastBatchEncoder.encode_stream``), ``batch_decode``
(``decode_jpeg_batch``) and ``sharded_encode``
(``ShardedEncoder.encode_batch`` over ranks).  Each has ``run(cell, seed,
seconds, trace, start, device)`` returning a ``harness.Outcome``."""
