"""decode_step_ms.serve: median of the benchmark's synchronised spans
around each TPServeEngine.decode_batch in the window."""

from bench.readers import median_ms


def read(rec):
    return median_ms(rec.decode_s)
