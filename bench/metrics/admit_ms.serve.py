"""admit_ms.serve: median of the benchmark's synchronised spans around
each TPServeEngine.admit in the window (the right-padded prefill and the
slot splice)."""

from bench.readers import median_ms


def read(rec):
    return median_ms(rec.admit_s)
