"""itl_p95_ms: 95th percentile over every gap inside the window between
two consecutive deliveries (step() returns that gave it tokens) of one
request (host clock)."""

from bench.readers import p95_ms


def read(rec):
    return p95_ms(rec.itl_s)
