"""ttft_p95_ms: 95th percentile, over every request submitted inside the
window, of the time from its submission to the step() return that first
gave it tokens (host clock)."""

from bench.readers import p95_ms


def read(rec):
    return p95_ms(rec.ttft_s)
