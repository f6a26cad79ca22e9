"""B1_roofline.train: B1's least time over its device time in the traced
window: every B1 call of the steps (the forward's and the recompute's
under remat), causal at (batch, seq_len); the calls are the wrapper's
launch count, the time the profiler's."""

from bench import flops
from bench.readers import kernel_s, shape, share


def read(rec):
    if rec.trace is None or rec.steps is None:
        return None
    calls = rec.launches.get("B1", 0)
    H, KV, hd = shape(rec.model)
    t = rec.traffic
    return share(calls * flops.flash_fwd_bound(t["batch"], t["seq_len"], H,
                                               KV, hd), kernel_s(rec, "B1"))
