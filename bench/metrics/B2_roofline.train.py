"""B2_roofline.train: the attention backward's least time
(bench.flops.flash_bwd_bound) over the device time of everything its
wrapper launches in the traced window: B2a's and B2b's kernels by name,
and the other kernels launched inside the wrapper (the delta, a copy of
do); the calls are B2a's launch count."""

from bench import flops
from bench.readers import kernel_pattern, kernel_s, shape, share


def read(rec):
    if rec.trace is None or rec.steps is None:
        return None
    calls = rec.launches.get("B2a", 0)
    if calls != rec.launches.get("B2b", 0):
        return None
    device_s = kernel_s(rec, "B2") + rec.trace.in_range(
        "bench.B2", but=kernel_pattern("B2"))
    H, KV, hd = shape(rec.model)
    t = rec.traffic
    return share(calls * flops.flash_bwd_bound(t["batch"], t["seq_len"], H,
                                               KV, hd), device_s)
