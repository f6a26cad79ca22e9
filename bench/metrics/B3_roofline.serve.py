"""B3_roofline.serve: B3's least time over its device time in the traced
window. Each decode step makes one B3 call a layer over every slot, its
bytes those of the cache rows each slot attends (its length + 1); the
calls are the wrapper's launch count, the time the profiler's."""

from bench import flops
from bench.readers import kernel_s, shape, share


def read(rec):
    if rec.trace is None or rec.decode_attended is None:
        return None
    L = rec.model["n_layers"]
    if rec.launches.get("B3", 0) != L * len(rec.decode_attended):
        return None
    H, KV, hd = shape(rec.model)
    B = rec.traffic["n_slots"]
    bound = L * sum(flops.decode_bound(a, B, H, KV, hd)
                    for a in rec.decode_attended)
    return share(bound, kernel_s(rec, "B3"))
