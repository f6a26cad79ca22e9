"""B1_roofline.serve: B1's least time over its device time in the traced
window. Each admission makes one causal B1 call a layer; its bound is
that of the prompt's own length (bench.flops counts useful tokens, never
the padding to prefill_len that the kernel is given). The calls are the
wrapper's launch count, the time the profiler's for B1's kernels."""

from bench import flops
from bench.readers import kernel_s, shape, share


def read(rec):
    if rec.trace is None or not rec.admitted_lens:
        return None
    L = rec.model["n_layers"]
    if rec.launches.get("B1", 0) != L * len(rec.admitted_lens):
        return None
    H, KV, hd = shape(rec.model)
    bound = L * sum(flops.flash_fwd_bound(1, n, H, KV, hd)
                    for n in rec.admitted_lens)
    return share(bound, kernel_s(rec, "B1"))
