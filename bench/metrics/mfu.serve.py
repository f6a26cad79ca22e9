"""mfu.serve: model operations of the useful work served in the window
(each prompt admitted, not its padding, and each token decoded:
bench.flops.prefill_ops and decode_ops) over the window's seconds times
the H100's bf16 peak."""

from bench import flops


def read(rec):
    if rec.useful_ops is None or rec.window_s <= 0:
        return None
    return 100.0 * rec.useful_ops / (rec.window_s * flops.PEAK_BF16_OPS)
