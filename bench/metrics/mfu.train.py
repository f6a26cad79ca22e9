"""mfu.train: model operations of the window's steps (forward and
backward, recompute not counted: bench.flops.train_ops) over the window's
seconds times the H100's bf16 peak."""

from bench import flops


def read(rec):
    if rec.steps is None or rec.window_s <= 0:
        return None
    t = rec.traffic
    ops = rec.steps * flops.train_ops(rec.model, t["batch"], t["seq_len"])
    return 100.0 * ops / (rec.window_s * flops.PEAK_BF16_OPS)
