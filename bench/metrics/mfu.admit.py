"""mfu.admit: model operations of the prompts admitted in the traced
window (bench.flops.prefill_ops of each prompt's own length, not its
padding) over the benchmark's synchronised spans around every admit,
times the H100's bf16 peak: the admission step's share of the chip."""

from bench import flops


def read(rec):
    if not rec.admit_s or rec.admitted_lens is None \
            or len(rec.admit_s) != len(rec.admitted_lens):
        return None
    ops = sum(flops.prefill_ops(rec.model, n) for n in rec.admitted_lens)
    return 100.0 * ops / (sum(rec.admit_s) * flops.PEAK_BF16_OPS)
