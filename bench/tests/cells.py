"""The benchmark's cells cut to a size the CPU runs in a second, for the
tests: the real manifest, configuration and traffic files, with the
model's widths and the traffic's sizes made small."""

import copy

from bench import harness

SMALL_MODEL = {
    "gpt2-124m.train_b64": dict(n_layers=1, d_model=32, n_heads=2,
                                n_kv_heads=2, d_ff=64, vocab=64),
    "yi-6b.doc_qa": dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128),
}
SMALL_TRAFFIC = {
    "gpt2-124m.train_b64": dict(batch=4, seq_len=16, pool_batches=8,
                                reference_rows=2),
    "yi-6b.doc_qa": dict(callers=4, n_slots=4, prefill_len=16, max_len=28,
                         prompt_len=[4, 16], output_len=[4, 12]),
}
CELLS = sorted(SMALL_MODEL)


def small(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.resolve(harness.load_manifest(), name))
    cell.config["model"].update(SMALL_MODEL[name])
    cell.traffic.update(SMALL_TRAFFIC[name])
    return cell
