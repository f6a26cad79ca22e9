"""Yi-6B [arXiv:2403.04652] — llama-architecture GQA."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="yi-6b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
    )
    base.update(overrides)
    return ModelConfig(**base)
