"""DeepSeek-67B [arXiv:2401.02954] — llama-architecture, 95 layers."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab=102400,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="deepseek-67b-smoke", family="dense", n_layers=3, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
    )
    base.update(overrides)
    return ModelConfig(**base)
