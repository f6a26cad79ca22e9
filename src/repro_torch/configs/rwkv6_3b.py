"""RWKV6-3B 'Finch' [arXiv:2404.05892] — attention-free, data-dependent decay."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="rwkv6-3b", family="rwkv6", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536, rwkv_head_dim=64,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="rwkv6-3b-smoke", family="rwkv6", n_layers=2, d_model=128,
        n_heads=2, n_kv_heads=2, d_ff=384, vocab=512, rwkv_head_dim=64,
    )
    base.update(overrides)
    return ModelConfig(**base)
