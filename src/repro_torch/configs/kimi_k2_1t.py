"""Kimi-K2 1T-A32B [arXiv:2501; paper-table, unverified] — trillion-parameter MoE, 384 experts top-8."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, capacity_factor=1.25,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="kimi-k2-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=64, vocab=512,
        n_experts=8, top_k=2, capacity_factor=1.5,
    )
    base.update(overrides)
    return ModelConfig(**base)
