"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention block every 6 layers."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="zamba2-1.2b-smoke", family="hybrid", n_layers=5, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=384, vocab=512,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, attn_every=2,
    )
    base.update(overrides)
    return ModelConfig(**base)
