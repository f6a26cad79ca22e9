"""Llama-4-Maverick 400B-A17B [hf:meta-llama; unverified] — MoE 128 experts top-1, early fusion."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        n_experts=128, top_k=1, capacity_factor=1.25,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="llama4-maverick-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
        n_experts=4, top_k=1, capacity_factor=1.5,
    )
    base.update(overrides)
    return ModelConfig(**base)
