"""Llama-3.2-Vision-90B [hf:meta-llama; unverified] — cross-attn image layers every 5th layer; patch-embedding frontend is a STUB (input_specs supplies precomputed patch embeddings)."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
        cross_attn_every=5, n_image_tokens=1600,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="llama-3.2-vision-90b-smoke", family="vlm", n_layers=4, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
        cross_attn_every=2, n_image_tokens=16,
    )
    base.update(overrides)
    return ModelConfig(**base)
