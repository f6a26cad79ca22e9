"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens; EnCodec frontend is a STUB (precomputed frame tokens)."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="musicgen-medium-smoke", family="audio", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=6, d_ff=384, vocab=256,
    )
    base.update(overrides)
    return ModelConfig(**base)
