"""StarCoder2-3B [arXiv:2402.19173] — dense GQA, RoPE."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152, act="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="starcoder2-3b-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=384, vocab=512, act="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)
