"""StarCoder2-15B [arXiv:2402.19173] — dense GQA, RoPE, GELU."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152, act="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="starcoder2-15b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, act="gelu",
    )
    base.update(overrides)
    return ModelConfig(**base)
