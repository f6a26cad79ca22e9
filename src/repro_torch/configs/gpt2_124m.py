"""GPT-2 124M [Radford et al. 2019] — the paper's own evaluation model (Fig. 8 PyTorch DDP training)."""

from repro_torch.models.common import ModelConfig


def config(**overrides) -> ModelConfig:
    base = dict(
        name="gpt2-124m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50257, act="gelu",
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke_config(**overrides) -> ModelConfig:
    base = dict(
        name="gpt2-124m-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=256, act="gelu",
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
