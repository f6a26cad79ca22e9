"""Layer blocks of the port: the gated MLP of the dense family."""

from __future__ import annotations

import torch

from .common import ModelConfig, act_fn, init_dense


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """act(x W_gate) * (x W_up) W_down, weights cast to x's dtype."""
    h = act_fn(cfg.act)(x @ p["w_gate"].to(x.dtype))
    h = h * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             layers: int) -> dict:
    """MLP weights of ``layers`` blocks, stacked on a leading layer axis."""
    return {"w_gate": init_dense(gen, (layers, d, f), in_axis=1, dtype=dtype),
            "w_up": init_dense(gen, (layers, d, f), in_axis=1, dtype=dtype),
            "w_down": init_dense(gen, (layers, f, d), in_axis=1, dtype=dtype)}
