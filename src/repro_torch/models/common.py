"""Shared model configuration and primitive layers (PyTorch).

``ModelConfig`` is the port's own copy of ``repro.models.common.ModelConfig``
with torch dtypes. There is no ``use_kernels`` field: a kernel wrapper sends
a CUDA tensor to its kernel and a CPU tensor to its plain version, so the
device alone decides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | rwkv6 | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"            # silu (swiglu) | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0
    router_jitter: float = 0.0
    # --- SSM / hybrid ---
    ssm_state: int = 0           # mamba2 state size N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0          # hybrid: shared attention block period
    rwkv_head_dim: int = 64
    # --- VLM ---
    cross_attn_every: int = 0    # vlm: cross-attn layer period
    n_image_tokens: int = 0
    # --- numerics / policy ---
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: str = "full"          # none | full | dots
    scan_layers: bool = True
    seq_shard_attn: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Total parameters (for 6ND MODEL_FLOPS accounting)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "audio", "moe"):
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.family == "moe":
                ff = self.n_experts * (3 * d * f) + d * self.n_experts
                if self.shared_expert_ff:
                    ff += 3 * d * self.shared_expert_ff
            else:
                ff = 3 * d * f
            per_layer = attn + ff + 2 * d
            extra = 0
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = L // self.cross_attn_every
                extra = n_cross * (attn + 2 * d)
            return emb + L * per_layer + extra + d
        if self.family == "rwkv6":
            per_layer = 7 * d * d + 2 * d * f + 12 * d
            return emb + L * per_layer + d
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            h_m = d_in // self.ssm_head_dim
            per_m = d * (2 * d_in + 2 * self.ssm_state + h_m) \
                + d_in * d + 5 * d_in + 2 * h_m + d
            shared = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d + 3 * d * f + 2 * d
            return emb + L * per_m + shared + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        ff_active = self.top_k * (3 * d * f) + d * self.n_experts
        if self.shared_expert_ff:
            ff_active += 3 * d * self.shared_expert_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + ff_active + 2 * d) + d


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed and scaled in float32, cast back to x's dtype."""
    return F.rms_norm(x.float(), x.shape[-1:], scale.float(), eps).to(x.dtype)


def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh approximation; so does this."""
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float):
    """float32 (cos, sin) of the rotary angles, each (..., seq, 1, hd/2),
    for positions (..., seq). A forward pass computes them once and every
    layer's :func:`rotate` reuses them."""
    freqs = rope_freqs(hd, theta, device=positions.device)     # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (...,S,hd/2)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding (not interleaved) of x (..., seq, heads,
    hd), computed in float32 and cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, hd); positions: (..., seq). Angles in float32."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def leading_axes(layers) -> tuple:
    """The leading axes of stacked block weights: none for one unstacked
    block (``layers`` None), ``(layers,)`` for an int, else the tuple
    given (the vlm family's self blocks stack over groups and blocks)."""
    if layers is None:
        return ()
    return (layers,) if isinstance(layers, int) else tuple(layers)


def init_dense(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen``, on ``gen``'s device.

    ``fan_in`` is ``shape[in_axis]``: a stack of layers passes the axis
    of one layer's input dimension."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return w.to(dtype)
