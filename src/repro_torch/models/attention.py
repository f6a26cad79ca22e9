"""Attention sublayer of the port: GQA with RoPE, for training, prefill
and decode.

Training and prefill run differentiable flash attention (the forward
kernel, and the two backward kernels when autograd asks for gradients),
decode the decode-attention kernel; each wrapper picks kernel or plain
version by the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention_train
from .common import ModelConfig, init_dense, rotate


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, heads, hd) -> (B, S, heads, hd)."""
    D, n, hd = w.shape
    return (x @ w.reshape(D, n * hd).to(x.dtype)).view(*x.shape[:2], n, hd)


def _append(cache_kv: torch.Tensor, new: torch.Tensor,
            at: torch.Tensor) -> None:
    """Write new (B, 1, KV, hd) rows into a (B, S, KV, hd) cache in place,
    row b at ``at[b]`` (or all rows at the scalar ``at``), int64."""
    new = new.to(cache_kv.dtype)
    if at.dim() == 1:
        rows = torch.arange(new.shape[0], device=new.device)
        cache_kv[rows, at] = new[:, 0]
    else:
        cache_kv.index_copy_(1, at.view(1), new)


def decode_rows(ln: torch.Tensor, B: int, S: int):
    """(at, attend) of a decode step at cache lengths ``ln`` (a scalar or
    (B,)), computed once for all layers: the new K/V row of sequence b is
    written at ``at`` = min(len_b, S - 1), int64 (a scalar when ``ln``
    is), and the sequence attends over ``attend[b]`` = len_b + 1 rows,
    (B,) int32, which the kernel clamps to S. Its RoPE position is the unclamped
    len_b. This is what the reference's clamped ``dynamic_update_slice``
    and its mask do when a length passes the end of the cache, and it
    never indexes out of bounds."""
    at = ln.clamp(max=S - 1).long()
    attend = (ln + 1).to(torch.int32).expand(B).contiguous()
    return at, attend


def attention_sublayer(x: torch.Tensor, p: dict, cfg: ModelConfig,
                       rope: Tuple[torch.Tensor, torch.Tensor],
                       cache: Optional[dict] = None) -> Tuple:
    """Self-attention sublayer (no residual or norm; the caller adds them).

    ``rope`` is the (cos, sin) pair of
    :func:`~repro_torch.models.common.rope_cos_sin` at the tokens'
    positions, computed once per forward pass for all layers.

    Training and prefill: x (B, S, D) -> (out, (k, v)), causal over the S
    positions; differentiable, with the backward kernels under autograd.
    Decode: x (B, 1, D) with ``cache`` {"k", "v": (B, S_max, KV, hd),
    "at", "attend": from :func:`decode_rows`} -> (out, (k_cache,
    v_cache)); the K/V rows are written in place.
    """
    q = rotate(_heads(x, p["wq"]), *rope)
    k = rotate(_heads(x, p["wk"]), *rope)
    v = _heads(x, p["wv"])
    if cache is None:
        out = flash_attention_train(q, k, v, causal=True)
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        _append(k_cache, k, cache["at"])
        _append(v_cache, v, cache["at"])
        out = decode_attention(q[:, 0], k_cache, v_cache,
                               cache["attend"])[:, None]
        new_kv = (k_cache, v_cache)
    B, S, H, hd = out.shape
    wo = p["wo"]
    o = out.reshape(B, S, H * hd) @ wo.reshape(H * hd, wo.shape[-1]).to(x.dtype)
    return o, new_kv


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Optional[int]) -> dict:
    """Attention weights of ``layers`` blocks, stacked on a leading axis
    (one unstacked block when ``layers`` is None).

    Fan-ins follow the reference: D for wq/wk/wv, H for wo."""
    D, H, KVh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = () if layers is None else (layers,)
    k = len(lead)
    return {
        "wq": init_dense(gen, (*lead, D, H, hd), in_axis=k, dtype=dtype),
        "wk": init_dense(gen, (*lead, D, KVh, hd), in_axis=k, dtype=dtype),
        "wv": init_dense(gen, (*lead, D, KVh, hd), in_axis=k, dtype=dtype),
        "wo": init_dense(gen, (*lead, H, hd, D), in_axis=k, dtype=dtype),
    }
