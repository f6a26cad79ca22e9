"""Attention sublayer of the port: GQA with RoPE, for training, prefill
and decode, and the vlm family's cross-attention over image K/V.

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
from .common import ModelConfig, init_dense, leading_axes, rotate


def heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                       cache: Optional[dict] = None,
                       kv_override: Optional[Tuple] = None) -> Tuple:
    """Self-attention sublayer (no residual or norm; the caller adds them).

    ``rope`` is the (cos, sin) pair of
    :func:`~repro_torch.models.common.rope_cos_sin` at the tokens'
    positions, computed once per forward pass for all layers.

    Training and prefill: x (B, S, D) -> (out, (k, v)), causal over the S
    positions; differentiable, with the backward kernels under autograd.
    Decode: x (B, 1, D) with ``cache`` {"k", "v": (B, S_max, KV, hd),
    "at", "attend": from :func:`decode_rows`} -> (out, (k_cache,
    v_cache)); the K/V rows are written in place.

    Cross-attention (the vlm family): ``kv_override`` = (k, v), each (B, n,
    KV, hd), the image tokens' K/V. Neither q nor k is rotated (``rope``
    is not read) and each query attends over all n keys: with ``cache``
    None, flash attention, non-causal (B1, and B2a/B2b under autograd);
    at a decode step ``cache`` = {"attend": (B,) int32, n for every row},
    and the one query row goes to the decode-attention kernel (B3) with
    the image K/V as its cache. That is the function the reference
    computes through its flash kernel at Sq = 1 (``cache`` None there);
    B3 takes one query row per (b, head) against a (B, S, KV, hd) cache,
    where B1's 128-row query blocks would do 1/128 useful work. Returns
    (out, (k, v)).
    """
    q = heads(x, p["wq"])
    if kv_override is not None:
        k, v = kv_override
        if cache is None:
            out = flash_attention_train(q, k, v, causal=False)
        else:
            out = decode_attention(q[:, 0], k, v, cache["attend"])[:, None]
        return _out(out, p["wo"], x.dtype), (k, v)
    q = rotate(q, *rope)
    k = rotate(heads(x, p["wk"]), *rope)
    v = heads(x, p["wv"])
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
    return _out(out, p["wo"], x.dtype), new_kv


def _out(out: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D), wo cast to ``dtype``."""
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ wo.reshape(H * hd, wo.shape[-1]).to(dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers) -> dict:
    """Attention weights of ``layers`` blocks, stacked on a leading axis
    (one unstacked block when ``layers`` is None; a tuple stacks on as many
    axes, see :func:`~repro_torch.models.common.leading_axes`).

    Fan-ins follow the reference: D for wq/wk/wv, H for wo."""
    D, H, KVh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = leading_axes(layers)
    k = len(lead)
    return {
        "wq": init_dense(gen, (*lead, D, H, hd), in_axis=k, dtype=dtype),
        "wk": init_dense(gen, (*lead, D, KVh, hd), in_axis=k, dtype=dtype),
        "wv": init_dense(gen, (*lead, D, KVh, hd), in_axis=k, dtype=dtype),
        "wo": init_dense(gen, (*lead, H, hd, D), in_axis=k, dtype=dtype),
    }
