"""Plain PyTorch version of the decode-attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lens, scale=None):
    """One query token per (b, h) against a (B, S, KV, hd) cache, in float32.

    q: (B, H, hd). ``lens``: per-sequence lengths, (B,) or a scalar; row b
    attends over its first min(len_b, S) cache rows (none when len_b <= 0:
    the output row is then 0, as in the kernel). Returns (B, H, hd) in q's
    dtype."""
    decode_attention_ref.launches += 1
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kr = k_cache.float().repeat_interleave(H // KV, dim=2)
    vr = v_cache.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, kr)
    lens = torch.as_tensor(lens, device=q.device).reshape(-1, 1, 1)
    valid = torch.arange(S, device=q.device)[None, None, :] < lens
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    o = torch.einsum("bhs,bshd->bhd", p, vr)
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype)


decode_attention_ref.launches = 0
