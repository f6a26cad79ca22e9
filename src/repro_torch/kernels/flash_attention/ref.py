"""Plain PyTorch version of the flash-attention forward kernel."""

from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    """Full-matrix softmax attention in float32.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), KV dividing H. The causal mask
    is top-left aligned (key k is seen by query q when k <= q). Returns
    (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32), the same
    function as the kernel."""
    flash_attention_ref.launches += 1
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kr = k.float().repeat_interleave(H // KV, dim=2)
    vr = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)
    return o.to(q.dtype), lse


flash_attention_ref.launches = 0
