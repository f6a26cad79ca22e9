"""Plain PyTorch versions of the flash-attention forward and backward
kernels."""

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


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            scale=None):
    """Full-matrix attention backward in float32, from the forward's
    residuals.

    Layouts as :func:`flash_attention_ref`: q, o, do (B, Sq, H, hd); k, v
    (B, Sk, KV, hd); lse (B, H, Sq) float32. P is recomputed from the given
    LSE as exp(q . k * scale - lse) under the same top-left causal mask,
    delta = rowsum(o * do) in float32, dS = P * (dP - delta) * scale, and
    dK and dV are summed over the G query heads of each K/V head. Returns
    (dq in q's dtype, dk and dv in k's dtype), the same function as the
    backward kernels."""
    flash_attention_bwd_ref.launches += 1
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(G, dim=2)
    vr = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kr)
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    delta = (o.float() * dof).sum(-1).transpose(1, 2)         # (B, H, Sq)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.view(B, Sk, KV, G, hd).sum(3)
    dv = dv.view(B, Sk, KV, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_ref.launches = 0
