"""Plain PyTorch version of the RWKV6 scan kernel."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 64   # steps per checkpointed chunk under autograd


def _steps(S, r, k, v, w, u):
    """The recurrence over the time axis of r, k, v and w (B, T, H, N), all
    float32, from the state S (B, H, N, N): (S after the last step, y (B, T,
    H, N))."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return S, torch.stack(ys, dim=1)


def rwkv6_scan_ref(r, k, v, w, u):
    """The RWKV6 recurrence from a zero state, sequentially in float32.

    r, k, v, w: (B, T, H, N); u: (H, N). The state S (B, H, N, N) is
    indexed S[n_k, n_v]; per step, y_t = r_t^T (S + (u o k_t) v_t^T), then
    S = diag(w_t) S + k_t v_t^T. Every input is cast to float32 first, so
    k_t v_t^T is a float32 product whatever the inputs' dtype, as in the
    Pallas kernel. Returns (y (B, T, H, N) float32, the final state (B, H,
    N, N) float32), at any T: nothing is padded, so the state is the one
    after step T. Under autograd the steps run in checkpointed chunks of 64
    (the last one shorter), so the backward keeps one state per chunk
    instead of one per step."""
    rwkv6_scan_ref.launches += 1
    B, T, H, N = r.shape
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u))):
        S, y = _steps(S, r, k, v, w, u)
        return y, S
    ys = []
    for t0 in range(0, T, CHUNK):
        part = slice(t0, t0 + CHUNK)
        S, y = checkpoint(_steps, S, r[:, part], k[:, part], v[:, part],
                          w[:, part], u, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), S


rwkv6_scan_ref.launches = 0
