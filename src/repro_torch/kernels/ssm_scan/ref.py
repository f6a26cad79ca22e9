"""Plain PyTorch version of the Mamba2 SSD scan kernel."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 64   # steps per checkpointed chunk under autograd


def _steps(h, da, dtx, b, c):
    """The recurrence over the time axis of da (B, T, H), dtx (B, T, H, P),
    b and c (B, T, N), from the state h (B, H, P, N): (h after the last
    step, y (B, T, H, P))."""
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t, :, None, None] * h \
            + dtx[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    return h, torch.stack(ys, dim=1)


def ssd_scan_ref(xh, dt, A, Bm, Cm):
    """The Mamba2 SSD recurrence from a zero state, sequentially in float32.

    xh: (B, T, H, P); dt: (B, T, H); A: (H,); Bm, Cm: (B, T, N), shared by
    the heads. Per step, h = exp(dt A) h + dt x B^T and y = h C. Returns
    (y (B, T, H, P) float32, the final state (B, H, P, N) float32). Under
    autograd the steps run in checkpointed chunks of 64, so the backward
    keeps one state per chunk instead of one per step (the reference's
    ``_chunked_time_scan``)."""
    ssd_scan_ref.launches += 1
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    dtf = dt.float()
    da = torch.exp(dtf * A.float())
    dtx = dtf[..., None] * xh.float()
    b, c = Bm.float(), Cm.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, dt, A, Bm, Cm))
    if not grad:
        h, y = _steps(h, da, dtx, b, c)
        return y, h
    ys = []
    for t0 in range(0, T, CHUNK):
        part = slice(t0, t0 + CHUNK)
        h, y = checkpoint(_steps, h, da[:, part], dtx[:, part], b[:, part],
                          c[:, part], use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


ssd_scan_ref.launches = 0
