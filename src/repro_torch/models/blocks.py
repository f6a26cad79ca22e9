"""Layer blocks of the port: the gated MLP of the dense family and the
Mamba2 (SSD) block of the hybrid family."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan.ops import ssd_scan
from .common import ModelConfig, act_fn, init_dense

CONV_K = 4   # width of the Mamba2 block's depthwise causal conv


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """act(x W_gate) * (x W_up) W_down, weights cast to x's dtype."""
    h = act_fn(cfg.act)(x @ p["w_gate"].to(x.dtype))
    h = h * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def init_mlp(gen: torch.Generator, d: int, f: int, dtype,
             layers: Optional[int]) -> dict:
    """MLP weights of ``layers`` blocks, stacked on a leading layer axis
    (one unstacked block when ``layers`` is None)."""
    lead = () if layers is None else (layers,)
    k = len(lead)
    return {"w_gate": init_dense(gen, (*lead, d, f), in_axis=k, dtype=dtype),
            "w_up": init_dense(gen, (*lead, d, f), in_axis=k, dtype=dtype),
            "w_down": init_dense(gen, (*lead, f, d), in_axis=k, dtype=dtype)}


def mamba2_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: Optional[dict] = None) -> Tuple:
    """Mamba2 block core (no residual or norm; the caller adds them).

    x (B, T, D) -> (out (B, T, D), state). ``w_in`` splits into the gate z,
    the conv input xc, B, C and dt; xc goes through a depthwise causal conv
    of width 4, then silu; dt = softplus(dt + dt_bias) in x's dtype, A =
    -exp(a_log) in float32; then the SSD scan, the D skip and the silu(z)
    gate. Weights are cast to x's dtype where they are used.

    Prefill and training (``state`` None): the conv runs over a zero
    history and the scan over all T steps (:func:`ssd_scan`: the B4 kernel
    on a CUDA tensor). The returned state is {"conv": the last 3 raw
    pre-conv xc rows (B, 3, d_in), "ssm": the final (B, H, P, N) float32
    state}, or None when T < 3 leaves no conv state. Decode (``state``
    holds them, T = 1): the conv runs over the state's rows and the scan is
    the one-token recurrence in float32."""
    B, T, D = x.shape
    d_in = cfg.ssm_expand * D
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = d_in // P
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, xc, Bm, Cm, dt = zxbcdt.split([d_in, d_in, N, N, H], dim=-1)
    wconv = p["w_conv"].to(x.dtype)                       # (K, d_in)
    hist = x.new_zeros(B, CONV_K - 1, d_in) if state is None \
        else state["conv"]
    xfull = torch.cat([hist, xc], dim=1)                  # (B, K-1+T, d_in)
    conv = xfull[:, :T] * wconv[0]
    for i in range(1, CONV_K):
        conv = conv + xfull[:, i:i + T] * wconv[i]
    new_conv = xfull[:, -(CONV_K - 1):] if state is not None \
        or T >= CONV_K - 1 else None
    xc = F.silu(conv)
    dt = F.softplus(dt + p["dt_bias"].to(x.dtype))        # (B, T, H)
    A = -torch.exp(p["a_log"].float())                    # (H,)
    xh = xc.reshape(B, T, H, P)
    if state is None:
        y, h = ssd_scan(xh, dt, A, Bm, Cm, return_state=True)
    else:
        dt0 = dt[:, 0].float()
        da = torch.exp(dt0 * A)                           # (B, H)
        dbx = dt0[..., None, None] * xh[:, 0, :, :, None].float() \
            * Bm[:, 0, None, None, :].float()             # (B, H, P, N)
        h = da[..., None, None] * state["ssm"] + dbx
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())[:, None]
    y = y.to(x.dtype).reshape(B, T, d_in)
    y = y + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    return out, None if new_conv is None else {"conv": new_conv, "ssm": h}


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                lead: Tuple[int, ...]) -> dict:
    """Mamba2 block weights, stacked on the leading axes ``lead``. Fan-ins
    and constants follow the reference: D for w_in, d_in for w_out, the
    conv width for w_conv; dt_bias and a_log 0, d_skip 1."""
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    e = 2 * d_in + 2 * N + H
    k = len(lead)
    full = lambda n, v: torch.full((*lead, n), v, dtype=dtype,
                                   device=gen.device)
    return {"w_in": init_dense(gen, (*lead, D, e), in_axis=k, dtype=dtype),
            "w_out": init_dense(gen, (*lead, d_in, D), in_axis=k,
                                dtype=dtype),
            "w_conv": init_dense(gen, (*lead, CONV_K, d_in), in_axis=k,
                                 dtype=dtype),
            "dt_bias": full(H, 0.0), "a_log": full(H, 0.0),
            "d_skip": full(d_in, 1.0)}
