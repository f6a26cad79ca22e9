"""Layer blocks of the port: the gated MLP of the dense family, the routed
experts of the moe family, the Mamba2 (SSD) block of the hybrid family and
the RWKV6 time and channel mixes."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan.ops import rwkv6_scan
from ..kernels.ssm_scan.ops import ssd_scan
from .common import ModelConfig, act_fn, init_dense, leading_axes

CONV_K = 4   # width of the Mamba2 block's depthwise causal conv


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """act(x W_gate) * (x W_up) W_down, weights cast to x's dtype."""
    h = act_fn(cfg.act)(x @ p["w_gate"].to(x.dtype))
    h = h * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def init_mlp(gen: torch.Generator, d: int, f: int, dtype, layers) -> dict:
    """MLP weights of ``layers`` blocks, stacked on a leading layer axis
    (one unstacked block when ``layers`` is None; a tuple stacks on as many
    axes, see :func:`~repro_torch.models.common.leading_axes`)."""
    lead = leading_axes(layers)
    k = len(lead)
    return {"w_gate": init_dense(gen, (*lead, d, f), in_axis=k, dtype=dtype),
            "w_up": init_dense(gen, (*lead, d, f), in_axis=k, dtype=dtype),
            "w_down": init_dense(gen, (*lead, f, d), in_axis=k, dtype=dtype)}


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, the lower index
    first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed experts with capacity dropping (no residual or norm).

    x (B, S, D) -> (B, S, D). Every token of the batch is routed together:
    router logits in x's dtype, softmax in float32, the top k gates
    renormalized by their sum. Each expert takes C = max(int(G K cf / E),
    1) of the G = B S tokens' G K choices, in token order (a stable sort
    by expert, rank within the expert by ``searchsorted``); the rest go to
    a drop slot whose row is never read and come back as 0. The expert
    products run as ``torch.bmm`` over (E, C, D) buffers; the output is
    the gate-weighted sum of a token's k expert rows, plus the shared
    expert's MLP when ``shared_expert_ff`` > 0. The reference's order of
    operations, so bf16 rounds where it rounds."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = B * S
    xt = x.reshape(G, D)
    logits = xt @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = _top_k(probs, K)                           # (G, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    C = max(int(G * K * cfg.capacity_factor / E), 1)
    flat_e = idx.reshape(-1)                                # (G K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(G * K, device=x.device) \
        - torch.searchsorted(sorted_e, sorted_e, right=False)
    dest = torch.where(pos < C, sorted_e * C + pos, E * C)  # drop slot last
    tok = order // K
    # several dropped choices write the drop slot; its row is never read
    buf = xt.new_zeros(E * C + 1, D).index_copy(0, dest, xt[tok])
    ebuf = buf[:E * C].view(E, C, D)

    h = act_fn(cfg.act)(torch.bmm(ebuf, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(ebuf, p["w_up"].to(x.dtype))
    eout = torch.bmm(h, p["w_down"].to(x.dtype))

    flat_out = torch.cat([eout.reshape(E * C, D), eout.new_zeros(1, D)])
    picked = flat_out[dest]                                 # sorted order
    yk = picked.new_zeros(G * K, D).index_copy(0, order, picked)
    y = torch.einsum("gkd,gk->gd", yk.view(G, K, D), gates.to(eout.dtype))
    if cfg.shared_expert_ff:
        y = y + mlp(x, p["shared"], cfg).reshape(G, D)
    return y.reshape(B, S, D).to(x.dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             layers: int) -> dict:
    """MoE weights of ``layers`` blocks, stacked on a leading layer axis:
    ``router`` (D, E), ``w_gate`` and ``w_up`` (E, D, F), ``w_down`` (E, F,
    D), with the reference's fan-ins (D for the router, axis 1 of an
    expert's leaf for the experts), and ``shared`` when
    ``shared_expert_ff`` > 0. The expert leaves are drawn one expert at a
    time into a tensor of ``dtype``, so the float32 scratch is one
    expert's slice, not the whole leaf."""
    d, f, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, layers

    def experts(rows, cols):
        w = torch.empty((L, E, rows, cols), dtype=dtype, device=gen.device)
        for layer in range(L):
            for e in range(E):
                w[layer, e] = init_dense(gen, (rows, cols), dtype=dtype)
        return w

    p = {"router": init_dense(gen, (L, d, E), in_axis=1, dtype=dtype),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if cfg.shared_expert_ff:
        p["shared"] = init_mlp(gen, d, cfg.shared_expert_ff, dtype, L)
    return p


def moe_aux_loss(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing loss of x (B, S, D) on one layer's
    router: E times the sum over experts of (the share of tokens whose
    top-1 is the expert) x (the mean router probability of the expert).
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    E = cfg.n_experts
    probs = torch.softmax((x @ p["router"].to(x.dtype)).float(), dim=-1)
    top1 = probs.argmax(dim=-1)
    frac_tokens = F.one_hot(top1, E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return E * (frac_tokens * frac_probs).sum()


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


def _previous(x: torch.Tensor, state: Optional[dict], key: str):
    """The token before each of x's (B, T, D): zero before the first one
    (``state`` None) or the cached row ``state[key]`` (B, D)."""
    if state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return state[key][:, None, :]


def _mix(x, x_prev, mu):
    """Token-shift interpolation x mu + x_prev (1 - mu), mu in x's dtype."""
    mu = mu.to(x.dtype)
    return x * mu + x_prev * (1 - mu)


def rwkv6_time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   state: Optional[dict] = None) -> Tuple:
    """RWKV6 time mix (no residual or norm; the caller adds them).

    x (B, T, D) -> (out (B, T, D), {"shift": x's last row (B, D), "wkv":
    the state (B, H, N, N) float32}). Each of r, k, v, the gate g and the
    decay's offset dw projects its own token-shift mix of x; w =
    exp(-exp(w0 + dw)) and the bonus u are float32. Prefill and training
    (``state`` None): the scan over all T steps from a zero state
    (:func:`rwkv6_scan`: the B5 kernel on a CUDA tensor), at any T. Decode
    (``state`` holds "shift" and "wkv", T = 1): the one-token recurrence in
    float32. Then silu(g) gates the scan's output, a per-head RMS norm
    scales it by ``ln_x`` (as (H, N)) and ``wo`` projects it back. Weights
    are cast to x's dtype where they are used."""
    B, T, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    x_prev = _previous(x, state, "shift")

    def proj(name, wname):
        w = p[wname].to(x.dtype).reshape(D, H * N)
        return (_mix(x, x_prev, p[f"mu_{name}"]) @ w).reshape(B, T, H, N)

    r, k, v = proj("r", "wr"), proj("k", "wk"), proj("v", "wv")
    g = F.silu(proj("g", "wg"))
    w = torch.exp(-torch.exp(p["w0"].float() + proj("w", "ww").float()))
    u = p["u"].float()
    if state is None:
        out, S = rwkv6_scan(r, k, v, w, u)
    else:
        S = state["wkv"]
        kv = k[:, 0, :, :, None].float() * v[:, 0, :, None, :].float()
        out = torch.einsum("bhn,bhnm->bhm", r[:, 0].float(),
                           S + u[None, :, :, None] * kv)[:, None]
        S = w[:, 0, :, :, None] * S + kv
    out = out.to(x.dtype) * g
    outn = F.rms_norm(out.float(), (N,), eps=cfg.norm_eps) \
        * p["ln_x"].float().reshape(H, N)
    y = outn.to(x.dtype).reshape(B, T, D) @ p["wo"].to(x.dtype).reshape(D, D)
    return y, {"shift": x[:, -1], "wkv": S}


def rwkv6_channel_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      state: Optional[dict] = None) -> Tuple:
    """RWKV6 channel mix: sigmoid(xr W_r) * (relu(xk W_k)^2 W_v), xk and xr
    token-shift mixes of x. Its weights live in the time mix's dict ``p``
    (``w_k``, ``w_v``, ``w_r``, ``mu_ck``, ``mu_cr``), as in the reference.
    Returns (out, {"shift_ffn": x's last row}); ``state`` (decode) holds the
    previous token's row under "shift_ffn"."""
    x_prev = _previous(x, state, "shift_ffn")
    xk = _mix(x, x_prev, p["mu_ck"])
    xr = _mix(x, x_prev, p["mu_cr"])
    kx = torch.relu(xk @ p["w_k"].to(x.dtype)).square()
    r = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    return r * (kx @ p["w_v"].to(x.dtype)), {"shift_ffn": x[:, -1]}


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype,
               lead: Tuple[int, ...]) -> dict:
    """RWKV6 block weights (time and channel mix in one dict), stacked on
    the leading axes ``lead``. Fan-ins and constants follow the reference:
    each weight's first axis is its fan-in (D for the projections, H for
    ``wo`` and ``u``, d_ff for ``w_v``); w0 -0.5, ln_x 1, every mu 0.5."""
    D, f = cfg.d_model, cfg.d_ff
    N = cfg.rwkv_head_dim
    H = D // N
    k = len(lead)
    dense = lambda *shape: init_dense(gen, (*lead, *shape), in_axis=k,
                                      dtype=dtype)
    full = lambda shape, val: torch.full((*lead, *shape), val, dtype=dtype,
                                         device=gen.device)
    p = {"wr": dense(D, H, N), "wk": dense(D, H, N), "wv": dense(D, H, N),
         "wg": dense(D, H, N), "ww": dense(D, H, N), "wo": dense(H, N, D),
         "w0": full((H, N), -0.5), "u": dense(H, N), "ln_x": full((D,), 1.0),
         "w_k": dense(D, f), "w_v": dense(f, D), "w_r": dense(D, D)}
    for name in ("r", "k", "v", "g", "w", "ck", "cr"):
        p[f"mu_{name}"] = full((D,), 0.5)
    return p
