"""Plain reference of the dense decoder LM, in float32 with TF32 off.

Written from the architecture's description, not from the program: a
pre-norm decoder with RMSNorm (scale, no bias), rotary position
embeddings on q and k (the two halves of each head rotated as a pair,
base ``rope_theta``), grouped-query causal softmax attention (query head
h reads K/V head h // (H / KV)), a gated MLP act(x W_gate) * (x W_up)
W_down (SiLU, or GELU with the tanh approximation), a final RMSNorm and
the logits through ``lm_head`` (or the embedding's transpose when tied).
No biases. The loss is the mean next-token cross-entropy. AdamW with
global-norm clipping, linear warm-up and cosine decay to a tenth.

It imports only ``torch`` and reads nothing the program made: the
weights are the benchmark's (:func:`make_params` draws them from the
seed), and it works every quantity out again. With ``fp8=True`` every
matrix product (the weights' and attention's) takes its operands rounded
to float8 e4m3 with one scale a tensor: the precision below the bf16
that the configurations state, which the limits must reject.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32, not TF32, restored on exit."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def head_dim(m) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def layout(m) -> List[Tuple[str, tuple, Optional[int]]]:
    """(path, shape, fan-in) of every weight, the blocks stacked over the
    layers, in sorted path order; fan-in None marks a norm scale (ones).
    A weight's fan-in is the width of the product's input (H hd for wo);
    the embedding table is looked up, so its rows are unit-variance (fan-in
    1), unless it doubles as the head (tied), whose fan-in is D."""
    D, H, KV, F = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    L, V, hd = m["n_layers"], m["vocab"], head_dim(m)
    tied = m["tie_embeddings"]
    leaves = [("embed", (V, D), D if tied else 1), ("final_norm", (D,), None),
              ("blocks/attn/wq", (L, D, H, hd), D),
              ("blocks/attn/wk", (L, D, KV, hd), D),
              ("blocks/attn/wv", (L, D, KV, hd), D),
              ("blocks/attn/wo", (L, H, hd, D), H * hd),
              ("blocks/ln1", (L, D), None), ("blocks/ln2", (L, D), None),
              ("blocks/mlp/w_gate", (L, D, F), D),
              ("blocks/mlp/w_up", (L, D, F), D),
              ("blocks/mlp/w_down", (L, F, D), F)]
    if not tied:
        leaves.append(("lm_head", (D, V), D))
    return sorted(leaves)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key in sorted(tree):
        path = prefix + key
        if isinstance(tree[key], dict):
            out.update(leaves(tree[key], path + "/"))
        else:
            out[path] = tree[key]
    return out


def make_params(m, seed: int, device, dtype) -> dict:
    """The weights from ``seed``, on ``device``: N(0, 1/fan_in) in
    ``dtype`` (one draw a stacked leaf, by a generator on the device),
    norm scales ones in float32. (The port's own init takes H as wo's
    fan-in and V as the embedding's; at yi-6b's widths its greedy tokens
    then repeat one token for a whole request, so that a served request
    checks about one decision. With these scales each served token is a
    decision of its own.)"""
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2**63)
    flat = {}
    for path, shape, fan in layout(m):
        if fan is None:
            flat[path] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            flat[path] = w.mul_(fan ** -0.5)
    return nest(flat)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's, back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _E4M3Product(torch.autograd.Function):
    """a @ b with both operands in e4m3, and e4m3 operands in the
    backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = e4m3(a), e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = e4m3(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def product(a, b, fp8: bool):
    return _E4M3Product.apply(a, b) if fp8 else a @ b


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def act(name: str, x):
    if name == "silu":
        return x * torch.sigmoid(x)
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3))))


def rotary(x, theta: float):
    """x (B, S, heads, hd) at positions 0..S-1: each pair (x_i, x_{i +
    hd/2}) turned by the angle pos * theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd // 2, device=x.device,
                                  dtype=torch.float64) * 2 / hd)
    ang = (torch.arange(S, device=x.device, dtype=torch.float64)[:, None]
           * inv[None, :]).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(q, k, v, fp8: bool):
    """Causal softmax attention; q (B, S, H, hd), k, v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = product(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return product(p, v, fp8).transpose(1, 2)


def layer(m, x, w, fp8: bool):
    B, S, D = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    h = rms(x, w["ln1"].float(), m["norm_eps"])
    q = product(h, w["wq"].float().reshape(D, H * hd), fp8)
    k = product(h, w["wk"].float().reshape(D, KV * hd), fp8)
    v = product(h, w["wv"].float().reshape(D, KV * hd), fp8)
    q = rotary(q.view(B, S, H, hd), m["rope_theta"])
    k = rotary(k.view(B, S, KV, hd), m["rope_theta"])
    o = attention(q, k, v.view(B, S, KV, hd), fp8).reshape(B, S, H * hd)
    x = x + product(o, w["wo"].float().reshape(H * hd, D), fp8)
    h = rms(x, w["ln2"].float(), m["norm_eps"])
    g = act(m["act"], product(h, w["w_gate"].float(), fp8))
    return x + product(g * product(h, w["w_up"].float(), fp8),
                       w["w_down"].float(), fp8)


def hidden(m, P, tokens, fp8: bool = False):
    """tokens (B, S) -> the final-normed hidden states (B, S, D), float32."""
    x = P["embed"].float()[tokens]
    blocks = P["blocks"]
    for i in range(m["n_layers"]):
        w = {"ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i],
             **{k: blocks["attn"][k][i] for k in ("wq", "wk", "wv", "wo")},
             **{k: blocks["mlp"][k][i]
                for k in ("w_gate", "w_up", "w_down")}}
        x = layer(m, x, w, fp8)
    return rms(x, P["final_norm"].float(), m["norm_eps"])


def logits(m, P, h, fp8: bool = False):
    head = P["embed"].float().t() if m["tie_embeddings"] \
        else P["lm_head"].float()
    return product(h, head, fp8)


def loss(m, P, tokens, fp8: bool = False):
    """Mean next-token cross-entropy of tokens (B, S + 1)."""
    lg = logits(m, P, hidden(m, P, tokens[:, :-1], fp8), fp8)
    tgt = tokens[:, 1:]
    picked = lg.gather(-1, tgt[..., None])[..., 0]
    return (torch.logsumexp(lg, dim=-1) - picked).mean()


@torch.no_grad()
def served_logits(m, P, prompt, served, fp8: bool = False):
    """The logits that chose each served token: one sequence, the prompt
    followed by the served tokens but the last; rows at the prompt's last
    position and after, (len(served), V) float32."""
    seq = torch.cat([prompt, served[:-1]])[None]
    h = hidden(m, P, seq, fp8)[0, prompt.numel() - 1:]
    return logits(m, P, h, fp8)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_and_grads(m, P, tokens, rows: int, fp8: bool = False):
    """(loss, grads by path) over tokens (B, S + 1), in blocks of ``rows``
    rows: the mean's gradient is the blocks' gradients weighted by their
    share of the rows."""
    flat = {k: v.detach().float().requires_grad_() for k, v in
            leaves(P).items()}
    tree = nest(flat)
    B = tokens.shape[0]
    total = torch.zeros((), device=tokens.device)
    for r0 in range(0, B, rows):
        part = tokens[r0:r0 + rows]
        lo = loss(m, tree, part, fp8) * (part.shape[0] / B)
        lo.backward()
        total += lo.detach()
    return total, {k: v.grad for k, v in flat.items()}


def learning_rate(opt, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                               * prog)))


@torch.no_grad()
def adamw(P: Dict[str, torch.Tensor], G: Dict[str, torch.Tensor], M, V,
          step: int, opt) -> Dict[str, torch.Tensor]:
    """One AdamW step on flat float32 params; updates M and V in place and
    returns (new params, the clipped gradients)."""
    norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in G.values()))
    clip = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
    lr = learning_rate(opt, step)
    c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
    out, clipped = {}, {}
    for k, p in P.items():
        g = G[k] * clip
        clipped[k] = g
        M[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        V[k].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
        upd = (M[k] / c1) / ((V[k] / c2).sqrt() + opt["eps"]) \
            + opt["weight_decay"] * p
        out[k] = p - lr * upd
    return out, clipped


def train_steps(m, P0: dict, batches, opt, rows: int, fp8: bool = False):
    """Follow ``len(batches)`` train steps from the params ``P0``: (each
    step's loss, the first step's clipped gradient by path, the params
    after the last step by path)."""
    P = {k: v.detach().float() for k, v in leaves(P0).items()}
    M = {k: torch.zeros_like(v) for k, v in P.items()}
    V = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first = [], None
    for i, tokens in enumerate(batches):
        lo, G = loss_and_grads(m, nest(P), tokens, rows, fp8)
        losses.append(float(lo))
        P, clipped = adamw(P, G, M, V, i + 1, opt)
        if first is None:
            first = clipped
        del G
    return losses, first, P
