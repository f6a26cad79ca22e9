"""Decoder LM of the port: the dense family, for training and serving.

Parameters are a nested dict of tensors with the reference's keys, the
blocks stacked on a leading layer axis; the layer loop is plain Python over
that axis. ``forward`` and ``loss`` are differentiable with respect to the
params (the training path, with ``cfg.remat`` deciding what each layer
keeps for the backward); ``prefill`` builds the KV cache, ``decode_step``
appends one token per sequence to it in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import attention as A
from . import blocks as BL
from .common import ModelConfig, init_dense, rms_norm, rope_cos_sin

# matmul weights; the other leaves are RMSNorm scales
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "embed", "lm_head")


def flatten(tree: Dict[str, Any], prefix: str = ""):
    """[(path, leaf)] with '/'-joined paths, keys sorted at every level
    (the order of ``jax.tree_util`` on the reference's param dicts)."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.extend(flatten(tree[key], path + "/"))
        else:
            out.append((path, tree[key]))
    return out


def unflatten(items) -> Dict[str, Any]:
    """Inverse of :func:`flatten`."""
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def serving_params(params: Dict[str, Any], cfg: ModelConfig,
                   device) -> Dict[str, Any]:
    """Params on ``device`` with the matmul weights cast once to ``cfg.dtype``.

    That gives the values the reference gets from its per-use
    ``w.astype(x.dtype)``. RMSNorm scales stay float32, because
    ``rms_norm`` multiplies by them in float32."""
    def cast(path, leaf):
        if path.rsplit("/", 1)[-1] in MATMUL_WEIGHTS:
            return leaf.to(device=device, dtype=cfg.dtype)
        return leaf.to(device=device)
    return unflatten((path, cast(path, leaf)) for path, leaf in flatten(params))


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s params: views into the stacked blocks."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _layers(blocks: Dict[str, Any], n: int):
    """The stacked blocks as ``n`` per-layer dicts of views, made by one
    ``unbind`` per leaf, whose backward stacks the layers' gradients in
    one operation."""
    per = [dict() for _ in range(n)]
    for key, leaf in blocks.items():
        parts = _layers(leaf, n) if isinstance(leaf, dict) \
            else leaf.unbind(0)
        for i in range(n):
            per[i][key] = parts[i]
    return per


class LM:
    """Dense decoder LM (GQA attention, gated MLP, RMSNorm, RoPE)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "dense":
            raise ValueError(f"the port serves the dense family only, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params in ``cfg.param_dtype`` from ``gen`` (on this LM's
        device). Same shapes, keys and init scales as the reference; the
        numbers differ, since a torch.Generator is not jax.random."""
        if gen.device != self.device:
            raise ValueError(f"generator on {gen.device}, LM on {self.device}")
        cfg = self.cfg
        dt = cfg.param_dtype
        D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=self.device)
        params: Dict[str, Any] = {
            "embed": init_dense(gen, (V, D), dtype=dt),
            "final_norm": ones(D),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_dense(gen, (D, V), dtype=dt)
        params["blocks"] = {"attn": A.init_attention(gen, cfg, dt, L),
                            "ln1": ones(L, D), "ln2": ones(L, D),
                            "mlp": BL.init_mlp(gen, D, cfg.d_ff, dt, L)}
        return params

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "len": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _dense_block(self, x, blk, rope, cache=None):
        cfg = self.cfg
        h, kv = A.attention_sublayer(rms_norm(x, blk["ln1"], cfg.norm_eps),
                                     blk["attn"], cfg, rope, cache=cache)
        x = x + h
        x = x + BL.mlp(rms_norm(x, blk["ln2"], cfg.norm_eps), blk["mlp"], cfg)
        return x, kv

    def _train_block(self, x, blk, rope):
        return self._dense_block(x, blk, rope)[0]

    def _embed(self, params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        return F.embedding(tokens.long(), params["embed"]).to(self.cfg.dtype)

    def _logits(self, params, x) -> torch.Tensor:
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        return x @ head.to(x.dtype)

    def forward(self, params, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``.

        Differentiable with respect to ``params``, which stay in
        ``cfg.param_dtype``: each matmul weight is cast to ``cfg.dtype`` where
        it is used, as in the reference, so the gradients reach the masters.
        ``cfg.remat == "full"`` keeps only each layer's input and runs the
        layer again in the backward (``torch.utils.checkpoint``), as the
        reference's ``jax.checkpoint`` does; ``"none"`` keeps everything."""
        cfg = self.cfg
        if cfg.remat not in ("full", "none"):
            raise NotImplementedError(
                f"remat={cfg.remat!r} is not ported yet (it comes with the "
                f"data-parallel training slice); use 'full' or 'none'")
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        for blk in _layers(params["blocks"], cfg.n_layers):
            if cfg.remat == "full":
                x = checkpoint(self._train_block, x, blk, rope,
                               use_reentrant=False)
            else:
                x = self._train_block(x, blk, rope)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S + 1):
        the logits of tokens[:, :-1] in float32, logsumexp minus the logit
        of each target tokens[:, 1:]. A scalar float32 tensor."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = self.forward(params, inputs).float()
        picked = logits.gather(-1, targets[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - picked).mean()

    def prefill(self, params, tokens, max_len: Optional[int] = None,
                last_pos=None):
        """Run the prompt (B, S) and build the decode cache.

        Returns (logits (B, 1, V), cache). ``last_pos`` ((B,) ints) names
        each sequence's true last prompt position: the logits are taken
        there, and the cache gets per-sequence lengths ``last_pos + 1``.
        None takes column S-1 and a scalar length S."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        max_len = max_len or S + 1
        if max_len < S:
            raise ValueError(f"max_len={max_len} is shorter than the "
                             f"prompt ({S})")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        cache = self.init_cache(B, max_len)
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            x, (k, v) = self._dense_block(x, _layer(blocks, i), rope)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if last_pos is None:
            sel = x[:, -1:]
            cache["len"] = torch.tensor(S, dtype=torch.int32,
                                        device=self.device)
        else:
            last_pos = torch.as_tensor(last_pos, device=self.device).long()
            sel = x[torch.arange(B, device=self.device), last_pos][:, None]
            cache["len"] = (last_pos + 1).to(torch.int32)
        return self._logits(params, sel), cache

    def decode_step(self, params, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V), cache).

        The K/V rows are written into ``cache`` in place (the reference
        donates its cache); the returned cache holds the same K/V tensors
        and ``len + 1``. ``cache["len"]`` is a scalar (one shared append
        position) or (B,) (each row appends at, and takes its RoPE position
        from, its own length)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B = x.shape[0]
        ln = cache["len"]
        pos = ln[:, None] if ln.dim() == 1 else ln.expand(B, 1)
        rope = rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
        at, attend = A.decode_rows(ln, B, cache["k"].shape[2])
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            x, _ = self._dense_block(
                x, _layer(blocks, i), rope,
                cache={"k": cache["k"][i], "v": cache["v"][i], "at": at,
                       "attend": attend})
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": ln + 1}
        return self._logits(params, x), new_cache


def build_model(cfg: ModelConfig, device="cuda") -> LM:
    return LM(cfg, device=device)
