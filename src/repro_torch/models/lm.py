"""Decoder LM of the port: the dense and audio families (:class:`LM`), the
moe family (:class:`MoeLM`), the vlm family (:class:`VlmLM`), the zamba2
hybrid family (:class:`HybridLM`) and the rwkv6 family (:class:`RwkvLM`),
for training and serving.

Parameters are a nested dict of tensors with the reference's keys, the
blocks stacked on a leading layer axis; the layer loop is plain Python over
that axis. ``forward`` and ``loss`` are differentiable with respect to the
params (the training path, with ``cfg.remat`` deciding what each layer
keeps for the backward); ``prefill`` builds the decode cache,
``decode_step`` appends one token per sequence to it in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..spans import span
from . import attention as A
from . import blocks as BL
from .common import ModelConfig, init_dense, rms_norm, rope_cos_sin

# the leaves the reference casts to the activation dtype where it uses
# them; the others (RMSNorm scales, Mamba2's a_log, RWKV6's w0, u and ln_x)
# stay float32
CAST_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "router", "embed", "lm_head", "w_in", "w_out", "w_conv",
                "dt_bias", "d_skip", "wr", "wg", "ww", "w_k", "w_v", "w_r",
                "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr",
                "gate")


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
    """Params on ``device`` with the :data:`CAST_WEIGHTS` cast once to
    ``cfg.dtype``.

    That gives the values the reference gets from its per-use
    ``w.astype(x.dtype)``. RMSNorm scales stay float32, because
    ``rms_norm`` multiplies by them in float32, and so does ``a_log``,
    which the reference reads in float32."""
    def cast(path, leaf):
        if path.rsplit("/", 1)[-1] in CAST_WEIGHTS:
            return leaf.to(device=device, dtype=cfg.dtype)
        return leaf.to(device=device)
    return unflatten((path, cast(path, leaf)) for path, leaf in flatten(params))


REMATS = ("none", "full", "dots")

# the products with no batch dims: what ``x @ W`` reaches (a 2-D weight
# folds the leading dims into one ``mm``), the outputs the reference's
# ``checkpoint_dots_with_no_batch_dims`` keeps
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of the products with no batch dims; recompute the
    rest (the experts' batched ``bmm``, the elementwise work, the
    attention and scan kernels)."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_dots_contexts = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_policy)


def _check_remat(cfg: ModelConfig) -> None:
    """Remat "none", "full" and "dots" are ported; any other name raises."""
    if cfg.remat not in REMATS:
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not a remat policy; use one of "
            f"{REMATS}")


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: "none" keeps every activation for
    the backward; "full" keeps only the inputs and runs ``fn`` again in the
    backward (``jax.checkpoint``); "dots" keeps the outputs of the products
    with no batch dims as well and recomputes the rest (``jax.checkpoint``
    with ``checkpoint_dots_with_no_batch_dims``), through a selective
    checkpoint whose policy is :func:`_dots_policy`."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_dots_contexts)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp minus the target's logit, in float32."""
    logits = logits.float()
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


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


def hybrid_layout(cfg: ModelConfig):
    """(n_groups, blocks per group, remainder blocks) of a hybrid ``cfg``."""
    every = max(cfg.attn_every, 1)
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


class LM:
    """Dense decoder LM (GQA attention, gated MLP, RMSNorm, RoPE). The audio
    family (musicgen) is the same model over audio-codec tokens, as in the
    reference."""

    families = ("dense", "audio")
    # whether a real position's outputs can depend on positions after it:
    # not here (causal attention, a per-token MLP), so padding is dead work
    reads_later_positions = False

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in self.families:
            served = " and the ".join(f"{f} family" for f in self.families)
            raise ValueError(f"{type(self).__name__} serves the {served}, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params in ``cfg.param_dtype`` from ``gen`` (on this LM's
        device). Same shapes, keys and init scales as the reference; the
        numbers differ, since a torch.Generator is not jax.random."""
        cfg = self.cfg
        dt = cfg.param_dtype
        D, L = cfg.d_model, cfg.n_layers
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=self.device)
        params = self._init_embedding(gen)
        params["blocks"] = {"attn": A.init_attention(gen, cfg, dt, L),
                            "ln1": ones(L, D), "ln2": ones(L, D),
                            **self._init_ffn(gen, dt)}
        return params

    def _init_embedding(self, gen: torch.Generator) -> Dict[str, Any]:
        """``embed``, ``final_norm`` and, unless tied, ``lm_head``, drawn
        from ``gen`` in ``cfg.param_dtype``; ``gen`` must be on this LM's
        device."""
        if gen.device != self.device:
            raise ValueError(f"generator on {gen.device}, LM on {self.device}")
        cfg = self.cfg
        dt, D, V = cfg.param_dtype, cfg.d_model, cfg.vocab
        params: Dict[str, Any] = {
            "embed": init_dense(gen, (V, D), dtype=dt),
            "final_norm": torch.ones(D, dtype=dt, device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_dense(gen, (D, V), dtype=dt)
        return params

    def _init_ffn(self, gen: torch.Generator, dtype) -> Dict[str, Any]:
        """The blocks' feed-forward weights, stacked over the layers."""
        cfg = self.cfg
        return {"mlp": BL.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                   cfg.n_layers)}

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
        return x + self._ffn(rms_norm(x, blk["ln2"], cfg.norm_eps), blk), kv

    def _ffn(self, y, blk):
        """The block's feed-forward sublayer on its normed input."""
        return BL.mlp(y, blk["mlp"], self.cfg)

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

    def _prefill_logits(self, params, x, cache, last_pos):
        """The end of a prefill: the final norm, then (logits (B, 1, V),
        ``cache``) at column S-1 with the scalar length S, or at each
        row's ``last_pos`` ((B,) ints) with the lengths ``last_pos + 1``."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        B, S = x.shape[:2]
        if last_pos is None:
            sel = x[:, -1:]
            cache["len"] = torch.tensor(S, dtype=torch.int32,
                                        device=self.device)
        else:
            last_pos = torch.as_tensor(last_pos, device=self.device).long()
            sel = x[torch.arange(B, device=self.device), last_pos][:, None]
            cache["len"] = (last_pos + 1).to(torch.int32)
        return self._logits(params, sel), cache

    def forward(self, params, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``.

        Differentiable with respect to ``params``, which stay in
        ``cfg.param_dtype``: each matmul weight is cast to ``cfg.dtype`` where
        it is used, as in the reference, so the gradients reach the masters.
        ``cfg.remat == "full"`` keeps only each layer's input and runs the
        layer again in the backward (``torch.utils.checkpoint``), as the
        reference's ``jax.checkpoint`` does; ``"dots"`` also keeps the
        layer's products with no batch dims (:func:`remat`); ``"none"``
        keeps everything."""
        cfg = self.cfg
        _check_remat(cfg)
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        for blk in _layers(params["blocks"], cfg.n_layers):
            x = remat(cfg, self._train_block, x, blk, rope)
        with span("model.head"):
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return self._logits(params, x)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S + 1):
        the logits of tokens[:, :-1] in float32, logsumexp minus the logit
        of each target tokens[:, 1:]. A scalar float32 tensor."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        logits = self.forward(params, tokens[:, :-1])
        with span("model.loss"):
            return _nll(logits, tokens[:, 1:])

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
        return self._prefill_logits(params, x, cache, last_pos)

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


class MoeLM(LM):
    """MoE decoder LM: the dense family's attention, prefill and decode
    (scalar and ``(B,)`` cache lengths, the clamped writes past the cache
    end), with routed experts (:func:`~repro_torch.models.blocks.moe_mlp`)
    as each block's feed-forward sublayer. Every token of a call is routed
    together, so a row's experts depend on the other rows of its batch
    (expert capacity)."""

    families = ("moe",)
    # expert capacity is set by every token of the call, padding included
    reads_later_positions = True

    def _init_ffn(self, gen: torch.Generator, dtype) -> Dict[str, Any]:
        return {"moe": BL.init_moe(gen, self.cfg, dtype, self.cfg.n_layers)}

    def _ffn(self, y, blk):
        return BL.moe_mlp(y, blk["moe"], self.cfg)

    def loss(self, params, batch) -> torch.Tensor:
        """:meth:`LM.loss` plus 0.01 times the load-balancing loss
        (:func:`~repro_torch.models.blocks.moe_aux_loss`) of the embedded
        inputs on layer 0's router, as in the reference."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = self._embed(params, tokens[:, :-1])
        first = _layer(params["blocks"], 0)["moe"]
        return super().loss(params, batch) \
            + 0.01 * BL.moe_aux_loss(x, first, self.cfg)


def vlm_layout(cfg: ModelConfig):
    """(n_groups, self blocks per group) of a vlm ``cfg``: each group is
    one cross block and ``cross_attn_every - 1`` self blocks."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


class VlmLM(LM):
    """llama-3.2-vision LM: ``n_groups`` groups, each one cross-attention
    block over the image tokens' K/V and ``cross_attn_every - 1`` dense
    self-attention blocks. A cross block adds its attention through a
    ``tanh(gate)``, the gate zero at init as in the reference (so a fresh
    model's image path changes nothing), then an MLP. The image embeddings
    (B, n_image_tokens, D) are a stub input, as in the reference: zeros
    when none are given.

    The decode cache holds each self block's K/V and each group's image
    K/V, computed once by the prefill; a decode step appends to the
    former in place. ``cache["len"]`` is a scalar: the grouped state has
    no per-row append position, as in the reference."""

    families = ("vlm",)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params in ``cfg.param_dtype`` from ``gen``, with the
        reference's shapes, keys and init scales; every gate 0."""
        cfg = self.cfg
        dt = cfg.param_dtype
        D, F_ = cfg.d_model, cfg.d_ff
        G, E = vlm_layout(cfg)
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=self.device)
        params = self._init_embedding(gen)
        params["cross_blocks"] = {
            "attn": A.init_attention(gen, cfg, dt, G),
            "mlp": BL.init_mlp(gen, D, F_, dt, G),
            "ln1": ones(G, D), "ln2": ones(G, D),
            "gate": torch.zeros((G, 1), dtype=dt, device=self.device)}
        params["self_blocks"] = {
            "attn": A.init_attention(gen, cfg, dt, (G, E)),
            "mlp": BL.init_mlp(gen, D, F_, dt, (G, E)),
            "ln1": ones(G, E, D), "ln2": ones(G, E, D)}
        return params

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        G, E = vlm_layout(cfg)
        B, KV, hd = batch_size, cfg.n_kv_heads, cfg.hd
        zeros = lambda *shape: torch.zeros(shape, dtype=cfg.dtype,
                                           device=self.device)
        return {"k": zeros(G, E, B, max_len, KV, hd),
                "v": zeros(G, E, B, max_len, KV, hd),
                "img_k": zeros(G, B, cfg.n_image_tokens, KV, hd),
                "img_v": zeros(G, B, cfg.n_image_tokens, KV, hd),
                "len": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _images(self, img_embeds, B: int) -> torch.Tensor:
        """The image embeddings (B, n_image_tokens, D) in ``cfg.dtype`` on
        this LM's device; zeros when ``img_embeds`` is None."""
        cfg = self.cfg
        if img_embeds is None:
            return torch.zeros((B, cfg.n_image_tokens, cfg.d_model),
                               dtype=cfg.dtype, device=self.device)
        return torch.as_tensor(img_embeds, device=self.device).to(cfg.dtype)

    def _img_kv(self, cross, img):
        """A cross block's image K/V, each (B, n_image_tokens, KV, hd): the
        embeddings through wk and wv, with no norm and no RoPE."""
        return A.heads(img, cross["attn"]["wk"]), \
            A.heads(img, cross["attn"]["wv"])

    def _cross_block(self, x, blk, img_kv, cache=None):
        """x + tanh(gate) * cross-attention, then x + MLP. The gate is cast
        to x's dtype before the tanh, as in the reference. ``cache`` as
        :func:`~repro_torch.models.attention.attention_sublayer` takes it
        with ``kv_override``: None, or a decode step's image lengths."""
        cfg = self.cfg
        h, _ = A.attention_sublayer(rms_norm(x, blk["ln1"], cfg.norm_eps),
                                    blk["attn"], cfg, None, cache=cache,
                                    kv_override=img_kv)
        x = x + torch.tanh(blk["gate"].to(x.dtype)) * h
        return x + self._ffn(rms_norm(x, blk["ln2"], cfg.norm_eps), blk)

    def forward(self, params, tokens, img_embeds=None) -> torch.Tensor:
        """tokens (B, S) and image embeddings (B, n_image_tokens, D) or None
        -> logits (B, S, V) in ``cfg.dtype``; differentiable as
        :meth:`LM.forward` is. Under remat "full" or "dots" each group (its
        cross block and its self blocks) is one checkpoint, as in the
        reference."""
        cfg = self.cfg
        _check_remat(cfg)
        G, E = vlm_layout(cfg)
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        img = self._images(img_embeds, B)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)

        def group(x, cross, selfs):
            x = self._cross_block(x, cross, self._img_kv(cross, img))
            for blk in _layers(selfs, E):
                x = self._train_block(x, blk, rope)
            return x

        for cross, selfs in zip(_layers(params["cross_blocks"], G),
                                _layers(params["self_blocks"], G)):
            x = remat(cfg, group, x, cross, selfs)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)

    def loss(self, params, batch) -> torch.Tensor:
        """:meth:`LM.loss` with ``batch.get("image_embeds")`` as the
        image embeddings, as in the reference."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        logits = self.forward(params, tokens[:, :-1],
                              batch.get("image_embeds"))
        return _nll(logits, tokens[:, 1:])

    def prefill(self, params, tokens, img_embeds=None,
                max_len: Optional[int] = None, last_pos=None):
        """Run the prompt (B, S) over the image embeddings (zeros when
        None) and build the decode cache: each self block's K/V and each
        group's image K/V. Returns (logits (B, 1, V), cache); ``last_pos``
        as in :meth:`LM.prefill` (the cache then has (B,) lengths, which
        :meth:`decode_step` refuses, as the reference's does)."""
        cfg = self.cfg
        G, E = vlm_layout(cfg)
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        max_len = max_len or S + 1
        if max_len < S:
            raise ValueError(f"max_len={max_len} is shorter than the "
                             f"prompt ({S})")
        img = self._images(img_embeds, B)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        cache = self.init_cache(B, max_len)
        for g in range(G):
            cross = _layer(params["cross_blocks"], g)
            img_k, img_v = self._img_kv(cross, img)
            cache["img_k"][g] = img_k
            cache["img_v"][g] = img_v
            x = self._cross_block(x, cross, (img_k, img_v))
            selfs = _layer(params["self_blocks"], g)
            for j in range(E):
                x, (k, v) = self._dense_block(x, _layer(selfs, j), rope)
                cache["k"][g, j, :, :S] = k
                cache["v"][g, j, :, :S] = v
        return self._prefill_logits(params, x, cache, last_pos)

    def decode_step(self, params, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V), cache): each group's cross
        block over its cached image K/V (B3, every row over all
        n_image_tokens rows), then its self blocks, whose K/V rows are
        written into the cache in place; the cache is returned with ``len
        + 1``. ``cache["len"]`` must be a scalar."""
        cfg = self.cfg
        ln = cache["len"]
        if ln.dim() == 1:
            raise ValueError(
                f"per-sequence cache lengths are not supported for family "
                f"{cfg.family!r} (recurrent/grouped state has no per-row "
                f"append position)")
        G, E = vlm_layout(cfg)
        x = self._embed(params, tokens)
        B = x.shape[0]
        rope = rope_cos_sin(ln.expand(B, 1), cfg.hd, cfg.rope_theta)
        at, attend = A.decode_rows(ln, B, cache["k"].shape[3])
        images = {"attend": torch.full((B,), cache["img_k"].shape[2],
                                       dtype=torch.int32, device=self.device)}
        for g in range(G):
            x = self._cross_block(x, _layer(params["cross_blocks"], g),
                                  (cache["img_k"][g], cache["img_v"][g]),
                                  cache=images)
            selfs = _layer(params["self_blocks"], g)
            for j in range(E):
                x, _ = self._dense_block(
                    x, _layer(selfs, j), rope,
                    cache={"k": cache["k"][g, j], "v": cache["v"][g, j],
                           "at": at, "attend": attend})
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), {**cache, "len": ln + 1}


class HybridLM(LM):
    """zamba2 hybrid LM: Mamba2 blocks in ``n_groups`` groups of
    ``attn_every``, ONE shared attention+MLP block (its weights shared,
    its KV cache per group) run at the start of every group, and the
    remaining ``n_layers % attn_every`` Mamba2 blocks after the last group.

    The decode cache holds each Mamba2 block's conv rows and SSM state and
    each group's K/V; a decode step updates them in place."""

    families = ("hybrid",)

    def _layout(self):
        return hybrid_layout(self.cfg)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params in ``cfg.param_dtype`` from ``gen``, with the
        reference's shapes, keys and init scales."""
        cfg = self.cfg
        dt = cfg.param_dtype
        D = cfg.d_model
        G, E, R = self._layout()
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=self.device)
        params = self._init_embedding(gen)
        params["groups"] = {"m": BL.init_mamba2(gen, cfg, dt, (G, E)),
                            "ln": ones(G, E, D)}
        if R:
            params["rem"] = {"m": BL.init_mamba2(gen, cfg, dt, (R,)),
                             "ln": ones(R, D)}
        params["shared_attn"] = {
            "attn": A.init_attention(gen, cfg, dt, None),
            "mlp": BL.init_mlp(gen, D, cfg.d_ff, dt, None),
            "ln": ones(D), "ln2": ones(D)}
        return params

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        G, E, R = self._layout()
        B, d_in = batch_size, cfg.ssm_expand * cfg.d_model
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        H = d_in // P
        kv = (G, B, max_len, cfg.n_kv_heads, cfg.hd)
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
        cache = {"conv": zeros((G, E, B, BL.CONV_K - 1, d_in), cfg.dtype),
                 "ssm": zeros((G, E, B, H, P, N), torch.float32),
                 "attn_k": zeros(kv, cfg.dtype), "attn_v": zeros(kv, cfg.dtype),
                 "len": zeros((), torch.int32)}
        if R:
            cache["rem_conv"] = zeros((R, B, BL.CONV_K - 1, d_in), cfg.dtype)
            cache["rem_ssm"] = zeros((R, B, H, P, N), torch.float32)
        return cache

    @staticmethod
    def _shared(params) -> Dict[str, Any]:
        """The shared block's params under the dense block's keys."""
        s = params["shared_attn"]
        return {"attn": s["attn"], "mlp": s["mlp"], "ln1": s["ln"],
                "ln2": s["ln2"]}

    def _mamba_block(self, x, blk, state=None):
        out, st = BL.mamba2_mix(rms_norm(x, blk["ln"], self.cfg.norm_eps),
                                blk["m"], self.cfg, state=state)
        return x + out, st

    def _train_mamba(self, x, blk):
        return self._mamba_block(x, blk)[0]

    def forward(self, params, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``; differentiable
        as :meth:`LM.forward` is. Under remat "full" or "dots" each group
        (the shared block and its Mamba2 blocks) and each remainder block is
        one checkpoint, as in the reference."""
        cfg = self.cfg
        _check_remat(cfg)
        G, E, R = self._layout()
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        shared = self._shared(params)

        def group(x, gp):
            x = self._dense_block(x, shared, rope)[0]
            for blk in _layers(gp, E):
                x = self._train_mamba(x, blk)
            return x

        steps = [(group, gp) for gp in _layers(params["groups"], G)]
        if R:
            steps += [(self._train_mamba, blk)
                      for blk in _layers(params["rem"], R)]
        for fn, p in steps:
            x = remat(cfg, fn, x, p)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)

    def prefill(self, params, tokens, max_len: Optional[int] = None,
                last_pos=None):
        """Run the prompt (B, S) and build the decode cache: each group's
        K/V, each Mamba2 block's conv rows and final SSM state. Returns
        (logits (B, 1, V), cache); ``last_pos`` as in :meth:`LM.prefill`.
        A prompt shorter than the conv's 3 rows of history is refused."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        max_len = max_len or S + 1
        if max_len < S:
            raise ValueError(f"max_len={max_len} is shorter than the "
                             f"prompt ({S})")
        if S < BL.CONV_K - 1:
            raise ValueError(
                f"a prompt of {S} tokens leaves the Mamba2 blocks no conv "
                f"state: the hybrid family prefills {BL.CONV_K - 1} tokens "
                f"or more")
        G, E, R = self._layout()
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        cache = self.init_cache(B, max_len)
        shared = self._shared(params)
        for g in range(G):
            x, (k, v) = self._dense_block(x, shared, rope)
            cache["attn_k"][g, :, :S] = k
            cache["attn_v"][g, :, :S] = v
            group = _layer(params["groups"], g)
            for j in range(E):
                x, st = self._mamba_block(x, _layer(group, j))
                cache["conv"][g, j] = st["conv"]
                cache["ssm"][g, j] = st["ssm"]
        for r in range(R):
            x, st = self._mamba_block(x, _layer(params["rem"], r))
            cache["rem_conv"][r] = st["conv"]
            cache["rem_ssm"][r] = st["ssm"]
        return self._prefill_logits(params, x, cache, last_pos)

    def decode_step(self, params, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V), cache), the cache updated in
        place and returned with ``len + 1``. ``cache["len"]`` must be a
        scalar: the recurrent state has no per-row append position."""
        cfg = self.cfg
        ln = cache["len"]
        if ln.dim() == 1:
            raise ValueError(
                f"per-sequence cache lengths are not supported for family "
                f"{cfg.family!r} (recurrent/grouped state has no per-row "
                f"append position)")
        x = self._embed(params, tokens)
        B = x.shape[0]
        rope = rope_cos_sin(ln.expand(B, 1), cfg.hd, cfg.rope_theta)
        at, attend = A.decode_rows(ln, B, cache["attn_k"].shape[2])
        G, E, R = self._layout()
        shared = self._shared(params)
        for g in range(G):
            x, _ = self._dense_block(
                x, shared, rope,
                cache={"k": cache["attn_k"][g], "v": cache["attn_v"][g],
                       "at": at, "attend": attend})
            group = _layer(params["groups"], g)
            for j in range(E):
                x = self._decode_mamba(x, _layer(group, j),
                                       cache["conv"][g, j], cache["ssm"][g, j])
        for r in range(R):
            x = self._decode_mamba(x, _layer(params["rem"], r),
                                   cache["rem_conv"][r], cache["rem_ssm"][r])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), {**cache, "len": ln + 1}

    def _decode_mamba(self, x, blk, conv, ssm):
        """One Mamba2 block of a decode step; its conv rows and SSM state
        are written back into the cache slices ``conv`` and ``ssm``."""
        x, st = self._mamba_block(x, blk, state={"conv": conv, "ssm": ssm})
        conv.copy_(st["conv"])
        ssm.copy_(st["ssm"])
        return x


class RwkvLM(LM):
    """RWKV6 ("Finch") LM: attention-free blocks, each a time mix (the RWKV6
    scan) and a channel mix, each after its own RMSNorm.

    The decode cache holds each block's token-shift rows (``shift`` and
    ``shift_ffn``, the last normed input of each mix) and its float32
    ``wkv`` state; a decode step updates them in place. The prefill keeps
    the state after the prompt's last step at any prompt length, where the
    reference's plain prefill pads the prompt to whole 64-step chunks and
    so leaves ``wkv`` at zero unless the length is a multiple of 64
    (ROADMAP C7): its decode continues what :meth:`forward` computes."""

    families = ("rwkv6",)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params in ``cfg.param_dtype`` from ``gen``, with the
        reference's shapes, keys and init scales."""
        cfg = self.cfg
        dt = cfg.param_dtype
        D, L = cfg.d_model, cfg.n_layers
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=self.device)
        params = self._init_embedding(gen)
        params["blocks"] = {"tm": BL.init_rwkv6(gen, cfg, dt, (L,)),
                            "ln1": ones(L, D), "ln2": ones(L, D)}
        return params

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """The recurrent state holds no sequence axis: ``max_len`` is not
        used."""
        cfg = self.cfg
        L, B, D, N = cfg.n_layers, batch_size, cfg.d_model, cfg.rwkv_head_dim
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
        return {"shift": zeros((L, B, D), cfg.dtype),
                "shift_ffn": zeros((L, B, D), cfg.dtype),
                "wkv": zeros((L, B, D // N, N, N), torch.float32),
                "len": zeros((), torch.int32)}

    def _rwkv_block(self, x, blk, state=None):
        """One block: (x after it, its new state {"shift", "wkv",
        "shift_ffn"})."""
        cfg = self.cfg
        h, st_t = BL.rwkv6_time_mix(rms_norm(x, blk["ln1"], cfg.norm_eps),
                                    blk["tm"], cfg, state=state)
        x = x + h
        h, st_c = BL.rwkv6_channel_mix(rms_norm(x, blk["ln2"], cfg.norm_eps),
                                       blk["tm"], cfg, state=state)
        return x + h, {**st_t, **st_c}

    def _train_rwkv(self, x, blk):
        return self._rwkv_block(x, blk)[0]

    def forward(self, params, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``; differentiable
        as :meth:`LM.forward` is. Under remat "full" or "dots" each block is
        one checkpoint, as in the reference."""
        cfg = self.cfg
        _check_remat(cfg)
        x = self._embed(params, tokens)
        for blk in _layers(params["blocks"], cfg.n_layers):
            x = remat(cfg, self._train_rwkv, x, blk)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)

    def prefill(self, params, tokens, max_len: Optional[int] = None,
                last_pos=None):
        """Run the prompt (B, S) and build the decode cache: each block's
        token-shift rows and its state after step S. Returns (logits (B, 1,
        V), cache); ``last_pos`` as in :meth:`LM.prefill`."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        max_len = max_len or S + 1
        if max_len < S:
            raise ValueError(f"max_len={max_len} is shorter than the "
                             f"prompt ({S})")
        cache = self.init_cache(B, max_len)
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            x, st = self._rwkv_block(x, _layer(blocks, i))
            for key in ("shift", "shift_ffn", "wkv"):
                cache[key][i] = st[key]
        return self._prefill_logits(params, x, cache, last_pos)

    def decode_step(self, params, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V), cache), the cache updated in
        place and returned with ``len + 1``. ``cache["len"]`` must be a
        scalar: the recurrent state has no per-row append position."""
        cfg = self.cfg
        ln = cache["len"]
        if ln.dim() == 1:
            raise ValueError(
                f"per-sequence cache lengths are not supported for family "
                f"{cfg.family!r} (recurrent/grouped state has no per-row "
                f"append position)")
        x = self._embed(params, tokens)
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            state = {key: cache[key][i] for key in ("shift", "shift_ffn",
                                                    "wkv")}
            x, st = self._rwkv_block(x, _layer(blocks, i), state=state)
            for key, slot in state.items():
                slot.copy_(st[key])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), {**cache, "len": ln + 1}


def build_model(cfg: ModelConfig, device="cuda") -> LM:
    """The port's LM class for ``cfg.family`` (dense, audio, moe, vlm,
    hybrid or rwkv6)."""
    classes = {fam: cls for cls in (LM, MoeLM, VlmLM, HybridLM, RwkvLM)
               for fam in cls.families}
    if cfg.family not in classes:
        raise ValueError(f"the port serves the dense, audio, moe, vlm, "
                         f"hybrid and rwkv6 families, not {cfg.family!r}")
    return classes[cfg.family](cfg, device=device)
