"""Step-function builders: the port's counterparts of
``repro.launch.steps``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.lm import LM, flatten, unflatten
from ..optim import AdamWConfig, adamw_update
from ..spans import span


def value_and_grad(model: LM, params: Dict[str, Any],
                   batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, grads) of ``model.loss`` at ``params``, grads with the params'
    keys. The params are differentiated through detached views that
    require grad, so the caller's tensors need not require grad and are
    left as they are."""
    items = [(path, p.detach().requires_grad_())
             for path, p in flatten(params)]
    with span("train.forward"):
        loss = model.loss(unflatten(items), batch)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, [p for _, p in items])
    return loss.detach(), unflatten(
        (path, g) for (path, _), g in zip(items, grads))


def make_train_step(model: LM, opt_cfg: AdamWConfig):
    """One train step: loss and grads, then the AdamW update, returning
    (params, opt_state, metrics) with ``loss``, ``grad_norm`` and ``lr``
    in the metrics (0-d tensors on the model's device)."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        with span("train.adamw"):
            new_params, new_state, metrics = adamw_update(
                params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss)
        return new_params, new_state, metrics
    return train_step


def make_prefill_step(model: LM, max_len: Optional[int] = None):
    """Prefill step over a token batch (plus the vlm family's image
    embeddings, ``batch.get("image_embeds")``; the other families take
    none); returns the model's (logits, cache). ``max_len`` is the decode
    cache's length; None gives the prompt's length + 1, as in the
    reference."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if model.cfg.family == "vlm":
            return model.prefill(params, batch["tokens"],
                                 img_embeds=batch.get("image_embeds"),
                                 max_len=max_len)
        return model.prefill(params, batch["tokens"], max_len=max_len)
    return prefill_step


def make_decode_step(model: LM):
    """Single-token decode step against a live KV cache; returns the
    model's (logits, cache)."""
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return serve_step
