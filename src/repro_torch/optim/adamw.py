"""AdamW with global-norm clipping, a cosine schedule and optional bfloat16
moments, written out on tensors (not ``torch.optim.AdamW``).

The port's own copy of ``repro.optim.adamw``: the same state tree
(``mu``, ``nu`` with the params' keys, and an int32 ``step``), the same
schedule and the same update, leaf by leaf in
:func:`repro_torch.models.lm.flatten` order. Nothing is updated in place:
:func:`adamw_update` returns new params and a new state, as the reference
does. Every quantity stays on the params' device, so a step makes no
host round trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..models.lm import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters and schedule shape (frozen, hashable)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: Any = torch.float32  # bfloat16 halves optimizer memory


def adamw_init(params: Dict[str, Any], cfg: AdamWConfig) -> Dict[str, Any]:
    """Zeroed optimizer state (first and second moments in
    ``cfg.moment_dtype``, with the params' keys, and a step counter)."""
    items = flatten(params)
    device = items[0][1].device

    def zeros():
        return unflatten((path, torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                            device=p.device))
                         for path, p in items)
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, Any]) -> torch.Tensor:
    """L2 norm over every leaf of ``tree`` (float32 accumulation)."""
    return torch.sqrt(sum(leaf.float().square().sum()
                          for _, leaf in flatten(tree)))


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at float32 ``step``: linear warmup to ``cfg.lr``,
    then cosine decay to 0.1 * lr at ``cfg.total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def adamw_update(params: Dict[str, Any], grads: Dict[str, Any],
                 state: Dict[str, Any], cfg: AdamWConfig):
    """One AdamW step (global-norm clip, bias correction, decoupled weight
    decay on every leaf, norms included). Returns ``(new_params,
    new_state, metrics)`` with ``grad_norm`` and ``lr`` in the metrics."""
    step = state["step"] + 1
    stepf = step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(stepf, cfg)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)

    g_of, mu_of, nu_of = (dict(flatten(t)) for t in
                          (grads, state["mu"], state["nu"]))
    new_p, new_mu, new_nu = [], [], []
    for path, p in flatten(params):
        mu, nu = mu_of[path], nu_of[path]
        g = g_of[path].float() * scale
        mu32 = mu.float() * cfg.b1 + (1 - cfg.b1) * g
        nu32 = nu.float() * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = mu32 / b1c
        vhat = nu32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p.append((path, (p.float() - lr * delta).to(p.dtype)))
        new_mu.append((path, mu32.to(mu.dtype)))
        new_nu.append((path, nu32.to(nu.dtype)))
    new_state = {"mu": unflatten(new_mu), "nu": unflatten(new_nu),
                 "step": step}
    return unflatten(new_p), new_state, {"grad_norm": gnorm, "lr": lr}
