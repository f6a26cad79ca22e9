"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, each number held to a limit of the cell's
(``bench/limits/<workload>.json``).

Training (the first ``check_steps`` steps of the object the window then
drives):

- ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over the steps;
- ``grad_gap``: by the worst leaf, the gap between the norm of the first
  gradient as the optimizer got it (the program's worked out from its
  first moment after one step) and the reference's clipped gradient's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
- ``update_gap``: the same for the parameters' change over the steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move under AdamW by round-off alone).

Serving: ``served_gap``, the widest gap by which a served token's logit
lies below the reference's best at the position that chose it, over the
requests checked.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch

MOVED = 1e-3    # a leaf's gradient under this share of the median leaf's


def leaf_norms(tree: Dict[str, torch.Tensor],
               scale: float = 1.0) -> Dict[str, float]:
    """Each leaf's L2 norm (in float64), times ``scale``."""
    return {k: float(v.double().norm()) * scale for k, v in tree.items()}


def worst_leaf(got: Dict[str, float], ref: Dict[str, float],
               keys: Iterable[str]) -> float:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return max(abs(got[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in keys)


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (a list), ``grad_norms``
    and ``update_norms`` (leaf norms by path); ``ref`` also ``moved``,
    the paths whose change is compared."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                   ref["grad_norms"]),
            "update_gap": worst_leaf(prog["update_norms"],
                                     ref["update_norms"], ref["moved"])}


def reference_train(ref_mod, m, P0, batches, opt, rows: int,
                    fp8: bool = False) -> dict:
    """The reference's ``train_readings`` side over the same batches from
    the same initial params."""
    with ref_mod.exact_float32():
        losses, first, P = ref_mod.train_steps(m, P0, batches, opt, rows,
                                               fp8)
        init = ref_mod.leaves(P0)
        update = {k: P[k] - init[k].float() for k in P}
        grads = leaf_norms(first)
        median = statistics.median(grads.values())
        return {"losses": losses, "grad_norms": grads,
                "update_norms": leaf_norms(update),
                "moved": [k for k, g in grads.items() if g >= MOVED * median]}


def served_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap of ``chosen`` tokens' logits below each row's best."""
    best = ref_logits.max(dim=-1).values
    picked = ref_logits.gather(-1, chosen.long()[:, None])[:, 0]
    return float((best - picked).max())


def verdict(readings: Dict[str, float],
            limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each reading beside its limit (None where the cell has none)."""
    return {k: {"value": v, "limit": limits.get(k)}
            for k, v in readings.items()}


def passed(checked: Dict[str, Dict[str, float]]) -> bool:
    return bool(checked) and all(
        c["limit"] is not None and c["value"] == c["value"]
        and c["value"] <= c["limit"] for c in checked.values())
