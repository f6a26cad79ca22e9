"""Convert params and AdamW state between the reference's numpy trees and
the port.

A reference param tree (``jax.tree_util.tree_map(np.asarray, params)``) is
a nested dict of numpy arrays. Its leaves, in ``jax.tree_util`` order, are,
for the dense and audio families, ``blocks/attn/{wk,wo,wq,wv}``,
``blocks/ln1``, ``blocks/ln2``, ``blocks/mlp/{w_down,w_gate,w_up}``, then
``embed``, ``final_norm`` and ``lm_head``; for the vlm family
``cross_blocks/{attn/*,gate,ln1,ln2,mlp/*}`` (stacked over the groups),
``embed``, ``final_norm``, ``lm_head`` and ``self_blocks/{attn/*,ln1,ln2,
mlp/*}`` (stacked over the groups and their self blocks); for the hybrid
family ``embed``, ``final_norm``, ``groups/{ln,m/*}``, ``lm_head``,
``rem/{ln,m/*}`` and ``shared_attn/{attn/*,ln,ln2,mlp/*}``; for the moe
family the dense family's with ``blocks/moe/{router,w_down,w_gate,w_up}``
(and ``blocks/moe/shared/*`` with a shared expert) in place of the MLP;
for the rwkv6 family ``blocks/{ln1,ln2}``, ``blocks/tm/*``, ``embed``,
``final_norm`` and ``lm_head``. :func:`repro_torch.models.lm.flatten`
walks the port's params in the same order.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .models.blocks import CONV_K
from .models.common import ModelConfig
from .models.lm import flatten, hybrid_layout, unflatten, vlm_layout


def _block_shapes(cfg: ModelConfig, lead: tuple, attn_mlp: bool) -> dict:
    """Shapes of one block's leaves on the leading axes ``lead``: the
    attention and MLP (``attn_mlp``) or the Mamba2 mixer."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    if attn_mlp:
        return {"attn/wk": (*lead, D, KV, hd), "attn/wo": (*lead, H, hd, D),
                "attn/wq": (*lead, D, H, hd), "attn/wv": (*lead, D, KV, hd),
                "mlp/w_down": (*lead, F, D), "mlp/w_gate": (*lead, D, F),
                "mlp/w_up": (*lead, D, F)}
    d_in = cfg.ssm_expand * D
    Hm = d_in // cfg.ssm_head_dim
    return {"m/a_log": (*lead, Hm), "m/d_skip": (*lead, d_in),
            "m/dt_bias": (*lead, Hm),
            "m/w_conv": (*lead, CONV_K, d_in),
            "m/w_in": (*lead, D, 2 * d_in + 2 * cfg.ssm_state + Hm),
            "m/w_out": (*lead, d_in, D), "ln": (*lead, D)}


def _moe_shapes(cfg: ModelConfig, L: int) -> dict:
    """Shapes of the moe family's feed-forward leaves, stacked over ``L``
    layers."""
    D, F, E, Fs = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.shared_expert_ff
    shapes = {"moe/router": (L, D, E), "moe/w_down": (L, E, F, D),
              "moe/w_gate": (L, E, D, F), "moe/w_up": (L, E, D, F)}
    if Fs:
        shapes.update({"moe/shared/w_down": (L, Fs, D),
                       "moe/shared/w_gate": (L, D, Fs),
                       "moe/shared/w_up": (L, D, Fs)})
    return shapes


def _rwkv6_shapes(cfg: ModelConfig, L: int) -> dict:
    """Shapes of the rwkv6 blocks' leaves, stacked over ``L`` layers."""
    D, F = cfg.d_model, cfg.d_ff
    N = cfg.rwkv_head_dim
    H = D // N
    tm = {"wr": (D, H, N), "wk": (D, H, N), "wv": (D, H, N),
          "wg": (D, H, N), "ww": (D, H, N), "wo": (H, N, D), "w0": (H, N),
          "u": (H, N), "ln_x": (D,), "w_k": (D, F), "w_v": (F, D),
          "w_r": (D, D)}
    tm.update((f"mu_{n}", (D,)) for n in ("r", "k", "v", "g", "w", "ck",
                                          "cr"))
    shapes = {f"tm/{k}": (L, *v) for k, v in tm.items()}
    shapes.update(ln1=(L, D), ln2=(L, D))
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """'/'-joined path -> shape of every param leaf of ``cfg``'s family
    (dense, audio, moe, vlm, hybrid or rwkv6)."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    shapes = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    blocks = {}
    if cfg.family == "hybrid":
        n_groups, every, n_rem = hybrid_layout(cfg)
        blocks["groups"] = _block_shapes(cfg, (n_groups, every), False)
        if n_rem:
            blocks["rem"] = _block_shapes(cfg, (n_rem,), False)
        blocks["shared_attn"] = dict(_block_shapes(cfg, (), True),
                                     ln=(D,), ln2=(D,))
    elif cfg.family == "rwkv6":
        blocks["blocks"] = _rwkv6_shapes(cfg, L)
    elif cfg.family == "vlm":
        G, E = vlm_layout(cfg)
        blocks["cross_blocks"] = dict(_block_shapes(cfg, (G,), True),
                                      gate=(G, 1), ln1=(G, D), ln2=(G, D))
        blocks["self_blocks"] = dict(_block_shapes(cfg, (G, E), True),
                                     ln1=(G, E, D), ln2=(G, E, D))
    elif cfg.family == "moe":
        attn = {k: v for k, v in _block_shapes(cfg, (L,), True).items()
                if k.startswith("attn/")}
        blocks["blocks"] = dict(attn, **_moe_shapes(cfg, L), ln1=(L, D),
                                ln2=(L, D))
    else:
        blocks["blocks"] = dict(_block_shapes(cfg, (L,), True),
                                ln1=(L, D), ln2=(L, D))
    for prefix, leaves in blocks.items():
        shapes.update((f"{prefix}/{k}", v) for k, v in leaves.items())
    return shapes


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The port's params from a reference tree of numpy arrays.

    Keys and shapes are checked against ``cfg``; dtypes are kept."""
    device = resolve_device(device)
    leaves = dict(flatten(tree))
    want = param_shapes(cfg)
    if set(leaves) != set(want):
        raise ValueError(f"param keys differ: missing "
                         f"{sorted(set(want) - set(leaves))}, unexpected "
                         f"{sorted(set(leaves) - set(want))}")
    out = []
    for path, shape in want.items():
        a = np.asarray(leaves[path])
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, config wants {shape}")
        out.append((path, _to_torch(a).to(device)))
    return unflatten(out)


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A nested dict of numpy arrays with the same keys, for the reference.

    numpy has no bfloat16, so bfloat16 leaves come back as float32, which
    holds them exactly."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return unflatten((path, conv(t)) for path, t in flatten(params))


def opt_state_from_jax(state: Dict[str, Any], cfg: ModelConfig,
                       device="cuda") -> Dict[str, Any]:
    """The port's AdamW state from a reference state of numpy arrays
    (``mu`` and ``nu`` trees with the params' keys, and ``step``); the
    moments keep their dtype (bfloat16 ones included)."""
    device = resolve_device(device)
    return {"mu": params_from_jax(state["mu"], cfg, device),
            "nu": params_from_jax(state["nu"], cfg, device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """A reference-shaped AdamW state of numpy arrays (bfloat16 moments come
    back as float32, which holds them exactly)."""
    return {"mu": params_to_numpy(state["mu"]),
            "nu": params_to_numpy(state["nu"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}
