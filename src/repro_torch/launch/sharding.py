"""Sharding rules of the port: parameter, optimizer, batch and cache specs.

The port's own copy of ``repro.launch.sharding``'s rules (see DESIGN.md
§4):

  * DP over ('pod','data') for batch dims,
  * FSDP parameter sharding over 'data' (the d_model-ish axis),
  * TP over 'model' (attention heads / ffn / vocab / experts),
  * EP: expert dim over 'model',
  * SP: decode KV caches shard the sequence axis over 'model'
    (long-context serving),
  * divisibility-checked: a rule only applies if the dim divides evenly,
    otherwise that dim is replicated (e.g. 4 KV heads on a 16-way model
    axis -> heads replicated, hd sharded instead where possible).

The rules apply to the port's trees: nested dicts whose
:func:`~repro_torch.models.lm.flatten` paths are the reference's key
paths, with real or meta tensors as leaves (anything with a ``.shape``).
A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names, or None, with a one-name tuple written as the name, as a
``PartitionSpec`` normalises its entries. In place of the reference's
``to_named``, :func:`to_placements` gives the DTensor placements of a
spec, :func:`shard_shape` a shard's shape and :func:`distribute` a tree
of DTensors.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ..models.common import ModelConfig
from ..models.lm import flatten
from .mesh import axis_size, dp_axes, mesh_of

# base rules keyed by parameter leaf name: spec for the TRAILING dims
# (leading stacked layer/group dims are padded with None automatically)
_RULES: Dict[str, Tuple] = {
    # embeddings / head. Embed shards d_model over 'model', NOT vocab.
    "embed": (None, "model"),              # (V, D)
    "lm_head": ("data", "model"),          # (D, V)
    "final_norm": (None,),
    # attention
    "wq": ("data", "model", None),         # (D, H, hd)
    "wk": ("data", "model", None),         # (D, KV, hd)
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),         # (H, hd, D)
    # dense mlp
    "w_gate": ("data", "model"),           # (D, F)
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),           # (F, D)
    # moe (experts over model = EP; FSDP over data on d_model)
    "router": ("data", None),              # (D, E)
    # rwkv6
    "wr": ("data", "model", None),
    "wg": ("data", "model", None),
    "ww": ("data", "model", None),
    "w0": (None, None),
    "u": (None, None),
    "ln_x": (None,),
    "w_k": ("data", "model"),
    "w_v": ("model", "data"),
    "w_r": ("data", "model"),
    # mamba2
    "w_in": ("data", "model"),             # (D, E)
    "w_out": ("model", "data"),            # (d_in, D)
    "w_conv": (None, "model"),             # (4, d_in)
    "dt_bias": (None,),
    "a_log": (None,),
    "d_skip": ("model",),
    "gate": (None,),
    # norms
    "ln": (None,), "ln1": (None,), "ln2": (None,),
    # misc vectors
    "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_g": (None,),
    "mu_w": (None,), "mu_ck": (None,), "mu_cr": (None,),
}

# MoE expert tensors get EP over 'model' on the expert dim instead of the
# dense-mlp rule (they are rank-3: (E, D, F) / (E, F, D))
_MOE_RULES = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}

# FSDP placement: "data" = pod-local FSDP (params replicated across pods;
# only gradients cross pods), or ("pod", "data") = global FSDP.
FSDP_AXES: Tuple = ("data",)


def _entry(ax):
    """A spec entry as a ``PartitionSpec`` holds it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        if not ax:
            return None
        return ax[0] if len(ax) == 1 else ax
    return ax


def _spec(*entries) -> Tuple:
    return tuple(_entry(e) for e in entries)


def _map(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, ``path`` the
    tuple of dict keys down to it."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _fit(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Pad leading Nones for stacked dims; drop axes that don't divide."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax == "data":
            ax = FSDP_AXES if len(FSDP_AXES) > 1 else FSDP_AXES[0]
        if ax is None:
            fixed.append(None)
        elif dim % axis_size(mesh, ax) == 0:
            fixed.append(ax)
        else:
            fixed.append(None)  # replicate non-divisible dims
    return _spec(*fixed)


def param_specs(cfg: ModelConfig, params, mesh):
    """Spec tree matching a params tree (real or meta leaves)."""

    def rule(path, leaf):
        moe = "moe" in path
        name = path[-1]
        spec = (_MOE_RULES if moe and name in _MOE_RULES else _RULES).get(
            name)
        if spec is None:
            spec = (None,) * len(leaf.shape)
        return _fit(spec, tuple(leaf.shape), mesh)

    return _map(rule, params)


def opt_specs(cfg: ModelConfig, opt_state, params_spec, mesh):
    """Optimizer moments inherit the parameter shardings; ``step`` is
    replicated."""

    def rule(path, leaf):
        if path[0] == "step":
            return ()
        sub = params_spec
        for key in path[1:]:   # strip the leading "mu" / "nu"
            sub = sub[key]
        return sub

    return _map(rule, opt_state)


def batch_specs(cfg: ModelConfig, mesh, batch_size: int) -> Dict[str, Tuple]:
    """Input-batch shardings: batch dim over the DP axes (replicated
    when ``batch_size`` does not divide), sequence dim replicated."""
    dp = dp_axes(mesh)
    dp = dp if batch_size % axis_size(mesh, dp) == 0 else ()
    specs = {"tokens": _spec(dp or None, None)}
    if cfg.family == "vlm":
        specs["image_embeds"] = _spec(dp or None, None, None)
    return specs


def cache_specs(cfg: ModelConfig, cache, mesh, batch_size: int):
    """Decode-cache shardings: batch over DP axes; the cache SEQUENCE axis
    shards over 'model' (sequence-parallel KV for long context)."""
    dp = dp_axes(mesh)
    dp_ok = batch_size % axis_size(mesh, dp) == 0 and batch_size > 1
    bspec = dp if dp_ok else None
    model = axis_size(mesh, "model")

    def rule(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if name == "len":
            return ()
        if name in ("k", "v", "attn_k", "attn_v"):
            # (..., B, S, KV, hd): S over model
            spec[-4] = bspec
            if shape[-3] % model == 0:
                spec[-3] = "model"
        elif name in ("img_k", "img_v"):
            spec[-4] = bspec
        elif name in ("wkv", "ssm", "rem_ssm"):
            # (L, B, H, N, N) / (..., B, H, P, N): heads over model
            spec[-4] = bspec
            if shape[-3] % model == 0:
                spec[-3] = "model"
        elif name in ("conv", "rem_conv"):
            # (..., B, K-1, d_in)
            spec[-3] = bspec
            if shape[-1] % model == 0:
                spec[-1] = "model"
        elif name in ("shift", "shift_ffn"):
            spec[-2] = bspec
        return _spec(*spec)

    return _map(rule, cache)


def _dims_of(spec: Tuple, name: str):
    return [i for i, e in enumerate(spec)
            if e == name or (isinstance(e, tuple) and name in e)]


def to_placements(spec: Tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    tensor dim sharded over ``("pod", "data")`` is ``Shard(i)`` on both mesh
    dims (in mesh order, major first, as the spec's tuple orders them);
    every other mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.axis_names:
        dims = _dims_of(spec, name)
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        if isinstance(e, tuple):
            order = [mesh.axis_names.index(n) for n in e
                     if n in mesh.axis_names]
            if order != sorted(order):
                raise ValueError(f"{e} is not in the mesh's axis order "
                                 f"{mesh.axis_names}")
    return out


def shard_shape(spec: Tuple, shape, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec``."""
    shape = tuple(shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {shape}")
    out = []
    for dim, ax in zip(shape, spec):
        n = 1 if ax is None else axis_size(mesh, ax)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shards of every leaf of ``tree`` (tensors,
    real or meta) under the matching ``specs`` tree."""
    total = 0
    for (path, leaf), (_, spec) in zip(flatten(tree), flatten(specs)):
        n = 1
        for d in shard_shape(spec, leaf.shape, mesh):
            n *= d
        total += n * leaf.element_size()
    return total


def distribute(params, specs, dmesh) -> Dict[str, Any]:
    """``params`` as DTensors on the ``DeviceMesh`` ``dmesh``
    (``distribute_tensor`` of each leaf with its spec's placements)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = mesh_of(dmesh)
    spec_of = dict(flatten(specs))
    return _map(lambda path, leaf: distribute_tensor(
        leaf, dmesh, to_placements(spec_of["/".join(path)], mesh)), params)
