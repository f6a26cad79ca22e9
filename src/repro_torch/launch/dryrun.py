"""Dry-run of the port's launch cells: per-device memory and FLOPs of every
(arch x input-shape x mesh) cell, from a trace on the meta device.

The port's counterpart of ``repro.launch.dryrun``. Where the reference
lowers and compiles each cell for 512 placeholder devices and reads XLA's
memory and cost analyses, this runs the cell's train, prefill or decode
step (``repro_torch.launch.steps``) on the meta device, at the per-device
batch, and accounts:

* **argument bytes** from the sharding rules, exactly: each argument
  leaf's shard bytes under ``param_specs``, ``opt_specs``, ``batch_specs``
  and ``cache_specs`` (what XLA reports as ``argument_size_in_bytes`` for
  the same sharded program);
* **temp bytes**, the peak of the live bytes that are not arguments, read
  off an event log of every storage's allocation and free
  (:class:`MemoryLog`), each allocation rounded up to the caching
  allocator's 512-byte blocks. An allocation that ends as the gradient of
  a param leaf is weighted by that leaf's shard fraction, and one the
  optimizer computes elementwise from sharded leaves takes their
  fraction; on a mesh whose axes are all 1 this is the raw peak. Outputs are
  included (``output_size_in_bytes`` gives them separately). Activations
  are not split over 'model': the port runs no tensor-parallel compute,
  so under TP this is an upper bound. The kernels' own temporaries that
  no meta kernel allocates are added where the card's kernel makes them
  (:data:`HIDDEN_WORKSPACE`);
* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over the
  traced step (backward and remat recompute included), scaled from the
  per-device batch to the global one, plus
  :func:`analytic_scan_corrections` for the attention and scan kernels,
  which the counter cannot see (the role it plays in the reference). The
  scans' backward is the plain scan differentiated, whose products the
  counter does see, so a hybrid or rwkv6 train cell counts those twice.

A set-up's peak, before any step, is traced the same way
(:func:`_init_pass`: a server's ``model.init`` drawing on meta, each
leaf's float32 draw and its casts logged).

Not carried over from the reference: ``collective_bytes`` (it parses
XLA's partitioned HLO, and the port has no partitioner), the TPU
constants and roofline terms, the unroll-and-extrapolate cost pass (the
port's layers are Python loops that the trace walks whole) and
``--scan-layers``. The dry-run is accounting for an 80 GB H100, not a run
on it: it computes nothing on any device.

    python -m repro_torch.launch.dryrun --arch A --shape S \\
        --mesh pod|multipod|both [--all] [--out F]

A cell is skipped, with its reason, where the reference skips it
(long_500k for full-attention archs), where the card's kernels would
refuse its step (a head dim outside ``HEAD_DIMS``; none of the configs
has one now that kimi-k2's 112 is in), and for the hybrid and rwkv6
train cells (their plain scan backward makes the trace take most of an
hour).
"""

from __future__ import annotations

import argparse
import json
import time
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import configs as C
from ..kernels._build import HEAD_DIMS
from ..models import build_model
from ..models.lm import flatten, serving_params
from ..optim import AdamWConfig, adamw_init, adamw_update
from . import sharding as SH
from .hook_dryrun import meta_params
from .mesh import axis_size, dp_axes, make_production_mesh
from .steps import make_decode_step, make_prefill_step, value_and_grad

#: the card the fit is judged against: an H100 with 80 GB of HBM3
HBM_BYTES = 80e9
#: the caching allocator's block: every allocation is a multiple of it
ALLOC_BLOCK = 512

_aten = torch.ops.aten
#: temporaries a CUDA kernel allocates through the caching allocator that
#: no meta kernel does, in bytes, from the op's arguments:
#: ``logsumexp`` forms ``(x - max).exp_()`` in x's dtype before its sum
HIDDEN_WORKSPACE = {
    _aten.logsumexp.default: lambda x, *a, **k: x.numel() * x.element_size(),
}


def _block(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


class MemoryLog(TorchDispatchMode):
    """An event log of the storages that the ops run under it allocate.

    Every op's output storages that are new (not arguments registered with
    :meth:`register` and not already tracked) are allocations; a weakref
    finaliser on each storage records its free. Each storage has a weight
    (default 1): a registered argument its shard fraction; a new
    allocation 1, or, while :attr:`propagate` is set (the optimizer's
    update, elementwise on sharded leaves), the least weight of its inputs
    with as many elements; :meth:`reweigh` sets it later for storages that
    turn out to be gradients. :meth:`peak` reads the weighted peak of live
    bytes off the log. (A gather or a product can share a leaf's element
    count by chance, embed's V x D with B x S x D activations, so fractions
    pass on only where every op is elementwise.)"""

    def __init__(self):
        super().__init__()
        self.size: Dict[int, int] = {}       # sid -> bytes (blocks)
        self.weight: Dict[int, float] = {}   # sid -> fraction
        self.op: Dict[int, str] = {}         # sid -> the op that made it
        self.events = []                     # (sid, +1 | -1)
        self._live: Dict[int, int] = {}      # id(storage) -> sid
        self._refs: Dict[int, weakref.ref] = {}
        self._args: Dict[int, float] = {}    # id(storage) -> fraction
        self._arg_refs = []
        self.propagate = False

    def register(self, tensors, fraction: float = 1.0) -> None:
        """Mark ``tensors``' storages as arguments (never allocations)."""
        for t in tensors:
            st = t.untyped_storage()
            self._args[id(st)] = fraction
            self._arg_refs.append(st)

    def _weight_of(self, t) -> float:
        key = id(t.untyped_storage())
        if key in self._args:
            return self._args[key]
        sid = self._live.get(key)
        return 1.0 if sid is None else self.weight[sid]

    def _free(self, key: int, sid: int) -> None:
        self.events.append((sid, -1))
        self._live.pop(key, None)
        self._refs.pop(key, None)

    def _track(self, st, weight: float, op) -> None:
        key = id(st)
        if key in self._args or key in self._live:
            return
        sid = len(self.size)
        self.size[sid] = _block(st.nbytes())
        self.weight[sid] = weight
        self.op[sid] = str(op)
        self.events.append((sid, +1))
        self._live[key] = sid
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, sid=sid: self._free(key, sid))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        hidden = HIDDEN_WORKSPACE.get(func)
        if hidden is not None:   # the kernel's temporary, live during it
            sid = len(self.size)
            self.size[sid] = _block(hidden(*args, **kwargs))
            self.weight[sid] = 1.0
            self.op[sid] = f"{func} (workspace)"
            self.events.append((sid, +1))
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            w = min((self._weight_of(i) for i in ins
                     if i.numel() == t.numel()), default=1.0) \
                if self.propagate else 1.0
            self._track(t.untyped_storage(), min(w, 1.0), func)
        if hidden is not None:   # freed after the output is made
            self.events.append((sid, -1))
        return out

    def storage_ids(self, tensors):
        """The sids of ``tensors``' tracked storages (None where a tensor's
        storage is an argument or untracked)."""
        return [self._live.get(id(t.untyped_storage())) for t in tensors]

    def reweigh(self, tensor, fraction: float) -> None:
        """Weigh ``tensor``'s storage (a gradient) by ``fraction``, where it
        is a tracked allocation of the tensor's own size."""
        sid = self._live.get(id(tensor.untyped_storage()))
        nbytes = tensor.numel() * tensor.element_size()
        if sid is not None and self.size[sid] == _block(nbytes):
            self.weight[sid] = fraction

    def peak(self) -> int:
        """The weighted peak of live allocated bytes over the log."""
        return int(round(self.at_peak()[0]))

    def at_peak(self):
        """(weighted peak bytes, {sid: weighted bytes} live at the peak)."""
        live, top, at = 0.0, 0.0, 0
        for i, (sid, sign) in enumerate(self.events):
            live += sign * self.size[sid] * self.weight[sid]
            if live > top:
                top, at = live, i + 1
        alive = {}
        for sid, sign in self.events[:at]:
            if sign > 0:
                alive[sid] = self.size[sid] * self.weight[sid]
            else:
                alive.pop(sid, None)
        return top, alive

    def breakdown(self, n: int = 8):
        """The ops whose allocations hold the most bytes at the peak:
        [(op, bytes, count)], largest first."""
        by_op: Dict[str, list] = {}
        for sid, b in self.at_peak()[1].items():
            e = by_op.setdefault(self.op[sid], [0.0, 0])
            e[0] += b
            e[1] += 1
        rows = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:n]
        return [(op, int(round(b)), c) for op, (b, c) in rows]


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def cell_config(arch: str, **overrides):
    """Full config for the dry-run: bf16 params (+bf16 moments via the
    optimizer config), remat "full" — the production numerics for the
    giant models."""
    base = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                remat="full")
    base.update(overrides)
    return C.get_config(arch, **base)


def analytic_scan_corrections(cfg, shape: C.Shape) -> float:
    """Closed-form FLOPs of the inner scans (per full model), to ADD to the
    counted FLOPs. Factors: fwd attention = 2 matmuls; train = fwd + remat
    recompute + 5-matmul flash bwd = 18 matmul-halves."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return 0.0  # decode paths have no inner scans
    train = shape.kind == "train"
    total = 0.0
    H, hd = cfg.n_heads, cfg.hd
    attn_unit = 2.0 * B * H * hd * float(S) * float(S)  # one S x S matmul
    attn_factor = 9.0 if train else 2.0                 # in units of 2BHS^2hd
    if cfg.family in ("dense", "audio", "moe"):
        total += cfg.n_layers * attn_factor * attn_unit
    elif cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_groups
        total += n_self * attn_factor * attn_unit
        cross_unit = 2.0 * B * H * hd * float(S) * float(cfg.n_image_tokens)
        total += n_groups * attn_factor * cross_unit
    elif cfg.family == "rwkv6":
        N = cfg.rwkv_head_dim
        Hr = cfg.d_model // N
        per_step = 10.0 * B * Hr * N * N
        factor = 4.0 if train else 1.0
        total += cfg.n_layers * factor * per_step * S
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        Hm = d_in // cfg.ssm_head_dim
        per_step = 8.0 * B * Hm * cfg.ssm_head_dim * cfg.ssm_state
        factor = 4.0 if train else 1.0
        total += cfg.n_layers * factor * per_step * S
        n_groups = cfg.n_layers // max(cfg.attn_every, 1)
        total += n_groups * attn_factor * attn_unit
    return total


def input_sds(cfg, shape: C.Shape, model,
              batch_size: Optional[int] = None) -> Tuple[Dict, Optional[Dict]]:
    """Meta stand-ins for every model input (no allocation), at
    ``batch_size`` rows (default the shape's global batch): the batch, and
    for decode the cache of ``shape.seq_len`` rows (None otherwise)."""
    B = shape.global_batch if batch_size is None else batch_size
    S = shape.seq_len

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": empty(B, S + 1 if shape.kind == "train" else S)}
        if cfg.family == "vlm":
            batch["image_embeds"] = empty(B, cfg.n_image_tokens, cfg.d_model,
                                          dtype=torch.bfloat16)
        return batch, None
    # decode: one new token with a KV cache of seq_len
    return {"tokens": empty(B, 1)}, model.init_cache(B, S)


def per_device_batch(mesh, batch_size: int, kind: str) -> int:
    """The rows one device takes: the batch over the DP axes where that
    divides (and, for a decode cache, the batch is above 1), else the whole
    batch, as ``batch_specs`` and ``cache_specs`` decide."""
    n = axis_size(mesh, dp_axes(mesh))
    ok = batch_size % n == 0 and (kind != "decode" or batch_size > 1)
    return batch_size // n if ok else batch_size


def _fractions(tree, specs, mesh) -> Dict[str, float]:
    """path -> the share of a leaf one device holds under its spec."""
    out = {}
    spec_of = dict(flatten(specs)) if isinstance(specs, dict) else {}
    for path, leaf in flatten(tree):
        spec = spec_of[path]
        n = 1
        for d in SH.shard_shape(spec, leaf.shape, mesh):
            n *= d
        out[path] = n / max(leaf.numel(), 1)
    return out


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def argument_bytes(cfg, shape: C.Shape, mesh,
                   opt_cfg: Optional[AdamWConfig] = None,
                   params: Optional[Dict] = None) -> int:
    """One device's bytes of the step's arguments, from the sharding rules:
    the params under ``param_specs``; for train the AdamW state under
    ``opt_specs`` and the batch under ``batch_specs``; for prefill the
    batch; for decode the cache of ``shape.seq_len`` rows under
    ``cache_specs`` and the new tokens over the DP axes where the cache's
    batch is (the reference's ``_compile_pass`` in_shardings)."""
    model = build_model(cfg, device="meta")
    params = meta_params(cfg) if params is None else params
    B = shape.global_batch
    pspecs = SH.param_specs(cfg, params, mesh)
    total = SH.shard_bytes(params, pspecs, mesh)
    batch, _ = input_sds(cfg, shape, model)
    if shape.kind == "decode":
        dp = dp_axes(mesh)
        ok = B % axis_size(mesh, dp) == 0 and B > 1
        bspecs = {"tokens": SH._spec(dp if ok else None, None)}
        cache = model.init_cache(B, shape.seq_len)
        total += SH.shard_bytes(cache, SH.cache_specs(cfg, cache, mesh, B),
                                mesh)
    else:
        bspecs = SH.batch_specs(cfg, mesh, B)
    total += SH.shard_bytes(batch, {k: bspecs[k] for k in batch}, mesh)
    if shape.kind == "train":
        opt_state = adamw_init(params, opt_cfg or AdamWConfig(
            moment_dtype=torch.bfloat16))
        total += SH.shard_bytes(opt_state, SH.opt_specs(
            cfg, opt_state, pspecs, mesh), mesh)
    return total


def _trace_pass(cfg, shape: C.Shape, mesh,
                opt_cfg: Optional[AdamWConfig] = None,
                params: Optional[Dict] = None) -> Dict:
    """Trace one cell's step (``launch/steps.py``: the train step's
    ``value_and_grad`` then ``adamw_update``, as ``make_train_step`` runs
    them; the prefill or decode step) on the meta device; return its memory
    (argument, output and temp bytes a device), the counted FLOPs at the
    per-device batch, the per-device batch, the ops whose allocations hold
    the most at the peak and the trace's seconds.

    ``params`` (meta tensors) replaces the tree built from ``cfg``'s param
    shapes in ``cfg.param_dtype``, so a caller can trace the exact tree it
    runs (serving casts some leaves)."""
    t0 = time.time()
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=torch.bfloat16)
    model = build_model(cfg, device="meta")
    params = meta_params(cfg) if params is None else params
    arg_bytes = argument_bytes(cfg, shape, mesh, opt_cfg, params)
    b_dev = per_device_batch(mesh, shape.global_batch, shape.kind)
    frac = _fractions(params, SH.param_specs(cfg, params, mesh), mesh)
    batch, cache = input_sds(cfg, shape, model, batch_size=b_dev)
    log = MemoryLog()
    for path, t in flatten(params):
        log.register([t], frac[path])
    log.register(_tensors(batch))
    fc = FlopCounterMode(display=False)
    if shape.kind == "train":
        opt_state = adamw_init(params, opt_cfg)
        for name in ("mu", "nu"):
            for path, t in flatten(opt_state[name]):
                log.register([t], frac[path])
        log.register([opt_state["step"]])
        # make_train_step's two halves, the gradients weighed between them
        with fc, log:
            loss, grads = value_and_grad(model, params, batch)
            for path, g in flatten(grads):
                log.reweigh(g, frac[path])
            log.propagate = True
            new_p, new_s, metrics = adamw_update(params, grads, opt_state,
                                                 opt_cfg)
            del grads
            out = (new_p, new_s, dict(metrics, loss=loss))
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        with fc, log:
            out = step(params, batch)
    else:
        log.register(_tensors(cache))
        step = make_decode_step(model)
        with fc, log:
            out = step(params, cache, batch["tokens"])
    out_sids = {s for s in log.storage_ids(_tensors(out)) if s is not None}
    out_bytes = sum(log.size[s] * log.weight[s] for s in out_sids)
    return {"memory": {"argument_size_in_bytes": int(arg_bytes),
                       "output_size_in_bytes": int(round(out_bytes)),
                       "temp_size_in_bytes": log.peak()},
            "flops_per_device": float(fc.get_total_flops()),
            "per_device_batch": b_dev,
            "peak_by_op": log.breakdown(),
            "trace_s": round(time.time() - t0, 2)}


class MetaGenerator(torch.Generator):
    """A generator that reports the meta device, so ``model.init(gen)``
    draws its params there (a meta draw reads no numbers from it)."""

    @property
    def device(self):
        return torch.device("meta")


def _init_pass(cfg) -> Dict:
    """Trace a server's set-up of ``cfg`` on the meta device under a
    MemoryLog: ``model.init`` (each leaf drawn in float32 and scaled before
    its cast, so the draw's temporaries show), then ``serving_params``'
    casts with the drawn tree still alive, as ``ServeEngine`` takes it.
    Returns the peak bytes, the served params (meta tensors) and the ops
    whose allocations hold the most at the peak."""
    model = build_model(cfg, device="meta")
    log = MemoryLog()
    with log:
        params = serving_params(model.init(MetaGenerator()), cfg, "meta")
    return {"peak_bytes": log.peak(), "params": params,
            "peak_by_op": log.breakdown()}


def traceable(cfg, shape: C.Shape):
    """(whether the cell's step can be traced, why not): the attention
    kernels refuse a head dim outside theirs, as the card would; a train
    step of a scan family runs the plain scan's backward one time step at
    a time, ~20 ms a step and layer on the meta device, so at 4096 tokens
    its trace would take most of an hour."""
    if cfg.family != "rwkv6" and cfg.hd not in HEAD_DIMS:
        return False, (f"head dim {cfg.hd}: the attention kernels take "
                       f"{HEAD_DIMS}, so the card refuses the step")
    if shape.kind == "train" and cfg.family in ("hybrid", "rwkv6"):
        return False, (f"the plain scan backward steps through "
                       f"{shape.seq_len} tokens one at a time on meta (~20 "
                       f"ms a token and layer): not traced")
    return True, ""


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_overrides: Optional[dict] = None,
             cfg_overrides: Optional[dict] = None,
             verbose: bool = True) -> Dict:
    """One dry-run cell: the meta trace of its step at full depth on the
    production mesh (memory and counted FLOPs), the scan corrections, and
    the model FLOPs (6ND train, 2ND otherwise)."""
    shape = C.SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    ok, why = C.shape_applicable(arch, shape_name)
    cfg = cell_config(arch, **(cfg_overrides or {}))
    if ok:
        ok, why = traceable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": True, "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "n_chips": mesh.size, "skipped": False,
              "params": int(cfg.param_count()),
              "active_params": int(cfg.active_param_count())}
    opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16,
                          **(opt_overrides or {}))
    traced = _trace_pass(cfg, shape, mesh, opt_cfg)
    result["trace_s"] = traced["trace_s"]
    result["per_device_batch"] = traced["per_device_batch"]
    result["memory"] = traced["memory"]
    mem = result["memory"]
    result["bytes_per_device"] = int(mem["argument_size_in_bytes"]
                                     + mem["temp_size_in_bytes"])
    result["fits_80gb_hbm"] = bool(result["bytes_per_device"] < HBM_BYTES)
    scale = shape.global_batch / traced["per_device_batch"]
    correction = analytic_scan_corrections(cfg, shape)
    result["flops_counted_per_device"] = traced["flops_per_device"]
    result["scan_correction_flops"] = correction
    result["flops"] = traced["flops_per_device"] * scale + correction
    n_tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    per_token = 6.0 if shape.kind == "train" else 2.0
    result["model_flops"] = per_token * cfg.active_param_count() * n_tokens
    result["useful_flops_ratio"] = (
        result["model_flops"] / result["flops"] if result["flops"] else 0.0)
    if verbose:
        print(json.dumps(result, indent=2, default=str), flush=True)
    return result


def main(argv=None) -> None:
    """CLI entry point: one (arch x shape x mesh) cell, or ``--all`` for
    every cell, with a table of each cell's bytes a device and its fit."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(C.SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="write JSON results here")
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s.name) for a, s, ok, _ in C.cells(include_skipped=True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    results = []
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                res = run_cell(arch, shape_name, mp, verbose=not args.all)
            except Exception as e:
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multipod" if mp else "pod",
                       "error": f"{type(e).__name__}: {e}"}
                print(json.dumps(res), flush=True)
            results.append(res)
            if args.all and not res.get("error"):
                print(_row(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
    n_err = sum(1 for r in results if r.get("error"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"\ndry-run: {len(results)} cells, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if n_err:
        raise SystemExit(1)


def _row(res: Dict) -> str:
    """One table row: cell, bytes a device (GB), fit, counted FLOPs."""
    if res.get("skipped"):
        return (f"{res['arch']:28s} {res['shape']:12s} {res['mesh']:8s} "
                f"skipped: {res['reason']}")
    mem = res["memory"]
    return (f"{res['arch']:28s} {res['shape']:12s} {res['mesh']:8s} "
            f"args {mem['argument_size_in_bytes'] / 1e9:9.3f} GB  temp "
            f"{mem['temp_size_in_bytes'] / 1e9:9.3f} GB  total "
            f"{res['bytes_per_device'] / 1e9:9.3f} GB  fits_80gb "
            f"{res['fits_80gb_hbm']!s:5s}  flops {res['flops']:.4g}  "
            f"useful {res['useful_flops_ratio']:.3f}  ({res['trace_s']} s)")


if __name__ == "__main__":
    main()
