"""The port's launch tooling against the JAX package's: the mesh helpers,
the sharding rules (param, AdamW-state, batch and cache specs) on the
production meshes and the debug mesh for all 11 archs at full width in
bf16, each cell's per-device argument bytes, ``shard_shape`` and DTensor
placement on a one-rank gloo group.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices)
over ``jax.eval_shape`` trees; the port's on its own ``Mesh`` over meta
tensors. A spec compares entry for entry with ``tuple(PartitionSpec)``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.hook_dryrun import meta_params  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh, axis_size, device_mesh, dp_axes, make_debug_mesh,
    make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import flatten  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCHS = C.list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "debug": ((1, 1), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The trees are meta tensors: one intra-op thread is plenty, and the
    test workers would oversubscribe a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), Mesh(sizes, names)


def _j_flat(tree, is_leaf=None):
    """'/'-joined key path -> leaf of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _j_specs(tree):
    return {p: tuple(s) for p, s in _j_flat(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec)).items()}


_REF_TREES = {}


def _ref_tree(arch):
    """(reference cell config, model, params ShapeDtypeStructs), cached."""
    if arch not in _REF_TREES:
        cfg = JD.cell_config(arch)
        model = j_build(cfg)
        sds = jax.eval_shape(lambda k: model.init(k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
        _REF_TREES[arch] = (cfg, model, sds)
    return _REF_TREES[arch]


# ---------------------------------------------------------------------------
# mesh helpers (the counterparts of tests/test_launch_helpers.py)
# ---------------------------------------------------------------------------


def test_debug_mesh_axes():
    mesh = make_debug_mesh(1, 1)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape["data"] == 1 and mesh.shape["model"] == 1


def test_dp_axes_single_and_multi_pod():
    assert dp_axes(make_debug_mesh(1, 1)) == ("data",)
    assert dp_axes(make_production_mesh()) == ("data",)
    assert dp_axes(make_production_mesh(multi_pod=True)) == ("pod", "data")


def test_axis_size_contract():
    mesh = make_debug_mesh(1, 1)
    assert axis_size(mesh, "data") == 1
    assert axis_size(mesh, "model") == 1
    # absent axes count as 1, tuples multiply extents
    assert axis_size(mesh, "pod") == 1
    assert axis_size(mesh, ("pod", "data")) == 1
    assert axis_size(mesh, ()) == 1
    assert axis_size(mesh, ["data", "model"]) == 1
    big = make_production_mesh(multi_pod=True)
    assert axis_size(big, ("pod", "data")) == 32 and big.size == 512


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_abstract_mesh(name):
    jm, tm = _meshes(name)
    assert tm.axis_names == jm.axis_names
    assert dict(tm.shape) == dict(jm.shape)
    for axes in ("data", "model", "pod", ("pod", "data"), ()):
        from repro.launch.mesh import axis_size as j_axis_size
        assert axis_size(tm, axes) == j_axis_size(jm, axes)


def test_device_mesh_needs_a_live_group_of_the_mesh_size():
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(make_debug_mesh(1, 1), "cpu")


# ---------------------------------------------------------------------------
# sharding rules against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch):
    """All three meshes: every leaf's spec, and the AdamW state's (bf16
    moments, the replicated step)."""
    jcfg, _, sds = _ref_tree(arch)
    tcfg = D.cell_config(arch)
    params = meta_params(tcfg)
    assert {p: tuple(t.shape) for p, t in flatten(params)} == \
        {p: tuple(s.shape) for p, s in _j_flat(sds).items()}
    j_opt = jax.eval_shape(lambda p: j_adamw_init(
        p, JAdamWConfig(moment_dtype=jnp.bfloat16)), sds)
    t_opt = adamw_init(params, AdamWConfig(moment_dtype=torch.bfloat16))
    for name in MESHES:
        jm, tm = _meshes(name)
        jspec = JSH.param_specs(jcfg, sds, jm)
        tspec = SH.param_specs(tcfg, params, tm)
        assert dict(flatten(tspec)) == _j_specs(jspec), name
        got = dict(flatten(SH.opt_specs(tcfg, t_opt, tspec, tm)))
        want = _j_specs(JSH.opt_specs(jcfg, j_opt, jspec, jm))
        assert got == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch):
    jcfg, tcfg = JD.cell_config(arch), D.cell_config(arch)
    for name in MESHES:
        jm, tm = _meshes(name)
        for B in (1, 32, 128, 256):
            want = {k: tuple(v) for k, v in
                    JSH.batch_specs(jcfg, jm, B).items()}
            assert SH.batch_specs(tcfg, tm, B) == want, (name, B)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    """The family's cache at smoke width and at decode_32k's full shape."""
    cases = [(JC.smoke_config(arch), C.smoke_config(arch), 2, 32)]
    shape = C.SHAPES["decode_32k"]
    cases.append((JD.cell_config(arch), D.cell_config(arch),
                  shape.global_batch, shape.seq_len))
    for jcfg, tcfg, B, S in cases:
        jcache = jax.eval_shape(lambda: j_build(jcfg).init_cache(B, S))
        tcache = build_model(tcfg, device="meta").init_cache(B, S)
        assert {p: tuple(t.shape) for p, t in flatten(tcache)} == \
            {p: tuple(s.shape) for p, s in _j_flat(jcache).items()}
        for name in MESHES:
            jm, tm = _meshes(name)
            got = dict(flatten(SH.cache_specs(tcfg, tcache, tm, B)))
            want = _j_specs(JSH.cache_specs(jcfg, jcache, jm, B))
            assert got == want, (name, B, S)


def _shard_bytes(tree, specs, mesh):
    """The reference's specs' shard bytes, summed over ShapeDtypeStructs."""
    leaves = _j_flat(tree)
    total = 0
    for path, spec in _j_specs(specs).items():
        leaf = leaves[path]
        n = 1
        for dim, ax in zip(leaf.shape, spec):
            n *= dim // (1 if ax is None else
                         JD.axis_size(mesh, ax))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _ref_argument_bytes(arch, shape, jm):
    """The bytes one device holds of the reference's step arguments, as
    its ``_compile_pass`` shards them."""
    jcfg, model, sds = _ref_tree(arch)
    total = _shard_bytes(sds, JSH.param_specs(jcfg, sds, jm), jm)
    batch, cache = JD.input_sds(jcfg, shape, model)
    B = shape.global_batch
    if shape.kind == "decode":
        dp = JD.dp_axes(jm)
        ok = B % JD.axis_size(jm, dp) == 0 and B > 1
        bspecs = {"tokens": PartitionSpec(dp if ok else None, None)}
        total += _shard_bytes(cache, JSH.cache_specs(jcfg, cache, jm, B), jm)
    else:
        bspecs = JSH.batch_specs(jcfg, jm, B)
    total += _shard_bytes(batch, {k: bspecs[k] for k in batch}, jm)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: j_adamw_init(
            p, JAdamWConfig(moment_dtype=jnp.bfloat16)), sds)
        total += _shard_bytes(opt, JSH.opt_specs(
            jcfg, opt, JSH.param_specs(jcfg, sds, jm), jm), jm)
    return total


CELLS = [(a, s.name) for a, s, ok, _ in C.cells() if ok]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_argument_bytes_equal_reference_specs(arch, shape):
    """Every cell on both production meshes: the port's argument bytes a
    device equal the shard bytes of the reference's own specs over
    ``jax.eval_shape`` leaves."""
    for name in ("pod", "multipod"):
        jm, tm = _meshes(name)
        got = D.argument_bytes(D.cell_config(arch), C.SHAPES[shape], tm)
        assert got == _ref_argument_bytes(arch, C.SHAPES[shape], jm), name


# ---------------------------------------------------------------------------
# shard_shape, placements and DTensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-6b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "rwkv6-3b"])
def test_shard_shape_is_the_reference_spec_arithmetic(arch):
    jcfg, _, sds = _ref_tree(arch)
    leaves = _j_flat(sds)
    params = meta_params(D.cell_config(arch))
    for name in ("pod", "multipod"):
        jm, tm = _meshes(name)
        jspec = _j_specs(JSH.param_specs(jcfg, sds, jm))
        for path, spec in dict(flatten(SH.param_specs(
                D.cell_config(arch), params, tm))).items():
            want = tuple(d // (1 if ax is None else JD.axis_size(jm, ax))
                         for d, ax in zip(leaves[path].shape, jspec[path]))
            assert SH.shard_shape(spec, leaves[path].shape, tm) == want


def test_placements_shard_a_dim_over_every_axis_of_its_entry():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert SH.to_placements((("pod", "data"), None), mesh) == \
        [Shard(0), Shard(0), Replicate()]
    assert SH.to_placements(("data", "model", None), mesh) == \
        [Replicate(), Shard(0), Shard(1)]
    assert SH.to_placements((), mesh) == [Replicate()] * 3
    assert SH.shard_shape((("pod", "data"), None), (64, 3), mesh) == (2, 3)
    with pytest.raises(ValueError, match="axis order"):
        SH.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        SH.shard_shape(("model",), (17,), mesh)


def test_distribute_smoke_params_on_a_one_rank_gloo_group():
    """A one-rank gloo group on a HashStore (no port), a (1, 1) CPU mesh:
    every leaf of the smoke params distributed by its spec, each local
    shard equal to its param."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    cfg = C.smoke_config("gpt2-124m")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    mesh = make_debug_mesh(1, 1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4"):
            device_mesh(make_debug_mesh(2, 2), "cpu")
        dmesh = device_mesh(mesh, "cpu")
        assert dmesh.mesh_dim_names == ("data", "model")
        out = SH.distribute(params, SH.param_specs(cfg, params, mesh), dmesh)
        for (path, d), (_, p) in zip(flatten(out), flatten(params)):
            assert isinstance(d, DTensor), path
            assert torch.equal(d.to_local(), p), path
    finally:
        dist.destroy_process_group()


def test_shard_bytes_is_the_product_of_shard_shapes():
    mesh = make_production_mesh()
    cfg = D.cell_config("yi-6b")
    params = meta_params(cfg)
    specs = SH.param_specs(cfg, params, mesh)
    want = sum(math.prod(SH.shard_shape(s, t.shape, mesh)) * 2
               for (_, t), (_, s) in zip(flatten(params), flatten(specs)))
    assert SH.shard_bytes(params, specs, mesh) == want
