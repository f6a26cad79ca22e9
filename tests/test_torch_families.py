"""The audio family (musicgen-medium), the dense configs the port gained
with it (starcoder2-3b, starcoder2-15b, deepseek-67b) and the registry of
all 11 archs, against the JAX package.

Reference params come from ``repro.models.build_model(cfg).init`` and are
loaded through ``params_from_jax``; inputs are made with numpy from a seed.
Tolerances: float32 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import RequestScheduler as JScheduler  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro.serving import TPServeEngine as JTP  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import param_shapes, params_from_jax  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten  # noqa: E402
from repro_torch.serving import RequestScheduler, ServeEngine  # noqa: E402
from repro_torch.serving import TPServeEngine  # noqa: E402
from repro_torch.serving.engine import KV_CACHE_FAMILIES  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
MUSICGEN = "musicgen-medium"
DENSE = ("starcoder2-3b", "starcoder2-15b", "deepseek-67b")
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, msg: str = ""):
    np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=msg)


@pytest.fixture(scope="module")
def ref_trees():
    """The reference's float32 smoke params of musicgen and the three
    dense configs, as numpy trees."""
    out = {}
    for arch in (MUSICGEN,) + DENSE:
        p = jax.jit(j_build(j_configs.smoke_config(arch)).init)(
            jax.random.PRNGKey(0))
        out[arch] = jax.tree_util.tree_map(np.asarray, p)
    return out


def _models(ref_trees, arch, use_kernels=False):
    """(JAX model, its params, port model, port params), float32."""
    jm = j_build(j_configs.smoke_config(arch, dtype=jnp.float32,
                                        use_kernels=use_kernels))
    tc = t_configs.smoke_config(arch, dtype=torch.float32)
    tm = t_build(tc, device="cpu")
    tp = params_from_jax(ref_trees[arch], tc, device="cpu")
    return jm, jax.tree_util.tree_map(jnp.asarray, ref_trees[arch]), tm, tp


# ---------------------------------------------------------------------------
# the registry: all 11 archs
# ---------------------------------------------------------------------------


def _same_config(t, j):
    for f in dataclasses.fields(j):
        if f.name == "use_kernels":     # the port dispatches by device
            continue
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(jv).name == str(tv).replace("torch.", "")
        else:
            assert jv == tv, f.name
    assert {f.name for f in dataclasses.fields(t)} == \
        {f.name for f in dataclasses.fields(j)} - {"use_kernels"}
    assert (t.hd, t.q_per_kv, t.param_count(), t.active_param_count()) == \
        (j.hd, j.q_per_kv, j.param_count(), j.active_param_count())


@pytest.mark.parametrize("which", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_every_config_matches_reference_field_by_field(arch, which):
    _same_config(getattr(t_configs, which)(arch),
                 getattr(j_configs, which)(arch))


def test_registry_helpers_match_reference():
    assert t_configs.list_archs() == j_configs.list_archs()
    assert t_configs.ASSIGNED == j_configs.ASSIGNED
    assert t_configs.SUBQUADRATIC == j_configs.SUBQUADRATIC
    assert {k: dataclasses.astuple(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in j_configs.SHAPES.items()}
    for arch in j_configs.list_archs():
        for shape in j_configs.SHAPES:
            assert t_configs.shape_applicable(arch, shape) == \
                j_configs.shape_applicable(arch, shape), (arch, shape)
    for skipped in (False, True):
        got = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why
               in t_configs.cells(include_skipped=skipped)]
        want = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why
                in j_configs.cells(include_skipped=skipped)]
        assert got == want
    assert len(want) == 40
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.smoke_config("musicgen-large")


@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_every_arch_builds_the_reference_param_tree(arch):
    """Each smoke config builds a port model whose param shapes, and whose
    init, give the reference's tree leaf for leaf."""
    jtree = jax.eval_shape(j_build(j_configs.smoke_config(arch)).init,
                           jax.random.PRNGKey(0))
    want = {p: tuple(a.shape) for p, a in flatten(jtree)}
    cfg = t_configs.smoke_config(arch)
    assert param_shapes(cfg) == want
    params = t_build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in flatten(params)} == want


def test_kv_cache_families_are_the_references():
    assert KV_CACHE_FAMILIES == ("dense", "audio", "moe")
    assert type(t_build(t_configs.smoke_config(MUSICGEN),
                        device="cpu")) is LM


# ---------------------------------------------------------------------------
# the dense configs: logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_logits_match_reference(ref_trees, arch, use_kernels):
    """float32 forward logits, against the reference's plain path and its
    Pallas kernels (interpret mode): starcoder2's 3 query heads a K/V head
    and GELU, deepseek's 3 layers."""
    jm, jp, tm, tp = _models(ref_trees, arch, use_kernels)
    toks = np.random.RandomState(2).randint(0, 512, (2, 10)).astype(np.int32)
    _close(tm.forward(tp, toks), jax.jit(jm.forward)(jp, jnp.asarray(toks)),
           arch)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_prefill_and_decode_match_reference(ref_trees, arch):
    jm, jp, tm, tp = _models(ref_trees, arch)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 512, (2, 7)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=12)
    tl, tc = tm.prefill(tp, toks, max_len=12)
    _close(tl, jl, "prefill")
    for step in range(3):
        f = rng.randint(0, 512, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        _close(tl, jl, f"decode step {step}")


# ---------------------------------------------------------------------------
# musicgen-medium: the audio family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_musicgen_forward_matches_reference(ref_trees, use_kernels):
    jm, jp, tm, tp = _models(ref_trees, MUSICGEN, use_kernels)
    toks = np.random.RandomState(4).randint(0, 256, (2, 12)).astype(np.int32)
    _close(tm.forward(tp, toks), jax.jit(jm.forward)(jp, jnp.asarray(toks)))
    want = float(jm.loss(jp, {"tokens": jnp.asarray(toks)}))
    assert float(tm.loss(tp, {"tokens": toks})) == pytest.approx(want,
                                                                 rel=1e-5)


@pytest.mark.parametrize("ragged", [False, True])
def test_musicgen_prefill_and_decode_match_reference(ref_trees, ragged):
    """A uniform or ragged prefill (every cache leaf) and 4 decode steps,
    the ragged rows each at their own length."""
    jm, jp, tm, tp = _models(ref_trees, MUSICGEN)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 256, (3, 8)).astype(np.int32)
    lp = np.array([7, 2, 4], np.int32) if ragged else None
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=14,
                        last_pos=None if lp is None else jnp.asarray(lp))
    tl, tc = tm.prefill(tp, toks, max_len=14, last_pos=lp)
    _close(tl, jl, "prefill")
    for name in ("k", "v"):
        _close(tc[name], jc[name], name)
    assert np.asarray(tc["len"]).tolist() == np.asarray(jc["len"]).tolist()
    for step in range(4):
        f = rng.randint(0, 256, (3, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        _close(tl, jl, f"decode step {step}")


@pytest.mark.parametrize("lens", [None, [3, 9, 6]])
def test_musicgen_generate_equals_reference(ref_trees, lens):
    jm, jp, tm, tp = _models(ref_trees, MUSICGEN)
    prompts = np.random.RandomState(6).randint(1, 256, (3, 9)).astype(
        np.int32)
    want = JServe(jm, jp, max_len=MAX_LEN).generate(prompts, 8,
                                                    prompt_lens=lens)
    got = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        prompts, 8, prompt_lens=lens)
    np.testing.assert_array_equal(got, want)


def test_musicgen_scheduler_equals_reference(ref_trees):
    """Continuous batching over ``TPServeEngine(world=None)``: the same
    requests give the same tokens, decode steps and slot lengths."""
    jm, jp, tm, tp = _models(ref_trees, MUSICGEN)
    rng = np.random.RandomState(7)
    plist = [rng.randint(1, 256, size=int(rng.randint(1, 13))
                         ).astype(np.int32) for _ in range(5)]
    n_tokens = [5, 1, 7, 3, 4]
    jt = JTP(jm, jp, world=None, max_len=MAX_LEN)
    tt = TPServeEngine(tm, tp, world=None, max_len=MAX_LEN, device="cpu")
    scheds = []
    for engine, cls in ((jt, JScheduler), (tt, RequestScheduler)):
        sched = cls(engine, n_slots=2, prefill_len=12)
        for p, n in zip(plist, n_tokens):
            sched.submit(p, n)
        sched.run()
        scheds.append(sched)
    js, ts = scheds
    assert [r.state for r in ts.requests] == ["done"] * len(plist)
    assert [r.tokens for r in ts.requests] == [r.tokens for r in js.requests]
    assert [len(r.tokens) for r in ts.requests] == n_tokens
    assert ts.decode_steps == js.decode_steps
    assert tt.sync_rounds == jt.sync_rounds
    assert tt._cache["len"].tolist() == np.asarray(jt._cache["len"]).tolist()
