"""The port's MoE (``moe_mlp``, ``moe_aux_loss``, ``MoeLM``) against the JAX
package at the llama4-maverick (top-1) and kimi-k2 (top-2) smoke widths.

Reference params come from ``repro.models.build_model(cfg).init`` and are
loaded through ``params_from_jax``; inputs are made with numpy from a seed.
Tolerances: float32 1e-5; bfloat16 5e-2 relative L2 (the frameworks round
the scaled q at different places, ROADMAP C5, and a bf16 rounding can move
a token's gate).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import kimi_k2_1t as j_kimi  # noqa: E402
from repro.configs import llama4_maverick as j_llama4  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import kimi_k2_1t as t_kimi  # noqa: E402
from repro_torch.configs import llama4_maverick as t_llama4  # noqa: E402
from repro_torch.convert import param_shapes, params_from_jax  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.models import MoeLM  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import _layer, flatten, serving_params  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 5e-2
ARCHS = {"llama4": (j_llama4, t_llama4), "kimi": (j_kimi, t_kimi)}
NAMES = {"llama4": "llama4-maverick-400b-a17b", "kimi": "kimi-k2-1t-a32b"}
TREES = (("llama4", 0), ("kimi", 0), ("kimi", 64))
# the reference's functions under jit: eager JAX re-traces its layer scan
# on every call
J_MOE = jax.jit(JB.moe_mlp, static_argnums=2)


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


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, dtype: str, msg: str = ""):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=msg)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2, msg


def _cfgs(arch: str, dtype: str, **over):
    jmod, tmod = ARCHS[arch]
    return (jmod.smoke_config(dtype=getattr(jnp, dtype), **over),
            tmod.smoke_config(dtype=getattr(torch, dtype), **over))


@pytest.fixture(scope="module")
def ref_trees():
    """The reference's smoke params as numpy trees (float32): each arch,
    and kimi-k2 with a shared expert."""
    out = {}
    for arch, shared in TREES:
        cfg = ARCHS[arch][0].smoke_config(shared_expert_ff=shared)
        p = jax.jit(j_build(cfg).init)(jax.random.PRNGKey(0))
        out[arch, shared] = jax.tree_util.tree_map(np.asarray, p)
    return out


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["moe"])


def _moe_pair(ref_trees, arch, dtype, **over):
    """(JAX cfg, port cfg, JAX layer-0 moe params, port layer-0 moe
    params in the port's serving dtypes)."""
    jc, tc = _cfgs(arch, dtype, **over)
    tree = ref_trees[arch, over.get("shared_expert_ff", 0)]
    tp = serving_params(params_from_jax(tree, tc, device="cpu"), tc, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, _layer0(tree))
    return jc, tc, jp, _layer(tp["blocks"], 0)["moe"]


# ---------------------------------------------------------------------------
# configs and param shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_matches_reference_field_by_field(arch, which):
    jmod, tmod = ARCHS[arch]
    j, t = getattr(jmod, which)(), getattr(tmod, which)()
    for f in dataclasses.fields(j):
        if f.name == "use_kernels":
            continue
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(jv).name == str(tv).replace("torch.", "")
        else:
            assert jv == tv, f.name
    assert (t.hd, t.param_count(), t.active_param_count()) == \
        (j.hd, j.param_count(), j.active_param_count())
    get = t_configs.get_config if which == "config" \
        else t_configs.smoke_config
    assert get(NAMES[arch]) == t


@pytest.mark.parametrize("arch,shared", TREES)
def test_param_shapes_and_init_match_the_reference_tree(ref_trees, arch,
                                                        shared):
    tcfg = ARCHS[arch][1].smoke_config(shared_expert_ff=shared)
    tree = ref_trees[arch, shared]
    want = {p: tuple(a.shape) for p, a in flatten(tree)}
    assert param_shapes(tcfg) == want
    params = t_build(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = {p: tuple(t.shape) for p, t in flatten(params)}
    assert got == want
    # the reference's fan-ins: D for the router and w_gate, F for w_down
    moe = params["blocks"]["moe"]
    for name, fan_in in (("router", 128), ("w_gate", 128),
                         ("w_down", tcfg.d_ff)):
        std = moe[name].float().std().item()
        assert abs(std * fan_in ** 0.5 - 1) < 0.1, name


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    "llama4 top-1": ("llama4", dict(), (2, 7)),
    "kimi top-2": ("kimi", dict(), (2, 7)),
    "capacity drops tokens": ("llama4", dict(capacity_factor=0.25), (2, 9)),
    "C=1 floor at G=2": ("llama4", dict(), (1, 2)),
    "shared expert": ("kimi", dict(shared_expert_ff=64), (2, 5)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_moe_mlp_matches_reference(ref_trees, case, dtype):
    arch, over, (B, S) = BLOCK_CASES[case]
    jc, tc, jp, tp = _moe_pair(ref_trees, arch, dtype, **over)
    x = np.random.RandomState(2).randn(B, S, tc.d_model).astype(np.float32)
    want = J_MOE(jnp.asarray(x).astype(jc.dtype), jp, jc)
    got = TB.moe_mlp(torch.from_numpy(x).to(tc.dtype), tp, tc)
    assert got.shape == (B, S, tc.d_model) and got.dtype == tc.dtype
    _close(got, want, dtype, case)
    if case == "capacity drops tokens":
        C = max(int(B * S * tc.top_k * tc.capacity_factor
                    / tc.n_experts), 1)
        assert C * tc.n_experts < B * S * tc.top_k   # some choice dropped
        # a dropped token's routed output is 0: some rows are exactly 0
        assert (_np(got).reshape(B * S, -1) == 0).all(-1).any()


@pytest.mark.parametrize("k", [1, 2, 8])
def test_top_k_breaks_ties_as_jax_lax_top_k(k):
    """Among equal probabilities the lower expert index comes first."""
    probs = np.random.RandomState(5).randint(0, 3, (64, 8)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tv, ti = TB._top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_router_scores_pick_the_references_experts(ref_trees):
    """Two router columns set equal (and large) tie two experts at the top
    for many tokens: top-1 must pick the lower index, as the reference
    does, and the block's output must follow."""
    jc, tc, jp, tp = _moe_pair(ref_trees, "llama4", "float32")
    router = np.array(jp["router"])
    router[:, 1] = router[:, 3] = 4 * router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.RandomState(3).randn(2, 8, 128).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(16, 128)
                          @ tp["router"], dim=-1)
    tied = (probs[:, 1] == probs[:, 3]) & (probs[:, 1] == probs.max(-1)[0])
    assert tied.sum() >= 4
    assert (TB._top_k(probs, 1)[1][tied] == 1).all()
    got = TB.moe_mlp(torch.from_numpy(x), tp, tc)
    want = J_MOE(jnp.asarray(x), jp, jc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_aux_loss_matches_reference(ref_trees, arch):
    jc, tc, jp, tp = _moe_pair(ref_trees, arch, "float32")
    x = np.random.RandomState(4).randn(3, 5, 128).astype(np.float32)
    want = float(JB.moe_aux_loss(jnp.asarray(x), jp, jc))
    got = float(TB.moe_aux_loss(torch.from_numpy(x), tp, tc))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# MoeLM against the reference LM
# ---------------------------------------------------------------------------


def _models(ref_trees, arch, dtype, **over):
    jc, tc = _cfgs(arch, dtype, **over)
    tree = ref_trees[arch, over.get("shared_expert_ff", 0)]
    tm = t_build(tc, device="cpu")
    tp = serving_params(params_from_jax(tree, tc, device="cpu"), tc,
                        tm.device)
    return _Jitted(j_build(jc)), jax.tree_util.tree_map(jnp.asarray, tree), \
        tm, tp


class _Jitted:
    """A reference LM's entry points under jit."""

    def __init__(self, model):
        self.forward = jax.jit(model.forward)
        self.loss = jax.jit(model.loss)
        self.loss_and_grad = jax.jit(jax.value_and_grad(model.loss))
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_reference(ref_trees, arch, dtype):
    jm, jp, tm, tp = _models(ref_trees, arch, dtype)
    assert isinstance(tm, MoeLM)
    toks = np.random.RandomState(5).randint(0, 512, (2, 11)).astype(np.int32)
    _close(tm.forward(tp, toks[:, :-1]),
           jm.forward(jp, jnp.asarray(toks[:, :-1])), dtype, "forward")
    want = float(jm.loss(jp, {"tokens": jnp.asarray(toks)}))
    got = float(tm.loss(tp, {"tokens": toks}))
    assert got == pytest.approx(want, rel=1e-5 if dtype == "float32"
                                else 1e-2)


def test_loss_includes_the_aux_term(ref_trees):
    """The loss is the cross-entropy plus 0.01 x the aux loss of the
    embedded inputs on layer 0's router."""
    _, _, tm, tp = _models(ref_trees, "llama4", "float32")
    toks = np.random.RandomState(6).randint(0, 512, (2, 9)).astype(np.int32)
    inputs = torch.from_numpy(toks[:, :-1]).long()
    logits = tm.forward(tp, inputs).float()
    targets = torch.from_numpy(toks[:, 1:]).long()
    nll = (torch.logsumexp(logits, -1)
           - logits.gather(-1, targets[..., None])[..., 0]).mean()
    x = torch.nn.functional.embedding(inputs, tp["embed"])
    aux = TB.moe_aux_loss(x, {"router": tp["blocks"]["moe"]["router"][0]},
                          tm.cfg)
    assert float(aux) > 0.9     # E sum(f p) >= 1 - rounding
    assert float(tm.loss(tp, {"tokens": toks})) == \
        pytest.approx(float(nll + 0.01 * aux), rel=1e-6)


def test_loss_gradient_matches_jax_grad(ref_trees):
    """``value_and_grad`` of the port's loss (aux term included) against
    ``jax.grad`` of the reference's, every leaf, float32."""
    jm, jp, tm, _ = _models(ref_trees, "kimi", "float32", remat="none")
    tp = params_from_jax(ref_trees["kimi", 0], tm.cfg, device="cpu")
    toks = np.random.RandomState(7).randint(0, 512, (2, 9)).astype(np.int32)
    jl, jg = jm.loss_and_grad(jp, {"tokens": jnp.asarray(toks)})
    tl, tg = value_and_grad(tm, tp, {"tokens": toks})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = dict(flatten(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(flatten(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        scale = max(np.abs(want[path]).max(), 1e-8)
        np.testing.assert_allclose(_np(g) / scale, want[path] / scale,
                                   rtol=1e-4, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_reference(ref_trees, arch, dtype):
    """A uniform prefill and three teacher-forced decode steps, the last
    one past the end of the cache (scalar length, C4)."""
    jm, jp, tm, tp = _models(ref_trees, arch, dtype)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, 512, (2, 6)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=8)
    tl, tc = tm.prefill(tp, toks, max_len=8)
    _close(tl, jl, dtype, "prefill")
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype, name)
    for step in range(3):
        f = rng.randint(0, 512, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        _close(tl, jl, dtype, f"decode step {step}")
    assert int(tc["len"]) == int(jc["len"]) == 9


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ragged_prefill_and_per_row_decode_past_the_cache_end(ref_trees,
                                                              arch):
    """prefill(last_pos=) gives (B,) lengths; each row then decodes at its
    own length, up to and past the end of the cache (float32)."""
    jm, jp, tm, tp = _models(ref_trees, arch, "float32")
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 512, (3, 9)).astype(np.int32)
    lp = np.array([8, 2, 5], np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=11,
                        last_pos=jnp.asarray(lp))
    tl, tc = tm.prefill(tp, toks, max_len=11, last_pos=lp)
    _close(tl, jl, "float32", "prefill")
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [9, 3, 6]
    for step in range(4):    # row 0 passes S = 11
        f = rng.randint(0, 512, (3, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        _close(tl, jl, "float32", f"decode step {step}")
    for name in ("k", "v"):
        _close(tc[name], jc[name], "float32", name)
    assert tc["len"].tolist() == [13, 7, 10]


def test_remat_dots_raises_naming_the_roadmap_item():
    """Remat "dots" is ported (its own tests are in test_torch_remat.py):
    it runs; a name that is no remat policy raises, naming the three that
    are."""
    tm = t_build(t_llama4.smoke_config(remat="dots"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    assert torch.isfinite(tm.forward(params, np.zeros((1, 4), np.int32))
                          .float()).all()
    tm = t_build(t_llama4.smoke_config(remat="selective"), device="cpu")
    with pytest.raises(NotImplementedError, match="'none', 'full', 'dots'"):
        tm.forward(params, np.zeros((1, 4), np.int32))
