"""The port's model (configs, primitives, MLP, params, prefill and decode)
against the JAX package at yi-6b's smoke width.

Reference params come from ``repro.models.build_model(cfg).init`` and are
loaded through ``params_from_jax``; inputs are made with numpy from a seed.
Tolerances: primitives and MLP 1e-5 (f32), model logits and caches 1e-4 in
f32 and 5e-2 in bf16. One bf16 ulp near 1 is 2^-8, and the two frameworks
round at different places: the port (like the Pallas kernel) forms
q . k * scale in float32, while the JAX plain path rounds q * scale to
bf16 first (models/attention.py:52); 5e-2 covers that difference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import yi_6b as j_yi  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import yi_6b as t_yi  # noqa: E402
from repro_torch.convert import (param_shapes, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models.lm import flatten, serving_params  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
PRIM = dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke params as a numpy tree (param_dtype float32)."""
    p = j_build(j_yi.smoke_config()).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _models(ref_params, dtype: str, use_kernels: bool, **over):
    jcfg = j_yi.smoke_config(dtype=getattr(jnp, dtype),
                             use_kernels=use_kernels, **over)
    tcfg = t_yi.smoke_config(dtype=getattr(torch, dtype), **over)
    tm = t_build(tcfg, device="cpu")
    tp = serving_params(params_from_jax(ref_params, tcfg, device="cpu"),
                        tcfg, tm.device)
    return j_build(jcfg), tm, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_matches_reference_field_by_field(which):
    j = getattr(j_yi, which)()
    t = getattr(t_yi, which)()
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    for f in dataclasses.fields(j):
        if f.name == "use_kernels":   # the port dispatches by device
            assert f.name not in tf
            continue
        jv, tv = getattr(j, f.name), tf.pop(f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(jv).name == str(tv).replace("torch.", "")
        else:
            assert jv == tv, f.name
    assert not tf
    assert (t.hd, t.q_per_kv, t.param_count()) == \
        (j.hd, j.q_per_kv, j.param_count())
    assert getattr(t_configs, "get_config" if which == "config"
                   else which)("yi-6b") == t


def test_config_registry_lists_only_ported_archs():
    """Every arch of the reference is ported: the port's registry lists
    the reference's 11 archs in its order, and refuses an unknown one."""
    from repro import configs as j_configs
    assert t_configs.list_archs() == j_configs.list_archs()
    assert len(t_configs.list_archs()) == 11
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get_config("llama-3.2-vision-1b")


# ---------------------------------------------------------------------------
# primitives and MLP (float32, 1e-5)
# ---------------------------------------------------------------------------


def test_rms_norm_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    s = rng.rand(64).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        _np(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)),
        _np(JC.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)), **PRIM)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_fn_matches(act):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(_np(TC.act_fn(act)(torch.from_numpy(x))),
                               _np(JC.act_fn(act)(jnp.asarray(x))), **PRIM)


def test_rope_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 32).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 300, 4000, 5, 6, 7]],
                   np.int32)
    np.testing.assert_allclose(_np(TC.rope_freqs(32, 1e4)),
                               _np(JC.rope_freqs(32, 1e4)), **PRIM)
    np.testing.assert_allclose(
        _np(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        _np(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), **PRIM)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 32).astype(np.float32)
    p = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    jcfg = j_yi.smoke_config(act=act, dtype=jnp.float32)
    tcfg = t_yi.smoke_config(act=act, dtype=torch.float32)
    np.testing.assert_allclose(
        _np(TB.mlp(torch.from_numpy(x),
                   {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)),
        _np(JB.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   jcfg)), **PRIM)


def test_init_dense_scale_and_generator():
    g = torch.Generator().manual_seed(0)
    w = TC.init_dense(g, (4, 2048, 8), in_axis=1)
    assert w.dtype == torch.float32
    assert w.std().item() == pytest.approx(2048 ** -0.5, rel=0.02)
    again = TC.init_dense(torch.Generator().manual_seed(0), (4, 2048, 8),
                          in_axis=1)
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_params_follow_tree_util_order_and_round_trip(ref_params):
    cfg = t_yi.smoke_config()
    tp = params_from_jax(ref_params, cfg, device="cpu")
    jpaths = ["/".join(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    assert [p for p, _ in flatten(tp)] == jpaths
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(flatten(ref_params), flatten(back)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    init = t_build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in flatten(init)} == param_shapes(cfg)


def test_params_from_jax_checks_keys_and_shapes(ref_params):
    cfg = t_yi.smoke_config()
    missing = {k: v for k, v in ref_params.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(ref_params, t_yi.smoke_config(vocab=256),
                        device="cpu")


def test_serving_params_cast_matmuls_keep_norms_f32(ref_params):
    cfg = t_yi.smoke_config()
    sp = serving_params(params_from_jax(ref_params, cfg, device="cpu"), cfg,
                        torch.device("cpu"))
    for path, t in flatten(sp):
        want = torch.float32 if path.split("/")[-1] in (
            "ln1", "ln2", "final_norm") else torch.bfloat16
        assert t.dtype == want, path


def test_bf16_numpy_leaves_load_bit_exact(ref_params):
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), ref_params)
    tp = params_from_jax(bf, t_yi.smoke_config(), device="cpu")
    for (path, a), (_, t) in zip(flatten(bf), flatten(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.astype(np.float32), _np(t),
                                      err_msg=path)


def test_other_families_and_devices_raise():
    # a family that neither package has
    with pytest.raises(ValueError, match="dense, audio, moe, vlm, hybrid "
                                         "and rwkv6 families"):
        t_build(dataclasses.replace(t_yi.smoke_config(), family="encoder"),
                device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        t_build(t_yi.smoke_config(), device="xpu")


# ---------------------------------------------------------------------------
# prefill + decode against the JAX LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, dtype, use_kernels):
    """Prefill logits and cache, then three teacher-forced decode steps,
    against the JAX LM with its plain path and with its Pallas kernels."""
    jm, tm, tp = _models(ref_params, dtype, use_kernels)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 512, size=(2, 13)).astype(np.int32)
    feed = rng.randint(0, 512, size=(3, 2, 1)).astype(np.int32)
    max_len = 20
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=max_len)
    tl, tc = tm.prefill(tp, toks, max_len=max_len)
    assert tl.shape == (2, 1, 512) and tc["k"].shape == jc["k"].shape
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL[dtype])
    assert int(tc["len"]) == int(jc["len"]) == 13
    for step in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed[step]))
        tl, tc = tm.decode_step(tp, tc, feed[step])
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype],
                                   err_msg=f"decode step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL[dtype])
    assert int(tc["len"]) == int(jc["len"]) == 16


@pytest.mark.parametrize("last", [[4, 12], [12, 0]])
def test_ragged_prefill_and_per_row_decode_match_reference(ref_params, last):
    """prefill(last_pos=) gives (B,) lengths; decode then appends each row
    at its own length, up to and past the end of the cache (f32)."""
    jm, tm, tp = _models(ref_params, "float32", False)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, size=(2, 13)).astype(np.int32)
    lp = np.asarray(last, np.int32)
    max_len = 15
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=max_len,
                        last_pos=jnp.asarray(lp))
    tl, tc = tm.prefill(tp, toks, max_len=max_len, last_pos=lp)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"])
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for step in range(5):   # row 0 (length 13) passes S = 15
        f = rng.randint(0, 512, size=(2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"],
                                   err_msg=f"decode step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   **TOL["float32"])


def test_scalar_length_past_the_cache_end_clamps(ref_params):
    """A uniform batch decoding past max_len writes the last row and
    attends over all rows, as the reference's clamped update does (f32)."""
    jm, tm, tp = _models(ref_params, "float32", False)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 512, size=(2, 6)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=7)
    tl, tc = tm.prefill(tp, toks, max_len=7)
    for step in range(3):
        f = rng.randint(0, 512, size=(2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"],
                                   err_msg=f"decode step {step}")
    assert int(tc["len"]) == 9
