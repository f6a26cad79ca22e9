"""The port's training path (gpt2-124m config, LM.loss and its gradients,
AdamW, make_train_step) against the JAX package on the CPU.

Reference params come from ``repro.models.build_model(cfg).init`` and are
loaded through ``params_from_jax``; tokens and gradients are made with
numpy from a seed. The reference runs both its attention paths: the plain
blockwise core (``use_kernels=False``) and the Pallas kernels in interpret
mode (``use_kernels=True``). Tolerances, in each assert: float32 losses to
1e-5 relative and each gradient leaf's relative L2 error to 1e-4; AdamW to
1e-6 (the same float32 arithmetic on the same inputs); the bf16
smoke-trainer config to bf16 tolerance, since the JAX plain path rounds the
scaled q to bf16 and the port scales in float32 (ROADMAP C5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gpt2_124m as j_gpt2  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import gpt2_124m as t_gpt2  # noqa: E402
from repro_torch.convert import (opt_state_from_jax,  # noqa: E402
                                 opt_state_to_numpy, params_from_jax,
                                 params_to_numpy)
from repro_torch.kernels.flash_attention import ref as TFR  # noqa: E402
from repro_torch.launch import (make_decode_step,  # noqa: E402
                                make_prefill_step, make_train_step,
                                value_and_grad)
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, global_norm)

LOSS_F32 = dict(rtol=1e-5, atol=0)
GRAD_REL_L2_F32 = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    """[(path, leaf)] of a reference tree, in jax.tree_util order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in flat]


def _smoke_trainer_overrides():
    """The model of the reference's smoke trainer (train/trainer.py:474)."""
    return dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                vocab=512)


def _pair(dtype="float32", smoke_trainer=False, **over):
    """(reference config, port config) of gpt2-124m's smoke width."""
    if smoke_trainer:
        over = dict(_smoke_trainer_overrides(), **over)
    j = j_gpt2.smoke_config(dtype=getattr(jnp, dtype), **over)
    t = t_gpt2.smoke_config(dtype=getattr(torch, dtype),
                            **{k: v for k, v in over.items()
                               if k != "use_kernels"})
    return j, t


def _ref_params(jcfg):
    p = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _tokens(cfg, B=2, S=17, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_gpt2_config_matches_reference_field_by_field(which):
    j = getattr(j_gpt2, which)()
    t = getattr(t_gpt2, which)()
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
    assert not tf, f"fields only in the port: {sorted(tf)}"
    assert t.param_count() == j.param_count()
    assert t_configs.get_config("gpt2-124m") == t_gpt2.config()
    assert t_configs.smoke_config("gpt2-124m") == t_gpt2.smoke_config()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _loss_and_grads(jcfg, tcfg, tokens):
    ref = _ref_params(jcfg)
    jm = j_build(jcfg)
    j_loss, j_grads = jax.value_and_grad(jm.loss)(
        jax.tree_util.tree_map(jnp.asarray, ref), {"tokens": tokens})
    tm = t_build(tcfg, device="cpu")
    t_loss, t_grads = value_and_grad(
        tm, params_from_jax(ref, tcfg, device="cpu"), {"tokens": tokens})
    return (float(j_loss), dict(_leaves(j_grads)), float(t_loss),
            dict(flatten(t_grads)))


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_and_grads_match_reference_f32(use_kernels, remat):
    """LM.loss and every gradient leaf against jax.value_and_grad(LM.loss),
    float32, with the reference's plain and Pallas attention."""
    jcfg, tcfg = _pair(use_kernels=use_kernels, remat=remat)
    j_loss, j_g, t_loss, t_g = _loss_and_grads(jcfg, tcfg, _tokens(tcfg))
    np.testing.assert_allclose(t_loss, j_loss, **LOSS_F32)
    assert set(t_g) == set(j_g)
    for path in j_g:
        assert tuple(t_g[path].shape) == j_g[path].shape, path
        assert t_g[path].dtype == torch.float32, path
        err = _rel_l2(t_g[path], j_g[path])
        assert err <= GRAD_REL_L2_F32, (path, err)


def test_loss_and_grads_match_reference_bf16_smoke_trainer():
    """The reference smoke trainer's model in bf16 (its default): the loss
    to 2e-2 relative and each gradient leaf's relative L2 error within
    5e-2, bf16 tolerance (C5). The f32 master grads stay float32."""
    jcfg, tcfg = _pair("bfloat16", smoke_trainer=True)
    j_loss, j_g, t_loss, t_g = _loss_and_grads(jcfg, tcfg,
                                               _tokens(tcfg, S=33))
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-2)
    for path in j_g:
        assert t_g[path].dtype == torch.float32, path
        err = _rel_l2(t_g[path], j_g[path])
        assert err <= 5e-2, (path, err)


def test_remat_does_not_change_the_gradients_and_reruns_the_forward():
    """remat "full" and "none" give the same loss and gradients; "full"
    runs each layer's attention forward twice (once again in the
    backward), "none" once; the backward runs once a layer either way."""
    out, counts = {}, {}
    for remat in ("full", "none"):
        cfg = t_gpt2.smoke_config(dtype=torch.float32, remat=remat)
        model = t_build(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        TFR.flash_attention_ref.launches = 0
        TFR.flash_attention_bwd_ref.launches = 0
        out[remat] = value_and_grad(model, params, {"tokens": _tokens(cfg)})
        counts[remat] = (TFR.flash_attention_ref.launches,
                         TFR.flash_attention_bwd_ref.launches)
    L = cfg.n_layers
    assert counts == {"full": (2 * L, L), "none": (L, L)}
    torch.testing.assert_close(out["full"][0], out["none"][0], rtol=0, atol=0)
    for (p, a), (_, b) in zip(flatten(out["full"][1]),
                              flatten(out["none"][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=p)


def test_remat_dots_is_not_ported():
    """Remat "dots" is ported now: it gives "full"'s loss and gradients
    bit for bit and, like "full", runs each layer's attention forward
    twice; a name that is no remat policy still raises."""
    out, counts = {}, {}
    for remat in ("full", "dots"):
        cfg = t_gpt2.smoke_config(dtype=torch.float32, remat=remat)
        model = t_build(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        TFR.flash_attention_ref.launches = 0
        TFR.flash_attention_bwd_ref.launches = 0
        out[remat] = value_and_grad(model, params, {"tokens": _tokens(cfg)})
        counts[remat] = (TFR.flash_attention_ref.launches,
                         TFR.flash_attention_bwd_ref.launches)
    L = cfg.n_layers
    assert counts == {"full": (2 * L, L), "dots": (2 * L, L)}
    assert torch.equal(out["full"][0], out["dots"][0])
    for (p, a), (_, b) in zip(flatten(out["full"][1]),
                              flatten(out["dots"][1])):
        assert torch.equal(a, b), p
    model = t_build(t_gpt2.smoke_config(remat="selective"), device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        model.loss(params, {"tokens": _tokens(cfg)})


def test_value_and_grad_leaves_the_params_alone():
    cfg = t_gpt2.smoke_config(n_layers=1)
    model = t_build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loss, grads = value_and_grad(model, params, {"tokens": _tokens(cfg)})
    assert loss.dim() == 0 and not loss.requires_grad
    for (path, p), (gpath, g) in zip(flatten(params), flatten(grads)):
        assert path == gpath and not p.requires_grad and p.grad is None
        assert g.shape == p.shape and bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


ADAMW_CASES = {
    # clip active: gradient norms of ~30 against clip_norm 1
    "clip": (dict(lr=1e-2, warmup_steps=3, total_steps=20), 1.0),
    # clip off, warmup then cosine past total_steps (held at 0.1 lr)
    "warmup-cosine": (dict(lr=3e-3, warmup_steps=3, total_steps=8,
                           clip_norm=1e9), 1e-2),
    "bf16-moments": (dict(lr=1e-2, warmup_steps=2, total_steps=6), 1e-2),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_matches_reference(case):
    """10 AdamW steps on the same gradient sequence: params, moments, step
    and metrics equal the reference's to float32 rounding (1e-6)."""
    kw, gscale = ADAMW_CASES[case]
    moment = "bfloat16" if case == "bf16-moments" else "float32"
    jcfg, tcfg = _pair()
    ref = _ref_params(jcfg)
    j_opt = JAdamWConfig(moment_dtype=getattr(jnp, moment), **kw)
    t_opt = AdamWConfig(moment_dtype=getattr(torch, moment), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, ref)
    js = j_adamw_init(jp, j_opt)
    tp = params_from_jax(ref, tcfg, device="cpu")
    ts = adamw_init(tp, t_opt)
    rng = np.random.RandomState(7)
    # bf16 moments: a float32 sum one ulp apart can round to neighbouring
    # bf16 values, so a moment may differ by a bf16 ulp (2^-8 relative) of
    # the larger values it was summed from, and a param by up to
    # lr * 2^-8 a step
    bf16_moments = moment == "bfloat16"
    p_tol = dict(rtol=1e-6, atol=1e-7) if moment == "float32" else \
        dict(rtol=1e-6, atol=10 * kw["lr"] * 2 ** -8)
    for step in range(10):
        g = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * gscale).astype(np.float32), ref)
        jp, js, jm = j_adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, j_opt)
        tp, ts, tm = adamw_update(
            tp, params_from_jax(g, tcfg, device="cpu"), ts, t_opt)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=f"{key} {step}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
    if case == "clip":
        assert float(jm["grad_norm"]) > 10 * t_opt.clip_norm
    if case == "warmup-cosine":
        np.testing.assert_allclose(float(tm["lr"]), 0.1 * t_opt.lr, rtol=1e-6)
    for path, leaf in _leaves(jax.tree_util.tree_map(np.asarray, jp)):
        np.testing.assert_allclose(_np(dict(flatten(tp))[path]), leaf,
                                   **p_tol, err_msg=path)
    state = opt_state_to_numpy(ts)
    for which in ("mu", "nu"):
        got = dict(flatten(ts[which]))
        assert all(t.dtype == getattr(torch, moment) for t in got.values())
        for path, leaf in _leaves(js[which]):
            leaf = _np(leaf)
            tol = dict(rtol=2 ** -7, atol=2 ** -7 * np.abs(leaf).max()) \
                if bf16_moments else dict(rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(_np(got[path]), leaf, **tol,
                                       err_msg=f"{which} {path}")
            np.testing.assert_allclose(dict(flatten(state[which]))[path],
                                       leaf, **tol)


def test_global_norm_matches_reference():
    jcfg, tcfg = _pair()
    ref = _ref_params(jcfg)
    from repro.optim import global_norm as j_global_norm
    np.testing.assert_allclose(
        float(global_norm(params_from_jax(ref, tcfg, device="cpu"))),
        float(j_global_norm(ref)), rtol=1e-6)


def test_opt_state_round_trips_from_jax():
    jcfg, tcfg = _pair()
    ref = _ref_params(jcfg)
    js = j_adamw_init(ref, JAdamWConfig(moment_dtype=jnp.bfloat16))
    js = dict(js, step=jnp.asarray(3, jnp.int32))
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), tcfg,
                            device="cpu")
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(ts["mu"]))
    back = opt_state_to_numpy(ts)
    assert int(back["step"]) == 3
    assert set(dict(flatten(back["nu"]))) == {p for p, _ in _leaves(ref)}


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_make_train_step_matches_reference(use_kernels):
    """3 train steps from the same params and optimizer state: losses to
    1e-5 relative, then every param leaf to 1e-4 relative L2 and the
    metrics, float32."""
    jcfg, tcfg = _pair(use_kernels=use_kernels)
    ref = _ref_params(jcfg)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    j_opt, t_opt = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, ref)
    js = j_adamw_init(jp, j_opt)
    tp = params_from_jax(ref, tcfg, device="cpu")
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), tcfg,
                            device="cpu")
    j_step = jax.jit(j_make_train_step(j_build(jcfg), j_opt))
    t_step = make_train_step(t_build(tcfg, device="cpu"), t_opt)
    tokens = _tokens(tcfg)
    losses = []
    for step in range(3):
        jp, js, jm = j_step(jp, js, {"tokens": jnp.asarray(tokens)})
        tp, ts, tm = t_step(tp, ts, {"tokens": tokens})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} {step}")
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    got = dict(flatten(tp))
    for path, leaf in _leaves(jax.tree_util.tree_map(np.asarray, jp)):
        assert got[path].dtype == torch.float32
        assert _rel_l2(got[path], leaf) <= 1e-4, path


def test_make_train_step_runs_and_updates():
    """As tests/test_launch_helpers.py: one step gives a finite loss,
    step 1, and moves the weights."""
    cfg = t_configs.smoke_config("gpt2-124m")
    model = t_build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3)
    opt_state = adamw_init(params, opt_cfg)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (2, 16))
    step = make_train_step(model, opt_cfg)
    new_params, new_state, metrics = step(params, opt_state,
                                          {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"]))
    assert int(new_state["step"]) == 1
    before = flatten(params)[0][1]
    after = flatten(new_params)[0][1]
    assert not torch.equal(before, after)


def test_make_prefill_then_decode_step():
    cfg = t_configs.smoke_config("gpt2-124m")
    model = t_build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (2, 8))
    logits, cache = make_prefill_step(model)(params, {"tokens": tokens})
    assert logits.shape == (2, 1, cfg.vocab)
    step_logits, cache = make_decode_step(model)(
        params, cache, torch.as_tensor(tokens[:, -1:]))
    assert step_logits.shape[0] == 2 and step_logits.shape[-1] == cfg.vocab
    assert bool(torch.isfinite(step_logits).all())
    assert not step_logits.requires_grad


def test_params_round_trip_through_numpy_after_a_step():
    """Trained params go back to the reference's numpy layout intact."""
    jcfg, tcfg = _pair()
    ref = _ref_params(jcfg)
    tp = params_from_jax(ref, tcfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    tp, _, _ = make_train_step(t_build(tcfg, device="cpu"), opt)(
        tp, adamw_init(tp, opt), {"tokens": _tokens(tcfg)})
    back = params_to_numpy(tp)
    for path, leaf in flatten(tp):
        np.testing.assert_array_equal(dict(flatten(back))[path], _np(leaf))
