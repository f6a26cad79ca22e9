"""The port's zamba2 hybrid family against the JAX package at zamba2-1.2b's
smoke width: the SSD scan's plain version and its autograd Function, the
Mamba2 block, the hybrid LM (forward, loss, prefill, decode), its params,
its serving, and the refusals.

Reference params come from ``repro.models.build_model(cfg).init`` through
``params_from_jax``; inputs are made with numpy from a seed. The Pallas SSD
kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.

Limits. float32: ``max |port - JAX| <= 1e-5 * max |JAX|`` over each tensor
compared (logits, each cache leaf, each gradient): 1e-5 relative to the
tensor's scale, because an elementwise relative limit means nothing for the
elements that cancel to near 0. bfloat16: one Mamba2 block's output and
conv rows within ``tests/test_kernels.py``'s 5e-2 (rtol and atol). The SSM
state sums dt x B over many steps and cancels near 0, and the whole model's
logits and caches carry bf16 sums of 5 layers: the two frameworks round to
bf16 at different places (XLA's CPU fusions keep float32 between
elementwise operations, torch rounds after each), each layer adds about one
bf16 ulp (2^-8 relative) and the layers compound it, so a few elements of
thousands pass 5e-2 while the tensor agrees to ~1.5e-2. Those are held to
a relative L2 error of 5e-2 over the whole tensor instead.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import zamba2_1p2b as j_zamba  # noqa: E402
from repro.kernels.ssm_scan import kernel as JSK  # noqa: E402
from repro.kernels.ssm_scan import ref as JSR  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import zamba2_1p2b as t_zamba  # noqa: E402
from repro_torch.convert import (param_shapes, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels.ssm_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as SR  # noqa: E402
from repro_torch.models import HybridLM, LM  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten, serving_params  # noqa: E402
from repro_torch.serving import RequestScheduler, ServeEngine  # noqa: E402
from repro_torch.serving import TPServeEngine  # noqa: E402

F32_REL = 1e-5
BF16 = dict(rtol=5e-2, atol=5e-2)
BF16_REL_L2 = 5e-2
# (B, T, H, P, N, bt): tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [(1, 32, 2, 16, 8, 8), (2, 64, 1, 8, 16, 16),
              (1, 48, 4, 16, 4, 16)]
MAX_LEN = 24


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_f32(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= F32_REL * np.abs(want).max(), \
        f"{what}: max|d| {err} against max|ref| {np.abs(want).max()}"


def assert_bf16(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **BF16)


def assert_rel_l2(got, want, limit, what=""):
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= limit, f"{what}: relative L2 error {rel}"


def scan_inputs(B, T, H, P, N, seed=0):
    """float32 numpy inputs of the scan, as the Mamba2 block makes them:
    dt = softplus(.) > 0 and A = -exp(.) < 0."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (f(B, T, H, P), np.log1p(np.exp(f(B, T, H))),
            -np.exp(0.3 * f(H)), f(B, T, N), f(B, T, N))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke params as a numpy tree (param_dtype float32)."""
    p = j_build(j_zamba.smoke_config()).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _models(ref_params, dtype: str, use_kernels: bool = False):
    jcfg = j_zamba.smoke_config(dtype=getattr(jnp, dtype),
                                use_kernels=use_kernels)
    tcfg = t_zamba.smoke_config(dtype=getattr(torch, dtype))
    tm = t_build(tcfg, device="cpu")
    tp = serving_params(params_from_jax(ref_params, tcfg, device="cpu"),
                        tcfg, tm.device)
    return j_build(jcfg), tm, tp


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(1, 512, (B, S)).astype(np.int32)


def _assert_close(dtype, got, want, what=""):
    """A model-level output: float32 to 1e-5, bf16 to a relative L2 of
    5e-2 (see the module's docstring)."""
    if dtype == "float32":
        assert_f32(got, want, what)
    else:
        assert_rel_l2(got, want, BF16_REL_L2, what)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_matches_reference_field_by_field(which):
    j = getattr(j_zamba, which)()
    t = getattr(t_zamba, which)()
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
    assert t.param_count() == j.param_count()
    assert getattr(t_configs, "get_config" if which == "config"
                   else which)("zamba2-1.2b") == t


def test_full_width_param_count():
    """zamba2-1.2b at full width: ~1.170 B parameters."""
    assert round(t_zamba.config().param_count() / 1e9, 3) == 1.170


# ---------------------------------------------------------------------------
# the SSD scan: plain version, autograd Function, wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_scan_matches_pallas_and_ref(shape, dtype):
    """The plain scan against the Pallas kernel (interpret mode) and the
    reference's sequential scan, final state included. bf16 inputs are
    cast to float32 by all three, so the float32 limit holds."""
    B, T, H, P, N, bt = shape
    ins = scan_inputs(B, T, H, P, N)
    jin = [jnp.asarray(a) for a in ins]
    tin = [torch.from_numpy(a) for a in ins]
    if dtype == "bfloat16":   # A stays float32, as the block gives it
        jin = [a if i == 2 else a.astype(jnp.bfloat16)
               for i, a in enumerate(jin)]
        tin = [a if i == 2 else a.bfloat16() for i, a in enumerate(tin)]
    y, h = SR.ssd_scan_ref(*tin)
    assert y.dtype == h.dtype == torch.float32
    assert_f32(y, JSK.ssd_scan(*jin, bt=bt), "y vs the Pallas kernel")
    y_ref, h_ref = JB._ssd_scan_ref(*jin)
    assert_f32(y, y_ref, "y vs _ssd_scan_ref")
    assert_f32(h, h_ref, "final state vs _ssd_scan_ref")
    assert_f32(y, JSR.ssd_scan_ref(*jin), "y vs ssm_scan/ref.py")


def _jax_scan_grads(ins, gy, gh):
    """jax.grad of <y, gy> + <h, gh> through the reference's scan."""
    def f(*a):
        y, h = JB._ssd_scan_ref(*a)
        return (y * gy).sum() + (h * gh).sum()
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))


def _port_scan_grads(fn, ins, gy, gh):
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = fn(*tin)
    ((y * torch.from_numpy(gy)).sum()
     + (h * torch.from_numpy(gh)).sum()).backward()
    return [t.grad for t in tin]


def test_plain_scan_autograd_matches_jax_grad():
    """Autograd of the plain scan, over 3 checkpointed 64-step chunks."""
    ins = scan_inputs(1, 130, 2, 8, 4, seed=1)
    rng = np.random.RandomState(2)
    gy = rng.randn(1, 130, 2, 8).astype(np.float32)
    gh = rng.randn(1, 2, 8, 4).astype(np.float32)
    got = _port_scan_grads(SR.ssd_scan_ref, ins, gy, gh)
    for name, g, r in zip(("xh", "dt", "A", "Bm", "Cm"), got,
                          _jax_scan_grads(ins, gy, gh)):
        assert_f32(g, r, name)


@pytest.mark.parametrize("state_grad", [False, True])
def test_ssdscan_gradient_matches_jax_grad(monkeypatch, state_grad):
    """SSDScan (the kernel forward, autograd of the plain scan backward) on
    the CPU, its kernel launch replaced by the plain scan: the gradient of
    y (and of the final state) against jax.grad of the reference."""
    monkeypatch.setattr(SO, "_launch", lambda *a: SR.ssd_scan_ref(*a))
    ins = scan_inputs(2, 70, 2, 8, 4, seed=3)
    rng = np.random.RandomState(4)
    gy = rng.randn(2, 70, 2, 8).astype(np.float32)
    gh = rng.randn(2, 2, 8, 4).astype(np.float32) * state_grad
    got = _port_scan_grads(SO.SSDScan.apply, ins, gy, gh)
    for name, g, r in zip(("xh", "dt", "A", "Bm", "Cm"), got,
                          _jax_scan_grads(ins, gy, gh)):
        assert_f32(g, r, name)


def test_ssd_scan_sends_cpu_tensors_to_the_plain_version():
    ins = [torch.from_numpy(a) for a in scan_inputs(1, 9, 2, 32, 16)]
    k0, p0 = SO.ssd_scan.launches, SR.ssd_scan_ref.launches
    y = SO.ssd_scan(*ins)
    y2, h = SO.ssd_scan(*ins, return_state=True)
    assert (SO.ssd_scan.launches, SR.ssd_scan_ref.launches) == (k0, p0 + 2)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    assert h.shape == (1, 2, 32, 16)


class _Elsewhere:
    """Stands for a tensor on a device that is neither the CPU, a card nor
    meta (which traces shapes); the wrapper reads ``.device`` first."""
    device = torch.device("xpu")


def test_ssd_scan_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        SO.ssd_scan(*[_Elsewhere()] * 5)


def test_ssd_scan_input_checks():
    """The checks the wrapper runs before a launch on a card refuse what
    the kernel does not take."""
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                         scan_inputs(1, 5, 2, 64, 64))
    SO._check(xh, dt, A, Bm, Cm)
    SO._check(xh.bfloat16(), dt.bfloat16(), A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(ValueError, match="takes"):
        SO._check(xh[..., :16], dt, A, Bm[..., :8], Cm[..., :8])
    with pytest.raises(TypeError, match="xh is"):
        SO._check(xh.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SO._check(xh.half(), dt.half(), A, Bm.half(), Cm.half())
    with pytest.raises(TypeError, match="A must be float32"):
        SO._check(xh, dt, A.double(), Bm, Cm)
    with pytest.raises(ValueError, match="do not match"):
        SO._check(xh, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="is on"):
        SO._check(xh, dt, A, Bm.to("meta"), Cm)
    with pytest.raises(ValueError, match="empty"):
        SO._check(xh[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0])


def test_ssd_scan_refuses_bf16_layouts_tma_cannot_read():
    """The bf16 body reads xh, Bm and Cm by TMA: a base that is not
    16-byte aligned, a stride that is not a multiple of 8 elements or a
    last dimension that is not contiguous is refused before a launch. The
    float32 body reads any strides, and an extent of 1 may have any
    stride."""
    bf = torch.bfloat16
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                         scan_inputs(2, 5, 3, 64, 64))
    xh, dt, Bm, Cm = xh.to(bf), dt.to(bf), Bm.to(bf), Cm.to(bf)
    SO._check(xh, dt, A, Bm, Cm)
    # B and C cut from one (B, T, 2N + 1) tensor: an odd row stride
    wide = torch.zeros(2, 5, 2 * 64 + 1, dtype=bf)
    with pytest.raises(ValueError, match="Bm .* 16-byte aligned"):
        SO._check(xh, dt, A, wide[..., :64], Cm)
    SO._check(xh.float(), dt.float(), A, wide[..., :64].float(), Cm.float())
    # a base one element past an aligned one
    off = torch.zeros(2, 5, 65, dtype=bf)[..., 1:]
    with pytest.raises(ValueError, match="Cm .* 16-byte aligned"):
        SO._check(xh, dt, A, Bm, off)
    # the head dim not contiguous
    with pytest.raises(ValueError, match="xh .* contiguous in its last"):
        SO._check(torch.zeros(2, 5, 64, 3, dtype=bf).transpose(-1, -2), dt,
                  A, Bm, Cm)
    # one step of one sequence: no stride but the last is ever stepped over
    SO._check(xh[:1, :1], dt[:1, :1], A, wide[:1, :1, :64], Cm[:1, :1])


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _block(ref_params):
    """Group 0's first Mamba2 block: (reference params, port params)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0, 0]),
                                ref_params["groups"]["m"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_mix_prefill_and_decode_match(ref_params, dtype):
    """The block over a 9-token prompt (its output and state), then one
    decode step from that state."""
    jcfg = j_zamba.smoke_config(dtype=getattr(jnp, dtype))
    tcfg = t_zamba.smoke_config(dtype=getattr(torch, dtype))
    jp, tp = _block(ref_params)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 10, tcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    close = assert_f32 if dtype == "float32" else assert_bf16
    j_out, j_st = JB.mamba2_mix(jx[:, :9], jp, jcfg)
    t_out, t_st = TB.mamba2_mix(tx[:, :9], tp, tcfg)
    close(t_out, j_out, "prefill out")
    close(t_st["conv"], j_st["conv"], "conv state")
    _assert_close(dtype, t_st["ssm"], j_st["ssm"], "ssm state")
    j_out, j_st = JB.mamba2_mix(jx[:, 9:], jp, jcfg, state=j_st)
    t_out, t_st = TB.mamba2_mix(tx[:, 9:], tp, tcfg, state=t_st)
    close(t_out, j_out, "decode out")
    close(t_st["conv"], j_st["conv"], "decode conv state")
    _assert_close(dtype, t_st["ssm"], j_st["ssm"], "decode ssm state")


def test_mamba2_mix_short_input_has_no_state(ref_params):
    """Fewer than 3 steps leave no conv state, as in the reference."""
    cfg = t_zamba.smoke_config(dtype=torch.float32)
    _, tp = _block(ref_params)
    out, st = TB.mamba2_mix(torch.ones(1, 2, cfg.d_model), tp, cfg)
    assert st is None and out.shape == (1, 2, cfg.d_model)


# ---------------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------------


def test_lm_of_a_hybrid_config_is_the_hybrid_lm():
    cfg = t_zamba.smoke_config()
    dense = t_zamba.smoke_config(family="dense")
    assert type(t_build(cfg, device="cpu")) is HybridLM
    assert type(t_build(dense, device="cpu")) is LM
    with pytest.raises(ValueError, match="hybrid family"):
        HybridLM(dense, device="cpu")
    with pytest.raises(ValueError, match="dense family"):
        LM(cfg, device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(ref_params, dtype, use_kernels):
    jm, tm, tp = _models(ref_params, dtype, use_kernels)
    toks = _tokens(2, 12)
    want = jm.forward(jax.tree_util.tree_map(jnp.asarray, ref_params),
                      jnp.asarray(toks))
    got = tm.forward(tp, toks)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(dtype, got, want, "logits")


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_gradient_match_reference(ref_params, remat):
    """float32 loss and the gradient of every param leaf against
    jax.value_and_grad of the reference's loss."""
    from repro_torch.launch import value_and_grad
    jcfg = j_zamba.smoke_config(dtype=jnp.float32, remat=remat)
    tcfg = t_zamba.smoke_config(dtype=torch.float32, remat=remat)
    batch = {"tokens": _tokens(2, 11, seed=6)}
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    j_loss, j_grads = jax.value_and_grad(j_build(jcfg).loss)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    t_loss, t_grads = value_and_grad(
        t_build(tcfg, device="cpu"),
        params_from_jax(ref_params, tcfg, device="cpu"), batch)
    assert_f32(t_loss, j_loss, "loss")
    j_flat = dict(flatten(jax.tree_util.tree_map(np.asarray, j_grads)))
    for path, g in flatten(t_grads):
        assert_f32(g, j_flat[path], path)


@pytest.mark.parametrize("last_pos", [None, [8, 4]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_every_cache_leaf_match_reference(
        ref_params, dtype, last_pos):
    """Against the reference's plain path: its kernel path cannot prefill
    (the Pallas scan drops the final state, ROADMAP C2)."""
    jm, tm, tp = _models(ref_params, dtype)
    toks = _tokens(2, 9, seed=7)
    jl, jc = jm.prefill(jax.tree_util.tree_map(jnp.asarray, ref_params),
                        jnp.asarray(toks), max_len=MAX_LEN,
                        last_pos=None if last_pos is None
                        else jnp.asarray(last_pos))
    tl, tc = tm.prefill(tp, toks, max_len=MAX_LEN, last_pos=last_pos)
    _assert_close(dtype, tl, jl, "logits")
    assert set(tc) == set(jc)
    for key in jc:
        assert tc[key].shape == jc[key].shape, key
        assert str(tc[key].dtype).replace("torch.", "") == \
            jnp.dtype(jc[key].dtype).name, key
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _assert_close(dtype, tc[key], jc[key], key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_reference(ref_params, dtype):
    """Prefill 6 tokens, then decode 5 more fed by hand: logits and the
    cache after every step."""
    jm, tm, tp = _models(ref_params, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    toks = _tokens(2, 11, seed=8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :6]), max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, toks[:, :6], max_len=MAX_LEN)
    for i in range(6, 11):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        _assert_close(dtype, tl, jl, f"logits at step {i}")
        for key in ("conv", "ssm", "attn_k", "attn_v", "rem_conv", "rem_ssm"):
            _assert_close(dtype, tc[key], jc[key], f"{key} at step {i}")
        assert int(tc["len"]) == int(jc["len"]) == i + 1


def test_decode_matches_forward(ref_params):
    """The port alone, float32: teacher-forced decode logits equal the
    parallel forward's at the same positions (the scan against the
    one-token recurrence, B1 against B3's plain versions)."""
    _, tm, tp = _models(ref_params, "float32")
    toks = _tokens(1, 10, seed=9)
    ref = tm.forward(tp, toks)
    logits, cache = tm.prefill(tp, toks[:, :5], max_len=12)
    assert_f32(logits[0, 0], ref[0, 4], "prefill")
    for i in range(5, 10):
        logits, cache = tm.decode_step(tp, cache, toks[:, i:i + 1])
        assert_f32(logits[0, 0], ref[0, i], f"decode {i}")


def test_generate_greedy_tokens_equal_reference(ref_params):
    """float32 greedy generation through ServeEngine, token for token."""
    jm, tm, tp = _models(ref_params, "float32")
    prompts = _tokens(3, 7, seed=10)
    want = JServe(jm, jax.tree_util.tree_map(jnp.asarray, ref_params),
                  max_len=MAX_LEN).generate(prompts, 8)
    got = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_params_round_trip_and_init_shapes(ref_params):
    cfg = t_zamba.smoke_config()
    tp = params_from_jax(ref_params, cfg, device="cpu")
    back = params_to_numpy(tp)
    ref_flat = flatten(ref_params)
    assert [p for p, _ in flatten(back)] == [p for p, _ in ref_flat]
    for (path, a), (_, b) in zip(flatten(back), ref_flat):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert {p: tuple(np.shape(a)) for p, a in ref_flat} == param_shapes(cfg)
    init = t_build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in flatten(init)} == param_shapes(cfg)
    for path, t in flatten(init):   # the reference's constants
        want = {"dt_bias": 0.0, "a_log": 0.0, "d_skip": 1.0, "ln": 1.0,
                "ln2": 1.0, "final_norm": 1.0}.get(path.split("/")[-1])
        if want is not None:
            assert torch.all(t == want), path


def test_serving_params_cast_leaf_by_leaf(ref_params):
    """The leaves the reference casts at use go to bf16 once; RMSNorm
    scales and a_log stay float32."""
    cfg = t_zamba.smoke_config()
    sp = serving_params(params_from_jax(ref_params, cfg, device="cpu"), cfg,
                        torch.device("cpu"))
    f32 = {"ln", "ln2", "final_norm", "a_log"}
    got = {path: t.dtype for path, t in flatten(sp)}
    assert got == {path: torch.float32 if path.split("/")[-1] in f32
                   else torch.bfloat16 for path in param_shapes(cfg)}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_recurrent_family_refusals(ref_params):
    """As the reference: ragged prompts, per-row cache lengths and
    tensor-parallel serving need a KV-cache family; and a prompt shorter
    than the conv's 3 rows leaves no state to prefill."""
    _, tm, tp = _models(ref_params, "float32")
    eng = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu")
    prompts = _tokens(2, 6)
    with pytest.raises(ValueError, match="ragged prompts"):
        eng.generate(prompts, 2, prompt_lens=[6, 4])
    _, cache = tm.prefill(tp, prompts, max_len=MAX_LEN)
    cache["len"] = torch.tensor([6, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="per-sequence cache lengths"):
        tm.decode_step(tp, cache, torch.ones(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="KV-cache family"):
        TPServeEngine(tm, tp, max_len=MAX_LEN, local=eng, device="cpu")
    with pytest.raises(ValueError, match="KV-cache family"):
        RequestScheduler(TPServeEngine(tm, tp, max_len=MAX_LEN, device="cpu"),
                         n_slots=2, prefill_len=4)
    with pytest.raises(ValueError, match="3 tokens or more"):
        tm.prefill(tp, prompts[:, :2], max_len=MAX_LEN)
    with pytest.raises(ValueError, match="dense, audio, moe, vlm, hybrid "
                                         "and rwkv6 families"):
        t_build(dataclasses.replace(t_zamba.smoke_config(), family="encoder"),
                device="cpu")
