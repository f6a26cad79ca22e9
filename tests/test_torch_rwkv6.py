"""The port's rwkv6 family against the JAX package at rwkv6-3b's smoke width:
the RWKV6 scan's plain version and its autograd Function, the time and
channel mixes, the rwkv6 LM (forward, prefill, decode), its params, its
serving, and the refusals. One test pins a fact of the reference itself:
its plain prefill zeroes the state unless the prompt is a whole number of
64-step chunks (ROADMAP C7), which the port does not copy.

Reference params come from ``repro.models.build_model(cfg).init`` through
``params_from_jax``; inputs are made with numpy from a seed. The Pallas
RWKV6 kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.

Limits. The scan's plain version against the reference's and the Pallas
kernel: ``np.testing.assert_allclose`` at rtol and atol 1e-5. Gradients,
logits and cache leaves in float32: ``max |port - JAX| <= 1e-5 * max
|JAX|`` over each tensor, 1e-5 relative to the tensor's scale, as in
``tests/test_torch_hybrid.py``. bfloat16: the relative L2 error of the
whole tensor within 5e-2, ``tests/test_kernels.py``'s bf16 tolerance: the
two frameworks round to bf16 at other places (C5), and the reference's
plain scan rounds k v^T to bf16 where the port computes it in float32
(C8).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import rwkv6_3b as j_rwkv  # noqa: E402
from repro.configs import yi_6b as j_yi  # noqa: E402
from repro.configs import zamba2_1p2b as j_zamba  # noqa: E402
from repro.kernels.rwkv6_scan import kernel as JRK  # noqa: E402
from repro.kernels.rwkv6_scan import ref as JRR  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import rwkv6_3b as t_rwkv  # noqa: E402
from repro_torch.configs import yi_6b as t_yi  # noqa: E402
from repro_torch.configs import zamba2_1p2b as t_zamba  # noqa: E402
from repro_torch.convert import (param_shapes, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels.rwkv6_scan import ops as RO  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as RR  # noqa: E402
from repro_torch.models import LM, RwkvLM  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten, serving_params  # noqa: E402
from repro_torch.serving import ServeEngine, TPServeEngine  # noqa: E402

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
F32_REL = 1e-5
BF16_REL_L2 = 5e-2
# (B, T, H, N, bt): tests/test_kernels.py's RWKV_SHAPES, then rwkv6-3b's
# head size N = 64 over a whole chunk
RWKV_SHAPES = [(1, 32, 2, 16, 8), (2, 33, 1, 16, 16), (1, 64, 4, 8, 32),
               (2, 64, 2, 64, 64)]
MAX_LEN = 160
# the leaves serving_params cast before the rwkv6 family was ported
DENSE_HYBRID_CAST = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "embed", "lm_head", "w_in", "w_out", "w_conv", "dt_bias",
                     "d_skip")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_f32(got, want, what=""):
    err = rel_err(got, want)
    assert err <= F32_REL, f"{what}: max|d| / max|ref| = {err}"


def assert_rel_l2(got, want, limit, what=""):
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= limit, f"{what}: relative L2 error {rel}"


def _assert_close(dtype, got, want, what=""):
    if dtype == "float32":
        assert_f32(got, want, what)
    else:
        assert_rel_l2(got, want, BF16_REL_L2, what)


def scan_inputs(B, T, H, N, seed=0):
    """float32 numpy (r, k, v, w, u), scaled as tests/test_kernels.py's:
    the decay w in (0.45, 0.95), the bonus u of order 0.1."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    w = 0.5 / (1 + np.exp(-f(B, T, H, N))) + 0.45
    return f(B, T, H, N), f(B, T, H, N), f(B, T, H, N), \
        w.astype(np.float32), 0.1 * f(H, N)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke params as a numpy tree (param_dtype float32)."""
    p = j_build(j_rwkv.smoke_config()).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _models(ref_params, dtype: str, use_kernels: bool = False):
    jcfg = j_rwkv.smoke_config(dtype=getattr(jnp, dtype),
                               use_kernels=use_kernels)
    tcfg = t_rwkv.smoke_config(dtype=getattr(torch, dtype))
    tm = t_build(tcfg, device="cpu")
    tp = serving_params(params_from_jax(ref_params, tcfg, device="cpu"),
                        tcfg, tm.device)
    return j_build(jcfg), tm, tp


def _jp(ref_params):
    return jax.tree_util.tree_map(jnp.asarray, ref_params)


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(1, 512, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_matches_reference_field_by_field(which):
    j = getattr(j_rwkv, which)()
    t = getattr(t_rwkv, which)()
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
                   else which)("rwkv6-3b") == t


def test_full_width_config():
    """rwkv6-3b: 32 layers, d=2560, 40 heads of 64, d_ff=8960, vocab 65536,
    untied, ~3.273 B parameters."""
    cfg = t_rwkv.config()
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv_head_dim,
            cfg.rwkv_head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == \
        (32, 2560, 40, 64, 8960, 65536, False)
    assert round(cfg.param_count() / 1e9, 3) == 3.273


# ---------------------------------------------------------------------------
# the RWKV6 scan: plain version, autograd Function, wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_plain_scan_matches_pallas_and_ref(shape):
    """y against the Pallas kernel (interpret mode) and both reference
    scans, and the final state against the model's reference scan (no T
    here is padded by it: each is at most one chunk)."""
    B, T, H, N, bt = shape
    ins = scan_inputs(B, T, H, N)
    jin = [jnp.asarray(a) for a in ins]
    y, S = RR.rwkv6_scan_ref(*[torch.from_numpy(a) for a in ins])
    assert y.dtype == S.dtype == torch.float32
    assert S.shape == (B, H, N, N)
    np.testing.assert_allclose(_np(y), _np(JRK.rwkv6_scan(*jin, bt=bt)),
                               err_msg="y vs the Pallas kernel", **SCAN_TOL)
    np.testing.assert_allclose(_np(y), _np(JRR.rwkv6_scan_ref(*jin)),
                               err_msg="y vs rwkv6_scan/ref.py", **SCAN_TOL)
    y_ref, S_ref = JB._rwkv_scan_ref(*jin)
    np.testing.assert_allclose(_np(y), _np(y_ref),
                               err_msg="y vs _rwkv_scan_ref", **SCAN_TOL)
    np.testing.assert_allclose(_np(S), _np(S_ref),
                               err_msg="state vs _rwkv_scan_ref", **SCAN_TOL)


@pytest.mark.parametrize("T", [65, 100])
def test_plain_scan_state_at_a_ragged_length(T):
    """The final state after T steps, T not a multiple of 64. The reference
    pads to whole chunks with w = 0 and so zeroes its state (C7); fed steps
    with w = 1 and k = v = 0 up to the next multiple of 64 instead, it
    keeps the state after step T, which the port's scan of T steps must
    give."""
    ins = scan_inputs(2, T, 2, 64, seed=T)
    pad = (-T) % 64
    widths = ((0, 0), (0, pad), (0, 0), (0, 0))
    r, k, v = (np.pad(a, widths) for a in ins[:3])
    w = np.pad(ins[3], widths, constant_values=1.0)
    y_ref, S_ref = JB._rwkv_scan_ref(*map(jnp.asarray, (r, k, v, w, ins[4])))
    y, S = RR.rwkv6_scan_ref(*[torch.from_numpy(a) for a in ins])
    np.testing.assert_allclose(_np(y), _np(y_ref)[:, :T], **SCAN_TOL)
    np.testing.assert_allclose(_np(S), _np(S_ref), **SCAN_TOL)
    assert np.abs(_np(S)).max() > 0.1


def _jax_scan_grads(ins, gy, gS):
    """jax.grad of <y, gy> + <S, gS> through the model's reference scan."""
    def f(*a):
        y, S = JB._rwkv_scan_ref(*a)
        return (y * gy).sum() + (S * gS).sum()
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))


def _port_scan_grads(fn, ins, gy, gS):
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, S = fn(*tin)
    ((y * torch.from_numpy(gy)).sum()
     + (S * torch.from_numpy(gS)).sum()).backward()
    return [t.grad for t in tin]


# (T, whether the final state carries a gradient): the reference's state is
# the true one only at whole chunks (C7), so a state gradient needs T = 128
GRAD_CASES = [(130, False), (128, True)]


@pytest.mark.parametrize("T,state_grad", GRAD_CASES)
def test_plain_scan_autograd_matches_jax_grad(T, state_grad):
    """Autograd of the plain scan over checkpointed 64-step chunks (the
    last one shorter at T = 130), all five inputs' gradients."""
    ins = scan_inputs(1, T, 2, 16, seed=1)
    rng = np.random.RandomState(2)
    gy = rng.randn(1, T, 2, 16).astype(np.float32)
    gS = rng.randn(1, 2, 16, 16).astype(np.float32) * state_grad
    got = _port_scan_grads(RR.rwkv6_scan_ref, ins, gy, gS)
    for name, g, r in zip("rkvwu", got, _jax_scan_grads(ins, gy, gS)):
        assert_f32(g, r, name)


@pytest.mark.parametrize("T,state_grad", GRAD_CASES)
def test_rwkv6scan_gradient_matches_jax_grad(monkeypatch, T, state_grad):
    """RWKV6Scan (the kernel forward, autograd of the plain scan backward)
    on the CPU, its kernel launch replaced by the plain scan: the gradient
    of y (and of the final state) against jax.grad of the reference."""
    monkeypatch.setattr(RO, "_launch", lambda *a: RR.rwkv6_scan_ref(*a))
    ins = scan_inputs(2, T, 2, 64, seed=3)
    rng = np.random.RandomState(4)
    gy = rng.randn(2, T, 2, 64).astype(np.float32)
    gS = rng.randn(2, 2, 64, 64).astype(np.float32) * state_grad
    got = _port_scan_grads(RO.RWKV6Scan.apply, ins, gy, gS)
    for name, g, r in zip("rkvwu", got, _jax_scan_grads(ins, gy, gS)):
        assert_f32(g, r, name)


def test_rwkv6_scan_sends_cpu_tensors_to_the_plain_version():
    ins = [torch.from_numpy(a) for a in scan_inputs(1, 9, 2, 64)]
    k0, p0 = RO.rwkv6_scan.launches, RR.rwkv6_scan_ref.launches
    y, S = RO.rwkv6_scan(*ins)
    assert (RO.rwkv6_scan.launches, RR.rwkv6_scan_ref.launches) == (k0, p0 + 1)
    y2, S2 = RR.rwkv6_scan_ref(*ins)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(S, S2, rtol=0, atol=0)


class _Elsewhere:
    """Stands for a tensor on a device that is neither the CPU, a card nor
    meta (which traces shapes); the wrapper reads ``.device`` first."""
    device = torch.device("xpu")


def test_rwkv6_scan_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        RO.rwkv6_scan(*[_Elsewhere()] * 5)


def test_rwkv6_scan_input_checks():
    """The checks the wrapper runs before a launch on a card refuse what
    the kernel does not take."""
    r, k, v, w, u = (torch.from_numpy(a) for a in scan_inputs(1, 5, 2, 64))
    RO._check(r, k, v, w, u)
    RO._check(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    with pytest.raises(ValueError, match="takes 64 only"):
        RO._check(r[..., :32], k[..., :32], v[..., :32], w[..., :32],
                  u[:, :32])
    with pytest.raises(TypeError, match="k is"):
        RO._check(r.bfloat16(), k, v.bfloat16(), w, u)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RO._check(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="w must be float32"):
        RO._check(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="u must be float32"):
        RO._check(r, k, v, w, u.double())
    with pytest.raises(ValueError, match="do not match"):
        RO._check(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="is on"):
        RO._check(r, k, v, w.to("meta"), u)
    with pytest.raises(ValueError, match="empty"):
        RO._check(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)


# ---------------------------------------------------------------------------
# the time and channel mixes
# ---------------------------------------------------------------------------


def _block(ref_params):
    """Block 0's mixer params: (reference, port)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                ref_params["blocks"]["tm"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_prefill_and_decode_match(ref_params, dtype):
    """Each mix over a 9-token prompt (its output and state), then one
    decode step from that state."""
    jcfg = j_rwkv.smoke_config(dtype=getattr(jnp, dtype))
    tcfg = t_rwkv.smoke_config(dtype=getattr(torch, dtype))
    jp, tp = _block(ref_params)
    x = np.random.RandomState(5).randn(2, 10, tcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    for name, jf, tf in (("time mix", JB.rwkv6_time_mix, TB.rwkv6_time_mix),
                         ("channel mix", JB.rwkv6_channel_mix,
                          TB.rwkv6_channel_mix)):
        j_out, j_st = jf(jx[:, :9], jp, jcfg)
        t_out, t_st = tf(tx[:, :9], tp, tcfg)
        _assert_close(dtype, t_out, j_out, f"{name} prefill out")
        assert set(t_st) == set(j_st)
        for key in j_st:
            _assert_close(dtype, t_st[key], j_st[key], f"{name} {key}")
        j_out, j_st = jf(jx[:, 9:], jp, jcfg, state=j_st)
        t_out, t_st = tf(tx[:, 9:], tp, tcfg, state=t_st)
        _assert_close(dtype, t_out, j_out, f"{name} decode out")
        for key in j_st:
            _assert_close(dtype, t_st[key], j_st[key], f"{name} decode {key}")


# ---------------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------------


def test_lm_of_an_rwkv6_config_is_the_rwkv_lm():
    cfg = t_rwkv.smoke_config()
    assert type(t_build(cfg, device="cpu")) is RwkvLM
    with pytest.raises(ValueError, match="rwkv6 family"):
        RwkvLM(t_rwkv.smoke_config(family="dense"), device="cpu")
    with pytest.raises(ValueError, match="dense family"):
        LM(cfg, device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_reference(ref_params, use_kernels):
    """float32 logits against the reference's plain path and its Pallas
    kernel path (interpret mode), 1e-5 relative."""
    jm, tm, tp = _models(ref_params, "float32", use_kernels)
    toks = _tokens(2, 12)
    want = jm.forward(_jp(ref_params), jnp.asarray(toks))
    got = tm.forward(tp, toks)
    assert got.dtype == torch.float32
    assert_f32(got, want, "logits")


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_gradient_match_reference(ref_params, remat):
    """float32 loss and the gradient of every param leaf against
    jax.value_and_grad of the reference's loss, over 70 tokens: two
    checkpointed scan chunks, the second one ragged."""
    from repro_torch.launch import value_and_grad
    jcfg = j_rwkv.smoke_config(dtype=jnp.float32, remat=remat)
    tcfg = t_rwkv.smoke_config(dtype=torch.float32, remat=remat)
    batch = {"tokens": _tokens(2, 71, seed=6)}
    j_loss, j_grads = jax.value_and_grad(j_build(jcfg).loss)(
        _jp(ref_params), {"tokens": jnp.asarray(batch["tokens"])})
    t_loss, t_grads = value_and_grad(
        t_build(tcfg, device="cpu"),
        params_from_jax(ref_params, tcfg, device="cpu"), batch)
    assert_f32(t_loss, j_loss, "loss")
    j_flat = dict(flatten(jax.tree_util.tree_map(np.asarray, j_grads)))
    for path, g in flatten(t_grads):
        assert_f32(g, j_flat[path], path)


def _check_cache(dtype, tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        assert tc[key].shape == jc[key].shape, key
        assert str(tc[key].dtype).replace("torch.", "") == \
            jnp.dtype(jc[key].dtype).name, key
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _assert_close(dtype, tc[key], jc[key], key)


@pytest.mark.parametrize("S", [32, 64, 128])
def test_prefill_logits_and_every_cache_leaf_match_reference(ref_params, S):
    """float32, against the reference's plain path (its kernel path cannot
    prefill: the Pallas scan drops the final state, C2), at prompt lengths
    its chunk padding does not touch (C7)."""
    jm, tm, tp = _models(ref_params, "float32")
    toks = _tokens(2, S, seed=7)
    jl, jc = jm.prefill(_jp(ref_params), jnp.asarray(toks), max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, toks, max_len=MAX_LEN)
    assert_f32(tl, jl, "logits")
    _check_cache("float32", tc, jc)
    assert (np.abs(_np(tc["wkv"])).max(axis=(2, 3, 4)) > 0).all()


@pytest.mark.parametrize("S", [65, 100])
def test_decode_after_a_ragged_prompt_matches_forward(ref_params, S):
    """The port alone, float32, at prompt lengths that are not whole 64-step
    chunks: prefill's logits and the first decode step's equal forward's
    over the prompt and the next token (where the reference's own decode
    does not, C7)."""
    _, tm, tp = _models(ref_params, "float32")
    toks = _tokens(2, S + 1, seed=S)
    ref = tm.forward(tp, toks)
    logits, cache = tm.prefill(tp, toks[:, :S], max_len=MAX_LEN)
    assert_f32(logits[:, 0], ref[:, S - 1], "prefill")
    logits, cache = tm.decode_step(tp, cache, toks[:, S:])
    assert_f32(logits[:, 0], ref[:, S], "decode")
    assert int(cache["len"]) == S + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_reference(ref_params, dtype):
    """Prefill 6 tokens, then decode 5 more fed by hand: logits and the
    cache after every step."""
    jm, tm, tp = _models(ref_params, dtype)
    jp = _jp(ref_params)
    toks = _tokens(2, 11, seed=8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :6]), max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, toks[:, :6], max_len=MAX_LEN)
    _assert_close(dtype, tl, jl, "prefill logits")
    for i in range(6, 11):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        _assert_close(dtype, tl, jl, f"logits at step {i}")
        _check_cache(dtype, tc, jc)
        assert int(tc["len"]) == i + 1


def test_generate_greedy_tokens_equal_reference(ref_params):
    """float32 greedy generation through ServeEngine, token for token."""
    jm, tm, tp = _models(ref_params, "float32")
    prompts = _tokens(3, 7, seed=10)
    want = JServe(jm, _jp(ref_params), max_len=MAX_LEN).generate(prompts, 8)
    got = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bf16_forward_and_prefill_match_reference(ref_params, use_kernels):
    """bfloat16 logits of forward (both reference paths) and the prefill's
    logits and cache (the plain path), within the bf16 limit."""
    jm, tm, tp = _models(ref_params, "bfloat16", use_kernels)
    toks = _tokens(2, 12, seed=11)
    got = tm.forward(tp, toks)
    assert got.dtype == torch.bfloat16
    _assert_close("bfloat16", got,
                  jm.forward(_jp(ref_params), jnp.asarray(toks)), "logits")
    if not use_kernels:
        jl, jc = jm.prefill(_jp(ref_params), jnp.asarray(toks),
                            max_len=MAX_LEN)
        tl, tc = tm.prefill(tp, toks, max_len=MAX_LEN)
        _assert_close("bfloat16", tl, jl, "prefill logits")
        _check_cache("bfloat16", tc, jc)


# ---------------------------------------------------------------------------
# a fact of the reference the port does not copy (ROADMAP C7)
# ---------------------------------------------------------------------------


def test_reference_plain_prefill_zeroes_the_state_unless_whole_chunks(
        ref_params):
    """The JAX smoke model in float32 with use_kernels=False. Prefilled at
    T = 65, its chunked scan pads the prompt to 128 steps with w = 0, so
    cache["wkv"] is all zeros and its first decode step disagrees with its
    own forward by more than 0.1 (relative to forward's largest logit).
    At T = 64 the two agree to 1e-5."""
    jm = j_build(j_rwkv.smoke_config(dtype=jnp.float32))
    jp = _jp(ref_params)
    toks = _tokens(2, 66, seed=12)
    full = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    for T, zeroed in ((65, True), (64, False)):
        _, cache = jm.prefill(jp, jnp.asarray(toks[:, :T]), max_len=MAX_LEN)
        wkv = np.asarray(cache["wkv"])
        assert (np.abs(wkv).max() == 0) == zeroed, T
        logits, _ = jm.decode_step(jp, cache, jnp.asarray(toks[:, T:T + 1]))
        err = rel_err(logits[:, 0], full[:, T])
        if zeroed:
            assert err > 0.1, err
        else:
            assert err <= F32_REL, err


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_params_round_trip_and_init_shapes(ref_params):
    cfg = t_rwkv.smoke_config()
    tp = params_from_jax(ref_params, cfg, device="cpu")
    back = params_to_numpy(tp)
    ref_flat = flatten(ref_params)
    assert [p for p, _ in flatten(back)] == [p for p, _ in ref_flat]
    for (path, a), (_, b) in zip(flatten(back), ref_flat):
        np.testing.assert_array_equal(a, b, err_msg=path)
    init = t_build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {p: tuple(t.shape) for p, t in flatten(init)} == param_shapes(cfg)
    for path, t in flatten(init):   # the reference's constants
        name = path.split("/")[-1]
        want = {"w0": -0.5, "ln_x": 1.0, "ln1": 1.0, "ln2": 1.0,
                "final_norm": 1.0}.get(name, 0.5 if name.startswith("mu_")
                                       else None)
        if want is not None:
            assert torch.all(t == want), path


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_param_shapes_match_the_reference_tree(which):
    """Every leaf's path and shape against the reference's init, traced
    with jax.eval_shape (rwkv6-3b at full width is never materialised)."""
    tree = jax.eval_shape(j_build(getattr(j_rwkv, which)()).init,
                          jax.random.PRNGKey(0))
    want = {p: tuple(a.shape) for p, a in flatten(tree)}
    assert param_shapes(getattr(t_rwkv, which)()) == want


def test_serving_params_cast_leaf_by_leaf(ref_params):
    """rwkv6: the leaves the reference casts at use go to bf16 once; the
    RMSNorm scales, w0, u and ln_x stay float32."""
    cfg = t_rwkv.smoke_config()
    sp = serving_params(params_from_jax(ref_params, cfg, device="cpu"), cfg,
                        torch.device("cpu"))
    f32 = {"ln1", "ln2", "final_norm", "w0", "u", "ln_x"}
    got = {path: t.dtype for path, t in flatten(sp)}
    assert got == {path: torch.float32 if path.split("/")[-1] in f32
                   else torch.bfloat16 for path in param_shapes(cfg)}


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b"])
def test_serving_params_of_dense_and_hybrid_trees_unchanged(arch):
    """The rwkv6 leaf names added to the cast set name no leaf of the dense
    or hybrid tree: each is cast exactly as before."""
    j_arch, t_arch = {"yi-6b": (j_yi, t_yi),
                      "zamba2-1.2b": (j_zamba, t_zamba)}[arch]
    cfg = t_arch.smoke_config()
    tree = jax.tree_util.tree_map(
        np.asarray, j_build(j_arch.smoke_config()).init(
            jax.random.PRNGKey(0)))
    sp = serving_params(params_from_jax(tree, cfg, device="cpu"), cfg,
                        torch.device("cpu"))
    got = {path: t.dtype for path, t in flatten(sp)}
    assert got == {path: torch.bfloat16 if path.split("/")[-1]
                   in DENSE_HYBRID_CAST else torch.float32
                   for path in param_shapes(cfg)}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_recurrent_family_refusals(ref_params):
    """As the reference: ragged prompts, per-row cache lengths and
    tensor-parallel serving need a KV-cache family."""
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
    with pytest.raises(NotImplementedError, match="remat"):
        t_build(t_rwkv.smoke_config(remat="selective"),
                device="cpu").forward(tp, prompts)
