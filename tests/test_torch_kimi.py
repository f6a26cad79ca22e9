"""kimi-k2 at head dim 112 on the CPU: the port's MoE LM against the JAX
package at kimi-k2-1t-a32b's own head dim, and the kernel wrappers at it.

kimi-k2-1t-a32b has d = 7168 over 64 query heads, a head dim of 112, which
the attention kernels (B1, B2a, B2b, B3) take beside 16, 32, 64 and 128.
Its smoke model keeps its 8 query heads over 2 K/V heads but takes
``head_dim=112``: float32, port against ``repro.models.build_model(cfg)``
on the same params (``params_from_jax``), to 1e-5 relative, for the
forward logits, the loss and every gradient, the prefill's logits and
cache, 6 decode steps and ``ServeEngine.generate``'s tokens. The wrappers'
meta branches (what the dry-run traces) give the kernels' shapes at hd 112,
and hd 96, which no kernel takes, is still refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import kimi_k2_1t as j_kimi  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import kimi_k2_1t as t_kimi  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

HD = 112
REL = 1e-5
MAX_LEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke model's tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, msg: str = "", rel: float = REL):
    """Elementwise within ``rel`` of the largest |want|."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rel,
                               atol=rel, err_msg=msg)


@pytest.fixture(scope="module")
def kimi():
    """(reference model's jitted entry points, its params, the port's
    model, its params): kimi-k2's smoke model at head dim 112, float32,
    remat "none", one set of params."""
    jcfg = j_kimi.smoke_config(dtype=jnp.float32, head_dim=HD, remat="none")
    tcfg = t_kimi.smoke_config(dtype=torch.float32, head_dim=HD,
                               remat="none")
    jm = j_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm = t_build(tcfg, device="cpu")
    return jm, jp, tm, params_from_jax(tree, tcfg, device="cpu")


def test_the_smoke_model_has_kimis_head_dim(kimi):
    jm, _, tm, tp = kimi
    assert tm.cfg.hd == jm.cfg.hd == HD == \
        t_kimi.config().d_model // t_kimi.config().n_heads
    assert tuple(tp["blocks"]["attn"]["wq"].shape) == \
        (2, tm.cfg.d_model, tm.cfg.n_heads, HD)
    assert HD in _build.HEAD_DIMS


def test_forward_loss_and_every_gradient_match_reference(kimi):
    jm, jp, tm, tp = kimi
    toks = np.random.RandomState(3).randint(0, 512, (2, 13)).astype(np.int32)
    _close(tm.forward(tp, toks[:, :-1]),
           jax.jit(jm.forward)(jp, jnp.asarray(toks[:, :-1])), "forward")
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tg = value_and_grad(tm, tp, {"tokens": toks})
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    want = dict(flatten(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(flatten(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        _close(g, want[path], path)


def test_prefill_cache_and_six_decode_steps_match_reference(kimi):
    jm, jp, tm, tp = kimi
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 512, (3, 9)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks), max_len=16)
    tl, tc = tm.prefill(tp, toks, max_len=16)
    _close(tl, jl, "prefill")
    assert set(tc) == set(jc)
    for name in sorted(tc):
        _close(tc[name], jc[name], f"cache {name}")
    step = jax.jit(jm.decode_step)
    for i in range(6):
        feed = rng.randint(0, 512, (3, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, feed)
        _close(tl, jl, f"decode step {i}")
    for name in ("k", "v"):
        _close(tc[name], jc[name], f"cache {name} after decoding")
    assert int(tc["len"]) == int(jc["len"]) == 15


def test_generate_tokens_equal_reference(kimi):
    jm, jp, tm, tp = kimi
    prompts = np.random.RandomState(5).randint(1, 512, (3, 9)).astype(
        np.int32)
    want = JServe(jm, jp, max_len=MAX_LEN).generate(prompts, 8)
    got = ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got, want)


def test_meta_branches_take_head_dim_112():
    """B1, B2a/B2b and B3 at kimi-k2's attention shape on meta tensors
    (what the dry-run traces): the kernels' checks pass, the outputs have
    the kernels' shapes and dtypes, and nothing is launched."""
    B, S, H, KV = 2, 40, 64, 8
    q = torch.empty(B, S, H, HD, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, KV, HD, dtype=torch.bfloat16, device="meta")
    counters = (FO.flash_attention, FO.flash_bwd_dq, FO.flash_bwd_dkv,
                DO.decode_attention)
    before = [f.launches for f in counters]
    o, lse = FO.flash_attention(q, k, k)
    assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
    assert (lse.shape, lse.dtype) == ((B, H, S), torch.float32)
    dq, dk, dv = FO.flash_attention_bwd(q, k, k, o, lse, q)
    assert [(g.shape, g.dtype) for g in (dq, dk, dv)] == \
        [(q.shape, torch.bfloat16), (k.shape, torch.bfloat16),
         (k.shape, torch.bfloat16)]
    od = DO.decode_attention(q[:, 0], k, k, 17)
    assert (od.shape, od.dtype) == ((B, H, HD), torch.bfloat16)
    assert all(t.device.type == "meta" for t in (o, lse, dq, dk, dv, od))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_head_dim_96_is_still_refused(device):
    """112 is in ``HEAD_DIMS``; a head dim no kernel has (96) is refused by
    the wrappers' checks, on the kernel path's meta branch too."""
    assert _build.HEAD_DIMS == (16, 32, 64, 112, 128)
    q = torch.zeros(1, 4, 8, 96, device=device)
    k = torch.zeros(1, 4, 2, 96, device=device)
    with pytest.raises(ValueError, match="head dim 96"):
        FO._check(q, k, k)
    with pytest.raises(ValueError, match="head dim 96"):
        DO._check(q[:, 0], k, k)
    if device == "meta":
        with pytest.raises(ValueError, match="head dim 96"):
            FO.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="head dim 96"):
            DO.decode_attention(q[:, 0], k, k, 3)
    q, k = q.new_zeros(1, 4, 8, HD), k.new_zeros(1, 4, 2, HD)
    FO._check(q, k, k)
    DO._check(q[:, 0], k, k)
