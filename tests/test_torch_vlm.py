"""The port's vlm family (``VlmLM``, llama-3.2-vision) against the JAX
package at its smoke width: 4 layers in 2 groups of one cross block and
one self block, d 128, 16 image tokens.

Reference params come from ``repro.models.build_model(cfg).init`` and are
loaded through ``params_from_jax``; inputs are made with numpy from a seed.
The reference initialises every cross block's gate to 0, so its image path
changes nothing (ROADMAP C11): the shared params here set the gates to
nonzero values and the image embeddings are random. Tolerances: float32
1e-5; bfloat16 5e-2 relative L2 (the frameworks round the scaled q at
different places, ROADMAP C5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import llama32_vision_90b as j_vlm  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill_step  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import llama32_vision_90b as t_vlm  # noqa: E402
from repro_torch.convert import param_shapes, params_from_jax  # noqa: E402
from repro_torch.launch import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.models import VlmLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.lm import flatten, serving_params  # noqa: E402
from repro_torch.serving import ServeEngine, TPServeEngine  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 5e-2
GATES = np.array([[0.7], [-0.45]], np.float32)   # one a group
B, S = 2, 9


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


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, dtype: str, msg: str = ""):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=msg)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2, msg


@pytest.fixture(scope="module")
def ref_tree():
    """The reference's smoke params as a numpy tree (float32), with the
    gates set nonzero."""
    p = jax.jit(j_build(j_vlm.smoke_config()).init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, p)
    assert not tree["cross_blocks"]["gate"].any()       # zero at init
    tree["cross_blocks"]["gate"] = GATES.copy()
    return tree


@pytest.fixture(scope="module")
def inputs():
    """(tokens (B, S), image embeddings (B, 16, 128)), from a seed."""
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 512, (B, S)).astype(np.int32)
    img = rng.randn(B, 16, 128).astype(np.float32)
    return toks, img


class _Jitted:
    """A reference LM's entry points under jit."""

    def __init__(self, model):
        self.model = model
        self.forward = jax.jit(model.forward)
        self.loss_and_grad = jax.jit(jax.value_and_grad(model.loss))
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)


def _models(tree, dtype="float32", use_kernels=False, **over):
    """(JAX model under jit, its params, port model, port serving params)."""
    jc = j_vlm.smoke_config(dtype=getattr(jnp, dtype),
                            use_kernels=use_kernels, **over)
    tc = t_vlm.smoke_config(dtype=getattr(torch, dtype), **over)
    tm = t_build(tc, device="cpu")
    tp = serving_params(params_from_jax(tree, tc, device="cpu"), tc,
                        tm.device)
    return _Jitted(j_build(jc)), jax.tree_util.tree_map(jnp.asarray, tree), \
        tm, tp


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_param_shapes_and_init_match_the_reference_tree(ref_tree):
    """Every leaf path and shape equals the reference's, in
    ``jax.tree_util`` order; the port's init draws the same tree with the
    reference's fan-ins and zero gates."""
    cfg = t_vlm.smoke_config()
    want = [(p, tuple(a.shape)) for p, a in flatten(ref_tree)]
    paths, _ = zip(*jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    jax_order = ["/".join(k.key for k in path) for path in paths]
    assert [p for p, _ in want] == jax_order
    assert param_shapes(cfg) == dict(want)
    tm = t_build(cfg, device="cpu")
    assert isinstance(tm, VlmLM)
    params = tm.init(torch.Generator().manual_seed(0))
    assert [(p, tuple(t.shape)) for p, t in flatten(params)] == want
    assert not params["cross_blocks"]["gate"].any()
    D, F = cfg.d_model, cfg.d_ff
    for path, fan_in in (("self_blocks/attn/wq", D),
                         ("cross_blocks/mlp/w_down", F),
                         ("self_blocks/mlp/w_down", F)):
        std = dict(flatten(params))[path].std().item()
        assert std == pytest.approx(fan_in ** -0.5, rel=0.1), path


def test_gate_is_cast_for_serving(ref_tree):
    tc = t_vlm.smoke_config()
    tp = serving_params(params_from_jax(ref_tree, tc, device="cpu"), tc,
                        "cpu")
    assert tp["cross_blocks"]["gate"].dtype == torch.bfloat16
    assert tp["cross_blocks"]["ln1"].dtype == torch.float32


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(ref_tree, inputs, dtype, use_kernels):
    """Logits against the reference's plain path and its Pallas kernels
    (interpret mode): causal self blocks, non-causal cross blocks over the
    16 image keys."""
    jm, jp, tm, tp = _models(ref_tree, dtype, use_kernels)
    toks, img = inputs
    _close(tm.forward(tp, toks, img),
           jm.forward(jp, jnp.asarray(toks), img_embeds=jnp.asarray(img)),
           dtype, "forward")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(ref_tree, inputs, remat):
    """``value_and_grad`` of the port's loss against
    ``jax.value_and_grad`` of the reference's, every leaf (the gates
    included), float32; remat "full" (one checkpoint a group) gives what
    "none" gives."""
    jm, jp, tm, _ = _models(ref_tree, remat=remat)
    tp = params_from_jax(ref_tree, tm.cfg, device="cpu")
    toks, img = inputs
    batch = {"tokens": toks, "image_embeds": img}
    jl, jg = jm.loss_and_grad(jp, {"tokens": jnp.asarray(toks),
                                   "image_embeds": jnp.asarray(img)})
    tl, tg = value_and_grad(tm, tp, batch)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = dict(flatten(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(flatten(tg))
    assert set(got) == set(want)
    assert np.abs(want["cross_blocks/gate"]).min() > 0
    for path, g in got.items():
        scale = max(np.abs(want[path]).max(), 1e-8)
        np.testing.assert_allclose(_np(g) / scale, want[path] / scale,
                                   rtol=1e-4, atol=1e-5, err_msg=path)
    if remat == "full":
        _, tg_none = value_and_grad(
            t_build(dataclasses.replace(tm.cfg, remat="none"), device="cpu"),
            tp, batch)
        for (path, a), (_, b) in zip(flatten(tg), flatten(tg_none)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       msg=path)


def test_remat_dots_raises_naming_the_roadmap_item():
    """Remat "dots" is ported (its own tests are in test_torch_remat.py):
    it runs; a name that is no remat policy raises, naming the three that
    are."""
    tm = t_build(t_vlm.smoke_config(remat="dots"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    assert torch.isfinite(tm.forward(params, np.zeros((1, 4), np.int32))
                          .float()).all()
    tm = t_build(t_vlm.smoke_config(remat="selective"), device="cpu")
    with pytest.raises(NotImplementedError, match="'none', 'full', 'dots'"):
        tm.forward(params, np.zeros((1, 4), np.int32))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_six_decode_steps_match_reference(ref_tree, inputs,
                                                      dtype):
    """The prefill's logits and every cache leaf, then 6 teacher-forced
    decode steps (the cross blocks over the cached image K/V)."""
    jm, jp, tm, tp = _models(ref_tree, dtype)
    toks, img = inputs
    jl, jc = jm.prefill(jp, jnp.asarray(toks), img_embeds=jnp.asarray(img),
                        max_len=16)
    tl, tc = tm.prefill(tp, toks, img, max_len=16)
    _close(tl, jl, dtype, "prefill")
    assert set(tc) == set(jc)
    for name in ("k", "v", "img_k", "img_v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name], dtype, name)
    assert int(tc["len"]) == int(jc["len"]) == S
    rng = np.random.RandomState(4)
    for step in range(6):
        f = rng.randint(0, 512, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(f))
        tl, tc = tm.decode_step(tp, tc, f)
        _close(tl, jl, dtype, f"decode step {step}")
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype, name)
    assert int(tc["len"]) == S + 6


def test_decode_agrees_with_forward(ref_tree, inputs):
    """A prefill of 4 tokens and 5 decode steps fed the rest give the
    logits ``forward`` gives at those positions (float32)."""
    _, _, tm, tp = _models(ref_tree)
    toks, img = inputs
    full = tm.forward(tp, toks, img)
    logits, cache = tm.prefill(tp, toks[:, :4], img, max_len=S)
    got = [logits]
    for t in range(4, S):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1])
        got.append(logits)
    np.testing.assert_allclose(_np(torch.cat(got, 1)), _np(full[:, 3:]),
                               **F32)


def test_prefill_step_with_images_matches_reference(ref_tree, inputs):
    """``make_prefill_step`` passes ``batch["image_embeds"]`` to the
    prefill, as the reference's does; ``make_decode_step`` then runs on
    its cache."""
    jm, jp, tm, tp = _models(ref_tree)
    toks, img = inputs
    jl, jc = j_prefill_step(jm.model)(jp, {"tokens": jnp.asarray(toks),
                                           "image_embeds": jnp.asarray(img)})
    tl, tc = make_prefill_step(tm)(tp, {"tokens": toks, "image_embeds": img})
    _close(tl, jl, "float32", "prefill step")
    jl_prefill = jl
    for name in ("img_k", "img_v", "k", "v"):
        _close(tc[name], jc[name], "float32", name)
    f = np.array([[3], [7]], np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(f))
    tl, _ = make_decode_step(tm)(tp, tc, f)
    _close(tl, jl, "float32", "decode step")
    # a cache long enough to generate from: the same prefill
    ll, lc = make_prefill_step(tm, max_len=16)(
        tp, {"tokens": toks, "image_embeds": img})
    _, pc = make_prefill_step(tm)(tp, {"tokens": toks, "image_embeds": img})
    assert tuple(lc["k"].shape[3:5]) == (16, 2)
    torch.testing.assert_close(lc["k"][:, :, :, :S], pc["k"][:, :, :, :S])
    _close(ll, jl_prefill, "float32", "prefill step, max_len=16")


def test_generate_with_zero_images_equals_the_reference_engine(ref_tree,
                                                               inputs):
    """``ServeEngine.generate`` passes no images, in the reference as in
    the port: greedy tokens equal, token for token (float32)."""
    jm, jp, tm, _ = _models(ref_tree)
    tp = params_from_jax(ref_tree, tm.cfg, device="cpu")
    toks = inputs[0]
    want = JServe(jm.model, jp, max_len=20).generate(toks, 8)
    got = ServeEngine(tm, tp, max_len=20, device="cpu").generate(toks, 8)
    np.testing.assert_array_equal(got, want)


def test_refusals_match_the_reference(ref_tree, inputs):
    """A (B,) length in ``decode_step`` raises the reference's
    ValueError; ragged prompts and tensor-parallel serving are refused, as
    the reference's engines refuse them."""
    jm, jp, tm, tp = _models(ref_tree)
    toks = inputs[0]
    lp = np.array([8, 4], np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=12,
                       last_pos=jnp.asarray(lp))
    _, tc = tm.prefill(tp, toks, max_len=12, last_pos=lp)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [9, 5]
    f = np.ones((B, 1), np.int32)
    with pytest.raises(ValueError, match="per-sequence cache lengths"):
        jm.model.decode_step(jp, jc, jnp.asarray(f))
    with pytest.raises(ValueError, match="per-sequence cache lengths"):
        tm.decode_step(tp, tc, f)
    with pytest.raises(ValueError, match="vlm family"):
        VlmLM(dataclasses.replace(tm.cfg, family="dense"), device="cpu")
    eng = ServeEngine(tm, tp, max_len=20, device="cpu")
    with pytest.raises(ValueError, match="ragged prompts"):
        eng.generate(toks, 2, prompt_lens=[9, 4])
    with pytest.raises(ValueError, match="KV-cache family"):
        TPServeEngine(tm, tp, max_len=20, local=eng, device="cpu")


# ---------------------------------------------------------------------------
# the cross path is live
# ---------------------------------------------------------------------------


def test_the_image_path_reaches_the_logits(ref_tree, inputs):
    """A guard against a dead cross path: other image embeddings give other
    logits, and with the gates at 0 any image gives the zero-image logits
    (as the reference's init does)."""
    _, _, tm, tp = _models(ref_tree)
    toks, img = inputs
    a = _np(tm.forward(tp, toks, img))
    b = _np(tm.forward(tp, toks, img[::-1].copy()))
    zero = _np(tm.forward(tp, toks))
    assert np.abs(a - b).max() > 1e-2
    assert np.abs(a - zero).max() > 1e-2
    closed = dict(tp, cross_blocks=dict(
        tp["cross_blocks"],
        gate=torch.zeros_like(tp["cross_blocks"]["gate"])))
    np.testing.assert_array_equal(_np(tm.forward(closed, toks, img)),
                                  _np(tm.forward(closed, toks)))
    # the prefill's image K/V differ with the images even so
    _, ca = tm.prefill(closed, toks, img)
    _, cz = tm.prefill(closed, toks)
    assert not torch.equal(ca["img_k"], cz["img_k"])
    assert not cz["img_k"].any()
