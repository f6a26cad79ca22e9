"""Remat "dots" in the port: each layer (each group for vlm and hybrid)
is one selective checkpoint that keeps the outputs of the products with
no batch dims (``aten.mm`` / ``aten.addmm``) and recomputes the rest, as
the reference's ``jax.checkpoint`` with
``checkpoint_dots_with_no_batch_dims`` does.

For the dense, moe, vlm, hybrid and rwkv6 smoke configs in float32 on the
CPU: the loss and every gradient under "dots" equal "full"'s and "none"'s
bit for bit, and the reference's "dots" within 1e-5 relative; the
dry-run's traced temp bytes of a train step order none > dots > full.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.lm import flatten  # noqa: E402

FAMILIES = {"dense": "gpt2-124m", "moe": "kimi-k2-1t-a32b",
            "vlm": "llama-3.2-vision-90b", "hybrid": "zamba2-1.2b",
            "rwkv6": "rwkv6-3b"}
REL = 1e-5
# (tokens a row, seed) of the scan families' reference comparisons: the
# lengths of their own gradient tests (test_torch_hybrid.py: 11;
# test_torch_rwkv6.py: 71, two scan chunks, the second ragged). Their
# float32 gradients are conditioned by the input: at other lengths both
# frameworks' float32 results lie ~1e-5 to 5e-5 from a float64 run of the
# port, and from each other (ROADMAP C12).
REF_BATCH = {"hybrid": (11, 6), "rwkv6": (71, 6)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TREES = {}


def _ref_tree(arch):
    """The reference's smoke params (float32) as numpy, cached."""
    if arch not in _TREES:
        p = j_build(JC.smoke_config(arch)).init(jax.random.PRNGKey(0))
        _TREES[arch] = jax.tree_util.tree_map(np.asarray, p)
    return _TREES[arch]


def _batch(cfg, B=2, S=13, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.randn(
            B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
    return batch


def _port(arch, remat, batch, params=None):
    """(loss, grads) of the port's float32 smoke model under ``remat``, at
    the reference's params unless ``params`` are given."""
    cfg = C.smoke_config(arch, dtype=torch.float32, remat=remat)
    if params is None:
        params = params_from_jax(_ref_tree(arch), cfg, device="cpu")
    return value_and_grad(build_model(cfg, device="cpu"), params, batch)


def _assert_f32(got, want, what):
    """The float32 limit of the other port tests: max|d| <= 1e-5 max|ref|
    (exact zeros where the reference's are all zero)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), \
        f"{what}: max|d| {err} against max|ref| {np.abs(want).max()}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_equals_full_and_none_bit_for_bit(family):
    arch = FAMILIES[family]
    cfg = C.smoke_config(arch, dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    out = {r: _port(arch, r, batch, params)
           for r in ("none", "full", "dots")}
    for other in ("full", "none"):
        assert torch.equal(out["dots"][0], out[other][0]), other
        for (p, a), (_, b) in zip(flatten(out["dots"][1]),
                                  flatten(out[other][1])):
            assert torch.equal(a, b), (other, p)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_matches_the_reference_dots(family):
    arch = FAMILIES[family]
    jcfg = JC.smoke_config(arch, dtype=jnp.float32, remat="dots")
    S, seed = REF_BATCH.get(family, (13, 1))
    batch = _batch(C.smoke_config(arch), S=S, seed=seed)
    jp = jax.tree_util.tree_map(jnp.asarray, _ref_tree(arch))
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_build(jcfg).loss))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    t_loss, t_grads = _port(arch, "dots", batch)
    _assert_f32(t_loss, j_loss, "loss")
    j_flat = dict(flatten(jax.tree_util.tree_map(np.asarray, j_grads)))
    assert set(j_flat) == {p for p, _ in flatten(t_grads)}
    for path, g in flatten(t_grads):
        _assert_f32(g, j_flat[path], path)


def test_dots_keeps_the_products_and_recomputes_the_attention():
    """The policy keeps ``mm``/``addmm`` outputs only; the attention
    forward still runs twice a layer, as under "full"."""
    assert LM._dots_policy(None, torch.ops.aten.mm.default) == \
        LM.CheckpointPolicy.MUST_SAVE
    assert LM._dots_policy(None, torch.ops.aten.addmm.default) == \
        LM.CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.empty.memory_format):
        assert LM._dots_policy(None, op) == \
            LM.CheckpointPolicy.PREFER_RECOMPUTE
    cfg = C.smoke_config("gpt2-124m", dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    counts = {}
    for remat in ("none", "full", "dots"):
        FR.flash_attention_ref.launches = 0
        _port("gpt2-124m", remat, _batch(cfg), params)
        counts[remat] = FR.flash_attention_ref.launches
    L = cfg.n_layers
    assert counts == {"none": L, "full": 2 * L, "dots": 2 * L}


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_traced_temp_bytes_order_none_dots_full(family):
    """At 8 x 256 tokens, where the activations outweigh the AdamW update's
    copies of the smoke params."""
    temp = {}
    for remat in ("none", "full", "dots"):
        cfg = C.smoke_config(FAMILIES[family], remat=remat)
        temp[remat] = D._trace_pass(cfg, C.Shape("t", 256, 8, "train"),
                                    make_debug_mesh(1, 1))[
            "memory"]["temp_size_in_bytes"]
    assert temp["none"] > temp["dots"] > temp["full"]


def test_unknown_remat_raises_naming_the_policies():
    cfg = C.smoke_config("gpt2-124m", remat="offload")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="'none', 'full', 'dots'"):
        model.loss(params, _batch(cfg))
