"""The port's serving (``ServeEngine``, ``TPServeEngine`` in local mode,
``RequestScheduler``) against the JAX package at yi-6b's smoke width in
float32: greedy tokens must be equal, token for token.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import yi_6b as j_yi  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import RequestScheduler as JScheduler  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro.serving import TPServeEngine as JTP  # noqa: E402
from repro_torch.collectives import build_world  # noqa: E402
from repro_torch.configs import yi_6b as t_yi  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import RequestScheduler, ServeEngine  # noqa: E402
from repro_torch.serving import TPServeEngine  # noqa: E402

MAX_LEN = 32


@pytest.fixture(scope="module")
def setup():
    """JAX and port models with the same f32 params, plus prompts."""
    jcfg = j_yi.smoke_config(dtype=jnp.float32)
    tcfg = t_yi.smoke_config(dtype=torch.float32)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = t_build(tcfg, device="cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, tcfg.vocab, size=(3, 9)).astype(np.int32)
    return jm, jp, tm, tp, prompts


@pytest.fixture(scope="module")
def engines(setup):
    jm, jp, tm, tp, _ = setup
    return (JServe(jm, jp, max_len=MAX_LEN),
            ServeEngine(tm, tp, max_len=MAX_LEN, device="cpu"))


@pytest.mark.parametrize("lens", [None, [3, 9, 6]])
def test_generate_greedy_tokens_equal_reference(setup, engines, lens):
    prompts = setup[4]
    j_eng, t_eng = engines
    want = j_eng.generate(prompts, 8, prompt_lens=lens)
    got = t_eng.generate(prompts, 8, prompt_lens=lens)
    np.testing.assert_array_equal(got, want)


def test_tp_generate_local_mode_equals_reference(setup, engines):
    jm, jp, tm, tp, prompts = setup
    jt = JTP(jm, jp, world=None, max_len=MAX_LEN, local=engines[0])
    tt = TPServeEngine(tm, tp, world=None, max_len=MAX_LEN,
                       local=engines[1], device="cpu")
    for lens in (None, [2, 9, 5]):
        np.testing.assert_array_equal(
            tt.generate(prompts, 6, prompt_lens=lens),
            jt.generate(prompts, 6, prompt_lens=lens))
    assert tt.sync_rounds == jt.sync_rounds == 14


def test_sampled_generate_is_seeded(engines, setup):
    """Sampling uses a torch.Generator: the same seed gives the same
    tokens (not the reference's; only greedy decoding is compared)."""
    t_eng = engines[1]
    a = t_eng.generate(setup[4], 6, greedy=False, seed=3)
    b = t_eng.generate(setup[4], 6, greedy=False, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 15) and (a[:, 9:] < 512).all()


def test_generate_rejects_what_the_reference_rejects(setup, engines):
    prompts = setup[4]
    for eng in engines:
        with pytest.raises(ValueError, match="exceed"):
            eng.generate(prompts, MAX_LEN)
        with pytest.raises(ValueError, match="shape"):
            eng.generate(prompts, 2, prompt_lens=[3, 4])
        with pytest.raises(ValueError, match=r"\[1, S\]"):
            eng.generate(prompts, 2, prompt_lens=[0, 4, 4])


def _drive(jt_or_tt, sched_cls, plist, n_tokens, n_slots, prefill_len):
    sched = sched_cls(jt_or_tt, n_slots=n_slots, prefill_len=prefill_len)
    for p, n in zip(plist, n_tokens):
        sched.submit(p, n)
    sched.run()
    return sched


@pytest.mark.parametrize("case", ["mixed", "overflow"])
def test_scheduler_tokens_equal_reference(setup, case):
    """Continuous batching over TPServeEngine(world=None): the same
    requests give the same tokens and the same slot lengths. "overflow"
    is one 3-token prompt asking for 30 tokens with max_len=16: both the
    active and the free slot run past the end of the cache."""
    jm, jp, tm, tp, _ = setup
    rng = np.random.RandomState(1)
    if case == "mixed":
        max_len, n_slots, prefill_len = MAX_LEN, 2, 12
        plist = [rng.randint(1, 512, size=int(rng.randint(1, 13))
                             ).astype(np.int32) for _ in range(5)]
        n_tokens = [5, 1, 7, 3, 4]
    else:
        max_len, n_slots, prefill_len = 16, 2, 8
        plist = [rng.randint(1, 512, size=3).astype(np.int32)]
        n_tokens = [30]
    jt = JTP(jm, jp, world=None, max_len=max_len)
    tt = TPServeEngine(tm, tp, world=None, max_len=max_len, device="cpu")
    js = _drive(jt, JScheduler, plist, n_tokens, n_slots, prefill_len)
    ts = _drive(tt, RequestScheduler, plist, n_tokens, n_slots, prefill_len)
    assert [r.state for r in ts.requests] == ["done"] * len(plist)
    assert [len(r.tokens) for r in ts.requests] == n_tokens
    assert [r.tokens for r in ts.requests] == [r.tokens for r in js.requests]
    assert ts.decode_steps == js.decode_steps
    assert tt.sync_rounds == jt.sync_rounds
    lens = tt._cache["len"].tolist()
    assert lens == np.asarray(jt._cache["len"]).tolist()
    if case == "overflow":
        assert lens == [32, 29]


def test_scheduler_state_machine(setup):
    _, _, tm, tp, _ = setup
    tt = TPServeEngine(tm, tp, world=None, max_len=MAX_LEN, device="cpu")
    sched = RequestScheduler(tt, n_slots=1, prefill_len=8)
    a = sched.submit(np.array([5, 6, 7]), 3)
    b = sched.submit(np.array([8]), 1)
    assert sched.step() and a.state == "active" and b.state == "queued"
    sched.run()
    assert (a.state, b.state) == ("done", "done")
    assert (len(a.tokens), len(b.tokens)) == (3, 1)
    assert sched.fail_outstanding() == 0
    with pytest.raises(ValueError):
        sched.submit(np.array([1]), 0)
    with pytest.raises(ValueError, match="outside"):
        tt.admit(0, np.arange(9))


def test_tp_needs_world_none_and_start_batch(setup):
    """A world is taken (serving over the port's fabric gives the local
    tokens), and continuous batching still needs ``start_batch``."""
    _, _, tm, tp, prompts = setup
    _, _, world = build_world(n_ranks=2, max_chunk_bytes=1 << 12)
    tw = TPServeEngine(tm, tp, world=world, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(
        tw.generate(prompts, 3),
        TPServeEngine(tm, tp, max_len=MAX_LEN, device="cpu").generate(
            prompts, 3))
    assert tw.reconstruction_mismatches == 0
    tt = TPServeEngine(tm, tp, world=None, max_len=MAX_LEN, device="cpu")
    with pytest.raises(RuntimeError, match="start_batch"):
        tt.decode_batch(np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="prefill_len"):
        tt.start_batch(2, MAX_LEN + 1)
