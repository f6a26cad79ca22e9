"""The port's ``TPServeEngine`` over its own ``JcclWorld`` on the CPU.

Over a healthy fabric the engine's tokens equal the local engine's
(``world=None``) for greedy and sampled ``generate`` and for continuous
batching, on the dense (gpt2-124m smoke) and moe (llama4-maverick smoke)
families, with 0 reconstruction mismatches and every work of a step in
flight before the first wait. The bytes it puts on the wire are the
reference's (bf16 logits, each layer's K then V rows at the pre-step
length, clamped). The float32 llama4-maverick smoke model's scheduler
tokens equal the JAX ``TPServeEngine(world=None)``'s on converted params.
Admission prefills a dense prompt at its own length and a MoE prompt
padded to ``prefill_len``; both give the padded prefill's first token.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import llama4_maverick as j_llama4  # noqa: E402
from repro.configs import yi_6b as j_yi  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import RequestScheduler as JScheduler  # noqa: E402
from repro.serving import TPServeEngine as JTP  # noqa: E402
from repro_torch.collectives import build_world  # noqa: E402
from repro_torch.configs import gpt2_124m, llama4_maverick  # noqa: E402
from repro_torch.configs import yi_6b  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import RequestScheduler, ServeEngine  # noqa: E402
from repro_torch.serving import TPServeEngine  # noqa: E402
from repro_torch.serving import tp as TP  # noqa: E402

MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["dense", "moe"])
def setup(request):
    """(model, params, shared local engine, prompts) per family: moe
    exercises the expert all-to-all path, dense the gathers alone."""
    cfg = (gpt2_124m if request.param == "dense"
           else llama4_maverick).smoke_config()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    local = ServeEngine(model, params, max_len=MAX_LEN, device="cpu")
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, cfg.vocab, size=(2, 8)).astype(np.int32)
    return model, params, local, prompts


def _world(channels=1):
    _, _, world = build_world(n_ranks=2, probe_interval=5e-4,
                              max_chunk_bytes=1 << 12, strict_order=False,
                              fast=True, channels=channels)
    return world


def _tp(model, local, world):
    return TPServeEngine(model, None, world=world, max_len=MAX_LEN,
                         local=local, device="cpu")


def test_generate_over_the_fabric_equals_local_greedy_and_sampled(setup):
    model, _, local, prompts = setup
    tp = _tp(model, local, _world())
    ref = _tp(model, local, None)
    for lens in (None, [5, 8]):
        want = local.generate(prompts, 5, prompt_lens=lens)
        assert np.array_equal(ref.generate(prompts, 5, prompt_lens=lens),
                              want)
        assert np.array_equal(tp.generate(prompts, 5, prompt_lens=lens),
                              want)
    want = local.generate(prompts, 5, greedy=False, seed=3)
    assert np.array_equal(tp.generate(prompts, 5, greedy=False, seed=3),
                          want)
    assert tp.reconstruction_mismatches == 0
    # one sync a prefill and a decode step, the last decode's included
    assert tp.sync_rounds == 3 * (5 + 1)


def test_every_work_of_a_step_is_in_flight_before_the_first_wait(setup):
    """A decode step issues the logits gather, one gather a layer and (MoE)
    the expert dispatch before it waits on any of them."""
    model, _, local, prompts = setup
    world = _world()
    _tp(model, local, world).generate(prompts, 3)
    floor = 1 + model.cfg.n_layers + (model.cfg.family == "moe")
    assert world.stats_snapshot()["peak_live_collectives"] >= floor


def test_continuous_batching_over_the_fabric_equals_local(setup):
    model, _, local, _ = setup
    rng = np.random.RandomState(1)
    plist = [rng.randint(1, model.cfg.vocab, size=int(rng.randint(3, 11))
                         ).astype(np.int32) for _ in range(4)]

    def drive(world):
        eng = _tp(model, local, world)
        sched = RequestScheduler(eng, n_slots=2, prefill_len=12)
        for p in plist:
            sched.submit(p, 5)
        sched.run()
        return [list(r.tokens) for r in sched.requests], eng, sched

    ref, _, _ = drive(None)
    got, eng, sched = drive(_world(channels=2))
    assert got == ref
    assert eng.reconstruction_mismatches == 0
    assert eng.sync_rounds == len(plist) + sched.decode_steps


def test_a_corrupted_reconstruction_is_counted_and_reaches_the_tokens(
        setup, monkeypatch):
    """Sampling reads the fabric's bytes: a gather that hands back the
    logits shifted by one vocabulary entry changes the tokens and counts
    as a mismatch."""
    model, _, local, prompts = setup
    world = _world()
    real = world.gather_replicated_async

    def corrupt(buf, **kw):
        work = real(buf, **kw)
        result = work.result

        def bad():
            out = [np.array(r) for r in result()]
            if out[0].size == prompts.shape[0] * 2 * model.cfg.vocab:
                out[0] = np.roll(out[0], 2)  # one bf16 logit later
            return out
        work.result = bad
        return work

    monkeypatch.setattr(world, "gather_replicated_async", corrupt)
    tp = _tp(model, local, world)
    got = tp.generate(prompts, 3)
    assert tp.reconstruction_mismatches > 0
    assert not np.array_equal(got, local.generate(prompts, 3))


def test_tp_refuses_what_the_reference_refuses(setup):
    model, _, local, _ = setup
    tt = _tp(model, local, _world())
    with pytest.raises(RuntimeError, match="start_batch"):
        tt.decode_batch(np.zeros(2, np.int32))
    with pytest.raises(RuntimeError, match="start_batch"):
        tt.admit(0, np.arange(3))
    with pytest.raises(ValueError, match="prefill_len"):
        tt.start_batch(2, MAX_LEN + 1)
    with pytest.raises(ValueError, match="max_len mismatch"):
        TPServeEngine(model, None, max_len=MAX_LEN + 1, local=local,
                      device="cpu")


# ---------------------------------------------------------------------------
# the bytes on the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens", [None, [3, 40, 17]])
def test_kv_row_bytes_equal_the_references(lens):
    """Each layer's payload is the K rows then the V rows of the step, at
    the pre-step length clamped to the last row, as the reference packs
    them (a scalar and a (B,) length, one of them past the end)."""
    L, B, S, KV, hd = 2, 3, 32, 2, 16
    vals = torch.arange(L * B * S * KV * hd, dtype=torch.float32) % 251
    k = (vals / 7).reshape(L, B, S, KV, hd).to(torch.bfloat16)
    v = (-vals / 5).reshape(L, B, S, KV, hd).to(torch.bfloat16)
    prev = torch.tensor(40 if lens is None else lens, dtype=torch.int32)
    got = TP.TPServeEngine._step_kv_bytes(None, {"k": k, "v": v}, prev)
    jk = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    jv = jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    want = JTP._step_kv_bytes(None, {"k": jk, "v": jv}, np.asarray(prev))
    assert list(got) == list(want) == ["kv0", "kv1"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert got["kv0"].size == 2 * B * KV * hd * 2


def test_logit_bytes_are_the_bf16_bytes_and_come_back_exactly():
    logits = torch.randn(2, 1, 50, generator=torch.Generator().manual_seed(0)
                         ).to(torch.bfloat16)
    got = TP._host_bytes(logits)
    want = np.asarray(jnp.asarray(logits.float().numpy())
                      .astype(jnp.bfloat16)).reshape(-1).view(np.uint8)
    np.testing.assert_array_equal(got, want)
    back = torch.from_numpy(got.copy()).view(torch.bfloat16).view(2, 1, 50)
    assert torch.equal(back, logits)


# ---------------------------------------------------------------------------
# float32 tokens against JAX
# ---------------------------------------------------------------------------


def _f32_pair(jmod, tmod):
    """(JAX model, its params, port model, the same params) of a config
    module pair's float32 smoke model, params drawn by the reference."""
    jm = j_build(jmod.smoke_config(dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tmod.smoke_config(dtype=torch.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jm, jp, build_model(tcfg, device="cpu"), tp


def _schedulers(pair, plist, n_tokens, prefill_len=12):
    """The JAX and the port scheduler, each over its
    ``TPServeEngine(world=None)`` with 2 slots, run over the same
    requests."""
    jm, jp, tm, tp = pair
    scheds = []
    for sched_cls, engine in (
            (JScheduler, JTP(jm, jp, world=None, max_len=MAX_LEN)),
            (RequestScheduler, TPServeEngine(tm, tp, world=None,
                                             max_len=MAX_LEN,
                                             device="cpu"))):
        sched = sched_cls(engine, n_slots=2, prefill_len=prefill_len)
        for p, n in zip(plist, n_tokens):
            sched.submit(p, n)
        sched.run()
        scheds.append(sched)
    ref, port = scheds
    assert [r.state for r in port.requests] == ["done"] * len(plist)
    assert [r.tokens for r in port.requests] == \
        [r.tokens for r in ref.requests]
    return ref, port


def test_f32_moe_scheduler_tokens_equal_reference():
    """The float32 llama4-maverick smoke model, params from the reference:
    continuous batching over ``TPServeEngine(world=None)`` gives the JAX
    engine's tokens, request by request."""
    rng = np.random.RandomState(2)
    plist = [rng.randint(1, 512, size=int(rng.randint(3, 13))
                         ).astype(np.int32) for _ in range(5)]
    ref, port = _schedulers(_f32_pair(j_llama4, llama4_maverick), plist,
                            [5, 2, 7, 3, 4])
    assert port.decode_steps == ref.decode_steps


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_admission_prefills_at_the_prompt_length_unless_later_positions_count(
        family):
    """The float32 yi-6b (dense) and llama4-maverick (moe) smoke models,
    params from the reference. A dense prompt is prefilled at its own
    length: its first token is the padded prefill's and its cache rows
    [0, n) equal the padded prefill's; MoE's expert capacity counts the
    padding, so a MoE prompt is still prefilled padded to prefill_len.
    ``prefill_positions`` reads the positions run, and the scheduler's
    tokens equal the JAX engine's (which pads every prompt)."""
    pair = _f32_pair(*((j_yi, yi_6b) if family == "dense"
                       else (j_llama4, llama4_maverick)))
    tm, tp = pair[2:]
    assert tm.reads_later_positions == (family == "moe")
    prefill_len = 12
    rng = np.random.RandomState(3)
    plist = [rng.randint(1, 512, size=n).astype(np.int32)
             for n in (3, prefill_len, 7, 1, 10)]
    want_positions = sum(p.size for p in plist) if family == "dense" \
        else prefill_len * len(plist)

    tt = TPServeEngine(tm, tp, world=None, max_len=MAX_LEN, device="cpu")
    tt.start_batch(len(plist), prefill_len)
    for slot, p in enumerate(plist):
        n = p.size
        tok = tt.admit(slot, p)
        padded = np.zeros((1, prefill_len), np.int32)
        padded[0, :n] = p
        logits, pcache = tt._local._prefill(padded, last_pos=[n - 1])
        assert tok == int(logits[0, -1].argmax())
        for kv in ("k", "v"):
            torch.testing.assert_close(tt._cache[kv][:, slot, :n],
                                       pcache[kv][:, 0, :n],
                                       rtol=1e-5, atol=1e-5)
    assert tt._cache["len"].tolist() == [p.size for p in plist]
    assert tt.prefill_positions == want_positions

    _, port = _schedulers(pair, plist, [5, 2, 7, 3, 4], prefill_len)
    assert port.engine.prefill_positions == want_positions
