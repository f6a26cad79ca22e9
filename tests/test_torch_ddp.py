"""The port's data-parallel training path (``repro_torch.train``,
``repro_torch.checkpoint``) against the JAX package on the CPU.

Each reference run and its port twin start from the same params (the
reference's ``init``, loaded through ``params_from_jax``) and run on
each package's own ``build_world`` of the same geometry. The fabric's
virtual accounting must come out exactly equal (same gradient bytes,
bucket bounds and wire dtypes give the same timings); float32 losses
agree to 1e-5 relative, the bf16 smoke trainer's to 2e-2 (C5: the JAX
plain path scales q in bf16, the port in float32). Inside the port the
reference's byte-identity contracts hold exactly: flat, bucketed and
hooked losses are equal bit for bit.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.collectives import aligned_bucket_bounds  # noqa: E402
from repro.collectives import build_world as j_build_world  # noqa: E402
from repro.configs import gpt2_124m as j_gpt2  # noqa: E402
from repro.configs import rwkv6_3b as j_rwkv6  # noqa: E402
from repro.configs import zamba2_1p2b as j_zamba2  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import backward as j_backward  # noqa: E402
from repro.train import trainer as J  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.collectives import CollectiveError  # noqa: E402
from repro_torch.collectives import build_world as t_build_world  # noqa: E402
from repro_torch.configs import gpt2_124m as t_gpt2  # noqa: E402
from repro_torch.configs import rwkv6_3b as t_rwkv6  # noqa: E402
from repro_torch.configs import zamba2_1p2b as t_zamba2  # noqa: E402
from repro_torch.convert import param_shapes, params_from_jax  # noqa: E402
from repro_torch.models.lm import flatten, unflatten  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import BackwardScheduler  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

LOSS_F32 = dict(rtol=1e-5, atol=0)
LOSS_BF16 = dict(rtol=2e-2, atol=0)
# the virtual accounting that must match exactly
EXACT = ("comm_time", "step_grad_times", "peak_works", "step_peak_works",
         "overlap_fraction", "first_issue_offsets", "fallbacks",
         "recoveries", "final_step", "restarts", "policy_ckpts",
         "policy_shrinks")
SMOKE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
             vocab=512)   # build_smoke_trainer's model
TWO_RANKS = dict(n_ranks=2, channels=2, max_chunk_bytes=1 << 14)
FOUR_RANKS_TWO_PODS = dict(n_ranks=4, channels=3, n_pods=2)

# one jitted reference backward a config: each reference trainer would
# otherwise compile its own
_J_GRAD = {}


def _losses(run):
    return [loss for _, _, loss in run.timeline]


def _tcfg(pkg, steps, ckpt_dir, **kw):
    """build_smoke_trainer's TrainerConfig, for ``pkg`` (J or T)."""
    return pkg.TrainerConfig(steps=steps, ckpt_every=max(2, steps // 2),
                             lr=3e-3, ckpt_dir=ckpt_dir, seed=0, **kw)


def _pair(tmp_path, dtype, steps, world_kw, lib_kind="shift", **kw):
    """(reference trainer, its world; port trainer, its world), both on
    the smoke trainer's model in ``dtype``, the port's params loaded from
    the reference's."""
    jcfg = j_gpt2.smoke_config(dtype=getattr(jnp, dtype), **SMOKE)
    tcfg = t_gpt2.smoke_config(dtype=getattr(torch, dtype), **SMOKE)
    jc, jlibs, jworld = j_build_world(lib_kind=lib_kind, **world_kw)
    jtr = J.DDPTrainer(jc, jlibs, jcfg,
                       _tcfg(J, steps, str(tmp_path / "ref"), **kw),
                       batch_per_rank=2, seq_len=32)
    if dtype not in _J_GRAD:
        _J_GRAD[dtype] = jtr._grad_fn
    jtr._grad_fn = _J_GRAD[dtype]
    ref_params = jax.tree_util.tree_map(np.asarray,
                                        jtr._init_state()["params"])
    tc, tlibs, tworld = t_build_world(lib_kind=lib_kind, **world_kw)
    ttr = T.DDPTrainer(tc, tlibs, tcfg,
                       _tcfg(T, steps, str(tmp_path / "port"), **kw),
                       batch_per_rank=2, seq_len=32, device="cpu")

    def init_state():
        params = params_from_jax(ref_params, tcfg, "cpu")
        return {"params": params, "opt": adamw_init(params, ttr.opt_cfg)}
    ttr._init_state = init_state
    return jtr, jworld, ttr, tworld


def _kill_after(cluster, at_step):
    def on_step(step, t, loss):
        if step == at_step:
            cluster.fail_nic("host1/mlx5_0")
    return on_step


def _assert_same_accounting(jrun, trun):
    for field in EXACT:
        assert getattr(trun, field) == getattr(jrun, field), field
    assert trun.slowdown_reschedule == jrun.slowdown_reschedule


# ---------------------------------------------------------------------------
# BackwardScheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gpt2", "zamba2", "rwkv6"])
def test_backward_scheduler_matches_reference(arch):
    jmod, tmod = {"gpt2": (j_gpt2, t_gpt2), "zamba2": (j_zamba2, t_zamba2),
                  "rwkv6": (j_rwkv6, t_rwkv6)}[arch]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    sds = jax.eval_shape(lambda k: j_build(jcfg).init(k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    meta = unflatten((path, torch.empty(shape, device="meta"))
                     for path, shape in param_shapes(tcfg).items())
    total = sum(int(np.prod(s)) for s in param_shapes(tcfg).values())
    bounds = aligned_bucket_bounds(total, 4, 1 << 12, max_chunk_bytes=1 << 10,
                                   n_ranks=2)
    ref = j_backward.BackwardScheduler(sds, bounds)
    port = BackwardScheduler(meta, bounds)
    assert len(bounds) > 20
    assert port.n_segments == ref.n_segments > 3
    assert port.bucket_ready == ref.bucket_ready
    assert [port.ready_after(s) for s in range(port.n_segments)] == \
        [ref.ready_after(s) for s in range(ref.n_segments)]
    assert port.stats() == ref.stats()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state_pair():
    """A reference trainer state (numpy) and the port's (tensors) holding
    the same values, params and AdamW moments."""
    jcfg = j_gpt2.smoke_config(dtype=jnp.float32)
    tcfg = t_gpt2.smoke_config(dtype=torch.float32)
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        j_build(jcfg).init(jax.random.PRNGKey(0)))
    mu = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    nu = jax.tree_util.tree_map(lambda a: a * a, params)
    ref = {"params": params,
           "opt": {"mu": mu, "nu": nu, "step": np.asarray(3, np.int32)}}
    port = {"params": params_from_jax(params, tcfg, "cpu"),
            "opt": {"mu": params_from_jax(mu, tcfg, "cpu"),
                    "nu": params_from_jax(nu, tcfg, "cpu"),
                    "step": torch.tensor(3, dtype=torch.int32)}}
    return ref, port


def _zeros_like_port(port):
    return unflatten((path, torch.zeros_like(t)) for path, t in flatten(port))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    ref, port = _state_pair()
    if writer == "ref":
        JStore(str(tmp_path), keep=2).save(
            5, ref, {"reason": "post-fallback"})
    else:
        CheckpointStore(str(tmp_path), keep=2).save(
            5, port, {"reason": "post-fallback"})
    d = tmp_path / "step-00000005"
    assert sorted(os.listdir(d)) == ["committed", "meta.json", "state.npz"]
    assert json.loads((d / "meta.json").read_text())["reason"] == \
        "post-fallback"
    keys = sorted(np.load(d / "state.npz").files)
    assert keys == sorted(path for path, _ in flatten(port))
    # the port restores tensors of its template's dtypes
    got, meta = CheckpointStore(str(tmp_path)).restore(
        _zeros_like_port(port))
    assert meta["step"] == 5
    for (path, t), (_, want) in zip(flatten(got), flatten(port)):
        assert t.dtype == want.dtype and torch.equal(t, want), path
    # the reference restores the same values
    jtemplate = jax.tree_util.tree_map(np.zeros_like, ref)
    jgot, _ = JStore(str(tmp_path)).restore(jtemplate)
    for (path, a), (_, want) in zip(flatten(jgot), flatten(port)):
        np.testing.assert_array_equal(np.asarray(a), want.numpy(),
                                      err_msg=path)


def test_checkpoint_stream_is_the_references_bytes(tmp_path):
    """The background-class replication puts the reference's first 64 KiB
    on the fabric (only that prefix is gathered from the state)."""
    ref, port = _state_pair()
    _, _, jworld = j_build_world(**TWO_RANKS)
    jstore = JStore(str(tmp_path / "ref"))
    jstore.attach_world(jworld)
    jstore.save(1, ref)
    _, _, tworld = t_build_world(**TWO_RANKS)
    tstore = CheckpointStore(str(tmp_path / "port"))
    tstore.attach_world(tworld)
    tstore.save(1, port)
    jw, tw = jstore._stream[0], tstore._stream[0]
    assert tstore.streamed_bytes == jstore.streamed_bytes == 1 << 16
    assert jstore.drain_stream() == tstore.drain_stream() == 1
    assert tworld.sim.now == jworld.sim.now
    np.testing.assert_array_equal(tw.result()[1], jw.result()[1])


def _tree(val: float):
    return {"w": torch.full((64, 64), val), "b": torch.full((64,), val * 2)}


CHILD_PRELUDE = """
import torch
from repro_torch.checkpoint.store import CheckpointStore
store = CheckpointStore({root!r}, keep=2, async_save=True)
tree = {{"w": torch.full((64, 64), {val}), "b": torch.full((64,), {val} * 2)}}
"""


def _child(code, tmp_path, check=True):
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], check=check, env=env,
                   cwd=str(tmp_path), timeout=120)


def test_crash_async_save_exit_without_wait(tmp_path):
    root = str(tmp_path / "ckpt")
    _child(CHILD_PRELUDE.format(root=root, val=3.0) + "store.save(7, tree)\n",
           tmp_path)
    store = CheckpointStore(root, keep=2)
    assert store.list_steps() == [7]
    restored, meta = store.restore(_tree(0.0))
    assert meta["step"] == 7
    assert torch.equal(restored["w"], _tree(3.0)["w"])


def test_crash_async_save_hard_crash_leaves_no_torn_state(tmp_path):
    root = str(tmp_path / "ckpt")
    _child(CHILD_PRELUDE.format(root=root, val=5.0)
           + "store.save(1, tree)\nstore.wait()\n"
           + "store.save(2, tree)\n"
           + "import os; os._exit(0)\n", tmp_path, check=False)
    store = CheckpointStore(root, keep=2)
    steps = store.list_steps()
    assert 1 in steps
    for s in steps:
        restored, meta = store.restore(_tree(0.0), step=s)
        assert meta["step"] == s
        assert torch.equal(restored["w"], _tree(5.0)["w"])


def test_crash_torn_directory_is_invisible(tmp_path):
    root = str(tmp_path / "ckpt")
    store = CheckpointStore(root, keep=3)
    store.save(10, _tree(1.0))
    torn = os.path.join(root, "step-00000099")
    os.makedirs(torn)
    with open(os.path.join(torn, "state.npz"), "wb") as f:
        f.write(b"\x00garbage")
    assert store.list_steps() == [10]
    assert store.latest_step() == 10
    _, meta = store.restore(_tree(0.0))
    assert meta["step"] == 10
    with pytest.raises(FileNotFoundError):
        store.restore(_tree(0.0), step=99)


def test_crash_same_step_overwrite_and_gc_stay_committed(tmp_path):
    root = str(tmp_path / "ckpt")
    store = CheckpointStore(root, keep=2, async_save=True)
    for step, val in [(10, 1.0), (10, 1.5), (20, 2.0), (30, 3.0)]:
        store.save(step, _tree(val))
    store.wait()
    assert store.list_steps() == [20, 30]
    restored, meta = store.restore(_tree(0.0), step=20)
    assert meta["step"] == 20
    assert torch.equal(restored["w"], _tree(2.0)["w"])
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]


# ---------------------------------------------------------------------------
# DDPTrainer against the reference
# ---------------------------------------------------------------------------

MODES = {
    "flat": (TWO_RANKS, dict(bucket_bytes=0), 3, None),
    "bucketed": (TWO_RANKS, dict(bucket_bytes=1 << 16), 3, None),
    "sequential": (TWO_RANKS, dict(bucket_bytes=1 << 16, overlap=False), 3,
                   None),
    "hooked": (TWO_RANKS, dict(bucket_bytes=1 << 16, issue_as_produced=True,
                               layer_compute_s=2e-4), 3, None),
    "grad_compress": (TWO_RANKS, dict(bucket_bytes=1 << 16,
                                      grad_compress=True), 3, None),
    "hierarchical-compress_dcn": (FOUR_RANKS_TWO_PODS, dict(
        bucket_bytes=1 << 18, hierarchical=True, compress_dcn=True), 2, None),
    "hierarchical-plain_dcn": (FOUR_RANKS_TWO_PODS, dict(
        bucket_bytes=1 << 18, hierarchical=True, compress_dcn=False), 2,
        None),
    "shift-nic-kill": (TWO_RANKS, dict(bucket_bytes=1 << 16), 3, 1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_ddp_trainer_matches_reference(tmp_path, mode):
    world_kw, kw, steps, kill = MODES[mode]
    jtr, jworld, ttr, tworld = _pair(tmp_path, "float32", steps, world_kw,
                                     **kw)
    hooks = [None, None] if kill is None else \
        [_kill_after(jtr.cluster, kill), _kill_after(ttr.cluster, kill)]
    jrun = jtr.train(jworld, on_step=hooks[0])
    trun = ttr.train(tworld, on_step=hooks[1])
    _assert_same_accounting(jrun, trun)
    assert trun.final_step == steps
    np.testing.assert_allclose(_losses(trun), _losses(jrun), **LOSS_F32)
    if kill is not None:
        assert trun.fallbacks >= 1
        # the §4.4 post-fallback save, as the reference made it
        assert CheckpointStore(ttr.tcfg.ckpt_dir).list_steps() == \
            JStore(jtr.tcfg.ckpt_dir).list_steps()
    if mode == "hooked":
        assert trun.overlap_fraction > 0


def test_bf16_smoke_trainer_matches_reference(tmp_path):
    jc, jlibs, jworld = j_build_world(**TWO_RANKS)
    jtr = J.build_smoke_trainer(jc, jlibs, steps=2,
                                ckpt_dir=str(tmp_path / "ref"))
    tc, tlibs, tworld = t_build_world(**TWO_RANKS)
    ttr = T.build_smoke_trainer(tc, tlibs, steps=2,
                                ckpt_dir=str(tmp_path / "port"),
                                device="cpu")
    assert ttr.model_cfg.dtype == torch.bfloat16
    ref_params = jax.tree_util.tree_map(np.asarray,
                                        jtr._init_state()["params"])

    def init_state():
        params = params_from_jax(ref_params, ttr.model_cfg, "cpu")
        return {"params": params, "opt": adamw_init(params, ttr.opt_cfg)}
    ttr._init_state = init_state
    jrun, trun = jtr.train(jworld), ttr.train(tworld)
    _assert_same_accounting(jrun, trun)
    np.testing.assert_allclose(_losses(trun), _losses(jrun), **LOSS_BF16)


def _restart_run(pkg, build_world, trainer):
    """4 steps on StandardLib ranks, host1's first NIC killed after step
    2: the crash, then ``resume_training`` on a fresh world."""
    cluster, libs, world = build_world(lib_kind="standard", **TWO_RANKS)
    trainer.cluster, trainer.libs = cluster, libs
    with pytest.raises(pkg.RestartNeeded) as ei:
        trainer.train(world, on_step=_kill_after(cluster, 2))
    rn = ei.value
    assert rn.step == 2 and rn.run.restarts == 1
    cluster.recover_nic("host1/mlx5_0")
    c2, libs2, world2 = build_world(lib_kind="standard", **TWO_RANKS)
    trainer.cluster, trainer.libs = c2, libs2
    return pkg.resume_training(trainer, world2, rn)


def test_standard_lib_restart_matches_reference(tmp_path):
    jtr, _, ttr, _ = _pair(tmp_path, "float32", 4, TWO_RANKS,
                           lib_kind="standard", bucket_bytes=1 << 16)
    jrun = _restart_run(J, j_build_world, jtr)
    trun = _restart_run(T, t_build_world, ttr)
    _assert_same_accounting(jrun, trun)
    assert trun.restarts == 1 and trun.final_step == 4
    assert trun.slowdown_reschedule == ttr.tcfg.reschedule_time
    np.testing.assert_allclose(_losses(trun), _losses(jrun), **LOSS_F32)


class _StubPolicy:
    """Duck-typed fault-policy engine: "checkpoint" after the second poll,
    "shrink" after the third."""

    def __init__(self):
        self.polls = 0

    def consume_trainer_actions(self):
        self.polls += 1
        return {"checkpoint": self.polls == 2, "shrink": self.polls == 3}


def test_policy_checkpoint_action_saves_as_the_reference(tmp_path):
    jtr, jworld, ttr, tworld = _pair(tmp_path, "float32", 3, TWO_RANKS,
                                     bucket_bytes=1 << 16)
    jtr.tcfg.ckpt_every = ttr.tcfg.ckpt_every = 100
    jtr.policy, ttr.policy = _StubPolicy(), _StubPolicy()
    jrun, trun = jtr.train(jworld), ttr.train(tworld)
    _assert_same_accounting(jrun, trun)
    assert (trun.policy_ckpts, trun.policy_shrinks) == (1, 1)
    steps = CheckpointStore(ttr.tcfg.ckpt_dir).list_steps()
    assert steps == JStore(jtr.tcfg.ckpt_dir).list_steps() == [2]
    meta = json.loads(open(os.path.join(ttr.tcfg.ckpt_dir, "step-00000002",
                                        "meta.json")).read())
    assert meta["reason"] == "post-fallback"


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def _port_smoke_run(tmp_path, name, **kw):
    cluster, libs, world = t_build_world(**TWO_RANKS)
    trainer = T.build_smoke_trainer(cluster, libs, steps=2,
                                    ckpt_dir=str(tmp_path / name),
                                    device="cpu", **kw)
    return trainer.train(world)


def test_port_flat_bucketed_hooked_bitwise_equal_hooked_faster(tmp_path):
    flat = _port_smoke_run(tmp_path, "flat", bucket_bytes=0,
                           layer_compute_s=2e-4)
    post = _port_smoke_run(tmp_path, "post", bucket_bytes=1 << 16,
                           layer_compute_s=2e-4)
    hook = _port_smoke_run(tmp_path, "hook", bucket_bytes=1 << 16,
                           issue_as_produced=True, layer_compute_s=2e-4)
    losses = [_losses(r) for r in (flat, post, hook)]
    assert losses[0] == losses[1] == losses[2]
    assert hook.overlap_fraction >= 0.5
    assert sum(hook.step_grad_times) < sum(post.step_grad_times)
    assert sum(hook.step_grad_times) < sum(flat.step_grad_times)
    assert all(0 < x < 4 * 2e-4 for x in hook.first_issue_offsets)
    assert hook.step_peak_works and all(p >= 4 for p in hook.step_peak_works)


def test_port_comm_timeout_names_the_stuck_bucket(tmp_path):
    cluster, libs, world = t_build_world(**TWO_RANKS)
    trainer = T.build_smoke_trainer(cluster, libs, steps=2,
                                    ckpt_dir=str(tmp_path), device="cpu",
                                    bucket_bytes=1 << 16, comm_timeout_s=0.0)
    vecs = [np.ones(40_000, np.float32) for _ in range(2)]
    with pytest.raises(CollectiveError) as ei:
        trainer._allreduce_grads(world, T.TrainRun(timeline=[]), vecs)
    msg = str(ei.value)
    assert "comm_timeout_s=0.0" in msg
    assert "bucket" in msg and "cid=" in msg


def test_port_trainer_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, libs, _ = t_build_world(**TWO_RANKS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_smoke_trainer(cluster, libs, ckpt_dir=str(tmp_path))
    assert T.TrainerConfig().ckpt_dir == os.path.join(tempfile.gettempdir(),
                                                      "repro-ckpt")
