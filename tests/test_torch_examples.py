"""The port's entry points (``repro_torch.examples``) against the
reference's ``examples/`` on the CPU.

* ``quickstart`` prints the reference's bytes exactly (both run as
  subprocesses; the fabric is deterministic);
* ``serve_decode.serve`` gives the reference ``ServeEngine.generate``'s
  tokens on the float32 smoke configs, with the reference's params
  converted (C9), rwkv6 at a whole 64-token chunk (C7);
* ``serve_decode --tp`` prints the reference example's TP line (sync
  rounds and peak live collectives come from the virtual clock), and
  refuses the vlm, hybrid and rwkv6 families as the reference does;
* ``train_ddp_shift`` and its ``--baseline`` give the reference example's
  fallbacks, restarts, recoveries and virtual gradient-sync times
  exactly, and its losses within the bf16 limit, from the reference's
  params. The reference's baseline kills the NIC again when the restarted
  run reaches ``--fail-at`` and crashes uncaught (C13); the port kills it
  once, and its comparison run makes the reference's kill one-shot too;
* with no card, the entries' default device raises.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.collectives import CollectiveError as JCollectiveError  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServeEngine as JServe  # noqa: E402
from repro.train import trainer as J  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.examples import serve_decode as SD  # noqa: E402
from repro_torch.examples import train_ddp_shift as TD  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LOSS_BF16 = dict(rtol=2e-2, atol=0)     # tests/test_torch_ddp.py
# one arch a family, rwkv6 at a whole chunk (C7)
TOKEN_ARCHS = {"gpt2-124m": 16, "musicgen-medium": 16,
               "llama4-maverick-400b-a17b": 16, "zamba2-1.2b": 16,
               "llama-3.2-vision-90b": 16, "rwkv6-3b": 64}
GEN = 24                                # serve_decode's default --gen
DDP_ARGS = ["--steps", "4", "--fail-at", "2"]
# the run's accounting that must equal the reference's exactly
EXACT = ("fallbacks", "restarts", "recoveries", "step_grad_times",
         "final_step", "slowdown_reschedule")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str):
    """The reference's ``examples/<name>.py``, loaded as a module (its
    ``main`` reads ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(monkeypatch, name: str, argv) -> None:
    mod = _reference(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    mod.main()


def _tp_line(out: str) -> str:
    lines = [x for x in out.splitlines() if x.startswith("TP over")]
    assert len(lines) == 1, out
    return lines[0]


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_the_references_bytes():
    env = dict(os.environ, PYTHONPATH=SRC)
    runs = [subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           timeout=120)
            for cmd in ([sys.executable, "examples/quickstart.py"],
                        [sys.executable, "-m",
                         "repro_torch.examples.quickstart"])]
    for r in runs:
        assert r.returncode == 0, r.stderr.decode()
    assert runs[1].stdout == runs[0].stdout
    assert b"exactly-once, in order" in runs[0].stdout


# ---------------------------------------------------------------------------
# serve_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(TOKEN_ARCHS))
def test_serve_tokens_equal_reference_generate(arch):
    """float32 smoke config, the reference's params: ``serve`` gives the
    reference ``ServeEngine.generate``'s tokens, token for token."""
    S = TOKEN_ARCHS[arch]
    jcfg = j_configs.smoke_config(arch, dtype=jnp.float32)
    jm = j_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(0).randint(
        0, jcfg.vocab, size=(4, S)).astype(np.int32)
    want = JServe(jm, jp, max_len=S + GEN + 1).generate(prompts, n_tokens=GEN)
    tcfg = t_configs.smoke_config(arch, dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
    got, stats = SD.serve(tcfg, params, prompts, GEN, device="cpu")
    assert stats is None
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("arch", ["gpt2-124m", "llama4-maverick-400b-a17b"])
def test_tp_line_equals_the_reference_examples(monkeypatch, capsys, arch,
                                                channels):
    argv = ["--arch", arch, "--tp", "--channels", str(channels)]
    _run_reference(monkeypatch, "serve_decode", argv)
    want = _tp_line(capsys.readouterr().out)
    tokens, stats = SD.main(argv + ["--device", "cpu"])
    got = _tp_line(capsys.readouterr().out)
    assert got == want
    assert tokens.shape == (4, 16 + GEN)
    assert stats["reconstruction_mismatches"] == 0
    assert f"({stats['sync_rounds']} fabric sync rounds, peak " \
           f"{stats['peak_live_collectives']} live collectives)" in got
    if (arch, channels) == ("gpt2-124m", 1):
        assert got.endswith("(25 fabric sync rounds, peak 3 live "
                            "collectives)")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-1.2b",
                                  "rwkv6-3b"])
def test_tp_refuses_the_families_the_reference_refuses(monkeypatch, arch):
    with pytest.raises(ValueError, match="tensor-parallel"):
        _run_reference(monkeypatch, "serve_decode", ["--arch", arch, "--tp"])
    with pytest.raises(ValueError, match="tensor-parallel"):
        SD.main(["--arch", arch, "--tp", "--device", "cpu"])


# ---------------------------------------------------------------------------
# train_ddp_shift
# ---------------------------------------------------------------------------


def _reference_ddp(monkeypatch, tmp_path, argv, one_shot_kill: bool):
    """The reference example's TrainRun and its initial params (a numpy
    tree), with its checkpoints under ``tmp_path``; ``one_shot_kill``
    makes its NIC kill fire once per cluster and NIC, as the port's."""
    captured = {}
    train, init = J.DDPTrainer.train, J.DDPTrainer._init_state

    def capture_train(self, world, on_step=None):
        try:
            captured["run"] = train(self, world, on_step=on_step)
        except J.RestartNeeded as rn:
            captured["run"] = rn.run        # resume_training continues it
            raise
        return captured["run"]

    def capture_init(self):
        state = init(self)
        captured.setdefault("params", jax.tree_util.tree_map(
            np.asarray, state["params"]))
        return state

    monkeypatch.setattr(J.DDPTrainer, "train", capture_train)
    monkeypatch.setattr(J.DDPTrainer, "_init_state", capture_init)
    if one_shot_kill:
        fail, failed = j_fabric.Cluster.fail_nic, set()

        def fail_once(cluster, nic, *a, **kw):
            if (id(cluster), nic) not in failed:
                failed.add((id(cluster), nic))
                fail(cluster, nic, *a, **kw)
        monkeypatch.setattr(j_fabric.Cluster, "fail_nic", fail_once)
    mod = _reference("train_ddp_shift")
    monkeypatch.setattr(
        mod, "TrainerConfig",
        lambda **kw: J.TrainerConfig(**dict(kw, ckpt_dir=str(tmp_path))))
    monkeypatch.setattr(sys, "argv", ["train_ddp_shift.py"] + list(argv))
    mod.main()
    return captured["run"], captured["params"]


@pytest.mark.parametrize("baseline", [False, True])
def test_train_ddp_shift_accounting_equals_the_reference_examples(
        monkeypatch, tmp_path, baseline):
    argv = DDP_ARGS + (["--baseline"] if baseline else [])
    ref, ref_params = _reference_ddp(monkeypatch, tmp_path / "ref", argv,
                                     one_shot_kill=baseline)

    def init_state(self):
        params = params_from_jax(ref_params, self.model_cfg, self.device)
        return {"params": params, "opt": adamw_init(params, self.opt_cfg)}
    monkeypatch.setattr(T.DDPTrainer, "_init_state", init_state)
    run = TD.main(argv + ["--device", "cpu"])
    for field in EXACT:
        assert getattr(run, field) == getattr(ref, field), field
    assert [s for _, s, _ in run.timeline] == [s for _, s, _ in ref.timeline]
    np.testing.assert_allclose([x for _, _, x in run.timeline],
                               [x for _, _, x in ref.timeline], **LOSS_BF16)
    if baseline:
        assert (run.restarts, run.fallbacks, run.final_step) == (1, 0, 4)
        # steps 1-2, the crash, then steps 1-4 again from no checkpoint
        assert [s for _, s, _ in run.timeline] == [1, 2, 1, 2, 3, 4]
    else:
        assert run.restarts == 0 and run.fallbacks >= 1


def test_reference_baseline_kills_the_nic_again_on_the_rerun(monkeypatch,
                                                             tmp_path):
    """C13: the reference example's ``on_step`` fails host1/mlx5_0
    whenever a step numbered ``--fail-at`` ends; the restarted baseline
    runs that step again, so its fresh ranks crash a second time, outside
    the ``try``. The port's kill fires once."""
    with pytest.raises(JCollectiveError):
        _reference_ddp(monkeypatch, tmp_path, DDP_ARGS + ["--baseline"],
                       one_shot_kill=False)


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", [SD, TD], ids=["serve_decode",
                                                 "train_ddp_shift"])
def test_default_device_raises_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main([])
