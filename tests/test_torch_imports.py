"""The port stands alone: importing it, serving (dense, audio, moe, vlm,
hybrid and rwkv6, and moe over its own fabric), taking a train step and a
data-parallel step over its own fabric on the CPU, running campaign
cells (``repro_torch.scenarios``, with ``repro_torch.policy`` imported; a
``serving`` cell among them), and the launch tooling
(``repro_torch.launch.{mesh,sharding,hook_dryrun,dryrun}``: a meta-device
trace and a readiness report) loads neither ``jax`` nor any module of
``repro``; nor do its entry points (``repro_torch.examples``); and it
never moves to the CPU on its own."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")

_PROGRAM = r"""
import sys
import numpy as np
import torch
import repro_torch
from repro_torch.configs import (gpt2_124m, llama32_vision_90b,
                                 llama4_maverick, musicgen_medium, rwkv6_3b,
                                 yi_6b, zamba2_1p2b)
from repro_torch.launch import (make_decode_step, make_prefill_step,
                                make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import RequestScheduler, ServeEngine, TPServeEngine

cfg = yi_6b.smoke_config(n_layers=1)
model = build_model(cfg, device="cpu")
params = model.init(torch.Generator().manual_seed(0))
eng = ServeEngine(model, params, max_len=16, device="cpu")
out = eng.generate(np.arange(1, 9, dtype=np.int32).reshape(2, 4), 3)
assert out.shape == (2, 7), out.shape
sched = RequestScheduler(TPServeEngine(model, params, max_len=16,
                                       local=eng, device="cpu"),
                         n_slots=2, prefill_len=4)
sched.submit(np.array([1, 2, 3]), 4)
sched.run()
tcfg = gpt2_124m.smoke_config(n_layers=1)
tmodel = build_model(tcfg, device="cpu")
tparams = tmodel.init(torch.Generator().manual_seed(0))
opt = AdamWConfig(lr=1e-3)
_, state, metrics = make_train_step(tmodel, opt)(
    tparams, adamw_init(tparams, opt),
    {"tokens": np.arange(18, dtype=np.int32).reshape(2, 9)})
assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
zcfg = zamba2_1p2b.smoke_config(n_layers=3)
zmodel = build_model(zcfg, device="cpu")
zeng = ServeEngine(zmodel, zmodel.init(torch.Generator().manual_seed(0)),
                   max_len=16, device="cpu")
out = zeng.generate(np.arange(1, 9, dtype=np.int32).reshape(2, 4), 3)
assert out.shape == (2, 7), out.shape
rcfg = rwkv6_3b.smoke_config(n_layers=1)
rmodel = build_model(rcfg, device="cpu")
reng = ServeEngine(rmodel, rmodel.init(torch.Generator().manual_seed(0)),
                   max_len=16, device="cpu")
out = reng.generate(np.arange(1, 9, dtype=np.int32).reshape(2, 4), 3)
assert out.shape == (2, 7), out.shape
vcfg = llama32_vision_90b.smoke_config()
vmodel = build_model(vcfg, device="cpu")
vparams = vmodel.init(torch.Generator().manual_seed(0))
veng = ServeEngine(vmodel, vparams, max_len=16, device="cpu")
out = veng.generate(np.arange(1, 9, dtype=np.int32).reshape(2, 4), 3)
assert out.shape == (2, 7), out.shape
img = np.random.RandomState(0).randn(2, vcfg.n_image_tokens, vcfg.d_model)
logits, cache = make_prefill_step(vmodel)(
    vparams, {"tokens": out[:, :4], "image_embeds": img})
logits, cache = make_decode_step(vmodel)(vparams, cache, out[:, 4:5])
assert logits.shape == (2, 1, vcfg.vocab), logits.shape
acfg = musicgen_medium.smoke_config(n_layers=1)
amodel = build_model(acfg, device="cpu")
aeng = ServeEngine(amodel, amodel.init(torch.Generator().manual_seed(0)),
                   max_len=16, device="cpu")
out = aeng.generate(np.arange(1, 9, dtype=np.int32).reshape(2, 4), 3,
                    prompt_lens=[4, 2])
assert out.shape == (2, 7), out.shape
from repro_torch.collectives import build_world
mcfg = llama4_maverick.smoke_config(n_layers=1)
mmodel = build_model(mcfg, device="cpu")
meng = ServeEngine(mmodel, mmodel.init(torch.Generator().manual_seed(0)),
                   max_len=16, device="cpu")
mtp = TPServeEngine(mmodel, None, world=build_world(n_ranks=2)[2],
                    max_len=16, local=meng, device="cpu")
prompts = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
assert (mtp.generate(prompts, 3) == meng.generate(prompts, 3)).all()
assert mtp.reconstruction_mismatches == 0
from repro_torch.train import build_smoke_trainer
import tempfile
cluster, libs, world = build_world(n_ranks=2)
with tempfile.TemporaryDirectory() as ckpt:
    run = build_smoke_trainer(cluster, libs, steps=1, ckpt_dir=ckpt,
                              device="cpu").train(world)
assert run.final_step == 1 and np.isfinite(run.timeline[0][2])
import repro_torch.policy
from repro_torch.scenarios import SCENARIOS, run_scenario
cell = run_scenario(SCENARIOS["sender_nic_down"], "pingpong")
assert cell.ok and cell.completed and cell.fallbacks >= 1, cell.violations
cell = run_scenario(SCENARIOS["rail_kill_striped"], "serving", device="cpu")
assert cell.ok and cell.completed and cell.fallbacks >= 1, cell.violations
import repro_torch.launch.mesh, repro_torch.launch.sharding
import repro_torch.launch.hook_dryrun
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch import configs as C
cell = dryrun._trace_pass(C.smoke_config("gpt2-124m"),
                          C.Shape("t", 8, 2, "train"), make_debug_mesh(1, 1))
assert cell["memory"]["temp_size_in_bytes"] > 0
report = repro_torch.launch.hook_dryrun.readiness_report("gpt2-124m")
assert report["n_segments"] == 14, report
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", _PROGRAM], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


_EXAMPLES = r"""
import sys
from repro_torch.examples import quickstart, serve_decode, train_ddp_shift
quickstart.main()
tokens, stats = serve_decode.main(["--device", "cpu", "--tp", "--gen", "3"])
assert tokens.shape == (4, 19) and stats["sync_rounds"] == 4, stats
run = train_ddp_shift.main(["--device", "cpu", "--steps", "2",
                            "--fail-at", "1"])
assert run.final_step == 2 and run.fallbacks >= 1, run
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_examples_import_neither_jax_nor_repro():
    """The three entry points, each run on the CPU in one process."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", _EXAMPLES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_default_device_raises_without_a_card(monkeypatch):
    """With no card, leaving ``device`` at its default raises instead of
    running on the CPU, for every entry point."""
    from repro_torch import resolve_device
    from repro_torch.configs import yi_6b
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine, TPServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = yi_6b.smoke_config(n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPServeEngine(model, params)
    from repro_torch.scenarios import SCENARIOS, run_scenario
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(SCENARIOS["baseline_clean"], "serving")
    assert resolve_device("cpu") == torch.device("cpu")
