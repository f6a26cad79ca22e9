"""The port stands alone: importing it, serving (dense, hybrid and rwkv6),
taking a train step and a data-parallel step over its own fabric on the
CPU loads neither ``jax`` nor any module of ``repro``; and it never moves
to the CPU on its own."""

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
from repro_torch.configs import gpt2_124m, rwkv6_3b, yi_6b, zamba2_1p2b
from repro_torch.launch import make_train_step
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
from repro_torch.collectives import build_world
from repro_torch.train import build_smoke_trainer
import tempfile
cluster, libs, world = build_world(n_ranks=2)
with tempfile.TemporaryDirectory() as ckpt:
    run = build_smoke_trainer(cluster, libs, steps=1, ckpt_dir=ckpt,
                              device="cpu").train(world)
assert run.final_step == 1 and np.isfinite(run.timeline[0][2])
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
    assert resolve_device("cpu") == torch.device("cpu")
