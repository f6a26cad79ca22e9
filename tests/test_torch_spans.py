"""The port's spans (``repro_torch.spans``) on the CPU.

With no profiler running, a span is one shared no-op context and records
nothing. Under ``torch.profiler`` each layer boundary opens its named
range: the scheduler's admission and decode, the TP engine's parts (the
fabric only with a world), the train step's forward, backward and AdamW,
the dense LM's head and loss, and a span opened inside a custom
``autograd.Function.backward``. The kernel wrappers open theirs only on
the card: their CPU and meta paths open none.
"""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.collectives import build_world
from repro_torch.configs import gpt2_124m
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.launch import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import RequestScheduler, TPServeEngine


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(fn):
    """Every ``repro_torch.*`` range that ``fn()`` opens under the
    profiler, with how often."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            name = e.name()[len(spans.PREFIX):]
            out[name] = out.get(name, 0) + 1
    return out


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"{name} recorded with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = spans.span("train.forward")
    assert first is spans.span("sched.decode") is spans.span("x", False)
    with first, spans.span("serve.decode.step"):
        pass


@pytest.fixture(scope="module")
def smoke():
    cfg = gpt2_124m.smoke_config()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_a_train_step_opens_its_parts_and_the_heads(smoke):
    cfg, model, params = smoke
    opt = AdamWConfig()
    state = adamw_init(params, opt)
    step = make_train_step(model, opt)
    tokens = torch.randint(0, cfg.vocab, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    got = _ranges(lambda: [step(params, state, {"tokens": tokens})
                           for _ in range(2)])
    assert got == {"train.forward": 2, "train.backward": 2,
                   "train.adamw": 2, "model.head": 2, "model.loss": 2}


@pytest.mark.parametrize("tp", [False, True], ids=["local", "fabric"])
def test_a_scheduler_tick_opens_admission_and_decode(smoke, tp):
    cfg, model, params = smoke
    world = build_world(n_ranks=2, probe_interval=5e-4,
                        max_chunk_bytes=1 << 12, strict_order=False)[2] \
        if tp else None
    engine = TPServeEngine(model, params, world=world, max_len=24,
                           device="cpu")
    sched = RequestScheduler(engine, n_slots=2, prefill_len=8)
    rng = np.random.RandomState(0)
    for n in (5, 8, 3):
        sched.submit(rng.randint(1, cfg.vocab, size=n), 3)
    ticks = []

    def run():
        while sched.pending:
            sched.step()
            ticks.append(1)

    got = _ranges(run)
    admits, decodes = 3, sched.decode_steps
    want = {"sched.admit": admits, "serve.admit.prefill": admits,
            "serve.admit.splice": admits, "serve.admit.readback": admits,
            "sched.decode": decodes, "serve.decode.feed": decodes,
            "serve.decode.step": decodes, "serve.decode.readback": decodes}
    if tp:
        want["serve.fabric"] = admits + decodes
    assert decodes == len(ticks)
    assert got == want


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with spans.span("test.backward"):
            return 2 * g


def test_a_span_inside_a_custom_backward_is_recorded():
    x = torch.ones(4, requires_grad=True)
    got = _ranges(lambda: _Twice.apply(x).sum().backward())
    assert got == {"test.backward": 1}


def test_the_wrappers_open_no_span_on_the_cpu_or_meta():
    def calls(device):
        q = torch.randn(1, 8, 2, 16, device=device)
        o, lse = flash_attention(q, q, q)
        flash_attention_bwd(q, q, q, o, lse, torch.randn_like(q))

    assert _ranges(lambda: calls("cpu")) == {}
    assert _ranges(lambda: calls("meta")) == {}
