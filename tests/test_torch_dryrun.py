"""The port's meta-device dry-run (``repro_torch.launch.dryrun``): its
scan corrections against the JAX package's for every cell, the kernel
wrappers' meta branches (the kernel path's checks and allocations, no
launch), the memory log, the trace of a train, prefill and decode step
for each family at smoke width, the counted FLOPs of a dense train step
against a closed form, and one full cell through ``run_cell``."""

import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as RO  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as RR  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as SR  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import flatten, serving_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COUNTED = (FO.flash_attention, FO.flash_bwd_dq, FO.flash_bwd_dkv,
           DO.decode_attention, SO.ssd_scan, RO.rwkv6_scan,
           FR.flash_attention_ref, FR.flash_attention_bwd_ref,
           DR.decode_attention_ref, SR.ssd_scan_ref, RR.rwkv6_scan_ref)
FAMILIES = {"dense": "yi-6b", "audio": "musicgen-medium",
            "moe": "llama4-maverick-400b-a17b",
            "vlm": "llama-3.2-vision-90b", "hybrid": "zamba2-1.2b",
            "rwkv6": "rwkv6-3b"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Meta tensors and tiny CPU ones: one intra-op thread is plenty, and
    the test workers would oversubscribe a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts():
    return [f.launches for f in COUNTED]


def _meta(*ts):
    return [t.to("meta") for t in ts]


def _same(meta, cpu):
    """Equal shapes and dtypes, element for element of nested outputs."""
    if isinstance(cpu, (tuple, list)):
        assert len(meta) == len(cpu)
        for m, c in zip(meta, cpu):
            _same(m, c)
        return
    assert meta.device.type == "meta"
    assert (meta.shape, meta.dtype) == (cpu.shape, cpu.dtype)


def _allocations(fn, *args):
    """(fn's result, the byte sizes of the storages it allocated)."""
    log = D.MemoryLog()
    log.register([a for a in args if torch.is_tensor(a)])
    with log:
        out = fn(*args)
    return out, sorted(log.size[s] for s, sign in log.events if sign > 0)


# ---------------------------------------------------------------------------
# the scan corrections
# ---------------------------------------------------------------------------

CELLS = [(a, s.name) for a, s, ok, _ in C.cells() if ok]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_scan_corrections_equal_reference(arch, shape):
    got = D.analytic_scan_corrections(D.cell_config(arch), C.SHAPES[shape])
    want = JD.analytic_scan_corrections(JD.cell_config(arch),
                                        JC.SHAPES[shape])
    assert got == want


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------


def _qkv(B=2, Sq=40, Sk=40, H=4, KV=2, hd=32, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, S, n, hd, generator=g).to(dtype)
            for S, n in ((Sq, H), (Sk, KV), (Sk, KV))]


def test_flash_forward_meta_allocates_o_and_lse_only():
    q, k, v = _qkv()
    cpu = FO.flash_attention(q, k, v, causal=True)
    before = _counts()
    (o, lse), sizes = _allocations(FO.flash_attention, *_meta(q, k, v))
    assert _counts() == before
    _same((o, lse), cpu)
    assert sizes == sorted(D._block(t.numel() * t.element_size())
                           for t in (o, lse))


def test_flash_backward_meta_gives_the_gradients_and_launches_nothing():
    q, k, v = _qkv()
    o, lse = FO.flash_attention(q, k, v, causal=True)
    do = torch.randn_like(o)
    cpu = FO.flash_attention_bwd(q, k, v, o, lse, do)
    before = _counts()
    meta = FO.flash_attention_bwd(*_meta(q, k, v, o, lse, do))
    assert _counts() == before
    _same(meta, cpu)


def test_flash_train_meta_runs_forward_and_backward_under_autograd():
    q, k, v = [t.to("meta").requires_grad_() for t in _qkv()]
    before = _counts()
    out = FO.flash_attention_train(q, k, v)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert _counts() == before
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_decode_meta_allocates_o_and_the_kernels_workspace():
    B, H, KV, S, hd = 3, 8, 2, 130, 64
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, H, hd, generator=g).bfloat16()
    kc, vc = (torch.randn(B, S, KV, hd, generator=g).bfloat16()
              for _ in range(2))
    lens = torch.tensor([1, 64, 130], dtype=torch.int32)
    cpu = DO.decode_attention(q, kc, vc, lens)
    before = _counts()
    o, sizes = _allocations(DO.decode_attention, *_meta(q, kc, vc, lens))
    assert _counts() == before
    _same(o, cpu)
    n = DO.workspace_floats(B, H, KV, S, hd)
    assert n == B * KV * 8 * 3 * hd     # 4 heads padded to 8, 3 chunks
    assert sizes == sorted(D._block(b) for b in
                           (B * H * hd * 2, n * 4, n // hd * 2 * 4))


def test_decode_workspace_formula_is_the_librarys():
    """The meta branch sizes the workspace as ``decode_workspace_floats``
    does in decode.cu: its constants and its formula, read from the
    source."""
    src = (ROOT / "src/repro_torch/kernels/decode_attention/csrc/"
           "decode.cu").read_text()
    assert f"constexpr int BS = {DO.CHUNK_ROWS};" in src
    assert f"constexpr int HEADS = {DO.BLOCK_HEADS};" in src
    body = re.search(r"decode_workspace_floats\(.*?\{(.*?)\n\}", src,
                     re.S).group(1)
    assert "(G + hopper::HEADS - 1) / hopper::HEADS * hopper::HEADS" in body
    assert "B * KV * padded * ((S + BS - 1) / BS) * hd" in body


def test_meta_branch_refuses_what_the_card_refuses():
    q, k, v = _meta(*_qkv(hd=96))                   # no kernel at hd 96
    with pytest.raises(ValueError, match="head dim 96"):
        FO.flash_attention(q, k, v)
    x = torch.empty(1, 8, 3, 48, device="meta")        # P = 48: no kernel
    with pytest.raises(ValueError, match="the kernel takes"):
        SO.ssd_scan(x, torch.empty(1, 8, 3, device="meta"),
                    torch.empty(3, device="meta"),
                    torch.empty(1, 8, 16, device="meta"),
                    torch.empty(1, 8, 16, device="meta"))


def _ssd_inputs(dtype=torch.bfloat16, B=2, T=70, H=3, P=32, N=16):
    g = torch.Generator().manual_seed(2)
    xh = torch.randn(B, T, H, P, generator=g).to(dtype)
    dt = (torch.rand(B, T, H, generator=g) * 0.1).to(dtype)
    A = -torch.rand(H, generator=g)
    Bm, Cm = (torch.randn(B, T, N, generator=g).to(dtype) for _ in range(2))
    return xh, dt, A, Bm, Cm


def test_ssd_meta_forward_and_autograd_launch_nothing():
    ins = _ssd_inputs()
    cpu = SO.ssd_scan(*ins, return_state=True)
    before = _counts()
    (y, st), sizes = _allocations(
        lambda *a: SO.ssd_scan(*a, return_state=True), *_meta(*ins))
    assert _counts() == before
    _same((y, st), cpu)
    assert sizes == sorted(D._block(t.numel() * 4) for t in (y, st))
    xs = [t.to("meta").requires_grad_(t.dtype.is_floating_point)
          for t in ins]
    y = SO.ssd_scan(*xs)
    grads = torch.autograd.grad(y.sum(), xs)
    assert [g.shape for g in grads] == [t.shape for t in ins]
    # the backward is the plain scan differentiated, on meta too
    assert _counts()[:6] == before[:6]


def _rwkv_inputs(B=2, T=70, H=2, N=64):
    g = torch.Generator().manual_seed(3)
    r, k, v = (torch.randn(B, T, H, N, generator=g).bfloat16()
               for _ in range(3))
    w = torch.rand(B, T, H, N, generator=g) * 0.5 + 0.4
    u = torch.randn(H, N, generator=g)
    return r, k, v, w, u


def test_rwkv6_meta_forward_and_autograd_launch_nothing():
    ins = _rwkv_inputs()
    cpu = RO.rwkv6_scan(*ins)
    before = _counts()
    (y, st), sizes = _allocations(RO.rwkv6_scan, *_meta(*ins))
    assert _counts() == before
    _same((y, st), cpu)
    assert sizes == sorted(D._block(t.numel() * 4) for t in (y, st))
    xs = [t.to("meta").requires_grad_() for t in ins]
    y, _ = RO.rwkv6_scan(*xs)
    grads = torch.autograd.grad(y.sum(), xs)
    assert [g.shape for g in grads] == [t.shape for t in ins]
    assert _counts()[:6] == before[:6]


# ---------------------------------------------------------------------------
# the memory log
# ---------------------------------------------------------------------------


def test_memory_log_reads_the_peak_and_weighs_arguments():
    arg = torch.empty(1000, device="meta")
    log = D.MemoryLog()
    log.register([arg], fraction=0.25)
    log.propagate = True
    with log:
        a = torch.empty(2000, device="meta")          # 8000 B
        b = a * 2                                     # 8000 B
        del a
        c = arg + 1                                   # 4000 B at 1/4
        v = b.view(40, 50)                            # a view: no bytes
        arg.mul_(2)                                   # in place: none
    assert log.peak() == 8192 + 8192
    del b, v
    assert log.peak() == 8192 + 8192
    live = sum(log.size[s] * log.weight[s] for s, sign in log.events
               if sign > 0) - sum(log.size[s] * log.weight[s]
                                  for s, sign in log.events if sign < 0)
    assert live == D._block(4000) * 0.25              # c is still held
    del c


def test_memory_log_passes_fractions_on_only_when_asked():
    """A gather whose output has as many elements as a sharded table
    (embed's V x D against B x S x D activations) keeps weight 1."""
    table = torch.empty(64, 8, device="meta")
    idx = torch.zeros(2, 32, dtype=torch.long, device="meta")
    log = D.MemoryLog()
    log.register([table], fraction=1 / 16)
    log.register([idx])
    with log:
        x = torch.nn.functional.embedding(idx, table)
    assert x.numel() == table.numel()
    assert log.peak() == D._block(x.numel() * 4)


def test_memory_log_counts_a_hidden_workspace_during_its_op():
    x = torch.empty(64, 1000, device="meta")
    log = D.MemoryLog()
    log.register([x])
    with log:
        y = torch.logsumexp(x, -1)
    # logsumexp's (x - max).exp_() temporary, then its (64,) output
    assert log.peak() == D._block(x.numel() * 4) + D._block(64 * 4)
    del y


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_trace_pass_runs_each_family_at_smoke_width(family, kind):
    cfg = C.smoke_config(FAMILIES[family])
    shape = C.Shape(kind, 16, 2, kind)
    mesh = make_debug_mesh(1, 1)
    before = _counts()
    r = D._trace_pass(cfg, shape, mesh)
    assert _counts()[:6] == before[:6]            # no kernel launched
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] == D.argument_bytes(cfg, shape,
                                                             mesh)
    assert 0 < mem["output_size_in_bytes"] <= mem["temp_size_in_bytes"]
    assert r["flops_per_device"] > 0 and r["per_device_batch"] == 2
    if kind == "train":   # the step's outputs: new params and moments
        batch, _ = D.input_sds(cfg, shape, None)
        held = mem["argument_size_in_bytes"] - sum(
            t.numel() * t.element_size() for t in batch.values())
        assert mem["output_size_in_bytes"] >= held


def _dense_train_flops(cfg, B, S) -> float:
    """The products of a dense train step under remat "full", 2 operations
    a multiply-add: each layer's projections and MLP forward and backward
    (2x: the input's and the weight's gradients), and forward again in the
    recompute but for w_down, the layer's last product (the checkpoint
    stops recomputing once the backward has every tensor it saved, and
    w_down's backward reads its inputs, not its output); the head forward
    and backward."""
    D_, H, KV, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, cfg.d_ff, cfg.vocab)
    N = B * S
    per_layer = 2 * N * (D_ * H * hd + 2 * D_ * KV * hd + H * hd * D_
                         + 3 * D_ * F)
    recompute = per_layer - 2 * N * F * D_
    head = 2 * N * D_ * V
    return cfg.n_layers * (3 * per_layer + recompute) + 3 * head


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_pass_on_meta_allocates_what_the_cpu_init_does(family):
    """``_init_pass`` draws the params on meta through ``MetaGenerator``
    and reads the same peak, leaf shapes and dtypes as a real ``init``
    and ``serving_params`` on the CPU under the same log; the float32
    draws put the peak above the served params' own bytes."""
    cfg = C.smoke_config(FAMILIES[family], param_dtype=torch.bfloat16)
    traced = D._init_pass(cfg)
    log = D.MemoryLog()
    with log:
        params = serving_params(build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0)), cfg, "cpu")
    assert traced["peak_bytes"] == log.peak()
    meta, cpu = flatten(traced["params"]), flatten(params)
    assert [(p, t.shape, t.dtype) for p, t in meta] \
        == [(p, t.shape, t.dtype) for p, t in cpu]
    assert all(t.device.type == "meta" for _, t in meta)
    held = sum(t.numel() * t.element_size() for _, t in cpu)
    assert traced["peak_bytes"] > held


def test_dense_train_flops_equal_the_closed_form():
    cfg = C.smoke_config("yi-6b")
    r = D._trace_pass(cfg, C.Shape("t", 32, 2, "train"),
                      make_debug_mesh(1, 1))
    assert r["flops_per_device"] == _dense_train_flops(cfg, 2, 32)


def test_run_cell_scales_the_counted_flops_to_the_global_batch():
    r = D.run_cell("starcoder2-3b", "train_4k", False, verbose=False)
    assert (r["n_chips"], r["per_device_batch"]) == (256, 16)
    assert r["flops"] == r["flops_counted_per_device"] * 16 \
        + r["scan_correction_flops"]
    cfg = D.cell_config("starcoder2-3b")
    assert r["flops_counted_per_device"] == _dense_train_flops(cfg, 16, 4096)
    mem = r["memory"]
    assert r["bytes_per_device"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"]
    assert r["fits_80gb_hbm"] == (r["bytes_per_device"] < 80e9)
    assert r["model_flops"] == 6.0 * cfg.active_param_count() * 256 * 4096


def test_run_cell_skips_with_a_reason():
    r = D.run_cell("yi-6b", "long_500k", False, verbose=False)
    assert r["skipped"] and "sub-quadratic" in r["reason"]
    # kimi-k2's head dim 112 is one the kernels take: its cell is traced,
    # its arguments the bytes the sharding rules give them
    r = D.run_cell("kimi-k2-1t-a32b", "decode_32k", True, verbose=False)
    assert not r["skipped"]
    assert r["memory"]["argument_size_in_bytes"] == D.argument_bytes(
        D.cell_config("kimi-k2-1t-a32b"), C.SHAPES["decode_32k"],
        make_production_mesh(multi_pod=True))
    r = D.run_cell("zamba2-1.2b", "train_4k", False, verbose=False)
    assert r["skipped"] and "plain scan backward" in r["reason"]


def test_cli_writes_the_cell(tmp_path, capsys):
    out = tmp_path / "cells.json"
    D.main(["--arch", "rwkv6-3b", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(out)])
    cells = json.loads(out.read_text())
    assert [c["mesh"] for c in cells] == ["pod", "multipod"]
    assert all(c["fits_80gb_hbm"] and not c["skipped"] for c in cells)
    assert "2 cells, 0 skipped" in capsys.readouterr().out
