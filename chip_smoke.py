#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/**/csrc``, holds each
kernel against its plain PyTorch version on the card, then serves yi-6b at
full width (random weights from a seed) through ``ServeEngine.generate``
(uniform and ragged prompts) and ``RequestScheduler`` over
``TPServeEngine(world=None)``, and shows from the launch counters that
this run went through the kernels. It then holds the kernel path against
the plain path at full width, times the kernels and the serving steps, and
prints:

* a ``{"kernels": [...]}`` line: per kernel its launches on the serving
  run (in all, and on each of its three paths), its error against the
  plain version, its time, the plain version's and
  ``torch.nn.functional.scaled_dot_product_attention``'s time at the same
  inputs, and the card's least time for the same work (``bound_ms``);
* a ``{"serving": ...}`` line: prefill ms, decode ms per step, tokens/s,
  peak memory;
* the card's name and power limit, as nvidia-smi gives them;
* last, ``{"ok": true, "device": {...}}``.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result. Any failed check exits non-zero. It imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import yi_6b  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (RequestScheduler, ServeEngine,  # noqa: E402
                                 TPServeEngine)

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core
# operations/s. Both timed kernels run in bf16.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# Kernel against plain version, set from the errors measured on the card
# with room on both sides. Elementwise: allclose at these limits; bf16
# outputs of one ulp apart (2^-8..2^-7 relative) pass, and the bf16 flash
# body also rounds P to bf16 before P.V. As a whole: the relative L2 error
# of each batch row, so that a fault in one sequence is not averaged away.
# Each case also checks that the same limits reject planted faults of the
# plain version (a length off by one, a 64-row chunk of keys dropped).
TOL = {("flash_attention", "bfloat16"): dict(rtol=1e-2, atol=5e-3),
       ("decode_attention", "bfloat16"): dict(rtol=1e-2, atol=2e-3),
       ("flash_attention", "float32"): dict(rtol=1e-4, atol=1e-5),
       ("decode_attention", "float32"): dict(rtol=1e-4, atol=1e-5)}
REL_L2 = {"bfloat16": 1e-2, "float32": 1e-4}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)       # float32 in both
# Kernel path vs plain path at full width, bf16 logits: relative L2 error
# of all the logits. The kernels sum in another order and the flash
# kernel rounds P to bf16 before P.V; each layer's difference is of the
# order of one bf16 ulp and 32 layers compound it (0.0086 measured on an
# H100, see PERF.md).
LOGITS_REL_L2 = 2e-2

SERVE_MAX_LEN = 544          # 512-token prompts + 32 new tokens
PROMPT_LENS = [128, 256, 384, 512]
N_NEW = 32
SCHED_SLOTS, SCHED_REQUESTS, SCHED_PREFILL = 4, 8, 256


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        die(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# device cycles (~30 ms) the timer keeps the card busy so that the host
# queues a whole timed loop before its first launch runs
SLEEP_CYCLES = 50_000_000


def time_ms(fn, inputs, iters: int = 20) -> float:
    """Mean device time of ``fn(*inputs[i % n])`` by CUDA events. The loop
    is queued behind a device sleep, so the host's launch cost does not
    enter the time of a kernel shorter than it. The input sets are cycled
    so that, as on the serving path, they are not all in the 50 MB L2."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    cycles = SLEEP_CYCLES
    while True:
        asleep, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        torch.cuda.synchronize()
        asleep.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued_ms < asleep.elapsed_time(start):
            return start.elapsed_time(end) / iters
        cycles *= 4      # the host outran the sleep: sleep longer
        check(cycles <= 256 * SLEEP_CYCLES, "cannot queue the timed loop")


def bound(nbytes: float, ops: float):
    """(ms, what bounds it): the larger of bytes over the HBM rate and bf16
    operations over the tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, H, KV, Sq, Sk, hd, dtype, causal)
    return [("yi-6b prefill", 4, 32, 4, 512, 512, 128, bf, True),
            ("yi-6b long prompt", 1, 32, 4, 2048, 2048, 128, bf, True),
            ("yi-6b admit", 1, 32, 4, 256, 256, 128, bf, True),
            ("ragged GQA non-causal", 3, 8, 2, 77, 301, 64, f32, False),
            ("ragged GQA non-causal", 2, 8, 2, 77, 130, 64, bf, False),
            ("ragged GQA causal Sq>Sk", 2, 6, 3, 100, 70, 32, f32, True),
            ("ragged GQA causal Sq>Sk", 2, 8, 2, 100, 70, 128, bf, True),
            ("ragged GQA causal Sq<Sk", 2, 4, 2, 40, 70, 16, bf, True),
            ("MHA", 1, 2, 2, 32, 32, 16, f32, True),
            ("MHA", 1, 2, 2, 32, 32, 16, bf, True),
            ("MQA", 1, 4, 1, 48, 48, 32, f32, True),
            ("MQA", 1, 4, 1, 48, 48, 32, bf, True),
            ("MHA non-causal Sq<Sk", 1, 2, 2, 16, 64, 16, f32, False)]


def decode_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, H, KV, S, hd, dtype, lens)
    return [("yi-6b ragged lengths", 4, 32, 4, 1024, 128, bf,
             [1, 300, 777, 1024]),
            ("yi-6b lengths past S", 4, 32, 4, 1024, 128, bf,
             [5, 1024, 2000, 64]),
            ("yi-6b serving", 4, 32, 4, SERVE_MAX_LEN, 128, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("yi-6b heads, an empty row", 4, 32, 4, 200, 128, bf,
             [0, 77, 199, 201]),
            ("ragged GQA f32", 3, 8, 2, 333, 64, f32, [333, 17, 200]),
            ("ragged GQA", 3, 8, 2, 128, 64, bf, [1, 128, 300]),
            ("GQA full cache", 2, 4, 2, 64, 16, f32, [64, 64]),
            ("GQA full cache", 2, 4, 2, 64, 16, bf, [64, 64]),
            ("MHA", 1, 4, 4, 96, 32, f32, [50]),
            ("MHA", 1, 4, 4, 96, 32, bf, [50])]


def rand_like_cases(gen, shapes, dtype, device):
    return [torch.randn(s, generator=gen, device=device).to(dtype)
            for s in shapes]


def agreement(kernel: str, out, ref):
    """(ok, max |out - ref|, largest relative L2 error of a batch row)."""
    name = str(ref.dtype).replace("torch.", "")
    d = (out.float() - ref.float()).flatten(1)
    rel = (d.norm(dim=1) / ref.float().flatten(1).norm(dim=1)
           .clamp_min(1e-30)).max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[kernel, name]) \
        and rel <= REL_L2[name]
    return ok, d.abs().max().item(), rel


def plain_masked(q, k, v, mask):
    """Softmax attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd) in
    float32, where ``mask`` (B, Sq, Sk) is True; a row with no key is 0.
    Only the planted faults below use it."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    kr = k.float().repeat_interleave(H // KV, dim=2)
    vr = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kr)
    p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.nan_to_num(0.0), vr).to(q.dtype)


def flash_faults(q, k, v, causal):
    """The plain version with planted faults: {fault: output}."""
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    right = kp <= qp if causal else kp < Sk
    faults = {"one key off": kp <= qp + 1 if causal else kp < Sk - 1}
    if Sk > 64 and (Sq > 64 or not causal):
        faults["64-key chunk dropped"] = right & ((kp < 64) | (kp >= 128))
    return {f: plain_masked(q, k, v, m.expand(B, Sq, Sk))
            for f, m in faults.items()}


def decode_faults(q, kc, vc, lens):
    B, S = kc.shape[:2]
    ln = lens.clamp(max=S)[:, None, None]
    kp = torch.arange(S, device=q.device)[None, None, :]
    faults = {"length off by one": kp < ln - 1}
    if (ln > 64).any():
        faults["64-row chunk dropped"] = (kp < ln) & ((kp < 64) | (kp >= 128))
    return {f: plain_masked(q[:, None], kc, vc, m)[:, 0]
            for f, m in faults.items()}


def report(kernel, label, shape, out, ref, faults):
    """Hold ``out`` against ``ref``, and check that the same limits reject
    each planted fault."""
    ok, err, rel = agreement(kernel, out, ref)
    print(f"{kernel} {label} {shape}: max|o-ref|={err:.3g} "
          f"row rel L2={rel:.3g} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{kernel} disagrees with its plain version ({label})")
    for fault, planted in faults.items():
        caught, ferr, frel = agreement(kernel, planted, ref)
        print(f"  planted fault '{fault}': max|d|={ferr:.3g} "
              f"row rel L2={frel:.3g} "
              f"{'rejected' if not caught else 'NOT REJECTED'}")
        check(not caught, f"the {kernel} limits pass a planted fault "
                          f"({fault}, {label})")
    return err


def check_kernels(device):
    """Every case: kernel against plain version. Returns each kernel's
    max abs error at its serving-shape case."""
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for label, B, H, KV, Sq, Sk, hd, dt, causal in flash_cases():
        q, k, v = rand_like_cases(gen, [(B, Sq, H, hd), (B, Sk, KV, hd),
                                        (B, Sk, KV, hd)], dt, device)
        o, lse = FO.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = FR.flash_attention_ref(q, k, v, causal=causal)
        name = str(dt).replace("torch.", "")
        shape = (f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} {name} "
                 f"causal={causal}")
        lerr = (lse - lse_ref).abs().max().item()
        print(f"flash_attention {label} {shape}: max|lse-ref|={lerr:.3g}")
        check(torch.allclose(lse, lse_ref, **LSE_TOL),
              f"flash_attention's LSE disagrees with its plain version "
              f"({label})")
        err = report("flash_attention", label, shape, o, o_ref,
                     flash_faults(q, k, v, causal))
        if label == "yi-6b prefill":
            errs["flash_attention"] = err
    for label, B, H, KV, S, hd, dt, lens in decode_cases():
        q, kc, vc = rand_like_cases(gen, [(B, 1, H, hd), (B, S, KV, hd),
                                          (B, S, KV, hd)], dt, device)
        q = q[:, 0]        # strided, as the decode step hands it over
        ln = torch.tensor(lens, dtype=torch.int32, device=device)
        o = DO.decode_attention(q, kc, vc, ln)
        torch.cuda.synchronize()
        o_ref = DR.decode_attention_ref(q, kc, vc, ln)
        name = str(dt).replace("torch.", "")
        err = report("decode_attention", label,
                     f"B={B} H={H} KV={KV} S={S} hd={hd} {name} lens={lens}",
                     o, o_ref, decode_faults(q, kc, vc, ln))
        if label == "yi-6b serving":
            errs["decode_attention"] = err
    return errs


def check_refusals(device):
    """On the card a wrapper launches its kernel or raises: what the
    kernels do not take is refused, and nothing falls back to the plain
    versions."""
    before = {f.__name__: f.launches for f in COUNTED}
    q = torch.randn(1, 8, 4, 8, device=device)
    k16 = torch.randn(1, 8, 4, 16)
    for what, call, exc in (
            ("head dim 8", lambda: FO.flash_attention(q, q, q), ValueError),
            ("float16", lambda: DO.decode_attention(
                q[:, 0].half(), q.half(), q.half(), 3), TypeError),
            ("k on the CPU", lambda: FO.flash_attention(
                k16.to(device), k16, k16), ValueError)):
        try:
            call()
        except exc as e:
            print(f"refused on the card: {what}: {e}")
        else:
            die(f"a wrapper took {what} on the card")
    check({f.__name__: f.launches for f in COUNTED} == before,
          "a refused call launched something")


def time_kernels(device, errs, launches):
    """The kernels' line: each kernel, its plain version and the library
    call timed at the serving shapes, with the card's bound. ``launches``
    holds each serving path's counts; ``launches`` in the line is their
    sum."""
    gen = torch.Generator(device=device).manual_seed(1)
    bf = torch.bfloat16
    out = []

    # B1 at the prefill of ServeEngine.generate: (4, 512), yi-6b heads
    B, H, KV, S, hd = 4, 32, 4, 512, 128
    sets = [rand_like_cases(gen, [(B, S, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hd)], bf, device)
            for _ in range(4)]
    ms = time_ms(lambda q, k, v: FO.flash_attention(q, k, v), sets)
    plain = time_ms(lambda q, k, v: FR.flash_attention_ref(q, k, v), sets,
                    iters=5)
    lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), sets)
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd) + 4 * B * H * S
    ops = 4 * B * H * hd * S * (S + 1) / 2          # causal QK^T and PV
    b_ms, b_by = bound(nbytes, ops)
    out.append({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_fwd.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
                "launches": sum(n["flash_attention"] for n in launches.values()),
                "launches_by_path": {p: n["flash_attention"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["flash_attention"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib,
                "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal"})

    # B3 at a decode step of the ragged generate: 32 layers' caches
    B, S = 4, SERVE_MAX_LEN
    lens = [n + N_NEW // 2 for n in PROMPT_LENS]
    ln = torch.tensor(lens, dtype=torch.int32, device=device)
    mask = (torch.arange(S, device=device)[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    sets = [rand_like_cases(gen, [(B, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hd)], bf, device)
            for _ in range(32)]
    ms = time_ms(lambda q, k, v: DO.decode_attention(q, k, v, ln), sets,
                 iters=64)
    plain = time_ms(lambda q, k, v: DR.decode_attention_ref(q, k, v, ln),
                    sets, iters=16)
    lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), sets, iters=64)
    rows = sum(min(n, S) for n in lens)
    nbytes = 2 * (2 * rows * KV * hd + 2 * B * H * hd) + 4 * B
    ops = 4 * rows * H * hd
    b_ms, b_by = bound(nbytes, ops)
    out.append({"name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/decode_attention/csrc/"
                          "decode.cu",
                "replaces": "src/repro/kernels/decode_attention/kernel.py:23",
                "launches": sum(n["decode_attention"] for n in launches.values()),
                "launches_by_path": {p: n["decode_attention"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["decode_attention"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib,
                "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 "
                         f"lens={lens}"})
    return out


# ---------------------------------------------------------------------------
# yi-6b serving at full width
# ---------------------------------------------------------------------------


# every wrapper and plain version, each with its launch counter
COUNTED = (FO.flash_attention, DO.decode_attention,
           FR.flash_attention_ref, DR.decode_attention_ref)


@contextmanager
def plain_attention():
    """The attention sublayer with the two kernel wrappers swapped for
    their plain versions: the yardstick of the full-width comparison."""
    saved = A.flash_attention, A.decode_attention
    A.flash_attention, A.decode_attention = \
        FR.flash_attention_ref, DR.decode_attention_ref
    try:
        yield
    finally:
        A.flash_attention, A.decode_attention = saved


def teacher_forced(engine, prompts, feed):
    """Logits of a prefill and len(feed) decode steps fed ``feed``."""
    logits, cache = engine._prefill(prompts)
    out = [logits.float()]
    for tok in feed:
        logits, cache = engine._decode(cache, tok)
        out.append(logits.float())
    return torch.cat(out, dim=1)


def serve(device, card):
    cfg = yi_6b.config()
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"setup: yi-6b ({cfg.param_count() / 1e9:.3f} B params) "
          f"initialised and cast to bf16 in {time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(0)
    prompts = rng.randint(1, cfg.vocab, size=(4, 512)).astype(np.int32)
    requests = [(rng.randint(1, cfg.vocab, size=int(rng.randint(16, 257))
                             ).astype(np.int32), int(rng.randint(8, 33)))
                for _ in range(SCHED_REQUESTS)]

    tp = TPServeEngine(model, None, world=None, max_len=SERVE_MAX_LEN,
                       local=engine, device=device)
    sched = RequestScheduler(tp, n_slots=SCHED_SLOTS,
                             prefill_len=SCHED_PREFILL)
    for prompt, n in requests:
        sched.submit(prompt, n)
    paths = {"generate uniform": lambda: engine.generate(prompts, N_NEW),
             "generate ragged": lambda: engine.generate(
                 prompts, N_NEW, prompt_lens=PROMPT_LENS),
             "scheduler": sched.run}
    out, seconds, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for path, run in paths.items():
        # each path's counts: set to 0 just before it, read just after
        torch.cuda.synchronize()
        for f in COUNTED:
            f.launches = 0
        t0 = time.perf_counter()
        out[path] = run()
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - t0
        launches[path] = {f.__name__: f.launches for f in COUNTED}
        print(f"{path} launches: {launches[path]}")
        check(launches[path]["flash_attention"] > 0,
              f"{path}: flash_attention never launched")
        check(launches[path]["decode_attention"] > 0,
              f"{path}: decode_attention never launched")
        check(launches[path]["flash_attention_ref"] == 0
              and launches[path]["decode_attention_ref"] == 0,
              f"{path}: a plain version ran")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    uniform, ragged = out["generate uniform"], out["generate ragged"]
    t_uniform, t_sched = seconds["generate uniform"], seconds["scheduler"]

    V = cfg.vocab
    for name, toks in (("uniform", uniform), ("ragged", ragged)):
        check(toks.shape == (4, 512 + N_NEW), f"{name} shape {toks.shape}")
        check(np.array_equal(toks[:, :512], prompts), f"{name} prompts")
        check(((toks[:, 512:] >= 0) & (toks[:, 512:] < V)).all(),
              f"{name} tokens out of range")
    check(np.array_equal(ragged[3], uniform[3]),
          "the full-length ragged row differs from the uniform run")
    for r, (prompt, n) in zip(sched.requests, requests):
        check(r.state == "done" and len(r.tokens) == n,
              f"request {r.rid}: {r.state} with {len(r.tokens)}/{n} tokens")
        check(all(0 <= t < V for t in r.tokens), f"request {r.rid} tokens")
    n_sched_tokens = sum(n for _, n in requests)
    print(f"scheduler: {len(requests)} requests, {n_sched_tokens} tokens, "
          f"{sched.decode_steps} decode steps, {tp.sync_rounds} sync rounds")

    # the kernel path against the plain path, teacher-forced, full width
    feed = [torch.as_tensor(rng.randint(1, V, size=(4, 1)), device=device)
            for _ in range(4)]
    fast = teacher_forced(engine, prompts, feed)
    with plain_attention():
        slow = teacher_forced(engine, prompts, feed)
    check(bool(torch.isfinite(fast).all()), "non-finite logits")
    rel = ((fast - slow).norm() / slow.norm()).item()
    agree = (fast.argmax(-1) == slow.argmax(-1)).float().mean().item()
    print(f"full width kernel vs plain (prefill + 4 decode steps, bf16 "
          f"logits): rel L2 {rel:.3g} (limit {LOGITS_REL_L2}), "
          f"max|d| {(fast - slow).abs().max().item():.3g}, "
          f"argmax agreement {agree:.3f}")
    check(rel <= LOGITS_REL_L2, "kernel path disagrees with the plain path")

    # step times at the uniform generate's shapes
    torch.cuda.synchronize()
    prefill_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, cache = engine._prefill(prompts)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    steps = 16
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = engine._decode(cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    profile = profile_steps(engine, prompts, min(prefill_ms), decode_ms)
    return launches, {
        "serving": {
            "model": "yi-6b (32 layers, d=4096, random bf16 weights)",
            "card": card,
            "prefill_ms": min(prefill_ms), "prefill_shape": "B=4 S=512",
            "decode_ms_per_step": decode_ms, "decode_batch": 4,
            "generate_uniform_s": t_uniform,
            "generate_ragged_s": seconds["generate ragged"],
            "generate_tokens_per_s": 4 * N_NEW / t_uniform,
            "decode_tokens_per_s": 4 / (decode_ms / 1e3),
            "scheduler_s": t_sched,
            "scheduler_tokens_per_s": n_sched_tokens / t_sched,
            "peak_memory_gb": peak_gb,
            "logits_rel_l2_kernel_vs_plain": rel},
        "profile": profile}


def profile_steps(engine, prompts, prefill_ms: float, decode_ms: float):
    """Device time by kernel over one prefill and over 4 decode steps, from
    torch.profiler; the idle share is taken against the unprofiled step
    times. None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    def window(fn, wall_ms: float, n: int):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():   # device events: kernels, copies
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.key] = per.get(e.key, 0.0) \
                    + e.self_device_time_total / 1e3 / n
        busy = sum(per.values())
        if busy == 0:
            return None
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        groups = {"attention kernels": 0.0, "matmul": 0.0, "other": 0.0}
        for name, t in per.items():
            low = name.lower()
            if "flash_fwd" in low or "decode_partial" in low \
                    or "decode_combine" in low:
                groups["attention kernels"] += t
            elif "nvjet" in low or "gemm" in low or "cutlass" in low:
                groups["matmul"] += t
            else:
                groups["other"] += t
        return {"device_busy_ms": busy, "wall_ms": wall_ms,
                "idle_share": max(0.0, 1 - busy / wall_ms),
                "groups_ms": groups,
                "top_kernels_ms": [[k[:90], t] for k, t in top]}

    logits, cache = engine._prefill(prompts)
    tok = logits[:, -1].argmax(-1, keepdim=True)

    def decode4():
        nonlocal cache, tok
        for _ in range(4):
            lg, cache = engine._decode(cache, tok)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    return {"prefill": window(lambda: engine._prefill(prompts), prefill_ms, 1),
            "decode_step": window(decode4, decode_ms, 4)}


def small_model_matches_cpu(device) -> None:
    """Smoke width in float32: greedy tokens on the card (kernels) equal
    those on the CPU (plain versions)."""
    cfg = yi_6b.smoke_config(dtype=torch.float32)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    prompts = np.random.RandomState(1).randint(1, cfg.vocab, (3, 16))
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", build_model(cfg, device))):
        eng = ServeEngine(model, params, max_len=32, device=dev)
        out[dev] = eng.generate(prompts, 12, prompt_lens=[16, 5, 11])
    check(np.array_equal(out["cuda"], out["cpu"]),
          "smoke model: card and CPU tokens differ")
    print("smoke model f32: card tokens equal CPU tokens")


def main() -> None:
    if not torch.cuda.is_available():
        die("no CUDA device: this smoke run needs an NVIDIA card")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")

    t0 = time.perf_counter()
    _build.build()
    print(f"setup: kernels built in {time.perf_counter() - t0:.1f} s")

    errs = check_kernels(device)
    check_refusals(device)
    small_model_matches_cpu(device)
    launches, serving = serve(device, card)
    kernels = time_kernels(device, errs, launches)
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
              f"sdpa {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by "
              f"{k['bound_by']}) on {card}")
    print(json.dumps(serving))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
