#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/**/csrc``, holds each
kernel against its plain PyTorch version on the card (every kernel also
against planted faults; the decode attention, the backward kernels and
both scans also against a second run, bit for bit), then
drives the port's main paths at full width with random weights from
a seed, and shows from the launch counters, set to 0 just before each path
and read just after, that each went through the kernels:

* serving yi-6b through ``ServeEngine.generate`` (uniform and ragged
  prompts) and ``RequestScheduler`` over ``TPServeEngine(world=None)``,
  with one decode-attention (B3) device kernel a layer in a profiled
  decode step;
* training gpt2-124m: 6 steps of ``make_train_step`` (AdamW) on one fixed
  batch of 8 x 1024 tokens, with remat "full", each step counted on its
  own: 24 forward launches, 12 of each backward kernel, 0 of the plain
  versions;
* serving zamba2-1.2b through ``ServeEngine.generate``: a prefill of
  exactly 38 SSD-scan (B4) and 6 flash-attention launches, decode steps of
  exactly 6 decode-attention launches and no scan, 0 plain launches;
* serving rwkv6-3b through ``ServeEngine.generate``: a prefill of exactly
  32 RWKV6-scan (B5) launches, decode steps of none (the one-token
  recurrence is plain float32 work), 0 plain launches;
* data-parallel training over the simulated fabric (the paper's §5.2
  experiment): ``DDPTrainer`` over a ``JcclWorld`` of 2 ``ShiftLib``
  ranks, gpt2-124m at full width, 4 x 1024 tokens a rank, 4 steps with
  host1's first NIC killed after step 2, each step counted on its own:
  48 forward launches, 24 of each backward kernel, 0 plain; step 1's
  all-reduce equal bit for bit to the float32 sum of the two ranks'
  gradients, a rank's gradient repeating bit for bit, the post-fallback
  checkpoint; then the ``StandardLib`` baseline crashes on the same kill,
  restores its step-2 checkpoint and resumes to step 4. Before it, the
  float32 smoke trainer on the card against the CPU (losses, virtual
  accounting) and its flat, bucketed and hooked runs, bit for bit.

It holds the kernel path against the plain path at full width (logits
while serving, loss and gradients while training; for zamba2 and rwkv6
the whole path in float32, each scan block in bf16, and the bf16 path's
drift printed, for rwkv6 beside a baseline), the float32 smoke models'
card runs against their CPU runs, times the kernels, the serving steps and
the train step, and prints:

* a ``{"serving": ...}`` line: prefill ms, decode ms per step, tokens/s,
  peak memory;
* a ``{"training": ...}`` line: train-step ms, tokens/s, device-busy ms and
  idle share from ``torch.profiler``, peak memory, the losses;
* a ``{"zamba2": ...}`` line: prefill ms, decode ms per step, tokens/s,
  device-busy ms and idle share, peak memory, the full-width readings;
* a ``{"rwkv6": ...}`` line: the same for rwkv6-3b;
* a ``{"ddp": ...}`` line: each step's wall ms, each rank's forward and
  backward ms, the gradient copies to the host, the fabric's host
  seconds, AdamW, the virtual gradient-sync ms (the healthy steps of the
  ShiftLib and StandardLib runs side by side), fallbacks, recoveries and
  restarts, the checkpoint saves and the restore (ms and bytes), both
  runs' losses, peak memory and the launches of each step;
* a ``{"kernels": [...]}`` line: per kernel its launches on the main
  paths (in all, and on each path), its error against the plain version,
  its time, the plain version's and one PyTorch call's time at the same
  inputs, and the card's least time for the same work (``bound_ms``);
  flash attention's entry also lists all three of its main-path shapes
  (``shapes``: yi-6b prefill, zamba2 prefill, gpt2 train forward), and
  the backward kernels' entries the time of the whole backward call
  (``bwd_ms``: delta, B2a and B2b), which compares with SDPA's; decode
  attention's entry its three shapes (yi-6b serving, zamba2 decode, every
  row in one chunk) and its time by the chunks a row holds
  (``ms_by_chunks``);
* the card's name and power limit, as nvidia-smi gives them;
* last, ``{"ok": true, "device": {...}}``.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result. Any failed check exits non-zero. It imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.collectives import build_world  # noqa: E402
from repro_torch.configs import (gpt2_124m, rwkv6_3b, yi_6b,  # noqa: E402
                                 zamba2_1p2b)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as RO  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as RR  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as SR  # noqa: E402
from repro_torch.launch import make_train_step, value_and_grad  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks as BL  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import flatten, unflatten  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.serving import (RequestScheduler, ServeEngine,  # noqa: E402
                                 TPServeEngine)
from repro_torch.train import trainer as TR  # noqa: E402

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core
# operations/s. Every timed kernel takes bf16 inputs.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# Kernel against plain version, set from the errors measured on the card
# with room on both sides. Elementwise: allclose at these limits; bf16
# outputs of one ulp apart (2^-8..2^-7 relative) pass, and the bf16 flash
# body also rounds P to bf16 before P.V. As a whole: the relative L2 error
# of each batch row, so that a fault in one sequence is not averaged away.
# Each case also checks that the same limits reject planted faults of the
# plain version (a length off by one, a 64-row chunk of keys dropped, and
# for flash attention keys [128, 256) dropped).
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
# Backward kernels against the plain backward, per gradient (dq, dk, dv):
# the relative L2 error of each batch row within REL_L2, and elementwise
# |d| <= rtol * |ref| + atol_rms * max(rms of ref's (b, s, head) vector,
# rms of ref). The bf16
# body rounds P and dS to bf16 before their products and each output to
# bf16: one bf16 ulp is 2^-8..2^-7 of an element, which rtol covers, and
# the batch-row error measured on an H100 is 0.0025-0.0029 (PERF.md). The
# absolute error of an element follows the size of the terms summed into
# it, not the element: an element of an early key's dK that cancels to
# near 0 from terms of order 1 carries ~0.006 of rounding (measured at the
# training shape). So atol is a share of the root mean square of the
# element's own (b, s, head) vector, whose terms are of that size, or of
# the whole tensor where that is larger: a vector that cancels to exactly
# 0 in the plain version (dQ of query 0, whose dS is P (dP - delta) with
# dP = delta) is a rounding residue in the kernel.
BWD_TOL = {"bfloat16": dict(rtol=2e-2, atol_rms=5e-2),
           "float32": dict(rtol=1e-4, atol_rms=1e-4)}
# gpt2-124m at full width, kernel path against plain path on the same
# params and batch: the loss's relative error and the relative L2 error of
# all the gradients flattened into one vector. Measured on an H100:
# 1.3e-6 and 0.0076 (bf16 P and dS in the kernels, over 12 layers); the
# same limits must reject planted faults of the plain attention at full
# width (PERF.md has the readings).
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL_L2 = 2e-2
# The embedding and MLP leaves dominate that global norm, so a fault of one
# layer's or one head's attention could hide in it. Each layer's slice of
# the attention weights' gradients (wq, wk, wv, wo) is also held on its
# own: the largest relative L2 error over those 48 slices. Measured on an
# H100: 0.0191 (wq of the last layer); the nearest planted fault, a 64-row
# K/V tile dropped in the first layer's first head only, reads 0.0683
# (PERF.md has the others).
TRAIN_ATTN_SLICE_REL_L2 = 3.5e-2
ATTN_LEAVES = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
               "blocks/attn/wo")
# The float32 smoke model, 3 train steps on the card against the CPU:
# losses, and each param leaf's relative L2 error after the steps
# (measured 2.5e-7 and 5.3e-6: AdamW's first steps move each weight by
# about lr whatever the size of its gradient, so a gradient of float32
# rounding size still moves a param).
SMOKE_TRAIN_REL = 5e-5
# B4 against the plain scan, for y and for the final state: the relative L2
# error of each batch row, and elementwise |d| <= rtol |ref| + atol_rms
# rms(ref). The float32 body computes in float32 from the same inputs, so
# it differs only by the order of the sums: the chunked form's
# exp(cum[t] - cum[s]) against the sequential product of decays (measured
# on an H100: row errors <= 1.02e-6, elements <= 0.234 of the limit 1e-4
# |ref| + 3e-5 rms, PERF.md). The bf16 body also cuts each float32 operand
# of its products into three bf16 terms, which leaves ~2^-24 of each, as
# much as float32 operands would (tests/test_torch_ssd_split.py emulates
# it on the CPU; two terms broke the elementwise limit at the zamba2
# prefill case on an H100, PERF.md). The same limits must reject six
# planted faults of the plain scan (SSD_FAULTS).
SSD_REL_L2 = 1e-5
SSD_TOL = dict(rtol=1e-4, atol_rms=3e-5)
# zamba2-1.2b at full width, kernel path against plain path. (a) float32,
# the whole path: the relative L2 error of the prefill logits and of each
# cache leaf, and of teacher-forced decode logits against forward's;
# (b) bf16, each of the 38 Mamba2 blocks on the same input: the relative
# L2 error of each batch row of its output and of its final state.
# Set from the readings on an H100 (PERF.md); each must reject planted
# faults of the scan. (a) reads up to 1.36e-3, not the ~1e-6 of one
# block: the random-weight model compounds each block's float32 rounding
# difference over the 44 blocks (the drift of each block's input, printed,
# grows from 1.5e-6 to 5.4e-4); its planted faults read 1.0 and up.
# (b) reads up to 1.83e-4; its weakest planted fault (the state reset
# every 64 steps) 0.071.
ZAMBA_F32_REL_L2 = 5e-3
ZAMBA_LAYER_REL_L2 = 1e-3

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 6

# data-parallel training over the fabric. (a) build_smoke_trainer's model
# in float32, 3 steps on the card against the CPU (losses within
# SMOKE_TRAIN_REL, the virtual accounting DDP_RUN_FIELDS equal), then the
# DDP_MODES on the card, whose losses must be equal bit for bit; (b)
# gpt2-124m at full width: 2 ranks of DDP_B x DDP_S tokens, DDP_STEPS
# steps, DDP_NIC killed after step DDP_KILL, 25 MiB buckets (PyTorch
# DDP's default bucket_cap_mb) of 1 MiB chunks (64 KiB chunks would cost
# the host ~9 s of fabric a step)
DDP_SMOKE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                 d_ff=512, vocab=512)
DDP_SMOKE_STEPS = 3
DDP_MODES = {"flat": dict(bucket_bytes=0),
             "bucketed": dict(bucket_bytes=1 << 16),
             "hooked": dict(bucket_bytes=1 << 16, issue_as_produced=True,
                            layer_compute_s=2e-4)}
DDP_RUN_FIELDS = ("comm_time", "step_grad_times", "step_peak_works",
                  "fallbacks", "final_step")
DDP_B, DDP_S, DDP_STEPS, DDP_KILL = 4, 1024, 4, 2
DDP_BUCKET_BYTES, DDP_CHUNK_BYTES = 25 << 20, 1 << 20
DDP_NIC = "host1/mlx5_0"

SERVE_MAX_LEN = 544          # 512-token prompts + 32 new tokens (both models)
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


def time_ms_unqueued(fn, inputs, iters: int = 3) -> float:
    """Mean time of ``fn(*inputs[i % n])`` between CUDA events, with no
    device sleep in front: for a plain version of thousands of launches a
    call, which fill the launch queue, so that the host cannot queue the
    loop ahead. Its time includes the host's launch cost."""
    fn(*inputs[0])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    # (label, B, H, KV, Sq, Sk, hd, dtype, causal, layout): "fused" reads
    # q, k and v as strided views of one (B, S, H + 2 KV, hd) tensor
    cases = [("yi-6b prefill", 4, 32, 4, 512, 512, 128, bf, True),
             ("yi-6b long prompt", 1, 32, 4, 2048, 2048, 128, bf, True),
             ("yi-6b admit", 1, 32, 4, 256, 256, 128, bf, True),
             ("zamba2 prefill", 4, 32, 32, 512, 512, 64, bf, True),
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
    # the bf16 body's 128-row query blocks and 128-key tiles: lengths on
    # either side of one and two tiles, at both model head dims
    for hd in (64, 128):
        cases += [(f"tile edge S={S}", 2, 8, 2, S, S, hd, bf, True)
                  for S in (127, 128, 129, 255, 257)]
        cases += [("tile edges causal Sq>Sk", 2, 8, 2, 257, 129, hd, bf, True),
                  ("tile edges causal Sq<Sk", 2, 8, 2, 129, 255, hd, bf, True),
                  ("tile edges non-causal", 2, 8, 2, 129, 257, hd, bf, False),
                  ("tile edges non-causal Sq>Sk", 1, 4, 1, 255, 128, hd, bf,
                   False),
                  ("fused qkv", 2, 8, 2, 257, 257, hd, bf, True, "fused")]
    # 5 x 9 x 5 = 225 blocks: not a whole number of waves on 132 SMs
    cases.append(("225 blocks", 5, 9, 3, 640, 640, 128, bf, True))
    return [c if len(c) == 10 else (*c, "contiguous") for c in cases]


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
            ("zamba2 serving", 4, 32, 32, SERVE_MAX_LEN, 64, bf,
             [512 + N_NEW // 2] * 4),
            ("ragged GQA f32", 3, 8, 2, 333, 64, f32, [333, 17, 200]),
            ("ragged GQA", 3, 8, 2, 128, 64, bf, [1, 128, 300]),
            ("GQA full cache", 2, 4, 2, 64, 16, f32, [64, 64]),
            ("GQA full cache", 2, 4, 2, 64, 16, bf, [64, 64]),
            ("MHA", 1, 4, 4, 96, 32, f32, [50]),
            ("MHA", 1, 4, 4, 96, 32, bf, [50]),
            # the bf16 body's paths: every row in one 64-row chunk (o
            # written at once), chunk counts that differ within the batch
            # and reach the last, partial chunk of S (the last block of a
            # row combines), G = 1 at hd = 64 on both, and 12 heads a K/V
            # head (groups of 8 and 4)
            ("one chunk each", 4, 32, 4, SERVE_MAX_LEN, 128, bf,
             [1, 17, 63, 64]),
            ("chunk counts differ", 4, 32, 4, 1000, 128, bf,
             [1000, 65, 937, 130]),
            ("MHA hd=64 one chunk each", 4, 32, 32, SERVE_MAX_LEN, 64, bf,
             [1, 17, 63, 64]),
            ("MHA hd=64 chunk counts differ", 4, 32, 32, SERVE_MAX_LEN, 64,
             bf, [SERVE_MAX_LEN, 1, 300, 129]),
            ("12 heads a K/V head", 2, 24, 2, 300, 64, bf, [300, 150])]


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
    float32, where ``mask`` ((B,) Sq, Sk) is True; a row with no key is 0.
    Returns (o, lse), as the forward does. Only the planted faults use
    it."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    kr = k.float().repeat_interleave(H // KV, dim=2)
    vr = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kr)
    s = s.masked_fill(~(mask[:, None] if mask.dim() == 3 else mask),
                      float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1)


def flash_faults(q, k, v, causal):
    """The plain version with planted faults: {fault: output}."""
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    right = kp <= qp if causal else kp < Sk
    faults = {"one key off": kp <= qp + 1 if causal else kp < Sk - 1}
    if Sk > 64 and (Sq > 64 or not causal):
        faults["64-key chunk dropped"] = right & ((kp < 64) | (kp >= 128))
    if Sk >= 192 and (Sq >= 192 or not causal):
        faults["keys [128, 256) dropped"] = right & ((kp < 128) | (kp >= 256))
    return {f: plain_masked(q, k, v, m.expand(B, Sq, Sk))[0]
            for f, m in faults.items()}


def decode_faults(q, kc, vc, lens):
    B, S = kc.shape[:2]
    ln = lens.clamp(max=S)[:, None, None]
    kp = torch.arange(S, device=q.device)[None, None, :]
    faults = {"length off by one": kp < ln - 1}
    if (ln > 64).any():
        faults["64-row chunk dropped"] = (kp < ln) & ((kp < 64) | (kp >= 128))
    return {f: plain_masked(q[:, None], kc, vc, m)[0][:, 0]
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


def flash_inputs(gen, B, H, KV, Sq, Sk, hd, dtype, layout, device):
    """q (B, Sq, H, hd), k and v (B, Sk, KV, hd); "fused" (Sq == Sk) cuts
    them from one (B, S, H + 2 KV, hd) tensor, as a fused QKV projection
    would hand them over."""
    if layout == "fused":
        qkv = torch.randn((B, Sq, H + 2 * KV, hd), generator=gen,
                          device=device).to(dtype)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    return rand_like_cases(gen, [(B, Sq, H, hd), (B, Sk, KV, hd),
                                 (B, Sk, KV, hd)], dtype, device)


def check_flash(device, gen):
    """Every B1 case against the plain version; returns the max abs error
    of the yi-6b prefill case."""
    err_main = 0.0
    for label, B, H, KV, Sq, Sk, hd, dt, causal, layout in flash_cases():
        q, k, v = flash_inputs(gen, B, H, KV, Sq, Sk, hd, dt, layout, device)
        o, lse = FO.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = FR.flash_attention_ref(q, k, v, causal=causal)
        name = str(dt).replace("torch.", "")
        shape = (f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} {name} "
                 f"causal={causal} {layout}")
        lerr = (lse - lse_ref).abs().max().item()
        print(f"flash_attention {label} {shape}: max|lse-ref|={lerr:.3g}")
        check(torch.allclose(lse, lse_ref, **LSE_TOL),
              f"flash_attention's LSE disagrees with its plain version "
              f"({label})")
        err = report("flash_attention", label, shape, o, o_ref,
                     flash_faults(q, k, v, causal))
        if label == "yi-6b prefill":
            err_main = err
    return err_main


def check_kernels(device):
    """Every case: kernel against plain version. Returns each kernel's
    max abs error at its serving-shape case."""
    gen = torch.Generator(device=device).manual_seed(0)
    return {"flash_attention": check_flash(device, gen),
            "decode_attention": check_decode(device)}


def decode_repeat(fn, ins):
    """``fn(*ins)`` twice: (the first run's output, whether the second run
    gave the same bits)."""
    o = fn(*ins)
    o2 = fn(*ins)
    if o.is_cuda:
        torch.cuda.synchronize()
    return o, torch.equal(o, o2)


def check_decode(device):
    """B3 against the plain version in every case, each run twice; the same
    limits must reject each planted fault, and the second run must give the
    same bits (the last block of a row combines its chunks in chunk order,
    whichever block that is). Returns the max abs error of the yi-6b
    serving case."""
    gen = torch.Generator(device=device).manual_seed(8)
    err_main = 0.0
    for label, B, H, KV, S, hd, dt, lens in decode_cases():
        q, kc, vc = rand_like_cases(gen, [(B, 1, H, hd), (B, S, KV, hd),
                                          (B, S, KV, hd)], dt, device)
        q = q[:, 0]        # strided, as the decode step hands it over
        ln = torch.tensor(lens, dtype=torch.int32, device=device)
        o, bitwise = decode_repeat(DO.decode_attention, (q, kc, vc, ln))
        o_ref = DR.decode_attention_ref(q, kc, vc, ln)
        name = str(dt).replace("torch.", "")
        shape = f"B={B} H={H} KV={KV} S={S} hd={hd} {name} lens={lens}"
        err = report("decode_attention", label, shape, o, o_ref,
                     decode_faults(q, kc, vc, ln))
        print(f"  second run {'bitwise equal' if bitwise else 'DIFFERS'}")
        check(bitwise, f"decode_attention does not repeat bit for bit "
                       f"({label}, {shape})")
        if label == "yi-6b serving":
            err_main = err
    return err_main


def bwd_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, H, KV, Sq, Sk, hd, dtype, causal, layout), layout as in
    # flash_cases
    cases = [("gpt2-124m training", TRAIN_B, 12, 12, TRAIN_S, TRAIN_S, 64,
              bf, True),
             ("smoke trainer", 2, 4, 4, 32, 32, 32, bf, True),
             ("smoke trainer", 2, 4, 4, 32, 32, 32, f32, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, bf, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, bf, False),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, f32, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, f32, False),
             ("GQA causal Sq>Sk", 2, 6, 3, 100, 70, 32, f32, True),
             ("GQA causal Sq>Sk", 2, 8, 2, 100, 70, 16, bf, True),
             ("GQA causal Sq<Sk", 2, 4, 2, 40, 70, 64, bf, True)]
    # the bf16 body's 128-row work tiles (queries for B2a, keys for B2b),
    # B2a's K/V tiles (128 keys, 64 at hd 128) and B2b's 64-query stages:
    # lengths on either side of one and two tiles, at both model head dims
    for hd in (64, 128):
        cases += [(f"tile edge S={S}", 2, 4, 4, S, S, hd, bf, True)
                  for S in (127, 128, 129, 255, 257)]
        cases += [("tile edges causal Sq>Sk", 2, 4, 4, 257, 129, hd, bf, True),
                  ("tile edges causal Sq<Sk", 2, 4, 4, 129, 255, hd, bf, True),
                  ("tile edges non-causal", 2, 4, 4, 127, 257, hd, bf, False),
                  ("tile edges non-causal Sq>Sk", 1, 4, 4, 255, 128, hd, bf,
                   False),
                  ("tile edges GQA G=4", 2, 8, 2, 255, 255, hd, bf, True),
                  ("fused qkv", 2, 8, 2, 257, 257, hd, bf, True, "fused")]
    return [c if len(c) == 10 else (*c, "contiguous") for c in cases]


def grad_agreement(out, ref):
    """(ok, max |out - ref|, largest relative L2 error of a batch row,
    largest |d| / (rtol |ref| + atol_rms max(rms(ref's (b, s, head)
    vector), rms(ref))) of an element, which passes at <= 1)."""
    name = str(ref.dtype).replace("torch.", "")
    tol = BWD_TOL[name]
    r = ref.float()
    d = out.float() - r
    rel = (d.flatten(1).norm(dim=1)
           / r.flatten(1).norm(dim=1).clamp_min(1e-30)).max().item()
    scale = r.square().mean(-1, keepdim=True).sqrt().clamp_min(
        r.square().mean().sqrt())
    bound = tol["rtol"] * r.abs() + tol["atol_rms"] * scale
    elem = (d.abs() / bound.clamp_min(1e-30)).max().item()
    return elem <= 1 and rel <= REL_L2[name], d.abs().max().item(), rel, elem


def causal_seen(q, k, edge: int = 0):
    """(Sq, Sk) pairs a top-left causal mask admits, ``edge`` keys late
    (an edge of Sk admits every pair)."""
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    return kp <= qp + edge


def tile_dropped(seen):
    """``seen`` without keys 64..127, the second 64-row K/V tile."""
    kp = torch.arange(seen.shape[1], device=seen.device)[None, :]
    return seen & ((kp < 64) | (kp >= 128))


def plain_bwd(q, k, v, o, lse, do, seen, use_delta=True, group_sum=True):
    """The plain backward written out again, with the knobs the planted
    faults turn: ``seen`` (Sq, Sk) marks the pairs whose probabilities are
    recomputed, ``use_delta`` whether dS subtracts rowsum(o * dO),
    ``group_sum`` whether dK and dV sum all G query heads of a K/V head
    (else only the first). Only the planted faults use it."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(G, dim=2)
    vr = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kr)
    p = torch.exp(s.masked_fill(~seen, float("-inf")) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    if use_delta:
        dp = dp - (o.float() * dof).sum(-1).transpose(1, 2)[..., None]
    ds = p * dp * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).view(B, Sk, KV, G, hd)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).view(B, Sk, KV, G, hd)
    if group_sum:
        dk, dv = dk.sum(3), dv.sum(3)
    else:
        dk, dv = dk[:, :, :, 0], dv[:, :, :, 0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_faults(q, k, v, o, lse, do, causal):
    """The plain backward with planted faults: {fault: (dq, dk, dv)}."""
    G = q.shape[2] // k.shape[2]
    Sq, Sk = q.shape[1], k.shape[1]
    right = causal_seen(q, k, edge=0 if causal else Sk)
    faults = {"delta left out": dict(seen=right, use_delta=False)}
    masks = {"64-row K/V tile dropped": tile_dropped(right)}
    if causal:
        masks["causal edge off by one"] = causal_seen(q, k, edge=1)
    # the second 128-row work tile of B2b (keys) or of B2a (queries) left out
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    masks["keys [128, 256) dropped"] = right & ((kp < 128) | (kp >= 256))
    masks["queries [128, 256) dropped"] = right & ((qp < 128) | (qp >= 256))
    for fault, seen in masks.items():
        # a mask that changes no seen pair (no query sees a second K/V
        # tile) is no fault at this shape
        if not torch.equal(seen, right):
            faults[fault] = dict(seen=seen)
    if G > 1:
        faults["first head of each group only"] = dict(seen=right,
                                                       group_sum=False)
    return {f: plain_bwd(q, k, v, o, lse, do, **kw)
            for f, kw in faults.items()}


def check_bwd(device):
    """B2a and B2b against the plain backward in every case; the same
    limits must reject each planted fault, and a second run on the same
    inputs must give the same bits. Returns the max abs errors of dq and
    of dk/dv at the training case."""
    gen = torch.Generator(device=device).manual_seed(2)
    errs = {}
    for label, B, H, KV, Sq, Sk, hd, dt, causal, layout in bwd_cases():
        q, k, v = flash_inputs(gen, B, H, KV, Sq, Sk, hd, dt, layout, device)
        do, = rand_like_cases(gen, [(B, Sq, H, hd)], dt, device)
        o, lse = FO.flash_attention(q, k, v, causal=causal)
        got = FO.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = FO.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        ref = FR.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        name = str(dt).replace("torch.", "")
        shape = (f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} {name} "
                 f"causal={causal} {layout}")
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        readings = [grad_agreement(g, r) for g, r in zip(got, ref)]
        print(f"flash_attention_bwd {label} {shape}: " + "; ".join(
            f"{n} max|d|={e:.3g} row rel L2={rl:.3g} elem={el:.3g}"
            for n, (_, e, rl, el) in zip(("dq", "dk", "dv"), readings))
            + f"; {'ok' if all(r[0] for r in readings) else 'MISMATCH'}"
            + f"; second run {'bitwise equal' if bitwise else 'DIFFERS'}")
        check(all(r[0] for r in readings),
              f"flash_attention_bwd disagrees with its plain version "
              f"({label}, {shape})")
        check(bitwise, f"flash_attention_bwd does not repeat bit for bit "
                       f"({label}, {shape})")
        for fault, planted in bwd_faults(q, k, v, o, lse, do,
                                         causal).items():
            fr = [grad_agreement(g, r) for g, r in zip(planted, ref)]
            caught = not all(x[0] for x in fr)
            print(f"  planted fault '{fault}': row rel L2 dq/dk/dv = "
                  + "/".join(f"{x[2]:.3g}" for x in fr) + ", elem = "
                  + "/".join(f"{x[3]:.3g}" for x in fr)
                  + f" {'rejected' if caught else 'NOT REJECTED'}")
            check(caught, f"the flash_attention_bwd limits pass a planted "
                          f"fault ({fault}, {label})")
        if label == "gpt2-124m training":
            errs["flash_bwd_dq"] = readings[0][1]
            errs["flash_bwd_dkv"] = max(readings[1][1], readings[2][1])
    return errs


SSD_FAULTS = ("decay left out at chunk boundaries",
              "dt left out of the input term",
              "output read from the state before the step",
              "state reset every 64 steps", "B and C swapped",
              "final state not written")


def plain_ssd(xh, dt, A, Bm, Cm, fault: str):
    """The plain scan written out again with one planted ``fault`` (of
    SSD_FAULTS): (y, final state), float32. Only the planted faults use
    it."""
    x, dtf, b, c = xh.float(), dt.float(), Bm.float(), Cm.float()
    if fault == "B and C swapped":
        b, c = c, b
    da = torch.exp(dtf * A)
    dtx = x if fault == "dt left out of the input term" \
        else dtf[..., None] * x
    undecayed = fault == "decay left out at chunk boundaries"
    reset = fault == "state reset every 64 steps"
    early = fault == "output read from the state before the step"
    B, T, H, P = x.shape
    h = torch.zeros((B, H, P, b.shape[-1]), device=x.device)
    ys = []
    for t in range(T):
        edge = t > 0 and t % 64 == 0
        if edge and reset:
            h = torch.zeros_like(h)
        before = h
        h = (1.0 if edge and undecayed else da[:, t, :, None, None]) * h \
            + dtx[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", before if early else h,
                               c[:, t]))
    if fault == "final state not written":
        h = torch.zeros_like(h)
    return torch.stack(ys, dim=1), h


def ssd_faults(T: int):
    """The faults that change the scan's result at T steps: the two at the
    64-step chunk boundaries need T > 64."""
    boundary = ("decay left out at chunk boundaries",
                "state reset every 64 steps")
    return [f for f in SSD_FAULTS if T > 64 or f not in boundary]


def ssd_agreement(out, ref):
    """(ok, max |out - ref|, largest relative L2 error of a batch row,
    largest |d| / (rtol |ref| + atol_rms rms(ref)) of an element, which
    passes at <= 1)."""
    d = out.float() - ref.float()
    rel = (d.flatten(1).norm(dim=1) / ref.float().flatten(1).norm(dim=1)
           .clamp_min(1e-30)).max().item()
    lim = SSD_TOL["rtol"] * ref.abs() \
        + SSD_TOL["atol_rms"] * ref.float().square().mean().sqrt()
    elem = (d.abs() / lim.clamp_min(1e-30)).max().item()
    return rel <= SSD_REL_L2 and elem <= 1, d.abs().max().item(), rel, elem


def ssd_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, T, H, P, N, dtype, layout): "model" takes B and C as
    # strided slices of one (B, T, e) tensor, as w_in's split gives them;
    # "strided" also xh and dt. The bf16 cases run the wgmma body: whole
    # and ragged 64-step chunks, one batch row, and an odd H, whose last
    # block holds one head (odd H makes e odd, so its B and C are
    # contiguous: the TMA body refuses B and C at e's stride)
    return [("zamba2 prefill", 4, 512, 64, 64, 64, bf, "model"),
            ("zamba2 prefill", 4, 512, 64, 64, 64, bf, "contiguous"),
            ("two chunks", 2, 128, 8, 64, 64, bf, "contiguous"),
            ("one sequence", 1, 200, 8, 64, 64, bf, "model"),
            ("odd heads", 2, 130, 5, 64, 64, bf, "contiguous"),
            ("odd heads at the smoke width", 1, 100, 3, 32, 16, bf,
             "contiguous"),
            ("zamba2 prefill", 4, 512, 64, 64, 64, f32, "model"),
            ("one step", 2, 1, 8, 64, 64, bf, "contiguous"),
            ("one step", 2, 1, 8, 64, 64, f32, "contiguous"),
            ("one chunk less a step", 2, 63, 8, 64, 64, bf, "contiguous"),
            ("one chunk", 2, 64, 8, 64, 64, f32, "contiguous"),
            ("one chunk and a step", 2, 65, 8, 64, 64, bf, "strided"),
            ("one chunk and a step", 2, 65, 8, 64, 64, f32, "contiguous"),
            ("smoke width", 2, 77, 8, 32, 16, f32, "contiguous"),
            ("smoke width", 3, 130, 8, 32, 16, bf, "strided")]


def ssd_inputs(gen, B, T, H, P, N, dtype, layout, device):
    """(xh, dt, A, Bm, Cm) as the Mamba2 block makes them: dt =
    softplus(.) > 0 in ``dtype``, A = -exp(.) < 0 in float32."""
    e = 2 * H * P + 2 * N + H
    zx = torch.randn(B, T, e, generator=gen, device=device).to(dtype)
    xh, Bm, Cm, dt = zx.split([2 * H * P, N, N, H], dim=-1)
    xh = xh[..., H * P:].unflatten(-1, (H, P))
    dt = F.softplus(dt.float() - 1).to(dtype)
    if layout == "strided":
        dt = torch.cat([dt, dt], dim=-1)[..., :H]
    else:
        xh = xh.contiguous()
        if layout == "contiguous":
            Bm, Cm = Bm.contiguous(), Cm.contiguous()
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=device))
    return xh, dt, A, Bm, Cm


def check_ssd(device):
    """B4 against the plain scan in every case, y and the final state; the
    same limits must reject each planted fault, and a second run on the
    same inputs must give the same bits. Returns the max abs error at the
    bf16 prefill case."""
    gen = torch.Generator(device=device).manual_seed(3)
    err = 0.0
    for label, B, T, H, P, N, dt_, layout in ssd_cases():
        ins = ssd_inputs(gen, B, T, H, P, N, dt_, layout, device)
        y, h = SO.ssd_scan(*ins, return_state=True)
        y2, h2 = SO.ssd_scan(*ins, return_state=True)
        torch.cuda.synchronize()
        bitwise = torch.equal(y, y2) and torch.equal(h, h2)
        y_ref, h_ref = SR.ssd_scan_ref(*ins)
        name = str(dt_).replace("torch.", "")
        shape = f"B={B} T={T} H={H} P={P} N={N} {name} {layout}"
        ry, rh = ssd_agreement(y, y_ref), ssd_agreement(h, h_ref)
        print(f"ssd_scan {label} {shape}: y max|d|={ry[1]:.3g} row rel "
              f"L2={ry[2]:.3g} elem={ry[3]:.3g}; state max|d|={rh[1]:.3g} "
              f"row rel L2={rh[2]:.3g} elem={rh[3]:.3g} "
              f"{'ok' if ry[0] and rh[0] else 'MISMATCH'}; second run "
              f"{'bitwise equal' if bitwise else 'DIFFERS'}")
        check(ry[0] and rh[0], f"ssd_scan disagrees with its plain version "
                               f"({label}, {shape})")
        check(bitwise, f"ssd_scan does not repeat bit for bit ({label}, "
                       f"{shape})")
        for fault in ssd_faults(T):
            fy, fh = plain_ssd(*ins, fault)
            fy, fh = ssd_agreement(fy, y_ref), ssd_agreement(fh, h_ref)
            caught = not (fy[0] and fh[0])
            print(f"  planted fault '{fault}': row rel L2 y/state = "
                  f"{fy[2]:.3g}/{fh[2]:.3g}, elem {fy[3]:.3g}/{fh[3]:.3g} "
                  f"{'rejected' if caught else 'NOT REJECTED'}")
            check(caught, f"the ssd_scan limits pass a planted fault "
                          f"({fault}, {label}, {shape})")
        if label == "zamba2 prefill" and dt_ == torch.bfloat16:
            err = max(ry[1], rh[1])
    return err


def check_ssd_grad(device):
    """SSDScan (B4 forward, autograd of the plain scan backward) against
    autograd of the plain scan, all five inputs' gradients through y and
    the final state, at the smoke width."""
    gen = torch.Generator(device=device).manual_seed(4)
    ins = ssd_inputs(gen, 2, 130, 4, 32, 16, torch.float32, "strided",
                     device)
    gy = torch.randn(2, 130, 4, 32, generator=gen, device=device)
    gh = torch.randn(2, 4, 32, 16, generator=gen, device=device)
    grads = {}
    for route, fn in (("kernel", lambda *a: SO.ssd_scan(*a, return_state=True)),
                      ("plain", SR.ssd_scan_ref)):
        leaves = [t.detach().requires_grad_() for t in ins]
        zero_counts()
        y, h = fn(*leaves)
        ((y * gy).sum() + (h * gh).sum()).backward()
        torch.cuda.synchronize()
        grads[route] = ([t.grad for t in leaves], read_counts())
    (gk, nk), (gp, _) = grads["kernel"], grads["plain"]
    rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp))
    print(f"ssd_scan gradient (SSDScan vs autograd of the plain scan, "
          f"B=2 T=130 H=4 P=32 N=16 f32): worst input's rel L2 {rel:.3g} "
          f"(limit {SSD_REL_L2}); launches {nk}")
    check(nk["ssd_scan"] == 1 and nk["ssd_scan_ref"] == 1,
          f"SSDScan did not run B4 forward and the plain scan backward: {nk}")
    check(rel <= SSD_REL_L2, "SSDScan's gradient disagrees with the plain")


def check_refusals(device):
    """On the card a wrapper launches its kernel or raises: what the
    kernels do not take is refused, and nothing falls back to the plain
    versions."""
    before = {f.__name__: f.launches for f in COUNTED}
    q = torch.randn(1, 8, 4, 8, device=device)
    k16 = torch.randn(1, 8, 4, 16)
    h16 = torch.randn(1, 8, 4, 16, device=device).half()
    lse = torch.zeros(1, 4, 8, device=device)

    def scan(P, N, dtype=torch.float32):
        return (torch.zeros(1, 8, 2, P, device=device, dtype=dtype),
                torch.ones(1, 8, 2, device=device),
                -torch.ones(2, device=device),
                torch.zeros(1, 8, N, device=device),
                torch.zeros(1, 8, N, device=device))

    for what, call, exc in (
            ("head dim 8", lambda: FO.flash_attention(q, q, q), ValueError),
            ("backward, head dim 8", lambda: FO.flash_attention_bwd(
                q, q, q, q, lse, q), ValueError),
            ("backward, float16", lambda: FO.flash_attention_bwd(
                h16, h16, h16, h16, lse, h16), TypeError),
            ("float16", lambda: DO.decode_attention(
                q[:, 0].half(), q.half(), q.half(), 3), TypeError),
            ("k on the CPU", lambda: FO.flash_attention(
                k16.to(device), k16, k16), ValueError),
            ("scan (P, N) = (16, 8)", lambda: SO.ssd_scan(
                *scan(16, 8)), ValueError),
            ("scan Bm on the CPU", lambda: SO.ssd_scan(
                *scan(64, 64)[:3], torch.zeros(1, 8, 64),
                scan(64, 64)[4]), ValueError),
            ("scan dt float32, xh bfloat16", lambda: SO.ssd_scan(
                *scan(64, 64, torch.bfloat16)[:1],
                *scan(64, 64)[1:]), TypeError),
            # B and C at the stride of an odd e (odd H): not 16-byte
            # aligned, so the bf16 body's TMA cannot read them
            ("scan bfloat16 B and C at an odd stride", lambda: SO.ssd_scan(
                *ssd_inputs(torch.Generator(device=device).manual_seed(5), 1,
                            8, 3, 64, 64, torch.bfloat16, "model", device)),
             ValueError)):
        try:
            call()
        except exc as e:
            print(f"refused on the card: {what}: {e}")
        else:
            die(f"a wrapper took {what} on the card")
    check({f.__name__: f.launches for f in COUNTED} == before,
          "a refused call launched something")


# B1's main-path shapes: (path, B, H, KV, S, hd), all bf16 and causal
FLASH_TIMED = (("yi-6b prefill", 4, 32, 4, 512, 128),
               ("zamba2 prefill", 4, 32, 32, 512, 64),
               ("gpt2 train forward", TRAIN_B, 12, 12, TRAIN_S, 64))


def time_flash(device, gen):
    """B1, its plain version and SDPA timed at each of FLASH_TIMED, with
    the card's bound; one dict a shape."""
    bf = torch.bfloat16
    out = []
    for path, B, H, KV, S, hd in FLASH_TIMED:
        sets = [rand_like_cases(gen, [(B, S, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd)], bf, device)
                for _ in range(4)]
        ms = time_ms(lambda q, k, v: FO.flash_attention(q, k, v), sets)
        plain = time_ms(lambda q, k, v: FR.flash_attention_ref(q, k, v),
                        sets, iters=5)
        lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), sets)
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd) \
            + 4 * B * H * S
        ops = 4 * B * H * hd * S * (S + 1) / 2      # causal QK^T and PV
        b_ms, b_by = bound(nbytes, ops)
        out.append({"path": path, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                    "vs_library": ms / lib,
                    "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 "
                             f"causal"})
    return out


# B3's main-path shapes: (path, B, H, KV, S, hd, lens), all bf16: a decode
# step of yi-6b's ragged generate (32 layers' caches), of zamba2's generate,
# and every row on the one-chunk path
DECODE_TIMED = (("yi-6b serving", 4, 32, 4, SERVE_MAX_LEN, 128,
                 [n + N_NEW // 2 for n in PROMPT_LENS]),
                ("zamba2 decode", 4, 32, 32, SERVE_MAX_LEN, 64,
                 [512 + N_NEW // 2] * 4),
                ("one chunk", 4, 32, 4, SERVE_MAX_LEN, 128, [1, 17, 63, 64]))


def decode_sets(gen, B, H, KV, S, hd, device, n: int = 32):
    return [rand_like_cases(gen, [(B, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hd)], torch.bfloat16, device)
            for _ in range(n)]


def time_decode(device, gen):
    """B3, its plain version and SDPA timed at each of DECODE_TIMED, with
    the card's bound; and B3 at yi-6b's heads by the chunks each row holds
    (1, 2, 5, 9: 16 blocks a chunk)."""
    shapes = []
    for path, B, H, KV, S, hd, lens in DECODE_TIMED:
        ln = torch.tensor(lens, dtype=torch.int32, device=device)
        mask = (torch.arange(S, device=device)[None, :] < ln[:, None])
        mask = mask[:, None, None, :]
        sets = decode_sets(gen, B, H, KV, S, hd, device)
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
        shapes.append({"path": path, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "vs_library": ms / lib,
                       "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 "
                                f"lens={lens}"})
    _, B, H, KV, S, hd, _ = DECODE_TIMED[0]
    sets = decode_sets(gen, B, H, KV, S, hd, device)
    by_chunks = []
    for rows in (64, 128, 320, 544):
        ln = torch.full((B,), rows, dtype=torch.int32, device=device)
        by_chunks.append({"chunks": -(-rows // 64), "rows": rows,
                          "ms": time_ms(lambda q, k, v: DO.decode_attention(
                              q, k, v, ln), sets, iters=64)})
    return shapes, by_chunks


def time_kernels(device, errs, launches):
    """The kernels' line: each kernel, its plain version and the library
    call timed at the main paths' shapes (B1 and B3 serving yi-6b, B2a and
    B2b training, B4 serving zamba2, B5 serving rwkv6-3b), with the card's
    bound. ``launches`` holds each path's counts; ``launches`` in the line
    is their sum."""
    gen = torch.Generator(device=device).manual_seed(1)
    bf = torch.bfloat16
    out = []

    # B1 at its three main-path shapes; the entry's own numbers are the
    # yi-6b prefill's, the first
    shapes = time_flash(device, gen)
    main = shapes[0]
    out.append({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_fwd.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
                "launches": sum(n["flash_attention"] for n in launches.values()),
                "launches_by_path": {p: n["flash_attention"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["flash_attention"],
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "shape")},
                "shapes": shapes})

    # B3 at its main-path shapes; the entry's own numbers are the yi-6b
    # serving shape's, the first
    shapes, by_chunks = time_decode(device, gen)
    main = shapes[0]
    out.append({"name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/decode_attention/csrc/"
                          "decode.cu",
                "replaces": "src/repro/kernels/decode_attention/kernel.py:23",
                "launches": sum(n["decode_attention"] for n in launches.values()),
                "launches_by_path": {p: n["decode_attention"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["decode_attention"],
                **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "shape")},
                "shapes": shapes, "ms_by_chunks": by_chunks})

    # B2a and B2b at a gpt2-124m train step's attention: (8, 1024), 12 heads
    B, H, KV, S, hd = TRAIN_B, 12, 12, TRAIN_S, 64
    scale = hd ** -0.5
    sets, full, lib_sets = [], [], []
    for _ in range(4):
        q, k, v, do = rand_like_cases(gen, [(B, S, H, hd), (B, S, KV, hd),
                                            (B, S, KV, hd), (B, S, H, hd)],
                                      bf, device)
        o, lse = FO.flash_attention(q, k, v)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, lse, delta))
        full.append((q, k, v, o, lse, do))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_sets.append((ot, qt, kt, vt, do.transpose(1, 2)))
    ms_dq = time_ms(lambda *a: FO.flash_bwd_dq(*a, True, scale), sets)
    ms_dkv = time_ms(lambda *a: FO.flash_bwd_dkv(*a, True, scale), sets)
    # the whole backward as the train step calls it (delta, B2a, B2b),
    # beside SDPA's, which also forms its delta
    ms_bwd = time_ms(lambda *a: FO.flash_attention_bwd(*a), full)
    plain = time_ms(lambda *a: FR.flash_attention_bwd_ref(*a), full, iters=5)
    lib = time_ms(lambda ot, qt, kt, vt, dot: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), lib_sets)
    pairs = B * H * S * (S + 1) / 2                    # causal (q, k) pairs
    shape = f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal"
    note = ("plain_ms and library_ms are each one timing of a call that "
            "computes dq, dk and dv together (flash_attention_bwd_ref; "
            "torch.autograd.grad of scaled_dot_product_attention); the "
            "same number stands in the B2a and the B2b entry, as does "
            "bwd_ms, the whole flash_attention_bwd call (delta, B2a and "
            "B2b), which is what compares with library_ms")
    for name, ms, line, nbytes, ops in (
            ("flash_bwd_dq", ms_dq, 138,
             2 * (3 * B * S * H * hd + 2 * B * S * KV * hd) + 8 * B * H * S,
             3 * 2 * hd * pairs),           # S, dP and dS.K
            ("flash_bwd_dkv", ms_dkv, 181,
             2 * (2 * B * S * H * hd + 4 * B * S * KV * hd) + 8 * B * H * S,
             4 * 2 * hd * pairs)):          # S, dP, P^T.dO and dS^T.Q
        b_ms, b_by = bound(nbytes, ops)
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_bwd.cu",
                    "replaces": f"src/repro/kernels/flash_attention/"
                                f"kernel.py:{line}",
                    "launches": sum(n[name] for n in launches.values()),
                    "launches_by_path": {p: n[name]
                                         for p, n in launches.items()},
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "bwd_ms": ms_bwd, "note": note, "shape": shape})

    # B4 at a Mamba2 block of zamba2-1.2b's prefill: (4, 512), 64 heads
    B, T, H, P, N = 4, 512, 64, 64, 64
    sets = [ssd_inputs(gen, B, T, H, P, N, bf, "model", device)
            for _ in range(4)]
    ms = time_ms(lambda *a: SO.ssd_scan(*a, return_state=True), sets)
    plain = time_ms_unqueued(lambda *a: SR.ssd_scan_ref(*a), sets)
    nbytes = 2 * (B * T * H * P + B * T * H + 2 * B * T * N) + 4 * H \
        + 4 * (B * T * H * P + B * H * P * N)
    # the chunked form over 64-step chunks: C.B^T and G.x over the causal
    # (s <= t) pairs, C.h^T for every chunk after the first (h is 0 in
    # it), and the state update
    chunks = [min(64, T - t0) for t0 in range(0, T, 64)]
    ops = B * H * sum(r * (r + 1) * (N + P) + 2 * r * P * N * (2 if i else 1)
                      for i, r in enumerate(chunks))
    b_ms, b_by = bound(nbytes, ops)
    out.append({"name": "ssd_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/ssm_scan/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssm_scan/kernel.py:22",
                "launches": sum(n["ssd_scan"] for n in launches.values()),
                "launches_by_path": {p: n["ssd_scan"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["ssd_scan"], "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "note": "no single PyTorch call computes the scan; the "
                        "operations are the function's, counted at the "
                        "bf16 rate of the inputs, while the kernel's wgmma "
                        "body runs each product with a float32 operand "
                        "as three bf16 products (10 where the function "
                        "has 4)",
                "shape": f"B={B} T={T} H={H} P={P} N={N} bf16, B and C "
                         f"strided, final state written"})

    # B5 at a time mix of rwkv6-3b's prefill: (4, 512), 40 heads of 64
    B, T, H, N = 4, 512, 40, 64
    sets = [rwkv_inputs(gen, B, T, H, bf, "model", device) for _ in range(4)]
    ms = time_ms(lambda *a: RO.rwkv6_scan(*a), sets)
    plain = time_ms_unqueued(lambda *a: RR.rwkv6_scan_ref(*a), sets)
    elems = B * T * H * N
    # r, k, v in bf16 and w in float32 read; u read; y and the state written
    nbytes = 2 * 3 * elems + 4 * elems + 4 * H * N + 4 * elems \
        + 4 * B * H * N * N
    # per step and (b, h), on the (N, N) state: k v^T, u o kv, S + that,
    # r^T times it (a multiply and an add), w o S, + kv
    ops = 7 * N * N * B * T * H
    b_ms, b_by = bound(nbytes, ops)
    # the bf16 body spreads the B * H chains of chunks over at most one
    # block an SM: its time at T = 512 for one chain alone, one for every
    # SM, rwkv6-3b's B * H and two for every SM
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    by_chains = []
    for Bw, Hw in ((1, 1), (1, sms), (B, H), (2, sms)):
        wsets = [rwkv_inputs(gen, Bw, T, Hw, bf, "model", device)
                 for _ in range(2)]
        by_chains.append({"chains": Bw * Hw, "ms": time_ms(
            lambda *a: RO.rwkv6_scan(*a), wsets)})
    out.append({"name": "rwkv6_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/rwkv6_scan/csrc/"
                          "rwkv6_scan.cu",
                "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:22",
                "launches": sum(n["rwkv6_scan"] for n in launches.values()),
                "launches_by_path": {p: n["rwkv6_scan"]
                                     for p, n in launches.items()},
                "max_abs_err": errs["rwkv6_scan"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
                "note": "no single PyTorch call computes the scan; the "
                        "operations are the sequential recurrence's, counted "
                        "at the bf16 rate, while the kernel's wgmma body runs "
                        "the chunked form: 64-step chunks on the tensor "
                        "cores, each float32 operand as three bf16 terms, "
                        "and the diagonal 16-step blocks and the decays as "
                        "float32 on the CUDA cores; persistent blocks share "
                        "the chunks of all (b, h) chains equally",
                "shape": f"B={B} T={T} H={H} N={N} bf16 r/k/v, float32 w "
                         f"and u, final state written",
                "ms_by_chains": by_chains})
    return out


# ---------------------------------------------------------------------------
# yi-6b serving at full width
# ---------------------------------------------------------------------------


# every kernel launcher and plain version, each with its launch counter
COUNTED = (FO.flash_attention, FO.flash_bwd_dq, FO.flash_bwd_dkv,
           DO.decode_attention, SO.ssd_scan, RO.rwkv6_scan,
           FR.flash_attention_ref, FR.flash_attention_bwd_ref,
           DR.decode_attention_ref, SR.ssd_scan_ref, RR.rwkv6_scan_ref)
KERNELS = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv",
           "decode_attention", "ssd_scan", "rwkv6_scan")
PLAIN = ("flash_attention_ref", "flash_attention_bwd_ref",
         "decode_attention_ref", "ssd_scan_ref", "rwkv6_scan_ref")


def zero_counts() -> None:
    for f in COUNTED:
        f.launches = 0


def read_counts() -> dict:
    return {f.__name__: f.launches for f in COUNTED}


def plain_train(q, k, v, causal=True, scale=None):
    """flash_attention_train with the plain forward and backward."""
    return FO.FlashAttention.apply(q, k, v, causal, scale,
                                   FR.flash_attention_ref,
                                   FR.flash_attention_bwd_ref)


@contextmanager
def plain_attention(train_route=plain_train):
    """The attention sublayer with the kernel wrappers swapped for their
    plain versions (forward, backward and decode): the yardstick of the
    full-width comparisons. ``train_route`` replaces the training and
    prefill attention (the planted faults pass their own)."""
    saved = A.flash_attention_train, A.decode_attention
    A.flash_attention_train, A.decode_attention = \
        train_route, DR.decode_attention_ref
    try:
        yield
    finally:
        A.flash_attention_train, A.decode_attention = saved


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
        zero_counts()
        t0 = time.perf_counter()
        out[path] = run()
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - t0
        launches[path] = read_counts()
        print(f"{path} launches: {launches[path]}")
        check(launches[path]["flash_attention"] > 0,
              f"{path}: flash_attention never launched")
        check(launches[path]["decode_attention"] > 0,
              f"{path}: decode_attention never launched")
        check(launches[path]["flash_bwd_dq"] == 0
              and launches[path]["flash_bwd_dkv"] == 0,
              f"{path}: a backward kernel ran while serving")
        check(launches[path]["ssd_scan"] == 0, f"{path}: B4 ran on yi-6b")
        check(all(launches[path][n] == 0 for n in PLAIN),
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
    # one device kernel a B3 call: one call a layer and decode step
    step = profile["decode_step"]
    b3 = step and step["b3_kernels_per_step"]
    print(f"yi-6b decode step: {b3} B3 device kernels for {cfg.n_layers} "
          f"calls")
    check(b3 == cfg.n_layers, f"yi-6b decode step: {b3} B3 device kernels, "
                              f"not one for each of {cfg.n_layers} calls")
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
    torch.profiler (see :func:`device_window`)."""
    logits, cache = engine._prefill(prompts)
    tok = logits[:, -1].argmax(-1, keepdim=True)

    def decode4():
        nonlocal cache, tok
        for _ in range(4):
            lg, cache = engine._decode(cache, tok)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    return {"prefill": device_window(lambda: engine._prefill(prompts),
                                     prefill_ms),
            "decode_step": device_window(decode4, decode_ms, 4)}


def small_model_matches_cpu(device) -> None:
    """Smoke width in float32: greedy tokens on the card (kernels) equal
    those on the CPU (plain versions), for yi-6b (ragged prompts) and
    zamba2-1.2b (uniform prompts; the hybrid family takes no other)."""
    for arch, lens in ((yi_6b, [16, 5, 11]), (zamba2_1p2b, None)):
        cfg = arch.smoke_config(dtype=torch.float32)
        cpu = build_model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        prompts = np.random.RandomState(1).randint(1, cfg.vocab, (3, 16))
        out = {}
        for dev, model in (("cpu", cpu), ("cuda", build_model(cfg, device))):
            eng = ServeEngine(model, params, max_len=32, device=dev)
            zero_counts()
            out[dev] = eng.generate(prompts, 12, prompt_lens=lens)
        n = read_counts()
        check(np.array_equal(out["cuda"], out["cpu"]),
              f"{cfg.name} smoke model: card and CPU tokens differ")
        check(all(n[k] == 0 for k in PLAIN) and n["flash_attention"] > 0
              and n["decode_attention"] > 0
              and (n["ssd_scan"] > 0) == (cfg.family == "hybrid"),
              f"{cfg.name} smoke model on the card: launches {n}")
        print(f"{cfg.name} smoke model f32: card tokens equal CPU tokens; "
              f"card launches {n}")


def small_train_matches_cpu(device) -> None:
    """Smoke width in float32: 3 train steps on the card (kernels) against
    3 on the CPU (plain versions), from the same params and batch."""
    cfg = gpt2_124m.smoke_config(dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens = np.random.RandomState(2).randint(0, cfg.vocab, (2, 33))
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    out = {}
    for dev in ("cpu", device):
        model = build_model(cfg, device=dev)
        p = unflatten((path, t.to(model.device)) for path, t in
                      flatten(params))
        state = adamw_init(p, opt)
        step = make_train_step(model, opt)
        zero_counts()
        losses = []
        for _ in range(3):
            p, state, metrics = step(p, state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
        out[str(model.device.type)] = (losses, p, read_counts())
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, n_gpu) = out["cpu"], out["cuda"]
    L = cfg.n_layers
    check(n_gpu["flash_attention"] == 3 * 2 * L
          and n_gpu["flash_bwd_dq"] == n_gpu["flash_bwd_dkv"] == 3 * L
          and all(n_gpu[n] == 0 for n in PLAIN),
          f"smoke model train steps on the card: launches {n_gpu}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    p_rel = max(((a.cpu() - b).norm() / b.norm()).item() for (_, a), (_, b)
                in zip(flatten(p_gpu), flatten(p_cpu)))
    print(f"smoke model f32, 3 train steps: losses card {l_gpu} cpu {l_cpu}; "
          f"loss rel err {loss_rel:.3g}, params rel L2 (worst leaf) "
          f"{p_rel:.3g} (limit {SMOKE_TRAIN_REL}); card launches {n_gpu}")
    check(loss_rel <= SMOKE_TRAIN_REL and p_rel <= SMOKE_TRAIN_REL,
          "smoke model: card and CPU train steps differ")


def model_faults(n_layers: int):
    """Training routes of the plain attention with one planted fault each,
    for the full-width comparison: {fault: route}. Each route serves one
    value_and_grad."""
    def route(fwd, bwd):
        return lambda q, k, v, causal=True, scale=None: \
            FO.FlashAttention.apply(q, k, v, causal, scale, fwd, bwd)

    def bwd_fault(mask=causal_seen, **kw):
        """The plain backward over the pairs ``mask(q, k)``, with ``kw``."""
        def bwd(q, k, v, o, lse, do, causal=True, scale=None):
            return plain_bwd(q, k, v, o, lse, do, seen=mask(q, k), **kw)
        return bwd

    def fwd_edge(q, k, v, causal=True, scale=None):
        return plain_masked(q, k, v, causal_seen(q, k, edge=1))

    def first_layer_only(bad):
        """The sound plain backward, except in the first layer (the last
        of the n_layers backward calls of one value_and_grad)."""
        calls = [0]

        def bwd(*a, **kw):
            calls[0] += 1
            return (bad if calls[0] == n_layers else
                    FR.flash_attention_bwd_ref)(*a, **kw)
        return bwd

    def first_head_tile_dropped(q, k):
        seen = causal_seen(q, k).expand(q.shape[2], -1, -1).clone()
        seen[0] = tile_dropped(seen[0])
        return seen

    return {
        "backward: delta left out": route(
            FR.flash_attention_ref, bwd_fault(use_delta=False)),
        "backward: 64-row K/V tile dropped": route(
            FR.flash_attention_ref,
            bwd_fault(lambda q, k: tile_dropped(causal_seen(q, k)))),
        "forward: causal edge off by one": route(
            fwd_edge, FR.flash_attention_bwd_ref),
        "backward, first layer only: delta left out": route(
            FR.flash_attention_ref,
            first_layer_only(bwd_fault(use_delta=False))),
        "backward, first layer and first head only: 64-row K/V tile "
        "dropped": route(
            FR.flash_attention_ref,
            first_layer_only(bwd_fault(first_head_tile_dropped)))}


def grads_vector(grads) -> torch.Tensor:
    return torch.cat([g.float().flatten() for _, g in flatten(grads)])


def attn_slices(grads) -> dict:
    """{leaf: float32 gradient} of the attention weights, stacked over the
    layers."""
    return {path: g.float() for path, g in flatten(grads)
            if path in ATTN_LEAVES}


def worst_attn_slice(got: dict, ref: dict):
    """(largest relative L2 error of one layer's slice of an attention
    weight's gradient, 'leaf layer i')."""
    worst = (0.0, "")
    for path, r in ref.items():
        d = (got[path] - r).flatten(1).norm(dim=1) \
            / r.flatten(1).norm(dim=1).clamp_min(1e-30)
        i = int(d.argmax())
        worst = max(worst, (d[i].item(), f"{path.split('/')[-1]} layer {i}"))
    return worst


def train(device, card):
    """gpt2-124m at full width: kernel path against plain path on one
    batch, then TRAIN_STEPS steps of make_train_step, each step's launch
    counts read on their own."""
    cfg = gpt2_124m.config()
    check(cfg.remat == "full" and cfg.dtype == torch.bfloat16
          and cfg.param_dtype == torch.float32, f"config {cfg}")
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1),
                           generator=torch.Generator(device=device)
                           .manual_seed(1), device=device)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    print(f"setup: gpt2-124m ({cfg.param_count() / 1e6:.1f} M params, "
          f"remat {cfg.remat}) initialised in "
          f"{time.perf_counter() - t0:.1f} s")

    # kernel path against plain path, the same params and batch
    zero_counts()
    loss_k, grads_k = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    n_k = read_counts()
    gk, ak = grads_vector(grads_k), attn_slices(grads_k)
    del grads_k
    with plain_attention():
        zero_counts()
        loss_p, grads_p = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        n_p = read_counts()
    gp, ap = grads_vector(grads_p), attn_slices(grads_p)
    del grads_p
    check(all(n_p[n] == 0 for n in KERNELS) and n_p["flash_attention_ref"]
          > 0 and n_p["flash_attention_bwd_ref"] > 0,
          f"the plain run launched a kernel or skipped a plain version: "
          f"{n_p}")
    check(bool(torch.isfinite(gk).all()) and bool(torch.isfinite(loss_k)),
          "non-finite loss or gradients on the kernel path")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = ((gk - gp).norm() / gp.norm()).item()
    slice_rel, slice_at = worst_attn_slice(ak, ap)
    print(f"full width kernel vs plain (loss and gradients, bf16 "
          f"activations, f32 params): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f}, rel {loss_rel:.3g} (limit {TRAIN_LOSS_REL});"
          f" gradients rel L2 {grad_rel:.3g} (limit {TRAIN_GRAD_REL_L2}); "
          f"worst attention-weight slice rel L2 {slice_rel:.3g} at "
          f"{slice_at} (limit {TRAIN_ATTN_SLICE_REL_L2}); "
          f"launches kernel path {n_k}, plain path {n_p}")
    check(loss_rel <= TRAIN_LOSS_REL, "kernel and plain losses differ")
    check(grad_rel <= TRAIN_GRAD_REL_L2, "kernel and plain gradients differ")
    check(slice_rel <= TRAIN_ATTN_SLICE_REL_L2,
          f"kernel and plain attention-weight gradients differ ({slice_at})")
    del gk, ak
    for fault, route in model_faults(cfg.n_layers).items():
        with plain_attention(route):
            loss_f, grads_f = value_and_grad(model, params, batch)
        f_loss = abs(loss_f.item() - loss_p.item()) / abs(loss_p.item())
        f_grad = ((grads_vector(grads_f) - gp).norm() / gp.norm()).item()
        f_slice, f_at = worst_attn_slice(attn_slices(grads_f), ap)
        del grads_f
        caught = [f_loss > TRAIN_LOSS_REL, f_grad > TRAIN_GRAD_REL_L2,
                  f_slice > TRAIN_ATTN_SLICE_REL_L2]
        print(f"  planted fault '{fault}' at full width: loss rel "
              f"{f_loss:.3g}, gradients rel L2 {f_grad:.3g}, worst "
              f"attention-weight slice rel L2 {f_slice:.3g} at {f_at}; "
              f"rejected by the loss/gradients/slice limits: {caught}")
        check(any(caught), f"the full-width training limits pass a "
                           f"planted fault ({fault})")
    del gp, ap

    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=2, total_steps=10)
    step = make_train_step(model, opt_cfg)
    state = adamw_init(params, opt_cfg)
    L = cfg.n_layers
    want = {n: 0 for n in PLAIN + ("decode_attention", "ssd_scan",
                                   "rwkv6_scan")}
    want.update(flash_attention=2 * L, flash_bwd_dq=L, flash_bwd_dkv=L)
    losses, step_ms, per_step = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        zero_counts()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_counts())
        losses.append(metrics["loss"].item())
        print(f"train step {i + 1}: loss {losses[-1]:.5f} grad_norm "
              f"{metrics['grad_norm'].item():.4f} lr "
              f"{metrics['lr'].item():.3g} {step_ms[-1]:.1f} ms launches "
              f"{per_step[-1]}")
        check(per_step[-1] == want, f"train step {i + 1}: launches "
              f"{per_step[-1]}, want exactly {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    steady = float(np.mean(step_ms[1:]))
    profile = device_window(lambda: step(params, state, batch), steady,
                            shapes=True)
    return per_step, {"training": {
        "model": "gpt2-124m (12 layers, d=768, 12 heads, vocab 50257, f32 "
                 "params, bf16 activations, remat full, random weights)",
        "card": card, "batch": f"B={TRAIN_B} S={TRAIN_S}",
        "optimizer": "AdamW lr=6e-4 warmup 2 total 10",
        "losses": losses, "step_ms": step_ms,
        "step_ms_mean_after_first": steady,
        "tokens_per_s": TRAIN_B * TRAIN_S / (steady / 1e3),
        "peak_memory_gb": peak_gb,
        "launches_per_step": per_step[-1],
        "loss_rel_kernel_vs_plain": loss_rel,
        "grad_rel_l2_kernel_vs_plain": grad_rel,
        "attn_slice_rel_l2_kernel_vs_plain": slice_rel,
        "profile": profile}}


# ---------------------------------------------------------------------------
# data-parallel training over the fabric: DDPTrainer over a JcclWorld
# ---------------------------------------------------------------------------


def fabric_sum_faults(inputs, outputs) -> list:
    """Where each rank's all-reduce output differs, bit for bit, from the
    float32 sum of the ranks' ``inputs`` taken in rank order (for two
    ranks the sum has one order): one line a rank that differs, else
    []."""
    want = inputs[0].copy()
    for v in inputs[1:]:
        want += v
    faults = []
    for r, out in enumerate(outputs):
        bad = np.flatnonzero(out.view(np.uint32) != want.view(np.uint32))
        if bad.size:
            faults.append(f"rank {r}: {bad.size} of {want.size} elements "
                          f"differ from the float32 sum, first at {bad[0]}")
    return faults


def sync(device) -> None:
    """Wait for the card, when ``device`` is one."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _losses(run):
    """A TrainRun's loss a step."""
    return [loss for _, _, loss in run.timeline]


def kill_nic_after(cluster, step: int):
    """An ``on_step`` that fails DDP_NIC after step ``step``."""
    def on_step(s, t, loss):
        if s == step:
            cluster.fail_nic(DDP_NIC)
    return on_step


@contextmanager
def ddp_recorded(trainer, kill_after=None):
    """Times one DDPTrainer's run on the host clock around synchronised
    work and keeps step 1's all-reduce inputs, by wrapping the trainer's
    own steps: each rank's forward and backward (``_grad_fn``), its
    gradient copy to the host (``_flatten_grads``), the all-reduce
    (``_allreduce_grads``), AdamW, the store's save and restore. Its
    ``on_step`` reads the launch counts of the step that just ended and
    sets them to 0, and fails host1's first NIC after step
    ``kill_after``. Step 1's sum check, and its copies, are left out of
    the step's wall time."""
    tr, dev = trainer, trainer.device
    rec = {"rank_ms": [], "copy_ms": [], "fabric_s": [], "adamw_ms": [],
           "step_ms": [], "counts": [], "saves": [], "restores": [],
           "excluded": 0.0, "mark": None, "inputs": None,
           "sum_faults": None, "init_params": None, "params": None}
    grad_fn, flat, allreduce = tr._grad_fn, tr._flatten_grads, \
        tr._allreduce_grads
    init, save, restore = tr._init_state, tr.store.save, tr.store.restore
    adamw = TR.adamw_update

    def t_init():
        state = init()
        rec["init_params"] = state["params"]   # never updated in place
        sync(dev)
        rec["mark"] = time.perf_counter()
        return state

    def t_grad(params, batch):
        sync(dev)
        t0 = time.perf_counter()
        out = grad_fn(params, batch)
        sync(dev)
        rec["rank_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def t_flat(grads):
        t0 = time.perf_counter()
        out = flat(grads)
        rec["copy_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def t_allreduce(world, run, vecs):
        first = rec["inputs"] is None
        if first:
            t0 = time.perf_counter()
            rec["inputs"] = [v.copy() for v in vecs]
            rec["excluded"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        allreduce(world, run, vecs)
        rec["fabric_s"].append(time.perf_counter() - t0)
        if first:
            t0 = time.perf_counter()
            rec["sum_faults"] = fabric_sum_faults(rec["inputs"], vecs)
            rec["excluded"] += time.perf_counter() - t0

    def t_adamw(*a, **kw):
        t0 = time.perf_counter()
        out = adamw(*a, **kw)
        sync(dev)
        rec["adamw_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["params"] = out[0]
        return out

    def t_save(step, tree, metadata=None):
        t0 = time.perf_counter()
        path = save(step, tree, metadata)
        rec["saves"].append({
            "step": step, "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": os.path.getsize(os.path.join(path, "state.npz")),
            "reason": (metadata or {}).get("reason")})
        rec["mark"] = time.perf_counter()
        return path

    def t_restore(template, step=None):
        t0 = time.perf_counter()
        out = restore(template, step)
        sync(dev)
        step = out[1]["step"]
        rec["restores"].append({
            "step": step, "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": os.path.getsize(os.path.join(
                tr.store.root, f"step-{step:08d}", "state.npz"))})
        return out

    def on_step(step, t, loss):
        sync(dev)
        now = time.perf_counter()
        rec["step_ms"].append((now - rec["mark"] - rec["excluded"]) * 1e3)
        rec["excluded"] = 0.0
        rec["counts"].append(read_counts())
        zero_counts()
        if step == kill_after:
            tr.cluster.fail_nic(DDP_NIC)
        rec["mark"] = time.perf_counter()

    tr._grad_fn, tr._flatten_grads, tr._allreduce_grads = \
        t_grad, t_flat, t_allreduce
    tr._init_state, tr.store.save, tr.store.restore = \
        t_init, t_save, t_restore
    TR.adamw_update = t_adamw
    rec["on_step"] = on_step
    zero_counts()
    try:
        yield rec
    finally:
        TR.adamw_update = adamw
        tr._grad_fn, tr._flatten_grads, tr._allreduce_grads = \
            grad_fn, flat, allreduce
        tr._init_state, tr.store.save, tr.store.restore = \
            init, save, restore


def ddp_trainer(device, cfg, world_kw, ckpt_dir, batch_per_rank, seq_len,
                **tcfg_kw):
    """A DDPTrainer over a fresh ``build_world(**world_kw)`` (the world is
    returned beside it)."""
    cluster, libs, world = build_world(**world_kw)
    tcfg = TR.TrainerConfig(ckpt_dir=ckpt_dir, seed=0, **tcfg_kw)
    return TR.DDPTrainer(cluster, libs, cfg, tcfg,
                         batch_per_rank=batch_per_rank, seq_len=seq_len,
                         device=device), world


def run_fields(run) -> dict:
    """The virtual accounting the card and the CPU must share."""
    return {f: getattr(run, f) for f in DDP_RUN_FIELDS}


def ddp_smoke_matches_cpu(device) -> dict:
    """(a) The smoke trainer's model in float32: 3 steps on the card
    against 3 on the CPU from the same params, host1's first NIC killed
    after step 1; then, on the card, flat, bucketed and hooked runs."""
    cfg = gpt2_124m.smoke_config(dtype=torch.float32, **DDP_SMOKE)
    L = cfg.n_layers
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(dev, name, kill_after=None, **kw):
            tr, world = ddp_trainer(
                dev, cfg, dict(n_ranks=2, channels=2,
                               max_chunk_bytes=1 << 14),
                os.path.join(tmp, name), steps=DDP_SMOKE_STEPS,
                ckpt_every=2, lr=3e-3, batch_per_rank=2, seq_len=32, **kw)
            zero_counts()
            r = tr.train(world, on_step=None if kill_after is None else
                         kill_nic_after(tr.cluster, kill_after))
            runs[name] = (r, read_counts())
            return r
        cpu = run("cpu", "cpu", 1, bucket_bytes=1 << 16)
        card = run(device, "card", 1, bucket_bytes=1 << 16)
        for name, kw in DDP_MODES.items():
            run(device, name, **kw)
    l_cpu, l_card = _losses(cpu), _losses(card)
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    n = runs["card"][1]
    print(f"ddp smoke f32 (2 ranks x 2 x 32 tokens, 3 steps, NIC killed "
          f"after step 1): losses card {l_card} cpu {l_cpu}, rel "
          f"{rel:.3g} (limit {SMOKE_TRAIN_REL}); card {run_fields(card)}; "
          f"cpu {run_fields(cpu)}; card launches {n}")
    check(rel <= SMOKE_TRAIN_REL, "ddp smoke: card and CPU losses differ")
    check(run_fields(card) == run_fields(cpu),
          "ddp smoke: card and CPU virtual accounting differ")
    check(card.fallbacks >= 1 and card.final_step == DDP_SMOKE_STEPS,
          f"ddp smoke: {run_fields(card)}")
    bwd = DDP_SMOKE_STEPS * 2 * L    # one a layer, rank and step
    check(n["flash_attention"] == 2 * bwd    # remat "full" runs it twice
          and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == bwd
          and all(n[k] == 0 for k in PLAIN),
          f"ddp smoke on the card: launches {n}")
    modes = {name: _losses(runs[name][0]) for name in DDP_MODES}
    print(f"ddp smoke f32 on the card, healthy: losses {modes}; virtual "
          f"grad ms a step " + str({
              name: [x * 1e3 for x in runs[name][0].step_grad_times]
              for name in DDP_MODES}))
    check(modes["flat"] == modes["bucketed"] == modes["hooked"],
          "ddp smoke: flat, bucketed and hooked losses differ")
    return {"losses_card": l_card, "losses_cpu": l_cpu, "loss_rel": rel,
            "virtual": run_fields(card), "modes_losses": modes}


def ddp_full_width(device, card) -> tuple:
    """(b) gpt2-124m at full width: 2 ShiftLib ranks of 4 x 1024 tokens,
    4 steps, host1's first NIC killed after step 2; then the StandardLib
    baseline's crash, restore and resume. Returns (launches of the
    ShiftLib run, the ddp line)."""
    cfg = gpt2_124m.config()
    L = cfg.n_layers
    want = {n: 0 for n in PLAIN + ("decode_attention", "ssd_scan",
                                   "rwkv6_scan")}
    want.update(flash_attention=2 * 2 * L, flash_bwd_dq=2 * L,
                flash_bwd_dkv=2 * L)
    kw = dict(steps=DDP_STEPS, lr=3e-3, bucket_bytes=DDP_BUCKET_BYTES,
              batch_per_rank=DDP_B, seq_len=DDP_S)
    world_kw = dict(n_ranks=2, max_chunk_bytes=DDP_CHUNK_BYTES)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tr, world = ddp_trainer(device, cfg, world_kw,
                                os.path.join(tmp, "shift"),
                                ckpt_every=10 * DDP_STEPS, **kw)
        torch.cuda.reset_peak_memory_stats()
        with ddp_recorded(tr, kill_after=DDP_KILL) as rec:
            run = tr.train(world, on_step=rec["on_step"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        shift_s = time.perf_counter() - t0
        losses = _losses(run)
        print(f"ddp gpt2-124m ShiftLib: losses {losses}; step ms "
              f"{rec['step_ms']}; rank fwd+bwd ms {rec['rank_ms']}; "
              f"gradient copy ms {rec['copy_ms']}; fabric host s "
              f"{rec['fabric_s']}; AdamW ms {rec['adamw_ms']}; virtual "
              f"grad ms {[x * 1e3 for x in run.step_grad_times]}; "
              f"fallbacks {run.fallbacks} recoveries {run.recoveries} "
              f"restarts {run.restarts}; saves {rec['saves']}; peak "
              f"{peak_gb:.2f} GB; launches a step {rec['counts']}")
        check(run.final_step == DDP_STEPS and run.fallbacks >= 1
              and run.restarts == 0, f"ddp: {run_fields(run)}")
        for i, n in enumerate(rec["counts"]):
            check(n == want, f"ddp step {i + 1}: launches {n}, want "
                             f"exactly {want}")
        check(not rec["sum_faults"],
              f"ddp step 1: the fabric's sum is wrong: {rec['sum_faults']}")
        latest = tr.store.latest_step()
        meta = {} if latest is None else json.loads(open(os.path.join(
            tr.store.root, f"step-{latest:08d}", "meta.json")).read())
        check(meta.get("reason") == "post-fallback" and rec["saves"]
              and all(s["reason"] == "post-fallback" for s in rec["saves"]),
              f"ddp: checkpoints {rec['saves']}, latest meta {meta}")
        # one rank's gradient again, from the same params and batch
        _, grads = tr._grad_fn(rec["init_params"], tr._batch(0, 0))
        again, _ = tr._flatten_grads(grads)
        del grads
        differ = int(np.count_nonzero(again.view(np.uint32)
                                      != rec["inputs"][0].view(np.uint32)))
        repeat = differ == 0
        print(f"ddp: step 1's all-reduce equals the float32 sum of the "
              f"ranks' gradients bit for bit: {not rec['sum_faults']}; "
              f"rank 0's gradient computed again from the same params and "
              f"batch equals step 1's bit for bit: {repeat} ({differ} of "
              f"{again.size} elements differ)")
        check(repeat, "ddp: a rank's gradient does not repeat bit for bit")
        # a step's loss is taken on that step's batches, new ones each
        # step: at vocab 50257 each of the stream's bigrams comes up less
        # than once in a step's 8192 tokens, so 4 steps cannot learn it
        # and the loss stays at ln(50257) = 10.825 within the batches'
        # spread. What 4 steps do fit is the data they saw: step 1's
        # batches must score lower at the final params than at the first.
        with torch.no_grad():
            seen = float(np.mean([tr.model.loss(rec["params"],
                                                tr._batch(r, 0)).item()
                                  for r in range(tr.n)]))
        print(f"ddp: step 1's batches: loss {losses[0]:.6f} at the first "
              f"params, {seen:.6f} at the final params; the fourth step's "
              f"loss (its own batches) {losses[-1]:.6f}")
        check(all(np.isfinite(losses)) and np.isfinite(seen)
              and seen < losses[0],
              f"ddp: losses {losses}, step 1's batches at the final "
              f"params {seen}")
        rank_ms = float(np.median(rec["rank_ms"][2:]))
        profile = device_window(lambda: tr._grad_fn(
            rec["init_params"], tr._batch(0, 0)), rank_ms)
        shift = {"rec": rec, "run": run, "peak_gb": peak_gb,
                 "phase_s": shift_s, "seen_loss": seen,
                 "rank_profile": profile}
        del tr, again
        rec["inputs"] = rec["init_params"] = rec["params"] = None
        torch.cuda.empty_cache()

        # the baseline: StandardLib ranks, the same kill, checkpoint-restart
        t0 = time.perf_counter()
        tr, world = ddp_trainer(device, cfg, dict(world_kw,
                                                  lib_kind="standard"),
                                os.path.join(tmp, "standard"),
                                ckpt_every=DDP_KILL, **kw)
        with ddp_recorded(tr, kill_after=DDP_KILL) as brec:
            try:
                tr.train(world, on_step=brec["on_step"])
                rn = None
            except TR.RestartNeeded as e:
                rn = e
            check(rn is not None, "ddp baseline: the StandardLib run did "
                                  "not crash on the killed NIC")
            tr.cluster.recover_nic(DDP_NIC)
            cluster, libs, world = build_world(**dict(world_kw,
                                                      lib_kind="standard"))
            tr.cluster, tr.libs = cluster, libs
            base = TR.resume_training(tr, world, rn,
                                      on_step=brec["on_step"])
        base_s = time.perf_counter() - t0
        b_losses = _losses(base)
        print(f"ddp gpt2-124m StandardLib baseline: losses {b_losses}; "
              f"restarts {base.restarts}, final step {base.final_step}; "
              f"virtual grad ms {[x * 1e3 for x in base.step_grad_times]}; "
              f"saves {brec['saves']}; restores {brec['restores']}; step ms "
              f"{brec['step_ms']}")
        check(base.final_step == DDP_STEPS and base.restarts == 1
              and [r["step"] for r in brec["restores"]] == [DDP_KILL],
              f"ddp baseline: {run_fields(base)}, restarts {base.restarts},"
              f" restores {brec['restores']}")
        check(all(np.isfinite(b_losses)), f"ddp baseline: {b_losses}")
        del tr
        torch.cuda.empty_cache()

    ms = lambda xs: [x * 1e3 for x in xs]
    line = {"ddp": {
        "model": "gpt2-124m (12 layers, d=768, vocab 50257, f32 params, "
                 "bf16 activations, remat full, random weights)",
        "card": card,
        "world": f"2 ranks on one card, in turn; build_world(n_ranks=2, "
                 f"max_chunk_bytes={DDP_CHUNK_BYTES}); bucket_bytes="
                 f"{DDP_BUCKET_BYTES}; {DDP_B} x {DDP_S} tokens a rank",
        "kill": f"fail_nic({DDP_NIC}) after step {DDP_KILL}",
        "step_ms": rec["step_ms"],
        "rank_fwd_bwd_ms": rec["rank_ms"],
        "grad_copy_ms": rec["copy_ms"],
        "fabric_host_s": rec["fabric_s"],
        "adamw_ms": rec["adamw_ms"],
        "virtual_grad_ms": ms(run.step_grad_times),
        "virtual_grad_ms_healthy": {
            "shift": ms(run.step_grad_times[:DDP_KILL]),
            "standard": ms(base.step_grad_times[:DDP_KILL])},
        "fallbacks": run.fallbacks, "recoveries": run.recoveries,
        "restarts": {"shift": run.restarts, "standard": base.restarts},
        "saves": rec["saves"] + [dict(s, run="standard")
                                 for s in brec["saves"]],
        "restores": brec["restores"],
        "losses": {"shift": _losses(run), "standard": b_losses},
        "step1_batches_loss_at_final_params": shift["seen_loss"],
        "rank_fwd_bwd_profile": shift["rank_profile"],
        "peak_memory_gb": shift["peak_gb"],
        "launches_per_step": rec["counts"],
        "phase_s": {"shift": shift["phase_s"], "standard": base_s}}}
    total = {k: sum(c[k] for c in rec["counts"]) for k in rec["counts"][0]}
    return total, line


def ddp(device, card) -> tuple:
    """The data-parallel phase: (a) the float32 smoke trainer on the card
    against the CPU, (b) gpt2-124m at full width with a NIC killed, and
    its StandardLib baseline. Returns (launches of (b)'s ShiftLib run,
    the ddp line)."""
    t0 = time.perf_counter()
    smoke = ddp_smoke_matches_cpu(device)
    launches, line = ddp_full_width(device, card)
    line["ddp"]["smoke_f32"] = smoke
    line["ddp"]["phase_wall_s"] = time.perf_counter() - t0
    print(f"ddp phase: {line['ddp']['phase_wall_s']:.1f} s on {card}")
    return launches, line


# ---------------------------------------------------------------------------
# zamba2-1.2b serving at full width
# ---------------------------------------------------------------------------


def scan_route(fault=None):
    """The Mamba2 block's scan as the plain version (``fault`` None) or as
    the plain version with a planted fault, with the wrapper's
    signature."""
    def route(xh, dt, A, Bm, Cm, return_state=False):
        y, h = SR.ssd_scan_ref(xh, dt, A, Bm, Cm) if fault is None \
            else plain_ssd(xh, dt, A, Bm, Cm, fault)
        return (y, h) if return_state else y
    return route


@contextmanager
def scan_swapped(route):
    saved = BL.ssd_scan
    BL.ssd_scan = route
    try:
        yield
    finally:
        BL.ssd_scan = saved


@contextmanager
def plain_path(fault=None):
    """Every kernel of the zamba2 path swapped for its plain version, the
    scan with a planted ``fault`` if one is named."""
    with plain_attention(), scan_swapped(scan_route(fault)):
        yield


@contextmanager
def recording_blocks(store: list):
    """Append each Mamba2 block's (normed input, params) to ``store``."""
    saved = BL.mamba2_mix

    def record(x, p, cfg, state=None):
        store.append((x, p))
        return saved(x, p, cfg, state=state)
    BL.mamba2_mix = record
    try:
        yield
    finally:
        BL.mamba2_mix = saved


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def row_rel_l2(a, b) -> float:
    d = (a.float() - b.float()).flatten(1).norm(dim=1)
    return (d / b.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max().item()


def prefill_reading(got, ref) -> dict:
    """Relative L2 error of the logits and of each cache leaf."""
    (lg, cg), (lr, cr) = got, ref
    out = {"logits": rel_l2(lg, lr)}
    for key in cr:
        if key == "len":
            check(torch.equal(cg[key], cr[key]), "cache lengths differ")
        else:
            out[key] = rel_l2(cg[key], cr[key])
    return out


def decode_vs_forward(model, params, prompts, feed) -> float:
    """Teacher-forced decode logits after a prefill against forward's
    logits at the same positions: their relative L2 error."""
    S = prompts.shape[1]
    logits, cache = model.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    steps = [logits]
    for i in range(feed.shape[1]):
        logits, cache = model.decode_step(params, cache, feed[:, i:i + 1])
        steps.append(logits)
    full = torch.cat([torch.as_tensor(prompts, device=feed.device), feed],
                     dim=1)
    ref = model.forward(params, full)[:, S - 1:]
    return rel_l2(torch.cat(steps, dim=1), ref)


def zamba2_f32_path(device, model, params, prompts, feed) -> dict:
    """(a) The whole path in float32 at full width: kernel prefill's logits
    and every cache leaf against the plain prefill, and teacher-forced
    decode against forward; each must also reject the planted 'final state
    not written' and 'dt left out' faults of the scan."""
    cfg = model.cfg
    kern_in, plain_in = [], []
    zero_counts()
    with recording_blocks(kern_in):
        kern = model.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    n = read_counts()
    check(n["ssd_scan"] == cfg.n_layers
          and n["flash_attention"] == cfg.n_layers // cfg.attn_every
          and all(n[k] == 0 for k in PLAIN),
          f"float32 prefill launches {n}")
    with plain_path(), recording_blocks(plain_in):
        plain = model.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    got = prefill_reading(kern, plain)
    drift = [rel_l2(a, b) for (a, _), (b, _) in zip(kern_in, plain_in)]
    del kern, kern_in, plain_in
    dvf = decode_vs_forward(model, params, prompts, feed)
    worst = max(max(got.values()), dvf)
    print(f"zamba2 (a) float32 whole path, kernel vs plain prefill: "
          + ", ".join(f"{k} {v:.3g}" for k, v in got.items())
          + f"; decode vs forward {dvf:.3g}; worst {worst:.3g} (limit "
          f"{ZAMBA_F32_REL_L2}); drift of each Mamba2 block's input: "
          + " ".join(f"{d:.2g}" for d in drift))
    check(worst <= ZAMBA_F32_REL_L2, "float32 zamba2 kernel path disagrees")
    faults = {}
    for fault in ("final state not written", "dt left out of the input term"):
        with plain_path(fault):
            pre = max(prefill_reading(
                model.prefill(params, prompts, max_len=SERVE_MAX_LEN),
                plain).values())
        with scan_swapped(scan_route(fault)):
            dec = decode_vs_forward(model, params, prompts, feed)
        faults[fault] = {"prefill": pre, "decode_vs_forward": dec}
        print(f"  planted fault '{fault}': prefill worst {pre:.3g}, decode "
              f"vs forward {dec:.3g}; rejected by both: "
              f"{pre > ZAMBA_F32_REL_L2 and dec > ZAMBA_F32_REL_L2}")
        check(pre > ZAMBA_F32_REL_L2 and dec > ZAMBA_F32_REL_L2,
              f"the float32 zamba2 limit passes a planted fault ({fault})")
    return {"prefill": got, "decode_vs_forward": dvf, "input_drift": drift,
            "faults": faults}


def zamba2_bf16_layers(engine, prompts) -> dict:
    """(b) and (c) in bf16. (c): the whole prefill, kernel vs plain, with
    the drift of each Mamba2 block's input printed, not gated. (b): each
    of the 38 blocks on the plain run's input, kernel vs plain, to one
    limit that every planted scan fault must pass at every block."""
    cfg = engine.model.cfg
    kern_in, plain_in = [], []
    with recording_blocks(kern_in):
        lk, _ = engine._prefill(prompts)
    with plain_path(), recording_blocks(plain_in):
        lp, _ = engine._prefill(prompts)
    drift = [rel_l2(a, b) for (a, _), (b, _) in zip(kern_in, plain_in)]
    whole = rel_l2(lk, lp)
    print(f"zamba2 (c) bf16 whole path, kernel vs plain prefill logits: rel "
          f"L2 {whole:.3g} (not gated); drift of each Mamba2 block's input: "
          + " ".join(f"{d:.2g}" for d in drift))

    def block(x, p, route):
        with scan_swapped(route):
            out, st = BL.mamba2_mix(x, p, cfg)
        return out, st["ssm"]

    def reading(got, ref):
        return max(row_rel_l2(got[0], ref[0]), row_rel_l2(got[1], ref[1]))

    per_layer, faults = [], {f: [] for f in SSD_FAULTS}
    for x, p in plain_in:
        ref = block(x, p, scan_route())
        per_layer.append(reading(block(x, p, SO.ssd_scan), ref))
        for fault in SSD_FAULTS:
            faults[fault].append(reading(block(x, p, scan_route(fault)), ref))
    worst = max(per_layer)
    print(f"zamba2 (b) bf16 layer by layer, kernel vs plain (block output "
          f"and final state, worst batch row): worst {worst:.3g} at block "
          f"{int(np.argmax(per_layer))} (limit {ZAMBA_LAYER_REL_L2}); "
          + " ".join(f"{r:.2g}" for r in per_layer))
    check(len(per_layer) == cfg.n_layers, f"{len(per_layer)} blocks ran")
    check(worst <= ZAMBA_LAYER_REL_L2, "a bf16 Mamba2 block disagrees")
    for fault, rs in faults.items():
        print(f"  planted fault '{fault}': weakest block {min(rs):.3g}, "
              f"strongest {max(rs):.3g}; rejected at every block: "
              f"{min(rs) > ZAMBA_LAYER_REL_L2}")
        check(min(rs) > ZAMBA_LAYER_REL_L2, f"the bf16 block limit passes a "
                                            f"planted fault ({fault})")
    return {"whole_path_logits_rel_l2": whole, "input_drift": drift,
            "layer_worst_rel_l2": worst,
            "faults_weakest_block": {f: min(rs) for f, rs in faults.items()}}


def zamba2(device, card):
    """zamba2-1.2b at full width with random weights: (a) float32 whole
    path, then the bf16 ServeEngine: generate, the launches of a prefill
    and of a decode step, (b) and (c), and the step times."""
    cfg = zamba2_1p2b.config()
    L, G = cfg.n_layers, cfg.n_layers // cfg.attn_every
    rng = np.random.RandomState(3)
    prompts = rng.randint(1, cfg.vocab, size=(4, 512)).astype(np.int32)
    feed = torch.as_tensor(rng.randint(1, cfg.vocab, size=(4, 4)),
                           device=device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model32 = build_model(zamba2_1p2b.config(dtype=torch.float32),
                          device=device)
    params = model32.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    print(f"setup: zamba2-1.2b ({cfg.param_count() / 1e9:.3f} B params) "
          f"initialised in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        f32 = zamba2_f32_path(device, model32, params, prompts, feed)
    model = build_model(cfg, device=device)
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params, model32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, N_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    n_gen = read_counts()
    want = {k: 0 for k in KERNELS + PLAIN}
    want.update(ssd_scan=L, flash_attention=G, decode_attention=G * N_NEW)
    print(f"zamba2 generate launches: {n_gen}")
    check(n_gen == want, f"zamba2 generate: launches {n_gen}, want {want}")
    check(toks.shape == (4, 512 + N_NEW)
          and np.array_equal(toks[:, :512], prompts)
          and ((toks[:, 512:] >= 0) & (toks[:, 512:] < cfg.vocab)).all(),
          f"zamba2 generate tokens {toks.shape}")
    zero_counts()
    logits, cache = engine._prefill(prompts)
    n_pre = read_counts()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    zero_counts()
    logits, cache = engine._decode(cache, tok)
    n_dec = read_counts()
    print(f"zamba2 prefill launches {n_pre}; decode step launches {n_dec}")
    check(n_pre == dict(want, decode_attention=0),
          f"zamba2 prefill: launches {n_pre}")
    check(n_dec == dict(want, ssd_scan=0, flash_attention=0,
                        decode_attention=G),
          f"zamba2 decode step: launches {n_dec}")
    check(bool(torch.isfinite(logits).all()), "non-finite zamba2 logits")

    with torch.no_grad():
        bf16 = zamba2_bf16_layers(engine, prompts)

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
    return {"generate": n_gen}, {"zamba2": {
        "model": "zamba2-1.2b (38 Mamba2 blocks + 1 shared attention block "
                 "run 6 times, d=2048, random bf16 weights)",
        "card": card,
        "prefill_ms": min(prefill_ms), "prefill_shape": "B=4 S=512",
        "decode_ms_per_step": decode_ms, "decode_batch": 4,
        "generate_s": t_gen, "generate_tokens_per_s": 4 * N_NEW / t_gen,
        "decode_tokens_per_s": 4 / (decode_ms / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "setup_peak_memory_gb": setup_peak_gb,
        "launches": {"generate": n_gen, "prefill": n_pre,
                     "decode_step": n_dec},
        "float32_path": f32, "bf16": bf16, "profile": profile}}


# ---------------------------------------------------------------------------
# B5 (the RWKV6 scan) against its plain version
# ---------------------------------------------------------------------------


# B5 is held to its plain scan, for y and for the final state, by B4's
# limits and check (SSD_REL_L2, SSD_TOL, ssd_agreement), taken before B5's
# first run: both compute in float32 from the same inputs (bf16 r, k and v
# are cast first), so they differ only by the order of the sums. The same
# limits must reject each planted fault of the plain scan (RWKV_FAULTS) in
# every case where it changes the result.
# rwkv6-3b at full width, kernel path against plain path: zamba2's limits,
# set before the first run. (a) float32, the whole path: the relative L2
# error of the prefill logits and of each cache leaf, and of teacher-forced
# decode logits after a 500-token prompt against forward's; (b) bf16, each
# of the 32 time mixes on the plain run's input: the relative L2 error of
# each batch row of its output and of its final state. (c), the bf16 whole
# path, is printed beside a baseline and not gated.
RWKV_F32_REL_L2 = 5e-3
RWKV_LAYER_REL_L2 = 1e-3
RWKV_RAGGED = 500     # a prompt length that is not a whole 64-step chunk

# cases whose label starts so take extreme decays (rwkv_inputs)
RWKV_EXTREME = "extreme decays"
# B * H above the card's SMs: the bf16 body hands chains from block to block
RWKV_CUT = "chains cut between blocks"
RWKV_FAULTS = ("bonus u left out", "w applied after the kv add",
               "output read after the update", "final state not written",
               "state zero-padded to a whole chunk")


def plain_rwkv(r, k, v, w, u, fault: str):
    """The plain scan written out again with one planted ``fault`` (of
    RWKV_FAULTS): (y, final state), float32. Only the planted faults use
    it. The zero-padded state is what a scan padded with w = 0 steps to a
    whole 64-step chunk ends with."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    if fault == "bonus u left out":
        u = torch.zeros_like(u)
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N), device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        before = S
        if fault == "w applied after the kv add":
            S = w[:, t, :, :, None] * (S + kv)
        else:
            S = w[:, t, :, :, None] * S + kv
        read = S if fault == "output read after the update" else before
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               read + u[None, :, :, None] * kv))
    if fault == "final state not written" \
            or (fault == "state zero-padded to a whole chunk" and T % 64):
        S = torch.zeros_like(S)
    return torch.stack(ys, dim=1), S


def rwkv_faults(T: int):
    """The faults that change the scan's result at T steps: the padded
    chunk only where T is not a multiple of 64."""
    return [f for f in RWKV_FAULTS
            if T % 64 or f != "state zero-padded to a whole chunk"]


def rwkv_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, T, H, dtype, layout): "model" hands the inputs over as the
    # time mix does; "strided" reads every input through other strides
    return [("rwkv6-3b prefill", 4, 512, 40, bf, "model"),
            ("rwkv6-3b prefill", 4, 512, 40, f32, "model"),
            ("rwkv6-3b prefill", 4, 512, 40, bf, "strided"),
            ("one step", 2, 1, 8, bf, "model"),
            ("one step", 2, 1, 8, f32, "strided"),
            ("one chunk less a step", 2, 63, 8, bf, "strided"),
            ("one chunk less a step", 2, 63, 8, f32, "model"),
            ("one chunk", 2, 64, 8, f32, "model"),
            ("one chunk", 2, 64, 8, bf, "strided"),
            ("one chunk and a step", 2, 65, 8, bf, "model"),
            ("one chunk and a step", 2, 65, 8, f32, "strided"),
            ("a ragged tail", 3, 100, 8, bf, "model"),
            ("a ragged tail", 3, 100, 8, f32, "strided"),
            ("smoke width", 2, 130, 2, f32, "model"),
            ("smoke width", 2, 130, 2, bf, "strided"),
            (RWKV_EXTREME, 2, 130, 8, bf, "model"),
            (f"{RWKV_EXTREME} at the rwkv6-3b prefill", 4, 512, 40, bf,
             "model"),
            # more (b, h) than SMs, chunks not a multiple of the blocks:
            # the bf16 body cuts chains between blocks
            (RWKV_CUT, 3, 200, 50, bf, "model"),
            (RWKV_CUT, 3, 200, 50, bf, "strided")]


def rwkv_case_inputs(gen, case, device):
    """The inputs of one of rwkv_cases()."""
    label, B, T, H, dtype, layout = case
    return rwkv_inputs(gen, B, T, H, dtype, layout, device,
                       extreme=label.startswith(RWKV_EXTREME))


def rwkv_inputs(gen, B, T, H, dtype, layout, device, N=64, extreme=False):
    """(r, k, v, w, u) as the time mix makes them: r, k and v of unit
    scale in ``dtype``; w = exp(-exp(-0.5 + z)) and u of scale H^-1/2 in
    float32. "model": each a contiguous (B, T, H, N) tensor, as the time
    mix's projections give them. "strided": r, k and v slices of one (B, T,
    3, H, 2N) tensor (k every other element), w a transposed (B, H, T, N)
    tensor and u a transposed (N, H) one. ``extreme``: w = exp(-exp(3 z -
    3)), from 1 to values that underflow to 0, and exactly 0 at every 7th
    channel (0, 7, 14, ...) and exactly 1 at channels 1, 10, 19, ...:
    decays whose running products underflow or never decay."""
    if layout == "model":
        r, k, v = (torch.randn(B, T, H, N, generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        z = torch.randn(B, T, H, N, generator=gen, device=device)
        u = torch.randn(H, N, generator=gen, device=device)
    else:
        rkv = torch.randn(B, T, 3, H, 2 * N, generator=gen,
                          device=device).to(dtype)
        r, k, v = rkv[:, :, 0, :, :N], rkv[:, :, 1, :, ::2], \
            rkv[:, :, 2, :, N:]
        z = torch.randn(B, H, T, N, generator=gen,
                        device=device).transpose(1, 2)
        u = torch.randn(N, H, generator=gen, device=device).t()
    if not extreme:
        return r, k, v, torch.exp(-torch.exp(z - 0.5)), u * H ** -0.5
    w = torch.exp(-torch.exp(3 * z - 3))
    w[..., ::7] = 0.0
    w[..., 1::9] = 1.0
    return r, k, v, w, u * H ** -0.5


def rwkv_repeat(scan, ins):
    """``scan(*ins)`` twice: (the first run's (y, state), whether the
    second run gave the same bits)."""
    y, S = scan(*ins)
    y2, S2 = scan(*ins)
    if y.is_cuda:
        torch.cuda.synchronize()
    return (y, S), torch.equal(y, y2) and torch.equal(S, S2)


def check_rwkv(device):
    """B5 against the plain scan in every case, y and the final state; the
    same limits must reject each planted fault that changes the result,
    and a second run on the same inputs must give the same bits. Returns
    the max abs error at the bf16 rwkv6-3b prefill case."""
    gen = torch.Generator(device=device).manual_seed(5)
    err = 0.0
    for case in rwkv_cases():
        label, B, T, H, dt_, layout = case
        ins = rwkv_case_inputs(gen, case, device)
        (y, S), bitwise = rwkv_repeat(RO.rwkv6_scan, ins)
        y_ref, S_ref = RR.rwkv6_scan_ref(*ins)
        name = str(dt_).replace("torch.", "")
        shape = f"B={B} T={T} H={H} N=64 {name} {layout}"
        ry, rs = ssd_agreement(y, y_ref), ssd_agreement(S, S_ref)
        print(f"rwkv6_scan {label} {shape}: y max|d|={ry[1]:.3g} row rel "
              f"L2={ry[2]:.3g} elem={ry[3]:.3g}; state max|d|={rs[1]:.3g} "
              f"row rel L2={rs[2]:.3g} elem={rs[3]:.3g} "
              f"{'ok' if ry[0] and rs[0] else 'MISMATCH'}; second run "
              f"{'bitwise equal' if bitwise else 'DIFFERS'}")
        check(ry[0] and rs[0], f"rwkv6_scan disagrees with its plain "
                               f"version ({label}, {shape})")
        check(bitwise, f"rwkv6_scan does not repeat bit for bit ({label}, "
                       f"{shape})")
        for fault in rwkv_faults(T):
            fy, fs = plain_rwkv(*ins, fault)
            fy, fs = ssd_agreement(fy, y_ref), ssd_agreement(fs, S_ref)
            caught = not (fy[0] and fs[0])
            print(f"  planted fault '{fault}': row rel L2 y/state = "
                  f"{fy[2]:.3g}/{fs[2]:.3g}, elem {fy[3]:.3g}/{fs[3]:.3g} "
                  f"{'rejected' if caught else 'NOT REJECTED'}")
            check(caught, f"the rwkv6_scan limits pass a planted fault "
                          f"({fault}, {label}, {shape})")
        if label == "rwkv6-3b prefill" and dt_ == torch.bfloat16 \
                and layout == "model":
            err = max(ry[1], rs[1])
    return err


def check_rwkv_grad(device):
    """RWKV6Scan (B5 forward, autograd of the plain scan backward) against
    autograd of the plain scan: all five inputs' gradients through y and
    the final state, at the smoke width, r, k and v in float32 and in
    bf16."""
    gen = torch.Generator(device=device).manual_seed(6)
    for dt_ in (torch.float32, torch.bfloat16):
        ins = rwkv_inputs(gen, 2, 130, 2, dt_, "strided", device)
        gy = torch.randn(2, 130, 2, 64, generator=gen, device=device)
        gS = torch.randn(2, 2, 64, 64, generator=gen, device=device)
        grads = {}
        for route, fn in (("kernel", RO.rwkv6_scan),
                          ("plain", RR.rwkv6_scan_ref)):
            leaves = [t.detach().requires_grad_() for t in ins]
            zero_counts()
            y, S = fn(*leaves)
            ((y * gy).sum() + (S * gS).sum()).backward()
            torch.cuda.synchronize()
            grads[route] = ([t.grad for t in leaves], read_counts())
        (gk, nk), (gp, _) = grads["kernel"], grads["plain"]
        rel = max(rel_l2(a, b) for a, b in zip(gk, gp))
        name = str(dt_).replace("torch.", "")
        print(f"rwkv6_scan gradient (RWKV6Scan vs autograd of the plain "
              f"scan, B=2 T=130 H=2 N=64 {name} r k v, strided): worst "
              f"input's rel L2 {rel:.3g} (limit {SSD_REL_L2}); launches "
              f"{nk}")
        check(nk == dict({n: 0 for n in KERNELS + PLAIN}, rwkv6_scan=1,
                         rwkv6_scan_ref=1),
              f"RWKV6Scan did not run B5 forward and the plain scan "
              f"backward: {nk}")
        check(rel <= SSD_REL_L2, "RWKV6Scan's gradient disagrees with the "
                                  "plain")


def check_rwkv_refusals(device):
    """On the card the B5 wrapper launches its kernel or raises: what the
    kernel does not take is refused, and nothing falls back to the plain
    scan."""
    before = read_counts()

    def ins(N=64, dtype=torch.float32):
        t = torch.zeros(1, 8, 2, N, device=device)
        return t.to(dtype), t.to(dtype), t.to(dtype), t + 0.5, t[0, 0]

    for what, call, exc in (
            ("rwkv6 scan N = 32", lambda: RO.rwkv6_scan(*ins(32)),
             ValueError),
            ("rwkv6 scan w on the CPU", lambda: RO.rwkv6_scan(
                *ins()[:3], ins()[3].cpu(), ins()[4]), ValueError),
            ("rwkv6 scan k float32, r and v bfloat16", lambda: RO.rwkv6_scan(
                ins(dtype=torch.bfloat16)[0], ins()[1],
                *ins(dtype=torch.bfloat16)[2:]), TypeError),
            ("rwkv6 scan w bfloat16", lambda: RO.rwkv6_scan(
                *ins()[:3], ins()[3].bfloat16(), ins()[4]), TypeError),
            ("rwkv6 scan float16", lambda: RO.rwkv6_scan(
                *ins(dtype=torch.float16)), TypeError)):
        try:
            call()
        except exc as e:
            print(f"refused on the card: {what}: {e}")
        else:
            die(f"the rwkv6_scan wrapper took {what} on the card")
    check(read_counts() == before, "a refused call launched something")


def small_rwkv_matches_cpu(device) -> None:
    """rwkv6-3b's smoke width in float32: greedy tokens on the card (B5)
    equal those on the CPU (the plain scan)."""
    cfg = rwkv6_3b.smoke_config(dtype=torch.float32)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    prompts = np.random.RandomState(1).randint(1, cfg.vocab, (3, 16))
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", build_model(cfg, device))):
        eng = ServeEngine(model, params, max_len=32, device=dev)
        zero_counts()
        out[dev] = eng.generate(prompts, 12)
    n = read_counts()
    check(np.array_equal(out["cuda"], out["cpu"]),
          f"{cfg.name} smoke model: card and CPU tokens differ")
    check(n == dict({k: 0 for k in KERNELS + PLAIN},
                    rwkv6_scan=cfg.n_layers),
          f"{cfg.name} smoke model on the card: launches {n}")
    print(f"{cfg.name} smoke model f32: card tokens equal CPU tokens; card "
          f"launches {n}")


# ---------------------------------------------------------------------------
# rwkv6-3b serving at full width
# ---------------------------------------------------------------------------


@contextmanager
def swapped(name: str, fn):
    """``BL.<name>`` (the blocks' scan or time mix) replaced by ``fn``."""
    saved = getattr(BL, name)
    setattr(BL, name, fn)
    try:
        yield
    finally:
        setattr(BL, name, saved)


def fault_route(fault: str):
    return lambda *a: plain_rwkv(*a, fault)


def recorder(store: list):
    """A time mix that appends its (normed input, params) to ``store``."""
    mix = BL.rwkv6_time_mix

    def record(x, p, cfg, state=None):
        store.append((x, p))
        return mix(x, p, cfg, state=state)
    return record


def rwkv6_f32_path(model, params, prompts, feed) -> dict:
    """(a) The whole path in float32 at full width: the kernel prefill's
    logits and every cache leaf against the plain prefill, and
    teacher-forced decode after a 500-token prompt against forward. Each
    planted fault of the state must be rejected by one of the two."""
    L = model.cfg.n_layers
    kern_in, plain_in = [], []
    zero_counts()
    with swapped("rwkv6_time_mix", recorder(kern_in)):
        kern = model.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    n = read_counts()
    check(n == dict({k: 0 for k in KERNELS + PLAIN}, rwkv6_scan=L),
          f"float32 prefill launches {n}")
    with swapped("rwkv6_scan", RR.rwkv6_scan_ref), \
            swapped("rwkv6_time_mix", recorder(plain_in)):
        plain = model.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    got = prefill_reading(kern, plain)
    drift = [rel_l2(a, b) for (a, _), (b, _) in zip(kern_in, plain_in)]
    del kern, kern_in, plain_in
    ragged = prompts[:, :RWKV_RAGGED]
    dvf = decode_vs_forward(model, params, ragged, feed)
    worst = max(max(got.values()), dvf)
    print(f"rwkv6 (a) float32 whole path, kernel vs plain prefill: "
          + ", ".join(f"{k} {v:.3g}" for k, v in got.items())
          + f"; decode after a {RWKV_RAGGED}-token prompt vs forward "
          f"{dvf:.3g}; worst {worst:.3g} (limit {RWKV_F32_REL_L2}); drift of "
          f"each time mix's input: " + " ".join(f"{d:.2g}" for d in drift))
    check(worst <= RWKV_F32_REL_L2, "float32 rwkv6 kernel path disagrees")
    faults = {}
    for fault in ("final state not written",
                  "state zero-padded to a whole chunk"):
        with swapped("rwkv6_scan", fault_route(fault)):
            pre = max(prefill_reading(
                model.prefill(params, prompts, max_len=SERVE_MAX_LEN),
                plain).values())
            dec = decode_vs_forward(model, params, ragged, feed)
        faults[fault] = {"prefill": pre, "decode_vs_forward": dec}
        print(f"  planted fault '{fault}': prefill worst {pre:.3g}, decode "
              f"after {RWKV_RAGGED} vs forward {dec:.3g}; rejected: "
              f"{max(pre, dec) > RWKV_F32_REL_L2}")
        check(max(pre, dec) > RWKV_F32_REL_L2,
              f"the float32 rwkv6 limit passes a planted fault ({fault})")
    return {"prefill": got, "decode_vs_forward": dvf, "input_drift": drift,
            "faults": faults}


def rwkv6_bf16_layers(engine, prompts) -> dict:
    """(b) and (c) in bf16. (b): each of the 32 time mixes on the plain
    run's input, kernel vs plain, to one limit that every planted scan
    fault that can show at T = 512 must pass at every block. (c): the whole
    prefill's logits, kernel vs plain, with the drift of each time mix's
    input, not gated; beside it the plain path against itself with each
    scan output multiplied by (1 + eps z), z a fixed-seed standard normal
    and eps the worst reading of (b)."""
    cfg = engine.model.cfg
    plain_in = []
    with swapped("rwkv6_scan", RR.rwkv6_scan_ref), \
            swapped("rwkv6_time_mix", recorder(plain_in)):
        lp, _ = engine._prefill(prompts)

    def block(x, p, route):
        with swapped("rwkv6_scan", route):
            out, st = BL.rwkv6_time_mix(x, p, cfg)
        return out, st["wkv"]

    def reading(got, ref):
        return max(row_rel_l2(got[0], ref[0]), row_rel_l2(got[1], ref[1]))

    per_layer = []
    faults = {f: [] for f in rwkv_faults(prompts.shape[1])}
    for x, p in plain_in:
        ref = block(x, p, RR.rwkv6_scan_ref)
        per_layer.append(reading(block(x, p, RO.rwkv6_scan), ref))
        for fault, rs in faults.items():
            rs.append(reading(block(x, p, fault_route(fault)), ref))
    worst = max(per_layer)
    print(f"rwkv6 (b) bf16 block by block, kernel vs plain (time mix output "
          f"and final state, worst batch row): worst {worst:.3g} at block "
          f"{int(np.argmax(per_layer))} (limit {RWKV_LAYER_REL_L2}); "
          + " ".join(f"{r:.2g}" for r in per_layer))
    check(len(per_layer) == cfg.n_layers, f"{len(per_layer)} blocks ran")
    check(worst <= RWKV_LAYER_REL_L2, "a bf16 time mix disagrees")
    for fault, rs in faults.items():
        print(f"  planted fault '{fault}': weakest block {min(rs):.3g}, "
              f"strongest {max(rs):.3g}; rejected at every block: "
              f"{min(rs) > RWKV_LAYER_REL_L2}")
        check(min(rs) > RWKV_LAYER_REL_L2, f"the bf16 block limit passes a "
                                           f"planted fault ({fault})")

    kern_in, pert_in = [], []
    with swapped("rwkv6_time_mix", recorder(kern_in)):
        lk, _ = engine._prefill(prompts)
    gen = torch.Generator(device=lp.device).manual_seed(7)

    def perturbed(*a):
        y, S = RR.rwkv6_scan_ref(*a)
        z = torch.randn(y.shape, generator=gen, device=y.device)
        return y * (1 + worst * z), S

    with swapped("rwkv6_scan", perturbed), \
            swapped("rwkv6_time_mix", recorder(pert_in)):
        lq, _ = engine._prefill(prompts)
    whole, base = rel_l2(lk, lp), rel_l2(lq, lp)
    drift = [rel_l2(a, b) for (a, _), (b, _) in zip(kern_in, plain_in)]
    base_drift = [rel_l2(a, b) for (a, _), (b, _) in zip(pert_in, plain_in)]
    print(f"rwkv6 (c) bf16 whole path, prefill logits rel L2 against the "
          f"plain path (not gated): kernel {whole:.3g}; baseline, the plain "
          f"path with each scan output times (1 + {worst:.3g} z), "
          f"{base:.3g}")
    print("  drift of each time mix's input, kernel / baseline: "
          + " ".join(f"{a:.2g}/{b:.2g}" for a, b in zip(drift, base_drift)))
    return {"layer_worst_rel_l2": worst,
            "layer_rel_l2": per_layer,
            "faults_weakest_block": {f: min(rs) for f, rs in faults.items()},
            "whole_path_logits_rel_l2": whole,
            "baseline_eps": worst, "baseline_logits_rel_l2": base,
            "input_drift": drift, "baseline_input_drift": base_drift}


def rwkv6(device, card):
    """rwkv6-3b at full width with random weights: (a) the float32 whole
    path, then the bf16 ServeEngine: generate, the launches of a prefill
    and of a decode step, (b) and (c), and the step times."""
    cfg = rwkv6_3b.config()
    L = cfg.n_layers
    rng = np.random.RandomState(4)
    prompts = rng.randint(1, cfg.vocab, size=(4, 512)).astype(np.int32)
    feed = torch.as_tensor(rng.randint(1, cfg.vocab, size=(4, 4)),
                           device=device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model32 = build_model(rwkv6_3b.config(dtype=torch.float32),
                          device=device)
    params = model32.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    print(f"setup: rwkv6-3b ({cfg.param_count() / 1e9:.3f} B params) "
          f"initialised in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        f32 = rwkv6_f32_path(model32, params, prompts, feed)
    model = build_model(cfg, device=device)
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params, model32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, N_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    n_gen = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict({k: 0 for k in KERNELS + PLAIN}, rwkv6_scan=L)
    print(f"rwkv6 generate launches: {n_gen}")
    check(n_gen == want, f"rwkv6 generate: launches {n_gen}, want {want}")
    check(toks.shape == (4, 512 + N_NEW)
          and np.array_equal(toks[:, :512], prompts)
          and ((toks[:, 512:] >= 0) & (toks[:, 512:] < cfg.vocab)).all(),
          f"rwkv6 generate tokens {toks.shape}")
    zero_counts()
    logits, cache = engine._prefill(prompts)
    n_pre = read_counts()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    zero_counts()
    logits, cache = engine._decode(cache, tok)
    n_dec = read_counts()
    print(f"rwkv6 prefill launches {n_pre}; decode step launches {n_dec}")
    check(n_pre == want, f"rwkv6 prefill: launches {n_pre}")
    check(n_dec == dict(want, rwkv6_scan=0),
          f"rwkv6 decode step: launches {n_dec}")
    check(bool(torch.isfinite(logits).all()), "non-finite rwkv6 logits")

    with torch.no_grad():
        bf16 = rwkv6_bf16_layers(engine, prompts)

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
    return {"generate": n_gen}, {"rwkv6": {
        "model": "rwkv6-3b (32 blocks, d=2560, 40 heads of 64, d_ff=8960, "
                 "vocab 65536, random bf16 weights)",
        "card": card,
        "prefill_ms": min(prefill_ms), "prefill_ms_runs": prefill_ms,
        "prefill_shape": "B=4 S=512",
        "decode_ms_per_step": decode_ms, "decode_batch": 4,
        "generate_s": t_gen, "generate_tokens_per_s": 4 * N_NEW / t_gen,
        "decode_tokens_per_s": 4 / (decode_ms / 1e3),
        "peak_memory_gb": peak_gb, "peak_memory_of": "generate",
        "setup_peak_memory_gb": setup_peak_gb,
        "launches": {"generate": n_gen, "prefill": n_pre,
                     "decode_step": n_dec},
        "float32_path": f32, "bf16": bf16, "profile": profile}}


def matmul_shapes(prof, n: int):
    """The matmul kernels' device ms per step by (kernel, launching
    operator, its input shapes and dtypes), the largest 8."""
    per = {}
    for e in prof.events():
        for kern in e.kernels:
            low = kern.name.lower()
            if "nvjet" in low or "gemm" in low or "cutlass" in low:
                key = (kern.name[:70], e.name, str(e.input_shapes),
                       str(getattr(e, "input_dtypes", "")))
                per[key] = per.get(key, 0.0) + kern.duration / 1e3 / n
    return [list(k) + [t] for k, t in
            sorted(per.items(), key=lambda kv: -kv[1])[:8]]


# names of B3's device kernels: the bf16 body's one, the float32 body's two
B3_KERNELS = ("decode_kernel", "decode_partial", "decode_combine")


def device_window(fn, wall_ms: float, n: int = 1, shapes: bool = False):
    """Device time by kernel over ``fn()`` (``n`` steps), from
    torch.profiler; the idle share is taken against the unprofiled wall
    time of a step, and B3's device kernels are counted a step. None where
    the profiler saw no device time. With ``shapes``, also the matmuls'
    operand shapes (:func:`matmul_shapes`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        fn()
        torch.cuda.synchronize()
    per, b3 = {}, 0
    for e in prof.key_averages():   # device events: kernels, copies
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.key] = per.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3 / n
            if any(w in e.key.lower() for w in B3_KERNELS):
                b3 += e.count
    busy = sum(per.values())
    if busy == 0:
        return None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    groups = {"attention kernels": 0.0, "scan kernel": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, t in per.items():
        low = name.lower()
        if any(w in low for w in ("flash_fwd", "dq_kernel", "dkv_kernel")
               + B3_KERNELS):
            groups["attention kernels"] += t
        elif "ssd_kernel" in low or "rwkv6_kernel" in low:
            groups["scan kernel"] += t
        elif "nvjet" in low or "gemm" in low or "cutlass" in low:
            groups["matmul"] += t
        else:
            groups["other"] += t
    out = {"device_busy_ms": busy, "wall_ms": wall_ms,
           "idle_share": max(0.0, 1 - busy / wall_ms),
           "b3_kernels_per_step": b3 / n,
           "groups_ms": groups,
           "top_kernels_ms": [[k[:90], t] for k, t in top]}
    if shapes:
        out["matmul_shapes_ms"] = matmul_shapes(prof, n)
    return out


def ptxas_report(log: str, marker: str) -> tuple[list[str], list[str]]:
    """From nvcc's output ``log``: one line of ptxas's registers, stack and
    spills for each kernel whose name holds ``marker``, plus each warning;
    and the faults among them: an instance with a stack frame or a spill,
    an instance whose properties are missing, a "C75xx" warning (wgmma
    serialised), or no instance at all."""
    lines = log.splitlines()
    report, faults = [], []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and marker in line:
            name = line.split("'")[1]
            props = " | ".join(x.split(":", 1)[-1].strip()
                               for x in lines[i + 1:i + 4]
                               if "Function properties" not in x)
            report.append(f"{name}: {props}")
            sizes = re.findall(r"(\d+) bytes (stack frame|spill stores|"
                               r"spill loads)", props)
            if len(sizes) != 3 or any(int(n) for n, _ in sizes):
                faults.append(f"{name}: {props}")
        elif "C75" in line or ("arning" in line and "#177" not in line):
            report.append(line.strip())
            if re.search(r"C75\d\d", line):
                faults.append(line.strip())
    if not any("Compiling entry function" in x and marker in x
               for x in lines):
        faults.append(f"no ptxas report of a '{marker}' kernel")
    return report, faults


def print_ptxas(lib: str, marker: str) -> None:
    """Print ptxas's report of ``lib``'s ``marker`` kernels from its build,
    and fail if any of them has a stack frame, spills or serialises
    wgmma."""
    report, faults = ptxas_report(_build.log(lib), marker)
    for line in report:
        print(f"ptxas {lib} {line}")
    check(not faults, f"ptxas {lib}: " + "; ".join(faults))


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
    print_ptxas("flash_fwd", "hopper")
    print_ptxas("flash_bwd", "hopper")
    print_ptxas("ssd_scan", "hopper")
    print_ptxas("rwkv6_scan", "hopper")
    print_ptxas("decode", "hopper")

    errs = check_kernels(device)
    errs.update(check_bwd(device))
    errs["ssd_scan"] = check_ssd(device)
    check_ssd_grad(device)
    check_refusals(device)
    small_model_matches_cpu(device)
    small_train_matches_cpu(device)
    launches, serving = serve(device, card)
    torch.cuda.empty_cache()
    per_step, training = train(device, card)
    launches[f"train ({TRAIN_STEPS} steps)"] = {
        n: sum(c[n] for c in per_step) for n in per_step[0]}
    torch.cuda.empty_cache()
    launches[f"ddp ({DDP_STEPS} steps, 2 ranks)"], ddp_line = ddp(device,
                                                                  card)
    torch.cuda.empty_cache()
    z_launches, zamba = zamba2(device, card)
    launches["zamba2 generate"] = z_launches["generate"]
    torch.cuda.empty_cache()
    errs["rwkv6_scan"] = check_rwkv(device)
    check_rwkv_grad(device)
    check_rwkv_refusals(device)
    small_rwkv_matches_cpu(device)
    check(all(n["rwkv6_scan"] == 0 and n["rwkv6_scan_ref"] == 0
              for n in launches.values()),
          f"B5 or its plain version ran on an earlier path: {launches}")
    r_launches, rwkv = rwkv6(device, card)
    launches["rwkv6 generate"] = r_launches["generate"]
    torch.cuda.empty_cache()
    kernels = time_kernels(device, errs, launches)
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        whole = f", whole backward {k['bwd_ms']:.4f}" if "bwd_ms" in k else ""
        print(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
              f"library {lib}, bound {k['bound_ms']:.4f} by "
              f"{k['bound_by']}{whole}) on {card}")
    print(json.dumps(serving))
    print(json.dumps(training))
    print(json.dumps(zamba))
    print(json.dumps(rwkv))
    print(json.dumps(ddp_line))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
