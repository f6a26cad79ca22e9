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
  accounting) and its flat, bucketed and hooked runs, bit for bit;
* the fault campaigns through ``repro_torch.scenarios.run_scenario``:
  ``rail_kill_striped`` on ``ddp_hooked`` (2 steps) and
  ``sender_nic_down`` on ``ddp`` under the adaptive fault policy, each
  on the card and on the CPU with equal fingerprints, no violated
  invariant and exactly the B1, B2a and B2b launches their steps give
  (the hooked cell also reads the reference's fault cell: completed, 2
  fallbacks, 0 payload mismatches, overlap 0.880795); then
  ``sender_nic_down`` on ``ddp`` with gpt2-124m at full width (4 steps,
  25 MiB buckets of 1 MiB chunks): no violated invariant, >= 1 fallback,
  48 B1, 24 B2a and 24 B2b each step, and the fault log's virtual times
  printed beside each step's all-reduce;
* serving the moe family: the float32 llama4-maverick and kimi-k2 smoke
  models on the card against the CPU, then llama4-maverick at full width
  with 2 of its 48 layers and bf16 params (68.8 GB, after a check that
  the card has that much free and 4 GB more) through
  ``ServeEngine.generate`` (uniform and ragged) and ``RequestScheduler``
  over ``TPServeEngine(world=None)``: exactly 2 flash-attention launches
  a prefill or admission, 2 decode-attention launches a decode step, 0
  plain; each layer's attention sublayer, kernels against plain versions
  on the same recorded inputs, within 2e-2 (a planted fault in one
  layer's plain attention must exceed it); the whole path's bf16 logits
  and the share of tokens routed to another expert printed;
* the ``serving`` campaign: ``sender_nic_down``, ``rail_kill_striped``
  and ``double_rail_outage`` (tensor-parallel serving of the smoke MoE
  model over a 2-rank world) on the card and on the CPU, with equal
  fingerprints, the maskable cells completed with no token or payload
  mismatch, the unmaskable one aborted loudly, and exactly one
  flash-attention launch a layer and admission and one decode-attention
  launch a layer and decode step; then the full-width llama4-maverick
  engine over a 2-rank, 2-channel world, healthy and with host0's first
  NIC killed mid-decode, giving the tokens of its ``world=None`` run
  with no reconstruction mismatch and a fallback under the kill;
* serving kimi-k2-1t-a32b (head dim 112, 64 query heads over 8 K/V heads,
  384 experts, top-8) once llama4-maverick's engine is freed: its float32
  smoke model at head dim 112 for 3 train steps on the card against the
  CPU, then KIMI_LAYERS of its 61 layers at full width with bf16 params
  (72.82 GB at 2 layers) through ``ServeEngine.generate`` (uniform and
  ragged) and ``RequestScheduler``: exactly KIMI_LAYERS flash-attention
  launches a prefill or admission and KIMI_LAYERS decode-attention
  launches a decode step, 0 plain; each layer's attention sublayer
  within 2e-2 of the plain versions (a one-layer planted fault must
  exceed it), the set-up's peak held to its meta trace, the whole path's
  logits and the share of expert choices that differ printed;
* the families phase: the float32 musicgen-medium, starcoder2-3b and
  deepseek-67b smoke models (ragged prompts) and the llama-3.2-vision
  smoke model (gates nonzero, a greedy loop over random image embeddings
  through ``make_prefill_step`` and ``make_decode_step``; 3 train steps)
  on the card against the CPU, then llama-3.2-vision at full width with
  10 of its 100 layers and bf16 params (21.9 GB): a prefill step over
  random images (4, 1600, 8192) of exactly 8 causal and 2 non-causal
  flash-attention launches, decode steps of exactly 10 decode-attention
  launches (the cross blocks' one query row over the 1600 image rows
  among them) and no flash attention, ``generate`` with the reference's
  zero images; each layer's attention sublayer, kernels against plain
  versions, within 2e-2 (a planted fault dropping the last image key of
  one cross block must exceed it), the whole path printed; then
  musicgen-medium (48 layers) and starcoder2-3b (30 layers) whole through
  ``generate`` (uniform and ragged; musicgen also ``RequestScheduler``
  over ``TPServeEngine(world=None)``) with exactly L flash-attention
  launches a prefill and L decode-attention launches a decode step, the
  serving logits kernel path against plain path within 2e-2;
* the launch phase (``repro_torch.launch``): the hook dry-run's
  readiness reports of kimi-k2-1t-a32b and starcoder2-15b at full depth
  (62059 buckets / 63 segments, 1312 / 42); each step's peak memory on
  the card above what it started with, against the meta-device dry-run's
  temp bytes for the same step on a (1, 1) mesh, within 10 % or 64 MiB:
  gpt2-124m's train step (8 x 1024) under remat none, full and dots, with
  exactly 12 / 24 / 24 flash-attention launches and 12 of each backward
  kernel a step, yi-6b's prefill (4 x 512) and decode step (4 rows, a
  544-row cache), zamba2-1.2b's and rwkv6-3b's prefill (4 x 512), with
  exact launches; "dots" giving "full"'s loss and gradients bit for bit,
  and the peaks ordered none > dots > full; gpt2-124m's params
  distributed by their ``param_specs`` over a one-rank NCCL group, each
  local shard equal to its param. The moe and families phases start
  only with the dry-run's bytes a device of their prefill step free;
* the examples phase: the port's own entry points
  (``repro_torch.examples``) through their ``main(argv)``, as a user runs
  them: ``train_ddp_shift --full --steps 6 --fail-at 3`` (gpt2-124m at
  full width, 2 ranks x 4 x 512 tokens, host1's first NIC killed after
  step 3) with >= 1 fallback, no restart and exactly 48 flash-attention
  launches and 24 of each backward kernel a step; the same with
  ``--baseline``, one restart and the run reaching step 6 (the crashed
  step's launches counted too); then ``serve_decode`` for each of the 11
  archs at its defaults (smoke scale, bf16), ``--tp`` for the dense,
  audio and moe ones, with exactly one B1 an attention layer a prefill,
  one B3 a layer a decode step, zamba2's B4 and rwkv6's B5 a block a
  prefill, 0 plain, and the TP line's sync rounds and peak live
  collectives equal to the same run's on the CPU; each run teacher-forced
  again with its own tokens, its bf16 logits on the kernels within
  LOGITS_REL_L2 of the plain path's, its greedy tokens the run's, and a
  planted fault for each kernel of its path past that limit. The
  examples' B1, B3 and B4 shapes are also kernel cases ("examples ...").

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
* a ``{"campaign": ...}`` line: each cell's fingerprint agreement,
  fallbacks, recoveries, overlap, decisions, launches and wall s, the
  full-width cell's fault and all-reduce times, and the phase's wall s;
* a ``{"moe": ...}`` line: llama4-maverick's prefill ms, decode ms per
  step, generate and scheduler tokens/s, device-busy ms and idle share,
  peak memory, each layer's attention error and the routing share that
  differs between the paths;
* a ``{"kimi": ...}`` line: the same readings as the moe line for
  kimi-k2-1t-a32b, the top-8 choices that differ among them, and the
  hd-112 smoke model's train-step losses on the card and the CPU;
* a ``{"serving_campaign": ...}`` line: each smoke cell's fingerprint
  agreement, fallbacks, mismatches, launches and wall s, and the
  full-width TP run's tokens per virtual second, healthy and under the
  fault, with its wall s;
* a ``{"families": ...}`` line: for llama-3.2-vision, musicgen-medium and
  starcoder2-3b the prefill ms, decode ms per step, tokens/s, device-busy
  ms and idle share, peak memory, launches and the kernel-vs-plain
  readings (llama-3.2-vision: each layer's attention error, the planted
  fault's, how far the images move the logits), and the phase's wall s;
* a ``{"launch": ...}`` line: the anchors, each memory cell's predicted,
  measured and ``MemoryLog``-on-the-card bytes, remat's bitwise
  equality, launches and peaks, the DTensor check, the phase's wall s;
* a ``{"examples": ...}`` line: each entry run's argv, wall s, tokens/s
  and launches; the training runs' fallbacks, restarts, recoveries,
  virtual gradient-sync ms a step and losses; each ``serve_decode`` run's
  TP statistics on the card and the CPU and its logits reading; the
  phase's wall s; then the
  whole script's wall s;
* a ``{"kernels": [...]}`` line: per kernel its launches on the main
  paths (in all, and on each path), its error against the plain version,
  its time, the plain version's and one PyTorch call's time at the same
  inputs, and the card's least time for the same work (``bound_ms``);
  flash attention's entry also lists all six of its main-path shapes
  (``shapes``: yi-6b prefill, zamba2 prefill, gpt2 train forward,
  llama4-maverick prefill, kimi-k2 prefill at hd 112, and the non-causal
  llama-3.2-vision cross prefill), and the backward kernels' entries the
  time of the whole backward call (``bwd_ms``: delta, B2a and B2b), which
  compares with SDPA's, and the same at kimi-k2's attention shape
  (``kimi``); decode attention's entry its six shapes (yi-6b serving,
  zamba2 decode, every row in one chunk, llama4-maverick serving,
  kimi-k2 serving at hd 112, llama-3.2-vision cross decode) and its time
  by the chunks a row holds (``ms_by_chunks``); at kimi-k2's shapes the
  SDPA backend that ran is named (``library_backend``);
* the card's name and power limit, as nvidia-smi gives them;
* last, ``{"ok": true, "device": {...}}``.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result. Any failed check exits non-zero. It imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.collectives import build_world  # noqa: E402
from repro_torch.configs import (deepseek_67b, gpt2_124m,  # noqa: E402
                                 kimi_k2_1t, llama32_vision_90b,
                                 llama4_maverick, musicgen_medium, rwkv6_3b,
                                 starcoder2_3b, yi_6b, zamba2_1p2b)
from repro_torch.examples import serve_decode as EX_SERVE  # noqa: E402
from repro_torch.examples import train_ddp_shift as EX_TRAIN  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as RO  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as RR  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as SR  # noqa: E402
from repro_torch import configs as CC  # noqa: E402
from repro_torch.launch import (make_decode_step,  # noqa: E402
                                make_prefill_step, make_train_step,
                                value_and_grad)
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import sharding as SHD  # noqa: E402
from repro_torch.launch.hook_dryrun import readiness_report  # noqa: E402
from repro_torch.launch.mesh import (device_mesh,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks as BL  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import (flatten, hybrid_layout,  # noqa: E402
                                   serving_params, unflatten, vlm_layout)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.scenarios import SCENARIOS, run_scenario  # noqa: E402
from repro_torch.scenarios import engine as SE  # noqa: E402
from repro_torch.serving import (RequestScheduler, ServeEngine,  # noqa: E402
                                 TPServeEngine)
from repro_torch.serving.engine import KV_CACHE_FAMILIES  # noqa: E402
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

# the fault campaigns through the port's run_scenario: (a) smoke-width
# cells (scenario, workload, keywords) on the card and on the CPU, with
# equal fingerprints; (b) one ddp cell with gpt2-124m at full width, the
# ddp phase's bucket and chunk sizes (16 KiB chunks would cost the host
# many seconds of fabric a step). HOOKED_FAULT_CELL is BENCH_core.json's
# ddp_hook_overlap.fault_cell, which the reference printed.
CAMPAIGN_SMOKE = (("rail_kill_striped", "ddp_hooked", {"steps": 2}),
                  ("sender_nic_down", "ddp",
                   {"policy": "adaptive", "steps": 6}))
CAMPAIGN_SMOKE_LAYERS = 2    # build_smoke_trainer's model
# Each smoke cell's card losses against its CPU losses, relative: the bf16
# model differs by the order of its sums (measured 1.4e-4 on an H100,
# PERF.md). The limit must reject planted faults of the plain attention in
# the ddp cell, whose 6 steps give a backward fault room to show (on the
# CPU 1.5e-3 with delta left out, 9.2e-3 with the causal edge off by one).
CAMPAIGN_LOSS_REL = 4e-4
CAMPAIGN_LOSS_FAULTS = ("backward: delta left out",
                        "forward: causal edge off by one")
HOOKED_FAULT_CELL = {"completed": True, "fallbacks": 2,
                     "payload_mismatches": 0, "overlap_fraction": 0.880795}
CAMPAIGN_FULL_SCENARIO = "sender_nic_down"
CAMPAIGN_FULL = dict(steps=4, bucket_bytes=25 << 20,
                     max_chunk_bytes=1 << 20)

SERVE_MAX_LEN = 544          # 512-token prompts + 32 new tokens (both models)
PROMPT_LENS = [128, 256, 384, 512]
N_NEW = 32
SCHED_SLOTS, SCHED_REQUESTS, SCHED_PREFILL = 4, 8, 256
# yi-6b admissions at a prompt's own length (``TPServeEngine.admit``) from
# the benchmark's document-QA traffic (prompts of 1024-3584): each ends
# inside a 128-row query block
ADMIT_LENS = (1025, 2303, 3583)

# llama4-maverick at full width on one card: MOE_LAYERS of its 48 layers
# with bf16 params, 34.4 B params or 68.8 GB (3 layers would be 101 GB).
# The phase starts only with the larger of the dry-run's set-up peak and
# its bytes a device of the B=4 x 512 prefill step free (``memory_check``),
# and the set-up's peak on the card is held to the traced one;
# MOE_HEADROOM_GB is the hand-set reckoning that check replaced (the
# params and 4 GB for the caches, the activations, the expert buffers,
# the float32 draw of one embedding-sized leaf at init), printed beside it.
MOE_LAYERS = 2
MOE_HEADROOM_GB = 4.0
# The moe path, kernel against plain: the whole-path bf16 logits are
# printed, not gated (a routing flip between the paths sends a token to
# another expert, and the path is then not comparable whole). Each layer's
# attention sublayer on the kernel path's recorded inputs (the prefill and
# 4 decode steps), kernels against plain versions: relative L2 within the
# serving limit, which a planted fault of the plain attention confined to
# one layer must exceed.
MOE_ATTN_REL_L2 = LOGITS_REL_L2
# kimi-k2-1t-a32b at full width on one card, once llama4-maverick's engine
# is freed: KIMI_LAYERS of its 61 layers with bf16 params, 36.4 B params or
# 72.82 GB (each layer 34.06 GB, 33.82 of it the 384 experts of 3 x 7168 x
# 2048; the embeddings 4.70). Its head dim is 112 (7168 / 64 heads), which B1,
# B2a, B2b and B3 take on 128-column tiles. It starts only with the
# dry-run's need free (``memory_check``: 74.64 GB at 2 layers, its B=4 x
# 512 prefill step; set-up 72.93), and is held to the same gates as
# llama4-maverick's: exact launches, each layer's attention within
# MOE_ATTN_REL_L2, the set-up's peak against its trace. Its routing is
# top-8 of 384; the share of expert choices that differ between the kernel
# and plain paths is printed, not gated, as for llama4.
KIMI_LAYERS = 2
# The serving campaign: (a) these cells of the smoke MoE model on the card
# and the CPU; (b) the moe phase's engine over a 2-rank, 2-channel world,
# TP_FULL_REQUESTS requests of TP_FULL_TOKENS tokens on as many slots,
# healthy and with TP_FULL_NIC killed half a step into decode (the perf
# suite's serving_tp pattern). The ring all-gather sends each rank's shard
# as one chunk, so a chunk must hold half a decode step's logits: 4 x
# 202048 bf16 logits are 1.6 MB, 808 KB a rank; 1 MiB chunks, as the ddp
# phase's.
SERVING_CELLS = ("sender_nic_down", "rail_kill_striped",
                 "double_rail_outage")
TP_FULL_REQUESTS, TP_FULL_TOKENS = 4, 8
TP_FULL_WORLD = dict(n_ranks=2, channels=2, probe_interval=5e-4,
                     max_chunk_bytes=1 << 20, strict_order=False)
TP_FULL_NIC = "host0/mlx5_0"


# The families phase. (a) llama-3.2-vision at full width: VLM_LAYERS of
# its 100 layers (2 groups of a cross block and 4 self blocks; the whole
# model is 181 GB in bf16), bf16 params, 21.9 GB; the phase starts only
# with the dry-run's need free, as the moe phase's (its set-up peak rules:
# the float32 draw of the largest stacked leaf, the self blocks' w_gate,
# 7.5 GB, which the step does not hold). VLM_HEADROOM_GB is the hand-set
# reckoning that check replaced, printed beside it. Each cross block's
# gate is set to VLM_GATE: the reference's zero gate would leave the
# image path no effect (ROADMAP C11). Its kernel path against its plain
# path: each layer's attention sublayer (self and cross) within
# MOE_ATTN_REL_L2, which a planted fault dropping the last image key of
# one cross block must exceed (dropping one of 1600 keys moves the output
# by ~1/sqrt(1600) = 0.025).
# (b) musicgen-medium (48 layers) and starcoder2-3b (30 layers) whole.
VLM_LAYERS = 10
VLM_IMAGE_TOKENS = 1600      # llama32_vision_90b.config().n_image_tokens
VLM_HEADROOM_GB = 12.0
VLM_GATE = 0.5


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
             ("MHA non-causal Sq<Sk", 1, 2, 2, 16, 64, 16, f32, False),
             # the campaign phase's trainers: the smoke model (bf16 in the
             # campaign cells, float32 in the ddp phase) and gpt2-124m
             # at full width, each 2 x 32 tokens a rank
             ("smoke trainer", 2, 4, 4, 32, 32, 32, bf, True),
             ("smoke trainer", 2, 4, 4, 32, 32, 32, f32, True),
             ("gpt2-124m campaign", 2, 12, 12, 32, 32, 64, bf, True),
             # the moe paths: llama4-maverick at full width, 5 query heads
             # a K/V head (a 4 x 512 prefill, an admission at 256), and
             # the serving campaign's smoke model (hd 16, an admission at
             # its 12-token prefill length)
             ("llama4 prefill", 4, 40, 8, 512, 512, 128, bf, True),
             ("llama4 admit", 1, 40, 8, SCHED_PREFILL, SCHED_PREFILL, 128,
              bf, True),
             ("moe smoke admit", 1, 8, 2, 12, 12, 16, bf, True),
             # the families phase: llama-3.2-vision's self and cross
             # prefill (512 queries over 1600 image keys, 12.5 key tiles:
             # the last one partial) and its smoke model's cross blocks,
             # musicgen-medium's MHA at hd 64, starcoder2-3b's 12 query
             # heads a K/V head at hd 128
             ("vlm self prefill", 4, 64, 8, 512, 512, 128, bf, True),
             ("vlm cross prefill", 4, 64, 8, 512, VLM_IMAGE_TOKENS, 128, bf,
              False),
             ("vlm smoke cross", 2, 8, 2, 12, 16, 16, bf, False),
             ("musicgen prefill", 4, 24, 24, 512, 512, 64, bf, True),
             ("starcoder2-3b prefill", 4, 24, 2, 512, 512, 128, bf, True),
             # kimi-k2 at full width: head dim 112 (the bf16 body's
             # 128-column tiles, TMA's zeros past 112), 8 query heads a
             # K/V head, a 4 x 512 prefill and an admission; a float32
             # ragged GQA case at hd 112
             ("kimi prefill", 4, 64, 8, 512, 512, 112, bf, True),
             ("kimi admit", 1, 64, 8, SCHED_PREFILL, SCHED_PREFILL, 112,
              bf, True),
             ("ragged GQA non-causal", 3, 16, 2, 77, 301, 112, f32, False),
             ("ragged GQA causal Sq>Sk", 2, 16, 2, 100, 70, 112, f32, True)]
    # the bf16 body's 128-row query blocks and 128- (64 at hd 112 and 128)
    # key tiles: lengths on either side of one and two tiles, at every
    # model head dim of the bf16 path
    for hd in (64, 112, 128):
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
    cases += [(f"yi-6b admission S={S}", 1, 32, 4, S, S, 128, bf, True)
              for S in ADMIT_LENS]
    # the examples phase: serve_decode's prefill of each arch's bf16 smoke
    # model (hd 16, zamba2's shared attention hd 32) and the vlm's cross
    # blocks over its image keys
    for (H, KV, hd), archs in example_heads().items():
        cases.append((f"examples prefill ({example_names(archs)})", EX_BATCH,
                      H, KV, EX_PROMPT, EX_PROMPT, hd, bf, True))
    vlm = CC.smoke_config("llama-3.2-vision-90b")
    cases.append(("examples vlm cross prefill", EX_BATCH, vlm.n_heads,
                  vlm.n_kv_heads, EX_PROMPT, vlm.n_image_tokens, vlm.hd, bf,
                  False))
    return [c if len(c) == 10 else (*c, "contiguous") for c in cases]


def decode_cases():
    bf, f32 = torch.bfloat16, torch.float32
    vlm = CC.smoke_config("llama-3.2-vision-90b")
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
            ("12 heads a K/V head", 2, 24, 2, 300, 64, bf, [300, 150]),
            # the moe paths: llama4-maverick's decode at full width (5 query
            # heads a K/V head in a block built for 8) and the serving
            # campaign's smoke decode (hd 16, a free slot's length past S)
            ("llama4 serving", 4, 40, 8, SERVE_MAX_LEN, 128, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("moe smoke decode", 2, 8, 2, 32, 16, bf, [12, 45]),
            # the families phase: llama-3.2-vision's cross decode (one
            # query row over all 1600 image rows, 25 chunks) and its self
            # decode, musicgen-medium's (G = 1, hd 64), starcoder2-3b's
            # (G = 12 at hd 128: groups of 8 and 4)
            ("vlm cross decode", 4, 64, 8, VLM_IMAGE_TOKENS, 128, bf,
             [VLM_IMAGE_TOKENS] * 4),
            ("vlm serving", 4, 64, 8, SERVE_MAX_LEN, 128, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("musicgen serving", 4, 24, 24, SERVE_MAX_LEN, 64, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("starcoder2-3b serving", 4, 24, 2, SERVE_MAX_LEN, 128, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            # kimi-k2's decode at full width (hd 112: 7 tiles of 16 over 4
            # warps; G = 8, one group a block): its serving lengths, every
            # row in one chunk, and float32; G = 1 at hd 112 (a row's 16
            # lanes, 14 of which load)
            ("kimi serving", 4, 64, 8, SERVE_MAX_LEN, 112, bf,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("kimi one chunk each", 4, 64, 8, SERVE_MAX_LEN, 112, bf,
             [1, 17, 63, 64]),
            ("kimi serving f32", 4, 64, 8, SERVE_MAX_LEN, 112, f32,
             [n + N_NEW // 2 for n in PROMPT_LENS]),
            ("MHA hd=112", 2, 8, 8, 300, 112, bf, [300, 77])] \
        + [(f"examples decode ({example_names(archs)})", EX_BATCH, H, KV,
            EX_MAX_LEN, hd, bf, EX_LENS)
           for (H, KV, hd), archs in example_heads().items()] \
        + [("examples vlm cross decode", EX_BATCH, vlm.n_heads,
            vlm.n_kv_heads, vlm.n_image_tokens, vlm.hd, bf,
            [vlm.n_image_tokens] * EX_BATCH)]


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
             ("gpt2-124m campaign", 2, 12, 12, 32, 32, 64, bf, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, bf, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, bf, False),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, f32, True),
             ("GQA ragged", 2, 8, 2, 77, 77, 128, f32, False),
             ("GQA causal Sq>Sk", 2, 6, 3, 100, 70, 32, f32, True),
             ("GQA causal Sq>Sk", 2, 8, 2, 100, 70, 16, bf, True),
             ("GQA causal Sq<Sk", 2, 4, 2, 40, 70, 64, bf, True),
             # kimi-k2's attention at hd 112 (the bf16 bodies' 128-column
             # tiles), both dtypes, and ragged causal
             ("kimi attention", 2, 64, 8, 1024, 1024, 112, bf, True),
             ("kimi attention", 2, 64, 8, 1024, 1024, 112, f32, True),
             ("GQA ragged causal", 2, 16, 2, 200, 200, 112, bf, True),
             ("GQA ragged causal Sq>Sk", 2, 16, 2, 257, 129, 112, bf, True)]
    # the bf16 body's 128-row work tiles (queries for B2a, keys for B2b),
    # B2a's K/V tiles (128 keys, 64 at hd 112 and 128) and B2b's 64-query
    # stages: lengths on either side of one and two tiles, at every model
    # head dim of the bf16 path
    for hd in (64, 112, 128):
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
            ("smoke width", 3, 130, 8, 32, 16, bf, "strided"),
            # the examples phase: zamba2's smoke prefill in serve_decode
            ("examples zamba2 prefill", EX_BATCH, EX_PROMPT, 8, 32, 16, bf,
             "model")]


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


# B1's main-path shapes: (path, B, H, KV, S, hd), all bf16 and causal (the
# llama4-maverick prefill: 5 query heads a K/V head; kimi-k2's: hd 112;
# yi-6b's admissions at their own lengths)
FLASH_TIMED = (("yi-6b prefill", 4, 32, 4, 512, 128),
               ("zamba2 prefill", 4, 32, 32, 512, 64),
               ("gpt2 train forward", TRAIN_B, 12, 12, TRAIN_S, 64),
               ("llama4 prefill", 4, 40, 8, 512, 128),
               ("kimi prefill", 4, 64, 8, 512, 112)) \
    + tuple((f"yi-6b admission S={S}", 1, 32, 4, S, 128) for S in ADMIT_LENS)
# and non-causal, (path, B, H, KV, Sq, Sk, hd): the vlm cross prefill, 512
# queries over 1600 image keys
FLASH_CROSS_TIMED = (("vlm cross prefill", 4, 64, 8, 512, VLM_IMAGE_TOKENS,
                      128),)
# the shapes whose SDPA backend is named beside its time: kimi-k2's, at
# hd 112
NAMED_BACKEND = ("kimi prefill", "kimi serving", "kimi attention")


def sdpa_backend(sdpa, inputs) -> dict:
    """Which of PyTorch's attention backends runs ``sdpa(*inputs)``:
    ``sdpa(*inputs, choice=torch._fused_sdp_choice)`` hands the same
    arguments to PyTorch's own pick among its backends (the backward runs
    the forward's backend's backward)."""
    from torch.nn.attention import SDPBackend
    names = {int(b): n.lower() for n, b in SDPBackend.__members__.items()}
    return {"library_backend":
            names[int(sdpa(*inputs, choice=torch._fused_sdp_choice))]}


def time_flash(device, gen):
    """B1, its plain version and SDPA timed at each of FLASH_TIMED and
    FLASH_CROSS_TIMED, with the card's bound; one dict a shape."""
    bf = torch.bfloat16
    out = []
    shapes = [(path, B, H, KV, S, S, hd, True)
              for path, B, H, KV, S, hd in FLASH_TIMED]
    shapes += [(*shape, False) for shape in FLASH_CROSS_TIMED]
    for path, B, H, KV, Sq, Sk, hd, causal in shapes:
        sets = [rand_like_cases(gen, [(B, Sq, H, hd), (B, Sk, KV, hd),
                                      (B, Sk, KV, hd)], bf, device)
                for _ in range(4)]
        ms = time_ms(lambda q, k, v: FO.flash_attention(q, k, v,
                                                        causal=causal), sets)
        plain = time_ms(lambda q, k, v: FR.flash_attention_ref(
            q, k, v, causal=causal), sets, iters=5)
        def sdpa(q, k, v, choice=F.scaled_dot_product_attention):
            return choice(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), is_causal=causal,
                          enable_gqa=True)
        lib = time_ms(sdpa, sets)
        named = sdpa_backend(sdpa, sets[0]) if path in NAMED_BACKEND else {}
        nbytes = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) \
            + 4 * B * H * Sq
        # QK^T and PV over the (q, k) pairs the mask keeps (causal: Sq = Sk)
        pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
        ops = 4 * B * H * hd * pairs
        b_ms, b_by = bound(nbytes, ops)
        out.append({"path": path, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                    "vs_library": ms / lib, **named,
                    "shape": f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                             f"bf16 {'causal' if causal else 'non-causal'}"})
    return out


# B3's main-path shapes: (path, B, H, KV, S, hd, lens), all bf16: a decode
# step of yi-6b's ragged generate (32 layers' caches), of zamba2's generate,
# every row on the one-chunk path, llama4-maverick's ragged generate (5
# query heads a K/V head), kimi-k2's (hd 112, 8 query heads a K/V head)
# and llama-3.2-vision's cross decode (every row over all 1600 image rows)
DECODE_TIMED = (("yi-6b serving", 4, 32, 4, SERVE_MAX_LEN, 128,
                 [n + N_NEW // 2 for n in PROMPT_LENS]),
                ("zamba2 decode", 4, 32, 32, SERVE_MAX_LEN, 64,
                 [512 + N_NEW // 2] * 4),
                ("one chunk", 4, 32, 4, SERVE_MAX_LEN, 128, [1, 17, 63, 64]),
                ("llama4 serving", 4, 40, 8, SERVE_MAX_LEN, 128,
                 [n + N_NEW // 2 for n in PROMPT_LENS]),
                ("kimi serving", 4, 64, 8, SERVE_MAX_LEN, 112,
                 [n + N_NEW // 2 for n in PROMPT_LENS]),
                ("vlm cross decode", 4, 64, 8, VLM_IMAGE_TOKENS, 128,
                 [VLM_IMAGE_TOKENS] * 4))


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
        def sdpa(q, k, v, choice=F.scaled_dot_product_attention):
            return choice(q[:, :, None], k.transpose(1, 2),
                          v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
        lib = time_ms(sdpa, sets, iters=64)
        named = sdpa_backend(sdpa, sets[0]) if path in NAMED_BACKEND else {}
        rows = sum(min(n, S) for n in lens)
        nbytes = 2 * (2 * rows * KV * hd + 2 * B * H * hd) + 4 * B
        ops = 4 * rows * H * hd
        b_ms, b_by = bound(nbytes, ops)
        shapes.append({"path": path, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "vs_library": ms / lib, **named,
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


# B2a and B2b at kimi-k2's attention: (B, H, KV, S, hd), bf16, causal
KIMI_BWD_TIMED = (2, 64, 8, 1024, 112)


def time_bwd(device, gen, path, B, H, KV, S, hd) -> dict:
    """B2a and B2b timed apart, the whole backward (delta, B2a, B2b), the
    plain backward and SDPA's backward at one bf16 causal shape, with the
    card's bounds: {kernel name: its entry's numbers}."""
    bf = torch.bfloat16
    scale = hd ** -0.5
    def sdpa(qt, kt, vt, choice=F.scaled_dot_product_attention):
        return choice(qt, kt, vt, is_causal=True, enable_gqa=H != KV)

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
        lib_sets.append((sdpa(qt, kt, vt), qt, kt, vt, do.transpose(1, 2)))
    ms_dq = time_ms(lambda *a: FO.flash_bwd_dq(*a, True, scale), sets)
    ms_dkv = time_ms(lambda *a: FO.flash_bwd_dkv(*a, True, scale), sets)
    # the whole backward as the train step calls it (delta, B2a, B2b),
    # beside SDPA's, which also forms its delta
    ms_bwd = time_ms(lambda *a: FO.flash_attention_bwd(*a), full)
    plain = time_ms(lambda *a: FR.flash_attention_bwd_ref(*a), full, iters=5)

    def sdpa_bwd(ot, qt, kt, vt, dot):
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    lib = time_ms(sdpa_bwd, lib_sets)
    named = sdpa_backend(sdpa, lib_sets[0][1:4]) \
        if path in NAMED_BACKEND else {}
    pairs = B * H * S * (S + 1) / 2                    # causal (q, k) pairs
    shape = f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal"
    out = {}
    for name, ms, nbytes, ops in (
            ("flash_bwd_dq", ms_dq,
             2 * (3 * B * S * H * hd + 2 * B * S * KV * hd) + 8 * B * H * S,
             3 * 2 * hd * pairs),           # S, dP and dS.K
            ("flash_bwd_dkv", ms_dkv,
             2 * (2 * B * S * H * hd + 4 * B * S * KV * hd) + 8 * B * H * S,
             4 * 2 * hd * pairs)):          # S, dP, P^T.dO and dS^T.Q
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {"path": path, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "bwd_ms": ms_bwd, **named, "shape": shape}
    return out


def time_kernels(device, errs, launches):
    """The kernels' line: each kernel, its plain version and the library
    call timed at the main paths' shapes (B1 and B3 serving yi-6b, B2a and
    B2b training, B4 serving zamba2, B5 serving rwkv6-3b), with the card's
    bound. ``launches`` holds each path's counts; ``launches`` in the line
    is their sum."""
    gen = torch.Generator(device=device).manual_seed(1)
    bf = torch.bfloat16
    out = []

    # B1 at its main-path shapes; the entry's own numbers are the yi-6b
    # prefill's, the first
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

    # B2a and B2b at a gpt2-124m train step's attention: (8, 1024), 12
    # heads; and at kimi-k2's attention, hd 112 (its hd-112 smoke trainer's
    # path, at kimi's heads)
    gpt2 = time_bwd(device, gen, "gpt2 train", TRAIN_B, 12, 12, TRAIN_S, 64)
    kimi = time_bwd(device, gen, "kimi attention", *KIMI_BWD_TIMED)
    note = ("plain_ms and library_ms are each one timing of a call that "
            "computes dq, dk and dv together (flash_attention_bwd_ref; "
            "torch.autograd.grad of scaled_dot_product_attention); the "
            "same number stands in the B2a and the B2b entry, as does "
            "bwd_ms, the whole flash_attention_bwd call (delta, B2a and "
            "B2b), which is what compares with library_ms")
    for name, line in (("flash_bwd_dq", 138), ("flash_bwd_dkv", 181)):
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_bwd.cu",
                    "replaces": f"src/repro/kernels/flash_attention/"
                                f"kernel.py:{line}",
                    "launches": sum(n[name] for n in launches.values()),
                    "launches_by_path": {p: n[name]
                                         for p, n in launches.items()},
                    "max_abs_err": errs[name], **gpt2[name],
                    "note": note, "kimi": kimi[name]})

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
def plain_attention(train_route=plain_train,
                    decode_route=DR.decode_attention_ref):
    """The attention sublayer with the kernel wrappers swapped for their
    plain versions (forward, backward and decode): the yardstick of the
    full-width comparisons. ``train_route`` replaces the training and
    prefill attention, ``decode_route`` the decode attention (the planted
    faults pass their own)."""
    saved = A.flash_attention_train, A.decode_attention
    A.flash_attention_train, A.decode_attention = \
        train_route, decode_route
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
    prefill_runs, decode_ms, profile = timed_steps(engine, prompts)
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
            "prefill_ms": min(prefill_runs), "prefill_shape": "B=4 S=512",
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


def timed_steps(engine, prompts, prefill=None):
    """(3 prefills' wall ms, the mean wall ms of 16 decode steps after
    one, their profile): each timed on the host clock and synchronised,
    the profile by :func:`profile_steps` against the best prefill.
    ``prefill`` () -> (logits, cache) replaces the engine's prefill of
    ``prompts`` (the vlm's prefill step over its image embeddings)."""
    prefill = prefill or (lambda: engine._prefill(prompts))
    prefill_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, cache = prefill()
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
    del logits, cache
    return prefill_ms, decode_ms, \
        profile_steps(engine, prefill, min(prefill_ms), decode_ms)


def profile_steps(engine, prefill, prefill_ms: float, decode_ms: float,
                  tries: int = 3):
    """Device time by kernel over one ``prefill()`` and over 4 decode
    steps after a fresh one, from torch.profiler (see
    :func:`device_window`). The decode window also holds
    ``b3_calls_per_step``, B3's launches a step by its wrapper's count in
    that window, and ``b3_readings``, its device kernels a step in each
    window taken. torch.profiler can lose a kernel's record (it read 127
    B3 kernels for 128 launches in one whole run on an NVIDIA H100 80GB
    HBM3, 700.00 W), so a window that reads fewer device kernels than
    launches is taken again, up to ``tries`` windows in all; the last one
    taken is kept. A reading of as many or more is final."""
    out = {"prefill": device_window(prefill, prefill_ms)}
    readings = []
    for _ in range(tries):
        logits, cache = prefill()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        del logits

        def decode4():
            nonlocal cache, tok
            for _ in range(4):
                lg, cache = engine._decode(cache, tok)
                tok = lg[:, -1].argmax(-1, keepdim=True)

        before = DO.decode_attention.launches
        step = device_window(decode4, decode_ms, 4)
        calls = (DO.decode_attention.launches - before) / 4
        del cache
        if step is None:
            break
        readings.append(step["b3_kernels_per_step"])
        step.update(b3_calls_per_step=calls, b3_readings=readings)
        if readings[-1] >= calls:
            break
        print(f"decode window: {readings[-1]} B3 device kernels a step for "
              f"{calls} launches; taken again")
    out["decode_step"] = step
    return out


def small_model_matches_cpu(
        device, archs=((yi_6b, [16, 5, 11]), (zamba2_1p2b, None))) -> None:
    """Smoke width in float32: greedy tokens on the card (kernels) equal
    those on the CPU (plain versions), for each (config module, prompt
    lengths[, smoke_config overrides]) of ``archs``: by default yi-6b
    (ragged prompts) and zamba2-1.2b (uniform prompts; the hybrid family
    takes no other)."""
    for arch, lens, *over in archs:
        cfg = arch.smoke_config(dtype=torch.float32, **(over[0] if over
                                                         else {}))
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
        print(f"{cfg.name} smoke model f32 (hd {cfg.hd}): card tokens equal "
              f"CPU tokens; card launches {n}")


def small_train_matches_cpu(device, cfg=None) -> dict:
    """Smoke width in float32: 3 train steps on the card (kernels) against
    3 on the CPU (plain versions), from the same params and batch; by
    default gpt2-124m's smoke model. Returns the readings. A vlm ``cfg``
    trains with its gates at VLM_GATE on seeded random image embeddings:
    B2a/B2b non-causal, 32 queries over its 16 image keys."""
    cfg = cfg or gpt2_124m.smoke_config(dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, cfg.vocab, (2, 33))}
    if cfg.family == "vlm":
        params["cross_blocks"]["gate"].fill_(VLM_GATE)
        batch["image_embeds"] = rng.randn(
            2, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
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
            p, state, metrics = step(p, state, batch)
            losses.append(float(metrics["loss"]))
        out[str(model.device.type)] = (losses, p, read_counts())
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, n_gpu) = out["cpu"], out["cuda"]
    L = cfg.n_layers
    check(n_gpu["flash_attention"] == 3 * 2 * L
          and n_gpu["flash_bwd_dq"] == n_gpu["flash_bwd_dkv"] == 3 * L
          and all(n_gpu[n] == 0 for n in PLAIN),
          f"{cfg.name} train steps on the card: launches {n_gpu}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    p_rel = max(((a.cpu() - b).norm() / b.norm()).item() for (_, a), (_, b)
                in zip(flatten(p_gpu), flatten(p_cpu)))
    print(f"{cfg.name} f32 (hd {cfg.hd}), 3 train steps: losses card "
          f"{l_gpu} cpu {l_cpu}; loss rel err {loss_rel:.3g}, params rel L2 "
          f"(worst leaf) {p_rel:.3g} (limit {SMOKE_TRAIN_REL}); card "
          f"launches {n_gpu}")
    check(loss_rel <= SMOKE_TRAIN_REL and p_rel <= SMOKE_TRAIN_REL,
          f"{cfg.name}: card and CPU train steps differ")
    return {"losses_card": l_gpu, "losses_cpu": l_cpu, "loss_rel": loss_rel,
            "params_rel_l2": p_rel, "launches": n_gpu}


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
# the fault campaigns: run_scenario cells with the trainer on the card
# ---------------------------------------------------------------------------


@contextmanager
def campaign_recorded():
    """Every DDPTrainer run inside, by wrapping the class's ``train`` and
    ``_allreduce_grads``: the launch counts of each step (read and set to
    0 as the step ends, before the workload's own ``on_step``) and each
    all-reduce's virtual window (sim time before, after)."""
    rec = {"counts": [], "sync": []}
    train, allreduce = TR.DDPTrainer.train, TR.DDPTrainer._allreduce_grads

    def t_train(self, world, on_step=None):
        def step_done(step, t, loss):
            rec["counts"].append(read_counts())
            zero_counts()
            if on_step is not None:
                on_step(step, t, loss)
        return train(self, world, on_step=step_done)

    def t_allreduce(self, world, run, vecs):
        t0 = self.cluster.sim.now
        allreduce(self, world, run, vecs)
        rec["sync"].append((t0, self.cluster.sim.now))

    TR.DDPTrainer.train, TR.DDPTrainer._allreduce_grads = t_train, t_allreduce
    zero_counts()
    try:
        yield rec
    finally:
        TR.DDPTrainer.train, TR.DDPTrainer._allreduce_grads = \
            train, allreduce


def campaign_cell(device, scenario: str, workload: str, **kw):
    """One cell through the port's ``run_scenario`` on ``device``, timed
    on the host clock; a card run is counted from 0 and a ``ddp_hooked``
    cell computes its clean reference on that device anew. Returns
    (result, wall s, launches)."""
    if torch.device(device).type == "cuda":
        SE._HOOKED_REFERENCE.clear()
    zero_counts()
    t0 = time.perf_counter()
    r = run_scenario(SCENARIOS[scenario], workload=workload, device=device,
                     **kw)
    sync(device)
    return r, time.perf_counter() - t0, read_counts()


def campaign_smoke(device) -> list:
    """(a) Each CAMPAIGN_SMOKE cell on the card and on the CPU: ``ok``,
    the same fingerprint, exact B1/B2a/B2b counts on the card and no
    plain launch; the hooked cell reads BENCH_core.json's fault cell, the
    ddp cell's decision log holds a checkpoint."""
    L = CAMPAIGN_SMOKE_LAYERS
    cells = []
    for scenario, workload, kw in CAMPAIGN_SMOKE:
        card_r, card_s, n = campaign_cell(device, scenario, workload, **kw)
        cpu_r, cpu_s, _ = campaign_cell("cpu", scenario, workload, **kw)
        same = card_r.fingerprint() == cpu_r.fingerprint()
        loss_rel = losses_rel(card_r.loss_trace, cpu_r.loss_trace)
        steps = kw["steps"]
        # each rank's step runs B1 twice a layer (remat "full") and each
        # backward kernel once; the hooked cell's clean reference trains
        # the same steps again
        runs = 2 if workload == "ddp_hooked" else 1
        bwd = runs * steps * 2 * L
        want = {k: 0 for k in PLAIN + ("decode_attention", "ssd_scan",
                                       "rwkv6_scan")}
        want.update(flash_attention=2 * bwd, flash_bwd_dq=bwd,
                    flash_bwd_dkv=bwd)
        decisions = [d[2] for d in card_r.decision_log]
        print(f"campaign {scenario} x {workload} {kw}: card ok "
              f"{card_r.ok} {card_r.violations}, cpu ok {cpu_r.ok}; "
              f"fingerprints equal {same}; completed {card_r.completed}, "
              f"fallbacks {card_r.fallbacks}, recoveries "
              f"{card_r.recoveries}, payload mismatches "
              f"{card_r.payload_mismatches}, overlap "
              f"{card_r.overlap_fraction:.6f}, decisions {decisions}; "
              f"losses card {card_r.loss_trace} cpu {cpu_r.loss_trace}, "
              f"rel {loss_rel:.3g} (limit {CAMPAIGN_LOSS_REL}); "
              f"wall s card {card_s:.2f} cpu {cpu_s:.2f}; card launches {n}")
        check(card_r.ok and cpu_r.ok,
              f"campaign {scenario} x {workload}: violations card "
              f"{card_r.violations}, cpu {cpu_r.violations}")
        check(same, f"campaign {scenario} x {workload}: the card's "
                    f"fingerprint differs from the CPU's")
        check(n == want, f"campaign {scenario} x {workload}: launches {n}, "
                         f"want exactly {want}")
        check(loss_rel <= CAMPAIGN_LOSS_REL,
              f"campaign {scenario} x {workload}: card and CPU losses "
              f"differ by {loss_rel:.3g}")
        if workload == "ddp_hooked":
            got = {"completed": card_r.completed,
                   "fallbacks": card_r.fallbacks,
                   "payload_mismatches": card_r.payload_mismatches,
                   "overlap_fraction": round(card_r.overlap_fraction, 6)}
            check(got == HOOKED_FAULT_CELL,
                  f"campaign hooked fault cell: {got}, want "
                  f"{HOOKED_FAULT_CELL}")
        else:
            check("checkpoint" in decisions,
                  f"campaign {scenario} x {workload}: no checkpoint "
                  f"decision in {decisions}")
            faults = campaign_loss_faults(device, scenario, workload, kw,
                                          cpu_r.loss_trace)
        cells.append({
            "scenario": scenario, "workload": workload, "kw": kw,
            "ok": card_r.ok, "fingerprint_equal_cpu": same,
            "completed": card_r.completed, "fallbacks": card_r.fallbacks,
            "recoveries": card_r.recoveries,
            "payload_mismatches": card_r.payload_mismatches,
            "overlap_fraction": card_r.overlap_fraction,
            "decisions": decisions, "launches": n,
            "losses": {"card": card_r.loss_trace, "cpu": cpu_r.loss_trace},
            "loss_rel": loss_rel,
            "planted_fault_loss_rel": faults if workload == "ddp" else None,
            "wall_s": {"card": card_s, "cpu": cpu_s}})
    return cells


def losses_rel(got, ref) -> float:
    """The largest relative difference of two loss traces of one length."""
    check(got is not None and ref is not None and len(got) == len(ref),
          f"loss traces differ in length: {got} against {ref}")
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def campaign_loss_faults(device, scenario, workload, kw, cpu_losses) -> dict:
    """The cell on the card again with each CAMPAIGN_LOSS_FAULTS route of
    the plain attention: CAMPAIGN_LOSS_REL must reject every one.
    Returns {fault: relative loss difference against the CPU}."""
    routes = model_faults(CAMPAIGN_SMOKE_LAYERS)
    out = {}
    for fault in CAMPAIGN_LOSS_FAULTS:
        with plain_attention(routes[fault]):
            r, _, _ = campaign_cell(device, scenario, workload, **kw)
        out[fault] = losses_rel(r.loss_trace, cpu_losses)
        print(f"  planted fault '{fault}' in {scenario} x {workload}: loss "
              f"rel {out[fault]:.3g} against the CPU, rejected "
              f"{out[fault] > CAMPAIGN_LOSS_REL}")
        check(out[fault] > CAMPAIGN_LOSS_REL,
              f"campaign loss limit passes a planted fault ({fault})")
    return out


def campaign_full_width(device) -> tuple:
    """(b) sender_nic_down on ddp with gpt2-124m at full width: ``ok``,
    completed, >= 1 fallback, finite losses, exactly 2 x 2L B1 and 2L of
    each backward kernel a step. Prints the fault log's virtual times
    beside each step's all-reduce window. Returns (launches, cell)."""
    cfg = gpt2_124m.config()
    L = cfg.n_layers
    want = {k: 0 for k in PLAIN + ("decode_attention", "ssd_scan",
                                   "rwkv6_scan")}
    want.update(flash_attention=2 * 2 * L, flash_bwd_dq=2 * L,
                flash_bwd_dkv=2 * L)
    with campaign_recorded() as rec:
        t0 = time.perf_counter()
        r = run_scenario(SCENARIOS[CAMPAIGN_FULL_SCENARIO], workload="ddp",
                         device=device, model_cfg=cfg, **CAMPAIGN_FULL)
        sync(device)
        wall_s = time.perf_counter() - t0
    steps = CAMPAIGN_FULL["steps"]
    sync_ms = [(a * 1e3, b * 1e3) for a, b in rec["sync"]]
    faults = [(t * 1e3, kind, gid) for t, kind, gid in r.fault_log]
    landed = [next((i + 1 for i, (a, b) in enumerate(sync_ms)
                    if a <= t <= b), None) for t, _, _ in faults]
    print(f"campaign {CAMPAIGN_FULL_SCENARIO} x ddp, gpt2-124m full width "
          f"{CAMPAIGN_FULL}: ok {r.ok} {r.violations}; completed "
          f"{r.completed}, steps {r.rounds}, fallbacks {r.fallbacks}, "
          f"recoveries {r.recoveries}, payload mismatches "
          f"{r.payload_mismatches}, losses {r.loss_trace}; wall "
          f"{wall_s:.1f} s; launches a step {rec['counts']}")
    print(f"campaign full width: each step's all-reduce in virtual ms "
          f"(start, end) {sync_ms}; faults (virtual ms, kind, NIC) "
          f"{faults}, in the all-reduce of step {landed}")
    check(r.ok and r.completed and r.fallbacks >= 1
          and r.rounds == steps,
          f"campaign full width: ok {r.ok} {r.violations}, completed "
          f"{r.completed}, steps {r.rounds}, fallbacks {r.fallbacks}")
    check(r.loss_trace is not None and len(r.loss_trace) == steps
          and all(np.isfinite(r.loss_trace)),
          f"campaign full width: losses {r.loss_trace}")
    check(len(rec["counts"]) == steps
          and all(n == want for n in rec["counts"]),
          f"campaign full width: launches a step {rec['counts']}, want "
          f"exactly {want} each")
    total = {k: sum(c[k] for c in rec["counts"]) for k in rec["counts"][0]}
    return total, {
        "scenario": CAMPAIGN_FULL_SCENARIO, "workload": "ddp",
        "model": "gpt2-124m (12 layers, d=768, vocab 50257, f32 params, "
                 "bf16 activations, remat full, random weights), 2 ranks "
                 "x 2 x 32 tokens",
        "kw": CAMPAIGN_FULL, "ok": r.ok, "violations": r.violations,
        "completed": r.completed, "steps": r.rounds,
        "fallbacks": r.fallbacks, "recoveries": r.recoveries,
        "payload_mismatches": r.payload_mismatches,
        "losses": r.loss_trace, "fault_log_virtual_ms": faults,
        "allreduce_virtual_ms": sync_ms, "fault_in_step": landed,
        "launches_per_step": rec["counts"], "wall_s": wall_s}


def campaign(device, card) -> tuple:
    """The campaign phase: (a) the smoke-width cells on the card against
    the CPU, (b) the full-width ddp cell. Returns (launches of the card
    runs, the campaign line)."""
    t0 = time.perf_counter()
    cells = campaign_smoke(device)
    total, full = campaign_full_width(device)
    for c in cells:
        for k in total:
            total[k] += c["launches"][k]
    phase_s = time.perf_counter() - t0
    print(f"campaign phase: {phase_s:.1f} s on {card}")
    return total, {"campaign": {"card": card, "smoke_cells": cells,
                                "full_width": full, "phase_wall_s": phase_s}}


# ---------------------------------------------------------------------------
# llama4-maverick (MoE) serving at full width
# ---------------------------------------------------------------------------


def moe_config():
    """llama4-maverick at full width, MOE_LAYERS of its 48 layers, the
    params in bf16 (a float32 master copy would not fit)."""
    return llama4_maverick.config(n_layers=MOE_LAYERS,
                                  param_dtype=torch.bfloat16)


def param_gb(cfg) -> float:
    """The size of ``cfg``'s params in ``cfg.param_dtype``, GB (1e9 B)."""
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    return cfg.param_count() * itemsize / 1e9


def memory_check(cfg, headroom_gb: float, label: str) -> tuple:
    """(free, total GB on the card with nothing of the earlier phases
    resident, the dry-run's GB): ``setup_gb`` the meta trace of the
    phase's set-up (``model.init`` and serving's casts), ``prefill_gb``
    the bytes a device of its B=4 x 512 prefill step over those params,
    ``need_gb`` the larger; fails unless the free memory holds ``need_gb``.
    The hand-set reckoning it replaced, the params and ``headroom_gb``, is
    printed beside it."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = (b / 1e9 for b in torch.cuda.mem_get_info())
    init = DRY._init_pass(cfg)
    mem = DRY._trace_pass(cfg, CC.Shape("prefill", 512, 4, "prefill"),
                          make_debug_mesh(1, 1),
                          params=init["params"])["memory"]
    dry = {"setup_gb": init["peak_bytes"] / 1e9,
           "prefill_gb": (mem["argument_size_in_bytes"]
                          + mem["temp_size_in_bytes"]) / 1e9}
    dry["need_gb"] = max(dry["setup_gb"], dry["prefill_gb"])
    print(f"{label}: {free:.2f} of {total:.2f} GB free on the card; the "
          f"{cfg.n_layers}-layer model needs {dry['need_gb']:.2f} GB by the "
          f"dry-run (set-up {dry['setup_gb']:.2f}, at "
          f"{init['peak_by_op'][:2]}; prefill step {dry['prefill_gb']:.2f}; "
          f"the hand-set reckoning: {param_gb(cfg):.2f} GB of params + "
          f"{headroom_gb} GB)")
    check(free >= dry["need_gb"],
          f"{label}: {free:.2f} GB free on the card, the {cfg.n_layers}-"
          f"layer model needs {dry['need_gb']:.2f} GB")
    return free, total, dry


def setup_agrees(label: str, dry: dict, base: int) -> float:
    """The set-up's peak GB on the card above ``base`` (what was allocated
    before it), held to the dry-run's set-up trace by
    :func:`memory_agrees`."""
    measured = torch.cuda.max_memory_allocated() - base
    predicted = int(round(dry["setup_gb"] * 1e9))
    ok, limit = memory_agrees(predicted, measured)
    print(f"{label}: set-up peak {measured / 1e9:.4f} GB above its base, "
          f"the dry-run's {predicted / 1e9:.4f} (limit {limit / 1e9:.4f})")
    check(ok, f"{label}: the set-up peaked at {measured} bytes above its "
              f"base, the dry-run traced {predicted} (limit {limit:.0f})")
    return measured / 1e9


@contextmanager
def recording_attention(store: list):
    """Append each attention sublayer call's (x, params, rope, cache,
    kv_override) to ``store``, a decode call's K/V cache cloned before it
    appends its rows."""
    saved = A.attention_sublayer

    def record(x, p, cfg, rope, cache=None, kv_override=None):
        snap = cache if cache is None or "k" not in cache else dict(
            cache, k=cache["k"].clone(), v=cache["v"].clone())
        store.append((x, p, rope, snap, kv_override))
        return saved(x, p, cfg, rope, cache=cache, kv_override=kv_override)
    A.attention_sublayer = record
    try:
        yield
    finally:
        A.attention_sublayer = saved


@contextmanager
def recording_routes(store: list):
    """Append each MoE block call's top-k experts of every token ((tokens,
    k), by router logit) to ``store``."""
    saved = BL.moe_mlp

    def record(x, p, cfg):
        logits = x.reshape(-1, x.shape[-1]) @ p["router"].to(x.dtype)
        store.append(logits.argmax(-1, keepdim=True) if cfg.top_k == 1
                     else logits.topk(cfg.top_k, dim=-1).indices)
        return saved(x, p, cfg)
    BL.moe_mlp = record
    try:
        yield
    finally:
        BL.moe_mlp = saved


def routes_differ(got: list, ref: list) -> float:
    """The share of (token, choice) expert choices of ``got`` that are not
    among the same token's choices in ``ref`` (recording_routes' lists)."""
    missing = sum(int((~(a[:, :, None] == b[:, None, :]).any(-1)).sum())
                  for a, b in zip(got, ref))
    return missing / sum(a.numel() for a in got)


def one_key_late(q, k, v, causal=True, scale=None):
    """The plain prefill attention with its causal edge one key late."""
    return plain_masked(q, k, v, causal_seen(q, k, edge=1))[0]


def one_row_short(q, kc, vc, lens):
    """The plain decode attention over one cache row fewer."""
    return DR.decode_attention_ref(q, kc, vc, lens - 1)


def last_key_dropped(q, k, v, causal=True, scale=None):
    """The plain non-causal (cross) attention without the last image
    key."""
    return plain_train(q, k[:, :-1], v[:, :-1], causal, scale)


def attention_replay(rec, cfg, routes=None):
    """One recorded attention call again, on a copy of its cache: through
    the kernel wrappers (``routes`` None) or the (prefill, decode)
    ``routes``."""
    x, p, rope, cache, kv = rec
    if cache is not None and "k" in cache:
        cache = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
    if routes is None:
        return A.attention_sublayer(x, p, cfg, rope, cache=cache,
                                    kv_override=kv)[0]
    with plain_attention(*routes):
        return A.attention_sublayer(x, p, cfg, rope, cache=cache,
                                    kv_override=kv)[0]


def moe_attention_layers(records, cfg, fault_layer=None,
                         faults=(one_key_late, one_row_short)) -> list:
    """Each layer's largest relative L2 error over its recorded attention
    calls (calls come a layer at a time, in order), the kernels against
    the plain versions; the plain versions carry the planted ``faults``
    (by default one key late in a prefill, one row short in a decode
    step) in the calls of ``fault_layer``."""
    L = cfg.n_layers
    plain = (plain_train, DR.decode_attention_ref)
    worst = [0.0] * L
    for i, rec in enumerate(records):
        layer = i % L
        ref = attention_replay(rec, cfg, faults if layer == fault_layer
                               else plain)
        worst[layer] = max(worst[layer],
                           rel_l2(attention_replay(rec, cfg), ref))
    return worst


def step_launches(L: int, prefills: int, decodes: int) -> dict:
    """The exact launches of ``prefills`` prefills (or admissions) and
    ``decodes`` decode steps of an L-layer KV-cache model: one B1 a layer
    and prefill, one B3 a layer and decode step, nothing else."""
    want = {k: 0 for k in KERNELS + PLAIN}
    want.update(flash_attention=L * prefills, decode_attention=L * decodes)
    return want


def moe(device, card):
    """llama4-maverick (MoE) serving: the float32 llama4 and kimi-k2 smoke
    models on the card against the CPU (kimi-k2's also at its head dim
    112), then llama4-maverick at full width (MOE_LAYERS of 48 layers, bf16
    params) through :func:`moe_full_width`. Returns (launches by path, the
    moe line, the engine), the engine kept for the serving campaign
    phase."""
    small_model_matches_cpu(device, ((llama4_maverick, [16, 5, 11]),
                                     (kimi_k2_1t, [16, 5, 11]),
                                     (kimi_k2_1t, [16, 5, 11],
                                      {"head_dim": 112})))
    launches, reading, engine = moe_full_width(
        device, card, moe_config(), "llama4", 48,
        "llama4-maverick-400b-a17b at full width, 2 of 48 layers (d=5120, "
        "40 heads, 8 KV heads, 128 experts of d_ff 8192, top-1, vocab "
        "202048), random bf16 params")
    return launches, {"moe": reading}, engine


def kimi_config():
    """kimi-k2-1t-a32b at full width, KIMI_LAYERS of its 61 layers, the
    params in bf16."""
    return kimi_k2_1t.config(n_layers=KIMI_LAYERS, param_dtype=torch.bfloat16)


def kimi(device, card):
    """kimi-k2-1t-a32b (head dim 112) serving, once llama4-maverick's engine
    is freed: its float32 smoke model at head dim 112 for 3 train steps on
    the card against the CPU (B2a/B2b at hd 112), then KIMI_LAYERS of its
    61 layers at full width through :func:`moe_full_width`. Returns
    (launches by path, the kimi line)."""
    t0 = time.perf_counter()
    train = small_train_matches_cpu(
        device, kimi_k2_1t.smoke_config(dtype=torch.float32, head_dim=112))
    cfg = kimi_config()
    launches, reading, engine = moe_full_width(
        device, card, cfg, "kimi", 61,
        f"kimi-k2-1t-a32b at full width, {KIMI_LAYERS} of 61 layers "
        f"(d=7168, 64 heads of hd 112, 8 KV heads, 384 experts of d_ff "
        f"2048, top-8, vocab 163840), random bf16 params")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    reading.update(smoke_train_hd112=train,
                   phase_wall_s=time.perf_counter() - t0)
    return launches, {"kimi": reading}


def moe_full_width(device, card, cfg, label: str, depth: int, desc: str):
    """An MoE model at full width on the card, ``cfg.n_layers`` of its
    ``depth`` layers with bf16 params, once the dry-run's need is free:
    generate (uniform and ragged) and the scheduler with exact launches;
    kernel path against plain path (each layer's attention gated, the
    whole path and the expert choices that differ printed); step times and
    the profile. ``desc`` names the model in the reading. Returns (launches
    by path, the reading, the engine)."""
    L, V, K = cfg.n_layers, cfg.vocab, cfg.top_k
    free_gb, total_gb, dry = memory_check(cfg, MOE_HEADROOM_GB, label)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    setup_gb = setup_agrees(label, dry, base)
    print(f"setup: {cfg.name} at full width, {L} of {depth} layers "
          f"({cfg.param_count() / 1e9:.3f} B params, {param_gb(cfg):.2f} "
          f"GB in bf16) initialised in {init_s:.1f} s; set-up peak "
          f"{setup_peak_gb:.2f} GB")

    rng = np.random.RandomState(5)
    prompts = rng.randint(1, V, size=(4, 512)).astype(np.int32)
    requests = [(rng.randint(1, V, size=int(rng.randint(16, SCHED_PREFILL
                                                         + 1))
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
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out[path] = run()
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - t0
        launches[f"{label} {path}"] = n = read_counts()
        steps = (SCHED_REQUESTS, sched.decode_steps) \
            if path == "scheduler" else (1, N_NEW)
        want = step_launches(L, *steps)
        print(f"{label} {path} launches: {n}")
        check(n == want, f"{label} {path}: launches {n}, want exactly {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: peak {peak_gb:.2f} GB (set-up {setup_peak_gb:.2f}) of "
          f"the card's {total_gb:.2f}, beside the dry-run's "
          f"{dry['need_gb']:.2f} GB and the hand-set "
          f"{param_gb(cfg) + MOE_HEADROOM_GB:.2f} GB")
    check(max(peak_gb, setup_peak_gb) <= total_gb,
          f"{label}: a peak of {max(peak_gb, setup_peak_gb):.2f} GB is "
          f"more than the card's {total_gb:.2f} GB")
    uniform, ragged = out["generate uniform"], out["generate ragged"]
    for name, toks in (("uniform", uniform), ("ragged", ragged)):
        check(toks.shape == (4, 512 + N_NEW)
              and np.array_equal(toks[:, :512], prompts)
              and ((toks[:, 512:] >= 0) & (toks[:, 512:] < V)).all(),
              f"{label} {name} tokens {toks.shape}")
    for r, (prompt, n) in zip(sched.requests, requests):
        check(r.state == "done" and len(r.tokens) == n
              and all(0 <= t < V for t in r.tokens),
              f"{label} request {r.rid}: {r.state} with {len(r.tokens)}/{n} "
              f"tokens")
    n_sched_tokens = sum(n for _, n in requests)
    print(f"{label} scheduler: {len(requests)} requests, {n_sched_tokens} "
          f"tokens, {sched.decode_steps} decode steps, {tp.sync_rounds} sync "
          f"rounds")

    # the kernel path against the plain path, teacher-forced
    feed = [torch.as_tensor(rng.randint(1, V, size=(4, 1)), device=device)
            for _ in range(4)]
    records, routes_k, routes_p = [], [], []
    with recording_attention(records), recording_routes(routes_k):
        fast = teacher_forced(engine, prompts, feed)
    with plain_attention(), recording_routes(routes_p):
        slow = teacher_forced(engine, prompts, feed)
    check(bool(torch.isfinite(fast).all()), f"non-finite {label} logits")
    whole = rel_l2(fast, slow)
    agree = (fast.argmax(-1) == slow.argmax(-1)).float().mean().item()
    flips = routes_differ(routes_k, routes_p)
    del fast, slow, routes_k, routes_p
    per_layer = moe_attention_layers(records, cfg)
    faulted = moe_attention_layers(records, cfg, fault_layer=L - 1)
    del records
    print(f"{label} kernel vs plain (prefill + 4 decode steps): whole-path "
          f"bf16 logits rel L2 {whole:.3g} (not gated), argmax agreement "
          f"{agree:.3f}, top-{K} expert choices that differ {flips:.4f}; "
          f"each layer's attention sublayer rel L2 "
          f"{[f'{r:.3g}' for r in per_layer]} (limit {MOE_ATTN_REL_L2})")
    print(f"  planted fault in layer {L - 1}'s plain attention (prefill one "
          f"key late, decode one row short): "
          f"{[f'{r:.3g}' for r in faulted]}, rejected "
          f"{faulted[L - 1] > MOE_ATTN_REL_L2}")
    check(max(per_layer) <= MOE_ATTN_REL_L2,
          f"{label}: an attention sublayer's kernel path disagrees with its "
          f"plain path")
    check(faulted[L - 1] > MOE_ATTN_REL_L2,
          f"{label}: the attention limit passes a one-layer planted fault")

    # step times at the uniform generate's shapes
    prefill_runs, decode_ms, profile = timed_steps(engine, prompts)
    step = profile["decode_step"]
    b3 = step and step["b3_kernels_per_step"]
    check(b3 == L, f"{label} decode step: {b3} B3 device kernels, not one "
                   f"for each of {L} calls")
    reading = {
        "model": desc,
        "card": card, "params_b": cfg.param_count() / 1e9,
        "params_gb": param_gb(cfg), "init_s": init_s,
        "free_gb_before": free_gb, "total_gb": total_gb,
        "prefill_ms": min(prefill_runs), "prefill_shape": "B=4 S=512",
        "decode_ms_per_step": decode_ms, "decode_batch": 4,
        "generate_uniform_s": seconds["generate uniform"],
        "generate_ragged_s": seconds["generate ragged"],
        "generate_tokens_per_s": 4 * N_NEW / seconds["generate uniform"],
        "decode_tokens_per_s": 4 / (decode_ms / 1e3),
        "scheduler_s": seconds["scheduler"],
        "scheduler_tokens_per_s": n_sched_tokens / seconds["scheduler"],
        "scheduler_decode_steps": sched.decode_steps,
        "peak_memory_gb": peak_gb, "setup_peak_memory_gb": setup_peak_gb,
        "setup_above_base_gb": setup_gb, "dryrun_setup_gb": dry["setup_gb"],
        "dryrun_prefill_gb": dry["prefill_gb"],
        "dryrun_need_gb": dry["need_gb"],
        "hand_set_need_gb": param_gb(cfg) + MOE_HEADROOM_GB,
        "whole_path_logits_rel_l2": whole, "argmax_agreement": agree,
        f"top{K}_expert_differs_share": flips,
        "attention_layer_rel_l2": per_layer,
        "planted_fault_layer_rel_l2": faulted,
        "launches": launches, "profile": profile}
    return launches, reading, engine


# ---------------------------------------------------------------------------
# the serving campaign: tensor-parallel serving over the fabric
# ---------------------------------------------------------------------------


@contextmanager
def serving_steps():
    """Count every ``TPServeEngine`` admission and decode step inside, by
    wrapping the class's ``admit`` and ``decode_batch``."""
    rec = {"admit": 0, "decode": 0}
    admit, decode = TPServeEngine.admit, TPServeEngine.decode_batch

    def t_admit(self, slot, prompt):
        rec["admit"] += 1
        return admit(self, slot, prompt)

    def t_decode(self, feed):
        rec["decode"] += 1
        return decode(self, feed)

    TPServeEngine.admit, TPServeEngine.decode_batch = t_admit, t_decode
    try:
        yield rec
    finally:
        TPServeEngine.admit, TPServeEngine.decode_batch = admit, decode


def serving_cell(device, scenario: str):
    """One ``serving`` cell through the port's ``run_scenario`` on
    ``device``: (result, wall s, launches, the admissions and decode steps
    they must follow from)."""
    with serving_steps() as steps:
        zero_counts()
        t0 = time.perf_counter()
        r = run_scenario(SCENARIOS[scenario], workload="serving",
                         device=device)
        sync(device)
        wall = time.perf_counter() - t0
        n = read_counts()
    return r, wall, n, steps


def serving_smoke(device) -> list:
    """(a) Each SERVING_CELLS cell on the card and on the CPU: both ``ok``,
    the same fingerprint; the maskable cells completed with no token or
    payload mismatch and at least the scenario's fallbacks
    (``rail_kill_striped`` also resteers), the unmaskable one aborted with
    a failed request and no token mismatch; exactly one B1 a layer and
    admission and one B3 a layer and decode step on the card (the cell's
    single-host reference run counted), no plain launch."""
    L = llama4_maverick.smoke_config().n_layers
    cells = []
    for name in SERVING_CELLS:
        card_r, card_s, n, steps = serving_cell(device, name)
        cpu_r, cpu_s, _, _ = serving_cell("cpu", name)
        same = card_r.fingerprint() == cpu_r.fingerprint()
        want = step_launches(L, steps["admit"], steps["decode"])
        sc = SCENARIOS[name]
        print(f"serving {name}: card ok {card_r.ok} {card_r.violations}, "
              f"cpu ok {cpu_r.ok}; fingerprints equal {same}; completed "
              f"{card_r.completed}, aborted {card_r.aborted}, requests "
              f"{card_r.requests_done}/{card_r.requests_total} done, "
              f"{card_r.requests_failed} failed, rounds {card_r.rounds}, "
              f"fallbacks {card_r.fallbacks}, resteered "
              f"{card_r.resteered_chunks}, token mismatches "
              f"{card_r.token_mismatches}, payload mismatches "
              f"{card_r.payload_mismatches}; wall s card {card_s:.2f} cpu "
              f"{cpu_s:.2f}; card steps {steps}, launches {n}")
        check(card_r.ok and cpu_r.ok,
              f"serving {name}: violations card {card_r.violations}, cpu "
              f"{cpu_r.violations}")
        check(same, f"serving {name}: the card's fingerprint differs from "
                    f"the CPU's")
        check(n == want, f"serving {name}: launches {n}, want exactly {want}")
        check(card_r.token_mismatches == 0,
              f"serving {name}: {card_r.token_mismatches} token mismatches")
        if sc.expect_masked:
            check(card_r.completed and card_r.payload_mismatches == 0
                  and card_r.fallbacks >= sc.min_fallbacks,
                  f"serving {name}: completed {card_r.completed}, payload "
                  f"mismatches {card_r.payload_mismatches}, fallbacks "
                  f"{card_r.fallbacks}")
        else:
            check(card_r.aborted and card_r.requests_failed >= 1,
                  f"serving {name}: aborted {card_r.aborted}, "
                  f"{card_r.requests_failed} requests failed")
        if name == "rail_kill_striped":
            check(card_r.resteered_chunks >= 1,
                  f"serving {name}: no chunk resteered")
        cells.append({
            "scenario": name, "ok": card_r.ok, "fingerprint_equal_cpu": same,
            "completed": card_r.completed, "aborted": card_r.aborted,
            "requests": [card_r.requests_done, card_r.requests_total,
                         card_r.requests_failed],
            "rounds": card_r.rounds, "fallbacks": card_r.fallbacks,
            "resteered_chunks": card_r.resteered_chunks,
            "token_mismatches": card_r.token_mismatches,
            "payload_mismatches": card_r.payload_mismatches,
            "steps": dict(steps), "launches": n,
            "wall_s": {"card": card_s, "cpu": cpu_s}})
    return cells


def tp_serving_run(model, engine, requests, world_kw=None, kill=None):
    """``RequestScheduler`` over ``TPServeEngine(world=...)`` sharing
    ``engine``: the perf suite's ``serving_tp`` loop. ``requests`` are
    (prompt, n_tokens); ``world_kw`` None serves with no world (the
    reference run), else over ``build_world(**world_kw)``; ``kill`` names
    a NIC taken down half a measured first step into decode. Returns the
    tokens of each request and the readings."""
    cluster = libs = world = None
    if world_kw is not None:
        cluster, libs, world = build_world(**world_kw)
    tp = TPServeEngine(model, None, world=world, max_len=engine.max_len,
                       timeout=10.0, local=engine, device=engine.device)
    sched = RequestScheduler(tp, n_slots=len(requests),
                             prefill_len=SCHED_PREFILL)
    for prompt, n in requests:
        sched.submit(prompt, n)
    with serving_steps() as steps:
        zero_counts()
        t0, v0 = time.perf_counter(), cluster and cluster.sim.now
        ticks = 0
        while sched.pending:
            sched.step()
            ticks += 1
            if ticks == 1 and kill is not None:
                per_step = cluster.sim.now - v0
                for lib in libs:
                    lib.config.probe_interval = max(per_step / 2, 1e-5)
                cluster.schedule_fault(cluster.sim.now + per_step / 2,
                                       "nic_down", kill)
        sync(engine.device)
        wall = time.perf_counter() - t0
        n = read_counts()
    tokens = [list(r.tokens) for r in sched.requests]
    check(all(r.state == "done" for r in sched.requests),
          f"tp serving: requests {[r.state for r in sched.requests]}")
    reading = {"wall_s": wall, "steps": dict(steps), "launches": n,
               "decode_steps": sched.decode_steps,
               "tokens": sum(len(t) for t in tokens),
               "reconstruction_mismatches": tp.reconstruction_mismatches}
    if world is not None:
        elapsed = cluster.sim.now - v0
        reading.update(
            virtual_ms=elapsed * 1e3,
            tokens_per_virtual_s=reading["tokens"] / elapsed,
            fallbacks=sum(lib.stats.fallbacks for lib in libs),
            resteered=world.scheduler.resteered)
    return tokens, reading


def serving_full_width(device, model, engine) -> dict:
    """(b) The moe phase's llama4-maverick engine over a 2-rank, 2-channel
    world: the scheduler with TP_FULL_REQUESTS requests on as many slots,
    healthy and with TP_FULL_NIC killed mid-decode, against a world=None
    run on the card: tokens equal bit for bit, no reconstruction mismatch,
    at least one fallback under the fault, exact launches."""
    L, V = model.cfg.n_layers, model.cfg.vocab
    rng = np.random.RandomState(6)
    requests = [(rng.randint(1, V, size=int(rng.randint(16, SCHED_PREFILL
                                                         + 1))
                             ).astype(np.int32), TP_FULL_TOKENS)
                for _ in range(TP_FULL_REQUESTS)]
    ref, local = tp_serving_run(model, engine, requests)
    runs = {"local": local}
    for name, kill in (("healthy", None), ("nic killed", TP_FULL_NIC)):
        tokens, runs[name] = tp_serving_run(model, engine, requests,
                                            TP_FULL_WORLD, kill)
        r = runs[name]
        r["tokens_equal_local"] = tokens == ref
        print(f"tp serving at full width, {name}: tokens equal to the "
              f"world=None run {tokens == ref}, {r['tokens']} tokens in "
              f"{r['virtual_ms']:.4f} virtual ms "
              f"({r['tokens_per_virtual_s']:.1f} tokens per virtual s), "
              f"fallbacks {r['fallbacks']}, resteered {r['resteered']}, "
              f"reconstruction mismatches {r['reconstruction_mismatches']}, "
              f"wall {r['wall_s']:.2f} s; launches {r['launches']}")
        check(tokens == ref, f"tp serving at full width, {name}: tokens "
                             f"differ from the world=None run")
        check(r["reconstruction_mismatches"] == 0,
              f"tp serving at full width, {name}: "
              f"{r['reconstruction_mismatches']} reconstruction mismatches")
    check(runs["nic killed"]["fallbacks"] >= 1,
          "tp serving at full width: no fallback under the NIC kill")
    for name, r in runs.items():
        want = step_launches(L, r["steps"]["admit"], r["steps"]["decode"])
        check(r["launches"] == want and r["steps"]["admit"] == len(requests),
              f"tp serving at full width, {name}: launches "
              f"{r['launches']}, want exactly {want}")
    return {"model": "the moe phase's llama4-maverick engine",
            "world": dict(TP_FULL_WORLD), "kill": TP_FULL_NIC,
            "requests": [[len(p), n] for p, n in requests],
            "runs": runs,
            "fault_throughput_ratio":
                runs["nic killed"]["tokens_per_virtual_s"]
                / runs["healthy"]["tokens_per_virtual_s"]}


def serving_campaign(device, card, model, engine) -> tuple:
    """The serving campaign phase: (a) the smoke cells on the card against
    the CPU, (b) the full-width TP run over the fabric. Returns (launches
    of the card runs, the serving_campaign line)."""
    t0 = time.perf_counter()
    cells = serving_smoke(device)
    full = serving_full_width(device, model, engine)
    total = {k: sum(c["launches"][k] for c in cells)
             + sum(r["launches"][k] for r in full["runs"].values())
             for k in KERNELS + PLAIN}
    phase_s = time.perf_counter() - t0
    print(f"serving campaign phase: {phase_s:.1f} s on {card}")
    return total, {"serving_campaign": {
        "card": card, "smoke_cells": cells, "full_width": full,
        "phase_wall_s": phase_s}}


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

    prefill_runs, decode_ms, profile = timed_steps(engine, prompts)
    return {"generate": n_gen}, {"zamba2": {
        "model": "zamba2-1.2b (38 Mamba2 blocks + 1 shared attention block "
                 "run 6 times, d=2048, random bf16 weights)",
        "card": card,
        "prefill_ms": min(prefill_runs), "prefill_shape": "B=4 S=512",
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

    prefill_runs, decode_ms, profile = timed_steps(engine, prompts)
    return {"generate": n_gen}, {"rwkv6": {
        "model": "rwkv6-3b (32 blocks, d=2560, 40 heads of 64, d_ff=8960, "
                 "vocab 65536, random bf16 weights)",
        "card": card,
        "prefill_ms": min(prefill_runs), "prefill_ms_runs": prefill_runs,
        "prefill_shape": "B=4 S=512",
        "decode_ms_per_step": decode_ms, "decode_batch": 4,
        "generate_s": t_gen, "generate_tokens_per_s": 4 * N_NEW / t_gen,
        "decode_tokens_per_s": 4 / (decode_ms / 1e3),
        "peak_memory_gb": peak_gb, "peak_memory_of": "generate",
        "setup_peak_memory_gb": setup_peak_gb,
        "launches": {"generate": n_gen, "prefill": n_pre,
                     "decode_step": n_dec},
        "float32_path": f32, "bf16": bf16, "profile": profile}}


# ---------------------------------------------------------------------------
# the families phase: llama-3.2-vision, musicgen-medium, starcoder2-3b
# ---------------------------------------------------------------------------


def small_vlm_matches_cpu(device) -> None:
    """The vlm smoke model in float32, its gates at VLM_GATE: a greedy loop
    through ``make_prefill_step`` over seeded random image embeddings and
    ``make_decode_step`` gives the same tokens on the card (kernels) as on
    the CPU (plain versions)."""
    cfg = llama32_vision_90b.smoke_config(dtype=torch.float32)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params["cross_blocks"]["gate"].fill_(VLM_GATE)
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(1, cfg.vocab, (3, 16)),
             "image_embeds": rng.randn(3, cfg.n_image_tokens,
                                       cfg.d_model).astype(np.float32)}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", build_model(cfg, device))):
        p = serving_params(params, cfg, model.device)
        prefill = make_prefill_step(model, max_len=32)
        decode = make_decode_step(model)
        zero_counts()
        logits, cache = prefill(p, batch)
        toks = []
        for _ in range(12):
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
            logits, cache = decode(p, cache, toks[-1])
        out[dev] = torch.cat(toks, 1).cpu().numpy()
    n = read_counts()
    check(np.array_equal(out["cuda"], out["cpu"]),
          f"{cfg.name} smoke model: card and CPU tokens differ")
    G, E = vlm_layout(cfg)
    check(n == step_launches(cfg.n_layers, 1, 12),
          f"{cfg.name} smoke model on the card: launches {n}")
    print(f"{cfg.name} smoke model f32 ({G} groups, gates {VLM_GATE}, "
          f"random images): card tokens equal CPU tokens; card launches "
          f"{n}")


@contextmanager
def counting_masks(tally: dict):
    """Count each flash-attention call of the attention sublayer in
    ``tally`` by its mask ("causal", "non-causal"), beside the wrapper's
    own launch count."""
    saved = A.flash_attention_train

    def count(q, k, v, causal=True, scale=None):
        tally["causal" if causal else "non-causal"] += 1
        return saved(q, k, v, causal=causal, scale=scale)
    A.flash_attention_train = count
    try:
        yield
    finally:
        A.flash_attention_train = saved


def vlm_config():
    """llama-3.2-vision at full width, VLM_LAYERS of its 100 layers, the
    params in bf16."""
    return llama32_vision_90b.config(n_layers=VLM_LAYERS,
                                     param_dtype=torch.bfloat16)


def vlm_full_width(device, card) -> tuple:
    """llama-3.2-vision at full width (VLM_LAYERS of 100 layers, bf16
    params, the gates at VLM_GATE): a prefill step over seeded random
    image embeddings and N_NEW decode steps, then ``generate`` with the
    reference's zero images, each with exact launches; each layer's
    attention sublayer, kernel against plain, gated, with a planted
    fault dropping the last image key of one cross block; the whole
    path printed; step times and the profile. Returns (launches by path,
    the line's entry)."""
    cfg = vlm_config()
    check(cfg.n_image_tokens == VLM_IMAGE_TOKENS, f"config {cfg}")
    L, V = cfg.n_layers, cfg.vocab
    G, E = vlm_layout(cfg)
    free_gb, total_gb, dry = memory_check(cfg, VLM_HEADROOM_GB, "vlm")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    params["cross_blocks"]["gate"].fill_(VLM_GATE)
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    setup_gb = setup_agrees("vlm", dry, base)
    print(f"setup: llama-3.2-vision at full width, {L} of 100 layers ({G} "
          f"groups of a cross block and {E} self blocks; "
          f"{cfg.param_count() / 1e9:.3f} B params, {param_gb(cfg):.2f} GB "
          f"in bf16) initialised in {init_s:.1f} s; set-up peak "
          f"{setup_peak_gb:.2f} GB; every cross block's gate set to "
          f"{VLM_GATE} (tanh {np.tanh(VLM_GATE):.4f})")

    rng = np.random.RandomState(9)
    prompts = rng.randint(1, V, size=(4, 512)).astype(np.int32)
    img = torch.randn((4, cfg.n_image_tokens, cfg.d_model),
                      generator=torch.Generator(device=device).manual_seed(7),
                      device=device).to(cfg.dtype)
    batch = {"tokens": prompts, "image_embeds": img}
    prefill_step = make_prefill_step(model, max_len=SERVE_MAX_LEN)
    decode_step = make_decode_step(model)
    step_masks = {"prefill": {"causal": G * E, "non-causal": G},
                  "decode": {"causal": 0, "non-causal": 0}}
    launches, seconds = {}, {}

    def counted(name, want, masks, fn):
        """fn() with the counts set to 0 just before and read just
        after, held to exactly ``want`` launches and ``masks`` B1 calls
        by mask."""
        tally = {"causal": 0, "non-causal": 0}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with counting_masks(tally):
            out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[f"vlm {name}"] = n = read_counts()
        print(f"vlm {name} launches: {n}; B1 calls by mask {tally}")
        check(n == want and tally == masks,
              f"vlm {name}: launches {n} and B1 calls {tally}, want "
              f"exactly {want} and {masks}")
        return out

    def decode_loop(logits, cache):
        toks = []
        for _ in range(N_NEW):
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
            logits, cache = decode_step(engine.params, cache, toks[-1])
        return torch.cat(toks, 1).cpu().numpy()

    torch.cuda.reset_peak_memory_stats()
    logits, cache = counted("prefill step (images)",
                            step_launches(L, 1, 0), step_masks["prefill"],
                            lambda: prefill_step(engine.params, batch))
    first = logits.float()
    with_images = counted(f"{N_NEW} decode steps", step_launches(L, 0, N_NEW),
                          step_masks["decode"],
                          lambda: decode_loop(logits, cache))
    del logits, cache
    zero_images = counted("generate (zero images)",
                          step_launches(L, 1, N_NEW), step_masks["prefill"],
                          lambda: engine.generate(prompts, N_NEW))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"vlm: peak {peak_gb:.2f} GB (set-up {setup_peak_gb:.2f}) beside "
          f"the dry-run's {dry['need_gb']:.2f} GB and the hand-set "
          f"{param_gb(cfg) + VLM_HEADROOM_GB:.2f} GB")
    check(with_images.shape == (4, N_NEW)
          and ((with_images >= 0) & (with_images < V)).all(),
          f"vlm tokens with images {with_images.shape}")
    check(zero_images.shape == (4, 512 + N_NEW)
          and np.array_equal(zero_images[:, :512], prompts)
          and ((zero_images[:, 512:] >= 0) & (zero_images[:, 512:] < V)).all(),
          f"vlm generate tokens {zero_images.shape}")
    # the image path is live at full width: the images move the first
    # logits by more than the kernels' rounding does
    zero_first, _ = engine._prefill(prompts)
    image_effect = rel_l2(first, zero_first.float())
    differ = float((with_images != zero_images[:, 512:]).mean())
    print(f"vlm: the images move the prefill logits by rel L2 "
          f"{image_effect:.3g} against the zero images (must exceed "
          f"{LOGITS_REL_L2}); {differ:.3f} of the greedy tokens differ")
    check(bool(torch.isfinite(first).all()), "non-finite vlm logits")
    check(image_effect > LOGITS_REL_L2,
          "vlm: the image embeddings do not reach the logits")

    # the kernel path against the plain path, teacher-forced
    feed = [torch.as_tensor(rng.randint(1, V, size=(4, 1)), device=device)
            for _ in range(4)]

    def forced():
        logits, cache = prefill_step(engine.params, batch)
        out = [logits.float()]
        for tok in feed:
            logits, cache = decode_step(engine.params, cache, tok)
            out.append(logits.float())
        return torch.cat(out, dim=1)

    records = []
    with recording_attention(records):
        fast = forced()
    with plain_attention():
        slow = forced()
    check(bool(torch.isfinite(fast).all()), "non-finite vlm logits")
    whole = rel_l2(fast, slow)
    agree = (fast.argmax(-1) == slow.argmax(-1)).float().mean().item()
    cross = [g * (E + 1) for g in range(G)]      # layer order: cross, selfs
    check(all(records[i][4] is not None for i in cross)
          and sum(r[4] is not None for r in records) == 5 * G,
          "vlm: the recorded cross-attention calls are not the cross blocks")
    per_layer = moe_attention_layers(records, cfg)
    fault_layer = cross[-1]
    faulted = moe_attention_layers(records, cfg, fault_layer,
                                   (last_key_dropped, one_row_short))
    del records
    print(f"vlm kernel vs plain (prefill + 4 decode steps): whole-path bf16 "
          f"logits rel L2 {whole:.3g} (not gated), argmax agreement "
          f"{agree:.3f}; each layer's attention sublayer rel L2 "
          f"{[f'{r:.3g}' for r in per_layer]} (cross blocks {cross}; limit "
          f"{MOE_ATTN_REL_L2})")
    print(f"  planted fault in cross block {fault_layer}'s plain attention "
          f"(the last of {cfg.n_image_tokens} image keys dropped): "
          f"{[f'{r:.3g}' for r in faulted]}, rejected "
          f"{faulted[fault_layer] > MOE_ATTN_REL_L2}")
    check(max(per_layer) <= MOE_ATTN_REL_L2,
          "vlm: an attention sublayer's kernel path disagrees with its plain "
          "path")
    check(faulted[fault_layer] > MOE_ATTN_REL_L2,
          "vlm: the attention limit passes a planted fault dropping the last "
          "image key")

    prefill_runs, decode_ms, profile = timed_steps(
        engine, prompts, prefill=lambda: prefill_step(engine.params, batch))
    step = profile["decode_step"]
    b3 = step and step["b3_kernels_per_step"]
    check(b3 == L, f"vlm decode step: {b3} B3 device kernels, not one for "
                   f"each of {L} calls")
    return launches, {
        "model": f"llama-3.2-vision-90b at full width, {L} of 100 layers "
                 f"({G} groups of a cross block and {E} self blocks; d=8192, "
                 f"64 heads, 8 KV heads, d_ff 28672, vocab 128256, "
                 f"{cfg.n_image_tokens} image tokens), random bf16 params, "
                 f"gates {VLM_GATE}",
        "card": card, "params_b": cfg.param_count() / 1e9,
        "params_gb": param_gb(cfg), "init_s": init_s,
        "free_gb_before": free_gb, "total_gb": total_gb,
        "prefill_ms": min(prefill_runs), "prefill_ms_runs": prefill_runs,
        "prefill_shape": "B=4 S=512, images (4, 1600, 8192)",
        "decode_ms_per_step": decode_ms, "decode_batch": 4,
        "prefill_and_decode_s": seconds["prefill step (images)"]
        + seconds[f"{N_NEW} decode steps"],
        "generate_s": seconds["generate (zero images)"],
        "generate_tokens_per_s": 4 * N_NEW / seconds["generate (zero images)"],
        "decode_tokens_per_s": 4 / (decode_ms / 1e3),
        "peak_memory_gb": peak_gb, "setup_peak_memory_gb": setup_peak_gb,
        "setup_above_base_gb": setup_gb, "dryrun_setup_gb": dry["setup_gb"],
        "dryrun_prefill_gb": dry["prefill_gb"],
        "dryrun_need_gb": dry["need_gb"],
        "hand_set_need_gb": param_gb(cfg) + VLM_HEADROOM_GB,
        "image_effect_logits_rel_l2": image_effect,
        "image_changes_tokens_share": differ,
        "whole_path_logits_rel_l2": whole, "argmax_agreement": agree,
        "attention_layer_rel_l2": per_layer, "cross_layers": cross,
        "planted_fault_layer_rel_l2": faulted, "launches": launches,
        "profile": profile}


def kv_serving(device, card, arch, scheduler: bool) -> tuple:
    """A dense-path (dense or audio) config at full width: generate
    (uniform and ragged) and, with ``scheduler``, ``RequestScheduler`` over
    ``TPServeEngine(world=None)``, each with exactly L B1 a prefill or
    admission and L B3 a decode step; the serving logits, kernel path
    against plain path, gated; step times and the profile. Returns
    (launches by path, the line's entry)."""
    cfg = arch.config()
    L, V, name = cfg.n_layers, cfg.vocab, cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN, device=device)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"setup: {name} ({cfg.family}, {L} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params) initialised and cast to "
          f"bf16 in {init_s:.1f} s")
    rng = np.random.RandomState(11)
    prompts = rng.randint(1, V, size=(4, 512)).astype(np.int32)
    paths = {"generate uniform": lambda: engine.generate(prompts, N_NEW),
             "generate ragged": lambda: engine.generate(
                 prompts, N_NEW, prompt_lens=PROMPT_LENS)}
    if scheduler:
        requests = [(rng.randint(1, V, size=int(rng.randint(16, SCHED_PREFILL
                                                             + 1))
                                 ).astype(np.int32), int(rng.randint(8, 33)))
                    for _ in range(SCHED_REQUESTS)]
        tp = TPServeEngine(model, None, world=None, max_len=SERVE_MAX_LEN,
                           local=engine, device=device)
        sched = RequestScheduler(tp, n_slots=SCHED_SLOTS,
                                 prefill_len=SCHED_PREFILL)
        for prompt, n in requests:
            sched.submit(prompt, n)
        paths["scheduler"] = sched.run
    out, seconds, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for path, run in paths.items():
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out[path] = run()
        torch.cuda.synchronize()
        seconds[path] = time.perf_counter() - t0
        launches[f"{name} {path}"] = n = read_counts()
        steps = (SCHED_REQUESTS, sched.decode_steps) \
            if path == "scheduler" else (1, N_NEW)
        want = step_launches(L, *steps)
        print(f"{name} {path} launches: {n}")
        check(n == want, f"{name} {path}: launches {n}, want exactly {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for path in ("generate uniform", "generate ragged"):
        toks = out[path]
        check(toks.shape == (4, 512 + N_NEW)
              and np.array_equal(toks[:, :512], prompts)
              and ((toks[:, 512:] >= 0) & (toks[:, 512:] < V)).all(),
              f"{name} {path} tokens {toks.shape}")
    check(np.array_equal(out["generate ragged"][3],
                         out["generate uniform"][3]),
          f"{name}: the full-length ragged row differs from the uniform run")
    if scheduler:
        for r, (prompt, n) in zip(sched.requests, requests):
            check(r.state == "done" and len(r.tokens) == n
                  and all(0 <= t < V for t in r.tokens),
                  f"{name} request {r.rid}: {r.state} with "
                  f"{len(r.tokens)}/{n} tokens")

    feed = [torch.as_tensor(rng.randint(1, V, size=(4, 1)), device=device)
            for _ in range(4)]
    fast = teacher_forced(engine, prompts, feed)
    with plain_attention():
        slow = teacher_forced(engine, prompts, feed)
    check(bool(torch.isfinite(fast).all()), f"non-finite {name} logits")
    rel = rel_l2(fast, slow)
    agree = (fast.argmax(-1) == slow.argmax(-1)).float().mean().item()
    print(f"{name} kernel vs plain (prefill + 4 decode steps, bf16 logits): "
          f"rel L2 {rel:.3g} (limit {LOGITS_REL_L2}), argmax agreement "
          f"{agree:.3f}")
    check(rel <= LOGITS_REL_L2,
          f"{name}: the kernel path disagrees with the plain path")

    prefill_runs, decode_ms, profile = timed_steps(engine, prompts)
    step = profile["decode_step"]
    b3 = step and step["b3_kernels_per_step"]
    check(b3 == L, f"{name} decode step: {b3} B3 device kernels, not one "
                   f"for each of {L} calls")
    t_gen = seconds["generate uniform"]
    entry = {"model": f"{name} ({cfg.family}, {L} layers, d={cfg.d_model}, "
                      f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, hd "
                      f"{cfg.hd}, d_ff {cfg.d_ff}, {cfg.act}, vocab "
                      f"{cfg.vocab}), random bf16 weights",
             "card": card, "params_b": cfg.param_count() / 1e9,
             "init_s": init_s,
             "prefill_ms": min(prefill_runs), "prefill_ms_runs": prefill_runs,
             "prefill_shape": "B=4 S=512",
             "decode_ms_per_step": decode_ms, "decode_batch": 4,
             "generate_uniform_s": t_gen,
             "generate_ragged_s": seconds["generate ragged"],
             "generate_tokens_per_s": 4 * N_NEW / t_gen,
             "decode_tokens_per_s": 4 / (decode_ms / 1e3),
             "peak_memory_gb": peak_gb,
             "logits_rel_l2_kernel_vs_plain": rel, "argmax_agreement": agree,
             "launches": launches, "profile": profile}
    if scheduler:
        n_tokens = sum(n for _, n in requests)
        entry.update(scheduler_s=seconds["scheduler"],
                     scheduler_tokens_per_s=n_tokens / seconds["scheduler"],
                     scheduler_decode_steps=sched.decode_steps)
    return launches, entry


def families(device, card) -> tuple:
    """The vlm and audio families and the remaining dense configs: the
    float32 smoke models on the card against the CPU (musicgen-medium,
    starcoder2-3b and deepseek-67b serving ragged prompts, the vlm's
    greedy loop over images and its 3 train steps), then
    llama-3.2-vision, musicgen-medium and starcoder2-3b at full width.
    Returns (launches by path, the families line)."""
    t0 = time.perf_counter()
    small_model_matches_cpu(device, ((musicgen_medium, [16, 5, 11]),
                                     (starcoder2_3b, [16, 5, 11]),
                                     (deepseek_67b, [16, 5, 11])))
    small_vlm_matches_cpu(device)
    small_train_matches_cpu(
        device, llama32_vision_90b.smoke_config(dtype=torch.float32))
    launches, line = {}, {}
    n, line["llama-3.2-vision-90b"] = vlm_full_width(device, card)
    launches.update(n)
    gc.collect()
    torch.cuda.empty_cache()
    for arch, scheduler in ((musicgen_medium, True), (starcoder2_3b, False)):
        n, entry = kv_serving(device, card, arch, scheduler)
        launches.update(n)
        line[arch.config().name] = entry
        gc.collect()
        torch.cuda.empty_cache()
    line["wall_s"] = time.perf_counter() - t0
    print(f"families phase: {line['wall_s']:.1f} s")
    return launches, {"families": line}


# ---------------------------------------------------------------------------
# the launch phase: the launch tooling and remat "dots" on the card
# ---------------------------------------------------------------------------

# (a) the hook dry-run's anchors at full depth, 64 MiB buckets of 1 MiB
# chunks over 8 ranks: (buckets, segments), the reference's numbers
LAUNCH_ANCHORS = {"kimi-k2-1t-a32b": (62059, 63),
                  "starcoder2-15b": (1312, 42)}
# (b) the dry-run's temp bytes of a step against the card's peak over the
# step's own allocations: within 10 % or 64 KiB, whichever is larger (the
# 10 % rules at every step the phase measures, yi-6b's 0.7 MiB decode
# included; the floor keeps a step of a few blocks from failing on the
# allocator's rounding)
MEM_REL, MEM_ABS = 0.10, 64 << 10
LAUNCH_B, LAUNCH_S = 4, 512
REMATS = ("none", "full", "dots")
# one prefill step's exact launches: yi-6b a B1 a layer, zamba2-1.2b a B4
# a Mamba2 block and a B1 a group, rwkv6-3b a B5 a block
LAUNCH_PREFILL = {"yi-6b": {"flash_attention": 32},
                  "zamba2-1.2b": {"ssd_scan": 38, "flash_attention": 6},
                  "rwkv6-3b": {"rwkv6_scan": 32}}


def memory_agrees(predicted: int, measured: int) -> tuple:
    """(within the limit, the limit in bytes) of a predicted step peak."""
    limit = max(MEM_REL * measured, MEM_ABS)
    return abs(predicted - measured) <= limit, limit


def remat_step_launches(remat: str, L: int) -> dict:
    """Exact launches of one train step of an L-layer dense model: B1 once
    a layer, again in the backward under "full" and "dots" (the attention
    kernel's output is recomputed, not kept); B2a and B2b once a layer."""
    want = {n: 0 for n in KERNELS + PLAIN}
    want.update(flash_attention=L if remat == "none" else 2 * L,
                flash_bwd_dq=L, flash_bwd_dkv=L)
    return want


def meta_like(tree):
    """``tree`` with every leaf a meta tensor of its shape and dtype."""
    return unflatten((p, torch.empty_like(t, device="meta"))
                     for p, t in flatten(tree))


def step_peak(run, args) -> tuple:
    """(the step's peak bytes above what was allocated before it, its
    MemoryLog on the card): a warm-up call whose results are freed, then
    one call between ``reset_peak_memory_stats`` and
    ``max_memory_allocated``, then one under a MemoryLog (registering
    ``args``' tensors) for the log's own reading of the same step."""
    out = run()
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    log = DRY.MemoryLog()
    log.register([t for _, t in flatten(args) if torch.is_tensor(t)])
    with log:
        out = run()
        torch.cuda.synchronize()
    del out
    return peak, log


def memory_cell(label, cfg, shape, run, args, params, opt_cfg=None) -> dict:
    """One (b) cell: the dry-run's temp bytes of ``shape``'s step on a
    one-card mesh, traced on meta over the exact params the card runs,
    against the card's peak; fails outside :func:`memory_agrees`."""
    traced = DRY._trace_pass(cfg, shape, make_debug_mesh(1, 1), opt_cfg,
                             params=meta_like(params))
    predicted = traced["memory"]["temp_size_in_bytes"]
    measured, log = step_peak(run, args)
    card_log, card_ops = log.peak(), log.breakdown()
    ok, limit = memory_agrees(predicted, measured)
    cell = {"cell": label, "predicted_bytes": predicted,
            "measured_bytes": measured, "card_log_bytes": card_log,
            "rel_err": (predicted - measured) / measured,
            "limit_bytes": int(limit), "trace_s": traced["trace_s"],
            "peak_by_op": traced["peak_by_op"], "card_peak_by_op": card_ops}
    print(f"launch memory {label}: predicted {predicted / 2**20:.1f} MiB, "
          f"measured {measured / 2**20:.1f} MiB (the MemoryLog on the card "
          f"{card_log / 2**20:.1f}), limit {limit / 2**20:.1f} MiB; at the "
          f"predicted peak (op, bytes, allocations): {traced['peak_by_op']}; "
          f"at the card log's: {card_ops}")
    check(ok, f"launch memory {label}: the dry-run predicts {predicted} "
              f"bytes, the card's step peaked at {measured} (limit "
              f"{limit:.0f})")
    return cell


def launch_remat(device) -> tuple:
    """(b) and (c) on gpt2-124m at full width, 8 x 1024 tokens: the train
    step's memory under each remat against the dry-run's; the loss and
    every gradient under "dots" equal "full"'s bit for bit; each step's
    exact launches; the peaks ordered none > dots > full."""
    cells, launches, peaks, grads = [], {}, {}, {}
    base = gpt2_124m.config()
    L = base.n_layers
    params = build_model(base, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=2, total_steps=10)
    opt = adamw_init(params, opt_cfg)
    tokens = torch.randint(0, base.vocab, (TRAIN_B, TRAIN_S + 1),
                           generator=torch.Generator(device=device)
                           .manual_seed(1), device=device,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    shape = CC.Shape("gpt2 train", TRAIN_S, TRAIN_B, "train")
    for remat in REMATS:
        cfg = dataclasses.replace(base, remat=remat)
        model = build_model(cfg, device=device)
        step = make_train_step(model, opt_cfg)
        zero_counts()
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        one = read_counts()
        del out
        want = remat_step_launches(remat, L)
        check(one == want, f"launch: a {remat} train step launched {one}, "
                           f"want exactly {want}")
        cell = memory_cell(f"gpt2-124m train {remat}", cfg, shape,
                           lambda: step(params, opt, batch),
                           {"p": params, "o": opt, "b": batch}, params,
                           opt_cfg)
        launches[remat] = read_counts()   # the step above and 3 more
        check(launches[remat] == {n: 4 * c for n, c in want.items()},
              f"launch: 4 {remat} train steps launched {launches[remat]}")
        cells.append(cell)
        peaks[remat] = cell["measured_bytes"]
        if remat != "none":
            grads[remat] = value_and_grad(model, params, batch)
    (loss_f, g_f), (loss_d, g_d) = grads["full"], grads["dots"]
    same = bool(torch.equal(loss_f, loss_d)) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(flatten(g_f),
                                                      flatten(g_d)))
    check(same, "launch: remat dots's loss or gradients differ from full's")
    check(peaks["none"] > peaks["dots"] > peaks["full"],
          f"launch: train-step peaks {peaks} are not ordered none > dots > "
          f"full")
    return cells, launches, {"dots_equals_full_bitwise": same,
                             "peak_bytes": peaks,
                             "launches_per_step": {
                                 r: {n: c // 4 for n, c in launches[r].items()
                                     if c} for r in REMATS}}


def launch_serving_cells(device) -> tuple:
    """(b) for yi-6b prefill (B=4 x 512) and decode (one step at B=4 with
    a 544-row cache), zamba2-1.2b and rwkv6-3b prefill (B=4 x 512), at
    full width with bf16 params: each step's memory against the dry-run's,
    with its launches counted."""
    cells, launches = [], {}
    gen = np.random.RandomState(7)
    for label, mod in (("yi-6b", yi_6b), ("zamba2-1.2b", zamba2_1p2b),
                       ("rwkv6-3b", rwkv6_3b)):
        cfg = mod.config(param_dtype=torch.bfloat16)
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        tokens = torch.as_tensor(gen.randint(1, cfg.vocab, (LAUNCH_B,
                                                            LAUNCH_S)),
                                 dtype=torch.int32, device=device)
        prefill = make_prefill_step(model)
        zero_counts()
        cells.append(memory_cell(
            f"{label} prefill", cfg,
            CC.Shape("prefill", LAUNCH_S, LAUNCH_B, "prefill"),
            lambda: prefill(params, {"tokens": tokens}),
            {"p": params, "t": tokens}, params))
        n = launches[f"launch {label} prefill (3 steps)"] = read_counts()
        want = {k: 3 * c for k, c in LAUNCH_PREFILL[label].items()}
        check(n == dict({k: 0 for k in n}, **want),
              f"launch: 3 {label} prefill steps launched {n}, want {want}")
        if label == "yi-6b":
            # the meta branch sizes B3's workspace by decode.cu's formula
            for shape in ((4, 32, 4, SERVE_MAX_LEN, 128),
                          (4, 64, 8, VLM_IMAGE_TOKENS, 128),
                          (4, 24, 2, SERVE_MAX_LEN, 128),
                          (4, 32, 32, SERVE_MAX_LEN, 64)):
                check(DO.workspace_floats(*shape)
                      == DO._workspace_floats(*shape),
                      f"launch: B3's workspace at {shape}: the meta "
                      f"branch's {DO.workspace_floats(*shape)} floats, "
                      f"the library's {DO._workspace_floats(*shape)}")
            _, cache = make_prefill_step(model, max_len=SERVE_MAX_LEN)(
                params, {"tokens": tokens})
            decode = make_decode_step(model)
            new = tokens[:, -1:]
            zero_counts()
            cells.append(memory_cell(
                f"{label} decode", cfg,
                CC.Shape("decode", SERVE_MAX_LEN, LAUNCH_B, "decode"),
                lambda: decode(params, cache, new)[0],
                {"p": params, "c": cache, "t": new}, params))
            n = launches[f"launch {label} decode (3 steps)"] = read_counts()
            want = {"decode_attention": 3 * cfg.n_layers}
            check(n == dict({k: 0 for k in n}, **want),
                  f"launch: 3 {label} decode steps launched {n}")
            del cache
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return cells, launches


def launch_dtensor(device) -> dict:
    """(d) gpt2-124m's params distributed by their ``param_specs`` over a
    one-rank NCCL group (``dist.HashStore``: no port, no network) on a
    (1, 1) device mesh; each local shard equals its param bit for bit."""
    import torch.distributed as dist
    cfg = gpt2_124m.config()
    params = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    mesh = make_debug_mesh(1, 1)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    try:
        dmesh = device_mesh(mesh, "cuda")
        specs = SHD.param_specs(cfg, params, mesh)
        dt = SHD.distribute(params, specs, dmesh)
        equal = all(torch.equal(d.to_local(), p) for (_, d), (_, p) in
                    zip(flatten(dt), flatten(params)))
        n = len(flatten(dt))
    finally:
        dist.destroy_process_group()
    check(equal, "launch: a DTensor's local shard differs from its param")
    return {"leaves": n, "local_shards_equal": equal,
            "mesh": dict(mesh.shape)}


def launch(device, card) -> tuple:
    """The launch phase: (a) the hook dry-run's anchors; (b) each step's
    memory, the dry-run's prediction against the card; (c) remat "dots"
    on gpt2-124m; (d) DTensor shards on a one-rank group. Returns
    (launches by path, the launch line)."""
    t0 = time.perf_counter()
    anchors = {}
    for arch, want in LAUNCH_ANCHORS.items():
        r = readiness_report(arch)
        anchors[arch] = {"buckets": r["n_buckets"],
                         "segments": r["n_segments"]}
        check((r["n_buckets"], r["n_segments"]) == want,
              f"launch: {arch}'s readiness report {anchors[arch]}, want "
              f"{want}")
    print(f"launch anchors: {anchors}")
    cells, launches, remat = launch_remat(device)
    gc.collect()
    torch.cuda.empty_cache()
    more, serving = launch_serving_cells(device)
    cells += more
    launches_by_path = {f"launch gpt2 train {r} (4 steps)": launches[r]
                        for r in REMATS}
    launches_by_path.update(serving)
    dtensor = launch_dtensor(device)
    line = {"launch": {"card": card, "anchors": anchors, "memory": cells,
                       "remat": remat, "dtensor": dtensor,
                       "wall_s": time.perf_counter() - t0}}
    return launches_by_path, line


# ---------------------------------------------------------------------------
# the examples phase: the port's own entry points, as a user runs them
# ---------------------------------------------------------------------------

# train_ddp_shift: gpt2-124m at full width, 2 ranks x 4 x 512 tokens,
# host1/mlx5_0 killed after step 3; then the same with --baseline
EX_DDP_ARGV = ["--full", "--steps", "6", "--fail-at", "3"]
EX_DDP_STEPS, EX_DDP_RANKS, EX_DDP_TOKENS = 6, 2, 4 * 512
# serve_decode's defaults: 4 prompts of 16 tokens, 24 new tokens; its
# cache holds 41 rows, and its decode steps attend over 17 to 40 of them
EX_BATCH, EX_PROMPT, EX_GEN = 4, 16, 24
EX_MAX_LEN = EX_PROMPT + EX_GEN + 1
EX_LENS = [EX_PROMPT + 1, 24, 33, EX_PROMPT + EX_GEN]


def example_names(archs) -> str:
    return archs[0] + (f" and {len(archs) - 1} more" if archs[1:] else "")


def example_heads() -> dict:
    """The (query heads, K/V heads, head dim) of the self-attention of
    every arch's smoke model that has one, each with its archs."""
    heads = {}
    for arch in CC.list_archs():
        cfg = CC.smoke_config(arch)
        if cfg.family != "rwkv6":
            heads.setdefault((cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                             []).append(arch)
    return heads


def example_serve_launches(cfg, prefills: int, decodes: int) -> dict:
    """The exact launches of ``prefills`` prefills and ``decodes`` decode
    steps of ``cfg``'s model: one B1 an attention layer (a vlm's cross
    blocks too) and prefill, one B3 an attention layer and decode step;
    a hybrid's B4 a Mamba2 block and prefill, its shared attention once a
    group; rwkv6's B5 a block and prefill and nothing a decode step."""
    if cfg.family == "hybrid":
        return dict(step_launches(hybrid_layout(cfg)[0], prefills, decodes),
                    ssd_scan=cfg.n_layers * prefills)
    if cfg.family == "rwkv6":
        return dict(step_launches(0, 0, 0), rwkv6_scan=cfg.n_layers * prefills)
    groups, selfs = vlm_layout(cfg) if cfg.family == "vlm" \
        else (cfg.n_layers, 0)
    return step_launches(groups * (1 + selfs), prefills, decodes)


def serve_example_faults(cfg, tokens, stats, cpu_stats, launches,
                         tp: bool) -> list:
    """What is wrong with one ``serve_decode`` run at its defaults: its
    tokens, its launches (one generate, with ``tp`` two: the local run
    and the TP run) and, with ``tp``, its TP line against the same run's
    on the CPU (``cpu_stats``: sync rounds and peak live collectives come
    from the virtual clock) and its reconstructions."""
    faults = []
    runs = 2 if tp else 1
    want = example_serve_launches(cfg, runs, runs * EX_GEN)
    if launches != want:
        faults.append(f"launches {launches}, want exactly {want}")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(EX_BATCH, EX_PROMPT))
    if tokens.shape != (EX_BATCH, EX_PROMPT + EX_GEN) \
            or not np.array_equal(tokens[:, :EX_PROMPT], prompts) \
            or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        faults.append(f"tokens {tokens.shape}: not the prompts and "
                      f"{EX_GEN} tokens in [0, {cfg.vocab})")
    if not tp:
        if stats is not None:
            faults.append(f"TP statistics without --tp: {stats}")
        return faults
    if stats is None or stats["reconstruction_mismatches"]:
        faults.append(f"TP run: {stats}")
        return faults
    for key in ("sync_rounds", "peak_live_collectives"):
        if stats[key] != cpu_stats[key]:
            faults.append(f"TP line: {key} {stats[key]} on the card, "
                          f"{cpu_stats[key]} on the CPU")
    return faults


# the planted faults of the examples' logits check, by the kernel they
# stand in for: the prefill's causal edge one key late (B1), a decode step
# one cache row short (B3), the SSD scan and the RWKV6 scan (B4, B5)
EX_KEY_LATE = "prefill: the causal edge one key late"
EX_ROW_SHORT = "decode: one cache row short"
EX_SSD_FAULT = "output read from the state before the step"
EX_RWKV_FAULT = "bonus u left out"


def example_faults(cfg) -> list:
    """The planted faults of ``cfg``'s serve path: one for each kernel it
    runs."""
    if cfg.family == "rwkv6":
        return [EX_RWKV_FAULT]
    return [EX_KEY_LATE, EX_ROW_SHORT] \
        + ([EX_SSD_FAULT] if cfg.family == "hybrid" else [])


def late_edge(q, k, v, causal=True, scale=None):
    """The plain prefill attention, its causal edge one key late (the
    cross blocks' non-causal attention as it is)."""
    return one_key_late(q, k, v) if causal \
        else plain_train(q, k, v, causal, scale)


@contextmanager
def example_plain(fault=None):
    """Every kernel of a serve path (B1, B3, B4, B5) swapped for its plain
    version, with one planted ``fault`` of example_faults() if named."""
    with plain_attention(late_edge if fault == EX_KEY_LATE else plain_train,
                         one_row_short if fault == EX_ROW_SHORT
                         else DR.decode_attention_ref), \
            scan_swapped(scan_route(EX_SSD_FAULT if fault == EX_SSD_FAULT
                                    else None)), \
            swapped("rwkv6_scan", fault_route(EX_RWKV_FAULT)
                    if fault == EX_RWKV_FAULT else RR.rwkv6_scan_ref):
        yield


def example_logits(cfg, tokens, device) -> dict:
    """A ``serve_decode`` run of ``cfg`` again, on a new engine with the
    same params, teacher-forced with the run's ``tokens``: the kernel
    path's bf16 logits (a prefill and EX_GEN decode steps) against the
    plain path's, the kernel path's greedy tokens against ``tokens``, and
    the plain path with each planted fault against the plain path."""
    engine = ServeEngine(build_model(cfg, device=device),
                         EX_SERVE.smoke_params(cfg), max_len=EX_MAX_LEN,
                         device=device)
    prompts = tokens[:, :EX_PROMPT]
    feed = [torch.as_tensor(tokens[:, i:i + 1], device=device)
            for i in range(EX_PROMPT, EX_PROMPT + EX_GEN)]
    fast = teacher_forced(engine, prompts, feed)
    with example_plain():
        slow = teacher_forced(engine, prompts, feed)
    greedy = fast[:, :EX_GEN].argmax(-1).cpu().numpy()
    reading = {"rel_l2": rel_l2(fast, slow),
               "finite": bool(torch.isfinite(fast).all()),
               "greedy_tokens_differ":
                   int((greedy != tokens[:, EX_PROMPT:]).sum()),
               "faults": {}}
    for fault in example_faults(cfg):
        with example_plain(fault):
            reading["faults"][fault] = rel_l2(
                teacher_forced(engine, prompts, feed), slow)
    return reading


def example_logits_faults(reading) -> list:
    """What is wrong with an example_logits() reading: non-finite logits,
    a kernel path off its plain path by more than LOGITS_REL_L2, greedy
    tokens that are not the run's, or a planted fault within the limit."""
    faults = []
    if not reading["finite"]:
        faults.append("non-finite logits")
    if not reading["rel_l2"] <= LOGITS_REL_L2:
        faults.append(f"kernel vs plain logits rel L2 {reading['rel_l2']:.3g}"
                      f" > {LOGITS_REL_L2}")
    if reading["greedy_tokens_differ"]:
        faults.append(f"{reading['greedy_tokens_differ']} of the run's "
                      f"tokens are not the kernel path's greedy tokens")
    for fault, rel in reading["faults"].items():
        if not rel > LOGITS_REL_L2:
            faults.append(f"planted fault '{fault}' not rejected: rel L2 "
                          f"{rel:.3g}")
    return faults


def ddp_example_launches(run, L: int) -> dict:
    """The exact launches of a ``train_ddp_shift`` run of an L-layer model
    (remat "full"): every rank's forward and backward of each step it
    computed, a timeline entry each, and one more a restart (the crash's
    step computed its gradients before the all-reduce failed)."""
    computed = (len(run.timeline) + run.restarts) * EX_DDP_RANKS
    return {k: v * computed
            for k, v in remat_step_launches("full", L).items()}


def ddp_example_faults(run, launches, baseline: bool, L: int,
                       steps: int = EX_DDP_STEPS) -> list:
    """What is wrong with a ``train_ddp_shift`` run of ``steps`` steps:
    its launches, its losses, and its fault accounting (SHIFT: >= 1
    fallback, no restart, each step once; the baseline: one restart, no
    fallback, the run reaching ``steps``)."""
    faults = []
    want = ddp_example_launches(run, L)
    if launches != want:
        faults.append(f"launches {launches}, want exactly {want}")
    losses = _losses(run)
    if not all(np.isfinite(losses)):
        faults.append(f"losses {losses}")
    seen = [s for _, s, _ in run.timeline]
    if run.final_step != steps or seen[-1:] != [steps]:
        faults.append(f"final step {run.final_step}, timeline steps "
                      f"{seen}, want {steps}")
    if baseline:
        if run.restarts != 1 or run.fallbacks != 0:
            faults.append(f"baseline: {run.restarts} restarts, "
                          f"{run.fallbacks} fallbacks; want 1 and 0")
    elif run.fallbacks < 1 or run.restarts != 0 \
            or seen != list(range(1, steps + 1)):
        faults.append(f"SHIFT: {run.fallbacks} fallbacks, {run.restarts} "
                      f"restarts, timeline steps {seen}")
    return faults


def examples(device, card) -> tuple:
    """The port's entry points, each through its ``main(argv)`` on the
    card with the launch counts set to 0 just before and read just after:
    (a) ``train_ddp_shift --full`` (gpt2-124m at full width, a NIC killed),
    (b) the same with ``--baseline``, (c) ``serve_decode`` for each of the
    11 archs at its defaults, ``--tp`` for the KV-cache families, whose TP
    line is held to the same run's on the CPU; each run's logits,
    teacher-forced with its own tokens, are held to the plain path's, with
    planted faults rejected (example_logits). Returns (launches by path,
    the examples line)."""
    t0 = time.perf_counter()
    cfg = gpt2_124m.config()
    launches, line = {}, {"card": card}
    for label, extra in (("train_ddp_shift --full", []),
                         ("train_ddp_shift --full --baseline",
                          ["--baseline"])):
        argv = EX_DDP_ARGV + extra + ["--device", "cuda"]
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        run = EX_TRAIN.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[f"examples {label}"] = n = read_counts()
        faults = ddp_example_faults(run, n, bool(extra), cfg.n_layers)
        computed = len(run.timeline) + run.restarts
        entry = {"argv": argv, "wall_s": wall,
                 "tokens_per_s": computed * EX_DDP_RANKS * EX_DDP_TOKENS
                 / wall,
                 "steps_computed": computed, "fallbacks": run.fallbacks,
                 "restarts": run.restarts, "recoveries": run.recoveries,
                 "step_grad_ms": [x * 1e3 for x in run.step_grad_times],
                 "losses": _losses(run), "launches": n}
        print(f"examples {label}: {json.dumps(entry)}")
        check(not faults, f"examples {label}: " + "; ".join(faults))
        line[label] = entry
        del run
        gc.collect()
        torch.cuda.empty_cache()

    serve = {}
    for arch in CC.list_archs():
        scfg = CC.smoke_config(arch)
        tp = scfg.family in KV_CACHE_FAMILIES
        argv = ["--arch", arch] + (["--tp"] if tp else [])
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        tokens, stats = EX_SERVE.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches[f"examples serve_decode {arch}"] = n = read_counts()
        cpu_stats = None
        if tp:
            with redirect_stdout(io.StringIO()):
                cpu_stats = EX_SERVE.main(argv + ["--device", "cpu"])[1]
        faults = serve_example_faults(scfg, tokens, stats, cpu_stats, n, tp)
        logits = example_logits(scfg, tokens, device)
        faults += example_logits_faults(logits)
        serve[arch] = {"argv": argv, "wall_s": wall,
                       "tokens_per_s": (2 if tp else 1) * EX_BATCH * EX_GEN
                       / wall,
                       "tp": stats, "tp_cpu": cpu_stats, "launches": n,
                       "logits": logits}
        print(f"examples serve_decode {arch}: {json.dumps(serve[arch])}")
        check(not faults, f"examples serve_decode {arch}: "
                          + "; ".join(faults))
    line["serve_decode"] = serve
    line["wall_s"] = time.perf_counter() - t0
    print(f"examples phase: {line['wall_s']:.1f} s on {card}")
    return launches, {"examples": line}


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
    t_start = time.perf_counter()
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
    launches["campaign (card runs)"], campaign_line = campaign(device, card)
    torch.cuda.empty_cache()
    moe_launches, moe_line, moe_engine = moe(device, card)
    launches.update(moe_launches)
    launches["serving campaign (card runs)"], serving_campaign_line = \
        serving_campaign(device, card, moe_engine.model, moe_engine)
    del moe_engine
    gc.collect()
    torch.cuda.empty_cache()
    kimi_launches, kimi_line = kimi(device, card)
    launches.update(kimi_launches)
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
    f_launches, families_line = families(device, card)
    launches.update(f_launches)
    torch.cuda.empty_cache()
    l_launches, launch_line = launch(device, card)
    launches.update(l_launches)
    gc.collect()
    torch.cuda.empty_cache()
    e_launches, examples_line = examples(device, card)
    launches.update(e_launches)
    gc.collect()
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
    print(json.dumps(campaign_line))
    print(json.dumps(moe_line))
    print(json.dumps(kimi_line))
    print(json.dumps(serving_campaign_line))
    print(json.dumps(families_line))
    print(json.dumps(launch_line))
    print(json.dumps(examples_line))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all on "
          f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
