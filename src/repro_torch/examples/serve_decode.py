"""Batched serving with a KV cache: prefill a batch of prompts and decode
greedily.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--arch yi-6b]
      PYTHONPATH=src python -m repro_torch.examples.serve_decode --tp
      PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

The arch is instantiated at its smoke scale (``configs.smoke_config``);
the full configs are exercised by the launch dry-run. ``--device`` is
``cuda`` by default and raises without a card.

``--tp`` shards the engine across a 2-rank JCCL world (per-step logits
and K/V all-gathers, MoE all-to-alls for moe archs) and checks that the
output is byte-identical to the single-host run: the fabric moves bytes,
it never changes them. Only the KV-cache families (dense, audio, moe)
serve tensor-parallel; the others raise ``ValueError``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .. import configs as C
from .. import resolve_device
from ..models import build_model
from ..serving import ServeEngine, TPServeEngine


def serve(cfg, params, prompts: np.ndarray, n_tokens: int, tp: bool = False,
          channels: int = 1, device="cuda"):
    """Greedy generation of ``n_tokens`` after ``prompts`` (B, S) with
    ``params`` (a tree on any device) on ``device``; with ``tp``, the same
    again over a 2-rank JCCL world of ``channels`` rails, which must give
    the same tokens with no reconstruction mismatch. Returns (tokens (B,
    S + n_tokens), the TP run's statistics or None): ``sync_rounds``,
    ``peak_live_collectives`` and ``reconstruction_mismatches``."""
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    max_len = prompts.shape[1] + n_tokens + 1
    engine = ServeEngine(model, params, max_len=max_len, device=device)
    if tp:
        from ..collectives import build_world
        _, _, world = build_world(n_ranks=2, channels=channels,
                                  probe_interval=5e-4, fast=True)
        # refuses a family with no per-row K/V cache before any work
        tp_engine = TPServeEngine(model, None, world=world, max_len=max_len,
                                  local=engine, device=device)
    out = engine.generate(prompts, n_tokens=n_tokens)
    if not tp:
        return out, None
    tp_out = tp_engine.generate(prompts, n_tokens=n_tokens)
    if not np.array_equal(tp_out, out):
        raise RuntimeError("TP output diverged from local")
    if tp_engine.reconstruction_mismatches:
        raise RuntimeError(f"{tp_engine.reconstruction_mismatches} fabric "
                           f"reconstructions differ from the local bytes")
    return out, {"sync_rounds": tp_engine.sync_rounds,
                 "peak_live_collectives":
                     world.stats_snapshot()["peak_live_collectives"],
                 "reconstruction_mismatches":
                     tp_engine.reconstruction_mismatches}


def smoke_params(cfg):
    """``cfg``'s params drawn from seed 0 on the CPU, so that a seed gives
    the same params on any device."""
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags, draw the smoke model's params from seed 0 on the
    CPU, serve and print. Returns (tokens, the TP statistics or None), as
    :func:`serve`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2-124m", choices=C.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--tp", action="store_true",
                    help="serve tensor-parallel over a 2-rank JCCL world "
                         "and verify byte-identity with the local run")
    ap.add_argument("--channels", type=int, default=1,
                    help="rails to stripe the TP collectives across")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = C.smoke_config(args.arch)
    params = smoke_params(cfg)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    out, stats = serve(cfg, params, prompts, args.gen, tp=args.tp,
                       channels=args.channels, device=device)
    print(f"arch={cfg.name} family={cfg.family}")
    for i, row in enumerate(out):
        print(f"  seq{i}: prompt={row[:args.prompt_len].tolist()} "
              f"-> gen={row[args.prompt_len:].tolist()}")
    print(f"generated {args.batch}x{args.gen} tokens with a "
          f"{cfg.family}-family KV/state cache")
    if stats is not None:
        print(f"TP over 2 ranks x {args.channels} channel(s): "
              f"byte-identical to single-host "
              f"({stats['sync_rounds']} fabric sync rounds, peak "
              f"{stats['peak_live_collectives']} live collectives)")
    return out, stats


if __name__ == "__main__":
    main()
