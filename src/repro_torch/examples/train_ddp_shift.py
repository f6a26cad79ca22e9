"""End-to-end example: data-parallel LM training with SHIFT-protected
gradient all-reduce, surviving a fatal NIC failure mid-run.

Default is a fast reduced model; ``--full`` trains the paper's GPT-2 124M
for ``--steps`` (a few hundred) steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_ddp_shift [--full]
          [--steps N] [--fail-at K] [--baseline] [--device cpu]

``--device`` is ``cuda`` by default and raises without a card. The
checkpoints go to a fresh temporary directory, removed at the end of the
run.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from .. import configs as C
from .. import resolve_device
from ..collectives import JcclWorld
from ..core import shift as S
from ..core.fabric import build_cluster
from ..train.trainer import (DDPTrainer, RestartNeeded, TrainerConfig,
                             TrainRun, resume_training)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    """Parse the flags, train with host1/mlx5_0 killed after step
    ``--fail-at`` (the baseline crashes there and restarts from its last
    checkpoint on fresh ranks), print the run and return its
    :class:`~repro_torch.train.trainer.TrainRun`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="GPT-2 124M (slow on CPU) instead of the reduced model")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--channels", type=int, default=1,
                    help="stripe gradient collectives across N rails "
                         "(multi-rail channelized JCCL)")
    ap.add_argument("--baseline", action="store_true",
                    help="StandardLib (crash + checkpoint-restart) instead "
                         "of SHIFT")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (200 if args.full else 60)
    fail_at = args.fail_at or steps // 3

    cluster = build_cluster(n_hosts=args.ranks,
                            nics_per_host=max(2, args.channels))
    if args.baseline:
        libs = [S.StandardLib(cluster, f"host{r}") for r in range(args.ranks)]
    else:
        kv = None
        libs = []
        for r in range(args.ranks):
            lib = S.ShiftLib(cluster, f"host{r}", kv=kv,
                             config=S.ShiftConfig(
                                 data_rails=max(1, args.channels)))
            kv = lib.kv
            libs.append(lib)
    world = JcclWorld(cluster, libs, max_chunk_bytes=1 << 20,
                      channels=args.channels)

    model_cfg = (C.get_config("gpt2-124m") if args.full else
                 C.smoke_config("gpt2-124m", n_layers=4, d_model=256,
                                n_heads=8, n_kv_heads=8, d_ff=1024,
                                vocab=2048))
    with tempfile.TemporaryDirectory(prefix="repro-train-ddp-") as ckpt_dir:
        tcfg = TrainerConfig(steps=steps, ckpt_every=max(steps // 5, 5),
                             ckpt_dir=ckpt_dir)
        trainer = DDPTrainer(cluster, libs, model_cfg, tcfg,
                             batch_per_rank=4 if args.full else 2,
                             seq_len=512 if args.full else 64,
                             device=device)

        killed = False

        def on_step(step, t, loss):
            # the NIC fails once: a restarted baseline that runs step
            # fail_at again finds it recovered (the reference kills it
            # again there and crashes a second time)
            nonlocal killed
            if step == fail_at and not killed:
                killed = True
                print(f">>> step {step}: killing host1/mlx5_0")
                cluster.fail_nic("host1/mlx5_0")
            if step % 10 == 0 or step == 1:
                print(f"step {step:4d}  t={t:8.2f}s  loss={loss:.4f}")

        try:
            run = trainer.train(world, on_step=on_step)
        except RestartNeeded as rn:
            print(">>> job crashed (baseline); restarting from checkpoint "
                  f"(step {rn.step}, +{tcfg.reschedule_time}s reschedule)")
            cluster.recover_nic("host1/mlx5_0")
            libs2 = [S.StandardLib(cluster, f"host{r}")
                     for r in range(args.ranks)]
            world2 = JcclWorld(cluster, libs2, max_chunk_bytes=1 << 20,
                               channels=args.channels)
            run = resume_training(trainer, world2, rn, on_step=on_step)

    t_final, final_step, final_loss = run.timeline[-1]
    print(f"\ndone: {final_step} steps in {t_final:.1f}s (combined "
          f"compute+network), final loss {final_loss:.4f}")
    print(f"restarts={run.restarts} fallbacks={run.fallbacks} "
          f"recoveries={run.recoveries} "
          f"slowdown={run.slowdown_reschedule + run.slowdown_retrain:.1f}s")
    return run


if __name__ == "__main__":
    main()
