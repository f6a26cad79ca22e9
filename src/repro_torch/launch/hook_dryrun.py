"""Backward-hook readiness dry-run for giant-model param trees.

The port's counterpart of ``repro.launch.hook_dryrun``: it shows that the
issue-as-produced leaf->bucket schedule
(:class:`repro_torch.train.backward.BackwardScheduler`) scales to the
trillion-parameter configs WITHOUT materializing a single gradient byte.
The param tree is meta tensors of :func:`repro_torch.convert.param_shapes`
(as ``DDPTrainer`` builds it), the bucket bounds come from the standalone
:func:`repro_torch.collectives.aligned_bucket_bounds` (no world needed),
and the report is shape arithmetic: total params, per-segment ready
bursts, first-issue segment.

    python -m repro_torch.launch.hook_dryrun [--arch kimi-k2-1t-a32b]

prints one report per arch (by default kimi-k2-1t-a32b and
starcoder2-15b). Bucket sizing defaults to 64 MiB targets over 1 MiB
engine chunks on an 8-rank world; a 1T-param tree folds into a few tens
of thousands of buckets and the report costs only tree walks and interval
sweeps.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ..collectives import aligned_bucket_bounds
from ..convert import param_shapes
from ..models.lm import flatten, unflatten
from ..train.backward import BackwardScheduler

#: the anchor architectures: a 1T-param MoE and a dense 15B
DEFAULT_ARCHS = ("kimi-k2-1t-a32b", "starcoder2-15b")


def meta_params(cfg) -> Dict[str, object]:
    """``cfg``'s param tree as meta tensors in ``cfg.param_dtype``."""
    return unflatten((path, torch.empty(shape, dtype=cfg.param_dtype,
                                        device="meta"))
                     for path, shape in param_shapes(cfg).items())


def readiness_report(arch: str, bucket_bytes: int = 64 << 20,
                     max_chunk_bytes: int = 1 << 20, n_ranks: int = 8,
                     **overrides) -> Dict[str, object]:
    """Build ``arch``'s leaf->bucket readiness schedule from shapes
    alone and return its stats (plus the config identity).

    ``overrides`` pass through to the arch's ``config()`` — e.g.
    ``n_layers=4`` for a fast structural check in tests."""
    from .. import configs as C

    cfg = C.get_config(arch, **overrides)
    params = meta_params(cfg)
    total = sum(t.numel() for _, t in flatten(params))
    bounds = aligned_bucket_bounds(total, 4, bucket_bytes,
                                   max_chunk_bytes=max_chunk_bytes,
                                   n_ranks=n_ranks)
    sched = BackwardScheduler(params, bounds)
    report = dict(sched.stats())
    report.update({
        "arch": cfg.name,
        "family": cfg.family,
        "n_layers": cfg.n_layers,
        "bucket_bytes": bucket_bytes,
        "max_chunk_bytes": max_chunk_bytes,
        "n_ranks": n_ranks,
        "param_gbytes": round(total * 4 / 2**30, 2),
    })
    return report


def format_report(report: Dict[str, object]) -> str:
    """One human-readable block per arch for the CLI output."""
    return (
        f"## {report['arch']} ({report['family']}, "
        f"{report['n_layers']} layers)\n"
        f"params           : {report['total_params']:,} "
        f"({report['param_gbytes']} GB fp32)\n"
        f"leaves/intervals : {report['n_leaves']} leaves -> "
        f"{report['n_intervals']} per-layer intervals\n"
        f"buckets          : {report['n_buckets']} x "
        f"{report['bucket_bytes'] >> 20} MiB aligned "
        f"({report['max_chunk_bytes'] >> 10} KiB chunks, "
        f"{report['n_ranks']} ranks)\n"
        f"segments         : {report['n_segments']} "
        f"(first issue after segment {report['first_ready_segment']}, "
        f"burst max {report['max_burst']} / "
        f"mean {report['mean_burst']} buckets)\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point: print the readiness report for each requested
    arch (default: kimi-k2-1t-a32b and starcoder2-15b)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", action="append", default=None,
                        help="arch id (repeatable; default: "
                             + ", ".join(DEFAULT_ARCHS))
    parser.add_argument("--bucket-bytes", type=int, default=64 << 20)
    parser.add_argument("--max-chunk-bytes", type=int, default=1 << 20)
    parser.add_argument("--n-ranks", type=int, default=8)
    args = parser.parse_args(argv)
    for arch in (args.arch or DEFAULT_ARCHS):
        report = readiness_report(arch, bucket_bytes=args.bucket_bytes,
                                  max_chunk_bytes=args.max_chunk_bytes,
                                  n_ranks=args.n_ranks)
        print(format_report(report), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
