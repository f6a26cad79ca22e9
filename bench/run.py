"""Run one cell of the port's benchmark on the chips of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It loads, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output (the
compared numbers and their limits also as the last lines of standard
error). It exits non-zero without a result where the machine has no
CUDA device or fewer than the cell asks for, or where the run loaded JAX
or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# kernel and compiler caches at fixed places inside the checkout (the
# port builds its own kernels under build/kernels)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one host thread for PyTorch's and numpy's CPU work: the run's host path
# launches work on the card, and idle worker threads only add noise
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    cell = harness.resolve(harness.load_manifest(), args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bench.measure import measure
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: JAX and the JAX package "
              f"may not be loaded", file=sys.stderr)
        return 3
    for line in harness.checked_lines(out["checked"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], out["device"],
                              out["checked"], out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
