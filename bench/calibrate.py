"""Readings from which a cell's limits are set, many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds 25]
        [--fault train.half_batch --fault-seeds 1,2,3]

For each seed it runs the cell as ``bench/run.py`` does (``--seconds``
long, untraced) and prints the numbers compared with the reference; on a
control seed it also reads the e4m3 reference against the float32 one
(``<name>.control``); on a fault seed it runs again with the fault
planted (``bench/faults.py``). One JSON line a run, on standard output.
The limits in ``bench/limits/`` are set from these readings (see
PERF.md); the benchmark's own runs never plant a fault or run the
control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch
    from bench import faults, harness, program
    cell = harness.resolve(harness.load_manifest(), args.workload)
    kind = harness.load_kind(cell.traffic["kind"])
    device = torch.device("cuda")
    runs = [(s, None) for s in dict.fromkeys(args.seeds + args.control_seeds)]
    runs += [(s, args.fault) for s in args.fault_seeds]
    for seed, fault in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = program.clock()
        if fault is None:
            out = kind.run(cell, seed, args.seconds, False, device, t0,
                           control=seed in args.control_seeds)
        else:
            with faults.FAULTS[fault]():
                out = kind.run(cell, seed, args.seconds, False, device, t0)
        print(json.dumps({"seed": seed, "fault": fault,
                          "readings": out.readings,
                          "attempted": out.attempted, "failed": out.failed,
                          "memory_peak_bytes": out.memory_peak_bytes,
                          "setup_s": out.record.setup_s,
                          "wall_s": program.clock() - t0}), flush=True)
        del out
        program.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
