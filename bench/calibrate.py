"""Readings for the limits of the comparison that decides ``correct``.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 2]

In one process on the card: for each seed of ``--seeds`` one run of the
cell with a short window (every step's scores against the reference, as a
benchmark run compares them), and for each seed of ``--control-seeds``
the control (the reference in the configuration's lower precision, in the
program's place) on the same inputs.  Prints one JSON line a reading.
The benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    harness.check_registered(cell.sizes)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    for seed in seeds:
        out = harness.run_cell(cell, seed, args.seconds, False, dev)
        print(json.dumps({"workload": cell.name, "side": "program",
                          "seed": seed, "correct": out["correct"],
                          "steps": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    for seed in controls:
        v = harness.control_reading(cell, seed, dev)
        print(json.dumps({"workload": cell.name, "side": "control",
                          "precision": cell.sizes["control"], "seed": seed,
                          "correct": v.correct, "checks": v.checks}),
              flush=True)
        del v
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
