"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Needs as many CUDA cards as the cell asks
for (it never falls back to the CPU) and the port in ``src/repro_torch``
of the same checkout.  The last line of standard output is one JSON
object; the numbers that decide ``correct`` are the last lines of
standard error, each beside its limit.  Exits non-zero, with no result,
where it cannot measure.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout (git-ignored), so that
# only a cell's first run in a checkout builds
CACHE = ROOT / "build" / "bench_cache"


def _finite(x):
    """The line's numbers as JSON allows them (an infinite gap as a
    string)."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def _fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the window's host work is one caller's: no pool of CPU threads
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # the harness's package from the checkout's root, the port from its
    # src; not this script's own directory
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path[1:] if p not in (str(ROOT / "src"), str(ROOT))]

    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        return _fail(f"no workload {args.workload!r} in BENCHMARK.json")

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return _fail("no CUDA card; the benchmark measures only on one")
    if torch.cuda.device_count() < entry["chips"]:
        return _fail(f"{args.workload} needs {entry['chips']} cards, "
                     f"{torch.cuda.device_count()} found")
    try:
        import repro_torch
    except ImportError as e:
        return _fail(f"the port is not in this checkout ({e})")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        return _fail(f"repro_torch comes from {repro_torch.__file__}, not "
                     f"from this checkout")

    from bench import harness

    cell = harness.load_cell(args.workload)
    harness.check_registered(cell.sizes)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_process=T_PROCESS)
    leaked = harness.forbidden_modules()
    if leaked:
        return _fail(f"the run loaded {', '.join(leaked)}")
    for line in out.pop("_notes"):
        print(line, file=sys.stderr)
    print(f"device {out['device']['kind']} power_limit "
          f"{out['device'].pop('power_limit')}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
