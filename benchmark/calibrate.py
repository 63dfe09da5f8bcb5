"""Readings for the limits of `correct`: for each seed, one set-up, a
window of `--steps` steps, then the numbers `correct` compares, of the
program and of the control (the reference in the precision below the
configuration's, in the program's place). One JSON line a seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--seconds 40 | --steps 2]

The limits in the drivers lie between the program's largest reading over
a dozen seeds or more and the control's smallest (benchmark/README.md).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[0:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from harness import guard, spec as spec_mod  # noqa: E402

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None, help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--steps", type=int, default=0, help="a window of this many steps instead")
    ap.add_argument("--fault", default=None, help="plant a fault in the program (the drivers' faults); no control")
    ap.add_argument("--no_control", action="store_true", help="the program's numbers only")
    ap.add_argument("--look", action="store_true", help="also the drivers' further readings behind a number")
    args = ap.parse_args(argv)
    guard.pin_caches(run.ROOT)
    spec = spec_mod.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        seconds = args.seconds if args.seconds is not None else spec_mod.run_seconds()
        ctx = run.Context(spec=spec, seed=seed, seconds=seconds, trace=False, device=torch.device("cuda", 0),
                          t0=t, max_steps=args.steps, calibrate=True, fault=args.fault,
                          control=not args.no_control, look=args.look)
        out = run.run_cell(ctx)
        out.update(workload=args.workload, seed=seed, fault=args.fault, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
