"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up builds the cell's inputs from the seed
and warms every shape the window uses; the window then drives the program
for `--seconds` (`--trace 1`: a few untraced steps, then as many under
the profiler instead, and the cell's per-layer metrics); the plain
reference then decides `correct`. The last line of standard output is the run's JSON result
(harness/result.py). A run needs as many CUDA devices as the cell asks
for: without them it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[0:0] = [str(BENCH), str(ROOT)]

from harness import guard, result, spec as spec_mod  # noqa: E402

import torch  # noqa: E402


@dataclass
class Context:
    spec: spec_mod.Spec
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    max_steps: int = 0  # stop the window after this many steps (0: after `seconds`)
    fault: Optional[str] = None  # a planted fault (tests only)
    calibrate: bool = False  # return the program's and the control's numbers (benchmark/calibrate.py)
    control: bool = True  # with calibrate: also the control's numbers
    look: bool = False  # with calibrate: also the readings of the look at a number (the drivers' `look`)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.pin_caches(ROOT)
    spec = spec_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {spec.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    ctx = Context(spec=spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), t0=T0,
                  max_steps=int(spec.traffic["trace_steps"]) if args.trace else 0)
    out = run_cell(ctx)
    found = guard.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    result.emit(out)
    return 0


def run_cell(ctx: Context) -> dict:
    driver = importlib.import_module(f"drivers.{ctx.spec.driver}")
    return driver.run(ctx)


if __name__ == "__main__":
    sys.exit(main())
