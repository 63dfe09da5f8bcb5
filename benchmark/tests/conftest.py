"""The benchmark's tests: on the CPU at toy sizes; those marked `cuda`
need a card and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH / "tests"), str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# several workers share the machine's cores
torch.set_num_threads(2)
