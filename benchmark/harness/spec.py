"""What one cell is: its entry in BENCHMARK.json, its workload file and its
configuration file, found by name.

    BENCHMARK.json                     at the root of the checkout
    benchmark/workloads/<cell>.json    {"config", "driver", "why", "traffic": {...}, "limits": {...}}
    benchmark/configs/<config>.json    the configuration as it is run
    benchmark/drivers/<driver>.py      the timed loop (`run(ctx)`)
    benchmark/metrics/<metric>.py      one per-layer metric (`MOVES`, `read(view)`)

A new cell, configuration or per-layer metric is a new file of its kind
and a new entry in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str] = None  # per-layer metrics: the end-to-end metric it moves
    layer: Optional[str] = None
    reader: Optional[ModuleType] = None  # per-layer metrics: benchmark/metrics/<name>.py


@dataclass
class Spec:
    cell: str
    config_name: str
    config: dict
    driver: str
    traffic: dict
    chips: int
    limits: dict  # the limit of each number that decides `correct`
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (metric names hold dots)."""
    sp = importlib.util.spec_from_file_location(name, path)
    if sp is None or sp.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def run_seconds(root: Path = ROOT) -> float:
    return float(_json(root / "BENCHMARK.json")["run_seconds"])


def _applies(entry: dict, cell: str) -> bool:
    """A metric belongs to a cell where its `workloads` names the cell; an
    end-to-end metric without the key (`peak_gb`, `setup_s`) to every
    cell. A per-layer metric has to name its cells."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if "moves" in entry:
        raise ValueError(f"per-layer metric {entry['name']!r} names no workloads")
    return True


def load(cell: str, root: Path = ROOT) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    wl = _json(BENCH / "workloads" / f"{cell}.json")
    if wl["config"] != entry["config"]:
        raise ValueError(f"{cell}: workload file names config {wl['config']!r}, BENCHMARK.json {entry['config']!r}")
    cfg = _json(root / configs[entry["config"]]["file"])
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"])
           for m in bench["end_to_end"] if _applies(m, cell)]
    per_layer = []
    for m in bench["per_layer"]:
        if _applies(m, cell):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
            per_layer.append(Metric(m["name"], m["unit"], m["better"], m["source"], m["moves"],
                                    m["layer"], reader))
    return Spec(cell=cell, config_name=entry["config"], config=cfg, driver=wl["driver"],
                traffic=wl["traffic"], chips=int(entry["chips"]), limits=wl["limits"], end_to_end=e2e,
                per_layer=per_layer)
