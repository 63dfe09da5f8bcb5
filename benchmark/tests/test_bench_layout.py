"""Every configuration, workload and metric of BENCHMARK.json loads by
name, and the file keeps to its contract's shape."""

import json
from types import SimpleNamespace
import re

import pytest

import toy  # noqa: F401  (puts benchmark/ on the path)
from harness import spec as spec_mod

BENCH = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    spec = spec_mod.load(cell)
    assert spec.chips == 1
    names = {m.name for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m.reader.MOVES == m.moves and m.moves in names
        assert callable(m.reader.read)


def test_names_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (spec_mod.BENCH / "metrics" / f"{e['name']}.py").exists()
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])


@pytest.mark.parametrize("cfg", [c["file"] for c in BENCH["configs"]])
def test_config_files(cfg):
    body = json.loads((spec_mod.ROOT / cfg).read_text())
    assert "reduced" in body and "assumed" in body and "source" in body


@pytest.mark.parametrize("metric", [e["name"] for e in BENCH["per_layer"]])
def test_metric_spans_resolve(metric):
    """Every span a metric file declares names a function that its module
    binds, so a driver can set it from the file alone."""
    from harness import trace

    reader = spec_mod.load_module(spec_mod.BENCH / "metrics" / f"{metric}.py", f"bench_metric_{metric}")
    for module, name, label in trace.metric_spans([SimpleNamespace(reader=reader)]):
        assert callable(getattr(module, name)) and label


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_reduced_matches(cfg):
    body = json.loads((spec_mod.ROOT / cfg["file"]).read_text())
    assert body["reduced"] == cfg["reduced"]
    assert all(k in body for k in cfg["reduced"])
