"""At toy sizes on the CPU: the drivers run the program's timed path and
the reference decides `correct`; every planted fault turns it false; the
control (the reference one precision down in the program's place) reads
far above the program. The harness's look for a card is skipped: the
drivers are called directly."""

import json

import pytest

import toy
import run

DDIM_CELLS = ["vc-guided-ddim", "vc-ddim"]
TRAIN_CELLS = ["gs-baseline-train", "gs-guided-train"]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def spec_of(cell):
    return toy.vc_spec(cell) if cell in DDIM_CELLS else toy.gs_spec(cell)


@pytest.mark.parametrize("cell", DDIM_CELLS + TRAIN_CELLS)
def test_correct_at_toy_size(cell):
    out = run.run_cell(toy.context(spec_of(cell), seconds=0.3))
    assert [k for k in out if k in REQUIRED] == REQUIRED and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m.name for m in spec_of(cell).end_to_end}
    json.dumps(out)


@pytest.mark.parametrize("cell", DDIM_CELLS[:1] + TRAIN_CELLS[:1])
def test_traced_line(cell):
    out = run.run_cell(toy.context(spec_of(cell), trace=True))
    assert [k for k in out if k in REQUIRED + ["breakdown"]] == REQUIRED + ["breakdown"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and list(out)[-1] == "checks"
    assert out["correct"]


FAULTS = [(c, f) for c in DDIM_CELLS for f in ("unchanged", "altered")] + [("vc-guided-ddim", "guidance")] + \
         [(c, f) for c in TRAIN_CELLS for f in ("unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    out = run.run_cell(toy.context(spec_of(cell), seconds=0.3, fault=fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", DDIM_CELLS + TRAIN_CELLS)
def test_control_reads_far_above_the_program(cell):
    out = run.run_cell(toy.context(spec_of(cell), calibrate=True, max_steps=3))
    prog, low = out["program"], out["control"]
    assert any(low[k] > 3 * prog[k] and low[k] > 0 for k in prog), out
