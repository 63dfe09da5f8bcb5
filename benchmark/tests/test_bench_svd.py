"""The svd-guided-euler cell at a toy size on the CPU: the driver runs the
program's guided Euler EDM steps and the plain reference decides
`correct`; every fault the cell can have (a step that leaves its state
unchanged, half of the frames left out, an answer altered where it is
produced, the guidance term scaled) turns it false; the control reads far
above the program."""

import copy
import json

import pytest

import toy
import run
from harness import spec as spec_mod

CELL = "svd-guided-euler"
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def svd_spec() -> spec_mod.Spec:
    """The cell's spec with SVD-XT's widths cut to a few channels and a toy
    request (4 frames at 32 x 32, guidance at 48 x 64, 3 steps, chunks of 3)."""
    spec = spec_mod.load(CELL)
    cfg = copy.deepcopy(json.loads((toy.BENCH / "configs" / "svd-xt.json").read_text()))
    cfg["compute_dtype"] = "float32"
    cfg["unet"].update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1, attention_resolutions=[1],
                       num_head_channels=16, context_dim=24, adm_in_channels=24, addition_time_embed_dim=8)
    cfg["vae"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=32)
    cfg["decoder"].update(block_out_channels=[32, 64], layers_per_block=1)
    cfg["clip_vision"].update(width=48, heads=4, layers=2, patch_size=32, image_size=64, projection_dim=24)
    spec.config = cfg
    spec.traffic = dict(spec.traffic, frames=4, height=32, width=32, guide_height=48, guide_width=64, steps=3,
                        decode_chunk=3, trace_steps=1)
    return spec


def test_correct_at_toy_size():
    out = run.run_cell(toy.context(svd_spec(), seconds=0.3))
    assert [k for k in out if k in REQUIRED] == REQUIRED and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m.name for m in svd_spec().end_to_end}
    json.dumps(out)


def test_traced_line():
    out = run.run_cell(toy.context(svd_spec(), trace=True))
    assert [k for k in out if k in REQUIRED + ["breakdown"]] == REQUIRED + ["breakdown"]
    assert out["correct"]
    # device-trace metrics only: the cell's step fills the card's launch queue, and the
    # profiler then gives some kernels to two CPU events, so sums by span count them twice
    assert {m.source for m in svd_spec().per_layer} == {"device_trace"}


@pytest.mark.parametrize("fault", ["unchanged", "half_frames", "altered", "guidance"])
def test_fault_is_caught(fault):
    out = run.run_cell(toy.context(svd_spec(), seconds=0.3, fault=fault))
    assert not out["correct"], out["checks"]


def test_control_reads_far_above_the_program():
    out = run.run_cell(toy.context(svd_spec(), calibrate=True, max_steps=3))
    prog, low = out["program"], out["control"]
    assert any(low[k] > 3 * prog[k] and low[k] > 0 for k in prog), out
