"""The operation, byte and FLOP counters against hand counts at toy
shapes."""

import pytest
import torch

import toy  # noqa: F401
from counts import attention, gaussian, peaks
from reference.gs.raster import Counts


def test_bound_is_the_larger_time():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 989e12, peaks.PEAK_BF16_FLOPS) == pytest.approx(1.0)


def test_l1_forward_and_backward_by_hand():
    b, h, n, d = 2, 3, 1024, 64
    # q, k, v read and o written in bf16; 4 B H N^2 D operations
    want = max(4 * b * h * n * d * 2 / 3.35e12, 4 * b * h * n * n * d / 989e12)
    assert attention.fwd_s((b, h, n, d), 2) == pytest.approx(want)
    dkv, dq = attention.bwd_s((b, h, n, d), 2)
    reads = 4 * b * h * n * d * 2 + 2 * b * h * n * 4
    assert dkv == pytest.approx(max((reads + 2 * b * h * n * d * 2) / 3.35e12, 8 * b * h * n * n * d / 989e12))
    assert dq == pytest.approx(max((reads + b * h * n * d * 2) / 3.35e12, 6 * b * h * n * n * d / 989e12))


def test_l1_launches_of_the_guided_step():
    cfg = toy.json.loads((toy.BENCH / "configs" / "viewcrafter-pvd1024.json").read_text())
    traffic = dict(guided=True, frames=25, height=320, width=448, decode_chunk=5)
    got = attention.step_launches(cfg, traffic)
    # 5 level-0 attentions: the batched pair once, each branch forward and
    # backward for its VJP; one VAE attention per chunk of 5 frames
    assert ("fwd", (50, 5, 2240, 64), 5) in got and ("bwd", (25, 5, 2240, 64), 10) in got
    assert sum(n for k, s, n in got if s == (5, 1, 2240, 512)) == 10
    plain = attention.step_launches(cfg, dict(traffic, guided=False))
    assert plain == [("fwd", (25, 5, 2240, 64), 10)]


def test_gaussian_kernels_by_hand():
    c = Counts(gaussians=1000, binned=400, instances=2000, tiles=1200, pixels=307200, blended=50000, walked=30000)
    assert gaussian.k4_s(c) == pytest.approx(max((2000 * 44 + 1200 * 12 + 307200 * 20) / 3.35e12,
                                                 (26 * 50000 + 11 * 30000) / 67e12))
    assert gaussian.k6_s(c) == pytest.approx(max((2000 * 40 + 1000 * 48) / 3.35e12, 2000 * 10 / 67e12))
    two = gaussian.chain([c, c])
    assert two.gaussians == 1000 and two.instances == 4000 and two.pixels == 2 * 307200
    assert gaussian.adam_s(1000) == pytest.approx(7 * 4 * 59 * 1000 / 3.35e12)


def test_flop_counter_by_hand():
    from counts import flops

    lin = torch.nn.Linear(64, 32, bias=False, device="meta")
    x = torch.empty((8, 64), device="meta")
    assert flops._count(lambda: lin(x)) == 2 * 8 * 64 * 32
    conv = torch.nn.Conv2d(4, 8, 3, padding=1, bias=False, device="meta")
    y = torch.empty((2, 4, 16, 16), device="meta")
    assert flops._count(lambda: conv(y)) == 2 * 2 * 8 * 16 * 16 * 4 * 9


def test_ddim_step_flops_structure():
    from drivers import ddim_steps

    spec = toy.vc_spec("vc-guided-ddim")
    guided = ddim_steps._step_flops(spec.config, spec.traffic)
    plain = ddim_steps._step_flops(spec.config, dict(spec.traffic, guided=False))
    # the pair at batch 2 alone is the plain step's work; the guided step adds
    # the branches' VJPs (each at least a forward) and the decode gradients
    assert guided > 2 * plain > 0
