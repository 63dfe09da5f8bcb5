"""Kernel L2 (short and cross attention at D = 64) on the CPU: which calls
take the kernels, the launch shapes the host picks, the kernels'
arithmetic, and the einsum form against the JAX package.

The CUDA kernels run only on the card (tests/test_torch_cuda_short_attention.py).
Here `emulate_fwd` / `emulate_bwd` repeat csrc/short_attn.cu's algorithm in
f32 torch ops on the tiles `plan` picks (the online softmax over key tiles,
P normalised before its bf16 rounding where all keys fit one tile, the
unnormalised P rounded and o divided by the row sum where they stream;
backward P recomputed from the log-sum-exp, Delta from dO and o, dS rounded
to bf16 for dQ and dK), and are held to the einsum form forward (L1's
bf16 tolerance, 1e-2 relative above 1) and to L1's plain backward (2e-2
of max |grad|). `nnops.attention` on the CPU takes the einsum form, held
to the JAX package's einsum path: float32 2e-6, bfloat16 2e-2 (as
tests/test_torch_flash_attention.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import nnops as jnn
from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa
from guidedvd3dgs_tpu_torch.ops import short_attention as sa
from guidedvd3dgs_tpu_torch.utils import tracing

torch.set_num_threads(2)

BF, F32 = torch.bfloat16, torch.float32


class Fake:
    """What takes_kernel reads of a tensor on a card, for a host without one."""

    def __init__(self, shape, dtype=BF, cuda=True, grad=False):
        self.shape, self.dtype, self.is_cuda, self.requires_grad = torch.Size(shape), dtype, cuda, grad

    def dim(self):
        return len(self.shape)


def fakes(b, h, lq, lk, d=64, dtype=BF, cuda=True, kgrad=False, vgrad=False):
    return (Fake((b, h, lq, d), dtype, cuda, True), Fake((b, h, lk, d), dtype, cuda, kgrad),
            Fake((b, h, lk, d), dtype, cuda, vgrad))


# (batch, heads, Lq, Lk) of the three classes at 320x448 and 320x512:
# temporal self-attention over 25 frames (ViewCrafter's level 0 to 3 and
# init_attn, SVD's temporal block), cross-attention to 77 text tokens, 16
# image tokens and SVD's one token (its 56,000 rows a video), spatial
# self-attention below level 0
CLASSES = {
    "T": [(2240, 5, 25, 25), (560, 10, 25, 25), (140, 20, 25, 25), (35, 20, 25, 25), (4480, 8, 25, 25)],
    "X": [(25, 5, 2240, 77), (25, 10, 560, 16), (25, 20, 35, 77), (2, 5, 56000, 1), (2, 10, 14000, 1)],
    "S": [(25, 10, 560, 560), (25, 10, 640, 640), (25, 20, 140, 140), (25, 20, 160, 160), (25, 20, 35, 35),
          (50, 20, 40, 40)],
}
SHAPES = [(cls, s) for cls, shapes in CLASSES.items() for s in shapes]


@pytest.mark.parametrize("cls,shape", SHAPES)
def test_takes_the_classes(cls, shape):
    b, h, lq, lk = shape
    assert sa.takes_kernel(*fakes(b, h, lq, lk, kgrad=cls != "X", vgrad=cls != "X"))


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_refuses_inside_plain_versions(cls):
    """Inside `plain_versions()` the kernels take nothing, and outside it
    again what they took before."""
    b, h, lq, lk = CLASSES[cls][0]
    args = fakes(b, h, lq, lk, kgrad=cls != "X", vgrad=cls != "X")
    with _build.plain_versions():
        assert not sa.takes_kernel(*args)
    assert sa.takes_kernel(*args)


@pytest.mark.parametrize("case", ["mask", "bias", "f32", "cpu", "d80", "d512", "l1", "cross_k_grad",
                                  "cross_v_grad", "batch_mismatch", "empty"])
def test_refuses(case, monkeypatch):
    """Everything the einsum form keeps: masked, biased, f32, the CPU, other
    head sizes, cross-attention whose k or v needs a gradient, broadcast
    batches, no keys. L1's case (self-attention of at least nnops'
    FLASH_MIN_SEQ tokens) is nnops' to refuse: it reaches kernel L1 even
    where takes_kernel would take it."""
    args = fakes(2, 5, 2240, 77)
    kw = {}
    if case == "mask":
        kw["mask"] = Fake((2, 1, 2240, 77), torch.bool)
    elif case == "bias":
        kw["bias"] = Fake((2240, 77), F32)
    elif case == "f32":
        args = fakes(2, 5, 2240, 77, dtype=F32)
    elif case == "cpu":
        args = fakes(2, 5, 2240, 77, cuda=False)
    elif case == "d80":
        args = fakes(2, 16, 257, 257, d=80)
    elif case == "d512":
        args = fakes(1, 1, 500, 500, d=512)
    elif case == "l1":
        def no_l2(*a, **kw):
            raise AssertionError("L1's case reached L2")

        monkeypatch.setattr(sa, "takes_kernel", lambda *a, **kw: True)
        monkeypatch.setattr(sa, "short_attention", no_l2)
        q = torch.randn((1, 1, nnops.FLASH_MIN_SEQ, 64)).to(BF)
        assert torch.equal(nnops.attention(q, q, q, 0.125), fa.flash_attention(q, q, q, 0.125))
        return
    elif case == "cross_k_grad":
        args = fakes(2, 5, 2240, 77, kgrad=True)
    elif case == "cross_v_grad":
        args = fakes(2, 5, 2240, 77, vgrad=True)
    elif case == "batch_mismatch":
        args = (Fake((2, 5, 25, 64)), Fake((1, 5, 25, 64)), Fake((1, 5, 25, 64)))
    elif case == "empty":
        args = fakes(2, 5, 25, 0)
    assert not sa.takes_kernel(*args, **kw)


def test_edges_of_the_rules():
    """One token below L1's length takes L2, and so does L1's length (keys
    stream: the kernels' reach is not nnops' routing); self-attention
    needing dK and dV does; cross-attention with k needing a gradient does
    where autograd is off."""
    n = nnops.FLASH_MIN_SEQ
    assert n == 1024
    assert sa.takes_kernel(*fakes(1, 5, n - 1, n - 1, kgrad=True, vgrad=True))
    assert sa.takes_kernel(*fakes(1, 5, n, n, kgrad=True, vgrad=True))
    with torch.no_grad():
        assert sa.takes_kernel(*fakes(2, 5, 2240, 77, kgrad=True))


@pytest.mark.parametrize("cls,shape", SHAPES)
def test_plan_covers_every_row_and_key(cls, shape):
    b, h, lq, lk = shape
    need_kv = cls != "X"
    pl = sa.plan(lq, lk, b * h, need_kv)
    assert pl.wp in (2, 4) and pl.slots * pl.wp == sa.WARPS
    assert pl.wp == 2 if lq <= 32 else pl.wp == 4
    rows = 16 * pl.wp  # a slot's rows (and keys) a block
    assert (pl.q_chunks - 1) * rows < lq <= pl.q_chunks * rows
    assert (pl.groups - 1) * pl.slots < b * h <= pl.groups * pl.slots
    assert pl.kv_chunks == (-(-lk // rows) if need_kv else 0)
    padded = -(-lk // 16) * 16
    assert pl.kt_fwd == min(t for t in sa.FWD_TILES if t >= min(padded, 128))
    assert pl.kt_bwd == min(t for t in sa.BWD_TILES if t >= min(padded, 64))
    assert pl.rows_fwd == min(pl.kt_fwd, padded) and pl.rows_bwd == min(pl.kt_bwd, padded)
    assert pl.blocks_fwd == pl.groups * pl.q_chunks and pl.blocks_bwd == pl.groups * (pl.q_chunks + pl.kv_chunks)
    # at least two blocks of 4 warps resident on an SM's 227 KB
    assert 0 < pl.smem_fwd <= 113 * 1024 and 0 < pl.smem_bwd <= 113 * 1024


def test_plan_of_the_temporal_attention():
    """25 frames: two problems a block of 4 warps (25 of 32 rows each), all
    keys in one tile of 32, one block a problem pair each way backward."""
    pl = sa.plan(25, 25, 11200, True)
    assert (pl.wp, pl.slots, pl.q_chunks, pl.kv_chunks, pl.kt_fwd, pl.rows_fwd) == (2, 2, 1, 1, 32, 32)
    assert (pl.blocks_fwd, pl.blocks_bwd) == (5600, 11200)
    # 77 keys in one forward pass, streamed by 64 backward; 560 keys streamed by 128
    assert (sa.plan(2240, 77, 125, False).kt_fwd, sa.plan(2240, 77, 125, False).rows_fwd) == (128, 80)
    assert sa.plan(560, 560, 250, True)[2:4] == (128, 64)


def heads(rng, b, h, n, dtype=BF):
    return nnops.split_heads(torch.from_numpy(rng.standard_normal((b, n, h * 64)).astype(np.float32)).to(dtype), h)


def emulate_fwd(q, k, v, scale):
    """csrc/short_attn.cu's forward in f32 torch ops: (o, lse)."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    kt = sa.plan(lq, lk, b * h, False).kt_fwd
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, lq), -torch.inf)
    l_sum = torch.zeros((b, h, lq))
    acc = torch.zeros((b, h, lq, 64))
    one = lk <= kt
    for k0 in range(0, lk, kt):
        s = torch.matmul(qf, kf[:, :, k0:k0 + kt].transpose(-1, -2)) * scale
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        m = mx
        p = torch.exp(s - m[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        if one:
            p = p * (1.0 / l_sum)[..., None]
        acc = acc * alpha[..., None] + torch.matmul(p.to(BF).float(), vf[:, :, k0:k0 + kt])
    o = acc if one else acc * (1.0 / l_sum)[..., None]
    return o.to(BF), m + torch.log(l_sum)


def emulate_bwd(q, k, v, o, lse, do, scale):
    """Its backward: (dq, dk, dv) in bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dv = torch.matmul(p.to(BF).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(BF).float().transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds.to(BF).float(), kf) * scale
    return dq.to(BF), dk.to(BF), dv.to(BF)


# small shapes of each class: one tile, 77 keys in one forward tile and two
# backward ones, keys streamed over two forward tiles, one key
EMULATED = [(6, 5, 25, 25), (2, 3, 140, 77), (1, 2, 200, 200), (3, 2, 40, 1), (2, 2, 35, 35)]


@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernels_match_the_plain_versions(shape):
    b, h, lq, lk = shape
    rng = np.random.default_rng(lq + lk)
    q, k, v, do = heads(rng, b, h, lq), heads(rng, b, h, lk), heads(rng, b, h, lk), heads(rng, b, h, lq)
    scale = 0.125
    o, lse = emulate_fwd(q, k, v, scale)
    want = sa.attention_plain(q, k, v, scale)
    assert bool(((o.float() - want.float()).abs() <= 1e-2 * want.float().abs().clamp(min=1.0)).all())
    want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    got = emulate_bwd(q, k, v, o, lse, do, scale)
    for g, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-3)) <= 2e-2


def test_output_layout_and_strides():
    """The output is (B, N, H, D) memory: merge_heads reshapes it without a
    copy. Strides passed per operand are (batch, head, row), 0 for an axis
    of one entry; a view off a 16-byte boundary or with a dim stride is
    copied."""
    rng = np.random.default_rng(3)
    q = heads(rng, 3, 5, 25)
    out = sa._heads_last(q)
    assert out.shape == q.shape and nnops.merge_heads(out).data_ptr() == out.data_ptr()
    assert sa._strides(q, None) == [25 * 320, 64, 320, 0, 0, 0]
    assert sa._strides(q[:1]) == [0, 64, 320]
    assert sa._rows(q) is q
    buf = torch.zeros(q.numel() + 1, dtype=BF)
    off = buf[1:].view(q.shape)
    if off.data_ptr() % 16:
        assert sa._rows(off).data_ptr() % 16 == 0
    t = q.transpose(-1, -2).contiguous().transpose(-1, -2)  # dims not unit-stride
    assert sa._rows(t).stride(-1) == 1 and torch.equal(sa._rows(t), q)


def test_cpu_takes_the_einsum_form_and_counts_it():
    """On the CPU nnops.attention takes the einsum form; under a profiler
    it counts it as "nn.attention.plain", and the relative-position form
    too; short_attention refuses CPU tensors and counts nothing."""
    rng = np.random.default_rng(4)
    q, k = heads(rng, 2, 2, 25), heads(rng, 2, 2, 7)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = nnops.attention(q, k, k, 0.125)
        with pytest.raises(ValueError, match="no short-attention kernel"):
            sa.short_attention(q, k, k, 0.125)
        rel = (torch.zeros((25, 7, 64), dtype=BF),) * 2
        nnops.attention(q, k, k, 0.125, rel=rel)
    assert torch.equal(got, sa.attention_plain(q, k, k, 0.125))
    assert tracing.COUNTS.get("nn.attention.plain") == 2 and "nn.attention.l2" not in tracing.COUNTS
    tracing.reset()


@pytest.mark.parametrize("masked", [False, True])
def test_relative_position_form_is_the_attend_math(masked):
    """nnops.attention with the relative-position tables `rel` is, bit for
    bit at f32, the form the transformer blocks computed for themselves
    before it moved into `attention_plain`: the tables' bias on the scaled
    logits, the causal mask, the f32 softmax and the tables' output term."""
    rng = np.random.default_rng(9 + masked)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 2, 6, 8)).astype(np.float32)) for _ in range(3))
    k2, v2 = (torch.from_numpy(rng.standard_normal((6, 6, 8)).astype(np.float32)) for _ in range(2))
    mask = torch.tril(torch.ones((6, 6), dtype=torch.bool))[None, None] if masked else None
    sim = torch.matmul(q, k.transpose(-1, -2)) * 0.35
    sim = sim + torch.einsum("bhtd,tsd->bhts", q, k2) * 0.35
    if mask is not None:
        sim = torch.where(mask, sim, torch.finfo(sim.dtype).min)
    attn = torch.softmax(sim, dim=-1)
    want = torch.matmul(attn, v) + torch.einsum("bhts,tsd->bhtd", attn, v2)
    assert torch.equal(nnops.attention(q, k, v, 0.35, mask=mask, rel=(k2, v2)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls,shape", [("T", (6, 2, 25, 25)), ("X", (2, 2, 140, 77)), ("X", (1, 2, 30, 1)),
                                       ("S", (1, 2, 160, 160))])
def test_nnops_attention_matches_jax_on_cpu(cls, shape, dtype):
    b, h, lq, lk = shape
    rng = np.random.default_rng(lq * lk)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((b, h, lq, 64), (b, h, lk, 64), (b, h, lk, 64))]
    scale = 0.125
    want = np.asarray(jnn.attention(*(jnp.asarray(a, dtype) for a in arrs), scale), np.float32)
    got = nnops.attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs), scale)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-6 if dtype == "float32" else 2e-2, rtol=0)


def test_masked_and_biased_match_jax_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 25, 64)).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((25, 25), bool))[None, None]
    bias = rng.standard_normal((25, 25)).astype(np.float32)
    for kw in (dict(mask=mask), dict(bias=bias)):
        want = np.asarray(jnn.attention(*map(jnp.asarray, (q, k, v)), 0.125,
                                        **{n: jnp.asarray(a) for n, a in kw.items()}))
        got = nnops.attention(*map(torch.from_numpy, (q, k, v)), 0.125,
                              **{n: torch.from_numpy(a) for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
