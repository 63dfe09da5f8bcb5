"""The check that nothing of JAX or the JAX package is loaded compares
whole top-level names."""

import toy  # noqa: F401
from harness import guard


def test_catches_jax_and_the_jax_package():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "guidedvd3dgs_tpu", "guidedvd3dgs_tpu.ops.raster"]
    assert guard.forbidden_modules(names) == ["flax", "guidedvd3dgs_tpu", "jax", "jaxlib"]


def test_passes_the_port():
    names = ["guidedvd3dgs_tpu_torch", "guidedvd3dgs_tpu_torch.ops._build", "numpy", "jaxtyping", "torch"]
    assert guard.forbidden_modules(names) == []


def test_this_process():
    assert guard.forbidden_modules() == []
