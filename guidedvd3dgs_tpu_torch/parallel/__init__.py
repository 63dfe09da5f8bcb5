"""Camera-batch training on one device (counterpart of the JAX package's
`parallel/`; its device mesh, `make_dp_train_step` and the tensor-parallel
engine wait for a multi-card host)."""

from guidedvd3dgs_tpu_torch.parallel.data_parallel import (  # noqa: F401
    camera_at,
    stack_cameras,
    train_step_dp,
)
