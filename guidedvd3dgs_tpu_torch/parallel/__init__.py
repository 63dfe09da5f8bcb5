"""The device mesh and what runs over it (counterpart of the JAX package's
`parallel/`): the camera-batch step on one device (`train_step_dp`) and
over a mesh's data axis (`make_dp_train_step`), and the diffusion stack's
weights sharded over its model axis (`shard_params`)."""

from guidedvd3dgs_tpu_torch.parallel.data_parallel import (  # noqa: F401
    camera_at,
    make_dp_train_step,
    stack_cameras,
    train_step_dp,
)
from guidedvd3dgs_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from guidedvd3dgs_tpu_torch.parallel.model_parallel import Sharded, shard_params  # noqa: F401
