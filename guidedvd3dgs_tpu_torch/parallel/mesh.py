"""A device mesh: a (n_data, n_model) grid of torch devices.

Counterpart of `guidedvd3dgs_tpu/parallel/mesh.py`. The axes keep their
names: "data" splits a batch of cameras (parallel/data_parallel.py::
make_dp_train_step) or a video's frames (`shard_video_batch`), "model"
splits the diffusion stack's weights (parallel/model_parallel.py). JAX
leaves the collectives to XLA; here they are explicit copies between the
devices, summed or concatenated on the mesh's home device, the first
device of the model axis, where activations and replicated weights live
(JAX's `replicated` sharding becomes that device).

A device may appear more than once: a mesh of ["cuda:0", "cuda:0"] runs
the sharded program on one card, and ["cpu", "cpu"] on the CPU. The
caller asks for that; `make_mesh` never repeats a device on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[i][j]: the device at data index i and model index j."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def model_devices(self) -> Tuple[torch.device, ...]:
        """The model axis of the first data row, home first."""
        return self.devices[0]

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The data axis of the first model column, home first."""
        return tuple(row[0] for row in self.devices)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first n_data * n_model of `devices` (every CUDA card by default)
    as an (n_data, n_model) mesh, row-major (JAX mesh.py:30-42). n_data
    defaults to as many rows as the devices fill."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if use < 1 or use > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {use} devices, {len(devices)} given")
    return Mesh(tuple(tuple(devices[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def device_scope(device: torch.device):
    """A context in which `device` is the current CUDA device, so that a
    kernel wrapper launches on its stream (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
