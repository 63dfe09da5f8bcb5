"""Tensor-parallel sharding of the diffusion stack over the mesh's model axis.

Counterpart of `guidedvd3dgs_tpu/parallel/model_parallel.py`. `spec_for` is
the same partition rule (Megatron-style pairs); `shard_params` places each
sharded weight as a `Sharded` holder, its pieces on the model axis's
devices. XLA inserts JAX's collectives from the annotations; here
diffusion/nnops.py's layers take a `Sharded` weight and run the pairing
themselves (`column_apply`, `row_apply`): a column-parallel layer copies
its input to each device and concatenates the outputs on the home device
in device order, a row-parallel one gives each device its slice of the
input's features and sums the partial outputs on the home device in
device order, adding the bias once. diffusion/attention.py keeps a
head-parallel attention's activations on their devices between the two
layers of its pair. All of it is plain autograd across devices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from guidedvd3dgs_tpu_torch.parallel.mesh import Mesh, device_scope


def spec_for(name: str, shape: Tuple[int, ...], n_model: int) -> Optional[int]:
    """The dim of a torch-named parameter that the model axis splits, or
    None where it is replicated (JAX `_spec_for`, model_parallel.py:23-58,
    in its order):
    - the second matmul of a pair (attention `to_out.0`, feed-forward
      `net.2`) splits its input features, dim 1 (row-parallel), so the
      first matmul's split outputs are consumed where they are;
    - GEGLU's `net.0.proj` is replicated: a dim-0 split would put the value
      and gate halves on different devices; `net.2` then takes local slices
      of its replicated output;
    - norms, 1-D tensors and anything not divisible are replicated;
    - every other weight of two or more dims splits its output features,
      dim 0 (column-parallel: Linear (out, in), Conv (out, in, ...))."""
    ndim = len(shape)
    if ndim == 0:
        return None
    is_norm = ".norm" in name or (name.endswith((".0.weight", ".0.bias")) and ndim == 1)
    if ndim >= 2 and ".weight" in name and not is_norm:
        if name.endswith((".to_out.0.weight", ".net.2.weight")):
            return 1 if shape[1] % n_model == 0 and shape[1] >= n_model else None
        if name.endswith(".net.0.proj.weight"):
            return None
        if shape[0] % n_model == 0 and shape[0] >= n_model:
            return 0
    return None


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A weight split along `dim` into equal pieces, piece i on devices[i]
    (the model axis, home first)."""

    shards: Tuple[torch.Tensor, ...]
    dim: int
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.dim] *= len(self.shards)
        return torch.Size(s)

    def bounds(self, i: int) -> slice:
        """The slice of the full `dim` that piece i holds."""
        size = self.shards[0].shape[self.dim]
        return slice(i * size, (i + 1) * size)


def shard_params(params, mesh: Mesh):
    """`params` (a torch-named dict, or a DiffusionParams of such dicts, each
    sharded alone) with every entry that `spec_for` splits as a `Sharded`
    of its pieces on the model axis, read from the given tensor piece by
    piece (the whole never goes to the home device), and every other entry
    on the home device."""
    if not isinstance(params, dict) and hasattr(params, "_fields"):
        return type(params)(*[shard_params(d, mesh) for d in params])
    devs = mesh.model_devices
    out = {}
    for name, t in params.items():
        dim = spec_for(name, tuple(t.shape), len(devs))
        if dim is None:
            out[name] = t.to(mesh.home)
            continue
        size = t.shape[dim] // len(devs)
        out[name] = Sharded(tuple(t.narrow(dim, i * size, size).to(d).contiguous() for i, d in enumerate(devs)),
                            dim, devs)
    return out


def shard_video_batch(x: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """The frame axis of a (B, T, H, W, C) video split in order over the
    data axis, piece i on data device i (JAX model_parallel.py:75-77)."""
    devs = mesh.data_devices
    if x.shape[1] % len(devs):
        raise ValueError(f"{x.shape[1]} frames do not split over {len(devs)} devices")
    return tuple(c.to(d) for c, d in zip(x.chunk(len(devs), dim=1), devs))


def shard_call(w: Sharded, i: int, x: torch.Tensor, fn: Callable, bias: Optional[torch.Tensor] = None):
    """Shard i of a column-parallel layer: fn(x, w_i, b_i) on device i with
    x copied there, w_i cast to x's dtype and b_i the bias's slice of w_i's
    output features. The result stays on device i."""
    dev = w.devices[i]
    b = None if bias is None else bias[w.bounds(i)].to(dev, x.dtype)
    return fn(x.to(dev), w.shards[i].to(x.dtype), b)


def column_apply(w: Sharded, x: torch.Tensor, fn: Callable, bias: Optional[torch.Tensor] = None):
    """A column-parallel layer (w split on dim 0, its output features):
    fn(x, w_i, b_i) on each device with x copied there, the outputs
    concatenated along their last (channel) axis on x's device in device
    order."""
    outs = []
    for i, dev in enumerate(w.devices):
        with device_scope(dev):
            outs.append(shard_call(w, i, x, fn, bias).to(x.device))
    return torch.cat(outs, dim=-1)


def row_apply(w: Sharded, x: torch.Tensor, fn: Callable, bias: Optional[torch.Tensor] = None):
    """A row-parallel layer (w split on dim 1, its input features): fn(x_i,
    w_i) on each device with x_i its slice of x's last axis, the partial
    outputs summed on x's device in device order (in float32, rounded once
    to x's dtype), the bias added once."""
    parts = []
    for i, (wi, dev) in enumerate(zip(w.shards, w.devices)):
        with device_scope(dev):
            parts.append(fn(x[..., w.bounds(i)].to(dev), wi.to(x.dtype), None))
    return sum_partials(parts, x.device, x.dtype, bias)


def sum_partials(parts, device: torch.device, dtype: torch.dtype,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The partial outputs of a row-parallel layer summed on `device` in
    their order, in float32 and rounded once to `dtype`, the bias added
    once."""
    total = None
    for part in parts:
        part = part.to(device, torch.float32)
        total = part if total is None else total + part
    y = total.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def embedding(w: Sharded, ids: torch.Tensor) -> torch.Tensor:
    """w[ids] for a table split on its rows (dim 0): each device looks up
    the ids in its rows, the rows meet on the ids' device."""
    if w.dim != 0:
        raise ValueError("an embedding table splits its rows")
    out = None
    for i, (wi, dev) in enumerate(zip(w.shards, w.devices)):
        rows = w.bounds(i)
        local = ids - rows.start
        inside = (local >= 0) & (local < wi.shape[0])
        got = wi[local.clamp(0, wi.shape[0] - 1).to(dev)].to(ids.device)
        out = got if out is None else torch.where(inside[..., None], got, out)
    return out
