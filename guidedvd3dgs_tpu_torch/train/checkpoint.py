"""Full training-state checkpoints in the reference's .npz layout.

Counterpart of `guidedvd3dgs_tpu/train/checkpoint.py`: one .npz whose keys
are the reference's flattened state paths (`params/xyz`, ...,
`adam_m/<name>`, `adam_v/<name>`, `step`, `active`, `confidence`,
`max_radii2d`, `xyz_gradient_accum`, `denom`) plus `__iteration__`. The
port writes its rows (all active); it reads a checkpoint of either package
by taking the `active` rows, so a reference checkpoint resumes in the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES, GaussianParams, GaussianState

_ROWS = ("confidence", "max_radii2d", "xyz_gradient_accum", "denom")


def save_checkpoint(path: str, state: GaussianState, iteration: int) -> None:
    arrays = {}
    for group, values in (("params", state.params.tensors()), ("adam_m", state.adam_m),
                          ("adam_v", state.adam_v)):
        for name in PARAM_NAMES:
            arrays[f"{group}/{name}"] = values[name].cpu().numpy()
    arrays["step"] = np.asarray(state.step, np.int32)
    arrays["active"] = np.ones((state.num_gaussians,), bool)
    for name in _ROWS:
        arrays[name] = getattr(state, name).cpu().numpy()
    arrays["__iteration__"] = np.asarray(iteration)
    # through a file object: np.savez would append ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, device="cpu") -> Tuple[GaussianState, int]:
    """(state of the checkpoint's active rows, iteration)."""
    data = np.load(path)
    act = np.asarray(data["active"], bool)

    def rows(key):
        return torch.from_numpy(np.ascontiguousarray(data[key][act], np.float32)).to(device)

    state = GaussianState(
        params=GaussianParams(**{n: rows(f"params/{n}") for n in PARAM_NAMES}),
        adam_m={n: rows(f"adam_m/{n}") for n in PARAM_NAMES},
        adam_v={n: rows(f"adam_v/{n}") for n in PARAM_NAMES},
        step=int(data["step"]),
        **{name: rows(name) for name in _ROWS},
    )
    return state, int(data["__iteration__"])
