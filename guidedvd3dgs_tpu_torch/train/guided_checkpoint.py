"""Exact checkpoint and resume of the guided trainer.

Counterpart of `guidedvd3dgs_tpu/train/guided_checkpoint.py`, for the
port's per-step trainer. Two files:

  * `<path>`: the Gaussian state and the iteration (train/checkpoint.py);
  * `<path>.guided.npz`: everything else a resumed run needs to draw the
    same stream: both pseudo stacks (each camera's R, T, fields of view,
    its frame and its packed mask), the trajectory pool (every view, the
    empty ones too) with each view's remaining shuffle, the train views'
    poses and centre depths, the event views left (`vd_indices`), the
    baseline trainer's view epoch, the three random streams (numpy's
    `default_rng`, the camera order's `random.Random`, the engine's torch
    `Generator`), the event count, the hybrid warm-up flag, the SH degree,
    the resolution and the engine's `video_length`.

Arrays and one JSON sidecar inside the npz (no pickle). A resumed run
from iteration i is bitwise the run that wrote the checkpoint at i.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.scene.cameras import PseudoCamera
from guidedvd3dgs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from guidedvd3dgs_tpu_torch.train.guided import TrajEntry


def _rng_state_json(gen: np.random.Generator) -> str:
    return json.dumps(gen.bit_generator.state)


def _restore_rng(state_json: str) -> np.random.Generator:
    st = json.loads(state_json)
    gen = np.random.Generator(getattr(np.random, st["bit_generator"])())
    gen.bit_generator.state = st
    return gen


def _cams_arrays(name: str, cams, height: int, width: int) -> dict:
    n = len(cams)
    frames = [c.pseudo_gt.detach().cpu().numpy() for c in cams]
    masks = [c.mask.detach().cpu().numpy().astype(bool) for c in cams]
    return {
        f"{name}/R": np.stack([np.asarray(c.R) for c in cams]) if n else np.zeros((0, 3, 3)),
        f"{name}/T": np.stack([np.asarray(c.T) for c in cams]) if n else np.zeros((0, 3)),
        f"{name}/fovx": np.asarray([c.FoVx for c in cams], np.float64),
        f"{name}/fovy": np.asarray([c.FoVy for c in cams], np.float64),
        f"{name}/frames": np.stack(frames) if n else np.zeros((0, 3, height, width), np.float32),
        f"{name}/mask": np.packbits(np.stack(masks), axis=None) if n else np.zeros((0,), np.uint8),
        f"{name}/mask_shape": np.asarray([n, *(masks[0].shape if n else (1, height, width))], np.int64),
    }


def _cams_from(data, name: str, height: int, width: int, device) -> list:
    shape = [int(x) for x in data[f"{name}/mask_shape"]]
    n, mask_shape = shape[0], tuple(shape[1:])
    masks = np.unpackbits(data[f"{name}/mask"], count=n * int(np.prod(mask_shape))).reshape(n, *mask_shape)
    frames = data[f"{name}/frames"]
    return [
        PseudoCamera(R=data[f"{name}/R"][i], T=data[f"{name}/T"][i], FoVx=float(data[f"{name}/fovx"][i]),
                     FoVy=float(data[f"{name}/fovy"][i]), width=width, height=height,
                     pseudo_gt=torch.from_numpy(frames[i]).to(device),
                     mask=torch.from_numpy(masks[i].astype(np.float32)).to(device))
        for i in range(n)
    ]


def save_guided_checkpoint(path: str, trainer, iteration: int) -> None:
    """Write `<path>` (the Gaussian state) and `<path>.guided.npz`. A
    pipelined event in flight is finalized first: the files hold the state
    after it (its stacks, its promotions' draws), and the resumed run starts
    with no event in flight, as the run that wrote them goes on."""
    trainer.flush_pending_event()
    save_checkpoint(path, trainer.state, iteration)
    train_cams = list(trainer.scene.getTrainCameras())
    cam_ids = {id(c): i for i, c in enumerate(train_cams)}
    arrays = {
        "vd_indices": np.asarray(trainer.vd_indices, np.int64),
        "torch_generator": trainer.generator.get_state().numpy(),
        "train_c2ws": np.asarray(getattr(trainer, "train_c2ws", np.zeros((0, 4, 4)))),
        "center_depths": np.asarray(getattr(trainer, "center_depths", np.zeros((0,)))),
        "ema_loss": np.asarray(float(trainer.ema_loss), np.float32),
    }
    for name, cams in (("cur", trainer.pseudo_stack), ("alltime", trainer.pseudo_stack_alltime)):
        arrays.update(_cams_arrays(name, cams, trainer.H, trainer.W))

    pool_index = []
    for view, entries in trainer.trajectory_pool.items():
        for i, e in enumerate(entries):
            for k in ("traj_c2ws", "obj_c2w", "transform_back"):
                arrays[f"traj/{view}/{i}/{k}"] = np.asarray(getattr(e, k))
            pool_index.append({"view": int(view), "i": i, "cand_idx": int(e.cand_idx),
                               "center_scale": float(e.center_scale), "scale_idx": int(e.scale_idx)})
    shuffle = {}
    for view, remaining in trainer.trajectory_pool_shuffle.items():
        # by identity: a TrajEntry holds arrays, so == is ambiguous
        ids = {id(x): i for i, x in enumerate(trainer.trajectory_pool.get(view, []))}
        shuffle[int(view)] = [ids[id(e)] for e in remaining]
    version, mt_state, gauss = trainer.rng.getstate()
    sidecar = {
        "iteration": int(iteration),
        "events_run": int(trainer.events_run),
        "txt_traj_warmup": bool(trainer.txt_traj_warmup),
        "active_sh_degree": int(trainer.active_sh_degree),
        "rng_np": _rng_state_json(trainer.rng_np),
        "rng_py": [version, list(mt_state), gauss],
        "viewpoint_stack": [cam_ids[id(c)] for c in trainer.viewpoint_stack],
        "pool_index": pool_index,
        # every pool view, the empty ones too: an event indexes trajectory_pool[view]
        "pool_views": [int(v) for v in trainer.trajectory_pool],
        "shuffle": shuffle,
        "H": int(trainer.H),
        "W": int(trainer.W),
        "video_length": int(trainer.engine.video_length),
    }
    arrays["__sidecar__"] = np.frombuffer(json.dumps(sidecar).encode(), dtype=np.uint8)
    with open(path + ".guided.npz", "wb") as f:
        np.savez(f, **arrays)


def load_guided_checkpoint(path: str, trainer) -> int:
    """Restore a freshly built trainer (the same scene, options and engine)
    in place; returns the checkpoint's iteration. Its trajectory pool is
    the checkpoint's (nothing is rendered). A plain checkpoint (no
    `.guided.npz`) restores the Gaussian state and iteration, and the pool
    (or, without the pool, the view geometry) is built as a new run
    builds it."""
    trainer.state, iteration = load_checkpoint(path, trainer.device)
    trainer.xyz_lr = trainer.xyz_sched(iteration)
    if not os.path.exists(path + ".guided.npz"):
        print(f"[resume] {path}: plain checkpoint (no .guided.npz): building the trajectory pool")
        if getattr(trainer.opt, "use_trajectory_pool", True):
            trainer.init_trajectory_pool()
        else:
            trainer.init_view_geometry()
        return iteration

    data = np.load(path + ".guided.npz")
    sidecar = json.loads(bytes(data["__sidecar__"]).decode())
    if [sidecar["H"], sidecar["W"]] != [trainer.H, trainer.W]:
        raise ValueError(f"checkpoint resolution {sidecar['H']}x{sidecar['W']} != trainer {trainer.H}x{trainer.W}")
    if int(sidecar["video_length"]) != trainer.engine.video_length:
        raise ValueError(f"checkpoint video_length {sidecar['video_length']} != engine "
                         f"{trainer.engine.video_length}: its pseudo stacks and pool trajectories have "
                         "that many frames; resume with the original engine config")

    dev = trainer.device
    trainer.vd_indices = [int(x) for x in data["vd_indices"]]
    trainer.generator.set_state(torch.from_numpy(data["torch_generator"].copy()))
    trainer.ema_loss = torch.tensor(float(data["ema_loss"]), device=dev)
    if data["train_c2ws"].shape[0]:
        trainer.train_c2ws, trainer.center_depths = data["train_c2ws"], data["center_depths"]
    trainer.events_run = sidecar["events_run"]
    trainer.txt_traj_warmup = sidecar["txt_traj_warmup"]
    trainer.active_sh_degree = sidecar["active_sh_degree"]
    trainer.rng_np = _restore_rng(sidecar["rng_np"])
    version, mt_state, gauss = sidecar["rng_py"]
    trainer.rng.setstate((version, tuple(mt_state), gauss))
    train_cams = list(trainer.scene.getTrainCameras())
    trainer.viewpoint_stack = [train_cams[i] for i in sidecar["viewpoint_stack"]]
    trainer.pseudo_stack = _cams_from(data, "cur", trainer.H, trainer.W, dev)
    trainer.pseudo_stack_alltime = _cams_from(data, "alltime", trainer.H, trainer.W, dev)

    pool = {int(v): {} for v in sidecar["pool_views"]}
    for rec in sidecar["pool_index"]:
        v, i = rec["view"], rec["i"]
        pool[v][i] = TrajEntry(
            cand_idx=rec["cand_idx"], traj_c2ws=data[f"traj/{v}/{i}/traj_c2ws"],
            center_scale=rec["center_scale"], scale_idx=rec["scale_idx"],
            obj_c2w=data[f"traj/{v}/{i}/obj_c2w"], transform_back=data[f"traj/{v}/{i}/transform_back"])
    trainer.trajectory_pool = {v: [d[i] for i in sorted(d)] for v, d in pool.items()}
    trainer.trajectory_pool_shuffle = {
        int(v): [trainer.trajectory_pool[int(v)][i] for i in idxs] for v, idxs in sidecar["shuffle"].items()
    }
    return iteration
