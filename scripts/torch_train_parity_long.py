"""The port's baseline trainer against the JAX package's over a long schedule.

    JAX_PLATFORMS=cpu python scripts/torch_train_parity_long.py [STEPS=600]

Both trainers start from one state on the scene of tests/test_train_baseline.py
and run STEPS steps with every schedule event: densify and prune every 100
steps, an opacity reset every 300, the SH degree step at 500. The port is
fed the JAX package's split noise, so the two should track each other until
floating-point differences flip a threshold. Prints, every 100 steps, the
Gaussian counts, the step losses and the eval PSNR of both (JAX, port).
The reference renders with its dense oracle, the port with its tile path on
the CPU. A script, not a test: ~4 minutes for 600 steps.
"""

import dataclasses
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from guidedvd3dgs_tpu.models import gaussians as JG  # noqa: E402
from guidedvd3dgs_tpu.train.baseline import BaselineTrainer as JaxTrainer  # noqa: E402
from guidedvd3dgs_tpu_torch.convert import state_from_numpy  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras  # noqa: E402
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer  # noqa: E402
from test_train_baseline import FakeModelParams, FakeOpt, FakePipe, FakeScene, make_synthetic  # noqa: E402

CAPACITY = 4096


def main(steps: int) -> None:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    cams = make_synthetic()
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=CAPACITY)
    opt = dataclasses.replace(
        FakeOpt(), iterations=steps, densification_interval=100, densify_from_iter=100,
        prune_from_iter=100, densify_until_iter=steps, opacity_reset_interval=300,
        position_lr_max_steps=steps,
    )
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]

    def noise(it):
        key = jax.random.key(it)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(key, i), (CAPACITY, 3))) for i in range(2)
        ]))

    jt = JaxTrainer(FakeScene(cams, 3.0), jstate, opt, FakePipe(), FakeModelParams())
    pt = BaselineTrainer(FakeScene(pcams, 3.0), state_from_numpy(jax.device_get(jstate)), opt,
                         FakePipe(raster_backend="tiles"), FakeModelParams(), split_noise=noise)
    t0 = time.time()
    for it in range(1, steps + 1):
        js, ps = jt.step(it), pt.step(it)
        if it % 100 == 0:
            print(f"step {it}: Gaussians {js.num_active} / {ps.num_active}, loss {js.loss:.5f} / "
                  f"{float(ps.loss):.5f}, eval PSNR {jt.evaluate(cams)['psnr']:.3f} / "
                  f"{pt.evaluate(pcams)['psnr']:.3f} ({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 600)
