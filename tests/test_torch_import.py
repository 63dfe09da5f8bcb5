"""The PyTorch port imports nothing of JAX, of the JAX package or of tools/.

The subprocess blocks the three module trees (`jax`, `guidedvd3dgs_tpu`,
`tools`) by setting them to None in sys.modules, then imports every module
of the port; the source scan refuses an import of any of them in the
package and in chip_smoke.py.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "guidedvd3dgs_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "guidedvd3dgs_tpu", "tools")
for root in BLOCKED:
    sys.modules[root] = None  # any import of the tree now raises
import guidedvd3dgs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if k.split(".")[0] in BLOCKED and v is not None]
assert not loaded, loaded
print(" ".join(names))
"""

# the generation and guided-sampler slices' modules, each of which must be
# among those imported
DIFFUSION_MODULES = [
    "ops.flash_attention", "diffusion.nnops", "diffusion.schedules", "diffusion.attention",
    "diffusion.unet3d", "diffusion.vae", "diffusion.tokenizer", "diffusion.clip",
    "diffusion.resampler", "diffusion.model", "diffusion.samplers.ddim", "diffusion.synthesis",
    "diffusion.init", "diffusion.convert", "train.guided",
    "diffusion.samplers.ddim_guidance", "guidance", "guidance.loss_guidance",
]
# the raw-data chain, the append-pcd path, the two-scale CFG and the viewer
RAW_DATA_MODULES = [
    "dataset_to_colmap", "geometry.dust3r", "geometry.global_aligner", "geometry.pipeline",
    "guidance.dpt", "guidance.depth_lift", "augment_ply_with_depth", "diffusion.samplers.ddim_multicond",
    "viewer.network_gui",
]
# the camera-batch step, the device mesh and the sharded diffusion weights
PARALLEL_MODULES = ["parallel", "parallel.data_parallel", "parallel.mesh", "parallel.model_parallel"]


def test_every_port_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 89  # every module of the port
    missing = [m for m in DIFFUSION_MODULES + RAW_DATA_MODULES + PARALLEL_MODULES
               if f"guidedvd3dgs_tpu_torch.{m}" not in names]
    assert not missing, missing


def test_port_sources_have_no_jax_import():
    pat = re.compile(
        r"^\s*(import jax|from jax|import guidedvd3dgs_tpu(?!_torch)|from guidedvd3dgs_tpu(?!_torch)"
        r"|import tools|from tools)\b",
        re.M,
    )
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
