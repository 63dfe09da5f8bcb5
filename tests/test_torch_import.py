"""The PyTorch port imports without JAX and never imports it."""

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
sys.modules["jax"] = None  # any `import jax` now raises
import guidedvd3dgs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if k.split(".")[0] == "jax" and v is not None]
assert not loaded, loaded
print(len(names))
"""


def test_every_port_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the port


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
