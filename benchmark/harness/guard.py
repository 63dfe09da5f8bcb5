"""What a run may load and where it may write.

* `forbidden_modules`: the top-level names in `sys.modules` that belong to
  JAX or to the JAX package, compared whole (the part before the first
  dot): the port `guidedvd3dgs_tpu_torch` begins with the JAX package's
  name and is allowed.
* `pin_caches`: every build and kernel cache of the program in fixed
  directories inside the checkout, so that only a cell's first run in a
  checkout builds. The port builds its kernels into `build/torch_kernels/`
  of the checkout by itself (`ops/_build.py`); Triton and torch extensions,
  should anything use them, go beside it.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "guidedvd3dgs_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules.keys() if names is None else names
    tops = {n.split(".", 1)[0] for n in list(names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def pin_caches(root: Path) -> None:
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # a library that could reach for flax on its own stays off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
