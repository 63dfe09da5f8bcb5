"""PyTorch + CUDA port of the guided sparse-view 3DGS system.

The JAX package `guidedvd3dgs_tpu` is the reference this package is held
against; module names follow its layout. This package imports `torch` and
never `jax`. It may import the reference package's pure-numpy host modules
(config, COLMAP/PLY readers, graphics and pose helpers).

Layout:
  ops/     preprocess (kernel K1), tile binning (kernel K3), tile blend
           (kernel K4), the dense oracle and the public `rasterize`
  csrc/    the hand-written CUDA kernels, built by ops/_build.py with nvcc
  models/  Gaussian parameters and the render API
  scene/   cameras and the scene reader
  utils/   SH, losses, PNG codec
  render.py, metrics.py  the serving CLIs (`python -m guidedvd3dgs_tpu_torch.render`)
  convert.py  numpy bridge from the reference package's arrays
"""
