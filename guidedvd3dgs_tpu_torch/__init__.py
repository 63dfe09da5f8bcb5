"""PyTorch + CUDA port of the guided sparse-view 3DGS system.

The JAX package `guidedvd3dgs_tpu` is the reference this package is held
against; module names follow its layout. This package imports `torch` and
never `jax`, nothing of the reference package and nothing of `tools/`: it
keeps its own copies of the host modules it needs (config, COLMAP/PLY
readers, dataset readers, graphics helpers, the synthetic scene).

Layout:
  ops/     preprocess and its VJP (kernels K1, K2), tile binning (K3),
           tile blend and its backward (K4, K5), the per-Gaussian gradient
           sum (K6), the dense oracle, the public `rasterize`, the 3-NN,
           flash attention (L1), the point splat
  csrc/    the hand-written CUDA kernels, built by ops/_build.py with nvcc
  models/  Gaussian parameters, the training state (Adam, densification)
           and the render API
  train/   the baseline, project-cam and guided trainers, checkpoints (the
           guided one exact), the metrics log
  scene/   cameras, readers (COLMAP layouts, Blender), the scene container,
           the point-cloud projection, the synthetic scene
  diffusion/, guidance/  the video-diffusion stack and its guidance
  utils/   SH, losses, LPIPS, the VGG loss, PNG codec, video writer, grids,
           LR schedule, graphics helpers, flythrough paths
  vendored/  verbatim third-party code (multinerf's camera paths)
  render.py, metrics.py, train_baseline.py, train_guidedvd.py,
  train_project_cam.py, project_pcd_to_views.py, get_avg_results.py
           the CLIs (`python -m guidedvd3dgs_tpu_torch.train_baseline`, ...)
  config.py  the config tree and its CLI flags
  convert.py  numpy bridge from the reference package's arrays
"""
