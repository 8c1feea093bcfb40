"""MAZE-IPP on PyTorch and CUDA: the port of the JAX package's device path.

This package is the PyTorch counterpart of ``maze_image_processing_pipeline_tpu``
for NVIDIA GPUs (Hopper, ``sm_90a``). It keeps the JAX package's module names
where a module has a counterpart:

* :mod:`.ops` — CCL (:mod:`.ops.label`, whose row scans are hand-written CUDA
  kernels in ``csrc/row_scan.cu`` behind :mod:`.ops.row_scan`), EDT,
  morphology, fused region measurement, filled area, device crops;
* :mod:`.models` — the U-Net, GroupNorm, checkpoint reading;
* :mod:`.engine` — the image stream nodes of the slice;
* :mod:`.loki` — the LOKI U-Net segmentation stage.

Nothing here imports jax. Kernels are compiled by ``nvcc`` at first use
(:mod:`._build`); on the CPU every kernel's plain PyTorch version runs.
"""
