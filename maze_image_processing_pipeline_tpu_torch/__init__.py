"""MAZE-IPP on PyTorch and CUDA: the port of the JAX package's device path.

This package is the PyTorch counterpart of ``maze_image_processing_pipeline_tpu``
for NVIDIA GPUs (Hopper, ``sm_90a``). It keeps the JAX package's module names
where a module has a counterpart:

* :mod:`.ops` — CCL (:mod:`.ops.label`, whose row scans are hand-written CUDA
  kernels in ``csrc/row_scan.cu`` behind :mod:`.ops.row_scan`), EDT,
  morphology, fused region measurement, filled area, device crops;
* :mod:`.models` — the U-Net, GroupNorm, checkpoint reading and writing;
* :mod:`.engine` — the streaming engine and the image stream nodes;
* :mod:`.dataio` — archives, EcoTaxa TSV, images, LOKI data, telemetry;
* :mod:`.loki` — the LOKI workload: U-Net segmentation stage, pipeline,
  ``Runner``, behind the ``maze-ipp-torch`` CLI (:mod:`.cli`).

Nothing here imports jax or the JAX package: the host modules the port
needs are its own copies, each naming its original. Kernels are compiled
by ``nvcc`` at first use (:mod:`._build`); entry points run on the card
unless the caller asks for the CPU, where every kernel's plain PyTorch
version runs.
"""

from ._version import get_version

__version__ = get_version()
del get_version
