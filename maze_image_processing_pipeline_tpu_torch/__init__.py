"""MAZE-IPP on PyTorch and CUDA: the port of the JAX package's device path.

This package is the PyTorch counterpart of ``maze_image_processing_pipeline_tpu``
for NVIDIA GPUs (Hopper, ``sm_90a``). It keeps the JAX package's module names
where a module has a counterpart:

* :mod:`.ops` — CCL (:mod:`.ops.label`, whose row scans and vertical pass
  are hand-written CUDA kernels behind :mod:`.ops.row_scan` and
  :func:`.ops.label.vertical_pass`), EDT, morphology, fused region
  measurement, filled area, device crops, segment measurement;
* :mod:`.models` — the U-Net, the polytaxo classifier, GroupNorm (a CUDA
  kernel, ``csrc/group_norm.cu``), checkpoint reading and writing, the
  inference stream nodes;
* :mod:`.engine` — the streaming engine and the image stream nodes;
* :mod:`.dataio` — archives, EcoTaxa TSV, images, LOKI data, telemetry;
* :mod:`.polytaxo` — the polyhierarchical taxonomy engine (a copy);
* :mod:`.loki` and :mod:`.predict` — the LOKI and prediction workloads:
  pipelines and ``Runner``s behind the ``maze-ipp-torch`` CLI (:mod:`.cli`).

Nothing here imports jax or the JAX package: the host modules the port
needs are its own copies, each naming its original. Kernels are compiled
by ``nvcc`` at first use (:mod:`._build`); entry points run on the card
unless the caller asks for the CPU, where every kernel's plain PyTorch
version runs.
"""

from ._version import get_version

__version__ = get_version()
del get_version
