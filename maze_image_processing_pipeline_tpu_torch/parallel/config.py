"""Config-reachable multi-card execution.

A copy of ``ParallelConfig`` from
``maze_image_processing_pipeline_tpu/parallel/config.py`` (the ``parallel:``
YAML section shared by both workloads, field for field, so the JAX
package's task files run unchanged), and the port's :func:`setup_parallel`,
which turns the section into a :class:`.mesh.Mesh` of the task's device.

YAML surface::

    parallel: true               # all local cards on one 'data' axis
    # or
    parallel:
      mesh: {data: 4, model: 2}  # explicit axis layout
      coordinator_address: host0:1234   # multi-host (torch.distributed)
      num_processes: 2
      process_id: 0
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from pydantic import Field

from ..config import TrueToDefaultsModel

logger = logging.getLogger(__name__)

__all__ = ["ParallelConfig", "setup_parallel"]


class ParallelConfig(TrueToDefaultsModel):
    mesh: Optional[Dict[str, int]] = Field(
        None,
        description="Named mesh axes (e.g. {data: 8} or {data: 4, model: 2}). "
        "Axis sizes must multiply to the device count. "
        "Default: all devices on one 'data' axis.",
    )
    data_axis: str = Field(
        "data", description="Mesh axis over which inference batches are sharded."
    )
    coordinator_address: Optional[str] = Field(
        None,
        description="host:port of process 0 for multi-host runs "
        "(passed to jax.distributed.initialize). Single-host when unset.",
    )
    num_processes: Optional[int] = Field(
        None, description="Total number of processes in a multi-host run."
    )
    process_id: Optional[int] = Field(
        None, description="This process's index in a multi-host run."
    )


def setup_parallel(config, device="cuda"):
    """Initialise distribution (if configured) and build the mesh.

    Returns ``None`` when ``parallel`` is disabled: the workloads then run on
    one device exactly as before. ``device`` is the task's device: a card
    (the default) builds the mesh over the CUDA cards and initialises
    ``torch.distributed`` with ``nccl``; ``"cpu"`` builds it from replicas of
    the CPU device, as many as the axes multiply to (one for ``parallel:
    true``), with ``gloo``.
    """
    if not config:
        return None

    import math

    import torch

    from .mesh import make_mesh
    from .multihost import initialize_distributed

    device = torch.device(device)
    initialize_distributed(
        coordinator_address=config.coordinator_address,
        num_processes=config.num_processes,
        process_id=config.process_id,
        device=device,
    )

    devices = None
    if device.type == "cpu":
        n = math.prod(config.mesh.values()) if config.mesh else 1
        devices = [device] * n
    mesh = make_mesh(config.mesh, devices)
    logger.info(
        "Parallel execution over mesh %s (%d devices)",
        dict(zip(mesh.axis_names, mesh.devices.shape)),
        mesh.devices.size,
    )
    return mesh
