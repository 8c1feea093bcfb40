"""Multi-host runs.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/multihost.py``.
The LOKI and predict workloads are embarrassingly parallel at the sample and
archive level (one output archive per sample), so several hosts each take a
strided share of the input list (:func:`partition_work`, a copy of the
original's) and run the ordinary pipeline on it; ``output.skip_existing``
makes retries idempotent. No collective is needed for that: the mesh holds a
host's own cards only. :func:`initialize_distributed` joins the hosts'
processes into a ``torch.distributed`` group where the JAX package calls
``jax.distributed.initialize``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = ["initialize_distributed", "partition_work", "host_id", "host_count"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join this process to the run's ``torch.distributed`` group.

    Does nothing without a coordinator (``coordinator_address``, else
    ``MAZE_IPP_COORDINATOR``), or when the group is already set up.
    Otherwise ``init_process_group`` with ``init_method="tcp://<address>"``,
    ``nccl`` when ``device`` is a card and ``gloo`` on the CPU; the process
    count and index default to ``WORLD_SIZE`` and ``RANK``.
    """
    coordinator_address = coordinator_address or os.environ.get("MAZE_IPP_COORDINATOR")
    if coordinator_address is None:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ else None
    if process_id is None:
        process_id = int(os.environ["RANK"]) if "RANK" in os.environ else None
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed: a coordinator needs num_processes and process_id "
            "(or WORLD_SIZE and RANK in the environment)"
        )
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )
    logger.info(
        "torch.distributed initialized (%s): process %d of %d", backend, dist.get_rank(), dist.get_world_size()
    )


def host_id() -> int:
    """This process's rank, 0 without a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_count() -> int:
    """The processes of the run, 1 without a process group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def partition_work(
    items: Sequence[T],
    n_hosts: Optional[int] = None,
    this_host: Optional[int] = None,
) -> List[T]:
    """Deterministic strided partition of a work list across hosts.

    Striding (rather than contiguous chunks) balances load when sample
    sizes correlate with their position in the sorted list.
    """
    if n_hosts is None:
        n_hosts = host_count()
    if this_host is None:
        this_host = host_id()
    if not 0 <= this_host < n_hosts:
        raise ValueError(f"host {this_host} not in [0, {n_hosts})")
    subset = list(items[this_host::n_hosts])
    logger.info(
        "Host %d/%d takes %d of %d work items", this_host, n_hosts, len(subset), len(items)
    )
    return subset
