"""The device mesh of the port.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/mesh.py``:
:func:`make_mesh` takes the same arguments and makes the same checks (a
copy of the original's), and returns a :class:`Mesh` with ``devices`` (a
numpy array of ``torch.device`` shaped by the axes) and ``axis_names``, as
``jax.sharding.Mesh`` has. Every card of a mesh runs as a data replica
(:mod:`..parallel`); :func:`replicate` and :func:`shard_params` place a
module on each of them, and :func:`split_batch` cuts a batch into one
share a card.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard_batch_spec", "shard_params", "replicate", "split_batch"]


class Mesh:
    """Named axes over devices: ``devices`` is a numpy object array of
    ``torch.device`` whose shape is the axes' sizes, ``axis_names`` the
    axes' names in order."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh over the devices.

    Args:
        axis_sizes: e.g. ``{"data": 4, "model": 2}``. Defaults to all devices
            on one ``data`` axis. Sizes must multiply to ``len(devices)``.
        devices: torch devices (or their names). Default: every CUDA card;
            without one it raises. A CPU run passes replicas of the CPU
            device (``[torch.device("cpu")] * n``), as
            :func:`.config.setup_parallel` does for a ``device: cpu`` task.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is available (torch.cuda.is_available() is false); "
                "pass devices=[torch.device('cpu')] * n to build a mesh of CPU replicas"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"data": n}
    sizes = list(axis_sizes.values())
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh axes {axis_sizes} do not cover {n} devices")
    flat = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        flat[i] = torch.device(d)
    return Mesh(flat.reshape(sizes), tuple(axis_sizes.keys()))


def shard_batch_spec(mesh: Mesh, ndim: int = 4) -> Tuple[Optional[str], ...]:
    """The axis each dimension of an image batch (B, H, W, C) is split over,
    as the JAX package's ``PartitionSpec``: ``data`` for the batch, ``space``
    for the rows, None for the rest."""
    parts = []
    if "data" in mesh.axis_names:
        parts.append("data")
    else:
        parts.append(None)
    if "space" in mesh.axis_names and ndim >= 3:
        parts.append("space")
    while len(parts) < ndim:
        parts.append(None)
    return tuple(parts)


def mesh_devices(mesh: Optional[Mesh], device) -> List[torch.device]:
    """The mesh's devices in order, one data replica each; without a mesh,
    ``[device]``."""
    if mesh is None:
        return [torch.device(device)]
    return list(mesh.devices.flat)


def replicate(module: torch.nn.Module, devices: Sequence[torch.device]) -> Dict[torch.device, torch.nn.Module]:
    """``module`` on each distinct device of ``devices`` (a mesh's, or
    :func:`mesh_devices`): the module itself on the first, copies of it on
    the others. Replicas of one device share a module."""
    out: Dict[torch.device, torch.nn.Module] = {}
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out[d] = module.to(d) if not out else copy.deepcopy(module).to(d)
    return out


def shard_params(module: torch.nn.Module, mesh: Mesh, model_axis: str = "model", min_size: int = 64):
    """Place ``module`` on the mesh: a replica on each card. The JAX package
    shards wide output channels over ``model`` here; the port runs every card
    as a data replica (:mod:`..parallel`), so this is :func:`replicate`."""
    return replicate(module, list(mesh.devices.flat))


def split_batch(n: int, parts: int) -> List[slice]:
    """``n`` items cut into ``parts`` consecutive shares in order, one a
    device, the first ``n % parts`` one item larger (``torch.tensor_split``'s
    shares; a share may be empty)."""
    base, extra = divmod(n, parts)
    out, o = [], 0
    for k in range(parts):
        size = base + (1 if k < extra else 0)
        out.append(slice(o, o + size))
        o += size
    return out
