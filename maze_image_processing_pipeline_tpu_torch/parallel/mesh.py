"""The device mesh of the port.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/mesh.py``:
:func:`make_mesh` takes the same arguments and makes the same checks (a
copy of the original's), and returns a :class:`Mesh` with ``devices`` (a
numpy array of ``torch.device`` shaped by the axes) and ``axis_names``, as
``jax.sharding.Mesh`` has, and ``processes``: the rank of the process that
holds each card, as a JAX device's ``process_index``. In a
``torch.distributed`` group of several processes the mesh spans every
process's cards, ordered by rank and then by local index, the process-major
order of ``jax.devices()``: a process computes on its own cards only and
reaches the others' through ``parallel.multihost``.

Placement, as the JAX package's (:mod:`..parallel` says what each axis
does): :func:`mesh_grid` orders the cards as (data, space, model);
:func:`shard_params` gives each card its share of a module's weights (the
wide output channels of a conv split over ``model``, the rest whole);
:func:`space_rows` cuts image rows into ``space`` shares that a U-Net's
pooling keeps whole; :func:`replicate` puts a whole module on each card of
a data-replica path, and :func:`split_batch` cuts a batch into one share a
card or card group. All of them are functions of the mesh alone.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .multihost import all_gather_objects, host_count, host_id

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_grid",
    "model_split",
    "place_params",
    "replicate",
    "require_local",
    "shard_batch_spec",
    "shard_params",
    "sharded_names",
    "space_rows",
    "split_batch",
]


class Mesh:
    """Named axes over devices: ``devices`` is a numpy object array of
    ``torch.device`` whose shape is the axes' sizes, ``axis_names`` the
    axes' names in order, ``processes`` an int array of the same shape: the
    rank that holds each card (all 0 without a process group). A card of
    another process is only a name here: this process sends it work
    through ``parallel.multihost``, never tensors through ``.to``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...], processes=None) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (np.zeros(devices.shape, dtype=int) if processes is None
                          else np.asarray(processes, dtype=int).reshape(devices.shape))

    @property
    def spans_processes(self) -> bool:
        """Whether another process holds some of the mesh's cards."""
        return bool((self.processes != host_id()).any())

    def local_devices(self) -> List[torch.device]:
        """This process's cards of the mesh, in the mesh's order, each once."""
        out: List[torch.device] = []
        for d, r in zip(self.devices.flat, self.processes.flat):
            if r == host_id() and d not in out:
                out.append(d)
        return out

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        if not self.processes.any():
            return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"
        return (f"Mesh({self.shape}, devices={[f'{r}:{d}' for d, r in zip(self.devices.flat, self.processes.flat)]})")


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh over the devices.

    Args:
        axis_sizes: e.g. ``{"data": 4, "model": 2}``. Defaults to all devices
            on one ``data`` axis. Sizes must multiply to ``len(devices)``.
        devices: torch devices (or their names). Default: every CUDA card;
            without one it raises. A CPU run passes replicas of the CPU
            device (``[torch.device("cpu")] * n``), as
            :func:`.config.setup_parallel` does for a ``device: cpu`` task.
            In a ``torch.distributed`` group of several processes these
            are this process's own devices (the default: its cards), and
            the mesh spans every process's, ordered by rank and then as
            each process lists them (``jax.devices()``'s process-major
            order); one all-gather tells each process the others' lists.
            The sizes then multiply to the count over every process.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is available (torch.cuda.is_available() is false); "
                "pass devices=[torch.device('cpu')] * n to build a mesh of CPU replicas"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    processes = [0] * len(devices)
    if host_count() > 1:
        lists = all_gather_objects([str(d) for d in devices], devices[0] if devices else None)
        devices = [torch.device(d) for names in lists for d in names]
        processes = [r for r, names in enumerate(lists) for _ in names]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"data": n}
    sizes = list(axis_sizes.values())
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh axes {axis_sizes} do not cover {n} devices")
    flat = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        flat[i] = d
    return Mesh(flat.reshape(sizes), tuple(axis_sizes.keys()), np.asarray(processes).reshape(sizes))


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


def require_local(mesh: Optional[Mesh], node: str) -> None:
    """Raise a ``ValueError`` where ``mesh`` holds another process's cards:
    ``node`` runs on one process's cards. The JAX package's counterpart
    raises at its first fetch of an output that spans another process's
    devices; over hosts, inference is spread by samples instead."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError(
            f"{node}: the mesh {mesh} holds cards of other processes, and this node runs on one process's cards. "
            "To spread inference over hosts, give each host's task input.num_shards and input.shard_index "
            "(its share of the samples) and a mesh of its own cards (parallel without coordinator_address)"
        )


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


def mesh_grid(mesh: Mesh, space_axis: str = "space", model_axis: str = "model", of: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """The mesh's devices (or ``of``, an array of the mesh's shape: for
    example ``mesh.processes``) as a (data, space, model) array: every axis
    but ``space_axis`` and ``model_axis`` folded into the first, in the
    mesh's order; an axis the mesh lacks has size 1."""
    names = list(mesh.axis_names)
    inner = [names.index(a) for a in (space_axis, model_axis) if a in names]
    outer = [i for i in range(len(names)) if i not in inner]
    arr = (mesh.devices if of is None else of).transpose(outer + inner)
    S = mesh.shape.get(space_axis, 1)
    M = mesh.shape.get(model_axis, 1)
    return arr.reshape(-1, S, M)


def model_split(shape: Sequence[int], size: int, min_size: int = 64) -> bool:
    """The JAX package's rule (``parallel/mesh.py:shard_params``): a weight
    of two or more dimensions is split over a ``model`` axis of ``size``
    cards where its output channels (a conv's OIHW ``O``) are at least
    ``min_size`` and divide by ``size``."""
    return size > 1 and len(shape) >= 2 and shape[0] % size == 0 and shape[0] >= min_size


def sharded_names(module: torch.nn.Module, size: int, min_size: int = 64) -> List[str]:
    """The parameters of ``module`` that a ``model`` axis of ``size`` cards
    splits: each weight :func:`model_split` splits, and the bias of its
    layer (the card that computes a slice of the output channels adds their
    bias; the JAX package, whose rule looks at each array alone, keeps the
    1-D biases whole on every card)."""
    out = []
    for prefix, m in module.named_modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.nn.Parameter) and model_split(w.shape, size, min_size):
            dot = f"{prefix}." if prefix else ""
            out.append(f"{dot}weight")
            if isinstance(getattr(m, "bias", None), torch.nn.Parameter):
                out.append(f"{dot}bias")
    return out


def place_params(module: torch.nn.Module, grid: np.ndarray, min_size: int = 64, processes=None
                 ) -> Dict[Tuple[int, int, int], Dict[str, torch.Tensor]]:
    """:func:`shard_params` over a (data, space, model) ``grid`` of
    devices. With ``processes`` (the grid's ranks, :func:`mesh_grid` of
    ``mesh.processes``) a card of another process gets tensors on the
    ``meta`` device: their shapes, no values."""
    M = grid.shape[2]
    split = set(sharded_names(module, M, min_size))
    out = {}
    for idx in np.ndindex(grid.shape):
        dev, m = grid[idx], idx[2]
        if processes is not None and processes[idx] != host_id():
            dev = torch.device("meta")
        held = {}
        for name, p in module.named_parameters():
            t = p.detach()
            if name in split:
                t = t.chunk(M)[m]
            held[name] = t.to(dev, copy=True)
        out[idx] = held
    return out


def shard_params(module: torch.nn.Module, mesh: Mesh, model_axis: str = "model", min_size: int = 64
                 ) -> Dict[Tuple[int, int, int], Dict[str, torch.Tensor]]:
    """Place ``module``'s parameters on the mesh, as the JAX package's
    ``shard_params`` places them: on each card (keyed by its (data, space,
    model) index in :func:`mesh_grid`), every parameter of
    :func:`sharded_names` cut to that card's slice of the output channels
    (slice ``m`` of ``model``'s M), every other one whole. Returns fresh
    tensors on the cards; the module is not changed."""
    return place_params(module, mesh_grid(mesh, model_axis=model_axis), min_size,
                        mesh_grid(mesh, model_axis=model_axis, of=mesh.processes))


def space_rows(H: int, parts: int, depth: int) -> List[slice]:
    """``H`` image rows cut into ``parts`` consecutive ``space`` shares, each
    a whole multiple of ``2**depth`` rows (so a U-Net of that depth pools
    and upsamples within a share), as even as that allows: the first shares
    one multiple larger. A share is empty where there are fewer multiples
    than shares."""
    step = 2**depth
    if H % step:
        raise ValueError(f"space_rows: {H} rows are not a multiple of 2**{depth}")
    return [slice(s.start * step, s.stop * step) for s in split_batch(H // step, parts)]


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
