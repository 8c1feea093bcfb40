"""Multi-host runs.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/multihost.py``.
:func:`initialize_distributed` joins the hosts' processes into a
``torch.distributed`` group where the JAX package calls
``jax.distributed.initialize``. Two ways of spreading work over hosts then
exist, as in the JAX package:

* Inference: the LOKI and predict workloads are embarrassingly parallel at
  the sample and archive level (one output archive per sample), so several
  hosts each take a strided share of the input list (:func:`partition_work`,
  a copy of the original's; ``input.num_shards`` / ``shard_index``) and run
  the ordinary pipeline on a mesh of their own cards; ``output.skip_existing``
  makes retries idempotent. No collective is needed for that.
* Training: a mesh may span the processes (``parallel.mesh.make_mesh``
  orders every process's cards as ``jax.devices()`` does), and each process
  runs the same program on its own cards (SPMD). The U-Net's and the
  classifier's halos, channel gathers and GroupNorm statistics then cross
  processes where neighbouring cards do (``models.unet.ShardedNet``), and
  the train step reduces gradients and broadcasts the updated parameters
  across them (``models.train``).

The transport of the second: :func:`exchange` sends each peer one buffer
and receives one from it (``batch_isend_irecv``), staged through the host
under ``gloo`` (which sends CPU tensors only) and through the process's
first card under ``nccl`` (a rank of a NCCL group is bound to one card);
the receiving side derives every shape from the network and the batch, so
nothing but the values is sent. :class:`Link` carries one forward's
crossings: each is a ``torch.autograd.Function`` whose backward is the
transposed exchange, and each takes and returns a token (a scalar that
requires grad), so the backward meets the crossings of every process in the
reverse of their forward order: program order, the same on every process.
A one-sided send whose gradient came back through some unrelated output
would leave each process waiting at its backward for a neighbour that waits
for it.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, TypeVar

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = [
    "initialize_distributed",
    "partition_work",
    "host_id",
    "host_count",
    "all_gather_objects",
    "barrier",
    "exchange",
    "staging_device",
    "Link",
    "Move",
]

# How long a collective waits for the other processes before it fails: a
# process that died leaves the others blocked until then.
TIMEOUT = datetime.timedelta(minutes=5)


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
    count and index default to ``WORLD_SIZE`` and ``RANK``. A collective
    that waits longer than :data:`TIMEOUT` for another process fails.
    """
    coordinator_address = coordinator_address or os.environ.get("MAZE_IPP_COORDINATOR")
    if coordinator_address is None:
        return
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
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=TIMEOUT,
    )
    logger.info(
        "torch.distributed initialized (%s): process %d of %d", backend, dist.get_rank(), dist.get_world_size()
    )


def host_id() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_count() -> int:
    """The processes of the run, 1 without a process group."""
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


# -- the transport of a mesh that spans processes ---------------------------


def _cuda_context(device):
    import contextlib

    return torch.cuda.device(device) if device is not None and device.type == "cuda" else contextlib.nullcontext()


def all_gather_objects(obj, device=None) -> list:
    """``obj`` of every process, in rank order (``all_gather_object``; under
    ``nccl`` through ``device``, a card of this process)."""
    out = [None] * dist.get_world_size()
    with _cuda_context(device if dist.get_backend() == "nccl" else None):
        dist.all_gather_object(out, obj)
    return out


def barrier(device=None) -> None:
    """Wait for every process of the group."""
    all_gather_objects(None, device)


def staging_device(devices) -> torch.device:
    """Where this process's cross-process traffic is staged: the host under
    ``gloo``, the first card of ``devices`` (this process's cards of the
    mesh) under ``nccl``."""
    if dist.get_backend() == "nccl":
        return next(torch.device(d) for d in devices if torch.device(d).type == "cuda")
    return torch.device("cpu")


_ALIGN = 16


def _nbytes(shape, dtype) -> int:
    return -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN


def _layout(t: torch.Tensor) -> List[int]:
    """The dims of ``t`` from outermost to innermost in the layout that
    ``t.to(another device)`` gives its copy (``preserve_format``)."""
    like = torch.empty_like(t, device="meta")
    return sorted(range(t.dim()), key=lambda d: -like.stride(d))


def exchange(sends: Dict[int, list], recvs: Dict[int, list], stage) -> Dict[int, list]:
    """Send each peer ``sends[peer]`` (tensors) and receive from each peer
    the tensors ``recvs[peer]`` describes ((shape, dtype, device) each), in
    one buffer each way a peer, staged on ``stage``. Every peer must make
    the mirror image of this call. A received tensor has the strides that
    ``.to`` would give a copy of the sent one (its dims' order leads the
    buffer): a kernel then sums in the same order on either side. Returns
    the received tensors, each on its device, by peer."""
    ops, inbox = [], {}
    for peer in sorted(set(sends) | set(recvs)):
        out = sends.get(peer, [])
        if out:
            orders = [_layout(t) for t in out]
            head = torch.tensor([d for o in orders for d in o] or [0], dtype=torch.int64)
            pieces = [head.view(torch.uint8).to(stage)]
            pad = _nbytes((max(1, head.numel()),), torch.int64) - 8 * max(1, head.numel())
            if pad:
                pieces.append(pieces[0].new_zeros(pad))
            for t, order in zip(out, orders):
                flat = t.detach().permute(order).contiguous().reshape(-1).view(torch.uint8).to(stage)
                pieces.append(flat)
                pad = _nbytes(t.shape, t.dtype) - flat.numel()
                if pad:
                    pieces.append(flat.new_zeros(pad))
            ops.append(dist.P2POp(dist.isend, torch.cat(pieces), peer))
        specs = recvs.get(peer, [])
        if specs:
            dims = max(1, sum(len(sh) for sh, _, _ in specs))
            inbox[peer] = torch.empty(_nbytes((dims,), torch.int64) + sum(_nbytes(sh, dt) for sh, dt, _ in specs),
                                      dtype=torch.uint8, device=stage)
            ops.append(dist.P2POp(dist.irecv, inbox[peer], peer))
    if ops:
        with _cuda_context(stage):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    got = {}
    for peer, specs in recvs.items():
        dims = max(1, sum(len(sh) for sh, _, _ in specs))
        head = inbox[peer][: 8 * dims].view(torch.int64).tolist()
        o, got[peer] = _nbytes((dims,), torch.int64), []
        for shape, dtype, device in specs:
            order, head = head[: len(shape)], head[len(shape):]
            n = math.prod(shape) * dtype.itemsize
            t = inbox[peer][o : o + n].view(dtype).view([shape[d] for d in order])
            got[peer].append(t.permute([order.index(d) for d in range(len(shape))]).to(device))
            o += _nbytes(shape, dtype)
    return got


class Move(NamedTuple):
    """One tensor from process ``src`` to process ``dst``: its ``shape`` and
    ``dtype``, the ``device`` where ``dst`` puts it, and ``arg``, its index
    among the sender's inputs."""

    src: int
    dst: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    arg: int


def _by_peer(moves, me: int, sending: bool) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for mv in moves:
        if (mv.src if sending else mv.dst) == me:
            out.setdefault(mv.dst if sending else mv.src, []).append(mv)
    return out


def _take(got: Dict[int, list], moves, me: int, sending: bool) -> list:
    """The received tensors in move order."""
    seen = {p: 0 for p in got}
    out = []
    for mv in moves:
        if (mv.src if sending else mv.dst) == me:
            peer = mv.dst if sending else mv.src
            out.append(got[peer][seen[peer]])
            seen[peer] += 1
    return out


class _Exchange(torch.autograd.Function):
    """Moves between processes: the forward sends each move's input to its
    ``dst``; the backward sends each received tensor's gradient back to its
    ``src``, where the gradients of an input sent to several places are
    summed in move order."""

    @staticmethod
    def forward(ctx, moves, link, token, *xs):
        me = link.rank
        got = exchange({p: [xs[mv.arg] for mv in mvs] for p, mvs in _by_peer(moves, me, True).items()},
                       {p: [(mv.shape, mv.dtype, mv.device) for mv in mvs]
                        for p, mvs in _by_peer(moves, me, False).items()}, link.stage)
        ctx.moves, ctx.link = moves, link
        ctx.inputs = [x.device for x in xs]
        return (token.new_zeros(()), *_take(got, moves, me, False))

    @staticmethod
    @once_differentiable
    def backward(ctx, dtoken, *douts):
        me, moves = ctx.link.rank, ctx.moves
        grads = dict(zip([i for i, mv in enumerate(moves) if mv.dst == me], douts))
        sends: Dict[int, list] = {}
        for i, mv in enumerate(moves):
            if mv.dst == me:
                g = grads[i]
                sends.setdefault(mv.src, []).append(
                    g if g is not None else torch.zeros(mv.shape, dtype=mv.dtype, device=mv.device))
        got = exchange(sends, {p: [(mv.shape, mv.dtype, ctx.inputs[mv.arg]) for mv in mvs]
                               for p, mvs in _by_peer(moves, me, True).items()}, ctx.link.stage)
        dxs = [None] * len(ctx.inputs)
        for mv, g in zip([mv for mv in moves if mv.src == me], _take(got, moves, me, True)):
            dxs[mv.arg] = g if dxs[mv.arg] is None else dxs[mv.arg] + g
        return (None, None, torch.zeros((), device=ctx.link.token_device), *dxs)


class _Gather(torch.autograd.Function):
    """Parts of one tensor, held by several processes, joined along ``dim``
    on every one of them. Every process then computes the same function of
    the whole, so the backward hands each local part its own slice of the
    gradient, without communication."""

    @staticmethod
    def forward(ctx, owners, members, shapes, dim, dtype, device, link, token, *parts):
        me = link.rank
        mine = [i for i, r in enumerate(owners) if r == me]
        peers = [p for p in members if p != me]
        got = exchange({p: list(parts) for p in peers} if parts else {},
                       {p: [(shapes[i], dtype, device) for i, r in enumerate(owners) if r == p]
                        for p in peers if p in owners}, link.stage)
        local, seen, whole = dict(zip(mine, parts)), {p: 0 for p in peers}, []
        for i, r in enumerate(owners):
            if r == me:
                whole.append(local[i].to(device))
            else:
                whole.append(got[r][seen[r]])
                seen[r] += 1
        ctx.mine, ctx.sizes, ctx.dim = mine, [sh[dim] for sh in shapes], dim
        ctx.devices, ctx.token_device = [p.device for p in parts], token.device
        return token.new_zeros(()), torch.cat(whole, dim=dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, dtoken, dwhole):
        pieces = dwhole.split(ctx.sizes, dim=ctx.dim)
        return (None, None, None, None, None, None, None, torch.zeros((), device=ctx.token_device),
                *[pieces[i].to(d) for i, d in zip(ctx.mine, ctx.devices)])


class Link:
    """The crossings of one forward through a mesh that spans processes:
    this process's rank, the staging device of its traffic
    (:func:`staging_device`) and the token that orders the crossings
    (module docstring). Every process of a crossing makes the same calls in
    the same order: the network's program order. The token lies on
    ``device``, the card the forward's output lands on: autograd runs a
    node on the thread of its gradients' card, so a crossing that only
    sends runs on that card's thread too, in order with the rest of the
    backward there (on the CPU's thread it would add its gradients
    concurrently, in an order that varies from run to run)."""

    def __init__(self, stage, device) -> None:
        self.rank = host_id()
        self.stage = stage
        self.token_device = torch.device(device)
        self.token = torch.zeros((), device=device, requires_grad=torch.is_grad_enabled())

    def move(self, moves: Sequence[Move], xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The tensors of ``moves`` that this process receives, in move
        order; ``xs`` are those it sends (``Move.arg`` indexes them)."""
        out = _Exchange.apply(tuple(moves), self, self.token, *xs)
        self.token = out[0]
        return list(out[1:])

    def gather(self, owners: Sequence[int], members: Sequence[int], shapes, parts: Sequence[torch.Tensor], dim: int,
               dtype, device) -> torch.Tensor:
        """The whole tensor, on this process's ``device``, of the parts that
        the processes ``owners`` hold (``shapes[i]`` each; ``parts`` are
        this process's, in order), joined along ``dim`` on every process of
        ``members`` (every one of them makes this call)."""
        self.token, whole = _Gather.apply(tuple(owners), tuple(members), tuple(tuple(s) for s in shapes), dim, dtype,
                                          device, self, self.token, *parts)
        return whole

    def sync(self, token: torch.Tensor) -> None:
        """Continue the order from ``token``, the token output of a
        crossing made outside :meth:`move` and :meth:`gather` (the sharded
        GroupNorm's)."""
        self.token = token
