"""U-Net semantic segmentation model.

Counterpart of ``UNet`` in ``maze_image_processing_pipeline_tpu/models/unet.py``
on its canonical path (no phase packing): per level a ConvBlock of two
(3×3 conv → GroupNorm → ReLU), 2×2 max pooling down, nearest 2× upsampling
and a 2×2 "same" conv up, the skip concatenated first, and a 1×1 head in
float32.

``forward`` takes and returns NHWC, like the JAX model; inside, tensors are
NCHW. Convolutions and norms run in the compute ``dtype`` (bfloat16 or
float32); parameters stay float32. Submodules carry the flax module names
(``ConvBlock_0.Conv_0`` ...), so a flax checkpoint maps onto the state dict
by name (:func:`.model_io.params_from_jax`).

:class:`ShardedUNet` runs the same U-Net over a mesh's ``space`` and
``model`` cards (one group of them a ``data`` index), with its weights
placed as ``parallel.mesh.shard_params`` places them; its placement, halo,
gather and norm helpers (:class:`ShardedNet`) serve the sharded
classifier too (``models.classifier.ShardedClassifier``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import mesh_grid, place_params, sharded_names, space_rows
from ..parallel.multihost import Link, Move, all_gather_objects, exchange, host_id, staging_device
from .layers import GroupNorm, group_norm, sharded_group_norm

__all__ = ["UNet", "ConvBlock", "ShardedNet", "ShardedUNet"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, padding, stride: int = 1) -> torch.Tensor:
    """``conv`` evaluated in ``dtype`` (weights cast, parameters untouched)."""
    x = x.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=stride, padding=padding)


class ConvBlock(nn.Module):
    """Two (3×3 conv → GroupNorm(min(8, features)) → ReLU)."""

    def __init__(self, in_features: int, features: int, norm: bool = True) -> None:
        super().__init__()
        self.norm = norm
        groups = min(8, features)
        for k in range(2):
            setattr(self, f"Conv_{k}", nn.Conv2d(in_features if k == 0 else features, features, 3))
            if norm:
                setattr(self, f"GroupNorm_{k}", GroupNorm(groups, features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for k in range(2):
            x = _conv(getattr(self, f"Conv_{k}"), x, dtype, padding=1)
            if self.norm:
                x = getattr(self, f"GroupNorm_{k}")(x)
            x = F.relu(x)
        return x


class UNet(nn.Module):
    """Encoder-decoder with skip connections.

    Args:
        out_channels: output mask channels.
        base_features: width of the first level; doubles per level.
        depth: number of down/up-sampling levels.
        dtype: compute dtype (``torch.bfloat16``/``torch.float32`` or their
            names); parameters stay float32.
        norm: GroupNorm after every conv.
        in_channels: input channels (3: gray frames are broadcast to RGB).
    """

    # The meta.json config a checkpoint records; the flax U-Net takes the
    # same fields (it has no in_channels: it reads them off its input).
    config_fields = ("out_channels", "base_features", "depth", "dtype", "norm")

    def __init__(
        self,
        out_channels: int = 2,
        base_features: int = 32,
        depth: int = 4,
        dtype=torch.bfloat16,
        norm: bool = True,
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.base_features = base_features
        self.depth = depth
        self.dtype = _dtype(dtype)
        self.norm = norm
        # Registered in the flax module's call order (= its parameter order).
        cin = in_channels
        for i in range(depth):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, base_features * 2**i, norm))
            cin = base_features * 2**i
        setattr(self, f"ConvBlock_{depth}", ConvBlock(cin, base_features * 2**depth, norm))
        for i in reversed(range(depth)):
            feats = base_features * 2**i
            setattr(self, f"Conv_{depth - 1 - i}", nn.Conv2d(2 * feats, feats, 2))
            setattr(self, f"ConvBlock_{2 * depth - i}", ConvBlock(2 * feats, feats, norm))
        setattr(self, f"Conv_{depth}", nn.Conv2d(base_features, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, H, W, out_channels) float32 logits."""
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"ConvBlock_{i}")(x, dt)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{self.depth}")(x, dt)
        for i in reversed(range(self.depth)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            # "SAME" for a 2×2 kernel pads (0, 1) on each axis, as in flax.
            x = F.pad(x, (0, 1, 0, 1))
            x = _conv(getattr(self, f"Conv_{self.depth - 1 - i}"), x, dt, padding=0)
            x = torch.cat([skips[i], x], dim=1)
            x = getattr(self, f"ConvBlock_{2 * self.depth - i}")(x, dt)
        head = getattr(self, f"Conv_{self.depth}")
        logits = F.conv2d(x.float(), head.weight, head.bias)
        return logits.permute(0, 2, 3, 1)


class _Act:
    """An activation of a sharded network's group: ``split`` over ``model``
    (``t[s][m]``: shard s's rows, slice m of the channels, on card (s, m))
    or whole (``t[s]``: shard s's rows, every channel, on card (s, 0)).
    Whole copies on other cards are made when asked for, once. A tensor of
    a card of another process is a ``meta`` tensor of its shape."""

    def __init__(self, split: bool, t) -> None:
        self.split = split
        self.t = t
        self.copies: Dict[Tuple[int, int], torch.Tensor] = {}


class ShardedNet:
    """A network over a mesh: each ``data`` index runs one copy of it on its
    group of ``space`` × ``model`` cards. The placement and the activation
    helpers that :class:`ShardedUNet` and
    ``models.classifier.ShardedClassifier`` share.

    * Placement: ``parallel.mesh.place_params``: every card holds the wide
      layers' slice of output channels that its ``model`` index takes, and
      every other parameter whole. Each card's tensors are leaves of their
      own; :meth:`parameters` are those of the first ``data`` and ``space``
      index (the owners, one of each slice), :meth:`reduce_grads` sums every
      copy's gradient onto its owner and :meth:`sync` copies the owners'
      values back to the other copies.
    * ``space``: image rows cut into shares, one a ``space`` card; a conv
      takes halo rows from the neighbouring shares (:meth:`_halo`), zeros at
      the image's top and bottom. A shard with no rows takes no part.
    * ``model``: a split layer's card computes its slice of the output
      channels from the whole input; the slices are gathered onto a card
      where an op needs every channel (:meth:`_whole`). A whole layer runs
      once a row shard, on the card of ``model`` index 0, and its output is
      copied where a split layer needs it.
    * Norms: a norm whose groups lie whole on one card runs the unsharded
      K5/K6 there; any other (rows over several cards, or a group that
      straddles slices) is ``layers.sharded_group_norm`` over the shards
      that hold its groups (:meth:`_norm`).

    Halos, gathers and copies are tensor copies between the cards of the
    process; autograd carries the backward through them. The result equals
    the unsharded network's within float tolerance.

    A mesh may span processes (``parallel.mesh.make_mesh`` in a
    ``torch.distributed`` group): every process then runs the same program
    (SPMD), computes on its own cards only and keeps a ``meta`` tensor, the
    shape alone, for each tensor of another process's card. A copy between
    two processes' cards goes through the forward's
    ``parallel.multihost.Link`` (its backward is the transposed copy), and
    so do the sharded norm's sums; a group's output is gathered onto every
    process of the group (:meth:`home`), each of which computes the same
    loss from it. :meth:`parameters` are this process's owners,
    :meth:`reduce_grads` sums each slice's copies across processes onto its
    owner in the same (data, space, model) order, :meth:`sync` sends the
    owners' values to the other processes' copies, and :meth:`state_dict`
    and :meth:`grads` gather the whole tensors on every process.

    Args:
        module: the network (its configuration and parameters; the module
            itself is not changed). Its ``dtype`` is the compute dtype,
            ``norm`` whether its convs are followed by GroupNorms.
        mesh: a ``parallel.mesh.Mesh``.
        space: False folds the ``space`` axis into ``data`` (inference,
            which splits batches only, as the JAX package's).
    """

    def __init__(self, module: nn.Module, mesh, space: bool = True) -> None:
        grid = mesh_grid(mesh)
        ranks = mesh_grid(mesh, of=mesh.processes)
        if not space:
            grid = grid.reshape(-1, 1, grid.shape[2])
            ranks = ranks.reshape(-1, 1, ranks.shape[2])
        self.module = module
        self.grid = grid
        self.ranks = ranks
        self.rank = host_id()
        self.split = set(sharded_names(module, grid.shape[2]))
        self.names = [n for n, _ in module.named_parameters()]
        self.params = place_params(module, grid, processes=ranks)
        for held in self.params.values():
            for t in held.values():
                if not t.is_meta:
                    t.requires_grad_(True)
        # Where this process stages its traffic to the others (None: the
        # mesh is this process's alone).
        self.stage = staging_device(mesh.local_devices()) if mesh.spans_processes else None

    # -- the parameters ----------------------------------------------------

    @property
    def groups(self) -> int:
        return self.grid.shape[0]

    def root(self, group: int = 0) -> torch.device:
        """The card that takes a group's input and returns its output."""
        return self.grid[group, 0, 0]

    def rows(self, H: int) -> List[slice]:
        """The non-empty ``space`` shares of ``H`` image rows."""
        raise NotImplementedError

    def takes_part(self, group: int, H: int) -> bool:
        """Whether this process holds a card of ``group`` that computes on
        images of ``H`` rows."""
        return bool((self.ranks[group, : len(self.rows(H))] == self.rank).any())

    def home(self, group: int, H: int) -> torch.device:
        """The card of this process where a group's output lands: the
        group's root, or on another process of the group its first card
        there that computes."""
        ranks = self.ranks[group, : len(self.rows(H))]
        return next(self.grid[group][i] for i in np.ndindex(ranks.shape) if ranks[i] == self.rank)

    def _here(self, idx) -> bool:
        return self.ranks[idx] == self.rank

    def _holders(self, name: str):
        """(owner index, [every index holding the same tensor]) for each
        slice of parameter ``name``."""
        D, S, M = self.grid.shape
        if name in self.split:
            return [((0, 0, m), [(d, s, m) for d in range(D) for s in range(S)]) for m in range(M)]
        return [((0, 0, 0), list(np.ndindex(D, S, M)))]

    def _slices(self):
        return [(n, o, idxs) for n in self.names for o, idxs in self._holders(n)]

    def parameters(self) -> List[torch.Tensor]:
        """This process's owners' tensors (what its optimizer updates), in
        the module's parameter order."""
        return [self.params[o][n] for n, o, _ in self._slices() if self._here(o)]

    def zero_grad(self) -> None:
        for held in self.params.values():
            for t in held.values():
                t.grad = None

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each owner's gradient := the sum of the gradients of every copy
        of its tensor, in (data, space, model) order; a copy on another
        process sends its gradient to the owner's process first (which
        copies have one, every process learns from the others)."""
        me, slices = self.rank, self._slices()
        present = {(n, i): self.params[i][n].grad is not None for n, _, idxs in slices for i in idxs if self._here(i)}
        sends, recvs = {}, {}
        if self.stage is not None:
            for part in all_gather_objects(dict(present), self.stage):
                present.update(part)
            for n, o, idxs in slices:
                ro = self.ranks[o]
                for i in idxs:
                    ri = self.ranks[i]
                    if ri == ro or not present[(n, i)]:
                        continue
                    if ri == me:
                        sends.setdefault(ro, []).append(self.params[i][n].grad)
                    elif ro == me:
                        owner = self.params[o][n]
                        recvs.setdefault(ri, []).append((tuple(owner.shape), owner.dtype, owner.device))
        got = {p: iter(ts) for p, ts in exchange(sends, recvs, self.stage).items()} if sends or recvs else {}
        for n, o, idxs in slices:
            total = None
            if self._here(o):
                owner = self.params[o][n]
                for i in idxs:
                    if not present[(n, i)]:
                        continue
                    g = self.params[i][n].grad.to(owner.device) if self._here(i) else next(got[self.ranks[i]])
                    total = g.clone() if total is None else total + g
            for i in idxs:
                if self._here(i):
                    self.params[i][n].grad = None
            if self._here(o):
                owner.grad = total

    @torch.no_grad()
    def sync(self) -> None:
        """Copy each owner's values to the other copies of its tensor (on
        other processes through one exchange)."""
        me, sends, recvs = self.rank, {}, {}
        slices = self._slices()
        for n, o, idxs in slices:
            ro = self.ranks[o]
            for r in sorted({self.ranks[i] for i in idxs} - {ro}):
                if ro == me:
                    sends.setdefault(r, []).append(self.params[o][n])
                elif r == me:
                    first = next(i for i in idxs if self._here(i))
                    t = self.params[first][n]
                    recvs.setdefault(ro, []).append((tuple(t.shape), t.dtype, t.device))
        got = {p: iter(ts) for p, ts in exchange(sends, recvs, self.stage).items()} if self.stage is not None else {}
        for n, o, idxs in slices:
            ro = self.ranks[o]
            mine = [i for i in idxs if i != o and self._here(i)]
            if not mine:
                continue
            value = self.params[o][n] if ro == me else next(got[ro])
            for i in mine:
                self.params[i][n].copy_(value, non_blocking=True)

    def _gathered(self, attr: str) -> Dict[str, torch.Tensor]:
        parts = {(n, o): getattr(self.params[o][n], attr) for n, o, _ in self._slices() if self._here(o)}
        parts = {k: None if v is None else v.detach().cpu() for k, v in parts.items()}
        if self.stage is not None:
            for other in all_gather_objects(parts, self.stage):
                parts.update(other)
        out = {}
        for n in self.names:
            ps = [parts[(n, o)] for o, _ in self._holders(n)]
            out[n] = None if ps[0] is None else torch.cat(ps)
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole parameters (the owners' slices joined), on the CPU,
        named as the module's."""
        return self._gathered("data")

    def grads(self) -> Dict[str, torch.Tensor]:
        """The owners' gradients joined, on the CPU (after
        :meth:`reduce_grads`)."""
        return self._gathered("grad")

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Set this process's cards' tensors from whole parameters
        ``state``."""
        M = self.grid.shape[2]
        for idx, held in self.params.items():
            if not self._here(idx):
                continue
            for n, t in held.items():
                v = torch.as_tensor(state[n])
                t.copy_(v.chunk(M)[idx[2]] if n in self.split else v)

    def optimizer_state_dict(self, optimizer: torch.optim.Optimizer) -> dict:
        """``optimizer``'s state (over :meth:`parameters`) as one process
        over every owner would hold it: each process's owners' moments
        gathered (on every process), indexed in the module's parameter
        order."""
        sd = optimizer.state_dict()
        if self.stage is None:
            return sd
        slices = [(n, o) for n, o, _ in self._slices()]
        mine = [k for k, (n, o) in enumerate(slices) if self._here(o)]
        states = {mine[i]: v for i, v in sd["state"].items()}
        for other in all_gather_objects(states, self.stage):
            states.update(other)
        group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        return {"state": dict(sorted(states.items())), "param_groups": [{**group, "params": list(range(len(slices)))}]}

    def load_optimizer_state_dict(self, optimizer: torch.optim.Optimizer, sd: dict) -> None:
        """Load the state of :meth:`optimizer_state_dict` into
        ``optimizer``: this process's owners' share of it."""
        if self.stage is None:
            return optimizer.load_state_dict(sd)
        mine = [k for k, (n, o, _) in enumerate(self._slices()) if self._here(o)]
        group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        optimizer.load_state_dict({"state": {i: sd["state"][k] for i, k in enumerate(mine) if k in sd["state"]},
                                   "param_groups": [{**group, "params": list(range(len(mine)))}]})

    def __call__(self, x: torch.Tensor, group: int = 0) -> torch.Tensor:
        return self.forward(x, group)

    # -- the activations -----------------------------------------------------

    def _start(self, x: torch.Tensor, group: int, rows: List[slice]) -> _Act:
        """The group's cards for a forward over the row shares ``rows`` of
        (B, H, W, C) images ``x``: each share on its card (s, 0), NCHW in
        the compute dtype (a ``meta`` tensor on another process's card)."""
        cards = self.grid[group]
        self._group = group
        self._cards = cards[: len(rows)]
        self._ranks = self.ranks[group][: len(rows)]
        self._held = [[self.params[(group, s, m)] for m in range(cards.shape[1])] for s in range(len(rows))]
        self._link = None
        if (self._ranks != self.rank).any():
            self._home = self.home(group, x.shape[1])
            self._link = Link(self.stage, self._home)
        dt = self.module.dtype
        return _Act(False, [x[:, r].to(self._cards[s, 0] if self._ranks[s, 0] == self.rank else "meta").to(dt)
                            .permute(0, 3, 1, 2) for s, r in enumerate(rows)])

    def _each(self, act: _Act, f) -> _Act:
        return _Act(act.split, [[f(t) for t in ts] for ts in act.t] if act.split else [f(t) for t in act.t])

    def _move(self, items, at) -> List[torch.Tensor]:
        """Tensors ``(t, (s, m))`` of the group's cards onto card ``at``:
        copies within this process, the forward's link between processes;
        a ``meta`` tensor where ``at`` is another process's card."""
        me, rd = self.rank, self._ranks[at]
        out: List = [None] * len(items)
        moves, sent = [], []
        for k, (t, src) in enumerate(items):
            rs = self._ranks[src]
            if rs == rd:
                out[k] = t.to(self._cards[at]) if rs == me else t
            elif me in (rs, rd):
                moves.append((k, Move(rs, rd, tuple(t.shape), t.dtype, self._cards[at], len(sent))))
                if rs == me:
                    sent.append(t)
            else:
                out[k] = t
        if moves:
            got = self._link.move([mv for _, mv in moves], sent)
            for j, (k, mv) in enumerate(moves):
                out[k] = got[j] if rd == me else torch.empty(mv.shape, dtype=mv.dtype, device="meta")
        return out

    def _out(self, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
        """The group's output, shard parts on cards (s, 0) joined along
        ``dim`` on :meth:`home` (the root without other processes)."""
        group, S = self._group, len(parts)
        if self._link is None:
            root = self.root(group)
            return torch.cat([p.to(root) for p in parts], dim=dim)
        owners = [int(self._ranks[s, 0]) for s in range(S)]
        return self._link.gather(owners, sorted(set(self._ranks.flat)), [tuple(p.shape) for p in parts],
                                 [p for p, r in zip(parts, owners) if r == self.rank], dim, parts[0].dtype,
                                 self._home)

    def _rows(self, act: _Act, s: int, rows: slice, at) -> torch.Tensor:
        """Rows ``rows`` of shard ``s``, every channel, on card ``at``."""
        if act.split:
            return torch.cat(self._move([(t[:, :, rows], (s, m)) for m, t in enumerate(act.t[s])], at), dim=1)
        return self._move([(act.t[s][:, :, rows], (s, 0))], at)[0]

    def _whole(self, act: _Act, s: int, m: int) -> torch.Tensor:
        """Shard ``s`` with every channel on card (s, m)."""
        if not act.split and m == 0:
            return act.t[s]
        if (s, m) not in act.copies:
            act.copies[(s, m)] = self._rows(act, s, slice(None), (s, m))
        return act.copies[(s, m)]

    def _conv(self, act: _Act, name: str, conv) -> _Act:
        """Conv ``name`` of each shard, by ``conv(act, s, x, at, w, b)`` on
        shard ``s``'s every channel ``x`` on card ``at``: on each card of
        its ``model`` slices where the layer is split, else on (s, 0)."""
        dt = self.module.dtype
        split = f"{name}.weight" in self.split
        out = []
        for s in range(len(self._cards)):
            outs = []
            for m in range(self._cards.shape[1] if split else 1):
                held = self._held[s][m]
                w, b = held[f"{name}.weight"].to(dt), held[f"{name}.bias"].to(dt)
                outs.append(conv(act, s, self._whole(act, s, m), (s, m), w, b))
            out.append(outs if split else outs[0])
        return _Act(split, out)

    def _halo(self, act: _Act, s: int, rows: slice, x: torch.Tensor, at) -> torch.Tensor:
        """Rows ``rows`` of shard ``s`` on card ``at``, or a zero row beyond
        the image."""
        if 0 <= s < len(self._cards):
            return self._rows(act, s, rows, at).to(x.dtype)
        return x.new_zeros(x.shape[:2] + (1, x.shape[3]))

    def _conv3x3(self, act: _Act, s: int, x: torch.Tensor, at, w, b) -> torch.Tensor:
        """A stride-1 3×3 conv with one zero row and column on each side of
        the image: the shard alone with zero rows, then its first and last
        rows again from three-row windows that take the neighbours' rows.
        The shard itself is not copied, so autograd keeps one copy of it."""
        S = len(self._cards)
        if S == 1:
            return F.conv2d(x, w, b, padding=1)
        if x.shape[2] == 1:
            window = torch.cat([self._halo(act, s - 1, slice(-1, None), x, at), x,
                                self._halo(act, s + 1, slice(0, 1), x, at)], dim=2)
            return F.conv2d(window, w, b, padding=(0, 1))
        y = F.conv2d(x, w, b, padding=1)
        first, last = y[:, :, :1], y[:, :, -1:]
        if s > 0:
            first = F.conv2d(torch.cat([self._halo(act, s - 1, slice(-1, None), x, at), x[:, :, :2]], dim=2), w, b,
                             padding=(0, 1))
        if s < S - 1:
            last = F.conv2d(torch.cat([x[:, :, -2:], self._halo(act, s + 1, slice(0, 1), x, at)], dim=2), w, b,
                            padding=(0, 1))
        return torch.cat([first, y[:, :, 1:-1], last], dim=2)

    def _norm(self, act: _Act, name: str) -> _Act:
        """GroupNorm ``name`` (min(8, C) groups) of ``act``."""
        S = len(self._cards)
        C = sum(t.shape[1] for t in act.t[0]) if act.split else act.t[0].shape[1]
        G = min(8, C)
        Cg = C // G
        if act.split:
            M = len(act.t[0])
            Cs = C // M
            calls = ([[(s, m) for s in range(S)] for m in range(M)] if Cs % Cg == 0
                     else [[(s, m) for s in range(S) for m in range(M)]])
            offset = lambda s, m: m * Cs  # noqa: E731
            tensor = lambda s, m: act.t[s][m]  # noqa: E731
        else:
            calls = [[(s, 0) for s in range(S)]]
            offset = lambda s, m: 0  # noqa: E731
            tensor = lambda s, m: act.t[s]  # noqa: E731
        out = {}
        for call in calls:
            xs = [tensor(s, m) for s, m in call]
            offs = [offset(s, m) for s, m in call]
            ws = [self._held[s][m][f"{name}.weight"][o : o + x.shape[1]] for (s, m), o, x in zip(call, offs, xs)]
            bs = [self._held[s][m][f"{name}.bias"][o : o + x.shape[1]] for (s, m), o, x in zip(call, offs, xs)]
            if len(xs) == 1 and offs[0] % Cg == 0 and xs[0].shape[1] % Cg == 0:  # whole groups on one card
                x = xs[0]
                ys = [torch.empty_like(x) if x.is_meta else group_norm(x, ws[0], bs[0], x.shape[1] // Cg)]
            elif self._link is None:
                ys = sharded_group_norm(xs, ws, bs, offs, C, G)
            else:
                ys = sharded_group_norm(xs, ws, bs, offs, C, G, ranks=[int(self._ranks[c]) for c in call],
                                        link=self._link)
            out.update(zip(call, ys))
        if act.split:
            return _Act(True, [[out[(s, m)] for m in range(len(act.t[0]))] for s in range(S)])
        return _Act(False, [out[(s, 0)] for s in range(S)])


class ShardedUNet(ShardedNet):
    """A :class:`UNet` over a mesh (:class:`ShardedNet`): image rows cut by
    ``parallel.mesh.space_rows`` (whole multiples of ``2**depth``); before
    each 3×3 conv a shard takes one halo row from each neighbour, before
    each up-path 2×2 "SAME" conv one from the shard below. Pooling,
    upsampling and the skip concatenation stay on the shard. Built as
    ``ShardedUNet(unet, mesh, space=True)`` (:class:`ShardedNet`'s
    arguments).
    """

    def forward(self, x: torch.Tensor, group: int = 0) -> torch.Tensor:
        """(B, H, W, C) images → (B, H, W, out_channels) float32 logits on
        :meth:`home` (the root), through group ``group``'s cards."""
        u = self.module
        rows = self.rows(x.shape[1])
        act = self._start(x, group, rows)
        skips = []
        for i in range(u.depth):
            act = self._block(act, f"ConvBlock_{i}")
            skips.append(act)
            act = self._each(act, lambda t: F.max_pool2d(t, 2))
        act = self._block(act, f"ConvBlock_{u.depth}")
        for i in reversed(range(u.depth)):
            act = self._each(act, lambda t: t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
            act = self._conv(act, f"Conv_{u.depth - 1 - i}", self._conv_up)
            act = _Act(False, [torch.cat([self._whole(skips[i], s, 0), self._whole(act, s, 0)], dim=1)
                               for s in range(len(rows))])
            act = self._block(act, f"ConvBlock_{2 * u.depth - i}")
        head = f"Conv_{u.depth}"
        logits = []
        for s in range(len(rows)):
            w, b = self._held[s][0][f"{head}.weight"], self._held[s][0][f"{head}.bias"]
            if f"{head}.weight" in self.split:  # the whole weight on card (s, 0)
                w = torch.cat(self._move([(h[f"{head}.weight"], (s, m)) for m, h in enumerate(self._held[s])], (s, 0)))
                b = torch.cat(self._move([(h[f"{head}.bias"], (s, m)) for m, h in enumerate(self._held[s])], (s, 0)))
            y = F.conv2d(self._whole(act, s, 0).float(), w, b)
            logits.append(y.permute(0, 2, 3, 1))
        return self._out(logits, dim=1)

    def rows(self, H: int) -> List[slice]:
        return [r for r in space_rows(H, self.grid.shape[1], self.module.depth) if r.stop > r.start]

    def _conv_up(self, act: _Act, s: int, x: torch.Tensor, at, w, b) -> torch.Tensor:
        """The up path's 2×2 "SAME" conv (padding (0, 1) on each axis, as in
        flax): the shard with the first row of the shard below (a zero row
        at the image's bottom) and a zero column on the right."""
        x = torch.cat([x, self._halo(act, s + 1, slice(0, 1), x, at)], dim=2)
        return F.conv2d(F.pad(x, (0, 1)), w, b)

    def _block(self, act: _Act, prefix: str) -> _Act:
        """A ConvBlock: two (3×3 conv → GroupNorm → ReLU)."""
        for k in range(2):
            act = self._conv(act, f"{prefix}.Conv_{k}", self._conv3x3)
            if self.module.norm:
                act = self._norm(act, f"{prefix}.GroupNorm_{k}")
            act = self._each(act, F.relu)
        return act
