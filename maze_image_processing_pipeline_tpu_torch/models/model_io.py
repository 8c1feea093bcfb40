"""Model checkpoints: the JAX package's directory format, in PyTorch.

A checkpoint is a directory with ``meta.json`` (architecture + metadata)
and ``params.msgpack`` (the flax parameter tree), as written by
``maze_image_processing_pipeline_tpu.models.save_model``. This module reads
and writes it without flax or the ``msgpack`` package:

* :func:`msgpack_restore` — a small decoder for the msgpack subset flax
  writes (maps, arrays, strings, binaries, numbers, and the ndarray and
  numpy-scalar extension types);
* :func:`params_from_jax` — a flax parameter tree → a state dict of the
  port's modules, which carry the flax module names (conv kernels HWIO →
  OIHW, ``kernel``/``scale`` → ``weight``). It is the inverse of the JAX
  package's ``import_torch_state_dict``;
* :func:`import_torch_state_dict` — a copy of that function: a torch state
  dict of a module that mirrors the flax architecture layer for layer → the
  flax tree of ``flax_params``' layout (so a reference TorchScript
  checkpoint's weights reach the port through :func:`params_from_jax`);
* :func:`load_model` — meta.json + params.msgpack → :class:`LoadedModel`;
* :func:`msgpack_serialize`, :func:`params_to_jax` and :func:`save_model`
  — the inverse: a module → a checkpoint directory that the JAX package's
  ``load_model`` reads (the counterpart of its ``save_model``);
* :func:`init_unet_params`, :func:`init_classifier_params` — seeded random
  U-Net and classifier parameters in the flax layout (the train state's
  initial parameters, and stand-ins for trained checkpoints);
* :func:`adam_state_from_optax` — optax's Adam moments → the state of the
  port's ``torch.optim.AdamW``, so that a JAX train state continues in the
  port (``models/train.py``).
"""

from __future__ import annotations

import inspect
import json
import os
import struct
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import tracing
from .classifier import ConvClassifier
from .unet import _DTYPES, UNet

__all__ = [
    "LoadedModel",
    "build_model",
    "load_model",
    "msgpack_restore",
    "msgpack_serialize",
    "params_from_jax",
    "params_to_jax",
    "import_torch_state_dict",
    "adam_state_from_optax",
    "save_model",
    "init_unet_params",
    "init_classifier_params",
]

_ARCHITECTURES: Dict[str, type] = {"unet": UNet, "conv_classifier": ConvClassifier}


@dataclass
class LoadedModel:
    """A ready-to-run model: the module (parameters loaded) and its meta."""

    module: nn.Module
    meta: Dict = field(default_factory=dict)


def build_model(arch_type: str, config: Mapping) -> nn.Module:
    """Instantiate a registered architecture from its meta.json config.

    Config keys the port's class does not take are dropped: they select
    TPU evaluation orders of the same math (e.g. the U-Net's ``s2d``)."""
    if arch_type not in _ARCHITECTURES:
        raise ValueError(f"Unknown architecture {arch_type!r}; known: {sorted(_ARCHITECTURES)}")
    cls = _ARCHITECTURES[arch_type]
    accepted = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in config.items() if k in accepted})


# -- msgpack ---------------------------------------------------------------


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_restore(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen exactly
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == 1:  # ndarray
        return _ndarray(data)
    if code == 3:  # numpy scalar, packed as a 0-d ndarray
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):  # noqa: C901 - one branch per msgpack format byte
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sizes:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[t])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return self.take(self.unpack(strs[t])).decode()
        nums = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in nums:
            return self.unpack(nums[t])
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[t])))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack format byte 0x{t:02x}")

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def msgpack_restore(data: bytes):
    """Decode msgpack bytes as written by ``flax.serialization.to_bytes``."""
    r = _Reader(memoryview(data).tobytes() if not isinstance(data, bytes) else data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


class _Writer:
    """msgpack in the encodings ``msgpack.packb(..., use_bin_type=True)``
    picks: the smallest format for each length and integer."""

    def __init__(self) -> None:
        self.parts: list = []

    def sized(self, n: int, small: Optional[int], limit: int, codes) -> None:
        if small is not None and n < limit:
            self.parts.append(bytes([small | n]))
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack object too large ({n})")

    def obj(self, x) -> None:  # noqa: C901 - one branch per msgpack type
        if x is None or isinstance(x, bool):
            self.parts.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[x])
        elif isinstance(x, np.ndarray):
            self.ext(1, _ndarray_bytes(x))
        elif isinstance(x, np.generic):
            self.ext(3, _ndarray_bytes(np.asarray(x)))
        elif isinstance(x, int):
            if 0 <= x < 0x80 or -32 <= x < 0:
                self.parts.append(struct.pack(">b" if x < 0 else ">B", x))
            elif x >= 0:
                self.sized(x, None, 0, [(0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")])
            else:
                for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                    if x >= lo:
                        self.parts.append(bytes([code]) + struct.pack(fmt, x))
                        break
        elif isinstance(x, float):
            self.parts.append(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            b = x.encode()
            self.sized(len(b), 0xA0, 32, [(0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")])
            self.parts.append(b)
        elif isinstance(x, (bytes, bytearray)):
            self.sized(len(x), None, 0, [(0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")])
            self.parts.append(bytes(x))
        elif isinstance(x, (list, tuple)):
            self.sized(len(x), 0x90, 16, [(0xDC, ">H"), (0xDD, ">I")])
            for v in x:
                self.obj(v)
        elif isinstance(x, Mapping):
            self.sized(len(x), 0x80, 16, [(0xDE, ">H"), (0xDF, ">I")])
            for k in sorted(x):  # flax flattens the tree first, sorting keys
                self.obj(k)
                self.obj(x[k])
        else:
            raise TypeError(f"cannot serialize {type(x).__name__} to msgpack")

    def ext(self, code: int, data: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            self.parts.append(bytes([fixed[len(data)]]))
        else:
            self.sized(len(data), None, 0, [(0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")])
        self.parts.append(struct.pack(">b", code) + data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > 2**30:
        raise ValueError("arrays above 1 GiB need flax's chunked format, which is not written here")
    w = _Writer()
    w.obj((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    return b"".join(w.parts)


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists and numpy arrays as
    ``flax.serialization.msgpack_serialize`` does: dict keys sorted, arrays
    as msgpack extension 1, numpy scalars as extension 3."""
    w = _Writer()
    w.obj(tree)
    return b"".join(w.parts)


# -- parameters -------------------------------------------------------------


def params_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree (numpy leaves) → the port's state dict.

    Module paths join with ``.``; ``kernel`` becomes ``weight`` (4-D conv
    kernels HWIO → OIHW, 2-D dense kernels (in, out) → (out, in)),
    ``scale`` becomes ``weight``, every other leaf keeps its name. A
    top-level ``params`` collection is unwrapped.
    """
    if set(params) == {"params"}:
        params = params["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            arr = np.array(v, dtype=np.float32)  # a copy: JAX arrays give read-only views
            name = k
            if k == "kernel":
                name = "weight"
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
            elif k == "scale":
                name = "weight"
            out[".".join(path + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, ())
    return out


def import_torch_state_dict(state_dict: Dict, flax_params: Dict) -> Dict:
    """Map a torch state dict onto a flax param pytree of the same topology.

    Modules are matched in order: the nested flax params dict is walked in
    INSERTION order (= flax module call order; ``tree_flatten_with_path``
    would sort alphabetically, putting ``bias`` before ``kernel`` and
    ``ConvBlock_10`` before ``ConvBlock_2``), and the torch state dict is
    grouped by submodule prefix in its own order — so the torch module must
    mirror the flax architecture layer-for-layer *in definition order*.
    Within each module, params match by name: torch ``weight`` → flax
    ``kernel`` (conv OIHW → HWIO, linear (out, in) → (in, out)) or
    ``scale`` (norm layers), ``bias`` → ``bias``.
    """

    def walk(d, path=()):
        for k, v in d.items():
            if isinstance(v, Mapping) or hasattr(v, "items"):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    flax_modules: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, leaf in walk(flax_params):
        flax_modules.setdefault(path[:-1], {})[path[-1]] = leaf

    torch_modules: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in state_dict.items():
        if "num_batches_tracked" in k:
            continue
        prefix, _, name = k.rpartition(".")
        torch_modules.setdefault(prefix, {})[name] = np.asarray(v)

    if len(flax_modules) != len(torch_modules):
        raise ValueError(
            f"Module count mismatch: flax {len(flax_modules)} "
            f"({list(flax_modules)}) vs torch {len(torch_modules)} "
            f"({list(torch_modules)})"
        )

    out: Dict = {}  # fresh nested dicts: works for FrozenDict inputs too

    def assign(d, path, value):
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = value

    for (fpath, fleaves), (tname, tleaves) in zip(
        flax_modules.items(), torch_modules.items()
    ):
        # Every torch param must be CONSUMED, not just every flax param
        # satisfied: e.g. a torch BatchNorm ({weight, bias, running_mean,
        # running_var}) zipped against a flax GroupNorm ({scale, bias})
        # would otherwise "import" while silently dropping the running
        # statistics the checkpoint's semantics depend on.
        consumed = {
            "weight" if ln in ("kernel", "scale") and "weight" in tleaves else ln
            for ln in fleaves
        }
        unconsumed = set(tleaves) - consumed
        if unconsumed:
            raise ValueError(
                f"Torch module '{tname}' has params {sorted(unconsumed)} "
                f"with no counterpart in flax module {fpath} "
                f"({sorted(fleaves)}) — the architectures differ "
                "(e.g. BatchNorm running stats vs a stateless norm)."
            )
        for leaf_name, target in fleaves.items():
            if leaf_name in ("kernel", "scale") and "weight" in tleaves:
                arr = tleaves["weight"]
                if leaf_name == "kernel" and arr.ndim == 4:
                    arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
                elif leaf_name == "kernel" and arr.ndim == 2:
                    arr = arr.T  # (out, in) -> (in, out)
            elif leaf_name in tleaves:
                arr = tleaves[leaf_name]
            else:
                raise ValueError(
                    f"No torch param for {fpath + (leaf_name,)} in "
                    f"{tname} ({sorted(tleaves)})"
                )
            target = np.asarray(target)
            if arr.shape != target.shape:
                raise ValueError(
                    f"Shape mismatch at {fpath + (leaf_name,)} / {tname}: "
                    f"{arr.shape} vs {target.shape}"
                )
            assign(out, fpath + (leaf_name,), arr.astype(target.dtype))

    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's state dict → a flax parameter tree (``{"params": ...}``,
    float32 numpy leaves); the inverse of :func:`params_from_jax`.

    ``weight`` becomes ``kernel`` (4-D conv weights OIHW → HWIO, 2-D dense
    weights (out, in) → (in, out)) or, 1-D, a norm's ``scale``; every other
    leaf keeps its name.
    """
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            else:
                name = "scale"
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[name] = np.ascontiguousarray(arr)
    return {"params": tree}


def _adam_moments(opt_state):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (``ScaleByAdamState``), searched through tuples and lists."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_moments(child)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, module: nn.Module) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax's ``adamw`` / ``adam`` state → the ``"state"`` entry of
    ``torch.optim.AdamW.state_dict()`` for ``module.parameters()``.

    ``ScaleByAdamState``'s ``count``, ``mu`` and ``nu`` (flax parameter
    trees, numpy or JAX leaves) become each parameter's ``step``,
    ``exp_avg`` and ``exp_avg_sq``, laid out as :func:`params_from_jax` lays
    out the parameters. Load it with::

        sd = optimizer.state_dict()
        sd["state"] = adam_state_from_optax(opt_state, module)
        optimizer.load_state_dict(sd)
    """
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("adam_state_from_optax: no ScaleByAdamState (count, mu, nu) in the optax state")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    names = [name for name, _ in module.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError(f"adam_state_from_optax: moments for {sorted(set(mu) ^ set(names))} do not match the module")
    step = float(np.asarray(adam.count))
    return {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in enumerate(names)
    }


def _lecun_conv(rng, k: int, ci: int, co: int) -> Dict:
    w = rng.standard_normal((k, k, ci, co)) * np.sqrt(1.0 / (k * k * ci))
    return {"kernel": w.astype(np.float32), "bias": np.zeros(co, np.float32)}


def _ones_zeros(f: int) -> Dict:
    return {"scale": np.ones(f, np.float32), "bias": np.zeros(f, np.float32)}


def init_unet_params(config: Mapping, seed: int = 0) -> Dict:
    """Seeded random U-Net parameters in the flax layout and order.

    Conv kernels are normal with variance 1/fan_in (flax's default
    ``lecun_normal`` scale), biases zero, GroupNorm scales one. ``config``
    holds the meta.json U-Net fields (``out_channels``, ``base_features``,
    ``depth``, ``norm``; ``in_channels`` defaults to 3).
    """
    rng = np.random.default_rng(seed)
    base = int(config.get("base_features", 32))
    depth = int(config.get("depth", 4))
    out_ch = int(config.get("out_channels", 2))
    norm = bool(config.get("norm", True))
    cin = int(config.get("in_channels", 3))

    def block(ci: int, f: int):
        d = {}
        for k in range(2):
            d[f"Conv_{k}"] = _lecun_conv(rng, 3, ci if k == 0 else f, f)
            if norm:
                d[f"GroupNorm_{k}"] = _ones_zeros(f)
        return d

    p: Dict[str, Any] = {}
    for i in range(depth):
        p[f"ConvBlock_{i}"] = block(cin, base * 2**i)
        cin = base * 2**i
    p[f"ConvBlock_{depth}"] = block(cin, base * 2**depth)
    for i in reversed(range(depth)):
        f = base * 2**i
        p[f"Conv_{depth - 1 - i}"] = _lecun_conv(rng, 2, 2 * f, f)
        p[f"ConvBlock_{2 * depth - i}"] = block(2 * f, f)
    p[f"Conv_{depth}"] = _lecun_conv(rng, 1, base, out_ch)
    return {"params": p}


def init_classifier_params(config: Mapping, seed: int = 0) -> Dict:
    """Seeded random ``ConvClassifier`` parameters in the flax layout and
    order: conv and dense kernels normal with variance 1/fan_in, biases
    zero, GroupNorm scales one. ``config`` holds the meta.json classifier
    fields (``n_outputs``, ``features``, ``norm``; ``in_channels`` defaults
    to 3)."""
    rng = np.random.default_rng(seed)
    features = [int(f) for f in config.get("features", (32, 64, 128, 256))]
    n_out = int(config.get("n_outputs", 32))
    norm = bool(config.get("norm", True))
    cin = int(config.get("in_channels", 3))
    p: Dict[str, Any] = {}
    for s, f in enumerate(features):
        for k in (2 * s, 2 * s + 1):
            p[f"Conv_{k}"] = _lecun_conv(rng, 3, cin, f)
            if norm:
                p[f"GroupNorm_{k}"] = _ones_zeros(f)
            cin = f
    for k, (fi, fo) in enumerate([(cin, features[-1]), (features[-1], n_out)]):
        w = rng.standard_normal((fi, fo)) * np.sqrt(1.0 / fi)
        p[f"Dense_{k}"] = {"kernel": w.astype(np.float32), "bias": np.zeros(fo, np.float32)}
    return {"params": p}


@tracing.span("model.load")
def load_model(model_fn: str, dtype: Optional[str] = None) -> LoadedModel:
    """Load a checkpoint directory (or its params.msgpack path).

    ``dtype`` overrides the compute dtype of architectures that have one.
    The module comes back in eval mode on the CPU.
    """
    model_dir = model_fn
    if model_dir.endswith(".msgpack"):
        model_dir = os.path.dirname(model_dir)
    with open(os.path.join(model_dir, "meta.json")) as f:
        meta = json.load(f)
    arch = meta.get("architecture") or {}
    config = dict(arch.get("config", {}))
    arch_type = arch.get("type")
    cls = _ARCHITECTURES.get(arch_type)
    if dtype is not None and cls is not None and "dtype" in inspect.signature(cls).parameters:
        config["dtype"] = dtype
    module = build_model(arch_type, config)
    with open(os.path.join(model_dir, "params.msgpack"), "rb") as f:
        params = msgpack_restore(f.read())
    module.load_state_dict(params_from_jax(params))
    meta = dict(meta)
    meta["architecture"] = {"type": arch_type, "config": config}
    return LoadedModel(module.eval(), meta)


def _config_value(value):
    if isinstance(value, torch.dtype):
        return {v: k for k, v in _DTYPES.items()}[value]
    if isinstance(value, tuple):
        return list(value)
    return value


def save_model(
    model_dir: str,
    module: nn.Module,
    *,
    outputs: Optional[Dict[str, Dict]] = None,
    extra_meta: Optional[Dict] = None,
) -> None:
    """Write ``module`` as a checkpoint directory: ``params.msgpack`` in
    flax's msgpack format and ``meta.json``.

    The counterpart of the JAX package's ``save_model``: the JAX package's
    ``load_model`` reads what this writes, and :func:`load_model` reads what
    either writes. The architecture's config holds the module's
    ``config_fields`` (the fields the flax module shares with it; the U-Net's
    ``in_channels`` is not one), else every constructor argument the module
    keeps as an attribute.
    """
    arch_type = {v: k for k, v in _ARCHITECTURES.items()}[type(module)]
    names = getattr(type(module), "config_fields", None)
    if names is None:
        names = [n for n in inspect.signature(type(module)).parameters if hasattr(module, n)]
    config = {n: _config_value(getattr(module, n)) for n in names}
    meta = {
        "format": "maze-ipp-tpu-model",
        "architecture": {"type": arch_type, "config": config},
    }
    if outputs is not None:
        meta["outputs"] = outputs
    if extra_meta:
        meta.update(extra_meta)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(params_to_jax(module.state_dict())))
    with open(os.path.join(model_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
