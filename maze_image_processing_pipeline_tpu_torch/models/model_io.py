"""Model checkpoints: the JAX package's directory format, read into PyTorch.

A checkpoint is a directory with ``meta.json`` (architecture + metadata)
and ``params.msgpack`` (the flax parameter tree), as written by
``maze_image_processing_pipeline_tpu.models.save_model``. This module reads
it without flax or the ``msgpack`` package:

* :func:`msgpack_restore` — a small decoder for the msgpack subset flax
  writes (maps, arrays, strings, binaries, numbers, and the ndarray and
  numpy-scalar extension types);
* :func:`params_from_jax` — a flax parameter tree → a state dict of the
  port's modules, which carry the flax module names (conv kernels HWIO →
  OIHW, ``kernel``/``scale`` → ``weight``). It is the inverse of the JAX
  package's ``import_torch_state_dict``;
* :func:`load_model` — meta.json + params.msgpack → :class:`LoadedModel`;
* :func:`init_unet_params` — seeded random U-Net parameters in the flax
  layout (a stand-in for a trained checkpoint).
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

from .unet import UNet

__all__ = [
    "LoadedModel",
    "build_model",
    "load_model",
    "msgpack_restore",
    "params_from_jax",
    "init_unet_params",
]

_ARCHITECTURES: Dict[str, type] = {"unet": UNet}


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
            arr = np.asarray(v, dtype=np.float32)
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

    def conv(k: int, ci: int, co: int):
        w = rng.standard_normal((k, k, ci, co)) * np.sqrt(1.0 / (k * k * ci))
        return {"kernel": w.astype(np.float32), "bias": np.zeros(co, np.float32)}

    def block(ci: int, f: int):
        d = {}
        for k in range(2):
            d[f"Conv_{k}"] = conv(3, ci if k == 0 else f, f)
            if norm:
                d[f"GroupNorm_{k}"] = {
                    "scale": np.ones(f, np.float32),
                    "bias": np.zeros(f, np.float32),
                }
        return d

    p: Dict[str, Any] = {}
    for i in range(depth):
        p[f"ConvBlock_{i}"] = block(cin, base * 2**i)
        cin = base * 2**i
    p[f"ConvBlock_{depth}"] = block(cin, base * 2**depth)
    for i in reversed(range(depth)):
        f = base * 2**i
        p[f"Conv_{depth - 1 - i}"] = conv(2, 2 * f, f)
        p[f"ConvBlock_{2 * depth - i}"] = block(2 * f, f)
    p[f"Conv_{depth}"] = conv(1, base, out_ch)
    return {"params": p}


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
