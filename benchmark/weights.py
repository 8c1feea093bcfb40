"""The configurations' weights: made once per checkout by the configuration's
architecture module, cached in the checkout.

``ensure_weights`` returns the float32 state dict (the reference's copy), a
checkpoint directory that the program's Runners load as users' models are
loaded, and the architecture module (``archs/<model.arch>.py``, found like
any other file of the benchmark: see :mod:`benchmark.archs.UNet` for what it
provides). The cache (``benchmark/_cache/weights/<config>-<key>/``) holds
``state.pt``, written here with ``torch.save``, and ``model/``, the same
parameters written by the module with the program's own checkpoint writer;
the key hashes the configuration's model and, where it has one, its
distillation settings. Only a checkout's first run makes them: every later
run, of the parent or of the change, loads the same parameters whatever the
program's kernels do.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import torch

from .harness import load_module


def cache_key(config: dict) -> str:
    blob = {"model": config["model"]}
    if "distill" in config:
        blob["distill"] = config["distill"]
    return hashlib.sha256(json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]


def ensure_weights(config: dict, cache_root: str, device, dirs) -> dict:
    """``{"state", "model_dir", "arch", "made", "seconds", "loss"}`` of the
    configuration's model; makes and writes the cache when it is absent."""
    t0 = time.perf_counter()
    arch = load_module(dirs, "archs", config["model"]["arch"])
    final = os.path.join(cache_root, "weights", f"{config['name']}-{cache_key(config)}")
    made, loss = False, None
    if not os.path.exists(os.path.join(final, "model", "meta.json")):
        state, loss = arch.make_state(config, device)
        tmp = final + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        arch.write_checkpoint(os.path.join(tmp, "model"), config, state)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        made = True
    state = torch.load(os.path.join(final, "state.pt"), map_location="cpu", weights_only=True)
    return {"state": state, "model_dir": os.path.join(final, "model"), "arch": arch, "made": made,
            "seconds": time.perf_counter() - t0, "loss": loss}
