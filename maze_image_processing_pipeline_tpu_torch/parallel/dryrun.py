"""A dry run of the mesh paths on n devices.

Counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``: the data-parallel train step, both inference nodes
and a small LOKI haul through the loki Runner, each on a mesh of ``n``
devices, the haul's archive held equal to the one-device run's. ``n`` is
factored into ``data`` × ``space`` × ``model`` axes as the JAX dry run
factors it; on four or more devices the train steps of the U-Net and of
the classifier are sharded over ``space`` and ``model`` and the inference
U-Net over ``model`` (:mod:`..parallel`).

    python -m maze_image_processing_pipeline_tpu_torch.parallel.dryrun [n] [--device cpu]

On the cards ``n`` defaults to all of them and may not exceed them: a mesh
of n cards needs n cards. ``--device cpu`` builds the mesh from n replicas
of the CPU device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["dryrun_multichip", "factor_axes"]


def factor_axes(n: int) -> Dict[str, int]:
    """``n`` devices as data × space × model axes, as the JAX dry run
    factors them."""
    if n % 4 == 0:
        return {"data": n // 4, "space": 2, "model": 2}
    if n % 2 == 0:
        return {"data": n // 2, "space": 2}
    return {"data": n}


def dryrun_multichip(n_devices: Optional[int] = None, device="cuda", log=print) -> Dict[str, object]:
    """Run the mesh train steps (a U-Net and a classifier), ``TorchInference``, ``DeviceTiledInference``
    and a small loki haul on an ``n_devices`` mesh of ``device`` (every card
    by default; CPU replicas for ``"cpu"``). Raises where a result is wrong
    or ``n_devices`` exceeds the cards. Returns what it checked."""
    from ..engine import Pipeline, Unpack
    from ..models.inference import DeviceTiledInference, TorchInference, resolve_device
    from ..models.model_io import LoadedModel, init_unet_params, params_from_jax
    from ..models.classifier import ConvClassifier
    from ..models.train import bce_loss, create_train_state, make_train_step
    from ..models.unet import UNet
    from .mesh import make_mesh

    device = resolve_device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        n_devices = cards if n_devices is None else n_devices
        if n_devices > cards:
            raise RuntimeError(f"dryrun_multichip: a mesh of {n_devices} cards needs {n_devices}, found {cards}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        n_devices = n_devices or 1
        devices = [device] * n_devices
    axes = factor_axes(n_devices)
    mesh = make_mesh(axes, devices=devices)
    out: Dict[str, object] = {"mesh": axes, "devices": [str(d) for d in devices]}

    # The train step (sharded over space and model where the axes have them).
    module = UNet(out_channels=2, base_features=64, depth=2, dtype="float32")
    state, opt = create_train_state(module, (2, 32, 32, 3), mesh=mesh)
    step = make_train_step(module, opt, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = max(4, n_devices)
    batch = -(-batch // axes["data"]) * axes["data"]
    x = rng.random((batch, 32, 32, 3)).astype(np.float32)
    y = (rng.random((batch, 32, 32, 2)) > 0.5).astype(np.float32)
    state, metrics = step(state, x, y)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: train loss {loss}")
    out["train_loss"] = loss
    out["train_sharded"] = type(state.module).__name__ == "ShardedUNet"
    log(f"dryrun_multichip train OK: mesh={axes} loss={loss:.4f} sharded={out['train_sharded']}")

    # The classifier's train step (its 64-wide conv and head split over model).
    clf = ConvClassifier(n_outputs=64, features=(16, 64), dtype="float32")
    state, opt = create_train_state(clf, (batch, 32, 32, 3), mesh=mesh)
    step = make_train_step(clf, opt, loss_fn=bce_loss, mesh=mesh)
    targets = (np.random.default_rng(1).random((batch, 64)) > 0.5).astype(np.float32)
    state, metrics = step(state, x, targets)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: classifier train loss {loss}")
    out["classifier_loss"] = loss
    out["classifier_sharded"] = type(state.module).__name__ == "ShardedClassifier"
    log(f"dryrun_multichip classifier train OK: mesh={axes} loss={loss:.4f} sharded={out['classifier_sharded']}")

    # Inference over the mesh.
    cfg = dict(out_channels=2, base_features=16, depth=2)
    infer_module = UNet(**cfg, dtype="float32")
    infer_module.load_state_dict(params_from_jax(init_unet_params(cfg, seed=1)))
    model = LoadedModel(infer_module, {})
    dp = axes["data"]
    images = [(rng.random((32, 32, 3)) * 255).astype(np.uint8) for _ in range(2 * dp + 1)]
    with Pipeline() as p:
        img = Unpack(images)
        pred = TorchInference(model, img, batch_size=dp, mesh=mesh)
    results = [obj[pred] for obj in p.run()]
    if len(results) != len(images) or results[0].shape != (32, 32, 2) or not all(
        np.isfinite(r).all() for r in results
    ):
        raise AssertionError(f"dryrun_multichip: TorchInference gave {len(results)} results")
    log(f"dryrun_multichip inference OK: {len(results)} objects through TorchInference(mesh), "
        f"output {results[0].shape}")
    crops = [(rng.random(s) * 255).astype(np.uint8) for s in [(48, 48), (70, 60), (40, 56)]]
    with Pipeline() as p:
        img = Unpack(crops)
        pred, _ = DeviceTiledInference(model, img, tile_size=32, tile_stride=24, batch_size=dp, mesh=mesh)
    tiled = [obj[pred] for obj in p.run()]
    if [r.shape for r in tiled] != [c.shape + (2,) for c in crops]:
        raise AssertionError(f"dryrun_multichip: DeviceTiledInference gave {[r.shape for r in tiled]}")
    out["inference_objects"] = len(results) + len(tiled)
    log(f"dryrun_multichip tiled inference OK: {len(tiled)} crops through DeviceTiledInference(mesh)")

    out["loki_rows"] = _loki_haul(axes, device, log)
    return out


def _loki_haul(axes: Dict[str, int], device: torch.device, log) -> int:
    """A small LOKI haul (4 frames of 180×230, tiles 128 / 96) through the
    loki Runner with ``parallel: {mesh: axes}`` and without; the archives'
    TSVs must be equal. Returns their rows."""
    from ..dataio import Archive, read_tsv
    from ..loki.pipeline import Runner
    from ..tools.synth import make_loki_tree, write_unet

    with tempfile.TemporaryDirectory(prefix="dryrun_loki_") as tmp:
        data = os.path.join(tmp, "data")
        make_loki_tree(data, n_frames=4, objects_per_frame=3, frame_shape=(180, 230), seed=3)
        unet = write_unet(os.path.join(tmp, "unet"), dict(out_channels=1, base_features=8, depth=2), "float32",
                          seed=0, gain=1000.0)

        def run(name, parallel):
            target = os.path.join(tmp, name)
            Runner._configure_and_run({
                "input": {"path": data},
                "segmentation": {"jax": {
                    "model_fn": unet, "dtype": "float32", "batch_size": 4, "frame_batch": 2, "tile_size": 128,
                    "tile_stride": 96, "device": device.type,
                    "postprocess": {"closing_radius": 2, "min_area": 20, "max_regions": 16}, "padding": 10,
                }},
                "postprocess": {},
                "output": {"target_dir": target},
                "parallel": parallel,
            })
            return read_tsv(Archive(os.path.join(target, "LOKI_PS122-1_7.zip")) / "ecotaxa_export.tsv")

        df_mesh = run("out_mesh", {"mesh": axes})
        df_single = run("out_single", False)
        if len(df_mesh) != len(df_single) or len(df_mesh) == 0:
            raise AssertionError(f"dryrun_multichip: {len(df_mesh)} objects on the mesh, {len(df_single)} on one")
        for col in df_single.columns:
            if col in ("process_datetime", "process_id"):
                continue
            a, b = df_single[col], df_mesh[col]
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b.to_numpy(), a.to_numpy(), rtol=1e-5, atol=1e-8, err_msg=col)
            elif a.tolist() != b.tolist():
                raise AssertionError(f"dryrun_multichip: column {col} differs on the mesh")
    log(f"dryrun_multichip loki haul OK: {len(df_mesh)} objects, mesh archive == single-device archive")
    return len(df_mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None, help="devices of the mesh (default: every card)")
    ap.add_argument("--device", default="cuda", help="cuda (the cards) or cpu (replicas of the CPU device)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
