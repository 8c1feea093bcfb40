"""End-to-end haul driver of the port: loki (U-Net) → semseg → polytaxo.

Counterpart of ``tools/bench_e2e.py``: a synthetic LOKI haul re-segmented
with a ``UNet(1, 32, 4)``, then semantic segmentation (with the raw ``.h5``
export) and polyhierarchical classification of the EcoTaxa archive it
produced, through the port's Runners, all host I/O included. Prints the
card's name, then ONE JSON line with the same keys as ``tools/bench_e2e.py``
(``metric: "e2e_haul_objects_per_sec"``, per-stage seconds, ``value``,
``value_first``, ``frames_per_sec_loki``), unrounded::

    python -m maze_image_processing_pipeline_tpu_torch.tools.bench_e2e \\
        [--haul standard|dense|sparse] [--frames N] [--objects-per-frame N] \\
        [--model-dir DIR] [--workdir DIR] [--distill-steps 200] [--repeat 2] \\
        [--device cuda|cpu]

Hauls (``tools/bench_e2e.py``'s): standard, 24 frames of 1024×1280 with 20
objects of 60×80 each; dense, 12 frames of 2048×2560 with 60 objects a
frame, crops log-uniform 30..380 × 40..480; sparse, 96 frames of 1024×1280
with 0-3 objects of 16..64 px. The inputs are made by
:mod:`.synth` (the layout and seeds of ``tests/fixtures.py:make_loki_sample``).

Models: the segmentation U-Nets are distilled for ``--distill-steps`` steps
by the port's ``fit`` on the card, on ``tools/bench_e2e.py``'s batches (one
generator, seed 0, the loki U-Net's batches first), to emit
brightness-threshold masks; the classifier has seeded random weights. Each
is cached under ``--model-dir`` (``loki-unet``, ``semseg-unet``,
``polytaxo-cnn``) through ``model_io.save_model`` and reused when present.

Each stage runs ``--repeat`` times in the process; ``value`` is the objects
over the sum of each stage's fastest run, ``value_first`` over the first
runs'. The card is the default and a missing card raises; ``--device cpu``
runs on the CPU (for tests: CPU times say nothing of the card).
``tools/bench_e2e.py``'s ``--profile``, ``--timing`` and its ``E2E_*``
environment knobs are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..dataio import Archive, read_tsv
from ..models.inference import resolve_device
from .synth import distill_batches, make_loki_tree, make_taxonomy_files, write_classifier

HAULS = {
    # frames, objects per frame, frame shape, crop size range
    "standard": (24, 20, (1024, 1280), None),
    "dense": (12, 60, (2048, 2560), ((30, 40), (380, 480))),
    "sparse": (96, (0, 3), (1024, 1280), ((16, 20), (48, 64))),
}
LOKI_UNET = dict(out_channels=1, base_features=32, depth=4)
SEMSEG_UNET = dict(out_channels=2, base_features=32, depth=4)
CLASSIFIER = dict(n_outputs=8, features=[32, 64, 128, 256])
DISTILL_SHAPE = (8, 128, 128, 3)
ARCHIVE = "LOKI_PS122-1_7.zip"
# The stages' settings (tools/bench_e2e.py's tasks).
LOKI_SEGMENTATION = dict(batch_size=16, frame_batch=8, tile_size=1024, tile_stride=896,
                         postprocess={"min_area": 30, "closing_radius": 2})
SEMSEG_MODEL = dict(batch_size=64, tiling={"size": 256, "stride": 192, "chunk_size": 32, "in_flight": 2})
POLYTAXO_MODEL = dict(batch_size=256, input_size=256)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--haul", choices=tuple(HAULS), default="standard")
    ap.add_argument("--frames", type=int, default=None, help="frame count (default: the haul's)")
    ap.add_argument("--objects-per-frame", type=int, default=None)
    ap.add_argument("--model-dir", default=os.path.join(tmp, "bench_e2e_models"))
    ap.add_argument("--workdir", default=os.path.join(tmp, "bench_e2e"))
    ap.add_argument("--distill-steps", type=int, default=200)
    ap.add_argument("--repeat", type=int, default=2, help="runs of each stage; the fastest is the steady one")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def ensure_models(model_dir: str, distill_steps: int, device) -> tuple:
    """The loki and semseg U-Nets (bf16, distilled by ``fit``) and the
    classifier (bf16, seeded), each made unless ``model_dir`` holds it."""
    from ..models.model_io import save_model
    from ..models.train_loop import fit
    from ..models.unet import UNet

    loki_unet = os.path.join(model_dir, "loki-unet")
    semseg_unet = os.path.join(model_dir, "semseg-unet")
    clf_dir = os.path.join(model_dir, "polytaxo-cnn")
    rng = np.random.default_rng(0)
    for path, cfg, channels in ((loki_unet, LOKI_UNET, ["foreground"]),
                                (semseg_unet, SEMSEG_UNET, ["Prosoma", "Oilsack"])):
        batches = distill_batches(cfg["out_channels"], rng=rng)
        if os.path.isdir(path):  # keep the shared generator where distillation leaves it
            for _ in range(distill_steps):
                next(batches)
            continue
        module = UNet(**cfg, dtype="bfloat16")
        fit(module, batches, distill_steps, input_shape=DISTILL_SHAPE, log_interval=1e9, device=device)
        save_model(path, module, outputs={"pred": {"channel_names": channels}})
    if not os.path.isdir(clf_dir):
        write_classifier(clf_dir, CLASSIFIER, "bfloat16", seed=2)
    return loki_unet, semseg_unet, clf_dir


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_runs(stage: Callable[[int], None], repeat: int, device: torch.device) -> List[float]:
    """Wall seconds of ``stage(rep)`` for each repeat, up to the card's last
    result."""
    times = []
    for rep in range(max(1, repeat)):
        t0 = time.perf_counter()
        stage(rep)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def main(argv: Optional[List[str]] = None) -> dict:
    from ..loki.pipeline import Runner as LokiRunner
    from ..predict.pipeline import Runner as PredictRunner

    args = parse_args(argv)
    device = resolve_device(args.device)
    dev_name = "cuda" if device.type == "cuda" else "cpu"

    t0 = time.perf_counter()
    loki_unet, semseg_unet, clf_dir = ensure_models(args.model_dir, args.distill_steps, device)
    _sync(device)
    t_models = time.perf_counter() - t0

    frames, objects, frame_shape, crop_range = HAULS[args.haul]
    args.frames = frames if args.frames is None else args.frames
    objects = objects if args.objects_per_frame is None else args.objects_per_frame
    work = args.workdir + ("" if args.haul == "standard" else f"_{args.haul}")
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    data = os.path.join(work, "data")
    make_loki_tree(data, n_frames=args.frames, objects_per_frame=objects, frame_shape=frame_shape, seed=0,
                   crop_size_range=crop_range)
    tax_fn, csv_fn = make_taxonomy_files(work)

    def run_loki(rep):
        LokiRunner._configure_and_run({
            "input": {"path": data},
            "segmentation": {"jax": {"model_fn": loki_unet, **LOKI_SEGMENTATION, "device": dev_name}},
            "postprocess": {},
            "output": {"target_dir": os.path.join(work, f"loki_out{rep}")},
        })

    t_lokis = timed_runs(run_loki, args.repeat, device)
    archive_fn = os.path.join(work, "loki_out0", ARCHIVE)
    n_objects = len(read_tsv(Archive(archive_fn) / "ecotaxa_export.tsv"))

    def run_semseg(rep):
        PredictRunner._configure_and_run({
            "input": {"path": archive_fn},
            "model": {"model_fn": semseg_unet, **SEMSEG_MODEL, "device": dev_name},
            "save_raw_h5": True,
            "segmentation": {"draw": False, "fill_holes": True},
            "target_dir": os.path.join(work, f"semseg_out{rep}"),
        })

    t_semsegs = timed_runs(run_semseg, args.repeat, device)

    def run_poly(rep):
        PredictRunner._configure_and_run({
            "input": {"path": archive_fn},
            "model": {"model_fn": clf_dir, **POLYTAXO_MODEL, "device": dev_name},
            "polytaxo": {
                "poly_taxonomy_fn": tax_fn,
                "ecotaxa_taxonomy_fn": csv_fn,
                "threshold": 0.01,
                "skip_unchanged_objects": False,
            },
            "target_dir": os.path.join(work, f"poly_out{rep}"),
        })

    t_polys = timed_runs(run_poly, args.repeat, device)

    total_first = t_lokis[0] + t_semsegs[0] + t_polys[0]
    total_steady = min(t_lokis) + min(t_semsegs) + min(t_polys)
    result = {
        "metric": "e2e_haul_objects_per_sec",
        "haul": args.haul,
        "frames": args.frames,
        "objects": n_objects,
        "model_prep_s": t_models,
        "loki_s": t_lokis[0],
        "semseg_s": t_semsegs[0],
        "polytaxo_s": t_polys[0],
        "loki_s_steady": min(t_lokis),
        "semseg_s_steady": min(t_semsegs),
        "polytaxo_s_steady": min(t_polys),
        "value_first": n_objects / total_first,
        "value": n_objects / total_steady,
        "frames_per_sec_loki": args.frames / min(t_lokis),
    }
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
