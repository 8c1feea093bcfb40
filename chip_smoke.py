#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # the whole smoke run
    python3 chip_smoke.py --stages   # phases 6, 7, 8 and 9's train step only,
                                     # with stage breakdowns and the device's
                                     # idle share
    python3 chip_smoke.py --mesh     # phases 12 and 14 alone (a machine of
                                     # several cards)
    python3 chip_smoke.py --library  # phase 13 alone

Builds the port's CUDA kernels from ``maze_image_processing_pipeline_tpu_torch/
csrc`` and runs, one line of output per phase:

0. the card: its name and power limit (``nvidia-smi``); no card → exit 1;
1. the kernel build (one ``nvcc`` per source, all started together), timed;
2. each kernel against its plain PyTorch version on the card, with CUDA-event
   times of both beside the kernel's bound:
   K1 ``hpass`` and K2 ``cumsum_rows`` (fg densities 0-1, a serpentine),
   K4 ``vertical_pass`` (the same masks, both connectivities, both
   directions; random labels and the raster ids ``label`` seeds),
   ``ccl_fixpoint`` (the same masks and seeds, both connectivities, labels
   and per-frame sweep counts; the serpentine capped at 1 and 3 sweeps),
   all bit-exact at the loki path's shape (8, 1024, 1280) and at edge
   shapes (W = 1, 37, 1000, 1277; H = 1), and K1, K2, K4 and the
   fixpoint at the fused measurement's shapes of
   phase 7 (``PREDICT_LABEL_SHAPES``: chunks of up to 32 canvases of
   64-512 × 128-512) on thresholded-blob and noisy masks; the fixpoint's
   time per ``label()`` fixpoint at (8, 1024, 1280) and (32, 256, 256)
   beside the old host loop of standalone K1 / K4 launches (the time to
   beat), its plain version and its bound; every one of these shapes
   prints its route (``ccl_route``: one block a frame); the banded route
   (``phase_wide_ccl``) at ``WIDE_CCL_SHAPES`` (rows of 8193 and 12000):
   the fixpoint (raster and random seeds, both connectivities, serpentines
   capped at 1 and 3 sweeps, labels and sweep counts), K4 alone and
   ``label()`` against ``label()`` through the plain versions on the card,
   bit-exact, each case's route and bands printed, K1's wide route at
   (2, 64, 50000), and the banded
   fixpoint's time at (2, 1024, 12000), both connectivities, beside the
   one-block route's time a pixel; the grid route (``phase_grid_ccl``, C4:
   frames whose bands the card cannot hold) at ``GRID_CCL_SHAPES``, a row
   of 4,000,000 columns and 8 rows of 1,200,000, and at
   ``GRID_FORCED``'s narrow frames with ``CCL_BAND`` lowered: the fixpoint
   (raster and random seeds, both connectivities, serpentines capped at 1
   and 3 sweeps, labels and sweep counts), the 8-connected pass alone and
   ``label()`` against the plain versions on the card, bit-exact, each
   case's route printed, the fixpoint's time a pixel beside the banded
   route's;
   K8 ``remove_small_objects`` (``relabel_cases``, min_area 0, 1 and 30
   each): R = 256 on rectangle frames with ids beyond R at the path's and
   the edge shapes, all-background frames, a region covering each frame,
   R = 1, the largest R the plan takes (and the wrapper's raise one beyond
   it), H·W not a multiple of 8 or of 4, rows not 16-B aligned, B = 1 and
   the dense haul's (8, 2048, 2560) (the two-read route), bit-exact, the
   same bits from two calls, each case's route and cluster size printed;
   its times at (8, 1024, 1280), (8, 1024, 1024) and (8, 2048, 2560) with
   the queue full, L2 cold (``l2_cold_inputs``) and warm, and host-paced;
   K3 ``region_histogram`` and K7 ``regionprops_fused``, one kernel
   (``csrc/region_measure.cu``): its partials (the perimeter units
   included) and histogram bit-exact against the plain versions and the
   same bits in two launches, the histogram alone too, the props' integers
   exact and the rest within rtol 1e-5 / atol 1e-3 (the orientation modulo
   pi), at (8, 1024, 1280) with R = 64 on blob, serpentine and rectangle
   label frames (ids beyond R), all-background and one-region frames,
   negative ids, at (8, 1024, 1), (8, 1, 1280), (3, 1000, 1280), (2, 37,
   1000), (2, 96, 1277), (4, 64, 37), rows not 16-B aligned, the dense
   haul's (2, 2048, 2560) with intensity 255, R = 256, and the threshold
   path's buckets (256, 64, 128) and (8, 512, 512) with R = 2; the fused
   launch, the histogram alone, the whole call and its derivation timed at
   the first shape and the buckets;
   K5 ``group_norm`` at the path's shapes (16, 32, 1024, 1024) (loki level
   0), (64, 32, 256, 256) (semseg level 0) and (256, 32, 128, 128)
   (classifier stage 1), the train step's, the distillation's (8, 32, 128,
   128) … (8, 512, 8, 8) and odd shapes ((3, 16, 5, 7), C = 512, H·W not
   a multiple of 8, C = 2600: a channels_last pixel of more vectors than a
   block has threads), NCHW and channels_last, float32 within rtol 1e-5 /
   atol 1e-5, bfloat16 and float16 within one ulp, the same bits twice,
   each shape's mode (one read or two passes) printed, with
   ``F.group_norm``'s time beside it; the layouts the U-Net and the
   classifier feed their norms are printed; K6 ``group_norm_bwd`` at the
   train step's shapes (8, 32, 512, 512) … (8, 512, 32, 32), the
   distillation's and odd shapes, NCHW and channels_last, float32,
   bfloat16 and float16: dx within rtol 1e-4 plus 1e-5 of its largest
   magnitude (float32) or one ulp, dweight and dbias within the float32
   tolerance, the same bits twice; with the plain version's and
   ``native_group_norm_backward``'s times beside it; one device operation
   (one kernel, no memset) a K5 and a K6 call at the path's, the train
   step's and the distillation's shapes (``tools/norm_ops.py`` under
   ``torch.profiler``, in a process of its own);
   K9 ``anchor`` bit-exact at (8, 1024, 1024) and (8, 2048, 2560) bool,
   (8, 1023, 1277), (3, 37, 1001) and (1, 1, 1), contiguous, transposed
   (the tiled transpose) and sliced views, bool, uint8, int32 and float32,
   with ``Tensor.clone()``'s and, for the transposed view, ``.contiguous()``'s
   times beside it, host-paced and with the queue full (L2 warm and cold),
   at both bool shapes; one device operation a K8 call at its three timed
   shapes (``tools/norm_ops.py --relabel``) and a K9 call, contiguous and
   transposed, at both bool shapes, with what its library calls launch
   (``--anchor``: ``Tensor.clone()`` is a driver device-to-device copy);
3. the frame chain (morphology → CCL → region measurement (K7, K3) →
   filled area) on the card against the same chain on the CPU;
4. the full-width U-Net (out_channels=1, base_features=32, depth=4) and
   ``ConvClassifier(8)`` in float32 on the card (their norms through K5)
   against the CPU;
5. the LOKI segmentation slice on the card at the standard haul's size:
   DeviceTiledSegmentation → FindRegions → ExtractROI →
   CalculateZooProcessFeatures over 24 frames of 1024×1280 with 20 objects
   each, a seeded random bf16 U-Net, tiles 1024 / stride 896, batch 16,
   frame groups of 8;
6. ``maze-ipp loki`` through the port's Runner on the card, from a LOKI
   sample tree (24 frames of 1024×1280, 20 vignettes of 60×80 each, log,
   meta.yaml, telemetry) to an EcoTaxa archive, with the benchmark's task
   (``tools/bench_e2e.py``) and a ``UNet(1, 32, 4)`` bf16 checkpoint of
   seeded random weights written by the port's ``save_model``; one warm-up,
   then the timed run. Then a smaller task (2 frames, ``UNet(1, 8, 2)``
   float32, TF32 off) on the card and on the CPU: the two archives must
   agree; the standard haul's task once more through the command line in
   a process of its own with ``MAZE_IPP_PROFILE_DIR`` (the Runner's
   ``torch.profiler`` trace: its size and the share of the run spent in
   ``Memcpy HtoD``); and the same small task with ``device_blend: false``,
   ``merge_segments_distance: 20`` and ``full_frame_archive_fn`` (tiles →
   ``TorchInference`` → host blend → ``DeviceFramePostprocess`` → merging
   on the host), card against CPU, the full-frame archive too;
7. ``maze-ipp predict`` through the port's Runner on the card, from an
   EcoTaxa archive of 480 seeded blob crops (40-200 px a side, one in ten
   260-420 px, so that several tiles blend): the semseg task of
   ``tools/bench_e2e.py`` (``UNet(2, 32, 4)`` bf16, tiles 256 / stride 192,
   batch 64, chunk 32, ``fill_holes``, the device blend with fused
   measurement; no ``save_raw_h5``) and its polytaxo task
   (``ConvClassifier(8)`` bf16, input 256, batch 256, threshold 0.01), both
   checkpoints seeded random weights written by the port's ``save_model``
   (the U-Net's head scaled as ``write_unet(..., gain=1000)``); one warm-up
   each, then the timed runs, objects/s of each. The fused measurement of
   two of the warm-up's canvases (the chunk with the most pixels, the one
   with the most rows) runs again on the card and on the CPU: the results
   must agree. Then a small task (4 crops,
   ``UNet(2, 4, 1)`` float32, ``ConvClassifier(4, (4, 8))`` float32, TF32
   off) on the card and on the CPU: the ``.segmentation.zip`` archives must
   agree, and so must the ``.polytaxo.zip`` archives; then the semseg task
   with ``save_raw_h5: true`` at the three ``raw_h5_dtype`` rungs: each
   archive equal to the run without ``.h5``, the file's HDF5 signature, the
   same bytes from a second write of the captured prediction stream, the
   ``.h5`` export's seconds;
8. ``maze-ipp loki`` with threshold segmentation (brighter than 50, the
   measurement's ``device`` at its default: the card) through the port's
   Runner, from a LOKI tree of 96 frames × 20 vignettes (1920 crops of
   60×80, every tenth 150-400 px a side); one warm-up, then the timed run,
   objects/s. The card's archive must equal the ``device: "cpu"`` run's,
   and every object's features the host path's (``device: false``) within
   the JAX package's tolerance of that comparison;
9. training through the port's ``models.train`` / ``train_loop`` on the
   card: the full-width step of ``bench.py``'s ``bench_unet_train_tpu``
   (``UNet(2, 32, 4)`` bf16, batch 8 of 512², ``bce_dice_loss``, AdamW
   1e-3; three warm-up steps, then ten timed, tiles/s; the loss finite and
   falling; 18 K5 and 18 K6 launches a step); ``ConvClassifier(8)`` bf16,
   batch 64 of 256², ``bce_loss``, three steps; ``UNet(1, 8, 2)``
   float32's first-step loss and gradients card against CPU (TF32 off);
   a ``UNet(1, 32, 4)`` bf16 distilled by ``fit`` for 200 steps of
   ``synth.vignette_batches`` (tiles like phase 6's stitched frames),
   saved by ``save_model``, then phase 6's task on it: at least 432 of the
   480 planted objects; the
   full-width step after ``save_checkpoint`` / ``restore_checkpoint``
   (AdamW's step counters on the CPU), fresh and resumed steps in turns,
   the resumed no slower beyond the fresh blocks' spread;
10. the port's frame-chain perf lab (``tools/perf_lab.py`` of the port)
    at (8, 1024, 1024), every experiment timed; ``chain`` and
    ``chain_anchor`` the same labels and props, ``chain_plain`` (on the
    CPU) within tolerance;
11. the port's haul driver (``tools/bench_e2e.py`` of the port),
    ``--haul standard --repeat 1`` with phase 9's distilled loki U-Net:
    its JSON line, at least 432 of the 480 planted objects found;
12. the mesh of every card the machine has (``parallel.make_mesh()``):
    phase 6's loki task (frame groups of 4, round-robin over the cards) and
    phase 7's semseg and polytaxo tasks (batches split over the cards) with
    ``parallel: true`` give the archives of the same tasks on one card; the
    mesh train step (``UNet(1, 8, 2)`` float32, 4 tiles a card) the one-card
    step's loss and gradients within phase 9's tolerance; the sharded train
    steps (``SHARDED_STEPS``: ``UNet(1, 64, 1)`` on ``{data: 1, space: 2,
    model: 2}``, ``UNet(1, 32, 4)`` at batch 8 of 512² on ``{space: 4}``,
    float32, over the first four cards or, on a machine of fewer, four
    replicas of card 0; and phase 9's ``ConvClassifier(8)`` at a batch of
    16 crops of 256² on both meshes, ``models.classifier.
    ShardedClassifier``) the one-card steps' loss and gradients, each card's
    peak memory and the bytes its forward saved for the backward printed
    beside the one-card step's, and K5 and K6's split
    launches (partials and apply) on every card, each held to its plain
    version at the shard shapes the steps gave it and timed at the largest;
    phase 7's polytaxo task in float32 with ``parallel: {mesh: {model:
    2}}`` (the classifier sharded over two cards, or two replicas of card
    0) gives the one-card archive;
    ``parallel.dryrun.dryrun_multichip`` on the card count; every kernel of
    each path launches on every card (``launches_by_device``);
13. the library functions of ``ops/`` at loki's frame shape (8, 1024,
    1280) on ``make_frames``' masks (``library_inputs``), each against the
    same call on the CPU: ``fill_holes`` bit-exact (the CCL fixpoint and K2
    launched), ``regionprops`` of the filled masks' labels at R = 64 with
    uint8 intensity and the histogram (K3 launched; integer keys and the
    histogram exact, floats within the CPU test's tolerances),
    ``isotropic_closing`` at radius 2.5 and ``edt`` at ``max_distance`` 16
    exact; each call's launches and time by CUDA events;
14. a mesh that spans two processes (``PROCESS_STEPS``): two processes of
    this script (``--process``) joined by ``initialize_distributed`` on a
    local port, ``gloo`` with both on card 0 (each process's two mesh
    cards replicas of it) or ``nccl`` with two cards each on a machine of
    four, run two full-width float32 sharded steps of ``UNet(1, 32, 4)``
    (batch 8 of 512², ``{space: 4}``: ``space`` crosses the processes) and
    of ``ConvClassifier(8)`` (batch 16 of 256², ``{model: 2, space: 2}``:
    ``model`` crosses them); both steps' losses and gradients against the
    same steps in this process on the same mesh shape, K5's and K6's split
    launches in each process, the walls.

Kernel launches are counted per phase (counts set to 0 just before each
timed run, read just after): every kernel but K6, K9 and the CCL passes
alone (K1, K4) must launch in phases 5, 6 and 12 (its loki run, on every
card); ``ccl_fixpoint``, K2 and K5
in phase 7, and not K3 or K7; ``ccl_fixpoint``, K2 and K3, and no other,
in phase 13; ``ccl_fixpoint``, K2, K3 and K7 in phase 8;
K5 and K6, and no other, in phase 9; K1, K4 (the lab's probes of them),
``ccl_fixpoint``, K2, K8, K3, K7 and K9, and not K5 or K6, in phase 10; all
but K9 and K1, K4 alone in phase 11. ``label`` runs K1 and K4 inside
``ccl_fixpoint``: alone they launch in phase 10 and no other. K9 launches in
no phase but 10. The split K5/K6 launches (``SPLIT_NORMS``) launch in phase
12's sharded train steps (counted from just before each sharded step to
just after it) and in no other phase. The last lines are a JSON object of the
kernels, the card's name and power limit, and ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero before the last line.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from types import SimpleNamespace

import numpy as np

from maze_image_processing_pipeline_tpu_torch.tools.synth import (  # noqa: F401 (the tests use them from here)
    TAXONOMY_YAML,
    distill_batches,
    make_crop_archive,
    make_loki_tree,
    make_taxonomy_files,
    vignette_batches,
    write_classifier,
    write_unet,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "maze_image_processing_pipeline_tpu_torch/csrc"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth

KERNELS = {
    # name: (source, TPU kernel it replaces, bytes per pixel (element) that
    # the function must move: each input read once, each output written once)
    "hpass": (f"{CSRC}/ccl.cu", "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:111", 4 + 1 + 4),
    "cumsum_rows": (f"{CSRC}/row_scan.cu", "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:77", 4 + 4),
    "vertical_pass": (f"{CSRC}/ccl.cu", "attic/pallas_label.py:58", 4 + 1 + 4),
    # The label fixpoint in one launch: the `jax.lax.while_loop` of `label`
    # over K1 (pallas_scan.py:111) and K4 (attic/pallas_label.py:58); seed
    # labels and mask read once, labels written once.
    "ccl_fixpoint": (f"{CSRC}/ccl.cu", "maze_image_processing_pipeline_tpu/ops/label.py:212", 4 + 1 + 4),
    "remove_small_objects": (f"{CSRC}/relabel.cu", "attic/pallas_relabel.py:99", 4 + 4),
    # bfloat16 activations, as every norm of the path: 2 B read, 2 B written.
    "group_norm": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:95", 2 + 2),
    # bfloat16 x and cotangent read, dx written (plus (C,) outputs per call).
    "group_norm_bwd": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:256", 2 + 2 + 2),
    # Labels and intensity read (5 B/px) plus outputs per region, not per
    # pixel: their bounds are reckoned in phase_region_kernels.
    # K3 and K7 are one kernel: `region_histogram` counts its launches that
    # write a histogram, `regionprops_fused` those that write the partials.
    "region_histogram": (f"{CSRC}/region_measure.cu", "attic/pallas_hist.py:94", None),
    "regionprops_fused": (f"{CSRC}/region_measure.cu", "attic/pallas_props.py:167", None),
    # The perf lab's layout anchor: the mask read once and written once
    # (1 + 1 B per bool element).
    "anchor": (f"{CSRC}/anchor.cu", "tools/perf_lab.py:94", 1 + 1),
    # The sharded norm's launches (a norm whose rows or groups span cards):
    # their bytes depend on the shard's dtype, reckoned in phase 12.
    "group_norm_partials": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:95", None),
    "group_norm_apply": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:95", None),
    "group_norm_bwd_partials": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:256", None),
    "group_norm_bwd_apply": (f"{CSRC}/group_norm.cu", "attic/pallas_norm.py:256", None),
}
# The kernels of the frame chain's region measurement (K3, K7).
REGION_KERNELS = ("region_histogram", "regionprops_fused")
# The CCL passes alone (K1, K4): `label` runs them inside `ccl_fixpoint`, so
# they launch only in phase 2 and in the perf lab's probes of them.
CCL_PASSES = ("hpass", "vertical_pass")
# The sharded norm's partials and apply launches of K5 and K6: only a U-Net
# sharded over space (or a group straddling model cards) runs them, in
# phase 12's sharded train steps and phase 14's over two processes.
SPLIT_NORMS = ("group_norm_partials", "group_norm_apply", "group_norm_bwd_partials", "group_norm_bwd_apply")
# The kernels inference may launch (all but the GroupNorm backward, K6, the
# perf lab's anchor, K9, the CCL passes alone and the sharded norm's).
INFERENCE_KERNELS = tuple(k for k in KERNELS if k not in ("group_norm_bwd", "anchor") + CCL_PASSES + SPLIT_NORMS)
# The kernels of the perf lab's experiments (phase 10).
LAB_KERNELS = CCL_PASSES + ("ccl_fixpoint", "cumsum_rows", "remove_small_objects") + REGION_KERNELS + ("anchor",)
# The norms' (B, C, H, W) on the path: loki level 0 (16 tiles of 1024²),
# semseg level 0 (64 tiles of 256²), classifier stage 1 (256 crops of 256²).
GN_SHAPES = ((16, 32, 1024, 1024), (64, 32, 256, 256), (256, 32, 128, 128))
# The norms' (B, C, H, W) in the full-width train step (UNet(2, 32, 4), batch
# 8 of 512²): 4 norms at each of the first four, 2 at the last.
GN_TRAIN_SHAPES = ((8, 32, 512, 512), (8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32))
GN_TRAIN_NORMS = (4, 4, 4, 4, 2)
# The norms' (B, C, H, W) of the haul's distillation (`fit` of UNet(1, 32, 4)
# on tools/bench_e2e.py's DISTILL_SHAPE (8, 128, 128, 3)), where phase 11
# launches K5 and K6 thousands of times.
GN_DISTILL_SHAPES = ((8, 32, 128, 128), (8, 64, 64, 64), (8, 128, 32, 32), (8, 256, 16, 16), (8, 512, 8, 8))

# Frame-chain and segmentation settings of the end-to-end benchmark's loki
# stage (tools/bench_e2e.py): postprocess min_area 30, closing radius 2; the
# other fields are the defaults of loki/config_schema.py.
POSTPROCESS = SimpleNamespace(
    opening_radius=0,
    closing_radius=2,
    merge_segments_distance=0,
    min_area=30,
    clear_border=False,
    max_regions=64,
)
SEGMENTATION = SimpleNamespace(
    tile_size=1024,
    tile_stride=896,
    batch_size=16,
    frame_batch=8,
    skip_empty_tiles=True,
    padding=75,
    min_intensity=None,
)
UNET = dict(out_channels=1, base_features=32, depth=4)
SMALL_UNET = dict(out_channels=1, base_features=8, depth=2)


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bytes_ms(nbytes: int) -> float:
    """``nbytes`` over the card's memory rate, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_ms(name: str, pixels: int) -> float:
    """The least time the card could take for the kernel's work on
    ``pixels`` pixels: its bytes over the memory rate (every kernel here does
    a few integer operations per pixel, far below the card's integer rate)."""
    return bytes_ms(KERNELS[name][2] * pixels)


def make_frames(n: int, H: int, W: int, objects: int, seed: int) -> np.ndarray:
    """Stitched-LOKI-like frames: zero background with ``objects`` pasted
    60×80 vignettes (noise up to 40, one bright ellipse each)."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, H, W), np.uint8)
    ch, cw = min(60, H), min(80, W)
    yy, xx = np.mgrid[:ch, :cw]
    for f in range(n):
        for _ in range(objects):
            crop = (rng.random((ch, cw)) * 40).astype(np.uint8)
            ry, rx = rng.integers(4, ch // 2 - 1), rng.integers(4, cw // 2 - 1)
            crop[((yy - ch / 2) / ry) ** 2 + ((xx - cw / 2) / rx) ** 2 <= 1] = rng.integers(100, 250)
            y, x = rng.integers(0, H - ch + 1), rng.integers(0, W - cw + 1)
            frames[f, y : y + ch, x : x + cw] = crop
    return frames


def serpentine(B: int, H: int, W: int) -> np.ndarray:
    """One snake through the whole frame: the CCL's worst case."""
    mask = np.zeros((B, H, W), bool)
    for k, y in enumerate(range(0, H - 2, 4)):
        mask[:, y, 1:-1] = True
        x = W - 2 if k % 2 == 0 else 1
        mask[:, y : y + 5, x] = True
    mask[:, -1, :] = False
    return mask


def region_labels(shape, R: int, seed: int) -> np.ndarray:
    """Label frames of rectangles with ids 1..R+44 (so some lie beyond the
    R-entry table), sizes from 1 to 48 px a side, on background 0."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.int32)
    H, W = shape[-2:]
    for f in np.ndindex(shape[:-2]):
        for i in range(1, R + 45):
            h, w = rng.integers(1, min(H, 48) + 1), rng.integers(1, min(W, 48) + 1)
            y, x = rng.integers(0, H - h + 1), rng.integers(0, W - w + 1)
            out[f + (slice(y, y + h), slice(x, x + w))] = i
    return out


L2_BYTES = 50 * 2**20  # H100 SXM L2 cache


def l2_cold_inputs(*tensors, factor: int = 2) -> list:
    """Copies of ``tensors`` (a tuple each), enough of them that together
    they exceed ``factor`` times the card's L2: a timing that rotates over
    them finds each input evicted from L2 when it comes round again."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(2, -(-factor * L2_BYTES // max(nbytes, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(copies)]


def _caller(fn, inputs):
    """``fn`` as a function of the call's index: ``fn()``, or with
    ``inputs``, ``fn(*inputs[i % len(inputs)])``."""
    if inputs is None:
        return lambda i: fn()
    return lambda i: fn(*inputs[i % len(inputs)])


def cuda_ms(fn, iters: int = 20, inputs=None) -> float:
    """Mean device time of ``fn`` in ms from CUDA events (after warm-up);
    with ``inputs`` (``l2_cold_inputs``), each call takes the next of them."""
    import torch

    call = _caller(fn, inputs)
    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, inputs=None) -> float:
    """Mean device time of ``fn`` in ms with the stream's queue kept full:
    the card sleeps (``torch.cuda._sleep``, about 25 ms) while the host
    enqueues the events and the ``iters`` calls, so the calls run back to
    back and the host's time per call (Python, ctypes) drops out. With
    ``inputs`` (``l2_cold_inputs``), each call takes the next of them, so
    that its input comes from device memory, not from L2."""
    import torch

    call = _caller(fn, inputs)
    for i in range(len(inputs) if inputs else 1):
        call(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        call(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def blob_masks(shape, seed: int) -> np.ndarray:
    """Thresholded blob canvases as the fused measurement of phase 7 sees
    them: noise below 0.5, discs (some with holes), specks, ``> 0.5``."""
    rng = np.random.default_rng(seed)
    B, H, W = shape
    canvas = rng.random(shape, dtype=np.float32) * 0.45
    yy, xx = np.mgrid[:H, :W]
    for b in range(B):
        for _ in range(int(rng.integers(1, 6))):
            cy, cx, r = int(rng.integers(0, H)), int(rng.integers(0, W)), int(rng.integers(3, max(4, H // 4)))
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            disc = d2 <= r * r
            if rng.random() < 0.5:
                disc &= d2 >= (r // 2) ** 2
            canvas[b][disc] = 0.9
        canvas[b, rng.integers(0, H, 40), rng.integers(0, W, 40)] = 0.8
    return canvas > 0.5


# Label batches of the fused measurement (phase 7): chunks of up to 32
# objects on (Hq, Wq) canvases of 64-512 rows and 128-512 columns.
PREDICT_LABEL_SHAPES = ((32, 256, 256), (8, 512, 512), (29, 64, 128), (3, 384, 512))


def host_loop_fixpoint(lab0, fg, connectivity: int, max_iters: int = 256):
    """The label fixpoint as the port ran it before ``ccl_fixpoint``: a
    host loop of standalone K1 and K4 launches, four a sweep, with a host
    synchronisation after every sweep. The time to beat. Returns the labels
    and the number of sweeps."""
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    def sweep(lab):
        lab = row_scan.hpass(lab, fg)
        lab = tl.vertical_pass(lab, fg, connectivity, reverse=False)
        lab = tl.vertical_pass(lab, fg, connectivity, reverse=True)
        return row_scan.hpass(lab, fg)

    lab, prev, i = sweep(lab0), lab0, 1
    while i < max_iters and bool((lab != prev).any()):
        lab, prev = sweep(lab), lab
        i += 1
    return lab, i


# The fixpoint's timed inputs: loki's frames (8-connected), and the fused
# measurement's largest chunk of canvases.
FIXPOINT_SHAPES = ((8, 1024, 1280), (32, 256, 256))


def fixpoint_timings(dev) -> dict:
    """``ccl_fixpoint`` per ``label()`` fixpoint (the raster seed) on loki-
    like frames and on thresholded blob canvases, both connectivities, by
    CUDA events: beside the old host loop of standalone launches on the same
    input (its labels must agree), the plain version and the bound; and K1
    and K4 alone on the same input. Returns the numbers at the first shape,
    8-connected, and (``one_block_ms``) its fixpoint's ms by connectivity."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    out = None
    for shape in FIXPOINT_SHAPES:
        B, H, W = shape
        fg_np = make_frames(B, H, W, 20, seed=11) > 50 if shape == FIXPOINT_SHAPES[0] else blob_masks(shape, seed=12)
        fg = torch.from_numpy(fg_np).to(dev)
        lin = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).reshape(H, W)
        lab0 = torch.where(fg, lin, 2**30)
        k1 = cuda_ms(lambda: row_scan.hpass(lab0, fg))
        k4 = [cuda_ms(lambda: tl.vertical_pass(lab0, fg, conn, False)) for conn in (2, 1)]
        say(f"  at {shape}: hpass {k1:.4f} ms, vertical_pass 8-connected {k4[0]:.4f} ms, 4-connected {k4[1]:.4f} ms; "
            f"bound {bound_ms('hpass', lab0.numel()):.4f} ms each")
        for conn in (2, 1):
            lab, sweeps = tl._fixpoint(lab0, fg, conn, 256)
            check(torch.equal(lab, host_loop_fixpoint(lab0, fg, conn)[0]), f"the host loop differs at {shape}")
            m = dict(ms=cuda_ms(lambda: tl._fixpoint(lab0, fg, conn, 256)),
                     host_loop_ms=cuda_ms(lambda: host_loop_fixpoint(lab0, fg, conn)),
                     plain_ms=cuda_ms(lambda: tl.fixpoint_plain(lab0, fg, conn, 256), iters=3),
                     bound_ms=bound_ms("ccl_fixpoint", lab0.numel()), library_ms=None)
            say(f"  ccl_fixpoint at {shape} {4 * conn}-connected, fg {float(fg_np.mean()):.3f}: {m['ms']:.4f} ms a "
                f"fixpoint, sweeps per frame {sorted(set(sweeps.tolist()))}; the old host loop of K1/K4 launches "
                f"{m['host_loop_ms']:.4f} ms; plain {m['plain_ms']:.4f} ms; bound {m['bound_ms']:.4f} ms")
            if out is None:
                out = dict(m, one_block_ms={})
            if shape == FIXPOINT_SHAPES[0]:
                out["one_block_ms"][conn] = m["ms"]
    return out


# The banded route (rows wider than one block walks): the fixpoint and the
# 8-connected pass alone at one column past a block's 8192 and well beyond;
# K1 alone past what a block stages (46000); the wide route's time at
# (2, 1024, 12000).
WIDE_CCL_SHAPES = ((2, 512, 8193), (2, 512, 12000))
WIDE_HPASS_SHAPE = (2, 64, 50000)
WIDE_TIMED = (2, 1024, 12000)


def wide_masks(shape, seed: int) -> np.ndarray:
    """Blob canvases with 30 % noise and one row of foreground across every
    band: runs and components cross the bands' edges."""
    rng = np.random.default_rng(seed)
    fg = blob_masks(shape, seed=seed) | (rng.random(shape) < 0.3)
    fg[:, shape[1] // 2, :] = True
    return fg


def plain_label(mask, connectivity: int):
    """``label()`` through the plain versions of its kernels (the fixpoint,
    K2), on the tensor's device: the card's reference for ``label()`` where
    the CPU would take minutes."""
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    saved = tl._fixpoint, tl.cumsum_rows
    tl._fixpoint, tl.cumsum_rows = tl.fixpoint_plain, row_scan.cumsum_rows_plain
    try:
        return tl.label(mask, connectivity=connectivity)
    finally:
        tl._fixpoint, tl.cumsum_rows = saved


def phase_wide_ccl(dev, record, one_block: dict) -> dict:
    """The banded route against the plain versions, bit-exact: the
    fixpoint's labels and per-frame sweep counts (raster and random seeds,
    both connectivities, serpentines capped at 1 and 3 sweeps), the passes
    alone and ``label()`` (against ``plain_label``), each case's route
    printed; K1's wide route. Times a ``label()`` fixpoint at ``WIDE_TIMED``,
    both connectivities, beside the one-block route's time a pixel
    (``one_block``: ``fixpoint_timings`` at loki's shape). Returns the
    times."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    rng = np.random.default_rng(4)
    for shape in WIDE_CCL_SHAPES:
        B, H, W = shape
        fg_np = wide_masks(shape, seed=W)
        fg = torch.from_numpy(fg_np).to(dev)
        route = tl.ccl_route_of(fg, 2)
        check(route.route == "banded", f"{shape} takes the {route.route} route")
        lin = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).reshape(H, W)
        seeds = (torch.where(fg, lin, 2**30), torch.from_numpy(rng.integers(1, 2**30, shape, dtype=np.int32)).to(dev))
        serp = torch.from_numpy(serpentine(*shape)).to(dev)
        sweeps = set()
        for conn in (1, 2):
            for lab0 in seeds:
                lab, sw = tl._fixpoint(lab0, fg, conn, 256)
                ref, ref_sw = tl.fixpoint_plain(lab0, fg, conn, 256)
                record("ccl_fixpoint", max(max_err(lab, ref), max_err(sw, ref_sw)), f"{shape} connectivity={conn}")
                sweeps |= set(sw.tolist())
                for rev in (False, True):
                    e = max_err(tl.vertical_pass(lab0, fg, conn, rev), tl.vertical_pass_plain(lab0, fg, conn, rev))
                    record("vertical_pass", e, f"{shape} connectivity={conn} reverse={rev}")
            for cap in (1, 3):
                lab0 = torch.where(serp, lin, 2**30)
                lab, sw = tl._fixpoint(lab0, serp, conn, cap)
                ref, ref_sw = tl.fixpoint_plain(lab0, serp, conn, cap)
                record("ccl_fixpoint", max(max_err(lab, ref), max_err(sw, ref_sw)),
                       f"{shape} serpentine connectivity={conn} max_iters={cap}")
            labels, n = tl.label(fg, connectivity=conn)
            ref, n_ref = plain_label(fg, conn)
            check(torch.equal(labels, ref) and torch.equal(n, n_ref),
                  f"label() differs from label() through the plain versions at {shape} connectivity={conn}")
        say(f"  {shape}: route {route.route}, {route.bands} bands of {route.band} columns; ccl_fixpoint (4/8-"
            f"connected, raster and random seeds, sweeps {sorted(sweeps)}; serpentines capped at 1 and 3), "
            f"vertical_pass (4/8-connected, down/up) and label() (against label() through the plain versions) "
            f"bit-exact")
    lab = torch.from_numpy(rng.integers(1, 2**30, WIDE_HPASS_SHAPE, dtype=np.int32)).to(dev)
    for p in (0.5, 0.999, 1.0):
        fg = torch.from_numpy(rng.random(WIDE_HPASS_SHAPE) < p).to(dev)
        record("hpass", max_err(row_scan.hpass(lab, fg), row_scan.hpass_plain(lab, fg)), f"{WIDE_HPASS_SHAPE} fg={p}")
    out = dict(wide_hpass_ms=cuda_ms(lambda: row_scan.hpass(lab, fg)), wide_hpass_bound_ms=bound_ms("hpass", lab.numel()))
    say(f"  {WIDE_HPASS_SHAPE}: hpass (the wide route: a block a row, chunks of {row_scan.WIDE_CHUNK}) bit-exact at "
        f"fg 0.5, 0.999, 1.0; {out['wide_hpass_ms']:.4f} ms (bound {out['wide_hpass_bound_ms']:.4f} ms)")

    B, H, W = WIDE_TIMED
    fg = torch.from_numpy(make_frames(B, H, W, 20 * W // 1280, seed=11) > 50).to(dev)
    route = tl.ccl_route_of(fg, 2)
    lin = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).reshape(H, W)
    lab0 = torch.where(fg, lin, 2**30)
    out["wide_vertical_pass_ms"] = cuda_ms(lambda: tl.vertical_pass(lab0, fg, 2, False))
    say(f"  vertical_pass at {WIDE_TIMED} 8-connected, {route.bands} bands of {route.band}: "
        f"{out['wide_vertical_pass_ms']:.4f} ms (bound {bound_ms('vertical_pass', lab0.numel()):.4f} ms)")
    for conn in (2, 1):
        _, sw = tl._fixpoint(lab0, fg, conn, 256)
        ms = cuda_ms(lambda: tl._fixpoint(lab0, fg, conn, 256), iters=10)
        per_px = ms * 1e6 / lab0.numel()
        base = one_block[conn]
        say(f"  ccl_fixpoint at {WIDE_TIMED} {4 * conn}-connected, {route.bands} bands of {route.band}: {ms:.4f} ms a "
            f"fixpoint, sweeps per frame {sorted(set(sw.tolist()))}, {per_px:.3f} ns a pixel; the one-block route at "
            f"{FIXPOINT_SHAPES[0]}: {base * 1e6 / math.prod(FIXPOINT_SHAPES[0]):.3f} ns a pixel")
        out[f"wide_ms_{4 * conn}"] = ms
        out[f"wide_ns_per_px_{4 * conn}"] = per_px
    return out


# The grid route (frames whose bands the card cannot hold at once, C4): a row
# of 4,000,000 columns, and 8 rows of 1,200,000 with runs and components
# across every band; then narrow frames with CCL_BAND lowered so that they
# need more bands than the card has SMs.
GRID_CCL_SHAPES = ((1, 1, 4_000_000), (1, 8, 1_200_000))
GRID_FORCED = ((32, (3, 61, 4300)), (32, (2, 1, 9000)), (64, (5, 16, 8449)))


def phase_grid_ccl(dev, record, banded_ns: dict) -> dict:
    """The grid route against the plain versions on the card, bit-exact:
    the fixpoint's labels and per-frame sweep counts (raster and random
    seeds, both connectivities, serpentines capped at 1 and 3 sweeps), the
    8-connected pass alone and ``label()`` (against ``plain_label``) at
    ``GRID_CCL_SHAPES``, the same at ``GRID_FORCED``'s narrow frames with
    ``CCL_BAND`` lowered; each case's route and time printed, the fixpoint's
    time a pixel beside the banded route's (``banded_ns``: 4/8-connected
    ns a pixel at ``WIDE_TIMED``). Returns the times."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl

    rng = np.random.default_rng(12)
    out = {}

    def cases(shape, fg_np, timed: bool):
        B, H, W = shape
        fg = torch.from_numpy(fg_np).to(dev)
        route = tl.ccl_route_of(fg, 2)
        check(route.route == "grid", f"{shape} takes the {route.route} route")
        lin = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).reshape(H, W)
        seeds = (torch.where(fg, lin, 2**30), torch.from_numpy(rng.integers(1, 2**30, shape, dtype=np.int32)).to(dev))
        serp = torch.from_numpy(serpentine(*shape) if H > 4 else np.ones(shape, bool)).to(dev)
        sweeps, times = set(), []
        for conn in (1, 2):
            for lab0 in seeds:
                lab, sw = tl._fixpoint(lab0, fg, conn, 256)
                ref, ref_sw = tl.fixpoint_plain(lab0, fg, conn, 256)
                record("ccl_fixpoint", max(max_err(lab, ref), max_err(sw, ref_sw)), f"{shape} grid connectivity={conn}")
                sweeps |= set(sw.tolist())
            for cap in (1, 3):
                lab0 = torch.where(serp, lin, 2**30)
                lab, sw = tl._fixpoint(lab0, serp, conn, cap)
                ref, ref_sw = tl.fixpoint_plain(lab0, serp, conn, cap)
                record("ccl_fixpoint", max(max_err(lab, ref), max_err(sw, ref_sw)),
                       f"{shape} grid serpentine connectivity={conn} max_iters={cap}")
            labels, n = tl.label(fg, connectivity=conn)
            ref, n_ref = plain_label(fg, conn)
            check(torch.equal(labels, ref) and torch.equal(n, n_ref),
                  f"label() differs from label() through the plain versions at {shape} connectivity={conn}")
            if timed:
                ms = cuda_ms(lambda: tl._fixpoint(seeds[0], fg, conn, 256), iters=3)
                times.append(ms)
                out[f"grid_ms_{4 * conn}_{W}"] = ms
                out[f"grid_ns_per_px_{4 * conn}_{W}"] = ms * 1e6 / fg.numel()
        for rev in (False, True):
            e = max_err(tl.vertical_pass(seeds[0], fg, 2, rev), tl.vertical_pass_plain(seeds[0], fg, 2, rev))
            record("vertical_pass", e, f"{shape} grid connectivity=2 reverse={rev}")
        msg = (f"route grid ({route.bands} chunks of {route.band} columns); ccl_fixpoint (4/8-connected, raster and "
               f"random seeds, sweeps {sorted(sweeps)}; serpentines capped at 1 and 3), vertical_pass (8-connected, "
               f"down/up) and label() bit-exact")
        if timed:
            msg += (f"; a fixpoint of raster seeds 4-connected {times[0]:.4f} ms ({times[0] * 1e6 / fg.numel():.3f} "
                    f"ns a pixel), 8-connected {times[1]:.4f} ms ({times[1] * 1e6 / fg.numel():.3f} ns a pixel); the "
                    f"banded route at {WIDE_TIMED}: {banded_ns[4]:.3f} / {banded_ns[8]:.3f} ns a pixel")
        return msg

    for shape in GRID_CCL_SHAPES:
        fg_np = wide_masks(shape, seed=shape[2] % 1000)
        t0 = time.perf_counter()
        msg = cases(shape, fg_np, timed=True)
        say(f"  {shape}: {msg} ({time.perf_counter() - t0:.1f} s)")
    saved = tl.CCL_BAND
    try:
        for band, shape in GRID_FORCED:
            tl.CCL_BAND = band
            msg = cases(shape, rng.random(shape) < 0.6, timed=False)
            say(f"  {shape} with CCL_BAND = {band}: {msg}")
    finally:
        tl.CCL_BAND = saved
    return out


def relabel_cases(r_max: int, main=(8, 1024, 1280), edges=()) -> list:
    """K8's cases: (where, labels, R, offset). R = 256 (loki's 4 *
    max_regions) on rectangle frames (ids beyond R) at the path's shape and
    ``edges``, all-background frames and a region covering each frame;
    R = 1; ``r_max``, the largest R the plan takes on this card, at loki's
    shape and a small one, with ids beyond it and negative; H*W not a
    multiple of 8 or of 4 (frames not 16-B aligned); rows not 16-B aligned
    (offset 1); B = 1; the dense haul's (8, 2048, 2560), which takes the
    two-read route."""
    rng = np.random.default_rng(6)
    R = 4 * POSTPROCESS.max_regions
    cases = [(f"{main} rectangles", region_labels(main, R, seed=2), R, 0),
             (f"{main} background", np.zeros(main, np.int32), R, 0),
             (f"{main} one region covering each frame", np.ones(main, np.int32), R, 0),
             (f"{main} R = 1", region_labels(main, 1, seed=7), 1, 0)]
    cases += [(f"{s} rectangles", region_labels(s, R, seed=3), R, 0) for s in edges]
    for shape in ((2, 512, 640), main):
        cases.append((f"{shape} R = {r_max} (the largest the plan takes), ids beyond R and negative",
                      rng.integers(-3, r_max + 50, shape, dtype=np.int32), r_max, 0))
    for s in ((3, 1001, 1277), (4, 33, 1276), (2, 3, 5)):
        cases.append((f"{s} rectangles (H*W % 8 = {s[1] * s[2] % 8})", region_labels(s, R, seed=8), R, 0))
    cases += [("(2, 96, 1280) rectangles, rows not 16-B aligned", region_labels((2, 96, 1280), R, seed=9), R, 1),
              ("(1, 1024, 1280) rectangles, B = 1", region_labels((1, 1024, 1280), R, seed=10), R, 0),
              ("(8, 2048, 2560) rectangles, the dense haul's frames", region_labels((8, 2048, 2560), R, seed=11), R, 0)]
    return cases


# K8's timed shapes: loki's frames, the perf lab's, the dense haul's.
RELABEL_TIMED = ((8, 1024, 1280), (8, 1024, 1024), (8, 2048, 2560))


def relabel_times(lab, R: int, min_area: int) -> dict:
    """K8's times on ``lab``: CUDA events around host-paced calls (``ms``),
    the device time with the queue full on one input (``queued_ms``, L2
    warm) and rotating over copies that exceed the L2 (``queued_l2_cold_ms``),
    the plain version's and the bound."""
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl

    def fn(x):
        return tl.remove_small_objects(x, min_area, R)

    cold = l2_cold_inputs(lab)
    t = dict(ms=cuda_ms(lambda: fn(lab)), queued_ms=queued_ms(lambda: fn(lab), iters=50),
             queued_l2_cold_ms=queued_ms(fn, iters=50, inputs=cold),
             plain_ms=cuda_ms(lambda: tl.remove_small_objects_plain(lab, min_area, R), iters=5),
             bound_ms=bound_ms("remove_small_objects", lab.numel()), library_ms=None)
    del cold
    return t


def phase_relabel(dev, main, edges, record) -> dict:
    """K8 against its plain version on the card at ``relabel_cases``, each
    with min_area 0, 1 and 30: bit-exact, the same bits from two calls, the
    plan's route and cluster size printed; the wrapper's raise one id beyond
    the largest R. Times at ``RELABEL_TIMED``; returns those at ``main``
    with the route."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl

    min_area = POSTPROCESS.min_area
    r_max = tl.relabel_max_segments(tl._relabel_capacity(dev)[0])
    for where, lab_np, R, offset in relabel_cases(r_max, main, edges):
        lab = on_card(lab_np, dev, offset)
        plan = tl.remove_small_objects_plan(lab, R)
        for m in (0, 1, min_area):
            k_out, k_n = tl.remove_small_objects(lab, m, R)
            again = tl.remove_small_objects(lab, m, R)
            p_out, p_n = tl.remove_small_objects_plain(lab, m, R)
            torch.cuda.synchronize()
            record("remove_small_objects", max(max_err(k_out, p_out), max_err(k_n, p_n)), f"{where} min_area={m}")
            check(torch.equal(k_out, again[0]) and torch.equal(k_n, again[1]),
                  f"remove_small_objects differs between two calls at {where} min_area={m}")
        say(f"  {where}: remove_small_objects bit-exact and the same twice at min_area 0, 1, {min_area} "
            f"({plan.route}, clusters of {plan.cluster}; kept per frame at {min_area}: {sorted(set(k_n.tolist()))})")
        del lab, k_out, k_n, again, p_out, p_n
    try:
        tl.remove_small_objects(torch.zeros((1, 8, 8), dtype=torch.int32, device=dev), min_area, r_max + 1)
    except ValueError as e:
        say(f"  remove_small_objects raises at R = {r_max + 1}: {e}")
    else:
        raise AssertionError(f"remove_small_objects took R = {r_max + 1}, beyond the plan's largest")
    R = 4 * POSTPROCESS.max_regions
    out = None
    for shape in RELABEL_TIMED:
        lab = torch.from_numpy(region_labels(shape, R, seed=2)).to(dev)
        plan = tl.remove_small_objects_plan(lab, R)
        t = relabel_times(lab, R, min_area)
        say(f"  remove_small_objects at {shape}, R = {R} ({plan.route}, clusters of {plan.cluster}): queue full, "
            f"L2 cold {t['queued_l2_cold_ms']:.4f} ms, L2 warm {t['queued_ms']:.4f} ms; host-paced {t['ms']:.4f} "
            f"ms; plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms")
        if out is None:
            out = dict(t, plan_route=plan.route, cluster=plan.cluster)
        del lab
    return out


def phase_kernels(dev, main=(8, 1024, 1280),
                  edges=((8, 1024, 1), (8, 1024, 1000), (8, 1, 1280), (4, 64, 37), (2, 96, 1277))) -> dict:
    """K1, K2, K4, ``ccl_fixpoint`` and K8 against their plain versions on
    the card, bit-exact (the fixpoint's sweep counts too), at the main
    path's shape, at edge shapes and (K1, K2, K4, the fixpoint) at the fused
    measurement's shapes; CUDA-event times at the main path's shape (the
    fixpoint's also at (32, 256, 256))."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    rng = np.random.default_rng(1)
    cases = [(f"{main} fg={p}", main, p) for p in (0.0, 0.05, 0.5, 1.0)]
    cases += [(f"{main} serpentine", main, "serpentine")]
    cases += [(f"{s} fg=0.5", s, 0.5) for s in edges]
    cases += [(f"{s} {p}", s, p) for s in PREDICT_LABEL_SHAPES for p in ("blobs", 0.3)]
    err = dict.fromkeys(KERNELS, 0)
    out = {}

    def record(name, e, where):
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} differs from its plain version at {where} by {e}")

    def record_fixpoint(lab0, fg, conn, cap, where) -> int:
        lab, sweeps = tl._fixpoint(lab0, fg, conn, cap)
        ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, conn, cap)
        e = max(max_err(lab, ref), max_err(sweeps, ref_sweeps))
        record("ccl_fixpoint", e, f"{where} connectivity={conn} max_iters={cap} (labels and sweep counts)")
        return int(sweeps.max())

    for where, shape, p in cases:
        if p == "serpentine":
            fg_np = serpentine(*shape)
        elif p == "blobs":
            fg_np = blob_masks(shape, seed=int(rng.integers(1 << 30)))
        else:
            fg_np = rng.random(shape) < p
        fg = torch.from_numpy(fg_np).to(dev)
        ints = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).to(dev)
        record("cumsum_rows", max_err(row_scan.cumsum_rows(ints), row_scan.cumsum_rows_plain(ints)), where)
        # Random labels, and the raster ids on the foreground that `label` seeds.
        raster = torch.arange(1, math.prod(shape[1:]) + 1, dtype=torch.int32, device=dev).reshape(shape[1:])
        random_lab = torch.from_numpy(rng.integers(1, 2**30, shape, dtype=np.int32)).to(dev)
        sweeps = []
        for lab in (random_lab, torch.where(fg, raster, 2**30)):
            record("hpass", max_err(row_scan.hpass(lab, fg), row_scan.hpass_plain(lab, fg)), where)
            for conn in (1, 2):
                for rev in (False, True):
                    e = max_err(tl.vertical_pass(lab, fg, conn, rev), tl.vertical_pass_plain(lab, fg, conn, rev))
                    record("vertical_pass", e, f"{where} connectivity={conn} reverse={rev}")
                # The serpentine needs a sweep a switchback: capped, it stops half done.
                for cap in (1, 3) if p == "serpentine" else (256,):
                    sweeps.append(record_fixpoint(lab, fg, conn, cap, where))
        lab = random_lab
        torch.cuda.synchronize()
        if shape == main and p == 0.05:
            px = lab.numel()
            out["hpass"] = dict(ms=cuda_ms(lambda: row_scan.hpass(lab, fg)),
                                plain_ms=cuda_ms(lambda: row_scan.hpass_plain(lab, fg)),
                                bound_ms=bound_ms("hpass", px), library_ms=None)
            out["cumsum_rows"] = dict(ms=cuda_ms(lambda: row_scan.cumsum_rows(ints)),
                                      plain_ms=cuda_ms(lambda: row_scan.cumsum_rows_plain(ints)),
                                      bound_ms=bound_ms("cumsum_rows", px),
                                      library_ms=cuda_ms(lambda: torch.cumsum(ints, dim=-1, dtype=torch.int32)))
            vp4 = cuda_ms(lambda: tl.vertical_pass(lab, fg, 1, False))
            out["vertical_pass"] = dict(ms=cuda_ms(lambda: tl.vertical_pass(lab, fg, 2, False)),
                                        plain_ms=cuda_ms(lambda: tl.vertical_pass_plain(lab, fg, 2, False), iters=3),
                                        bound_ms=bound_ms("vertical_pass", px), library_ms=None)
            say(f"  {where}: 8-connected vertical_pass {out['vertical_pass']['ms']:.4f} ms, "
                f"4-connected {vp4:.4f} ms")
        route = tl.ccl_route_of(fg, 2).route
        check(route == "one_block", f"the path's shape {shape} takes the {route} route")
        say(f"  {where}: hpass, cumsum_rows, vertical_pass (4/8-connected, down/up; random and raster "
            f"labels), ccl_fixpoint (4/8-connected, sweeps {sorted(set(sweeps))}) bit-exact, "
            f"fg {float(fg_np.mean()):.3f}, route {route}")

    out["remove_small_objects"] = phase_relabel(dev, main, edges, record)
    out["ccl_fixpoint"] = fixpoint_timings(dev)
    out["ccl_fixpoint"].update(phase_wide_ccl(dev, record, out["ccl_fixpoint"].pop("one_block_ms")))
    banded = {c: out["ccl_fixpoint"][f"wide_ns_per_px_{c}"] for c in (4, 8)}
    out["ccl_fixpoint"].update(phase_grid_ccl(dev, record, banded))
    for name, m in out.items():
        m.update(max_abs_err=err[name], bound_by="bytes")
        say(f"  {name} at {main}: {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms"
            + (f", library {m['library_ms']:.4f} ms" if m["library_ms"] is not None else ""))
    return out


# K7's props that are integers (or exact float64 sums of float32 terms, the
# perimeter) and must be equal; the rest must agree within rtol 1e-5 / atol
# 1e-3 (mu11 is centred per row on the kernel route, per pixel on the plain
# one), the orientation modulo pi.
K7_EXACT = ("area", "min_row", "max_row", "min_col", "max_col", "histogram", "intensity_sum",
            "intensity_min", "intensity_max", "perimeter")


def threshold_buckets() -> list:
    """Crops as the threshold path's buckets hold them: (N, H, W) uint8 with
    a bright blob (a ring in every other crop) on dark noise, zero padded."""
    rng = np.random.default_rng(21)
    out = []
    for N, Hb, Wb in ((256, 64, 128), (8, 512, 512)):
        imgs = np.zeros((N, Hb, Wb), np.uint8)
        for i in range(N):
            h, w = int(rng.integers(Hb // 2, Hb + 1)), int(rng.integers(Wb // 2, Wb + 1))
            yy, xx = np.mgrid[:h, :w]
            d2 = (yy - h / 2) ** 2 + (xx - w / 2) ** 2
            r = min(h, w) / 3
            crop = (rng.random((h, w)) * 40).astype(np.uint8)
            crop[(d2 <= r * r) & ((i % 2 == 0) | (d2 >= r * r / 4))] = rng.integers(120, 250)
            imgs[i, :h, :w] = crop
        out.append(imgs)
    return out


def compare_props(kp: dict, pp: dict, where: str) -> float:
    """K7's props (``kp``) against the plain version's (``pp``): the same
    keys, ``K7_EXACT`` equal, the orientation modulo pi and the rest within
    rtol 1e-5 / atol 1e-3. Returns the largest absolute difference of the
    rest."""
    import torch

    torch.cuda.synchronize()
    check(set(kp) == set(pp), f"K7 keys differ at {where}: {set(kp) ^ set(pp)}")
    worst = 0.0
    for k in pp:
        a, b = kp[k].cpu().numpy(), pp[k].cpu().numpy()
        if k in K7_EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{k} at {where}")
        elif k == "orientation":
            d = np.abs(a - b) % np.pi
            check(np.minimum(d, np.pi - d).max() <= 1e-3 + 1e-5 * np.abs(b).max(), f"orientation at {where}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3, err_msg=f"{k} at {where}")
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def on_card(arr: np.ndarray, dev, offset: int = 0):
    """``arr`` as a contiguous tensor on the card whose data starts
    ``offset`` elements past the start of its allocation (offset 1: no row
    is 16-B aligned)."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)[offset:].view(t.shape)
    return out.copy_(t)


def region_cases(main=(8, 1024, 1280)) -> list:
    """The region-measurement kernel's cases: (where, labels, intensity, R,
    offset). loki's shape with R = 64 on blob, serpentine and rectangle
    label frames (ids beyond R), all-background and one-region frames, ids
    beyond R and negative ids; ragged widths and heights; unaligned rows;
    the dense haul's width with intensity 255 everywhere (Σ I·x and Σ I·y
    past 2³²); R = 256 (the histogram in device memory); the threshold
    path's buckets with R = 2."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(5)
    R = POSTPROCESS.max_regions
    frames = make_frames(main[0], main[1], main[2], 20, seed=15)
    blobs = np.stack([ndi.label(f > 60, np.ones((3, 3)))[0] for f in frames]).astype(np.int32)
    odd = blobs.copy()
    odd[rng.random(main) < 0.01] = -3
    odd[rng.random(main) < 0.01] = R + 7
    cases = [(f"{main} blobs", blobs, frames, R, 0),
             (f"{main} serpentine", serpentine(*main).astype(np.int32), frames, R, 0),
             (f"{main} rectangles", region_labels(main, R, seed=16), frames, R, 0),
             (f"{main} background", np.zeros(main, np.int32), frames, R, 0),
             (f"{main} one region", np.ones(main, np.int32), frames, R, 0),
             (f"{main} blobs, ids beyond R and negative", odd, frames, R, 0)]
    for shape in ((8, 1024, 1), (8, 1, 1280), (3, 1000, 1280), (2, 37, 1000), (2, 96, 1277), (4, 64, 37)):
        cases.append((f"{shape} rectangles", region_labels(shape, R, seed=17),
                      rng.integers(0, 256, shape, dtype=np.uint8), R, 0))
    shape = (2, 96, 1280)
    cases.append((f"{shape} rectangles, rows not 16-B aligned", region_labels(shape, R, seed=18),
                  rng.integers(0, 256, shape, dtype=np.uint8), R, 1))
    dense = (2, 2048, 2560)
    cases.append((f"{dense} rectangles, intensity 255", region_labels(dense, R, seed=19),
                  np.full(dense, 255, np.uint8), R, 0))
    shape = (2, 512, 640)
    cases.append((f"{shape} rectangles", region_labels(shape, 256, seed=20),
                  rng.integers(0, 256, shape, dtype=np.uint8), 256, 0))
    for imgs in threshold_buckets():
        cases.append((f"{imgs.shape} threshold crops", (imgs > 50).astype(np.int32), imgs, 2, 0))
    return cases


PARTIAL_NAMES = ("sums", "rowcnt", "rowsumx", "rowminx", "rowmaxx", "colcnt")


def check_region_kernel(lab, img, r: int, where: str) -> None:
    """The region-measurement kernel's partials and histogram against their
    plain versions, bit for bit, and the same bits in a second launch; the
    histogram alone (``region_histogram``) too."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
    from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf

    got = rf.region_props_partials(lab, img, r)
    again = rf.region_props_partials(lab, img, r)
    ref = rf.region_props_partials_plain(lab, img, r)
    for name, a, b, c in zip(PARTIAL_NAMES, got, again, ref):
        check(torch.equal(a, c), f"the region kernel's {name} differs from the plain version at {where} "
              f"by {max_err(a, c)}")
        check(torch.equal(a, b), f"the region kernel's {name} differs between two launches at {where}")
    if img is not None:
        hist = rh.region_histogram_plain(lab, img, r)
        check(torch.equal(got[6].float(), hist), f"the fused histogram differs at {where} by {max_err(got[6], hist)}")
        check(torch.equal(got[6], again[6]), f"the fused histogram differs between two launches at {where}")
        alone = rh.region_histogram(lab, img, r)
        check(torch.equal(alone, hist), f"region_histogram differs at {where} by {max_err(alone, hist)}")


def region_timings(lab, img, R: int) -> dict:
    """CUDA-event times of the fused launch, the histogram alone, the whole
    ``regionprops_fused`` call and its derivation (the call less the
    launch), beside the bounds: the fused launch's (labels and intensity
    read once, partials and histogram written once) and the histogram's
    alone; the plain versions' and ``bincount``'s (K3's plain version)."""
    from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
    from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf

    B, H, W = lab.shape
    px = lab.numel()
    partials_out = B * R * 5 * 8 + 4 * B * H * R * 4 + B * W * R * 4
    hist_out = B * R * 256 * 4
    m = dict(fused_ms=cuda_ms(lambda: rf.region_props_partials(lab, img, R)),
             hist_ms=cuda_ms(lambda: rh.region_histogram(lab, img, R)),
             call_ms=cuda_ms(lambda: rf.regionprops_fused(lab, img, num_segments=R)),
             fused_bound_ms=bytes_ms(5 * px + partials_out + hist_out),
             hist_bound_ms=bytes_ms(5 * px + hist_out),
             plain_fused_ms=cuda_ms(lambda: (rf.region_props_partials_plain(lab, img, R),
                                             rh.region_histogram_plain(lab, img, R)), iters=3),
             plain_call_ms=cuda_ms(lambda: rf.regionprops_fused_plain(lab, img, num_segments=R), iters=3),
             bincount_ms=cuda_ms(lambda: rh.region_histogram_plain(lab, img, R)))
    m["derivation_ms"] = m["call_ms"] - m["fused_ms"]
    return m


def phase_region_kernels(dev, main=(8, 1024, 1280)) -> dict:
    """K3 and K7, one kernel (``csrc/region_measure.cu``), against their
    plain versions on the card at ``region_cases``: the partials (the
    perimeter units included) and the histogram bit-exact and the same in
    two launches, the histogram alone too, the props of ``regionprops_fused``
    (integers exact, the rest within tolerance) and its options (no
    intensity, no histogram, no feret). Times at the main shape on the blob
    frames and at the threshold path's buckets."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf

    R = POSTPROCESS.max_regions
    worst = 0.0
    times = {}
    for where, lab_np, img_np, r, offset in region_cases(main):
        lab, img = on_card(lab_np, dev, offset), on_card(img_np, dev, offset)
        check_region_kernel(lab, img, r, where)
        kp = rf.regionprops_fused(lab, img, num_segments=r)
        pp = rf.regionprops_fused_plain(lab, img, num_segments=r)
        worst = max(worst, compare_props(kp, pp, where))
        if where == f"{(2, 37, 1000)} rectangles":
            check_region_kernel(lab, None, r, f"{where} without intensity")
            # The wrapper's options that no path of the port uses yet.
            for kw in (dict(intensity=None), dict(compute_histogram=False), dict(n_feret_angles=0)):
                args = {"intensity": img, "num_segments": r, **kw}
                compare_props(rf.regionprops_fused(lab, **args), rf.regionprops_fused_plain(lab, **args), f"{where} {kw}")
            say(f"  {where}: partials without intensity bit-exact; regionprops_fused without intensity, without "
                f"histogram, without feret within tolerance")
        say(f"  {where}, R={r}: partials and histogram bit-exact, the same twice, region_histogram bit-exact; "
            f"props within tolerance; regions present per frame up to {int((kp['area'] > 0).sum(-1).max())}")
        if where == f"{main} blobs" or where.endswith("threshold crops"):
            times[where] = m = region_timings(lab, img, r)
            say(f"  times at {where}, R={r}: fused launch {m['fused_ms']:.4f} ms (bound {m['fused_bound_ms']:.4f}), "
                f"region_histogram alone {m['hist_ms']:.4f} ms (bound {m['hist_bound_ms']:.4f}), whole "
                f"regionprops_fused call {m['call_ms']:.4f} ms, its derivation {m['derivation_ms']:.4f} ms; plain "
                f"partials + histogram {m['plain_fused_ms']:.4f} ms, plain call {m['plain_call_ms']:.4f} ms, "
                f"bincount {m['bincount_ms']:.4f} ms")
        del lab, img, kp, pp
    m = times[f"{main} blobs"]
    buckets = {k: v for k, v in times.items() if k != f"{main} blobs"}
    return {
        "region_histogram": dict(
            ms=m["hist_ms"], plain_ms=m["bincount_ms"], bound_ms=m["hist_bound_ms"],
            # The library call is torch.bincount of the joint index built in
            # the timed region: the plain version itself.
            library_ms=m["bincount_ms"], max_abs_err=0, bound_by="bytes",
            at_buckets={k: v["hist_ms"] for k, v in buckets.items()},
        ),
        "regionprops_fused": dict(
            ms=m["fused_ms"], plain_ms=m["plain_fused_ms"], bound_ms=m["fused_bound_ms"], library_ms=None,
            max_abs_err=0, bound_by="bytes", call_ms=m["call_ms"], derivation_ms=m["derivation_ms"],
            plain_call_ms=m["plain_call_ms"], props_max_abs_err=worst,
            at_buckets={k: {n: v[n] for n in ("fused_ms", "call_ms", "derivation_ms", "fused_bound_ms")}
                        for k, v in buckets.items()},
        ),
    }


def half_ulp(v, mantissa_bits: int):
    """One ulp at |v| of a 16-bit float with ``mantissa_bits`` stored bits
    (bfloat16 7, float16 10), at least 2**-16: below that the float32
    statistics' rounding (~1e-6 of the unit scale) is larger than an ulp."""
    import torch

    e = torch.floor(torch.log2(torch.clamp(v.abs(), min=2.0 ** (mantissa_bits - 16))))
    return torch.exp2(e - mantissa_bits)


def norm_layouts(dev) -> str:
    """The layouts the U-Net and the classifier feed their norms: one bf16
    forward of each, with every ``group_norm`` call's input recorded."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import layers
    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    seen = []
    forward = layers.GroupNorm.forward

    def spy(self, x):
        seen.append("channels_last" if not x.is_contiguous() else "NCHW")
        return forward(self, x)

    out = []
    layers.GroupNorm.forward = spy
    try:
        for name, model in (("U-Net", UNet(**SEMSEG_UNET)), ("classifier", ConvClassifier(**CLASSIFIER))):
            seen.clear()
            with torch.inference_mode():
                model.to(dev)(torch.rand((2, 256, 256, 3), device=dev))
            out.append(f"{name} {', '.join(f'{seen.count(k)} {k}' for k in sorted(set(seen)))}")
    finally:
        layers.GroupNorm.forward = forward
    torch.cuda.synchronize()
    return "; ".join(out)


def norm_times(fn, plain, library, bound: float) -> dict:
    """A GroupNorm kernel's times: CUDA events around host-paced calls
    (``ms``), the device time with the queue kept full (``queued_ms``), the
    plain version's and the library call's, and the bound."""
    return dict(ms=cuda_ms(fn, iters=10), queued_ms=queued_ms(fn, iters=20), plain_ms=cuda_ms(plain, iters=3),
                library_ms=cuda_ms(library, iters=10), bound_ms=bound)


def say_times(t: dict, library: str) -> str:
    return (f"; {t['ms']:.4f} ms (queue full {t['queued_ms']:.4f}), plain {t['plain_ms']:.4f} ms, {library} "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")


def phase_group_norm(dev) -> dict:
    """K5 against its plain version on the card at the inference path's,
    the train step's and the distillation's shapes and odd shapes, both
    layouts, float32, bfloat16 and float16 (a task may ask for any of
    them): y within 1e-5 (float32) or one 16-bit ulp, the same bits from
    two calls, and the mean and rstd it saves for the backward (K6) within
    rtol 1e-5 / atol 1e-5 of ``group_stats_plain``'s. Each shape's mode
    (one read or two passes, ``layers.group_norm_plan``) is printed. Times
    at the inference path's and the distillation's shapes in bfloat16."""
    import torch
    import torch.nn.functional as F

    from maze_image_processing_pipeline_tpu_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = (list(GN_SHAPES) + list(GN_TRAIN_SHAPES) + list(GN_DISTILL_SHAPES)
              + [(3, 16, 5, 7), (4, 512, 9, 11), (8, 32, 30, 31), (2, 2600, 4, 4)])
    mantissa = {torch.bfloat16: 7, torch.float16: 10}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0, torch.float16: 0.0}
    times = {}
    for shape in shapes:
        C = shape[1]
        G = min(8, C)
        w = torch.rand(C, device=dev, generator=gen) + 0.5
        b = torch.randn(C, device=dev, generator=gen)
        base = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for layout in ("NCHW", "channels_last"):
                x = base.to(dtype)
                if layout == "channels_last":
                    x = x.contiguous(memory_format=torch.channels_last)
                y, stats = layers._group_norm_forward(x, w, b, G, 1e-6)
                y2, stats2 = layers._group_norm_forward(x, w, b, G, 1e-6)
                ref = layers.group_norm_plain(x, w, b, G)
                ref_stats = layers.group_stats_plain(x, G)
                torch.cuda.synchronize()
                where = f"{shape} {str(dtype)[6:]} {layout}"
                check(y.stride() == x.stride(), f"group_norm changed the layout at {where}")
                check(torch.equal(y, y2) and torch.equal(stats, stats2), f"group_norm not deterministic at {where}")
                check(torch.allclose(stats, ref_stats, rtol=1e-5, atol=1e-5),
                      f"group_norm's saved statistics differ from the plain ones at {where} by "
                      f"{float((stats - ref_stats).abs().max()):.3g}")
                err = float((y.float() - ref.float()).abs().max())
                worst[dtype] = max(worst[dtype], err)
                if dtype == torch.float32:
                    ok = torch.allclose(y, ref, rtol=1e-5, atol=1e-5)
                    detail = f"max abs diff {err:.3g}"
                else:
                    ok = bool(((y.float() - ref.float()).abs() <= half_ulp(ref.float(), mantissa[dtype])).all())
                    detail = f"{int((y != ref).sum())} of {y.numel()} elements differ by one ulp"
                if not ok:
                    raise AssertionError(f"group_norm differs from its plain version at {where}")
                if shape in GN_SHAPES + GN_DISTILL_SHAPES and dtype == torch.bfloat16:
                    t = times[(shape, layout)] = norm_times(
                        lambda: layers.group_norm(x, w, b, G), lambda: layers.group_norm_plain(x, w, b, G),
                        lambda: F.group_norm(x, G, w.to(dtype), b.to(dtype), eps=1e-6),
                        bound_ms("group_norm", x.numel()))
                    detail += say_times(t, "F.group_norm")
                say(f"  {where}: group_norm ({layers.group_norm_plan(x, G).mode}) and its statistics within "
                    f"tolerance, the same bits twice, {detail}")
                del x, y, y2, ref, stats, stats2, ref_stats
        del base
    say(f"  group_norm feeds: {norm_layouts(dev)}")
    main = times[(GN_SHAPES[0], "channels_last")]
    return {"group_norm": dict(main, max_abs_err=worst[torch.bfloat16], bound_by="bytes")}


def norm_ops(*args: str) -> dict:
    """``tools/norm_ops.py`` with ``args`` in a process of its own: its JSON
    line, after printing the profiler sessions it discarded as blind."""
    out = subprocess.run([sys.executable, "-m", "maze_image_processing_pipeline_tpu_torch.tools.norm_ops", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"tools/norm_ops.py {' '.join(args)} failed: {out.stderr[-3000:]}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    say(f"  tools/norm_ops.py {' '.join(args)}: profiler sessions discarded as blind (no device activity, not even "
        f"the control kernel): {result['blind_sessions']}")
    return result


def phase_norm_ops() -> None:
    """The device operations of one K5 and one K6 call at the path's, the
    train step's and the distillation's shapes, both layouts, of one K8
    call at ``RELABEL_TIMED``, and of one K9 call on the perf lab's and the
    dense haul's masks, contiguous and transposed (``tools/norm_ops.py``
    under ``torch.profiler``, in processes of their own): each must be one
    kernel, with no memset or copy. K9's library calls' operations are
    printed (what ``Tensor.clone()`` launches)."""
    for case in norm_ops()["cases"]:
        where = f"{tuple(case['shape'])} bfloat16 {case['layout']}"
        for kind, name in (("fwd", "gn_fwd_kernel"), ("bwd", "gn_bwd_kernel")):
            ops = case[kind]
            check(len(ops) == 1 and sum(ops.values()) == 1 and name in next(iter(ops)),
                  f"{name} at {where}: device operations {ops}")
        say(f"  {where}: one device operation a call, K5 ({case['mode_fwd']}) and K6 ({case['mode_bwd']})")
    for case in norm_ops("--relabel")["relabel"]:
        ops = case["ops"]
        check(len(ops) == 1 and sum(ops.values()) == 1 and "relabel_cluster_kernel" in next(iter(ops)),
              f"remove_small_objects at {tuple(case['shape'])}: device operations {ops}")
        say(f"  {tuple(case['shape'])}: one device operation a remove_small_objects call ({case['route']}, "
            f"clusters of {case['cluster']})")
    for case in norm_ops("--anchor")["anchor"]:
        ops, kernel = case["anchor"], "copy_vec_kernel" if case["view"] == "contiguous" else "transpose_bytes_kernel"
        where = f"{tuple(case['shape'])} bool {case['view']}"
        check(len(ops) == 1 and sum(ops.values()) == 1 and kernel in next(iter(ops)),
              f"anchor at {where}: device operations {ops}")
        library = "; ".join(f"{n} x {k[:100]}" for k, n in case["library"].items())
        say(f"  {where}: one device operation an anchor call ({kernel}); its library call "
            f"({'Tensor.clone()' if case['view'] == 'contiguous' else '.contiguous()'}) launches: {library}")


def within_f32(got, ref) -> bool:
    """float32 tolerance of K6 against its plain version: rtol 1e-4 plus
    1e-5 of the reference's largest magnitude (sums in other orders)."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-5 * ref.abs().max()).all())


def phase_group_norm_bwd(dev) -> dict:
    """K6 against its plain version on the card at the train step's shapes
    and odd shapes, both layouts, float32, bfloat16 and float16: dx within
    the float32 tolerance (``within_f32``) or one 16-bit ulp, dweight and
    dbias within the float32 tolerance, and the same bits on a repeated
    call; the same tolerances through autograd (``group_norm(...)
    .backward(ct)``: K5's saved statistics into K6) against the plain
    version on the plain statistics. Times in bfloat16 at the train step's
    shapes, beside the plain
    version's and ``torch.ops.aten.native_group_norm_backward``'s (which
    needs NCHW-contiguous tensors on the card: for channels_last its timed
    call includes the copies)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(12)
    shapes = list(GN_TRAIN_SHAPES) + list(GN_DISTILL_SHAPES) + [(3, 16, 5, 7), (4, 512, 9, 11), (8, 32, 30, 31),
                                                                (2, 24, 7, 5), (2, 2600, 4, 4)]
    mantissa = {torch.bfloat16: 7, torch.float16: 10}
    worst = 0.0
    times = {}
    for shape in shapes:
        C = shape[1]
        G = min(8, C)
        B, HW = shape[0], math.prod(shape[2:])
        w = torch.rand(C, device=dev, generator=gen) + 0.5
        bias = torch.randn(C, device=dev, generator=gen)
        base_x = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        base_ct = torch.randn(shape, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for layout in ("NCHW", "channels_last"):
                fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
                x = base_x.to(dtype).contiguous(memory_format=fmt)
                ct = base_ct.to(dtype).contiguous(memory_format=fmt)
                stats = layers.group_stats_plain(x, G)
                got = layers.group_norm_bwd(x, ct, w, stats, G)
                again = layers.group_norm_bwd(x, ct, w, stats, G)
                ref = layers.group_norm_bwd_plain(x, ct, w, stats, G)
                # The chain the train step runs: K5's saved statistics into K6.
                xg, wg, bg = x.detach().requires_grad_(), w.clone().requires_grad_(), bias.clone().requires_grad_()
                layers.group_norm(xg, wg, bg, G).backward(ct)
                auto = (xg.grad, wg.grad, bg.grad)
                torch.cuda.synchronize()
                where = f"{shape} {str(dtype)[6:]} {layout}"
                check(got[0].stride() == x.stride() and auto[0].stride() == x.stride(),
                      f"group_norm_bwd changed the layout at {where}")
                check(all(torch.equal(a, b) for a, b in zip(got, again)), f"group_norm_bwd not deterministic at {where}")
                details = []
                for how, grads in (("on the plain statistics", got), ("through autograd", auto)):
                    err = float((grads[0].float() - ref[0].float()).abs().max())
                    if dtype == torch.float32:
                        ok = within_f32(grads[0], ref[0])
                        details.append(f"dx {how} max abs diff {err:.3g}")
                    else:
                        ok = bool(((grads[0].float() - ref[0].float()).abs()
                                   <= half_ulp(ref[0].float(), mantissa[dtype])).all())
                        details.append(f"dx {how}: {int((grads[0] != ref[0]).sum())} of {x.numel()} elements "
                                       "differ by one ulp")
                        if dtype == torch.bfloat16:
                            worst = max(worst, err)
                    if not (ok and within_f32(grads[1], ref[1]) and within_f32(grads[2], ref[2])):
                        raise AssertionError(f"group_norm_bwd {how} differs from its plain version at {where}: "
                                             f"{details[-1]}")
                detail = "; ".join(details)
                if shape in GN_TRAIN_SHAPES + GN_DISTILL_SHAPES and dtype == torch.bfloat16:
                    # The card's native GroupNorm takes statistics and weight
                    # in the activations' dtype (as F.group_norm in phase 2).
                    mean, rstd, w_lib = stats[0].view(B, G).to(dtype), stats[1].view(B, G).to(dtype), w.to(dtype)

                    def library():
                        return torch.ops.aten.native_group_norm_backward(
                            ct.contiguous(), x.contiguous(), mean, rstd, w_lib, B, C, HW, G, [True, True, True])

                    lib = library()
                    lib_err = float((lib[0].float() - ref[0].float()).abs().max())
                    t = times[(shape, layout)] = norm_times(
                        lambda: layers.group_norm_bwd(x, ct, w, stats, G),
                        lambda: layers.group_norm_bwd_plain(x, ct, w, stats, G), library,
                        bound_ms("group_norm_bwd", x.numel()))
                    detail += (say_times(t, "native_group_norm_backward")
                               + f" (its dx within {lib_err:.3g} of the plain version's)")
                    del lib
                say(f"  {where}: group_norm_bwd ({layers.group_norm_plan(x, G, backward=True).mode}) within "
                    f"tolerance, the same bits twice, {detail}")
                del x, ct, got, again, ref, xg, auto
        del base_x, base_ct
    for layout in ("NCHW", "channels_last"):
        step = sum(k * times[(s, layout)]["ms"] for s, k in zip(GN_TRAIN_SHAPES, GN_TRAIN_NORMS))
        queued = sum(k * times[(s, layout)]["queued_ms"] for s, k in zip(GN_TRAIN_SHAPES, GN_TRAIN_NORMS))
        bound = sum(k * times[(s, layout)]["bound_ms"] for s, k in zip(GN_TRAIN_SHAPES, GN_TRAIN_NORMS))
        say(f"  group_norm_bwd over the train step's 18 norms, all {layout}: {step:.4f} ms (queue full "
            f"{queued:.4f}), bound {bound:.4f} ms")
    main = times[(GN_TRAIN_SHAPES[0], "channels_last")]
    return {"group_norm_bwd": dict(main, max_abs_err=worst, bound_by="bytes")}


ANCHOR_SHAPES = ((8, 1024, 1024), (8, 2048, 2560), (8, 1023, 1277), (3, 37, 1001), (1, 1, 1))


def phase_anchor(dev) -> dict:
    """K9 against its plain version on the card, bit-exact: bool masks at
    the perf lab's shapes ((8, 1024, 1024) and the dense haul's (8, 2048,
    2560)), a tail that is not a multiple of 16 B, odd shapes ((3, 37,
    1001), (1, 1, 1)), a transposed view (the tiled transpose) and a
    sliced one, and uint8, int32 and float32. At (8, 1024, 1024) and (8,
    2048, 2560) bool: CUDA-event times beside ``Tensor.clone()`` (the
    library call: a contiguous copy of a contiguous tensor), and the
    transposed view's beside ``.contiguous()``, each also with the queue
    kept full (``queued_ms``: the device's time without the host's per-call
    time), on one input (L2 warm) and rotating over copies that exceed the
    L2 (``l2_cold_inputs``); the bound is 2 · bytes / 3.35 TB/s."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops.anchor import anchor, anchor_plain

    gen = torch.Generator(device=dev).manual_seed(13)
    cases = 0
    for shape in ANCHOR_SHAPES:
        for dtype in (torch.bool, torch.uint8, torch.int32, torch.float32):
            if dtype != torch.bool and shape == ANCHOR_SHAPES[1]:
                continue
            base = (torch.rand(shape, device=dev, generator=gen) * 200).to(dtype)
            views = {"contiguous": base, "transposed": base.transpose(1, 2), "sliced": base[:, ::2, 1:]}
            for how, view in views.items():
                if view.numel() == 0:
                    continue
                out = anchor(view)
                torch.cuda.synchronize()
                check(out.is_contiguous() and out.shape == view.shape and out.dtype == dtype,
                      f"anchor's output at {shape} {dtype} {how} is not a contiguous copy")
                check(torch.equal(out, anchor_plain(view)), f"anchor differs from its plain version at {shape} "
                                                             f"{dtype} {how}")
                cases += 1
            del base, views
    say(f"  anchor bit-exact in {cases} cases: {', '.join(map(str, ANCHOR_SHAPES))}; bool, uint8, int32, float32; "
        "contiguous, transposed and sliced views")
    out = {}
    for shape in ANCHOR_SHAPES[:2]:
        mask = torch.rand(shape, device=dev, generator=gen) < 0.3
        tview = mask.transpose(1, 2)
        cold = l2_cold_inputs(mask)
        t = dict(ms=cuda_ms(lambda: anchor(mask)), plain_ms=cuda_ms(lambda: anchor_plain(mask)),
                 library_ms=cuda_ms(lambda: mask.clone()), bound_ms=bound_ms("anchor", mask.numel()),
                 queued_ms=queued_ms(lambda: anchor(mask)), library_queued_ms=queued_ms(lambda: mask.clone()),
                 queued_l2_cold_ms=queued_ms(anchor, iters=50, inputs=cold),
                 library_queued_l2_cold_ms=queued_ms(lambda m: m.clone(), iters=50, inputs=cold))
        cold_t = [(c[0].transpose(1, 2),) for c in cold]
        t.update(transposed_ms=cuda_ms(lambda: anchor(tview)),
                 transposed_library_ms=cuda_ms(lambda: tview.contiguous()),
                 transposed_queued_ms=queued_ms(lambda: anchor(tview)),
                 transposed_library_queued_ms=queued_ms(lambda: tview.contiguous()),
                 transposed_queued_l2_cold_ms=queued_ms(anchor, iters=50, inputs=cold_t),
                 transposed_library_queued_l2_cold_ms=queued_ms(lambda m: m.contiguous(), iters=50, inputs=cold_t))
        del cold, cold_t
        say(f"  anchor at {shape} bool: {t['ms']:.4f} ms, plain (contiguous().clone()) {t['plain_ms']:.4f} ms, "
            f"Tensor.clone() {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (2 x {mask.numel() / 1e6:.1f} MB"
            f"{', below a launch latency' if t['bound_ms'] < 0.01 else ''}); with the queue full (device time "
            f"back to back): anchor {t['queued_ms']:.4f} ms, Tensor.clone() {t['library_queued_ms']:.4f} ms; with "
            f"the queue full and L2 cold: anchor {t['queued_l2_cold_ms']:.4f} ms, Tensor.clone() "
            f"{t['library_queued_l2_cold_ms']:.4f} ms; "
            f"transposed view: anchor {t['transposed_ms']:.4f} ms, .contiguous() {t['transposed_library_ms']:.4f} "
            f"ms; queue full: {t['transposed_queued_ms']:.4f} / {t['transposed_library_queued_ms']:.4f} ms; queue "
            f"full, L2 cold: {t['transposed_queued_l2_cold_ms']:.4f} / "
            f"{t['transposed_library_queued_l2_cold_ms']:.4f} ms")
        if shape == ANCHOR_SHAPES[0]:
            out["anchor"] = dict(t, max_abs_err=0, bound_by="bytes")
        del mask, tview
    return out


def phase_frame_chain(dev, B=2, H=1024, W=1280) -> str:
    """The frame chain on the card (kernels) against the CPU (plain)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.loki.device_seg import _build_frame_chain

    rng = np.random.default_rng(2)
    image = make_frames(B, H, W, 20, seed=3)
    pred = np.where(image > 60, 0.9, 0.1) + 0.1 * rng.standard_normal(image.shape)
    pred = pred.astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        chain, keys = _build_frame_chain(POSTPROCESS)
        with torch.inference_mode():
            labels, flat = chain(torch.from_numpy(pred).to(d), torch.from_numpy(image).to(d))
        out[d.type] = (labels.cpu().numpy(), flat.cpu().numpy(), list(keys))
    (lg, fg_, keys), (lc, fc, keys_c) = out[dev.type], out["cpu"]
    check(keys == keys_c, f"packed keys differ: {keys} vs {keys_c}")
    if not np.array_equal(lg, lc):
        raise AssertionError(f"labels differ on {int((lg != lc).sum())} pixels")
    R, K = POSTPROCESS.max_regions, len(keys)
    n_g, n_c = fg_[:B], fc[:B]
    pg = fg_[B : B + K * B * R].reshape(K, B, R)
    pc = fc[B : B + K * B * R].reshape(K, B, R)
    hist_g, hist_c = fg_[B + K * B * R :], fc[B + K * B * R :]
    check(np.array_equal(n_g, n_c), f"region counts differ: {n_g} vs {n_c}")
    check(np.array_equal(hist_g, hist_c), "histograms differ")
    exact = ("area", "area_filled", "area_filled_ambiguous", "min_row", "max_row",
             "min_col", "max_col", "intensity_min", "intensity_max")
    worst = 0.0
    for i, k in enumerate(keys):
        if k in exact:
            check(np.array_equal(pg[i], pc[i]), f"{k} differs")
        else:
            np.testing.assert_allclose(pg[i], pc[i], rtol=1e-5, atol=1e-3, err_msg=k)
            rel = np.abs(pg[i] - pc[i]) / np.maximum(np.abs(pc[i]), 1.0)
            worst = max(worst, float(rel.max()))
    return (
        f"regions per frame {n_g.astype(int).tolist()}, labels/counts/histograms/integer "
        f"props exact, float props within rtol 1e-5 atol 1e-3 (max relative diff {worst:.3g})"
    )


def phase_unet(dev) -> str:
    """Full-width U-Net in float32, card against CPU."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.model_io import init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = UNet(**UNET, dtype=torch.float32)
    model.load_state_dict(params_from_jax(init_unet_params(UNET, seed=4)))
    x = torch.from_numpy(np.random.default_rng(5).random((2, 256, 256, 3), dtype=np.float32))
    with torch.inference_mode():
        y_cpu = model.eval()(x)
        y_gpu = model.to(dev)(x.to(dev)).cpu()
    scale = max(1.0, float(y_cpu.abs().max()))
    err = float((y_gpu - y_cpu).abs().max())
    # float32 convolutions sum in other orders on the card (cuDNN) than on
    # the CPU; 13 conv layers with GroupNorm stay well inside 1e-3 relative.
    if not (math.isfinite(err) and err <= 1e-3 * scale):
        raise AssertionError(f"U-Net logits differ by {err} (scale {scale})")
    msg = f"U-Net logits (2, 256, 256, 1) max abs diff {err:.3g}, tolerance 1e-3 x {scale:.3g}"

    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.model_io import init_classifier_params

    clf = ConvClassifier(**CLASSIFIER, dtype=torch.float32)
    clf.load_state_dict(params_from_jax(init_classifier_params(CLASSIFIER, seed=4)))
    x = torch.from_numpy(np.random.default_rng(6).random((4, 256, 256, 3), dtype=np.float32))
    with torch.inference_mode():
        y_cpu = clf.eval()(x)
        y_gpu = clf.to(dev)(x.to(dev)).cpu()
    scale = max(1.0, float(y_cpu.abs().max()))
    err = float((y_gpu - y_cpu).abs().max())
    if not (math.isfinite(err) and err <= 1e-3 * scale):
        raise AssertionError(f"classifier logits differ by {err} (scale {scale})")
    return msg + f"; classifier logits (4, 8) max abs diff {err:.3g}, tolerance 1e-3 x {scale:.3g}"


def run_slice(dev, frames: np.ndarray, model, seg_cfg=SEGMENTATION, post_cfg=POSTPROCESS):
    """The segmentation slice in an engine Pipeline; returns per frame the
    (n_regions, [(RegionInfo, roi, features)]) in emission order."""
    from maze_image_processing_pipeline_tpu_torch.engine import Call, Pipeline, Unpack
    from maze_image_processing_pipeline_tpu_torch.engine.image import (
        CalculateZooProcessFeatures,
        ExtractROI,
        FindRegions,
    )
    from maze_image_processing_pipeline_tpu_torch.loki.device_seg import DeviceTiledSegmentation

    per_frame = []
    objects = []
    with Pipeline() as p:
        idx, image = Unpack([(i, f) for i, f in enumerate(frames)]).unpack(2)
        labels, props, n_regions, regions = DeviceTiledSegmentation(
            image, model, seg_cfg, post_cfg, device=dev
        )
        Call(lambda i, n: per_frame.append((int(i), int(n))), idx, n_regions)
        region = FindRegions(
            labels, image, padding=seg_cfg.padding, min_intensity=seg_cfg.min_intensity,
            props=props, regions=regions,
        )
        roi = ExtractROI(image, region, alpha=0, labels=labels)
        meta = CalculateZooProcessFeatures(region, Call(lambda i: {"frame": int(i)}, idx), prefix="object_")
        Call(lambda i, r, o, m: objects.append((int(i), r, o, m)), idx, region, roi, meta)
    p.run()
    return per_frame, objects


def check_objects(frames: np.ndarray, per_frame, objects) -> int:
    """Every frame came out in order; every object is well formed."""
    check([i for i, _ in per_frame] == list(range(len(frames))), "frames missing or out of order")
    n_regions = 0
    for i, region, roi, meta in objects:
        y0, x0, y1, x1 = region.bbox_padded
        check(region.image.shape == (y1 - y0, x1 - x0) == roi.shape, "crop shapes disagree")
        check(region.image.any(), "empty region mask")
        np.testing.assert_array_equal(roi, frames[i, y0:y1, x0:x1])
        check(all(np.isfinite(np.asarray(v, np.float64)).all() for v in region.props.values()), "non-finite props")
        feats = {k: v for k, v in meta.items() if k.startswith("object_")}
        check(feats and all(math.isfinite(float(v)) for v in feats.values()), "non-finite features")
        n_regions += 1
    return n_regions


def _counted():
    """The kernel wrappers, by name: each counts its launches."""
    from maze_image_processing_pipeline_tpu_torch.models import layers
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
    from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan
    from maze_image_processing_pipeline_tpu_torch.ops.anchor import anchor

    return {"hpass": row_scan.hpass, "cumsum_rows": row_scan.cumsum_rows, "vertical_pass": tl.vertical_pass,
            "ccl_fixpoint": tl._fixpoint,
            "remove_small_objects": tl.remove_small_objects, "group_norm": layers.group_norm,
            "group_norm_bwd": layers.group_norm_bwd, "region_histogram": rh.region_histogram,
            "regionprops_fused": rf.regionprops_fused, "anchor": anchor,
            **{name: getattr(layers, name) for name in SPLIT_NORMS}}


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0
        fn.launches_by_device = {}


def read_launches_by_card(where: str, expected, cards: int) -> dict:
    """The launches since :func:`reset_launches` on each card (by index);
    every kernel in ``expected`` must have launched on each of the first
    ``cards`` cards."""
    by_card = {name: dict(getattr(fn, "launches_by_device", {})) for name, fn in _counted().items()}
    for name in expected:
        for i in range(cards):
            if by_card[name].get(i, 0) <= 0:
                raise AssertionError(f"kernel {name} did not launch on card {i} in {where}: {by_card[name]}")
    return {name: v for name, v in by_card.items() if v}


def read_launches(where: str, expected=INFERENCE_KERNELS,
                  absent=("group_norm_bwd", "anchor") + CCL_PASSES + SPLIT_NORMS) -> dict:
    """The launch counts since :func:`reset_launches`; every kernel the
    phase's path runs (``expected``) must have launched, and the kernels of
    other paths (``absent``) must not have."""
    launches = {name: fn.launches for name, fn in _counted().items()}
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} did not launch in {where}")
    for name in absent:
        if launches[name] != 0:
            raise AssertionError(f"kernel {name} launched {launches[name]} times in {where}")
    return launches


def phase_slice(dev, limit: str) -> dict:
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.model_io import LoadedModel, init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    module = UNet(**UNET, dtype=torch.bfloat16)
    module.load_state_dict(params_from_jax(init_unet_params(UNET, seed=6)))
    model = LoadedModel(module, {})
    frames = make_frames(24, 1024, 1280, 20, seed=7)

    run_slice(dev, frames[:8], model)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_frame, objects = run_slice(dev, frames, model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("phase 5")
    n_obj = check_objects(frames, per_frame, objects)
    regions = sum(n for _, n in per_frame)
    say(
        f"  frames {len(per_frame)}, regions {regions}, objects {n_obj}, wall {wall:.3f} s, "
        f"{len(per_frame) / wall:.3f} frames/s, launches {launches} [{limit}]"
    )
    return launches


# -- phase 6: maze-ipp loki through the port's Runner ------------------------

# -- phase 7: maze-ipp predict through the port's Runner ---------------------

SEMSEG_UNET = dict(out_channels=2, base_features=32, depth=4)
CLASSIFIER = dict(n_outputs=8, features=[32, 64, 128, 256])
SMALL_SEMSEG_UNET = dict(out_channels=2, base_features=4, depth=1)
SMALL_CLASSIFIER = dict(n_outputs=4, features=[4, 8])
CHANNELS = ("prosoma", "oilsack")


def semseg_task(archive: str, model_fn: str, target_dir: str, tiling=None, segmentation=None, **model) -> dict:
    """The semseg task of ``tools/bench_e2e.py`` (tiles 256 / stride 192,
    batch 64, chunk 32, fill_holes, the device blend with fused measurement),
    without ``save_raw_h5``."""
    return {
        "input": {"path": archive},
        "model": {"model_fn": model_fn, "batch_size": 64,
                  "tiling": {"size": 256, "stride": 192, "chunk_size": 32, "in_flight": 2, **(tiling or {})},
                  **model},
        "segmentation": {"draw": False, "fill_holes": True, **(segmentation or {})},
        "target_dir": target_dir,
    }


def polytaxo_task(archive: str, model_fn: str, target_dir: str, taxonomy: tuple, polytaxo=None, **model) -> dict:
    """The polytaxo task of ``tools/bench_e2e.py`` (input 256, batch 256,
    threshold 0.01, every object written)."""
    return {
        "input": {"path": archive},
        "model": {"model_fn": model_fn, "batch_size": 256, "input_size": 256, **model},
        "polytaxo": {"poly_taxonomy_fn": taxonomy[0], "ecotaxa_taxonomy_fn": taxonomy[1], "threshold": 0.01,
                     "skip_unchanged_objects": False, **(polytaxo or {})},
        "target_dir": target_dir,
    }


LOKI_POSTPROCESS = {"min_area": 30, "closing_radius": 2}


def loki_task(data: str, model_fn: str, target_dir: str, **segmentation) -> dict:
    """The loki task of ``tools/bench_e2e.py`` (the standard haul's), with
    the masks stored beside the images."""
    seg = {
        "model_fn": model_fn,
        "batch_size": 16,
        "frame_batch": 8,
        "tile_size": 1024,
        "tile_stride": 896,
        "postprocess": LOKI_POSTPROCESS,
    }
    seg.update(segmentation)
    return {
        "input": {"path": data},
        "segmentation": {"jax": seg},
        "postprocess": {},
        "output": {"target_dir": target_dir, "store_mask": True},
    }


def _read_archive_tsv(z: zipfile.ZipFile):
    from maze_image_processing_pipeline_tpu_torch.dataio.ecotaxa import read_tsv

    return read_tsv(io.StringIO(z.read("ecotaxa_export.tsv").decode()))


def check_archive(fn: str) -> tuple:
    """The archive exists, its TSV has one row per object and every image and
    mask decodes. Returns (rows, images)."""
    from maze_image_processing_pipeline_tpu_torch.dataio.imageio import decode_image

    check(os.path.exists(fn), f"no archive at {fn}")
    with zipfile.ZipFile(fn) as z:
        df = _read_archive_tsv(z)
        names = [n for n in z.namelist() if n != "ecotaxa_export.tsv"]
        check(len(df) > 0, "the archive holds no object")
        check(df["object_id"].is_unique, "object ids repeat")
        check("img_file_name_1" in df.columns, "no masks in the archive")
        check(sorted(names) == sorted([*df["img_file_name"], *df["img_file_name_1"]]),
              "archive members are not one image and one mask per row")
        for n in names:
            img = decode_image(z.read(n))
            check(img is not None and img.size > 0, f"{n} does not decode")
    return len(df), len(names)


# Columns that name the run, not its result: the pipeline's name and the
# wall-clock time of the run (and the process id made from it).
RUN_COLUMNS = ("process_pipeline", "process_datetime", "process_id")


def compare_archives(ref_fn: str, fn: str, skip_columns=RUN_COLUMNS, one_level=()) -> int:
    """Two EcoTaxa archives hold the same members in the same order, the same
    TSV columns and rows; integer and text columns are equal, float columns
    within rtol 1e-5 / atol 1e-3 (float64-summed moments, as the frame chain
    is held card against CPU); decoded images and masks are equal, except
    that members whose names start with a prefix in ``one_level`` may differ
    by one grey level (the full-frame archive's score images: probabilities
    ×255, truncated, from two float32 forwards). Returns the number of
    rows."""
    from maze_image_processing_pipeline_tpu_torch.dataio.imageio import decode_image

    with zipfile.ZipFile(ref_fn) as za, zipfile.ZipFile(fn) as zb:
        check(za.namelist() == zb.namelist(), f"members differ: {za.namelist()} vs {zb.namelist()}")
        a, b = _read_archive_tsv(za), _read_archive_tsv(zb)
        check(list(a.columns) == list(b.columns), f"columns differ: {set(a.columns) ^ set(b.columns)}")
        check(len(a) == len(b), f"rows differ: {len(a)} vs {len(b)}")
        for col in a.columns:
            if col in skip_columns:
                continue
            x, y = a[col].to_numpy(), b[col].to_numpy()
            if x.dtype.kind == "f" and y.dtype.kind == "f":
                ints = np.all(np.isnan(x) | (x == np.round(x))) and np.all(np.isnan(y) | (y == np.round(y)))
                if ints:
                    np.testing.assert_array_equal(y, x, err_msg=col)
                else:
                    np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-3, err_msg=col)
            else:
                check(list(map(str, x)) == list(map(str, y)), f"column {col} differs")
        for n in za.namelist():
            if n == "ecotaxa_export.tsv":
                continue
            x, y = decode_image(za.read(n)).astype(np.int16), decode_image(zb.read(n)).astype(np.int16)
            if n.startswith(tuple(one_level)):
                check(x.shape == y.shape and np.abs(x - y).max() <= 1, f"{n} differs by more than one level")
            else:
                np.testing.assert_array_equal(y, x, err_msg=n)
    return len(a)


def run_loki(task: dict) -> float:
    """The port's Runner on ``task``; returns the wall time in seconds,
    up to the card's last result."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner

    t0 = time.perf_counter()
    Runner._configure_and_run(task)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_loki(limit: str, work: str) -> dict:
    """``maze-ipp loki`` at the standard haul's shapes on the card, then a
    small task on the card and on the CPU."""
    import torch

    data = os.path.join(work, "data")
    make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    unet = write_unet(os.path.join(work, "unet"), UNET, "bfloat16", seed=6)
    archive = "LOKI_PS122-1_7.zip"
    run_loki(loki_task(data, unet, os.path.join(work, "warm")))  # cuDNN choice, allocator
    reset_launches()
    wall = run_loki(loki_task(data, unet, os.path.join(work, "out")))
    launches = read_launches("phase 6")
    rows, members = check_archive(os.path.join(work, "out", archive))
    say(f"  standard haul: 24 frames, {rows} objects ({members} images and masks), wall {wall:.3f} s, "
        f"{24 / wall:.3f} frames/s, {rows / wall:.3f} objects/s, launches {launches} [{limit}]")
    traced_loki(work, limit, wall)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = os.path.join(work, "small")
    make_loki_tree(small, n_frames=2, objects_per_frame=20, frame_shape=(1024, 1280), seed=9)
    unet_s = write_unet(os.path.join(work, "unet_small"), SMALL_UNET, "float32", seed=0, gain=1000.0)
    for device in ("cuda", "cpu"):
        run_loki(loki_task(small, unet_s, os.path.join(work, device), dtype="float32", batch_size=4,
                           frame_batch=2, device=device))
    n = compare_archives(os.path.join(work, "cpu", archive), os.path.join(work, "cuda", archive))
    check(n > 0, "the small task's archive holds no object")
    say(f"  small task (2 frames, UNet(1, 8, 2) float32, TF32 off): card and CPU archives agree, {n} objects")
    # The label-frame paths: host blend (TorchInference, DeviceFramePostprocess),
    # segment merging and the full-frame debug archive.
    frames = "full_frames.zip"
    for device in ("cuda", "cpu"):
        run_loki(loki_task(small, unet_s, os.path.join(work, f"hb_{device}"), dtype="float32", batch_size=4,
                           frame_batch=2, device=device, device_blend=False, full_frame_archive_fn=frames,
                           postprocess={**LOKI_POSTPROCESS, "merge_segments_distance": 20}))
    n = compare_archives(os.path.join(work, "hb_cpu", archive), os.path.join(work, "hb_cuda", archive))
    m = compare_archives(os.path.join(work, "hb_cpu", frames), os.path.join(work, "hb_cuda", frames),
                         one_level=("score/",))
    check(n > 0 and m == 2, f"the host-blend task's archives hold {n} objects and {m} frames")
    say(f"  small task with device_blend: false, merge_segments_distance: 20 and full_frame_archive_fn: card and "
        f"CPU archives agree ({n} objects), full-frame archives agree ({m} frames; score images within one level)")
    return launches


TRACE_ATTEMPTS, TRACE_WAIT_S = 4, 30


def traced_loki(work: str, limit: str, warm_wall: float) -> dict:
    """Phase 6's standard-haul task once more through the command line
    (``maze-ipp-torch loki task.yaml``, its own process) with
    ``MAZE_IPP_PROFILE_DIR`` set: the Runner writes a ``torch.profiler``
    Chrome trace. Prints the trace's size and the share of the traced run's
    wall (the trace's span) spent in ``Memcpy HtoD`` device activities, and
    the same time over phase 6's warm wall. Returns the numbers."""
    import yaml

    task_dir = os.path.join(work, "traced")
    os.makedirs(task_dir, exist_ok=True)
    task_fn = os.path.join(task_dir, "loki.yaml")
    with open(task_fn, "w") as f:
        yaml.safe_dump(loki_task(os.path.join(work, "data"), os.path.join(work, "unet"),
                                 os.path.join(task_dir, "out")), f)
    env = {**os.environ, "PYTHONPATH": REPO}
    # The profiler has come back blind (no device activity) for minutes on a
    # fresh card (tools/norm_ops.py): a trace without kernels is taken again.
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        prof = os.path.join(work, f"prof{attempt}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "maze_image_processing_pipeline_tpu_torch.cli", "loki", task_fn],
                              cwd=REPO, env={**env, "MAZE_IPP_PROFILE_DIR": prof}, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"the traced loki run failed ({proc.returncode}): {proc.stderr[-3000:]}")
        traces = sorted(f for f in os.listdir(prof) if f.endswith(".pt.trace.json"))
        check(len(traces) == 1, f"the traced run wrote {traces}")
        path = os.path.join(prof, traces[0])
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        check(len(events) > 0, "the trace holds no event")
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        if kernels > 0:
            break
        say(f"  traced run {attempt}: the trace holds no kernel (the profiler was blind); again in {TRACE_WAIT_S} s")
        time.sleep(TRACE_WAIT_S)
    check(kernels > 0, f"the trace holds no kernel on the card in {TRACE_ATTEMPTS} runs")
    span_us = max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
    copies = {d: [e for e in events if e.get("cat") == "gpu_memcpy" and d in e.get("name", "")]
              for d in ("HtoD", "DtoH", "DtoD")}
    ms = {d: sum(e.get("dur", 0) for e in v) / 1e3 for d, v in copies.items()}
    out = dict(trace_bytes=os.path.getsize(path), span_s=span_us / 1e6, process_s=wall, htod_ms=ms["HtoD"],
               htod_copies=len(copies["HtoD"]), htod_share=ms["HtoD"] / (span_us / 1e3),
               htod_share_warm=ms["HtoD"] / (warm_wall * 1e3), dtoh_ms=ms["DtoH"])
    say(f"  traced run (MAZE_IPP_PROFILE_DIR, its own process, {wall:.1f} s): trace {out['trace_bytes']} bytes, "
        f"{len(events)} events ({kernels} kernels), span {out['span_s']:.3f} s; Memcpy HtoD {ms['HtoD']:.3f} ms in "
        f"{out['htod_copies']} copies = {100 * out['htod_share']:.3f} % of the traced span, "
        f"{100 * out['htod_share_warm']:.3f} % of phase 6's warm wall {warm_wall:.3f} s; Memcpy DtoH "
        f"{ms['DtoH']:.3f} ms, DtoD {ms['DtoD']:.3f} ms [{limit}]")
    return out


def threshold_task(data: str, target_dir: str, **threshold) -> dict:
    """A loki task with threshold segmentation (brighter than 50), the
    measurement's ``device`` at its default unless given."""
    return {
        "input": {"path": data},
        "segmentation": {"threshold": {"threshold_brighter": 50, **threshold}},
        "postprocess": {},
        "output": {"target_dir": target_dir, "store_mask": True},
    }


def compare_features(ref_fn: str, fn: str, rtol=2e-3, atol=2e-2) -> int:
    """The same objects in the same order, and every numeric ``object_``
    feature within rtol / atol of the reference's, the angle modulo 180
    degrees: the tolerance of the JAX package's device-against-host check of
    the threshold measurement (``tests/test_threshold_device.py``). Returns
    the number of objects."""
    with zipfile.ZipFile(ref_fn) as za, zipfile.ZipFile(fn) as zb:
        a, b = _read_archive_tsv(za), _read_archive_tsv(zb)
    check(list(a["object_id"]) == list(b["object_id"]), "objects differ")
    for col in a.columns:
        if not col.startswith("object_") or a[col].dtype.kind not in "fi" or b[col].dtype.kind not in "fi":
            continue
        x, y = a[col].to_numpy(np.float64), b[col].to_numpy(np.float64)
        if col == "object_angle":
            d = np.abs(x - y) % 180.0
            check(np.minimum(d, 180.0 - d).max() <= atol + rtol * 180.0, f"{col} differs")
        else:
            np.testing.assert_allclose(y, x, rtol=rtol, atol=atol, err_msg=col)
    return len(a)


def phase_threshold(limit: str, work: str) -> dict:
    """``maze-ipp loki`` with threshold segmentation through the port's
    Runner at a haul's size: 96 frames × 20 vignettes (60×80 blobs, every
    tenth 150-400 px a side), the measurement on the card (``device`` at its
    default). The card's archive must equal the ``device: "cpu"`` run's, and
    every object's features the host path's (``device: false``) within the
    JAX package's tolerance."""
    data = os.path.join(work, "thr_data")
    make_loki_tree(data, n_frames=96, objects_per_frame=20, frame_shape=(1024, 1280), seed=10, big_every=10)
    archive = "LOKI_PS122-1_7.zip"
    run_loki(threshold_task(data, os.path.join(work, "thr_warm")))
    reset_launches()
    wall = run_loki(threshold_task(data, os.path.join(work, "thr_card")))
    launches = read_launches("phase 8", expected=("ccl_fixpoint", "cumsum_rows") + REGION_KERNELS)
    card = os.path.join(work, "thr_card", archive)
    rows, members = check_archive(card)
    check(rows == 1920, f"the threshold archive holds {rows} objects, expected 1920")
    say(f"  1920 crops: {rows} objects ({members} images and masks), wall {wall:.3f} s, {rows / wall:.3f} objects/s, "
        f"launches {launches} [{limit}]")
    host_wall = run_loki(threshold_task(data, os.path.join(work, "thr_host"), device=False))
    m = compare_features(os.path.join(work, "thr_host", archive), card)
    say(f"  every object's features within rtol 2e-3 / atol 2e-2 of the host path's ({m} objects); the host path "
        f"(device: false) took {host_wall:.3f} s, {m / host_wall:.3f} objects/s")
    t0 = time.perf_counter()
    run_loki(threshold_task(data, os.path.join(work, "thr_cpu"), device="cpu"))
    n = compare_archives(os.path.join(work, "thr_cpu", archive), card)
    say(f"  card and device: cpu archives agree ({n} objects) ({time.perf_counter() - t0:.1f} s)")
    return launches


def crop_sizes(n: int, seed: int) -> list:
    """Seeded crop sizes: 40-200 px a side, one in ten 260-420 px (several
    256² tiles, blended)."""
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(260, 421, 2)) if i % 10 == 0 else
            tuple(int(v) for v in rng.integers(40, 201, 2)) for i in range(n)]


def run_predict(task: dict) -> float:
    """The port's predict Runner on ``task``; returns the wall time in
    seconds, up to the card's last result."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner

    t0 = time.perf_counter()
    Runner._configure_and_run(task)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def predict_inputs(work: str) -> dict:
    """Phase 7's archive of 480 crops, the full-width bf16 checkpoints and
    the taxonomy files."""
    return {
        "archive": make_crop_archive(os.path.join(work, "crops", "crops.zip"), crop_sizes(480, seed=12), seed=13),
        "unet": write_unet(os.path.join(work, "semseg_unet"), SEMSEG_UNET, "bfloat16", seed=0, gain=1000.0,
                           channel_names=CHANNELS),
        "clf": write_classifier(os.path.join(work, "clf"), CLASSIFIER, "bfloat16", seed=1),
        "taxonomy": make_taxonomy_files(os.path.join(work, "tax")),
    }


def check_predict_archive(fn: str, n: int, columns) -> None:
    """One row per object, finite values in the measured columns."""
    with zipfile.ZipFile(fn) as z:
        df = _read_archive_tsv(z)
    check(len(df) == n and df["object_id"].is_unique, f"{fn}: {len(df)} rows, expected {n}")
    for col in columns:
        check(col in df.columns and np.isfinite(df[col].to_numpy(np.float64)).all(), f"{fn}: column {col}")


def capture_fused_inputs(run) -> dict:
    """``run()`` with the fused measurement's inputs recorded: those of the
    call with the most pixels and of the call with the most rows."""
    from maze_image_processing_pipeline_tpu_torch.ops import segment_measure

    seen = {}
    measure = segment_measure.measure_channels_packed

    def spy(canvas, hs, ws, **kw):
        Bo, Hq, Wq, _ = canvas.shape
        for key, size in (("most pixels", Bo * Hq * Wq), ("most rows", Hq)):
            if key not in seen or size > seen[key][0]:
                seen[key] = (size, canvas.clone(), list(hs), list(ws), kw)
        return measure(canvas, hs, ws, **kw)

    segment_measure.measure_channels_packed = spy
    try:
        run()
    finally:
        segment_measure.measure_channels_packed = measure
    return {k: v[1:] for k, v in seen.items()}


def check_fused_measurement(captured: dict, ref_device="cpu") -> str:
    """The fused measurement of each captured canvas where it lies (the card:
    K1, K2, K4) against the same on ``ref_device`` (the plain versions):
    raw area, area, overflow flags and row extremes equal, axis lengths
    within rtol 1e-5 (float64 moment sums in other orders)."""
    from maze_image_processing_pipeline_tpu_torch.ops.segment_measure import (
        measure_channels_packed,
        unpack_channel_stats,
    )

    check(captured, "the fused measurement never ran")
    out = []
    for key, (canvas, hs, ws, kw) in captured.items():
        Bo, Hq, Wq, C = canvas.shape
        got = unpack_channel_stats(measure_channels_packed(canvas, hs, ws, **kw).cpu().numpy(), Bo, Hq, C)
        ref = unpack_channel_stats(measure_channels_packed(canvas.to(ref_device), hs, ws, **kw).cpu().numpy(),
                                   Bo, Hq, C)
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"row extremes, {key}")
        for field, name in ((0, "raw_area"), (1, "area"), (3, "overflow")):
            np.testing.assert_array_equal(got[0][:, field], ref[0][:, field], err_msg=f"{name}, {key}")
        np.testing.assert_allclose(got[0][:, 2], ref[0][:, 2], rtol=1e-5, err_msg=f"axis_major_length, {key}")
        out.append(f"{key} ({Bo}, {Hq}, {Wq}, {C}): {int(ref[0][:, 3].sum())} overflowing masks")
    return "; ".join(out)


def host_remeasured(ref_fn: str, fn: str) -> int:
    """The semseg archives of two runs whose fetched maps differ in type
    (float16 without ``.h5``; float32 or uint8 at those ``raw_h5_dtype``
    rungs): masks that overflow the fused measurement are measured again on
    the host from the fetched maps, so their channel measurements may move
    by the pixels whose probability rounds across 0.5. Every other column
    must be equal (``compare_archives``); the channel columns may differ in
    at most 5 % of the rows, each value by at most 1 pixel or 2 %. Returns
    (rows, rows that differ)."""
    with zipfile.ZipFile(ref_fn) as za, zipfile.ZipFile(fn) as zb:
        a, b = _read_archive_tsv(za), _read_archive_tsv(zb)
    channel = [c for c in a.columns if c.startswith(tuple(f"object_{ch}_" for ch in CHANNELS))]
    rows = compare_archives(ref_fn, fn, skip_columns=RUN_COLUMNS + tuple(channel))
    x, y = a[channel].to_numpy(np.float64), b[channel].to_numpy(np.float64)
    d = np.abs(x - y)
    check(np.all(d <= np.maximum(1.0, 0.02 * np.abs(x))), f"channel measurements of {fn} moved too far")
    moved = int((d > 0).any(axis=1).sum())
    check(moved <= 0.05 * rows, f"channel measurements of {moved} of {rows} rows moved in {fn}")
    return rows, moved


def semseg_h5(work: str, inp: dict, wall_plain: float) -> list:
    """Phase 7's semseg task with ``save_raw_h5: true`` at each
    ``raw_h5_dtype`` rung: its archive must equal the run without ``.h5``
    (float16, whose fetched maps are those of the run without ``.h5``), or
    differ only where ``host_remeasured`` allows (float32, uint8); the file
    must start with the HDF5 signature and hold one dataset per object, and
    a second write of the prediction stream the writer received (captured on
    the way) must give the same bytes. Returns a line per rung with the
    ``.h5`` export's seconds (the wall with ``.h5`` less the wall
    without)."""
    from maze_image_processing_pipeline_tpu_torch.dataio import HDF5Writer
    from maze_image_processing_pipeline_tpu_torch.engine import Call, Pipeline, Unpack
    from maze_image_processing_pipeline_tpu_torch.predict import pipeline as pp

    streams = []

    class Capturing(HDF5Writer):
        """The predict pipeline's writer, keeping each dataset it writes."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            streams.append((kwargs, []))

        def _create(self, h5, name, value):
            streams[-1][1].append((name, value.copy()))
            super()._create(h5, name, value)

    lines = []
    plain = os.path.join(work, "semseg", "crops.segmentation.zip")
    pp.HDF5Writer = Capturing
    try:
        for rung in ("float32", "float16", "uint8"):
            streams.clear()
            out = os.path.join(work, f"semseg_h5_{rung}")
            wall = run_predict({**semseg_task(inp["archive"], inp["unet"], out), "save_raw_h5": True,
                                "raw_h5_dtype": rung})
            archive = os.path.join(out, "crops.segmentation.zip")
            if rung == "float16":
                n, how = compare_archives(plain, archive), "archive equal to the run without .h5"
            else:
                n, moved = host_remeasured(plain, archive)
                how = f"archive equal to the run without .h5 but for {moved} rows re-measured from {rung} maps"
            fn = os.path.join(out, "crops.h5")
            with open(fn, "rb") as f:
                first = f.read()
            kwargs, items = streams[0]
            check(first[:8] == b"\x89HDF\r\n\x1a\n", f"{fn} does not start with the HDF5 signature")
            check(len(items) == n == 480, f"{fn}: {len(items)} datasets for {n} objects")
            again = os.path.join(out, "again.h5")
            with Pipeline() as p:
                item = Unpack(items)
                HDF5Writer(again, [(Call(lambda t: t[0], item), Call(lambda t: t[1], item))], **kwargs)
            p.run()
            with open(again, "rb") as f:
                check(f.read() == first, f"a second write of the {rung} stream gives other bytes")
            mb = sum(v.nbytes for _, v in items) / 1e6
            lines.append(f"semseg with save_raw_h5, raw_h5_dtype {rung}: {how}, {len(items)} datasets ({mb:.1f} "
                         f"MB of {items[0][1].dtype} maps, {len(first) / 1e6:.1f} MB on disk), a second write of "
                         f"the stream gives the same bytes; wall {wall:.3f} s, the .h5 export "
                         f"{wall - wall_plain:.3f} s ({100 * (wall - wall_plain) / wall:.1f} % of the wall)")
    finally:
        pp.HDF5Writer = HDF5Writer
    return lines


def phase_predict(limit: str, work: str) -> dict:
    """``maze-ipp predict`` (semseg, then polytaxo) at the benchmark's task
    settings on the card, then a small task on the card and on the CPU."""
    import torch

    inp = predict_inputs(work)
    semseg = lambda out: semseg_task(inp["archive"], inp["unet"], os.path.join(work, out))  # noqa: E731
    poly = lambda out: polytaxo_task(inp["archive"], inp["clf"], os.path.join(work, out), inp["taxonomy"])  # noqa: E731
    # Warm-up (cuDNN algorithm choice, allocator), keeping the fused
    # measurement's inputs for the card-against-CPU check below.
    fused_inputs = capture_fused_inputs(lambda: run_predict(semseg("semseg_warm")))
    run_predict(poly("poly_warm"))
    reset_launches()
    wall_s = run_predict(semseg("semseg"))
    wall_p = run_predict(poly("poly"))
    launches = read_launches("phase 7", expected=("ccl_fixpoint", "cumsum_rows", "group_norm"),
                             absent=REGION_KERNELS + ("group_norm_bwd", "anchor") + CCL_PASSES)
    measured = [f"object_{c}_{k}" for c in CHANNELS for k in ("raw_area", "area", "axis_major_length", "area_convex")]
    check_predict_archive(os.path.join(work, "semseg", "crops.segmentation.zip"), 480, measured)
    check_predict_archive(os.path.join(work, "poly", "crops.polytaxo.zip"), 480, [])
    say(f"  semseg: 480 objects, wall {wall_s:.3f} s, {480 / wall_s:.3f} objects/s; polytaxo: 480 objects, "
        f"wall {wall_p:.3f} s, {480 / wall_p:.3f} objects/s; launches {launches} [{limit}]")
    t0 = time.perf_counter()
    msg = check_fused_measurement(fused_inputs)
    say(f"  fused measurement of the full-width run's canvases, card against CPU: equal ({msg}; "
        f"{time.perf_counter() - t0:.1f} s)")
    for line in semseg_h5(work, inp, wall_s):
        say(f"  {line} [{limit}]")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    archive = make_crop_archive(os.path.join(work, "small", "crops.zip"), [(64, 64), (100, 90), (300, 170), (40, 56)],
                                seed=14, with_annotations=True)
    unet = write_unet(os.path.join(work, "unet_small2"), SMALL_SEMSEG_UNET, "float32", seed=0, gain=1000.0,
                      channel_names=CHANNELS)
    clf = write_classifier(os.path.join(work, "clf_small"), SMALL_CLASSIFIER, "float32", seed=0)
    for device in ("cuda", "cpu"):
        small = dict(device=device, dtype="float32", batch_size=2)
        run_predict(semseg_task(archive, unet, os.path.join(work, f"p_{device}"), tiling={"size": 64, "stride": 48},
                                **small))
        run_predict(polytaxo_task(archive, clf, os.path.join(work, f"p_{device}"), inp["taxonomy"], input_size=64,
                                  **small))
    n = [compare_archives(os.path.join(work, "p_cpu", f), os.path.join(work, "p_cuda", f))
         for f in ("crops.segmentation.zip", "crops.polytaxo.zip")]
    check(n == [4, 4], f"the small task's archives hold {n} rows, expected 4 each")
    say("  small task (4 crops, UNet(2, 4, 1) and ConvClassifier(4, (4, 8)) float32, TF32 off): card and CPU "
        ".segmentation.zip agree, .polytaxo.zip agree")
    return launches


# -- phase 9: training on the card --------------------------------------------

TRAIN_UNET = dict(out_channels=2, base_features=32, depth=4)
TRAIN_BATCH = (8, 512, 512, 3)
LOKI_UNET = dict(out_channels=1, base_features=32, depth=4)


def full_width_step(dev):
    """The full-width train step: ``UNet(2, 32, 4)`` bf16, AdamW 1e-3,
    ``bce_dice_loss``, one fixed batch of 8 tiles of 512² (distillation
    blobs) on the card. Returns (step, state, images, targets)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    module = UNet(**TRAIN_UNET, dtype="bfloat16")
    state, opt = tt.create_train_state(module, TRAIN_BATCH, device=dev)
    x, y = next(distill_batches(2, size=TRAIN_BATCH[1], batch=TRAIN_BATCH[0], seed=20))
    return tt.make_train_step(module, opt), state, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def train_grads_card_vs_cpu(dev) -> str:
    """First-step loss and gradients of ``UNet(1, 8, 2)`` float32 (TF32 off)
    on the card and on the CPU: the loss within rtol 1e-5, every gradient
    within 1e-3 of its tensor's norm plus 1e-5 of the whole gradient's norm.
    On this batch float32 rounding of the forward alone (GroupNorm
    statistics in float64 instead) moves the CPU's gradients by up to
    2.8e-4 of their norm; the conv biases that feed a GroupNorm have an
    analytically zero gradient, float noise on both sides."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = next(distill_batches(1, size=128, batch=4, seed=21))
    out = {}
    for d in (dev, torch.device("cpu")):
        module = UNet(**SMALL_UNET, dtype="float32")
        state, opt = tt.create_train_state(module, x.shape, device=d, seed=3)
        state, m = tt.make_train_step(module, opt)(state, x, y)
        out[d.type] = (float(m["loss"]), {k: p.grad.cpu().double() for k, p in module.named_parameters()})
    (loss_g, grads_g), (loss_c, grads_c) = out[dev.type], out["cpu"]
    check(math.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), f"losses {loss_g} vs {loss_c}")
    total = math.sqrt(sum(float((g ** 2).sum()) for g in grads_c.values()))
    worst = 0.0
    for k, g in grads_c.items():
        err = float((grads_g[k] - g).abs().max())
        check(err <= 1e-3 * float(g.norm()) + 1e-5 * total, f"gradient of {k} differs by {err} (norm {float(g.norm())})")
        worst = max(worst, err / max(float(g.norm()), 1e-30) if float(g.norm()) > 1e-5 * total else 0.0)
    return (f"UNet(1, 8, 2) float32, TF32 off: first-step loss {loss_g:.7f} vs {loss_c:.7f}, {len(grads_c)} gradients "
            f"within tolerance (largest difference over its tensor's norm {worst:.3g})")


def resumed_step(dev, step, state, x, y, n_steps: int, work: str) -> str:
    """The full-width step after a resume: ``state`` saved by
    ``save_checkpoint`` and restored by ``restore_checkpoint`` into a fresh
    state (every AdamW ``step`` counter must stay on the CPU, as a fresh
    run keeps it), then ``n_steps`` steps of the fresh and of the resumed
    state in turns, twice. The resumed step may be no slower than the fresh
    one beyond the spread of the fresh blocks (at least 3 %)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.train_loop import restore_checkpoint, save_checkpoint

    ckpt = os.path.join(work, "ckpt")
    save_checkpoint(ckpt, state, 13)
    step2, state2, _, _ = full_width_step(dev)
    restore_checkpoint(ckpt, state2)
    opt = state2.optimizer
    counters = [opt.state[p]["step"].device.type for g in opt.param_groups for p in g["params"]]
    check(counters and set(counters) == {"cpu"}, f"resumed AdamW step counters lie on {set(counters)}")
    blocks = {"fresh": [], "resumed": []}
    for _ in range(2):
        for name, fn, st in (("fresh", step, state), ("resumed", step2, state2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                fn(st, x, y)
            torch.cuda.synchronize()
            blocks[name].append(1e3 * (time.perf_counter() - t0) / n_steps)
    fresh, resumed = (sum(v) / len(v) for v in (blocks["fresh"], blocks["resumed"]))
    spread = max(max(blocks["fresh"]) - min(blocks["fresh"]), 0.03 * fresh)
    check(resumed <= fresh + spread, f"the resumed step takes {resumed:.2f} ms, the fresh one {fresh:.2f} ms "
                                     f"(spread {spread:.2f} ms)")
    del step2, state2
    return (f"after a resume ({len(counters)} AdamW step counters on the CPU): fresh / resumed steps in turns "
            f"{' / '.join(f'{a:.2f} / {b:.2f}' for a, b in zip(blocks['fresh'], blocks['resumed']))} ms a step")


def phase_train(dev, limit: str, work: str) -> dict:
    """Training through the port's ``models.train`` and ``train_loop`` on the
    card: the full-width U-Net step (tiles/s, a falling loss, 18 K5 and 18
    K6 launches a step), the polytaxo classifier's step, the first step card
    against CPU, and a loki U-Net distilled on the card that must find at
    least 432 of phase 6's 480 planted objects."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.model_io import save_model
    from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    step, state, x, y = full_width_step(dev)
    losses = [float(step(state, x, y)[1]["loss"]) for _ in range(3)]  # warm-up: cuDNN choice, allocator
    n_steps = 10
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    timed = [step(state, x, y)[1]["loss"] for _ in range(n_steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("phase 9 (U-Net step)", expected=("group_norm", "group_norm_bwd"),
                             absent=tuple(k for k in KERNELS if k not in ("group_norm", "group_norm_bwd")))
    check(launches["group_norm"] == 18 * n_steps and launches["group_norm_bwd"] == 18 * n_steps,
          f"K5 / K6 launched {launches['group_norm']} / {launches['group_norm_bwd']} times in {n_steps} steps")
    losses += [float(v) for v in timed]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"losses {losses}")
    say(f"  UNet(2, 32, 4) bf16, batch {TRAIN_BATCH[0]} of {TRAIN_BATCH[1]}², AdamW 1e-3: {n_steps} steps in "
        f"{wall:.3f} s, {1e3 * wall / n_steps:.2f} ms a step, {TRAIN_BATCH[0] * n_steps / wall:.3f} tiles/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches a step K5 {launches['group_norm'] // n_steps}, K6 "
        f"{launches['group_norm_bwd'] // n_steps} [{limit}]")
    say(f"  {resumed_step(dev, step, state, x, y, n_steps, work)} [{limit}]")
    del step, state, x, y

    clf = ConvClassifier(**CLASSIFIER, dtype="bfloat16")
    cstate, copt = tt.create_train_state(clf, (64, 256, 256, 3), device=dev, seed=1)
    cstep = tt.make_train_step(clf, copt, loss_fn=tt.bce_loss)
    rng = np.random.default_rng(22)
    cx = torch.from_numpy(rng.random((64, 256, 256, 3), dtype=np.float32)).to(dev)
    cy = torch.from_numpy((rng.random((64, CLASSIFIER["n_outputs"])) > 0.5).astype(np.float32)).to(dev)
    reset_launches()
    closses = [float(cstep(cstate, cx, cy)[1]["loss"]) for _ in range(3)]
    c_launches = read_launches("phase 9 (classifier step)", expected=("group_norm", "group_norm_bwd"),
                               absent=tuple(k for k in KERNELS if k not in ("group_norm", "group_norm_bwd")))
    check(c_launches["group_norm"] == 24 and c_launches["group_norm_bwd"] == 24, f"classifier launches {c_launches}")
    check(all(math.isfinite(v) for v in closses), f"classifier losses {closses}")
    say(f"  ConvClassifier(8) bf16, batch 64 of 256², bce_loss: 3 steps, losses {[round(v, 4) for v in closses]}, "
        f"launches K5 {c_launches['group_norm']}, K6 {c_launches['group_norm_bwd']}")
    del clf, cstate, copt, cx, cy
    for k, v in c_launches.items():
        launches[k] += v

    say(f"  card against CPU: {train_grads_card_vs_cpu(dev)}")

    # A loki U-Net distilled on the card, then phase 6's task on it; phase
    # 11 reuses it. It learns from tiles like the stitched frames it then
    # segments: the haul driver's own batches (noise and discs) hold no
    # black frame, and a model distilled on them finds 276 to 1600
    # objects depending on the seed and the rounding of its training.
    t0 = time.perf_counter()
    module = UNet(**LOKI_UNET, dtype="bfloat16")
    fit(module, vignette_batches(1), 200, input_shape=(8, 128, 128, 3), log_interval=1e9, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    unet = os.path.join(work, "haul_models", "loki-unet")
    save_model(unet, module, outputs={"pred": {"channel_names": ["foreground"]}})
    data = os.path.join(work, "data")
    if not os.path.isdir(data):
        make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    wall = run_loki(loki_task(data, unet, os.path.join(work, "distilled")))
    rows, _ = check_archive(os.path.join(work, "distilled", "LOKI_PS122-1_7.zip"))
    check(rows >= 432, f"the distilled U-Net found {rows} of the 480 planted objects (at least 432 needed)")
    say(f"  UNet(1, 32, 4) bf16 distilled for 200 steps of (8, 128, 128, 3) vignette tiles in {t_fit:.1f} s; phase 6's task on it: "
        f"{rows} of 480 objects, wall {wall:.3f} s (first run, not warmed up)")
    return launches


def train_stage_breakdown(dev, limit: str) -> None:
    """The full-width train step with a ``torch.cuda.synchronize()`` timer
    around its forward, loss, backward and optimizer step, then five steps
    under ``torch.profiler``: the device's idle share and the GroupNorm
    kernels' (K5, K6) share of the device time."""
    import torch

    step, state, x, y = full_width_step(dev)
    n = 5

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step(state, x, y)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run()  # warm-up: cuDNN choice, allocator
    plain = run()
    patches = [(state.module, "forward", "forward"), (torch.Tensor, "backward", "backward"),
               (state.optimizer, "step", "AdamW step")]
    wall, totals = timed_stages(patches, run)
    say(f"stage breakdown of the phase 9 train step ({n} steps with a synchronize around each stage; "
        f"{1e3 * wall / n:.2f} ms a step, {1e3 * plain / n:.2f} ms without timers) [{limit}]:")
    for stage, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {stage}: {1e3 * t / n:.2f} ms a step, {100 * t / wall:.1f} %")
    busy, events = idle_share(run, plain, steps=n)
    kernel = {name: sum(e.self_device_time_total for e in events if any(s in e.key for s in keys)) / 1e6
              for name, keys in (("K5", ("gn_fwd_kernel",)), ("K6", ("gn_bwd_kernel",)))}
    say(f"  K5 {1e3 * kernel['K5'] / n:.3f} ms a step ({100 * kernel['K5'] / busy:.1f} % of the device time), "
        f"K6 {1e3 * kernel['K6'] / n:.3f} ms a step ({100 * kernel['K6'] / busy:.1f} %)")


def timed_stages(patches, run):
    """``run()`` with a ``torch.cuda.synchronize()`` timer around each
    patched ``(object, attribute, name)``; returns (wall, {name: seconds})."""
    import torch

    totals: dict = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        wall = run()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return wall, totals


def device_events(prof) -> list:
    """The profile's device activities (kernels, copies, memsets), by name:
    the CPU-side operators that launched them carry the same device time
    again, and a range annotated on the device (``Optimizer.step#AdamW.step``)
    spans kernels already counted, so only the activities are summed."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                  key=lambda e: -e.self_device_time_total)


def idle_share(run, plain: float, steps: int = 1) -> tuple:
    """``run()`` once under ``torch.profiler``: the device's busy time and
    idle share, and the kernels that take the most device time (per step
    when ``run()`` takes ``steps`` train steps). Returns (busy seconds, the
    device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    say(f"device busy {busy:.3f} s in a profiled run of {wall:.3f} s: idle share {1 - busy / wall:.3f}; "
        f"against the unprofiled run's {plain:.3f} s: {1 - busy / plain:.3f}")
    per = " a step" if steps > 1 else ""
    for e in events[:12]:
        say(f"  {e.key[:70]}: {e.self_device_time_total / 1e3 / steps:.3f} ms device{per}, {e.count // steps} calls{per}")
    return busy, events


def predict_stage_breakdown(limit: str, work: str) -> None:
    """Phase 7's semseg and polytaxo tasks with a timer around each stage of
    the inference nodes, then under ``torch.profiler``."""
    from maze_image_processing_pipeline_tpu_torch.models import inference
    from maze_image_processing_pipeline_tpu_torch.ops import segment_measure

    inp = predict_inputs(work)
    tasks = {
        "semseg": lambda out: semseg_task(inp["archive"], inp["unet"], os.path.join(work, out)),
        "polytaxo": lambda out: polytaxo_task(inp["archive"], inp["clf"], os.path.join(work, out), inp["taxonomy"]),
    }
    dti, ti = inference.DeviceTiledInference.node_class, inference.TorchInference.node_class
    patches = [
        (dti, "_forward", "U-Net forward (upload, pre, forward, sigmoid)"),
        (dti, "_run_bucket", "dispatch of a bucket (tile cut, forward, blend, measurement, cast)"),
        (segment_measure, "measure_channels_packed", "fused measurement (label: ccl_fixpoint, K2; moments, extremes)"),
        (dti, "_unpack_chunk", "fetch + unpack"),
        (ti, "_dispatch", "classifier dispatch (stack, crop, upload, forward, cast)"),
        (ti, "_fetch", "classifier fetch"),
    ]
    for name, task in tasks.items():
        run_predict(task(f"{name}_warm"))
        plain = run_predict(task(f"{name}_plain"))
        wall, totals = timed_stages(patches, lambda: run_predict(task(f"{name}_timed")))
        say(f"stage breakdown of phase 7 {name} (one run with a synchronize around each stage; wall {wall:.3f} s, "
            f"the same run without timers {plain:.3f} s) [{limit}]:")
        for stage, t in sorted(totals.items(), key=lambda kv: -kv[1]):
            say(f"  {stage}: {t:.3f} s, {100 * t / wall:.1f} %")
        idle_share(lambda: run_predict(task(f"{name}_profiled")), plain)


def stage_breakdown(dev, limit: str, work: str) -> None:
    """Phase 6's task once more with a ``torch.cuda.synchronize()`` timer
    around each stage of the segmentation node, then once under
    ``torch.profiler`` for the device's busy time; then phase 7's, phase
    8's and phase 9's train step."""
    from maze_image_processing_pipeline_tpu_torch.loki import device_seg
    from maze_image_processing_pipeline_tpu_torch.ops import fill_holes

    data = os.path.join(work, "data")
    make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    unet = write_unet(os.path.join(work, "unet"), UNET, "bfloat16", seed=6)
    run_loki(loki_task(data, unet, os.path.join(work, "warm")))
    plain = run_loki(loki_task(data, unet, os.path.join(work, "plain")))

    node = device_seg.DeviceTiledSegmentation.node_class
    patches = [
        (node, "_predict", "tiles + U-Net forward + blend"),
        (node, "_crops", "crops + RegionInfo assembly"),
        (device_seg, "label", "label of the objects (K1, K2, K4)"),
        (fill_holes, "label", "label of the background in region_filled_extra (K1, K2, K4)"),
        (device_seg, "binary_closing", "closing"),
        (device_seg, "remove_small_objects", "remove_small_objects (K8)"),
        (device_seg, "regionprops_fused", "regionprops_fused (K7, K3, the props from their partials)"),
        (device_seg, "region_filled_extra", "region_filled_extra (all)"),
        (node, "_dispatch_group", "segmentation node: dispatch (upload, tiles, forward, blend, chain)"),
        (node, "_finish_group", "segmentation node: fetch (stats, crops, RegionInfo assembly)"),
    ]
    timed_wall, totals = timed_stages(patches, lambda: run_loki(loki_task(data, unet, os.path.join(work, "timed"))))
    say(f"stage breakdown of phase 6 (one run with a synchronize around each stage; wall {timed_wall:.3f} s, "
        f"the same run without timers {plain:.3f} s) [{limit}]:")
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {name}: {t:.3f} s, {100 * t / timed_wall:.1f} %")
    idle_share(lambda: run_loki(loki_task(data, unet, os.path.join(work, "profiled"))), plain)
    predict_stage_breakdown(limit, work)
    threshold_stage_breakdown(limit, work)
    train_stage_breakdown(dev, limit)


def threshold_stage_breakdown(limit: str, work: str) -> None:
    """Phase 8's threshold task with a timer around the device measurement
    of each bucket and around the host fallback, then under
    ``torch.profiler``."""
    from maze_image_processing_pipeline_tpu_torch.engine import image
    from maze_image_processing_pipeline_tpu_torch.ops import threshold_props

    data = os.path.join(work, "thr_data")
    make_loki_tree(data, n_frames=96, objects_per_frame=20, frame_shape=(1024, 1280), seed=10, big_every=10)
    run_loki(threshold_task(data, os.path.join(work, "thr_warm")))
    plain = run_loki(threshold_task(data, os.path.join(work, "thr_plain")))
    node = image.BatchedImageProperties.node_class
    patches = [
        (node, "_measure", "device measurement of a bucket (upload, K7/K3, label, filled area, fetch)"),
        (threshold_props, "regionprops_fused", "regionprops_fused (K7, K3, the props from their partials)"),
        (threshold_props, "label", "label of the background (K1, K2, K4)"),
        (node, "_host", "host fallback"),
    ]
    wall, totals = timed_stages(patches, lambda: run_loki(threshold_task(data, os.path.join(work, "thr_timed"))))
    say(f"stage breakdown of phase 8 (one run with a synchronize around each stage; wall {wall:.3f} s, "
        f"the same run without timers {plain:.3f} s) [{limit}]:")
    for stage, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {stage}: {t:.3f} s, {100 * t / wall:.1f} %")
    idle_share(lambda: run_loki(threshold_task(data, os.path.join(work, "thr_profiled"))), plain)


def phase_lab(dev, limit: str) -> dict:
    """The port's frame-chain perf lab at (8, 1024, 1024): every experiment
    (CUDA-event times printed as the JAX lab prints them), K9 launched by
    ``morph_anchor_label`` and ``chain_anchor``; then ``chain`` and
    ``chain_anchor`` must give the same labels, counts and props, and
    ``chain_plain`` (the plain versions, on a CPU copy of the frames) the
    same labels and counts and the props within phase 2's tolerance."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.tools import perf_lab

    reset_launches()
    results = perf_lab.run(device=dev)
    launches = read_launches("phase 10", expected=LAB_KERNELS, absent=("group_norm", "group_norm_bwd") + SPLIT_NORMS)
    x = torch.from_numpy(perf_lab.lab_frames()).to(dev)
    with torch.inference_mode():
        ref, anchored, plain = perf_lab.chain(x), perf_lab.chain(x, anchored=True), perf_lab.chain(x.cpu())
    torch.cuda.synchronize()
    for name, other in (("chain_anchor", anchored), ("chain_plain", plain)):
        check(torch.equal(ref[0].cpu(), other[0].cpu()) and torch.equal(ref[1].cpu(), other[1].cpu()),
              f"chain and {name} differ in labels")
    check(ref[2].keys() == anchored[2].keys() and all(torch.equal(v, anchored[2][k]) for k, v in ref[2].items()),
          "chain and chain_anchor differ in props")
    worst = compare_props(ref[2], plain[2], "the perf lab's chain")
    say(f"  chain and chain_anchor: the same labels, counts ({ref[1].tolist()} regions kept per frame) and props; "
        f"chain_plain the same labels and counts, props within tolerance (largest float difference {worst:.3g}); "
        f"chain {results['chain'] * 1e3:.3f} ms, chain_anchor {results['chain_anchor'] * 1e3:.3f} ms a batch of 8; "
        f"launches {launches} [{limit}]")
    return launches


def phase_haul(limit: str, work: str) -> dict:
    """The port's haul driver, ``--haul standard --repeat 1``: the loki
    U-Net distilled in phase 9 is reused from the model directory, the
    semseg U-Net is distilled here (K6 launches) and the classifier seeded.
    Its JSON line is printed; the loki stage must find at least 432 of the
    480 planted objects."""
    from maze_image_processing_pipeline_tpu_torch.tools import bench_e2e

    models = os.path.join(work, "haul_models")
    check(os.path.isdir(os.path.join(models, "loki-unet")), "phase 9's distilled loki U-Net is missing")
    reset_launches()
    result = bench_e2e.main(["--haul", "standard", "--repeat", "1", "--model-dir", models,
                             "--workdir", os.path.join(work, "haul")])
    launches = read_launches("phase 11", expected=INFERENCE_KERNELS + ("group_norm_bwd",),
                             absent=("anchor",) + CCL_PASSES)
    check(result["objects"] >= 432, f"the haul found {result['objects']} of 480 planted objects (at least 432)")
    say(f"  standard haul: {result['objects']} of 480 objects, {result['value']:.3f} objects/s (loki "
        f"{result['loki_s']:.3f} s, semseg with .h5 {result['semseg_s']:.3f} s, polytaxo {result['polytaxo_s']:.3f} "
        f"s; model preparation {result['model_prep_s']:.1f} s); launches {launches} [{limit}]")
    return launches


# -- phase 12: several cards ---------------------------------------------------

MESH_FRAME_BATCH = 4  # 6 frame groups of the 24 frames: every card of up to 6 takes one


def mesh_train_step(dev, cards: int) -> str:
    """``UNet(1, 8, 2)`` float32 (TF32 off), a batch of 4 of 128² per card:
    the first step's loss and gradients on a mesh of every card against the
    one-card step on the whole batch, within phase 9's card-against-CPU
    tolerance (the loss within rtol 1e-5, every gradient within 1e-3 of its
    tensor's norm plus 1e-5 of the whole gradient's); K5 and K6 launch on
    every card."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet
    from maze_image_processing_pipeline_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = next(distill_batches(1, size=128, batch=4 * cards, seed=21))
    out = {}
    for name, mesh in (("one", None), ("mesh", make_mesh())):
        module = UNet(**SMALL_UNET, dtype="float32")
        state, opt = tt.create_train_state(module, x.shape, device=dev, seed=3, mesh=mesh)
        step = tt.make_train_step(module, opt, mesh=mesh)
        reset_launches()
        state, m = step(state, x, y)
        torch.cuda.synchronize()
        if mesh is not None:
            by_card = read_launches_by_card("the mesh train step", ("group_norm", "group_norm_bwd"), cards)
        out[name] = (float(m["loss"]), {k: p.grad.cpu().double() for k, p in module.named_parameters()})
    (loss_m, grads_m), (loss_1, grads_1) = out["mesh"], out["one"]
    check(math.isfinite(loss_m) and abs(loss_m - loss_1) <= 1e-5 * abs(loss_1), f"losses {loss_m} vs {loss_1}")
    total = math.sqrt(sum(float((g ** 2).sum()) for g in grads_1.values()))
    worst = 0.0
    for k, g in grads_1.items():
        err = float((grads_m[k] - g).abs().max())
        check(err <= 1e-3 * float(g.norm()) + 1e-5 * total, f"mesh gradient of {k} differs by {err}")
        worst = max(worst, err / max(float(g.norm()), 1e-30) if float(g.norm()) > 1e-5 * total else 0.0)
    return (f"train step of UNet(1, 8, 2) float32 (TF32 off), batch {len(x)}: mesh loss {loss_m:.7f}, one card "
            f"{loss_1:.7f}, {len(grads_1)} gradients within tolerance (largest difference over its tensor's norm "
            f"{worst:.3g}); K5 / K6 launches by card {by_card.get('group_norm')} / {by_card.get('group_norm_bwd')}")


# The sharded train steps: UNet(1, 64, 1) (tests/test_models.py's sharded
# step, its 64- and 128-wide convs split over model) on {data: 1, space: 2,
# model: 2}, and phase 9's batch of UNet(1, 32, 4) over space alone; the
# polytaxo ConvClassifier(8) (its 64- to 256-wide convs and Dense_0 split
# over model) on a batch of 16 crops of 256² on both meshes.
SHARDED_STEPS = (
    ("unet", dict(out_channels=1, base_features=64, depth=1), {"data": 1, "space": 2, "model": 2}, (8, 128, 128)),
    ("unet", dict(out_channels=1, base_features=32, depth=4), {"space": 4}, TRAIN_BATCH[:3]),
    ("classifier", CLASSIFIER, {"data": 1, "space": 2, "model": 2}, (16, 256, 256)),
    ("classifier", CLASSIFIER, {"space": 4}, (16, 256, 256)),
)


def step_name(kind: str, cfg: dict) -> str:
    if kind == "unet":
        return f"UNet({cfg['out_channels']}, {cfg['base_features']}, {cfg['depth']})"
    return f"ConvClassifier({cfg['n_outputs']}, {tuple(cfg['features'])})"


def sharded_cards():
    """Four cards for the sharded steps: the machine's first four, or, on a
    machine of fewer, four replicas of card 0."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", i if n >= 4 else 0) for i in range(4)]


def peak_step(dev, kind, cfg, axes, x, y):
    """One float32 train step of ``UNet(**cfg)`` (``kind`` "unet",
    ``bce_dice_loss``) or ``ConvClassifier(**cfg)`` ("classifier",
    ``bce_loss``) on one card (``axes`` None) or sharded over ``axes`` on
    :func:`sharded_cards`: (loss, gradients on
    the CPU, the step's peak memory on each card (bytes above what the card
    held before the state was made), the bytes of the tensors the forward
    saved for the backward on each card (each storage once: what the
    activations take, whatever workspace cuDNN takes besides), launches by
    card, seconds)."""
    import gc

    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.unet import ShardedNet, UNet
    from maze_image_processing_pipeline_tpu_torch.parallel import make_mesh

    mesh = None if axes is None else make_mesh(axes, devices=sharded_cards()[: math.prod(axes.values())])
    cards = sorted({d.index for d in (mesh.devices.flat if mesh is not None else [dev])})
    torch.cuda.synchronize()
    base = {}
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
        base[i] = torch.cuda.memory_allocated(i)
    module = (UNet if kind == "unet" else ConvClassifier)(**cfg, dtype="float32")
    state, opt = tt.create_train_state(module, x.shape, device=dev, seed=3, mesh=mesh)
    check((mesh is not None) == isinstance(state.module, ShardedNet), f"the step on {axes} is not sharded")
    step = tt.make_train_step(module, opt, loss_fn=tt.bce_dice_loss if kind == "unet" else tt.bce_loss, mesh=mesh)
    saved, storages = {}, set()

    def pack(t):
        key = (t.device, t.untyped_storage().data_ptr())
        if t.is_cuda and key not in storages:
            storages.add(key)
            saved[t.device.index] = saved.get(t.device.index, 0) + t.untyped_storage().nbytes()
        return t

    reset_launches()
    t0 = time.perf_counter()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        state, m = step(state, x, y)
    loss = float(m["loss"])
    for i in cards:
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    launches = {name: dict(getattr(fn, "launches_by_device", {})) for name, fn in _counted().items()}
    peak = {i: torch.cuda.max_memory_allocated(i) - base[i] for i in cards}
    if mesh is not None:
        grads = state.module.grads()
    else:
        grads = {k: p.grad.cpu() for k, p in module.named_parameters()}
    del state, opt, step, module, m
    gc.collect()
    torch.cuda.empty_cache()
    return loss, {k: g.double() for k, g in grads.items()}, peak, saved, launches, wall


def split_norm_cases(dev, seen) -> dict:
    """Each split K5/K6 launch against its plain version at the shard
    shapes, dtypes and layouts ``seen`` in the sharded steps, on fresh
    seeded inputs: the sums and rows within K6's float32 tolerance
    (``within_f32``), y within phase 2's K5 tolerance (1e-5 float32, one
    16-bit ulp), dx within K6's; the same bits twice. At the largest shape
    the four launches are timed beside their plain versions, the one-launch
    K5 and K6 on the same shard and the bound. Returns the kernels line's
    entries."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(13)
    worst = dict.fromkeys(SPLIT_NORMS, 0.0)
    cases = sorted(seen, key=lambda c: (math.prod(c[0]), c[0], c[2]))
    mantissa = {torch.bfloat16: 7, torch.float16: 10}
    out = {}
    for shape, dtype, layout in cases:
        C = shape[1]
        G = min(8, C)
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype).contiguous(memory_format=fmt)
        ct = torch.randn(shape, device=dev, generator=gen).to(dtype).contiguous(memory_format=fmt)
        w = torch.rand(C, device=dev, generator=gen) + 0.5
        b = torch.randn(C, device=dev, generator=gen)
        stats = layers.group_stats_plain(x, G)
        rows = layers.group_norm_bwd_partials_plain(x, ct, stats, G)
        n = math.prod(shape[1:]) // G
        s2 = (w * rows[0].view(shape[0], C)).view(shape[0], G, C // G).sum(-1).reshape(-1)
        s1 = (w * rows[1].view(shape[0], C)).view(shape[0], G, C // G).sum(-1).reshape(-1)
        coef = torch.stack([(-stats[1] * stats[1]) * s2 / n, (-stats[1]) * s1 / n])
        calls = {
            "group_norm_partials": (lambda: layers.group_norm_partials(x, G),
                                    lambda: layers.group_partials_plain(x, G)),
            "group_norm_apply": (lambda: layers.group_norm_apply(x, w, b, stats, G),
                                 lambda: layers.group_norm_apply_plain(x, w, b, stats, G)),
            "group_norm_bwd_partials": (lambda: layers.group_norm_bwd_partials(x, ct, stats, G),
                                        lambda: layers.group_norm_bwd_partials_plain(x, ct, stats, G)),
            "group_norm_bwd_apply": (lambda: layers.group_norm_bwd_apply(x, ct, w, stats, coef, G),
                                     lambda: layers.group_norm_bwd_apply_plain(x, ct, w, stats, coef, G)),
        }
        where = f"{shape} {str(dtype)[6:]} {layout}"
        for name, (kernel, plain) in calls.items():
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} not deterministic at {where}")
            err = float((got.float() - ref.float()).abs().max())
            worst[name] = max(worst[name], err)
            if name.endswith("partials") or (dtype == torch.float32 and name == "group_norm_bwd_apply"):
                ok = within_f32(got, ref)
            elif dtype == torch.float32:
                ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
            else:
                ok = bool(((got.float() - ref.float()).abs() <= half_ulp(ref.float(), mantissa[dtype])).all())
            check(ok, f"{name} differs from its plain version at {where} by {err:.3g}")
            if not name.endswith("partials"):
                check(got.stride() == x.stride(), f"{name} changed the layout at {where}")
        say(f"  {where}: the four split launches within tolerance of their plain versions, the same bits twice")
        if (shape, dtype, layout) == cases[-1]:
            nbytes = x.numel() * x.element_size()
            bound = {"group_norm_partials": bytes_ms(nbytes + 8 * shape[0] * G),
                     "group_norm_apply": bytes_ms(2 * nbytes),
                     "group_norm_bwd_partials": bytes_ms(2 * nbytes + 8 * shape[0] * C),
                     "group_norm_bwd_apply": bytes_ms(3 * nbytes)}
            for name, (kernel, plain) in calls.items():
                out[name] = dict(ms=cuda_ms(kernel, iters=10), queued_ms=queued_ms(kernel, iters=20),
                                 plain_ms=cuda_ms(plain, iters=3), library_ms=None, bound_ms=bound[name],
                                 bound_by="bytes", shape=list(shape), dtype=str(dtype)[6:], layout=layout)
            whole = {"K5": queued_ms(lambda: layers.group_norm(x, w, b, G), iters=20),
                     "K6": queued_ms(lambda: layers.group_norm_bwd(x, ct, w, stats, G), iters=20)}
            say(f"  split launches at {where}: " + "; ".join(
                f"{k} {v['ms']:.4f} ms (queue full {v['queued_ms']:.4f}), plain {v['plain_ms']:.4f} ms, bound "
                f"{v['bound_ms']:.4f} ms" for k, v in out.items())
                + f"; the one-launch K5 / K6 on the same shard, queue full: {whole['K5']:.4f} / {whole['K6']:.4f} ms")
        del x, ct
    for name in SPLIT_NORMS:
        out[name]["max_abs_err"] = worst[name]
    return out


def sharded_train_steps(dev, limit: str) -> tuple:
    """The sharded train steps of ``SHARDED_STEPS`` on :func:`sharded_cards`
    (four cards, or four replicas of card 0), each against the same step on
    one card: float32 (TF32 off) on distillation batches, the loss within
    rtol 1e-5 and every gradient within 1e-3 of its tensor's norm plus 1e-5
    of the whole gradient's (:func:`mesh_train_step`'s tolerance); K5 and
    K6's split launches on every card of the mesh and each held to its
    plain version at the shapes it took (:func:`split_norm_cases`); each
    step's peak memory and saved-for-backward bytes on each card beside the
    one-card step's. Returns
    (the launches of the sharded steps, the kernels line's entries of the
    split launches)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import unet as unet_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seen = set()
    real = unet_mod.sharded_group_norm

    def spy(xs, ws, bs, offsets, C, G, eps=1e-6):
        for t in xs:
            seen.add((tuple(t.shape), t.dtype, "NCHW" if t.is_contiguous() else "channels_last"))
        return real(xs, ws, bs, offsets, C, G, eps)

    total = {}
    gib = 2.0**30
    cards = sorted({d.index for d in sharded_cards()})
    unet_mod.sharded_group_norm = spy
    try:
        for kind, cfg, axes, (B, H, W) in SHARDED_STEPS:
            x, y = next(distill_batches(1, size=H, batch=B, seed=23))
            if kind == "classifier":  # multi-label targets for the taxonomy nodes
                y = (np.random.default_rng(24).random((B, cfg["n_outputs"])) > 0.5).astype(np.float32)
            loss_1, grads_1, peak_1, saved_1, _, wall_1 = peak_step(dev, kind, cfg, None, x, y)
            loss_s, grads_s, peak_s, saved_s, launches, wall_s = peak_step(dev, kind, cfg, axes, x, y)
            check(math.isfinite(loss_s) and abs(loss_s - loss_1) <= 1e-5 * abs(loss_1),
                  f"sharded loss {loss_s} vs one card {loss_1} on {axes}")
            norm = math.sqrt(sum(float((g ** 2).sum()) for g in grads_1.values()))
            worst, worst_k = 0.0, None
            for k, g in grads_1.items():
                err = float((grads_s[k] - g).abs().max())
                check(err <= 1e-3 * float(g.norm()) + 1e-5 * norm, f"sharded gradient of {k} differs by {err}")
                rel = err / max(float(g.norm()), 1e-30) if float(g.norm()) > 1e-5 * norm else 0.0
                if rel > worst:
                    worst, worst_k = rel, k
            for name in SPLIT_NORMS:
                for i in cards:
                    check(launches[name].get(i, 0) > 0, f"{name} did not launch on card {i} in the step on {axes}")
            for name, by_card in launches.items():
                total[name] = total.get(name, 0) + sum(by_card.values())
            say(f"  sharded step {step_name(kind, cfg)} float32 (TF32 "
                f"off), batch {B} of {H}x{W}, on {axes} over cards {[d.index for d in sharded_cards()]}: loss "
                f"{loss_s:.7f}, one card {loss_1:.7f}; {len(grads_1)} gradients within tolerance (largest "
                f"difference over its tensor's norm {worst:.3g}, {worst_k}); {wall_s:.3f} s, one card {wall_1:.3f} s (first "
                f"steps); peak memory by card { {i: round(v / gib, 4) for i, v in peak_s.items()} } GiB, one card "
                f"{peak_1[dev.index] / gib:.4f} GiB; saved for the backward by card "
                f"{ {i: round(v / gib, 4) for i, v in sorted(saved_s.items())} } GiB, one card "
                f"{saved_1.get(dev.index, 0) / gib:.4f} GiB; split launches by card "
                f"{ {k: launches[k] for k in SPLIT_NORMS} }, K5 / K6 {launches['group_norm']} / "
                f"{launches['group_norm_bwd']} [{limit}]")
    finally:
        unet_mod.sharded_group_norm = real
    return total, split_norm_cases(dev, seen)


def polytaxo_model_axis(inp: dict, work: str, limit: str) -> str:
    """Phase 7's polytaxo task with ``parallel: {mesh: {model: 2}}`` (the
    classifier sharded over two cards, ``models.classifier.
    ShardedClassifier``, on the first two cards or, on a machine of one,
    two replicas of it)
    against the same task on one card: the same archive. Both in float32
    (TF32 off): the split convs' slices are other cuDNN problems than the
    whole conv, and in bfloat16 their roundings could move a score."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = "crops.polytaxo.zip"

    def task(name):
        return polytaxo_task(inp["archive"], inp["clf"], os.path.join(work, name), inp["taxonomy"], dtype="float32")

    wall_1 = run_predict(task("model_axis_one"))
    # The Runner's mesh covers every card of the machine; this one takes the
    # first two (or two replicas of card 0 on a machine of one).
    real = mesh_mod.make_mesh
    mesh_mod.make_mesh = lambda axes=None, devices=None: real(axes, devices or sharded_cards()[:2])
    reset_launches()
    try:
        wall_m = run_predict({**task("model_axis_mesh"), "parallel": {"mesh": {"model": 2}}})
    finally:
        mesh_mod.make_mesh = real
    cards = min(2, torch.cuda.device_count())
    by_card = read_launches_by_card("phase 12 (polytaxo on model: 2)", ("group_norm",), cards)
    launches = read_launches("phase 12 (polytaxo on model: 2)", expected=("group_norm",),
                             absent=tuple(k for k in KERNELS if k != "group_norm"))
    n = compare_archives(os.path.join(work, "model_axis_one", fn), os.path.join(work, "model_axis_mesh", fn))
    return (f"predict polytaxo, ConvClassifier(8) float32 (TF32 off), parallel: {{mesh: {{model: 2}}}} over cards "
            f"{[d.index for d in sharded_cards()[:2]]}: the archive of the one-card run ({n} objects); wall "
            f"{wall_m:.3f} s on the mesh, {wall_1:.3f} s on one card; K5 launches {launches['group_norm']}, by card "
            f"{by_card.get('group_norm')} [{limit}]")


def phase_mesh(dev, limit: str, work: str) -> dict:
    """Every path of this script that takes ``parallel:``, on a mesh of
    every card the machine has (``make_mesh()``), against the same task on
    one card: the loki Runner at the standard haul's shapes (frame groups of
    4, round-robin over the cards) and predict semseg + polytaxo on phase
    7's crops (batches split over the cards) give the same archives; the
    mesh train step the one-card step's loss and gradients; the sharded
    train steps (:func:`sharded_train_steps`) the one-card steps'; the port's
    ``dryrun_multichip`` runs on the card count. Every kernel of each path
    launches on every card. Returns the launches of the loki run and of the
    sharded steps, and the split launches' entries of the kernels line."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.parallel.dryrun import dryrun_multichip

    cards = torch.cuda.device_count()
    say(f"  {cards} card(s): {[torch.cuda.get_device_name(i) for i in range(cards)]}")
    data, unet = os.path.join(work, "data"), os.path.join(work, "unet")
    if not os.path.isdir(data):
        make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
        unet = write_unet(unet, UNET, "bfloat16", seed=6)
    archive = "LOKI_PS122-1_7.zip"
    one = os.path.join(work, "mesh_loki_one")
    wall_1 = run_loki(loki_task(data, unet, one, frame_batch=MESH_FRAME_BATCH))
    reset_launches()
    wall_m = run_loki({**loki_task(data, unet, os.path.join(work, "mesh_loki"), frame_batch=MESH_FRAME_BATCH),
                       "parallel": True})
    launches = read_launches("phase 12 (loki on the mesh)")
    by_card = read_launches_by_card("phase 12 (loki on the mesh)", INFERENCE_KERNELS,
                                    min(cards, 24 // MESH_FRAME_BATCH))
    n = compare_archives(os.path.join(one, archive), os.path.join(work, "mesh_loki", archive))
    say(f"  loki, standard haul, parallel: true, frame groups of {MESH_FRAME_BATCH}: the archive of the one-card run "
        f"({n} objects); wall {wall_m:.3f} s on the mesh, {wall_1:.3f} s on one card; launches by card {by_card} "
        f"[{limit}]")

    inp = predict_inputs(work)
    for name, task in (("semseg", lambda out: semseg_task(inp["archive"], inp["unet"], out)),
                       ("polytaxo", lambda out: polytaxo_task(inp["archive"], inp["clf"], out, inp["taxonomy"]))):
        ref = os.path.join(work, f"mesh_{name}_one")
        wall_1 = run_predict(task(ref))
        reset_launches()
        wall_m = run_predict({**task(os.path.join(work, f"mesh_{name}")), "parallel": True})
        fn = "crops.segmentation.zip" if name == "semseg" else "crops.polytaxo.zip"
        expected = ("ccl_fixpoint", "cumsum_rows", "group_norm") if name == "semseg" else ("group_norm",)
        by_card = read_launches_by_card(f"phase 12 ({name} on the mesh)", expected, cards)
        n = compare_archives(os.path.join(ref, fn), os.path.join(work, f"mesh_{name}", fn))
        say(f"  predict {name}, parallel: true: the archive of the one-card run ({n} objects); wall {wall_m:.3f} s "
            f"on the mesh, {wall_1:.3f} s on one card; launches by card "
            f"{ {k: by_card.get(k) for k in expected} } [{limit}]")

    say(f"  {polytaxo_model_axis(inp, work, limit)}")
    say(f"  {mesh_train_step(dev, cards)}")
    t0 = time.perf_counter()
    sharded, measured = sharded_train_steps(dev, limit)
    say(f"  sharded train steps and their split launches: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    result = dryrun_multichip(cards, log=lambda line: say(f"  {line}"))
    say(f"  dryrun_multichip({cards}) on {result['mesh']}: {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + sharded.get(k, 0) for k in launches}, measured


# -- phase 13: the library functions on the card ----------------------------

LIBRARY_SHAPE = (8, 1024, 1280)  # loki's frames
LIBRARY_R = 64
# The kernels the library calls launch: the CCL fixpoint and K2 (label, in
# fill_holes and for regionprops' labels), K3 (regionprops' histogram).
LIBRARY_KERNELS = ("ccl_fixpoint", "cumsum_rows", "region_histogram")
LIBRARY_EXACT = {"area", "min_row", "min_col", "max_row", "max_col", "intensity_min", "intensity_max", "histogram"}


def library_inputs(shape=LIBRARY_SHAPE, seed: int = 31):
    """Loki-like masks: :func:`make_frames`' vignettes brighter than 50 (20
    a frame), with 1 % of the pixels knocked out (holes for ``fill_holes``);
    the intensity: the frames plus noise of 0-39."""
    B, H, W = shape
    frames = make_frames(B, H, W, 20, seed)
    rng = np.random.default_rng(seed + 1)
    mask = (frames > 50) & ~(rng.random(shape) < 0.01)
    inten = np.clip(frames.astype(np.int16) + rng.integers(0, 40, shape), 0, 255).astype(np.uint8)
    return mask, inten


def compare_library_props(got: dict, ref: dict) -> dict:
    """``regionprops`` on the card against the CPU, with the tolerances of
    ``tests/test_torch_library_ops.py``: the integer keys and the histogram
    exact; the float keys within rtol 1e-5 / atol 1e-4, skew and kurtosis
    within rtol 1e-4 / atol 1e-4 (NaN where the CPU has NaN), the
    orientation modulo pi within 1e-4. Every region is held, the background
    (id 0, about 1.3 M pixels a frame) too: the port sums in float64, so the
    order of the card's atomics does not show. Returns the largest absolute
    difference by float key."""
    check(set(got) == set(ref), f"regionprops keys differ: {set(got) ^ set(ref)}")
    worst = {}
    for k, r in ref.items():
        r, o = r.numpy(), got[k].cpu().numpy()
        check(o.shape == r.shape and o.dtype == r.dtype, f"regionprops {k}: {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        if k in LIBRARY_EXACT:
            np.testing.assert_array_equal(o, r, err_msg=k)
            continue
        with np.errstate(invalid="ignore"):
            d = np.abs(o - r)
        if k == "orientation":
            d = np.minimum(d % np.pi, np.pi - d % np.pi)
            check(bool((d <= 1e-4).all()), f"orientation differs by {d.max()}")
        elif k in ("intensity_skew", "intensity_kurtosis"):
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-4, err_msg=k)
        d = d[np.isfinite(d)]  # empty regions: ±inf sentinels on both sides
        worst[k] = float(d.max()) if d.size else 0.0
    return worst


def phase_library(dev, limit: str) -> dict:
    """The library functions of ``ops/`` on the card at loki's frame shape
    (``LIBRARY_SHAPE``), each against the same call on the CPU (the plain
    versions): ``fill_holes`` bit-exact (``ccl_fixpoint`` and K2 launched);
    ``regionprops`` of the filled masks' labels (``label`` on the card; the
    same labels on the CPU) at R = 64 with uint8 intensity and the
    histogram (K3 launched) within
    :func:`compare_library_props`' tolerances, ``isotropic_closing`` at
    radius 2.5 and ``edt`` at ``max_distance`` 16 exact. Each call's launches
    (counts set to 0 just before it) and its time by CUDA events. Returns
    the launches of the calls."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops.edt import edt
    from maze_image_processing_pipeline_tpu_torch.ops.label import label
    from maze_image_processing_pipeline_tpu_torch.ops.morphology import isotropic_closing
    from maze_image_processing_pipeline_tpu_torch.ops.regionprops import fill_holes, regionprops

    mask, inten = library_inputs()
    m_d, i_d = torch.from_numpy(mask).to(dev), torch.from_numpy(inten).to(dev)
    state = {}
    calls = (
        ("fill_holes", lambda: state.update(filled=fill_holes(m_d)), ("ccl_fixpoint", "cumsum_rows")),
        ("label", lambda: state.update(labels=label(state["filled"])[0]), ("ccl_fixpoint", "cumsum_rows")),
        ("regionprops", lambda: state.update(props=regionprops(state["labels"], i_d, num_segments=LIBRARY_R,
                                                               compute_histogram=True)), ("region_histogram",)),
        ("isotropic_closing", lambda: state.update(closed=isotropic_closing(m_d, 2.5)), ()),
        ("edt", lambda: state.update(dist=edt(m_d, 16)), ()),
    )
    total = dict.fromkeys(KERNELS, 0)
    parts = []
    for name, call, expected in calls:
        reset_launches()
        call()
        torch.cuda.synchronize()
        launches = read_launches(f"phase 13 ({name})", expected=expected,
                                 absent=tuple(k for k in KERNELS if k not in expected))
        for k, v in launches.items():
            total[k] += v
        ms = cuda_ms(call, iters=5)
        parts.append(f"{name} {ms:.4f} ms, launches {({k: v for k, v in launches.items() if v})}")

    m_c = torch.from_numpy(mask)
    t0 = time.perf_counter()
    filled_c = fill_holes(m_c)
    t_fill = time.perf_counter() - t0
    check(torch.equal(state["filled"].cpu(), filled_c), "fill_holes differs from the CPU run")
    props_c = regionprops(state["labels"].cpu(), torch.from_numpy(inten), num_segments=LIBRARY_R,
                          compute_histogram=True)
    worst = compare_library_props(state["props"], props_c)
    check(torch.equal(state["closed"].cpu(), isotropic_closing(m_c, 2.5)), "isotropic_closing differs from the CPU run")
    check(torch.equal(state["dist"].cpu(), edt(m_c, 16)), "edt differs from the CPU run")
    regions = int((props_c["area"][:, 1:] > 0).sum())
    filled_px = int(filled_c.sum()) - int(m_c.sum())
    say(f"  at {LIBRARY_SHAPE}: fill_holes ({filled_px} pixels filled) bit-exact; regionprops of the filled masks' "
        f"labels ({regions} regions), R = {LIBRARY_R}, with the histogram: integer keys and histogram exact, the largest float "
        f"differences {({k: float(f'{v:.3g}') for k, v in worst.items()})}; isotropic_closing(2.5) and edt(16) "
        f"exact; against the CPU (fill_holes {t_fill:.2f} s there)")
    say("  card, CUDA events (5 calls each): " + "; ".join(parts) + f" [{limit}]")
    return total


# -- phase 14: a mesh that spans two processes ----------------------------------

# Phase 12's full-width sharded steps over two processes: UNet(1, 32, 4) at
# batch 8 of 512² with its rows over {space: 4} (space crosses the
# processes), and ConvClassifier(8) at batch 16 of 256² on {model: 2,
# space: 2} (model crosses them).
PROCESS_STEPS = (
    ("unet", UNET, {"space": 4}, TRAIN_BATCH[:3]),
    ("classifier", CLASSIFIER, {"model": 2, "space": 2}, (16, 256, 256)),
)
PROCESS_TIMEOUT = 600  # seconds both processes of phase 14 may take together


def process_backend() -> str:
    """``nccl`` with a card a process (two cards each, four in all), else
    ``gloo`` with both processes on card 0 (NCCL refuses two ranks on one
    card)."""
    import torch

    return "nccl" if torch.cuda.device_count() >= 4 else "gloo"


def process_cards(rank: int, backend: str) -> list:
    """The two cards of process ``rank`` in phase 14's mesh: cards 2r and
    2r + 1 under nccl, two replicas of card 0 under gloo."""
    import torch

    return [torch.device("cuda", 2 * rank + i if backend == "nccl" else 0) for i in range(2)]


def process_inputs(kind: str, cfg: dict, shape) -> tuple:
    """The global batch of a phase 14 step: every process takes the same
    (phase 12's distillation batch; multi-label targets for the
    classifier)."""
    B, H, _ = shape
    x, y = next(distill_batches(1, size=H, batch=B, seed=23))
    if kind == "classifier":
        y = (np.random.default_rng(24).random((B, cfg["n_outputs"])) > 0.5).astype(np.float32)
    return x, y


def process_steps(devices, seed: int = 3) -> list:
    """Two float32 steps of each of ``PROCESS_STEPS`` on a mesh of
    ``devices`` (this process's; in a process group the mesh spans every
    process's), TF32 off and cuDNN deterministic: per step the loss, the
    gradients (whole, on the CPU) and the launches by card, with the wall
    of both steps."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's deterministic algorithms: two runs of one step may then differ
    # only where the port sums in another order.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _process_steps(devices, seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _process_steps(devices, seed: int) -> list:
    import torch

    from maze_image_processing_pipeline_tpu_torch.models import train as tt
    from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
    from maze_image_processing_pipeline_tpu_torch.models.unet import ShardedNet, UNet
    from maze_image_processing_pipeline_tpu_torch.parallel import make_mesh

    out = []
    for kind, cfg, axes, shape in PROCESS_STEPS:
        x, y = process_inputs(kind, cfg, shape)
        mesh = make_mesh(axes, devices=devices)
        module = (UNet if kind == "unet" else ConvClassifier)(**cfg, dtype="float32")
        state, opt = tt.create_train_state(module, x.shape, seed=seed, mesh=mesh)
        check(isinstance(state.module, ShardedNet), f"the step on {axes} is not sharded")
        step = tt.make_train_step(module, opt, loss_fn=tt.bce_dice_loss if kind == "unet" else tt.bce_loss, mesh=mesh)
        losses, grads = [], []
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))
            grads.append({k: g.double() for k, g in state.module.grads().items()})
        for d in mesh.local_devices():
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        launches = {name: {str(k): v for k, v in getattr(fn, "launches_by_device", {}).items()}
                    for name, fn in _counted().items() if fn.launches}
        out.append(dict(losses=losses, grads=grads, launches=launches, wall=wall,
                        processes=mesh.processes.tolist()))
        del state, opt, step, module
    return out


def process_worker(argv) -> int:
    """One process of phase 14 (``chip_smoke.py --process <rank> <address>
    <backend> <out>``): joins the group, runs :func:`process_steps` on its
    cards, writes its results to ``<out><rank>.pt`` and prints a JSON
    line."""
    import torch

    rank, address, backend, out = int(argv[0]), argv[1], argv[2], argv[3]
    from maze_image_processing_pipeline_tpu_torch import _build
    from maze_image_processing_pipeline_tpu_torch.parallel import initialize_distributed

    _build.kernels()  # the libraries the parent built
    cards = process_cards(rank, backend)
    torch.cuda.set_device(cards[0])
    initialize_distributed(address, 2, rank, device="cuda" if backend == "nccl" else "cpu")
    t0 = time.perf_counter()
    results = process_steps(cards)
    torch.save(results, f"{out}{rank}.pt")
    say(json.dumps({"rank": rank, "wall": time.perf_counter() - t0,
                    "steps": [{k: v for k, v in r.items() if k != "grads"} for r in results]}))
    torch.distributed.destroy_process_group()
    return 0


def phase_processes(dev, limit: str, work: str) -> dict:
    """``PROCESS_STEPS`` over two processes joined by
    ``initialize_distributed`` on a local port (``gloo`` with both on card
    0, each process's two mesh cards replicas of it; ``nccl`` with two
    cards each on a machine of four), two steps each, against the same
    steps in this process on :func:`sharded_cards` (the same mesh shape):
    the losses within rtol 1e-5, every gradient within phase 12's bound
    (1e-3 of its tensor's norm plus 1e-5 of the whole gradient's); K5's
    and K6's split launches in both processes. Either process failing,
    missing the reference or outlasting ``PROCESS_TIMEOUT`` fails the
    phase (both are killed). Returns the launches of both processes."""
    import gc

    import torch

    backend = process_backend()
    t0 = time.perf_counter()
    refs = process_steps(sharded_cards())
    ref_wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    out = os.path.join(work, "process")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--process", str(r), address, backend, out],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    deadline = time.monotonic() + PROCESS_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 14: a process outlasted {PROCESS_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"phase 14: process {r} failed ({p.returncode}):\n{stderr[-6000:]}")
    lines = [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in logs]
    got = [torch.load(f"{out}{r}.pt", weights_only=False) for r in (0, 1)]
    total = {k: 0 for k in KERNELS}
    for (kind, cfg, axes, (B, H, W)), ref, mine, theirs in zip(PROCESS_STEPS, refs, got[0], got[1]):
        where = f"{step_name(kind, cfg)} on {axes} over two processes"
        check(mine["losses"] == theirs["losses"], f"{where}: the processes' losses differ")
        worst, equal = [0.0, 0.0], [True, True]
        for i in range(2):
            a, b = mine["losses"][i], ref["losses"][i]
            check(math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b), f"{where}: step {i + 1} loss {a} vs {b}")
            norm = math.sqrt(sum(float((g ** 2).sum()) for g in ref["grads"][i].values()))
            for k, g in ref["grads"][i].items():
                err = float((mine["grads"][i][k] - g).abs().max())
                check(err <= 1e-3 * float(g.norm()) + 1e-5 * norm, f"{where}: step {i + 1} gradient of {k} by {err}")
                equal[i] &= err == 0.0
                if float(g.norm()) > 1e-5 * norm:
                    worst[i] = max(worst[i], err / float(g.norm()))
        per_process = []
        for r, res in enumerate((mine, theirs)):
            counts = {name: sum(res["launches"].get(name, {}).values()) for name in SPLIT_NORMS}
            for name in SPLIT_NORMS:
                check(counts[name] > 0, f"{where}: {name} did not launch in process {r}")
            per_process.append(counts)
            for name, by_card in res["launches"].items():
                total[name] += sum(by_card.values())
        say(f"  {where} ({backend}; float32, TF32 off, batch {B} of {H}x{W}; ranks of the mesh's cards "
            f"{mine['processes']}): losses {mine['losses']}, one process {ref['losses']}; every gradient within "
            f"tolerance (largest difference over its tensor's norm by step {[float(f'{w:.3g}') for w in worst]}, "
            f"every gradient equal to the last bit by step {equal}); split launches by process "
            f"{per_process}; two steps {mine['wall']:.3f} / {theirs['wall']:.3f} s, one process {ref['wall']:.3f} s "
            f"[{limit}]")
    say(f"  two processes ({backend}): {wall:.1f} s from start to exit (process walls "
        f"{[round(line['wall'], 3) for line in lines]} s), the one-process steps {ref_wall:.1f} s [{limit}]")
    return total


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--process"]:  # a process of phase 14
        return process_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from maze_image_processing_pipeline_tpu_torch import _build

    dev = torch.device("cuda", 0)
    limit = gpu_name_and_limit()
    say(f"phase 0 card: {limit}; torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    _build.kernels()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({', '.join(os.path.basename(p) for p in libs)})")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if "--stages" in sys.argv[1:]:
            stage_breakdown(dev, limit, work)
            sys.stdout.flush()
            os._exit(0)  # a process that ran torch.profiler may not exit by itself
        if "--mesh" in sys.argv[1:]:
            say("phase 12 several cards:")
            phase_mesh(dev, limit, work)
            say("phase 14 a mesh over two processes:")
            phase_processes(dev, limit, work)
        if "--library" in sys.argv[1:]:
            say("phase 13 library functions on the card:")
            phase_library(dev, limit)
        if {"--library", "--mesh"} & set(sys.argv[1:]):
            say(gpu_name_and_limit())
            say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                   "count": torch.cuda.device_count()}}))
            return 0

        say("phase 2 kernels against their plain versions:")
        measured = phase_kernels(dev)
        measured.update(phase_region_kernels(dev))
        measured.update(phase_group_norm(dev))
        measured.update(phase_group_norm_bwd(dev))
        phase_norm_ops()
        measured.update(phase_anchor(dev))

        t0 = time.perf_counter()
        msg = phase_frame_chain(dev)
        say(f"phase 3 frame chain card vs CPU: {msg} ({time.perf_counter() - t0:.1f} s)")

        say(f"phase 4 U-Net and classifier float32 card vs CPU: {phase_unet(dev)}")

        say("phase 5 slice end to end:")
        launches = {5: phase_slice(dev, limit)}

        say("phase 6 maze-ipp loki through the port's Runner:")
        t0 = time.perf_counter()
        launches[6] = phase_loki(limit, work)
        say(f"  phase 6 took {time.perf_counter() - t0:.1f} s")

        say("phase 7 maze-ipp predict through the port's Runner:")
        t0 = time.perf_counter()
        launches[7] = phase_predict(limit, work)
        say(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

        say("phase 8 maze-ipp loki with threshold segmentation through the port's Runner:")
        t0 = time.perf_counter()
        launches[8] = phase_threshold(limit, work)
        say(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

        say("phase 9 training on the card:")
        t0 = time.perf_counter()
        launches[9] = phase_train(dev, limit, work)
        say(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

        say("phase 10 the frame-chain perf lab:")
        t0 = time.perf_counter()
        launches[10] = phase_lab(dev, limit)
        say(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

        say("phase 11 the haul driver (loki U-Net, semseg with .h5, polytaxo):")
        t0 = time.perf_counter()
        launches[11] = phase_haul(limit, work)
        say(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

        say("phase 12 several cards:")
        t0 = time.perf_counter()
        launches[12], split = phase_mesh(dev, limit, work)
        measured.update(split)
        say(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

        say("phase 13 library functions on the card:")
        t0 = time.perf_counter()
        launches[13] = phase_library(dev, limit)
        say(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

        say("phase 14 a mesh over two processes:")
        t0 = time.perf_counter()
        launches[14] = phase_processes(dev, limit, work)
        say(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not any(m == "jax" or m.startswith(("jax.", "maze_image_processing_pipeline_tpu."))
                  or m == "maze_image_processing_pipeline_tpu" for m in sys.modules),
          "jax or the JAX package was imported")

    # launches: the main paths' runs of this script (phases 5 to 14) in all.
    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": sum(launches[p][k] for p in launches),
         "launches_by_phase": {str(p): launches[p][k] for p in launches}, **measured[k]}
        for k in KERNELS
    ]
    say(json.dumps({"kernels": kernels}))
    say(gpu_name_and_limit())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
