"""A/B walls of checkouts: the ``maze-ipp loki`` Runner's wall for two or
more checkouts of this repo, in turns, on one set of inputs::

    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] [--workdir DIR]

The task is ``chip_smoke.py``'s phase 6: the standard haul's loki task
(24 frames of 1024×1280, 20 vignettes a frame, a ``UNet(1, 32, 4)`` bf16 of
seeded random weights, masks stored). The inputs are made once, here, by
:mod:`.synth`; each TREE then runs in a process of its own that imports
that checkout's package (its kernels built at the first call into its own
``build/``), runs the task once to warm up and ``WALLS`` times more.
Name the trees in the order they should run, for example parent, change,
change, parent. One line is printed per run, then a JSON object of the
walls by tree. Times are taken on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from .bench_e2e import LOKI_SEGMENTATION, LOKI_UNET
from .synth import make_loki_tree, write_unet

WALLS = 3  # timed runs a process, after one warm-up

# Runs in the checkout's process: argv = data, model, output root, walls, segmentation.
_WORKER = """
import json, sys, time, torch
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner
data, unet, out, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
seg = json.loads(sys.argv[5])

def wall(tag):
    t0 = time.perf_counter()
    Runner._configure_and_run({"input": {"path": data}, "segmentation": {"jax": {"model_fn": unet, **seg}},
                               "postprocess": {}, "output": {"target_dir": f"{out}/{tag}", "store_mask": True}})
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0

wall("warm")
print("WALLS " + json.dumps([wall(i) for i in range(n)]), flush=True)
"""


def run_tree(tree: str, data: str, unet: str, out: str) -> List[float]:
    """The walls of one run of ``tree``'s package, in its own process."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", _WORKER, data, unet, out, str(WALLS), json.dumps(LOKI_SEGMENTATION)],
                          cwd=tree, env=env, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("WALLS "):
            return json.loads(line[len("WALLS "):])
    raise RuntimeError(f"{tree}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def main(argv: Optional[List[str]] = None) -> Dict[str, List[List[float]]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo, in the order they run")
    ap.add_argument("--workdir", default=None, help="inputs and outputs (default: a new temporary directory)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the walls are taken on the card")
    work = args.workdir or tempfile.mkdtemp(prefix="ab_walls_")
    data = make_loki_tree(os.path.join(work, "data"), n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280),
                          seed=8)
    unet = write_unet(os.path.join(work, "unet"), LOKI_UNET, "bfloat16", seed=6)
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    results: Dict[str, List[List[float]]] = {}
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        walls = run_tree(tree, data, unet, os.path.join(work, f"out{i}"))
        results.setdefault(tree, []).append(walls)
        print(f"run {i} {tree}: loki walls {walls}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
