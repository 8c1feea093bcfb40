"""The readings that the limits of ``correct`` are set from, in one process::

    python -m benchmark.calibrate --workload <cell> --seconds <s> --seeds <n> ... \\
        [--control-seeds <n> ...] [--control fp8]

Runs the cell once a seed, at its own size and load with a window of
``--seconds``, and prints one JSON line a seed with every compared number;
on the control seeds also the numbers of the reference computed in the
control's precision put in the program's place (``fp8``: one below the
configurations' bfloat16). The last line sums them up: for each number the
largest that the program read (the lower reading) and the smallest that the
control read (the upper reading). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of the program and of its control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default="fp8")
    args = ap.parse_args(argv)
    from benchmark.run import ROOT, _environment

    _environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import run_cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    lower, upper = {}, {}
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        controls = (args.control,) if seed in args.control_seeds else ()
        r = run_cell(spec, args.workload, seed, args.seconds, False, controls=controls,
                     log=lambda m: print(m, file=sys.stderr, flush=True))
        line = {"seed": seed, "correct": r["correct"], "program": {k: c["value"] for k, c in r["checks"].items()},
                "limits": {k: c["limit"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
        if seed in args.seeds:
            for k, v in line["program"].items():
                lower[k] = max(lower.get(k, v), v)
        if controls:
            line["control"] = r["controls"][args.control]
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper, "control": args.control}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
