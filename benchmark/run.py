"""Run one cell of the benchmark once and print its result line::

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout. Needs a CUDA card:
without one (or with fewer cards than the cell asks for) it exits with 2
and prints no result. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, then ``checks``: each compared number and its
limit); the last lines of standard error repeat the checks. Builds and
caches go under ``benchmark/_cache`` in the checkout, inputs and outputs
under ``$TMPDIR``, removed at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark.harness import forbidden_modules, run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                      t_start=T_START, log=log)
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"the run loaded modules it may not load: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r}){'' if c['value'] <= c['limit'] else '  FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
