"""Workload runner scaffold: logging, task-file handling, config dispatch.

Capability parity with ``maze_ipp/pipeline_runner.py``: Rich console +
timestamped file logging, chdir to the task file's directory, excepthook
capture, YAML load, and dispatch to the workload's ``_configure_and_run``.

Counterpart of ``maze_image_processing_pipeline_tpu/runner.py`` for the
PyTorch port, with its environment hooks:

* ``MAZE_IPP_PROFILE_DIR=<dir>`` traces the whole ``_configure_and_run``
  with ``torch.profiler`` (CPU activities, and CUDA ones when a card is
  present) and writes a Chrome trace, ``<task>-<time>.pt.trace.json``, into
  the directory (:func:`profile_trace`); the program's spans
  (:mod:`.tracing`) show in it as ``maze::<name>`` annotations; the JAX
  package writes a ``jax.profiler`` trace there;
* ``MAZE_IPP_TRACE_DIR=<dir>`` turns the program's spans and counters on
  (:mod:`.tracing`) and, at the end of each unit (one
  ``_configure_and_run``), writes its spans, one JSON object a line, to
  ``<task>-<time>-unit<n>.spans.jsonl`` and their summary (each span name's
  count, total and self milliseconds, and the counters) to
  ``<task>-<time>-unit<n>.summary.json`` in the directory, then drops them
  from memory (:func:`.tracing.export_units`);
* ``MAZE_IPP_PLATFORM`` picks the device of every ``device:`` field of the
  validated task (:func:`apply_platform`, which both Runners call right
  after validation): ``cpu`` runs the task on the CPU whatever its fields
  say, ``cuda`` (or ``gpu``) on the card; any other value raises. The
  entry points themselves keep the card as their default;
* ``MAZE_IPP_COMPILE_CACHE`` (the JAX package's persistent XLA compilation
  cache) has no counterpart: the port's CUDA kernels are built once into the
  ignored ``build/`` directory beside the package and loaded from there.
"""

from __future__ import annotations

import abc
import contextlib
import datetime
import logging
import os
import sys

import yaml

from . import tracing

__all__ = ["PipelineRunner", "apply_platform", "profile_trace", "PLATFORMS"]

logger = logging.getLogger(__name__)

# MAZE_IPP_PLATFORM's accepted values and the device each asks for.
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def apply_platform(config):
    """Point every device field of a validated loki or predict task at the
    device ``MAZE_IPP_PLATFORM`` names; without the variable the task is
    returned as it is. Loki: ``segmentation.pytorch.device`` (``jax:`` in the
    JAX package's task files) and ``segmentation.threshold.device`` (where it
    is not false, the per-crop host path); predict: ``model.device``, which
    ``segmentation.device`` and the measurement follow. A ``parallel:`` mesh
    is built on the task's device, so it follows too. Returns ``config``,
    changed in place."""
    value = os.environ.get("MAZE_IPP_PLATFORM")
    if not value:
        return config
    device = PLATFORMS.get(value.strip().lower())
    if device is None:
        raise ValueError(
            f"MAZE_IPP_PLATFORM={value!r}: accepted values are {', '.join(repr(k) for k in PLATFORMS)}"
        )
    logger.info("MAZE_IPP_PLATFORM=%s: running the task on %s", value, device)
    segmentation = getattr(config, "segmentation", None)
    model_seg = getattr(segmentation, "pytorch", None)
    if model_seg is not None:
        model_seg.device = device
    threshold = getattr(segmentation, "threshold", None)
    if threshold is not None and threshold.device is not False:
        threshold.device = device
    model = getattr(config, "model", None)
    if model is not None:
        model.device = device
    return config


@contextlib.contextmanager
def profile_trace(profile_dir, name: str):
    """Trace the block with ``torch.profiler`` when ``profile_dir`` is set:
    CPU activities of every thread, and CUDA ones when a card is present;
    every program span of the block is a ``maze::<name>`` annotation in it.
    The trace stops in ``finally`` and goes to
    ``<profile_dir>/<name>.pt.trace.json`` (Chrome trace format:
    chrome://tracing, Perfetto)."""
    if not profile_dir:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.pt.trace.json")
    logger.info("Capturing a torch.profiler trace to %s", path)
    # The pipeline's stages run in threads of their own: trace them all.
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=activities, experimental_config=every_thread)
    prof.start()
    try:
        with tracing.annotating():
            yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


class PipelineRunner(abc.ABC):
    @classmethod
    def run(cls, task_fn: str) -> None:
        root_logger = logging.getLogger()
        root_logger.setLevel(logging.INFO)

        try:
            from rich.highlighter import NullHighlighter
            from rich.logging import RichHandler

            stdout_handler: logging.Handler = RichHandler(highlighter=NullHighlighter())
        except ImportError:  # pragma: no cover
            stdout_handler = logging.StreamHandler()
        stdout_handler.setLevel(logging.DEBUG)
        root_logger.addHandler(stdout_handler)

        # Read before the chdir below, so a relative directory is the caller's.
        profile_dir, trace_dir = (
            os.path.abspath(d) if d else None
            for d in (os.environ.get("MAZE_IPP_PROFILE_DIR"), os.environ.get("MAZE_IPP_TRACE_DIR"))
        )

        sys.path.insert(0, os.path.realpath(os.curdir))
        os.chdir(os.path.dirname(task_fn) or ".")

        task_name = os.path.splitext(os.path.basename(task_fn))[0]
        task_mtime = datetime.datetime.fromtimestamp(os.stat(task_fn).st_mtime)

        log_fn = os.path.abspath(
            f"{task_name}-{datetime.datetime.now().isoformat(timespec='seconds')}.log"
        )
        print(f"Logging to {log_fn}.")
        file_handler = logging.FileHandler(log_fn)
        file_handler.setLevel(logging.DEBUG)
        root_logger.addHandler(file_handler)

        def log_except_hook(*exc_info):
            root_logger.error("Unhandled exception", exc_info=exc_info)  # type: ignore[arg-type]

        sys.excepthook = log_except_hook
        logging.captureWarnings(True)

        root_logger.info(
            "Loading pipeline config from %s (last modified %s)",
            task_fn,
            task_mtime.isoformat(timespec="seconds"),
        )

        log_levels = {
            name: logging.getLevelName(logging.getLogger(name).getEffectiveLevel())
            for name in sorted(root_logger.manager.loggerDict)
        }
        root_logger.info("Log levels: %s", log_levels)

        with open(task_fn) as f:
            config_dict = yaml.safe_load(f)

        stamp = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
        name = f"{task_name}-{stamp}"
        with tracing.export_units(trace_dir, name), profile_trace(profile_dir, name):
            cls._configure_and_run(config_dict)

        root_logger.info("Finished processing.")

    @staticmethod
    @abc.abstractmethod
    def _configure_and_run(config_dict): ...
