"""Workload runner scaffold: logging, task-file handling, config dispatch.

Capability parity with ``maze_ipp/pipeline_runner.py``: Rich console +
timestamped file logging, chdir to the task file's directory, excepthook
capture, YAML load, and dispatch to the workload's ``_configure_and_run``.

Copy of ``maze_image_processing_pipeline_tpu/runner.py`` for the PyTorch
port, without its JAX-only parts (the ``MAZE_IPP_PLATFORM`` backend
override, the XLA compile cache and ``jax.profiler`` tracing).
"""

from __future__ import annotations

import abc
import datetime
import logging
import os
import sys

import yaml

__all__ = ["PipelineRunner"]


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

        cls._configure_and_run(config_dict)

        root_logger.info("Finished processing.")

    @staticmethod
    @abc.abstractmethod
    def _configure_and_run(config_dict): ...
