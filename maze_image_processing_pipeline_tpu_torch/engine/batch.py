"""Batch container used by :class:`~.pipelines.BatchedPipeline`.

A :class:`Batch` marks a list of per-object values that travel through the
stream as one unit so that device nodes can process them in a single
fixed-shape dispatch (reference: ``morphocut.batch``).

Copy of ``maze_image_processing_pipeline_tpu/engine/batch.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Any, Iterable, List


class Batch(List[Any]):
    """A list subclass marking batched per-object values."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Batch({list.__repr__(self)})"


def is_batch(value: Any) -> bool:
    return isinstance(value, Batch)
