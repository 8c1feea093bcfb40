"""Streaming engine of the port.

The dataflow engine (``Pipeline``, ``Node``, ``Call``, stream nodes) is pure
Python and shared with the JAX package: it is re-exported here from
``maze_image_processing_pipeline_tpu.engine``, whose modules import neither
jax nor any accelerator library. The image nodes of the slice live in
:mod:`.image`.
"""

from maze_image_processing_pipeline_tpu.engine import Call, Pipeline, Unpack  # noqa: F401
