"""Streaming dataflow engine of the port.

``Pipeline``, ``Node``, ``Call`` and the stream nodes are the port's own
copies of the JAX package's pure-Python engine (``core``, ``stream``,
``pipelines``, ``batch``, ``tiles``, ``stitch``; each names its original),
so the port imports nothing of the JAX package. The image nodes of the
LOKI workload live in :mod:`.image`.
"""

from .core import (
    Call,
    Node,
    Output,
    Pipeline,
    RawOrVariable,
    ReturnOutputs,
    Stream,
    StreamObject,
    Variable,
    closing_if_closable,
)
from .stream import (
    Filter,
    Progress,
    Slice,
    StreamBuffer,
    StreamEstimator,
    Unpack,
    stream_groupby,
)
from .pipelines import (
    AggregateErrorsPipeline,
    BatchedPipeline,
    DataParallelPipeline,
    MergeNodesPipeline,
)
from .batch import Batch
from .tiles import TiledPipeline
from .stitch import Stitch, StitchedImage

__all__ = [
    "Pipeline",
    "Node",
    "Variable",
    "StreamObject",
    "Stream",
    "Call",
    "Output",
    "ReturnOutputs",
    "RawOrVariable",
    "closing_if_closable",
    "Filter",
    "Slice",
    "StreamBuffer",
    "Unpack",
    "Progress",
    "stream_groupby",
    "StreamEstimator",
    "BatchedPipeline",
    "DataParallelPipeline",
    "MergeNodesPipeline",
    "AggregateErrorsPipeline",
    "Batch",
    "TiledPipeline",
    "Stitch",
    "StitchedImage",
]
