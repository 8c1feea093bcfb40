"""Several cards: the ``parallel:`` section, the mesh and multi-host runs.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/__init__.py``,
with the same exports. The JAX package places data and weights over a mesh
of named axes (``data``, ``space``, ``model``) and lets XLA insert the halo
exchanges and gathers; the results are those of the data axis alone. The
port accepts any axis names and sizes and runs every card of the mesh as a
data replica, which gives the same outputs:

* inference: a replica of the module on each card; ``TorchInference``
  splits each batch over the cards, ``DeviceTiledInference`` each bucket of
  a tile chunk (a card infers, blends and measures its share); the results
  are gathered in order;
* the loki device path (``DeviceTiledSegmentation``,
  ``DeviceFramePostprocess``): frame groups, or frames, round-robin over the
  cards;
* training (``models.train.make_train_step(..., mesh=)``): the batch split
  over the cards, the gradients summed onto the first, AdamW there, the
  parameters copied back to the replicas;
* multi-host: samples partitioned per host (``input.num_shards`` /
  ``shard_index``, :func:`partition_work`), with ``torch.distributed``
  initialised from the coordinator's address.

Spatial and tensor sharding of one model over several cards is not ported:
nothing in the repo needs a model that one card cannot hold.
"""

from .config import ParallelConfig, setup_parallel
from .mesh import (
    make_mesh,
    shard_batch_spec,
    shard_params,
    replicate,
)
from .multihost import (
    host_count,
    host_id,
    initialize_distributed,
    partition_work,
)

__all__ = [
    "ParallelConfig",
    "setup_parallel",
    "make_mesh",
    "shard_batch_spec",
    "shard_params",
    "replicate",
    "host_count",
    "host_id",
    "initialize_distributed",
    "partition_work",
]
