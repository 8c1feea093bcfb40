"""Several cards: the ``parallel:`` section, the mesh and multi-host runs.

Counterpart of ``maze_image_processing_pipeline_tpu/parallel/__init__.py``,
with the same exports. A mesh has named axes; the port gives them the JAX
package's meaning (``parallel.mesh.mesh_grid`` orders the cards as data ×
space × model, any other axis folded into ``data``):

* ``data``: samples. Each ``data`` index takes a share of every batch.
* ``space``: image rows, in training. The train step of a U-Net or of
  the ConvClassifier (``models.train.make_train_step(..., mesh=)``) cuts
  each image's rows over the ``space`` cards (``parallel.mesh.space_rows``),
  with halo rows exchanged before each conv and GroupNorm statistics summed
  over the shards (``models.layers.sharded_group_norm``: K5/K6's partials
  and apply launches). Inference splits batches over ``data`` only, as the
  JAX package's (``PartitionSpec("data")``), so there the ``space`` cards
  are data replicas.
* ``model``: wide output channels. ``parallel.mesh.shard_params`` splits
  every conv or dense weight (and its bias) of at least 64 outputs that
  divide by the axis over its cards, as the JAX package's rule; the U-Net
  (``models.unet.ShardedUNet``) and the classifier
  (``models.classifier.ShardedClassifier``) compute each slice on its card
  and gather the slices where an op needs every channel, in training and
  in inference (both nodes for the U-Net, ``TorchInference`` for the
  classifier).

Where the axes shard nothing (a ``data`` mesh, a network with no layer
wide enough, the loki device path) every card is a data replica:

* inference: a replica of the module on each card; ``TorchInference``
  splits each batch over the cards, ``DeviceTiledInference`` each bucket of
  a tile chunk (a card infers, blends and measures its share); the results
  are gathered in order;
* the loki device path (``DeviceTiledSegmentation``,
  ``DeviceFramePostprocess``): frame groups, or frames, round-robin over the
  cards, as the JAX package's;
* training: the batch split over the cards, the gradients summed onto the
  first, AdamW there, the parameters copied back to the replicas;
* multi-host: samples partitioned per host (``input.num_shards`` /
  ``shard_index``, :func:`partition_work`), with ``torch.distributed``
  initialised from the coordinator's address.

Every path gives the outputs of one device. ``space`` and ``model`` shard
over the cards of one process (one host); across hosts each host runs its
own mesh.
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
