"""Serving drivers and the multi-device layout of the port (counterpart of
``libpointmatcher_tpu.parallel``)."""

from .batch import PendingRegistration, register_batch, register_batch_to_map
from .sharding import (make_mesh, replicate_cloud, shard_cloud,
                       sharded_block_nn1, sharded_knn, sharded_tile_nn1)
from .stream import queue_eligible, register_queue_to_map

__all__ = ["make_mesh", "shard_cloud", "replicate_cloud", "sharded_knn",
           "sharded_block_nn1", "sharded_tile_nn1", "register_batch",
           "register_batch_to_map", "register_queue_to_map", "queue_eligible",
           "PendingRegistration"]
