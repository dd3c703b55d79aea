"""Serving drivers of the port (counterpart of
``libpointmatcher_tpu.parallel``)."""

from .batch import PendingRegistration, register_batch, register_batch_to_map
from .stream import queue_eligible, register_queue_to_map

__all__ = ["register_batch", "register_batch_to_map", "register_queue_to_map",
           "queue_eligible", "PendingRegistration"]
