"""Serving drivers of the port (counterpart of
``libpointmatcher_tpu.parallel``)."""

from .batch import PendingRegistration, register_batch_to_map

__all__ = ["register_batch_to_map", "PendingRegistration"]
