"""Pose algebra and masked order statistics (counterpart of
``libpointmatcher_tpu.utils``)."""

from . import masked, se3  # noqa: F401
