"""Host-side pipeline events, routed to Python's ``logging``
(reference: PointMatcher.h:104-120: an info and a warning channel)."""

from __future__ import annotations

import logging

__all__ = ["log_info", "log_warning"]

_py_logger = logging.getLogger("libpointmatcher_tpu_torch")


def log_info(msg: str) -> None:
    _py_logger.info(msg)


def log_warning(msg: str) -> None:
    _py_logger.warning(msg)
