"""Loggers (counterpart of ``libpointmatcher_tpu.loggers``; reference:
PointMatcher.h:104-120, LoggerImpl.{h,cpp}).

One logger is installed for the whole process, as in the reference, with
an info and a warning channel and an optional source location. Every
host-side pipeline event goes through it and through Python's ``logging``
(logger ``libpointmatcher_tpu_torch``)."""

from __future__ import annotations

import logging
import sys
import threading
from typing import Optional

from .registry import Param, Parametrizable, Registrar

__all__ = ["Logger", "NullLogger", "FileLogger", "LoggerRegistrar",
           "set_logger", "get_logger", "log_info", "log_warning"]

LoggerRegistrar = Registrar("Logger")

_lock = threading.Lock()
_current: Optional["Logger"] = None

_py_logger = logging.getLogger("libpointmatcher_tpu_torch")


class Logger(Parametrizable):
    """Interface (reference: PointMatcher.h:104-120)."""

    def has_info_channel(self) -> bool:
        return False

    def has_warning_channel(self) -> bool:
        return False

    def info(self, msg: str, where: str = "") -> None:
        pass

    def warning(self, msg: str, where: str = "") -> None:
        pass


@LoggerRegistrar.register
class NullLogger(Logger):
    """Swallows everything (reference: LoggerImpl.h:49-53)."""


@LoggerRegistrar.register
class FileLogger(Logger):
    """Routes info to stdout/file and warnings to stderr/file
    (reference: LoggerImpl.h:55-90)."""
    # each line is written through

    PARAMS = (
        Param("infoFileName", "file for the info channel ('' = stdout)", str, ""),
        Param("warningFileName", "file for the warning channel ('' = stderr)",
              str, ""),
        Param("displayLocation", "whether to display the source location",
              bool, False),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self._info = open(self.infoFileName, "a") if self.infoFileName else sys.stdout
        self._warn = (open(self.warningFileName, "a") if self.warningFileName
                      else sys.stderr)

    def has_info_channel(self) -> bool:
        return True

    def has_warning_channel(self) -> bool:
        return True

    def _write(self, stream, line: str, where: str) -> None:
        loc = f" [{where}]" if self.displayLocation and where else ""
        print(f"{line}{loc}", file=stream, flush=True)

    def info(self, msg: str, where: str = "") -> None:
        self._write(self._info, msg, where)

    def warning(self, msg: str, where: str = "") -> None:
        self._write(self._warn, f"WARN: {msg}", where)

    def close(self) -> None:
        """Close the files this logger opened (not stdout or stderr)."""
        for stream in (self._info, self._warn):
            if stream not in (sys.stdout, sys.stderr):
                stream.close()


def set_logger(logger: Optional[Logger]) -> None:
    """Install the process's logger (reference: PointMatcher.h:120, under a
    lock); None goes back to a ``NullLogger``."""
    global _current
    with _lock:
        _current = logger


def get_logger() -> Logger:
    """The installed logger (a ``NullLogger`` until one is set)."""
    global _current
    with _lock:
        if _current is None:
            _current = NullLogger()
        return _current


def log_info(msg: str, where: str = "") -> None:
    get_logger().info(msg, where)
    _py_logger.info(msg)


def log_warning(msg: str, where: str = "") -> None:
    get_logger().warning(msg, where)
    _py_logger.warning(msg)
