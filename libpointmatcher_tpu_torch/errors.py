"""Exception hierarchy of the PyTorch port.

The same names and meanings as ``libpointmatcher_tpu.errors``:
``ConvergenceError`` when ICP cannot proceed (empty cloud after filtering,
no inliers, NaN differential, out-of-bound transform); the configuration
errors when a module name or parameter is wrong."""

from __future__ import annotations


class PointMatcherError(RuntimeError):
    """Base class for all framework errors."""


class ConvergenceError(PointMatcherError):
    """ICP could not converge / cannot proceed."""


class InvalidField(PointMatcherError):
    """A required descriptor field is missing or malformed."""


class InvalidParameter(PointMatcherError):
    """Bad module parameter: unknown name, out of bounds, or unused."""


class InvalidModuleType(PointMatcherError):
    """Unknown module name requested from a registrar, or unknown section."""


class ConfigurationError(PointMatcherError):
    """Malformed pipeline configuration."""
