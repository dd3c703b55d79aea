"""Exception hierarchy of the PyTorch port.

The same names and meanings as ``libpointmatcher_tpu.errors``:
``ConvergenceError`` when ICP cannot proceed (empty cloud after filtering,
no inliers, NaN differential, out-of-bound transform); the configuration
errors when a module name or parameter is wrong; ``InvalidElement`` when
a registrar is asked for a class it does not hold; ``TransformationError``
when a transformation matrix fails its validity check."""

from __future__ import annotations


class PointMatcherError(RuntimeError):
    """Base class for all framework errors."""


class ConvergenceError(PointMatcherError):
    """ICP could not converge / cannot proceed."""


class TransformationError(PointMatcherError):
    """A transformation matrix fails its validity check (a rotation block
    that is not orthogonal)."""


class InvalidField(PointMatcherError):
    """A required descriptor field is missing or malformed."""


class InvalidParameter(PointMatcherError):
    """Bad module parameter: unknown name, out of bounds, or unused."""


class InvalidModuleType(PointMatcherError):
    """Unknown module name requested from a registrar, or unknown section."""


class ConfigurationError(PointMatcherError):
    """Malformed pipeline configuration."""


class InvalidElement(PointMatcherError):
    """Registrar element not found (reference: Registrar.h:82-88)."""
