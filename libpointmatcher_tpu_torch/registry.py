"""Parametrization and module registry.

Same contract as ``libpointmatcher_tpu.registry`` (reference:
Parametrizable.h:98-175, Registrar.h:76-230): each module is a named class
with documented parameters; values arrive as strings from YAML and are cast
on read, with "inf"/"nan" accepted; an unknown parameter, a value outside
its bounds, or any parameter given to a parameterless module raises.
Registry names and parameter defaults are shared with the JAX package, so a
module configured by a ``{name: value}`` dict means the same on both sides.
Registries are introspectable (``names``, ``items``, ``dump``), and each
module's ``description()`` and ``available_parameters()`` are the JAX
package's text, which the ``list_modules`` application prints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Type

from .errors import InvalidElement, InvalidModuleType, InvalidParameter

__all__ = ["Param", "Parametrizable", "Registrar", "parse_scalar"]


def parse_scalar(value: Any, typ: type):
    """Lexical cast with inf/nan handling (reference: Parametrizable.h:53-64)."""
    if isinstance(value, bool) and typ in (int, float):
        return typ(value)
    if typ is bool:
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("1", "true", "yes"):
                return True
            if v in ("0", "false", "no"):
                return False
            raise InvalidParameter(f"cannot parse '{value}' as bool")
        return bool(value)
    if typ in (int, float):
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("inf", "+inf", "infinity"):
                return typ(math.inf) if typ is float else (2**31 - 1)
            if v == "-inf":
                return typ(-math.inf) if typ is float else -(2**31)
            if v == "nan":
                return float("nan")
        try:
            f = float(value)
        except (TypeError, ValueError):
            raise InvalidParameter(
                f"cannot parse '{value}' as {typ.__name__}") from None
        return typ(f) if typ is not int else int(f)
    if typ is str:
        return str(value)
    raise InvalidParameter(f"unsupported parameter type {typ}")


@dataclass(frozen=True)
class Param:
    """One documented module parameter (reference: Parametrizable.h:117-141)."""

    name: str
    doc: str
    type: type = float
    default: Any = None
    min: Optional[float] = None
    max: Optional[float] = None

    def parse(self, raw: Any):
        v = parse_scalar(raw, self.type)
        if self.type in (int, float) and not (
                isinstance(v, float) and math.isnan(v)):
            if self.min is not None and v < self.min:
                raise InvalidParameter(
                    f"parameter {self.name}={v} below minimum {self.min}")
            if self.max is not None and v > self.max:
                raise InvalidParameter(
                    f"parameter {self.name}={v} above maximum {self.max}")
        return v


class Parametrizable:
    """Base for all named, parameterized modules: ``PARAMS`` lists the
    parameters; construction parses and validates the given map and rejects
    unknown names (reference: Registrar.h:103-134). ``description()`` is
    ``DESCRIPTION`` where a module sets it (its JAX counterpart's text, where
    that text describes the TPU design and the port's docstring says what
    the port does instead), else the docstring, which is then the JAX
    counterpart's text."""

    PARAMS: tuple = ()
    DESCRIPTION: str = ""

    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        params = dict(params or {})
        self.parameters: Dict[str, Any] = {}
        by_name = {p.name: p for p in self.PARAMS}
        for key in params:
            if key not in by_name:
                raise InvalidParameter(
                    f"{type(self).__name__}: unknown parameter '{key}'; "
                    f"available: {sorted(by_name)}")
        for p in self.PARAMS:
            if p.name in params:
                self.parameters[p.name] = p.parse(params[p.name])
            elif p.default is not None or p.type is str:
                self.parameters[p.name] = p.parse(p.default)
            else:
                raise InvalidParameter(
                    f"{type(self).__name__}: missing required parameter "
                    f"'{p.name}'")
        for p in self.PARAMS:
            setattr(self, p.name, self.parameters[p.name])

    @classmethod
    def name(cls) -> str:
        return cls.__name__

    @classmethod
    def available_parameters(cls) -> List[Param]:
        return list(cls.PARAMS)

    @classmethod
    def description(cls) -> str:
        return cls.DESCRIPTION or (cls.__doc__ or "").strip()

    def __repr__(self):
        ps = ", ".join(f"{k}={v}" for k, v in self.parameters.items())
        return f"{type(self).__name__}({ps})"


class Registrar:
    """Name → module-class factory map (reference: Registrar.h:76-218)."""

    def __init__(self, interface_name: str):
        self.interface_name = interface_name
        self._classes: Dict[str, Type[Parametrizable]] = {}

    def register(self, cls: Optional[Type[Parametrizable]] = None, *,
                 name: Optional[str] = None):
        """Register ``cls`` under ``name`` (its class name by default); with
        no class, a decorator that does so."""
        def do(c):
            self._classes[name or c.__name__] = c
            return c

        return do(cls) if cls is not None else do

    def create(self, name: str,
               params: Optional[Mapping[str, Any]] = None) -> Parametrizable:
        cls = self._classes.get(name)
        if cls is None:
            raise InvalidModuleType(
                f"no {self.interface_name} named '{name}'; "
                f"registered: {sorted(self._classes)}")
        if params and not cls.PARAMS:
            raise InvalidParameter(
                f"{name} takes no parameters but got {sorted(params)}")
        return cls(params)

    def get_class(self, name: str) -> Type[Parametrizable]:
        try:
            return self._classes[name]
        except KeyError:
            raise InvalidElement(
                f"no {self.interface_name} named '{name}'") from None

    def has(self, name: str) -> bool:
        return name in self._classes

    def names(self) -> List[str]:
        return sorted(self._classes)

    def dump(self) -> str:
        return "\n".join(self.names())

    def items(self):
        return sorted(self._classes.items())
