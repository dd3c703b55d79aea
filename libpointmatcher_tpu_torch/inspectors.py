"""Inspector hooks the engine calls (reference: PointMatcher.h:621-650)."""

from __future__ import annotations

from .registry import Parametrizable, Registrar

__all__ = ["Inspector", "NullInspector", "InspectorRegistrar"]

InspectorRegistrar = Registrar("Inspector")


class Inspector(Parametrizable):
    """Interface: ``init`` before a registration, ``add_stat`` for each
    named statistic, ``finish`` with the iteration count."""

    def init(self) -> None:
        pass

    def add_stat(self, name: str, value) -> None:
        pass

    def finish(self, iteration_count: int) -> None:
        pass


@InspectorRegistrar.register
class NullInspector(Inspector):
    """Does nothing (reference: Inspector.cpp)."""
