"""Inspectors: the engine's observation hooks (counterpart of
``libpointmatcher_tpu.inspectors``; reference: PointMatcher.h:621-650,
InspectorsImpl.cpp):

- ``NullInspector`` does nothing, and asks for no statistic, so the engine
  pays no host read for one;
- ``PerformanceInspector`` keeps a histogram per named statistic of the
  engine (InspectorsImpl.cpp:52-110);
- ``VTKFileInspector`` also writes the reading, the reference and the
  match links of every iteration as VTK POLYDATA files
  (InspectorsImpl.cpp:138-366).

An inspector that dumps iterations (``needs_iteration_data``) makes the
engine take its stepped driver, which hands it host copies each
iteration."""

from __future__ import annotations

import sys
from typing import Dict

from .registry import Param, Parametrizable, Registrar
from .utils.histogram import Histogram

__all__ = ["Inspector", "NullInspector", "PerformanceInspector",
           "VTKFileInspector", "InspectorRegistrar"]

InspectorRegistrar = Registrar("Inspector")


class Inspector(Parametrizable):
    """Interface: ``init`` before a registration, ``add_stat`` for each
    named statistic, ``dump_iteration`` each iteration when
    ``needs_iteration_data``, ``finish`` with the iteration count."""

    #: True when ``dump_iteration`` must see every iteration (the engine
    #: then runs its stepped driver)
    needs_iteration_data: bool = False

    #: True when ``add_stat`` records: the engine computes the statistics
    #: that cost a host read (point counts, visit counts) only then
    wants_stats: bool = True

    def init(self) -> None:
        pass

    def add_stat(self, name: str, value) -> None:
        pass

    def dump_iteration(self, iteration, T_iter, reference, reading, matches,
                       outlier_weights, checkers) -> None:
        pass

    def finish(self, iteration_count: int) -> None:
        pass


@InspectorRegistrar.register
class NullInspector(Inspector):
    """Does nothing (reference: Inspector.cpp)."""

    wants_stats = False


@InspectorRegistrar.register
class PerformanceInspector(Inspector):
    """Keeps histograms of the engine's performance counters
    (reference: InspectorsImpl.cpp:52-110)."""

    PARAMS = (
        Param("baseFileName", "base file name for the statistics files "
              "(if empty, disabled)", str, ""),
        Param("dumpPerfOnExit", "dump performance statistics to stderr on "
              "exit", bool, False),
        Param("dumpStats", "dump the statistics on exit", bool, False),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self.histograms: Dict[str, Histogram] = {}

    def add_stat(self, name: str, value) -> None:
        self.histograms.setdefault(name, Histogram(name)).push(float(value))

    def stats(self, name: str):
        return self.histograms[name].stats()

    def dump_stats(self) -> str:
        return "".join(h.dump_stats() for h in self.histograms.values())

    def dump_stats_header(self) -> str:
        return "".join(Histogram.dump_stats_header(n) for n in self.histograms)

    def finish(self, iteration_count: int) -> None:
        if self.dumpPerfOnExit:
            print(self.dump_stats(), file=sys.stderr)
        if self.dumpStats and self.baseFileName:
            with open(f"{self.baseFileName}-stats.csv", "w") as f:
                f.write(self.dump_stats_header())
                f.write(self.dump_stats())


@InspectorRegistrar.register
class VTKFileInspector(PerformanceInspector):
    """Per-iteration VTK dumps of clouds, match links and weights
    (reference: InspectorsImpl.cpp:138-366)."""
    # the files are named ``<baseFileName>-<role>-<iteration:04d>.vtk``

    PARAMS = PerformanceInspector.PARAMS + (
        Param("dumpIterationInfo", "dump iteration info clouds", bool, False),
        Param("dumpDataLinks", "dump match links between clouds", bool, False),
        Param("dumpReading", "dump the reading cloud each iteration", bool, False),
        Param("dumpReference", "dump the reference cloud each iteration",
              bool, False),
        Param("writeBinary", "write binary VTK instead of ASCII", bool, False),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self.needs_iteration_data = bool(
            self.dumpIterationInfo or self.dumpDataLinks or self.dumpReading
            or self.dumpReference)

    def _path(self, role: str, iteration) -> str:
        base = self.baseFileName or "point-matcher-output"
        return f"{base}-{role}-{iteration:04d}.vtk"

    def dump_iteration(self, iteration, T_iter, reference, reading, matches,
                       outlier_weights, checkers) -> None:
        from .io.vtkio import save_vtk, save_vtk_links

        if self.dumpReading or self.dumpIterationInfo:
            save_vtk(reading, self._path("reading", iteration),
                     binary=self.writeBinary)
        if self.dumpReference:
            save_vtk(reference, self._path("reference", iteration),
                     binary=self.writeBinary)
        if self.dumpDataLinks:
            save_vtk_links(reading, reference, matches, outlier_weights,
                           self._path("link", iteration),
                           binary=self.writeBinary)
