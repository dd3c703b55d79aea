"""YAML chain configuration (counterpart of ``libpointmatcher_tpu.config``;
reference: ICP.cpp:117-236): the reference's section names and module
syntax, resolved through the port's registries. An unknown section or
module raises ``InvalidModuleType``; a bad parameter ``InvalidParameter``.
Modules the port does not have yet are unknown modules here. The
``logger`` section installs the process's logger first, as the reference
does (ICP.cpp:131-135)."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import yaml

from .checkers import TransformationCheckerRegistrar
from .errors import ConfigurationError, InvalidModuleType
from .filters.base import DataPointsFilterRegistrar
from .inspectors import InspectorRegistrar, NullInspector
from .loggers import LoggerRegistrar, set_logger
from .matchers import MatcherRegistrar
from .minimizers import ErrorMinimizerRegistrar
from .outlierfilters import OutlierFilterRegistrar
from .transformations import RigidTransformation, SimilarityTransformation

__all__ = ["configure_chain_from_yaml", "parse_module_spec", "VALID_SECTIONS"]

VALID_SECTIONS = (
    "readingDataPointsFilters",
    "readingStepDataPointsFilters",
    "referenceDataPointsFilters",
    "matcher",
    "outlierFilters",
    "errorMinimizer",
    "transformationCheckers",
    "inspector",
    "logger",
)


def parse_module_spec(node: Any) -> Tuple[str, Dict[str, Any]]:
    """A module is a bare name or ``{name: {param: value}}``."""
    if isinstance(node, str):
        return node, {}
    if isinstance(node, Mapping):
        if len(node) != 1:
            raise ConfigurationError(
                f"expected a single module name, got {sorted(node)}")
        name, params = next(iter(node.items()))
        if params is None:
            params = {}
        if not isinstance(params, Mapping):
            raise ConfigurationError(
                f"parameters of module '{name}' must be a mapping")
        return str(name), {str(k): v for k, v in params.items()}
    raise ConfigurationError(f"cannot parse module spec from {node!r}")


def _create(registrar, node):
    name, params = parse_module_spec(node)
    return registrar.create(name, params)


def _create_list(registrar, node) -> List:
    if node is None:
        return []
    if not isinstance(node, list):
        raise ConfigurationError(
            f"expected a list of modules for {registrar.interface_name}")
    return [_create(registrar, item) for item in node]


def configure_chain_from_yaml(chain, source) -> None:
    """Populate an ICP engine from YAML text, a stream or a parsed dict.
    The whole chain is replaced: a section absent from the YAML leaves its
    slot empty (reference: ICP.cpp:117-128)."""
    if isinstance(source, dict):
        doc = source
    else:
        doc = yaml.safe_load(source.read() if hasattr(source, "read") else source)
    doc = doc or {}
    if not isinstance(doc, dict):
        raise ConfigurationError("top-level YAML must be a mapping of sections")
    for section in doc:
        if section not in VALID_SECTIONS:
            raise InvalidModuleType(
                f"unknown section '{section}'; valid sections: "
                f"{list(VALID_SECTIONS)}")
    if "logger" in doc:
        set_logger(_create(LoggerRegistrar, doc["logger"]))
    chain.reading_filters = _create_list(
        DataPointsFilterRegistrar, doc.get("readingDataPointsFilters"))
    chain.reading_step_filters = _create_list(
        DataPointsFilterRegistrar, doc.get("readingStepDataPointsFilters"))
    chain.reference_filters = _create_list(
        DataPointsFilterRegistrar, doc.get("referenceDataPointsFilters"))
    chain.matcher = (_create(MatcherRegistrar, doc["matcher"])
                     if "matcher" in doc else None)
    chain.outlier_filters = _create_list(OutlierFilterRegistrar,
                                         doc.get("outlierFilters"))
    chain.error_minimizer = (_create(ErrorMinimizerRegistrar, doc["errorMinimizer"])
                             if "errorMinimizer" in doc else None)
    # the transformation follows the minimizer (reference: ICP.cpp:145-148)
    name = (parse_module_spec(doc["errorMinimizer"])[0]
            if "errorMinimizer" in doc else "")
    chain.transformations = [SimilarityTransformation() if "Similarity" in name
                             else RigidTransformation()]
    chain.checkers = _create_list(TransformationCheckerRegistrar,
                                  doc.get("transformationCheckers"))
    chain.inspector = (_create(InspectorRegistrar, doc["inspector"])
                       if "inspector" in doc else NullInspector())
