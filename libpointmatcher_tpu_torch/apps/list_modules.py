"""Dump every registered module with its parameters and bibliography
(reference: examples/list_modules.cpp). The text is the JAX package's,
module for module."""

from __future__ import annotations

import argparse
import sys

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.bibliography import (bibtex_entry,
                                                    process_citations,
                                                    text_entry)

REGISTRARS = [
    ("Transformations", pt.TransformationRegistrar),
    ("DataPointsFilters", pt.DataPointsFilterRegistrar),
    ("Matchers", pt.MatcherRegistrar),
    ("OutlierFilters", pt.OutlierFilterRegistrar),
    ("ErrorMinimizers", pt.ErrorMinimizerRegistrar),
    ("TransformationCheckers", pt.TransformationCheckerRegistrar),
    ("Inspectors", pt.InspectorRegistrar),
    ("Loggers", pt.LoggerRegistrar),
]


def describe_module(name, cls, cited_keys, style="normal") -> str:
    desc, keys = process_citations(cls.description(), style)
    for k in keys:
        if k not in cited_keys:
            cited_keys.append(k)
    lines = [f"* {name}", f"  {desc.strip()}"]
    params = cls.available_parameters()
    if params:
        lines.append("  Parameters:")
        for p in params:
            bound = ""
            if p.min is not None or p.max is not None:
                bound = f" (min: {p.min}, max: {p.max})"
            lines.append(
                f"    - {p.name} ({p.type.__name__}, default: {p.default})"
                f"{bound}: {p.doc}")
    else:
        lines.append("  (no parameters)")
    return "\n".join(lines)


def describe_chain(icp) -> str:
    lines = []
    for label, modules in [
        ("readingDataPointsFilters", icp.reading_filters),
        ("readingStepDataPointsFilters", icp.reading_step_filters),
        ("referenceDataPointsFilters", icp.reference_filters),
        ("matcher", [icp.matcher] if icp.matcher else []),
        ("outlierFilters", icp.outlier_filters),
        ("errorMinimizer", [icp.error_minimizer] if icp.error_minimizer else []),
        ("transformationCheckers", icp.checkers),
        ("inspector", [icp.inspector] if icp.inspector else []),
    ]:
        lines.append(f"{label}:")
        for m in modules:
            lines.append(f"  {m!r}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="List all registered modules.")
    p.add_argument("--citationStyle", choices=["normal", "roswiki", "bibtex"],
                   default="normal")
    args = p.parse_args(argv)

    cited = []
    for section, registrar in REGISTRARS:
        print(f"{'=' * 60}\n{section}\n{'=' * 60}")
        for name, cls in registrar.items():
            print(describe_module(name, cls, cited, args.citationStyle))
            print()
    if cited:
        print(f"{'=' * 60}\nBibliography\n{'=' * 60}")
        for i, key in enumerate(cited, 1):
            if args.citationStyle == "bibtex":
                print(bibtex_entry(key))
            else:
                print(f"[{i}] {text_entry(key)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
