"""External-column → internal-channel label mapping (the port's own copy of
``libpointmatcher_tpu.io.labels``).

The reference's supported-labels table and ``LabelGenerator`` (reference:
IO.h:117-176): external per-column names (``nx``, ``normal_x``, ``red``, …)
are grouped into named multi-span internal descriptors (``normals`` [3],
``color`` [4], …). Host numpy only."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "FEATURE",
    "DESCRIPTOR",
    "TIME",
    "external_label_info",
    "group_columns",
    "descriptor_column_names",
    "time_column_indices",
]

FEATURE = "feature"
DESCRIPTOR = "descriptor"
TIME = "time"

# (externalName → (internalName, kind, position-within-group))
# mirrors reference: IO.h getSupportedExternalLabels
_EXTERNAL: Dict[str, Tuple[str, str, int]] = {}


def _add(internal: str, externals: List[str], kind: str):
    for pos, ext in enumerate(externals):
        _EXTERNAL[ext] = (internal, kind, pos)


_add("x", ["x"], FEATURE)
_add("y", ["y"], FEATURE)
_add("z", ["z"], FEATURE)
_add("pad", ["pad"], FEATURE)
_add("normals", ["nx", "ny", "nz"], DESCRIPTOR)
_EXTERNAL["normal_x"] = ("normals", DESCRIPTOR, 0)
_EXTERNAL["normal_y"] = ("normals", DESCRIPTOR, 1)
_EXTERNAL["normal_z"] = ("normals", DESCRIPTOR, 2)
_add(
    "observationDirections",
    ["observationDirections0", "observationDirections1", "observationDirections2"],
    DESCRIPTOR,
)
_add("color", ["red", "green", "blue", "alpha"], DESCRIPTOR)
_add("eigValues", ["eigValues0", "eigValues1", "eigValues2"], DESCRIPTOR)
_add(
    "eigVectors",
    [
        "eigVectors0X", "eigVectors0Y", "eigVectors0Z",
        "eigVectors1X", "eigVectors1Y", "eigVectors1Z",
        "eigVectors2X", "eigVectors2Y", "eigVectors2Z",
    ],
    DESCRIPTOR,
)
_add("intensity", ["intensity"], DESCRIPTOR)
_add("time", ["time"], TIME)


def external_label_info(name: str) -> Optional[Tuple[str, str, int]]:
    """→ (internalName, kind, position) or None if unknown."""
    return _EXTERNAL.get(name)


def group_columns(col_names: List[str], data):
    """Split columns into (points, descriptors, times) following the label
    table. ``data`` is either an [N, C] array or a list of C per-column 1-D
    arrays (the latter preserves integer dtypes — int64 time channels must
    not round-trip through float64, which quantizes nanosecond epochs to
    ~256 ns). Unknown columns become 1-D descriptors under their own name
    (reference CSV behavior)."""
    columns = (
        [data[:, i] for i in range(data.shape[1])]
        if isinstance(data, np.ndarray) and data.ndim == 2
        else list(data)
    )
    feat_cols = {}
    desc_cols: Dict[str, Dict[int, np.ndarray]] = {}
    time_cols: Dict[str, Dict[int, np.ndarray]] = {}
    extra_order: List[str] = []
    for ci, name in enumerate(col_names):
        info = external_label_info(name)
        col = columns[ci]
        if info is None:
            desc_cols.setdefault(name, {})[0] = col
            if name not in extra_order:
                extra_order.append(name)
            continue
        internal, kind, pos = info
        if kind == FEATURE:
            feat_cols[internal] = col
        elif kind == DESCRIPTOR:
            desc_cols.setdefault(internal, {})[pos] = col
            if internal not in extra_order:
                extra_order.append(internal)
        else:
            time_cols.setdefault(internal, {})[pos] = col
            if internal not in extra_order:
                extra_order.append(internal)

    dims = [d for d in ("x", "y", "z") if d in feat_cols]
    if "x" not in feat_cols or "y" not in feat_cols:
        raise ValueError(f"no x/y columns found among {col_names}")
    points = np.stack([feat_cols[d] for d in dims], axis=1).astype(np.float32)

    descriptors = {}
    times = {}
    for name in extra_order:
        if name in desc_cols:
            group = desc_cols[name]
            arr = np.stack(
                [group[p] for p in sorted(group)], axis=1
            ).astype(np.float32)
            descriptors[name] = arr
        elif name in time_cols:
            group = time_cols[name]
            cols = [group[p] for p in sorted(group)]
            if any(np.issubdtype(c.dtype, np.floating) for c in cols):
                # float-parsed time column: exact only below 2^53
                arr = np.stack(cols, axis=1).astype(np.int64)
            else:
                arr = np.stack(
                    [c.astype(np.int64) for c in cols], axis=1
                )
            times[name] = arr
    return points, descriptors, times


def descriptor_column_names(name: str, span: int, dim: int) -> List[str]:
    """Canonical external column names when saving (reference: IO.cpp save)."""
    if name == "normals":
        return ["nx", "ny", "nz"][:span]
    if name == "color":
        return ["red", "green", "blue", "alpha"][:span]
    if name == "eigValues":
        return [f"eigValues{i}" for i in range(span)]
    if name == "eigVectors":
        axes = "XYZ"
        return [f"eigVectors{i // dim}{axes[i % dim]}" for i in range(span)]
    if span == 1:
        return [name]
    return [f"{name}{i}" for i in range(span)]


def time_column_indices(col_names: List[str]) -> set:
    """Indices of the columns that hold a time channel (parsed as int64,
    never through float64)."""
    return {i for i, name in enumerate(col_names)
            if (external_label_info(name) or (None, None, None))[1] == TIME}
