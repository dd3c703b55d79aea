"""Batch experiment file lists (counterpart of
``libpointmatcher_tpu.io.filelist``; reference: IO.h:230-254,
IO.cpp:179-351).

A CSV with a header; supported columns:
- ``reading``   — file name of the reading cloud (required)
- ``reference`` — file name of the reference cloud
- ``config``    — YAML configuration of the ICP chain
- ``iTxy``      — initial transformation entries (2D: iT00..iT22, 3D: iT00..iT33)
- ``gTxy``      — ground-truth transformation entries
- ``gravity``   — gravity vector components gx, gy, gz
Relative paths resolve against the list file's directory."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["FileInfo", "FileInfoVector", "load_file_info_vector"]


@dataclass
class FileInfo:
    reading: str
    reference: Optional[str] = None
    configuration: Optional[str] = None
    initial_transformation: Optional[np.ndarray] = None
    ground_truth_transformation: Optional[np.ndarray] = None
    gravity: Optional[np.ndarray] = None


class FileInfoVector(list):
    """List of FileInfo rows."""


def _find_transform(cols, prefix: str) -> Optional[int]:
    """→ dimension+1 of the homogeneous transform found, or None."""
    for dim in (4, 3):
        needed = [f"{prefix}{i}{j}" for i in range(dim) for j in range(dim)]
        if all(n in cols for n in needed):
            return dim
    return None


def load_file_info_vector(file_name: str, data_path: str = "",
                          config_path: str = "") -> FileInfoVector:
    """One :class:`FileInfo` per data row of the list ``file_name``; the
    cloud paths resolve against ``data_path`` and the configurations
    against ``config_path`` (both default to the list's directory)."""
    base = os.path.dirname(os.path.abspath(file_name))
    data_path = data_path or base
    config_path = config_path or base

    with open(file_name) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = [t.strip() for t in re.split(r"[,;\t]|\s+", lines[0]) if t.strip()]
    rows = []
    for ln in lines[1:]:
        rows.append([t.strip() for t in re.split(r"[,;\t]|\s+", ln) if t.strip()])
    cols = {name: [row[i] for row in rows] for i, name in enumerate(header)}

    if "reading" not in cols:
        raise RuntimeError(
            'the header should at least contain "reading"'
        )

    it_dim = _find_transform(cols, "iT")
    gt_dim = _find_transform(cols, "gT")
    if it_dim and gt_dim and it_dim != gt_dim:
        raise RuntimeError(
            "Initial transformation and ground truth have different dimensions"
        )

    def resolve(path, root):
        return path if os.path.isabs(path) else os.path.join(root, path)

    out = FileInfoVector()
    for li in range(len(rows)):
        info = FileInfo(reading=resolve(cols["reading"][li], data_path))
        if "reference" in cols:
            info.reference = resolve(cols["reference"][li], data_path)
        if "config" in cols:
            info.configuration = resolve(cols["config"][li], config_path)
        if it_dim:
            T = np.array(
                [
                    [float(cols[f"iT{i}{j}"][li]) for j in range(it_dim)]
                    for i in range(it_dim)
                ]
            )
            info.initial_transformation = T
        if gt_dim:
            T = np.array(
                [
                    [float(cols[f"gT{i}{j}"][li]) for j in range(gt_dim)]
                    for i in range(gt_dim)
                ]
            )
            info.ground_truth_transformation = T
        if all(f"g{a}" in cols for a in "xyz"):
            info.gravity = np.array(
                [float(cols[f"g{a}"][li]) for a in "xyz"]
            )
        out.append(info)
    return out
