"""CSV point-cloud IO (counterpart of ``libpointmatcher_tpu.io.csvio``;
reference: IO.cpp:534-805 loadCSV/saveCSV).

Header-sniffing parser: delimiter in {',', ';', tab, space}, a header when
the first line holds a non-numeric token, x/y/z and descriptor columns
through the external label table; a headerless file maps its first 2-3
columns to coordinates. A block without time columns is parsed by the
native tokenizer (:mod:`.native`) when it is available, else by Python's
``float``; both are correctly rounded, so both give the same float64. Time
columns are parsed as int64 and written as integers.
"""

from __future__ import annotations

import csv as _csv
from typing import List, TextIO, Union

import numpy as np

from ..cloud import PointCloud
from . import native
from .files import open_dest, read_bytes
from .labels import descriptor_column_names, group_columns, time_column_indices

__all__ = ["load_csv", "save_csv"]


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _sniff_delimiter(line: str) -> str:
    for cand in (",", ";", "\t"):
        if cand in line:
            return cand
    return " "


def _split(line: str, delim: str) -> List[str]:
    if delim == " ":
        return line.split()
    return [t.strip() for t in line.split(delim) if t.strip() != ""]


def load_csv(source: Union[str, TextIO], device=None) -> PointCloud:
    """Load a CSV file (a path or a file object) onto ``device`` (the card
    unless ``device="cpu"``)."""
    text = read_bytes(source).decode()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty CSV file")
    delim = _sniff_delimiter(lines[0])
    first = _split(lines[0], delim)
    if any(not _is_number(tok) for tok in first):
        col_names, data_lines = first, lines[1:]
    else:
        ncols = len(first)
        col_names = ["x", "y", "z"][:min(ncols, 3)] + [
            f"desc{i}" for i in range(max(0, ncols - 3))]
        data_lines = lines
    time_cols = time_column_indices(col_names)

    data = None
    if data_lines and not time_cols:
        vals = native.parse_floats("\n".join(data_lines).encode())
        if vals is not None and len(vals) == len(data_lines) * len(col_names):
            data = vals.reshape(len(data_lines), len(col_names))
    if data is None:
        rows = [_split(ln, delim) for ln in data_lines]
        data = [np.asarray([int(r[ci]) for r in rows], np.int64) if ci in time_cols
                else np.asarray([float(r[ci]) for r in rows], np.float64)
                for ci in range(len(col_names))]
    points, descriptors, times = group_columns(col_names, data)
    return PointCloud.from_numpy(points, descriptors, device, times=times)


def _column_text(col: np.ndarray) -> List[str]:
    """A column's cells: integers (time channels) exactly, floats as ``.9g``,
    which reads back to the same float32."""
    if col.dtype.kind in "iu":
        return [str(v) for v in col.tolist()]
    return [format(v, ".9g") for v in col.tolist()]


def save_csv(cloud: PointCloud, dest: Union[str, TextIO]) -> None:
    """Write the valid rows with a header: coordinates, the descriptors'
    columns under their external names, then the time channels."""
    pts, descs, times = cloud.to_numpy(with_times=True)
    dim = pts.shape[1]
    headers = ["x", "y", "z"][:dim]
    cols = [pts[:, i] for i in range(dim)]
    for name, arr in descs.items():
        for i, cn in enumerate(descriptor_column_names(name, arr.shape[1], dim)):
            headers.append(cn)
            cols.append(arr[:, i])
    for name, arr in times.items():
        for i in range(arr.shape[1]):
            headers.append(name if arr.shape[1] == 1 else f"{name}{i}")
            cols.append(arr[:, i])
    f, own = open_dest(dest, text=True)
    try:
        w = _csv.writer(f)
        w.writerow(headers)
        w.writerows(zip(*(_column_text(c) for c in cols)))
    finally:
        if own:
            f.close()
