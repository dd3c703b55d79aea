"""Legacy VTK writers (counterpart of the writers of
``libpointmatcher_tpu.io.vtkio``; reference: IO.cpp saveVTK,
InspectorsImpl.cpp:159-366): a cloud as POLYDATA vertices with its
descriptors as POINT_DATA, and match links as LINES with their outlier
weights as CELL_DATA, in ASCII or big-endian binary
(reference: IOFunctions.h:49-78). Only the valid rows are written."""

from __future__ import annotations

from typing import BinaryIO, Union

import numpy as np
import torch

from ..cloud import PointCloud

__all__ = ["save_vtk", "save_vtk_links"]

_BIG_ENDIAN = {"float": np.dtype(">f4"), "int": np.dtype(">i4"),
               "unsigned_char": np.dtype(">u1")}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _write_values(f, arr: np.ndarray, type_name: str, binary: bool) -> None:
    if binary:
        f.write(np.ascontiguousarray(arr, dtype=_BIG_ENDIAN[type_name]).tobytes())
        f.write(b"\n")
        return
    for row in np.asarray(arr).reshape(arr.shape[0], -1):
        f.write((" ".join(format(v, ".9g") for v in row) + "\n").encode())


def _open(dest):
    """``(file, owned)``: ``dest`` itself if it is writable, else the path
    opened for binary writing."""
    if hasattr(dest, "write"):
        return dest, False
    return open(dest, "wb"), True


def _header(f, title: bytes, binary: bool) -> None:
    f.write(b"# vtk DataFile Version 3.0\n")
    f.write(title + b"\n")
    f.write(b"BINARY\n" if binary else b"ASCII\n")
    f.write(b"DATASET POLYDATA\n")


def _xyz(pts: np.ndarray) -> np.ndarray:
    """Rows as 3-D points (a 2-D cloud gets z = 0)."""
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), pts.dtype)], axis=1)
    return pts.astype(np.float32)


def save_vtk(cloud: PointCloud, dest: Union[str, BinaryIO],
             binary: bool = False) -> None:
    """Write POLYDATA with VERTICES and descriptor-typed POINT_DATA
    (reference: InspectorsImpl.cpp:159-235, IO.cpp saveVTK)."""
    pts, descs = cloud.to_numpy()
    n = len(pts)
    f, own = _open(dest)
    try:
        _header(f, b"libpointmatcher-tpu cloud", binary)
        f.write(f"POINTS {n} float\n".encode())
        _write_values(f, _xyz(pts), "float", binary)
        f.write(f"VERTICES {n} {2 * n}\n".encode())
        verts = np.stack([np.ones(n, np.int32), np.arange(n, dtype=np.int32)],
                         axis=1)
        _write_values(f, verts, "int", binary)
        f.write(f"POINT_DATA {n}\n".encode())
        for name, arr in descs.items():
            span = arr.shape[1]
            if name == "normals" and span == 3:
                f.write(b"NORMALS normals float\n")
                _write_values(f, arr, "float", binary)
            elif name == "color":
                f.write(f"COLOR_SCALARS color {span}\n".encode())
                if binary:
                    _write_values(f, np.clip(arr * 255.0, 0, 255),
                                  "unsigned_char", True)
                else:
                    _write_values(f, arr, "float", False)
            elif span in (3, 9):
                kind = "VECTORS" if span == 3 else "TENSORS"
                f.write(f"{kind} {name} float\n".encode())
                _write_values(f, arr, "float", binary)
            else:
                for i in range(span):
                    cname = name if span == 1 else f"{name}{i}"
                    f.write(f"SCALARS {cname} float\n".encode())
                    f.write(b"LOOKUP_TABLE default\n")
                    _write_values(f, arr[:, i:i + 1], "float", binary)
    finally:
        if own:
            f.close()


def save_vtk_links(reading: PointCloud, reference: PointCloud, matches,
                   weights, dest, binary: bool = False) -> None:
    """Write the match links of the valid reading rows as LINES between the
    reading's valid points and the reference's (in that order, each cloud's
    valid rows only), with each link's outlier weight as CELL_DATA
    (reference: InspectorsImpl.cpp:286-366). A link is kept where its id is
    a valid reference row and its distance is finite; links follow the
    reading's rows, then the match order."""
    r_pts, _ = reading.to_numpy()
    f_pts, _ = reference.to_numpy()
    dists, ids, w = _host(matches.dists), _host(matches.ids), _host(weights)
    valid_rows = np.flatnonzero(_host(reading.mask))
    fmask = _host(reference.mask)
    # reference row (padded space) → its index among the valid rows
    remap = -np.ones(len(fmask), np.int64)
    remap[np.flatnonzero(fmask)] = np.arange(int(fmask.sum()))
    j = ids[valid_rows].astype(np.int64)
    rj = remap[np.clip(j, 0, None)]
    keep = (j >= 0) & np.isfinite(dists[valid_rows]) & (rj >= 0)
    li = np.broadcast_to(np.arange(len(valid_rows))[:, None], j.shape)[keep]
    lines = np.stack([np.full(len(li), 2), li, len(valid_rows) + rj[keep]],
                     axis=1).astype(np.int32)
    cell_w = w[valid_rows][keep].astype(np.float32)
    f, own = _open(dest)
    try:
        all_pts = np.concatenate([_xyz(r_pts), _xyz(f_pts)], axis=0)
        _header(f, b"libpointmatcher-tpu match links", binary)
        f.write(f"POINTS {len(all_pts)} float\n".encode())
        _write_values(f, all_pts, "float", binary)
        f.write(f"LINES {len(lines)} {3 * len(lines)}\n".encode())
        _write_values(f, lines, "int", binary)
        f.write(f"CELL_DATA {len(lines)}\n".encode())
        f.write(b"SCALARS outlier_weights float\n")
        f.write(b"LOOKUP_TABLE default\n")
        _write_values(f, cell_w[:, None], "float", binary)
    finally:
        if own:
            f.close()
