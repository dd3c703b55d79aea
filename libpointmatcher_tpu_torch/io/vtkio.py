"""Legacy VTK point-cloud IO (counterpart of ``libpointmatcher_tpu.io.vtkio``;
reference: IO.cpp loadVTK/saveVTK, InspectorsImpl.cpp:159-366).

Loads DATASET POLYDATA and UNSTRUCTURED_GRID, ASCII and BINARY (big-endian,
reference: IOFunctions.h:49-78), with POINT_DATA attributes FIELD, SCALARS,
VECTORS, NORMALS, TENSORS and COLOR_SCALARS (binary as uchar / 255), and
int64 time channels split into ``<name>_splitTime_high32`` / ``..._low32``
unsigned-int scalars (reference: IO.cpp:1106-1236). A cloud always loads
3D: a 2D cloud is stored with z = 0 and reads back so. Writes a cloud as
POLYDATA vertices with its descriptors and time channels as POINT_DATA, and
match links as LINES with their outlier weights as CELL_DATA; only the
valid rows are written. ASCII floats are written as ``.9g`` (which reads
back to the same float32) and integers exactly.
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Union

import numpy as np
import torch

from ..cloud import PointCloud
from . import native
from .files import open_dest, read_bytes

__all__ = ["load_vtk", "save_vtk", "save_vtk_links"]

#: VTK type name → (big-endian file dtype, in-memory dtype)
_DTYPES = {
    "float": (np.dtype(">f4"), np.float32),
    "double": (np.dtype(">f8"), np.float64),
    "int": (np.dtype(">i4"), np.int32),
    "unsigned_int": (np.dtype(">u4"), np.uint32),
    "unsigned_char": (np.dtype(">u1"), np.uint8),
    "long": (np.dtype(">i8"), np.int64),
    "short": (np.dtype(">i2"), np.int16),
    "unsigned_short": (np.dtype(">u2"), np.uint16),
    "char": (np.dtype(">i1"), np.int8),
}
_HIGH, _LOW = "_splitTime_high32", "_splitTime_low32"


class _Reader:
    """Line and value reader over the bytes of a legacy VTK file."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def readline(self) -> str:
        end = self.data.find(b"\n", self.pos)
        if end == -1:
            line, self.pos = self.data[self.pos:], len(self.data)
        else:
            line, self.pos = self.data[self.pos:end], end + 1
        return line.decode("ascii", errors="replace").strip()

    def next_nonempty_line(self) -> str:
        while self.pos < len(self.data):
            ln = self.readline()
            if ln:
                return ln
        return ""

    def read_values(self, count: int, type_name: str, binary: bool) -> np.ndarray:
        big, dtype = _DTYPES[type_name]
        if binary:
            nbytes = count * big.itemsize
            buf = self.data[self.pos:self.pos + nbytes]
            self.pos += nbytes
            if self.data[self.pos:self.pos + 1] == b"\n":   # after the block
                self.pos += 1
            return np.frombuffer(buf, dtype=big).astype(dtype)
        res = native.parse_floats_n(self.data[self.pos:], count)
        if res is not None and len(res[0]) == count:
            self.pos += res[1]
            return res[0].astype(dtype)
        vals: List[float] = []
        while len(vals) < count:
            ln = self.next_nonempty_line()
            if not ln:
                break
            vals.extend(float(t) for t in ln.split())
        return np.asarray(vals[:count], dtype=dtype)


def load_vtk(source: Union[str, BinaryIO], device=None) -> PointCloud:
    """Load a legacy VTK file (a path or a file object) onto ``device``
    (the card unless ``device="cpu"``)."""
    r = _Reader(read_bytes(source))
    magic = r.readline()
    if "# vtk DataFile" not in magic:
        raise ValueError(f"not a VTK legacy file: {magic!r}")
    r.readline()  # title
    binary = r.next_nonempty_line().upper() == "BINARY"
    dataset = r.next_nonempty_line().split()
    if len(dataset) != 2 or dataset[0] != "DATASET":
        raise ValueError(f"expected DATASET line, got {dataset}")
    if dataset[1] not in ("POLYDATA", "UNSTRUCTURED_GRID"):
        raise ValueError(f"unsupported VTK dataset type {dataset[1]}")

    points = None
    n_points = 0
    descriptors: Dict[str, np.ndarray] = {}
    split_times: Dict[str, Dict[str, np.ndarray]] = {}
    while r.pos < len(r.data):
        line = r.next_nonempty_line()
        if not line:
            break
        tokens = line.split()
        kw = tokens[0].upper()
        if kw == "POINTS":
            n_points = int(tokens[1])
            points = r.read_values(n_points * 3, tokens[2], binary).reshape(n_points, 3)
        elif kw in ("VERTICES", "POLYGONS", "LINES", "TRIANGLE_STRIPS", "CELLS"):
            r.read_values(int(tokens[2]), "int", binary)
        elif kw == "CELL_TYPES":
            r.read_values(int(tokens[1]), "int", binary)
        elif kw == "POINT_DATA":
            if int(tokens[1]) != n_points:
                raise ValueError("POINT_DATA size differs from POINTS")
        elif kw == "CELL_DATA":
            pass
        elif kw == "FIELD":
            for _ in range(int(tokens[2])):
                h = r.next_nonempty_line().split()
                name, ncomp, cnt = h[0], int(h[1]), int(h[2])
                descriptors[name] = r.read_values(ncomp * cnt, h[3], binary
                                                  ).reshape(cnt, ncomp)
        elif kw == "SCALARS":
            name, typ = tokens[1], tokens[2]
            ncomp = int(tokens[3]) if len(tokens) > 3 else 1
            if not r.next_nonempty_line().upper().startswith("LOOKUP_TABLE"):
                raise ValueError("expected LOOKUP_TABLE after SCALARS")
            arr = r.read_values(n_points * ncomp, typ, binary).reshape(n_points, ncomp)
            if name.endswith(_HIGH):
                split_times.setdefault(name[:-len(_HIGH)], {})["high"] = arr[:, 0]
            elif name.endswith(_LOW):
                split_times.setdefault(name[:-len(_LOW)], {})["low"] = arr[:, 0]
            else:
                descriptors[name] = arr
        elif kw in ("VECTORS", "NORMALS", "TENSORS"):
            span = 9 if kw == "TENSORS" else 3
            name = "normals" if kw == "NORMALS" else tokens[1]
            descriptors[name] = r.read_values(n_points * span, tokens[2], binary
                                              ).reshape(n_points, span)
        elif kw == "COLOR_SCALARS":
            name, ncomp = tokens[1], int(tokens[2])
            if binary:
                vals = r.read_values(n_points * ncomp, "unsigned_char", True)
                arr = vals.reshape(n_points, ncomp).astype(np.float32) / 255.0
            else:
                arr = r.read_values(n_points * ncomp, "float", False
                                    ).reshape(n_points, ncomp)
            descriptors[name] = arr
        else:
            raise ValueError(f"unknown VTK field {kw}")

    if points is None:
        raise ValueError("VTK file has no POINTS")
    times = {}
    for name, hl in split_times.items():
        if "high" not in hl or "low" not in hl:
            raise ValueError(
                f"time channel '{name}' missing one of the _splitTime_ fields")
        t = (hl["high"].astype(np.int64) << 32) | hl["low"].astype(np.int64)
        times[name] = t[:, None]
    return PointCloud.from_numpy(points, descriptors, device, times=times)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _write_values(f, arr: np.ndarray, type_name: str, binary: bool) -> None:
    if binary:
        f.write(np.ascontiguousarray(arr, dtype=_DTYPES[type_name][0]).tobytes())
        f.write(b"\n")
        return
    rows = np.asarray(arr).reshape(arr.shape[0], -1)
    fmt = str if rows.dtype.kind in "iu" else (lambda v: format(v, ".9g"))
    f.write("".join(" ".join(map(fmt, row)) + "\n" for row in rows.tolist()).encode())


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
    """Write POLYDATA with VERTICES, descriptor-typed POINT_DATA and each
    time channel's first column as its ``_splitTime_`` unsigned-int pair
    (reference: InspectorsImpl.cpp:159-235, IO.cpp saveVTK)."""
    pts, descs, times = cloud.to_numpy(with_times=True)
    n = len(pts)
    f, own = open_dest(dest)
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
        for name, arr in times.items():
            t = arr[:, 0].astype(np.int64)
            for suffix, half in ((_HIGH, t >> 32), (_LOW, t & 0xFFFFFFFF)):
                f.write(f"SCALARS {name}{suffix} unsigned_int\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                _write_values(f, half.astype(np.uint32)[:, None], "unsigned_int",
                              binary)
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
    f, own = open_dest(dest)
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
