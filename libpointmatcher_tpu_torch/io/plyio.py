"""PLY point-cloud IO (counterpart of ``libpointmatcher_tpu.io.plyio``;
reference: IO.cpp loadPLY / savePLY, IO.h:263-361).

Full header parser (elements with typed properties, list properties
skipped; ascii and binary in both endians); the vertex properties map to
coordinates and descriptors through the external label table. PLY has no
64-bit integer type, so a time channel is not written (as in the JAX
package)."""

from __future__ import annotations

from typing import BinaryIO, List, Tuple, Union

import numpy as np

from ..cloud import PointCloud
from .files import open_dest, read_bytes
from .labels import descriptor_column_names, group_columns, time_column_indices

__all__ = ["load_ply", "save_ply"]

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(source: Union[str, BinaryIO], device=None) -> PointCloud:
    """Load a PLY file (a path or a file object) onto ``device`` (the card
    unless ``device="cpu"``)."""
    data = read_bytes(source)

    # ---- header
    end = data.find(b"end_header")
    if end == -1:
        raise ValueError("PLY: no end_header")
    end_line = data.find(b"\n", end) + 1
    header = data[:end_line].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines() if ln.strip()]
    if lines[0] != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for ln in lines[1:]:
        parts = ln.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment" or parts[0] == "obj_info":
            continue
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise ValueError("PLY: property before element")
            if parts[1] == "list":
                elements[-1][2].append((parts[-1], f"list:{parts[2]}:{parts[3]}"))
            else:
                elements[-1][2].append((parts[-1], parts[1]))
        elif parts[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY: no format line")

    body = data[end_line:]
    vertex = None
    offset = 0
    if fmt == "ascii":
        tokens = body.split()
        ti = 0
        for name, count, props in elements:
            ncols = len(props)
            if any(t.startswith("list") for _, t in props):
                # consume lists row by row
                rows = []
                for _ in range(count):
                    row = []
                    for pname, ptype in props:
                        if ptype.startswith("list"):
                            n = int(tokens[ti]); ti += 1 + n
                        else:
                            row.append(float(tokens[ti])); ti += 1
                    rows.append(row)
                arr = np.asarray(rows, np.float64)
            else:
                flat = np.asarray(
                    tokens[ti:ti + count * ncols], dtype=np.float64
                )
                ti += count * ncols
                arr = flat.reshape(count, ncols)
            if name == "vertex":
                vertex = (props, arr)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            if any(t.startswith("list") for _, t in props):
                # element with list properties (e.g. faces): parse row-wise
                rows = []
                for _ in range(count):
                    vals = []
                    for pname, ptype in props:
                        if ptype.startswith("list"):
                            _, cnt_t, val_t = ptype.split(":")
                            cdt = np.dtype(endian + _PLY_TYPES[cnt_t])
                            n = int(np.frombuffer(body, cdt, 1, offset)[0])
                            offset += cdt.itemsize
                            vdt = np.dtype(endian + _PLY_TYPES[val_t])
                            offset += vdt.itemsize * n
                        else:
                            dt = np.dtype(endian + _PLY_TYPES[ptype])
                            vals.append(float(np.frombuffer(body, dt, 1, offset)[0]))
                            offset += dt.itemsize
                    rows.append(vals)
                arr = np.asarray(rows, np.float64)
            else:
                dt = np.dtype(
                    [(pname, endian + _PLY_TYPES[ptype]) for pname, ptype in props]
                )
                rec = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                # per-column list keeps native dtypes (int64 times stay exact)
                arr = [rec[pname] for pname, _ in props]
            if name == "vertex":
                vertex = (props, arr)

    if vertex is None:
        raise ValueError("PLY: no vertex element")
    props, arr = vertex
    col_names = [p for p, t in props if not t.startswith("list")]
    if isinstance(arr, np.ndarray):
        time_cols = time_column_indices(col_names)
        if time_cols:
            arr = [
                arr[:, i].astype(np.int64) if i in time_cols else arr[:, i]
                for i in range(arr.shape[1])
            ]
    points, descriptors, times = group_columns(col_names, arr)
    return PointCloud.from_numpy(points, descriptors, device, times=times)


def save_ply(cloud: PointCloud, dest: Union[str, BinaryIO],
             binary: bool = False) -> None:
    """Write the valid rows' coordinates and descriptors as float vertex
    properties, ascii or binary little-endian."""
    pts, descs = cloud.to_numpy()
    n, dim = pts.shape
    headers = ["x", "y", "z"][:dim]
    cols = [pts[:, i] for i in range(dim)]
    for name, arr in descs.items():
        for i, cn in enumerate(descriptor_column_names(name, arr.shape[1], dim)):
            headers.append(cn)
            cols.append(arr[:, i])

    f, own = open_dest(dest)
    try:
        f.write(b"ply\n")
        fmt = "binary_little_endian" if binary else "ascii"
        f.write(f"format {fmt} 1.0\n".encode())
        f.write(b"comment generated by libpointmatcher_tpu\n")
        f.write(f"element vertex {n}\n".encode())
        for h in headers:
            f.write(f"property float {h}\n".encode())
        f.write(b"end_header\n")
        mat = np.stack(cols, axis=1).astype(np.float32)
        if binary:
            f.write(np.ascontiguousarray(mat, dtype="<f4").tobytes())
        else:
            f.write("".join(" ".join(format(v, ".9g") for v in row) + "\n"
                            for row in mat.tolist()).encode())
    finally:
        if own:
            f.close()
