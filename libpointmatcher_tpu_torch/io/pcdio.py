"""PCD point-cloud IO (counterpart of ``libpointmatcher_tpu.io.pcdio``;
reference: IO.cpp loadPCD / savePCD, IO.h:363-407).

Header parser (VERSION / FIELDS / SIZE / TYPE / COUNT / WIDTH / HEIGHT /
VIEWPOINT / POINTS / DATA) with ascii and binary bodies. Time columns are
read as int64, never through float64, and each time channel is written as
``SIZE 8 TYPE I`` columns after the float ones (the JAX package's writer
leaves them out)."""

from __future__ import annotations

from typing import BinaryIO, Union

import numpy as np

from ..cloud import PointCloud
from .files import open_dest, read_bytes
from .labels import descriptor_column_names, group_columns, time_column_indices

__all__ = ["load_pcd", "save_pcd"]

_PCD_NP = {
    ("F", 4): "f4", ("F", 8): "f8",
    ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4", ("I", 8): "i8",
    ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4", ("U", 8): "u8",
}


def load_pcd(source: Union[str, BinaryIO], device=None) -> PointCloud:
    """Load a PCD file (a path or a file object) onto ``device`` (the card
    unless ``device="cpu"``)."""
    data = read_bytes(source)

    fields = sizes = types = counts = None
    n_points = None
    data_mode = None
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl == -1:
            raise ValueError("PCD: truncated header")
        line = data[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        kw = tok[0].upper()
        if kw == "FIELDS":
            fields = tok[1:]
        elif kw == "SIZE":
            sizes = [int(t) for t in tok[1:]]
        elif kw == "TYPE":
            types = tok[1:]
        elif kw == "COUNT":
            counts = [int(t) for t in tok[1:]]
        elif kw == "POINTS":
            n_points = int(tok[1])
        elif kw in ("VERSION", "WIDTH", "HEIGHT", "VIEWPOINT"):
            pass
        elif kw == "DATA":
            data_mode = tok[1].lower()
            break
        else:
            raise ValueError(f"PCD: unknown header keyword {kw}")
    if fields is None:
        raise ValueError("PCD Parse Error: no FIELDS found in the header")
    if sizes is None or types is None:
        raise ValueError("PCD: missing SIZE or TYPE")
    if counts is None:
        counts = [1] * len(fields)
    if len(sizes) != len(fields) or len(types) != len(fields):
        raise ValueError("PCD: SIZE/TYPE length mismatch with FIELDS")
    if n_points is None:
        raise ValueError("PCD: missing POINTS")

    col_names = []
    for fname, cnt in zip(fields, counts):
        if cnt == 1:
            col_names.append(fname)
        else:
            col_names.extend(f"{fname}{i}" for i in range(cnt))

    time_cols = time_column_indices(col_names)
    if data_mode == "ascii":
        text = data[pos:].decode("ascii", errors="replace")
        token_rows = [ln.split() for ln in text.splitlines() if ln.strip()]
        token_rows = token_rows[:n_points]
        arr = [
            np.asarray(
                [int(r[ci]) for r in token_rows], np.int64
            ) if ci in time_cols else np.asarray(
                [float(r[ci]) for r in token_rows], np.float64
            )
            for ci in range(len(col_names))
        ]
    elif data_mode == "binary":
        dt = np.dtype(
            [
                (f"{fname}_{i}", "<" + _PCD_NP[(typ, sz)])
                for fname, typ, sz, cnt in zip(fields, types, sizes, counts)
                for i in range(cnt)
            ]
        )
        rec = np.frombuffer(data, dt, n_points, pos)
        # per-column arrays keep native dtypes (int64 times stay exact)
        arr = [rec[name] for name in rec.dtype.names]
    else:
        raise ValueError(f"PCD: unsupported DATA mode {data_mode}")

    # rows with non-finite coordinates are kept, as in the reference
    points, descriptors, times = group_columns(col_names, arr)
    return PointCloud.from_numpy(points, descriptors, device, times=times)


def save_pcd(cloud: PointCloud, dest: Union[str, BinaryIO],
             binary: bool = False) -> None:
    """Write the valid rows: coordinates and descriptors as ``F 4`` fields,
    then the time channels as ``I 8`` fields; ascii (floats as ``.9g``,
    integers exactly) or binary little-endian."""
    pts, descs, times = cloud.to_numpy(with_times=True)
    n, dim = pts.shape
    fields = ["x", "y", "z"][:dim]
    cols = [pts[:, i] for i in range(dim)]
    for name, arr in descs.items():
        for i, cn in enumerate(descriptor_column_names(name, arr.shape[1], dim)):
            fields.append(cn)
            cols.append(arr[:, i])
    n_float = len(fields)
    for name, arr in times.items():
        for i in range(arr.shape[1]):
            fields.append(name if arr.shape[1] == 1 else f"{name}{i}")
            cols.append(arr[:, i])
    sizes = ["4"] * n_float + ["8"] * (len(fields) - n_float)
    types = ["F"] * n_float + ["I"] * (len(fields) - n_float)

    f, own = open_dest(dest)
    try:
        f.write(b"# .PCD v.7 - Point Cloud Data file format\n")
        f.write(b"VERSION .7\n")
        f.write(("FIELDS " + " ".join(fields) + "\n").encode())
        f.write(("SIZE " + " ".join(sizes) + "\n").encode())
        f.write(("TYPE " + " ".join(types) + "\n").encode())
        f.write(("COUNT " + " ".join(["1"] * len(fields)) + "\n").encode())
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n".encode())
        f.write(f"POINTS {n}\n".encode())
        if binary:
            rec = np.empty(n, [(f"c{i}", "<f4" if i < n_float else "<i8")
                               for i in range(len(cols))])
            for i, c in enumerate(cols):
                rec[f"c{i}"] = c
            f.write(b"DATA binary\n")
            f.write(rec.tobytes())
        else:
            text = [[format(v, ".9g") for v in c.astype(np.float32).tolist()]
                    if i < n_float else [str(v) for v in c.tolist()]
                    for i, c in enumerate(cols)]
            f.write(b"DATA ascii\n")
            f.write("".join(" ".join(row) + "\n" for row in zip(*text)).encode())
    finally:
        if own:
            f.close()
