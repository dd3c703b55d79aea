"""Point-cloud IO: extension-dispatched load and save (counterpart of
``libpointmatcher_tpu.io``; reference: IO.cpp:375-390 load dispatch,
IO.cpp:808-827 save dispatch): ``.csv``, ``.vtk``, ``.ply``, ``.pcd``.

Files are parsed on the host (as in the reference and the JAX package) and
the cloud is built on ``device``: the card unless ``device="cpu"``; without
a card and without that request a loader raises. The JAX loaders' bucket
``granule`` has no counterpart: the port's clouds hold the exact row count.
"""

from __future__ import annotations

import os

from ..cloud import PointCloud
from . import native  # noqa: F401
from .csvio import load_csv, save_csv
from .filelist import FileInfo, FileInfoVector, load_file_info_vector
from .pcdio import load_pcd, save_pcd
from .plyio import load_ply, save_ply
from .vtkio import load_vtk, save_vtk, save_vtk_links

__all__ = ["load", "save", "validate_file", "load_csv", "save_csv", "load_vtk",
           "save_vtk", "save_vtk_links", "load_ply", "save_ply", "load_pcd",
           "save_pcd", "FileInfo", "FileInfoVector", "load_file_info_vector"]

_LOADERS = {".csv": load_csv, ".vtk": load_vtk, ".ply": load_ply,
            ".pcd": load_pcd}


def validate_file(path: str) -> None:
    """Existence and readability check (reference: PointMatcher.h:122)."""
    if not os.path.isfile(path):
        raise RuntimeError(f"file does not exist: {path}")
    if not os.access(path, os.R_OK):
        raise RuntimeError(f"file is not readable: {path}")


def _unknown(path: str) -> RuntimeError:
    return RuntimeError(
        f"unknown extension for file {path}; supported: .csv .vtk .ply .pcd")


def load(path: str, device=None) -> PointCloud:
    """Load ``path`` by its extension onto ``device`` (the card unless
    ``device="cpu"``)."""
    validate_file(path)
    loader = _LOADERS.get(os.path.splitext(path)[1].lower())
    if loader is None:
        raise _unknown(path)
    return loader(path, device=device)


def save(cloud: PointCloud, path: str, binary: bool = False) -> None:
    """Save the valid rows of ``cloud`` to ``path`` by its extension
    (``binary`` for VTK, PLY and PCD; CSV is always text)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        return save_csv(cloud, path)
    savers = {".vtk": save_vtk, ".ply": save_ply, ".pcd": save_pcd}
    if ext not in savers:
        raise _unknown(path)
    return savers[ext](cloud, path, binary=binary)
