"""Carry an ``ICPSequence``'s long-lived state, its prefiltered map, into
the port.

The map crosses as numpy arrays: the JAX engine's
``seq.get_prefiltered_internal_map().to_numpy()`` gives the centred points
and their "normals" descriptor, ``seq.trm_host()`` the transform from the
centred frame back to the map's own frame. Module parameters cross as
plain ``{name: value}`` dicts through the shared registry names.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cloud import PointCloud

__all__ = ["install_map"]


def install_map(seq, points: np.ndarray, normals: np.ndarray,
                T_refIn_refMean: np.ndarray,
                mask: Optional[np.ndarray] = None) -> None:
    """Install a prefiltered, centred map in the port ``ICPSequence``
    ``seq``, on its device, in place of ``seq.set_map``."""
    dev = seq.device
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    m = None if mask is None else torch.as_tensor(np.asarray(mask, bool),
                                                  device=dev)
    nrm = torch.as_tensor(np.asarray(normals, np.float32), device=dev)
    T = torch.as_tensor(np.asarray(T_refIn_refMean, np.float32), device=dev)
    seq._install_map(PointCloud(pts, m, {"normals": nrm}), T)
