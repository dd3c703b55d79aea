"""PointCloud: a masked, fixed-capacity row layout in torch.

The counterpart of ``libpointmatcher_tpu.cloud.PointCloud``:

- ``points``      [N, d] float32 coordinates (d = 2 or 3);
- ``mask``        [N] bool valid-row mask; a filter "removes" a point by
  clearing its bit;
- ``descriptors`` {name: [N, span] float32} in insertion order
  ("normals" has span d).

``compact()`` packs the valid rows to the front in their original order, so
a row id means the same point before and after, on both sides of a parity
test. The JAX package pads the result to a bucket ladder because every new
shape costs XLA a compile; PyTorch runs eagerly with no such cost, so the
port compacts to the exact valid count.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .device import resolve_device
from .errors import InvalidField

__all__ = ["PointCloud"]


class PointCloud:
    """Masked point cloud (see module docstring)."""

    __slots__ = ("points", "mask", "descriptors", "_count_cache")

    def __init__(self, points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 descriptors: Optional[Mapping[str, torch.Tensor]] = None):
        if points.ndim != 2:
            raise InvalidField(f"points must be [N, d], got {tuple(points.shape)}")
        self.points = points.to(torch.float32)
        if mask is None:
            mask = torch.ones(points.shape[0], dtype=torch.bool,
                              device=points.device)
        self.mask = mask.to(torch.bool)
        self.descriptors: Dict[str, torch.Tensor] = dict(descriptors or {})
        self._count_cache: Optional[int] = None

    # ------------------------------------------------------------ properties
    @property
    def num_points(self) -> int:
        """Capacity N (rows allocated, valid or not)."""
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid rows, as a tensor on the cloud's device."""
        return self.mask.sum()

    def count_host(self) -> int:
        """Number of valid rows on the host (one sync, then cached)."""
        if self._count_cache is None:
            self._count_cache = int(self.count())
        return self._count_cache

    # ----------------------------------------------------------- descriptors
    def has_descriptor(self, name: str) -> bool:
        return name in self.descriptors

    def get_descriptor(self, name: str) -> torch.Tensor:
        try:
            return self.descriptors[name]
        except KeyError:
            raise InvalidField(
                f"Missing descriptor '{name}'; have {list(self.descriptors)}"
            ) from None

    # ------------------------------------------------------------- structure
    def replace(self, **kw) -> "PointCloud":
        out = PointCloud(kw.get("points", self.points),
                         kw.get("mask", self.mask),
                         kw.get("descriptors", self.descriptors))
        if "mask" not in kw:
            out._count_cache = self._count_cache
        return out

    def with_mask(self, mask: torch.Tensor) -> "PointCloud":
        """New cloud whose validity mask is ``self.mask & mask``."""
        return self.replace(mask=self.mask & mask)

    def to(self, device) -> "PointCloud":
        """The same cloud on ``device``."""
        device = torch.device(device)
        if self.device == device:
            return self
        out = PointCloud(self.points.to(device), self.mask.to(device),
                         {k: v.to(device) for k, v in self.descriptors.items()})
        out._count_cache = self._count_cache
        return out

    def compact(self) -> "PointCloud":
        """Valid rows packed to the front in their original order, at the
        exact valid count (one host sync)."""
        keep = torch.nonzero(self.mask, as_tuple=True)[0]
        out = PointCloud(self.points[keep],
                         torch.ones(keep.shape[0], dtype=torch.bool,
                                    device=self.device),
                         {k: v[keep] for k, v in self.descriptors.items()})
        out._count_cache = keep.shape[0]
        return out

    # -------------------------------------------------------------- numpy IO
    def host_rows(self):
        """All rows ``(points, mask)`` as numpy, valid or not: row indices
        match the tensor layout (``to_numpy`` keeps valid rows only)."""
        return self.points.cpu().numpy(), self.mask.cpu().numpy()

    def to_numpy(self):
        """``(points[N_valid, d], {name: [N_valid, span]})`` as numpy."""
        m = self.mask.cpu().numpy()
        pts = self.points.cpu().numpy()[m]
        descs = {k: v.cpu().numpy()[m] for k, v in self.descriptors.items()}
        return pts, descs

    @staticmethod
    def from_numpy(points, descriptors=None, device=None) -> "PointCloud":
        """Cloud of all-valid rows on ``device`` (the card unless
        ``device="cpu"``)."""
        dev = resolve_device(device)
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        descs = {}
        for k, v in (descriptors or {}).items():
            v = np.asarray(v, np.float32)
            descs[k] = torch.as_tensor(v[:, None] if v.ndim == 1 else v,
                                       device=dev)
        out = PointCloud(pts, None, descs)
        out._count_cache = pts.shape[0]
        return out

    def __repr__(self):
        labels = tuple((k, v.shape[1]) for k, v in self.descriptors.items())
        return (f"PointCloud(N={self.num_points}, dim={self.dim}, "
                f"device={self.device}, descriptors={labels})")
