"""PointCloud: a masked, fixed-capacity row layout in torch.

The counterpart of ``libpointmatcher_tpu.cloud.PointCloud``:

- ``points``      [N, d] float32 coordinates (d = 2 or 3);
- ``mask``        [N] bool valid-row mask; a filter "removes" a point by
  clearing its bit;
- ``descriptors`` {name: [N, span] float32} in insertion order
  ("normals" has span d);
- ``times``       {name: [N, span] int64} time channels (nanosecond
  stamps). The JAX package splits them into int32 pairs because it runs
  without 64-bit types; torch keeps int64 on the card.

A batch of scans is the same layout with a leading batch dimension
(``points [B, N, d]``, ``mask [B, N]``, each channel ``[B, N, span]``), the
counterpart of the JAX
package's clouds stacked for ``vmap``: the loop modules take either.

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

    __slots__ = ("points", "mask", "descriptors", "times", "_count_cache")

    def __init__(self, points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 descriptors: Optional[Mapping[str, torch.Tensor]] = None,
                 times: Optional[Mapping[str, torch.Tensor]] = None):
        if points.ndim < 2:
            raise InvalidField(f"points must be [..., N, d], got {tuple(points.shape)}")
        self.points = points.to(torch.float32)
        if mask is None:
            mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                              device=points.device)
        self.mask = mask.to(torch.bool)
        self.descriptors: Dict[str, torch.Tensor] = dict(descriptors or {})
        self.times: Dict[str, torch.Tensor] = {
            k: v.to(torch.int64) for k, v in (times or {}).items()}
        self._count_cache: Optional[int] = None

    # ------------------------------------------------------------ properties
    @property
    def num_points(self) -> int:
        """Capacity N (rows allocated, valid or not)."""
        return self.points.shape[-2]

    @property
    def dim(self) -> int:
        return self.points.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid rows (per scan of a batch), as a tensor on the
        cloud's device."""
        return self.mask.sum(dim=-1)

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

    def with_descriptor(self, name: str, value: torch.Tensor) -> "PointCloud":
        """New cloud with descriptor ``name`` set to ``value`` ([..., N] or
        [..., N, span]); an existing one keeps its place in the order."""
        if value.shape == self.mask.shape:
            value = value[..., None]
        if value.shape[:-1] != self.mask.shape:
            raise InvalidField(f"descriptor '{name}' of shape {tuple(value.shape)} "
                               f"for {self.num_points} rows")
        return self.replace(descriptors={**self.descriptors, name: value})

    # ----------------------------------------------------------------- times
    def has_time(self, name: str) -> bool:
        return name in self.times

    def get_time(self, name: str) -> torch.Tensor:
        """Time channel ``name``, int64 on the cloud's device."""
        try:
            return self.times[name]
        except KeyError:
            raise InvalidField(
                f"Missing time '{name}'; have {list(self.times)}") from None

    def with_time(self, name: str, value) -> "PointCloud":
        """New cloud with time channel ``name`` set to ``value`` (int64,
        [..., N] or [..., N, span]; a tensor or numpy)."""
        value = torch.as_tensor(value, dtype=torch.int64, device=self.device)
        if value.shape == self.mask.shape:
            value = value[..., None]
        if value.shape[:-1] != self.mask.shape:
            raise InvalidField(f"time '{name}' of shape {tuple(value.shape)} "
                               f"for {self.num_points} rows")
        return self.replace(times={**self.times, name: value})

    # ------------------------------------------------------------- structure
    def replace(self, **kw) -> "PointCloud":
        out = PointCloud(kw.get("points", self.points),
                         kw.get("mask", self.mask),
                         kw.get("descriptors", self.descriptors),
                         kw.get("times", self.times))
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
                         {k: v.to(device) for k, v in self.descriptors.items()},
                         {k: v.to(device) for k, v in self.times.items()})
        out._count_cache = self._count_cache
        return out

    def permute_rows(self, perm: torch.Tensor) -> "PointCloud":
        """The rows in the order ``perm`` (every row-aligned field
        follows)."""
        out = PointCloud(self.points[perm], self.mask[perm],
                         {k: v[perm] for k, v in self.descriptors.items()},
                         {k: v[perm] for k, v in self.times.items()})
        out._count_cache = self._count_cache
        return out

    def concatenate(self, other: "PointCloud") -> "PointCloud":
        """``other``'s rows appended (reference: DataPoints.cpp:225), on
        this cloud's device. A descriptor or time channel is kept only where
        both clouds have it with the same span, as in the JAX package."""
        if other.dim != self.dim:
            raise InvalidField("cannot concatenate clouds of different dim")
        other = other.to(self.device)

        def common(a, b):
            return {k: torch.cat([v, b[k]], dim=-2) for k, v in a.items()
                    if k in b and b[k].shape[-1] == v.shape[-1]}

        return PointCloud(torch.cat([self.points, other.points], dim=-2),
                          torch.cat([self.mask, other.mask], dim=-1),
                          common(self.descriptors, other.descriptors),
                          common(self.times, other.times))

    def compact(self) -> "PointCloud":
        """Valid rows packed to the front in their original order, at the
        exact valid count (one host sync)."""
        keep = torch.nonzero(self.mask, as_tuple=True)[0]
        return self.take_rows(keep)

    def take_rows(self, rows: torch.Tensor) -> "PointCloud":
        """All-valid cloud of the rows ``rows`` (int64 on the cloud's
        device), in that order, every channel following."""
        out = PointCloud(self.points[rows],
                         torch.ones(rows.shape[0], dtype=torch.bool,
                                    device=self.device),
                         {k: v[rows] for k, v in self.descriptors.items()},
                         {k: v[rows] for k, v in self.times.items()})
        out._count_cache = rows.shape[0]
        return out

    # -------------------------------------------------------------- numpy IO
    def host_rows(self):
        """All rows ``(points, mask)`` as numpy, valid or not: row indices
        match the tensor layout (``to_numpy`` keeps valid rows only)."""
        return self.points.cpu().numpy(), self.mask.cpu().numpy()

    def to_numpy(self, with_times: bool = False):
        """``(points[N_valid, d], {name: [N_valid, span]})`` as numpy, and
        the time channels (int64) as a third item when ``with_times``, as
        the JAX package's ``to_numpy`` returns them."""
        m = self.mask.cpu().numpy()
        pts = self.points.cpu().numpy()[m]
        descs = {k: v.cpu().numpy()[m] for k, v in self.descriptors.items()}
        if with_times:
            return pts, descs, {k: v.cpu().numpy()[m] for k, v in self.times.items()}
        return pts, descs

    @staticmethod
    def from_numpy(points, descriptors=None, device=None, *,
                   times=None) -> "PointCloud":
        """Cloud of all-valid rows on ``device`` (the card unless
        ``device="cpu"``); ``times`` {name: int [N] or [N, span]}."""
        dev = resolve_device(device)
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        descs = {}
        for k, v in (descriptors or {}).items():
            v = np.asarray(v, np.float32)
            descs[k] = torch.as_tensor(v[:, None] if v.ndim == 1 else v,
                                       device=dev)
        tms = {}
        for k, v in (times or {}).items():
            v = np.asarray(v, np.int64)
            tms[k] = torch.as_tensor(v[:, None] if v.ndim == 1 else v, device=dev)
        out = PointCloud(pts, None, descs, tms)
        out._count_cache = pts.shape[0]
        return out

    def __repr__(self):
        labels = tuple((k, v.shape[-1]) for k, v in self.descriptors.items())
        times = tuple((k, v.shape[-1]) for k, v in self.times.items())
        return (f"PointCloud(N={self.num_points}, dim={self.dim}, "
                f"device={self.device}, descriptors={labels}, times={times})")
