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

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .errors import InvalidField

__all__ = ["PointCloud", "bucket_size", "split_int64", "merge_int64"]


def split_int64(arr) -> np.ndarray:
    """int64 [N, k] → int32 [N, 2k], (high, low) interleaved: the JAX
    package's device layout of a time channel (its ``cloud.split_int64``),
    for converting to and from it; the port keeps int64."""
    arr = np.asarray(arr, dtype=np.int64)
    out = np.empty((arr.shape[0], arr.shape[1] * 2), np.int32)
    out[:, 0::2] = (arr >> 32).astype(np.int32)
    out[:, 1::2] = (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return out


def merge_int64(arr) -> np.ndarray:
    """int32 [N, 2k], (high, low) interleaved → int64 [N, k]: the inverse
    of :func:`split_int64`."""
    arr = np.asarray(arr, dtype=np.int32)
    hi = arr[:, 0::2].astype(np.int64)
    lo = arr[:, 1::2].view(np.uint32).astype(np.int64)
    return (hi << 32) | lo


def bucket_size(n: int, granule: int = 256) -> int:
    """``n`` rounded up on the 1-1.5-2 ladder (granule, 1.5·granule,
    2·granule, 3·granule, …): the JAX package's ``cloud.bucket_size``. The
    port compacts to exact counts; the ladder sizes the tile and block axes
    of an assignment and gives the row counts at which the JAX package
    holds a cloud, for thresholds on a cloud's size."""
    if n <= granule:
        return granule
    p = granule * (2 ** math.floor(math.log2(n / granule)))
    if n <= p:
        return p
    if n <= (p * 3) // 2:
        return (p * 3) // 2
    return 2 * p


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

    def without_descriptor(self, name: str) -> "PointCloud":
        """New cloud without descriptor ``name`` (no error if absent)."""
        return self.replace(descriptors={k: v for k, v in self.descriptors.items()
                                         if k != name})

    def descriptor_labels(self) -> Tuple[Tuple[str, int], ...]:
        """``((name, span), ...)`` of the descriptors, in order."""
        return tuple((k, int(v.shape[-1])) for k, v in self.descriptors.items())

    # ----------------------------------------------------------------- times
    def time_labels(self) -> Tuple[Tuple[str, int], ...]:
        """``((name, span), ...)`` of the time channels, each span the
        logical one (the port holds int64, so it is not halved as the JAX
        package's split layout is)."""
        return tuple((k, int(v.shape[-1])) for k, v in self.times.items())

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

    def create_similar_empty(self, n: Optional[int] = None) -> "PointCloud":
        """Cloud of ``n`` rows (default: this capacity) with the same
        channels, spans, types and device, every row invalid (reference:
        DataPoints.cpp:339)."""
        n = self.num_points if n is None else n

        def zeros(v):
            return torch.zeros((n, v.shape[-1]), dtype=v.dtype, device=v.device)

        out = PointCloud(zeros(self.points),
                         torch.zeros(n, dtype=torch.bool, device=self.device),
                         {k: zeros(v) for k, v in self.descriptors.items()},
                         {k: zeros(v) for k, v in self.times.items()})
        out._count_cache = 0
        return out

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
        return (f"PointCloud(N={self.num_points}, dim={self.dim}, "
                f"device={self.device}, descriptors={self.descriptor_labels()}, "
                f"times={self.time_labels()})")
