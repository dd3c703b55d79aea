"""Morton (Z-order) row orders for the survivor sweep (the port's copy of
the Morton helpers of ``libpointmatcher_tpu.ops.knn_skip``).

The map is sorted once per map on the host, each scan once per registration
on its device, so that every 128-row chunk of the map and every tile of
queries is spatially tight. Valid rows are ordered by their 30-bit code of
3 x 10 bits, invalid rows last, ties by row index (a stable sort). Each
axis is quantised in float32 in one order, ``(p − lo) / span · 1023``, then
clipped to [0, 1023] and truncated, with ``lo`` and ``span`` over the valid
rows: the host and the device orders, and the JAX package's, are the same.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import telemetry

__all__ = ["morton_argsort", "morton_argsort_batch", "morton_argsort_device"]

_BITS = 10
_SCALE = (1 << _BITS) - 1
_INVALID = 0xFFFFFFFF


def _spread_table() -> np.ndarray:
    """10-bit value → its bits spread to every third bit."""
    v = np.arange(1 << _BITS, dtype=np.uint32)
    out = np.zeros_like(v)
    for b in range(_BITS):
        out |= ((v >> np.uint32(b)) & np.uint32(1)) << np.uint32(3 * b)
    return out


_SPREAD = _spread_table()


def morton_argsort_batch(pts_b, mask_b) -> np.ndarray:
    """Host: ``pts_b [b, n, d]``, ``mask_b [b, n]`` → orders ``[b, n]``
    int32 (per scan: valid rows by Morton code, invalid rows last, stable)."""
    pts = np.asarray(pts_b, np.float32)
    mask = np.asarray(mask_b, bool)
    b, n, d = pts.shape
    masked = np.where(mask[..., None], pts, np.nan)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nanmin(masked, axis=1, keepdims=True)
        span = np.nanmax(masked, axis=1, keepdims=True) - lo
    lo = np.where(np.isnan(lo), np.float32(0.0), lo)
    span = np.where(np.isnan(span), np.float32(1.0),
                    np.maximum(span, np.float32(1e-9)))
    q = np.clip((pts - lo) / span * _SCALE, 0, _SCALE).astype(np.uint32)
    code = np.zeros((b, n), np.uint32)
    for a in range(min(d, 3)):
        code |= _SPREAD[q[..., a]] << np.uint32(a)
    code = np.where(mask, code, np.uint32(_INVALID))
    return np.argsort(code, axis=1, kind="stable").astype(np.int32)


def morton_argsort(pts, mask) -> tuple:
    """Host: one cloud → ``(order, inverse)``, int32 [n] each."""
    order = morton_argsort_batch(np.asarray(pts)[None],
                                 np.asarray(mask, bool)[None])[0]
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order), dtype=np.int32)
    return order, inverse


def morton_argsort_device(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """On the cloud's device: ``pts [n, d]``, ``mask [n]`` → order [n]
    int64, the same order as :func:`morton_argsort`."""
    n, d = pts.shape
    telemetry.sync(pts.device, copy=True)
    inf = torch.tensor(float("inf"), device=pts.device)
    lo = torch.where(mask[:, None], pts, inf).amin(dim=0)
    hi = torch.where(mask[:, None], pts, -inf).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    span = hi - lo
    span = torch.where(torch.isfinite(span), torch.clamp(span, min=1e-9),
                       torch.ones_like(span))
    q = torch.clamp((pts - lo) / span * float(_SCALE), 0.0, float(_SCALE))
    q = q.to(torch.int64)
    code = torch.zeros(n, dtype=torch.int64, device=pts.device)
    for b in range(_BITS):
        for a in range(min(d, 3)):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    code = torch.where(mask, code, torch.full_like(code, _INVALID))
    return torch.sort(code, stable=True).indices
