"""Median-split boxes with a normal each, then a random subsample (upstream
DataPointsFilters/SamplingSurfaceNormal.cpp, the default map filter).

A box of more than ``knn`` points is cut at the median of its largest
extent: the first n − n//2 points in the order of that coordinate go left
(upstream's ``nth_element`` leaves ties in any order; here a stable sort
keeps them in the order the box received them, rows first in cloud
order). Each leaf box's covariance gives the normal of all its points; a
box whose covariance has rank below 2 is dropped. A point stays where its
draw lies under ``ratio`` (``samplingMethod`` 0)."""

from __future__ import annotations

import numpy as np
import torch

from ._eigen import normals_of


def boxes(points: np.ndarray, knn: int) -> np.ndarray:
    """A leaf-box id per row."""
    n = len(points)
    box = np.zeros(n, np.int64)
    stack = [np.arange(n)]
    next_id = 0
    while stack:
        rows = stack.pop()
        if len(rows) <= knn:
            box[rows] = next_id
            next_id += 1
            continue
        sub = points[rows]
        dim = int(np.argmax(sub.max(0) - sub.min(0)))
        rows = rows[np.argsort(sub[:, dim], kind="stable")]
        left = len(rows) - len(rows) // 2
        stack.append(rows[left:])
        stack.append(rows[:left])
    return box


def filter(points, params, draw, ctx):
    if int(params.get("samplingMethod", 0)) != 0:
        raise ValueError("the plain SamplingSurfaceNormal serves samplingMethod 0")
    if float(params.get("maxBoxDim", "inf")) != float("inf"):
        raise ValueError("the plain SamplingSurfaceNormal serves maxBoxDim inf")
    knn = int(params.get("knn", 7))
    ratio = float(params.get("ratio", 0.5))
    host = points.detach().cpu().numpy().astype(np.float64)
    box = torch.as_tensor(boxes(host, knn), device=points.device)
    nb = int(box.max()) + 1
    cnt = torch.zeros(nb, dtype=points.dtype, device=points.device).index_add_(
        0, box, torch.ones_like(points[:, 0]))
    mean = torch.zeros(nb, 3, dtype=points.dtype, device=points.device
                       ).index_add_(0, box, points) / cnt[:, None]
    c = points - mean[box]
    # each box's covariance as one small product, so a lower matrix
    # precision reaches it: rows sorted by box, padded to knn rows a box
    order = torch.argsort(box, stable=True)
    start = torch.zeros(nb + 1, dtype=torch.int64, device=points.device)
    start[1:] = torch.cumsum(cnt.to(torch.int64), 0)
    slot = torch.arange(len(box), device=points.device) - start[box[order]]
    P = torch.zeros(nb, knn, 3, dtype=points.dtype, device=points.device)
    P[box[order], slot] = c[order]
    C = ctx.mm(P.transpose(1, 2), P)
    normal, cond, degenerate = normals_of(C)
    keep = (draw.to(points.device) < ratio) & ~degenerate[box]
    return {"keep": keep, "normals": normal[box], "cond": cond[box]}
