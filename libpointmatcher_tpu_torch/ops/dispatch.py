"""One entry point for the exact k-NN search (counterpart of
``libpointmatcher_tpu.ops.dispatch``), routed as the JAX package routes it:

- k = 1, ε < MXU_EPSILON_FLOOR → K1 (exact difference form);
- k = 1, ε ≥ MXU_EPSILON_FLOOR → K9 (expansion form, (1+ε)-exact);
- 2 ≤ k ≤ KNNK_MAX             → K5;
- k > KNNK_MAX                 → the plain tiled sweep.

The device comes from the tensors: on CUDA tensors each route launches its
hand-written kernel, on CPU tensors it runs that kernel's plain version.
Results follow the invalid conventions dist = +inf, id = −1
(reference: PointMatcher.h:377-378).
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import knn_brute_force
from .knn_cuda import KNNK_MAX, knn1, knn1_mxu, knnk

__all__ = ["knn_search", "apply_max_dist", "radius2", "MXU_EPSILON_FLOOR"]

#: ε from which K9 serves the (1+ε) contract of libnabo's approximate
#: search (reference: MatchersImpl.cpp:86-101): the exact distance of K9's
#: neighbour is at most (1+ε) times the optimum. K9's rounding error is
#: absolute, about 2^-20·(q²+r²), so near-coincident points make its
#: relative excess large: chip_smoke.py measured up to 0.89 on registration
#: data on an H100, far above the JAX package's 1e-5 floor (which rests on
#: sparse uniform data, tools/knn_micro.py). The floor is 10x the measured
#: excess, the JAX package's own margin; chip_smoke.py re-measures the
#: excess and fails if it reaches the floor.
MXU_EPSILON_FLOOR = 10.0


def knn_search(query, query_mask, ref, ref_mask, k: int = 1,
               epsilon: float = 0.0):
    """kNN of ``query`` [N, d] into ``ref`` [M, d] → ``(dists2, ids)``,
    both [N, k], squared distances ascending, (+inf, −1) invalid. With a
    pair axis (``query`` [B, N, d], ``ref`` [B, M, d]) each pair searches
    its own reference, in one launch → [B, N, k]."""
    if k == 1:
        fn = knn1_mxu if epsilon >= MXU_EPSILON_FLOOR else knn1
        d, i = fn(query, query_mask, ref, ref_mask)
        return d[..., None], i[..., None]
    if k <= KNNK_MAX:
        return knnk(query, query_mask, ref, ref_mask, k)
    return knn_brute_force(query, query_mask, ref, ref_mask, k=k)


def radius2(max_dist: float) -> float:
    """``max_dist``² in float32, as the JAX package squares it."""
    return float(np.float32(max_dist) * np.float32(max_dist))


def apply_max_dist(dists, ids, max_dist: float):
    """k-NN results beyond ``max_dist`` made invalid (+inf, −1)."""
    if max_dist == float("inf"):
        return dists, ids
    keep = dists <= radius2(max_dist)
    return torch.where(keep, dists, float("inf")), torch.where(keep, ids, -1)
