"""Exact k-NN as a tiled torch sweep: the plain version of the K1 and K5
kernels and the CPU path (counterpart of ``libpointmatcher_tpu.ops.knn``).

For each tile of reference rows it forms the squared distances in the exact
float32 difference form, in one fixed order,
``d² = ((pen + dx²) + dy²) + dz²`` with ``pen = +inf`` at masked reference
rows, then folds the tile into a running top-k. Every step is a separate
rounded torch operation, so the hand-written kernels, which round each step
the same way, agree with it bit for bit. The expansion form
‖q‖²+‖r‖²−2q·r is not used: it cancels catastrophically at scene scale.

Ties go to the lowest reference index. Invalid queries and missing
neighbours get (+inf, −1) (reference: PointMatcher.h:377-378).
"""

from __future__ import annotations

import torch

__all__ = ["knn_brute_force"]

TILE_M = 4096


def _ref_penalty(ref_mask: torch.Tensor) -> torch.Tensor:
    """0 at valid reference rows, +inf at masked ones."""
    zero = torch.zeros(ref_mask.shape, dtype=torch.float32, device=ref_mask.device)
    return torch.where(ref_mask, zero, torch.full_like(zero, float("inf")))


def _tile_d2(query: torch.Tensor, ref_t: torch.Tensor, pen_t: torch.Tensor):
    d2 = None
    for c in range(query.shape[1]):
        diff = query[:, c, None] - ref_t[None, :, c]
        d2 = (pen_t[None, :] if d2 is None else d2) + diff * diff
    return d2


def knn_brute_force(query: torch.Tensor, query_mask: torch.Tensor,
                    ref: torch.Tensor, ref_mask: torch.Tensor, k: int = 1,
                    tile_m: int = TILE_M):
    """Exact kNN of ``query`` [N, d] into ``ref`` [M, d] →
    ``(dists2 [N, k], ids [N, k])``, ascending per row. With a pair axis,
    ``query`` [B, N, d] into ``ref`` [B, M, d], each pair searched on its
    own → ``[B, N, k]``."""
    if query.ndim == 3:
        d, i = zip(*(knn_brute_force(*a, k=k, tile_m=tile_m)
                     for a in zip(query, query_mask, ref, ref_mask)))
        return torch.stack(d), torch.stack(i)
    n = query.shape[0]
    m = ref.shape[0]
    dev = query.device
    inf = float("inf")
    best_d = torch.full((n, k), inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    pen = _ref_penalty(ref_mask)
    for t0 in range(0, m, tile_m):
        t1 = min(m, t0 + tile_m)
        d2 = _tile_d2(query, ref[t0:t1], pen[t0:t1])
        if k == 1:
            ti = torch.argmin(d2, dim=1, keepdim=True)   # first of equal minima
            td = torch.gather(d2, 1, ti)
            take = td < best_d                           # earlier tile wins ties
            best_d = torch.where(take, td, best_d)
            best_i = torch.where(take, ti + t0, best_i)
        else:
            gid = torch.arange(t0, t1, device=dev).expand(n, -1)
            md = torch.cat([best_d, d2], dim=1)
            mi = torch.cat([best_i, gid], dim=1)
            # stable: among equal distances the running entries (lower ids)
            # stay ahead of this tile's, and this tile's stay in id order
            md, pos = torch.sort(md, dim=1, stable=True)
            best_d = md[:, :k]
            best_i = torch.gather(mi, 1, pos[:, :k])
    ok = torch.isfinite(best_d) & query_mask[:, None]
    best_d = torch.where(query_mask[:, None], best_d, torch.full_like(best_d, inf))
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    return best_d, best_i.to(torch.int32)
