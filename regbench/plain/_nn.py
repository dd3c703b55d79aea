"""Brute-force nearest neighbours for the plain modules: every query
against every reference row, in blocks of queries, in the context's dtype.
Distances are formed as |q|² + |r|² − 2 q·r (a matrix product, so the
control's TF32 reaches it) to pick the candidates, and the winners' squared
distances are then formed again as the sum of squared differences."""

from __future__ import annotations

import torch


def _block(m: int) -> int:
    # about 2^28 distances a block: 2 GiB in float64
    return max(1, min(65536, (1 << 28) // max(m, 1)))


def knn(q: torch.Tensor, r: torch.Tensor, k: int, ctx):
    """The ``k`` nearest rows of ``r`` for each row of ``q`` → (d2 [Q, k]
    ascending, ids [Q, k])."""
    rn = (r * r).sum(1)
    out_d, out_i = [], []
    step = _block(r.shape[0])
    k = min(k, r.shape[0])
    for s in range(0, q.shape[0], step):
        qc = q[s:s + step]
        d2 = (qc * qc).sum(1)[:, None] + rn[None, :] - 2.0 * ctx.mm(qc, r.T)
        _, ids = torch.topk(d2, k, dim=1, largest=False)
        exact = ((qc[:, None, :] - r[ids]) ** 2).sum(-1)
        exact, order = torch.sort(exact, dim=1, stable=True)
        out_d.append(exact)
        out_i.append(torch.gather(ids, 1, order))
    return torch.cat(out_d), torch.cat(out_i)


def nn1(q: torch.Tensor, r: torch.Tensor, max_dist: float, ctx):
    """Each query's nearest row of ``r`` within ``max_dist`` (+inf, -1
    where none lies within it) → (d2 [Q], ids [Q])."""
    d2, ids = knn(q, r, 1, ctx)
    d2, ids = d2[:, 0], ids[:, 0]
    if max_dist != float("inf"):
        far = d2 > max_dist * max_dist
        d2 = torch.where(far, torch.full_like(d2, float("inf")), d2)
        ids = torch.where(far, torch.full_like(ids, -1), ids)
    return d2, ids
