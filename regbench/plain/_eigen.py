"""Normals from 3x3 covariances for the plain normal filters."""

from __future__ import annotations

import torch


def normals_of(C: torch.Tensor):
    """Covariances [B, 3, 3] → (normal [B, 3], cond [B], degenerate [B]):
    the eigenvector of the smallest eigenvalue; cond the gap of the two
    smallest eigenvalues over the largest (how far rounding can turn the
    normal); degenerate where the second eigenvalue is at most 1e-9 of the
    largest (rank below 2: upstream zeroes or drops such a normal)."""
    # cuSOLVER's batched eigh refuses batches of 10^5 matrices: slices
    ev, V = (torch.cat(x) for x in zip(*(
        torch.linalg.eigh(0.5 * (c + c.transpose(1, 2)))
        for c in torch.split(C, 16384))))
    lam_max = torch.clamp(ev[:, 2], min=1e-30)
    degenerate = ev[:, 1] <= lam_max * 1e-9
    cond = (ev[:, 1] - ev[:, 0]) / lam_max
    return V[:, :, 0], cond, degenerate
