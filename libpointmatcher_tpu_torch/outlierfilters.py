"""Outlier filters: match distances → per-pair weights (counterpart of
``libpointmatcher_tpu.outlierfilters``; reference: PointMatcher.h:496-525,
OutlierFiltersImpl.{h,cpp}). Weight 0 rejects a pair; a chain multiplies the
weights of its filters (OutlierFilter.cpp:88-97); an empty chain zeroes only
the infinite-distance pairs (OutlierFilter.cpp:68-83). Matches are
``[N, knn]``, or ``[B, N, knn]`` for a batch of scans, each filtered on its
own."""

from __future__ import annotations

import torch

from .registry import Param, Parametrizable, Registrar
from .utils.masked import masked_quantile

__all__ = ["OutlierFilter", "OutlierFilterRegistrar", "TrimmedDistOutlierFilter",
           "compute_outlier_weights"]

OutlierFilterRegistrar = Registrar("OutlierFilter")


class OutlierFilter(Parametrizable):
    """Interface (reference: PointMatcher.h:496-525)."""

    def compute(self, reading, reference, matches) -> torch.Tensor:
        raise NotImplementedError


def compute_outlier_weights(filters, reading, reference, matches) -> torch.Tensor:
    """Chain semantics (reference: OutlierFilter.cpp:63-97) → [N, knn]."""
    if not filters:
        return torch.isfinite(matches.dists).to(torch.float32)
    w = torch.ones_like(matches.dists)
    for f in filters:
        w = w * f.compute(reading, reference, matches)
    return w


@OutlierFilterRegistrar.register
class TrimmedDistOutlierFilter(OutlierFilter):
    """Keeps the best ``ratio`` fraction of matches by distance
    (reference: OutlierFiltersImpl.cpp:132-147; the default chain's filter,
    ICP.cpp:107)."""

    PARAMS = (
        Param("ratio", "fraction of matches to keep (by increasing distance)",
              float, 0.85, min=0.0000001, max=1.0),
    )

    def compute(self, reading, reference, matches):
        batch_dims = matches.dists.ndim - 2
        limit = masked_quantile(matches.dists, self.ratio, batch_dims)
        return (matches.dists <= limit[..., None, None]).to(torch.float32)
