"""Keep the matches whose squared distance is at most the one at ascending
index floor(n·ratio) of the n finite ones (upstream
OutlierFiltersImpl.cpp TrimmedDist and Matches::getDistsQuantile, whose
index is formed in float32)."""

import numpy as np
import torch


def weights(d2, params, ctx):
    ratio = float(params.get("ratio", 0.85))
    finite = torch.isfinite(d2)
    n = int(finite.sum())
    if n == 0:
        return torch.zeros_like(d2)
    idx = int(np.floor(np.float32(n) * np.float32(ratio)))
    idx = min(max(idx, 0), n - 1)
    limit = torch.sort(d2[finite]).values[idx]
    return ((d2 <= limit) & finite).to(d2.dtype)
