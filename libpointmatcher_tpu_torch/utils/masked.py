"""Order statistics over the finite entries of a tensor
(the counterpart of ``libpointmatcher_tpu.utils.masked``; reference:
Matches.cpp:61-129, where invalid matches carry +inf).

Each function reduces over everything past the first ``batch_dims``
dimensions and returns one value per batch entry, as the JAX functions do
under ``vmap``."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["masked_quantile", "masked_median", "masked_mad", "masked_std"]


def _flatten_finite(values: torch.Tensor, batch_dims: int):
    flat = values.reshape(*values.shape[:batch_dims], -1)
    return flat, torch.isfinite(flat)


def _select_rank(flat, finite, idx):
    """The ``idx``-th smallest finite entry (``idx`` int64, one per batch
    entry). The JAX package selects by a radix rank-select because sorts
    are slow on the TPU. Here a sort of the entries, with the non-finite
    ones set to +inf, indexed by a rank held on the device, returns the
    same element bit for bit with no host sync (``torch.kthvalue`` would
    need the rank on the host)."""
    keyed = torch.where(finite, flat, torch.full_like(flat, float("inf")))
    ordered = torch.sort(keyed, dim=-1).values
    return torch.gather(ordered, -1, idx[..., None])[..., 0]


def masked_quantile(values: torch.Tensor, q: Union[float, torch.Tensor],
                    batch_dims: int = 0) -> torch.Tensor:
    """Element at ascending index ``floor(n·q)`` of the ``n`` finite
    entries (nth_element, Matches.cpp:85-86), q == 1 meaning the maximum.
    ``q`` is a float or a float32 tensor with one value per batch entry
    (VarTrimmedDist's ratio); ``n·q`` is formed in float32, as the JAX
    package forms it."""
    flat, finite = _flatten_finite(values, batch_dims)
    n = finite.sum(dim=-1).to(torch.int32)
    idx = torch.floor(n.to(torch.float32) * q).to(torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(n.to(torch.int64) - 1, min=0))
    return _select_rank(flat, finite, idx)


def masked_median(values: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """The reference's median: the element at index n/2 (Matches.cpp:109-121)."""
    flat, finite = _flatten_finite(values, batch_dims)
    n = finite.sum(dim=-1).to(torch.int64)
    idx = torch.minimum(n // 2, torch.clamp(n - 1, min=0))
    return _select_rank(flat, finite, idx)


def masked_mad(values: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Median absolute deviation, reference convention (Matches.cpp:91-122)."""
    flat, finite = _flatten_finite(values, batch_dims)
    med = masked_median(values, batch_dims)
    dev = torch.where(finite, torch.abs(flat - med[..., None]),
                      torch.full_like(flat, float("inf")))
    return masked_median(dev, batch_dims)


def masked_std(values: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Sample standard deviation over the finite entries, with the JAX
    package's ``n = max(count, 2)`` and ``/(n − 1)`` (Matches.cpp:125-129
    computes it over every entry; with knn = 1 and no maxDist the two
    agree)."""
    flat, finite = _flatten_finite(values, batch_dims)
    n = torch.clamp(finite.sum(dim=-1), min=2).to(torch.float32)
    vals = torch.where(finite, flat, torch.zeros_like(flat))
    mean = vals.sum(dim=-1) / n
    sq = torch.where(finite, (flat - mean[..., None]) ** 2, torch.zeros_like(flat))
    return torch.sqrt(sq.sum(dim=-1) / (n - 1.0))
