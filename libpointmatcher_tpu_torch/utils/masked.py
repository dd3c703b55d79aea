"""Order statistics over the finite entries of a tensor
(the counterpart of ``libpointmatcher_tpu.utils.masked``; reference:
Matches.cpp:61-129, where invalid matches carry +inf)."""

from __future__ import annotations

import torch

__all__ = ["masked_quantile"]


def masked_quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """Element at ascending index ``floor(n·q)`` of the ``n`` finite
    entries (nth_element, Matches.cpp:85-86), q == 1 meaning the maximum.

    ``n·q`` is formed in float32, as the JAX package forms it. The JAX
    package selects by a radix rank-select because sorts are slow on the
    TPU. Here a sort of the entries, with the non-finite ones set to +inf,
    indexed by a rank held on the device, returns the same element bit for
    bit with no host sync (``torch.kthvalue`` would need the rank on the
    host)."""
    flat = values.reshape(-1)
    finite = torch.isfinite(flat)
    n = finite.sum().to(torch.int32)
    idx = torch.floor(n.to(torch.float32) * q).to(torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(n.to(torch.int64) - 1, min=0))
    keyed = torch.where(finite, flat, torch.full_like(flat, float("inf")))
    ordered = torch.sort(keyed).values
    return ordered[idx]
