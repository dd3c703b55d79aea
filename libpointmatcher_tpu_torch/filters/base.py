"""Filter interface and chain semantics (counterpart of
``libpointmatcher_tpu.filters.base``; reference: PointMatcher.h:437-467,
DataPointsFilter.cpp:106-131).

Filters are functions on masked clouds. A chain applies them in order,
compacts after each one, logs the surviving count and raises
``ConvergenceError`` when a filter leaves no point.

Random draws come from explicit ``torch.Generator``s, one per filter of a
chain, seeded from ``(seed, stream, position in the chain)``: the engine
gives the reference chain stream 1 and the reading chain stream 2, as the
JAX package folds 1 and 2 into its key. In batch serving each scan's chain
draws from generators of its own, seeded with the scan's index as well. A
filter that draws also takes a precomputed ``uniform`` draw, which replaces
its own: one value in [0, 1) per row, or ``[B, rows]`` for a batch, of
which scan i takes the first values of row i (the draw over a batch's
stacked rows). The parity tests hand it the JAX package's draws that way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..cloud import PointCloud
from ..errors import ConvergenceError
from ..loggers import log_info
from ..registry import Parametrizable, Registrar

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar",
           "apply_filter_chain", "chain_generator"]

DataPointsFilterRegistrar = Registrar("DataPointsFilter")


def chain_generator(seed: int, stream: int, index: int, device,
                    scan: Optional[int] = None) -> torch.Generator:
    """The generator of the ``index``-th filter of chain ``stream`` (of
    scan ``scan`` of a batch)."""
    entropy = [seed, stream, index] + ([] if scan is None else [scan])
    state = np.random.SeedSequence(entropy).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class DataPointsFilter(Parametrizable):
    """Interface (reference: PointMatcher.h:437-450)."""

    #: True for a per-row rule on the cloud's device with no host step: the
    #: JAX package's ``TRACEABLE`` filters, the ones its queue serves
    #: (see ``parallel.stream.queue_eligible``)
    TRACEABLE = False

    def __init__(self, params=None):
        super().__init__(params)
        #: optional precomputed draw, one value per row of the next input
        self.uniform: Optional[torch.Tensor] = None

    def filter(self, cloud: PointCloud,
               generator: Optional[torch.Generator] = None,
               scan: Optional[int] = None) -> PointCloud:
        raise NotImplementedError

    def draw_uniform(self, cloud: PointCloud,
                     generator: Optional[torch.Generator],
                     scan: Optional[int] = None) -> torch.Tensor:
        """One value in [0, 1) per row: the precomputed ``uniform`` if set
        (row ``scan`` of a ``[B, rows]`` one), else a draw from
        ``generator`` (seed 0 when none is given)."""
        n = cloud.num_points
        if self.uniform is not None:
            u = self.uniform
            if not isinstance(u, torch.Tensor):
                u = torch.from_numpy(np.array(u, np.float32))
            u = u.to(device=cloud.device, dtype=torch.float32)
            if u.ndim == 2 and scan is not None and u.shape[1] >= n:
                u = u[scan, :n]
            if u.shape != (n,):
                raise ValueError(f"{type(self).__name__}.uniform has shape "
                                 f"{tuple(u.shape)}, the cloud has {n} rows")
            return u
        if generator is None:
            generator = torch.Generator(device=cloud.device).manual_seed(0)
        return torch.rand(n, generator=generator, device=cloud.device)


def apply_filter_chain(filters: Sequence[DataPointsFilter], cloud: PointCloud,
                       seed: int = 0, stream: int = 0,
                       scan: Optional[int] = None,
                       allow_empty: bool = False,
                       compact: bool = True) -> PointCloud:
    """Apply ``filters`` in order, compacting after each unless
    ``compact`` is False (the tile route keeps the raw rows, which its
    assignment addresses). A filter that leaves no point raises
    ``ConvergenceError``, unless ``allow_empty``: in serving, the emptied
    scan goes on to the loop and stops there with the no-inliers code, as
    in the JAX package's serving functions."""
    before = None
    for i, f in enumerate(filters):
        gen = chain_generator(seed, stream, i, cloud.device, scan)
        cloud = f.filter(cloud, generator=gen, scan=scan)
        if compact:
            cloud = cloud.compact()
        after = cloud.count_host()
        log_info(f"Applied {type(f).__name__} - {after} points remaining"
                 + (f" (of {before})" if before is not None else ""))
        before = after
        if after == 0 and not allow_empty:
            raise ConvergenceError(
                f"no points remaining after filter {type(f).__name__}")
    return cloud
