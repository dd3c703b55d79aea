"""Filter interface and chain semantics (counterpart of
``libpointmatcher_tpu.filters.base``; reference: PointMatcher.h:437-467,
DataPointsFilter.cpp:106-131).

Filters are functions on masked clouds. A chain applies them in order,
compacts after each one, logs the surviving count and raises
``ConvergenceError`` when a filter leaves no point.

Random draws are JAX's (``utils/prng.py``): a chain takes one key, and
filter i draws from ``fold_in(key, i)``, as in the JAX package
(``filters/base.py``). The drivers form the chain keys as the JAX package
does (``icp.py``, ``parallel/batch.py``). A batch passes
:class:`ScanKeys`, its scans' chain keys, whose draws are formed for every
scan in one pass. A filter with no key draws from ``PRNGKey(0)``. A filter
that draws also takes a precomputed ``uniform`` draw, which replaces its
own: one value in [0, 1) per row, or ``[B, rows]`` for a batch, of which
scan i takes the first values of row i (the draw over a batch's stacked
rows). Tests pin a draw that way.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import telemetry
from ..cloud import PointCloud
from ..errors import ConvergenceError
from ..loggers import log_info
from ..registry import Parametrizable, Registrar
from ..utils import prng

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar",
           "apply_filter_chain", "chain_is_traceable", "ScanKeys", "key_word"]

DataPointsFilterRegistrar = Registrar("DataPointsFilter")


class ScanKeys:
    """The chain keys of a batch's scans, one per scan, in scan order.

    ``fold_in(i)`` gives the keys of every scan's i-th filter (kept, so
    each scan's chain reaches the same object). ``uniform(scan, n)`` is
    scan ``scan``'s draw of n values: the first time, the draws of every
    scan are formed together over ``rows`` counters on ``device``, one pass
    of a few hundred small operations for the whole batch. Threefry draws
    are prefix-stable, so a scan of n ≤ ``rows`` rows takes the first n
    values of its row."""

    def __init__(self, keys: Sequence[prng.Key], rows: int, device):
        self.keys = list(keys)
        self.rows = int(rows)
        self.device = device
        self._children: Dict[int, "ScanKeys"] = {}
        self._draws: Optional[torch.Tensor] = None

    def fold_in(self, data: int) -> "ScanKeys":
        if data not in self._children:
            self._children[data] = ScanKeys(
                [prng.fold_in(k, data) for k in self.keys], self.rows,
                self.device)
        return self._children[data]

    def draws(self) -> torch.Tensor:
        """Every scan's draw → float32 ``[B, rows]``."""
        if self._draws is None:
            k0, k1 = (torch.tensor([k[j] for k in self.keys], dtype=torch.int64)
                      for j in (0, 1))
            telemetry.sync(torch.device(self.device), 2, copy=True)
            self._draws = prng.uniform((k0, k1), self.rows, self.device)
        return self._draws

    def uniform(self, scan: int, n: int) -> torch.Tensor:
        if n > self.rows:
            self.rows, self._draws = n, None
        return self.draws()[scan, :n]


ChainKey = Union[prng.Key, ScanKeys]


def key_word(key: Optional[ChainKey], scan: Optional[int] = None) -> int:
    """The key's second word (scan ``scan``'s of a :class:`ScanKeys`;
    ``PRNGKey(0)``'s, 0, with no key): the seed of the JAX filters that
    draw with numpy, ``key_data(key)[-1]`` (OctreeGrid, Gestalt)."""
    if key is None:
        key = prng.prng_key(0)
    elif isinstance(key, ScanKeys):
        key = key.keys[scan]
    return int(key[1])


class DataPointsFilter(Parametrizable):
    """Interface (reference: PointMatcher.h:437-450)."""

    #: True for a per-row rule on the cloud's device with no host step: the
    #: JAX package's ``TRACEABLE`` filters, the ones its queue serves
    #: (see ``parallel.stream.queue_eligible``)
    TRACEABLE = False

    #: True for a filter whose JAX counterpart splits into a host structure
    #: step and a traced tail (its ``HOST_PREP``, SamplingSurfaceNormal's):
    #: the JAX one-shot runs a reference chain headed by one in one program
    HOST_PREP = False

    #: True when the filter's effect at each ICP iteration, as a reading
    #: step filter, is a function of the cloud and the iteration alone
    #: (:meth:`mask_at_iteration`): the engine's loop then applies it in
    #: each step; a step chain with any other filter takes the stepped
    #: driver (the JAX package's ``SCHEDULE_TRACEABLE``)
    SCHEDULE_TRACEABLE = False

    def __init__(self, params=None):
        super().__init__(params)
        #: optional precomputed draw, one value per row of the next input
        self.uniform: Optional[torch.Tensor] = None

    def init(self) -> None:
        """Reset the per-registration state (reference:
        DataPointsFilter::init; only FixStepSampling's schedule has one)."""

    def mask_at_iteration(self, cloud: PointCloud, iteration) -> PointCloud:
        """The cloud this filter passes to iteration ``iteration`` (an int,
        or one per scan of a batch), as a mask shrink (see
        ``SCHEDULE_TRACEABLE``)."""
        raise NotImplementedError

    def filter(self, cloud: PointCloud, key: Optional[ChainKey] = None,
               scan: Optional[int] = None) -> PointCloud:
        raise NotImplementedError

    def draw_uniform(self, cloud: PointCloud, key: Optional[ChainKey],
                     scan: Optional[int] = None) -> torch.Tensor:
        """One value in [0, 1) per row: the precomputed ``uniform`` if set
        (row ``scan`` of a ``[B, rows]`` one), else JAX's draw from ``key``
        (scan ``scan``'s of a :class:`ScanKeys`; ``PRNGKey(0)`` when no key
        is given, as in the JAX filters)."""
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
        if isinstance(key, ScanKeys):
            return key.uniform(scan, n)
        return prng.uniform(prng.prng_key(0) if key is None else key, n,
                            cloud.device)


def chain_is_traceable(filters: Sequence[DataPointsFilter]) -> bool:
    return all(f.TRACEABLE for f in filters)


def apply_filter_chain(filters: Sequence[DataPointsFilter], cloud: PointCloud,
                       key: Optional[ChainKey] = None,
                       scan: Optional[int] = None,
                       allow_empty: bool = False,
                       compact: bool = True,
                       traced: bool = False) -> PointCloud:
    """Apply ``filters`` in order, filter i drawing from ``fold_in(key,
    i)`` (scan ``scan``'s of :class:`ScanKeys`), compacting after each unless
    ``compact`` is False (the tile route keeps the raw rows, which its
    assignment addresses). With ``traced``, the rows are compacted once,
    after the last filter: the JAX package's one-program engines apply a
    ``TRACEABLE`` chain so (``apply_filter_chain_traced``), and a draw then
    falls on the rows the chain was given, not on the survivors of the
    filters before it. A filter that leaves no point raises
    ``ConvergenceError``, unless ``allow_empty``: in serving, the emptied
    scan goes on to the loop and stops there with the no-inliers code, as
    in the JAX package's serving functions."""
    before = None
    for i, f in enumerate(filters):
        sub = None
        if isinstance(key, ScanKeys):
            sub = key.fold_in(i)
        elif key is not None:
            sub = prng.fold_in(key, i)
        cloud = f.filter(cloud, key=sub, scan=scan)
        if compact and (not traced or i == len(filters) - 1):
            cloud = cloud.compact()
        after = cloud.count_host()
        log_info(f"Applied {type(f).__name__} - {after} points remaining"
                 + (f" (of {before})" if before is not None else ""))
        before = after
        if after == 0 and not allow_empty:
            raise ConvergenceError(
                f"no points remaining after filter {type(f).__name__}")
    return cloud
