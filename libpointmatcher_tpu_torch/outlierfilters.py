"""Outlier filters: match distances → per-pair weights (counterpart of
``libpointmatcher_tpu.outlierfilters``; reference: PointMatcher.h:496-525,
OutlierFiltersImpl.{h,cpp}). Weight 0 rejects a pair; a chain multiplies the
weights of its filters (OutlierFilter.cpp:88-97); an empty chain zeroes only
the infinite-distance pairs (OutlierFilter.cpp:68-83).

Interface: ``compute(reading, reference, matches, state) → (weights,
state)``. Matches are ``[N, knn]``, or ``[B, N, knn]`` for a batch of scans,
each filtered on its own: every reduction runs over a scan's last two
dimensions, as the JAX filters run under ``vmap``. The reference is shared
(``[M, d]``) or one per scan (``[B, M, d]``). The one stateful filter,
``RobustOutlierFilter``, carries its scale schedule as explicit loop state
(one value per scan), which the engine threads through its loops."""

from __future__ import annotations

import math

import torch

from .errors import InvalidParameter
from .minimizers import gather_rows
from .registry import Param, Parametrizable, Registrar
from .utils.masked import masked_mad, masked_median, masked_quantile, masked_std

__all__ = ["OutlierFilter", "OutlierFilterRegistrar", "compute_outlier_weights",
           "init_outlier_states", "NullOutlierFilter", "MaxDistOutlierFilter",
           "MinDistOutlierFilter", "MedianDistOutlierFilter",
           "TrimmedDistOutlierFilter", "VarTrimmedDistOutlierFilter",
           "SurfaceNormalOutlierFilter", "GenericDescriptorOutlierFilter",
           "RobustOutlierFilter"]

OutlierFilterRegistrar = Registrar("OutlierFilter")

#: float32's smallest normal number
_TINY = torch.finfo(torch.float32).tiny


def _batch_dims(matches) -> int:
    return matches.dists.ndim - 2


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Zero where |x| is below float32's smallest normal: XLA on the CPU
    flushes subnormal results and operands to zero, which decides the JAX
    package's weights there; torch keeps them."""
    return torch.where(torch.abs(x) < _TINY, torch.zeros_like(x), x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b over the last dimension, added in index order by elementwise
    operations, so that the card rounds as the CPU does (a reduction
    kernel may add in another order)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _unit_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-20)[..., None]


def _gather_pairs(table: torch.Tensor, ids: torch.Tensor,
                  cloud=None) -> torch.Tensor:
    """Rows of ``table`` (shared or one per scan, of ``cloud`` as
    ``gather_rows`` takes it) at the match ids ``[..., N, knn]`` (clamped
    to 0) → ``[..., N, knn, s]``."""
    *b, n, k = ids.shape
    flat = torch.clamp(ids, min=0).to(torch.int64).reshape(*b, n * k)
    return gather_rows(table, flat, cloud).reshape(*b, n, k, table.shape[-1])


class OutlierFilter(Parametrizable):
    """Interface (reference: PointMatcher.h:496-525)."""

    def init_state(self, batch_shape=(), device=None):
        """The filter's loop state at a registration's start, one value
        per scan of ``batch_shape`` (most filters: none)."""
        return ()

    def compute(self, reading, reference, matches, state):
        raise NotImplementedError


def init_outlier_states(filters, batch_shape=(), device=None):
    return tuple(f.init_state(batch_shape, device) for f in filters)


def compute_outlier_weights(filters, reading, reference, matches, states):
    """Chain semantics (reference: OutlierFilter.cpp:63-97) →
    ``(weights [..., N, knn], states)``."""
    if not filters:
        return torch.isfinite(matches.dists).to(torch.float32), states
    w = torch.ones_like(matches.dists)
    new_states = []
    for f, s in zip(filters, states):
        wi, s2 = f.compute(reading, reference, matches, s)
        w = w * wi
        new_states.append(s2)
    return w, tuple(new_states)


@OutlierFilterRegistrar.register
class NullOutlierFilter(OutlierFilter):
    """Accepts all matches (reference: OutlierFiltersImpl.cpp:52-59)."""

    def compute(self, reading, reference, matches, state):
        return torch.ones_like(matches.dists), state


@OutlierFilterRegistrar.register
class MaxDistOutlierFilter(OutlierFilter):
    """Rejects pairs farther than maxDist (reference: OutlierFiltersImpl.cpp:66-81)."""

    PARAMS = (
        Param("maxDist", "maximum distance beyond which matches are rejected",
              float, 1.0, min=0.0),
    )

    def compute(self, reading, reference, matches, state):
        limit = _f32(self.maxDist) ** 2
        return (matches.dists <= limit).to(torch.float32), state


@OutlierFilterRegistrar.register
class MinDistOutlierFilter(OutlierFilter):
    """Rejects pairs closer than minDist (reference: OutlierFiltersImpl.cpp:87-101).

    Note the reference semantics: an infinite (invalid) distance satisfies
    ``dist >= minDist`` and gets weight 1 here; the minimizer is what finally
    drops invalid pairs."""

    PARAMS = (
        Param("minDist", "minimum distance below which matches are rejected",
              float, 1.0, min=0.0),
    )

    def compute(self, reading, reference, matches, state):
        limit = _f32(self.minDist) ** 2
        return (matches.dists >= limit).to(torch.float32), state


@OutlierFilterRegistrar.register
class MedianDistOutlierFilter(OutlierFilter):
    """Rejects pairs beyond factor·median distance
    (reference: OutlierFiltersImpl.cpp:109-125)."""

    PARAMS = (
        Param("factor", "points whose distance exceeds this factor times the "
              "median distance are rejected", float, 3.0, min=0.0000001),
    )

    def compute(self, reading, reference, matches, state):
        limit = self.factor * masked_median(matches.dists, _batch_dims(matches))
        return (matches.dists <= limit[..., None, None]).to(torch.float32), state


@OutlierFilterRegistrar.register
class TrimmedDistOutlierFilter(OutlierFilter):
    """Keeps the best ``ratio`` fraction of matches by distance
    (reference: OutlierFiltersImpl.cpp:132-147; the default chain's filter,
    ICP.cpp:107)."""

    PARAMS = (
        Param("ratio", "fraction of matches to keep (by increasing distance)",
              float, 0.85, min=0.0000001, max=1.0),
    )

    def compute(self, reading, reference, matches, state):
        limit = masked_quantile(matches.dists, self.ratio, _batch_dims(matches))
        return (matches.dists <= limit[..., None, None]).to(torch.float32), state


def _blocked_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Float32 inclusive sum along the last dimension in XLA's order: its
    rewrite of a long cumulative sum runs sequential sums within blocks of
    ``base`` and adds the blocks' own cumulative totals, recursively. The
    JAX package's ``jnp.cumsum`` gives these values bit for bit on the CPU;
    ``torch.cumsum`` adds in float64 on the CPU and in a scan on the card.
    Only float32 additions in a fixed order here, so the card gives the
    same values as the CPU."""
    n = x.shape[-1]
    if n <= base:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // base)
    blocks = torch.nn.functional.pad(x, (0, nb * base - n)).reshape(
        *x.shape[:-1], nb, base)
    intra = _blocked_cumsum(blocks, base)
    totals = _blocked_cumsum(intra[..., -1], base)
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (intra + before[..., None]).reshape(*x.shape[:-1], nb * base)[..., :n]


@OutlierFilterRegistrar.register
class VarTrimmedDistOutlierFilter(OutlierFilter):
    """Auto-tunes the trim ratio each iteration by minimizing the FRMS
    criterion over [minRatio, maxRatio]
    (reference: OutlierFiltersImpl.cpp:152-220, \\cite{Phillips2007})."""

    PARAMS = (
        Param("minRatio", "lower bound of the search interval", float, 0.05,
              min=0.0000001, max=1.0),
        Param("maxRatio", "upper bound of the search interval", float, 0.99,
              min=0.0000001, max=1.0),
        Param("lambda", "FRMS exponent λ; FRMS = cumdist/n/f^2λ", float, 2.35),
    )

    def __init__(self, params=None):
        super().__init__(params)
        if self.minRatio >= self.maxRatio:
            raise InvalidParameter(
                f"VarTrimmedDistOutlierFilter: minRatio ({self.minRatio}) must "
                f"be smaller than maxRatio ({self.maxRatio})")

    def compute(self, reading, reference, matches, state):
        dists = matches.dists
        bd = _batch_dims(matches)
        # ratios of the real (finite, nonzero) matches, as the JAX filter
        # counts them: padding rows would inflate the denominator
        flat = dists.reshape(*dists.shape[:bd], -1)
        valid = torch.isfinite(flat) & (flat > 0)
        n = torch.clamp(valid.sum(dim=-1), min=1).to(torch.float32)[..., None]
        s = torch.sort(torch.where(valid, flat, torch.full_like(flat, float("inf"))),
                       dim=-1).values
        cumsum = _blocked_cumsum(s)            # the +inf tail stays +inf
        ids = torch.arange(1, flat.shape[-1] + 1, dtype=torch.float32,
                           device=flat.device)
        ratio = ids / n
        in_window = ((ids >= torch.floor(self.minRatio * n) + 1.0)
                     & (ids <= torch.floor(self.maxRatio * n)))
        # the power in float64, rounded once: the same value on the CPU and
        # the card, and XLA's float32 power but for rare last-bit cases
        power = float(torch.tensor(2.0 * self.parameters["lambda"],
                                   dtype=torch.float32))
        frms = cumsum / ids / (ratio.double() ** power).to(torch.float32)
        frms = torch.where(in_window, frms, torch.full_like(frms, float("inf")))
        # the reference's optRatio = (minIndex + minEl)/n, and the quantile
        # indexes floor(n·ratio) (OutlierFiltersImpl.cpp:215-219);
        # torch.argmin returns the first minimum, as jnp.argmin does
        opt_ratio = torch.argmin(frms, dim=-1).to(torch.float32) / n[..., 0]
        limit = masked_quantile(dists, opt_ratio, bd)
        return (dists <= limit[..., None, None]).to(torch.float32), state


@OutlierFilterRegistrar.register
class SurfaceNormalOutlierFilter(OutlierFilter):
    """Rejects pairs whose normals disagree by more than maxAngle
    (reference: OutlierFiltersImpl.cpp:226-288)."""

    PARAMS = (
        Param("maxAngle", "maximum angle between the normals of a matched "
              "pair [rad]", float, 1.50, min=0.0, max=3.1416),
    )

    def compute(self, reading, reference, matches, state):
        if not (reading.has_descriptor("normals")
                and reference.has_descriptor("normals")):
            # no filtering without normals (reference:
            # OutlierFiltersImpl.cpp:271-281)
            return torch.ones_like(matches.dists), state
        eps = _f32(math.cos(self.maxAngle))
        nr = _unit_rows(reading.get_descriptor("normals"))
        nf = _unit_rows(reference.get_descriptor("normals"))
        nref = _gather_pairs(nf, matches.ids, reference)  # [..., N, knn, d]
        dot = torch.abs(_dot(nr[..., None, :], nref))
        w = (dot >= eps).to(torch.float32)
        return torch.where(matches.ids >= 0, w, torch.zeros_like(w)), state


@OutlierFilterRegistrar.register
class GenericDescriptorOutlierFilter(OutlierFilter):
    """Weights pairs by thresholding (or directly using) a 1-D descriptor
    (reference: OutlierFiltersImpl.cpp:291-374).

    Note: with ``source: reading`` the descriptor is indexed by the reading
    point (the reference contains a known quirk where both branches read the
    reference cloud; we implement the documented intent)."""

    PARAMS = (
        Param("source", "cloud carrying the descriptor: 'reference' or "
              "'reading'", str, "reference"),
        Param("descName", "name of the 1-D descriptor to use", str, "none"),
        Param("useSoftThreshold", "if true, use the descriptor value as "
              "weight (normalized by its max); if false, hard threshold",
              bool, False),
        Param("useLargerThan", "hard threshold direction: keep if descriptor "
              "larger (true) or smaller (false) than threshold", bool, True),
        Param("threshold", "hard threshold value", float, 0.9, min=0.0000001),
    )

    def __init__(self, params=None):
        super().__init__(params)
        if self.source not in ("reference", "reading"):
            raise InvalidParameter(
                "GenericDescriptorOutlierFilter: 'source' must be 'reference' "
                f"or 'reading', got '{self.source}'")

    def compute(self, reading, reference, matches, state):
        cloud = reference if self.source == "reference" else reading
        desc = cloud.get_descriptor(self.descName)
        if desc.shape[-1] != 1:
            raise InvalidParameter(
                f"GenericDescriptorOutlierFilter: '{self.descName}' must be 1-D")
        if self.source == "reference":
            vals = _gather_pairs(desc, matches.ids, reference)[..., 0]
        else:
            vals = desc[..., :, :1].expand(matches.dists.shape)
        matched = matches.ids >= 0
        zero = torch.zeros_like(matches.dists)
        if self.useSoftThreshold:
            w = torch.where(matched, vals, zero)
            top = torch.amax(w, dim=(-2, -1), keepdim=True)
            return w / torch.clamp(top, min=1e-20), state
        thr = _f32(self.threshold)
        w = (vals > thr if self.useLargerThan else vals < thr).to(torch.float32)
        return torch.where(matched, w, zero), state


@OutlierFilterRegistrar.register
class RobustOutlierFilter(OutlierFilter):
    r"""M-estimator weighting with pluggable robust cost and scale estimator
    (reference: OutlierFiltersImpl.cpp:379-602, \cite{RobustWeightFcts}).

    Supported robust functions: cauchy, welsch, sc (switchable constraint),
    gm (Geman-McClure), tukey, huber, L1, student; scale estimators: none,
    mad, std, berg — with an iteration schedule threaded through the ICP loop
    as explicit state (the reference mutates members instead)."""
    # the scale and the iteration count, ``(scale, iteration)``, are loop
    # state, one of each per scan

    PARAMS = (
        Param("robustFct", "robust cost: cauchy|welsch|sc|gm|tukey|huber|L1|student",
              str, "cauchy"),
        Param("tuning", "tuning constant k of the robust function (or target "
              "scale for the berg estimator)", float, 1.0, min=0.0000001),
        Param("scaleEstimator", "scale estimator: none|mad|std|berg", str, "mad"),
        Param("nbIterationForScale", "number of iterations the scale is "
              "re-estimated for (0 = every iteration)", int, 0, min=0, max=100),
        Param("distanceType", "residual type: point2point|point2plane", str,
              "point2point"),
        Param("approximation", "cutoff distance above which weights are "
              "forced to 0 (inf = disabled)", float, "inf", min=0.0),
    )

    _BERG_TUNING = {"cauchy": 4.3040, "tukey": 7.0589, "huber": 2.0138}

    def __init__(self, params=None):
        super().__init__(params)
        if self.robustFct not in ("cauchy", "welsch", "sc", "gm", "tukey",
                                  "huber", "L1", "student"):
            raise InvalidParameter("Invalid robust function name.")
        if self.scaleEstimator not in ("none", "mad", "std", "berg"):
            raise InvalidParameter("Invalid scale estimator name.")
        if self.distanceType not in ("point2point", "point2plane"):
            raise InvalidParameter("Invalid distance type name.")
        self.berg_target_scale = 0.0
        self.k = self.tuning
        if self.scaleEstimator == "berg":
            self.berg_target_scale = self.tuning
            self.k = self._BERG_TUNING.get(self.robustFct, self.tuning)
        self.squared_approximation = float(self.approximation) ** 2

    def init_state(self, batch_shape=(), device=None):
        return (torch.ones(batch_shape, dtype=torch.float32, device=device),
                torch.ones(batch_shape, dtype=torch.int32, device=device))

    def _residuals(self, reading, reference, matches):
        if self.distanceType == "point2point":
            return matches.dists
        nref = _gather_pairs(_unit_rows(reference.get_descriptor("normals")),
                             matches.ids, reference)
        pref = _gather_pairs(reference.points, matches.ids, reference)
        delta = reading.points[..., None, :] - pref
        d = _dot(nref, delta) ** 2
        return torch.where(matches.ids >= 0, d, torch.zeros_like(d))

    def _scale(self, dists, bd, scale, iteration):
        if self.scaleEstimator == "mad":
            return torch.sqrt(masked_mad(dists, bd))
        if self.scaleEstimator == "std":
            return torch.sqrt(masked_std(dists, bd))
        if self.scaleEstimator == "berg":
            first = 1.9 * torch.sqrt(masked_quantile(dists, 0.5, bd))
            decayed = (0.85 * (scale - self.berg_target_scale)
                       + self.berg_target_scale)
            return torch.where(iteration == 1, first, decayed)
        return torch.ones_like(scale)

    def compute(self, reading, reference, matches, state):
        scale, iteration = state
        bd = _batch_dims(matches)
        nb = self.nbIterationForScale
        update = (iteration <= nb) | (nb == 0)
        scale = torch.where(update, self._scale(matches.dists, bd, scale,
                                                iteration), scale)
        s2 = (scale * scale)[..., None, None]
        e2 = _flush_subnormal(self._residuals(reading, reference, matches) / s2)
        k = _f32(self.k).to(e2.device)
        k2 = k * k
        one = torch.ones_like(e2)
        fct = self.robustFct
        if fct == "cauchy":
            w = 1.0 / (1.0 + e2 / k2)
        elif fct == "welsch":
            w = torch.exp(-e2 / k2)
        elif fct == "sc":
            w = torch.where(e2 >= k, 4.0 * k2 / (k + e2) ** 2, one)
        elif fct == "gm":
            w = k2 / (k + e2) ** 2
        elif fct == "tukey":
            w = torch.where(e2 >= k2, torch.zeros_like(e2), (1.0 - e2 / k2) ** 2)
        elif fct == "huber":
            w = torch.where(e2 >= k2, k / torch.sqrt(e2), one)
        elif fct == "L1":
            # the JAX filter's floor max(e2, 1e-38) is subnormal, which XLA
            # reads as 0: a zero residual weighs 1/0 = inf there too
            w = 1.0 / torch.sqrt(e2)
        else:  # student
            d = 3.0
            p = (1.0 + e2 / k) ** (-(k + d) / 2.0)
            w = p * (k + d) / (k + e2)
        # The reference clamps weights to 1e-50 to keep them "used"
        # (OutlierFiltersImpl.cpp:587-588); in float32 that floor is 0, and
        # XLA flushes a subnormal weight to 0, so every weight below
        # float32's smallest normal is 0, as in the JAX package.
        w = _flush_subnormal(w)
        w = torch.where(torch.isfinite(matches.dists), w, torch.zeros_like(w))
        if self.squared_approximation != float("inf"):
            w = torch.where(e2 >= self.squared_approximation,
                            torch.zeros_like(w), w)
        return w, (scale, iteration + 1)
