"""Hold the port's loop modules on the card to the same modules on the CPU.

The outlier filters, minimizers and transformations of the port have no
kernel of their own: they are plain torch, run on whichever device their
inputs lie on. ``check_modules`` runs each of them on the inputs of one ICP
step on the card, then on copies of the same inputs on the CPU, compares
the two and times the card's run with CUDA events. ``chip_smoke.py`` calls
it at recorded steps of the K1 and K5 sequences, and
``tests/test_torch_cuda.py`` at a synthetic step.

Tolerances, from the arithmetic each module does:

- outlier weights equal (order statistics, thresholds, float32 sums added
  in a fixed order by elementwise operations);
- RobustOutlierFilter's weights and scale within 1e-6 relative (the card's
  ``exp`` and ``pow``, and the standard deviation's sum, may differ in the
  last bit);
- the transforms of the point-to-point family within 1e-5 (an SVD of a 3x3
  cross-covariance summed in another order), PointToPlane's likewise, and
  each minimizer's residual within 1e-5 relative;
- the Censi covariances within 1e-4 of their largest entry (a 6x6
  pseudo-inverse);
- the transformations within 1e-5 on points and rotated descriptors.
"""

from __future__ import annotations

import torch

from libpointmatcher_tpu_torch.matchers import Matches
from libpointmatcher_tpu_torch.minimizers import ErrorMinimizerRegistrar
from libpointmatcher_tpu_torch.outlierfilters import OutlierFilterRegistrar
from libpointmatcher_tpu_torch.transformations import TransformationRegistrar

#: the outlier filters other than RobustOutlierFilter, as (name, params)
FILTERS = (
    ("NullOutlierFilter", {}),
    ("MaxDistOutlierFilter", {"maxDist": "0.1"}),
    ("MinDistOutlierFilter", {"minDist": "0.01"}),
    ("MedianDistOutlierFilter", {"factor": "3.0"}),
    ("TrimmedDistOutlierFilter", {"ratio": "0.85"}),
    ("VarTrimmedDistOutlierFilter", {}),
    ("SurfaceNormalOutlierFilter", {"maxAngle": "0.8"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality", "threshold": "0.4"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality", "source": "reading",
                                        "useSoftThreshold": "1"}),
)

#: RobustOutlierFilter: every cost, every scale estimator, point-to-plane
ROBUST = tuple(
    [{"robustFct": f} for f in ("cauchy", "welsch", "sc", "gm", "tukey", "huber",
                                "L1", "student")]
    + [{"scaleEstimator": s} for s in ("none", "std", "berg")]
    + [{"distanceType": "point2plane", "nbIterationForScale": "2"}])

MINIMIZERS = (
    ("IdentityErrorMinimizer", {}),
    ("PointToPointErrorMinimizer", {}),
    ("PointToPointSimilarityErrorMinimizer", {}),
    ("PointToPlaneErrorMinimizer", {}),
    ("PointToPointWithCovErrorMinimizer", {}),
    ("PointToPlaneWithCovErrorMinimizer", {}),
)

TRANSFORMATIONS = ("RigidTransformation", "SimilarityTransformation",
                   "PureTranslation")


def card_ms(fn, reps: int) -> float:
    """Mean card time of ``fn`` over ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(_cpu(v) for v in x)) if hasattr(x, "_fields") else \
            tuple(_cpu(v) for v in x)
    if x is None or isinstance(x, (int, float)):
        return x
    return x.to("cpu")                               # a PointCloud


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / |b| over the entries where either is nonzero and
    finite; inf where the non-finite entries differ."""
    a, b = a.double(), b.double()
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(a[~torch.isfinite(a)], b[~torch.isfinite(b)]):
        return float("inf")
    f = torch.isfinite(b)
    d = (a[f] - b[f]).abs()
    return float((d / b[f].abs().clamp(min=1e-300)).max()) if d.numel() else 0.0


def _abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _scaled(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b| (the covariance's own scale)."""
    return _abs(a, b) / max(float(b.double().abs().max()), 1e-300)


def step_inputs(reading, reference, matches, seed: int = 0):
    """The inputs of one step with the descriptors every module reads: a
    1-D "quality" on both clouds and an "eigVectors" matrix per reading
    row, drawn from ``seed`` on the host; the reading keeps its normals,
    if it has them."""
    gen = torch.Generator().manual_seed(seed)
    dev = reading.device
    rq = torch.rand(reading.points.shape[:-1] + (1,), generator=gen).to(dev)
    fq = torch.rand(reference.points.shape[:-1] + (1,), generator=gen).to(dev)
    ev = torch.randn(reading.points.shape[:-1] + (9,), generator=gen).to(dev)
    reading = reading.replace(descriptors={**reading.descriptors, "quality": rq,
                                           "eigVectors": ev})
    reference = reference.replace(descriptors={**reference.descriptors,
                                               "quality": fq})
    return reading, reference, Matches(matches.dists, matches.ids)


def check_modules(reading, reference, matches, label: str, reps: int = 5,
                  log=print) -> list:
    """Every loop module on the card's inputs and on their copies on the
    CPU → one record per module (its difference, tolerance and card ms);
    raises AssertionError on the first difference beyond its tolerance."""
    reading, reference, matches = step_inputs(reading, reference, matches)
    cpu = (_cpu(reading), _cpu(reference), _cpu(matches))
    records = []

    def record(kind, name, params, diff, tol, fn):
        ms = card_ms(fn, reps)
        rec = {"kind": kind, "name": name, "params": params, "diff": diff,
               "tol": tol, "card_ms": round(ms, 4)}
        log(f"[modules] {label} {kind} {name} {params}: diff {diff:.3g} "
            f"(tolerance {tol:g}), card {ms:.4f} ms")
        if not diff <= tol:
            raise AssertionError(f"{label} {kind} {name} {params}: card and CPU "
                                 f"differ by {diff:.3g} > {tol:g}")
        records.append(rec)

    for name, params in FILTERS:
        f = OutlierFilterRegistrar.create(name, params)
        w, _ = f.compute(reading, reference, matches, f.init_state())
        wc, _ = f.compute(*cpu, f.init_state())
        diff = float((w.cpu() != wc).sum())          # mismatched weights
        record("outlier", name, params, diff, 0,
               lambda: f.compute(reading, reference, matches, ()))
    bshape = matches.dists.shape[:-2]
    for params in ROBUST:
        f = OutlierFilterRegistrar.create("RobustOutlierFilter", params)
        w, (s, it) = f.compute(reading, reference, matches,
                               f.init_state(bshape, reading.device))
        wc, (sc, itc) = f.compute(*cpu, f.init_state(bshape))
        diff = max(_rel(w.cpu(), wc), _rel(s.cpu(), sc),
                   float((it.cpu() != itc).sum()))
        st = f.init_state(bshape, reading.device)
        record("outlier", "RobustOutlierFilter", params, diff, 1e-6,
               lambda: f.compute(reading, reference, matches, st))

    trim = OutlierFilterRegistrar.create("TrimmedDistOutlierFilter", {})
    weights, _ = trim.compute(reading, reference, matches, ())
    T_rigid = None
    for name, params in MINIMIZERS:
        m = ErrorMinimizerRegistrar.create(name, params)
        T, st = m.compute(reading, reference, weights, matches)
        Tc, stc = m.compute(cpu[0], cpu[1], weights.cpu(), cpu[2])
        diff = max(_abs(T.cpu(), Tc), _rel(st.residual.cpu(), stc.residual))
        record("minimizer", name, params, diff, 1e-5,
               lambda: m.compute(reading, reference, weights, matches))
        if st.covariance is not None:
            cov = st.covariance.cpu()
            dc = _scaled(cov, stc.covariance)
            sym = _scaled(cov, cov.mT)
            low = float(torch.linalg.eigvalsh(cov.double()).min()) / \
                max(float(cov.abs().max()), 1e-300)
            log(f"[modules] {label} covariance of {name}: diff {dc:.3g} of its "
                f"largest entry (tolerance 1e-4), asymmetry {sym:.3g}, lowest "
                f"eigenvalue {low:.3g} of it")
            if not (dc <= 1e-4 and torch.isfinite(cov).all()):
                raise AssertionError(f"{label} {name}: covariance diff {dc:.3g}")
        if name == "PointToPointSimilarityErrorMinimizer":
            T_sim = T
        if name == "PointToPointErrorMinimizer":
            T_rigid = T
    for name in TRANSFORMATIONS:
        t = TransformationRegistrar.create(name)
        Tn = T_sim if name == "SimilarityTransformation" else T_rigid
        out = t.compute(reading, Tn)
        outc = t.compute(cpu[0], Tn.cpu())
        diff = max([_abs(out.points.cpu(), outc.points)]
                   + [_abs(out.descriptors[k].cpu(), outc.descriptors[k])
                      for k in out.descriptors])
        record("transformation", name, {}, diff, 1e-5,
               lambda: t.compute(reading, Tn))
    return records


#: YAML chains of the new modules (and the default chain, for reference),
#: as (reading filters beyond RandomSampling, outlier filters, minimizer)
CHAINS = {
    "default": ("", """
  - TrimmedDistOutlierFilter:
      ratio: 0.85""", "PointToPlaneErrorMinimizer"),
    "p2p_trimmed": ("", """
  - TrimmedDistOutlierFilter:
      ratio: 0.8""", "PointToPointErrorMinimizer"),
    "p2plane_robust": ("", """
  - RobustOutlierFilter:
      robustFct: cauchy
      scaleEstimator: mad
      nbIterationForScale: 2""", "PointToPlaneErrorMinimizer"),
    "cov_median_normal": ("""
  - SurfaceNormalDataPointsFilter:
      knn: 10""", """
  - MedianDistOutlierFilter:
      factor: 3.0
  - SurfaceNormalOutlierFilter:
      maxAngle: 0.8""", "PointToPlaneWithCovErrorMinimizer"),
    "p2p_vartrimmed": ("", """
  - VarTrimmedDistOutlierFilter""", "PointToPointErrorMinimizer"),
}


#: the default chain's stop rule: Counter(40), Differential(1e-3)
DEFAULT_STOP = (40, 1e-3)
#: point-to-point converges linearly, so its chains stop on finer
#: Differential thresholds within a larger budget: at DEFAULT_STOP 2 of 24
#: batch scans stopped outside chip_smoke.py's gates on an H100, none at
#: these (tools_torch/chain_convergence.py; PERF.md, §6)
P2P_STOP = (100, 1e-4)


def chain_yaml(name: str, knn: int = 1, stop=None) -> str:
    """The YAML text of chain ``name``: RandomSampling (and the chain's own
    reading filters), SamplingSurfaceNormal on the map, KDTreeMatcher with
    ``knn``, and the stop rule ``stop = (max_iter, diff)``: the Counter
    checker at ``max_iter`` and, unless ``diff`` is None, the Differential
    checker at ``diff`` rad and m (default P2P_STOP for the point-to-point
    chains, else DEFAULT_STOP)."""
    extra, outliers, minimizer = CHAINS[name]
    if stop is None:
        stop = P2P_STOP if minimizer.startswith("PointToPoint") else DEFAULT_STOP
    max_iter, diff = stop
    checkers = f"""
  - CounterTransformationChecker:
      maxIterationCount: {max_iter}"""
    if diff is not None:
        checkers += f"""
  - DifferentialTransformationChecker:
      minDiffRotErr: {diff}
      minDiffTransErr: {diff}"""
    return f"""readingDataPointsFilters:
  - RandomSamplingDataPointsFilter{extra}
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher:
  KDTreeMatcher:
    knn: {knn}
outlierFilters:{outliers}
errorMinimizer: {minimizer}
transformationCheckers:{checkers}
"""


def record_step(run):
    """Call ``run()`` (a registration through any entry point) and return
    the inputs of its first step's outlier filters: ``(reading, reference,
    matches)``, the reading moved by the loop's pose."""
    from libpointmatcher_tpu_torch import icp

    orig = icp.compute_outlier_weights
    calls = []

    def recorded(filters, reading, reference, matches, states):
        if not calls:
            calls.append((reading, reference,
                          Matches(matches.dists.clone(), matches.ids.clone())))
        return orig(filters, reading, reference, matches, states)

    icp.compute_outlier_weights = recorded
    try:
        run()
    finally:
        icp.compute_outlier_weights = orig
    return calls[0]
