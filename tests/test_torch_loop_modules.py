"""The loop modules of the port (outlier filters with their loop state,
minimizers with the Censi covariance, transformations) against their JAX
counterparts on the CPU, on the same seeded numpy matches.

Three layouts: one scan (``[N, knn]`` matches), a batch of 3 scans against
a shared map (``[B, N, knn]``, one scan's rows partly masked, as the
engine masks a stopped scan) and the same batch with one map per scan
(``[B, M, d]``, the pair axis). The JAX side runs each scan on its own, as
its engines run the modules under ``vmap``.

Tolerances: weights of the order-statistic and threshold filters equal;
RobustOutlierFilter's weights within 1e-6 relative (the two frameworks'
``exp``, ``pow`` and the standard deviation's sum may differ in the last
bit); transforms within 1e-5 absolute and covariances within 1e-5 of their
largest entry (float32 sums in another order, LAPACK's SVD on both sides).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu import minimizers as jmin
from libpointmatcher_tpu import outlierfilters as jout
from libpointmatcher_tpu import transformations as jtr
from libpointmatcher_tpu.matchers import Matches as JMatches
from libpointmatcher_tpu.utils import masked as jmasked
from libpointmatcher_tpu.utils import se3 as jse3

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import minimizers as tmin
from libpointmatcher_tpu_torch import outlierfilters as tout
from libpointmatcher_tpu_torch import transformations as ttr
from libpointmatcher_tpu_torch.matchers import Matches
from libpointmatcher_tpu_torch.utils import masked as tmasked
from libpointmatcher_tpu_torch.utils import se3 as tse3

N, M, B = 300, 500, 3
LAYOUTS = ("one", "batch", "pairs")


def _planes(rng, m):
    """Points on three axis planes and a tilted one, with their normals."""
    k = m // 4
    pts = np.concatenate([
        np.c_[rng.uniform(0, 5, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 5, k), np.zeros(k), rng.uniform(0, 3, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 3, k)],
        np.c_[rng.uniform(1, 3, m - 3 * k), rng.uniform(1, 3, m - 3 * k),
              np.full(m - 3 * k, 1.0)]])
    nrm = np.concatenate([np.tile([0, 0, 1.0], (k, 1)), np.tile([0, 1.0, 0], (k, 1)),
                          np.tile([1.0, 0, 0], (k, 1)),
                          np.tile([0, 0, 1.0], (m - 3 * k, 1))])
    a = rng.uniform(-0.4, 0.4, m - 3 * k)[:, None]   # tilt the last group
    nrm[3 * k:] = np.c_[np.sin(a), np.zeros_like(a), np.cos(a)]
    return pts.astype(np.float32), nrm.astype(np.float32)


def _yaw(ang, t, scale=1.0):
    T = np.eye(4)
    T[:3, :3] = scale * np.array([[np.cos(ang), -np.sin(ang), 0],
                                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    T[:3, 3] = t
    return T


def _scan(rng, ref, ref_n, knn, mask_rows=None, scale=1.0):
    """Reading rows: reference rows moved by a small pose and noised; match
    0 of each row is its true row, the others random rows; distances are
    the squared distances to them, sorted per row. Every 17th row has no
    match; ``mask_rows`` rows are masked (inf / -1), as the engine masks
    them."""
    true = rng.choice(len(ref), N, replace=False)
    T = np.linalg.inv(_yaw(rng.uniform(-0.05, 0.05),
                           rng.uniform(-0.05, 0.05, 3), scale))
    read = (ref[true] @ T[:3, :3].T + T[:3, 3]
            + 0.003 * rng.standard_normal((N, 3))).astype(np.float32)
    rn = ref_n[true] @ T[:3, :3].T / scale + 0.05 * rng.standard_normal((N, 3))
    rn = (rn / np.linalg.norm(rn, axis=1, keepdims=True)).astype(np.float32)
    ids = np.c_[true[:, None], rng.integers(0, len(ref), (N, knn - 1))]
    outl = rng.random(N) < 0.1                      # a tenth far outliers
    ids[outl, 0] = rng.integers(0, len(ref), outl.sum())
    d = ((read[:, None, :] - ref[ids]) ** 2).sum(-1).astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")
    d = np.take_along_axis(d, order, 1)
    ids = np.take_along_axis(ids, order, 1).astype(np.int32)
    mask = np.ones(N, bool)
    d[::17], ids[::17] = np.inf, -1
    if mask_rows is not None:
        mask[mask_rows] = False
        d[mask_rows], ids[mask_rows] = np.inf, -1
    return read, rn, mask, d, ids


def make_case(seed, knn, layout, scale=1.0):
    """numpy inputs: reading [B, N, 3] (+ normals, a 1-D "quality"
    descriptor, mask), map [M, 3] or [B, M, 3] (+ normals, "quality"),
    dists and ids [B, N, knn]; B = 1 for the one-scan layout."""
    rng = np.random.default_rng(seed)
    nb = 1 if layout == "one" else B
    maps = [_planes(rng, M) for _ in range(nb if layout == "pairs" else 1)]
    scans = [_scan(rng, *maps[b if layout == "pairs" else 0], knn,
                   np.arange(100, 180) if b == 1 else None, scale)
             for b in range(nb)]
    read, rn, mask, d, ids = (np.stack(x) for x in zip(*scans))
    ref = np.stack([m[0] for m in maps])
    ref_n = np.stack([m[1] for m in maps])
    quality = rng.uniform(0, 1, (len(maps), M, 1)).astype(np.float32)
    rq = rng.uniform(0, 1, (nb, N, 1)).astype(np.float32)
    w = (rng.uniform(0.2, 1.0, d.shape) * (rng.random(d.shape) > 0.1)
         ).astype(np.float32)
    return dict(layout=layout, read=read, rn=rn, mask=mask, rq=rq, ref=ref,
                ref_n=ref_n, quality=quality, d=d, ids=ids, w=w)


def jax_scan(c, b, reading_normals=True):
    """The JAX clouds and matches of scan b."""
    f = b if c["layout"] == "pairs" else 0
    rdesc = {"quality": jnp.asarray(c["rq"][b])}
    if reading_normals:
        rdesc["normals"] = jnp.asarray(c["rn"][b])
    read = pm.PointCloud(jnp.asarray(c["read"][b]), jnp.asarray(c["mask"][b]), rdesc)
    ref = pm.PointCloud(jnp.asarray(c["ref"][f]), descriptors={
        "normals": jnp.asarray(c["ref_n"][f]), "quality": jnp.asarray(c["quality"][f])})
    return read, ref, JMatches(jnp.asarray(c["d"][b]), jnp.asarray(c["ids"][b]))


def port_inputs(c, reading_normals=True):
    """The port's clouds and matches of the whole layout."""
    one = c["layout"] == "one"
    sq = (lambda x: torch.from_numpy(x[0])) if one else torch.from_numpy
    rsq = (lambda x: torch.from_numpy(x[0])) if c["layout"] != "pairs" else sq
    rdesc = {"quality": sq(c["rq"])}
    if reading_normals:
        rdesc["normals"] = sq(c["rn"])
    read = pt.PointCloud(sq(c["read"]), sq(c["mask"]), rdesc)
    ref = pt.PointCloud(rsq(c["ref"]), descriptors={"normals": rsq(c["ref_n"]),
                                                    "quality": rsq(c["quality"])})
    return read, ref, Matches(sq(c["d"]), sq(c["ids"]))


def per_scan(c, x):
    """Port output → a list with scan b's value at b."""
    x = np.asarray(x)
    return [x] if c["layout"] == "one" else list(x)


# ------------------------------------------------------------ masked stats
@pytest.mark.parametrize("fn", ["masked_median", "masked_mad", "masked_std",
                                "masked_quantile"])
def test_masked_statistics_per_scan(fn):
    """Each statistic per batch entry equals the JAX one on that entry (std
    within 1e-6 relative: a float32 sum in another order)."""
    rng = np.random.default_rng(1)
    v = rng.exponential(size=(3, 397, 2)).astype(np.float32)
    v[0, ::7, 0] = np.inf
    v[1, 10:20, 1] = v[1, 0, 0]                      # repeated values
    v[2] = np.inf
    v[2, :3, 0] = [0.5, 0.25, 2.0]                   # three finite entries
    q = np.float32([0.3, 0.85, 1.0])
    args = (torch.from_numpy(q),) if fn == "masked_quantile" else ()
    got = getattr(tmasked, fn)(torch.from_numpy(v), *args, batch_dims=1).numpy()
    for b in range(3):
        jargs = (jnp.float32(q[b]),) if fn == "masked_quantile" else ()
        want = np.asarray(getattr(jmasked, fn)(jnp.asarray(v[b]), *jargs))
        if fn == "masked_std":
            np.testing.assert_allclose(got[b], want, rtol=1e-6)
        else:
            assert got[b].tobytes() == want.tobytes(), (b, got[b], want)


def test_blocked_cumsum_is_xla_order():
    """VarTrimmedDist's cumulative sum equals jnp.cumsum bit for bit, one
    scan and a vmapped batch, across block boundaries."""
    import jax

    rng = np.random.default_rng(2)
    for n in (1, 15, 16, 17, 255, 256, 257, 4099):
        x = np.sort(rng.exponential(size=(2, n)).astype(np.float32) ** 2, axis=1)
        x[1, n // 2:] = np.inf
        got = tout._blocked_cumsum(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(x)))
        assert got.tobytes() == want.tobytes(), n
        assert (tout._blocked_cumsum(torch.from_numpy(x[0])).numpy().tobytes()
                == np.asarray(jnp.cumsum(jnp.asarray(x[0]))).tobytes())


# ---------------------------------------------------------- outlier filters
FILTERS = [
    ("NullOutlierFilter", {}),
    ("MaxDistOutlierFilter", {"maxDist": "0.05"}),
    ("MinDistOutlierFilter", {"minDist": "0.004"}),
    ("MedianDistOutlierFilter", {"factor": "2.5"}),
    ("TrimmedDistOutlierFilter", {"ratio": "0.7"}),
    ("VarTrimmedDistOutlierFilter", {}),
    ("VarTrimmedDistOutlierFilter", {"minRatio": "0.3", "maxRatio": "0.95",
                                     "lambda": "1.5"}),
    ("SurfaceNormalOutlierFilter", {"maxAngle": "0.3"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality", "threshold": "0.4"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality", "source": "reading",
                                        "useLargerThan": "0", "threshold": "0.6"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality",
                                        "useSoftThreshold": "1"}),
    ("GenericDescriptorOutlierFilter", {"descName": "quality", "source": "reading",
                                        "useSoftThreshold": "1"}),
]


def _filter_pair(name, params):
    return (tout.OutlierFilterRegistrar.create(name, params),
            jout.OutlierFilterRegistrar.create(name, params))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("knn", [1, 3])
@pytest.mark.parametrize("name,params", FILTERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FILTERS)])
def test_outlier_filter_weights_equal(name, params, knn, layout):
    c = make_case(10 + knn, knn, layout)
    tf, jf = _filter_pair(name, params)
    w, state = tf.compute(*port_inputs(c), tf.init_state())
    assert state == ()
    for b, wb in enumerate(per_scan(c, w)):
        wj, _ = jf.compute(*jax_scan(c, b), jf.init_state())
        np.testing.assert_array_equal(wb, np.asarray(wj), err_msg=f"scan {b}")


def test_surface_normal_filter_without_normals_keeps_all():
    c = make_case(3, 1, "batch")
    tf, jf = _filter_pair("SurfaceNormalOutlierFilter", {})
    w, _ = tf.compute(*port_inputs(c, reading_normals=False), ())
    wj, _ = jf.compute(*jax_scan(c, 0, reading_normals=False), ())
    assert np.all(w.numpy() == 1.0) and np.all(np.asarray(wj) == 1.0)


ROBUST = ([{"robustFct": f} for f in ("cauchy", "welsch", "sc", "gm", "tukey",
                                       "huber", "L1", "student")]
          + [{"scaleEstimator": s} for s in ("none", "std", "berg")]
          + [{"robustFct": "tukey", "scaleEstimator": "berg", "tuning": "0.5"},
             {"distanceType": "point2plane", "tuning": "2.0"},
             {"robustFct": "welsch", "approximation": "3.0"}])


def _robust_equal(wt, st, wj, sj, msg):
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=1e-6, atol=0, err_msg=msg)
    np.testing.assert_allclose(st[0], np.asarray(sj[0]), rtol=1e-6, err_msg=msg)
    assert int(st[1]) == int(sj[1]), msg


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("knn", [1, 3])
@pytest.mark.parametrize("params", ROBUST, ids=lambda p: "-".join(p.values()))
def test_robust_weights(params, knn, layout):
    c = make_case(20 + knn, knn, layout)
    tf, jf = _filter_pair("RobustOutlierFilter", params)
    w, (scale, it) = tf.compute(*port_inputs(c),
                                tf.init_state(() if layout == "one" else (B,)))
    for b, (wb, sb, ib) in enumerate(zip(per_scan(c, w), per_scan(c, scale),
                                         per_scan(c, it))):
        wj, sj = jf.compute(*jax_scan(c, b), jf.init_state())
        _robust_equal(wb, (sb, ib), wj, sj, f"scan {b}")


@pytest.mark.parametrize("estimator", ["none", "mad", "std", "berg"])
def test_robust_state_sequence(estimator):
    """Four calls with shrinking residuals, nbIterationForScale 2: the
    scale moves on the first two and then holds (berg decays from its
    first estimate), per scan of a batch as per single scan."""
    c = make_case(30, 1, "batch")
    params = {"scaleEstimator": estimator, "nbIterationForScale": "2"}
    tf, jf = _filter_pair("RobustOutlierFilter", params)
    st = tf.init_state((B,))
    sj = [jf.init_state() for _ in range(B)]
    for call in range(4):
        c2 = dict(c, d=(c["d"] * np.float32(0.6) ** call))
        w, st = tf.compute(*port_inputs(c2), st)
        for b in range(B):
            wj, sj[b] = jf.compute(*jax_scan(c2, b), sj[b])
            _robust_equal(w[b].numpy(), (st[0][b], st[1][b]), wj, sj[b],
                          f"call {call} scan {b}")
    assert int(st[1][0]) == 5


def test_robust_weights_below_float32_normal_are_zero():
    """welsch at e2 = 87.5 gives exp(-87.5), a float32 subnormal: XLA
    flushes it to 0 and so must the port; 87.0 stays normal. L1 at a zero
    residual weighs inf on both sides."""
    d = np.float32([[0.5], [87.0], [87.5], [88.0], [120.0], [np.inf]])
    ids = np.int32([[0], [1], [2], [3], [4], [-1]])
    for params, rows in (({"robustFct": "welsch", "scaleEstimator": "none"},
                          slice(None)),
                         ({"robustFct": "L1", "scaleEstimator": "none"}, slice(None))):
        tf, jf = _filter_pair("RobustOutlierFilter", params)
        dd = d.copy()
        if params["robustFct"] == "L1":
            dd[0] = 0.0
        wt, _ = tf.compute(None, None, Matches(torch.from_numpy(dd),
                                               torch.from_numpy(ids)), tf.init_state())
        wj, _ = jf.compute(None, None, JMatches(jnp.asarray(dd), jnp.asarray(ids)),
                           jf.init_state())
        np.testing.assert_array_equal(wt.numpy()[rows], np.asarray(wj)[rows])
    welsch = tout.RobustOutlierFilter({"robustFct": "welsch", "scaleEstimator": "none"})
    w, _ = welsch.compute(None, None, Matches(torch.from_numpy(d), torch.from_numpy(ids)),
                          welsch.init_state())
    assert w[1, 0] > 0 and w[2, 0] == 0 and w[3, 0] == 0


def test_outlier_chain_states():
    """A chain multiplies its filters' weights and threads each filter's
    state; the empty chain keeps the finite pairs."""
    c = make_case(4, 3, "batch")
    chain_t = [tout.MedianDistOutlierFilter({"factor": "3"}),
               tout.RobustOutlierFilter({"nbIterationForScale": "1"})]
    chain_j = [jout.MedianDistOutlierFilter({"factor": "3"}),
               jout.RobustOutlierFilter({"nbIterationForScale": "1"})]
    states = tout.init_outlier_states(chain_t, (B,))
    w, states = tout.compute_outlier_weights(chain_t, *port_inputs(c), states)
    assert states[0] == () and states[1][1].tolist() == [2] * B
    for b in range(B):
        wj, sj = jout.compute_outlier_weights(chain_j, *jax_scan(c, b),
                                              jout.init_outlier_states(chain_j))
        np.testing.assert_allclose(w[b].numpy(), np.asarray(wj), rtol=1e-6, atol=0)
    w0, s0 = tout.compute_outlier_weights([], *port_inputs(c), ())
    np.testing.assert_array_equal(w0.numpy(), np.isfinite(c["d"]).astype(np.float32))


# --------------------------------------------------------------- minimizers
MINIMIZERS = [
    ("IdentityErrorMinimizer", {}),
    ("PointToPointErrorMinimizer", {}),
    ("PointToPointSimilarityErrorMinimizer", {}),
    ("PointToPointWithCovErrorMinimizer", {"sensorStdDev": "0.02"}),
    ("PointToPlaneWithCovErrorMinimizer", {}),
]


def _assert_stats(st, sj, b, c, msg):
    pick = (lambda x: np.asarray(x)) if c["layout"] == "one" else \
        (lambda x: np.asarray(x)[b])
    for f in ("point_used_ratio", "weighted_point_used_ratio", "residual"):
        np.testing.assert_allclose(pick(getattr(st, f)), np.asarray(getattr(sj, f)),
                                   rtol=1e-5, err_msg=f"{msg} {f}")
    for f in ("nb_rejected_matches", "nb_rejected_points"):
        assert int(pick(getattr(st, f))) == int(getattr(sj, f)), f"{msg} {f}"


def _assert_cov(ct, cj, msg):
    cj = np.asarray(cj)
    assert np.abs(ct - cj).max() <= 1e-5 * np.abs(cj).max(), msg


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("knn", [1, 3])
@pytest.mark.parametrize("name,params", MINIMIZERS, ids=[n for n, _ in MINIMIZERS])
def test_minimizer_transform_stats_covariance(name, params, knn, layout):
    scale = 1.05 if "Similarity" in name else 1.0
    c = make_case(40 + knn, knn, layout, scale=scale)
    tm = tmin.ErrorMinimizerRegistrar.create(name, params)
    jm = jmin.ErrorMinimizerRegistrar.create(name, params)
    assert tm.PRODUCES_COVARIANCE == jm.PRODUCES_COVARIANCE
    read, ref, matches = port_inputs(c)
    w = torch.from_numpy(c["w"][0] if layout == "one" else c["w"])
    T, st = tm.compute(read, ref, w, matches)
    assert st._fields == jmin.MinimizerStats._fields
    assert (st.covariance is None) != tm.PRODUCES_COVARIANCE
    res = tm.residual_error(read, ref, w, matches)
    for b, Tb in enumerate(per_scan(c, T)):
        jr, jf, jmt = jax_scan(c, b)
        Tj, sj = jm.compute(jr, jf, jnp.asarray(c["w"][b]), jmt)
        np.testing.assert_allclose(Tb, np.asarray(Tj), atol=1e-5, rtol=0,
                                   err_msg=f"scan {b}")
        _assert_stats(st, sj, b, c, f"scan {b}")
        if tm.PRODUCES_COVARIANCE:
            _assert_cov(per_scan(c, st.covariance)[b], sj.covariance, f"scan {b}")
        np.testing.assert_allclose(
            per_scan(c, res)[b],
            np.asarray(jm.residual_error(jr, jf, jnp.asarray(c["w"][b]), jmt)),
            rtol=1e-5)


@pytest.mark.parametrize("layout", ["one", "batch"])
def test_point_to_plane_residual_error(layout):
    c = make_case(50, 3, layout)
    read, ref, matches = port_inputs(c)
    w = torch.from_numpy(c["w"][0] if layout == "one" else c["w"])
    got = tmin.PointToPlaneErrorMinimizer().residual_error(read, ref, w, matches)
    for b, gb in enumerate(per_scan(c, got)):
        jr, jf, jmt = jax_scan(c, b)
        want = jmin.PointToPlaneErrorMinimizer().residual_error(
            jr, jf, jnp.asarray(c["w"][b]), jmt)
        np.testing.assert_allclose(gb, np.asarray(want), rtol=1e-5)


def test_similarity_recovers_scale():
    """PointToPointSimilarity on exact pairs gives the pose and scale back;
    below sigma 1e-4 (a collapsed reading) the scale is 1."""
    ref, _ = _planes(np.random.default_rng(60), M)
    T = _yaw(0.1, [0.3, -0.2, 0.1], 1.2)
    read = ((ref - T[:3, 3]) @ T[:3, :3]) / 1.2 ** 2    # ref = T · read
    ids = torch.arange(M, dtype=torch.int32)[:, None]
    matches = Matches(torch.zeros((M, 1)), ids)
    w = torch.ones((M, 1))
    refc = pt.PointCloud(torch.from_numpy(ref))
    mini = tmin.PointToPointSimilarityErrorMinimizer()
    Tt, _ = mini.compute(pt.PointCloud(torch.from_numpy(read.astype(np.float32))),
                         refc, w, matches)
    np.testing.assert_allclose(Tt.numpy(), T, atol=1e-4)
    T0, _ = mini.compute(pt.PointCloud(torch.zeros((M, 3))), refc, w, matches)
    np.testing.assert_allclose(float(torch.linalg.det(T0[:3, :3])), 1.0, atol=1e-5)


# ---------------------------------------------------------- transformations
def test_rigid_rotates_eig_vectors():
    """The eigVectors descriptor rotates as V → R·V (JAX's
    transformations.py:39-44), per scan of a batch too."""
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((5, 3)).astype(np.float32)
    ev = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (5, 1))
    ev[1] = rng.standard_normal(9)
    T = _yaw(0.3, [0.1, 0.2, 0.3]).astype(np.float32)
    jc = pm.PointCloud(jnp.asarray(pts), descriptors={"eigVectors": jnp.asarray(ev)})
    want = np.asarray(jtr.RigidTransformation().compute(jc, jnp.asarray(T))
                      .descriptors["eigVectors"])
    tc = pt.PointCloud(torch.from_numpy(pts),
                       descriptors={"eigVectors": torch.from_numpy(ev)})
    got = ttr.RigidTransformation().compute(tc, torch.from_numpy(T)
                                            ).descriptors["eigVectors"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0], [0.955336, -0.29552, 0, 0.29552, 0.955336,
                                        0, 0, 0, 1], atol=1e-5)
    # a batch of two scans, one transform each
    T2 = np.stack([T, _yaw(-0.7, [0, 0, 1]).astype(np.float32)])
    tb = pt.PointCloud(torch.from_numpy(np.stack([pts, pts])),
                       descriptors={"eigVectors": torch.from_numpy(np.stack([ev, ev]))})
    gb = ttr.RigidTransformation().compute(tb, torch.from_numpy(T2)
                                           ).descriptors["eigVectors"].numpy()
    for b in range(2):
        wb = np.asarray(jtr.RigidTransformation().compute(jc, jnp.asarray(T2[b]))
                        .descriptors["eigVectors"])
        np.testing.assert_allclose(gb[b], wb, atol=1e-6)


@pytest.mark.parametrize("name", ["RigidTransformation", "SimilarityTransformation",
                                  "PureTranslation"])
def test_transformation_compute(name):
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    nrm = rng.standard_normal((50, 3)).astype(np.float32)
    ev = rng.standard_normal((50, 9)).astype(np.float32)
    T = _yaw(0.4, [1.0, -2.0, 0.5], 1.3 if name == "SimilarityTransformation"
             else 1.0).astype(np.float32)
    descs = {"normals": nrm, "eigVectors": ev}
    jc = pm.PointCloud(jnp.asarray(pts), descriptors={k: jnp.asarray(v)
                                                      for k, v in descs.items()})
    tc = pt.PointCloud(torch.from_numpy(pts), descriptors={
        k: torch.from_numpy(v) for k, v in descs.items()})
    jo = jtr.TransformationRegistrar.create(name).compute(jc, jnp.asarray(T))
    to = ttr.TransformationRegistrar.create(name).compute(tc, torch.from_numpy(T))
    np.testing.assert_allclose(to.points.numpy(), np.asarray(jo.points), atol=1e-5)
    for k in descs:
        np.testing.assert_allclose(to.descriptors[k].numpy(),
                                   np.asarray(jo.descriptors[k]), atol=1e-5)


def test_check_correct_and_compute_checked():
    """check_parameters, correct_parameters and compute_checked as in JAX:
    a drifted rotation fails the rigid check, raises in compute_checked,
    and its correction passes and equals JAX's within 1e-6."""
    T = _yaw(0.2, [1, 2, 3]).astype(np.float32)
    bad = T.copy()
    bad[:3, :3] *= 1.01
    rigid_t, rigid_j = ttr.RigidTransformation(), jtr.RigidTransformation()
    pure_t, pure_j = ttr.PureTranslation(), jtr.PureTranslation()
    for t in (T, bad):
        assert rigid_t.check_parameters(torch.from_numpy(t)) == \
            rigid_j.check_parameters(jnp.asarray(t))
        assert pure_t.check_parameters(torch.from_numpy(t)) == \
            pure_j.check_parameters(jnp.asarray(t))
        for mod_t, mod_j in ((rigid_t, rigid_j), (pure_t, pure_j)):
            np.testing.assert_allclose(
                mod_t.correct_parameters(torch.from_numpy(t)).numpy(),
                np.asarray(mod_j.correct_parameters(jnp.asarray(t))), atol=1e-6)
    assert rigid_t.check_parameters(torch.from_numpy(T))
    assert not rigid_t.check_parameters(torch.from_numpy(bad))
    fixed = rigid_t.correct_parameters(torch.from_numpy(bad))
    assert rigid_t.check_parameters(fixed)
    np.testing.assert_allclose(fixed.numpy(), np.asarray(jse3.orthogonalize(
        jnp.asarray(bad))), atol=1e-6)
    np.testing.assert_allclose(tse3.orthogonalize(torch.from_numpy(np.stack([bad, T])))
                               [0].numpy(), fixed.numpy(), atol=1e-6)
    cloud = pt.PointCloud(torch.zeros((4, 3)))
    with pytest.raises(pt.TransformationError):
        rigid_t.compute_checked(cloud, torch.from_numpy(bad))
    rigid_t.compute_checked(cloud, torch.from_numpy(T))
    assert pure_t.check_parameters(pure_t.correct_parameters(torch.from_numpy(T)))


# ------------------------------------------------------------ configuration
def test_every_module_registered_with_jax_defaults():
    for reg_t, reg_j in ((tout.OutlierFilterRegistrar, jout.OutlierFilterRegistrar),
                         (tmin.ErrorMinimizerRegistrar, jmin.ErrorMinimizerRegistrar),
                         (ttr.TransformationRegistrar, jtr.TransformationRegistrar)):
        names = sorted(reg_j._classes)
        assert sorted(reg_t._classes) == names
        for name in names:
            assert reg_t.create(name).parameters == reg_j.create(name).parameters, name
    assert math.isinf(tout.RobustOutlierFilter().approximation)


YAML = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher:
  KDTreeMatcher
outlierFilters:
  - {outlier}
errorMinimizer: {minimizer}
transformationCheckers:
  - CounterTransformationChecker
"""


@pytest.mark.parametrize("minimizer", [n for n, _ in MINIMIZERS] +
                         ["PointToPlaneErrorMinimizer"])
def test_transformation_follows_minimizer(minimizer):
    text = YAML.format(outlier="RobustOutlierFilter:\n      robustFct: tukey",
                       minimizer=minimizer)
    icp_t = pt.ICP(device="cpu")
    icp_t.load_from_yaml(text)
    icp_j = pm.ICP()
    icp_j.load_from_yaml(text)
    assert [type(t).__name__ for t in icp_t.transformations] == \
        [type(t).__name__ for t in icp_j.transformations]
    assert [type(f).__name__ for f in icp_t.outlier_filters] == ["RobustOutlierFilter"]
    assert icp_t.outlier_filters[0].parameters == icp_j.outlier_filters[0].parameters
    with pytest.raises(RuntimeError, match="covariance"):
        icp_t.get_covariance()


def test_public_names():
    for name in ("ICPChainBase", "Matches", "OutlierFilterRegistrar",
                 "ErrorMinimizerRegistrar", "TransformationRegistrar",
                 "RigidTransformation", "SimilarityTransformation",
                 "PureTranslation", "TransformationError", "PointMatcherError",
                 "InvalidField", "ConfigurationError", "DataPointsFilterRegistrar",
                 "MatcherRegistrar", "TransformationCheckerRegistrar",
                 "InspectorRegistrar"):
        assert hasattr(pt, name) and name in pt.__all__, name
        a, b = getattr(pt, name), getattr(pm, name)
        assert getattr(a, "__name__", None) == getattr(b, "__name__", None)
        assert getattr(a, "interface_name", None) == getattr(b, "interface_name", None)
