"""Modules of the port (libpointmatcher_tpu_torch) against their JAX
counterparts on the same numpy inputs, on the CPU.

Tolerances: order statistics and masks are compared exactly; sums over a
few thousand float32 terms are compared at rtol 1e-5 (the two frameworks
add in another order); normals up to sign, which point-to-plane ignores.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu import checkers as jchk
from libpointmatcher_tpu.cloud import bucket_size
from libpointmatcher_tpu.filters.basic import RandomSamplingDataPointsFilter as JRS
from libpointmatcher_tpu.filters.normals import (
    SamplingSurfaceNormalDataPointsFilter as JSSN)
from libpointmatcher_tpu.matchers import Matches as JMatches
from libpointmatcher_tpu.minimizers import PointToPlaneErrorMinimizer as JP2P
from libpointmatcher_tpu.minimizers import solve_possibly_underdetermined as jsolve
from libpointmatcher_tpu.outlierfilters import TrimmedDistOutlierFilter as JTrim
from libpointmatcher_tpu.utils.masked import masked_quantile as jquantile

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import checkers as tchk
from libpointmatcher_tpu_torch.filters.basic import RandomSamplingDataPointsFilter
from libpointmatcher_tpu_torch.filters.normals import (
    SamplingSurfaceNormalDataPointsFilter)
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher, Matches
from libpointmatcher_tpu_torch.minimizers import (
    PointToPlaneErrorMinimizer, solve_possibly_underdetermined)
from libpointmatcher_tpu_torch.outlierfilters import TrimmedDistOutlierFilter
from libpointmatcher_tpu_torch.registry import Param, Parametrizable
from libpointmatcher_tpu_torch.utils.masked import masked_quantile

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _scene(n, seed):
    """Points on a few axis planes and a tilted one: well-defined normals."""
    rng = np.random.default_rng(seed)
    k = n // 4
    parts = [np.c_[rng.uniform(0, 5, k), rng.uniform(0, 4, k), np.zeros(k)],
             np.c_[rng.uniform(0, 5, k), np.zeros(k), rng.uniform(0, 3, k)],
             np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 3, k)]]
    a, b = rng.uniform(0, 2, n - 3 * k), rng.uniform(0, 2, n - 3 * k)
    parts.append(np.c_[2 + a, 1 + b, 0.5 + 0.3 * a + 0.2 * b])
    return (np.concatenate(parts)
            + 0.002 * rng.standard_normal((n, 3))).astype(np.float32)


def _jax_draw(seed, stream, n):
    """The JAX engine's draw for the first filter of a chain on a cloud
    built by from_numpy (padded to the bucket ladder), cut to its rows."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), stream), 0)
    return np.asarray(jax.random.uniform(key, (bucket_size(n),)))[:n]


@pytest.mark.parametrize("q", [0.0, 0.5, 0.85, 0.999, 1.0])
def test_masked_quantile_bit_equal(q):
    rng = np.random.default_rng(1)
    v = rng.exponential(size=(997, 2)).astype(np.float32)
    v[::7, 0] = np.inf
    v[3, 1] = np.nan
    v[10:20, 1] = v[0, 0]                         # repeated values
    got = masked_quantile(torch.from_numpy(v), q).numpy()
    want = np.asarray(jquantile(jnp.asarray(v), q))
    assert got.tobytes() == want.tobytes()


def test_minimal_norm_solve_singular_planar():
    """All pairs on the plane z = 0 with normal +z: the 6x6 normal matrix
    has rank 3; the solve must be the minimal-norm one, as in JAX."""
    rng = np.random.default_rng(2)
    p = np.c_[rng.uniform(-5, 5, (400, 2)), np.zeros(400)].astype(np.float32)
    n = np.tile(np.float32([0, 0, 1]), (400, 1))
    F = np.c_[np.cross(p, n), n].astype(np.float32)
    dot = (0.05 + 0.01 * p[:, 0] - 0.02 * p[:, 1]).astype(np.float32)
    A = (F.T @ F).astype(np.float32)
    b = -(F.T @ dot).astype(np.float32)
    got = solve_possibly_underdetermined(torch.from_numpy(A), torch.from_numpy(b))
    want = np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # the unobservable directions (x, y translation; yaw) stay exactly 0
    np.testing.assert_allclose(got.numpy()[[2, 3, 4]], 0.0, atol=1e-6)


def test_random_sampling_with_jax_draws():
    pts = _scene(1000, 3)
    cj = JRS().filter(pm.PointCloud.from_numpy(pts),
                      key=jax.random.fold_in(jax.random.fold_in(
                          jax.random.PRNGKey(4), 2), 0))
    f = RandomSamplingDataPointsFilter()
    f.uniform = _jax_draw(4, 2, 1000)
    ct = f.filter(pt.PointCloud.from_numpy(pts, device=CPU))
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask)[:1000])


@pytest.mark.parametrize("params", [
    {},
    {"samplingMethod": "1"},
    {"samplingMethod": "1", "averageExistingDescriptors": "0"},
    {"keepDensities": "1", "keepEigenValues": "1", "keepEigenVectors": "1"},
    {"maxBoxDim": "0.3", "knn": "12"},
])
def test_sampling_surface_normal_with_jax_draws(params):
    pts = _scene(3000, 5)
    inten = np.linspace(0, 1, 3000, dtype=np.float32)[:, None]
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(6), 1), 0)
    cj = JSSN(params).filter(pm.PointCloud.from_numpy(pts, {"intensity": inten}),
                             key=key)
    f = SamplingSurfaceNormalDataPointsFilter(params)
    f.uniform = _jax_draw(6, 1, 3000)
    ct = f.filter(pt.PointCloud.from_numpy(pts, {"intensity": inten}, device=CPU))
    keep = np.asarray(cj.mask)[:3000]
    assert keep.sum() > 100
    np.testing.assert_array_equal(ct.mask.numpy(), keep)
    np.testing.assert_allclose(ct.points.numpy()[keep],
                               np.asarray(cj.points)[:3000][keep], atol=1e-6)
    assert sorted(ct.descriptors) == sorted(cj.descriptors)
    for name, vt in ct.descriptors.items():
        vt = vt.numpy()[keep]
        vj = np.asarray(cj.descriptors[name])[:3000][keep]
        if name == "normals":
            # eigenvectors are defined up to sign
            vt = vt * np.sign(np.sum(vj * vt, axis=1))[:, None]
        if name == "eigVectors":
            vt, vj = np.abs(vt), np.abs(vj)
        np.testing.assert_allclose(vt, vj, rtol=1e-4, atol=2e-5, err_msg=name)


def _matches(seed, n=800, m=1200):
    rng = np.random.default_rng(seed)
    read = _scene(n, seed)
    ref = _scene(m, seed + 1)
    rn = np.tile(np.float32([0, 0, 1]), (m, 1))
    rn[m // 4:m // 2] = [0, 1, 0]
    rn[m // 2:3 * m // 4] = [1, 0, 0]
    d = rng.exponential(0.01, (n, 1)).astype(np.float32)
    ids = rng.integers(0, m, (n, 1)).astype(np.int32)
    d[::17] = np.inf
    ids[::17] = -1
    return read, ref, rn, d, ids


def test_trimmed_dist_weights():
    read, ref, rn, d, ids = _matches(7)
    wj = np.asarray(JTrim({"ratio": "0.85"}).compute(
        None, None, JMatches(jnp.asarray(d), jnp.asarray(ids)), ())[0])
    wt = TrimmedDistOutlierFilter({"ratio": "0.85"}).compute(
        None, None, Matches(torch.from_numpy(d), torch.from_numpy(ids)), ())[0].numpy()
    np.testing.assert_array_equal(wt, wj)


@pytest.mark.parametrize("params", [{}, {"force2D": "1"}, {"force4DOF": "1"}])
def test_point_to_plane_transform_and_stats(params):
    read, ref, rn, d, ids = _matches(8)
    w = (np.isfinite(d) & (np.arange(len(d))[:, None] % 5 != 0)).astype(np.float32)
    jr = pm.PointCloud(jnp.asarray(read))
    jf = pm.PointCloud(jnp.asarray(ref), descriptors={"normals": jnp.asarray(rn)})
    Tj, sj = JP2P(params).compute(jr, jf, jnp.asarray(w),
                                   JMatches(jnp.asarray(d), jnp.asarray(ids)))
    tr = pt.PointCloud(torch.from_numpy(read))
    tf = pt.PointCloud(torch.from_numpy(ref), descriptors={"normals": torch.from_numpy(rn)})
    Tt, st = PointToPlaneErrorMinimizer(params).compute(
        tr, tf, torch.from_numpy(w), Matches(torch.from_numpy(d), torch.from_numpy(ids)))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)
    for a, b in ((st.point_used_ratio, sj.point_used_ratio),
                 (st.weighted_point_used_ratio, sj.weighted_point_used_ratio),
                 (st.residual, sj.residual)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert int(st.nb_rejected_matches) == int(sj.nb_rejected_matches)
    assert int(st.nb_rejected_points) == int(sj.nb_rejected_points)


def _pose(angle, t):
    c, s = np.cos(angle), np.sin(angle)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


@pytest.mark.parametrize("name,params", [
    ("CounterTransformationChecker", {"maxIterationCount": "4"}),
    ("DifferentialTransformationChecker", {}),
    ("BoundTransformationChecker", {"maxRotationNorm": "0.1",
                                    "maxTranslationNorm": "0.3"}),
])
def test_checker_codes(name, params):
    """Stop flags and codes over a converging, then diverging, sequence."""
    seq = [_pose(0.02 / (i + 1) ** 2, [0.1 / (i + 1) ** 2, 0, 0]) for i in range(8)]
    seq += [_pose(0.3, [0.5, 0, 0]), _pose(np.nan, [0, 0, 0])]
    jc = getattr(jchk, name)(params)
    tc = getattr(tchk, name)(params)
    js = jc.init_state(jnp.eye(4, dtype=jnp.float32))
    ts = tc.init_state(torch.eye(4))
    for i, T in enumerate(seq):
        js, jstop, jcode = jc.check(js, jnp.asarray(T), i)
        ts, tstop, tcode = tc.check(ts, torch.from_numpy(T), i)
        assert (bool(tstop), int(tcode)) == (bool(jstop), int(jcode)), i


def test_registry_defaults_and_validation():
    m = KDTreeMatcher()
    assert (m.knn, m.epsilon, m.maxDist) == (1, 0.0, float("inf"))
    assert KDTreeMatcher({"knn": "3", "maxDist": "inf"}).knn == 3
    with pytest.raises(pt.InvalidParameter):
        KDTreeMatcher({"knnn": "3"})
    with pytest.raises(pt.InvalidParameter):
        KDTreeMatcher({"knn": "0"})
    with pytest.raises(pt.InvalidParameter):
        SamplingSurfaceNormalDataPointsFilter({"ratio": "1.5"})

    class Two(Parametrizable):
        PARAMS = (Param("a", "doc", int, 2), Param("b", "doc", bool, True))

    assert (Two().a, Two({"b": "0"}).b) == (2, False)
    # the same parameter dict means the same module on both sides
    for cls_t, cls_j in ((SamplingSurfaceNormalDataPointsFilter, JSSN),
                         (TrimmedDistOutlierFilter, JTrim),
                         (KDTreeMatcher, pm.matchers.KDTreeMatcher)):
        assert cls_t().parameters == cls_j().parameters


DEFAULT_YAML = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.75
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher:
  KDTreeMatcher:
    knn: 1
outlierFilters:
  - TrimmedDistOutlierFilter:
      ratio: 0.85
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker
  - DifferentialTransformationChecker
inspector: NullInspector
"""


@pytest.mark.parametrize("yaml_text,error", [
    (DEFAULT_YAML, None),
    (DEFAULT_YAML.replace("KDTreeMatcher", "NoSuchMatcher"), pt.InvalidModuleType),
    (DEFAULT_YAML.replace("matcher:", "matchr:"), pt.InvalidModuleType),
    (DEFAULT_YAML.replace("knn: 1", "knn: 1\n    foo: 2"), pt.InvalidParameter),
    (DEFAULT_YAML.replace("ratio: 0.85", "ratio: 2"), pt.InvalidParameter),
])
def test_yaml_chain(yaml_text, error):
    icp = pt.ICP(device=CPU)
    if error is not None:
        with pytest.raises(error):
            icp.load_from_yaml(yaml_text)
        return
    icp.load_from_yaml(yaml_text)
    ref = pt.ICP(device=CPU)
    ref.set_default()
    for a, b in ((icp.reading_filters, ref.reading_filters),
                 (icp.reference_filters, ref.reference_filters),
                 ([icp.matcher], [ref.matcher]),
                 (icp.outlier_filters, ref.outlier_filters),
                 ([icp.error_minimizer], [ref.error_minimizer]),
                 (icp.checkers, ref.checkers)):
        assert [(type(x), x.parameters) for x in a] == \
            [(type(x), x.parameters) for x in b]


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.PointCloud.from_numpy(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ICP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ICPSequence()
    assert pt.PointCloud.from_numpy(pts, device=CPU).device.type == "cpu"
    assert pt.ICPSequence(device=CPU).device.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys, libpointmatcher_tpu_torch as p; p.ICP(device='cpu'); "
            "import libpointmatcher_tpu_torch.config, "
            "libpointmatcher_tpu_torch.state, "
            "libpointmatcher_tpu_torch.filters.sampling, "
            "libpointmatcher_tpu_torch.filters.descriptor; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'libpointmatcher_tpu' or m.startswith('libpointmatcher_tpu.')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax():
    for path in list((REPO / "libpointmatcher_tpu_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        # no filter loads the JAX package's compiled library
        assert "libpm_native" not in path.read_text(), path
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "libpointmatcher_tpu"), \
                    f"{path}: {line}"
