"""The point-to-plane kernel pair (``csrc/plane.cu``: ``plane_moments`` +
``plane_solve``) on the card against its plain version
(``ops/plane_cuda.py::point_to_plane_plain``) on the same CUDA inputs, and
``PointToPlaneErrorMinimizer`` on the card (the kernel) against its CPU
path (``torch.linalg.eigh``). Every test needs a CUDA device and skips
without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_plane_cuda.py

Inputs: the benchmark's shapes (32 scans x 25 000 points x k = 1 against
a 49 950-row map), one scan, a pair axis, k = 3, a scan with no valid
pair, and rank-deficient scenes (a floor alone, rank 3; a corridor, rank
5, also turned off the axes), each with masked rows, inf distances and
zero weights mixed in.

Tolerances: the integer statistics and the used ratio are equal (the same
counts). The kernel sums the moments in another order than the plain
version (a tree against the GEMM of the minimizer's torch body), and each lies within 5e-7 ×
‖x‖∞ of the float64 solution on these scenes (the plain version, measured
on the CPU), so x is held within 1e-5 × ‖x‖∞, and 4e-7 more for the
float32 rounding of the rotation's entries near 1. Against the CPU path,
whose eigensolver is another, 2e-5 × ‖x‖∞ (ROADMAP Queue 3 #40 found the
two within 7e-6). The dropped eigenvalues of the rank-deficient scenes lie
30 times or more under the cutoff, so both versions drop the same ones.
The weight and residual sums: 1e-5 relative (two float32 orders of at most
10^6 positive terms). Two launches on the same inputs give the same bits
(a fixed partition and reduction order, no atomics).
"""

import sys
from pathlib import Path

import pytest
import torch

from libpointmatcher_tpu_torch.cloud import PointCloud
from libpointmatcher_tpu_torch.matchers import Matches
from libpointmatcher_tpu_torch.minimizers import PointToPlaneErrorMinimizer
from libpointmatcher_tpu_torch.ops import plane_cuda as pc
from libpointmatcher_tpu_torch.utils import se3

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
from plane_micro import make_scene as _scene  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(reading, reference, weights, matches):
    return (reading.points, reading.mask, reference.points,
            reference.get_descriptor("normals"), matches.dists, matches.ids,
            weights)


def _x(T):
    T = T.double().cpu()
    return torch.cat([se3.log_rotation(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def _assert_poses_close(T, T_ref, rel):
    x, x_ref = _x(T), _x(T_ref)
    scale = x_ref.abs().amax(dim=-1, keepdim=True)
    err = (x - x_ref).abs()
    assert torch.all(err <= rel * scale + 4e-7), float((err / scale).max())


def _assert_stats(out, ref, rtol=1e-5):
    for a, b in ((out.point_used_ratio, ref.point_used_ratio),
                 (out.rejected_matches, ref.rejected_matches),
                 (out.rejected_points, ref.rejected_points)):
        assert torch.equal(a.cpu(), b.cpu())
    assert out.rejected_matches.dtype == torch.int32
    torch.testing.assert_close(out.weighted_point_used_ratio.cpu(),
                               ref.weighted_point_used_ratio.cpu(), rtol=rtol, atol=0)
    torch.testing.assert_close(out.residual.cpu(), ref.residual.cpu(), rtol=rtol,
                               atol=0)


CASES = {
    "cell": {"B": 32, "n": 25000, "m": 49950},
    "one_scan": {"B": 1, "n": 25000, "m": 49950},
    "pair_axis": {"B": 4, "n": 3000, "m": 5000, "pair": True},
    "k3": {"B": 8, "n": 9000, "m": 20000, "k": 3},
    "floor": {"B": 8, "n": 25000, "m": 20000, "shape": "floor"},
    "corridor": {"B": 8, "n": 25000, "m": 20000, "shape": "corridor"},
    "floor_rotated": {"B": 8, "n": 25000, "m": 20000, "shape": "floor",
                      "rotate": True},
    "corridor_rotated": {"B": 8, "n": 25000, "m": 20000, "shape": "corridor",
                         "rotate": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain(cuda, case):
    kw = CASES[case]
    reading, reference, weights, matches = _scene(11, cuda, **kw)
    args = _args(reading, reference, weights, matches)
    if case == "one_scan":
        pts, mask, ref_p, ref_n, d, ids, w = args
        args = (pts[0], mask[0], ref_p, ref_n, d[0], ids[0], w[0])
    pc.reset_launch_counts()
    out = pc.point_to_plane(*args)
    ref = pc.point_to_plane_plain(*args)
    torch.cuda.synchronize()
    assert pc.point_to_plane.launches == 1
    assert out.T.shape == ref.T.shape and out.residual.shape == ref.residual.shape
    _assert_poses_close(out.T, ref.T, 1e-5)
    _assert_stats(out, ref)
    again = pc.point_to_plane(*args)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_scan_without_a_valid_pair(cuda):
    reading, reference, weights, matches = _scene(12, cuda, B=4, n=5000, m=8000)
    d = matches.dists.clone()
    d[1] = float("inf")
    w = weights.clone()
    w[2] = 0.0
    out = pc.point_to_plane(reading.points, reading.mask, reference.points,
                            reference.get_descriptor("normals"), d, matches.ids, w)
    ref = pc.point_to_plane_plain(reading.points, reading.mask, reference.points,
                                  reference.get_descriptor("normals"), d,
                                  matches.ids, w)
    torch.cuda.synchronize()
    eye = torch.eye(4, device=cuda)
    for b in (1, 2):
        assert torch.equal(out.T[b], eye)
        assert float(out.residual[b]) == float(out.point_used_ratio[b]) == 0.0
    assert out.rejected_matches[1] == 0
    _assert_stats(out, ref)


def test_non_finite_system_gives_a_non_finite_pose(cuda):
    reading, reference, weights, matches = _scene(13, cuda, B=2, n=2000, m=3000)
    valid = torch.isfinite(matches.dists[0, :, 0]) & (weights[0, :, 0] != 0)
    pts = reading.points.clone()
    pts[0, int(torch.nonzero(valid)[0, 0])] = float("nan")
    out = pc.point_to_plane(pts, reading.mask, reference.points,
                            reference.get_descriptor("normals"), matches.dists,
                            matches.ids, weights)
    torch.cuda.synchronize()
    assert not torch.isfinite(out.T[0]).all()
    assert torch.isfinite(out.T[1]).all()


@pytest.mark.parametrize("case", ["cell", "pair_axis", "k3", "floor_rotated"])
def test_minimizer_on_card_matches_cpu_path(cuda, case):
    """``PointToPlaneErrorMinimizer.compute`` takes the kernel on the card
    (one launch, T and statistics) and agrees with its CPU path."""
    kw = CASES[case]
    reading, reference, weights, matches = _scene(14, cuda, **kw)
    m = PointToPlaneErrorMinimizer()
    assert m._kernel_path(reading)
    pc.reset_launch_counts()
    T, st = m.compute(reading, reference, weights, matches)
    torch.cuda.synchronize()
    assert pc.point_to_plane.launches == 1
    cpu = (PointCloud(reading.points.cpu(), reading.mask.cpu()),
           PointCloud(reference.points.cpu(), descriptors={
               "normals": reference.get_descriptor("normals").cpu()}),
           weights.cpu(), Matches(matches.dists.cpu(), matches.ids.cpu()))
    Tc, stc = m.compute(*cpu)
    _assert_poses_close(T, Tc, 2e-5)
    assert torch.equal(st.point_used_ratio.cpu(), stc.point_used_ratio)
    assert torch.equal(st.nb_rejected_matches.cpu(), stc.nb_rejected_matches)
    assert torch.equal(st.nb_rejected_points.cpu(), stc.nb_rejected_points)
    torch.testing.assert_close(st.weighted_point_used_ratio.cpu(),
                               stc.weighted_point_used_ratio, rtol=1e-5, atol=0)
    torch.testing.assert_close(st.residual.cpu(), stc.residual, rtol=1e-5, atol=0)
    assert st.covariance is None


def test_force2d_and_force4dof_keep_the_torch_solve(cuda):
    reading, reference, weights, matches = _scene(15, cuda, B=2, n=2000, m=3000)
    for params in ({"force2D": "1"}, {"force4DOF": "1"}):
        m = PointToPlaneErrorMinimizer(params)
        pc.reset_launch_counts()
        m.compute(reading, reference, weights, matches)
        assert pc.point_to_plane.launches == 0
