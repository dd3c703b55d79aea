"""The queue's coarse-to-fine schedule: the port's ``register_queue_to_map``
with ``coarse`` against the JAX package's on the CPU, on the four routes of
tests/test_torch_queue.py and at the same tolerances. ``(4, 16, 1.0)`` is
the JAX package's bench schedule; ``(4, 12)`` takes the default 2x
loosening of the differential thresholds. The iteration counts held equal
are the fine pass's, as both packages report them; the fine pass starts from
the coarse pass's poses, so they agree only if the coarse passes do.
"""

import numpy as np
import pytest
from test_torch_batch import interpret_mode  # noqa: F401
from test_torch_queue import (assert_routes_agree, assert_same, force_route,
                              queue_both, scene)  # noqa: F401

from libpointmatcher_tpu_torch.checkers import (
    BoundTransformationChecker, CounterTransformationChecker,
    DifferentialTransformationChecker)
from libpointmatcher_tpu_torch.parallel import register_queue_to_map
from libpointmatcher_tpu_torch.parallel.stream import (_coarse_checkers,
                                                       _compact_rows,
                                                       _decimate_mask)
from libpointmatcher_tpu_torch.cloud import PointCloud

import torch


@pytest.mark.parametrize("coarse", [(4, 16, 1.0), (4, 12)])
@pytest.mark.parametrize("route", ["dense", "K3", "K4", "K6"])
def test_coarse_to_fine_matches_jax(scene, monkeypatch, interpret_mode, route,
                                    coarse):
    params = force_route(monkeypatch, route)
    jax_out, port_out, js, ps = queue_both(scene, params, coarse=coarse)
    assert_same(jax_out, port_out, scene)
    assert_routes_agree(js, ps, route)


def test_coarse_pass_parts():
    """The decimation keeps every 4th valid row in order, the compaction
    packs them to the front, the coarse checkers cap the counter and loosen
    the differential thresholds, and decim < 2 runs the fine pass alone."""
    mask = torch.tensor([[True, False, True, True, True, True, False, True,
                          True, True]])
    pts = torch.arange(10, dtype=torch.float32)[None, :, None].expand(1, 10, 3)
    cloud = _decimate_mask(PointCloud(pts, mask), 4)
    # valid rows 0 2 3 4 5 7 8 9 rank 0..7: ranks 0 and 4 stay
    assert cloud.mask[0].nonzero().flatten().tolist() == [0, 5]
    packed = _compact_rows(cloud, 3)
    assert packed.points[0, :, 0].tolist() == [0.0, 5.0, 1.0]
    assert packed.mask[0].tolist() == [True, True, False]

    class Seq:
        checkers = [CounterTransformationChecker({"maxIterationCount": "40"}),
                    DifferentialTransformationChecker(
                        {"minDiffRotErr": "0.001", "minDiffTransErr": "0.01",
                         "smoothLength": "4"}),
                    BoundTransformationChecker()]

    cnt, diff, bound = _coarse_checkers(Seq, 12)
    assert cnt.maxIterationCount == 12 and bound is Seq.checkers[2]
    assert (diff.minDiffRotErr, diff.minDiffTransErr, diff.smoothLength) == (
        pytest.approx(0.002), pytest.approx(0.02), 4)
    Seq.checkers = Seq.checkers[1:]
    assert _coarse_checkers(Seq, 7, 3.0)[-1].maxIterationCount == 7


def test_decim_below_two_disables_the_schedule(scene):
    from test_torch_queue import port_sequence, SEED, LANES
    import libpointmatcher_tpu_torch as pt

    ref, scans, _, inits, _ = scene
    ps = port_sequence(ref)
    clouds = [pt.PointCloud.from_numpy(s, device="cpu") for s in scans[:2]]
    Tq, iq = register_queue_to_map(ps, clouds, T_inits=inits[:2], seed=SEED,
                                   lanes=LANES)
    Tc, ic = register_queue_to_map(ps, clouds, T_inits=inits[:2], seed=SEED,
                                   lanes=LANES, coarse=(1, 16))
    np.testing.assert_array_equal(Tc, Tq)
    np.testing.assert_array_equal(ic["iterations"], iq["iterations"])
