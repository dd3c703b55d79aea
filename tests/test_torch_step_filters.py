"""Reading step filters against the JAX package on the CPU:
FixStepSampling's schedule table, host ``filter()`` sequence and
``mask_at_iteration`` (one scan, a batch with per-scan iterations),
SimpleSensorNoise, one-shot ``ICP`` with a FixStep step filter in the loop
and through the stepped driver, a RandomSampling step filter through the
stepped driver (the same rows each iteration), the YAML section, the queue
with FixStep against the batch, the queue's refusals, and the JAX batch
that drops a step filter without a schedule, which the port follows.

Scenes are synthetic (``test_torch_loop_chains.make_scene``: a
~2000-point room map, scans of 700-900 points). Held equal: tables,
masks, iteration counts, stop codes and the noise descriptor. Held within
tolerance: the one-shot poses within 1e-5 of JAX's and of the port's other
driver; the serving batch's within 1e-4 on rotation entries and 1e-4 ×
the scene extent on translation of JAX's (the module-parity rule: the
frameworks sum the normal equations in another order), and the queue's
within 1e-5 of the batch's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_chains import make_scene

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.filters.basic import (
    FixStepSamplingDataPointsFilter as JFixStep,
    SimpleSensorNoiseDataPointsFilter as JNoise)
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_batch
from libpointmatcher_tpu.parallel.stream import queue_eligible as jax_eligible

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.filters.basic import (
    FixStepSamplingDataPointsFilter, SimpleSensorNoiseDataPointsFilter)
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.parallel.stream import queue_eligible

CPU = "cpu"
SEED = 3
MAP_SEED = 5
SCHEDULES = [(25, 1, 1.4), (4, 1, 0.5), (8, 1, 0.5), (1, 10, 2.0), (10, 10, 1.0)]


def _params(sched):
    start, end, mult = sched
    return {"startStep": str(start), "endStep": str(end), "stepMult": str(mult)}


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _masked_rows(n=301, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    return pts, mask


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_table(sched):
    np.testing.assert_array_equal(
        FixStepSamplingDataPointsFilter(_params(sched))._schedule_table(),
        np.asarray(JFixStep(_params(sched))._schedule_table()))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_host_filter_sequence(sched):
    """Six calls of the host ``filter()`` on a masked cloud: the same masks
    as the JAX filter's, call by call, and the same step after ``init()``."""
    pts, mask = _masked_rows()
    ft, fj = FixStepSamplingDataPointsFilter(_params(sched)), JFixStep(_params(sched))
    ct = pt.PointCloud(torch.as_tensor(pts), torch.as_tensor(mask))
    cj = pm.PointCloud(pts, mask)
    for _ in range(6):
        np.testing.assert_array_equal(ft.filter(ct).mask.numpy(),
                                      np.asarray(fj.filter(cj).mask))
        assert ft.step == fj.step
    ft.init()
    fj.init()
    assert ft.step == fj.step == float(sched[0])


@pytest.mark.parametrize("sched", SCHEDULES[:3])
def test_mask_at_iteration(sched):
    """One scan at iterations 0..7 and 600 (past the table), and a batch
    of three scans at their own iterations (the queue's lanes), against
    the JAX filter (vmapped over the scans)."""
    f, fj = FixStepSamplingDataPointsFilter(_params(sched)), JFixStep(_params(sched))
    pts, mask = _masked_rows()
    for it in list(range(8)) + [600]:
        np.testing.assert_array_equal(
            f.mask_at_iteration(pt.PointCloud(torch.as_tensor(pts),
                                              torch.as_tensor(mask)), it).mask.numpy(),
            np.asarray(fj.mask_at_iteration(pm.PointCloud(pts, mask),
                                            jnp.int32(it)).mask))
    rows = [_masked_rows(seed=s) for s in range(3)]
    pts_b = np.stack([r[0] for r in rows])
    mask_b = np.stack([r[1] for r in rows])
    iters = np.array([0, 2, 5], np.int32)
    got = f.mask_at_iteration(pt.PointCloud(torch.as_tensor(pts_b),
                                            torch.as_tensor(mask_b)),
                              torch.as_tensor(iters)).mask.numpy()
    want = jax.vmap(lambda p, m, i: fj.mask_at_iteration(pm.PointCloud(p, m), i).mask)(
        jnp.asarray(pts_b), jnp.asarray(mask_b), jnp.asarray(iters))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("sensor", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("gain", [1.0, 2.5])
def test_simple_sensor_noise(sensor, gain):
    rng = np.random.default_rng(sensor)
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    params = {"sensorType": str(sensor), "gain": str(gain)}
    got = SimpleSensorNoiseDataPointsFilter(params).filter(
        pt.PointCloud.from_numpy(pts, device=CPU)).get_descriptor("simpleSensorNoise")
    want = JNoise(params).filter(pm.PointCloud.from_numpy(pts)).get_descriptor(
        "simpleSensorNoise")
    assert got.shape == (500, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:500])
    assert SimpleSensorNoiseDataPointsFilter.TRACEABLE


def _pair(scene):
    ref, scans, poses, inits, extent = scene
    T_init = np.linalg.inv(inits[0]) @ inits[1]
    return scans[1], scans[0], T_init, extent


def _engines(step_filter):
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    ij.set_default()
    it.set_default()
    name, params = step_filter
    ij.reading_step_filters = [pm.DataPointsFilterRegistrar.create(name, params)]
    it.reading_step_filters = [pt.DataPointsFilterRegistrar.create(name, params)]
    return ij, it


def _run(ij, it, scene):
    reading, reference, T_init, _ = _pair(scene)
    Tj = np.asarray(ij(pm.PointCloud.from_numpy(reading),
                       pm.PointCloud.from_numpy(reference), T_init, seed=SEED))
    Tt = it(pt.PointCloud.from_numpy(reading, device=CPU),
            pt.PointCloud.from_numpy(reference, device=CPU), T_init,
            seed=SEED).numpy()
    return Tj, Tt


def _assert_pose(Tt, Tj, extent):
    np.testing.assert_allclose(Tt[..., :3, :3], Tj[..., :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[..., :3, 3], Tj[..., :3, 3], atol=1e-4 * extent)


FIXSTEP = ("FixStepSamplingDataPointsFilter", _params((4, 1, 0.5)))


def test_icp_fixstep_in_loop_and_stepped(scene):
    """FixStep in the loop: JAX's iterations and stop, its pose within
    1e-5; the same chain forced through the port's stepped driver: the
    same iterations and the pose within 1e-5."""
    ij, it = _engines(FIXSTEP)
    assert it._step_chain_traced() and it._fused()
    Tj, Tt = _run(ij, it, scene)
    assert (it.last_iteration_count, it.max_num_iterations_reached) == \
        (ij.last_iteration_count, ij.max_num_iterations_reached)
    assert it.last_iteration_count > 1
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    stepped = pt.ICP(device=CPU)
    stepped.set_default()
    stepped.reading_step_filters = [FixStepSamplingDataPointsFilter(FIXSTEP[1])]
    stepped._step_chain_traced = lambda: False
    reading, reference, T_init, _ = _pair(scene)
    Ts = stepped(pt.PointCloud.from_numpy(reading, device=CPU),
                 pt.PointCloud.from_numpy(reference, device=CPU), T_init,
                 seed=SEED).numpy()
    assert stepped.last_iteration_count == it.last_iteration_count
    np.testing.assert_allclose(Ts, Tt, atol=1e-5)


def _record_masks(f, out, n):
    orig = f.filter

    def recorded(cloud, key=None, **kw):
        c = orig(cloud, key=key, **kw)
        out.append(np.asarray(c.mask)[:n].copy())
        return c

    f.filter = recorded


def test_random_sampling_step_filter_stepped(scene):
    """A RandomSampling step filter (no schedule: the stepped driver in
    both packages) keeps the same rows at each iteration, drawn from
    ``fold_in(fold_in(PRNGKey(seed), 3), iteration)``, and gives JAX's
    iterations and pose."""
    ij, it = _engines(("RandomSamplingDataPointsFilter", {"prob": "0.5"}))
    assert not it._fused()
    n = 900
    mj, mt = [], []
    _record_masks(ij.reading_step_filters[0], mj, n)
    _record_masks(it.reading_step_filters[0], mt, n)
    Tj, Tt = _run(ij, it, scene)
    assert it.last_iteration_count == ij.last_iteration_count == len(mt) == len(mj)
    n_rows = it.prefiltered_reading_pts_count
    assert n_rows == ij.prefiltered_reading_pts_count
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a[:n_rows], b[:n_rows])
        assert 0.3 * n_rows < a[:n_rows].sum() < 0.7 * n_rows
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)


def test_yaml_step_section():
    text = """
readingStepDataPointsFilters:
  - FixStepSamplingDataPointsFilter:
      startStep: 8
      endStep: 2
      stepMult: 0.5
  - RandomSamplingDataPointsFilter:
      prob: 0.9
matcher: KDTreeMatcher
errorMinimizer: PointToPointErrorMinimizer
"""
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    ij.load_from_yaml(text)
    it.load_from_yaml(text)
    assert [(type(f).__name__, f.parameters) for f in it.reading_step_filters] == \
        [(type(f).__name__, f.parameters) for f in ij.reading_step_filters]
    assert it._step_chain_traced() == ij._step_chain_traced() is False


def _sequences(ref, step_filters=()):
    js = pm.ICPSequence()
    js.set_default()
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    for name, params in step_filters:
        js.reading_step_filters.append(pm.DataPointsFilterRegistrar.create(name, params))
        ps.reading_step_filters.append(pt.DataPointsFilterRegistrar.create(name, params))
    return js, ps


def _serve(js, ps, scans, inits):
    Tj, ij = jax_batch(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=inits, seed=SEED)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    Tt, it = register_batch_to_map(ps, clouds, T_inits=inits, seed=SEED)
    return Tj, ij, Tt, it


def test_batch_and_queue_with_fixstep(scene):
    """The batch with FixStep in the loop gives JAX's batch per scan; the
    queue (two lanes, each lane's schedule at its own iteration) gives the
    batch's iterations and codes, and its poses within 1e-5."""
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, [FIXSTEP])
    Tj, ij, Tt, it = _serve(js, ps, scans, inits)
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    _assert_pose(Tt, Tj, extent)
    assert queue_eligible(ps) and jax_eligible(js)
    Tq, iq = register_queue_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED, lanes=2)
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(iq[key], it[key], err_msg=key)
    np.testing.assert_allclose(Tq, Tt, atol=1e-5)


def test_jax_batch_drops_hostful_step_filter(scene):
    """The JAX package's batch takes its host path for a step filter
    without a schedule and drops the filter there (a one-shot ``compute``
    applies it): with a RandomSampling step filter it gives the poses and
    iterations it gives with none. The port's batch does the same, and
    equals it."""
    ref, scans, poses, inits, extent = scene
    scans, inits = scans[:3], inits[:3]
    step = [("RandomSamplingDataPointsFilter", {"prob": "0.5"})]
    js, ps = _sequences(ref, step)
    Tj, ij, Tt, it = _serve(js, ps, scans, inits)
    js0, ps0 = _sequences(ref)
    Tj0, ij0, Tt0, it0 = _serve(js0, ps0, scans, inits)
    np.testing.assert_array_equal(ij["iterations"], ij0["iterations"])
    np.testing.assert_allclose(Tj, Tj0, atol=1e-5)
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
        np.testing.assert_array_equal(it[key], it0[key], err_msg=key)
    _assert_pose(Tt, Tj, extent)
    np.testing.assert_allclose(Tt, Tt0, atol=1e-5)
    # the queue serves such a chain as a batch, in both packages
    assert not queue_eligible(ps) and not jax_eligible(js)
    Tq, iq = register_queue_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED, lanes=2)
    np.testing.assert_array_equal(iq["iterations"], it["iterations"])
    np.testing.assert_array_equal(Tq, Tt)


def _set_case(seq, registrar, case):
    if case == "acceleration":
        seq.acceleration = "anderson"
    elif case == "vtk_dump":
        seq.inspector = registrar["inspector"].create(
            "VTKFileInspector", {"dumpReading": "1"})
    elif case == "random_step":
        seq.reading_step_filters = [registrar["filter"].create(
            "RandomSamplingDataPointsFilter", {"prob": "0.5"})]
    elif case == "fixstep":
        seq.reading_step_filters = [registrar["filter"].create(*FIXSTEP)]


@pytest.mark.parametrize("case", ["default", "acceleration", "vtk_dump",
                                  "random_step", "fixstep"])
def test_queue_eligible_as_jax(scene, case):
    js, ps = _sequences(scene[0])
    _set_case(js, {"inspector": pm.InspectorRegistrar,
                   "filter": pm.DataPointsFilterRegistrar}, case)
    _set_case(ps, {"inspector": pt.InspectorRegistrar,
                   "filter": pt.DataPointsFilterRegistrar}, case)
    assert queue_eligible(ps) == jax_eligible(js)
    assert queue_eligible(ps) == (case in ("default", "fixstep"))
