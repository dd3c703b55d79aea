"""The port's telemetry (``libpointmatcher_tpu_torch/telemetry.py``): call
records, spans and counters of the serving drivers, the engine and the
step, on tiny scenes through the port's plain kernels on the CPU.

The host syncs of a two-scan batch on the CPU, on the dense route (a map
under 16 384 rows), each registration stopped by a Counter of ``ITERS``
steps: the reading chain compacts each scan once (2 ``torch.nonzero``),
each step reads the minimizer's eigh error flags (``ITERS``) and the
scans' flags (``ITERS``) on the host, and ``finish`` copies the poses and
the five per-scan fields of ``info`` (6). The copies from host memory
(poses, scans, draw keys) do not happen on a CPU engine and are not
counted: 2 + 2·ITERS + 6.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.cloud import PointCloud
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)

CPU = "cpu"
ITERS = 4
SCANS = 2
LANES = 2
QUEUE = 4
STEP_SPANS = ("step.filters", "step.match", "step.outliers", "step.minimize",
              "step.check")


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _room(rng, n):
    """Points on the floor, two walls and a box of a small room."""
    faces = []
    for _ in range(n):
        k = rng.integers(4)
        u, v = rng.uniform(0, 1, 2)
        faces.append([(3 * u, 2 * v, 0.0), (3 * u, 0.0, 1.5 * v),
                      (0.0, 2 * u, 1.5 * v), (1 + 0.4 * u, 1 + 0.4 * v, 0.5)][k])
    return np.asarray(faces)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(24)
    world = _room(rng, 3000)
    ref = world[:1500].astype(np.float32)
    scans, inits = [], []
    for i in range(QUEUE):
        rows = world[rng.choice(len(world), 500, replace=False)]
        T = _pose(0.02 * (i - 1), [0.03, -0.02 + 0.01 * i, 0.01])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        inits.append(_pose(0.005, [0.01, 0.0, 0.0]) @ T)
    return ref, scans, inits


@pytest.fixture(autouse=True)
def default_level():
    telemetry.set_level("spans")
    telemetry.reset()
    yield
    telemetry.set_level("spans")
    telemetry.reset()


def _sequence(ref):
    seq = pt.ICPSequence(device=CPU)
    seq.set_default()
    seq.checkers = [CounterTransformationChecker({"maxIterationCount": str(ITERS)})]
    seq.set_map(PointCloud.from_numpy(ref, device=CPU), seed=5)
    return seq


def _clouds(scans):
    return [PointCloud.from_numpy(s, device=CPU) for s in scans]


def _serve(scene, level):
    """One batch of ``SCANS`` and one queue of ``QUEUE`` scans at ``level``
    → (outputs, the two call records)."""
    ref, scans, inits = scene
    seq = _sequence(ref)
    telemetry.set_level(level)
    telemetry.reset()
    out = [register_batch_to_map(seq, _clouds(scans[:SCANS]),
                                 T_inits=inits[:SCANS], seed=3),
           register_queue_to_map(seq, _clouds(scans), T_inits=inits, seed=3,
                                 lanes=LANES)]
    return out, telemetry.snapshot()


@pytest.fixture(scope="module")
def served(scene):
    return {level: _serve(scene, level) for level in ("off", "spans", "detail")}


def test_one_record_per_call_with_steps_and_slots(served):
    (batch, queue), recs = served["spans"]
    assert [r["entry"] for r in recs] == ["register_batch_to_map",
                                          "register_queue_to_map"]
    assert recs[0]["id"] + 1 == recs[1]["id"]
    for rec, (T, info), width, rounds in zip(recs, (batch, queue),
                                             (SCANS, LANES), (1, QUEUE // LANES)):
        c = rec["counters"]
        steps = int(info["iterations"].max()) * rounds
        assert c["steps"] == steps == rec["spans"]["step"]["count"]
        assert len(T) == len(info["iterations"]) == rounds * width
        for name in STEP_SPANS + ("flag_wait", "merge"):
            assert rec["spans"][name]["count"] == steps, name
        assert rec["spans"]["loop"]["count"] == 1
        for name in ("prep", "prep.upload", "prep.chain", "prep.order",
                     "prep.stack", "finish", "call"):
            assert rec["spans"][name]["count"] == 1, name
        assert rec["start"] <= rec["end"]
    assert "lane_swap" not in recs[0]["spans"]
    assert recs[1]["spans"]["lane_swap"]["count"] == QUEUE // LANES


def test_host_syncs_of_a_two_scan_batch(served):
    """The count the module docstring derives."""
    (batch, _), recs = served["spans"]
    assert int(batch[1]["iterations"].max()) == ITERS
    assert recs[0]["counters"]["host_syncs"] == 2 + 2 * ITERS + 6


@pytest.mark.parametrize("level", ["spans", "detail"])
def test_pending_result_adds_its_finish_to_the_call(scene, served, level):
    """``block=False`` returns before ``finish``; ``result()`` adds the span
    and its host syncs to the dispatching call's record."""
    ref, scans, inits = scene
    seq = _sequence(ref)
    (blocked, _), recs = served[level]
    telemetry.set_level(level)
    telemetry.reset()
    pending = [register_batch_to_map(seq, _clouds(scans[:SCANS]),
                                     T_inits=inits[:SCANS], seed=3,
                                     block=False),
               register_queue_to_map(seq, _clouds(scans), T_inits=inits,
                                     seed=3, lanes=LANES, block=False)]
    assert all("finish" not in r["spans"] for r in telemetry.snapshot())
    outs = [p.result() for p in pending]
    assert np.array_equal(outs[0][0], blocked[0])
    after = telemetry.snapshot()
    for rec, full in zip(after, recs):
        assert rec["spans"]["finish"]["count"] == 1
        assert rec["counters"] == full["counters"]
    if level == "detail":
        ev = after[0]["events"]
        assert ev[-1]["name"] == "finish" and ev[-1]["parent"] == -1
        assert ev[-1]["start"] >= after[0]["end"]


def test_one_shot_records_its_two_preps(scene):
    ref, scans, inits = scene
    icp = pt.ICP(device=CPU)
    icp.set_default()
    icp.checkers = [CounterTransformationChecker({"maxIterationCount": "2"})]
    icp(PointCloud.from_numpy(scans[0], device=CPU),
        PointCloud.from_numpy(ref, device=CPU), inits[0], seed=1)
    rec, = telemetry.snapshot()
    assert rec["entry"] == "ICP.compute"
    assert rec["spans"]["prep"]["count"] == 2
    assert rec["spans"]["loop"]["count"] == 1
    assert rec["counters"]["steps"] == rec["spans"]["step"]["count"] == 2


def test_detail_spans_nest_in_their_call(served):
    _, recs = served["detail"]
    for rec in recs:
        ev = rec["events"]
        assert ev[0]["name"] == "call" and ev[0]["parent"] == -1
        assert ev[0]["start"] == rec["start"] and ev[0]["end"] == rec["end"]
        for i, e in enumerate(ev[1:], 1):
            p = ev[e["parent"]]
            assert 0 <= e["parent"] < i
            assert p["start"] <= e["start"] <= e["end"] <= p["end"]
        # the step modules under the step, the step under the loop
        names = {e["name"]: ev[e["parent"]]["name"] for e in ev[1:]}
        assert all(names[n] == "step" for n in STEP_SPANS)
        assert names["step"] == "loop" and names["prep.chain"] == "prep"
        # self time: duration less what the children cover
        own = {}
        child = [0.0] * len(ev)
        for e in ev[1:]:
            child[e["parent"]] += e["end"] - e["start"]
        for e, c in zip(ev, child):
            own[e["name"]] = own.get(e["name"], 0.0) + (e["end"] - e["start"]) - c
        for name, s in rec["spans"].items():
            assert s["self_s"] == pytest.approx(own[name], rel=1e-6, abs=1e-9)


def test_spans_level_keeps_the_same_tree_without_events(served):
    _, spans = served["spans"]
    _, detail = served["detail"]
    for a, b in zip(spans, detail):
        assert a["events"] is None and b["events"] is not None
        assert {k: v["count"] for k, v in a["spans"].items()} == \
            {k: v["count"] for k, v in b["spans"].items()}
        for rec in (a, b):
            # the self times of every name add up to the call
            total = sum(v["self_s"] for v in rec["spans"].values())
            assert total == pytest.approx(rec["end"] - rec["start"], rel=1e-6)
        # the same counters, and at detail only the detail counter of the
        # minimizer's route: one value a step, the torch solve on the CPU
        detail_only = {"minimize_kernel_share": [0.0] * b["counters"]["steps"]}
        assert {**a["counters"], **detail_only} == b["counters"]


def test_off_records_nothing_and_serves_the_same(served):
    outs_off, recs = served["off"]
    assert recs == []
    for level in ("spans", "detail"):
        outs, _ = served[level]
        for (T0, i0), (T1, i1) in zip(outs_off, outs):
            assert np.array_equal(T0, T1)
            assert np.array_equal(i0["iterations"], i1["iterations"])
            assert np.array_equal(i0["codes"], i1["codes"])


def test_records_are_bounded():
    for i in range(telemetry.MAX_CALLS + 10):
        with telemetry.call("x"):
            with telemetry.span("prep"):
                pass
    recs = telemetry.snapshot()
    assert len(recs) == telemetry.MAX_CALLS
    assert recs[-1]["id"] - recs[0]["id"] == telemetry.MAX_CALLS - 1
    assert telemetry.calls_between(recs[-1]["start"], recs[-1]["start"]) == [recs[-1]]
    telemetry.reset()
    with telemetry.call("x"):
        pass
    assert [r["id"] for r in telemetry.snapshot()] == [1]


def test_detail_keeps_events_of_the_newest_calls_only():
    telemetry.set_level("detail")
    for _ in range(telemetry.DETAIL_CALLS + 3):
        with telemetry.call("x"):
            telemetry.sample("survivor_share", torch.ones(2))
    recs = telemetry.snapshot()
    kept = [r for r in recs if r["events"] is not None]
    assert len(kept) == telemetry.DETAIL_CALLS and kept[-1] is recs[-1]
    assert recs[0]["events"] is None
    assert "survivor_share" not in recs[0]["counters"]
    assert recs[-1]["counters"]["survivor_share"] == [[1.0, 1.0]]


@pytest.mark.parametrize("level", ["spans", "detail"])
def test_profiler_ranges_only_at_detail(level):
    from torch.profiler import ProfilerActivity, profile

    telemetry.set_level(level)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.call("x"):
            with telemetry.span("step"):
                torch.ones(3).sum()
    names = {e.name for e in prof.events() if e.name.startswith("pm.")}
    assert names == ({"pm.call", "pm.step"} if level == "detail" else set())


@pytest.mark.parametrize("level", ["off", "spans"])
def test_preprocessing_durations_end_after_their_count_read(scene, monkeypatch,
                                                            level):
    """Each count read sleeps 50 ms, standing in for the device's wait on
    the chain. Each preprocessing duration covers every count read made
    before its point count is recorded: the read of the chain's result
    included."""
    ref, scans, inits = scene
    inner = PointCloud.count_host
    reads = []

    def slow(self):
        time.sleep(0.05)
        reads.append(time.perf_counter())
        return inner(self)

    icp = pt.ICP(device=CPU)
    icp.set_default()
    icp.checkers = [CounterTransformationChecker({"maxIterationCount": "2"})]
    icp.inspector = pt.InspectorRegistrar.create("PerformanceInspector", {})
    stats = []
    add = icp.inspector.add_stat

    def add_stat(name, value):
        stats.append((name, value, len(reads)))
        add(name, value)

    monkeypatch.setattr(icp.inspector, "add_stat", add_stat)
    monkeypatch.setattr(PointCloud, "count_host", slow)
    telemetry.set_level(level)
    icp(PointCloud.from_numpy(scans[0], device=CPU),
        PointCloud.from_numpy(ref, device=CPU), inits[0], seed=1)
    at = {name: (value, n) for name, value, n in stats}
    n_ref = at["ReferencePointCount"][1]
    n_read = at["ReadingPointCount"][1] - n_ref
    assert n_ref >= 2 and n_read >= 2
    assert at["ReferencePreprocessingDuration"][0] >= 0.05 * n_ref
    assert at["ReadingPreprocessingDuration"][0] >= 0.05 * n_read
