"""Inspectors, the engine's statistics and visit counts, and the loggers
against the JAX package on the CPU.

- ``Histogram``: statistics, bins and CSV dumps equal to JAX's;
- ``PerformanceInspector`` after one ``ICP`` run: JAX's ten statistic
  names in its order, equal counts, iterations and touched pairs; an
  ``ICPSequence`` run records the reading half only, as JAX's;
- ``PointCountTouched`` for ``KDTreeMatcher`` (iterations × valid reading
  × valid reference), ``NullMatcher`` (0) and ``BlockGridMatcher`` (the
  tile assignment's pairs), and the tile route's per-scan counts of a
  batch against the JAX matcher's assignment of the same rows;
- ``VTKFileInspector`` in ASCII and binary: one reading and one link file
  an iteration, the first reading file read by JAX's ``load_vtk`` to the
  points of JAX's own first file (within 1e-5: each framework moves the
  reading by the initial pose in its own float32 product), and the same
  number of links;
- the loggers: channels, file contents equal to JAX's, ``set_logger``
  swapping, the engine's info line through the installed logger, and a
  YAML with a step filter, a logger and an inspector loading to the same
  modules and parameters in both packages. The process's logger is
  restored after each test.

Scenes are synthetic (``test_torch_loop_chains.make_scene``)."""

import glob
import os

import numpy as np
import pytest
from test_torch_loop_chains import make_scene

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.loggers as jlog
from libpointmatcher_tpu.io.vtkio import load_vtk
from libpointmatcher_tpu.utils.histogram import Histogram as JHistogram

import libpointmatcher_tpu_torch as pt
import libpointmatcher_tpu_torch.loggers as tlog
from libpointmatcher_tpu_torch.parallel import register_batch_to_map
from libpointmatcher_tpu_torch.utils.histogram import Histogram

CPU = "cpu"
SEED = 3
MAP_SEED = 5
STATS = ["ReferencePreprocessingDuration", "ReferenceInPointCount",
         "ReferencePointCount", "ReadingPreprocessingDuration",
         "ReadingInPointCount", "ReadingPointCount", "IterationsCount",
         "PointCountTouched", "OverlapRatio", "ConvergenceDuration"]
COUNTS = ["ReferenceInPointCount", "ReferencePointCount", "ReadingInPointCount",
          "ReadingPointCount", "IterationsCount", "PointCountTouched"]


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.fixture(autouse=True)
def restore_loggers():
    saved = tlog._current, jlog._current
    yield
    tlog._current, jlog._current = saved


@pytest.mark.parametrize("values", [[], [2.5], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                                    list(np.linspace(-1, 7, 33))])
def test_histogram(values):
    h, hj = Histogram("x"), JHistogram("x")
    for v in values:
        h.push(v)
        hj.push(v)
    assert len(h) == len(hj)
    np.testing.assert_equal(h.stats(), hj.stats())
    assert h.bins() == hj.bins()
    assert h.dump_stats() == hj.dump_stats()
    assert Histogram.dump_stats_header("x") == JHistogram.dump_stats_header("x")


def _engines(reg_name="PerformanceInspector", params=None, matcher=None,
             minimizer=None):
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    for e, pkg in ((ij, pm), (it, pt)):
        e.set_default()
        e.inspector = pkg.InspectorRegistrar.create(reg_name, params or {})
        if matcher is not None:
            e.matcher = pkg.MatcherRegistrar.create(*matcher)
            e.reference_filters = []
        if minimizer is not None:
            e.error_minimizer = pkg.ErrorMinimizerRegistrar.create(minimizer)
    return ij, it


def _run(scene, ij=None, it=None):
    ref, scans, poses, inits, extent = scene
    T_init = np.linalg.inv(inits[0]) @ inits[1]
    if ij is not None:
        ij(pm.PointCloud.from_numpy(scans[1]), pm.PointCloud.from_numpy(scans[0]),
           T_init, seed=SEED)
    if it is not None:
        it(pt.PointCloud.from_numpy(scans[1], device=CPU),
           pt.PointCloud.from_numpy(scans[0], device=CPU), T_init, seed=SEED)


def _stat(insp, name):
    return insp.histograms[name].values


def test_performance_inspector_stats(scene):
    ij, it = _engines()
    _run(scene, ij, it)
    assert list(it.inspector.histograms) == list(ij.inspector.histograms) == STATS
    for name in COUNTS:
        assert _stat(it.inspector, name) == _stat(ij.inspector, name), name
    iters = it.last_iteration_count
    assert _stat(it.inspector, "PointCountTouched") == [
        iters * it.prefiltered_reading_pts_count * it.prefiltered_reference_pts_count]
    assert it.matcher.get_visit_count() == 0          # reset after reporting
    np.testing.assert_allclose(_stat(it.inspector, "OverlapRatio"),
                               _stat(ij.inspector, "OverlapRatio"), atol=1e-6)
    assert it.inspector.dump_stats_header() == ij.inspector.dump_stats_header()
    # the sequence records the reading half only
    ref = scene[0]
    seqs = []
    for pkg, kw in ((pm, {}), (pt, {"device": CPU})):
        seq = pkg.ICPSequence(**kw)
        seq.set_default()
        seq.set_map(pkg.PointCloud.from_numpy(ref, **kw), seed=MAP_SEED)
        seq.inspector = pkg.InspectorRegistrar.create("PerformanceInspector")
        seq.compute(pkg.PointCloud.from_numpy(scene[1][2], **kw),
                    T_init=scene[3][2], seed=SEED)
        seqs.append(seq)
    assert list(seqs[1].inspector.histograms) == list(seqs[0].inspector.histograms) \
        == STATS[3:]


TILE = ("BlockGridMatcher", {"maxDist": "0.5", "motionBound": "0.5",
                             "tileQueries": "64", "blockCap": "256"})


@pytest.mark.parametrize("matcher", ["KDTreeMatcher", "NullMatcher", "BlockGridMatcher"])
def test_point_count_touched(scene, matcher):
    spec = TILE if matcher == "BlockGridMatcher" else (matcher, {})
    ij, it = _engines(matcher=spec, minimizer="PointToPointErrorMinimizer")
    if matcher == "NullMatcher":
        # no match, no inlier: both engines stop with ConvergenceError
        # before reporting, having counted no pair
        with pytest.raises(pm.ConvergenceError):
            _run(scene, ij=ij)
        with pytest.raises(pt.ConvergenceError):
            _run(scene, it=it)
        assert it.matcher.get_visit_count() == ij.matcher.get_visit_count() == 0
        return
    _run(scene, ij, it)
    got = _stat(it.inspector, "PointCountTouched")
    assert got == _stat(ij.inspector, "PointCountTouched")
    dense = (it.last_iteration_count * it.prefiltered_reading_pts_count
             * it.prefiltered_reference_pts_count)
    if matcher == "BlockGridMatcher":
        assert got == [it.last_iteration_count * it.matcher._loop_touched]
        assert 0 < got[0] < dense
    else:
        assert got == [dense]


def test_tile_batch_touched(scene):
    """The tile route's batch: each scan's swept pairs per iteration equal
    the JAX matcher's assignment of the same rows at the same pose, and the
    matcher's ``touched_per_iteration`` is their sum."""
    ref, scans, poses, inits, extent = scene
    seqs = []
    for pkg, kw in ((pm, {}), (pt, {"device": CPU})):
        seq = pkg.ICPSequence(**kw)
        seq.set_default()
        seq.reference_filters = []
        seq.matcher = pkg.MatcherRegistrar.create(*TILE)
        seq.error_minimizer = pkg.ErrorMinimizerRegistrar.create(
            "PointToPointErrorMinimizer")
        seq.set_map(pkg.PointCloud.from_numpy(ref, **kw), seed=MAP_SEED)
        seqs.append(seq)
    js, ps = seqs
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    register_batch_to_map(ps, clouds, T_inits=inits, seed=SEED)
    trm_inv = np.linalg.inv(ps.trm_host())
    want = []
    for s, T_init in zip(scans, inits):
        T = trm_inv @ np.asarray(T_init, np.float64)
        js.matcher.prepare_loop_host(s @ T[:3, :3].T + T[:3, 3],
                                     np.ones(len(s), bool))
        want.append(js.matcher._loop_touched)
    assert ps.matcher.touched_per_scan == want
    assert ps.matcher.touched_per_iteration(None, None) == sum(want)


@pytest.mark.parametrize("binary", [False, True])
def test_vtk_file_inspector(scene, binary, tmp_path):
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
    params = {"dumpReading": "1", "dumpDataLinks": "1",
              "writeBinary": "1" if binary else "0"}
    ij, it = _engines("VTKFileInspector", params)
    ij.inspector.baseFileName = str(dirs[0] / "run")
    it.inspector.baseFileName = str(dirs[1] / "run")
    assert it.inspector.needs_iteration_data and not it._fused()
    _run(scene, ij, it)
    assert it.last_iteration_count == ij.last_iteration_count
    for role in ("reading", "link"):
        files = sorted(glob.glob(str(dirs[1] / f"run-{role}-*.vtk")))
        assert len(files) == it.last_iteration_count, role
        assert os.path.basename(files[0]) == f"run-{role}-0000.vtk"
    mine = load_vtk(str(dirs[1] / "run-reading-0000.vtk"))
    theirs = load_vtk(str(dirs[0] / "run-reading-0000.vtk"))
    # the reading moved by the initial pose: each framework rounds its own
    # float32 product
    assert mine.to_numpy()[0].shape == theirs.to_numpy()[0].shape
    np.testing.assert_allclose(mine.to_numpy()[0], theirs.to_numpy()[0], atol=1e-5)

    def lines(path):
        with open(path, "rb") as f:
            return [ln for ln in f.read().split(b"\n") if ln.startswith(b"LINES")]

    assert lines(dirs[1] / "run-link-0000.vtk") == lines(dirs[0] / "run-link-0000.vtk")


def test_logger_channels(tmp_path):
    assert not tlog.NullLogger().has_info_channel()
    assert not tlog.NullLogger().has_warning_channel()
    outs = []
    for mod, tag in ((tlog, "port"), (jlog, "jax")):
        paths = (tmp_path / f"{tag}-info.txt", tmp_path / f"{tag}-warn.txt")
        lg = mod.FileLogger({"infoFileName": str(paths[0]),
                             "warningFileName": str(paths[1]),
                             "displayLocation": "1"})
        assert lg.has_info_channel() and lg.has_warning_channel()
        lg.info("hello", "icp.py:1")
        lg.warning("careful")
        for stream in (lg._info, lg._warn):
            stream.close()
        outs.append([p.read_text() for p in paths])
    assert outs[0] == outs[1] == ["hello [icp.py:1]\n", "WARN: careful\n"]


def test_set_logger_and_engine_line(scene, tmp_path):
    path = tmp_path / "info.txt"
    lg = pt.LoggerRegistrar.create("FileLogger", {"infoFileName": str(path)})
    pt.set_logger(lg)
    assert tlog.get_logger() is lg
    ij, it = _engines("NullInspector")
    _run(scene, ij, it)
    text = path.read_text()
    assert f"PointMatcher::icp - {it.last_iteration_count} iterations took" in text
    assert "points remaining" in text
    pt.set_logger(tlog.NullLogger())
    _run(scene, ij, it)
    lg.close()
    assert path.read_text() == text
    pt.set_logger(None)
    assert isinstance(tlog.get_logger(), tlog.NullLogger)


@pytest.mark.parametrize("inspector", ["PerformanceInspector", "VTKFileInspector"])
def test_yaml_step_filter_logger_inspector(tmp_path, inspector):
    text = f"""
logger:
  FileLogger:
    infoFileName: {tmp_path / 'info.txt'}
    displayLocation: 1
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.5
readingStepDataPointsFilters:
  - FixStepSamplingDataPointsFilter:
      startStep: 4
      endStep: 1
      stepMult: 0.5
matcher: KDTreeMatcher
errorMinimizer: PointToPointErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker
inspector:
  {inspector}:
    baseFileName: {tmp_path / 'run'}
    dumpStats: 1
"""
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    ij.load_from_yaml(text)
    jl = jlog.get_logger()
    it.load_from_yaml(text)
    tl = tlog.get_logger()
    assert (type(tl).__name__, tl.parameters) == (type(jl).__name__, jl.parameters)
    assert type(tl) is tlog.FileLogger
    for a, b in ((it.reading_filters, ij.reading_filters),
                 (it.reading_step_filters, ij.reading_step_filters),
                 ([it.inspector], [ij.inspector]),
                 ([it.matcher], [ij.matcher]), (it.checkers, ij.checkers)):
        assert [(type(x).__name__, x.parameters) for x in a] == \
            [(type(x).__name__, x.parameters) for x in b]
    assert it._fused() == ij._step_chain_traced() is True
    tl.close()
