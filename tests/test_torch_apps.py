"""The port's applications against the JAX package's, on the CPU.

Each test writes the same synthetic files (a planar room scene made with a
numpy seed, scans of 1 500-3 000 points displaced by known poses), runs the
JAX application and the port's with ``--device cpu`` on them, and holds
what they print or save to each other: poses within 1e-4, maps by row count
and coordinates (1e-4), overlap matrices within 1e-6, the ``eval_solution``
JSON (poses 1e-4, iteration counts and errors equal, rotation errors
1e-3: an arccos near 1 magnifies rounding), the report of
``plot_results`` and the chain listing character for character. The random
filters draw JAX's threefry values in both packages, so the same seed keeps
the same rows.

The port's ``eval_solution`` is also held to itself: ``--batch 3`` (pairs
of different sizes in one lockstep loop) equals ``--batch 1`` per pair
(pose within 1e-5, the same iterations and errors). And without a card,
``--device cuda`` (the default) raises: no application falls back to the
CPU.
"""

import contextlib
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from test_torch_batch import _room, _yaw_pose

import libpointmatcher_tpu as pm
import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu.apps import align_sequence as j_align
from libpointmatcher_tpu.apps import build_map as j_build
from libpointmatcher_tpu.apps import compute_overlap as j_overlap
from libpointmatcher_tpu.apps import demo_pipeline as j_demo
from libpointmatcher_tpu.apps import eval_solution as j_eval
from libpointmatcher_tpu.apps import filter_profiler as j_profiler
from libpointmatcher_tpu.apps import golden_check as j_golden
from libpointmatcher_tpu.apps import icp as j_icp
from libpointmatcher_tpu.apps import icp_advance_api as j_advance
from libpointmatcher_tpu.apps import icp_customized as j_customized
from libpointmatcher_tpu.apps import icp_simple as j_simple
from libpointmatcher_tpu.apps import list_modules as j_list
from libpointmatcher_tpu.apps import plot_results as j_plot
from libpointmatcher_tpu.cloud import bucket_size

from libpointmatcher_tpu_torch.apps import align_sequence as t_align
from libpointmatcher_tpu_torch.apps import build_map as t_build
from libpointmatcher_tpu_torch.apps import compute_overlap as t_overlap
from libpointmatcher_tpu_torch.apps import demo_pipeline as t_demo
from libpointmatcher_tpu_torch.apps import eval_solution as t_eval
from libpointmatcher_tpu_torch.apps import filter_profiler as t_profiler
from libpointmatcher_tpu_torch.apps import golden_check as t_golden
from libpointmatcher_tpu_torch.apps import icp as t_icp
from libpointmatcher_tpu_torch.apps import icp_advance_api as t_advance
from libpointmatcher_tpu_torch.apps import icp_customized as t_customized
from libpointmatcher_tpu_torch.apps import icp_simple as t_simple
from libpointmatcher_tpu_torch.apps import list_modules as t_list
from libpointmatcher_tpu_torch.apps import plot_results as t_plot

CPU = ["--device", "cpu"]
POSE_TOL = 1e-4
ROT_ERR_TOL = 1e-3
SCANS = 4
#: eval_solution's chain. Its differential checker's rotation threshold
#: (5e-3 rad) lies well above the float32 resolution of an angle near zero
#: (acos of a trace near 3: about 5e-4 rad per ulp), so that where a scan
#: stops is decided by its motion, not by rounding
SOLUTION = (
    "matcher:\n  KDTreeMatcher:\n    knn: 1\n"
    "outlierFilters:\n  - TrimmedDistOutlierFilter:\n      ratio: 0.85\n"
    "errorMinimizer:\n  PointToPointErrorMinimizer\n"
    "transformationCheckers:\n"
    "  - CounterTransformationChecker:\n      maxIterationCount: 60\n"
    "  - DifferentialTransformationChecker:\n"
    "      minDiffRotErr: 0.005\n      minDiffTransErr: 0.01\n"
    "      smoothLength: 4\n")
GOLDEN_YAML = (
    "readingDataPointsFilters:\n  - RandomSamplingDataPointsFilter:\n"
    "      prob: 0.5\n"
    "referenceDataPointsFilters:\n  - SamplingSurfaceNormalDataPointsFilter:\n"
    "      knn: 7\n" + SOLUTION.replace("PointToPoint", "PointToPlane"))


def _gt_row(name, T):
    return f"{name}, " + ", ".join(str(v) for v in np.asarray(T).reshape(-1))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The synthetic inputs of every application, in one directory:

    - ``ref.csv`` (3 000 points of the room) and ``data.csv`` (2 000 of its
      rows with 3 mm of noise, displaced by ``pose``): ref ≈ pose · data;
    - ``scan{i}.csv``: nested prefixes (1 500 + 100 i rows) of one sample
      of a 4 m cube, with 2 mm of noise, each in its own frame ``poses[i]`` (world = poses[i] · scan), listed
      in ``list.csv`` (reading only) and ``gtlist.csv`` (with gT);
    - ``protocol.csv``: five pairs scan(k+1 mod 4) → scan(k mod 4) with
      their ground truth, and the solution ``sol.yaml``;
    - ``golden/``: cloud.00000.vtk, cloud.00001.vtk and one configuration
      with its ``.ref_trans``, the layout of the reference's example data;
    - ``seed.csv``: 3 000 points of the room for demo_pipeline."""
    d = tmp_path_factory.mktemp("apps")
    rng = np.random.default_rng(11)
    world = _room(rng, 9000).astype(np.float32)
    ref = world[rng.choice(len(world), 3000, replace=False)]
    pose = _yaw_pose(0.03, [0.08, -0.05, 0.02])
    rows = ref[rng.choice(len(ref), 2000, replace=False)]
    rows = rows + 0.003 * rng.standard_normal(rows.shape)
    data = ((rows - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)
    save = lambda pts, name: pm.io.save(pm.PointCloud.from_numpy(pts), str(d / name))
    save(ref, "ref.csv")
    save(data, "data.csv")

    sample = rng.uniform(-2, 2, (1800, 3)).astype(np.float32)
    poses, names = [], []
    for i in range(SCANS):
        P = _yaw_pose(0.02 * i, [0.05 * i, 0.02 * i, 0.01 * i])
        rows = sample[:1500 + 100 * i]
        rows = rows + 0.002 * rng.standard_normal(rows.shape)
        save(((rows - P[:3, 3]) @ P[:3, :3]).astype(np.float32), f"scan{i}.csv")
        poses.append(P)
        names.append(f"scan{i}.csv")
    (d / "list.csv").write_text("reading\n" + "\n".join(names[:3]) + "\n")
    head = ", ".join(f"gT{i}{j}" for i in range(4) for j in range(4))
    (d / "gtlist.csv").write_text(
        f"reading, {head}\n"
        + "".join(_gt_row(n, P) + "\n" for n, P in zip(names, poses)))
    pairs = [((k + 1) % SCANS, k % SCANS) for k in range(5)]
    (d / "protocol.csv").write_text(
        f"reading, reference, {head}\n" + "".join(
            _gt_row(f"{names[a]}, {names[b]}", np.linalg.inv(poses[b]) @ poses[a])
            + "\n" for a, b in pairs))
    (d / "sol.yaml").write_text(SOLUTION)

    g = d / "golden"
    (g / "icp_data").mkdir(parents=True)
    pm.io.save(pm.PointCloud.from_numpy(ref), str(g / "cloud.00000.vtk"))
    pm.io.save(pm.PointCloud.from_numpy(data), str(g / "cloud.00001.vtk"))
    np.savetxt(str(g / "icp_data" / "default.ref_trans"), pose)
    (g / "icp_data" / "default.yaml").write_text(GOLDEN_YAML)
    save(world[rng.choice(len(world), 3000, replace=False)], "seed.csv")
    return d, pose, poses


def _run(main, argv, cwd, monkeypatch):
    """``main(argv)`` in ``cwd`` → (return code, standard output)."""
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(j_main, t_main, argv, tmp_path, monkeypatch):
    """The JAX application in ``tmp_path/jax``, the port's in
    ``tmp_path/port`` with ``--device cpu`` → ((rc, out), (rc, out))."""
    j = _run(j_main, argv, tmp_path / "jax", monkeypatch)
    t = _run(t_main, list(argv) + CPU, tmp_path / "port", monkeypatch)
    assert j[0] == 0 and t[0] == 0
    return j, t


_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _final_pose(text):
    """The 4x4 matrix printed after 'Final transformation:'."""
    tail = text.split("Final transformation:", 1)[1]
    return np.array([float(v) for v in _NUM.findall(tail.split("]]", 1)[0])]
                    ).reshape(4, 4)


def _line_value(text, label):
    line = next(ln for ln in text.splitlines() if ln.startswith(label))
    return line[len(label):].strip()


def _assert_same_cloud(path_j, path_t):
    a = pm.io.load(str(path_j)).to_numpy()[0]
    b = pt.io.load(str(path_t), device="cpu").to_numpy()[0]
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=POSE_TOL)


def test_icp_simple(files, tmp_path, monkeypatch):
    d, pose, _ = files
    j, t = _both(j_simple.main, t_simple.main,
                 [str(d / "ref.csv"), str(d / "data.csv")], tmp_path, monkeypatch)
    np.testing.assert_allclose(_final_pose(t[1]), _final_pose(j[1]), atol=POSE_TOL)
    np.testing.assert_allclose(_final_pose(t[1]), pose, atol=0.01)
    for name in ("test_data_out.vtk", "test_data_in.vtk", "test_ref.vtk"):
        _assert_same_cloud(tmp_path / "jax" / name, tmp_path / "port" / name)


def test_icp(files, tmp_path, monkeypatch):
    """The YAML chain, the initial translation and rotation, the verbose
    chain listing and the seed."""
    d, pose, _ = files
    argv = [str(d / "ref.csv"), str(d / "data.csv"), "--config", str(d / "sol.yaml"),
            "--output", "out", "--initTranslation", "[0.01,0,0]",
            "--initRotation", "1,0,0,0,1,0,0,0,1", "--isVerbose", "--seed", "3"]
    j, t = _both(j_icp.main, t_icp.main, argv, tmp_path, monkeypatch)
    assert t[1].split("match ratio:")[0] == j[1].split("match ratio:")[0]
    np.testing.assert_allclose(float(_line_value(t[1], "match ratio:")),
                               float(_line_value(j[1], "match ratio:")), rtol=1e-5)
    np.testing.assert_allclose(_final_pose(t[1]), _final_pose(j[1]), atol=POSE_TOL)
    np.testing.assert_allclose(_final_pose(t[1]), pose, atol=0.01)
    np.testing.assert_array_equal(t_icp.parse_translation("[1,2,3]", 3),
                                  j_icp.parse_translation("[1,2,3]", 3))
    np.testing.assert_array_equal(t_icp.parse_rotation("0,-1,1,0", 2),
                                  j_icp.parse_rotation("0,-1,1,0", 2))
    _assert_same_cloud(tmp_path / "jax" / "out_data_out.vtk",
                       tmp_path / "port" / "out_data_out.vtk")


def test_icp_customized(files, tmp_path, monkeypatch):
    d, _, _ = files
    j, t = _both(j_customized.main, t_customized.main,
                 [str(d / "ref.csv"), str(d / "data.csv")], tmp_path, monkeypatch)
    np.testing.assert_allclose(_final_pose(t[1]), _final_pose(j[1]), atol=POSE_TOL)
    _assert_same_cloud(tmp_path / "jax" / "test_data_out.vtk",
                       tmp_path / "port" / "test_data_out.vtk")


def test_icp_advance_api(files, tmp_path, monkeypatch):
    """The accessors and the manual step at the final pose. The JAX
    package's match ratio divides by the reading's padded rows (its bucket);
    the port's by its points, so the JAX value is rescaled."""
    d, _, _ = files
    j, t = _both(j_advance.main, t_advance.main,
                 [str(d / "ref.csv"), str(d / "data.csv"), "--seed", "2"],
                 tmp_path, monkeypatch)
    np.testing.assert_allclose(_final_pose(t[1]), _final_pose(j[1]), atol=POSE_TOL)
    for label in ("max iterations reached:", "prefiltered reading points:",
                  "prefiltered reference points:"):
        assert _line_value(t[1], label) == _line_value(j[1], label)
    for label in ("point used ratio:", "weighted point used ratio (overlap est.):",
                  "residual error at final pose:"):
        np.testing.assert_allclose(float(_line_value(t[1], label)),
                                   float(_line_value(j[1], label)), rtol=1e-4)
    n = int(_line_value(j[1], "prefiltered reading points:"))
    np.testing.assert_allclose(
        float(_line_value(t[1], "match ratio:")),
        float(_line_value(j[1], "match ratio:")) * bucket_size(n) / n, rtol=1e-6)


def _sequence_steps(text):
    """align_sequence's per-scan lines → [(T [4, 4], map points, iters)]."""
    steps = re.findall(r"\[\d+\] T=\n(.*?\]\])\nmap: (\d+) points, iters: (\d+)",
                       text, re.S)
    return [(np.array([float(v) for v in _NUM.findall(m)]).reshape(4, 4),
             int(n), int(it)) for m, n, it in steps]


def test_align_sequence(files, tmp_path, monkeypatch):
    d, _, poses = files
    j, t = _both(j_align.main, t_align.main,
                 [str(d / "list.csv"), "--output", "map.vtk", "--seed", "1"],
                 tmp_path, monkeypatch)
    sj, st = _sequence_steps(j[1]), _sequence_steps(t[1])
    assert len(sj) == len(st) == 2
    for (Tj, nj, ij), (Tt, nt, it), P in zip(sj, st, poses[1:]):
        assert (nt, it) == (nj, ij)
        np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)
        np.testing.assert_allclose(Tt, np.linalg.inv(poses[0]) @ P, atol=0.03)
    _assert_same_cloud(tmp_path / "jax" / "map.vtk", tmp_path / "port" / "map.vtk")


def test_build_map(files, tmp_path, monkeypatch):
    d, _, _ = files
    j, t = _both(j_build.main, t_build.main, [str(d / "gtlist.csv"), "map.vtk"],
                 tmp_path, monkeypatch)
    assert t[1] == j[1]
    _assert_same_cloud(tmp_path / "jax" / "map.vtk", tmp_path / "port" / "map.vtk")


def test_compute_overlap(files, tmp_path, monkeypatch):
    d, _, _ = files
    argv = [str(d / "gtlist.csv"), "--noise", "0.01", "--output", "ov.csv"]
    j, t = _both(j_overlap.main, t_overlap.main, argv, tmp_path, monkeypatch)
    assert t[1] == j[1]
    Mj = np.loadtxt(tmp_path / "jax" / "ov.csv", delimiter=",")
    Mt = np.loadtxt(tmp_path / "port" / "ov.csv", delimiter=",")
    assert Mt.shape == (SCANS, SCANS)
    np.testing.assert_allclose(Mt, Mj, atol=1e-6)
    assert 0.5 < Mt[0, 1] < 1.0 and np.all(np.diag(Mt) == 1.0)


@pytest.mark.parametrize("params", [
    [],
    ["--filter", "RandomSamplingDataPointsFilter", "--param", "prob=0.5"]])
def test_filter_profiler(files, tmp_path, monkeypatch, params):
    """The same rows in and out (the random filter's draw is JAX's)."""
    d, _, _ = files
    j, t = _both(j_profiler.main, t_profiler.main,
                 [str(d / "scan3.csv"), "--runs", "2"] + params, tmp_path, monkeypatch)
    assert t[1].split(" pts,")[0] == j[1].split(" pts,")[0]


def _eval_json(path):
    with open(path) as f:
        return json.load(f)


def test_eval_solution(files, tmp_path, monkeypatch):
    """The sequential drivers of both packages agree; the port's batched
    driver (groups of 3 pairs of different sizes) equals its sequential
    one per pair."""
    d, _, _ = files
    argv = [str(d / "protocol.csv"), str(d / "sol.yaml")]
    j, t = _both(j_eval.main, t_eval.main, argv + ["--batch", "1"], tmp_path,
                 monkeypatch)
    rc, _ = _run(t_eval.main, argv + ["--batch", "3", "--output", "b3.json"] + CPU,
                 tmp_path / "port", monkeypatch)
    assert rc == 0
    ej = _eval_json(tmp_path / "jax" / "eval_results.json")
    et = _eval_json(tmp_path / "port" / "eval_results.json")
    eb = _eval_json(tmp_path / "port" / "b3.json")
    assert len(ej["results"]) == len(et["results"]) == len(eb["results"]) == 5
    for rj, rt, rb in zip(ej["results"], et["results"], eb["results"]):
        for key in ("pair", "reading", "reference", "iterations", "error"):
            assert rt[key] == rj[key] == rb[key]
        np.testing.assert_allclose(rt["T"], rj["T"], atol=POSE_TOL)
        np.testing.assert_allclose(rb["T"], rt["T"], atol=1e-5)
        # the rotation error is an arccos near 1, where a difference of
        # 1e-7 in the trace moves it by ~4e-4: held to 1e-3
        np.testing.assert_allclose(rt["trans_err"], rj["trans_err"], atol=POSE_TOL)
        np.testing.assert_allclose(rt["rot_err"], rj["rot_err"], atol=ROT_ERR_TOL)
        assert rt["trans_err"] < 0.01 and rt["rot_err"] < 0.01
    for key in ("pairs", "failed"):
        assert et["summary"][key] == ej["summary"][key] == eb["summary"][key]
    for key in ("median_trans_err", "p95_trans_err"):
        np.testing.assert_allclose(et["summary"][key], ej["summary"][key], atol=POSE_TOL)
    for key in ("median_rot_err", "p95_rot_err"):
        np.testing.assert_allclose(et["summary"][key], ej["summary"][key],
                                   atol=ROT_ERR_TOL)
    assert t_eval.SEQUENCES == j_eval.SEQUENCES
    sizes = [(256, 512), (384, 384), (512, 1024), (256, 256), (768, 512)] * 4
    assert t_eval.select_ladder(sizes) == j_eval.select_ladder(sizes)
    assert t_eval.select_ladder([]) == j_eval.select_ladder([]) == []


def test_plot_results(files, tmp_path, monkeypatch):
    """Both reports of one results file, histograms and CSV, are equal."""
    d, _, _ = files
    _run(t_eval.main, [str(d / "protocol.csv"), str(d / "sol.yaml"), "--output",
                       str(tmp_path / "r.json")] + CPU, tmp_path, monkeypatch)
    argv = [str(tmp_path / "r.json"), "--csv", "pairs.csv", "--bins", "4"]
    j = _run(j_plot.main, argv, tmp_path / "jax", monkeypatch)
    t = _run(t_plot.main, argv, tmp_path / "port", monkeypatch)
    assert j[0] == t[0] == 0 and t[1] == j[1] and "Rotation error" in t[1]
    assert ((tmp_path / "port" / "pairs.csv").read_text()
            == (tmp_path / "jax" / "pairs.csv").read_text())


def test_golden_check(files, tmp_path, monkeypatch):
    """Both sweeps pass on the same synthetic example data, within one
    relative error of each other. The JAX application's persistent
    compilation cache is left off."""
    d, _, _ = files
    for mod in (j_golden, t_golden):
        monkeypatch.setattr(mod, "DATA", str(d / "golden"))
        monkeypatch.setattr(mod, "ICP_DATA", str(d / "golden" / "icp_data"))
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if "cache" in name else update(name, value))
    j, t = _both(j_golden.main, t_golden.main, ["--seeds", "1", "--out", "g.json"],
                 tmp_path, monkeypatch)
    assert t[1].startswith("PASS default: ") and j[1].startswith("PASS default: ")
    gj = _eval_json(tmp_path / "jax" / "g.json")["configs"]["default"]
    gt = _eval_json(tmp_path / "port" / "g.json")["configs"]["default"]
    assert gj["pass"] and gt["pass"]
    np.testing.assert_allclose(gt["median_rel_err"], gj["median_rel_err"], atol=1e-4)


def test_demo_pipeline(files, tmp_path, monkeypatch):
    d, _, _ = files
    argv = ["--cloud", str(d / "seed.csv"), "--scans", "3", "--decimate", "2"]
    j, t = _both(j_demo.main, t_demo.main, argv, tmp_path, monkeypatch)
    oj, ot = (json.loads(o[1].strip().splitlines()[-1]) for o in (j, t))
    assert ot["scans"] == oj["scans"] == 3
    for key in ("ate_odometry_noisy", "ate_refined", "posegraph_residual"):
        np.testing.assert_allclose(ot[key], oj[key], atol=POSE_TOL)
    assert ot["ate_refined"] <= ot["ate_odometry_noisy"]
    assert j[1].splitlines()[:-1] == t[1].splitlines()[:-1]


def test_list_modules(files):
    """The chain listing of a default chain and of a YAML chain, and each
    module's entry (the full dump per citation style is in
    tests/test_torch_bibliography.py)."""
    d, _, _ = files
    jx, tc = pm.ICP(), pt.ICP(device="cpu")
    jx.set_default()
    tc.set_default()
    assert t_list.describe_chain(tc) == j_list.describe_chain(jx)
    for icp in (jx, tc):
        icp.load_from_yaml((d / "sol.yaml").read_text())
    assert t_list.describe_chain(tc) == j_list.describe_chain(jx)
    assert [s for s, _ in t_list.REGISTRARS] == [s for s, _ in j_list.REGISTRARS]
    cited_j, cited_t = [], []
    for (_, rj), (_, rt) in zip(j_list.REGISTRARS, t_list.REGISTRARS):
        for (nj, cj), (nt, ct) in zip(rj.items(), rt.items()):
            assert t_list.describe_module(nt, ct, cited_t) == \
                j_list.describe_module(nj, cj, cited_j)
    assert cited_t == cited_j and cited_t


APPS_ON_DEVICE = {
    "icp_simple": (t_simple, ["ref.csv", "data.csv"]),
    "icp": (t_icp, ["ref.csv", "data.csv"]),
    "icp_customized": (t_customized, ["ref.csv", "data.csv"]),
    "icp_advance_api": (t_advance, ["ref.csv", "data.csv"]),
    "align_sequence": (t_align, ["list.csv"]),
    "build_map": (t_build, ["gtlist.csv", "map.vtk"]),
    "compute_overlap": (t_overlap, ["gtlist.csv"]),
    "filter_profiler": (t_profiler, ["scan0.csv"]),
    "eval_solution": (t_eval, ["protocol.csv", "sol.yaml"]),
    "golden_check": (t_golden, []),
    "demo_pipeline": (t_demo, ["--cloud", "seed.csv"]),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(APPS_ON_DEVICE))
def test_default_device_raises_without_card(files, tmp_path, monkeypatch, name):
    """The default device is the card; without one the application raises
    before it computes anything, and writes nothing."""
    d, _, _ = files
    mod, args = APPS_ON_DEVICE[name]
    monkeypatch.setattr(t_golden, "DATA", str(d / "golden"))
    monkeypatch.chdir(tmp_path)
    argv = [str(d / a) if a.endswith((".csv", ".yaml")) else a for a in args]
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []
