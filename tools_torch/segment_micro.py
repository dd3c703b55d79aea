"""Card time of the filters built on segment sums (VoxelGrid, OctreeGrid,
Elipsoids) at ``chip_smoke.py`` phase 23's inputs, for an A/B of two trees
of the port.

    python3 tools_torch/segment_micro.py [--tree DIR] [--reps 7]
        [--points N] [--device cpu] [--out FILE.json]

The inputs are phase 23's: the 100 000-point scene of ``chip_smoke.py``
(``make_scene(default_rng(0))``) with a time channel, SurfaceNormal (knn 10,
ε 5, densities and eigenvalues kept) of it, and the filters phase 23 checks
there: VoxelGrid (0.05 m) and OctreeGrid (32 points a node, methods 0-3)
on the SurfaceNormal output, Elipsoids (methods 0 and 1, every descriptor
kept) on the scene. Each filter runs once untimed, then ``--reps`` times,
each timed on the host clock from a synchronize to a synchronize, as
``tools_torch/filter_checks.py::timed`` does. The filters' times spread
with the host; so the segment sums alone are timed too, the same way over
``4 * --reps`` calls: ``sampling.segment_stats`` over the three filters'
own segments (the 0.05 m voxels and the 32-point octree leaves of the
SurfaceNormal output, means only; Elipsoids' 7-point boxes of the scene,
with covariances), the calls those filters make. The script prints one
JSON object with the card's name and power limit, the tree, per filter
its times, their median and its output rows, and per segmentation its
segments, its longest and the sums' times.

``--tree DIR`` imports ``libpointmatcher_tpu_torch`` from DIR (an unpacked
other commit) instead of this checkout; the scene always comes from this
checkout's ``chip_smoke.py``, so both trees see the same input. Run the
trees in turns, one process each, on one machine. ``--device cpu``
runs here at ``--points`` rows to check the script; its times are the
host's and no measure of the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_scene",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card(torch, device):
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve() if args.tree else REPO))
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("segment_micro: no CUDA device", file=sys.stderr)
        return 1
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.filters import DataPointsFilterRegistrar
    from libpointmatcher_tpu_torch.utils import prng

    cs = _chip_smoke()
    world = (cs.make_scene(np.random.default_rng(0)) if args.points is None
             else cs.make_scene(np.random.default_rng(0), args.points))
    dev = args.device

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def create(name, params):
        return DataPointsFilterRegistrar.create(name, params)

    stamps = {"stamps": 1_700_000_000_000_000_000 + np.arange(len(world)) * 1000}
    base = pt.PointCloud.from_numpy(world, device=dev, times=stamps)
    sn = create("SurfaceNormalDataPointsFilter",
                {"knn": "10", "epsilon": "5", "keepDensities": "1",
                 "keepEigenValues": "1"}).filter(base)
    key = prng.fold_in(prng.prng_key(23), 1)
    cases = [("VoxelGrid(0.05)", "VoxelGridDataPointsFilter",
              {"vSizeX": "0.05", "vSizeY": "0.05", "vSizeZ": "0.05"}, sn)]
    cases += [(f"OctreeGrid({cs.OCTREE_NODE}, method {m})",
               "OctreeGridDataPointsFilter",
               {"maxPointByNode": cs.OCTREE_NODE, "samplingMethod": str(m)}, sn)
              for m in range(4)]
    cases += [(f"Elipsoids(method {m})", "ElipsoidsDataPointsFilter",
               {"samplingMethod": str(m), "keepEigenValues": "1",
                "keepDensities": "1", "keepShapes": "1", "keepMeans": "1"}, base)
              for m in (0, 1)]
    out = {"card": _card(torch, dev), "device": dev,
           "tree": str(args.tree) if args.tree else str(REPO),
           "rows": len(world), "reps": args.reps, "filters": {}}
    for label, name, params, cloud in cases:
        f = create(name, params)
        res = f.filter(cloud, key=key)
        ms = []
        for _ in range(args.reps):
            sync()
            t = time.perf_counter()
            f.filter(cloud, key=key)
            sync()
            ms.append(round(1e3 * (time.perf_counter() - t), 3))
        out["filters"][label] = {"ms": ms, "median_ms": statistics.median(ms),
                                 "rows_in": cloud.count_host(),
                                 "rows_out": res.count_host()}
    from libpointmatcher_tpu_torch.filters import sampling
    from libpointmatcher_tpu_torch.filters.normals import median_split_boxes

    host = sn.points.cpu().numpy()
    idx = np.floor(host / 0.05).astype(np.int64)
    octree = create("OctreeGridDataPointsFilter", {"maxPointByNode": cs.OCTREE_NODE})
    segs = [("voxels 0.05", sn.points, np.unique(idx, axis=0, return_inverse=True)[1],
             False),
            (f"octree leaves {cs.OCTREE_NODE}", sn.points,
             sampling.octree_split(host, int(cs.OCTREE_NODE),
                                   float(octree.maxSizeByNode)), False),
            ("Elipsoids boxes 7", base.points,
             median_split_boxes(base.points.cpu().numpy(), 7), True)]
    out["sums"] = {}
    for label, pts, seg_h, cov in segs:
        seg_h = np.asarray(seg_h).reshape(-1)
        seg = torch.as_tensor(seg_h, device=pts.device)
        num = int(seg_h.max()) + 1
        sampling.segment_stats(pts, seg, num, covariance=cov)
        ms = []
        for _ in range(4 * args.reps):
            sync()
            t = time.perf_counter()
            sampling.segment_stats(pts, seg, num, covariance=cov)
            sync()
            ms.append(round(1e3 * (time.perf_counter() - t), 4))
        out["sums"][label] = {"segments": num,
                              "longest": int(np.bincount(seg_h).max()),
                              "covariance": cov, "ms": ms,
                              "median_ms": statistics.median(ms)}
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
