"""Scan-to-map odometry over a sequence of clouds
(reference: examples/align_sequence.cpp): prior = last pose, ICP against the
growing map, re-orthogonalize, merge, density-cap the map. ``--device cpu``
runs on the CPU; the card is the default."""

from __future__ import annotations

import argparse
import sys

import numpy as np

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument, host
from libpointmatcher_tpu_torch.errors import ConvergenceError
from libpointmatcher_tpu_torch.filters.base import apply_filter_chain
from libpointmatcher_tpu_torch.io.filelist import load_file_info_vector
from libpointmatcher_tpu_torch.utils import prng


def default_map_post_filters():
    """Density maintenance chain (reference: align_sequence.cpp:140-144):
    SurfaceNormal (densities) + MaxDensity."""
    reg = pt.DataPointsFilterRegistrar
    return [
        reg.create(
            "SurfaceNormalDataPointsFilter",
            {"knn": "10", "epsilon": "5", "keepNormals": "0",
             "keepDensities": "1"}),
        reg.create("MaxDensityDataPointsFilter", {"maxDensity": "30"}),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Align a sequence of clouds into a map.")
    p.add_argument("cloud_list", help="CSV list of cloud files (reading column)")
    p.add_argument("--config", help="ICP YAML configuration")
    p.add_argument("--output", default="map_final.vtk")
    p.add_argument("--max-map-points", type=int, default=200000)
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    args = p.parse_args(argv)

    infos = load_file_info_vector(args.cloud_list)
    icp = pt.ICPSequence(device=args.device)
    if args.config:
        with open(args.config) as f:
            icp.load_from_yaml(f.read())
    else:
        icp.set_default()
    post_filters = default_map_post_filters()
    rigid = pt.RigidTransformation()

    map_cloud = None
    T = None
    for i, info in enumerate(infos):
        cloud = pt.io.load(info.reading, device=args.device)
        if map_cloud is None:
            map_cloud = cloud
            icp.set_map(map_cloud, seed=args.seed)
            T = np.eye(cloud.dim + 1, dtype=np.float32)
            print(f"[0] seeded map with {cloud.count_host()} points")
            continue
        try:
            T = icp(cloud, T_init=T, seed=args.seed + i)
        except ConvergenceError as e:
            print(f"[{i}] convergence error: {e}; skipping cloud",
                  file=sys.stderr)
            continue
        if not rigid.check_parameters(T):
            T = rigid.correct_parameters(T)
        aligned = rigid.compute(cloud, T)
        map_cloud = map_cloud.concatenate(aligned).compact()
        map_cloud = apply_filter_chain(post_filters, map_cloud,
                                       prng.prng_key(args.seed + i))
        if map_cloud.count_host() > args.max_map_points:
            f = pt.DataPointsFilterRegistrar.create(
                "MaxPointCountDataPointsFilter",
                {"maxCount": str(args.max_map_points), "seed": str(i)})
            map_cloud = f.filter(map_cloud).compact()
        icp.set_map(map_cloud, seed=args.seed + i)
        T = host(T)
        print(
            f"[{i}] T=\n{T}\nmap: {map_cloud.count_host()} points, "
            f"iters: {icp.last_iteration_count}"
        )

    if map_cloud is not None:
        pt.io.save(map_cloud, args.output)
        print(f"map saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
