"""Batch map building from a file list with ground-truth poses
(reference: examples/build_map.cpp): transform each cloud by its gT pose,
merge, clean up with a density-capping chain. ``--device cpu`` runs on
the CPU; the card is the default."""

from __future__ import annotations

import argparse
import sys

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import (add_device_argument,
                                                    device_pose)
from libpointmatcher_tpu_torch.filters.base import apply_filter_chain
from libpointmatcher_tpu_torch.io.filelist import load_file_info_vector
from libpointmatcher_tpu_torch.utils import prng


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Build a map from clouds with known ground-truth poses.")
    p.add_argument("file_list", help="CSV list with reading + gTxy columns")
    p.add_argument("output", nargs="?", default="finalMap.vtk")
    p.add_argument("--max-density", type=float, default=30.0)
    add_device_argument(p)
    args = p.parse_args(argv)

    infos = load_file_info_vector(args.file_list)
    rigid = pt.RigidTransformation()
    reg = pt.DataPointsFilterRegistrar
    cleanup = [
        reg.create(
            "SurfaceNormalDataPointsFilter",
            {"knn": "10", "epsilon": "5", "keepNormals": "1",
             "keepDensities": "1"}),
        reg.create("MaxDensityDataPointsFilter",
                   {"maxDensity": str(args.max_density)}),
    ]

    map_cloud = None
    for i, info in enumerate(infos):
        cloud = pt.io.load(info.reading, device=args.device)
        T = info.ground_truth_transformation
        if T is None:
            print(f"[{i}] no ground-truth pose, skipping", file=sys.stderr)
            continue
        aligned = rigid.compute(cloud, device_pose(T, cloud.device))
        map_cloud = (
            aligned if map_cloud is None
            else map_cloud.concatenate(aligned).compact()
        )
        print(f"[{i}] merged {cloud.count_host()} pts → "
              f"{map_cloud.count_host()} total")

    if map_cloud is None:
        print("no clouds merged", file=sys.stderr)
        return 1
    map_cloud = apply_filter_chain(cleanup, map_cloud, prng.prng_key(0))
    pt.io.save(map_cloud, args.output)
    print(f"map with {map_cloud.count_host()} points saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
