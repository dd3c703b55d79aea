"""Pairwise overlap-ratio matrix between all clouds of a list
(reference: examples/compute_overlap.cpp:98-260). For each ordered pair the
clouds are moved to their ground-truth poses (when provided), matched with
the exact NN search (``ops.dispatch.knn_search``: K1 on the card, its plain
version on the CPU), and the overlap is the fraction of source points whose
nearest neighbor lies within the combined sensor-noise bound.
``--device cpu`` runs on the CPU; the card is the default."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import (add_device_argument,
                                                    device_pose)
from libpointmatcher_tpu_torch.io.filelist import load_file_info_vector
from libpointmatcher_tpu_torch.ops.dispatch import knn_search


def overlap_ratio(src: pt.PointCloud, dst: pt.PointCloud,
                  default_noise: float = 0.1, search=knn_search) -> float:
    """The share of ``src``'s valid points whose nearest ``dst`` point lies
    within the noise bound; ``search`` is the k-NN function used."""
    d2, _ = search(src.points, src.mask, dst.points, dst.mask, k=1)
    d = torch.sqrt(torch.clamp(d2[:, 0], min=0.0))
    valid = torch.isfinite(d)
    if src.has_descriptor("simpleSensorNoise"):
        noise = src.get_descriptor("simpleSensorNoise")[:, 0]
    else:
        noise = torch.full_like(d, default_noise)
    hits = valid & (d < noise)
    n = max(int(valid.sum()), 1)
    return float(hits.sum()) / n


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Compute the pairwise overlap matrix of a cloud list.")
    p.add_argument("file_list")
    p.add_argument("--noise", type=float, default=0.1,
                   help="acceptance distance when no simpleSensorNoise "
                   "descriptor is present")
    p.add_argument("--output", default="overlap.csv")
    add_device_argument(p)
    args = p.parse_args(argv)

    infos = load_file_info_vector(args.file_list)
    rigid = pt.RigidTransformation()
    clouds = []
    for info in infos:
        c = pt.io.load(info.reading, device=args.device)
        if info.ground_truth_transformation is not None:
            c = rigid.compute(
                c, device_pose(info.ground_truth_transformation, c.device))
        clouds.append(c)

    n = len(clouds)
    M = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            M[i, j] = (
                1.0 if i == j
                else overlap_ratio(clouds[i], clouds[j], args.noise)
            )
            print(f"overlap[{i}→{j}] = {M[i, j]:.3f}")
    np.savetxt(args.output, M, delimiter=",", fmt="%.6f")
    print(f"overlap matrix saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
