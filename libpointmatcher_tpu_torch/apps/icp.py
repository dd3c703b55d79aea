"""Full ICP CLI (reference: examples/icp.cpp): YAML config, initial
transform, output basename, verbose module listing. ``--device cpu`` runs
on the CPU; the card is the default."""

from __future__ import annotations

import argparse
import sys

import numpy as np

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument, host


def parse_translation(text: str, dim: int) -> np.ndarray:
    vals = [float(t) for t in text.replace("[", "").replace("]", "").split(",")]
    if len(vals) != dim:
        raise ValueError(f"expected {dim} translation values, got {len(vals)}")
    T = np.eye(dim + 1, dtype=np.float32)
    T[:dim, dim] = vals
    return T


def parse_rotation(text: str, dim: int) -> np.ndarray:
    vals = [float(t) for t in text.replace("[", "").replace("]", "").split(",")]
    if len(vals) != dim * dim:
        raise ValueError(f"expected {dim * dim} rotation values, got {len(vals)}")
    T = np.eye(dim + 1, dtype=np.float32)
    T[:dim, :dim] = np.asarray(vals).reshape(dim, dim)
    return T


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Register a reading cloud onto a reference cloud.")
    p.add_argument("reference")
    p.add_argument("reading")
    p.add_argument("--config", help="YAML pipeline configuration file")
    p.add_argument("--output", default="test", help="output file basename")
    p.add_argument("--initTranslation", default=None,
                   help="e.g. [x,y,z] or x,y,z")
    p.add_argument("--initRotation", default=None,
                   help="row-major rotation matrix entries")
    p.add_argument("--isVerbose", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    args = p.parse_args(argv)

    ref = pt.io.load(args.reference, device=args.device)
    data = pt.io.load(args.reading, device=args.device)
    dim = ref.dim

    icp = pt.ICP(device=args.device)
    if args.config:
        with open(args.config) as f:
            icp.load_from_yaml(f.read())
    else:
        icp.set_default()

    T_init = np.eye(dim + 1, dtype=np.float32)
    if args.initTranslation:
        T_init = T_init @ parse_translation(args.initTranslation, dim)
    if args.initRotation:
        T_init = T_init @ parse_rotation(args.initRotation, dim)

    if args.isVerbose:
        from libpointmatcher_tpu_torch.apps.list_modules import describe_chain

        print(describe_chain(icp))

    T = icp(data, ref, T_init=T_init, seed=args.seed)
    aligned = pt.RigidTransformation().compute(data, T)
    pt.io.save(aligned, f"{args.output}_data_out.vtk")
    pt.io.save(data, f"{args.output}_data_in.vtk")
    pt.io.save(ref, f"{args.output}_ref.vtk")
    print("match ratio:",
          float(icp.last_stats.weighted_point_used_ratio)
          if icp.last_stats else float("nan"))
    print("Final transformation:")
    print(host(T))
    return 0


if __name__ == "__main__":
    sys.exit(main())
