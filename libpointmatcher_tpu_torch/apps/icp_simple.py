"""Minimal ICP: load two clouds, default chain, print T
(reference: examples/icp_simple.cpp). ``--device cpu`` runs on the CPU;
the card is the default."""

from __future__ import annotations

import sys

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import host


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv[:-1]:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    if len(argv) != 2:
        print(
            "Error in command line, usage: icp_simple "
            "reference.csv reading.csv [--device cuda|cpu]",
            file=sys.stderr,
        )
        return 1
    ref = pt.io.load(argv[0], device=device)
    data = pt.io.load(argv[1], device=device)
    icp = pt.ICP(device=device)
    icp.set_default()
    T = icp(data, ref)
    aligned = pt.RigidTransformation().compute(data, T)
    pt.io.save(aligned, "test_data_out.vtk")
    pt.io.save(data, "test_data_in.vtk")
    pt.io.save(ref, "test_ref.vtk")
    print("Final transformation:")
    print(host(T))
    return 0


if __name__ == "__main__":
    sys.exit(main())
