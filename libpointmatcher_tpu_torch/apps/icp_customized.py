"""Chain built programmatically via registrars, no YAML
(reference: examples/icp_customized.cpp). ``--device cpu`` runs on the
CPU; the card is the default."""

from __future__ import annotations

import argparse
import sys

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument, host


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("reference")
    p.add_argument("reading")
    add_device_argument(p)
    args = p.parse_args(argv)

    ref = pt.io.load(args.reference, device=args.device)
    data = pt.io.load(args.reading, device=args.device)

    icp = pt.ICP(device=args.device)
    icp.reading_filters = [
        pt.DataPointsFilterRegistrar.create(
            "MinDistDataPointsFilter", {"minDist": "1.0"}),
        pt.DataPointsFilterRegistrar.create(
            "RandomSamplingDataPointsFilter", {"prob": "0.05"}),
    ]
    icp.reference_filters = [
        pt.DataPointsFilterRegistrar.create(
            "MinDistDataPointsFilter", {"minDist": "1.0"}),
        pt.DataPointsFilterRegistrar.create(
            "RandomSamplingDataPointsFilter", {"prob": "0.05"}),
    ]
    icp.matcher = pt.MatcherRegistrar.create(
        "KDTreeMatcher", {"knn": "1", "epsilon": "3.16"})
    icp.outlier_filters = [
        pt.OutlierFilterRegistrar.create(
            "TrimmedDistOutlierFilter", {"ratio": "0.75"})
    ]
    icp.error_minimizer = pt.ErrorMinimizerRegistrar.create(
        "PointToPointErrorMinimizer")
    icp.checkers = [
        pt.TransformationCheckerRegistrar.create(
            "CounterTransformationChecker", {"maxIterationCount": "150"}),
        pt.TransformationCheckerRegistrar.create(
            "DifferentialTransformationChecker",
            {"minDiffRotErr": "0.001", "minDiffTransErr": "0.01",
             "smoothLength": "4"}),
    ]
    icp.inspector = pt.InspectorRegistrar.create("NullInspector")

    T = icp(data, ref)
    aligned = pt.RigidTransformation().compute(data, T)
    pt.io.save(aligned, "test_data_out.vtk")
    print("Final transformation:\n", host(T))
    return 0


if __name__ == "__main__":
    sys.exit(main())
