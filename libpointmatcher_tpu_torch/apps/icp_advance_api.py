"""Advanced-API demo: introspection of match ratio, manual matcher reuse,
residual computation (reference: examples/icp_advance_api.cpp:140-204).
``--device cpu`` runs on the CPU; the card is the default.

The chains of the manual step draw from the keys the engine folds for its
own (``fold_in(PRNGKey(seed), 1)`` for the reference, ``2`` for the
reading), so they keep the rows the registration kept. The match ratio is
the share of the filtered reading's points that found a match."""

from __future__ import annotations

import argparse
import sys

import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument, host
from libpointmatcher_tpu_torch.filters.base import apply_filter_chain
from libpointmatcher_tpu_torch.outlierfilters import (compute_outlier_weights,
                                                      init_outlier_states)
from libpointmatcher_tpu_torch.utils import prng


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("reference")
    p.add_argument("reading")
    p.add_argument("--config")
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    args = p.parse_args(argv)

    ref = pt.io.load(args.reference, device=args.device)
    data = pt.io.load(args.reading, device=args.device)

    icp = pt.ICP(device=args.device)
    if args.config:
        with open(args.config) as f:
            icp.load_from_yaml(f.read())
    else:
        icp.set_default()

    T = icp(data, ref, seed=args.seed)
    print("Final transformation:\n", host(T))
    print("max iterations reached:", icp.get_max_num_iterations_reached())
    print("prefiltered reading points:", icp.get_prefiltered_reading_pts_count())
    print("prefiltered reference points:", icp.get_prefiltered_reference_pts_count())
    print("point used ratio:", float(icp.last_stats.point_used_ratio))
    print("weighted point used ratio (overlap est.):",
          float(icp.last_stats.weighted_point_used_ratio))

    # ---- manual matcher reuse: residual at the final pose
    key = prng.prng_key(args.seed)
    ref_f = apply_filter_chain(icp.reference_filters, ref, prng.fold_in(key, 1))
    data_f = apply_filter_chain(icp.reading_filters, data, prng.fold_in(key, 2))
    icp.matcher.init(ref_f)
    rigid = pt.RigidTransformation()
    moved = rigid.compute(data_f, T)
    matches = icp.matcher.find_closests_in(moved, ref_f)
    weights, _ = compute_outlier_weights(
        icp.outlier_filters, moved, ref_f, matches,
        init_outlier_states(icp.outlier_filters, (), moved.device))
    residual = icp.error_minimizer.residual_error(moved, ref_f, weights, matches)
    print("residual error at final pose:", float(residual))
    valid = torch.isfinite(matches.dists)[moved.mask]
    print("match ratio:", float(valid.float().mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
