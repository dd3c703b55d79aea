"""Full-cloud golden-config sweep vs the reference's committed transforms:
every ``icp_data/*.yaml`` of the reference's example data that has a
``.ref_trans`` registers ``cloud.00001.vtk`` onto ``cloud.00000.vtk``, and
passes when the median relative point error is under the threshold for one
of the seeds tried. ``DATA`` and ``ICP_DATA`` name the directories read.
``--device cpu`` runs on the CPU; the card is the default."""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import (REFERENCE_DATA,
                                                    add_device_argument, host)

DATA = REFERENCE_DATA
ICP_DATA = os.path.join(DATA, "icp_data")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--threshold", type=float, default=0.03)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--out", default="", help="write the full per-config "
                   "report (margins, timings, device) as a JSON artifact")
    add_device_argument(p)
    args = p.parse_args(argv)

    ref = pt.io.load(os.path.join(DATA, "cloud.00000.vtk"), device=args.device)
    data = pt.io.load(os.path.join(DATA, "cloud.00001.vtk"), device=args.device)
    pts, _ = data.to_numpy()

    configs = sorted(
        os.path.basename(f)[:-5]
        for f in glob.glob(os.path.join(ICP_DATA, "*.yaml"))
        if os.path.exists(os.path.join(ICP_DATA, os.path.basename(f)[:-5] + ".ref_trans"))
    )
    passed = failed = 0
    report = {}
    for name in configs:
        rows = []
        with open(os.path.join(ICP_DATA, name + ".ref_trans")) as f:
            for ln in f:
                if ln.strip():
                    rows.append([float(t) for t in ln.split()])
        T_ref = np.asarray(rows)
        best = np.inf
        t0 = time.perf_counter()
        for seed in range(args.seeds):
            icp = pt.ICP(device=args.device)
            with open(os.path.join(ICP_DATA, name + ".yaml")) as f:
                icp.load_from_yaml(f.read())
            T = host(icp(data, ref, seed=seed))
            a = pts @ T[:3, :3].T + T[:3, 3]
            b = pts @ T_ref[:3, :3].T + T_ref[:3, 3]
            err = float(np.median(
                np.linalg.norm(a - b, axis=1)
                / np.maximum(np.linalg.norm(b, axis=1), 1e-9)
            ))
            best = min(best, err)
            if best < args.threshold:
                break
        ok = best < args.threshold
        passed += ok
        failed += not ok
        report[name] = {"median_rel_err": best, "pass": bool(ok),
                        "time_s": time.perf_counter() - t0}
        print(f"{'PASS' if ok else 'FAIL'} {name}: {best:.4f}")
    print(json.dumps({"passed": passed, "failed": failed}))
    if args.out:
        artifact = {
            "backend": "torch",
            "device": str(ref.device),
            "protocol": "reference golden configs, full cloud density "
                        "(examples/data/icp_data/*.yaml vs committed "
                        ".ref_trans; median relative point error < "
                        f"{args.threshold}, utest/utest.cpp:81-160)",
            "seeds_tried": args.seeds,
            "passed": passed,
            "failed": failed,
            "configs": report,
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print("wrote", args.out)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
