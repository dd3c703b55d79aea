"""K3 and K4, the survivor sweeps, timed at recorded serving inputs: the
A/B of two trees of the port on one card.

    python3 tools_torch/sweep_micro.py record --out FILE
    python3 tools_torch/sweep_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--out JSON]

``record`` serves one ``register_batch_to_map`` of 8 scans on the K4 and
the K3 maps of tools_torch/profile_serving.py (the 100 000- and 60 000-point
scenes, scans of 25 000 points) and keeps each batch's survivor step at its
second lockstep iteration: the sorted queries, their mask, the transported
bound and the map's tables, written to FILE with ``torch.save``.

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit is timed on the same inputs.
Per route it forms the query table and K2's flags, and hands each sweep the
flags its tree's route gives it: K2's own rows where the tree's sweeps take
them (``sweep_cuda.flag_tile`` exists), else their OR per 1024 queries. It
checks K3 and K4 against the plain version and each other, then times each
(CUDA events, ``--reps`` launches, ``--rounds`` times). Another build of
csrc/sweep.cu is timed by unpacking a tree that holds it and passing
``--tree``. Needs a CUDA device; prints one JSON object (and writes it to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(path: str) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import sweep
    from libpointmatcher_tpu_torch.parallel import register_batch_to_map

    rng = np.random.default_rng(0)            # profile_serving.py's scenes
    saved = {}
    for route in ("K4", "K3"):
        world = cs.make_scene(rng, cs.SERVE_SCENES[route])
        poses = cs.make_poses(world, cs.SERVE_BATCH, rng)
        clouds = [pt.PointCloud.from_numpy(cs.make_scan(world, P, rng))
                  for P in poses]
        inits = [cs.perturb(rng) @ P for P in poses]
        seq = pt.ICPSequence()
        seq.set_default()
        seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        with cs.InputRecorder(sweep, keep=2) as rec:
            register_batch_to_map(seq, clouds, T_inits=inits, seed=1)
        aux = seq.matcher.serving_aux()
        qs, qm, ub_t = rec.calls[1][:3]
        saved[route] = {"qs": qs.cpu(), "qm": qm.cpu(), "ub_t": ub_t.cpu(),
                        "rt3": aux["skip_rt3"].cpu(), "ct": aux["skip_ct"].cpu()}
    torch.save(saved, path)
    return {route: {"query_rows": int(v["qs"].numel() // 3),
                    "chunks": int(v["rt3"].shape[0])}
            for route, v in saved.items()}


def _ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_sweeps(path, tree, reps, rounds) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from libpointmatcher_tpu_torch.ops import sweep
    from libpointmatcher_tpu_torch.ops import sweep_cuda as sc

    new = hasattr(sc, "flag_tile")
    sc.build()
    build_log = [ln.strip() for ln in sc.LIBRARY.build_log.splitlines()
                 if "survivor_sweep" in ln or "registers" in ln or "spill" in ln]
    data = torch.load(path)
    out = {"tree": os.path.abspath(tree), "flags": "256" if new else "1024",
           "build": build_log, "routes": {}}
    for route, v in data.items():
        t = {k: x.cuda() for k, x in v.items()}
        nch = t["rt3"].shape[0]
        qp = sweep.query_table(t["qs"], t["qm"], t["ub_t"])
        _, surv = sc.survivors_and_bounds(qp, t["ct"], nch=nch)
        if not new:
            surv = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
        dp, ip = sc.survivor_sweep_plain(qp, t["rt3"], surv)
        res = {"query_rows": qp.shape[0], "chunks": nch}
        for label, fn in (("K3", sc.nn1_survivor_sweep),
                          ("K4", sc.nn1_survivor_sweep_stream)):
            d, i = fn(qp, t["rt3"], surv)
            torch.cuda.synchronize()
            if not (torch.equal(d, dp) and torch.equal(i, ip)):
                raise AssertionError(f"{route} {label}: the sweep differs from "
                                     f"its plain version")
            res[label] = [_ms(torch, lambda: fn(qp, t["rt3"], surv), reps)
                          for _ in range(rounds)]
        out["routes"][route] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "time"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None, help="the file `record` wrote")
    ap.add_argument("--tree", default=ROOT, help="root of the port to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("sweep_micro: no CUDA device", file=sys.stderr)
        return 1
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    if args.mode == "record":
        if not args.out:
            ap.error("record needs --out")
        res = {"device": smi, "recorded": record(args.out)}
    else:
        if not args.inputs:
            ap.error("time needs --inputs")
        res = {"device": smi, **time_sweeps(args.inputs, args.tree, args.reps,
                                            args.rounds)}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
