"""The survivor route's kernels, K2, K3/K4 and K6, timed at recorded serving
inputs: the A/B of two trees of the port on one card.

    python3 tools_torch/sweep_micro.py record --out FILE
    python3 tools_torch/sweep_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--out JSON]

``record`` serves one ``register_batch_to_map`` of 8 scans on the K4 and
the K3 maps of tools_torch/profile_serving.py (the 100 000- and 60 000-point
scenes, scans of 25 000 points) and keeps each batch's survivor step at its
first lockstep iteration (cold: no transported bound) and its second
(warm): the sorted queries, their mask, the transported bound and the map's
tables. It then serves a queue of 16 such scans through 8 lanes with
``KDTreeMatcher({"knn": "3"})`` under ``PMTPU_SERVE_SKIP=1`` on the K3
map (chip_smoke.py's K6 route) and keeps its top-k step at the second lane
iteration. All is written to FILE with ``torch.save``.

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit is timed on the same inputs:
run the trees in turns (parent, change, change, parent), one process each.
Per batch it forms the query table and times K2 cold and warm (held bit
for bit to its plain version first; when the tree is this checkout, with
the shares of (warp, chunk) pairs that its prefilter passes at these
inputs, from ``emulate_k2`` of tests/torch_survivor_emulation.py), then,
at the warm inputs, K3 and K4 on the flags the tree's route gives them:
K2's own rows where the tree's sweeps take them (``sweep_cuda.flag_tile``
exists), else their OR per 1024 queries. At the knn = 3 input it times K2
(k = 3) and K6, each held to its plain version, K6 on the flags the tree's
K6 takes: K2's own rows where ``sweep_cuda.SWEEPK_TILE`` is 256, else the
1024-query fold. Times are CUDA events over ``--reps`` launches,
``--rounds`` times. Needs a CUDA device; prints one JSON object (and
writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- record
def _serve_scene(cs, pt, rng, route, count):
    world = cs.make_scene(rng, cs.SERVE_SCENES[route])
    poses = cs.make_poses(world, count, rng)
    clouds = [pt.PointCloud.from_numpy(cs.make_scan(world, P, rng))
              for P in poses]
    inits = [cs.perturb(rng) @ P for P in poses]
    return world, clouds, inits


def _tables(seq):
    aux = seq.matcher.serving_aux()
    return {"rt3": aux["skip_rt3"].cpu(), "ct": aux["skip_ct"].cpu()}


def _step(call):
    qs, qm, ub_t = call[:3]
    return {"qs": qs.cpu(), "qm": qm.cpu(), "ub_t": ub_t.cpu()}


def record(path: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
    from libpointmatcher_tpu_torch.ops import sweep
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    rng = np.random.default_rng(0)            # profile_serving.py's scenes
    saved = {}
    for route in ("K4", "K3"):
        world, clouds, inits = _serve_scene(cs, pt, rng, route, cs.SERVE_BATCH)
        seq = pt.ICPSequence()
        seq.set_default()
        seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        with cs.InputRecorder(sweep, keep=2) as rec:
            register_batch_to_map(seq, clouds, T_inits=inits, seed=1)
        saved[route] = {"cold": _step(rec.calls[0]), "warm": _step(rec.calls[1]),
                        **_tables(seq)}
    world, clouds, inits = _serve_scene(cs, pt, rng, "K3", 2 * cs.QUEUE_LANES)
    seq = pt.ICPSequence()
    seq.set_default()
    seq.matcher = KDTreeMatcher({"knn": "3"})
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    env = os.environ.get("PMTPU_SERVE_SKIP")
    os.environ["PMTPU_SERVE_SKIP"] = "1"
    try:
        with cs.InputRecorder(sweep, "nnk_sorted_v2", keep=2) as rec:
            register_queue_to_map(seq, clouds, T_inits=inits, seed=1,
                                  lanes=cs.QUEUE_LANES)
    finally:
        if env is None:
            del os.environ["PMTPU_SERVE_SKIP"]
        else:
            os.environ["PMTPU_SERVE_SKIP"] = env
    saved["K6"] = {"warm": _step(rec.calls[1]), "k": 3, **_tables(seq)}
    torch.save(saved, path)
    return {route: {"query_rows": int(v["warm"]["qs"].numel() // 3),
                    "chunks": int(v["rt3"].shape[0])}
            for route, v in saved.items()}


# ------------------------------------------------------------- time
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


def _equal(torch, got, want, what):
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what} differs from its plain version")


def _shares(qp, ct, k, nch):
    """The shares of (warp, chunk) pairs that K2's schedule evaluates in
    pass 1, passes pass 2's test with and evaluates in pass 2, at these
    inputs (its emulation in torch, on the inputs' device)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_survivor_emulation as em

    _, _, c = em.emulate_k2(qp, ct, k, nch=nch)
    pairs = max(c["pairs"], 1)
    return {"pairs": c["pairs"], **{key: c[key] / pairs for key in
                                    ("pass1", "pass2_box", "pass2")}}


def _time_k2(torch, sc, sweep, step, t, k, label, reps, rounds, shares):
    """K2 at one step's inputs → its record and the flags."""
    nch = t["rt3"].shape[0]
    qp = sweep.query_table(step["qs"], step["qm"], step["ub_t"])
    got = sc.survivors_and_bounds(qp, t["ct"], k, nch=nch)
    _equal(torch, got, sc.survivors_and_bounds_plain(qp, t["ct"], k, nch=nch),
           f"{label} K2")
    res = {"query_rows": qp.shape[0], "chunks": nch,
           "ms": [_ms(torch, lambda: sc.survivors_and_bounds(qp, t["ct"], k,
                                                            nch=nch), reps)
                  for _ in range(rounds)]}
    if shares:
        res["prefilter"] = _shares(qp, t["ct"], k, nch)
    return qp, got[1], res


def time_sweeps(path, tree, reps, rounds) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    from libpointmatcher_tpu_torch.ops import sweep
    from libpointmatcher_tpu_torch.ops import sweep_cuda as sc

    new = hasattr(sc, "flag_tile")          # K3/K4 take K2's own rows
    new_k6 = getattr(sc, "SWEEPK_TILE", sc.SWEEP_TILE) == sc.BOUND_TILE  # K6 too
    sc.build()
    build_log = [ln.strip() for ln in sc.LIBRARY.build_log.splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    data = torch.load(path)
    out = {"tree": os.path.abspath(tree), "flags": "256" if new else "1024",
           "k6_flags": "256" if new_k6 else "1024", "build": build_log,
           "routes": {}}
    fold = lambda s: s.reshape(-1, 4, s.shape[1]).amax(dim=1)
    for route, v in data.items():
        t = {key: v[key].cuda() for key in ("rt3", "ct")}
        steps = {label: {x: y.cuda() for x, y in v[label].items()}
                 for label in ("cold", "warm") if label in v}
        k = v.get("k", 1)
        res = {}
        for label, step in steps.items():
            qp, surv, res[f"K2 {label}"] = _time_k2(
                torch, sc, sweep, step, t, k, f"{route} {label}", reps, rounds,
                os.path.abspath(tree) == ROOT)
        # qp, surv: the warm step's
        if k == 1:
            flags = surv if new else fold(surv)
            dp, ip = sc.survivor_sweep_plain(qp, t["rt3"], flags)
            for name, fn in (("K3", sc.nn1_survivor_sweep),
                             ("K4", sc.nn1_survivor_sweep_stream)):
                _equal(torch, fn(qp, t["rt3"], flags), (dp, ip),
                       f"{route} {name}")
                res[name] = [_ms(torch, lambda: fn(qp, t["rt3"], flags), reps)
                             for _ in range(rounds)]
        else:
            grain, flags = ("256", surv) if new_k6 else ("1024", fold(surv))
            run = lambda: sc.nnk_survivor_sweep(qp, t["rt3"], flags, k)
            _equal(torch, run(), sc.nnk_survivor_sweep_plain(
                qp, t["rt3"], flags, k), f"{route} K6 at {grain} flags")
            res[f"K6 {grain}"] = [_ms(torch, run, reps) for _ in range(rounds)]
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
