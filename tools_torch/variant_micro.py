"""T2 and T3 (the transposed and matrix-product 1-NN lowerings) and T4 and
T5 (K7's min-only ablations), timed at the tools' shapes and at recorded
main-path inputs: the A/B of two trees of the port on one card.

    python3 tools_torch/variant_micro.py record --out FILE
    python3 tools_torch/variant_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--t2-split AIM:ROWS,...]
        [--t3-split AIM,...] [--yardstick] [--out JSON]

``record`` keeps two inputs, written to FILE with ``torch.save`` (~0.3 GB):

- ``K1 sequence``: K1's arguments at the second iteration of
  ``ICPSequence.compute`` on chip_smoke.py's 100 000-point scene (its
  50 147-row map), as tools_torch/dense_micro.py records them;
- ``K7 batch 1e5``: K7's parent-form arguments at the second lockstep
  iteration of a batch of 8 scans on chip_smoke.py's 10^5-point terrain
  (phase 14), as per-tile inputs (chip_smoke.py's ``vtile_inputs``: each
  virtual tile's queries ``[Bf·Tv, TQ, 8]`` against its table
  ``[Bf·Tv, 8, M]``), what phase 19 gives T4 and T5 (phase 20 gives T1-T3
  phase 5's K1 inputs, recorded the same way).

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit, or a copy with another
build of a kernel, is timed on the same inputs: run the trees in turns
(parent, change, change, parent), one process each. T2 and T3 run at the
JAX tool's 20 480 × 12 459 (tools_torch/knn_micro.py) and at ``K1
sequence``, T2 held to K1 and to its plain version bit for bit, T3 to
``knn1_mxu3_plain`` bit for bit and to K1's d² within 2^-20·(q² +
r²max); T4 and T5 at the JAX tool's 2048 × 256 × 4096
(tools_torch/tile_kernel_micro.py) and at ``K7 batch 1e5``, held to
``tile_min_plain`` and to K7's d² bit for bit. Each is timed with CUDA
events (``--reps`` launches, ``--rounds`` times), K1 and K7 beside them.
``--t2-split`` times T2 at other split rules in turn (``AIM:ROWS``:
``knn_variants_cuda``'s ``T2_BLOCKS_PER_SM`` and ``T2_CHUNK_ROWS``, in
trees that have them), ``--t3-split`` T3 at other aims
(``T3_BLOCKS_PER_SM``). Every input reports its bound (9 fp32 operations
a pair, T3 8, at 67 TFLOP/s, or its bytes at 3.35 TB/s) and issue floor
(9 instructions a pair at one warp instruction a clock in each of the
SMs' partitions at 1.98 GHz; for T3 also at its 8) over the pairs the
function needs: T2 and T3 their valid (query, reference) pairs, T4 every
query against its tile's real candidates. ``--yardstick`` adds the plain
versions' times and the PyTorch yardsticks (``torch.cdist`` + ``min``,
for T3 in its matmul form with TF32 off; for T4 the batched call, cut
into chunks of tiles where cdist refuses it). Needs a CUDA device; prints
one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
ISSUE_LANES_S = 4 * 32 * 1.98e9      # per SM: four partitions of 32 lanes
OPS_PER_PAIR = 9


# ------------------------------------------------------------- record
def record(path: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import dispatch, tilesweep
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import register_batch_to_map

    saved = {}
    # the sequence (tools_torch/dense_micro.py's "K1 sequence")
    rng = np.random.default_rng(0)
    world = cs.make_scene(rng)
    poses = cs.make_poses(world, 5, rng)
    scans = [cs.make_scan(world, P, rng) for P in poses]
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    with cs.InputRecorder(dispatch, "knn1", keep=2) as rec:
        seq.compute(pt.PointCloud.from_numpy(scans[1]),
                    T_init=cs.perturb(rng) @ poses[1], seed=1)
    saved["K1 sequence"] = dict(zip(("q", "qm", "r", "rm"),
                                    (x.cpu() for x in rec.calls[1][:4])))
    del seq
    # the terrain batch (chip_smoke.py phase 14)
    rng = np.random.default_rng(7)
    map_pts, side = cs.make_terrain(cs.TERRAIN_MAPS[0], rng)
    scans, _ = cs.make_terrain_scans(map_pts, side, rng)
    seq = cs.terrain_sequence(pt)
    seq.set_map(pt.PointCloud.from_numpy(map_pts), seed=0)
    with cs.InputRecorder(tilesweep, "tile_sweep_parents", keep=2) as rec:
        register_batch_to_map(seq, [pt.PointCloud.from_numpy(s) for s in scans],
                              seed=1)
    q, cand, dim = cs.vtile_inputs(torch, tc, rec.calls[1][:6])
    saved["K7 batch 1e5"] = {"q": q.cpu(), "cand": cand.cpu(), "dim": dim}
    torch.save(saved, path)
    return {"K1 sequence": list(saved["K1 sequence"]["q"].shape)
            + [int(saved["K1 sequence"]["r"].shape[0])],
            "K7 batch 1e5": list(cand.shape) + [int(q.shape[1])]}


# ------------------------------------------------------------- time
def _ms(fn, reps):
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


def _bounds(pairs, nbytes, sms, ops=OPS_PER_PAIR) -> dict:
    t_ops = ops * pairs / FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_S
    out = {"pairs": pairs, "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "issue_floor_ms": 1e3 * OPS_PER_PAIR * pairs / (sms * ISSUE_LANES_S)}
    if ops != OPS_PER_PAIR:
        out[f"issue_floor_{ops}_ms"] = 1e3 * ops * pairs / (sms * ISSUE_LANES_S)
    return out


def _ptxas(log, names) -> dict:
    """ptxas's registers, spills and shared memory of the entry functions
    whose mangled names hold one of ``names`` (empty: built earlier)."""
    out, lines = {}, log.splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry" in ln and any(n in ln for n in names):
            out[ln.split("'")[1]] = " ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[k + 1:k + 4]
                if "stack frame" in x or "Used" in x)
    return out


def _equal(got, want, what):
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what} differs")


def _t2_rules(kv, spec):
    """The split rules to time T2 at: [(label, aim, rows)], this tree's own
    first; the others only in trees with ``T2_CHUNK_ROWS``."""
    if not spec or not hasattr(kv, "T2_CHUNK_ROWS"):
        return [("own", None, None)]
    return [("own", None, None)] + [
        (f"aim {a}, rows {r}", int(a), int(r))
        for a, r in (item.split(":") for item in spec.split(","))]


def _t3_aims(kv, spec):
    """The aims to time T3 at: [(label, aim)], this tree's own first; the
    others only in trees with ``T3_BLOCKS_PER_SM``."""
    if not spec or not hasattr(kv, "T3_BLOCKS_PER_SM"):
        return [("own", None)]
    return [("own", None)] + [(f"aim {a}", int(a)) for a in spec.split(",")]


def _t3(kc, kv, q, qm, r, rm, reps, rounds, spec, sms) -> dict:
    """T3 at one input: bit for bit its plain version, within 2^-20·(q² +
    r²max) of K1's d², timed at this tree's aim and at ``spec``'s."""
    d1, _ = kc.knn1(q, qm, r, rm)
    dp, ip = kv.knn1_mxu3_plain(q, qm, r, rm)
    tol = 2.0 ** -20 * ((q * q).sum(dim=1) + float((r[rm] * r[rm]).sum(dim=1).max()))
    fin = torch.isfinite(d1)
    res = {}
    for rule, aim in _t3_aims(kv, spec):
        own = getattr(kv, "T3_BLOCKS_PER_SM", None)
        if aim is not None:
            kv.T3_BLOCKS_PER_SM = aim
        fn = lambda: kv.knn1_mxu(q, qm, r, rm)
        d, i = fn()
        _equal((d, i), (dp, ip), f"T3 ({rule}) against its plain version")
        if not (torch.equal(fin, torch.isfinite(d))
                and bool(((d - d1).abs() <= tol)[fin].all())):
            raise AssertionError(f"T3 ({rule}): |Δd²| to K1 above 2^-20·(q²+r²max)")
        key = "T3" if rule == "own" else f"T3 {rule}"
        res[key] = [_ms(fn, reps) for _ in range(rounds)]
        if hasattr(kv, "t3_split"):
            res[f"{key} splits, chunk"] = list(kv.t3_split(
                int(q.shape[0]), int(r.shape[0]), sms))
        if aim is not None:
            kv.T3_BLOCKS_PER_SM = own
    res["T3 max_abs_err_to_k1"] = float((d - d1).abs()[fin].max())
    return res


def time_kernels(path, tree, reps, rounds, t2_split=None, t3_split=None,
                 yardstick=False):
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, ROOT)
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    from tools_torch import knn_micro, tile_kernel_micro

    for lib in (kv.LIBRARY, tc.LIBRARY, kc.LIBRARY):
        lib.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    data = torch.load(path)
    out = {"tree": os.path.abspath(tree), "sms": sms,
           "ptxas": _ptxas(kv.LIBRARY.build_log + tc.LIBRARY.build_log,
                           ("nn1_transposed", "nn1_mxu", "tile_min")),
           "inputs": {}}
    # ---- T2 and T3
    k1 = data["K1 sequence"]
    t2_inputs = {"T2 tool 20480x12459": knn_micro.make_inputs(
        torch, knn_micro.N, knn_micro.M, "cuda"),
        "T2 K1 sequence": [k1[k].cuda() for k in ("q", "qm", "r", "rm")]}
    for label, (q, qm, r, rm) in t2_inputs.items():
        d1, i1 = kc.knn1(q, qm, r, rm)
        dp, ip = (x[:, 0] for x in knn_brute_force(q, qm, r, rm, k=1))
        res = {"shape": [int(q.shape[0]), int(r.shape[0])],
               **_bounds(float(qm.sum()) * float(rm.sum()),
                         13.0 * (q.shape[0] + r.shape[0]) + 8.0 * q.shape[0], sms),
               "K1": [_ms(lambda: kc.knn1(q, qm, r, rm), reps)
                      for _ in range(rounds)]}
        for rule, aim, rows in _t2_rules(kv, t2_split):
            own = (getattr(kv, "T2_BLOCKS_PER_SM", None),
                   getattr(kv, "T2_CHUNK_ROWS", None))
            if aim is not None:
                kv.T2_BLOCKS_PER_SM, kv.T2_CHUNK_ROWS = aim, rows
            fn = lambda: kv.knn1_transposed(q, qm, r, rm)
            _equal(fn(), (d1, i1), f"{label} T2 ({rule}) against K1")
            _equal(fn(), (dp, ip), f"{label} T2 ({rule}) against its plain version")
            key = "T2" if rule == "own" else f"T2 {rule}"
            res[key] = [_ms(fn, reps) for _ in range(rounds)]
            if hasattr(kv, "t2_split"):
                res[f"{key} splits, chunk"] = list(kv.t2_split(
                    int(q.shape[0]), int(r.shape[0]), sms))
            if aim is not None:
                kv.T2_BLOCKS_PER_SM, kv.T2_CHUNK_ROWS = own
        res.update(_t3(kc, kv, q, qm, r, rm, reps, rounds, t3_split, sms))
        res["T3 bound"] = _bounds(res["pairs"], 13.0 * (q.shape[0] + r.shape[0])
                                  + 8.0 * q.shape[0], sms, ops=8)
        if yardstick:
            res["plain_ms"] = _ms(lambda: knn_brute_force(q, qm, r, rm, k=1), 3)
            rv = r[rm]
            res["library_ms"] = _ms(lambda: torch.cdist(
                q, rv, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1), 3)
            res["T3 plain_ms"] = _ms(lambda: kv.knn1_mxu3_plain(q, qm, r, rm), 3)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                res["T3 library_ms"] = _ms(lambda: torch.cdist(
                    q, rv, compute_mode="use_mm_for_euclid_dist").min(dim=1), 3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        out["inputs"][label] = res
    del t2_inputs
    # ---- T4 (and T5)
    k7 = data["K7 batch 1e5"]
    qt, ct, _, _ = tile_kernel_micro.make_inputs(
        torch, tile_kernel_micro.T, tile_kernel_micro.TQ, tile_kernel_micro.M,
        "cuda")
    t4_inputs = {"T4 tool 2048x256x4096": (qt, ct, 3),
                 "T4 K7 batch 1e5": (k7["q"].cuda(), k7["cand"].cuda(), k7["dim"])}
    del qt, ct
    for label, (q, cand, dim) in t4_inputs.items():
        dp = tc.tile_min_plain(q, cand, dim)
        d7, _ = tc.tile_sweep(q, cand, dim)
        _equal((d7,), (dp,), f"{label} K7's d² against T4's plain version")
        ncand = (cand[:, tc.PEN_ROW] == 0).sum(dim=1).double()
        nq = q.shape[0] * q.shape[1]
        res = {"shape": [int(q.shape[0]), int(q.shape[1]), int(cand.shape[2])],
               **_bounds(float((ncand * q.shape[1]).sum()),
                         4.0 * (dim + 1) * (nq + float(ncand.sum())), sms),
               "K7": [_ms(lambda: tc.tile_sweep(q, cand, dim), reps)
                      for _ in range(rounds)]}
        for name, fn in (("T4", tc.tile_min_only), ("T5", tc.tile_min_one)):
            _equal((fn(q, cand, dim),), (dp,), f"{label} {name}")
            res[name] = [_ms(lambda: fn(q, cand, dim), reps) for _ in range(rounds)]
        if yardstick:
            import chip_smoke as cs

            res["plain_ms"] = _ms(lambda: tc.tile_min_plain(q, cand, dim), 2)
            res["library_ms"], res["library_calls"] = cs.cdist_min_ms(
                torch, q, cand, dim, label)
        out["inputs"][label] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "time"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None, help="the file `record` wrote")
    ap.add_argument("--tree", default=ROOT, help="root of the port to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--t2-split", default=None,
                    help="other T2 split rules to time, AIM:ROWS,...")
    ap.add_argument("--t3-split", default=None,
                    help="other T3 split aims to time, AIM,...")
    ap.add_argument("--yardstick", action="store_true")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("variant_micro: no CUDA device", file=sys.stderr)
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
        res = {"device": smi, **time_kernels(args.inputs, args.tree, args.reps,
                                             args.rounds, args.t2_split,
                                             args.t3_split, args.yardstick)}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
