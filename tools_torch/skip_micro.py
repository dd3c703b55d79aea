"""The v1 skip route's kernels, K10 and K11, timed at recorded serving
inputs: the A/B of two trees of the port on one card.

    python3 tools_torch/skip_micro.py record --out FILE
    python3 tools_torch/skip_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--out JSON]

``record`` serves one ``register_batch_to_map`` of 8 scans of 25 000
points on the 60 000-point scene of tools_torch/profile_serving.py (a map
of ~30 000 rows, chip_smoke.py's v1 cell) under ``PMTPU_SKIP_V1=1`` and
``PMTPU_SKIP_MXU_BOUND=1``, and keeps the arguments of
``ops.skip.nn1_sorted_v1`` at its first lockstep iteration (cold: no
transported bound) and its second (warm). It then serves a queue of 16
such scans through 8 lanes under the same switches and keeps the second
lane iteration's. All is written to FILE with ``torch.save``.

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit is timed on the same inputs:
run the trees in turns (parent, change, change, parent), one process each.
Per step it forms K10's inputs (``augment_queries``) and K11's flags as
``nn1_sorted_v1`` does (the transported bound tightened by K10's), holds
each kernel to its plain version bit for bit, and times both with CUDA
events over ``--reps`` launches, ``--rounds`` times. When the tree is this
checkout it also reports K10's work at these inputs from ``emulate_k10``
(tests/torch_skip_emulation.py, on the card): the box and lane tests, the
chunks swept (those swept lane by lane, and per warp: mean, 99th
percentile, maximum), the share of the (query, column) pairs that the lanes
failing their own test need, and the share whose t is formed. Needs a CUDA device; prints one JSON object (and writes it to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWITCHES = ("PMTPU_SKIP_V1", "PMTPU_SKIP_MXU_BOUND")


# ------------------------------------------------------------- record
def _step(call):
    names = ("qs", "qm", "ub2", "rt", "rpen", "cbox", "ra")
    return {k: v.cpu() for k, v in zip(names, call[:7])}


def record(path: str) -> dict:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools_torch"))
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import skip
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)
    from sweep_micro import _serve_scene

    rng = np.random.default_rng(0)
    world, clouds, inits = _serve_scene(cs, pt, rng, "K3", 2 * cs.QUEUE_LANES)
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    saved_env = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ[k] = "1"
    saved = {}
    try:
        batch = clouds[:cs.SERVE_BATCH]
        with cs.InputRecorder(skip, "nn1_sorted_v1", keep=2) as rec:
            register_batch_to_map(seq, batch, T_inits=inits[:cs.SERVE_BATCH], seed=1)
        saved["batch cold"] = _step(rec.calls[0])
        saved["batch warm"] = _step(rec.calls[1])
        with cs.InputRecorder(skip, "nn1_sorted_v1", keep=2) as rec:
            register_queue_to_map(seq, clouds, T_inits=inits, seed=1,
                                  lanes=cs.QUEUE_LANES)
        saved["queue warm"] = _step(rec.calls[1])
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.save(saved, path)
    return {label: {"queries": list(v["qs"].shape[:2]),
                    "map_columns": int(v["ra"].shape[1])}
            for label, v in saved.items()}


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


def _equal(got, want, what):
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what} differs from its plain version")


def k10_work(qa, ra) -> dict:
    """K10's work at these inputs, from its emulation on their device."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_skip_emulation as em

    _, c = em.emulate_k10(qa, ra)
    per = c.pop("per_warp").cpu().numpy()
    return {**c, "swept_share": c["swept_pairs"] / max(c["dense_pairs"], 1),
            "formed_share": c["formed_pairs"] / max(c["dense_pairs"], 1),
            "chunks": em.k10_table(ra)["nch"],
            "chunks_swept_a_warp": {"mean": float(per.mean()),
                                    "p99": float(np.percentile(per, 99)),
                                    "max": int(per.max())}}


def time_kernels(path, tree, reps, rounds) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    from libpointmatcher_tpu_torch.ops import skip
    from libpointmatcher_tpu_torch.ops import skip_cuda as skc

    skc.build()
    build_log = [ln.strip() for ln in skc.LIBRARY.build_log.splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    data = torch.load(path)
    out = {"tree": os.path.abspath(tree), "build": build_log, "steps": {}}
    for label, v in data.items():
        qs, qm, ub2, rt, rpen, cbox, ra = (v[k].cuda() for k in (
            "qs", "qm", "ub2", "rt", "rpen", "cbox", "ra"))
        b, n, _ = qs.shape
        qa, q2 = skip.augment_queries(qs, -(-n // skc.TILE_Q) * skc.TILE_Q)
        amin = skc.approx_min_sorted(qa, ra)
        _equal((amin,), (skc.approx_min_sorted_plain(qa, ra),), f"{label} K10")
        amin = amin[:, :n]
        flags = skip.build_skip_mask(
            qs, qm, torch.minimum(ub2, amin + skip.bound_margin(q2, amin)), cbox)
        args = (qs, qm, rt, rpen, flags)
        _equal(skc.nn1_sorted_skip(*args), skc.nn1_sorted_skip_plain(*args),
               f"{label} K11")
        res = {"queries": [b, n], "valid_queries": int(qm.sum()),
               "map_columns": int(ra.shape[1]),
               "skipped_share": float(flags.float().mean()),
               "K10": [_ms(lambda: skc.approx_min_sorted(qa, ra), reps)
                       for _ in range(rounds)],
               "K11": [_ms(lambda: skc.nn1_sorted_skip(*args), reps)
                       for _ in range(rounds)]}
        if os.path.abspath(tree) == ROOT:
            res["K10 work"] = k10_work(qa, ra)
        out["steps"][label] = res
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
        print("skip_micro: no CUDA device", file=sys.stderr)
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
                                             args.rounds)}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
