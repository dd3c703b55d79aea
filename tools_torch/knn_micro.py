"""The 1-NN lowerings on the card at the JAX tool's serving shape: the dense
K1 kernel (the control), K9, and the variants T1, T2 and T3 (counterpart of
tools/knn_micro.py).

    python3 tools_torch/knn_micro.py [N M] [--reps 20] [--device cpu]
        [--out FILE.json]

The default shape is the JAX tool's: N = 20 480 queries against M = 12 459
references, uniform in [-10, 10]^3 from ``default_rng(0)``, the last 7% of
the queries masked, every reference valid. Each kernel is first checked
against K1: T1 and T2 must equal it bit for bit, d² and ids; T3 and K9 must
lie within 2^-20·(q² + r²max) of K1's d², and report their id agreement
(over the valid queries, and where the neighbour is unique beyond that
bound). A failed check exits non-zero. Each kernel is then timed with CUDA
events over ``--reps`` launches after one warm-up, in ms and in Tcell/s
(N·M cells a launch). The script prints one JSON object with the card's
name, the shape, and per kernel its check and its time.

The JAX tool's other cases: its ``mxu default`` (a bf16 pass of the TPU's
matrix unit) is refused by the port's T3 and reported so; its tile-size
sweeps have no counterpart, each port kernel having one schedule, and are
reported once.

Needs a CUDA device. ``--device cpu`` runs the wrappers' plain versions, at
2048 x 1246 unless N M are given, to check the script; its times are the
host's clock and no measure of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, M = 20480, 12459          # the JAX tool's shape
CPU_SHAPE = (2048, 1246)
REPS = 20
#: the expansion form's rounding bound, per unit of q² + r²
MXU_TOL = 2.0 ** -20


def make_inputs(torch, n, m, device, seed=0):
    """The JAX tool's inputs: ``(q [n, 3], qm [n], r [m, 3], rm [m])``."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    return [torch.as_tensor(a, device=device) for a in (q, qm, r, rm)]


def kernels():
    """name → the wrapper, called as ``fn(q, qm, r, rm)``."""
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv

    return {"K1 knn1": kc.knn1, "K9 knn1_mxu": kc.knn1_mxu,
            "T1 knn1_chunked": kv.knn1_chunked,
            "T2 knn1_transposed": kv.knn1_transposed,
            "T3 knn1_mxu": kv.knn1_mxu}


def check(torch, name, d, i, ref, q, qm, r, rm) -> dict:
    """One kernel's result against K1's → its check record; raises if it
    fails."""
    d1, i1, second = ref
    v = qm
    if name.startswith(("K1", "T1", "T2")):
        if not (torch.equal(d, d1) and torch.equal(i, i1)):
            raise AssertionError(f"{name} differs from K1")
        return {"equal_to_k1": True}
    fin = torch.isfinite(d1)
    if not torch.equal(fin, torch.isfinite(d)):
        raise AssertionError(f"{name}: finite pattern differs from K1's")
    tol = MXU_TOL * ((q * q).sum(dim=1) + float((r[rm] * r[rm]).sum(dim=1).max()))
    err = (d - d1).abs()
    if not bool((err <= tol)[fin].all()):
        raise AssertionError(f"{name}: |Δd²| above 2^-20·(q²+r²max)")
    unique = v & fin & ((second - d1) > 2 * tol)
    return {"max_abs_err": float(err[fin].max()) if fin.any() else 0.0,
            "id_agreement": float((i[v] == i1[v]).float().mean()),
            "id_agreement_unique": float((i[unique] == i1[unique]).float().mean()),
            "unique_share": float(unique[v].float().mean())}


def _time(torch, fn, reps, device) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def run(n=N, m=M, reps=REPS, device="cuda") -> dict:
    """Check every kernel against K1 and time it → the report."""
    import torch

    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv

    q, qm, r, rm = make_inputs(torch, n, m, device)
    d1, i1 = kc.knn1(q, qm, r, rm)
    second = kc.knnk(q, qm, r, rm, 2)[0][:, 1]
    cells = n * m
    out = {"device": (torch.cuda.get_device_name(0) if device != "cpu"
                      else "cpu (host clock, plain versions)"),
           "n": n, "m": m, "cells": cells, "reps": reps, "kernels": {}}
    for name, fn in kernels().items():
        d, i = fn(q, qm, r, rm)
        rec = check(torch, name, d, i, (d1, i1, second), q, qm, r, rm)
        rec["ms"] = _time(torch, lambda: fn(q, qm, r, rm), reps, device)
        rec["cells_per_s"] = cells / (rec["ms"] * 1e-3)
        out["kernels"][name] = rec
    try:
        kv.knn1_mxu(q, qm, r, rm, precision="default")
        raise AssertionError("T3 ran at precision 'default'")
    except ValueError as e:
        out["refused"] = {"mxu default 512x2048": str(e)}
    out["not_ported"] = {
        "tile-size sweeps (vpu 256x4096, 1024x2048, 512x4096; chunked "
        "1024x2048, 256x4096; transposed 4096x512, 2048x1024)":
            "each port kernel has one schedule"}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shape", nargs="*", type=int, help="N M")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if len(args.shape) not in (0, 2):
        ap.error("give both N and M, or neither")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("knn_micro: no CUDA device", file=sys.stderr)
        return 1
    n, m = args.shape or (CPU_SHAPE if args.device == "cpu" else (N, M))
    try:
        report = run(n, m, args.reps, args.device)
    except AssertionError as e:
        print(f"knn_micro: check failed: {e}", file=sys.stderr)
        return 1
    for name, rec in report["kernels"].items():
        print(f"{name:20s} {rec['ms']:10.4f} ms  {rec['cells_per_s'] / 1e12:.4f} "
              f"Tcell/s", file=sys.stderr)
    for name, why in {**report["refused"], **report["not_ported"]}.items():
        print(f"{name}: {why}", file=sys.stderr)
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
