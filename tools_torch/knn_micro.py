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

:func:`emulate_t1`, :func:`emulate_t2` and :func:`emulate_t3` are T1's,
T2's and T3's schedules in plain torch, which
tests/test_torch_variant_schedule.py holds to the plain versions bit for
bit; :func:`negative_twins` makes the inputs on which T3's
expansion form goes below 0 that those tests and the card's use.
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


def emulate_t2(q, qm, r, rm, sms: int = 132):
    """T2's schedule in plain torch, on any device → ``(d [N], id [N])``:
    the reference cut into chunks by ``knn_variants_cuda.t2_split`` for
    ``sms`` SMs, blocks of ``T2_BLOCK_QUERIES`` queries (a warp whose
    queries are all masked does not sweep), ``x + pen`` staging, groups of
    8 rows folded with fminf, the best group's first row equal to its
    minimum, the chunks merged in order with a strict '<'. It is K1's
    schedule (tools_torch/dense_micro.py) at T2's block and split."""
    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
    from tools_torch import dense_micro

    splits, chunk = kv.t2_split(q.shape[0], r.shape[0], sms)
    d, i, _, _ = dense_micro._emulate_pair(q, qm, r, rm, 1, splits, chunk,
                                           block=kv.T2_BLOCK_QUERIES)
    return d[:, 0], i[:, 0]


def emulate_t1(q, qm, r, rm, sms: int = 132):
    """T1's schedule in plain torch, on any device → ``(d [N], id [N])``:
    the reference cut into chunks by ``knn_variants_cuda.t1_split`` for
    ``sms`` SMs, ``x + pen`` staging, (+inf, 0, 0) past a chunk's end;
    blocks of ``T1_BLOCK_QUERIES`` queries, each warp's a contiguous run (a
    block or a warp whose queries are all masked does not sweep); each
    query keeps ``T1_ACCUMULATORS`` (min, id) accumulators, accumulator a
    taking the rows j ≡ a (mod T1_ACCUMULATORS), each updated with a strict
    '<' in increasing row order (so it holds its rows' minimum at its first
    row; NaN never taken); after the chunk the accumulators merge in (d²,
    id) order; the chunks merge in order with a strict '<'. d² is K1's
    ``(dx·dx + dy·dy) + dz·dz`` against ``x + pen``."""
    import torch

    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
    from tools_torch import dense_micro

    dev = q.device
    inf = float("inf")
    n, m = q.shape[0], r.shape[0]
    bq, acc = kv.T1_BLOCK_QUERIES, kv.T1_ACCUMULATORS
    splits, chunk = kv.t1_split(n, m, sms)
    q3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    q3[:, :q.shape[1]] = q
    nb = max(1, -(-n // bq))
    valid = torch.zeros(nb * bq, dtype=torch.bool, device=dev)
    valid[:n] = qm
    sweeps = valid.view(nb, 4, bq // 4).any(-1, keepdim=True).expand(
        nb, 4, bq // 4).reshape(-1)[:n]
    rows = torch.zeros((3, splits * chunk), dtype=torch.float32, device=dev)
    rows[0] = inf
    rows[0, :m] = r[:, 0] + torch.where(rm, 0.0, inf).to(torch.float32)
    rows[1:r.shape[1], :m] = r[:, 1:].T
    best_d = torch.full((n,), inf, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c in range(splits):
        sl = slice(c * chunk, (c + 1) * chunk)
        d = dense_micro._d2(q3, rows[0, sl], rows[1, sl], rows[2, sl])
        d = torch.where(sweeps[:, None] & ~torch.isnan(d), d, inf)
        # accumulator a: its rows' minimum at the first row holding it
        da = d.view(n, chunk // acc, acc)                # [n, steps, acc]
        bd = da.amin(1)
        first = (da == bd[:, None, :]).int().argmax(1)
        bi = torch.where(bd < inf, c * chunk + first * acc
                         + torch.arange(acc, device=dev), -1)
        # the accumulators in (d², id) order: (+inf, -1) holds no neighbour
        cd = bd.amin(1)
        big = torch.iinfo(torch.int64).max
        ci = torch.where(bd == cd[:, None], bi, big).amin(1)
        ci = torch.where(cd < inf, ci, -1)
        take = cd < best_d
        best_d = torch.where(take, cd, best_d)
        best_i = torch.where(take, ci, best_i)
    ok = torch.isfinite(best_d) & qm
    return (torch.where(qm, best_d, torch.full_like(best_d, inf)),
            torch.where(ok, best_i, -1).to(torch.int32))


def _mxu_dot(a, b):
    """``(a₀b₀ + a₁b₁) + a₂b₂`` (the last term at d = 3), each step rounded,
    as ``knn_variants_cuda.knn1_mxu3_plain`` forms it."""
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    return s + a[..., 2] * b[..., 2] if a.shape[-1] == 3 else s


def emulate_t3(q, qm, r, rm, sms: int = 132):
    """T3's schedule in plain torch, on any device → ``(d [N], id [N])``:
    the reference cut into chunks by ``knn_variants_cuda.t3_split`` for
    ``sms`` SMs, staged in 256-column stages (``(0, 0, 0, +inf)`` past the
    chunk); blocks of ``T3_BLOCK_QUERIES`` queries, rows ``ty + 16 i`` of
    thread (ty, tx) (a block or a warp of them whose queries are all
    masked does not sweep: ``(+inf, −1)``); each row's 16 threads
    take the columns ``4 tx + e`` and ``64 + 4 tx + e`` of every 128-column
    tile, one group a tile, folded with fmin, (best, best tile) kept with a
    strict '<'; the best tile's first column equal to the best; the 16
    threads' (d², id) reduced lexicographically; the chunks merged in order
    with a strict '<', unclamped; then the clamp at 0 and the query mask.
    d² = (q² + r²pen) − 2·dot as the plain version forms it (the kernel's
    fma gives the same bits: 2·dot is exact)."""
    import torch

    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv

    n, m = q.shape[0], r.shape[0]
    inf = float("inf")
    block, stage, tile = kv.T3_BLOCK_QUERIES, kv.T3_CHUNK_COLS, 128
    splits, chunk = kv.t3_split(n, m, sms)
    q2 = _mxu_dot(q, q)
    r2pen = torch.where(rm, _mxu_dot(r, r), torch.full_like(r[:, 0], inf))
    # which rows sweep: their block's and their warp's (rows ty + 16 i of
    # thread (ty, tx); a warp holds ty = 2w, 2w + 1) queries not all masked
    nb, per = -(-n // block), block // 16
    qmp = torch.zeros(nb * block, dtype=torch.bool, device=q.device)
    qmp[:n] = qm
    by_block = qmp.view(nb, per, 16)               # [block, i, ty]
    warp = by_block.view(nb, per, 8, 2).any(dim=(1, 3))
    sweeps = (by_block.any(dim=(1, 2))[:, None] & warp)[:, None, :, None]
    sweeps = sweeps.expand(nb, per, 8, 2).reshape(-1)[:n]
    # column e of thread tx's group: 4 tx + e (e < 4), 64 + 4 tx + e - 4
    e = torch.arange(8, device=q.device)
    tx = torch.arange(16, device=q.device)
    offs = torch.where(e < 4, 4 * tx[:, None] + e, 64 + 4 * tx[:, None] + e - 4)
    best_d = torch.full((n,), inf, device=q.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=q.device)
    for j0 in range(0, splits * chunk, chunk):
        j1 = min(m, j0 + chunk)
        if j1 <= j0:                       # no rows: (+inf, -1), never taken
            continue
        w = -(-(j1 - j0) // stage) * stage
        rc = torch.zeros((w, q.shape[1]), dtype=torch.float32, device=q.device)
        rp = torch.full((w,), inf, device=q.device)
        rc[:j1 - j0] = r[j0:j1]
        rp[:j1 - j0] = r2pen[j0:j1]
        d = (q2[:, None] + rp[None]) - 2.0 * _mxu_dot(q[:, None, :], rc[None])
        g = d.view(n, w // tile, tile)[:, :, offs]       # [n, tile, tx, e]
        fold = g
        for h in (4, 2, 1):
            fold = torch.fmin(fold[..., :h], fold[..., h:2 * h])
        gm = fold[..., 0].transpose(1, 2)               # [n, tx, tile]
        bd = gm.amin(dim=2)
        first_tile = (gm == bd[..., None]).int().argmax(dim=2)
        cols = g.transpose(1, 2).gather(
            2, first_tile[..., None, None].expand(n, 16, 1, 8))[:, :, 0]
        first_e = (cols == bd[..., None]).int().argmax(dim=2)
        bi = j0 + first_tile * tile + offs[tx[None], first_e]
        bi = torch.where(torch.isinf(bd), -1, bi)   # no group under +inf: -1
        bd = torch.where(sweeps[:, None], bd, inf)
        bi = torch.where(sweeps[:, None], bi, -1)
        # the row's 16 threads: the least d², then the least id
        pd = bd.amin(dim=1)
        big = torch.iinfo(torch.int64).max
        pi = torch.where(bd == pd[:, None], bi, big).amin(dim=1)
        take = pd < best_d
        best_d = torch.where(take, pd, best_d)
        best_i = torch.where(take, pi, best_i)
    best_d = torch.clamp(best_d, min=0.0)
    ok = torch.isfinite(best_d) & qm
    best_d = torch.where(qm, best_d, torch.full_like(best_d, inf))
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    return best_d, best_i.to(torch.int32)


def negative_twins(rng, count, lo=500.0, hi=1000.0):
    """``count`` queries far from the origin, each with two near-copies
    (a few ulp off) whose expansion-form d² (as ``knn1_mxu3_plain`` forms
    it) are both negative and differ → ``(q [count, 3], less [count, 3],
    more [count, 3])``: ``more`` the more negative."""
    out = []
    while len(out) < count:
        qv = rng.uniform(lo, hi, 3).astype(np.float32)
        steps = rng.integers(-4, 5, (64, 3)).astype(np.float32)
        cand = (qv + steps * np.spacing(qv)).astype(np.float32)
        q2 = (qv[0] * qv[0] + qv[1] * qv[1]) + qv[2] * qv[2]
        r2 = (cand[:, 0] * cand[:, 0] + cand[:, 1] * cand[:, 1]) + cand[:, 2] * cand[:, 2]
        dot = (qv[0] * cand[:, 0] + qv[1] * cand[:, 1]) + qv[2] * cand[:, 2]
        d = (q2 + r2) - np.float32(2.0) * dot
        neg = np.unique(d[d < 0])
        if len(neg) >= 2:
            out.append((qv, cand[d == neg[-1]][0], cand[d == neg[0]][0]))
    return tuple(np.stack(x) for x in zip(*out))


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
