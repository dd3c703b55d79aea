"""What K7's id tracking and its schedule cost on the card: the same work
through the dense K1 kernel (the control), K7, and K7's two min-only
ablations T4 and T5 (counterpart of tools/tile_kernel_micro.py).

    python3 tools_torch/tile_kernel_micro.py [--tiles 2048] [--tq 256]
        [--m 4096] [--reps 10] [--out FILE.json]

The default shape is the JAX tool's: T = 2048 tiles of TQ = 256 queries,
each against its own M = 4096 candidates (the 4·10^5-point assignment),
uniform in [-5, 5]^3 from a seed, every candidate real (pen 0). The control
is K1 over the T·TQ query rows against M references, the same number of
(query, candidate) cells. T4 (four queries a thread, ``cp.async`` stages) and
T5 (one tile a block, its whole list at once) compute K7's d² without the
id; the script checks that both equal K7's d² bit for bit before it times
anything. Each kernel is timed with CUDA events over ``--reps`` launches
after one warm-up; the script prints one JSON object with the card's name,
the shape, and per kernel its ms and cells per second.

Needs a CUDA device. ``--device cpu`` runs the wrappers' plain versions at
the given shape, to check the script; its times are the host's clock and no
measure of the card.

:func:`emulate_t4` is T4's schedule in plain torch, which
tests/test_torch_variant_schedule.py holds to the plain version bit for bit.
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

T, TQ, M = 2048, 256, 4096      # the JAX tool's shape
REPS = 10


def make_inputs(torch, tiles, tq, m, device, seed=0):
    """K7's inputs (``q [T, TQ, 8]``, ``cand [T, 8, M]``: coordinates in
    rows 0..2, pen 0 in row 6, the position as the id in row 7) and the
    control's (``T·TQ`` query rows, ``M`` references)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((tiles, tq, 8), np.float32)
    q[..., :3] = rng.uniform(-5, 5, (tiles, tq, 3))
    cand = np.zeros((tiles, 8, m), np.float32)
    cand[:, :3] = rng.uniform(-5, 5, (tiles, 3, m))
    cand[:, 7] = np.arange(m, dtype=np.float32)
    qd = rng.uniform(-5, 5, (tiles * tq, 3)).astype(np.float32)
    rd = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(q), t(cand), t(qd), t(rd)


def emulate_t4(q, cand, dim):
    """T4's schedule in plain torch, on any device → ``d2 [T, TQ]``: the
    tiles in blocks of ``T4_THREADS // team`` (``tile_cuda.t4_team``; the
    last block's missing tiles and each tile's query slots past TQ swept
    as dead), each table staged ``4 * team`` columns at a time, every four
    columns copied with the columns past M zero-filled and then folded (x +
    pen, +inf past M), the stage swept over whole groups of 8 columns, each
    group folded with fminf and each query's minimum kept with fminf."""
    import torch

    from libpointmatcher_tpu_torch.ops import tile_cuda as tc

    T, tq, _ = q.shape
    m = cand.shape[2]
    team = tc.t4_team(tq)
    per_block, cols = tc.T4_THREADS // team, 4 * team
    t_pad = -(-T // per_block) * per_block
    slots = -(-tq // (tc.T4_QUERIES * team)) * tc.T4_QUERIES * team
    inf = float("inf")
    qs = torch.zeros((t_pad, slots, 3), dtype=torch.float32, device=q.device)
    qs[:T, :tq, :dim] = q[..., :dim]
    best = torch.full((t_pad, slots), inf, device=q.device)
    for m0 in range(0, m, cols):
        span = -(-min(cols, m - m0) // 8) * 8          # whole groups
        tab = torch.zeros((t_pad, 4, span), dtype=torch.float32, device=q.device)
        valid = min(span, m - m0)                      # zero-filled past M
        tab[:T, :, :valid] = cand[:, [0, 1, 2, tc.PEN_ROW], m0:m0 + valid]
        if dim == 2:
            tab[:, 2] = 0.0
        live = torch.zeros((t_pad, span), dtype=torch.bool, device=q.device)
        live[:T, :valid] = True
        x = torch.where(live, tab[:, 0] + tab[:, 3], inf)
        dx = qs[..., 0, None] - x[:, None, :]
        dy = qs[..., 1, None] - tab[:, None, 1]
        dz = qs[..., 2, None] - tab[:, None, 2]
        d = (dx * dx + dy * dy) + dz * dz               # [t_pad, slots, span]
        for g in range(0, span, 8):
            gm = d[..., g:g + 8]
            for w in (4, 2, 1):
                gm = torch.fmin(gm[..., :w], gm[..., w:2 * w])
            best = torch.fmin(best, gm[..., 0])
    return best[:T, :tq]


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


def run(tiles=T, tq=TQ, m=M, reps=REPS, device="cuda") -> dict:
    """Check T4 and T5 against K7 and time the four kernels → the report."""
    import torch

    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc

    q, cand, qd, rd = make_inputs(torch, tiles, tq, m, device)
    qm = torch.ones(qd.shape[0], dtype=torch.bool, device=device)
    rm = torch.ones(rd.shape[0], dtype=torch.bool, device=device)
    d7, _ = tc.tile_sweep(q, cand, 3)
    for name, fn in (("T4", tc.tile_min_only), ("T5", tc.tile_min_one)):
        if not torch.equal(fn(q, cand, 3), d7):
            raise AssertionError(f"{name} differs from K7's d2")
    kernels = {
        "K1 control": lambda: kc.knn1(qd, qm, rd, rm),
        "K7 tile_sweep": lambda: tc.tile_sweep(q, cand, 3),
        "T4 tile_min_only": lambda: tc.tile_min_only(q, cand, 3),
        "T5 tile_min_one": lambda: tc.tile_min_one(q, cand, 3),
    }
    cells = tiles * tq * m
    out = {"device": (torch.cuda.get_device_name(0) if device != "cpu"
                      else "cpu (host clock, plain versions)"),
           "tiles": tiles, "tq": tq, "m": m, "cells": cells, "kernels": {}}
    for name, fn in kernels.items():
        ms = _time(torch, fn, reps, device)
        out["kernels"][name] = {"ms": ms, "cells_per_s": cells / (ms * 1e-3)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=T)
    ap.add_argument("--tq", type=int, default=TQ)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("tile_kernel_micro: no CUDA device", file=sys.stderr)
        return 1
    report = run(args.tiles, args.tq, args.m, args.reps, args.device)
    for name, rec in report["kernels"].items():
        print(f"{name:18s} {rec['ms']:10.4f} ms  {rec['cells_per_s'] / 1e12:.4f} "
              f"Tcell/s", file=sys.stderr)
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
