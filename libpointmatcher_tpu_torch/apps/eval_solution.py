"""ETH 'Challenging datasets' evaluation protocol runner
(reference: evaluations/eval_solution.cpp).

The reference downloads the six sequences (apartment, ETH hauptgebaude,
plain, stairs, gazebo winter, wood summer) and runs a YAML solution over all
protocol pairs with one thread per core
(reference: eval_solution.cpp:125-131 — one EvaluationModule per coreId).
The datasets must already be on disk (``--data-root``). The per-pair sweep
maps to pair-parallel batching on the device: consecutive pairs are grouped
``--batch`` at a time and each group runs one lockstep loop
(:func:`..parallel.batch.register_batch`). ``--batch 1`` is the sequential
per-pair path. ``--device cpu`` runs on the CPU; the card is the default.

The JAX package pads every pair to one of at most two shape steps
(:func:`select_ladder`) and repeats pairs to fill the last group, so that
its sweep compiles at most two programs. Eager torch compiles nothing per
shape, so the groups here are neither padded to a ladder nor filled; the
ladder's choice is kept as a function, the JAX package's, for a caller
that wants it.

Protocol CSV format: the standard ``local_frame`` validation files with
``reading``/``reference`` cloud names and iTxy initial + gTxy ground-truth
transforms (parsed by :mod:`..io.filelist`)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument, host
from libpointmatcher_tpu_torch.errors import ConvergenceError
from libpointmatcher_tpu_torch.io.filelist import load_file_info_vector

SEQUENCES = [
    "apartment", "eth", "plain", "stairs", "gazebo", "wood",
]


def pose_errors(T_est: np.ndarray, T_gt: np.ndarray):
    """Translation [m] and rotation [rad] error of T_est vs ground truth."""
    d = T_est.shape[0] - 1
    dT = np.linalg.inv(T_gt) @ T_est
    trans_err = float(np.linalg.norm(dT[:d, d]))
    R = dT[:d, :d]
    if d == 3:
        ang = float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    else:
        ang = float(abs(np.arctan2(R[1, 0], R[0, 0])))
    return trans_err, ang


_CODE_MESSAGES = {
    2: "abs rotation/translation norm not a number",
    3: "transformation bound exceeded (BoundTransformationChecker)",
    4: "ErrorMinimizer: no point to minimize",
}


def _finish_row(i, info, T, wall, iterations, err, verbose=True):
    row = {
        "pair": i,
        "reading": os.path.basename(info.reading),
        "reference": os.path.basename(info.reference),
        "T": np.asarray(T).tolist(),
        "time_s": wall,
        "iterations": int(iterations),
        "error": err,
    }
    if info.ground_truth_transformation is not None:
        te, re_ = pose_errors(
            np.asarray(T), np.asarray(info.ground_truth_transformation))
        row["trans_err"] = te
        row["rot_err"] = re_
    if verbose:
        print(
            f"[{i + 1}] {row['reading']}→{row['reference']} {wall:.3f}s"
            + (f" terr={row.get('trans_err', float('nan')):.4f}"
               f" rerr={row.get('rot_err', float('nan')):.4f}"
               if "trans_err" in row else "")
        )
    return row


def select_ladder(sizes):
    """Choose at most TWO (rows_reading, rows_reference) padded-shape
    ladder steps covering every pair, minimizing total padded cells (the
    JAX package's choice, where each distinct shape is a separate compile).
    ``sizes``: iterable of (reading_bucket, reference_bucket). Returns an
    ascending list of 1-2 (cap_r, cap_f) steps; the last covers all."""
    sized = sorted((br * bf, br, bf) for br, bf in sizes)
    if not sized:
        return []

    def cost(members):
        if not members:
            return 0, (0, 0)
        cr = max(s[1] for s in members)
        cf = max(s[2] for s in members)
        return cr * cf * len(members), (cr, cf)

    best = None
    stride = max(1, len(sized) // 16)
    for split in range(0, len(sized) + 1, stride):
        lo, hi = sized[:split], sized[split:]
        c1, cap1 = cost(lo)
        c2, cap2 = cost(hi)
        n_groups = int(bool(lo)) + int(bool(hi))
        key = (c1 + c2, n_groups)
        if best is None or key < best[0]:
            best = (key, [cap for cap, m in ((cap1, lo), (cap2, hi)) if m])
    return best[1]


def evaluate_protocol(protocol_csv: str, config_yaml: str, data_path: str = "",
                      limit: int = 0, seed: int = 0, batch: int = 8,
                      verbose: bool = True, device=None):
    infos = load_file_info_vector(protocol_csv, data_path=data_path)
    if limit:
        infos = infos[:limit]
    with open(config_yaml) as f:
        yaml_text = f.read()
    # one engine for the whole sweep (per-run module state is
    # re-initialized inside compute)
    icp = pt.ICP(device=device)
    icp.load_from_yaml(yaml_text)

    cache = {}

    def cloud(path):
        c = cache.get(path)
        if c is None:
            c = cache[path] = pt.io.load(path, device=icp.device)
        return c

    pairs = [(i, info) for i, info in enumerate(infos)
             if info.reference is not None]

    if batch <= 1:
        return _evaluate_sequential(icp, pairs, cloud, seed, verbose)

    from ..parallel import register_batch

    results = []
    for off in range(0, len(pairs), batch):
        chunk = pairs[off: off + batch]
        readings = [cloud(info.reading) for _, info in chunk]
        references = [cloud(info.reference) for _, info in chunk]
        T_inits = [
            np.asarray(info.initial_transformation, np.float32)
            if info.initial_transformation is not None
            else np.eye(readings[0].dim + 1, dtype=np.float32)
            for _, info in chunk
        ]
        t0 = time.perf_counter()
        T_b, binfo = register_batch(icp, readings, references,
                                    T_inits=T_inits, seed=seed + chunk[0][0])
        wall = (time.perf_counter() - t0) / len(chunk)
        for b, (i, info) in enumerate(chunk):
            code = int(binfo["codes"][b])
            err = _CODE_MESSAGES.get(code)
            T = T_b[b] if err is None else np.eye(readings[0].dim + 1)
            results.append(_finish_row(
                i, info, T, wall, binfo["iterations"][b], err, verbose))
    return results


def _evaluate_sequential(icp, pairs, cloud, seed, verbose):
    """Per-pair driver (--batch 1): one registration at a time."""
    results = []
    for i, info in pairs:
        reading = cloud(info.reading)
        reference = cloud(info.reference)
        T_init = (
            np.asarray(info.initial_transformation, np.float32)
            if info.initial_transformation is not None else None
        )
        t0 = time.perf_counter()
        try:
            T = host(icp(reading, reference, T_init=T_init, seed=seed + i))
            err = None
        except ConvergenceError as e:
            T = np.eye(reading.dim + 1)
            err = str(e)
        wall = time.perf_counter() - t0
        results.append(_finish_row(
            i, info, T, wall, icp.last_iteration_count, err, verbose))
    return results


def summarize(results):
    te = [r["trans_err"] for r in results if "trans_err" in r]
    re_ = [r["rot_err"] for r in results if "rot_err" in r]
    ts = [r["time_s"] for r in results]
    out = {
        "pairs": len(results),
        "failed": sum(1 for r in results if r["error"]),
        "mean_time_s": float(np.mean(ts)) if ts else None,
        "registrations_per_s": float(1.0 / np.mean(ts)) if ts else None,
    }
    if te:
        out.update(
            median_trans_err=float(np.median(te)),
            p95_trans_err=float(np.quantile(te, 0.95)),
            median_rot_err=float(np.median(re_)),
            p95_rot_err=float(np.quantile(re_, 0.95)),
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Run a YAML solution over an evaluation protocol.")
    p.add_argument("protocol", help="protocol CSV (reading/reference/iT/gT)")
    p.add_argument("config", help="solution YAML "
                   "(e.g. the reference's official_solutions/*.yaml)")
    p.add_argument("--data-root", default="", help="directory of the clouds")
    p.add_argument("--limit", type=int, default=0, help="max pairs (0 = all)")
    p.add_argument("--batch", type=int, default=8,
                   help="pairs per lockstep loop (1 = sequential)")
    p.add_argument("--output", default="eval_results.json")
    add_device_argument(p)
    args = p.parse_args(argv)

    results = evaluate_protocol(
        args.protocol, args.config, args.data_root, args.limit,
        batch=args.batch, device=args.device)
    summary = summarize(results)
    with open(args.output, "w") as f:
        json.dump({"summary": summary, "results": results}, f, indent=1)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
