"""Render eval_solution results to a text/CSV report
(the reference ships a Jupyter notebook for this,
evaluations/jupyter/PlotSingleResults.ipynb; this is a terminal table and a
CSV instead). Pure numpy, the port's own copy of the JAX package's
report."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results", help="eval_results.json from eval_solution")
    p.add_argument("--csv", default="", help="optional per-pair CSV output")
    p.add_argument("--bins", type=int, default=10)
    args = p.parse_args(argv)

    with open(args.results) as f:
        doc = json.load(f)
    results = doc["results"]
    summary = doc.get("summary", {})

    print("=" * 64)
    print("Evaluation summary")
    print("=" * 64)
    for k, v in summary.items():
        print(f"  {k}: {v}")

    te = np.array([r["trans_err"] for r in results if "trans_err" in r])
    re_ = np.array([r["rot_err"] for r in results if "rot_err" in r])
    if len(te):
        print("\nTranslation error histogram [m]:")
        counts, edges = np.histogram(te, bins=args.bins)
        peak = max(counts.max(), 1)
        for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
            bar = "#" * int(40 * c / peak)
            print(f"  {lo:8.4f}-{hi:8.4f} | {bar} {c}")
        print("\nRotation error histogram [rad]:")
        counts, edges = np.histogram(re_, bins=args.bins)
        peak = max(counts.max(), 1)
        for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
            bar = "#" * int(40 * c / peak)
            print(f"  {lo:8.4f}-{hi:8.4f} | {bar} {c}")

    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["pair", "reading", "reference", "time_s",
                        "iterations", "trans_err", "rot_err", "error"])
            for r in results:
                w.writerow([
                    r["pair"], r["reading"], r["reference"],
                    f"{r['time_s']:.4f}", r["iterations"],
                    r.get("trans_err", ""), r.get("rot_err", ""),
                    r["error"] or "",
                ])
        print(f"\nper-pair CSV written to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
