"""Histogram statistics accumulator (counterpart of
``libpointmatcher_tpu.utils.histogram``; reference:
pointmatcher/Histogram.{h,cpp}): named scalar samples, their mean,
variance, median, quartiles, minimum and maximum, a fixed-bin histogram
and a CSV dump."""

from __future__ import annotations

import csv
import io
from typing import Dict, List

__all__ = ["Histogram"]


class Histogram:
    def __init__(self, name: str = "", bin_count: int = 16):
        self.name = name
        self.bin_count = bin_count
        self.values: List[float] = []

    def push(self, value: float) -> None:
        self.values.append(float(value))

    def __len__(self):
        return len(self.values)

    def stats(self) -> Dict[str, float]:
        v = sorted(self.values)
        n = len(v)
        if n == 0:
            nan = float("nan")
            return {k: nan for k in
                    ("mean", "var", "median", "lowQt", "highQt", "min", "max")}
        mean = sum(v) / n
        var = sum((x - mean) ** 2 for x in v) / n if n > 1 else 0.0
        return {"mean": mean, "var": var, "median": v[n // 2],
                "lowQt": v[n // 4], "highQt": v[(3 * n) // 4],
                "min": v[0], "max": v[-1]}

    def bins(self):
        """``(counts [bin_count], low, high)`` over equal-width bins."""
        v = self.values
        if not v:
            return [0] * self.bin_count, 0.0, 0.0
        lo, hi = min(v), max(v)
        width = (hi - lo) / self.bin_count if hi > lo else 1.0
        counts = [0] * self.bin_count
        for x in v:
            counts[min(int((x - lo) / width), self.bin_count - 1)] += 1
        return counts, lo, hi

    def dump_stats(self) -> str:
        s = self.stats()
        buf = io.StringIO()
        csv.writer(buf).writerow(
            [self.name, len(self.values), s["mean"], s["var"], s["median"],
             s["lowQt"], s["highQt"], s["min"], s["max"]])
        return buf.getvalue()

    @staticmethod
    def dump_stats_header(name: str = "") -> str:
        cols = ["name", "count", "mean", "var", "median", "lowQt", "highQt",
                "min", "max"]
        return ",".join(f"{name}_{c}" if name else c for c in cols) + "\n"
