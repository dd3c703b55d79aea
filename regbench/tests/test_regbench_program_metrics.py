"""The per-layer metrics that read the program's own telemetry
(``regbench/program.py``), on a tiny traced cell on the CPU.

    python -m pytest regbench/tests -q
"""

from __future__ import annotations

import json
import math

import pytest

from regbench_fixtures import CHECKOUT, tiny_root  # noqa: F401

from libpointmatcher_tpu_torch import telemetry
from regbench import run

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
#: the metrics whose reader reads the program's telemetry
PROGRAM = sorted(m["name"] for m in BENCH["per_layer"]
                 if "regbench import program" in (
                     CHECKOUT / "regbench" / "metrics" / f"{m['name']}.py").read_text())
ENQUEUE = ("filter_enqueue_ms", "match_enqueue_ms", "outlier_enqueue_ms",
           "minimize_enqueue_ms", "check_enqueue_ms")
#: read only where the map takes the survivor route (not the tiny cells'
#: dense one)
SURVIVOR = ("map_tables_ms",)


def test_program_metrics_are_declared():
    assert len(PROGRAM) == 17
    assert set(ENQUEUE) <= set(PROGRAM)
    queue_only = [m for m in BENCH["per_layer"] if m["name"] == "lane_swap_ms_per_call"]
    assert queue_only[0]["workloads"] == ["apartment_counter40.queue256"]


@pytest.mark.parametrize("cell,survivor", [("tiny_room.batch4", False),
                                           ("tiny_room.queue6", False),
                                           ("tiny_room.batch4", True)])
def test_each_program_metric_reads_a_finite_number(tiny_root, cell, survivor,
                                                   monkeypatch):
    if survivor:
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    # the set-up metrics read the process's first records: as a fresh
    # process has them, whatever this process ran before
    telemetry.reset()
    res = run.run_cell(cell, 4_294_967_311, 0.0, True, device="cpu",
                       root=tiny_root, bench=json.loads(
                           (tiny_root.parent / "BENCHMARK.json").read_text()))
    assert res["correct"], res["checks"]
    m = res["metrics"]
    want = [n for n in PROGRAM
            if (n != "lane_swap_ms_per_call" or cell.endswith("queue6"))
            and (n not in SURVIVOR or survivor)]
    for name in want:
        assert name in m, name
        assert math.isfinite(m[name]["value"]) and m[name]["value"] >= 0, name
    if cell.endswith("batch4"):
        assert "lane_swap_ms_per_call" not in m
    # the modules' enqueue lies inside the harness's wrapper on the step
    assert sum(m[n]["value"] for n in ENQUEUE) <= m["step_enqueue_ms"]["value"]
    # one sync a step for the flags and one for the minimizer's solve
    assert m["host_syncs_per_call"]["value"] >= 2 * 40
