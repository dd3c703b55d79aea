"""Fixtures of the benchmark's tests: a copy of the harness with tiny cells
added as files, which run on the CPU through the port's plain kernels."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REGBENCH = HERE.parent
CHECKOUT = REGBENCH.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: a tiny version of the configuration: the same chain, a scene small
#: enough for the CPU (the map under 16 384 rows: the dense route)
TINY = {
    "tiny_room": ("apartment_counter40", {"points": 6000, "scan_points": 1500}),
}
TINY_TRAFFIC = {
    "batch4": {"driver": "batch", "scans_per_call": 4, "lanes": None,
               "profile_calls": 1},
    "queue6": {"driver": "queue", "scans_per_call": 6, "lanes": 2,
               "profile_calls": 1},
}
TINY_CELLS = {
    "tiny_room.batch4": ("tiny_room", "batch4", ["knn1"]),
    "tiny_room.queue6": ("tiny_room", "queue6", ["knn1"]),
}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of ``regbench/`` holding the tiny cells, and the copy's
    ``BENCHMARK.json`` listing them."""
    base = tmp_path_factory.mktemp("checkout")
    root = base / "regbench"
    shutil.copytree(REGBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for name, (parent, scene) in TINY.items():
        cfg = json.loads((REGBENCH / "configs" / f"{parent}.json").read_text())
        cfg["scene"].update(scene)
        cfg["check_sample"] = 4
        _write(root / "configs" / f"{name}.json", cfg)
    for name, tr in TINY_TRAFFIC.items():
        _write(root / "traffic" / f"{name}.json", tr)
    for name, (config, traffic, kernels) in TINY_CELLS.items():
        _write(root / "workloads" / f"{name}.json",
               {"config": config, "traffic": traffic, "chips": 1, "pool": 8,
                "match_kernels": kernels, "why": "a CPU test"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + list(TINY_CELLS)
    _write(base / "BENCHMARK.json", bench)
    return root
