"""Tests of the benchmark harness. They run on the CPU through the port's
plain kernels at tiny sizes; the one marked ``cuda`` runs a tiny cell on
the card and skips without one.

    python -m pytest regbench/tests -q
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from regbench_fixtures import CHECKOUT, REGBENCH, tiny_root  # noqa: F401

from regbench import run
from regbench.reference import Precision

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CPU_CONTROL = Precision(torch.float32, True, "cpu")


def test_benchmark_parses_with_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in BENCH[k])
    assert all(m["better"] in ("lower", "higher")
               for k in ("end_to_end", "per_layer") for m in BENCH[k])
    lines = [x["why"] for k in ("configs", "workloads") for x in BENCH[k]]
    lines += [c["source"] for c in BENCH["configs"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(LINE.match(s) for s in lines)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])


def test_every_cell_resolves_its_files_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cl = run.load_cell(w["name"])
        assert cl.cell["config"] == w["config"] and cl.cell["traffic"] == w["traffic"]
        assert (CHECKOUT / configs[w["config"]]["file"]).exists()
        assert cl.config["source"] == configs[w["config"]]["source"]
        for kind in ("end_to_end", "per_layer"):
            for m in run.cell_metrics(BENCH, w["name"], kind):
                assert callable(run.metric_reader(m["name"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_an_added_workload_file_is_found(tiny_root):
    path = tiny_root / "workloads" / "tiny_room.batch4_again.json"
    path.write_text(json.dumps({"config": "tiny_room", "traffic": "batch4",
                                "chips": 1, "pool": 8, "match_kernels": [],
                                "why": "found by name"}))
    try:
        cl = run.load_cell("tiny_room.batch4_again", tiny_root)
        assert cl.config["scene"]["points"] == 6000
        assert cl.traffic["scans_per_call"] == 4
        bench = {"end_to_end": [{"name": "setup_s"},
                                {"name": "latency_p95_ms", "workloads": ["x"]}]}
        assert [m["name"] for m in run.cell_metrics(
            bench, "tiny_room.batch4_again", "end_to_end")] == ["setup_s"]
    finally:
        path.unlink()


def _run(root, cell, trace=False, seconds=0.0, control=None):
    return run.run_cell(cell, 4_294_967_311, seconds, trace, device="cpu",
                        root=root, bench=json.loads(
                            (root.parent / "BENCHMARK.json").read_text()),
                        control=control)


@pytest.mark.parametrize("cell", ["tiny_room.batch4", "tiny_room.queue6"])
def test_tiny_cell_agrees_with_the_reference(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 4
    assert {"registrations_per_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(run.load_cell(cell, tiny_root).config["limits"])
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"], k


def test_traced_run_reads_the_spans(tiny_root):
    res = _run(tiny_root, "tiny_room.batch4", trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert {"prep_ms_per_call", "slot_iterations_per_registration",
            "ms_per_step", "step_enqueue_ms"} <= set(m)
    # no device on the CPU: the device metrics find nothing to read
    assert "match_roofline_share" not in m and "device_idle_share" not in m
    assert m["slot_iterations_per_registration"]["value"] >= 3


@pytest.mark.parametrize("cell", ["tiny_room.batch4", "tiny_room.queue6"])
def test_the_control_fails_the_comparison(tiny_root, cell):
    """The reference in float32 with TF32 products (rounded operands on
    the CPU) in the program's place is not correct."""
    res = _run(tiny_root, cell, control=CPU_CONTROL)
    limits = run.limits_of(run.load_cell(cell, tiny_root).config)
    assert res["correct"]
    assert any(res["control"][k] > limits[k] for k in limits), res["control"]


def _unchanged_step(monkeypatch):
    from libpointmatcher_tpu_torch.icp import ICP
    inner = ICP._step

    def step(self, reading, reference, T_iter, *a, **k):
        return (T_iter,) + inner(self, reading, reference, T_iter, *a, **k)[1:]

    monkeypatch.setattr(ICP, "_step", step)


def _half_batch(monkeypatch):
    from libpointmatcher_tpu_torch.icp import ICP
    inner = ICP._step

    def step(self, reading, reference, *a, **k):
        if reading.points.ndim == 3:
            keep = torch.arange(reading.points.shape[0]) < reading.points.shape[0] // 2
            reading = reading.with_mask(keep.to(reading.mask.device)[:, None])
        return inner(self, reading, reference, *a, **k)

    monkeypatch.setattr(ICP, "_step", step)


def _altered_answer(monkeypatch):
    import libpointmatcher_tpu_torch.parallel as par
    inner = par.register_batch_to_map

    def serve(*a, **k):
        T, info = inner(*a, **k)
        T = np.array(T)
        T[0, 0, 3] += 0.002
        return T, info

    monkeypatch.setattr(par, "register_batch_to_map", serve)


def _early_stop(monkeypatch):
    import libpointmatcher_tpu_torch.parallel as par
    inner = par.register_batch_to_map

    def serve(*a, **k):
        T, info = inner(*a, **k)
        info["iterations"] = np.array(info["iterations"]) - 1
        return T, info

    monkeypatch.setattr(par, "register_batch_to_map", serve)


def _dropped_row(monkeypatch):
    from libpointmatcher_tpu_torch.parallel import batch
    inner = batch.apply_filter_chain

    def chain(*a, **k):
        cloud = inner(*a, **k)
        return cloud.with_mask(torch.arange(cloud.num_points) != 0)

    monkeypatch.setattr(batch, "apply_filter_chain", chain)


@pytest.mark.parametrize(
    "fault", [_unchanged_step, _half_batch, _altered_answer, _early_stop,
              _dropped_row],
    ids=["unchanged_step", "half_batch", "altered_answer", "early_stop",
         "dropped_row"])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, fault):
    """The run as it stands, with the timed path broken underneath (one
    window call; the sample holds its every registration). The cells run
    on one chip, so there is no exchange between chips to leave out."""
    fault(monkeypatch)
    res = _run(tiny_root, "tiny_room.batch4")
    assert not res["correct"], res["checks"]


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path; "
            "from regbench import run, reference, trace, control, scenes; "
            "import libpointmatcher_tpu_torch.parallel; "
            "[run.metric_reader(p.stem) for p in Path(%r).glob('*.py') "
            "if p.stem != '__init__']; "
            "[reference._module(p.stem) for p in Path(%r).glob('[A-Z]*.py')]; "
            "print(run.forbidden_modules())") % (
                str(CHECKOUT), str(REGBENCH / "metrics"), str(REGBENCH / "plain"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(CHECKOUT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(REGBENCH / "run.py"), "--workload",
                          "apartment_counter40.batch32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run.run_cell("tiny_room.batch4", 7, 0.5, True, device="cuda",
                       root=tiny_root, bench=json.loads(
                           (tiny_root.parent / "BENCHMARK.json").read_text()))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
