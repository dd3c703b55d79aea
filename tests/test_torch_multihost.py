"""Two processes on the pair axis: ``tools_torch/dryrun_multihost.py`` on
the CPU (two gloo ranks, 8 pairs of 512 points), in a subprocess under its
own 300 s timeout. Every pose within 1e-5 of the one-process run, the same
iterations and codes, every translation within 0.05 m of the truth
(tests/test_multihost.py's gates). And ``apps.scaling_bench`` on two gloo
ranks on the CPU, and its refusal of an NCCL group there."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_register_batch_agrees_with_one(tmp_path):
    out = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools_torch", "dryrun_multihost.py"),
         "--device", "cpu", "--points", "512", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(out.read_text())
    assert summary["ok"] and len(summary["results"]) == 2
    for r in summary["results"]:
        assert r["multi_vs_single_maxdiff"] < 1e-5
        assert r["trans_err_max_vs_truth"] < 0.05
        assert r["same_iterations_and_codes"]
        assert r["processes"] == 2 and r["pairs"] == 8


def test_scaling_bench_on_cpu_ranks(tmp_path):
    """``apps.scaling_bench`` with two gloo ranks on the CPU: one line a
    mesh size, then the JAX package's JSON keys."""
    proc = subprocess.run(
        [sys.executable, "-m", "libpointmatcher_tpu_torch.apps.scaling_bench",
         "--ranks", "2", "--device", "cpu", "--points", "256", "--runs", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert set(res) == {"1_devices", "2_devices"}
    assert [r["pairs"] for r in res.values()] == [2, 4]
    assert all(r["registrations_per_s"] > 0 for r in res.values())
    assert lines[0].startswith("1 devices: 2 pairs in ")


def test_scaling_bench_refuses_nccl_on_the_cpu():
    from libpointmatcher_tpu_torch.apps import scaling_bench

    with pytest.raises(SystemExit, match="NCCL group needs --device cuda"):
        scaling_bench.main(["--backend", "nccl", "--device", "cpu"])
