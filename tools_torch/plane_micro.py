"""The point-to-plane kernel pair (``csrc/plane.cu``) timed alone at the
benchmark's shapes, beside its bound, its plain version and the torch path
it replaced.

    python3 tools_torch/plane_micro.py [--batch 32] [--points 25000]
        [--knn 1] [--map 49950] [--reps 200] [--out JSON] [--device cpu]

Inputs: ``make_scene``, a box room of ``--map`` rows with normals and
``--batch`` moved, noisy readings of ``--points`` matched rows each (masked
rows, inf distances and zero weights mixed in), made from a fixed seed.
The tool builds ``plane.cu`` into a fresh directory, so that ptxas's
report (registers, spills) of this build is printed, then reports:

- ``kernel_ms``: one call of the wrapper (both launches), CUDA events over
  ``--reps`` calls back to back; ``device_ms`` with ``moments_ms`` and
  ``solve_ms``: the two kernels' own device time a call from
  ``torch.profiler``; ``enqueue_ms``: the wrapper's host time a call;
- ``bound_ms``: the bytes the call reads, each input byte once (points,
  masks, distances, ids, weights, the reference tables) at 3.35 TB/s, and
  ``bound_gathers_ms`` counting each valid slot's 24-byte gather of map
  rows instead of the tables once;
- ``plain_ms``: the plain version on the card (CUDA events);
- the yardstick, ``torch_path_ms``: ``PointToPlaneErrorMinimizer``'s torch
  body (the pair gathers, the ``[6 x P]·[P x 6]`` GEMM, ``torch.linalg.eigh``
  with its host read of the error flags, the statistics) a call, host wait
  included (host clock, each call synchronised), and its
  ``torch_path_device_ms`` from the profiler.

Prints one JSON object (and writes it to ``--out``). ``--device cpu``
runs the plain version alone, for a rehearsal of the tool; it reports no
time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PEAK_BYTES_S = 3.35e12


def make_scene(seed, device, B=3, n=600, m=900, k=1, pair=False,
               shape="room", rotate=False):
    """A box room (``floor``: its floor alone, rank 3; ``corridor``: floor
    and two walls, rank 5) of ``m`` map rows with their normals and ``B``
    readings of ``n`` points, each a moved copy of matched map rows with
    noise (one table per reading with ``pair``); some rows masked, some
    slots at inf distance or zero weight. ``rotate`` turns the whole scene
    so that no null direction lies on an axis. → (reading, reference,
    weights, matches) on ``device``."""
    from libpointmatcher_tpu_torch.cloud import PointCloud
    from libpointmatcher_tpu_torch.matchers import Matches
    from libpointmatcher_tpu_torch.utils import se3

    rng = np.random.default_rng(seed)
    lim = np.array([6.0, 4.0, 1.5])
    axes, signs = {"room": ([2, 2, 1, 1, 0, 0], [-1, 1, -1, 1, -1, 1]),
                   "floor": ([2], [-1]),
                   "corridor": ([2, 1, 1], [-1, -1, 1])}[shape]

    def table():
        face = rng.integers(0, len(axes), m)
        p = rng.uniform(-1, 1, (m, 3)) * lim
        nrm = np.zeros((m, 3))
        for f, (a, s) in enumerate(zip(axes, signs)):
            p[face == f, a] = s * lim[a]
            nrm[face == f, a] = -s
        return p, nrm

    tabs = [table() for _ in range(B if pair else 1)]
    ids = rng.integers(0, m, (B, n, k))
    pose = se3.rodrigues(torch.tensor(rng.normal(scale=0.02, size=(B, 3)),
                                      dtype=torch.float32)).double().numpy()
    q = np.stack([tabs[b if pair else 0][0][ids[b, :, 0]] for b in range(B)])
    pts = (np.einsum("bij,bnj->bni", pose, q)
           + rng.normal(scale=0.05, size=(B, 1, 3))
           + rng.normal(scale=0.005, size=q.shape))
    p_tab = np.stack([t[0] for t in tabs])
    n_tab = np.stack([t[1] for t in tabs])
    if rotate:
        Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pts, p_tab, n_tab = pts @ Q.T, p_tab @ Q.T, n_tab @ Q.T
    mask = rng.random((B, n)) > 0.05
    d = rng.random((B, n, k)).astype(np.float32)
    d[rng.random((B, n, k)) < 0.05] = np.inf
    d[~mask] = np.inf
    ids = ids.astype(np.int32)
    ids[~np.isfinite(d)] = -1
    w = rng.random((B, n, k)).astype(np.float32)
    w[rng.random((B, n, k)) < 0.05] = 0.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(device)

    ref_shape = (B, m, 3) if pair else (m, 3)
    reading = PointCloud(t(pts), t(mask, torch.bool))
    reference = PointCloud(t(p_tab).reshape(ref_shape),
                           descriptors={"normals": t(n_tab).reshape(ref_shape)})
    return reading, reference, t(w), Matches(t(d), t(ids, torch.int32))


def _bytes(reading, reference, weights, matches):
    """(each input byte once, with each valid slot's gather instead of the
    tables) for one call."""
    B, n, k = matches.dists.shape
    valid = int((torch.isfinite(matches.dists) & (weights != 0)).sum())
    per_point = B * n * (12 + 1) + B * n * k * 12 + B * 21 * 4
    tables = 2 * reference.points.numel() * 4
    return per_point + tables, per_point + valid * 24


def _events_ms(fn, reps):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _profile(fn, reps):
    """{kernel name: device ms a call} over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0.0)
        if dev and ev.key and not ev.key.startswith(("aten::", "cuda", "Memcpy")):
            out[ev.key] = out.get(ev.key, 0.0) + dev / 1000.0 / reps
    return out


def run(batch=32, points=25000, knn=1, map_rows=49950, reps=200,
        device="cuda") -> dict:
    from libpointmatcher_tpu_torch.minimizers import (PointToPlaneErrorMinimizer,
                                                      build_stats)
    from libpointmatcher_tpu_torch.ops import plane_cuda as pc

    reading, reference, weights, matches = make_scene(
        25, device, B=batch, n=points, m=map_rows, k=knn)
    args = (reading.points, reading.mask, reference.points,
            reference.get_descriptor("normals"), matches.dists, matches.ids,
            weights)
    once, gathers = _bytes(reading, reference, weights, matches)
    out = {"shape": {"batch": batch, "points": points, "knn": knn,
                     "map": map_rows},
           "bytes_once": once, "bytes_gathers": gathers,
           "bound_ms": once / PEAK_BYTES_S * 1e3,
           "bound_gathers_ms": gathers / PEAK_BYTES_S * 1e3}
    if device == "cpu":
        t0 = time.perf_counter()
        pc.point_to_plane(*args)
        out["plain_cpu_s"] = time.perf_counter() - t0
        return out

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    os.environ["PMTPU_CACHE_DIR"] = tempfile.mkdtemp(prefix="plane_micro_")
    pc.build()
    out["ptxas"] = [ln.strip() for ln in pc.LIBRARY.build_log.splitlines()
                    if re.search(r"Compiling entry|registers|spill", ln)]

    got = pc.point_to_plane(*args)
    want = pc.point_to_plane_plain(*args)
    torch.cuda.synchronize()
    out["max_T_gap"] = float((got.T - want.T).abs().max())

    out["kernel_ms"] = _events_ms(lambda: pc.point_to_plane(*args), reps)
    prof = _profile(lambda: pc.point_to_plane(*args), reps)
    out["moments_ms"] = sum(v for k, v in prof.items() if "plane_moments" in k)
    out["solve_ms"] = sum(v for k, v in prof.items() if "plane_solve" in k)
    out["device_ms"] = out["moments_ms"] + out["solve_ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pc.point_to_plane(*args)
    out["enqueue_ms"] = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    out["plain_ms"] = _events_ms(lambda: pc.point_to_plane_plain(*args), 5)
    out["roofline_share"] = out["bound_ms"] / out["device_ms"] * 100.0

    torch_path = PointToPlaneErrorMinimizer()

    def yard():
        T, pairs, _, dot = torch_path._solve(reading, reference, weights,
                                             matches)
        return T, build_stats(reading, weights, matches,
                              torch.sum(pairs.w * dot * dot, dim=-1))

    yard()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps // 4):
        yard()
        torch.cuda.synchronize()
    out["torch_path_ms"] = (time.perf_counter() - t0) / (reps // 4) * 1e3
    yprof = _profile(yard, reps // 4)
    out["torch_path_device_ms"] = sum(yprof.values())
    out["torch_path_top"] = sorted(yprof.items(), key=lambda kv: -kv[1])[:5]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=25000)
    ap.add_argument("--knn", type=int, default=1)
    ap.add_argument("--map", type=int, default=49950)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.device != "cpu" and not torch.cuda.is_available():
        print("plane_micro.py needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 2
    res = run(a.batch, a.points, a.knn, a.map, a.reps, a.device)
    text = json.dumps(res)
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
