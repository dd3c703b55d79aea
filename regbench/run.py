"""One run of one benchmark cell of libpointmatcher_tpu_torch.

    python3 regbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's scene and its pool of scans on the host, filters
the map (``set_map``) and runs ``WARM_CALLS`` of the cell's own calls
untimed. The window then issues serving calls back to back from one client
for ``--seconds`` (whole calls), each carrying the next scans of the pool as
host clouds, and prints one JSON line: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1`` (the same window
with the benchmark's spans, then a short profiled sub-window). After the
window a sample of the registrations it served is recomputed by the plain
reference (``reference.py``) and compared: the filtered map, each sampled
scan's kept rows (read from the serving drivers' reading chain by a
wrapper the harness installs), its iteration count, stop code and pose;
``correct`` says whether every number lies within its limit.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, each metric in ``metrics/<metric>.py`` and
which metrics a cell reports in the checkout's ``BENCHMARK.json``.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # one process with few threads: the host's BLAS runs single-threaded
    # (set before numpy loads it), so the serving drivers' own worker
    # threads (the tile assignment's pool) do not oversubscribe the cores
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_var] = "1"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

MASK32 = 0xFFFFFFFF
#: untimed calls before the window (set-up): the first builds the cell's
#: shapes, the rest let the allocator and the libraries settle
WARM_CALLS = 3
#: top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "libpointmatcher_tpu")


# ------------------------------------------------------------- lookups
def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> SimpleNamespace:
    """The cell ``name`` with its configuration and traffic, by name."""
    cell = load_json(root / "workloads" / f"{name}.json")
    return SimpleNamespace(
        name=name, cell=cell,
        config=load_json(root / "configs" / f"{cell['config']}.json"),
        traffic=load_json(root / "traffic" / f"{cell['traffic']}.json"))


def cell_metrics(bench: Dict, name: str, kind: str) -> List[Dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that BENCHMARK.json
    gives cell ``name``: those listing it, and those that list no cells."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"regbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -------------------------------------------------------------- inputs
def make_inputs(config: Dict, pool: int, seed: int) -> SimpleNamespace:
    """The configuration's scene and pool (fixed by its ``scene.seed``: every
    seed serves the same set of scans) and what ``seed`` draws: the order
    in which calls take the pool, each call's filter seed, the map's."""
    from regbench import scenes

    sc = config["scene"]
    if sc["kind"] != "apartment":
        raise ValueError(f"unknown scene kind {sc['kind']}")
    rng = np.random.default_rng(int(sc["seed"]))
    world = scenes.make_scene(rng, int(sc["points"]))
    truth = scenes.make_poses(world, pool, rng)
    scans = [scenes.make_scan(world, P, rng, int(sc["scan_points"]))
             for P in truth]
    inits = [scenes.perturb(rng, float(sc["trans_sigma"]),
                            float(sc["rot_sigma"])) @ P for P in truth]
    srng = np.random.default_rng(int(seed) % 2**64)
    return SimpleNamespace(
        world=np.asarray(world, np.float32), scans=scans, truth=truth,
        inits=inits, order=srng.permutation(pool),
        map_seed=int(srng.integers(2**32)), call_base=int(srng.integers(2**32)),
        sample_rng=srng)


def call_plan(inp, traffic: Dict, c: int):
    """Call ``c``'s pool rows (round-robin through the seed's order) and
    filter seed."""
    n = int(traffic["scans_per_call"])
    pool = len(inp.scans)
    rows = [int(inp.order[(c * n + j) % pool]) for j in range(n)]
    return rows, (inp.call_base + c) & MASK32


# ------------------------------------------------------------- program
def build_program(config: Dict, inp, device: str):
    import libpointmatcher_tpu_torch as pt

    seq = pt.ICPSequence(device=device)
    seq.load_from_yaml(config["chain"])
    seq.set_map(pt.PointCloud.from_numpy(inp.world, device=device),
                seed=inp.map_seed)
    clouds = [pt.PointCloud.from_numpy(s, device="cpu") for s in inp.scans]
    return seq, clouds


def serve(seq, clouds, inp, traffic: Dict, c: int):
    """One serving call → (rows, call seed, T [n, 4, 4], info)."""
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    rows, call_seed = call_plan(inp, traffic, c)
    batch = [clouds[r] for r in rows]
    inits = [inp.inits[r] for r in rows]
    if traffic["driver"] == "batch":
        T, info = register_batch_to_map(seq, batch, T_inits=inits, seed=call_seed)
    elif traffic["driver"] == "queue":
        T, info = register_queue_to_map(seq, batch, T_inits=inits, seed=call_seed,
                                        lanes=int(traffic["lanes"]))
    else:
        raise ValueError(f"unknown driver {traffic['driver']}")
    return rows, call_seed, T, info


def flagged(info: Dict) -> np.ndarray:
    """Registrations the program itself marks as not exact."""
    n = len(info["iterations"])
    out = np.zeros(n, bool)
    for key in ("compact_overflow", "motion_bound_exceeded"):
        if key in info:
            out |= np.asarray(info[key], bool)
    return out


class KeptRows:
    """Reads each scan's kept rows where the timed path produces them: a
    wrapper on the serving drivers' reading chain
    (``parallel.batch.apply_filter_chain``, which the queue's prep calls
    too) keeps, per call and scan, the device's ``kept_digest`` of the rows
    the chain returns, read on the host once the window has closed. The
    program is not changed."""

    def __init__(self):
        from libpointmatcher_tpu_torch.parallel import batch

        self._mod, self._inner = batch, batch.apply_filter_chain
        self.call: Optional[int] = None
        self.digests: Dict[int, Dict[int, object]] = {}
        batch.apply_filter_chain = self._chain

    def _chain(self, *args, **kwargs):
        cloud = self._inner(*args, **kwargs)
        if self.call is not None:
            import torch
            m = cloud.mask.to(torch.int64)
            bits = cloud.points.contiguous().view(torch.int32).to(torch.int64)
            self.digests.setdefault(self.call, {})[kwargs["scan"]] = torch.cat(
                [m.sum()[None], (bits * m[:, None]).sum(0)])
        return cloud

    def of(self, call: int, slot: int) -> np.ndarray:
        return self.digests[call][slot].cpu().numpy()

    def remove(self) -> None:
        self._mod.apply_filter_chain = self._inner


# ------------------------------------------------------------ checking
def sample_regs(regs: List[Dict], size: int, rng) -> List[Dict]:
    """``size`` registrations drawn from the seed, the one that iterated
    longest among them."""
    if len(regs) <= size:
        return list(regs)
    longest = max(range(len(regs)), key=lambda i: regs[i]["iters"])
    rest = [i for i in range(len(regs)) if i != longest]
    pick = rng.choice(len(rest), size - 1, replace=False)
    return [regs[longest]] + [regs[rest[i]] for i in sorted(pick)]


def judge(config: Dict, inp, prog: Dict, prec) -> Dict[str, float]:
    """The numbers compared: the filtered map's rows and normals and, over
    the sampled registrations, how many kept other reading rows than the
    reference's draw keeps, the widest gap of the iteration counts, how many
    stopped with another code, and the widest pose gap, each side's pose
    where its own checkers stopped."""
    from regbench.reference import PlainChain, kept_digest, map_gaps, pose_gap

    chain = PlainChain(config["chain"], prec)
    mp = chain.map(inp.world, inp.map_seed)
    rows, normal = map_gaps(prog["map_points"], prog["map_normals"], mp, prec)
    out = {"map_rows": float(rows), "map_normal": normal, "read_rows": 0.0,
           "iter_gap": 0.0, "code_gap": 0.0, "pose_rot": 0.0, "pose_trans": 0.0}
    for r in prog["regs"]:
        scan = inp.scans[r["row"]]
        kept = chain.reading_rows(scan, r["call_seed"], r["slot"])
        ref = chain.register(mp, scan, kept, inp.inits[r["row"]])
        g_rot, g_trans = pose_gap(r["T"], ref["T"])
        out["read_rows"] += not np.array_equal(r["kept"], kept_digest(scan[kept]))
        out["iter_gap"] = max(out["iter_gap"], float(abs(r["iters"] - ref["iters"])))
        out["code_gap"] += r["code"] != ref["code"]
        out["pose_rot"] = max(out["pose_rot"], g_rot)
        out["pose_trans"] = max(out["pose_trans"], g_trans)
        if r["iters"] != ref["iters"] or r["code"] != ref["code"]:
            print(f"regbench: iterations {r['iters']} (code {r['code']}), "
                  f"reference {ref['iters']} (code {ref['code']})",
                  file=sys.stderr)
    return out


def plain_outputs(config: Dict, inp, regs: List[Dict], prec) -> Dict:
    """What the plain chain at ``prec`` gives where the program gave
    ``regs``: the control, the reference put in the program's place."""
    from regbench.reference import PlainChain, kept_digest

    chain = PlainChain(config["chain"], prec)
    mp = chain.map(inp.world, inp.map_seed)
    out = []
    for r in regs:
        scan = inp.scans[r["row"]]
        kept = chain.reading_rows(scan, r["call_seed"], r["slot"])
        res = chain.register(mp, scan, kept, inp.inits[r["row"]])
        out.append({**r, "T": res["T"], "iters": res["iters"], "code": res["code"],
                    "kept": kept_digest(scan[kept])})
    return {"map_points": mp["points"].double().cpu().numpy(),
            "map_normals": mp["normals"].double().cpu().numpy(), "regs": out}


def limits_of(config: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in config["limits"].items()}


# ----------------------------------------------------------------- run
def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = HERE,
             bench: Optional[Dict] = None, control=None) -> Dict:
    """One run of cell ``name`` → the result line (a dict). ``control``
    (a ``reference.Precision``) also judges the plain chain at that
    precision in the program's place, under ``control``."""
    import torch

    from regbench.reference import Precision

    cl = load_cell(name, root)
    bench = bench if bench is not None else load_json(root.parent / "BENCHMARK.json")
    config, traffic = cl.config, cl.traffic
    torch.backends.cuda.matmul.allow_tf32 = bool(config["precision"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["precision"]["tf32"])
    cuda = device == "cuda"
    inp = make_inputs(config, int(cl.cell["pool"]), seed)
    seq, clouds = build_program(config, inp, device)
    kept = KeptRows()
    for c in range(WARM_CALLS):
        serve(seq, clouds, inp, traffic, c)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START

    spans = None
    if trace:
        from regbench.trace import StepSpans
        spans = StepSpans(seq)
    regs: List[Dict] = []
    calls, lat, ends = 0, [], []
    attempted = failed = raised = 0
    c = WARM_CALLS
    t0 = time.perf_counter()
    while True:
        if spans:
            spans.begin()
        kept.call = c
        ts = time.perf_counter()
        try:
            rows, call_seed, T, info = serve(seq, clouds, inp, traffic, c)
        except Exception:  # a failed call counts its scans as failed
            traceback.print_exc()
            rows, call_seed, T, info = call_plan(inp, traffic, c) + (None, None)
        te = time.perf_counter()
        kept.call = None
        if spans:
            spans.end()
        lat.append(te - ts)
        ends.append(te - t0)
        calls += 1
        attempted += len(rows)
        if T is None:
            failed += len(rows)
            raised += 1
        else:
            bad = flagged(info)
            for j, r in enumerate(rows):
                ok = not bad[j] and _gates(T[j], inp.truth[r])
                failed += not ok
                regs.append({"row": r, "call_seed": call_seed, "slot": j,
                             "call": c, "T": T[j],
                             "iters": int(info["iterations"][j]),
                             "code": int(info["codes"][j])})
        c += 1
        if te - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    q = np.percentile(1e3 * np.asarray(lat), [10, 50, 90, 100])
    print(f"regbench: {calls} calls in {window_s:.3f} s; call ms p10 {q[0]:.1f} "
          f"p50 {q[1]:.1f} p90 {q[2]:.1f} max {q[3]:.1f}; mean iterations "
          f"{np.mean([r['iters'] for r in regs]):.2f}", file=sys.stderr)
    print(f"regbench: reg/s by sixths of the window {chunk_rates(ends, len(rows))}",
          file=sys.stderr)

    ctx = SimpleNamespace(cell=cl, setup_s=setup_s, window_s=window_s,
                          registrations=attempted, latencies=lat,
                          spans=spans.calls if spans else None, profile=None,
                          match_bytes=None, match_device_s=None)
    breakdown = None
    if trace:
        ctx.profile, ctx.match_bytes, ctx.match_device_s = _profiled(
            seq, clouds, inp, cl, spans, c, cuda)
        breakdown = {
            "device_ops": [[n, s] for n, s, _ in ctx.profile.by_name[:10]],
            "idle_gaps": [[n, s] for n, s in ctx.profile.gaps[:10]]}
        spans.remove()
    kept.remove()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    # the program's outputs to the host, its state freed, then the check
    m = seq.get_prefiltered_internal_map()
    trm = seq.trm_host()
    mask = m.mask.cpu().numpy()
    prog = {"map_points": m.points.cpu().numpy()[mask].astype(np.float64) + trm[:3, 3],
            "map_normals": m.descriptors["normals"].cpu().numpy()[mask],
            "regs": sample_regs(regs, int(config["check_sample"]), inp.sample_rng)}
    for r in prog["regs"]:
        r["kept"] = kept.of(r["call"], r["slot"])
    del seq, clouds, m, kept
    if cuda:
        torch.cuda.empty_cache()
    prec = Precision(torch.float64, False, device)
    t_check = time.perf_counter()
    numbers = judge(config, inp, prog, prec)
    print(f"regbench: {len(prog['regs'])} registrations checked in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    limits = limits_of(config)
    correct = raised == 0 and bool(prog["regs"]) and all(
        numbers[k] <= limits[k] for k in numbers)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for spec in cell_metrics(bench, name, kind):
        value = metric_reader(spec["name"], root)(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = ctx.profile.busy_s
        dev["window_s"] = ctx.profile.wall_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    if control is not None:
        ctrl = plain_outputs(config, inp, prog["regs"], control)
        result["control"] = judge(config, inp, ctrl, prec)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in numbers}
    return result


def chunk_rates(ends: List[float], per_call: int, parts: int = 6) -> List[float]:
    """Registrations per second in each of ``parts`` equal stretches of the
    window, each call counted in the stretch where it ended: whether a
    run's speed drifts inside it or only differs from run to run."""
    span = ends[-1] / parts if ends else 0.0
    counts = np.bincount(np.minimum((np.asarray(ends) / span).astype(int),
                                    parts - 1), minlength=parts) if span else []
    return [round(float(n) * per_call / span, 1) for n in counts]


def _gates(T, T_true) -> bool:
    from regbench import scenes
    return scenes.within_gates(T, T_true)


def _profiled(seq, clouds, inp, cl, spans, c: int, cuda: bool):
    """The profiled sub-window: ``profile_calls`` more calls under
    ``torch.profiler`` with the host phases labelled → (Profile, the bytes
    its matching must move, its matching kernels' device seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from regbench import yardstick
    from regbench.reference import PlainChain, Precision
    from regbench.trace import read_profile

    n = int(cl.traffic["profile_calls"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.labels = True
    first = len(spans.calls)
    served = []
    with profile(activities=acts, acc_events=True) as prof:
        t = time.perf_counter()
        for k in range(n):
            spans.begin()
            served.append(serve(seq, clouds, inp, cl.traffic, c + k))
            spans.end()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans.labels = False
    steps = sum(s.steps for s in spans.calls[first:])
    del spans.calls[first:]
    pr = read_profile(prof, wall, steps)
    names = cl.cell.get("match_kernels", [])
    match_s = sum(s for key, s, _ in pr.by_name if any(k in key for k in names))
    chain = PlainChain(cl.config["chain"], Precision(torch.float64, False, "cpu"))
    map_rows = seq.prefiltered_reference_pts_count
    queries = 0
    for rows, call_seed, _, info in served:
        for j, r in enumerate(rows):
            kept = len(chain.reading_rows(inp.scans[r], call_seed, j))
            queries += kept * int(info["iterations"][j])
    return pr, yardstick.match_bytes(queries, map_rows * steps), match_s


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_note() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel builds stay in the checkout, at a fixed path
    os.environ["PMTPU_CACHE_DIR"] = str(CHECKOUT / ".torch_ext_build")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".triton_cache")
    import torch

    cl = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cl.cell["chips"]):
        print(f"regbench: needs {cl.cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"regbench: {args.workload} seed {args.seed} on {card_note()}",
          file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"regbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
