"""The plain reference of scan-to-map registration: the configuration's
chain run module by module in plain torch, from the same seeded inputs the
program gets, with no kernel, table, batching or state of the program.

Each module of the chain's YAML is the file of its name under ``plain/``.
The map chain keys its draws ``fold_in(PRNGKey(map_seed), 1)``, filter i
folding in i; a served scan's chain ``fold_in(PRNGKey(call_seed), slot)``,
slot being the scan's position in its call. The map is centred at the mean
of its kept rows, and each registration iterates in that frame from the
identity on the scan moved by ``centre⁻¹ · T_init``, as upstream's
``ICPSequence`` does (ICP.cpp:316-452), until the chain's checkers stop it;
the final pose is composed back.

``Precision`` sets the dtype; the control runs the same code in float32
with TF32 matrix products (``Precision.mm``).
"""

from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import prng
from .plain._nn import nn1

PLAIN = Path(__file__).resolve().parent / "plain"
REFERENCE_STREAM = 1


@dataclass
class Precision:
    """The reference's arithmetic: ``dtype``, whether float32 matrix
    products run in TF32, and the device."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False
    device: str = "cpu"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A matrix product at this precision. With ``tf32`` the float32
        operands are rounded to TF32's 10-bit mantissa and the products
        accumulate in float32, as TF32 does: on the CPU, which has no TF32,
        and on the card, whose libraries keep small products (a box's 3x3
        covariance) off the tensor cores even with TF32 allowed."""
        if self.tf32 and a.dtype == torch.float32:
            a, b = _tf32(a), _tf32(b)
        return a @ b


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (10-bit mantissa)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _spec(node):
    if isinstance(node, str):
        return node, {}
    (name, params), = node.items()
    return name, dict(params or {})


def _module(name: str):
    path = PLAIN / f"{name}.py"
    if not path.exists():
        raise ValueError(f"the reference has no plain module {name} "
                         f"(add plain/{name}.py)")
    spec = importlib.util.spec_from_file_location(
        f"regbench.plain.{name}", path,
        submodule_search_locations=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "regbench.plain"
    spec.loader.exec_module(mod)
    return mod


class PlainChain:
    """The configuration's chain (its YAML as a dict) as plain modules."""

    def __init__(self, chain: Dict, prec: Precision):
        self.prec = prec
        load = lambda node: (_module(_spec(node)[0]), _spec(node)[1])  # noqa: E731
        self.map_filters = [load(n) for n in chain.get("referenceDataPointsFilters") or []]
        self.read_filters = [load(n) for n in chain.get("readingDataPointsFilters") or []]
        if chain.get("readingStepDataPointsFilters"):
            raise ValueError("the reference runs no reading step filter")
        self.matcher = load(chain["matcher"])
        self.outliers = [load(n) for n in chain.get("outlierFilters") or []]
        self.minimizer = load(chain["errorMinimizer"])
        self.checkers = [load(n) for n in chain.get("transformationCheckers") or []]

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.prec.device
                               ).to(self.prec.dtype)

    # ---------------------------------------------------------------- map
    def map(self, scene: np.ndarray, map_seed: int) -> Dict:
        """The map chain on the scene → rows (scene row of each kept row),
        points and normals (scene frame), cond, and the centre."""
        rows = np.arange(len(scene))
        pts = self.tensor(scene)
        normals = cond = None
        for i, (mod, params) in enumerate(self.map_filters):
            draw = prng.chain_draw(map_seed, REFERENCE_STREAM, i, len(rows))
            out = mod.filter(pts, params, draw, self.prec)
            keep = out["keep"].cpu().numpy()
            if "normals" in out:
                normals, cond = out["normals"], out["cond"]
            rows, pts = rows[keep], pts[torch.as_tensor(keep, device=pts.device)]
            if normals is not None:
                k = torch.as_tensor(keep, device=pts.device)
                normals, cond = normals[k], cond[k]
        centre = pts.to(torch.float64).mean(0)
        return {"rows": rows, "points": pts, "normals": normals,
                "cond": cond, "centre": centre}

    # ------------------------------------------------------------- reading
    def reading_rows(self, scan: np.ndarray, call_seed: int, slot: int) -> np.ndarray:
        """Rows of ``scan`` that its reading chain keeps (in scan order)."""
        rows = np.arange(len(scan))
        key = prng.fold_in(prng.prng_key(call_seed), slot)
        for i, (mod, params) in enumerate(self.read_filters):
            draw = prng.uniform(prng.fold_in(key, i), len(rows))
            keep = mod.filter(torch.as_tensor(scan[rows]), params, draw,
                              self.prec)["keep"].cpu().numpy()
            rows = rows[keep]
        return rows

    # ------------------------------------------------------- registration
    def register(self, mp: Dict, scan: np.ndarray, rows: np.ndarray,
                 T_init: np.ndarray) -> Dict:
        """One registration of ``scan[rows]`` against ``mp`` from ``T_init``
        → {"T": the world pose where the checkers stop, "iters": that
        iteration, "code": the stop code (4 where no match is left, the
        pose then being the last one)}."""
        dt, dev = self.prec.dtype, self.prec.device
        centre = torch.eye(4, dtype=torch.float64, device=dev)
        centre[:3, 3] = mp["centre"]
        T_rmd = torch.linalg.inv(centre) @ torch.as_tensor(
            np.asarray(T_init, np.float64), device=dev)
        ref = mp["points"] - mp["centre"].to(dt)
        normals = mp["normals"]
        p0 = self.tensor(scan[rows])
        T_pre = T_rmd.to(dt)
        p0 = self.prec.mm(p0, T_pre[:3, :3].T) + T_pre[:3, 3]
        T = torch.eye(4, dtype=dt, device=dev)
        states = [m.init(T, prm, self.prec) for m, prm in self.checkers]

        def out(it: int, code: int) -> Dict:
            world = centre @ T.to(torch.float64) @ T_rmd
            return {"T": world.cpu().numpy(), "iters": it, "code": code}

        it = 0
        while True:
            it += 1
            p = self.prec.mm(p0, T[:3, :3].T) + T[:3, 3]
            mod, prm = self.matcher
            d2, ids = mod.match(p, ref, prm, self.prec)
            w = torch.isfinite(d2).to(dt)
            for m, prm_o in self.outliers:
                w = w * m.weights(d2, prm_o, self.prec)
            usable = torch.isfinite(d2) & (w != 0)
            if not bool(usable.any()):
                return out(it, 4)
            safe = ids.clamp(min=0)
            mod_m, prm_m = self.minimizer
            T = mod_m.step(p[usable], ref[safe][usable], normals[safe][usable],
                           w[usable], prm_m, self.prec) @ T
            done, code = False, 0
            for j, (m, prm_c) in enumerate(self.checkers):
                states[j], stop, c = m.check(states[j], T, prm_c, self.prec)
                done, code = done or stop, max(code, c)
            if done:
                return out(it, code)


def kept_digest(points: np.ndarray) -> np.ndarray:
    """The count of a scan's kept rows and the sums of their float32
    coordinates' bit patterns, per axis (int64): equal for two sets of rows,
    in any order, exactly when the sets are equal, but for a collision that
    no rounding or draw makes by chance."""
    bits = np.ascontiguousarray(points, np.float32).view(np.int32)
    return np.concatenate([[len(bits)], bits.astype(np.int64).sum(0)])


# ------------------------------------------------------------ comparisons
def rotation_gap(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Geodesic angle between two rotations, exact near zero."""
    s = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return 2.0 * math.asin(min(1.0, s / (2.0 * math.sqrt(2.0))))


def pose_gap(T: np.ndarray, T_ref: np.ndarray):
    """(rotation rad, translation m) between two 4x4 poses."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    return (rotation_gap(T[:3, :3], T_ref[:3, :3]),
            float(np.linalg.norm(T[:3, 3] - T_ref[:3, 3])))


def map_gaps(prog_points: np.ndarray, prog_normals: np.ndarray, mp: Dict,
             prec: Precision, tol: float = 1e-4):
    """The program's filtered map against the reference's → (rows: how many
    rows one side has and the other lacks, normal: the widest
    sign-free normal gap times the reference's cond over the rows both
    have)."""
    ref_pts = mp["points"].to(torch.float64)
    q = torch.as_tensor(np.asarray(prog_points, np.float64), device=ref_pts.device)
    d2, ids = nn1(q, ref_pts, tol, Precision(torch.float64, False, prec.device))
    hit = ids >= 0
    claimed = torch.unique(ids[hit])
    rows = int((~hit).sum()) + (ref_pts.shape[0] - int(claimed.numel()))
    n_p = torch.as_tensor(np.asarray(prog_normals, np.float64), device=ref_pts.device)[hit]
    n_r = mp["normals"].to(torch.float64)[ids[hit]]
    cond = mp["cond"].to(torch.float64)[ids[hit]]
    gap = torch.minimum(torch.linalg.norm(n_p - n_r, dim=1),
                        torch.linalg.norm(n_p + n_r, dim=1)) * cond
    return rows, float(gap.max()) if gap.numel() else 0.0
