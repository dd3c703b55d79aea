"""The point-to-plane minimizer on the card, beside its plain version.

========================  ====================================  ==========================
kernel                    replaces                              plain version
========================  ====================================  ==========================
``plane_moments`` +       no Pallas kernel: the JAX package's   :func:`point_to_plane_plain`
``plane_solve``           XLA-fused normal equations and
                          ``utils/smalleig.py::eigh_jacobi``
========================  ====================================  ==========================

The kernels are CUDA C++ in ``csrc/plane.cu`` (see its header for the
design and for what bounds them), built at first use by :mod:`.cuda_build`.
:func:`point_to_plane` takes the stepped reading, its matches and weights
and the reference's points and normals, and returns each scan's
incremental transform and the minimizer's statistics: the whole of
``PointToPlaneErrorMinimizer.compute`` for 3-D input at six degrees of
freedom, in two launches, with no host read.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernels or raises. There is no fallback between the two. The
wrapper counts its calls (each one launch of the pair) in
``point_to_plane.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .cuda_build import KernelLibrary

__all__ = ["PlaneSolve", "point_to_plane", "point_to_plane_plain",
           "eigh_jacobi", "solve_jacobi", "ROUNDS",
           "BLOCK_POINTS", "MAX_BATCH", "build", "LIBRARY", "reset_launch_counts"]

#: reading points a block of the moments pass takes (mirrors ``kBlockPoints``)
BLOCK_POINTS = 1024
#: floats a partial row holds (``kRow``) and outputs a scan (``kOut``)
_ROW = 33
_OUT = 21
#: largest batch the moments grid takes (its y dimension)
MAX_BATCH = 65535
#: the round-robin schedule of the JAX package's parallel Jacobi for p = 6
#: (``smalleig._round_robin_pairs(6)``): 5 rounds of 3 disjoint pairs
ROUNDS = (((0, 5), (1, 4), (2, 3)), ((0, 4), (3, 5), (1, 2)),
          ((0, 3), (2, 4), (1, 5)), ((0, 2), (1, 3), (4, 5)),
          ((0, 1), (2, 5), (3, 4)))
#: Jacobi sweeps (the JAX package's default)
SWEEPS = 4
_DTYPES = (torch.float32, torch.bool, torch.float32, torch.float32,
           torch.float32, torch.int32, torch.float32)


class PlaneSolve(NamedTuple):
    """Per scan: the incremental transform and the minimizer's statistics
    (``MinimizerStats``' fields)."""

    T: torch.Tensor                          # [..., 4, 4]
    residual: torch.Tensor                   # [...] Σ w·dot²
    point_used_ratio: torch.Tensor           # [...]
    weighted_point_used_ratio: torch.Tensor  # [...]
    rejected_matches: torch.Tensor           # [...] int32
    rejected_points: torch.Tensor            # [...] int32


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pm_point_to_plane.argtypes = [p, p, i, i, i, p, p, p, p, p, ll, i, p,
                                      p, p]
    lib.pm_point_to_plane.restype = i
    for fn in ("pm_plane_block_points", "pm_plane_row", "pm_plane_out"):
        getattr(lib, fn).restype = i
    if ((lib.pm_plane_block_points(), lib.pm_plane_row(), lib.pm_plane_out())
            != (BLOCK_POINTS, _ROW, _OUT)):
        raise RuntimeError("csrc/plane.cu block or row sizes differ from "
                           "ops/plane_cuda.py")


LIBRARY = KernelLibrary("plane.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


# ------------------------------------------------------------ plain version
def eigh_jacobi(A: torch.Tensor, sweeps: int = SWEEPS):
    """The JAX package's parallel cyclic Jacobi for batched 6x6 symmetric
    matrices (``utils/smalleig.py::eigh_jacobi``), in the kernel's order:
    per round the three pivots at its start, rows rotated, then columns,
    the eliminated entries set to 0, ``V ← V·G``. → ``(w [..., 6]``
    unsorted, ``V [..., 6, 6])``."""
    A = 0.5 * (A + A.mT)
    V = torch.eye(6, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for pairs in ROUNDS:
            cs = []
            for i, j in pairs:
                aij, aii, ajj = A[..., i, j], A[..., i, i], A[..., j, j]
                safe = torch.where(aij == 0.0, 1.0, 2.0 * aij)
                tau = (ajj - aii) / safe
                sgn = torch.where(tau >= 0.0, 1.0, -1.0)
                t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
                t = torch.where((aij == 0.0) | torch.isnan(t), 0.0, t)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                cs.append((c[..., None], (t * c)[..., None]))
            A = A.clone()
            for (i, j), (c, s) in zip(pairs, cs):
                ai, aj = A[..., i, :].clone(), A[..., j, :].clone()
                A[..., i, :] = c * ai - s * aj
                A[..., j, :] = s * ai + c * aj
            for M in (A, V):
                for (i, j), (c, s) in zip(pairs, cs):
                    ai, aj = M[..., :, i].clone(), M[..., :, j].clone()
                    M[..., :, i] = c * ai - s * aj
                    M[..., :, j] = s * ai + c * aj
                if M is A:
                    for i, j in pairs:
                        A[..., i, j] = 0.0
                        A[..., j, i] = 0.0
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def solve_jacobi(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimal-norm solve of the batched 6x6 normal equations through
    :func:`eigh_jacobi`'s pseudo-inverse with the rank cutoff
    ``max|w|·6·1e-7`` (the JAX package's ``solve_possibly_underdetermined``)."""
    w, V = eigh_jacobi(A)
    tol = torch.amax(torch.abs(w), dim=-1, keepdim=True) * 6 * 1e-7
    keep = w > tol
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    z = winv * (V * b[..., :, None]).sum(dim=-2)
    return (V * z[..., None, :]).sum(dim=-1)


def _shapes(points, mask, ref_points, ref_normals, dists, ids, weights):
    """Shapes checked → ``(bshape, B, n, k, ref_stride)``: the batch shape,
    its size, the points and matches a scan, and 0 for one shared reference
    table (``[M, 3]``) or ``M`` for one a scan (``[..., M, 3]``)."""
    shape = dists.shape
    rows = shape[:-1]
    if (ids.shape != shape or weights.shape != shape or mask.shape != rows
            or points.shape[:-1] != rows or points.shape[-1] != 3):
        raise ValueError(
            f"point_to_plane takes points [..., n, 3], mask [..., n] and "
            f"dists, ids, weights [..., n, k] over one batch shape; got "
            f"{tuple(points.shape)}, {tuple(mask.shape)}, {tuple(dists.shape)}, "
            f"{tuple(ids.shape)}, {tuple(weights.shape)}")
    if ref_points.shape != ref_normals.shape or ref_points.shape[-1] != 3:
        raise ValueError(f"reference points and normals must be [..., M, 3], "
                         f"got {tuple(ref_points.shape)}, {tuple(ref_normals.shape)}")
    bshape, n, k = tuple(rows[:-1]), rows[-1], shape[-1]
    B = math.prod(bshape)
    if ref_points.ndim == 2:
        return bshape, B, n, k, 0
    if tuple(ref_points.shape[:-2]) == bshape:
        return bshape, B, n, k, ref_points.shape[-2]
    raise ValueError(f"reference tables {tuple(ref_points.shape)} for a batch "
                     f"of {bshape}")


def point_to_plane_plain(points, mask, ref_points, ref_normals, dists, ids,
                         weights) -> PlaneSolve:
    """Plain version of the kernel pair: ``PointToPlaneErrorMinimizer``'s
    torch body (``_solve``, its residual and ``build_stats``) with
    :func:`solve_jacobi` in place of its eigensolver."""
    from ..cloud import PointCloud
    from ..matchers import Matches
    from ..minimizers import PointToPlaneErrorMinimizer, build_stats

    _shapes(points, mask, ref_points, ref_normals, dists, ids, weights)
    reading = PointCloud(points, mask)
    reference = PointCloud(ref_points, descriptors={"normals": ref_normals})
    matches = Matches(dists, ids)
    T, pairs, _, dot = PointToPlaneErrorMinimizer()._solve(
        reading, reference, weights, matches, solve=solve_jacobi)
    st = build_stats(reading, weights, matches,
                     torch.sum(pairs.w * dot * dot, dim=-1))
    return PlaneSolve(T, st.residual, st.point_used_ratio,
                      st.weighted_point_used_ratio, st.nb_rejected_matches,
                      st.nb_rejected_points)


# ------------------------------------------------------------------ kernel
def point_to_plane(points, mask, ref_points, ref_normals, dists, ids,
                   weights) -> PlaneSolve:
    """The point-to-plane minimize of a batch: ``points [..., n, 3]`` (the
    stepped reading), ``mask [..., n]``, ``dists, ids, weights [..., n,
    k]``, the reference's ``points`` and ``normals`` as one shared ``[M,
    3]`` table or one per scan (``[..., M, 3]``) → :class:`PlaneSolve`. A
    slot is valid where its distance is finite and its weight non-zero; a
    valid slot's id must index the reference."""
    if points.device.type == "cpu":
        return point_to_plane_plain(points, mask, ref_points, ref_normals,
                                    dists, ids, weights)
    bshape, B, n, k, stride = _shapes(points, mask, ref_points, ref_normals,
                                      dists, ids, weights)
    tensors = (points, mask, ref_points, ref_normals, dists, ids, weights)
    if tuple(t.dtype for t in tensors) != _DTYPES:
        raise ValueError(f"point_to_plane takes {_DTYPES}, got "
                         f"{tuple(t.dtype for t in tensors)}")
    if len({t.get_device() for t in tensors}) != 1:
        raise ValueError("point_to_plane's inputs lie on several devices")
    if B > MAX_BATCH or B * n * k >= 2**31:
        raise ValueError(f"batch {B} x {n} x {k} exceeds the kernel's grid")
    lib = build()
    pts, msk, refs, nrms, d, i, w = (t if t.is_contiguous() else t.contiguous()
                                     for t in tensors)
    nblk = max(1, -(-n // BLOCK_POINTS))
    # T [B, 16], then the statistics as rows of B, then the partial rows
    buf = torch.empty(B * (_OUT + nblk * _ROW), dtype=torch.float32,
                      device=pts.device)
    ptr = buf.data_ptr()
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = lib.pm_point_to_plane(pts.data_ptr(), msk.data_ptr(), B, n, k,
                                d.data_ptr(), i.data_ptr(), w.data_ptr(),
                                refs.data_ptr(), nrms.data_ptr(), stride, nblk,
                                ptr + 4 * _OUT * B, ptr, stream)
    LIBRARY.check(err, "point-to-plane")
    point_to_plane.launches += 1
    residual, used, weighted = buf[16 * B:19 * B].view(3, *bshape).unbind(0)
    rejected_matches, rejected_points = (
        buf[19 * B:21 * B].view(torch.int32).view(2, *bshape).unbind(0))
    return PlaneSolve(buf[:16 * B].view(*bshape, 4, 4), residual, used, weighted,
                      rejected_matches, rejected_points)


def reset_launch_counts() -> None:
    point_to_plane.launches = 0


reset_launch_counts()
