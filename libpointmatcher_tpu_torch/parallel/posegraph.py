"""Pose-graph optimization by matrix-free Gauss-Newton, on one device
(counterpart of ``libpointmatcher_tpu.parallel.posegraph``).

Given keyframe poses and relative-pose constraints from scan-to-map
registrations (each optionally weighted, e.g. by the Censi covariance the
WithCov minimizers produce), all poses are optimized jointly. Each
Gauss-Newton step solves its normal equations by conjugate gradient with
JᵀWJ products that never form the [6K, 6K] Hessian. The JAX package
differentiates the whole residual with ``jax.jvp``/``jax.vjp`` inside each
product of its compiled loop; eager torch would pay that tracing on every
product, so here each step first takes the Jacobian's two nonzero 6x6
blocks per constraint (∂r_c/∂δ_i and ∂r_c/∂δ_j, by reverse-mode autograd
through the same residual: six products for all constraints), and each CG
product is then two batched 6x6 products and a scatter-add. The loops
are plain Python over tensors on the poses' device, with the JAX package's
fixed counts (no early exit), damping and 1e-20 guards.

Parametrization: poses as [K, 4, 4]; updates as per-pose twists
δ = (ω, u) ∈ R⁶ applied as T ← T·exp(δ) with the rotation/translation
decoupled retraction. Pose 0 is gauge-fixed.

The sharded form: the JAX package shards the edge arrays over a mesh and
lets XLA split the two sweeps of each CG product. Here
``optimize_pose_graph(..., mesh=)`` takes this rank's share of the edges
(:func:`shard_edges`): in each product the local J·δ and the scatter-add
of Jᵀ(W·r) into ``[K, 6]`` are followed by one ``all_reduce(SUM)``, as is
the final residual's sum; the dot products over poses stay replicated.
The sums then run in another order, so the result agrees with the
single-device solve to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import se3
from .sharding import all_reduce

__all__ = ["PoseGraphEdges", "optimize_pose_graph", "relative_pose_residual",
           "edges_from_numpy", "shard_edges"]


class PoseGraphEdges(NamedTuple):
    """Relative-pose constraints i → j."""

    i: torch.Tensor       # [C] int64 source pose index
    j: torch.Tensor       # [C] int64 target pose index
    T_meas: torch.Tensor  # [C, 4, 4] measured T_i_j (j expressed in i)
    weight: torch.Tensor  # [C] or [C, 6] per-residual-component weights


def _retract(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """poses [K, 4, 4] ∘ exp(delta [K, 6]) with decoupled rot/trans."""
    R = poses[:, :3, :3] @ se3.rodrigues(delta[:, :3])
    t = poses[:, :3, 3] + (poses[:, :3, :3] @ delta[:, 3:6, None])[..., 0]
    return se3.from_rt(R, t)


def _residual(T_err: torch.Tensor) -> torch.Tensor:
    """[C, 4, 4] → [log(R_err), t_err] [C, 6]."""
    return torch.cat([se3.log_rotation(T_err[:, :3, :3]), T_err[:, :3, 3]],
                     dim=-1)


def relative_pose_residual(poses: torch.Tensor,
                           edges: PoseGraphEdges) -> torch.Tensor:
    """r_c = [log(R_err), t_err] ∈ R⁶ for every constraint → [C, 6].

    T_err = T_meas⁻¹ · T_i⁻¹ · T_j; zero iff the poses satisfy the
    measurement."""
    return _residual(se3.inverse(edges.T_meas)
                     @ (se3.inverse(poses[edges.i]) @ poses[edges.j]))


def _jacobian_blocks(poses, edges: PoseGraphEdges, gauge):
    """The residual at δ = 0 and its Jacobian's two nonzero 6x6 blocks per
    constraint, ∂r_c/∂δ_i and ∂r_c/∂δ_j (gauge applied) → r0 [C, 6],
    Ji, Jj [C, 6, 6]. Constraint c's residual depends only on its own
    twists, so the gradient of Σ_c r_c[k] gives row k of every block at
    once: six reverse-mode products for all constraints."""
    Pi, Pj = poses[edges.i], poses[edges.j]
    T_meas_inv = se3.inverse(edges.T_meas)
    # d [C, 12]: the twists of pose i, then of pose j
    d = torch.zeros(Pi.shape[0], 12, dtype=poses.dtype, device=poses.device,
                    requires_grad=True)
    with torch.enable_grad():
        r = _residual(T_meas_inv @ (se3.inverse(_retract(Pi, d[:, :6]))
                                    @ _retract(Pj, d[:, 6:])))
        rows = [torch.autograd.grad(r[:, k].sum(), d, retain_graph=k < 5)[0]
                for k in range(6)]
    J = torch.stack(rows, dim=1)                           # [C, 6, 12]
    Ji = J[..., :6] * gauge[edges.i][:, None, :]
    Jj = J[..., 6:] * gauge[edges.j][:, None, :]
    return r.detach(), Ji, Jj


def _gn_step(poses, edges, w, gauge, cg_iters: int, damping: float, total):
    """One Gauss-Newton step: CG on (JᵀWJ + λI)·x = −JᵀW·r at δ = 0.
    ``total`` sums a ``[K, 6]`` product over the ranks' edges."""
    r0, Ji, Jj = _jacobian_blocks(poses, edges, gauge)

    def jtw(vec_c):       # Jᵀ(W·vec): [C, 6] → [K, 6]
        u = (w * vec_c)[..., None]
        out = torch.zeros_like(gauge)
        out.index_add_(0, edges.i, (Ji.mT @ u)[..., 0])
        return total(out.index_add_(0, edges.j, (Jj.mT @ u)[..., 0]))

    def jv(delta):        # J·delta: [K, 6] → [C, 6]
        return (Ji @ delta[edges.i, :, None]
                + Jj @ delta[edges.j, :, None])[..., 0]

    def A(x):             # (JᵀWJ + λI)·x
        return jtw(jv(x)) + damping * x

    b = -jtw(r0)
    x, r, p = torch.zeros_like(b), b, b
    rs = torch.sum(b * b)
    for _ in range(cg_iters):
        Ap = A(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs = rs_new
    return _retract(poses, x * gauge)


def optimize_pose_graph(poses, edges: PoseGraphEdges, gn_iters: int = 10,
                        cg_iters: int = 25, damping: float = 1e-6, mesh=None):
    """→ (optimized poses [K, 4, 4], final weighted residual norm), both
    tensors on the edges' device. ``poses`` [K, 4, 4] (numpy or a tensor).
    With ``mesh`` (:func:`.sharding.make_mesh`), ``edges`` is this rank's
    share of the constraints (:func:`shard_edges`), ``poses`` the same on
    every rank, and every rank returns the same result."""
    if mesh is None:
        total = lambda x: x
    else:
        mesh.require()
        total = lambda x: all_reduce(mesh, x, "sum")
    dev = edges.T_meas.device
    poses = torch.as_tensor(np.asarray(poses, np.float32)
                            if not isinstance(poses, torch.Tensor) else poses,
                            dtype=torch.float32, device=dev)
    w = edges.weight
    if w.ndim == 1:
        w = w[:, None]
    gauge = torch.ones((poses.shape[0], 6), dtype=torch.float32, device=dev)
    gauge[0] = 0.0                                     # fix pose 0
    for _ in range(gn_iters):
        poses = _gn_step(poses, edges, w, gauge, cg_iters, damping, total)
    final_res = relative_pose_residual(poses, edges)
    return poses, torch.sqrt(total(torch.sum((w * final_res) ** 2)))


def shard_edges(edges: PoseGraphEdges, mesh) -> PoseGraphEdges:
    """This rank's contiguous share of the constraints (the shares of the
    ranks differ by at most one edge), on the mesh's device."""
    mesh.require()
    c = edges.T_meas.shape[0]
    lo, hi = c * mesh.index // mesh.size, c * (mesh.index + 1) // mesh.size
    return PoseGraphEdges(*(x[lo:hi].to(mesh.device) for x in edges))


def edges_from_numpy(i, j, T_meas, weight=None, device=None) -> PoseGraphEdges:
    """Constraints from host arrays, on ``device`` (the card unless
    ``device="cpu"``); ``weight`` [C] or [C, 6], all ones by default."""
    dev = resolve_device(device)
    T_meas = torch.as_tensor(np.asarray(T_meas, np.float32), device=dev)
    if weight is None:
        weight = torch.ones((T_meas.shape[0],), dtype=torch.float32, device=dev)
    else:
        weight = torch.as_tensor(np.asarray(weight, np.float32), device=dev)
    return PoseGraphEdges(
        torch.as_tensor(np.asarray(i, np.int64), device=dev),
        torch.as_tensor(np.asarray(j, np.int64), device=dev), T_meas, weight)
