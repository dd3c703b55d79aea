"""Linearised point-to-plane least squares (upstream
ErrorMinimizers/PointToPlane.cpp): rows [p × n, n] and residuals
(p − q)·n, the 6x6 normal equations weighted by the outlier weights, a
minimal-norm solve that drops eigenvalues under 6·1e-7 of the largest, and
the step exp of the rotation vector with the translation."""

import torch


def _rodrigues(w):
    th = torch.linalg.norm(w)
    K = torch.zeros(3, 3, dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 0] = -w[2], w[1], w[2]
    K[1, 2], K[2, 0], K[2, 1] = -w[0], -w[1], w[0]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + K
    return (eye + torch.sin(th) / th * K
            + (1 - torch.cos(th)) / (th * th) * (K @ K))


def step(p, q, n, w, params, ctx):
    if params.get("force2D") or params.get("force4DOF"):
        raise ValueError("the plain PointToPlane serves the 6-DoF form")
    F = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=1)
    dot = ((p - q) * n).sum(1)
    wF = w[:, None] * F
    A = ctx.mm(wF.T, F)
    b = -ctx.mm(wF.T, dot[:, None])[:, 0]
    ev, V = torch.linalg.eigh(0.5 * (A + A.T))
    keep = ev > ev.abs().max() * 6 * 1e-7
    inv = torch.where(keep, 1.0 / torch.where(keep, ev, torch.ones_like(ev)),
                      torch.zeros_like(ev))
    x = V @ (inv * (V.T @ b))
    T = torch.eye(4, dtype=p.dtype, device=p.device)
    T[:3, :3] = _rodrigues(x[:3])
    T[:3, 3] = x[3:]
    return T
