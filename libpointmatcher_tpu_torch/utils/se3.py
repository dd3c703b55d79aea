"""SE(2)/SE(3) helpers on (d+1)x(d+1) homogeneous float32 matrices
(the counterpart of ``libpointmatcher_tpu.utils.se3``). Every helper takes
leading batch dimensions as well: ``T [..., d+1, d+1]``."""

from __future__ import annotations

import torch

__all__ = ["identity", "inverse", "from_rt", "apply", "rodrigues",
           "log_rotation", "rot2d", "rotation_angle_between", "orthogonalize"]


def identity(dim: int, device=None) -> torch.Tensor:
    return torch.eye(dim + 1, dtype=torch.float32, device=device)


def _eye_like(R: torch.Tensor, d: int) -> torch.Tensor:
    """Identity of size d+1 with the batch dimensions of R [..., d, d]."""
    eye = torch.eye(d + 1, dtype=R.dtype, device=R.device)
    return eye.expand(*R.shape[:-2], d + 1, d + 1).clone()


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(n) inverse: [R t]⁻¹ = [Rᵀ -Rᵀt]."""
    d = T.shape[-1] - 1
    Rt = T[..., :d, :d].mT
    out = _eye_like(Rt, d)
    out[..., :d, :d] = Rt
    out[..., :d, d] = -(Rt @ T[..., :d, d, None])[..., 0]
    return out


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = R.shape[-1]
    T = _eye_like(R, d)
    T[..., :d, :d] = R
    T[..., :d, d] = t
    return T


def apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous T [..., d+1, d+1] to [..., N, d] points."""
    d = points.shape[-1]
    return points @ T[..., :d, :d].mT + T[..., None, :d, d]


def rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector [..., 3] → rotation matrix [..., 3, 3], with the
    same series form near zero as the JAX package (no branch on the host)."""
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta < 1e-6
    one = torch.ones_like(theta)
    safe_t = torch.where(small, one, theta)
    safe_t2 = torch.where(small, one, theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(wx)
    K = torch.stack([torch.stack([z, -wz, wy], dim=-1),
                     torch.stack([wz, z, -wx], dim=-1),
                     torch.stack([-wy, wx, z], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * K + b * (K @ K)


def log_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → axis-angle vector [..., 3], the inverse
    of :func:`rodrigues` for angles in [0, π). The JAX package's formula,
    guards included: the series near θ = 0 and the +1e-30 under the square
    root keep it differentiable at the identity, where the pose graph's
    Gauss-Newton linearizes."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    # ‖w‖ = 2 sin θ
    s = 0.5 * torch.sqrt(torch.sum(w * w, dim=-1) + 1e-30)
    tr = (R[..., 0, 0] + R[..., 1, 1]) + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(s, c)
    small = s < 1e-5
    safe_s = torch.where(small, torch.ones_like(s), s)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * safe_s))
    return scale[..., None] * w


def rot2d(angle: torch.Tensor) -> torch.Tensor:
    """Angle [...] → rotation matrix [..., 2, 2]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a0·b0 + a1·b1 + a2·b2 accumulated with fused multiply-adds,
    in that order: each float32 product is exact in float64, so one float64
    add per step rounded back to float32 is the fused result."""
    acc = (a[..., 0] * b[..., 0]).to(torch.float32)
    for k in (1, 2):
        acc = (acc.to(torch.float64) + a[..., k].to(torch.float64)
               * b[..., k].to(torch.float64)).to(torch.float32)
    return acc


def rotation_angle_between(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations, batched over leading dims.
    3D: acos((tr(Ra·Rbᵀ) − 1)/2); 2D: |atan2| of the relative rotation.

    Near the identity acos of a float32 trace moves in steps of about
    5e-4·√k rad, so one ulp of the trace can flip the Differential
    checker's 1e-3 threshold. The diagonal is therefore formed as the JAX
    engine's 3x3 product forms it, with fused multiply-adds in index order,
    and the two engines stop on the same iteration."""
    d = Ra.shape[-1]
    if d == 2:
        Rrel = Ra @ Rb.transpose(-1, -2)
        return torch.abs(torch.atan2(Rrel[..., 1, 0], Rrel[..., 0, 0]))
    diag = [_fma_dot3(Ra[..., i, :], Rb[..., i, :]) for i in range(3)]
    tr = (diag[0] + diag[1]) + diag[2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def orthogonalize(T: torch.Tensor) -> torch.Tensor:
    """Project each rotation block onto SO(d) through its SVD (the polar
    decomposition): the recovery of a drifted rotation
    (reference: TransformationsImpl.cpp:109-151)."""
    d = T.shape[-1] - 1
    U, _, Vh = torch.linalg.svd(T[..., :d, :d])
    D = torch.ones(T.shape[:-2] + (d,), dtype=T.dtype, device=T.device)
    D[..., -1] = torch.linalg.det(U @ Vh)
    out = T.clone()
    out[..., :d, :d] = (U * D[..., None, :]) @ Vh
    return out
