"""The benchmark's scene makers and pose gates, frozen.

Copied from ``chip_smoke.py`` (``make_scene``, ``make_poses``, ``make_scan``,
``perturb`` and the gates ``ROT_TOL`` / ``TRANS_TOL``) so that a later change
to the smoke run cannot move the yardstick. The sizes that ``chip_smoke.py`` held in module
constants are parameters here, read from a configuration's ``scene`` block.
Everything runs on the host in numpy from one ``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

#: ground-truth pose gates of a registration (rad, m), inside the 0.1 of the
#: reference's own validation
ROT_TOL = 0.02
TRANS_TOL = 0.05


# ------------------------------------------------------------ apartment
def _plane(rng, origin, u, v, nu, nv, density):
    n = max(int(nu * nv * density), 1)
    a = rng.uniform(0, nu, n)
    b = rng.uniform(0, nv, n)
    return (np.asarray(origin, float) + a[:, None] * np.asarray(u, float)
            + b[:, None] * np.asarray(v, float))


def _box(rng, center, size, density):
    sx, sy, sz = size
    o = np.asarray(center, float) - np.asarray(size, float) / 2
    return np.concatenate([
        _plane(rng, o, [1, 0, 0], [0, 1, 0], sx, sy, density),
        _plane(rng, o + [0, 0, sz], [1, 0, 0], [0, 1, 0], sx, sy, density),
        _plane(rng, o, [1, 0, 0], [0, 0, 1], sx, sz, density),
        _plane(rng, o + [0, sy, 0], [1, 0, 0], [0, 0, 1], sx, sz, density),
        _plane(rng, o, [0, 1, 0], [0, 0, 1], sy, sz, density),
        _plane(rng, o + [sx, 0, 0], [0, 1, 0], [0, 0, 1], sy, sz, density),
    ])


def make_scene(rng, target):
    """An apartment-like room (floor, ceiling, walls, a split inner wall,
    furniture boxes) resampled to ``target`` points."""
    W, L, H, d = 14.0, 10.0, 2.8, 300.0
    parts = [_plane(rng, [0, 0, 0], [1, 0, 0], [0, 1, 0], W, L, d),
             _plane(rng, [0, 0, H], [1, 0, 0], [0, 1, 0], W, L, d / 2)]
    for o, u, nu in (([0, 0, 0], [1, 0, 0], W), ([0, L, 0], [1, 0, 0], W),
                     ([0, 0, 0], [0, 1, 0], L), ([W, 0, 0], [0, 1, 0], L)):
        parts.append(_plane(rng, o, u, [0, 0, 1], nu, H, d))
    parts.append(_plane(rng, [W / 2, 0, 0], [0, 1, 0], [0, 0, 1], L * 0.4, H, d))
    parts.append(_plane(rng, [W / 2, L * 0.6, 0], [0, 1, 0], [0, 0, 1],
                        L * 0.4, H, d))
    for _ in range(10):
        c = [rng.uniform(1, W - 1), rng.uniform(1, L - 1), rng.uniform(0.3, 0.9)]
        parts.append(_box(rng, c, rng.uniform(0.4, 1.6, 3), d))
    world = np.concatenate(parts)
    return world[rng.choice(len(world), target, replace=False)]


def _yaw(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1.0]])


def make_poses(world, n, rng):
    """Sensor→world poses walking through the scene."""
    lo, hi = world.min(0), world.max(0)
    pos = (lo + hi) / 2
    pos[2] = lo[2] + 1.3
    ang = rng.uniform(0, 2 * np.pi)
    poses = []
    for _ in range(n):
        P = np.eye(4)
        P[:3, :3] = _yaw(ang)
        P[:3, 3] = pos
        poses.append(P)
        ang += rng.uniform(-0.25, 0.25)
        pos = pos + _yaw(ang)[:, 0] * rng.uniform(0.15, 0.45)
        pos[:2] = np.clip(pos[:2], lo[:2] + 1, hi[:2] - 1)
    return poses


def make_scan(world, P, rng, target):
    """Range-limited, range-noised scan in the sensor frame."""
    Pinv = np.linalg.inv(P)
    local = world @ Pinv[:3, :3].T + Pinv[:3, 3]
    r = np.linalg.norm(local, axis=1)
    keep = (r > 0.7) & (r < 15.0)
    local, r = local[keep], r[keep]
    sel = rng.choice(len(local), min(target, len(local)), replace=False)
    local, r = local[sel], r[sel]
    noise = (rng.standard_normal(len(local)) * (0.005 + 0.002 * r))[:, None]
    local = local + local / r[:, None] * noise + 0.002 * rng.standard_normal(local.shape)
    return local.astype(np.float32)


def perturb(rng, trans_sigma=0.08, rot_sigma=0.03):
    dT = np.eye(4)
    w = rng.standard_normal(3) * rot_sigma
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    dT[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    dT[:3, 3] = rng.standard_normal(3) * trans_sigma
    return dT


# ---------------------------------------------------------------- gates
def pose_errors(T, T_true):
    """(rotation angle rad, translation m) between two 4x4 poses."""
    T = np.asarray(T, np.float64)
    T_true = np.asarray(T_true, np.float64)
    R = T[:3, :3] @ T_true[:3, :3].T
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.arccos(cos)), float(np.linalg.norm(T[:3, 3] - T_true[:3, 3]))


def within_gates(T, T_true) -> bool:
    rot, trans = pose_errors(T, T_true)
    return rot < ROT_TOL and trans < TRANS_TOL
