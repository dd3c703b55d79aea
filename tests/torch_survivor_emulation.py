"""K2's and K6's card schedules in plain torch on the CPU, for the tests.

:func:`emulate_k2` is ``csrc/sweep.cu::survivors_bounds``: the warp box, the
nearest chunk and the ring order, the warp prefilter of both passes and the
exact square-root skip; it also counts the (warp, chunk) pairs each pass
evaluates. :func:`emulate_k6` is ``survivor_sweep_k`` + ``survivor_merge_k``:
the 256-query lists cut into segments, groups of 8 rows inserted under the
k-th distance, the merge in segment order. tests/test_torch_survivor_k2k6.py
holds both to the plain versions bit for bit; tests/test_torch_cuda.py holds
the kernels to them on the card; tools_torch/sweep_micro.py and
chip_smoke.py take the pair counts of K2's prefilter from
:func:`emulate_k2`. :func:`margin_rows` places queries on the prefilter's
boundary.

:func:`emulate_k2` and :func:`margin_rows` run on the device of their
inputs. On a CUDA device torch's square root is correctly rounded, as the
kernel's ``__fsqrt_rn`` is, so there the emulation equals the kernel bit
for bit. torch's vectorised square root on the CPU is not always (its
AVX-512 build misses the correctly rounded value by an ulp on about 0.7%
of uniform inputs), so on the CPU the emulation is held to the plain
version on the CPU, which shares that square root.
"""

import numpy as np
import torch

UP = float(np.float32(1.0 + 4e-7))
DOWN = float(np.float32(1.0 - 4e-7))
FAR = 1.0e15
WARP = 32
START_BEFORE = 16       # csrc/sweep.cu kStartBefore
SEGMENTS = 8            # csrc/sweep.cu kSegments
GROUP = 8               # csrc/sweep.cu kGroup
TILE = 256              # K2's tile and the sweeps' block


def _gap(a, b, c, d):
    """fmaxf(fmaxf(a - b, c - d), 0), as K2 rounds it (finite inputs)."""
    return torch.clamp(torch.maximum(a - b, c - d), min=0.0)


def emulate_k2(qp, ct, k: int = 1, nch=None, slack: float = 0.0):
    """K2's schedule (csrc/sweep.cu::survivors_bounds) on the CPU →
    ``(ub, surv, counts)``: per warp of 32 queries its box, the chunk whose
    centre lies nearest the box's centre and the ring order from
    ``START_BEFORE`` chunks before it, 32 chunks a batch; pass 1 evaluates a
    (warp, chunk) pair only if the box's bound is under the warp's largest U
    at the batch's start, and skips the square root where dc2 > U²; pass 2
    evaluates a pair only if the box's lhs is not above the warp's largest
    U²·UP, each group of its rows (penalty 0 and the others) on its own.
    ``slack`` > 0 makes both tests skip that much too early (a wrong
    prefilter, for the tests). ``counts``: the (warp, chunk) pairs in all,
    those that pass 1 evaluates, those that pass pass 2's test, and those
    that pass 2 evaluates (its test passed and the chunk not yet flagged by
    an earlier warp of the tile, whose flags the kernel ORs in warp
    order)."""
    n_pad, nch_pad = qp.shape[0], ct.shape[1]
    nch = nch_pad if nch is None else int(nch)
    w = n_pad // WARP
    dev = qp.device
    surv = torch.zeros((n_pad // TILE, nch_pad), dtype=torch.int32, device=dev)
    counts = {"pairs": w * nch, "pass1": 0, "pass2_box": 0, "pass2": 0}
    if nch == 0:
        return qp[:, 4].clone(), surv, counts
    q = qp.reshape(w, WARP, 8)
    qc = [q[..., a] for a in range(3)]                    # [w, 32] each
    pen = q[..., 3]
    u = q[..., 4].clone()
    lo, hi = ct[0:3, :nch], ct[3:6, :nch]
    ctr = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    rad = torch.sqrt(half[0] * half[0] + half[1] * half[1] + half[2] * half[2])
    add = (torch.where(ct[6, :nch] < float(k), FAR, 0.0) if k > 1
           else torch.zeros(nch, device=dev))
    blo = [x.amin(dim=1) for x in qc]                     # [w] each
    bhi = [x.amax(dim=1) for x in qc]

    # the nearest chunk (centres doubled) and the ring order
    d = None
    for a in range(3):
        dx = (lo[a] + hi[a])[None, :] - (blo[a] + bhi[a])[:, None]
        d = dx * dx if d is None else d + dx * dx
    near = torch.argmin(d, dim=1)                         # first minimum
    start = torch.clamp(near - START_BEFORE, min=0, max=max(nch - WARP, 0))
    order = (start[:, None] + torch.arange(nch, device=dev)[None, :]) % nch

    def cand(d2, c):
        return (torch.sqrt(d2) + rad[c]) * UP + add[c]

    for j0 in range(0, nch, WARP):
        umax = torch.where(torch.isnan(u), float("inf"), u).amax(dim=1)
        cs = order[:, j0:j0 + WARP]                       # [w, lanes]
        e = [_gap(blo[a][:, None], ctr[a][cs], ctr[a][cs], bhi[a][:, None])
             for a in range(3)]
        low = cand(e[0] * e[0] + e[1] * e[1] + e[2] * e[2], cs)
        passed = ~(low * (1.0 + slack) >= umax[:, None])
        counts["pass1"] += int(passed.sum())
        for lane in range(cs.shape[1]):
            sel = passed[:, lane]
            if not bool(sel.any()):
                continue
            c = cs[:, lane][:, None]
            dx = [qc[a] - ctr[a][c] for a in range(3)]
            dc2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            # the sign of dc2 - u² (exact in float64), as the kernel's FMA
            skip = (dc2.double() - u.double() * u.double()) > 0
            upd = sel[:, None] & ~skip
            u = torch.where(upd, torch.minimum(u, cand(dc2, c)), u)
    ub = u.reshape(-1)

    ub2 = (u * u) * UP
    v0 = pen == 0
    inf = float("inf")
    vlo = [torch.where(v0, x, inf).amin(dim=1) for x in qc]
    vhi = [torch.where(v0, x, -inf).amax(dim=1) for x in qc]
    ub2max = torch.where(v0, ub2, -inf).amax(dim=1)        # pen-0 rows
    pen_other = torch.where(v0, inf, pen).amin(dim=1)      # the others
    ub2max_other = torch.where(v0, -inf, ub2).amax(dim=1)
    flags = torch.zeros((w, nch), dtype=torch.bool, device=dev)
    tested = torch.zeros((w, nch), dtype=torch.bool, device=dev)
    for c0 in range(0, nch, WARP):
        cs = torch.arange(c0, min(c0 + WARP, nch), device=dev)
        g = [_gap(lo[a][cs][None, :], vhi[a][:, None], vlo[a][:, None],
                  hi[a][cs][None, :]) for a in range(3)]
        low = (g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) * DOWN
        passed = (~(low * (1.0 + slack) > ub2max[:, None])
                  | ~(pen_other * (1.0 + slack) > ub2max_other)[:, None])
        tested[:, c0:c0 + WARP] = passed
        for lane, c in enumerate(cs.tolist()):
            sel = passed[:, lane]
            if not bool(sel.any()):
                continue
            gq = [_gap(lo[a][c], qc[a], qc[a], hi[a][c]) for a in range(3)]
            gap2 = gq[0] * gq[0] + gq[1] * gq[1] + gq[2] * gq[2]
            ok = (gap2 * DOWN + pen) <= ub2
            flags[:, c] = sel & ok.any(dim=1)
    counts["pass2_box"] = int(tested.sum())
    f = flags.reshape(-1, TILE // WARP, nch).to(torch.int32)
    earlier = (torch.cumsum(f, dim=1) - f) > 0
    counts["pass2"] = int((tested.reshape(f.shape) & ~earlier).sum())
    surv[:, :nch] = flags.reshape(-1, TILE // WARP, nch).any(dim=1).to(torch.int32)
    return ub, surv, counts


def _insert_rows(ld, li, d, i):
    """Entries ``(d, i)`` [n, G] (ids above the list's, in order) into the
    sorted lists ``(ld, li)`` [n, k], each under the k-th distance and after
    any equal entry (the kernel's strict '<'): the stable merge, cut to k."""
    k = ld.shape[1]
    sd, order = torch.sort(torch.cat([ld, d], 1), dim=1, stable=True)
    return sd[:, :k], torch.gather(torch.cat([li, i], 1), 1, order)[:, :k]


def _merge_segment(ld, li, d, i):
    """A later segment's sorted list ``(d, i)`` [n, k] into ``(ld, li)`` as
    survivor_merge_k does: entry by entry, each only under the k-th
    distance (strict '<', after any equal entry), the first that is not
    ending that query's segment."""
    alive = torch.ones(ld.shape[0], dtype=torch.bool)
    for s in range(d.shape[1]):
        go = alive & (d[:, s] < ld[:, -1])
        nd, ni = _insert_rows(ld, li, d[:, s:s + 1], i[:, s:s + 1])
        ld = torch.where(go[:, None], nd, ld)
        li = torch.where(go[:, None], ni, li)
        alive = go
    return ld, li


def emulate_k6(qp, rt3, surv, k: int):
    """K6's schedule (csrc/sweep.cu::survivor_sweep_k + survivor_merge_k)
    on the CPU → ``(d2 [n_pad, k], ids [n_pad, k], groups)``: per 256
    queries the ordered list of its row of ``surv`` (K2's own rows), cut
    into ``SEGMENTS`` segments of ceil(len / SEGMENTS) chunks; per segment a k-slot list per query, each group of 8 rows (x + pen)
    entering only under the k-th distance; the segments' lists merged in
    segment order. ``groups``: (query, group) units that took the
    insertion branch, and all units swept."""
    n_pad, nch = qp.shape[0], rt3.shape[0]
    inf = float("inf")
    out_d = torch.empty((n_pad, k), dtype=torch.float32)
    out_i = torch.empty((n_pad, k), dtype=torch.int32)
    groups = {"inserted": 0, "swept": 0}
    rx = rt3[:, 0, :] + rt3[:, 3, :]                      # x + pen
    for b in range(n_pad // TILE):
        sl = slice(b * TILE, (b + 1) * TILE)
        q = qp[sl, :3]
        lst = torch.nonzero(surv[b, :nch]).flatten().tolist()
        per = -(-len(lst) // SEGMENTS)
        lists = []
        for s in range(SEGMENTS):
            ld = torch.full((TILE, k), inf)
            li = torch.full((TILE, k), -1, dtype=torch.int32)
            for ch in lst[s * per:(s + 1) * per]:
                for g0 in range(0, 128, GROUP):
                    rows = slice(g0, g0 + GROUP)
                    dx = q[:, 0, None] - rx[ch, rows][None, :]
                    dy = q[:, 1, None] - rt3[ch, 1, rows][None, :]
                    dz = q[:, 2, None] - rt3[ch, 2, rows][None, :]
                    d = (dx * dx + dy * dy) + dz * dz     # [256, 8]
                    go = d.amin(dim=1) < ld[:, -1]
                    groups["swept"] += TILE
                    if not bool(go.any()):
                        continue
                    groups["inserted"] += int(go.sum())
                    ids = (ch * 128 + g0 + torch.arange(GROUP, dtype=torch.int32))
                    nd, ni = _insert_rows(ld, li, d, ids.expand(TILE, -1))
                    ld = torch.where(go[:, None], nd, ld)
                    li = torch.where(go[:, None], ni, li)
            lists.append((ld, li))
        ld, li = lists[0]
        for d, i in lists[1:]:
            ld, li = _merge_segment(ld, li, d, i)
        out_d[sl] = ld
        out_i[sl] = li
    return out_d, out_i, groups


def margin_rows(qp, ct, nch, rng):
    """The query table ``qp`` with two tiles placed on K2's prefilter
    boundary, for the tests → ``(qp, c1, c2)``. Rows 0..255 all at one
    map-side point, col 4 one ulp above the smallest bound candidate over
    the chunks (chunk ``c1`` lowers it by that ulp); rows 256..511 all at a
    point outside the map, col 4 the float u whose U²·UP equals exactly the
    flag test's lhs of the chunk ``c2`` nearest it (so ``c2`` survives for
    tile 1 at equality). Works on either device."""
    dev = qp.device
    up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
    down = lambda x: torch.nextafter(x, torch.full_like(x, -float("inf")))
    qp = qp.clone()
    lo, hi = ct[0:3, :nch], ct[3:6, :nch]
    ctr = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    rad = torch.sqrt(half[0] * half[0] + half[1] * half[1] + half[2] * half[2])
    p = qp[300, :3].clone()
    dx = [p[a] - ctr[a] for a in range(3)]
    cand = (torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]) + rad) * UP
    c1 = int(torch.argmin(cand))
    qp[:256, :3] = p
    qp[:256, 3] = 0.0
    qp[:256, 4] = up(cand[c1])
    for _ in range(50):
        p2 = torch.tensor(rng.uniform(12, 20, 3), dtype=torch.float32, device=dev)
        g = [torch.clamp(torch.maximum(lo[a] - p2[a], p2[a] - hi[a]), min=0.0)
             for a in range(3)]
        lhs = (g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) * DOWN
        c2 = int(torch.argmin(lhs))
        u = torch.sqrt(lhs[c2] / UP)
        for _ in range(64):              # walk u to where U²·UP meets lhs
            ub2 = (u * u) * UP
            if bool(ub2 == lhs[c2]):
                qp[256:512, :3] = p2
                qp[256:512, 3] = 0.0
                qp[256:512, 4] = u
                return qp, c1, c2
            u = up(u) if bool(ub2 < lhs[c2]) else down(u)
    raise AssertionError("no float bound meets the lhs exactly")
