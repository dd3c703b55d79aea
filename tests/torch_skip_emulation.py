"""K10's and K11's card schedules in plain torch, for the tests and the tools.

:func:`emulate_k10` is ``csrc/skip.cu::approx_chunks`` + ``approx_min``: the
chunk table, the chunk nearest each warp's query box and the outward
visiting order, the warp's box test a batch of 32 chunks at a time, each
lane's exact lower-bound test against its running best, the warp ballot,
the sweep for all lanes or for the few that need a chunk, the hoisted
terms; it counts the tests, the (query, column) pairs that the lanes
needing a chunk take, and those whose t it forms. :func:`emulate_k11` is
``nn1_skip_sweep`` + ``nn1_skip_merge``: each tile's list of unskipped
super-chunks as 128-row chunks, cut into segments, each segment's partial
(d², id), the merge in segment order; it counts the swept pairs.
tests/test_torch_skip_schedule.py holds both to the plain versions bit for
bit; tests/test_torch_cuda.py holds the kernels to them on the card;
tools_torch/skip_micro.py and chip_smoke.py take K10's work counts from
:func:`emulate_k10`. :func:`k10_test` is the per-lane test alone, for the
lemma test.

Both run on the device of their inputs, with the kernel's rounded fp32
operations in its order (torch's elementwise float32 operations round to
nearest and are not contracted). A square root is taken in float64 and
rounded to float32, which gives the correctly rounded float32 root that the
kernel's ``__fsqrt_rn`` gives (53 >= 2·24 + 2 bits); torch's own float32
root on the CPU is not always correctly rounded (see
tests/torch_survivor_emulation.py).
"""

import numpy as np
import torch

WARP = 32
CHUNK = 128             # csrc/skip.cu kChunk
TILE = 256              # csrc/skip.cu kTileQ
GROUP = 4               # csrc/skip.cu kGroup
SEGMENTS = 8            # csrc/skip.cu kSegments
FEW = 16                # csrc/skip.cu kFew
UP = float(np.float32(1.0 + 2.0 ** -20))
DOWN = float(np.float32(1.0 - 2.0 ** -20))
ERR = 5.0 * 2.0 ** -21
SLACK = 2.0 ** -20
ABS = 2.0 ** -100
COORD_MAX = 2.0 ** 40
BIG_R = 2.0 ** 96
CAP = 2.0 ** 95
INF = float("inf")


def _sqrt(x):
    """The correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def _no_nan(x, fill):
    return torch.where(torch.isnan(x), fill, x)


def k10_table(ra):
    """K10's chunk table (``approx_chunks``) → dict of [nch] tensors: ``lo``,
    ``hi`` [nch, 3] the box of the valid columns, ``rho``, ``e2``, ``cap``."""
    m_pad = ra.shape[1]
    nch = -(-m_pad // CHUNK)
    cols = torch.nn.functional.pad(ra[:4], (0, nch * CHUNK - m_pad))
    present = (torch.arange(nch * CHUNK, device=ra.device) < m_pad).reshape(nch, CHUNK)
    x, y, z, r3 = (cols[k].reshape(nch, CHUNK) for k in range(4))
    v = present & (r3 >= 0) & (r3 < BIG_R)
    b = present & (r3 >= BIG_R)
    ok = (x.abs() < COORD_MAX) & (y.abs() < COORD_MAX) & (z.abs() < COORD_MAX)
    bad = (present & (~ok | ~(v | b))).any(dim=1)
    lo = torch.stack([torch.where(v & ~torch.isnan(c), c, INF).amin(dim=1)
                      for c in (x, y, z)], dim=1)
    hi = torch.stack([torch.where(v & ~torch.isnan(c), c, -INF).amax(dim=1)
                      for c in (x, y, z)], dim=1)
    p = torch.where(v, r3, -INF).amax(dim=1)
    rho = torch.where(p >= 0, _sqrt(p * UP) * UP, 0.0)
    e2 = torch.where(bad, INF, ERR * (rho * rho))
    cap = torch.where(b.any(dim=1), CAP, INF)
    return {"lo": lo, "hi": hi, "rho": rho, "e2": e2, "cap": cap, "nch": nch}


def _queries(qa):
    """Per query row of ``qa`` (padded to whole warps): a0..a2, a4, live,
    q, safe, Qu, qk."""
    flat = qa.reshape(-1, qa.shape[-1])
    nq = flat.shape[0]
    w = -(-nq // WARP)
    a = torch.nn.functional.pad(flat[:, :5], (0, 0, 0, w * WARP - nq))
    live = torch.arange(w * WARP, device=qa.device) < nq
    q = [a[:, k] * -0.5 for k in range(3)]
    safe = (q[0].abs() < COORD_MAX) & (q[1].abs() < COORD_MAX) & (q[2].abs() < COORD_MAX)
    qu = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) * UP
    qn = _sqrt(qu) * UP
    qk = ERR * (qn + qn)
    rs = lambda t: t.reshape(w, WARP)
    return {"a": [rs(a[:, k]) for k in range(3)], "a4": rs(a[:, 4]),
            "live": rs(live), "q": [rs(t) for t in q], "safe": rs(safe),
            "qu": rs(qu), "qk": rs(qk), "nq": nq, "w": w}


def best_limit(best, qu, safe):
    """H of csrc/skip.cu::best_limit."""
    h = (best + qu) + ((SLACK * (best.abs() + qu)) + ABS)
    return torch.where(safe, h, INF)


def k10_test(q, qk, lim_best, best, lo, hi, rho, e2, cap):
    """The per-lane skip test of ``approx_min`` (broadcasting): True where
    the lower bound on the chunk's t lies above the limit of the running
    best and the best lies at or under the chunk's cap."""
    g = [torch.fmax(torch.fmax(lo[k] - q[k], q[k] - hi[k]),
                    torch.zeros((), device=q[k].device)) for k in range(3)]
    low = ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) * DOWN
    lim = lim_best + ((qk * rho) + e2)
    return (low > lim) & (best <= cap)


def _box_gap(lo, blo, bhi, hi):
    """fmaxf(fmaxf(lo - Bhi, Blo - hi), 0), the box test's axis gap."""
    return torch.fmax(torch.fmax(lo - bhi, blo - hi), torch.zeros((), device=lo.device))


def emulate_k10(qa, ra):
    """K10's schedule (csrc/skip.cu) → ``(out [...], counts)`` with ``out``
    shaped as ``qa.shape[:-1]``. Per warp of 32 query rows: the box of its
    live queries and the chunk whose centre lies nearest the box's centre,
    the chunks in outward order, 32 a batch; a chunk passes the box test
    unless the box's bound lies above the warp's largest limit at the
    batch's start; for each chunk that passes, in order, each lane's own
    test against its running best, and a sweep if any lane needs the chunk:
    for each needing lane alone if at most ``FEW`` need it, else for all.
    ``counts``: ``box_tests`` ((warp, chunk) pairs), ``lane_tests`` ((query
    row, chunk) pairs tested by a lane), ``swept_chunks`` ((warp, chunk)
    pairs swept), ``few_sweeps`` (those swept lane by lane),
    ``swept_pairs`` ((query row, map column) pairs of the lanes that fail
    their own test: the work the result needs), ``formed_pairs`` (those
    whose t is formed: a sweep by all lanes also forms the other lanes'),
    ``dense_pairs`` (query rows × map columns), ``per_warp`` (the chunks
    each warp sweeps, a tensor)."""
    dev = qa.device
    m_pad = ra.shape[1]
    tab = k10_table(ra)
    nch = tab["nch"]
    Q = _queries(qa)
    w, nq = Q["w"], Q["nq"]
    live, q, a = Q["live"], Q["q"], Q["a"]
    best = torch.full((w, WARP), INF, device=dev)
    lim_best = torch.full((w, WARP), INF, device=dev)
    counts = {"box_tests": w * nch, "lane_tests": 0, "swept_chunks": 0,
              "few_sweeps": 0, "swept_pairs": 0, "formed_pairs": 0,
              "dense_pairs": nq * m_pad,
              "per_warp": torch.zeros(w, dtype=torch.int64, device=dev)}
    if nch == 0:
        return (best.reshape(-1)[:nq] + Q["a4"].reshape(-1)[:nq]).reshape(
            qa.shape[:-1]), counts

    # the box of each warp's live queries, the chunk nearest its centre
    # (centres doubled), the outward order
    blo = [torch.where(live & ~torch.isnan(c), c, INF).amin(dim=1) for c in q]
    bhi = [torch.where(live & ~torch.isnan(c), c, -INF).amax(dim=1) for c in q]
    qkmax = torch.where(live, Q["qk"], -INF).amax(dim=1)
    ctr = tab["lo"] + tab["hi"]                              # [nch, 3]
    dd = [ctr[None, :, k] - (blo[k] + bhi[k])[:, None] for k in range(3)]
    d = (dd[0] * dd[0] + dd[1] * dd[1]) + dd[2] * dd[2]
    near = torch.argmin(_no_nan(d, INF), dim=1)              # first minimum
    c_all = torch.arange(nch, device=dev)
    key = 2 * (c_all[None, :] - near[:, None]).abs() - (c_all[None, :] > near[:, None]).long()
    order = torch.argsort(key, dim=1)                        # c, c+1, c-1, ...

    rows = torch.nn.functional.pad(ra[:4], (0, nch * CHUNK - m_pad))
    rows[3, m_pad:] = INF                                    # t = +inf past the map
    present = torch.arange(nch * CHUNK, device=dev) < m_pad
    nlive = live.sum(dim=1)
    lo, hi = tab["lo"], tab["hi"]
    for j0 in range(0, nch, WARP):
        hmax = torch.where(live, lim_best, -INF).amax(dim=1)
        bmax = torch.where(live, best, -INF).amax(dim=1)
        cs = order[:, j0:j0 + WARP]                          # [w, lanes]
        g = [_box_gap(lo[cs, k], blo[k][:, None], bhi[k][:, None], hi[cs, k])
             for k in range(3)]
        low = ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) * DOWN
        lim = hmax[:, None] + ((qkmax[:, None] * tab["rho"][cs]) + tab["e2"][cs])
        passed = ~((low > lim) & (bmax[:, None] <= tab["cap"][cs]))
        for jj in range(cs.shape[1]):
            sel = torch.nonzero(passed[:, jj]).flatten()
            if sel.numel() == 0:
                continue
            c = cs[sel, jj]
            counts["lane_tests"] += int(nlive[sel].sum())
            skip = k10_test([x[sel] for x in q], Q["qk"][sel], lim_best[sel],
                            best[sel], [lo[c, k][:, None] for k in range(3)],
                            [hi[c, k][:, None] for k in range(3)],
                            tab["rho"][c][:, None], tab["e2"][c][:, None],
                            tab["cap"][c][:, None])
            needs = ~skip & live[sel]
            pop = needs.sum(dim=1)
            go = pop > 0
            idx, c, pop, needs = sel[go], c[go], pop[go], needs[go]
            if idx.numel() == 0:
                continue
            col = c[:, None] * CHUNK + torch.arange(CHUNK, device=dev)[None, :]
            r = [rows[k][col][:, None, :] for k in range(4)]     # [n, 1, 128]
            t = ((a[0][idx, :, None] * r[0] + a[1][idx, :, None] * r[1])
                 + a[2][idx, :, None] * r[2]) + r[3]
            tmin = _no_nan(t, INF).amin(dim=2)
            few = pop <= FEW
            # lane by lane only the needing lanes take the chunk's minimum
            take = torch.where(few[:, None], needs, True)
            best[idx] = torch.where(take, torch.fmin(best[idx], tmin), best[idx])
            lim_best[idx] = best_limit(best[idx], Q["qu"][idx], Q["safe"][idx])
            cnt = present[col].sum(dim=1)
            counts["swept_chunks"] += int(idx.numel())
            counts["few_sweeps"] += int(few.sum())
            counts["swept_pairs"] += int((pop * cnt).sum())
            counts["formed_pairs"] += int((torch.where(few, pop, nlive[idx]) * cnt).sum())
            counts["per_warp"][idx] += 1
    out = (best + Q["a4"]).reshape(-1)[:nq]
    return out.reshape(qa.shape[:-1]), counts


def k11_lists(skip, m_pad):
    """Per (scan, tile) the ordered 128-row chunks K11 sweeps: four per
    unskipped super-chunk, the last super-chunk's missing ones left out."""
    nch = m_pad // CHUNK
    out = []
    for row in skip.reshape(-1, skip.shape[-1]).cpu():
        sg = torch.nonzero(row == 0).flatten()
        ch = (sg[:, None] * GROUP + torch.arange(GROUP)[None, :]).flatten()
        out.append(ch[ch < nch])
    return out


def emulate_k11(qs, qm, rt, rpen, skip):
    """K11's schedule (csrc/skip.cu::nn1_skip_sweep + nn1_skip_merge) →
    ``(d2 [B, n], ids [B, n] int32, counts)``: per 256-query tile its chunk
    list cut into ``SEGMENTS`` segments of ceil(len / SEGMENTS) chunks, per
    segment the first minimum of d² = (dx² + dy²) + dz² with dx taken
    against x + pen, the partials merged in segment order with a strict
    '<', then the mask. ``counts``: ``swept_pairs`` (query rows × rows of
    the chunks swept), ``list_max`` and ``list_mean`` (chunks a tile)."""
    B, n, d = qs.shape
    dev = qs.device
    m_pad = rt.shape[1]
    ni = skip.shape[1]
    qp = torch.zeros((B, ni * TILE, 3), dtype=torch.float32, device=dev)
    qp[:, :n, :d] = qs
    rx = rt[0] + rpen[0]
    lists = k11_lists(skip, m_pad)
    out_d = torch.full((B, ni * TILE), INF, device=dev)
    out_i = torch.full((B, ni * TILE), -1, dtype=torch.int32, device=dev)
    swept = 0
    for t, ch in enumerate(lists):
        b, tile = divmod(t, ni)
        q = qp[b, tile * TILE:(tile + 1) * TILE]
        per = -(-len(ch) // SEGMENTS)
        best = torch.full((TILE,), INF, device=dev)
        besti = torch.full((TILE,), -1, dtype=torch.int32, device=dev)
        for s in range(SEGMENTS):
            seg = ch[s * per:(s + 1) * per].to(dev)
            if seg.numel() == 0:
                continue
            cols = (seg[:, None] * CHUNK + torch.arange(CHUNK, device=dev)[None, :]).flatten()
            dx = q[:, 0, None] - rx[cols][None, :]
            dy = q[:, 1, None] - rt[1][cols][None, :]
            dz = q[:, 2, None] - rt[2][cols][None, :]
            dd = (dx * dx + dy * dy) + dz * dz
            j = torch.argmin(dd, dim=1)                        # first minimum
            sd = torch.gather(dd, 1, j[:, None])[:, 0]
            si = torch.where(torch.isfinite(sd), cols[j].to(torch.int32), -1)
            take = sd < best
            best = torch.where(take, sd, best)
            besti = torch.where(take, si, besti)
            swept += TILE * cols.numel()
        out_d[b, tile * TILE:(tile + 1) * TILE] = best
        out_i[b, tile * TILE:(tile + 1) * TILE] = besti
    dist = torch.where(qm, out_d[:, :n], INF)
    ids = torch.where(qm & torch.isfinite(dist), out_i[:, :n], -1)
    lens = [len(c) for c in lists]
    return dist, ids, {"swept_pairs": swept, "list_max": max(lens, default=0),
                       "list_mean": float(np.mean(lens)) if lens else 0.0}
