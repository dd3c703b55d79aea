"""The v1 skip route's card schedules on the CPU: K10's exact pruned sweep
and K11's segmented sweep (tests/torch_skip_emulation.py) against their
plain versions (``ops/skip_cuda.py``), bit for bit, on seeded numpy inputs.

Cases: the ``tools/synth_eth.py`` apartment at its own coordinates and
translated by 10³ and 10⁴ m (where the expansion form cancels hardest);
duplicate map rows (ties); masked queries and a fully masked tile; maps
with invalid rows, a partial last chunk, and one valid row; queries on the
chunks' boxes; random skip flags. The lemma test holds K10's per-lane test
to every (query, chunk) pair it draws: the test never skips a chunk whose
smallest t lies at or under the running best, and every invalid column's t
lies above the chunk's cap. No tolerance: the emulations and the plain
versions round the same fp32 operations, and pruning is exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_skip_emulation as em
from libpointmatcher_tpu_torch.ops import skip, skip_cuda, sweep
from libpointmatcher_tpu_torch.ops.morton import morton_argsort

_spec = importlib.util.spec_from_file_location(
    "synth_eth", Path(__file__).resolve().parent.parent / "tools" / "synth_eth.py")
synth_eth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(synth_eth)

OFFSETS = [0.0, 1e3, 1e4]


def _world(seed):
    return synth_eth.make_world("apartment", np.random.default_rng(seed))


def _case(seed, offset=0.0, n_map=5000, n_q=1500, scans=2, dup=False,
          invalid=13, m_extra=0):
    """A Morton-sorted map of the apartment (every ``invalid``-th row
    masked; with ``dup`` every third row a copy of the one before) and
    ``scans`` Morton-sorted scans of noisy surface points (every 9th
    masked), all translated by ``offset`` → dict of tensors and tables."""
    rng = np.random.default_rng(seed)
    world = _world(seed)
    r = world[rng.choice(len(world), n_map, replace=False)]
    if dup:
        r[1::3] = r[0::3][: len(r[1::3])]
    r = (r + offset).astype(np.float32)
    rm = np.ones(n_map, bool)
    rm[::invalid] = False
    o, _ = morton_argsort(r, rm)
    rs, rsm = r[o], rm[o]
    qs, qms = [], []
    for _ in range(scans):
        q = world[rng.choice(len(world), n_q, replace=False)]
        q = (q + rng.normal(0, 0.02, q.shape) + offset).astype(np.float32)
        qm = np.ones(n_q, bool)
        qm[::9] = False
        oq, _ = morton_argsort(q, qm)
        qs.append(q[oq])
        qms.append(qm[oq])
    return _tables(rs, rsm, np.stack(qs), np.stack(qms), m_extra)


def _tables(rs, rsm, qs, qm, m_extra=0):
    m_pad = 128 * -(-len(rs) // 128) + m_extra
    rt, rpen = skip.v1_tables(rs, rsm, m_pad)
    ra, _ = skip.augmented_ref_table(rs, rsm, m_pad)
    t = torch.as_tensor
    return {"rs": rs, "rsm": rsm, "qs": t(qs), "qm": t(qm), "rt": t(rt),
            "rpen": t(rpen), "ra": t(ra),
            "cbox": t(skip.chunk_bboxes(rs, rsm, skip_cuda.SUPER))}


def _k10(c):
    n = c["qs"].shape[1]
    qa, q2 = skip.augment_queries(c["qs"], -(-n // skip_cuda.TILE_Q) * skip_cuda.TILE_Q)
    got, counts = em.emulate_k10(qa, c["ra"])
    want = skip_cuda.approx_min_sorted_plain(qa, c["ra"])
    assert torch.equal(got, want)
    assert counts["swept_pairs"] <= counts["formed_pairs"] <= counts["dense_pairs"]
    return want[:, :n], q2, counts


def _k11(c, ub2):
    args = (c["qs"], c["qm"], c["rt"], c["rpen"])
    flags = skip.build_skip_mask(c["qs"], c["qm"], ub2, c["cbox"])
    d, i, _ = em.emulate_k11(*args, flags)
    dp, ip = skip_cuda.nn1_sorted_skip_plain(*args, flags)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    return d


def _route(c):
    """Cold, K10's bound, then a transported bound: K10 and K11 at each."""
    amin, q2, counts = _k10(c)
    inf = torch.full(c["qm"].shape, float("inf"))
    _k11(c, inf)
    d = _k11(c, torch.minimum(inf, amin + skip.bound_margin(q2, amin)))
    _k11(c, (torch.sqrt(d) + 0.01) ** 2 * sweep.UP)
    return counts


def test_k10_tables_hold_the_hoisting_precondition():
    """K10's kernel takes a3·r3 = r3 and a4·r4 = a4: the builders must put 1
    in every row's column 3 of qa and every column's row 4 of ra, padding
    rows and columns and invalid columns included."""
    c = _case(6, n_map=700, n_q=300, invalid=3, m_extra=3 * 128 + 5)
    n_pad = -(-300 // skip_cuda.TILE_Q) * skip_cuda.TILE_Q + skip_cuda.TILE_Q
    qa, _ = skip.augment_queries(c["qs"], n_pad)
    assert qa.shape[-2] == n_pad > 300 and c["ra"].shape[1] > 700
    assert bool((qa[..., 3] == 1.0).all())
    assert bool((c["ra"][4] == 1.0).all())
    assert bool((c["ra"][3, 700:] == skip.BOUND_BIG).all())


@pytest.mark.parametrize("offset", OFFSETS)
def test_scene_at_offsets(offset):
    counts = _route(_case(1, offset))
    share = counts["swept_pairs"] / counts["dense_pairs"]
    print(f"offset {offset:g}: K10 swept share {share:.4f}")
    if offset == 0.0:          # the room itself prunes well
        assert share < 0.5


def test_duplicate_rows_ties():
    _route(_case(2, dup=True))


def test_masked_queries_and_a_fully_masked_tile():
    c = _case(3, n_q=800)
    c["qm"][0, 256:512] = False              # the second tile of scan 0
    c["qm"][1, ::2] = False
    _route(c)


@pytest.mark.parametrize("what", ["invalid", "partial", "one_valid", "padded"])
def test_map_edges(what):
    """Many invalid rows; a partial last chunk of K10 (m_pad not a multiple
    of 128) and a partial last super-chunk of K11; one valid row; K10 over
    five chunks of padding columns beyond the map."""
    if what == "invalid":
        c = _case(4, invalid=2)
    elif what == "partial":
        c = _case(5, n_map=1000)             # m_pad 1024: 2 super-chunks
        ra = c["ra"][:, :1000]               # K10 over a ragged last chunk
        n = c["qs"].shape[1]
        qa, _ = skip.augment_queries(c["qs"], -(-n // 256) * 256)
        got, _ = em.emulate_k10(qa, ra)
        assert torch.equal(got, skip_cuda.approx_min_sorted_plain(qa, ra))
    elif what == "one_valid":
        base = _case(6, n_map=700)
        rsm = np.zeros_like(base["rsm"])
        rsm[350] = True
        c = _tables(base["rs"], rsm, base["qs"].numpy(), base["qm"].numpy())
    else:
        c = _case(7, n_map=900, m_extra=640)
        _k10(c)
        return
    _route(c)


def test_queries_on_chunk_boxes():
    """Queries at the corners and on the faces of K10's chunk boxes and of
    K11's super-chunk boxes, where the lower bound's gap is 0."""
    c = _case(8, n_q=600)
    tab = em.k10_table(c["ra"])
    lo, hi = tab["lo"], tab["hi"]
    fin = torch.isfinite(lo).all(dim=1)
    lo, hi = lo[fin], hi[fin]
    mid = 0.5 * (lo + hi)
    pts = torch.cat([lo, hi, torch.stack([lo[:, 0], mid[:, 1], mid[:, 2]], 1),
                     torch.stack([mid[:, 0], hi[:, 1], lo[:, 2]], 1),
                     c["cbox"][:, 0], c["cbox"][:, 1]])
    pts = pts[torch.isfinite(pts).all(dim=1)]
    q = pts[:600].numpy()
    qm = np.ones(len(q), bool)
    o, _ = morton_argsort(q, qm)
    d = _tables(c["rs"], c["rsm"], q[o][None], qm[None])
    _route(d)


def test_random_flags_segments():
    """K11 on arbitrary flag rows: lists of every length, cut unevenly into
    the 8 segments, skipping the true neighbour's super-chunk too (K11 is the
    exact minimum over what the flags leave)."""
    c = _case(9, n_map=6000, n_q=1200)
    rng = np.random.default_rng(9)
    B, n = c["qm"].shape
    ni, nsg = -(-n // 256), -(-c["rt"].shape[1] // 512)
    for p in (0.0, 0.3, 0.8, 0.97, 1.0):
        flags = torch.as_tensor((rng.random((B, ni, nsg)) < p).astype(np.int32))
        args = (c["qs"], c["qm"], c["rt"], c["rpen"], flags)
        d, i, counts = em.emulate_k11(*args)
        dp, ip = skip_cuda.nn1_sorted_skip_plain(*args)
        assert torch.equal(d, dp) and torch.equal(i, ip)


def _bits(x):
    """float32 → an integer key in the order of the floats."""
    i = x.view(torch.int32).long()
    return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))


def _float(k):
    i = torch.where(k >= 0, k, ((-k) | 0x80000000) - (1 << 32))
    return i.to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("offset", OFFSETS)
def test_lemma_lower_bound(offset):
    """For (query, chunk) pairs of the scene, the scene's far corners and
    the chunk boxes: K10's test at a running best X skips the chunk only if
    X < the chunk's smallest t. Checked at X = that t (and a few floats
    above), and the largest X the test skips at, found by bisection, lies
    below it; the smallest slack is printed. Every invalid column's t lies
    above the chunk's cap."""
    c = _case(10, offset, n_map=4000, n_q=400, scans=1, invalid=7)
    ra = c["ra"]
    tab = em.k10_table(ra)
    nch = tab["nch"]
    rng = np.random.default_rng(10)
    extra = (rng.uniform(-20, 30, (64, 3)) + offset).astype(np.float32)
    q = torch.cat([c["qs"][0], torch.as_tensor(extra),
                   tab["lo"][torch.isfinite(tab["lo"]).all(dim=1)][:64]])
    qa, _ = skip.augment_queries(q, q.shape[0])
    Q = em._queries(qa)
    flat = lambda t: t.reshape(-1)[: q.shape[0]]
    a = [flat(x) for x in Q["a"]]
    qq = [flat(x) for x in Q["q"]]
    qu, qk, safe = flat(Q["qu"]), flat(Q["qk"]), flat(Q["safe"])
    assert bool(safe.all())
    cols = torch.arange(nch * 128).reshape(nch, 128)
    rows = torch.nn.functional.pad(ra[:4], (0, nch * 128 - ra.shape[1]))
    r = [rows[k][cols] for k in range(4)]                      # [nch, 128]
    t = ((a[0][:, None, None] * r[0] + a[1][:, None, None] * r[1])
         + a[2][:, None, None] * r[2]) + r[3]                  # [nq, nch, 128]
    present = (cols < ra.shape[1])
    valid = present & (r[3] < em.BIG_R)
    big = present & (r[3] >= em.BIG_R)
    assert bool((t[:, big] > em.CAP).all())
    tmin = torch.where(valid, t, float("inf")).amin(dim=2)     # [nq, nch]
    has = torch.isfinite(tmin)
    args = ([x[:, None] for x in qq], qk[:, None])
    chunk = ([tab["lo"][None, :, k] for k in range(3)],
             [tab["hi"][None, :, k] for k in range(3)],
             tab["rho"][None], tab["e2"][None], tab["cap"][None])

    def skips(x):
        return em.k10_test(*args, em.best_limit(x, qu[:, None], safe[:, None]),
                           x, *chunk)

    for k in range(4):
        x = _float(_bits(tmin) + k) if k < 3 else tmin + tmin.abs() * 2.0 ** -10
        assert not bool(skips(torch.where(has, x, 0.0))[has].any())
    # the largest X that still skips, by bisection over the floats
    lo = torch.where(has, -(qu[:, None] * 4 + 1), 0.0)
    ok = skips(lo) & has
    klo, khi = _bits(lo), _bits(torch.where(has, tmin, 0.0))
    for _ in range(34):
        mid = (klo + khi) // 2
        s = skips(_float(mid))
        klo = torch.where(s, mid, klo)
        khi = torch.where(s, khi, mid)
    xs = _float(klo)
    assert bool((xs[ok] < tmin[ok]).all())
    slack = (tmin[ok].double() - xs[ok].double())
    rel = slack / (qu[:, None].expand_as(tmin)[ok].double() + 1.0)
    print(f"offset {offset:g}: {int(ok.sum())} of {int(has.sum())} pairs can "
          f"skip; smallest slack {float(slack.min()):.6g} m², "
          f"{float(rel.min()):.3g} of |q|² + 1")
