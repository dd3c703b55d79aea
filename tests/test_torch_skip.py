"""The v1 skip route of the port (``ops/skip.py``, ``ops/skip_cuda.py``, the
``PMTPU_SKIP_V1`` / ``PMTPU_SKIP_MXU_BOUND`` branch of
``KDTreeMatcher.find_closests_in_stateful`` and the batch's
``PMTPU_SKIP_HOST_MORTON`` order) against the JAX package's
``ops/knn_skip.py`` and serving drivers on the CPU. The JAX side's Pallas
kernels run in interpret mode, as tests/test_torch_batch.py runs them.

Held equal: the host tables (``chunk_bboxes``, ``augmented_ref_table``, the
v1 tables, ``augment_queries``) array for array; the skip flags; the host
Morton orders; per scan, the serving drivers' iterations and codes.

Tolerances. The interpret-mode kernels run through XLA's CPU compiler,
which may contract ``d2 + diff * diff`` into fused multiply-adds, so K11's
d² is held within 2 ulp of theirs (ROADMAP Queue 3's last paragraph), and
exactly to the port's dense search. K11's ids are held to the Pallas
kernel's where the neighbour is unique: it picks by lane among equal
distances, K11 the lowest sorted index (ROADMAP Queue 3 #15). K10 is an
approximation in both packages, each within its rounding error of the
exact minimum: the two are held within the bound's margin of each other,
and the bound (minimum + margin) above the exact float64 minimum on every
valid query. Poses: 1e-4 on rotation entries and 1e-4 × the scene extent
on translation, as in tests/test_torch_queue.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_knn_skip import _cloudlike
from test_torch_batch import interpret_mode  # noqa: F401
from test_torch_queue import (LANES, SEED, assert_same, force_route,
                              port_sequence, queue_both, scene)  # noqa: F401
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.ops.knn_skip as ks
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_serve

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.ops import skip, skip_cuda, sweep
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force
from libpointmatcher_tpu_torch.ops.morton import morton_argsort
from libpointmatcher_tpu_torch.parallel import register_batch_to_map

ULP2 = 2.0 ** -22        # 2 ulp of float32, relative
T = torch.from_numpy


def _sorted_case(seed, n=900, m=2600, batch=3, scale=1.0):
    """A Morton-sorted map and its v1 tables, and ``batch`` Morton-sorted
    scans of clustered queries (each its own draw) → dict of numpy."""
    q, qm, r, rm = _cloudlike(n=n, m=m, seed=seed)
    r = (r * scale).astype(np.float32)
    rorder, _ = morton_argsort(r, rm)
    rs, rsm = r[rorder], rm[rorder]
    m_pad = 128 * -(-m // 128)
    rt, rpen = skip.v1_tables(rs, rsm, m_pad)
    qs, qms = [], []
    for b in range(batch):
        qb, qmb, _, _ = _cloudlike(n=n, m=m, seed=seed + 100 + b)
        qb = (qb * scale).astype(np.float32)
        o, _ = morton_argsort(qb, qmb)
        qs.append(qb[o])
        qms.append(qmb[o])
    return {"rs": rs, "rsm": rsm, "rt": rt, "rpen": rpen, "m_pad": m_pad,
            "cbox": skip.chunk_bboxes(rs, rsm, 512), "qs": np.stack(qs),
            "qm": np.stack(qms)}


def _warm_bound(d_prev, shift):
    """The transported bound of the next iteration, as the matcher forms it."""
    ub = torch.sqrt(d_prev) + float(np.linalg.norm(shift))
    return (ub * ub) * sweep.UP


def _assert_d2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=ULP2, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_tables_equal_jax(seed):
    c = _sorted_case(seed)
    rs, rsm, m_pad = c["rs"], c["rsm"], c["m_pad"]
    for chunk in (256, 512):
        np.testing.assert_array_equal(skip.chunk_bboxes(rs, rsm, chunk),
                                      ks.chunk_bboxes(rs, rsm, chunk=chunk))
    ra, r2max = skip.augmented_ref_table(rs, rsm, m_pad)
    ra_j, r2max_j = ks.augmented_ref_table(rs, rsm, m_pad)
    np.testing.assert_array_equal(ra, ra_j)
    assert r2max == r2max_j
    for b in range(c["qs"].shape[0]):
        qa_j, q2_j = ks.augment_queries(jnp.asarray(c["qs"][b]), 1024)
        qa, q2 = skip.augment_queries(T(c["qs"][b]), 1024)
        np.testing.assert_array_equal(qa.numpy(), np.asarray(qa_j))
        np.testing.assert_array_equal(q2.numpy(), np.asarray(q2_j))
    # batched, each scan as alone
    qa_b, _ = skip.augment_queries(T(c["qs"]), 1024)
    np.testing.assert_array_equal(qa_b[1].numpy(),
                                  skip.augment_queries(T(c["qs"][1]), 1024)[0])


def test_matcher_v1_tables_equal_jax(scene, monkeypatch):
    """serving_loop_aux builds the v1 tables of the JAX matcher from the
    same map, equal on the port's columns (the JAX cloud holds trailing
    padding rows, ROADMAP Queue 3 #6, whose boxes are empty and whose
    columns are padding); with knn > 1 the port builds none (the JAX
    matcher builds them and does not use them)."""
    import libpointmatcher_tpu.matchers as jmatchers

    force_route(monkeypatch, "K3")
    ps = port_sequence(scene[0])
    pts = ps.get_prefiltered_internal_map().points.numpy()
    jm = jmatchers.KDTreeMatcher()
    assert jm.serving_loop_aux(pm.PointCloud.from_numpy(pts))
    pmat = KDTreeMatcher()
    assert pmat.serving_loop_aux(pt.PointCloud.from_numpy(pts, device="cpu"))
    tj = jm._skip_shared
    tp = pmat._skip_shared
    m_pad = tp["skip_rt"].shape[1]
    nsg = tp["skip_cbox"].shape[0]
    assert m_pad == 128 * -(-len(pts) // 128) <= tj["skip_rt"].shape[1]
    for key in ("skip_rt", "skip_rpen", "skip_ra"):
        np.testing.assert_array_equal(tp[key].numpy(),
                                      np.asarray(tj[key])[:, :m_pad], key)
    np.testing.assert_array_equal(tp["skip_cbox"].numpy(),
                                  np.asarray(tj["skip_cbox"])[:nsg])
    extra = np.asarray(tj["skip_cbox"])[nsg:]
    assert np.all(extra[:, 0] == np.inf) and np.all(extra[:, 1] == -np.inf)
    assert KDTreeMatcher.SKIP_TILE_Q == jmatchers.KDTreeMatcher.SKIP_TILE_Q
    assert KDTreeMatcher.SKIP_GROUP == jmatchers.KDTreeMatcher.SKIP_GROUP
    k3 = KDTreeMatcher({"knn": "3"})
    assert k3.serving_loop_aux(ps.get_prefiltered_internal_map())
    assert "skip_rt" not in k3.serving_aux()


@pytest.mark.parametrize("warm", [False, True])
def test_build_skip_mask_equal_jax(warm):
    """The flags of a batch of scans equal the JAX function's, scan by scan;
    where XLA's sum of three squares rounds otherwise, a flag may differ
    only where mind² and U² lie within 2 ulp, and none does here."""
    c = _sorted_case(2, n=1100)
    qs, qm = T(c["qs"]), T(c["qm"])
    ub2 = torch.full(qm.shape, float("inf"))
    if warm:
        d, _ = skip_cuda.nn1_sorted_skip_plain(
            qs, qm, T(c["rt"]), T(c["rpen"]),
            skip.build_skip_mask(qs, qm, ub2, T(c["cbox"])))
        shift = np.float32([0.02, -0.01, 0.015])
        ub2 = torch.where(qm, _warm_bound(d, shift), float("inf"))
        qs = qs + T(shift)
    flags = skip.build_skip_mask(qs, qm, ub2, T(c["cbox"]))
    jfn = jax.vmap(functools.partial(ks.build_skip_mask, tile_q=256),
                   in_axes=(0, 0, 0, None))
    fj = np.asarray(jfn(jnp.asarray(qs.numpy()), jnp.asarray(qm.numpy()),
                        jnp.asarray(ub2.numpy()), jnp.asarray(c["cbox"])))
    mind2, U2 = skip.skip_gaps(qs, qm, ub2, T(c["cbox"]))
    differ = flags.numpy() != fj
    with np.errstate(invalid="ignore"):
        near = (np.abs(mind2.numpy() - U2.numpy()[..., None])
                <= ULP2 * np.abs(U2.numpy()[..., None]))
    assert not np.any(differ & ~near)
    assert not differ.any()
    assert flags.shape == (3, 5, c["cbox"].shape[0]) and flags.dtype == torch.int32
    # masked rows only: every flag set
    dead = skip.build_skip_mask(qs, torch.zeros_like(qm), ub2, T(c["cbox"]))
    assert bool((dead == 1).all())
    if warm:
        assert flags.float().mean() > 0.2


@pytest.mark.parametrize("warm", [False, True])
def test_k11_plain_matches_pallas_and_brute_force(warm, interpret_mode):
    """K11's plain version: d² within 2 ulp of the interpret-mode Pallas
    kernel's, ids equal where the neighbour is unique, and equal outright
    to the port's dense search on the sorted map."""
    c = _sorted_case(2, n=1100)
    qs, qm = T(c["qs"]), T(c["qm"])
    ub2 = torch.full(qm.shape, float("inf"))
    if warm:
        flags = skip.build_skip_mask(qs, qm, ub2, T(c["cbox"]))
        d, _ = skip_cuda.nn1_sorted_skip_plain(qs, qm, T(c["rt"]),
                                               T(c["rpen"]), flags)
        shift = np.float32([0.01, 0.02, -0.01])
        ub2 = torch.where(qm, _warm_bound(d, shift), float("inf"))
        qs = qs + T(shift)
    flags = skip.build_skip_mask(qs, qm, ub2, T(c["cbox"]))
    if warm:
        assert flags.float().mean() > 0.2
    d, i = skip_cuda.nn1_sorted_skip(qs, qm, T(c["rt"]), T(c["rpen"]), flags)
    for b in range(qs.shape[0]):
        dj, ij = ks.nn1_sorted_skip(jnp.asarray(qs[b].numpy()),
                                    jnp.asarray(qm[b].numpy()),
                                    jnp.asarray(c["rt"]), jnp.asarray(c["rpen"]),
                                    jnp.asarray(flags[b].numpy()))
        _assert_d2(d[b], dj)
        db, ib = knn_brute_force(qs[b], qm[b], T(c["rs"]), T(c["rsm"]), k=2)
        assert torch.equal(d[b], db[:, 0]) and torch.equal(i[b], ib[:, 0])
        d1, d2 = db[:, 0].numpy(), db[:, 1].numpy()
        with np.errstate(invalid="ignore"):
            unique = np.isfinite(d1) & (d2 - d1 > 4 * ULP2 * np.abs(d1))
        assert unique.sum() > 500
        np.testing.assert_array_equal(i[b].numpy()[unique],
                                      np.asarray(ij)[unique])
        assert np.all(i[b].numpy()[~qm[b].numpy()] == -1)


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_k10_plain_matches_pallas_and_bounds(scale, interpret_mode,
                                            detail_telemetry):
    """K10's plain version and the interpret-mode Pallas kernel agree
    within the bound's margin, and the bound covers the exact float64
    minimum on every valid query (ops/skip.py::bound_margin; the derivation
    is in csrc/skip.cu)."""
    c = _sorted_case(4, n=800, m=2000, batch=2, scale=scale)
    ra, _ = skip.augmented_ref_table(c["rs"], c["rsm"], c["m_pad"])
    qs, qm = T(c["qs"]), T(c["qm"])
    n = qs.shape[1]
    qa, q2 = skip.augment_queries(qs, 1024)
    amin = skip_cuda.approx_min_sorted(qa, T(ra))
    assert amin.shape == (2, 1024)
    amin = amin[:, :n]
    margin = skip.bound_margin(q2, amin)
    ub2 = amin + margin
    d64 = ((c["qs"][:, :, None, :].astype(np.float64)
            - c["rs"][None, None].astype(np.float64)) ** 2).sum(-1)
    d64[..., ~c["rsm"]] = np.inf
    true_min = d64.min(-1)
    ok = c["qm"]
    assert np.all(ub2.numpy()[ok] >= true_min[ok])
    assert np.all(amin.numpy()[ok] <= true_min[ok] + margin.numpy()[ok])
    for b in range(2):
        aj = np.asarray(ks.approx_min_sorted(jnp.asarray(qa[b].numpy()),
                                             jnp.asarray(ra)))[:n]
        assert np.all(np.abs(amin[b].numpy() - aj) <= margin[b].numpy())
    # the route with the bound: the same matches as without it
    cbox = T(c["cbox"])
    inf = torch.full(qm.shape, float("inf"))
    with telemetry.call("nn1_sorted_v1"):
        d0, i0 = skip.nn1_sorted_v1(qs, qm, inf, T(c["rt"]), T(c["rpen"]), cbox)
        d1, i1 = skip.nn1_sorted_v1(qs, qm, inf, T(c["rt"]), T(c["rpen"]), cbox,
                                    ra=T(ra))
    f0, f1 = map(np.asarray, detail_telemetry("skip_share"))
    assert f0.shape == f1.shape == (2,)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert bool((f1 >= f0).all()) and bool(torch.isfinite(ub2[qm]).all())


def _batch_both(scene, n_scans=3):
    ref, scans, _, inits, _ = scene
    js = pm.ICPSequence()
    js.set_default()
    js.set_map(pm.PointCloud.from_numpy(ref), seed=5)
    jax_out = jax_serve(js, [pm.PointCloud.from_numpy(s) for s in scans[:n_scans]],
                        T_inits=inits[:n_scans], seed=SEED)
    ps = port_sequence(ref)
    port_out = register_batch_to_map(
        ps, [pt.PointCloud.from_numpy(s, device="cpu") for s in scans[:n_scans]],
        T_inits=inits[:n_scans], seed=SEED)
    return jax_out, port_out, ps


def _scene_prefix(scene, k):
    ref, scans, poses, inits, extent = scene
    return ref, scans[:k], poses[:k], inits[:k], extent


SWITCHES = {"v1": {"PMTPU_SKIP_V1": "1"},
            "v1_mxu": {"PMTPU_SKIP_V1": "1", "PMTPU_SKIP_MXU_BOUND": "1"},
            "host_morton": {"PMTPU_SKIP_V1": "1", "PMTPU_SKIP_HOST_MORTON": "1"}}


def _count_calls(monkeypatch):
    """Count the calls of the port's plain kernels (the CPU wrappers launch
    nothing), of its host order, and the JAX package's traces of its K10
    and K11 (zero when its matcher takes another route)."""
    from libpointmatcher_tpu_torch.parallel import batch

    calls = dict.fromkeys(("K10", "K11", "K3", "host", "jax K10", "jax K11"), 0)
    for key, mod, name in (("K10", skip_cuda, "approx_min_sorted_plain"),
                           ("K11", skip_cuda, "nn1_sorted_skip_plain"),
                           ("K3", sc, "survivor_sweep_plain"),
                           ("host", batch, "_host_orders"),
                           ("jax K10", ks, "approx_min_sorted"),
                           ("jax K11", ks, "nn1_sorted_skip")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_batch_v1_routes_match_jax(scene, monkeypatch, interpret_mode, switch,
                                   detail_telemetry):
    force_route(monkeypatch, "K3")
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    calls = _count_calls(monkeypatch)
    jax_out, port_out, ps = _batch_both(scene)
    assert_same(jax_out, port_out, _scene_prefix(scene, 3))
    it = int(port_out[1]["iterations"].max())
    mxu = switch == "v1_mxu"
    assert (calls["K10"], calls["K11"], calls["K3"]) == (it if mxu else 0, it, 0)
    assert calls["host"] == (switch == "host_morton")
    assert calls["jax K11"] > 0 and (calls["jax K10"] > 0) == mxu
    fr = [np.asarray(f) for f in detail_telemetry("skip_share")]
    assert len(fr) == it and all(f.shape == (3,) for f in fr)
    assert not detail_telemetry("survivor_share")
    # the transported bound skips from the second iteration on
    assert float(fr[-1].mean()) > 0.0
    if switch == "v1_mxu":
        assert float(fr[0].mean()) > 0.0


@pytest.mark.parametrize("coarse", [None, (4, 16, 1.0)])
def test_queue_v1_mxu_matches_jax(scene, monkeypatch, interpret_mode, coarse,
                                  detail_telemetry):
    force_route(monkeypatch, "K3")
    for k, v in SWITCHES["v1_mxu"].items():
        monkeypatch.setenv(k, v)
    calls = _count_calls(monkeypatch)
    jax_out, port_out, _, ps = queue_both(scene, {}, coarse=coarse)
    assert_same(jax_out, port_out, scene)
    assert calls["K3"] == 0 and calls["K10"] == calls["K11"] > 0
    assert calls["jax K10"] > 0 and calls["jax K11"] > 0
    shares = detail_telemetry("skip_share")
    assert shares and all(np.shape(f) == (LANES,) for f in shares)


def test_host_qorder_equal_jax(scene, monkeypatch):
    """The port's host Morton orders (prepare_loop_host_batch, and the
    batch's order of raw rows moved by Trm⁻¹·T_init) equal the JAX
    matcher's."""
    import libpointmatcher_tpu.matchers as jmatchers
    from libpointmatcher_tpu_torch.parallel.batch import _host_orders

    monkeypatch.setattr(jmatchers, "_use_pallas", lambda: True)
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    ref, scans, _, inits, _ = scene
    js = pm.ICPSequence()
    js.set_default()
    js.set_map(pm.PointCloud.from_numpy(ref), seed=5)
    assert js.matcher.serving_loop_aux(js.get_prefiltered_internal_map())
    ps = port_sequence(ref)
    assert ps.matcher.serving_loop_aux(ps.get_prefiltered_internal_map())
    rows = max(len(s) for s in scans)
    trm_inv = np.linalg.inv(js.trm_host())
    pts_b = np.zeros((len(scans), rows, 3), np.float32)
    mask_b = np.zeros((len(scans), rows), bool)
    for i, s in enumerate(scans):
        Tm = trm_inv @ np.asarray(inits[i], np.float64)
        pts_b[i, :len(s)] = s @ Tm[:3, :3].T + Tm[:3, 3]
        mask_b[i, :len(s)] = True
    oj = np.asarray(js.matcher.prepare_loop_host_batch(pts_b, mask_b)[0]["qorder"])
    op = ps.matcher.prepare_loop_host_batch(pts_b, mask_b)["qorder"]
    np.testing.assert_array_equal(op, oj)
    np.testing.assert_array_equal(ps.matcher.prepare_loop_host(pts_b[1], mask_b[1])
                                  ["qorder"], oj[1])
    np.testing.assert_allclose(ps.trm_host(), js.trm_host(), atol=1e-6)
    orders = _host_orders(ps, [pt.PointCloud.from_numpy(s, device="cpu")
                               for s in scans], inits)
    for i, s in enumerate(scans):
        assert sorted(orders[i].tolist()) == list(range(len(s)))
        np.testing.assert_array_equal(orders[i].numpy(), oj[i, :len(s)])
    off = KDTreeMatcher()
    assert off.prepare_loop_host(pts_b[0], mask_b[0]) is None
