"""The schedule of the tile sweeps K7 and K8 on the card's terms, on the
CPU: tools_torch/tile_micro.py's ``emulate`` (one block per parent tile
over its virtual tiles in ``vrows`` order, each over its ``ncols`` prefix,
``x + pen`` staging, groups of 8 columns, K7's group argmin with its
recomputed group and the merge by (d², id), K8's k-slot list per virtual
tile merged with ``_merge_sorted_k``'s pass, the radius and the mask in the
epilogue, masked warps skipped) against the parent-form plain versions,
which are the port's composition of today (``_by_parent`` → per-tile sweep
→ ``apply_max_dist`` → ``_merge_rows`` → scatter → mask); and the same
inputs through the JAX package's ``tile_nn1_from_candidates`` and
``tile_knnk_from_candidates``.

Tolerances: the emulation equals the plain versions bit for bit, d² and
ids, ties included. Against the JAX package: d² within 2 ulp and ids
exactly, tests/test_torch_tilesweep.py's tolerances (its XLA fallbacks keep
the lowest candidate position). The kernels themselves are held to the
plain versions on the card in tests/test_torch_cuda.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tilesweep import _assert_d2

import libpointmatcher_tpu.ops.tilesweep as jts
from libpointmatcher_tpu_torch.ops import tile_cuda
from libpointmatcher_tpu_torch.ops import tilesweep as ts
from libpointmatcher_tpu_torch.parallel.batch import _pad_tile_aux_np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
import tile_micro  # noqa: E402

INF = float("inf")
CASES = {"3d-64": (3, 64), "3d-256": (3, 256), "2d-64": (2, 64)}


def _cases(name):
    """A case's ``q_rows`` form and its tile order (two scans of other
    sizes, masked warps, sentinel virtual tiles)."""
    dim, tq = CASES[name]
    a = tile_micro.make_case("random", dim, tq)
    b = tile_micro.make_case("random", dim, tq, seed=1, near=300)
    return a, tile_micro.tile_order([a, b])[0]


def _plain(args, md, k):
    if k == 0:
        return tile_cuda.tile_sweep_parents_plain(*args, md)
    return tile_cuda.tile_sweep_k_parents_plain(*args, md, k)


def _assert_schedule(args, md, k):
    d, i, st = tile_micro.emulate(*args, md, k)
    dp, ip = _plain(args, md, k)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert 0 <= st["taken"] <= st["units"] and (st["taken"] == 0) == (k == 0)


@pytest.mark.parametrize("name,k", [
    ("3d-64", 0), ("3d-64", 3), ("3d-256", 0), ("3d-256", 10), ("2d-64", 0),
    ("2d-64", 17)])
def test_schedule_matches_plain(name, k):
    """Parents of up to eight virtual tiles, one without a candidate,
    padded parents; the ``q_rows`` form with no radius, the tile order of
    two scans (sentinel virtual tiles, masked warps) with ``maxDist``."""
    case, order = _cases(name)
    _assert_schedule(case["args"], INF, k)
    _assert_schedule(order, 0.5, k)


def test_cases_cover_the_schedule():
    """The random cases hold what the schedule must get right: a parent of
    four or more virtual tiles, a parent with live queries and no candidate
    (its steps all the sentinel), padded parents, a warp of K8 (and at TQ
    256 one of K7) with no live query, and sentinel steps in the batch."""
    for name, (dim, tq) in CASES.items():
        case, (pts, qmask, _, _, ncols, vrows) = _cases(name)
        per = case["per"]
        own = (per["ncols"][per["vrows"]] > 0).sum(0)      # per parent
        live = (per["q_rows"] >= 0).any(1)
        assert own.max() >= 4
        assert (live & (own == 0)).any()
        assert (~live).any()
        m = qmask.reshape(2, -1, tq)
        assert (~m[..., 32:64].any(-1) & m.any(-1)).any()  # a dead K8 warp
        if tq == 256:
            assert (~(m[..., 32:64].any(-1) | m[..., 160:192].any(-1))
                    & m.any(-1)).any()                     # a dead K7 warp
        steps = torch.gather(ncols.reshape(2, -1), 1,
                             vrows.reshape(2, -1).long())
        assert (ncols[:, -1] == 0).all() and (steps == 0).any()
        if name == "3d-64":                # the batch's own padded steps
            assert (vrows[1, -1] == ncols.shape[-1] - 1).all()


@pytest.mark.parametrize("k", [0, 1, 2, 3, 10, 16, 17, 32])
def test_ties_across_virtual_tiles(k):
    """Six candidates at d² = 0.5625 exactly from the query (1.5, 1.5,
    1.5), in six cells and two virtual tiles of one parent: within a
    virtual tile the lowest position wins (the first tile's is row 7, the
    second's row 5 although row 0 lies there too, at a higher position),
    then K7 takes the lower row id across virtual tiles (5) and K8 merges
    the lists in virtual-tile order: 7, 1, 8, 9, then 5, 0."""
    case = tile_micro.make_case("ties")
    args = case["args"]
    assert case["per"]["vrows"].shape[0] == 2
    for md in (INF, 1.0):
        _assert_schedule(args, md, k)
    d, i = _plain(args, 1.0, k)
    want = [7, 1, 8, 9, 5, 0]
    if k == 0:
        assert float(d[0]) == 0.5625 and int(i[0]) == 5
    else:
        assert d[0, :min(k, 6)].eq(0.5625).all()
        assert i[0, :min(k, 6)].tolist() == want[:k]
    order, _ = tile_micro.tile_order([case], warp_mask=False)
    _assert_schedule(order, 1.0, k)


@pytest.mark.parametrize("k", [0, 10])
def test_schedule_matches_jax(k):
    """The same step through the JAX package's ``tile_nn1_from_candidates``
    / ``tile_knnk_from_candidates`` (the tie case and a random case with
    virtual tiles)."""
    for case in (tile_micro.make_case("ties"),
                 tile_micro.make_case("random", 3, 64)):
        sj = jts.build_sub_blocks(case["ref"], case["rmask"], case["cell"])
        per = case["per"]
        cj = jts.gather_candidates(sj, jnp.asarray(per["blocks"]))
        q, qm = jnp.asarray(case["q"]), jnp.asarray(case["qm"])
        md = 0.9
        if k == 0:
            dj, ij = jts.tile_nn1_from_candidates(
                q, qm, per["q_rows"], *cj, md, parent=per["parent"],
                vrows=per["vrows"])
        else:
            dj, ij = jts.tile_knnk_from_candidates(
                q, qm, per["q_rows"], *cj, md, parent=per["parent"],
                vrows=per["vrows"], k=k)
        d, i, _ = tile_micro.emulate(*case["args"], md, k)
        _assert_d2(d.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


def test_live_columns():
    """``ncols`` is 64 × the entries of a row of ``blocks`` that are not the
    all-pad unit U, which fill the row from the left; stacked by
    ``_pad_tile_aux_np`` with 0 for padded virtual tiles."""
    a = tile_micro.make_case("random", 3, 64)
    b = tile_micro.make_case("random", 3, 64, seed=1, near=300)
    u = len(a["sub"].units) - 1
    for c in (a, b):
        blocks, ncols = c["per"]["blocks"], c["per"]["ncols"]
        assert ncols.dtype == np.int32 and ncols.shape == blocks.shape[:1]
        live = np.arange(blocks.shape[1])[None] < (ncols // 64)[:, None]
        np.testing.assert_array_equal(blocks != u, live)
        np.testing.assert_array_equal(ncols, ts.live_columns(blocks, u))
    aux = _pad_tile_aux_np([a["per"], b["per"]], u)
    np.testing.assert_array_equal(aux["ncols"], ts.live_columns(aux["blocks"], u))
    tv = a["per"]["blocks"].shape[0]
    np.testing.assert_array_equal(aux["ncols"][0, :tv], a["per"]["ncols"])
    assert (aux["ncols"][0, tv:] == 0).all()


def test_tile_micro_time_runs_on_the_cpu(tmp_path):
    """tools_torch/tile_micro.py's ``time`` at a tiny recorded step with the
    plain versions: each step is checked and reported with its work."""
    case, order = _cases("3d-64")
    path = tmp_path / "in.pt"
    torch.save({"K7 tiny": {"kernel": "K7", "k": 0, "max_dist": 0.5,
                            "args": order,
                            "parent": tile_micro._parent(order[5], order[3])},
                "K8 tiny k=3": {"kernel": "K8", "k": 3, "max_dist": INF,
                                "args": case["args"],
                                "parent": torch.from_numpy(case["per"]["parent"])}},
               path)
    rep = tile_micro.time_steps(str(path), tile_micro.ROOT, reps=1, rounds=2,
                                device="cpu")
    assert list(rep["inputs"]) == ["K7 tiny", "K8 tiny k=3"]
    k7, k8 = rep["inputs"].values()
    assert k7["kernel"] == "tile_sweep_parents x 1"
    assert k8["kernel"] == "tile_sweep_k_parents x 1"
    for r in (k7, k8):
        assert len(r["step_ms"]) == 2 and min(r["kernel_ms"]) > 0
        assert 0 < r["valid_pairs"] <= r["live_pairs"] <= r["pairs_per_tile_sweep"]
        assert r["vtiles_per_live_parent"][2] >= 4
