"""Card-against-CPU checks of the data filters: the same filter on the same
input, run on the card and on the CPU (``chip_smoke.py`` phase 23,
``tests/test_torch_cuda.py``).

:func:`compare` holds the card's output to the CPU's:

- masks, kept rows, time channels and integer outputs equal; where a
  filter picks rows by a float comparison of sums (OctreeGrid's medoid,
  CovarianceSampling's greedy pick) at least ``kept_share`` of the rows are
  shared and the rest are logged;
- points within 1e-5 relative and 1e-5 m;
- descriptors within 1e-4 relative and 1e-5 of the descriptor's largest
  value; eigenvalues within 1e-4 of their row's largest;
- eigen-derived descriptors (normals, eigenvectors, the Gestalt bins) up
  to sign, within 1e-3, in at least ``eig_share`` of the rows: the card's
  sums run in another order (``index_add_`` in atomic order), and where a
  neighbourhood's eigenvalues nearly tie, or a neighbour lies on a Gestalt
  bin's edge, the rounding decides.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["compare", "timed", "EIGEN_DESCRIPTORS"]

#: descriptors that the card forms from its own eigenvectors or bins
EIGEN_DESCRIPTORS = ("normals", "eigVectors", "gestaltMeans", "gestaltVariances",
                     "gestaltShapes", "shapes")


def timed(torch, fn):
    """``fn()`` once untimed, then once timed on the host clock ending in a
    synchronize → (its output, ms)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def _rows_by_point(a, b):
    """Indices (ia, ib) of the rows of ``a`` and ``b`` with the same point."""
    where = {row.tobytes(): i for i, row in enumerate(b)}
    pairs = [(i, where[row.tobytes()]) for i, row in enumerate(a)
             if row.tobytes() in where]
    ia, ib = (np.asarray(x, np.int64) for x in zip(*pairs)) if pairs else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    return ia, ib


def _sign_rows(a, b):
    return a * np.where(np.sum(a * b, axis=1) < 0, -1.0, 1.0)[:, None]


def compare(card, cpu, kept_share: float = 1.0, eig_share: float = 0.99) -> dict:
    """The card's output cloud against the CPU's (see the module
    docstring) → the measured differences; raises AssertionError beyond
    the tolerances."""
    pc, dc, tc = card.to_numpy(with_times=True)
    pp, dp, tp = cpu.to_numpy(with_times=True)
    out = {"rows": int(len(pc))}
    if card.num_points == cpu.num_points:
        mask_diff = int((card.mask.cpu().numpy() != cpu.mask.cpu().numpy()).sum())
    else:
        mask_diff = abs(card.num_points - cpu.num_points)
    out["mask_diff"] = mask_diff
    if kept_share >= 1.0:
        if mask_diff or pc.shape != pp.shape:
            raise AssertionError(f"masks differ in {mask_diff} rows, rows "
                                 f"{pc.shape} against {pp.shape}")
        ia = ib = np.arange(len(pc))
    else:
        ia, ib = _rows_by_point(pc, pp)
        share = len(ia) / max(len(pp), 1)
        out["kept_shared"] = round(share, 6)
        if share < kept_share or len(pc) != len(pp):
            raise AssertionError(f"kept rows: {len(pc)} against {len(pp)}, "
                                 f"{share:.4%} shared (at least {kept_share:.2%})")
    if list(dc) != list(dp) or list(tc) != list(tp):
        raise AssertionError(f"channels {list(dc)} {list(tc)} against "
                             f"{list(dp)} {list(tp)}")
    for k in tp:
        if not np.array_equal(tc[k][ia], tp[k][ib]):
            raise AssertionError(f"time channel {k} differs")
    err = float(np.abs(pc[ia] - pp[ib]).max()) if len(ia) else 0.0
    if not np.allclose(pc[ia], pp[ib], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"points differ by {err}")
    out["points_err"] = err
    flip = None
    if "normals" in dp:
        flip = np.sum(dc["normals"][ia] * dp["normals"][ib], axis=1) < 0
    eig_bad = np.zeros(len(ia), bool)
    worst = {}
    for k in dp:
        a, b = dc[k][ia].astype(np.float64), dp[k][ib].astype(np.float64)
        if k == "normals":
            a = _sign_rows(a, b)
        elif k == "eigVectors":
            d = int(round(np.sqrt(b.shape[1])))
            a3, b3 = a.reshape(-1, d, d), b.reshape(-1, d, d)
            s = np.where(np.sum(a3 * b3, axis=1, keepdims=True) < 0, -1.0, 1.0)
            a = (a3 * s).reshape(a.shape)
        elif k in ("gestaltMeans", "gestaltVariances") and flip is not None:
            g = a.reshape(-1, 4, 8)
            a = np.where(flip[:, None, None], np.roll(g, 4, axis=2), g).reshape(a.shape)
        nan = np.isnan(a) & np.isnan(b)
        diff = np.where(nan, 0.0, np.abs(a - b))
        diff = np.where(np.isnan(diff), np.inf, diff)
        worst[k] = float(diff.max()) if diff.size else 0.0
        if k in EIGEN_DESCRIPTORS:
            eig_bad |= (diff > 1e-3 + 1e-4 * np.abs(b)).any(axis=1)
            continue
        mag = np.nan_to_num(np.abs(b))
        if k in ("eigValues", "covariance"):
            tol = 1e-4 * mag.max(axis=1, keepdims=True) + 1e-12
        else:
            tol = 1e-4 * mag + 1e-5 * max(float(mag.max()) if mag.size else 0.0, 1.0)
        if (diff > tol).any():
            raise AssertionError(f"descriptor {k} differs by {worst[k]}")
    out["descriptor_err"] = {k: float(f"{v:.3g}") for k, v in worst.items()}
    if len(ia):
        share = 1.0 - float(eig_bad.mean())
        out["eigen_rows_within"] = round(share, 6)
        if share < eig_share:
            raise AssertionError(f"eigen-derived descriptors within 1e-3 in "
                                 f"{share:.4%} of rows (at least {eig_share:.2%})")
    return out
