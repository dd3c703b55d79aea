"""The 1-NN lowerings T1, T2 and T3 (libpointmatcher_tpu_torch.ops.
knn_variants_cuda) against the JAX tool's Pallas kernels
(tools/knn_variants.py), run in interpret mode on the CPU, and the port's
tools_torch/knn_micro.py on the CPU.

Tolerances: the plain T1 and T2 form K1's difference-form d² and equal the
port's K1 bit for bit; against the interpret-mode Pallas kernels their d²
agrees within 2 ulp, because XLA's CPU compiler contracts
``d2 + diff * diff`` into fused multiply-adds, and their ids wherever the
neighbour is unique beyond that. T3's expansion form errs by up to
2^-20·(q² + r²): its d² agrees with the Pallas T3 within that bound, and
its ids wherever the neighbour is unique beyond it. The Pallas T1 breaks
ties by lane; every port variant keeps the lowest index.

The same kernels on the card are tested in tests/test_torch_cuda.py.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jkv = _load("jax_knn_variants", "tools/knn_variants.py")
PORT = {"T1": kv.knn1_chunked, "T2": kv.knn1_transposed, "T3": kv.knn1_mxu}
PALLAS = {"T1": jkv.knn1_chunked, "T2": jkv.knn1_transposed, "T3": jkv.knn1_mxu}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jkv.pl, "pallas_call", patched)


def _data(n, m, dim, seed=0, dup=False):
    """Uniform in [-10, 10]^dim; the last 7% of the queries and every 17th
    reference row masked; with ``dup`` each odd row repeats the even one
    before it (ties in two lanes)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, (n, dim)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, dim)).astype(np.float32)
    if dup:
        r[1::2] = r[::2][:len(r[1::2])]
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    rm[::17] = False
    if dup:
        rm[:] = True
    return q, qm, r, rm


def _d2_sorted(q, r, rm):
    """float64 squared distances, masked rows at +inf, sorted per query."""
    d = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    return np.sort(np.where(rm[None], d, np.inf), axis=1)


def _run(variant, q, qm, r, rm):
    dp, ip = PORT[variant](*(torch.from_numpy(a) for a in (q, qm, r, rm)))
    dj, ij = PALLAS[variant](*(jnp.asarray(a) for a in (q, qm, r, rm)))
    return dp.numpy(), ip.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("n,m,dim", [(700, 3000, 3), (333, 1234, 3),
                                     (700, 3000, 2), (333, 1234, 2)])
@pytest.mark.parametrize("variant", ["T1", "T2", "T3"])
def test_plain_matches_pallas(variant, n, m, dim):
    q, qm, r, rm = _data(n, m, dim, seed=n + m + dim)
    dp, ip, dj, ij = _run(variant, q, qm, r, rm)
    assert dp.dtype == np.float32 and ip.dtype == np.int32
    assert dp.shape == ip.shape == (n,)
    # masked queries: (+inf, -1) in both
    assert np.isinf(dp[~qm]).all() and (ip[~qm] == -1).all()
    assert np.isinf(dj[~qm]).all() and (ij[~qm] == -1).all()
    fin = np.isfinite(dp)
    np.testing.assert_array_equal(fin, np.isfinite(dj))
    ds = _d2_sorted(q, r, rm)
    if variant == "T3":
        tol = 2.0 ** -20 * ((q.astype(np.float64) ** 2).sum(1)
                            + (r[rm].astype(np.float64) ** 2).sum(1).max())
    else:
        tol = 2 * np.spacing(np.abs(dj).astype(np.float32)).astype(np.float64)
        tol = np.where(fin, tol, 0.0)
    assert (np.abs(dp[fin].astype(np.float64) - dj[fin]) <= tol[fin]).all()
    unique = fin & ((ds[:, 1] - ds[:, 0]) > 2 * tol)
    assert unique.mean() > 0.8
    np.testing.assert_array_equal(ip[unique], ij[unique])
    if variant != "T3":
        # the port's K1 on the same inputs, bit for bit
        d1, i1 = kc.knn1(*(torch.from_numpy(a) for a in (q, qm, r, rm)))
        np.testing.assert_array_equal(dp, d1.numpy())
        np.testing.assert_array_equal(ip, i1.numpy())


@pytest.mark.parametrize("variant", ["T1", "T2", "T3"])
def test_duplicated_rows_keep_the_lowest_index(variant):
    q, qm, r, rm = _data(300, 1001, 3, seed=4, dup=True)
    t = [torch.from_numpy(a) for a in (q, qm, r, rm)]
    _, i = PORT[variant](*t)
    i = i.numpy()
    # the even row of its pair: for T3 too, whose pick may be another near
    # neighbour than K1's, but never the odd copy of its pick
    assert (i[qm] % 2 == 0).all()
    assert (i[~qm] == -1).all()
    if variant != "T3":
        np.testing.assert_array_equal(i, kc.knn1(*t)[1].numpy())


def test_no_valid_reference_and_empty_inputs():
    q, qm, r, rm = _data(50, 40, 3)
    for fn in PORT.values():
        d, i = fn(torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(r),
                  torch.zeros(40, dtype=torch.bool))
        assert torch.isinf(d).all() and (i == -1).all()
        d, i = fn(torch.from_numpy(q), torch.from_numpy(qm),
                  torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool))
        assert d.shape == (50,) and (i == -1).all()


def test_precision_and_inputs_refused():
    q, qm, r, rm = (torch.from_numpy(a) for a in _data(20, 30, 3))
    for precision in ("default", "high"):
        with pytest.raises(ValueError, match="bf16"):
            kv.knn1_mxu(q, qm, r, rm, precision=precision)
    with pytest.raises(ValueError, match="pair axis"):
        kv.knn1_chunked(q[None], qm[None], r[None], rm[None])
    with pytest.raises(ValueError, match="float32"):
        kv.knn1_transposed(q.double(), qm, r, rm)


def test_launch_counts_stay_zero_on_the_cpu():
    kv.reset_launch_counts()
    q, qm, r, rm = (torch.from_numpy(a) for a in _data(20, 30, 3))
    for fn in PORT.values():
        fn(q, qm, r, rm)
        assert fn.launches == 0


def test_knn_micro_runs_on_the_cpu(capsys):
    micro = _load("port_knn_micro", "tools_torch/knn_micro.py")
    assert micro.main(["600", "900", "--device", "cpu", "--reps", "1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["n"] == 600 and report["m"] == 900
    assert set(report["kernels"]) == set(micro.kernels())
    for name in ("T1 knn1_chunked", "T2 knn1_transposed"):
        assert report["kernels"][name]["equal_to_k1"]
    assert report["kernels"]["T3 knn1_mxu"]["id_agreement_unique"] == 1.0
    assert "mxu default 512x2048" in report["refused"]
