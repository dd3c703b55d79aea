"""The normal equations' eigensolver: the JAX package solves them with its
fused cyclic Jacobi (``utils/smalleig.py::eigh_jacobi``, 4 sweeps), the
port with ``torch.linalg.eigh`` (``minimizers.solve_possibly_underdetermined``),
both through the same pseudo-inverse with the rank cutoff
``max|w|·p·1e-7``. A recorded divergence (ROADMAP Queue 3): the two
eigensolvers round differently, so the solutions agree to a tolerance, not
bit for bit.

On full-rank and singular (two equal columns) 6x6 systems from seeded
numpy: eigenvalues within 2e-6 × max|w| of each other; each solution
within 2e-5 × ‖x‖∞ of the other's and of the float64 minimal-norm solution
(measured on this CPU: the port within 6.4e-6, the Jacobi within 4.3e-7,
of float64), the singular one with no component along the null direction;
and the cutoff drops the same eigenvalue in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpointmatcher_tpu import minimizers as jmin
from libpointmatcher_tpu.utils.smalleig import eigh_jacobi

from libpointmatcher_tpu_torch.minimizers import solve_possibly_underdetermined

P = 6


def _system(seed: int, singular: bool):
    """A = FᵀF and b = Fᵀr in float32, F [300, 6] with the translation
    columns 5x the rotation ones (a point-to-plane system's scale)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(300, P)).astype(np.float32) * np.float32([1, 1, 1, 5, 5, 5])
    if singular:
        F[:, 5] = F[:, 4]
    A = (F.T @ F).astype(np.float32)
    b = (F.T @ rng.normal(size=300)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("singular", [False, True])
def test_solve_matches_jacobi(seed, singular):
    A, b = _system(seed, singular)
    x_port = solve_possibly_underdetermined(torch.as_tensor(A),
                                            torch.as_tensor(b)).numpy()
    x_jax = np.asarray(jmin.solve_possibly_underdetermined(jnp.asarray(A),
                                                           jnp.asarray(b)))
    x64 = np.linalg.pinv(A.astype(np.float64), rcond=P * 1e-7) @ b
    scale = np.abs(x64).max()
    np.testing.assert_allclose(x_port, x_jax, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(x_port, x64, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(x_jax, x64, rtol=0, atol=2e-5 * scale)
    w_jax = np.sort(np.asarray(eigh_jacobi(jnp.asarray(A))[0]))
    w_port = torch.linalg.eigh(torch.as_tensor(A))[0].numpy()
    np.testing.assert_allclose(w_port, w_jax, rtol=0,
                               atol=2e-6 * np.abs(w_port).max())
    if singular:
        # minimal norm: nothing along the null direction e4 − e5
        for x in (x_port, x_jax):
            assert abs(x[4] - x[5]) < 2e-5 * scale


def test_cutoff_drops_the_same_eigenvalue():
    """An eigenvalue just under the cutoff is dropped in both packages, one
    just over it kept."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(P, P)))
    b = rng.normal(size=P).astype(np.float32)
    for factor, kept in ((0.5, False), (2.0, True)):
        w = np.array([factor * P * 1e-7, 0.3, 0.5, 0.7, 0.9, 1.0])
        A = (Q @ np.diag(w) @ Q.T).astype(np.float32)
        x_port = solve_possibly_underdetermined(torch.as_tensor(A),
                                                torch.as_tensor(b)).numpy()
        x_jax = np.asarray(jmin.solve_possibly_underdetermined(
            jnp.asarray(A), jnp.asarray(b)))
        along = [abs(float(Q[:, 0] @ x)) for x in (x_port, x_jax)]
        # kept, the weak direction's component is b·q/w, about 1e6 here
        assert all((a > 1e3) == kept for a in along), along
