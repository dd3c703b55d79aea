"""JAX's threefry-2x32 draws in plain torch integer operations, frozen.

The configurations' ``RandomSampling`` and ``SamplingSurfaceNormal`` keep a
row where its draw lies under the filter's probability; the draw is
``jax.random.uniform`` of a key folded from the seed (with
``jax_threefry_partitionable`` on, JAX's default, and 32-bit keys). This is
an independent copy of that arithmetic, so the reference can make the same
draws without importing the program: every value is a uint32 held in an
int64 and masked to 32 bits after each add and shift.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, key (k0, k1) over counter words (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` without x64: (0, low 32 bits)."""
    return 0, int(seed) & MASK


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def uniform(key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in [0, 1) → float32 [n] on the CPU."""
    k0, k1 = key
    i = torch.arange(n, dtype=torch.int64)
    a, b = threefry2x32(k0, k1, i >> 32, i & MASK)
    bits = ((a ^ b) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def chain_draw(seed: int, stream, filter_index: int, n: int) -> torch.Tensor:
    """The draw of filter ``filter_index`` of a chain keyed
    ``fold_in(PRNGKey(seed), stream)`` over ``n`` rows. A map chain is keyed
    by stream 1; a served scan's chain by its position in its call."""
    key = fold_in(fold_in(prng_key(seed), stream), filter_index)
    return uniform(key, n)
