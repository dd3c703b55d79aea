"""JAX's threefry random draws in torch integer ops (the port's copy of what
it needs from ``jax.random``, with ``jax_threefry_partitionable`` on, its
default, and without ``jax_enable_x64``).

A key is a pair ``(k0, k1)`` of uint32 values: Python ints for one key, or
int64 tensors of one shape for several keys at once (a batch's scans).
Every value is a uint32 held in an int64 and masked to 32 bits after each
add and shift, so the CPU and the card run the same integer code and give
the same bits as JAX.

- :func:`prng_key` is ``jax.random.PRNGKey`` (a seed's low 32 bits, as JAX
  keeps them without x64);
- :func:`fold_in` is ``jax.random.fold_in``;
- :func:`uniform` is ``jax.random.uniform(key, (n,))`` in [0, 1). Its values
  are prefix-stable: the draw of n values is the first n of a longer one.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["prng_key", "fold_in", "uniform", "threefry2x32"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds of the key (k0, k1) over the counter
    words (x0, x1), which broadcast like tensors."""
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


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: (0, the seed's low 32 bits)."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` → float32 [n], or [B, n] for a key
    of B-element tensors, on ``device`` (the key tensors' by default)."""
    k0, k1 = key
    if isinstance(k0, torch.Tensor):
        device = k0.device if device is None else device
        k0 = k0.to(device=device, dtype=torch.int64)[..., None]
        k1 = k1.to(device=device, dtype=torch.int64)[..., None]
    i = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k0, k1, i >> 32, i & MASK)
    bits = ((a ^ b) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
