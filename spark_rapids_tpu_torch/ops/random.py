"""Counter-based random numbers: threefry2x32 in plain torch.

The JAX package draws ``rand()`` from ``jax.random`` (``expr/misc.Rand``):
``uniform(fold_in(PRNGKey(seed), row_offset), (capacity,), float64)``
under ``jax_threefry_partitionable`` (jax 0.9's default). This module is
that stream bit for bit, so the port's column equals the reference's:

- ``threefry2x32(k0, k1, x0, x1)``: the 20-round Threefry-2x32 hash with
  jax's rotations and key schedule;
- ``prng_key(seed)``: the 64-bit seed split into its high and low words
  (``threefry_seed``);
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
- ``random_bits64(key, n)``: the partitionable layout, counter ``i``
  hashed as ``(0, i)``, the two output words as the high and low halves;
- ``uniform(key, n)``: the top 52 bits as the mantissa of a double in
  [1, 2), minus 1.

Words are int64 lanes masked to 32 bits (CUDA torch lacks some uint32
shifts); the same functions take Python ints, which derive the key on the
host. A draw is elementwise torch ops on the device its counters live on.
The reference has no Pallas kernel here, so there is none to port.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3FF0000000000000       # 1.0 as a double's bits


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (ints or
    int64 tensors of 32-bit values) under the key ``(k0, k1)``."""
    ks = (k0 & MASK, k1 & MASK, (k0 ^ k1 ^ _PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``PRNGKey(seed)`` of a 64-bit seed: (high word, low word)."""
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"rand: seed {seed} does not fit in 64 bits")
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key: tuple, data: int) -> tuple:
    """``fold_in(key, data)`` for a 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def random_bits64(key: tuple, n: int, device) -> torch.Tensor:
    """``n`` 64-bit draws as int64 (two's complement of the uint64)."""
    x0 = torch.zeros((n,), dtype=torch.int64, device=device)
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key[0], key[1], x0, x1)
    return (hi << 32) | lo


def uniform(key: tuple, n: int, device) -> torch.Tensor:
    """``n`` float64 draws in [0, 1): the top 52 bits of each 64-bit draw
    as the mantissa of a double in [1, 2), minus 1."""
    mant = (random_bits64(key, n, device) >> 12) & ((1 << 52) - 1)
    return (mant | _ONE_BITS).view(torch.float64) - 1.0
