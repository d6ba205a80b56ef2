"""JAX's threefry2x32 PRNG in plain uint32 numpy: the draws the games'
initial states make (``PRNGKey``, ``split``, ``uniform``), so a seed gives
the same level in the port as in the JAX package, bit for bit.

This is the form JAX 0.9 uses by default (``jax_default_prng_impl`` =
``threefry2x32``, ``jax_threefry_partitionable`` = True): ``split(key, n)``
runs the block function on the counters (0, 0..n-1) and returns the pairs
of output words; ``uniform`` takes the xor of the two output words of the
counters (0, 0..size-1), keeps their top 23 bits as the mantissa of a float
in [1, 2), subtracts 1 and scales with one fused multiply-add, as XLA's CPU
backend compiles it.  (The older, non-partitionable form draws other
numbers from the same key.)
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The 20-round threefry-2x32 block function of (x0, x1) under the key
    (k0, k1), elementwise (uint32 arrays)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF) as
    uint32 (a 32-bit seed: (0, seed))."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32-bit ``jax.random.bits``: the xor of the block function's two
    words on the counters 0..size-1."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA's CPU backend fuses floats * (hi - lo) + lo into one multiply-add:
    # the product of two floats is exact in float64, and so is its sum with
    # lo at these magnitudes, so one rounding to float32 follows
    fused = (floats.astype(np.float64) * np.float64(hi - lo)
             + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused)
