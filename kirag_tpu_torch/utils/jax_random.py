"""JAX's default random draws, restated in numpy.

The reference package draws some random choices with ``jax.random`` (the
16 rows that start its k-means, ``kirag_tpu/ops/pq.py``). The port runs
where JAX is absent, so it states the same draw here: the Threefry-2x32
hash (Random123's, 20 rounds, as ``jax._src.prng`` applies it), the key of
an integer seed, ``split`` and 32-bit ``random_bits`` in their
partitionable form (``jax_threefry_partitionable``, the default since JAX
0.5), and ``permutation``'s rounds of stable sorts by fresh random keys.
Everything is uint32 arithmetic modulo 2^32, so the draws are JAX's bit for
bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter pairs (x0, x1) under ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s raw data for a seed in [0, 2^32): the high
    and low 32 bits of the seed."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: key i is the hash of the counter (0, i)."""
    b0, b1 = threefry2x32(k, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def random_bits32(k: np.ndarray, n: int) -> np.ndarray:
    """``n`` 32-bit words of ``jax.random.bits(k, (n,))``: the two halves
    of the hash of the counter (0, i), XORed."""
    b0, b1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return b0 ^ b1


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: ``arange(n)`` sorted stably by fresh
    random 32-bit keys, ceil(3 ln n / ln(2^32 - 1)) times."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x


def choice_without_replacement(seed: int, n: int, draws: int) -> np.ndarray:
    """``jax.random.choice(jax.random.key(seed), n, (draws,), replace=False)``."""
    if draws > n:
        raise ValueError(f"cannot draw {draws} of {n} without replacement")
    return permutation(key(seed), n)[:draws]
