"""The port's copy of the part of `jax.random` that quantized training uses.

JAX's default generator is threefry2x32 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011).  The quantized trainer draws its
stochastic-rounding noise with `jax.random.uniform(key, (n,), float32)`
under a key from `PRNGKey(seed)` and `fold_in`, so the port must give the
same bits to give the same gradient codes.  This module computes them with
integer torch ops: each uint32 lane is held in an int64 tensor (or a Python
int) and masked to 32 bits after every add and shift, since torch's uint32
arithmetic is thin.

The layout of the counters follows JAX with `jax_threefry_partitionable`
on (its default): element i of an (n,) draw hashes the 64-bit counter i,
split into a (high, low) pair of 32-bit words, and the two output words are
XOR'd into one 32-bit draw.  The float is jax.random._uniform's: the top 23
bits as the mantissa of a float in [1, 2), minus 1.

A key is a (k1, k2) pair of Python ints.
"""
from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 block (20 rounds, key injections every 4) on one
    counter pair or on int64 tensors of counter pairs; words in [0, 2^32)."""
    ks = (k1 & M32, k2 & M32, (k1 ^ k2 ^ _PARITY) & M32)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey for a seed in [0, 2^32): (high word, low word)."""
    seed = int(seed)
    if not 0 <= seed <= M32:
        raise ValueError("seed must be in [0, 2^32), got %d" % seed)
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in: hash the counter pair (0, data) under key."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32) in [0, 1), bit for bit: the
    32-bit draw of element i hashes the counter pair (0, i)."""
    if n >= 1 << 32:
        raise ValueError("draws of 2^32 or more values are not supported")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
