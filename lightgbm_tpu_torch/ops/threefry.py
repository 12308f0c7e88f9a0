"""The port's copy of the part of `jax.random` that quantized training and
GOSS use.

JAX's default generator is threefry2x32 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011).  The quantized trainer draws its
stochastic-rounding noise with `jax.random.uniform(key, (n,), float32)`
under a key from `PRNGKey(seed)` and `fold_in`, so the port must give the
same bits to give the same gradient codes.  GOSS draws its rows with
`jax.random.uniform` under keys from a chain of `jax.random.split`
(lightgbm_tpu/models/goss.py:49, :78).  This module computes them with
integer torch ops: each uint32 lane is held in an int64 tensor (or a Python
int) and masked to 32 bits after every add and shift, since torch's uint32
arithmetic is thin.

The layout of the counters follows JAX with `jax_threefry_partitionable`
on (its default): element i of an (n,) draw hashes the 64-bit counter i,
split into a (high, low) pair of 32-bit words, and the two output words are
XOR'd into one 32-bit draw.  The float is jax.random._uniform's: the top 23
bits as the mantissa of a float in [1, 2), minus 1.

A key is a (k1, k2) pair of Python ints, or, for `uniform`, the same two
words in an int64 [2] tensor on the device, so that a captured CUDA graph
reads the key of each round from a buffer instead of baking it in.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[Tuple[int, int], torch.Tensor]


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


def split(key: Tuple[int, int], num: int = 2) -> List[Tuple[int, int]]:
    """jax.random.split with partitionable threefry
    (`jax._src.prng._threefry_split_foldlike`): key i hashes the counter
    pair (0, i), so it equals fold_in(key, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32) in [0, 1), bit for bit: the
    32-bit draw of element i hashes the counter pair (0, i).  key: a pair
    of ints, or an int64 [2] tensor holding them (on the draw's device,
    which it then sets), read by the same integer ops without a host
    read."""
    if n >= 1 << 32:
        raise ValueError("draws of 2^32 or more values are not supported")
    if isinstance(key, torch.Tensor):
        if key.dtype != torch.int64 or tuple(key.shape) != (2,):
            raise ValueError("a tensor key is int64 [2], got %s %s"
                             % (key.dtype, tuple(key.shape)))
        device = key.device
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
