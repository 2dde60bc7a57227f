"""jax 0.9's threefry2x32 PRNG in plain torch (partitionable mode).

Bit-for-bit the draws ``jax.random`` makes with
``jax_threefry_partitionable=True`` (jax/_src/prng.py ``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``; jax/_src/random.py
``_randint``).  A key is an int64 tensor of shape ``[2]`` holding the
two u32 halves; there is no global generator.

All arithmetic runs on int64 carriers masked to 32 bits after every
operation, on the CPU and on the card alike.  That matters beyond
style: ``randint`` squares ``2^16 % span`` *in u32*, which wraps before
its ``% span`` — at span = 100000 an unmasked int64 product gives a
different multiplier and wrong draws for every node-range draw.

Counters are ``iota_2x32_shape``: the high word is 0 and the low word
the flat index, so shapes stay below 2^32 elements.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ..device import MASK32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of counter pairs (x1, x2) under key
    (k1, k2): int64 tensors (or ints) holding u32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 values, without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    return (((a_hi * b_lo + a_lo * b_hi) << 16) + a_lo * b_lo) & MASK32


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32-range seed: [0, seed]."""
    if not -(1 << 31) <= seed < 1 << 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _hash_counts(key: torch.Tensor, shape: Sequence[int]):
    size = math.prod(shape)
    if size >= 1 << 32:
        raise ValueError("counter shapes must stay below 2^32 elements")
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64 ``[num, 2]``."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``."""
    b1, b2 = threefry2x32(key[0], key[1], 0, data & MASK32)
    return torch.stack([b1, b2])


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2^32)."""
    b1, b2 = _hash_counts(key, tuple(shape))
    return (b1 ^ b2).reshape(tuple(shape))


_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: Union[int, torch.Tensor],
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``;
    ``maxval`` is an int or an integer tensor broadcastable to
    ``shape``.  Returns int32."""
    if not _I32_MIN < minval <= _I32_MAX:
        # minval = int32 min with an out-of-range maxval is jax's span
        # 2^32, which wraps to 0 — no caller draws over the whole range
        raise ValueError(f"minval {minval} outside (-2^31, 2^31)")
    hi = torch.as_tensor(maxval, device=key.device).to(torch.int64)
    hi_out_of_range = hi > _I32_MAX
    hi = hi.clamp(_I32_MIN, _I32_MAX)

    k = split(key, 2)
    higher = bits(k[0], shape)
    lower = bits(k[1], shape)

    span = (hi - minval) & MASK32
    span = torch.where(hi <= minval, torch.ones_like(span), span)
    span = torch.where(
        hi_out_of_range & (hi > minval), (span + 1) & MASK32, span
    )
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = _mul32(multiplier, multiplier) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    offset = offset % span
    return (minval + offset).to(torch.int32)
