"""jax 0.9's threefry2x32 PRNG in plain torch (partitionable mode).

Bit-for-bit the draws ``jax.random`` makes with
``jax_threefry_partitionable=True`` (jax/_src/prng.py ``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``; jax/_src/random.py
``_randint``).  A key is an int64 tensor of shape ``[2]`` holding the
two u32 halves; there is no global generator.

`uniform` and `bernoulli` are jax's f32 transforms of a `bits` draw
(``_uniform``, ``_bernoulli`` in its default mode "low").

On a key that lies on the card, `split`, `fold_in`, `bits` and
`randint` each launch K5 (``kernels/csrc/threefry.cu``), which reads the
key through its pointer: no draw copies a key to the host.  On a CPU key
they run the plain versions below, whose arithmetic runs on int64
carriers masked to 32 bits after every operation.  That matters beyond
style: ``randint`` squares ``2^16 % span`` *in u32*, which wraps before
its ``% span`` — at span = 100000 an unmasked int64 product gives a
different multiplier and wrong draws for every node-range draw.  The
kernel computes in ``uint32_t`` and gets the wrap for free.

Counters are ``iota_2x32_shape``: the high word is 0 and the low word
the flat index, so shapes stay below 2^31 elements (the kernels' int
sizes; jax's own limit is 2^32).

The lane entries (`split_lanes`, `fold_in_lanes`, `bits_lanes`,
`randint_lanes`) are ``jax.vmap`` of the same draws over a batch of
keys ``[K, 2]``, for the seed ensembles: lane k's draw is the solo draw
under key k, its counters 0 … n − 1 like every other lane's.  On the
card each is one launch of K5's lane entry for all K lanes.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import torch

from .. import kernels
from ..device import MASK32, i32
from ..kernels.build import check

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of counter pairs (x1, x2) under key
    (k1, k2): int64 tensors (or ints) holding u32 values.  The plain
    versions' hash; the kernels' is ``kernels/csrc/threefry.cuh``."""
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


def _size(shape: Sequence[int]) -> int:
    size = math.prod(shape)
    if size >= 1 << 31:
        raise ValueError("counter shapes must stay below 2^31 elements")
    return size


def _hash_counts(key: torch.Tensor, size: int, base: int = 0):
    lo = (torch.arange(size, dtype=torch.int64, device=key.device)
          + base) & MASK32
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def _threefry(key: torch.Tensor, size: int, base: int, pairs: bool):
    """K5's hash entry: int64 ``[size, 2]`` pairs (``pairs``) or ``[size]``
    xors of the hashes of counters ``base + i``."""
    check("key", key, torch.int64, (2,))
    shape = (size, 2) if pairs else (size,)
    out = torch.empty(shape, dtype=torch.int64, device=key.device)
    if size:
        kernels.THREEFRY.launch([key, out], [size, i32(base), int(pairs)])
    return out


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    b1, b2 = _hash_counts(key, _size((num,)))
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64 ``[num, 2]``."""
    if key.device.type == "cpu":
        return split_plain(key, num)
    return _threefry(key, _size((num,)), 0, True)


def fold_in_plain(key: torch.Tensor, data: int) -> torch.Tensor:
    b1, b2 = _hash_counts(key, 1, data & MASK32)
    return torch.cat([b1, b2])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``."""
    if key.device.type == "cpu":
        return fold_in_plain(key, data)
    return _threefry(key, 1, data & MASK32, True).reshape(2)


def bits_plain(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    b1, b2 = _hash_counts(key, _size(shape))
    return (b1 ^ b2).reshape(tuple(shape))


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2^32)."""
    if key.device.type == "cpu":
        return bits_plain(key, shape)
    return _threefry(key, _size(shape), 0, False).reshape(tuple(shape))


_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)


def _check_minval(minval: int) -> None:
    if not _I32_MIN < minval <= _I32_MAX:
        # minval = int32 min with an out-of-range maxval is jax's span
        # 2^32, which wraps to 0 — no caller draws over the whole range
        raise ValueError(f"minval {minval} outside (-2^31, 2^31)")


def _span_multiplier(hi: torch.Tensor, minval: int):
    """jax _randint's span and u32 multiplier for int64 maxvals ``hi``."""
    hi_out_of_range = hi > _I32_MAX
    hi = hi.clamp(_I32_MIN, _I32_MAX)
    span = (hi - minval) & MASK32
    span = torch.where(hi <= minval, torch.ones_like(span), span)
    span = torch.where(
        hi_out_of_range & (hi > minval), (span + 1) & MASK32, span
    )
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    return span, _mul32(multiplier, multiplier) % span


def randint_plain(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: Union[int, torch.Tensor],
) -> torch.Tensor:
    _check_minval(minval)
    if isinstance(maxval, torch.Tensor):
        hi = maxval.to(torch.int64)
    else:  # a fill, not a host copy: the plain draws stay graph-capturable
        hi = torch.full((), int(maxval), dtype=torch.int64, device=key.device)
    span, multiplier = _span_multiplier(hi, minval)
    k = split_plain(key, 2)
    higher = bits_plain(k[0], shape)
    lower = bits_plain(k[1], shape)
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    offset = offset % span
    return (minval + offset).to(torch.int32)


def randint_at_plain(key: torch.Tensor, idx: torch.Tensor, minval: int,
                     maxval: int) -> torch.Tensor:
    """The draws of ``randint(key, shape, minval, maxval)`` at the flat
    element indices ``idx`` (int64) of ``shape``, without drawing the
    rest: element i's draw hashes counter i under each half of the split
    key, whatever the shape."""
    _check_minval(minval)
    span, mult = scalar_span(minval, int(maxval))
    k = split_plain(key, 2)
    ctr = idx & MASK32
    zeros = torch.zeros_like(ctr)
    h1, h2 = threefry2x32(k[0][0], k[0][1], zeros, ctr)
    l1, l2 = threefry2x32(k[1][0], k[1][1], zeros, ctr)
    offset = (_mul32((h1 ^ h2) % span, mult) + (l1 ^ l2) % span) & MASK32
    return (minval + offset % span).to(torch.int32)


@functools.lru_cache(maxsize=None)
def scalar_span(minval: int, maxval: int):
    """`_span_multiplier` of a scalar maxval as host ints, for K5 and
    K10's jitter stream (once per (minval, maxval): the round draws the
    same spans every time)."""
    span, mult = _span_multiplier(torch.tensor(maxval, dtype=torch.int64),
                                  minval)
    return int(span), int(mult)


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: Union[int, torch.Tensor],
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``;
    ``maxval`` is an int or an integer tensor broadcastable to
    ``shape``.  Returns int32.  On the card one K5 launch draws it all."""
    if key.device.type == "cpu":
        return randint_plain(key, shape, minval, maxval)
    _check_minval(minval)
    shape = tuple(shape)
    size = _size(shape)
    check("key", key, torch.int64, (2,))
    out = torch.empty(shape, dtype=torch.int32, device=key.device)
    if not size:
        return out
    if isinstance(maxval, torch.Tensor):
        if maxval.dtype not in (torch.int32, torch.int64):
            raise TypeError(
                f"maxval must be int32 or int64, got {maxval.dtype}"
            )
        hi = maxval.expand(shape).contiguous()
        check("maxval", hi, hi.dtype, shape)
        per_element = 1 if hi.dtype == torch.int32 else 2
        span = mult = 0
    else:
        hi, per_element = None, 0
        span, mult = scalar_span(minval, int(maxval))
    kernels.RANDINT.launch(
        [key, hi, out], [size, minval, i32(span), i32(mult), per_element]
    )
    return out


def uniform(
    key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of each u32 draw OR'd into 1.0f's bit pattern, bitcast,
    then ``- 1``, the scale and ``max(minval, ...)`` in f32."""
    float_bits = (bits(key, shape) >> 9) | 0x3F800000  # < 2^31: fits i32
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (f32, mode "low"): ``uniform(key, shape) < p``."""
    return uniform(key, shape) < torch.tensor(
        p, dtype=torch.float32, device=key.device
    )


# -- lane entries (jax.vmap over a [K, 2] key batch) -------------------------


def _hash_counts_lanes(keys: torch.Tensor, size: int, base=0):
    """Lane k hashes counters base[k] + i (``base`` an int or a [K]
    tensor) under key k."""
    if isinstance(base, torch.Tensor):
        base = base.to(torch.int64).reshape(-1, 1)
    lo = (torch.arange(size, dtype=torch.int64, device=keys.device)[None, :]
          + base) & MASK32
    lo = lo.expand(keys.shape[0], size)
    return threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)


def _threefry_lanes(keys: torch.Tensor, size: int, base: int, pairs: bool):
    """K5's lane hash entry: int64 ``[K, size, 2]`` pairs or ``[K, size]``
    xors, lane k under key k with counters ``base + i``."""
    lanes = keys.shape[0]
    check("keys", keys, torch.int64, (lanes, 2))
    shape = (lanes, size, 2) if pairs else (lanes, size)
    out = torch.empty(shape, dtype=torch.int64, device=keys.device)
    if size and lanes:
        kernels.THREEFRY_LANES.launch(
            [keys, out], [size, i32(base), int(pairs), lanes])
    return out


def split_lanes_plain(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    b1, b2 = _hash_counts_lanes(keys, _size((num,)))
    return torch.stack([b1, b2], dim=-1)


def split_lanes(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``vmap(jax.random.split)`` over keys ``[K, 2]``: ``[K, num, 2]``."""
    if keys.device.type == "cpu":
        return split_lanes_plain(keys, num)
    return _threefry_lanes(keys, _size((num,)), 0, True)


def fold_in_lanes_plain(keys: torch.Tensor, data) -> torch.Tensor:
    """``data`` an int, or a [K] tensor folding lane k's own value (the
    lanes' plan seeds)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    b1, b2 = _hash_counts_lanes(keys, 1, data & MASK32)
    return torch.cat([b1, b2], dim=1)


def fold_in_lanes(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``vmap(jax.random.fold_in)`` of one ``data`` over keys ``[K, 2]``."""
    if keys.device.type == "cpu":
        return fold_in_lanes_plain(keys, data)
    return _threefry_lanes(keys, 1, data & MASK32, True).reshape(-1, 2)


def bits_lanes_plain(keys: torch.Tensor, shape: Sequence[int]):
    b1, b2 = _hash_counts_lanes(keys, _size(shape))
    return (b1 ^ b2).reshape(keys.shape[0], *shape)


def bits_lanes(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``vmap(jax.random.bits)`` over keys ``[K, 2]``: int64
    ``[K, *shape]`` in [0, 2^32)."""
    if keys.device.type == "cpu":
        return bits_lanes_plain(keys, shape)
    return _threefry_lanes(keys, _size(shape), 0, False).reshape(
        keys.shape[0], *shape)


def randint_lanes_plain(keys: torch.Tensor, shape: Sequence[int],
                        minval: int, maxval) -> torch.Tensor:
    _check_minval(minval)
    lanes = keys.shape[0]
    shape = tuple(shape)
    if isinstance(maxval, torch.Tensor):
        hi = maxval.to(torch.int64).expand(lanes, *shape)
    else:
        hi = torch.full((), int(maxval), dtype=torch.int64,
                        device=keys.device)
    span, multiplier = _span_multiplier(hi, minval)
    k = split_lanes_plain(keys, 2)
    higher = bits_lanes_plain(k[:, 0], shape)
    lower = bits_lanes_plain(k[:, 1], shape)
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    offset = offset % span
    return (minval + offset).to(torch.int32)


def randint_lanes(keys: torch.Tensor, shape: Sequence[int], minval: int,
                  maxval) -> torch.Tensor:
    """``vmap(jax.random.randint)`` over keys ``[K, 2]``: int32
    ``[K, *shape]``; ``maxval`` an int or an integer tensor broadcastable
    to ``[K, *shape]``.  One launch of K5's lane entry on the card."""
    if keys.device.type == "cpu":
        return randint_lanes_plain(keys, shape, minval, maxval)
    _check_minval(minval)
    lanes = keys.shape[0]
    shape = tuple(shape)
    size = _size(shape)
    check("keys", keys, torch.int64, (lanes, 2))
    out = torch.empty((lanes, *shape), dtype=torch.int32, device=keys.device)
    if not size or not lanes:
        return out
    if isinstance(maxval, torch.Tensor):
        if maxval.dtype not in (torch.int32, torch.int64):
            raise TypeError(
                f"maxval must be int32 or int64, got {maxval.dtype}"
            )
        hi = maxval.expand(lanes, *shape).contiguous()
        per_element = 1 if hi.dtype == torch.int32 else 2
        span = mult = 0
    else:
        hi, per_element = None, 0
        span, mult = scalar_span(minval, int(maxval))
    kernels.RANDINT_LANES.launch(
        [keys, hi, out],
        [size, minval, i32(span), i32(mult), per_element, lanes])
    return out
