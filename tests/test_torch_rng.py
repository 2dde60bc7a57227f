"""The port's threefry2x32 (corrosion_tpu_torch/sim/rng.py) against
jax.random, exact: every draw is integer, so the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu_torch.sim import rng
from tests import torch_parity  # noqa: F401  (one intra-op thread)

SEEDS = (0, 7, 12345)
SHAPES = ((12, 100_000), (100_000, 8))


def _np(t):
    return t.cpu().numpy()


def test_threefry_partitionable_is_on():
    # the port implements the partitionable split/bits; a flip of this
    # jax default would change every draw of the reference
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS + (-1, 2**31 - 1))
def test_prng_key(seed):
    np.testing.assert_array_equal(
        np.asarray(jax.random.PRNGKey(seed)), _np(rng.prng_key(seed, "cpu"))
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 3, 4, 11))
def test_split(seed, num):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(key, num)),
        _np(rng.split(rng.prng_key(seed, "cpu"), num)),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", (0, 103, 104, 2**32 - 1))
def test_fold_in(seed, data):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(key, np.uint32(data))),
        _np(rng.fold_in(rng.prng_key(seed, "cpu"), data)),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    tkey = rng.split(rng.prng_key(seed, "cpu"), 3)[1]
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64),
        _np(rng.bits(tkey, shape)),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("span", (64, 8, 100_000, 262_144))
def test_randint_scalar_span(seed, shape, span):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(key, shape, 0, span, jnp.int32)),
        _np(rng.randint(rng.prng_key(seed, "cpu"), shape, 0, span)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_array_maxval(seed):
    # sync_packed's rearm: randint(k, (n,), 1, backoff + 1)
    backoff = np.random.default_rng(seed).integers(1, 33, 100_000)
    backoff = backoff.astype(np.int32)
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(
            key, (100_000,), 1, jnp.asarray(backoff) + 1, jnp.int32
        )),
        _np(rng.randint(
            rng.prng_key(seed, "cpu"), (100_000,), 1,
            torch.from_numpy(backoff) + 1,
        )),
    )


def test_randint_u32_wrap():
    """At span 100000 jax squares 2^16 % span = 65536 in u32, where it
    wraps to 0; an unwrapped product keeps a nonzero multiplier and draws
    other values.  The port must take the wrapped path."""
    span, shape = 100_000, (100_000,)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.randint(key, shape, 0, span, jnp.int32))
    got = _np(rng.randint(rng.prng_key(7, "cpu"), shape, 0, span))
    np.testing.assert_array_equal(want, got)

    k = rng.split(rng.prng_key(7, "cpu"), 2)
    hi = _np(rng.bits(k[0], shape)).astype(object)
    lo = _np(rng.bits(k[1], shape)).astype(object)
    mult = ((1 << 16) % span) ** 2 % span  # no u32 wrap: 65536^2 % span
    assert mult != 0
    unwrapped = np.array(
        [(h % span * mult + l % span) % span for h, l in zip(hi, lo)]
    )
    assert (unwrapped != want).mean() > 0.9


@pytest.mark.parametrize("minval, maxval", ((0, 1), (1, 2), (1, 1), (5, -3)))
def test_randint_span_of_one(minval, maxval):
    """A scalar span of 1, and maxval <= minval (jax's hi <= minval
    branch): every draw is minval, through the same hashes."""
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, (1000,), minval, maxval,
                                         jnp.int32))
    got = _np(rng.randint(rng.prng_key(11, "cpu"), (1000,), minval, maxval))
    np.testing.assert_array_equal(want, got)
    assert (got == minval).all()


def test_randint_array_maxval_at_or_below_minval():
    """Per-element maxval with entries at and below minval beside real
    spans (the rearm's shape with degenerate backoffs)."""
    g = np.random.default_rng(5)
    maxval = g.integers(-2, 40, 50_000).astype(np.int32)
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(key, (50_000,), 1, jnp.asarray(maxval),
                                      jnp.int32)),
        _np(rng.randint(rng.prng_key(5, "cpu"), (50_000,), 1,
                        torch.from_numpy(maxval))),
    )

