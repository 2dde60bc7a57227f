"""The port's CUDA kernels against their plain torch versions on the
card, at small and ragged shapes (chip_smoke.py covers the storm's).
Needs a card, so every test is marked ``cuda`` and skips without one.
The machine with the card has no JAX, so this file imports none and
runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.sim import gaps, packed, pswim, rng
from corrosion_tpu_torch.sim.round import RunMetrics
from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kernels.build_all()
    return torch.device("cuda")


def _i32(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                           device=dev)


def _words(g, shape, dev):
    return _i32(g.integers(0, 1 << 32, shape, dtype=np.uint32).view(np.int32),
                dev)


def _tables(g, n, m):
    ids = np.arange(m)[None, :] + m * g.integers(0, (n + m - 1) // m, (n, m))
    pid = np.where((ids < n) & (g.random((n, m)) > 0.2), ids, -1)
    key = g.integers(0, 2047, (n, m)) * 4 + g.integers(0, 3, (n, m))
    pkey = np.where(pid >= 0, key, -1)
    psince = np.where(g.random((n, m)) < 0.5, g.integers(0, 30, (n, m)), -1)
    return pid, pkey, psince


@pytest.mark.parametrize("n", (1, 257, 3000))
@pytest.mark.parametrize("count", (1, 3))
def test_sample_targets(card, n, count):
    g = np.random.default_rng(n + count)
    pid, pkey, _ = _tables(g, n, 64)
    table = pswim._pack_tables(_i32(pid, card), _i32(pkey, card))
    slots = _i32(g.integers(0, 64, (4 * count, n)), card)
    before = kernels.SAMPLE_TARGETS.launches
    got = pswim.sample_candidates(table, slots, count)
    assert kernels.SAMPLE_TARGETS.launches == before + 1
    assert torch.equal(got, pswim.sample_candidates_plain(table, slots, count))


@pytest.mark.parametrize("n, w, f", ((5, 1, 3), (1000, 16, 3), (333, 8, 2)))
def test_broadcast_scatter(card, n, w, f):
    g = np.random.default_rng(n)
    ring = _words(g, (2, n, w), card)
    sending = _words(g, (n, w), card)
    dst = _i32(g.integers(0, n, n * f), card)
    slot = _i32(g.integers(0, 2, n * f), card)
    ok = torch.as_tensor(g.random(n * f) < 0.8, device=card)
    got, want = ring.clone(), ring.clone()
    packed.scatter_sending(got, sending, dst, slot, ok, f)
    packed.scatter_sending_plain(want, sending, dst, slot, ok, f)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n, w, s", ((7, 1, 3), (1000, 16, 3), (301, 8, 5)))
def test_sync_pull(card, n, w, s):
    g = np.random.default_rng(n)
    masks = _words(g, (n, 4, w), card)
    miss = _words(g, (n, w), card)
    peers = _i32(g.integers(0, n, (n, s)), card)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=card)
    slot0 = _words(g, (n, w), card)  # OR keeps what the slot held
    got_slot, want_slot = slot0.clone(), slot0.clone()
    got = packed.sync_pull(masks, miss, peers, ok, got_slot)
    want = packed.sync_pull_plain(masks, miss, peers, ok, want_slot)
    assert torch.equal(got, want) and torch.equal(got_slot, want_slot)


@pytest.mark.parametrize("n, e", ((3, 0), (300, 5000), (2000, 60000)))
def test_merge_entries(card, n, e):
    g = np.random.default_rng(n)
    pid, pkey, psince = _tables(g, n, 64)
    e_dst = g.integers(0, max(1, n // 4), e)
    picked = pid[e_dst, g.integers(0, 64, e)]
    e_id = np.where((g.random(e) < 0.5) & (picked >= 0), picked,
                    g.integers(0, n, e))
    e_key = g.integers(0, 2047, e) * 4 + g.integers(0, 3, e)
    args = (
        _i32(pid, card), _i32(pkey, card), _i32(psince, card),
        _i32(e_dst, card), _i32(e_id, card), _i32(e_key, card),
        torch.as_tensor(g.random(e) < 0.8, device=card), 40, 12,
    )
    got = pswim.merge_entries(*args)
    want = pswim.merge_entries_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _launched(kernel, before):
    assert kernel.launches == before + 1, f"{kernel.name} did not launch"


@pytest.mark.parametrize("seed", (0, 7))
def test_threefry_split_bits_fold_in(card, seed):
    key = rng.prng_key(seed, card)
    for num in (1, 2, 11):
        before = kernels.THREEFRY.launches
        got = rng.split(key, num)
        _launched(kernels.THREEFRY, before)
        assert torch.equal(got, rng.split_plain(key, num))
    sub = rng.split(key, 3)[1]  # a key that is a view of a [3, 2] tensor
    for shape in ((1,), (257,), (12, 1001), (100_003,)):
        before = kernels.THREEFRY.launches
        got = rng.bits(sub, shape)
        _launched(kernels.THREEFRY, before)
        assert got.shape == shape
        assert torch.equal(got, rng.bits_plain(sub, shape))
    for data in (0, 103, 2**32 - 1):
        before = kernels.THREEFRY.launches
        got = rng.fold_in(key, data)
        _launched(kernels.THREEFRY, before)
        assert torch.equal(got, rng.fold_in_plain(key, data))


@pytest.mark.parametrize("shape", ((1,), (257,), (12, 3001)))
@pytest.mark.parametrize("minval, maxval", (
    (0, 64), (0, 100_000), (0, 262_144), (1, 65_537), (0, 1), (1, 1),
    (5, -3), (-7, 2**31 + 9),
))
def test_randint_scalar(card, shape, minval, maxval):
    """Spans above 2^16 take the u32 wrap of test_randint_u32_wrap."""
    key = rng.split(rng.prng_key(3, card), 2)[1]
    before = kernels.RANDINT.launches
    got = rng.randint(key, shape, minval, maxval)
    _launched(kernels.RANDINT, before)
    assert got.dtype == torch.int32
    assert torch.equal(got, rng.randint_plain(key, shape, minval, maxval))


@pytest.mark.parametrize("dtype", (torch.int32, torch.int64))
@pytest.mark.parametrize("n", (1, 255, 100_000))
def test_randint_per_element(card, dtype, n):
    """The rearm's per-element maxval, with entries at and below minval
    and, in int64, above the int32 range."""
    g = np.random.default_rng(n)
    hi = g.integers(-2, 40, n)
    if dtype == torch.int64:
        hi = np.where(g.random(n) < 0.1, 2**31 + g.integers(0, 9, n), hi)
    maxval = torch.as_tensor(hi, dtype=dtype, device=card)
    key = rng.prng_key(9, card)
    before = kernels.RANDINT.launches
    got = rng.randint(key, (n,), 1, maxval)
    _launched(kernels.RANDINT, before)
    assert torch.equal(got, rng.randint_plain(key, (n,), 1, maxval))


def _bits_words(g, n, p, p_bit, dev):
    bits = g.random((n, p // 32, 32)) < p_bit
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return _i32(w.astype(np.uint32).view(np.int32), dev)


@pytest.mark.parametrize("n", (1, 257, 3000))
@pytest.mark.parametrize("c, a, v, k, p_bit", (
    (1, 16, 32, 8, 0.6), (4, 16, 8, 2, 0.2), (4, 16, 8, 8, 0.2),
    (32, 2, 16, 3, 0.03), (2, 3, 32, 4, 0.4),
))
def test_gaps_refresh(card, n, c, a, v, k, p_bit):
    cfg = SimConfig(n_nodes=n, n_payloads=a * v * c, n_writers=a,
                    chunks_per_version=c, gap_slots=k)
    g = np.random.default_rng(n + c)
    have = _bits_words(g, n, cfg.n_payloads, p_bit, card)
    before = kernels.GAPS_REFRESH.launches
    got = gaps.refresh_gaps(have, cfg)
    _launched(kernels.GAPS_REFRESH, before)
    for x, y in zip(got, gaps.refresh_gaps_plain(have, cfg)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _storm_cfg(n, p=512):
    return SimConfig(n_nodes=n, n_payloads=p, n_writers=16,
                     chunks_per_version=4, max_transmissions=10)


@pytest.mark.parametrize("n", (1, 255, 257, 3000))
@pytest.mark.parametrize("t", (3, 14, 20))
def test_converge_record(card, n, t):
    cfg = _storm_cfg(n)
    meta = uniform_payloads(cfg, card, inject_every=2)
    g = np.random.default_rng(n + t)
    w = cfg.n_payloads // 32
    full = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    holes = _bits_words(g, n, cfg.n_payloads, 0.97, "cpu").numpy()
    rows = g.random(n) < 0.3
    full[rows] &= holes.view(np.uint32)[rows]
    have = _i32(full.view(np.int32), card)
    inj = _bits_words(g, 1, cfg.n_payloads, 0.9, card)[0]
    alive = torch.as_tensor((g.random(n) < 0.2) * 2, dtype=torch.uint8,
                            device=card)
    p = cfg.n_payloads
    metrics = RunMetrics(
        coverage_at=_i32(np.where(g.random(p) < 0.3, 1, -1), card),
        converged_at=_i32(np.where(g.random(n) < 0.3, 2, -1), card),
        overflow_frac=torch.zeros((), device=card),
        order_violations=torch.zeros((), dtype=torch.int32, device=card),
    )
    before = kernels.CONVERGE_ROWS.launches
    got = packed.converge_record(have, inj, alive, metrics, meta, t, cfg)
    _launched(kernels.CONVERGE_ROWS, before)
    want = packed.converge_record_plain(have, inj, alive, metrics, meta, t,
                                        cfg)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _carry(g, n, w, d, dev):
    return packed.PackedCarry(
        have=_words(g, (n, w), dev), inflight=_words(g, (d, n, w), dev),
        relay=packed.Planes(*(_words(g, (n, w), dev) for _ in range(4))),
        sync_buf=_words(g, (d, n, w), dev),
    )


def _clone(c):
    return packed.PackedCarry(
        have=c.have.clone(), inflight=c.inflight.clone(),
        relay=packed.Planes(*(p.clone() for p in c.relay)),
        sync_buf=c.sync_buf.clone(),
    )


def _assert_carry_equal(a, b):
    assert torch.equal(a.have, b.have)
    assert torch.equal(a.inflight, b.inflight)
    assert torch.equal(a.sync_buf, b.sync_buf)
    for x, y in zip(a.relay, b.relay):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", (1, 257, 3000))
@pytest.mark.parametrize("t", (0, 4, 99))  # 99: no payload injects
def test_word_inject(card, n, t):
    cfg = _storm_cfg(n)
    meta = uniform_payloads(cfg, card, inject_every=2)
    g = np.random.default_rng(n + t)
    c0 = _carry(g, n, cfg.n_payloads // 32, 2, card)
    inj0 = _words(g, (cfg.n_payloads // 32,), card)
    alive = torch.as_tensor((g.random(n) < 0.3) * 2, dtype=torch.uint8,
                            device=card)
    got, want = _clone(c0), _clone(c0)
    got_inj, want_inj = inj0.clone(), inj0.clone()
    before = kernels.WORD_INJECT.launches
    packed.inject_packed(got, got_inj, t, meta, cfg, alive)
    _launched(kernels.WORD_INJECT, before)
    packed.inject_packed_plain(want, want_inj, t, meta, cfg, alive)
    _assert_carry_equal(got, want)
    assert torch.equal(got_inj, want_inj)


@pytest.mark.parametrize("n, w, f", ((1, 16, 3), (257, 16, 3), (3000, 8, 2)))
def test_word_spend(card, n, w, f):
    g = np.random.default_rng(n)
    c0 = _carry(g, n, w, 2, card)
    inj = _words(g, (w,), card)
    me = np.arange(n)[:, None]
    targets = np.where(g.random((n, f)) < 0.3, -1, g.integers(0, n, (n, f)))
    targets = np.where(g.random((n, f)) < 0.2, me, targets)
    targets[: n // 3] = -1  # rows that attempt nothing
    targets = _i32(targets, card)
    alive = torch.as_tensor((g.random(n) < 0.2) * 2, dtype=torch.uint8,
                            device=card)
    got, want = _clone(c0), _clone(c0)
    before = kernels.WORD_SPEND.launches
    sent = packed.spend_relay(got, inj, targets, alive)
    _launched(kernels.WORD_SPEND, before)
    want_sent = packed.spend_relay_plain(want, inj, targets, alive)
    assert torch.equal(sent, want_sent)
    _assert_carry_equal(got, want)


@pytest.mark.parametrize("n, w, d", ((1, 16, 2), (257, 16, 2), (3000, 8, 4)))
@pytest.mark.parametrize("t", (0, 3))
def test_word_deliver(card, n, w, d, t):
    cfg = SimConfig(n_nodes=n, n_payloads=w * 32, max_transmissions=10)
    g = np.random.default_rng(n + t)
    c0 = _carry(g, n, w, d, card)
    got, want = _clone(c0), _clone(c0)
    before = kernels.WORD_DELIVER.launches
    packed.deliver_packed(got, t, cfg)
    _launched(kernels.WORD_DELIVER, before)
    packed.deliver_packed_plain(want, t, cfg)
    _assert_carry_equal(got, want)
