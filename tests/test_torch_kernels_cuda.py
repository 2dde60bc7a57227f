"""The port's CUDA kernels against their plain torch versions on the
card, at small and ragged shapes (chip_smoke.py covers the storm's).
Needs a card, so every test is marked ``cuda`` and skips without one.
The machine with the card has no JAX, so this file imports none and
runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import kernels
from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
from corrosion_tpu_torch.sim import faults, gaps, packed, pswim, rng
from corrosion_tpu_torch.sim.round import RunMetrics
from corrosion_tpu_torch.sim.runner import storm_fault_plan
from corrosion_tpu_torch.sim.state import (
    SimConfig,
    init_state,
    uniform_payloads,
)
from tests import torch_merge_cases as merge_cases

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
@pytest.mark.parametrize("m", (64, 48))
def test_sample_targets(card, n, count, m):
    """K1 draws its buckets itself (no K5 launch) from the unpacked tables,
    with keys at the clamp (bit 31), repeated buckets and ids past
    2^19 - 1; at M = 48 randint's multiplier is not 0."""
    g = np.random.default_rng(n + count)
    pid, pkey, _ = _tables(g, n, m)
    pid, pkey = _smoke()._member_traps(g, _i32(pid, card), _i32(pkey, card))
    key = rng.prng_key(n + count, card)
    before = (kernels.SAMPLE_TARGETS.launches, kernels.RANDINT.launches)
    got = pswim.sample_members(pid, pkey, key, count)
    assert (kernels.SAMPLE_TARGETS.launches,
            kernels.RANDINT.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, pswim.sample_members_plain(pid, pkey, key, count))


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


@pytest.mark.parametrize("layout, lead", (
    ("storm", (64,)), ("storm", (3001,)), ("storm", (3, 257)),
    ("gapstress", (300,)), ("gapstress", (2, 65)), ("gapstress_k64", (64,))))
def test_sync_masks(card, layout, lead):
    """K3's mask pass (its lane form for a [K, N] lead) at the storm's and
    gapstress's layouts, every trap of `advertised_rows` reached."""
    from corrosion_tpu_torch.sim.runner import _gapstress_cfg

    sm = _smoke()
    cfg = (sm._storm_cfg(lead[-1], card)[0] if layout == "storm" else
           _gapstress_cfg(lead[-1], 64 if layout == "gapstress_k64" else 8))
    kern = kernels.SYNC_MASKS if len(lead) == 1 else kernels.SYNC_MASKS_LANES
    before = kern.launches
    row, _ = sm.compare_sync_masks(card, np.random.default_rng(len(lead)),
                                   cfg, lead, timed=False)
    _launched(kern, before)
    assert row["equal"], row


@pytest.mark.parametrize("entry", ("unmetered", "delay", "metered",
                                   "granted", "metered_granted"))
@pytest.mark.parametrize("lanes", (None, 3))
def test_sync_pull_on_pass_masks(card, entry, lanes):
    """Every pull entry (its lane entry for ``lanes``) on masks from the
    mask pass: equal to the plain pull, ring, fruitful and granted words,
    on a ring that already holds words."""
    from corrosion_tpu_torch.sim import lanes as ln

    sm = _smoke()
    n, s, d = 1001, 3, 4
    g = np.random.default_rng(len(entry) + (lanes or 0))
    cfg = sm._storm_cfg(n, card)[0]
    w = cfg.n_payloads // 32
    lead = (n,) if lanes is None else (lanes, n)
    masks, miss = packed.sync_masks(*sm.advertised_rows(g, lead, cfg, card),
                                    cfg)
    peers = _i32(g.integers(0, n, (*lead, s)), card)
    ok = torch.as_tensor(g.random((*lead, s)) < 0.8, device=card)
    edges = (n * s,) if lanes is None else (lanes, n * s)
    sdelay = (_i32(g.integers(0, d, edges), card) if entry == "delay"
              else None)
    budget = 2048 if entry.startswith("metered") else None
    nbytes = _i32(np.full(w * 32, 64), card)
    ring = (_words(g, (d, n, w), card) & _words(g, (d, n, w), card)
            if lanes is None else
            _words(g, (lanes, d, n, w), card) & _words(g, (lanes, d, n, w),
                                                        card))
    outs = []
    for fn in ((packed.sync_pull, packed.sync_pull_plain) if lanes is None
               else (ln.sync_pull_lanes, ln.sync_pull_lanes_plain)):
        r = ring.clone()
        granted = (torch.zeros((*edges, w), dtype=torch.int32, device=card)
                   if entry.endswith("granted") else None)
        if lanes is None:
            fr = fn(masks, miss, peers, ok, r if sdelay is not None else r[1],
                    budget, nbytes, granted, sdelay, 1)
        else:
            fr = fn(masks, miss, peers, ok, r, 1, sdelay, granted, budget,
                    nbytes)
        outs.append((fr, r, granted))
    (fr, r, gr), (want_fr, want_r, want_gr) = outs
    assert fr.dtype == torch.bool and torch.equal(fr, want_fr)
    assert torch.equal(r, want_r)
    assert gr is None or torch.equal(gr, want_gr)
    assert bool(want_fr.any())


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
    ptbl = pswim._pack_tables(args[0], args[1])
    got = pswim.merge_entries(*args, ptbl)
    want = pswim.merge_entries_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(merge_cases.CASES))
def test_merge_entries_branches(card, case):
    inputs, fired = merge_cases.build(case)
    args = [torch.as_tensor(x, device=card) for x in inputs]
    ptbl = pswim._pack_tables(args[0], args[1])
    before = kernels.MERGE_ENTRIES.launches
    got = pswim.merge_entries(*args, merge_cases.T, merge_cases.GC, ptbl)
    _launched(kernels.MERGE_ENTRIES, before)
    want = pswim.merge_entries_plain(*args, merge_cases.T, merge_cases.GC,
                                     ptbl)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fired(inputs[:3], [x.cpu().numpy() for x in got]), case


def _merge_args(g, n, e, dev, lanes=None):
    """Merge inputs at ``n`` receivers (per lane with ``lanes``), crowded
    onto a quarter of them, half the ids already in the bucket; and the
    packed table."""
    k = lanes or 1
    tabs = [_tables(g, n, 64) for _ in range(k)]
    pid, pkey, psince = (np.stack([tb[i] for tb in tabs]) for i in range(3))
    e_dst = g.integers(0, max(1, n // 4), (k, e))
    picked = np.take_along_axis(pid.reshape(k, -1),
                                e_dst * 64 + g.integers(0, 64, (k, e)), 1)
    e_id = np.where((g.random((k, e)) < 0.5) & (picked >= 0), picked,
                    g.integers(0, n, (k, e)))
    e_key = g.integers(0, 2047, (k, e)) * 4 + g.integers(0, 3, (k, e))
    xs = [pid, pkey, psince, e_dst, e_id, e_key]
    if lanes is None:
        xs = [x[0] for x in xs]
    args = [_i32(x, dev) for x in xs]
    ok = g.random((k, e)) < 0.8
    args.append(torch.as_tensor(ok if lanes else ok[0], device=dev))
    return args, pswim._pack_tables(args[0], args[1])


def test_merge_scratch_clears_itself(card):
    """K4's scratch is zeroed once and cleared by each apply pass: solo
    calls, the lane entry on the same cell count, a smaller solo shape,
    then twenty calls replayed in one CUDA graph — each equal to the
    plain version."""
    g = np.random.default_rng(22)
    t, gc = 40, 12
    cases = [_merge_args(g, 3000, 60_000, card),
             _merge_args(g, 1000, 20_000, card, lanes=3),  # 3000 rows too
             _merge_args(g, 3000, 60_000, card),
             _merge_args(g, 257, 5_000, card)]
    for args, ptbl in cases:
        lanes = args[0].dim() == 3
        run = pswim.merge_entries_lanes if lanes else pswim.merge_entries
        plain = (pswim.merge_entries_lanes_plain if lanes
                 else pswim.merge_entries_plain)
        got = run(*args, t, gc, ptbl)
        want = plain(*args, t, gc, ptbl)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    scratch = pswim.merge_scratch(card, 3000 * 64)
    assert not bool(scratch.any()), "K4 left its scratch dirty"
    graphed = [_merge_args(g, 257, 5_000, card) for _ in range(20)]
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for args, ptbl in graphed:
            outs.append(pswim.merge_entries(*args, t, gc, ptbl))
    graph.replay()
    torch.cuda.synchronize()
    for (args, ptbl), got in zip(graphed, outs):
        want = pswim.merge_entries_plain(*args, t, gc, ptbl)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not bool(pswim.merge_scratch(card, 257 * 64).any())


def test_merge_scratch_refuses_capture_allocation(card):
    """A scratch whose first allocation would fall inside a CUDA-graph
    capture raises, never silently."""
    args, ptbl = _merge_args(np.random.default_rng(5), 131, 900, card)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            pswim.merge_entries(*args, 40, 12, ptbl)


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
    # past 32 versions: the walk over version words (gapstress's shape,
    # V not a multiple of 32, K past 32)
    (8, 8, 128, 8, 0.06), (2, 4, 96, 4, 0.3), (2, 4, 40, 2, 0.4),
    (1, 3, 64, 2, 0.5), (32, 1, 33, 3, 0.02), (8, 8, 128, 64, 0.06),
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


@pytest.mark.parametrize("k", (2, 3, 8, 64, 256))
@pytest.mark.parametrize("lanes", (None, 3))
@pytest.mark.parametrize("a, v, c, p_bit", ((16, 8, 4, 0.2),
                                            (8, 128, 8, 0.06)))
def test_gaps_refresh_slots(card, k, lanes, a, v, c, p_bit):
    """K6 and its lane entry at K from 2 to 256 slots (the tile's rows
    shrink with K; at 256 the staged slots pass 48 KB and the block opts
    in to more shared memory), on the storm's and gapstress's version
    shapes, with N * A a multiple of no tile's rows."""
    n = 1001
    cfg = SimConfig(n_nodes=n, n_payloads=a * v * c, n_writers=a,
                    chunks_per_version=c, gap_slots=k)
    g = np.random.default_rng(k + v)
    have = torch.stack([_bits_words(g, n, cfg.n_payloads, p_bit, card)
                        for _ in range(lanes or 1)])
    if lanes is None:
        have = have[0]
        kernel, run, plain = (kernels.GAPS_REFRESH, gaps.refresh_gaps,
                              gaps.refresh_gaps_plain)
    else:
        kernel, run, plain = (kernels.GAPS_REFRESH_LANES,
                              gaps.refresh_gaps_lanes,
                              gaps.refresh_gaps_lanes_plain)
    before = kernel.launches
    got = run(have, cfg)
    _launched(kernel, before)
    want = plain(have, cfg)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if k == 2:
        assert int(want[3].sum()) > 0, "no row overflowed K = 2"
    if lanes:
        for x, y in zip(got, gaps.refresh_gaps(have[-1], cfg)):
            assert torch.equal(x[-1], y)


@pytest.mark.parametrize("lanes", (None, 2))
@pytest.mark.parametrize("v, k", ((2048, 8), (64, 1024)))
def test_gaps_refresh_past_shared_memory(card, v, k, lanes):
    """K6 and its lane entry where a 32-row tile fits the card's shared
    memory nowhere, so the unstaged form runs (have rows and slots in
    global memory): one writer and V = 2048 versions of 32 chunks (2048
    have words a node, and the tile spans 33 nodes), and K = 1024 slots;
    each equal to the plain version."""
    n = 77
    cfg = SimConfig(n_nodes=n, n_payloads=v * 32, n_writers=1,
                    chunks_per_version=32, gap_slots=k)
    g = np.random.default_rng(v + k)
    have = torch.stack([_bits_words(g, n, cfg.n_payloads, 0.003, card)
                        for _ in range(lanes or 1)])
    if lanes is None:
        have = have[0]
        kernel, run, plain = (kernels.GAPS_REFRESH, gaps.refresh_gaps,
                              gaps.refresh_gaps_plain)
    else:
        kernel, run, plain = (kernels.GAPS_REFRESH_LANES,
                              gaps.refresh_gaps_lanes,
                              gaps.refresh_gaps_lanes_plain)
    before = kernel.launches
    got = run(have, cfg)
    _launched(kernel, before)
    want = plain(have, cfg)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if k == 8:
        assert int(want[3].sum()) > 0, "no row overflowed K = 8"


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
        overflow_frac=torch.tensor(0.125 if t == 14 else 0.0, device=card),
        order_violations=torch.zeros((), dtype=torch.int32, device=card),
    )
    count = torch.tensor(int(g.integers(0, n * 16 // 2 + 1)),
                         dtype=torch.int32, device=card)
    before = kernels.CONVERGE_RECORD.launches
    last_round = int(meta.round.max())
    got = packed.converge_record(have, inj, alive, metrics, meta, t, cfg,
                                 count, last_round)
    _launched(kernels.CONVERGE_RECORD, before)  # one launch, no finish
    want = packed.converge_record_plain(have, inj, alive, metrics, meta, t,
                                        cfg, count, last_round)
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


def _fault_plan(kind, n):
    """The storm's plan, or one with two overlapping losses (a composite
    factor), a one-way cut and a range crash with a wipe."""
    if kind == "storm":
        return storm_fault_plan(n, 3)
    return FaultPlan(n_nodes=n, seed=5, events=(
        FaultEvent("loss", 0, 10, p=0.2),
        FaultEvent("loss", 5, 15, src=f"0:{3 * n // 5}",
                   dst=f"{n // 5}:{n}", p=0.3),
        FaultEvent("partition", 3, 9, src=f"0:{n // 2}", dst=f"{n // 2}:{n}"),
        FaultEvent("crash", 4, 12, node=f"{n // 10}:{n // 5 + 1}", wipe=True),
    ))


def _round(card, kind, n, t):
    cfg = _storm_cfg(n)
    fplan = faults.compile_plan(_fault_plan(kind, n), cfg, factored=True,
                                device=card)
    return cfg, fplan, faults.round_faults(fplan, t)


def _fault_edges(g, n, e, dev):
    src = g.integers(0, n, e)
    dst = np.where(g.random(e) < 0.1, src, g.integers(0, n, e))
    return _i32(src, dev), _i32(dst, dev)


@pytest.mark.parametrize("kind", ("storm", "overlap"))
@pytest.mark.parametrize("n", (10, 257, 3000))
@pytest.mark.parametrize("t", (0, 5, 7, 13))
def test_fault_edges(card, kind, n, t):
    _, _, rf = _round(card, kind, n, t)
    g = np.random.default_rng(n + t)
    src, dst = _fault_edges(g, n, 3 * n + 5, card)
    for fn, plain in (
        (faults.fault_edge_block, faults._block_plain),
        (faults.fault_edge_loss, faults._loss_plain),
        (faults.fault_session_refused,
         lambda rf, s, d: (faults._block_plain(rf, s, d)
                           | faults._block_plain(rf, d, s))),
    ):
        before = kernels.FAULT_EDGES.launches
        got = fn(rf, src, dst)
        _launched(kernels.FAULT_EDGES, before)
        want = plain(rf, src, dst)
        assert got.dtype == want.dtype and torch.equal(got, want), fn
    ok = torch.as_tensor(g.random(src.shape[0]) < 0.8, device=card)
    got_ok, got_thr, _, _ = faults.fault_wire_effects(rf, src, dst,
                                                      ok.clone())
    want_ok = ok & ~faults._block_plain(rf, src, dst)
    assert torch.equal(got_ok, want_ok)
    assert torch.equal(got_thr, faults._loss_plain(rf, src, dst))


@pytest.mark.parametrize("kind", ("storm", "overlap"))
@pytest.mark.parametrize("n, e", ((10, 30), (257, 257), (3000, 9000),
                                  (1000, 128 * 7)))
@pytest.mark.parametrize("t", (2, 6, 13))
def test_fault_reach(card, kind, n, e, t):
    _, _, rf = _round(card, kind, n, t)
    g = np.random.default_rng(n + e + t)
    src, dst = _fault_edges(g, n, e, card)
    ok = torch.as_tensor(g.random(e) < 0.9, device=card)
    key = rng.prng_key(n + t, card)
    before = kernels.FAULT_REACH.launches
    got = faults.fault_reach_(ok.clone(), rf, key, src, dst)
    _launched(kernels.FAULT_REACH, before)
    want = faults.fault_reach_plain(ok.clone(), rf, key, src, dst)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n, w, f", ((10, 1, 3), (1000, 16, 3), (333, 8, 2)))
@pytest.mark.parametrize("t", (1, 5, 13))
def test_broadcast_scatter_lossy(card, n, w, f, t):
    _, _, rf = _round(card, "overlap", n, t)
    g = np.random.default_rng(n + t)
    ring = _words(g, (2, n, w), card)
    sending = _words(g, (n, w), card)
    src = torch.arange(n, dtype=torch.int32, device=card).repeat_interleave(f)
    dst = _i32(g.integers(0, n, n * f), card)
    slot = _i32(g.integers(0, 2, n * f), card)
    ok = torch.as_tensor(g.random(n * f) < 0.8, device=card)
    ok, thr, _, _ = faults.fault_wire_effects(rf, src, dst, ok)
    key = rng.prng_key(t, card)
    got, want = ring.clone(), ring.clone()
    before = kernels.BROADCAST_SCATTER_LOSSY.launches
    packed.scatter_sending_lossy(got, sending, dst, slot, ok, thr, key, 77, f)
    _launched(kernels.BROADCAST_SCATTER_LOSSY, before)
    packed.scatter_sending_lossy_plain(want, sending, dst, slot, ok, thr, key,
                                       77, f)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ("storm", "overlap"))
@pytest.mark.parametrize("n", (10, 257, 3000))
@pytest.mark.parametrize("t", (4, 8, 12, 20))
def test_node_faults(card, kind, n, t):
    cfg, _, rf = _round(card, kind, n, t)
    g = np.random.default_rng(n + t)
    pid, pkey, psince = _tables(g, n, cfg.member_slots)
    a, k = cfg.n_writers, cfg.gap_slots
    slim = packed.shrink_state(init_state(cfg, rng.prng_key(1, card)))
    slim = slim._replace(
        pid=_i32(pid, card), pkey=_i32(pkey, card), psince=_i32(psince, card),
        heads=_i32(g.integers(0, 9, (n, a)), card),
        gap_lo=_i32(g.integers(0, 9, (n, a, k)), card),
        gap_hi=_i32(g.integers(0, 9, (n, a, k)), card),
        alive=torch.as_tensor((g.random(n) < 0.2) * 2, dtype=torch.uint8,
                              device=card),
    )
    c0 = _carry(g, n, cfg.n_payloads // 32, cfg.n_delay_slots, card)
    names = ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey", "psince")

    def copy():
        return slim._replace(**{x: getattr(slim, x).clone() for x in names})

    got_s, got_c = copy(), _clone(c0)
    before = kernels.NODE_FAULTS.launches
    packed.apply_round_faults(got_s, got_c, rf)
    _launched(kernels.NODE_FAULTS, before)
    want_s = faults.apply_node_faults_plain(copy(), rf)
    want_c = packed.apply_carry_faults(_clone(c0), rf)
    _assert_carry_equal(got_c, want_c)
    for x in names:
        assert torch.equal(getattr(got_s, x), getattr(want_s, x)), x


@pytest.mark.parametrize("n", (1, 257, 3000))
@pytest.mark.parametrize("t, horizon", ((5, 21), (19, 21), (20, 21),
                                        (30, 21)))
@pytest.mark.parametrize("wiped", (False, True))
def test_converge_record_fault_exit(card, n, t, horizon, wiped):
    """K7's exit mode: t + 1 >= horizon and the fresh all-have predicate,
    which a wipe after a node's sticky stamp undoes."""
    cfg = _storm_cfg(n)
    meta = uniform_payloads(cfg, card, inject_every=2)
    g = np.random.default_rng(n + t)
    w = cfg.n_payloads // 32
    full = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    dead = g.random(n) < 0.2
    dead[0] = False
    if wiped:
        full[0] = 0
    have = _i32(full.view(np.int32), card)
    inj = torch.full((w,), -1, dtype=torch.int32, device=card)
    alive = torch.as_tensor(dead * 2, dtype=torch.uint8, device=card)
    metrics = RunMetrics(
        coverage_at=torch.full((cfg.n_payloads,), -1, dtype=torch.int32,
                               device=card),
        converged_at=_i32(np.where(g.random(n) < 0.9, 3, -1), card),
        overflow_frac=torch.zeros((), device=card),
        order_violations=torch.zeros((), dtype=torch.int32, device=card),
    )
    count = torch.tensor(n, dtype=torch.int32, device=card)
    before = kernels.CONVERGE_RECORD.launches
    last_round = int(meta.round.max())
    got = packed.converge_record(have, inj, alive, metrics, meta, t, cfg,
                                 count, last_round, horizon)
    _launched(kernels.CONVERGE_RECORD, before)
    want = packed.converge_record_plain(have, inj, alive, metrics, meta, t,
                                        cfg, count, last_round, horizon)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert bool(got[3]) == (t + 1 >= horizon and not wiped)


@pytest.mark.parametrize("n, w", ((31, 6), (1000, 6), (3000, 16),
                                  (257, 256), (2000, 256)))
@pytest.mark.parametrize("lanes", (None, 3))
@pytest.mark.parametrize("horizon", (None, 21))
def test_converge_record_widths(card, n, w, lanes, horizon):
    """K7's one launch at W = 6 (the one-word path), 16 (the storm's
    runs) and 256 (gapstress's: a block a node), solo and on the lanes
    (counted apart), in both modes; three calls in a row, each on the
    scratch the one before cleared, each with its own overflow count."""
    from corrosion_tpu_torch.sim import lanes as ln

    sm = _smoke()
    cfg = _storm_cfg(n, 32 * w)
    meta = uniform_payloads(_storm_cfg(n), card, inject_every=2)
    g = np.random.default_rng(n + w)
    cases = sm._record_cases(g, card, n, w, cfg)
    if horizon is None:
        cases = cases[:2]
    else:
        cases = cases[2:]
    last_round = int(meta.round.max())
    for have, inj, alive, m, t, count, hz in cases:
        if lanes is None:
            args = (have, inj, alive, m, meta, t, cfg, count, last_round, hz)
            kernel, run, plain = (kernels.CONVERGE_RECORD,
                                  packed.converge_record,
                                  packed.converge_record_plain)
        else:
            def stack(x):
                return torch.stack([x] * lanes)

            args = (stack(have), stack(inj), stack(alive),
                    RunMetrics(*(stack(x) for x in m)), meta, t, cfg,
                    torch.stack([count + k for k in range(lanes)]),
                    last_round, hz)
            kernel, run, plain = (kernels.CONVERGE_RECORD_LANES,
                                  ln.converge_record_lanes,
                                  ln.converge_record_lanes_plain)
        before = kernel.launches
        got = run(*args)
        _launched(kernel, before)
        for x, y in zip(got, plain(*args)):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("n, f", ((1, 3), (257, 3), (3000, 2)))
@pytest.mark.parametrize("lanes", (None, 3))
@pytest.mark.parametrize("kind", ("broadcast", "sync"))
def test_edge_list(card, n, f, lanes, kind):
    """K2's edge pass against its plain version on targets with -1 and
    self entries, two partition groups, SUSPECT and DOWN rows, senders not
    due (the sync) and two delay classes (the broadcast), solo and on the
    lanes (counted apart)."""
    sm = _smoke()
    g = np.random.default_rng(n + f)
    lead = () if lanes is None else (lanes,)
    targets, group, alive, due, topo, region = sm._edge_traps(g, card, lead,
                                                              n, f)
    args = ((targets, group, alive, None, topo, region, 9, 3)
            if kind == "broadcast"
            else (targets, group, alive, due, None, region, 9, 3))
    kernel = kernels.EDGE_LIST if lanes is None else kernels.EDGE_LIST_LANES
    before = kernel.launches
    got = packed.edge_list(*args)
    _launched(kernel, before)
    want = packed.edge_list_plain(*args)
    for x, y in zip(got, want):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and torch.equal(x, y))


@pytest.mark.parametrize("n, w", ((5, 1), (1000, 3), (1000, 16),
                                  (257, 256)))
@pytest.mark.parametrize("lanes", (None, 3))
def test_broadcast_scatter_forms(card, n, w, lanes):
    """K2 on the edge pass's lists, solo and on the lanes folded into the
    rows, at W = 1, 3, 16 and 256 (rows within and across warps), against
    its plain version; zero sending rows skip."""
    from corrosion_tpu_torch.sim import lanes as ln

    sm = _smoke()
    g = np.random.default_rng(n + w)
    lead = () if lanes is None else (lanes,)
    f = 3
    targets, group, alive, _, topo, region = sm._edge_traps(g, card, lead, n,
                                                            f)
    sending = _words(g, (*lead, n, w), card)
    sending[..., : n // 3, :] = 0
    ring = _words(g, (*lead, 2, n, w), card)
    got, want = ring.clone(), ring.clone()
    kernel = (kernels.BROADCAST_SCATTER if lanes is None
              else kernels.BROADCAST_SCATTER_LANES)
    dst, ok, slot = packed.edge_list_plain(targets, group, alive, None, topo,
                                           region, 7, 2)
    before = kernel.launches
    if lanes is None:
        packed.scatter_sending(got, sending, dst, slot, ok, f)
        packed.scatter_sending_plain(want, sending, dst, slot, ok, f)
    else:
        ln.scatter_lanes(got, sending, dst, slot, ok, f)
        ln.scatter_lanes_plain(want, sending, dst, slot, ok, f)
    assert kernel.launches == before + 1
    assert torch.equal(got, want)


# -- the dense round: K1's uniform entry and K12-K15 --------------------------
# chip_smoke.py's comparisons at small and ragged shapes; each raises when
# its inputs miss a trap and reports whether kernel and plain agree


def _smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("n", (31, 257, 3000))
@pytest.mark.parametrize("count", (1, 3))
def test_sample_uniform(card, n, count):
    row = _smoke().compare_sample_uniform(
        card, np.random.default_rng(n), n=n, count=count, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (64, 1001))
def test_dense_phases(card, n):
    row = _smoke().compare_dense_phases(card, np.random.default_rng(n), n=n,
                                        timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (64, 1001))
def test_dense_sync(card, n):
    row = _smoke().compare_dense_sync(card, np.random.default_rng(n), n=n,
                                      timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, n_writers, n_payloads", (
    (37, 4, 256), (1000, 8, 256), (300, 2, 192), (65, 1, 64)))
def test_dense_gaps(card, n, n_writers, n_payloads):
    row = _smoke().compare_dense_gaps(
        card, np.random.default_rng(n), n=n, n_writers=n_writers,
        n_payloads=n_payloads, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, f", ((31, 2), (300, 3), (1024, 3)))
def test_swim_full(card, n, f):
    row = _smoke().compare_swim_full(card, np.random.default_rng(n), n=n,
                                     f=f, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("name", ("dense3", "lossy9", "churn64", "heal512"))
def test_dense_run_on_card_equals_cpu(card, name):
    """A whole dense run through every kernel on the card equals the
    plain versions' run on the CPU, state for state."""
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim import runner
    from corrosion_tpu_torch.sim.round import (
        new_metrics, new_sim, round_step, run_to_convergence)
    from corrosion_tpu_torch.sim.topology import Topology, regions

    def run(dev):
        if name == "churn64":
            return runner.membership_churn(64, 0, device=dev,
                                           return_state=True)["state"]
        if name == "heal512":
            cfg, meta = runner.heal_config(512, dev)
            topo = Topology(n_regions=2, inter_delay=2)
            region = regions(512, 2, dev)
            state = new_sim(cfg, 0, dev)
            half = torch.arange(512, device=dev) >= 256
            state = state._replace(group=half.to(torch.int32))
            metrics = new_metrics(cfg, dev)
            for _ in range(20):
                state, metrics = round_step(state, metrics, meta, cfg, topo,
                                            region)
            state = state._replace(group=torch.zeros_like(state.group))
            return run_to_convergence(state, meta, cfg, topo, 2000)[0]
        topo = Topology()
        kw = dict(n_nodes=24, n_payloads=16, fanout=2)
        if name == "lossy9":
            topo = Topology(n_regions=2, inter_delay=2, loss=0.2)
            kw.update(swim_full_view=True)
        else:
            kw.update(sync_interval_rounds=4)
        cfg = SimConfig(**kw)
        meta = uniform_payloads(cfg, dev, inject_every=1)
        seed = 9 if name == "lossy9" else 3
        return run_to_convergence(new_sim(cfg, seed, dev), meta, cfg, topo,
                                  400)[0]

    assert state_digest(run(card)) == state_digest(run("cpu"))


# -- the gapstress storm: K16, K3's metered entry, K10's topology stream,
# K6 past 32 versions, K14 at K = 64, K8's metered spend ---------------------


@pytest.mark.parametrize("rows, p", ((1, 256), (33, 8192), (300, 8192),
                                     (5, 65536)))
@pytest.mark.parametrize("budget", (0, 1, 17_000, 5 * 1024 * 1024))
def test_budget_words(card, rows, p, budget):
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes

    g = np.random.default_rng(rows + p)
    words = _words(g, (rows, p // 32), card)
    words[::7] = 0
    sizes = _i32(gapstress_payload_sizes(p), card)
    before = kernels.BUDGET_WORDS.launches
    got = packed.budget_prefix_words(words, budget, sizes)
    _launched(kernels.BUDGET_WORDS, before)
    assert torch.equal(got, packed.budget_prefix_words_plain(words, budget,
                                                             sizes))


@pytest.mark.parametrize("n", (64, 1001))
def test_budget_words_gapstress(card, n):
    row = _smoke().compare_budget_words(card, np.random.default_rng(n), n=n,
                                        timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (64, 1001))
def test_sync_pull_metered(card, n):
    before = kernels.SYNC_PULL_METERED.launches
    row = _smoke().compare_sync_pull_metered(
        card, np.random.default_rng(n), n=n, timed=False)
    # one launch under each grant, the 4 MiB one and 1
    assert kernels.SYNC_PULL_METERED.launches == before + 2
    assert row["equal"], row


@pytest.mark.parametrize("n", (64, 999))
def test_scatter_topology_loss(card, n):
    row = _smoke().compare_scatter_topo(card, np.random.default_rng(n), n=n,
                                        timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (300, 2100))
def test_gaps_refresh_wide(card, n):
    row = _smoke().compare_gaps_wide(card, np.random.default_rng(n), n=n,
                                     timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (37, 300))
def test_dense_gaps_past_32_slots(card, n):
    row = _smoke().compare_dense_gaps(
        card, np.random.default_rng(n), n=n, n_writers=8, n_payloads=8192,
        chunks=8, gap_slots=64, p_one=0.083, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, w, f", ((1, 16, 3), (257, 256, 3), (3000, 8, 2)))
@pytest.mark.parametrize("budget", (1, 40_000))
def test_word_spend_metered(card, n, w, f, budget):
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes

    g = np.random.default_rng(n + w)
    c0 = _carry(g, n, w, 2, card)
    inj = _words(g, (w,), card)
    targets = _i32(np.where(g.random((n, f)) < 0.3, -1,
                            g.integers(0, n, (n, f))), card)
    alive = torch.as_tensor((g.random(n) < 0.2) * 2, dtype=torch.uint8,
                            device=card)
    sizes = _i32(gapstress_payload_sizes(w * 32), card)
    got, want = _clone(c0), _clone(c0)
    before = kernels.BUDGET_WORDS.launches
    sent = packed.spend_relay(got, inj, targets, alive, budget, sizes)
    _launched(kernels.BUDGET_WORDS, before)
    want_sent = packed.spend_relay_plain(want, inj, targets, alive, budget,
                                         sizes)
    assert torch.equal(sent, want_sent)
    _assert_carry_equal(got, want)


@pytest.mark.parametrize("name", ("lockstep24", "v64", "fault48"))
def test_gapstress_packed_run_on_card_equals_cpu(card, name):
    """A metered, lossy packed run on the card launches K16, K3's metered
    entry, K10 and K6 (past 32 versions for v64), raises nothing, and
    ends in the CPU run's state."""
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes
    from corrosion_tpu_torch.sim.topology import Topology

    kw = dict(gap_slots=4, fanout=2, sync_interval_rounds=3,
              swim_partial_view=True, member_slots=8, packed_min_cells=0,
              rate_limit_bytes_round=32 * 1024, sync_budget_bytes=24 * 1024)
    if name == "v64":
        kw.update(n_payloads=512, n_writers=4, chunks_per_version=2)
        n = 64
    else:
        kw.update(n_payloads=256, n_writers=4, chunks_per_version=4,
                  n_delay_slots=2)
        n = 48 if name == "fault48" else 24
    cfg = SimConfig.wan_tuned(n, **kw)

    def run(dev):
        meta = uniform_payloads(
            cfg, dev, inject_every=0,
            payload_bytes=gapstress_payload_sizes(cfg.n_payloads))
        topo = Topology(loss=0.3 if name != "fault48" else 0.2)
        state = new_sim(cfg, 29, dev)
        if name == "fault48":
            plan = FaultPlan(n_nodes=n, seed=11, events=(
                FaultEvent("loss", 0, 18, p=0.3),
                FaultEvent("partition", 3, 12, src="0:16", dst="16:48"),
            ))
            fplan = faults.compile_plan(plan, cfg, topo, factored=True,
                                        device=dev)
            return faults.run_fault_plan(state, meta, cfg, topo, fplan,
                                         400)[0]
        return run_to_convergence(state, meta, cfg, topo, 400)[0]

    kernels.reset_launch_counts()
    on_card = run(card)
    for kern in (kernels.BUDGET_WORDS, kernels.SYNC_PULL_METERED,
                 kernels.BROADCAST_SCATTER_LOSSY, kernels.GAPS_REFRESH):
        assert kern.launches > 0, kern.name
    assert state_digest(on_card) == state_digest(run("cpu"))


# -- the flight recorder: K17-K19 and the telemetry outputs of K3, K9,
# K10, K12 and K13 -----------------------------------------------------------


def _sizes(dev, p, size=60_000):
    """Payload sizes large enough that the byte folds pass 2^31."""
    return torch.full((p,), size, dtype=torch.int32, device=dev)


# rows not a multiple of 15 (K17's nibble chunk) and one that is
@pytest.mark.parametrize("n, w, e", ((1003, 5, 3009), (15, 1, 45),
                                     (3000, 16, 9001), (301, 256, 903)))
def test_trace_counts(card, n, w, e):
    row = _smoke().compare_trace_counts(card, np.random.default_rng(n), n, w,
                                        e, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, p", ((100, 8192), (37, 96), (1024, 8192)))
def test_trace_counts_dense(card, n, p):
    row = _smoke().compare_trace_counts_dense(
        card, np.random.default_rng(n), n=n, p=p, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, w", ((1001, 16), (300, 256), (7, 3)))
def test_trace_wire(card, n, w):
    size = 60_000 if n > 7 else 1 << 30  # seven nodes pass 2^31 too
    row = _smoke().compare_trace_wire(card, np.random.default_rng(n), n, w,
                                      3, _sizes(card, w * 32, size),
                                      timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n", (999, 1024))
def test_trace_wire_rows(card, n):
    row = _smoke().compare_trace_wire_rows(card, np.random.default_rng(n),
                                           n=n, timed=False)
    assert row["equal"], row


@pytest.mark.parametrize("n, p", ((3001, 512), (600, 8192), (5, 32)))
def test_trace_row(card, n, p):
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes

    sizes = torch.as_tensor(gapstress_payload_sizes(p), device=card)
    row = _smoke().compare_trace_row(card, np.random.default_rng(n), n, p,
                                     sizes, timed=False)
    assert row["equal"], row


def test_trace_outputs(card):
    rows = _smoke().compare_trace_outputs(card, np.random.default_rng(4),
                                          timed=False, n=3000, n_gs=600,
                                          n_dense=200)
    for row in rows:
        assert row["equal"], row


def _telemetry_run(name, dev, telemetry=True):
    """A whole run on ``dev``, with the flight recorder unless told not
    to: the packed storm and fault storm at 512 nodes, gapstress at 64
    nodes on the dense round and forced onto the packed one (lossy,
    metered), the dense bool branch (full view under loss, P = 16) and a
    decimated 3-node run."""
    import dataclasses

    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import (
        _gapstress_cfg, _write_storm, gapstress_payload_sizes)
    from corrosion_tpu_torch.sim.topology import Topology

    topo, seed = Topology(), 0
    if name in ("storm512", "fault512"):
        cfg, meta = _write_storm(512, 256, dev)
        cfg = dataclasses.replace(cfg, packed_min_cells=0)
        seed = 7
        if name == "fault512":
            plan = faults.compile_plan(storm_fault_plan(512, 7), cfg, topo,
                                       factored=True, device=dev)
            return faults.run_fault_plan(new_sim(cfg, seed, dev), meta, cfg,
                                         topo, plan, 600, telemetry)
    elif name in ("gs64", "gs64_packed"):
        cfg = _gapstress_cfg(64, 8)
        if name == "gs64_packed":
            cfg = dataclasses.replace(cfg, packed_min_cells=0)
        meta = uniform_payloads(cfg, dev, inject_every=0,
                                payload_bytes=gapstress_payload_sizes(8192))
        topo, seed = Topology(loss=0.3), 1
    elif name == "lossy9":
        cfg = SimConfig(n_nodes=24, n_payloads=16, fanout=2, n_delay_slots=4,
                        swim_full_view=True)
        meta = uniform_payloads(cfg, dev, inject_every=1)
        topo, seed = Topology(n_regions=2, inter_delay=2, loss=0.2), 9
    else:  # 3node_every3
        cfg = SimConfig(n_nodes=3, n_payloads=64, fanout=2,
                        sync_interval_rounds=4, trace_every=3)
        meta = uniform_payloads(cfg, dev, inject_every=1)
    return run_to_convergence(new_sim(cfg, seed, dev), meta, cfg, topo, 600,
                              telemetry)


@pytest.mark.parametrize("name", ("storm512", "fault512", "gs64",
                                  "gs64_packed", "lossy9", "3node_every3"))
def test_telemetry_run_on_card_equals_cpu(card, name):
    """A whole run with telemetry on the card records the CPU run's trace
    bit for bit (f32 channels included: both round the same exact
    totals), ends in its state, and launches K17-K19; without telemetry
    the same run launches none of them and every other kernel exactly as
    often."""
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim import telemetry

    kernels.reset_launch_counts()
    final, _, trace = _telemetry_run(name, card)
    on = {k.name: k.launches for k in kernels.KERNELS}
    packed_run = name in ("storm512", "fault512", "gs64_packed")
    for row in ("trace_row",) + (
            ("trace_counts", "trace_wire") if packed_run
            else ("trace_counts_dense", "trace_wire_rows")):
        for kern in kernels.PORTED[row]:
            assert kern.launches > 0, kern.name
    cpu_final, _, cpu_trace = _telemetry_run(name, "cpu")
    assert state_digest(final) == state_digest(cpu_final)
    for f in telemetry.CHANNELS:
        assert torch.equal(getattr(trace, f).cpu(), getattr(cpu_trace, f)), f

    trace_entries = {k.name for row in kernels.TRACE_ROWS
                     for k in kernels.PORTED[row]}
    kernels.reset_launch_counts()
    off_final, _ = _telemetry_run(name, card, telemetry=False)
    assert state_digest(off_final) == state_digest(final)
    for kern in kernels.KERNELS:
        want = 0 if kern.name in trace_entries else on[kern.name]
        assert kern.launches == want, (kern.name, kern.launches, want)


# -- the latency storm: K9's latency entry, K10's jitter stream, K3's delay
# entry (chip_smoke.py's comparisons at small shapes, then ragged ones)


@pytest.mark.parametrize("n", (1200, 3000))
def test_fault_latency(card, n):
    before = kernels.FAULT_EDGES_DELAY.launches
    row = _smoke().compare_fault_latency(card, np.random.default_rng(n),
                                         n=n, timed=False)
    assert row["equal"], row
    assert kernels.FAULT_EDGES_DELAY.launches > before


@pytest.mark.parametrize("n", (1200, 3000))
def test_scatter_jitter(card, n):
    before = kernels.BROADCAST_SCATTER_JITTER.launches
    row = _smoke().compare_scatter_jitter(card, np.random.default_rng(n),
                                          n=n, timed=False)
    assert row["equal"], row
    assert kernels.BROADCAST_SCATTER_JITTER.launches == before + 3


@pytest.mark.parametrize("n", (1200, 3000))
def test_sync_delay(card, n):
    before = (kernels.SYNC_PULL_DELAY.launches,
              kernels.SYNC_PULL_METERED.launches)
    rows = _smoke().compare_sync_delay(card, np.random.default_rng(n), n=n,
                                       timed=False)
    assert all(row["equal"] for row in rows), rows
    assert kernels.SYNC_PULL_DELAY.launches == before[0] + 2
    assert kernels.SYNC_PULL_METERED.launches == before[1] + 2


@pytest.mark.parametrize("n, w, f, d, jb", (
    (10, 1, 3, 4, 1), (333, 8, 2, 4, 3), (1000, 16, 3, 8, 6)))
def test_scatter_jitter_bounds(card, n, w, f, d, jb):
    """Jitter bounds 0..jb per edge (4 or more take the per-bit path), any
    slot of a ring of d, with and without the fault loss."""
    g = np.random.default_rng(n + jb)
    ring = _words(g, (d, n, w), card)
    sending = _words(g, (n, w), card)
    dst = _i32(g.integers(0, n, n * f), card)
    slot = _i32(g.integers(0, d, n * f), card)
    ok = torch.as_tensor(g.random(n * f) < 0.8, device=card)
    jit = _i32(g.integers(0, jb + 1, n * f), card)
    thr = torch.as_tensor(g.integers(0, 120, n * f), dtype=torch.uint8,
                          device=card)
    key = rng.prng_key(jb, card)
    for t in (None, thr):
        got, want = ring.clone(), ring.clone()
        before = kernels.BROADCAST_SCATTER_JITTER.launches
        packed.scatter_sending_lossy(got, sending, dst, slot, ok, t, key, 5,
                                     f, jit=jit)
        _launched(kernels.BROADCAST_SCATTER_JITTER, before)
        packed.scatter_sending_lossy_plain(want, sending, dst, slot, ok, t,
                                           key, 5, f, jit=jit)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n, w, s, d", (
    (7, 1, 3, 2), (257, 16, 3, 4), (1000, 8, 5, 7)))
def test_sync_pull_classes(card, n, w, s, d):
    """Session delays 0..d (classes past d - 2 land nowhere; 4 or more OR
    straight into their slot), unmetered and metered, on a ring that
    already holds words."""
    g = np.random.default_rng(n + d)
    masks = _words(g, (n, 4, w), card)
    miss = _words(g, (n, w), card)
    peers = _i32(g.integers(0, n, (n, s)), card)
    ok = torch.as_tensor(g.random((n, s)) < 0.8, device=card)
    sdelay = _i32(g.integers(0, d + 1, n * s), card)
    nbytes = _i32(np.full(w * 32, 8192), card)
    ring = _words(g, (d, n, w), card) & _words(g, (d, n, w), card)
    for budget in (None, 3 * 8192):
        got, want = ring.clone(), ring.clone()
        kern = (kernels.SYNC_PULL_DELAY if budget is None
                else kernels.SYNC_PULL_METERED)
        before = kern.launches
        fr = packed.sync_pull(masks, miss, peers, ok, got, budget, nbytes,
                              sdelay=sdelay, slot=d - 1)
        _launched(kern, before)
        want_fr = packed.sync_pull_plain(masks, miss, peers, ok, want, budget,
                                         nbytes, sdelay=sdelay, slot=d - 1)
        assert torch.equal(fr, want_fr) and torch.equal(got, want)


def _latency_run(dev, telemetry):
    """JAX's 48-node "storm-mix" lockstep plan through `run_fault_plan`."""
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.topology import Topology

    cfg = SimConfig.wan_tuned(
        48, n_payloads=128, n_writers=4, chunks_per_version=4, fanout=3,
        sync_interval_rounds=4, swim_partial_view=True, member_slots=16,
        rate_limit_bytes_round=None, sync_budget_bytes=None,
        packed_min_cells=0, n_delay_slots=4)
    meta = uniform_payloads(cfg, dev, inject_every=2)
    plan = FaultPlan(n_nodes=48, seed=5, events=(
        FaultEvent("loss", 0, 20, p=0.3),
        FaultEvent("partition", 4, 14, src="0:24", dst="24:48",
                   symmetric=True),
        FaultEvent("delay", 2, 16, src="0:8", dst="*", delay_rounds=1),
        FaultEvent("jitter", 2, 16, src="0:8", dst="*", delay_rounds=1),
        FaultEvent("crash", 10, 22, node=2, wipe=True),
    ))
    fplan = faults.compile_plan(plan, cfg, Topology(), factored=True,
                                device=dev)
    return faults.run_fault_plan(new_sim(cfg, 9, dev), meta, cfg, Topology(),
                                 fplan, 100, telemetry)


@pytest.mark.parametrize("telemetry", (False, True))
def test_latency_run_on_card_equals_cpu(card, telemetry):
    """The storm-mix plan (loss, a cut, the latency pair, a wipe) on the
    card ends in the CPU run's state (and records its trace), through
    K9's latency entry, K10's jitter stream and K3's delay entry."""
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim import telemetry as tel

    kernels.reset_launch_counts()
    out = _latency_run(card, telemetry)
    for kern in (kernels.FAULT_EDGES_DELAY, kernels.BROADCAST_SCATTER_JITTER,
                 kernels.SYNC_PULL_DELAY):
        assert kern.launches > 0, kern.name
    cpu = _latency_run("cpu", telemetry)
    assert state_digest(out[0]) == state_digest(cpu[0])
    if telemetry:
        for f in tel.CHANNELS:
            assert torch.equal(getattr(out[2], f).cpu(), getattr(cpu[2], f)), f


# -- the dense round's fault entries: K11's dense entry, K12's fault entry,
# K13's delay entry, K14's exit mode (chip_smoke.py's comparisons, each
# reaching its traps, at small node counts)


@pytest.mark.parametrize("n", (1200, 3001))
def test_node_faults_dense(card, n):
    before = kernels.NODE_FAULTS_DENSE.launches
    row = _smoke().compare_node_faults_dense(card, np.random.default_rng(n),
                                             n=n, timed=False)
    assert row["equal"], row
    assert kernels.NODE_FAULTS_DENSE.launches == before + 4


@pytest.mark.parametrize("n", (1200, 3001))
def test_broadcast_fault(card, n):
    before = kernels.DENSE_BROADCAST_FAULT.launches
    row = _smoke().compare_broadcast_fault(card, np.random.default_rng(n),
                                           n=n, timed=False)
    assert row["equal"], row
    assert kernels.DENSE_BROADCAST_FAULT.launches > before


@pytest.mark.parametrize("n", (1200, 3001))
def test_sync_delay_dense(card, n):
    before = kernels.DENSE_SYNC_DELAY.launches
    row = _smoke().compare_sync_delay_dense(card, np.random.default_rng(n),
                                            n=n, timed=False)
    assert row["equal"], row
    assert kernels.DENSE_SYNC_DELAY.launches == before + 2


@pytest.mark.parametrize("n", (1200, 3001))
def test_dense_gaps_exit(card, n):
    before = kernels.DENSE_GAPS_FINISH_EXIT.launches
    row = _smoke().compare_dense_gaps_exit(card, np.random.default_rng(n),
                                           n=n, timed=False)
    assert row["equal"], row
    assert kernels.DENSE_GAPS_FINISH_EXIT.launches == before + 4


def test_packed_node_faults_wipe_full_view(card):
    """K11's word entry now also puts a wiped node's full-view row back
    to its init (view 0, vinc 0, suspect_since -1), as the plain
    version does."""
    from corrosion_tpu_torch.sim.topology import Topology

    n = 300
    cfg = SimConfig(n_nodes=n, n_payloads=64, swim_full_view=True,
                    packed_min_cells=0)
    plan = FaultPlan(n_nodes=n, seed=1, events=(
        FaultEvent("crash", 1, 3, node="5:9", wipe=True),))
    g = np.random.default_rng(3)
    view, vinc, since = (g.integers(0, 3, (n, n)), g.integers(0, 4, (n, n)),
                         g.integers(-1, 3, (n, n)))
    out = []
    for dev in (card, "cpu"):
        state = init_state(cfg, rng.prng_key(2, dev))
        state = state._replace(
            view=torch.as_tensor(view, dtype=torch.int8, device=dev),
            vinc=_i32(vinc, dev), suspect_since=_i32(since, dev))
        fplan = faults.compile_plan(plan, cfg, Topology(), factored=True,
                                    device=dev)
        slim, carry = packed.apply_round_faults(
            packed.shrink_state(state), packed.pack_state(state, cfg),
            faults.round_faults(fplan, 3))
        out.append((slim, carry))
    for got, want in zip(out[0][0], out[1][0]):
        assert torch.equal(got.cpu(), want)
    assert (out[1][0].view[5:9] == 0).all()


def _dense_fault_run(dev, telemetry, full_view=False):
    """JAX's 48-node "storm-mix" plan (tests/sim/test_packed_equivalence.py)
    on the dense round, or the full-view storm at 64 nodes."""
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import fault_storm
    from corrosion_tpu_torch.sim.topology import Topology

    if full_view:
        cfg, meta, fplan = fault_storm(
            64, 128, 3, dev, factored=True, swim_partial_view=False,
            swim_full_view=True, allow_packed=False)
        seed = 7
    else:
        cfg = SimConfig.wan_tuned(
            48, n_payloads=128, n_writers=4, chunks_per_version=4, fanout=3,
            sync_interval_rounds=4, swim_partial_view=True, member_slots=16,
            rate_limit_bytes_round=None, sync_budget_bytes=None,
            n_delay_slots=4, allow_packed=False)
        meta = uniform_payloads(cfg, dev, inject_every=2)
        plan = FaultPlan(n_nodes=48, seed=5, events=(
            FaultEvent("loss", 0, 20, p=0.3),
            FaultEvent("partition", 4, 14, src="0:24", dst="24:48",
                       symmetric=True),
            FaultEvent("delay", 2, 16, src="0:8", dst="*", delay_rounds=1),
            FaultEvent("jitter", 2, 16, src="0:8", dst="*", delay_rounds=1),
            FaultEvent("crash", 10, 22, node=2, wipe=True),
        ))
        fplan = faults.compile_plan(plan, cfg, Topology(), factored=True,
                                    device=dev)
        seed = 9
    return faults.run_fault_plan(new_sim(cfg, seed, dev), meta, cfg,
                                 Topology(), fplan, 300, telemetry)


@pytest.mark.parametrize("telemetry", (False, True))
@pytest.mark.parametrize("full_view", (False, True))
def test_dense_fault_run_on_card_equals_cpu(card, telemetry, full_view):
    """A fault plan on the dense round (the storm-mix plan: loss, a cut,
    the latency pair, a wipe; or the full-view storm) ends on the card in
    the CPU run's state and records its trace, through K11's dense entry,
    K12's fault entry, K14's exit mode (and K13's delay entry)."""
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim import telemetry as tel

    kernels.reset_launch_counts()
    out = _dense_fault_run(card, telemetry, full_view)
    used = [kernels.NODE_FAULTS_DENSE, kernels.DENSE_BROADCAST_FAULT,
            kernels.DENSE_GAPS_ROWS_EXIT, kernels.DENSE_GAPS_FINISH_EXIT]
    if not full_view:
        used.append(kernels.DENSE_SYNC_DELAY)
    for kern in used:
        assert kern.launches > 0, kern.name
    cpu = _dense_fault_run("cpu", telemetry, full_view)
    assert state_digest(out[0]) == state_digest(cpu[0])
    for a, b in zip(out[1], cpu[1]):
        assert torch.equal(a.cpu(), b)
    if telemetry:
        for f in tel.CHANNELS:
            assert torch.equal(getattr(out[2], f).cpu(), getattr(cpu[2], f)), f


# -- K9's matrix entry (K9m): a matrix plan's per-edge queries
# (chip_smoke.py's comparison, every trap reached, at small node counts;
# then whole matrix-plan runs on the card against the CPU)


@pytest.mark.parametrize("n, big", ((1000, 256), (333, 96)))
def test_fault_edges_matrix(card, n, big):
    before = (kernels.FAULT_EDGES_MATRIX.launches,
              kernels.FAULT_REACH_MATRIX.launches)
    rows = _smoke().compare_matrix_fault_kernels(card, n=n, big=big,
                                                 timed=False)
    assert all(row["equal"] for row in rows), rows
    assert kernels.FAULT_EDGES_MATRIX.launches > before[0]
    assert kernels.FAULT_REACH_MATRIX.launches > before[1]


def _matrix_run(dev, name):
    """A matrix-plan run: the 3-node fault campaign (run_fault_plan, or
    the checked driver with its digests), or the fault storm at 96 nodes
    on the packed round."""
    from corrosion_tpu_torch.faults import demo_plan
    from corrosion_tpu_torch.invariants import Catalog
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import _write_storm
    from corrosion_tpu_torch.sim.topology import Topology

    if name == "packed96":
        cfg, meta = _write_storm(96, 128, dev)
        cfg = dataclasses.replace(cfg, packed_min_cells=0)
        fplan = faults.compile_plan(storm_fault_plan(96, 0), cfg,
                                    factored=False, device=dev)
        return faults.run_fault_plan(new_sim(cfg, 0, dev), meta, cfg,
                                     Topology(), fplan, 300)
    cfg = SimConfig(n_nodes=3, n_payloads=16, fanout=2,
                    sync_interval_rounds=4, n_delay_slots=4)
    meta = uniform_payloads(cfg, dev, inject_every=1)
    if name == "checked":
        return faults.run_fault_plan_checked(
            demo_plan(seed=0), new_sim(cfg, 0, dev), meta, cfg,
            max_rounds=400, catalog=Catalog())
    fplan = faults.compile_plan(demo_plan(seed=0), cfg, device=dev)
    return faults.run_fault_plan(new_sim(cfg, 0, dev), meta, cfg, Topology(),
                                 fplan, 1000, name == "telemetry")


@pytest.mark.parametrize("name", ("campaign", "telemetry", "checked",
                                  "packed96"))
def test_matrix_run_on_card_equals_cpu(card, name):
    """A matrix-plan run ends on the card in the CPU run's state, metrics
    (and trace, digests), through K9m and never K9's factored entries."""
    from corrosion_tpu_torch.convert import state_digest

    kernels.reset_launch_counts()
    out = _matrix_run(card, name)
    assert kernels.FAULT_EDGES_MATRIX.launches > 0
    assert kernels.FAULT_EDGES.launches == kernels.FAULT_REACH.launches == 0
    if name == "packed96":
        assert kernels.FAULT_REACH_MATRIX.launches > 0
    cpu = _matrix_run("cpu", name)
    assert state_digest(out[0]) == state_digest(cpu[0])
    for a, b in zip(out[1], cpu[1]):
        assert torch.equal(a.cpu(), b)
    if name == "checked":
        assert out[2] == cpu[2] and len(out[2]) == 41
    if name == "telemetry":
        from corrosion_tpu_torch.sim import telemetry as tel

        for f in tel.CHANNELS:
            assert torch.equal(getattr(out[2], f).cpu(), getattr(cpu[2], f)), f


# -- the topology axis: K20, K21, K1's view entry, the tiered K10 and K12 ----


@pytest.mark.parametrize("n", (1201, 3001))
def test_topology_kernels(card, n):
    """chip_smoke.py's phase 3h comparisons at small node counts the
    regions and AZs do not divide, every trap reached."""
    cs = _smoke()
    g = np.random.default_rng(n)
    before = {k.name: k.launches for k in kernels.KERNELS}
    rows = (cs.compare_edge_slots(card, g, n, timed=False)
            + [cs.compare_degree_caps(card, g, n, timed=False)]
            + cs.compare_edge_reach(card, g, n, timed=False)
            + [cs.compare_scatter_tiered(card, g, n, timed=False),
               cs.compare_dense_tiered(card, g, n, timed=False)]
            + cs.compare_sample_view(card, g, n, timed=False)
            + cs.compare_peerswap(card, g, n, timed=False))
    assert all(row["equal"] for row in rows), rows
    for row in ("edge_slots", "degree_caps", "edge_reach",
                "broadcast_scatter_tiered", "dense_broadcast_tiered",
                "sample_view", "peerswap"):
        for kern in kernels.PORTED[row]:
            assert kern.launches > before[kern.name], kern.name


def _topology_run(dev, family, sampler, packed, telemetry):
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import _resolve_topo, _write_storm

    topo = _resolve_topo(family)
    cfg, meta = _write_storm(240, 128, dev, topo, sampler)
    change = dict(packed_min_cells=0) if packed else dict(allow_packed=False)
    cfg = dataclasses.replace(cfg, **change)
    return run_to_convergence(new_sim(cfg, 5, dev), meta, cfg, topo, 400,
                              telemetry)


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family, sampler, telemetry", (
    ("wan-3x2", None, True), ("wan-fly-6r", None, False),
    ("hetero-degree", "peerswap", False), ("wan-3x2", "peerswap", True)))
def test_topology_run_on_card_equals_cpu(card, family, sampler, telemetry,
                                         packed):
    """A small storm over each kind of topology and under PeerSwap on the
    card, every state tensor (the view included), metric and trace
    channel equal to the same run's plain versions on the CPU."""
    got = _topology_run(card, family, sampler, packed, telemetry)
    want = _topology_run(torch.device("cpu"), family, sampler, packed,
                         telemetry)
    for a, b in zip(got, want):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y), name


# -- the protocol axis: K10p, K12p, K8f, K12f-o, K22, K20's schedule, K18 pull


@pytest.mark.parametrize("n", (1201, 3001))
def test_protocol_kernels(card, n):
    """chip_smoke.py's phase 3i comparisons at small node counts, every
    trap reached."""
    cs = _smoke()
    g = np.random.default_rng(n)
    before = {k.name: k.launches for k in kernels.KERNELS}
    rows = (cs.compare_pull_scatter(card, g, n, timed=False)
            + cs.compare_dense_pull(card, g, timed=False)
            + cs.compare_fifo_deliver(card, g, n, timed=False)
            + cs.compare_order_check(card, g, n, timed=False)
            + cs.compare_caps_schedule(card, g, n, timed=False)
            + cs.compare_trace_wire_pull(card, g, n, timed=False))
    assert all(row["equal"] for row in rows), rows
    for row in ("broadcast_pull", "broadcast_pull_lossy",
                "broadcast_pull_tiered", "dense_pull", "dense_pull_lossy",
                "dense_pull_tiered", "word_deliver_fifo", "dense_deliver_fifo",
                "order_check_words", "order_check_dense", "degree_caps_sched",
                "trace_wire_pull", "trace_wire_rows_pull"):
        for kern in kernels.PORTED[row]:
            assert kern.launches > before[kern.name], kern.name


def _protocol_run(dev, family, topo_family, packed, telemetry, plan=False):
    from corrosion_tpu_torch.sim import faults as pfaults
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import _resolve_topo, _write_storm

    topo = _resolve_topo(topo_family)
    cfg, meta = _write_storm(240, 128, dev, topo, None, family)
    change = dict(packed_min_cells=0) if packed else dict(allow_packed=False)
    cfg = dataclasses.replace(cfg, **change)
    if plan:
        fplan = pfaults.compile_plan(_smoke().one_way_plan(240), cfg, topo,
                                     device=dev)
        return pfaults.run_fault_plan(new_sim(cfg, 5, dev), meta, cfg, topo,
                                      fplan, 600, telemetry)
    return run_to_convergence(new_sim(cfg, 5, dev), meta, cfg, topo, 600,
                              telemetry)


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family, topo_family, telemetry, plan", (
    ("push-pull", "wan-3x2", True, False), ("push-pull", "flat-lossy", True,
                                             True),
    ("lab-ordered", None, False, True), ("lab-ordered-broken", "flat-lossy",
                                         False, False),
    ("fanout-decay", "hetero-degree", False, False),
    ("swarm-aggressive", None, True, False)))
def test_protocol_run_on_card_equals_cpu(card, family, topo_family,
                                         telemetry, plan, packed):
    """A small storm under each protocol family on the card (push-pull
    and FIFO also under a one-way plan), every state tensor, metric (the
    order count included) and trace channel equal to the same run's plain
    versions on the CPU."""
    got = _protocol_run(card, family, topo_family, packed, telemetry, plan)
    want = _protocol_run(torch.device("cpu"), family, topo_family, packed,
                         telemetry, plan)
    for a, b in zip(got, want):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y), name


# -- membership churn: K23's two entries, K11's PeerSwap view row -------------


def test_churn_kernels(card):
    """chip_smoke.py's phase 3j comparisons at small shapes (full view at
    N = 33, 100 and 257, and 1001 whose rows do not start on words;
    partial view at N = 301 and 2999, M = 64; K11's view row at 3000
    nodes on the word entry), every trap reached."""
    cs = _smoke()
    g = np.random.default_rng(12)
    before = {k.name: k.launches for k in kernels.KERNELS}
    rows = (cs.compare_detect_full(card, g, (33, 100, 257), timed=False)
            + cs.compare_detect_partial(card, g, (301, 2999), timed=False)
            + cs.compare_node_faults_view(card, g, 3000, timed=False))
    assert all(row["equal"] for row in rows), rows
    for row in ("detect_full", "detect_partial", "node_faults",
                "node_faults_dense"):
        for kern in kernels.PORTED[row]:
            assert kern.launches > before[kern.name], kern.name


@pytest.mark.parametrize("n, partial", ((64, False), (96, False),
                                        (300, True), (1000, True)))
def test_detect_run_on_card_equals_cpu(card, n, partial):
    """A membership-churn detect run on the card — K23 after every round
    — and with the recorder: the final state, metrics, detect_round and
    every trace channel equal to the same run's plain versions on the
    CPU."""
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.telemetry import run_membership_detect
    from corrosion_tpu_torch.sim.topology import Topology

    tier = (dict(swim_partial_view=True, probe_period_rounds=1) if partial
            else dict(swim_full_view=True))
    cfg = SimConfig.wan_tuned(n, n_payloads=1, **tier)
    outs = []
    for dev in (card, torch.device("cpu")):
        meta, state = churn_setup(cfg, 3, dev)
        outs.append(run_membership_detect(state, meta, cfg, Topology(), 300,
                                          telemetry=True, device=dev))
    got, want = outs
    assert int(got[2]) == int(want[2])
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y), name


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", (None, "wan-3x2"))
def test_peerswap_fault_run_on_card_equals_cpu(card, family, packed):
    """A PeerSwap storm under a flash crowd (the tail quarter back wiped,
    K11's view row) and a loss burst on the card: every state tensor (the
    view included) and metric equal to the same run's plain versions on
    the CPU."""
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import _resolve_topo, _write_storm
    from corrosion_tpu_torch.topo import flash_crowd_events

    n = 240
    plan = FaultPlan(n_nodes=n, seed=2, events=(
        *flash_crowd_events(n, join_round=6),
        FaultEvent("loss", 2, 10, p=0.2)))
    outs = []
    for dev in (card, torch.device("cpu")):
        topo = _resolve_topo(family)
        cfg, meta = _write_storm(n, 128, dev, topo, "peerswap")
        change = (dict(packed_min_cells=0) if packed
                  else dict(allow_packed=False))
        cfg = dataclasses.replace(cfg, **change)
        fplan = faults.compile_plan(plan, cfg, topo, factored=True,
                                    device=dev)
        outs.append(faults.run_fault_plan(new_sim(cfg, 5, dev), meta, cfg,
                                          topo, fplan, 600))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y), name


# -- the seed ensembles' lane entries (B16p) ---------------------------------


@pytest.mark.parametrize("lanes, n", ((2, 1201), (3, 3001)))
def test_lane_kernels(card, lanes, n):
    """chip_smoke's phase 3k at small and ragged shapes: every lane entry
    equal to its plain version, and each lane to the solo entry on its
    inputs (K10 also at 16 lanes); two lanes at least, so that the lanes'
    draws, overflow counts and done flags can differ."""
    rows = _smoke().compare_lane_kernels(card, lanes=lanes, n=n,
                                         timed=False)
    assert all(r["equal"] for r in rows), [r["name"] for r in rows
                                           if not r["equal"]]


@pytest.mark.parametrize("faults_on", (False, True), ids=("storm", "fault"))
def test_ensemble_on_card_equals_cpu(card, faults_on):
    """Three lanes of the storm (or the fault storm) through the engine's
    ensemble on the card: every lane state tensor and metric equal to the
    same ensemble's plain versions on the CPU, and each lane to the card's
    solo run of its seed."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.campaign.spec import (
        CampaignSpec, storm_fault_events, storm_scenario)
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    n, seeds = 1280, (0, 3, 5)
    spec = CampaignSpec(
        name="lanes", scenario=dict(storm_scenario(n), n_payloads=64,
                                    packed_min_cells=0),
        events=storm_fault_events(n) if faults_on else (), seeds=seeds)
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = spec.fault_plan({}, seed=0)
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(plan, cfg, topo, meta, seeds,
                                      max_rounds=3000, device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(seeds):
        state = new_sim(cfg, s, card)
        if plan is None:
            solo, _ = run_to_convergence(state, meta, cfg, topo, 3000)
        else:
            fp = faults.compile_plan(dataclasses.replace(plan, seed=s), cfg,
                                     topo, device=card)
            solo, _ = faults.run_fault_plan(state, meta, cfg, topo, fp, 3000)
        for name, x, y in zip(solo._fields, solo, lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)


# -- the dense round's lane entries (B16, dense half) -------------------------


DENSE_LANE_CASES = {
    "dense_phases": lambda s, dev, g: s.compare_lane_dense_phases(
        dev, g, 3, n=301, timed=False),
    "dense_phases_p1": lambda s, dev, g: s.compare_lane_dense_phases(
        dev, g, 2, n=3001, p=1, timed=False),
    "dense_sync": lambda s, dev, g: s.compare_lane_dense_sync(
        dev, g, 3, n=301, timed=False),
    "dense_sync_p1": lambda s, dev, g: s.compare_lane_dense_sync(
        dev, g, 2, n=3001, p=1, timed=False),
    "dense_gaps": lambda s, dev, g: s.compare_lane_dense_gaps(
        dev, g, 3, n=301, timed=False),
    "dense_gaps_p1": lambda s, dev, g: s.compare_lane_dense_gaps(
        dev, g, 4, n=3001, p=1, timed=False),
    "swim_full": lambda s, dev, g: s.compare_lane_swim_full(
        dev, g, 3, n=257, timed=False),
    "sample_uniform": lambda s, dev, g: s.compare_lane_sample_uniform(
        dev, g, 3, n=257, timed=False),
    "detect": lambda s, dev, g: s.compare_lane_detect(
        dev, g, 5, timed=False, full_n=301, partial_n=3001),
}


@pytest.mark.parametrize("case", sorted(DENSE_LANE_CASES))
def test_dense_lane_kernels(card, case):
    """chip_smoke's phase 3l at small and ragged shapes: each dense lane
    entry (K12's three, K13, K14's two, K15's three, K1's uniform entry,
    K23's two) equal to its plain version, each lane to the solo entry on
    its inputs, binding budgets and lane-varying done flags included."""
    out = DENSE_LANE_CASES[case](_smoke(), card,
                                 np.random.default_rng(len(case)))
    rows = out if isinstance(out, list) else [out]
    assert all(r["equal"] for r in rows), [r["name"] for r in rows
                                           if not r["equal"]]


@pytest.mark.parametrize("tier", ("ground", "full", "partial", "metered"))
def test_dense_ensemble_on_card_equals_cpu(card, tier):
    """Three lanes on the dense round through the engine's ensemble on
    the card: every lane tensor and metric equal to the same ensemble's
    plain versions on the CPU, and each lane to the card's solo run."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.campaign.spec import CampaignSpec
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    extra = {"ground": {}, "full": {"swim_full_view": True},
             "partial": {"swim_partial_view": True, "member_slots": 16},
             "metered": {"rate_limit_bytes_round": 3 * 8192 + 100,
                         "sync_budget_bytes": 2 * 8192}}[tier]
    seeds = (0, 2, 4)
    spec = CampaignSpec(name="dense", scenario=dict(
        n_nodes=96, n_payloads=64, n_writers=4, fanout=3, n_delay_slots=4,
        inject_every=2, **extra), seeds=seeds)
    cfg, topo = spec.sim_config({}), spec.topo({})
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(None, cfg, topo, meta, seeds,
                                      max_rounds=3000, device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(seeds):
        solo, _ = run_to_convergence(new_sim(cfg, s, card), meta, cfg, topo,
                                     3000)
        for name, x, y in zip(solo._fields, solo, lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)


@pytest.mark.parametrize("n, partial", ((64, False), (512, True)))
def test_detect_ensemble_on_card_equals_cpu(card, n, partial):
    """Three lanes of the detect loop (K23's lane entries) on the card:
    finals, metrics and detect rounds equal to the CPU's plain lanes,
    each lane to the card's solo `run_membership_detect`."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_detect_ensemble)
    from corrosion_tpu_torch.campaign.spec import (
        swim_churn_64_spec, swim_churn_partial_spec)
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.telemetry import run_membership_detect

    seeds = (0, 1, 2)
    spec = (swim_churn_partial_spec(seeds=seeds, n=n, max_rounds=300)
            if partial else swim_churn_64_spec(seeds=seeds, n=n))
    cfg, topo = spec.sim_config({}), spec.topo({})
    outs = [run_detect_ensemble(
        cfg, topo, uniform_payloads(cfg, dev, inject_every=1), seeds,
        kill_every=3, max_rounds=spec.max_rounds, device=dev)
        for dev in (card, torch.device("cpu"))]
    for x, y in zip(outs[0][:2], outs[1][:2]):
        for name, a, b in zip(type(y)._fields, x, y):
            assert torch.equal(a.cpu(), b.cpu()), name
    assert torch.equal(outs[0][2].cpu(), outs[1][2])
    for k, s in enumerate(seeds):
        meta, state = churn_setup(cfg, s, card)
        solo, _, det = run_membership_detect(state, meta, cfg, topo,
                                             spec.max_rounds, device=card)
        assert int(det) == int(outs[0][2][k])
        for name, a, b in zip(solo._fields, solo, lane_state(outs[0][0], k)):
            assert torch.equal(a.cpu(), b.cpu()), (k, name)


# -- the dense fault loop's lane entries (B16d, faults) -----------------------


DENSE_FAULT_LANE_CASES = {
    "reach_matrix": lambda s, dev, g, gen: s.compare_lane_reach_matrix(
        dev, g, 3, n=333, timed=False),
    "node_faults_dense": lambda s, dev, g, gen:
        s.compare_lane_node_faults_dense(dev, gen, 3, n=3001, full_n=257,
                                         timed=False),
    "broadcast_fault": lambda s, dev, g, gen: s.compare_lane_broadcast_fault(
        dev, gen, 3, n=3001, timed=False),
    "sync_delay": lambda s, dev, g, gen: s.compare_lane_sync_delay(
        dev, g, gen, 3, n=3001, timed=False),
    "gaps_exit": lambda s, dev, g, gen: s.compare_lane_gaps_exit(
        dev, gen, 4, n=3001, timed=False),
}


@pytest.mark.parametrize("case", sorted(DENSE_FAULT_LANE_CASES))
def test_dense_fault_lane_kernels(card, case):
    """chip_smoke's phase 3lf at small and ragged shapes: K9m's reach,
    K11d, K12f, K13d and K14x lane entries equal to their plain versions,
    each lane to the solo entry on its inputs, every trap reached."""
    gen = torch.Generator(device=card)
    gen.manual_seed(len(case))
    row = DENSE_FAULT_LANE_CASES[case](
        _smoke(), card, np.random.default_rng(len(case)), gen)
    assert row["equal"], row["name"]


@pytest.mark.parametrize("case", ("parity", "latency_partial",
                                  "storm_full_view"))
def test_dense_fault_ensemble_on_card_equals_cpu(card, case):
    """Lanes of the dense fault loop through the engine's ensemble on the
    card: the 3-node parity campaign's matrix plan (four seeds), a
    96-node storm with the latency pair on partial view and the fault
    storm on full view (three seeds, factored): every lane tensor and
    metric equal to the same ensemble's plain versions on the CPU, and
    each lane to the card's solo `run_fault_plan` of its seed."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.sim.round import new_sim

    if case == "parity":
        spec = sp.fault_parity_3node_spec((0, 1, 2, 3))
    else:
        latency = case == "latency_partial"
        spec = sp.dense_storm_seeds_spec((0, 2, 4), latency=latency)
        events = sp.storm_fault_events(96) + (
            sp.storm_latency_events(96) if latency else ())
        if case == "storm_full_view":
            scenario = dict(spec.scenario, swim_partial_view=False,
                            swim_full_view=True, n_payloads=64)
        else:
            scenario = dict(spec.scenario, n_payloads=64, member_slots=16)
        spec = dataclasses.replace(spec, scenario=dict(scenario, n_nodes=96),
                                   events=events)
    cfg, topo = spec.sim_config({}), spec.topo({})
    every = spec.inject_every({})
    plan = spec.fault_plan({}, seed=spec.seeds[0])
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=every)
        outs.append(run_seed_ensemble(plan, cfg, topo, meta, spec.seeds,
                                      max_rounds=spec.max_rounds,
                                      device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=every)
    for k, s in enumerate(spec.seeds):
        fp = faults.compile_plan(spec.fault_plan({}, seed=s), cfg, topo,
                                 device=card)
        solo, _ = faults.run_fault_plan(new_sim(cfg, s, card), meta, cfg,
                                        topo, fp, spec.max_rounds)
        for name, x, y in zip(solo._fields, solo, lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)


# -- the flight recorder on the dense round's lanes (B16r) --------------------


TRACE_LANE_CASES = {
    "coverage_dense": lambda s, dev, g, gen: [s.compare_lane_coverage_dense(
        dev, gen, 3, n=3001, p=96, timed=False)],
    "wire_rows": lambda s, dev, g, gen: [s.compare_lane_wire_rows(
        dev, gen, 3, n=3001, timed=False)],
    "trace_row": lambda s, dev, g, gen: [s.compare_lane_trace_row(
        dev, gen, 3, n=3001, p=96, full_n=257, timed=False)],
    "broadcast_trace": lambda s, dev, g, gen: s.compare_lane_broadcast_trace(
        dev, g, gen, 3, n=3001, n1k=301, timed=False),
    "sync_trace": lambda s, dev, g, gen: s.compare_lane_sync_trace(
        dev, g, gen, 3, n=3001, timed=False),
    "fault_counts": lambda s, dev, g, gen: s.compare_lane_fault_counts(
        dev, gen, 3, n=3001, mid=333, timed=False),
}


@pytest.mark.parametrize("case", sorted(TRACE_LANE_CASES))
def test_trace_lane_kernels(card, case):
    """chip_smoke's phase 3lr at small and ragged shapes: K17's dense
    lane entry, K18's rows lane entry, K19's lane entry, the recording
    forms of K12, K12f, K13 and K13d and the lane-strided counts of K9,
    its latency entry and K9m equal to their plain versions, each lane
    to the solo entry on its inputs, every trap reached."""
    gen = torch.Generator(device=card)
    gen.manual_seed(len(case))
    rows = TRACE_LANE_CASES[case](_smoke(), card,
                                  np.random.default_rng(len(case)), gen)
    assert all(row["equal"] for row in rows), [r["name"] for r in rows]


@pytest.mark.parametrize("case", ("parity", "churn_partial", "every2"))
def test_trace_ensemble_on_card_equals_cpu(card, case):
    """Recording lanes through the engine's ensembles on the card: the
    3-node parity campaign (four seeds, matrix plan), a 256-node
    partial-view detect ensemble (three seeds) and the parity campaign at
    trace_every 2 (two seeds): every lane tensor, metric and trace field
    equal to the same ensemble's plain versions on the CPU."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.campaign.ensemble import (
        run_detect_ensemble, run_seed_ensemble)

    if case == "churn_partial":
        spec = sp.swim_churn_partial_spec(seeds=(0, 1, 2), n=256,
                                          max_rounds=150)
    else:
        spec = sp.fault_parity_3node_spec(
            (0, 1, 2, 3) if case == "parity" else (0, 1))
        if case == "every2":
            spec = dataclasses.replace(spec, scenario=dict(
                spec.scenario, trace_every=2))
    cfg, topo = spec.sim_config({}), spec.topo({})
    detect = spec.detect_membership({})
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev,
                                inject_every=1 if detect
                                else spec.inject_every({}))
        if detect:
            out = run_detect_ensemble(cfg, topo, meta, spec.seeds,
                                      kill_every=spec.kill_every({}),
                                      max_rounds=spec.max_rounds,
                                      telemetry=True, device=dev)
        else:
            out = run_seed_ensemble(spec.fault_plan({}, seed=spec.seeds[0]),
                                    cfg, topo, meta, spec.seeds,
                                    max_rounds=spec.max_rounds,
                                    telemetry=True, device=dev)
        outs.append(out)
    for a, b in zip(*outs):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a.cpu(), b.cpu())
            continue
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name


# -- topology families and PeerSwap on the dense round's lanes (B16t, B16s) ---


TOPO_LANE_CASES = {
    "edge_slots": lambda s, dev, g, gen: s.compare_lane_edge_slots(
        dev, g, 3, n=3001, n1k=301, timed=False),
    "degree_caps": lambda s, dev, g, gen: [s.compare_lane_degree_caps(
        dev, g, 3, n=97, timed=False)],
    "edge_reach": lambda s, dev, g, gen: s.compare_lane_edge_reach(
        dev, g, 3, n=3001, timed=False),
    "broadcast_tiered": lambda s, dev, g, gen: s.compare_lane_broadcast_tiered(
        dev, g, gen, 3, n=3001, n1k=301, timed=False),
    "sample_view": lambda s, dev, g, gen: s.compare_lane_sample_view(
        dev, g, 3, n=301, timed=False),
    "peerswap": lambda s, dev, g, gen: s.compare_lane_peerswap(
        dev, g, 3, n=301, timed=False),
}


@pytest.mark.parametrize("case", sorted(TOPO_LANE_CASES))
def test_topology_lane_kernels(card, case):
    """chip_smoke's phase 3lt at small and ragged shapes: K20's slots,
    caps and reach lane entries, K12t's lane entry and its recording
    form, K1's view lane entry and K21's lane entries equal to their
    plain versions, each lane to the solo entry on its inputs, every trap
    reached."""
    gen = torch.Generator(device=card)
    gen.manual_seed(len(case))
    rows = TOPO_LANE_CASES[case](_smoke(), card,
                                 np.random.default_rng(len(case)), gen)
    assert all(row["equal"] for row in rows), [r["name"] for r in rows]


@pytest.mark.parametrize("case", ("wan-3x2/peerswap", "wan-2region/full",
                                  "flat-lossy/partial", "wan-fly-6r/ground",
                                  "hetero-degree/peerswap-full"))
def test_topology_ensemble_on_card_equals_cpu(card, case):
    """Topology families and PeerSwap on the dense lanes through the
    ensemble, three seeds at 96 nodes, on the card and on the CPU: every
    lane tensor and metric equal, and each lane the card's solo run of
    its seed."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    family, tier = case.split("/")
    scenario = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4, "fanout": 3,
                "n_delay_slots": 6, "inject_every": 2, "topo_family": family}
    scenario.update({
        "peerswap": {"peer_sampler": "peerswap"},
        "peerswap-full": {"peer_sampler": "peerswap", "swim_full_view": True},
        "full": {"swim_full_view": True},
        "partial": {"swim_partial_view": True, "member_slots": 16},
        "ground": {}}[tier])
    spec = sp.CampaignSpec(name=case, scenario=scenario, seeds=(0, 1, 2))
    cfg, topo = spec.sim_config({}), spec.topo({})
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(None, cfg, topo, meta, spec.seeds,
                                      max_rounds=spec.max_rounds,
                                      device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(spec.seeds):
        solo, _ = run_to_convergence(new_sim(cfg, s, card), meta, cfg, topo,
                                     spec.max_rounds)
        for name, x, y in zip(solo._fields, solo, lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)


# -- the protocol variants on the dense round's lanes (B16v, B16s-f) ----------


PROTO_LANE_CASES = {
    "dense_pull": lambda s, dev, g, gen: s.compare_lane_dense_pull(
        dev, g, gen, 3, n=3001, n1k=301, timed=False),
    "fifo_deliver": lambda s, dev, g, gen: s.compare_lane_fifo_deliver(
        dev, g, 3, n=97, n1k=301, timed=False),
    "order_check": lambda s, dev, g, gen: s.compare_lane_order_check(
        dev, g, 3, n=97, n1k=301, timed=False),
    "caps_schedule": lambda s, dev, g, gen: s.compare_lane_caps_schedule(
        dev, g, 3, n=301, timed=False),
    "wire_rows_pull": lambda s, dev, g, gen: s.compare_lane_wire_rows_pull(
        dev, g, 3, n=97, timed=False),
}


@pytest.mark.parametrize("case", sorted(PROTO_LANE_CASES))
def test_protocol_lane_kernels(card, case):
    """chip_smoke's phase 3lv at small and ragged shapes: K12p's lane
    entry and its recording forms, K12f-o's, K22's u8, K20's schedule and
    K18's rows-pull lane entries equal to their plain versions, each lane
    to the solo entry on its inputs, every trap reached."""
    gen = torch.Generator(device=card)
    gen.manual_seed(len(case))
    rows = PROTO_LANE_CASES[case](_smoke(), card,
                                  np.random.default_rng(len(case)), gen)
    assert all(row["equal"] for row in rows), [r["name"] for r in rows]


@pytest.mark.parametrize("case", ("push-pull/flat-lossy", "push-pull/wan-3x2",
                                  "push-pull/flat-lossy/no-recorder",
                                  "push-pull/wan-3x2/no-recorder",
                                  "swarm-aggressive/wan-3x2",
                                  "fanout-decay/hetero-degree",
                                  "lab-ordered/",
                                  "lab-ordered-broken/flat-lossy",
                                  "peerswap-fault/wan-3x2"))
def test_protocol_ensemble_on_card_equals_cpu(card, case):
    """The protocol variants (and PeerSwap under the fault storm's plan)
    on the dense lanes through the campaign engine, three seeds at 96
    nodes, on the card and on the CPU: the same artifact (wire bytes and
    order counts banded; push-pull also without the recorder, K12p's
    forms without a dropped slot), every lane tensor and metric equal,
    and each lane the card's solo run of its seed."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    family, topo_family, *no_recorder = case.split("/")
    if family == "peerswap-fault":
        spec = sp.broadcast_peerswap_fault_seeds_spec((0, 1, 2))
        spec = dataclasses.replace(
            spec, name=case, scenario=dict(spec.scenario, n_nodes=96),
            events=sp.storm_fault_events(96))
    else:
        scenario = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4,
                    "fanout": 3, "n_delay_slots": 4, "inject_every": 2,
                    "proto_family": family}
        if not no_recorder:
            scenario["measure_wire"] = 1
        if topo_family:
            scenario["topo_family"] = topo_family
        spec = sp.CampaignSpec(name=case, scenario=scenario, seeds=(0, 1, 2))
    arts, kept = [], []
    for dev in (card, torch.device("cpu")):
        kept.append({})
        arts.append(run_campaign(spec, device=dev, lanes_out=kept[-1]))
    assert arts[0]["result_digest"] == arts[1]["result_digest"]
    assert arts[0]["cells"][0]["per_seed"] == arts[1]["cells"][0]["per_seed"]
    for key in ("finals", "metrics"):
        for name, x, y in zip(type(kept[1][0][key])._fields, kept[0][0][key],
                              kept[1][0][key]):
            assert torch.equal(x.cpu(), y.cpu()), (key, name)
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, card, inject_every=spec.inject_every({}))
    for k, s in enumerate(spec.seeds):
        plan = spec.fault_plan({}, seed=s)
        if plan is None:
            solo, metrics = run_to_convergence(new_sim(cfg, s, card), meta,
                                               cfg, topo, spec.max_rounds)
        else:
            solo, metrics = run_fault_plan(
                new_sim(cfg, s, card), meta, cfg, topo,
                compile_plan(plan, cfg, topo, device=card), spec.max_rounds)
        for name, x, y in zip(solo._fields, solo,
                              lane_state(kept[0][0]["finals"], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)
        assert int(metrics.order_violations) == int(
            kept[0][0]["metrics"].order_violations[k])


# -- latency plans and the recorder on the packed round's lanes (B16l, B16r) --


@pytest.mark.parametrize("lanes, n", ((2, 1201), (3, 3001)))
def test_packed_lane_latency_kernels(card, lanes, n):
    """chip_smoke's phase 3lp at small and ragged shapes: K10j's lane
    entry, K3's delay lane entry, the recording forms of K10's, K10j's and
    K3's lane entries and K17's and K18's word lane entries equal to
    their plain versions, lanes 0 and K - 1 to the solo entries on their
    inputs, every trap reached."""
    smoke = _smoke()
    g = np.random.default_rng(lanes + n)
    rows = smoke.compare_packed_lane_scatter_jitter(card, g, lanes, n,
                                                    timed=False)
    sync_rows, granted = smoke.compare_packed_lane_sync_delay(
        card, g, lanes, n, timed=False)
    rows += sync_rows + smoke.compare_packed_lane_trace_words(
        card, g, lanes, granted, n, timed=False)
    assert all(r["equal"] for r in rows), [r["name"] for r in rows
                                           if not r["equal"]]


@pytest.mark.parametrize("case", ("latency", "latency_telemetry",
                                  "fault_telemetry"))
def test_packed_latency_ensemble_on_card_equals_cpu(card, case):
    """Three lanes of the latency storm (and, recording, of it and of the
    fault storm) at 1280 × 64 through the engine's ensemble on the card's
    packed round: every lane tensor, metric and trace field equal to the
    same ensemble's plain versions on the CPU, and each lane's state (and
    trace) to the card's solo run of its seed."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.campaign.spec import (
        CampaignSpec, storm_fault_events, storm_latency_events,
        storm_scenario)
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.telemetry import lane_trace

    n, seeds = 1280, (0, 3, 5)
    scenario = dict(storm_scenario(n), n_payloads=64, packed_min_cells=0)
    events = storm_fault_events(n)
    if case.startswith("latency"):
        scenario["n_delay_slots"] = 4
        events += storm_latency_events(n)
    spec = CampaignSpec(name="lanes", scenario=scenario, events=events,
                        seeds=seeds)
    telemetry = case.endswith("telemetry")
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = spec.fault_plan({}, seed=0)
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(plan, cfg, topo, meta, seeds,
                                      max_rounds=80, telemetry=telemetry,
                                      device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(seeds):
        fp = faults.compile_plan(dataclasses.replace(plan, seed=s), cfg,
                                 topo, device=card)
        solo = faults.run_fault_plan(new_sim(cfg, s, card), meta, cfg, topo,
                                     fp, 80, telemetry=telemetry)
        for name, x, y in zip(solo[0]._fields, solo[0],
                              lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)
        if telemetry:
            for name, x, y in zip(solo[2]._fields, solo[2],
                                  lane_trace(outs[0][2], k)):
                assert torch.equal(x.cpu(), y.cpu()), (k, name)


@pytest.mark.parametrize("lanes, n, n_wan", ((3, 1283, 1200), (4, 2051, 3001)))
def test_packed_lane_metered_kernels(card, lanes, n, n_wan):
    """chip_smoke's phase 3lm at small and ragged shapes: K16 on the
    lanes' rows, K3m's lane entry (delay classes, recording form), K10's
    flat topology stream on the lanes and the tiered lane instantiation
    (with the fault loss, the jitter and as recording forms) and K11's
    lane entry with the full view's tables equal to their plain versions,
    lanes 0 and K - 1 to the solo entries on their inputs, every trap
    reached."""
    smoke = _smoke()
    g = np.random.default_rng(lanes + n)
    rows = smoke.compare_packed_lane_budget(card, g, lanes, n, timed=False)
    rows += smoke.compare_packed_lane_sync_metered(card, g, lanes, n,
                                                   timed=False)
    rows += smoke.compare_packed_lane_scatter_topo(card, g, lanes, n, n_wan,
                                                   timed=False)
    smoke.compare_packed_lane_node_faults_view(card, g, lanes, 1031)
    assert all(r["equal"] for r in rows), [r["name"] for r in rows
                                           if not r["equal"]]


def _axis_spec(case):
    """The packed lanes' new axes at 1280 × 64 (the envelope forced open):
    a topology family, PeerSwap under ground truth, full view under the
    latency storm's plan (node 1 wiped at round 20), a metered storm."""
    from corrosion_tpu_torch.campaign.spec import (
        CampaignSpec, storm_fault_events, storm_latency_events,
        storm_scenario)

    n = 1280
    scenario = dict(storm_scenario(n), n_payloads=64, packed_min_cells=0)
    events = ()
    if case in ("wan-3x2", "hetero-degree"):
        scenario.update(topo_family=case, n_delay_slots=3)
    elif case == "peerswap":
        scenario.update(peer_sampler="peerswap", swim_partial_view=False)
    elif case == "full_view_plan":
        scenario.update(swim_partial_view=False, swim_full_view=True,
                        n_delay_slots=4)
        events = storm_fault_events(n) + storm_latency_events(n)
    else:
        scenario.update(rate_limit_bytes_round=64 * 1024,
                        sync_budget_bytes=48 * 1024)
    return CampaignSpec(name=case, scenario=scenario, events=events,
                        seeds=(0, 3, 5))


@pytest.mark.parametrize("case, telemetry", (
    ("wan-3x2", True), ("hetero-degree", False), ("peerswap", False),
    ("full_view_plan", True), ("metered", True)))
def test_packed_axis_ensemble_on_card_equals_cpu(card, case, telemetry):
    """Three lanes of each new packed-lane axis at 1280 × 64 (wan-3x2
    with the recorder, hetero-degree, PeerSwap under ground truth, full
    view under a latency plan that wipes a node, both byte budgets
    binding) through the engine's ensemble on the card: every lane tensor,
    metric and trace field equal to the same ensemble's plain versions on
    the CPU, and each lane's state (and trace) to the card's solo run of
    its seed."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.telemetry import lane_trace

    spec = _axis_spec(case)
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = spec.fault_plan({}, seed=0)
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(plan, cfg, topo, meta, spec.seeds,
                                      max_rounds=120, telemetry=telemetry,
                                      device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(spec.seeds):
        state = new_sim(cfg, s, card)
        if plan is None:
            solo = run_to_convergence(state, meta, cfg, topo, 120,
                                      telemetry)
        else:
            fp = faults.compile_plan(dataclasses.replace(plan, seed=s), cfg,
                                     topo, device=card)
            solo = faults.run_fault_plan(state, meta, cfg, topo, fp, 120,
                                         telemetry=telemetry)
        for name, x, y in zip(solo[0]._fields, solo[0],
                              lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)
        if telemetry:
            for name, x, y in zip(solo[2]._fields, solo[2],
                                  lane_trace(outs[0][2], k)):
                assert torch.equal(x.cpu(), y.cpu()), (k, name)


@pytest.mark.parametrize("lanes, n, w", ((3, 1203, 16), (4, 2051, 4)))
def test_packed_lane_protocol_kernels(card, lanes, n, w):
    """chip_smoke's phase 3lq at small and ragged shapes: K10p's lane
    entry (its three streams, their recording forms and the checks: flat
    and fault streams together, a severed flat channel, tiers with the
    fault stream, a tier at certainty), K18's words-pull, K8f's and K22's
    words lane entries equal to their plain versions, lanes 0 and K - 1 to
    the solo entries on their inputs, every trap reached."""
    smoke = _smoke()
    g = np.random.default_rng(lanes + n)
    rows = smoke.compare_packed_lane_pull(card, g, lanes, n, False, w=w)
    rows += smoke.compare_packed_lane_wire_pull(card, g, lanes, n, False,
                                                w=w)
    rows += smoke.compare_packed_lane_fifo(card, g, lanes, n, False)
    rows += smoke.compare_packed_lane_order_words(card, g, lanes, n, False)
    assert len(rows) == 8
    assert all(r["equal"] for r in rows), [r["name"] for r in rows
                                           if not r["equal"]]


def _proto_spec(case):
    """The packed lanes' protocol variants at 1280 nodes (the envelope
    forced open): each family, push-pull over wan-3x2 or under the latency
    storm's plan, every knob at once over wan-3x2 under PeerSwap with both
    budgets and the plan."""
    from corrosion_tpu_torch.campaign.spec import (
        CampaignSpec, storm_fault_events, storm_latency_events,
        storm_scenario)

    n = 1280
    family, _, extra = case.partition("/")
    scenario = dict(storm_scenario(n), n_payloads=128, packed_min_cells=0,
                    proto_family=family)
    events = ()
    if extra == "wan-3x2":
        scenario.update(topo_family="wan-3x2", n_delay_slots=3)
    elif extra == "plan":
        scenario.update(n_delay_slots=4)
        events = storm_fault_events(n) + storm_latency_events(n)
    elif extra == "every-knob":
        del scenario["proto_family"]
        scenario.update(
            dissemination="push-pull",
            fanout_schedule="decay", fanout_decay_rounds=4,
            sync_cadence="eager", ordering="fifo", topo_family="wan-3x2",
            n_delay_slots=6, peer_sampler="peerswap",
            swim_partial_view=False, rate_limit_bytes_round=40 * 8192,
            sync_budget_bytes=20 * 8192)
        events = storm_fault_events(n) + storm_latency_events(n)
    return CampaignSpec(name=case, scenario=scenario, events=events,
                        seeds=(0, 3, 5))


@pytest.mark.parametrize("case, telemetry", (
    ("push-pull", False), ("push-pull/wan-3x2", True),
    ("push-pull/plan", True), ("lab-ordered", False),
    ("lab-ordered-broken", False), ("swarm-aggressive", False),
    ("fanout-decay", False), ("knobs/every-knob", True)))
def test_packed_proto_ensemble_on_card_equals_cpu(card, case, telemetry):
    """Three lanes of each protocol variant on the packed round's lanes at
    1280 × 128 through the engine's ensemble on the card: every lane
    tensor, metric (the order count too) and trace field equal to the same
    ensemble's plain versions on the CPU, and each lane's state, metrics
    (and trace) to the card's solo run of its seed."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_state, run_seed_ensemble)
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.telemetry import lane_trace

    spec = _proto_spec(case)
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = spec.fault_plan({}, seed=0)
    outs = []
    for dev in (card, torch.device("cpu")):
        meta = uniform_payloads(cfg, dev, inject_every=2)
        outs.append(run_seed_ensemble(plan, cfg, topo, meta, spec.seeds,
                                      max_rounds=400, telemetry=telemetry,
                                      device=dev))
    for a, b in zip(*outs):
        for name, x, y in zip(type(b)._fields, a, b):
            assert torch.equal(x.cpu(), y.cpu()), name
    meta = uniform_payloads(cfg, card, inject_every=2)
    for k, s in enumerate(spec.seeds):
        state = new_sim(cfg, s, card)
        if plan is None:
            solo = run_to_convergence(state, meta, cfg, topo, 400,
                                      telemetry)
        else:
            fp = faults.compile_plan(dataclasses.replace(plan, seed=s), cfg,
                                     topo, device=card)
            solo = faults.run_fault_plan(state, meta, cfg, topo, fp, 400,
                                         telemetry=telemetry)
        for name, x, y in zip(solo[0]._fields, solo[0],
                              lane_state(outs[0][0], k)):
            assert torch.equal(x.cpu(), y.cpu()), (k, name)
        for name, x, y in zip(solo[1]._fields, solo[1], outs[0][1]):
            assert torch.equal(x.cpu(), y[k].cpu()), (k, name)
        if telemetry:
            for name, x, y in zip(solo[2]._fields, solo[2],
                                  lane_trace(outs[0][2], k)):
                assert torch.equal(x.cpu(), y.cpu()), (k, name)
