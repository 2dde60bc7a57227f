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
from corrosion_tpu_torch.sim import packed, pswim

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
