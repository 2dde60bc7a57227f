"""The bitpacked round on u32 words — the port of
``corrosion_tpu/sim/packed.py`` for the faultless, telemetry-free
envelope the 100k write storm runs.

Words ride int32 carriers (`..device`).  One layout differs from JAX:
the broadcast delay ring ``inflight`` is u32 words ``[D, N, W]``
written by an OR scatter (K2, `scatter_sending`), where JAX keeps a
dense u8 ``[D, N, P]`` ring because XLA lacks an OR scatter
(packed.py:285-293); the sent values are 0/1, so the bits agree, and
`deliver_packed` no longer packs the ring.

Two hot functions run hand-written kernels on the card: the ring
scatter (K2) and the sync pull (K3, `sync_pull`).  Each wrapper takes
the plain torch version beside it for a CPU tensor.  `run_packed` is a
Python loop that reads the done flag once per round (a CUDA graph is
ROADMAP B9).  The round counter ``t`` lives on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..device import ONES, i32, shr
from ..kernels.build import check
from . import rng
from .gaps import extract_gaps, gaps_to_mask
from .round import RunMetrics, new_metrics
from .state import ALIVE, PayloadMeta, SimConfig, SimState, version_heads
from .swim import sample_member_targets, swim_step
from .topology import (
    Topology,
    apply_degree_caps,
    edge_alive,
    edge_delay,
    regions,
)


def packed_supported(cfg: SimConfig, topo: Topology) -> bool:
    c = cfg.chunks_per_version
    return (
        cfg.allow_packed
        and cfg.n_nodes * cfg.n_payloads >= cfg.packed_min_cells
        and cfg.n_payloads % 32 == 0
        and c in (1, 2, 4, 8, 16, 32)
        and cfg.max_transmissions < 16
    )


def _require_unmetered(budget_bytes) -> None:
    if budget_bytes is not None:
        raise NotImplementedError(
            "byte budgets (budget_prefix_words) are not ported yet "
            "(ROADMAP B11); optimize_budgets drops budgets that cannot bind"
        )


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool/u8[..., P] → int32-carried u32 words [..., P/32], LSB-first."""
    *lead, p = x.shape
    b = (x > 0).reshape(*lead, p // 32, 32).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    # distinct bits: no partial sum leaves the int32 range (bit 31 is the
    # carrier's -2^31), so the int32 sum is exactly the OR
    return (b << shifts).sum(dim=-1, dtype=torch.int32)


def unpack_bits(w: torch.Tensor, p: int) -> torch.Tensor:
    """int32-carried words [..., W] → bool[..., P]."""
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    bits = (w[..., None] >> shifts) & 1
    return bits.to(torch.bool).reshape(*w.shape[:-1], p)


# -- bitsliced 4-bit counters ------------------------------------------------


class Planes(NamedTuple):
    r0: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    r3: torch.Tensor

    @property
    def nonzero(self) -> torch.Tensor:
        return self.r0 | self.r1 | self.r2 | self.r3


def planes_set(planes: Planes, where: torch.Tensor, value: int) -> Planes:
    """Set the counter to ``value`` (0..15) at every bit of ``where``."""
    return Planes(*(
        (plane & ~where) | (where if (value >> k) & 1 else 0)
        for k, plane in enumerate(planes)
    ))


def planes_dec(planes: Planes, where: torch.Tensor) -> Planes:
    """Decrement at every bit of ``where`` (ripple borrow; callers
    guarantee where ⊆ nonzero)."""
    r0, r1, r2, r3 = planes
    borrow = where
    n0 = r0 ^ borrow
    borrow = borrow & ~r0
    n1 = r1 ^ borrow
    borrow = borrow & ~r1
    n2 = r2 ^ borrow
    borrow = borrow & ~r2
    n3 = r3 ^ borrow
    return Planes(n0, n1, n2, n3)


# -- chunk-group folds -------------------------------------------------------


def _fold_all(w: torch.Tensor, c: int) -> torch.Tensor:
    step = 1
    while step < c:
        w = w & shr(w, step)
        step *= 2
    return w


def _fold_any(w: torch.Tensor, c: int) -> torch.Tensor:
    step = 1
    while step < c:
        w = w | shr(w, step)
        step *= 2
    return w


def _group_low_bits_mask(c: int) -> int:
    """The u32 mask with a bit at every multiple of c, as an int32 value."""
    return i32(sum(1 << i for i in range(0, 32, c)))


def _smear_groups(low: torch.Tensor, c: int) -> torch.Tensor:
    """Broadcast each aligned c-bit group's low bit across the group."""
    w = low
    step = 1
    while step < c:
        w = w | (w << step)
        step *= 2
    return w


def group_grid(w: torch.Tensor, cfg: SimConfig, mode: str) -> torch.Tensor:
    """have-words [..., W] → bool[..., A, V] version grid (all/any chunks)."""
    c = cfg.chunks_per_version
    fold = _fold_all if mode == "all" else _fold_any
    low = fold(w, c) & _group_low_bits_mask(c)
    shifts = torch.arange(0, 32, c, dtype=torch.int32, device=w.device)
    bits = (low[..., None] >> shifts) & 1  # [..., W, 32/c]
    grid = bits.reshape(*w.shape[:-1], cfg.n_versions, cfg.n_writers)
    return grid.transpose(-1, -2).to(torch.bool)  # [..., A, V]


def grid_to_words(x_av: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[..., A, V] → words [..., W] with each (v, a) group's C bits
    set where the grid is True (inverse of group_grid)."""
    c = cfg.chunks_per_version
    va = x_av.transpose(-1, -2).reshape(
        *x_av.shape[:-2], cfg.n_versions * cfg.n_writers
    )
    per_word = 32 // c
    g = va.reshape(*va.shape[:-1], va.shape[-1] // per_word, per_word)
    shifts = torch.arange(0, 32, c, dtype=torch.int64, device=x_av.device)
    low = (g.to(torch.int64) << shifts).sum(dim=-1).to(torch.int32)
    return _smear_groups(low, c)


def all_chunks_words(have_w: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Word mask: every bit of version v's group set iff ALL its chunks
    are held."""
    c = cfg.chunks_per_version
    return _smear_groups(_fold_all(have_w, c) & _group_low_bits_mask(c), c)


def _and_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise AND of the rows of [R, W] words (torch has no AND reduction:
    a halving fold, log2(R) steps)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.full_like(x[:1], ONES)])
        x = x[0::2] & x[1::2]
    return x[0]


# -- packed state ------------------------------------------------------------


class PackedCarry(NamedTuple):
    have: torch.Tensor  # words [N, W]
    inflight: torch.Tensor  # words [D, N, W] — the OR-scattered ring
    relay: Planes  # 4 × words [N, W]
    sync_buf: torch.Tensor  # words [D, N, W]


def pack_state(state: SimState, cfg: SimConfig) -> PackedCarry:
    relay = state.relay_left.to(torch.int32)
    return PackedCarry(
        have=pack_bits(state.have),
        inflight=state.inflight,
        relay=Planes(*(pack_bits((relay >> k) & 1) for k in range(4))),
        sync_buf=pack_bits(state.sync_inflight),
    )


def unpack_into_state(
    carry: PackedCarry, state: SimState, cfg: SimConfig
) -> SimState:
    p = cfg.n_payloads
    relay = sum(
        unpack_bits(plane, p).to(torch.uint8) << k
        for k, plane in enumerate(carry.relay)
    )
    return state._replace(
        have=unpack_bits(carry.have, p).to(torch.uint8),
        inflight=carry.inflight,
        relay_left=relay.to(torch.uint8),
        sync_inflight=unpack_bits(carry.sync_buf, p).to(torch.uint8),
    )


def shrink_state(state: SimState) -> SimState:
    """Zero-width payload-axis tensors: the loop carries the PackedCarry."""
    n = state.have.shape[0]
    d = state.inflight.shape[0]
    dev = state.have.device
    u8 = torch.uint8
    return state._replace(
        have=torch.zeros((n, 0), dtype=u8, device=dev),
        injected=torch.zeros((0,), dtype=u8, device=dev),
        relay_left=torch.zeros((n, 0), dtype=u8, device=dev),
        inflight=torch.zeros((d, n, 0), dtype=torch.int32, device=dev),
        sync_inflight=torch.zeros((d, n, 0), dtype=u8, device=dev),
    )


# -- the packed phases -------------------------------------------------------


def inject_packed(
    carry: PackedCarry, injected_p: torch.Tensor, t: int, meta: PayloadMeta,
    cfg: SimConfig, alive: torch.Tensor,
) -> Tuple[PackedCarry, torch.Tensor]:
    n = cfg.n_nodes
    w = cfg.n_payloads // 32
    dev = carry.have.device
    injecting = (meta.round == t) & (alive[meta.actor.long()] == ALIVE)
    idx = torch.arange(cfg.n_payloads, dtype=torch.int32, device=dev)
    bit = torch.bitwise_left_shift(torch.ones_like(idx), idx % 32)
    contrib = torch.where(injecting, bit, 0)
    # add == OR: every payload owns a distinct bit of its (actor, word)
    own = torch.zeros(n * w, dtype=torch.int32, device=dev).index_add_(
        0, (meta.actor * w + idx // 32).long(), contrib
    ).reshape(n, w)
    newly = own & ~carry.have
    return (
        carry._replace(
            have=carry.have | own,
            relay=planes_set(carry.relay, newly, cfg.max_transmissions),
        ),
        injected_p | pack_bits(injecting),
    )


def scatter_sending_plain(ring, sending, dst, slot, ok, fanout: int) -> None:
    """Plain version of K2, in place: OR sending[e // fanout] into
    ring[slot[e], dst[e]] for every ok edge (an unpacked u8 scatter-max,
    as JAX does it)."""
    d, n, w = ring.shape
    p = w * 32
    sent = unpack_bits(sending, p).repeat_interleave(fanout, dim=0)
    sent = (sent & ok[:, None]).to(torch.uint8)  # [E, P]; 0 is a no-op
    rows = slot.long() * n + dst.long()
    dense = unpack_bits(ring.reshape(d * n, w), p).to(torch.uint8)
    dense.scatter_reduce_(0, rows[:, None].expand(-1, p), sent, "amax")
    ring.copy_(pack_bits(dense).reshape(d, n, w))


def scatter_sending(ring, sending, dst, slot, ok, fanout: int) -> None:
    """OR each ok edge's sender words into its ring row, in place; K2 on
    the card."""
    if ring.device.type == "cpu":
        scatter_sending_plain(ring, sending, dst, slot, ok, fanout)
        return
    d, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (d, n, w))
    check("sending", sending, torch.int32, (n, w))
    check("dst", dst, torch.int32, (e,))
    check("slot", slot, torch.int32, (e,))
    check("ok", ok, torch.bool, (e,))
    kernels.BROADCAST_SCATTER.launch(
        [ring, sending, dst, slot, ok], [n, d, w, fanout]
    )


def broadcast_packed(
    carry: PackedCarry, injected_p: torch.Tensor, state: SimState,
    cfg: SimConfig, topo: Topology, region: torch.Tensor, key: torch.Tensor,
    meta: PayloadMeta,
) -> PackedCarry:
    n, f = cfg.n_nodes, cfg.fanout
    k_targets = rng.split(key, 3)[0]  # k_drop, k_ring0 unused when flat
    _require_unmetered(cfg.rate_limit_bytes_round)
    sending = carry.have & carry.relay.nonzero & injected_p[None, :]
    targets = sample_member_targets(state, cfg, k_targets, f)  # [N, F]
    if topo.n_regions > 1:
        raise NotImplementedError(
            "multi-region broadcast (ring0-first tiering) is not ported "
            "yet (ROADMAP B15)"
        )
    targets = apply_degree_caps(targets, topo)
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    src = me.repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst)
    ok &= dst != src
    delay = edge_delay(topo, region, src, dst)
    d_slots = carry.inflight.shape[0]
    slot = ((int(state.t) + delay) % d_slots).to(torch.int32)
    inflight = carry.inflight.clone()
    scatter_sending(inflight, sending, dst, slot, ok, f)

    # the budget spends on the ATTEMPT: the sender sees neither cuts nor
    # dead targets, only what it tried to send
    attempted = (targets >= 0) & (targets != me[:, None])
    any_attempt = attempted.any(dim=1) & (state.alive == ALIVE)
    spent = torch.where(any_attempt[:, None], sending, 0)
    return carry._replace(
        inflight=inflight, relay=planes_dec(carry.relay, spent)
    )


def deliver_packed(carry: PackedCarry, t: int, cfg: SimConfig) -> PackedCarry:
    """Broadcast arrivals re-arm the relay budget; the sync ring's slot t
    merges into have without re-arming."""
    d_slots = carry.inflight.shape[0]
    slot = t % d_slots
    arriving = carry.inflight[slot]
    newly = arriving & ~carry.have
    have = carry.have | arriving | carry.sync_buf[slot]
    relay = planes_set(carry.relay, newly, max(cfg.max_transmissions - 1, 1))
    inflight = carry.inflight.clone()
    inflight[slot] = 0
    sync_buf = carry.sync_buf.clone()
    sync_buf[slot] = 0
    return PackedCarry(have=have, inflight=inflight, relay=relay,
                       sync_buf=sync_buf)


def sync_pull_plain(masks, miss, peers, ok, slot_words) -> torch.Tensor:
    """Plain version of K3: OR the need words pulled from every ok peer
    into ``slot_words`` in place; returns bool[N] fruitful."""
    haves_w, partial_w, below_w, have_w = masks.unbind(dim=1)
    d = masks[peers.long()]  # [N, S, 4, W]
    haves_d, partial_d, below_d, have_d = d.unbind(dim=2)
    wanted = (
        (miss[:, None, :] & haves_d)
        | (partial_w[:, None, :] & (haves_d | partial_d))
        | (~below_w[:, None, :] & below_d)
    )
    need = wanted & have_d & ~have_w[:, None, :]
    need = torch.where(ok[:, :, None], need, 0)
    pulled = need[:, 0]
    for s in range(1, need.shape[1]):
        pulled = pulled | need[:, s]
    slot_words |= pulled
    return (pulled != 0).any(dim=1)


def sync_pull(masks, miss, peers, ok, slot_words) -> torch.Tensor:
    """Gather the S peers' mask rows, apply the need algebra and OR the
    pulled words into ``slot_words`` in place; returns bool[N] fruitful.
    K3 on the card."""
    if masks.device.type == "cpu":
        return sync_pull_plain(masks, miss, peers, ok, slot_words)
    n, _, w = masks.shape
    s = peers.shape[1]
    check("masks", masks, torch.int32, (n, 4, w))
    check("miss", miss, torch.int32, (n, w))
    check("peers", peers, torch.int32, (n, s))
    check("ok", ok, torch.bool, (n, s))
    check("slot_words", slot_words, torch.int32, (n, w))
    fruitful = torch.zeros(n, dtype=torch.uint8, device=masks.device)
    kernels.SYNC_PULL.launch(
        [masks, miss, peers, ok, slot_words, fruitful], [n, w, s]
    )
    return fruitful.to(torch.bool)


def sync_packed(
    carry: PackedCarry, state: SimState, cfg: SimConfig, topo: Topology,
    key: torch.Tensor, meta: PayloadMeta,
):
    """Anti-entropy on packed words: per-node group-uniform masks from the
    advertised heads/gaps, the per-edge pull on the card (K3), and the
    fruitfulness-adaptive backoff."""
    n, s = cfg.n_nodes, cfg.sync_peers
    ks = rng.split(key, 3)
    k_peers, k_rearm = ks[0], ks[2]
    due = state.sync_countdown <= 0
    peers = sample_member_targets(state, cfg, k_peers, s)
    me = torch.arange(n, dtype=torch.int32, device=peers.device)
    src = me.repeat_interleave(s)
    dst = peers.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst)
    ok &= due[src.long()]
    ok &= dst != src

    v = cfg.n_versions
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=peers.device)
    miss_w = grid_to_words(gaps_to_mask(state.gap_lo, state.gap_hi, v), cfg)
    below_w = grid_to_words(v_idx <= state.heads[:, :, None], cfg)
    comp_w = all_chunks_words(carry.have, cfg)
    haves_w = below_w & ~miss_w & comp_w
    partial_w = below_w & ~miss_w & ~comp_w
    masks = torch.stack([haves_w, partial_w, below_w, carry.have], dim=1)
    _require_unmetered(cfg.sync_budget_bytes)

    d_slots = carry.sync_buf.shape[0]
    sync_buf = carry.sync_buf.clone()
    fruitful = sync_pull(
        masks, miss_w, dst.reshape(n, s), ok.reshape(n, s),
        sync_buf[(int(state.t) + 1) % d_slots],
    )

    backoff = torch.where(
        due & fruitful,
        cfg.sync_interval_rounds,
        torch.where(
            due,
            torch.clamp(state.sync_backoff * 2, max=cfg.sync_backoff_cap()),
            state.sync_backoff,
        ),
    ).to(torch.int32)
    rearm = rng.randint(k_rearm, (n,), 1, backoff + 1)
    countdown = torch.where(due, rearm, state.sync_countdown - 1)
    return carry._replace(sync_buf=sync_buf), countdown, backoff


# -- the round and the loop --------------------------------------------------


def packed_round_step(
    state: SimState, carry: PackedCarry, injected_p: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    region: torch.Tensor,
):
    """One gossip tick on packed words, phase-for-phase and PRNG-stream
    identical to JAX's ``packed_round_step``: inject → broadcast → sync →
    deliver → SWIM → bookkeeping refresh → convergence record."""
    ks = rng.split(state.key, 4)
    state = state._replace(key=ks[0])
    k_bcast, k_sync, k_swim = ks[1], ks[2], ks[3]
    t = int(state.t)

    carry, injected_p = inject_packed(
        carry, injected_p, t, meta, cfg, state.alive
    )
    carry = broadcast_packed(
        carry, injected_p, state, cfg, topo, region, k_bcast, meta
    )
    carry, countdown, backoff = sync_packed(carry, state, cfg, topo, k_sync, meta)
    state = state._replace(sync_countdown=countdown, sync_backoff=backoff)
    carry = deliver_packed(carry, t, cfg)
    state = swim_step(state, cfg, topo, k_swim)

    touched = group_grid(carry.have, cfg, "any")  # [N, A, V]
    heads = version_heads(touched)
    gaps = extract_gaps(touched, heads, cfg)
    state = state._replace(heads=heads, gap_lo=gaps.lo, gap_hi=gaps.hi)
    frac = gaps.overflow.sum().to(torch.float32) / torch.tensor(
        float(gaps.overflow.numel()), dtype=torch.float32,
        device=gaps.overflow.device,
    )
    overflow_frac = torch.maximum(metrics.overflow_frac, frac)

    up = state.alive == ALIVE
    c = cfg.chunks_per_version
    comp_w = all_chunks_words(carry.have, cfg)
    act_w = _smear_groups(
        _fold_any(injected_p, c) & _group_low_bits_mask(c), c
    )
    masked = torch.where(up[:, None], comp_w, ONES)
    payload_done = unpack_bits(_and_rows(masked) & act_w, cfg.n_payloads)
    coverage_at = torch.where(
        (metrics.coverage_at < 0) & payload_done, t, metrics.coverage_at
    )
    node_done = ((comp_w | ~act_w[None, :]) == ONES).all(dim=1) & up
    all_injected = (meta.round <= t).all()
    converged_at = torch.where(
        (metrics.converged_at < 0) & node_done & all_injected,
        t, metrics.converged_at,
    )
    out_metrics = RunMetrics(
        coverage_at=coverage_at.to(torch.int32),
        converged_at=converged_at.to(torch.int32),
        overflow_frac=overflow_frac,
        order_violations=metrics.order_violations,
    )
    state = state._replace(t=state.t + 1)
    return state, carry, injected_p, out_metrics


def _converged_done(
    slim: SimState, metrics: RunMetrics, meta: PayloadMeta
) -> torch.Tensor:
    """Exit predicate: every payload injected and every up node
    converged (a device bool)."""
    all_injected = (meta.round <= int(slim.t)).all()
    return all_injected & (
        (metrics.converged_at >= 0) | (slim.alive != ALIVE)
    ).all()


def run_packed(
    state: SimState, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    max_rounds: int,
):
    """Pack once, loop rounds on words until convergence or
    ``max_rounds``, unpack once.  Returns (SimState, RunMetrics)."""
    dev = state.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    carry = pack_state(state, cfg)
    inj = pack_bits(state.injected)
    slim = shrink_state(state)
    done = _converged_done(slim, metrics, meta)
    while int(slim.t) < max_rounds and not bool(done):
        slim, carry, inj, metrics = packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region
        )
        done = _converged_done(slim, metrics, meta)
    full = unpack_into_state(carry, slim, cfg)
    full = full._replace(
        injected=unpack_bits(inj, cfg.n_payloads).to(torch.uint8)
    )
    return full, metrics
