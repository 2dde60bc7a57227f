"""The bitpacked round on u32 words — the port of
``corrosion_tpu/sim/packed.py`` for the faultless, telemetry-free
envelope the 100k write storm runs.

Words ride int32 carriers (`..device`; the packing helpers and
chunk-group folds are `.words`).  One layout differs from JAX: the
broadcast delay ring ``inflight`` is u32 words ``[D, N, W]`` written by
an OR scatter (K2, `scatter_sending`), where JAX keeps a dense u8
``[D, N, P]`` ring because XLA lacks an OR scatter (packed.py:285-293);
the sent values are 0/1, so the bits agree, and `deliver_packed` no
longer packs the ring.

Every phase of the round runs hand-written kernels on the card: the
word phases (K8: `inject_packed`, `spend_relay`, `deliver_packed`), the
ring scatter (K2), the sync pull (K3) and the convergence record (K7,
`converge_record`) here; the draws (K5, `.rng`), the member sampler and
table merge (K1, K4, `.pswim`) and the gap refresh (K6, `.gaps`).  Each
wrapper takes the plain torch version beside it for a CPU tensor.

**In place.**  The word phases and the pull update the carry's tensors
(``have``, the relay planes, both rings) and ``injected_p`` in place, on
the card and on the CPU alike: no caller reads a carry again once the
next phase has it, and `pack_state` gives the loop tensors of its own.
A caller that needs the old carry clones it first.

`run_packed` is a Python loop that reads K7's done flag once per round
(a CUDA graph is ROADMAP B9).  The round counter ``t`` lives on the
host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..device import ONES
from ..kernels.build import check
from . import rng
from .gaps import gaps_to_mask, refresh_gaps
from .round import RunMetrics, new_metrics
from .state import ALIVE, PayloadMeta, SimConfig, SimState
from .swim import sample_member_targets, swim_step
from .topology import (
    Topology,
    apply_degree_caps,
    edge_alive,
    edge_delay,
    regions,
)
from .words import (
    all_chunks_words,
    and_rows,
    fold_any,
    grid_to_words,
    group_low_bits_mask,
    pack_bits,
    smear_groups,
    unpack_bits,
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


# -- bitsliced 4-bit counters ------------------------------------------------


class Planes(NamedTuple):
    r0: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    r3: torch.Tensor

    @property
    def nonzero(self) -> torch.Tensor:
        return self.r0 | self.r1 | self.r2 | self.r3


def planes_set_(planes: Planes, where: torch.Tensor, value: int) -> None:
    """Set the counter to ``value`` (0..15) at every bit of ``where``, in
    place."""
    for k, plane in enumerate(planes):
        plane &= ~where
        if (value >> k) & 1:
            plane |= where


def planes_dec_(planes: Planes, where: torch.Tensor) -> None:
    """Decrement at every bit of ``where``, in place (ripple borrow;
    callers guarantee where ⊆ nonzero)."""
    borrow = where
    for plane in planes:
        nxt = borrow & ~plane
        plane ^= borrow
        borrow = nxt


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
        inflight=state.inflight.clone(),  # the loop updates it in place
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


def inject_packed_plain(
    carry: PackedCarry, injected_p: torch.Tensor, t: int, meta: PayloadMeta,
    cfg: SimConfig, alive: torch.Tensor,
) -> Tuple[PackedCarry, torch.Tensor]:
    """Plain version of K8's inject, in place."""
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
    carry.have.bitwise_or_(own)
    planes_set_(carry.relay, newly, cfg.max_transmissions)
    injected_p |= pack_bits(injecting)
    return carry, injected_p


def inject_packed(
    carry: PackedCarry, injected_p: torch.Tensor, t: int, meta: PayloadMeta,
    cfg: SimConfig, alive: torch.Tensor,
) -> Tuple[PackedCarry, torch.Tensor]:
    """Inject round t's payloads at their up writers: ``have``, the relay
    planes (armed to max_transmissions where new) and ``injected_p``
    are updated in place.  K8 on the card."""
    if carry.have.device.type == "cpu":
        return inject_packed_plain(carry, injected_p, t, meta, cfg, alive)
    n, w = carry.have.shape
    p = cfg.n_payloads
    _check_words(carry, n, w)
    check("injected_p", injected_p, torch.int32, (w,))
    check("meta.round", meta.round, torch.int32, (p,))
    check("meta.actor", meta.actor, torch.int32, (p,))
    check("alive", alive, torch.uint8, (n,))
    kernels.WORD_INJECT.launch(
        [meta.round, meta.actor, alive, carry.have, *carry.relay, injected_p],
        [n, w, p, t, cfg.max_transmissions],
    )
    return carry, injected_p


def _check_words(carry: PackedCarry, n: int, w: int) -> None:
    check("have", carry.have, torch.int32, (n, w))
    for k, plane in enumerate(carry.relay):
        check(f"relay.r{k}", plane, torch.int32, (n, w))


def spend_relay_plain(
    carry: PackedCarry, injected_p: torch.Tensor, targets: torch.Tensor,
    alive: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K8's spend: the sending words; the relay planes
    count down in place."""
    n = targets.shape[0]
    sending = carry.have & carry.relay.nonzero & injected_p[None, :]
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    attempted = (targets >= 0) & (targets != me[:, None])
    any_attempt = attempted.any(dim=1) & (alive == ALIVE)
    planes_dec_(carry.relay, torch.where(any_attempt[:, None], sending, 0))
    return sending


def spend_relay(
    carry: PackedCarry, injected_p: torch.Tensor, targets: torch.Tensor,
    alive: torch.Tensor,
) -> torch.Tensor:
    """The broadcast's sending words ``have & relay-nonzero &
    injected_p``; where an up row attempted a send (a target neither -1
    nor itself) its relay counters drop by one at the sent bits, in
    place.  The budget spends on the ATTEMPT: the sender sees neither
    cuts nor dead targets.  K8 on the card."""
    if carry.have.device.type == "cpu":
        return spend_relay_plain(carry, injected_p, targets, alive)
    n, w = carry.have.shape
    f = targets.shape[1]
    _check_words(carry, n, w)
    check("injected_p", injected_p, torch.int32, (w,))
    check("targets", targets, torch.int32, (n, f))
    check("alive", alive, torch.uint8, (n,))
    sending = torch.empty_like(carry.have)
    kernels.WORD_SPEND.launch(
        [carry.have, *carry.relay, injected_p, targets, alive, sending],
        [n, w, f],
    )
    return sending


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
    """Fan-out push: draw targets, spend the relay budget (K8) and OR
    the sent words into the delay ring (K2), in place."""
    n, f = cfg.n_nodes, cfg.fanout
    k_targets = rng.split(key, 3)[0]  # k_drop, k_ring0 unused when flat
    _require_unmetered(cfg.rate_limit_bytes_round)
    targets = sample_member_targets(state, cfg, k_targets, f)  # [N, F]
    if topo.n_regions > 1:
        raise NotImplementedError(
            "multi-region broadcast (ring0-first tiering) is not ported "
            "yet (ROADMAP B15)"
        )
    targets = apply_degree_caps(targets, topo)
    sending = spend_relay(carry, injected_p, targets, state.alive)
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
    scatter_sending(carry.inflight, sending, dst, slot, ok, f)
    return carry


def deliver_packed_plain(
    carry: PackedCarry, t: int, cfg: SimConfig
) -> PackedCarry:
    """Plain version of K8's deliver, in place."""
    slot = t % carry.inflight.shape[0]
    arriving = carry.inflight[slot]
    newly = arriving & ~carry.have
    carry.have.bitwise_or_(arriving | carry.sync_buf[slot])
    planes_set_(carry.relay, newly, max(cfg.max_transmissions - 1, 1))
    carry.inflight[slot] = 0
    carry.sync_buf[slot] = 0
    return carry


def deliver_packed(carry: PackedCarry, t: int, cfg: SimConfig) -> PackedCarry:
    """Broadcast arrivals re-arm the relay budget; the sync ring's slot t
    merges into have without re-arming; both slots are cleared.  In
    place; K8 on the card."""
    if carry.have.device.type == "cpu":
        return deliver_packed_plain(carry, t, cfg)
    n, w = carry.have.shape
    d_slots = carry.inflight.shape[0]
    _check_words(carry, n, w)
    check("inflight", carry.inflight, torch.int32, (d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (d_slots, n, w))
    kernels.WORD_DELIVER.launch(
        [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
        [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1)],
    )
    return carry


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
    advertised heads/gaps, the per-edge pull into the sync ring's slot
    t + 1 (K3, in place), and the fruitfulness-adaptive backoff."""
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
    fruitful = sync_pull(
        masks, miss_w, dst.reshape(n, s), ok.reshape(n, s),
        carry.sync_buf[(int(state.t) + 1) % d_slots],
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
    return carry, countdown, backoff


# -- the convergence record -------------------------------------------------

# K7's row pass: nodes per block, so the wrapper sizes the partial rows
CONVERGE_ROWS_PER_BLOCK = 256


def converge_record_plain(
    have: torch.Tensor, injected_p: torch.Tensor, alive: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, t: int, cfg: SimConfig,
):
    """Plain version of K7."""
    up = alive == ALIVE
    c = cfg.chunks_per_version
    comp_w = all_chunks_words(have, cfg)
    act_w = smear_groups(fold_any(injected_p, c) & group_low_bits_mask(c), c)
    masked = torch.where(up[:, None], comp_w, ONES)
    payload_done = unpack_bits(and_rows(masked) & act_w, cfg.n_payloads)
    coverage_at = torch.where(
        (metrics.coverage_at < 0) & payload_done, t, metrics.coverage_at
    ).to(torch.int32)
    node_done = ((comp_w | ~act_w[None, :]) == ONES).all(dim=1) & up
    all_injected = (meta.round <= t).all()
    converged_at = torch.where(
        (metrics.converged_at < 0) & node_done & all_injected,
        t, metrics.converged_at,
    ).to(torch.int32)
    done = (meta.round <= t + 1).all() & ((converged_at >= 0) | ~up).all()
    return coverage_at, converged_at, done


def converge_record(
    have: torch.Tensor, injected_p: torch.Tensor, alive: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, t: int, cfg: SimConfig,
):
    """Round t's convergence record on words: (coverage_at i32[P],
    converged_at i32[N], done) — the stamps of payloads complete on
    every up node and of nodes holding every active version, and the
    run's exit flag for round t + 1 (`_converged_done` on the new
    metrics), a bool scalar that stays on the device.  K7 on the card:
    a row pass and a one-block finish."""
    if have.device.type == "cpu":
        return converge_record_plain(
            have, injected_p, alive, metrics, meta, t, cfg
        )
    n, w = have.shape
    p = cfg.n_payloads
    c = cfg.chunks_per_version
    check("have", have, torch.int32, (n, w))
    check("injected_p", injected_p, torch.int32, (w,))
    check("alive", alive, torch.uint8, (n,))
    check("meta.round", meta.round, torch.int32, (p,))
    check("converged_at", metrics.converged_at, torch.int32, (n,))
    check("coverage_at", metrics.coverage_at, torch.int32, (p,))
    rows = CONVERGE_ROWS_PER_BLOCK
    blocks = -(-n // rows)
    dev = have.device
    partial = torch.empty((blocks, w + 1), dtype=torch.int32, device=dev)
    converged_at = torch.empty_like(metrics.converged_at)
    coverage_at = torch.empty_like(metrics.coverage_at)
    done = torch.empty((), dtype=torch.bool, device=dev)
    kernels.CONVERGE_ROWS.launch(
        [have, injected_p, alive, meta.round, metrics.converged_at,
         converged_at, partial],
        [n, w, c, p, t, rows],
    )
    kernels.CONVERGE_FINISH.launch(
        [partial, injected_p, meta.round, metrics.coverage_at, coverage_at,
         done],
        [blocks, w, c, p, t],
    )
    return coverage_at, converged_at, done


# -- the round and the loop --------------------------------------------------


def packed_round_step(
    state: SimState, carry: PackedCarry, injected_p: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    region: torch.Tensor,
):
    """One gossip tick on packed words, phase-for-phase and PRNG-stream
    identical to JAX's ``packed_round_step``: inject → broadcast → sync →
    deliver → SWIM → bookkeeping refresh → convergence record.  Updates
    ``carry`` and ``injected_p`` in place and returns (state, carry,
    injected_p, metrics, done), where ``done`` is JAX's
    ``_converged_done`` after the round, on the device."""
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

    heads, gap_lo, gap_hi, n_overflow = refresh_gaps(carry.have, cfg)
    state = state._replace(heads=heads, gap_lo=gap_lo, gap_hi=gap_hi)
    # JAX's overflow.mean(f32): the count over the cell count, both f32
    # (a tensor divisor: torch multiplies by the reciprocal of a scalar)
    frac = n_overflow.to(torch.float32) / torch.full(
        (), float(heads.numel()), dtype=torch.float32, device=heads.device
    )
    overflow_frac = torch.maximum(metrics.overflow_frac, frac)

    coverage_at, converged_at, done = converge_record(
        carry.have, injected_p, state.alive, metrics, meta, t, cfg
    )
    out_metrics = RunMetrics(
        coverage_at=coverage_at,
        converged_at=converged_at,
        overflow_frac=overflow_frac,
        order_violations=metrics.order_violations,
    )
    state = state._replace(t=state.t + 1)
    return state, carry, injected_p, out_metrics, done


def _converged_done(
    slim: SimState, metrics: RunMetrics, meta: PayloadMeta
) -> torch.Tensor:
    """Exit predicate: every payload injected and every up node
    converged (a device bool); the loop takes it from K7 after each
    round and evaluates it here only before the first."""
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
        slim, carry, inj, metrics, done = packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region
        )
    full = unpack_into_state(carry, slim, cfg)
    full = full._replace(
        injected=unpack_bits(inj, cfg.n_payloads).to(torch.uint8)
    )
    return full, metrics
