"""The bitpacked round on u32 words — the port of
``corrosion_tpu/sim/packed.py`` for the envelope the 100k write storm
and the gapstress storm run, faultless (`run_packed`) and under a
fault plan of either form (`run_packed_faults`), over one region or several
(ring0 tiering, shared with the dense round), with the byte budgets
metered, the flat topology loss drawn on the wire, and the flight
recorder (`.telemetry`) when a run asks for it.

Words ride int32 carriers (`..device`; the packing helpers and
chunk-group folds are `.words`).  One layout differs from JAX: the
broadcast delay ring ``inflight`` is u32 words ``[D, N, W]`` written by
an OR scatter (K2, `scatter_sending`), where JAX keeps a dense u8
``[D, N, P]`` ring because XLA lacks an OR scatter (packed.py:285-293);
the sent values are 0/1, so the bits agree, and `deliver_packed` no
longer packs the ring.

Every phase of the round runs hand-written kernels on the card: the
word phases (K8: `inject_packed`, `spend_relay`, `deliver_packed`), the
ring scatter (K2), the sync pull (K3, after its mask pass
`sync_masks`) and the convergence record (K7,
`converge_record`) here; the draws (K5, `.rng`), the member sampler and
table merge (K1, K4, `.pswim`) and the gap refresh (K6, `.gaps`).  The
byte budgets run K16 (`budget_prefix_words`, the broadcast governor)
and K3's metered entry (the sync grant).  Under the flat topology loss
or a fault plan the ring scatter is K10 (`scatter_sending_lossy`), under
tiered topology loss its tiered instantiation; a
plan's edge queries run K9 or K9m (`.faults`) and its node faults K11
(`apply_round_faults`).  Each wrapper takes the plain torch version
beside it for a CPU tensor.

**In place.**  The word phases and the pull update the carry's tensors
(``have``, the relay planes, both rings) and ``injected_p`` in place, on
the card and on the CPU alike: no caller reads a carry again once the
next phase has it, and `pack_state` gives the loop tensors of its own.
A caller that needs the old carry clones it first.

`run_packed` and `run_packed_faults` are Python loops that read K7's
done flag once per round (a CUDA graph is ROADMAP B9).  The round
counter ``t`` lives on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import ONES, i32, popcount
from ..kernels.build import check
from . import rng
from .broadcast import ring0_targets
from .faults import (
    JITTER_TAG,
    WIRE_LOSS_TAG,
    AnyFaultPlan,
    AnyRoundFaults,
    RoundActivity,
    apply_node_faults_plain,
    fault_key,
    fault_session_effects,
    fault_wire_effects,
    host_activity,
    round_faults,
)
from ..proto.ordering import admit_words, order_checked, order_enforced
from ..proto.schedule import cadence_due, capped_schedule
from .gaps import gaps_to_mask, refresh_gaps
from .invariants import count_order_violations_
from .round import RunMetrics, new_metrics, overflow_fraction
from .state import (
    ALIVE,
    PayloadMeta,
    SimConfig,
    SimState,
    budget_prefix_mask,
)
from .swim import sample_member_targets, swim_step
from .telemetry import (
    COVERAGE,
    GRANTS,
    WIRE,
    RoundTrace,
    acc_slot,
    count_words_,
    coverage_delivered_,
    new_trace,
    record_row,
    trace_row,
    wire_loss_active,
    wire_words_,
    wire_words_pull_,
)
from .topology import (
    Topology,
    edge_alive,
    edge_loss_thresholds_raw,
    edge_slot,
    edge_slot_plain,
    loss_threshold,
    regions,
    topo_table,
    wire_tiers,
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


def budget_prefix_words_plain(
    elig_w: torch.Tensor, budget_bytes, nbytes: torch.Tensor
) -> torch.Tensor:
    """Plain version of K16: unpack, meter with the dense
    `.state.budget_prefix_mask`, pack (JAX's word form gives the same
    bits)."""
    if budget_bytes is None:
        return elig_w
    p = elig_w.shape[-1] * 32
    return pack_bits(budget_prefix_mask(unpack_bits(elig_w, p), budget_bytes,
                                        nbytes))


def _check_budget(budget_bytes: int, nbytes: torch.Tensor, w: int) -> None:
    """What K16's row scan takes: JAX's payload limit, an i32 budget, the
    sizes of the W words' payloads."""
    p = w * 32
    if p >= 1 << 21:
        raise ValueError(
            f"byte budget supports at most 2^21-1 payloads, got {p}"
        )
    if not -(1 << 31) <= budget_bytes < 1 << 31:
        raise ValueError(f"byte budget {budget_bytes} is not an i32")
    check("nbytes", nbytes, torch.int32, (p,))


def budget_prefix_words(
    elig_w: torch.Tensor, budget_bytes, nbytes: torch.Tensor
) -> torch.Tensor:
    """Word twin of `.state.budget_prefix_mask` (JAX
    ``budget_prefix_words``): per row of ``elig_w`` [R, W], the
    payload-index prefix of set bits whose byte total (``nbytes`` i32[P])
    fits ``budget_bytes``; None is unmetered.  K16 on the card."""
    if budget_bytes is None:
        return elig_w
    if elig_w.device.type == "cpu":
        return budget_prefix_words_plain(elig_w, budget_bytes, nbytes)
    rows, w = elig_w.shape
    check("elig_w", elig_w, torch.int32, (rows, w))
    _check_budget(budget_bytes, nbytes, w)
    out = torch.empty_like(elig_w)
    if rows:
        kernels.BUDGET_WORDS.launch([elig_w, nbytes, out],
                                    [rows, w, budget_bytes])
    return out


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
    alive: torch.Tensor, budget=None, nbytes=None,
) -> torch.Tensor:
    """Plain version of K8's spend: the sending words; the relay planes
    count down in place."""
    n = targets.shape[0]
    sending = carry.have & carry.relay.nonzero & injected_p[None, :]
    sending = budget_prefix_words_plain(sending, budget, nbytes)
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    attempted = (targets >= 0) & (targets != me[:, None])
    any_attempt = attempted.any(dim=1) & (alive == ALIVE)
    planes_dec_(carry.relay, torch.where(any_attempt[:, None], sending, 0))
    return sending


def spend_relay(
    carry: PackedCarry, injected_p: torch.Tensor, targets: torch.Tensor,
    alive: torch.Tensor, budget=None, nbytes=None,
) -> torch.Tensor:
    """The broadcast's sending words ``have & relay-nonzero &
    injected_p``, metered by `budget_prefix_words` (``budget`` bytes of
    ``nbytes``; None is unmetered); where an up row attempted a send (a
    target neither -1 nor itself) its relay counters drop by one at the
    sent bits, in place.  The budget spends on the ATTEMPT: the sender
    sees neither cuts nor dead targets.  K8 on the card, around K16 when
    metered."""
    if carry.have.device.type == "cpu":
        return spend_relay_plain(carry, injected_p, targets, alive, budget,
                                 nbytes)
    n, w = carry.have.shape
    f = targets.shape[1]
    _check_words(carry, n, w)
    check("injected_p", injected_p, torch.int32, (w,))
    check("targets", targets, torch.int32, (n, f))
    check("alive", alive, torch.uint8, (n,))
    sending = torch.empty_like(carry.have)
    args = [carry.have, *carry.relay, injected_p, targets, alive]
    if budget is None:
        kernels.WORD_SPEND.launch([*args, sending], [n, w, f, 0])
        return sending
    # metered: the eligible words (mode 1), K16's prefix, the spend of
    # the metered words (mode 2)
    kernels.WORD_SPEND.launch([*args, sending], [n, w, f, 1])
    sending = budget_prefix_words(sending, budget, nbytes)
    kernels.WORD_SPEND.launch([*args, sending], [n, w, f, 2])
    return sending


def _or_rows_plain(ring, edge_words, dst, slot) -> None:
    """OR each edge's words [E, W] into ring[slot[e], dst[e]] in place,
    as an unpacked u8 scatter-max (JAX's form; a zero word is a no-op)."""
    d, n, w = ring.shape
    p = w * 32
    sent = unpack_bits(edge_words, p).to(torch.uint8)  # [E, P]
    rows = slot.long() * n + dst.long()
    dense = unpack_bits(ring.reshape(d * n, w), p).to(torch.uint8)
    dense.scatter_reduce_(0, rows[:, None].expand(-1, p), sent, "amax")
    ring.copy_(pack_bits(dense).reshape(d, n, w))


def _edge_words(sending, ok, fanout: int) -> torch.Tensor:
    """Each edge's sender words [E, W], zero on edges that are not ok."""
    words = sending.repeat_interleave(fanout, dim=0)
    return torch.where(ok[:, None], words, 0)


def scatter_sending_plain(ring, sending, dst, slot, ok, fanout: int) -> None:
    """Plain version of K2, in place: OR sending[e // fanout] into
    ring[slot[e], dst[e]] for every ok edge."""
    _or_rows_plain(ring, _edge_words(sending, ok, fanout), dst, slot)


def scatter_sending(ring, sending, dst, slot, ok, fanout: int) -> None:
    """OR each ok edge's sender words into its ring row, in place; K2 on
    the card (a thread per word of a sender's row, for all its edges)."""
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
        [ring, sending, dst, slot, ok], [n, d, w, fanout, 1])


def senders(n: int, fanout: int, device) -> torch.Tensor:
    """src i32[N * F]: the sender e // F of each edge, for the consumers
    that read it (K9's queries, K20's edge entry, the push-pull leg)."""
    return torch.arange(n, dtype=torch.int32,
                        device=device).repeat_interleave(fanout)


def edge_list_plain(targets, group, alive, due=None, topo=None, region=None,
                    t: int = 0, d_slots: int = 0):
    """Plain version of K2's edge pass: JAX's edge list
    (packed.py:435-441, and :1178-1184 with ``due``) — `topology.
    edge_alive`, the flat `topology.edge_slot_plain` — on one table, or on
    each lane's of [K, N, F]."""
    if targets.dim() == 3:
        outs = [edge_list_plain(targets[k], group[k], alive[k],
                                None if due is None else due[k], topo,
                                region, t, d_slots)
                for k in range(targets.shape[0])]
        return tuple(None if outs[0][i] is None
                     else torch.stack([out[i] for out in outs])
                     for i in range(3))
    n, f = targets.shape
    src = senders(n, f, targets.device)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(group, alive, src, dst)
    if due is not None:
        ok &= due[src.long()]
    ok &= dst != src
    slot = (None if topo is None
            else edge_slot_plain(topo, region, src, dst, t, d_slots))
    return dst, ok, slot


def edge_list(targets, group, alive, due=None, topo=None, region=None,
              t: int = 0, d_slots: int = 0):
    """The edge lists of a target table i32[N, F], or of the lanes' [K, N,
    F] (``group``, ``alive`` and ``due`` then [K, N], each lane's targets
    its own): (dst i32[E] clamped at 0, ok bool[E], slot i32[E] or None),
    E = N * F, edge e from sender e // F.  ok is a real target, both ends
    in one partition group and up, not the sender and, with ``due`` (the
    sync's cadence mask), the sender due.  With a flat ``topo`` (no AZ or
    matrix delay classes) the slot is (t + edge_delay) % ``d_slots`` over
    ``region``; without one the caller's slot comes later (K20's edge
    entry, or `topology.edge_slot` after a plan's fixed delays).  K2's
    edge pass on the card, counted as edge_list or, by the lead shape,
    edge_list_lanes; no sender array is built."""
    if targets.device.type == "cpu":
        return edge_list_plain(targets, group, alive, due, topo, region, t,
                               d_slots)
    lead = tuple(targets.shape[:-2])
    n, f = targets.shape[-2:]
    check("targets", targets, torch.int32, (*lead, n, f))
    check("group", group, torch.int32, (*lead, n))
    check("alive", alive, torch.uint8, (*lead, n))
    if due is not None:
        check("due", due, torch.bool, (*lead, n))
    if topo is not None:
        if topo.delay_classes:
            raise ValueError("the edge pass takes the flat delay only: AZ "
                             "and matrix classes go to K20's edge entry")
        check("region", region, torch.int32, (n,))
    dev = targets.device
    dst = torch.empty((*lead, n * f), dtype=torch.int32, device=dev)
    ok = torch.empty((*lead, n * f), dtype=torch.bool, device=dev)
    slot = None if topo is None else torch.empty_like(dst)
    kernel = kernels.EDGE_LIST_LANES if lead else kernels.EDGE_LIST
    kernel.launch(
        [targets, group, alive, due, None if topo is None else region, dst,
         ok, slot],
        [n, f, lead[0] if lead else 1, t, d_slots,
         0 if topo is None else topo.intra_delay,
         0 if topo is None else topo.inter_delay])
    return dst, ok, slot


# (edge, word) pairs per chunk of the plain lossy scatter's draw: 2^17
# pairs are 2^20 hashes, so the int64 threefry temporaries stay near 8 MB
_LOSS_CHUNK_PAIRS = 1 << 17


def _keep_stream_(words, thr, key) -> None:
    """AND each (edge, word) of ``words`` [E, W] with the keep bits of
    one loss stream, in place: payload 32k + b of edge e survives where
    byte e*P + 32k + b of ``aligned_u8_bits(key, [E, P])`` is at least
    thr[e].  Draws only the words of pairs that send something under a
    threshold, in chunks (it syncs with the host to find them)."""
    w = words.shape[1]
    need = (words != 0) & (thr > 0)[:, None]
    e_idx, k_idx = torch.nonzero(need, as_tuple=True)
    dev = words.device
    j = torch.arange(8, dtype=torch.int64, device=dev)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=dev)
    for i0 in range(0, e_idx.numel(), _LOSS_CHUNK_PAIRS):
        e_c = e_idx[i0:i0 + _LOSS_CHUNK_PAIRS]
        k_c = k_idx[i0:i0 + _LOSS_CHUNK_PAIRS]
        # the eight u32 words holding bytes e*P + 32k .. +31
        ctr = ((e_c * 8 * w + 8 * k_c)[:, None] + j).reshape(-1)
        b1, b2 = rng.threefry2x32(key[0], key[1], torch.zeros_like(ctr), ctr)
        byte = (((b1 ^ b2)[:, None] >> shifts) & 0xFF).reshape(-1, 32)
        keep = pack_bits(byte >= thr[e_c, None].to(torch.int64))
        words[e_c, k_c] &= keep.reshape(-1)


#: the jitter draw's bounds: ``randint(key, [E, P], 0, 2^31 - 1)``
JITTER_MAX = (1 << 31) - 1


def _jitter_rows_plain(ring, words, dst, slot, jit, key) -> None:
    """OR each edge's words [E, W] into the ring in place, bit q of edge
    e at slot (slot[e] + j) % D, j = element e*P + q of ``randint(key,
    [E, P], 0, 2^31 - 1)`` mod (jit[e] + 1) where jit[e] > 0 (JAX's
    per-(edge, payload) ``delay_ep`` scatter); other edges' words go to
    slot[e] whole.  Draws only the bits of jittered edges that send, in
    chunks (it syncs with the host to find them)."""
    d, n, w = ring.shape
    p = w * 32
    jittered = (jit > 0)[:, None] & (words != 0)
    _or_rows_plain(ring, torch.where(jittered, 0, words), dst, slot)
    e_idx, k_idx = torch.nonzero(jittered, as_tuple=True)
    if e_idx.numel() == 0:
        return
    dev = words.device
    b = torch.arange(32, dtype=torch.int64, device=dev)
    dense = unpack_bits(ring.reshape(d * n, w), p).to(torch.uint8)
    flat = dense.reshape(-1)
    for i0 in range(0, e_idx.numel(), _LOSS_CHUNK_PAIRS):
        e_c = e_idx[i0:i0 + _LOSS_CHUNK_PAIRS]
        k_c = k_idx[i0:i0 + _LOSS_CHUNK_PAIRS]
        q = (32 * k_c)[:, None] + b  # [pairs, 32] payload indices
        sent = ((words[e_c, k_c].long()[:, None] >> b) & 1).bool()
        draw = rng.randint_at_plain(key, e_c[:, None] * p + q, 0,
                                    JITTER_MAX)
        j = draw % (jit[e_c, None] + 1)
        slot_b = (slot[e_c, None] + j) % d
        rows = slot_b.long() * n + dst[e_c, None].long()
        flat[(rows * p + q)[sent]] = 1
    ring.copy_(pack_bits(dense).reshape(d, n, w))


def scatter_sending_lossy_plain(
    ring, sending, dst, slot, ok, thr, key, seed: int, fanout: int,
    topo_thr: int = 0, topo_key=None, dropped=None, jit=None,
    tiers: Optional[Topology] = None,
) -> None:
    """Plain version of K10 and its tiered instantiation, in place: K2
    with payload q of edge e dropped where the topology stream (byte
    e*P + q of the ``topo_key`` draw below ``topo_thr``, or with
    ``tiers`` below the edge's tier threshold; 256 or more drops all) or
    the fault stream
    (the wire-loss draw below thr[e]) drops it, and with ``jit`` each
    surviving payload of a jittered edge in its own slot
    (`_jitter_rows_plain`); the dropped frames are added to ``dropped``
    when given."""
    words = _edge_words(sending, ok, fanout)
    sent = words.clone() if dropped is not None else None
    if tiers is not None:
        n = sending.shape[0]
        region = regions(n, tiers.n_regions, words.device)
        src = torch.arange(n, dtype=torch.int32,
                           device=words.device).repeat_interleave(fanout)
        raw = edge_loss_thresholds_raw(tiers, region, src, dst)
        words[raw >= 256] = 0
        _keep_stream_(words, torch.where(raw >= 256, 0, raw), topo_key)
    elif topo_thr >= 256:
        words.zero_()
    elif topo_thr > 0:
        _keep_stream_(words, torch.full_like(dst, topo_thr), topo_key)
    if thr is not None:
        _keep_stream_(words, thr, fault_key(key, seed, WIRE_LOSS_TAG))
    if dropped is not None:
        dropped += popcount(sent & ~words).sum()
    if jit is None:
        _or_rows_plain(ring, words, dst, slot)
    else:
        _jitter_rows_plain(ring, words, dst, slot, jit,
                           fault_key(key, seed, JITTER_TAG))


def scatter_sending_lossy(
    ring, sending, dst, slot, ok, thr, key, seed: int, fanout: int,
    topo_thr: int = 0, topo_key=None, dropped=None, jit=None,
    tiers: Optional[Topology] = None,
) -> None:
    """`scatter_sending` under the wire's loss, in place: payload q of
    edge e is dropped where either stream drops it — the flat topology
    loss, byte e*P + q of ``aligned_u8_bits(topo_key, [E, P])`` below
    ``topo_thr`` (JAX ``edge_payload_drop``; ``topo_key`` is the
    broadcast key's ``k_drop``, 0 draws nothing, 256 or more drops
    everything), or the fault plan's, byte e*P + q of
    ``aligned_u8_bits(fold_in(fold_in(key, seed), 101), [E, P])`` below
    thr[e] (JAX ``fault_wire_effects``' drop bits; ``key`` is the
    broadcast phase key; ``thr`` None is no fault loss).  With
    ``dropped`` (an int64 accumulator, the flight recorder's) the frames
    the two streams ate on ok edges are added to it.  With ``jit`` (i32[E]
    jitter bounds, K9's; None is no jitter this round) the third stream
    delays each surviving payload q of an edge with jit[e] > 0 by
    element e*P + q of ``randint(fold_in(fold_in(key, seed), 102), [E,
    P], 0, 2^31 - 1)`` mod (jit[e] + 1) rounds past slot[e] (JAX
    ``fault_wire_effects``' ``delay_ep``).  With ``tiers`` (a topology whose
    loss is tiered, `topology.wire_tiers`; ``topo_thr`` is then 0) the
    topology stream compares the same ``topo_key`` draw against each
    edge's tier threshold instead, and an edge whose tier is at
    certainty (256 or more) drops every payload (JAX ``tiered_edge_drop``
    via ``edge_payload_drop``).  K10 on the card, which draws the bits
    itself; its jitter stream and its tiered instantiation count as
    entries of their own."""
    if ring.device.type == "cpu":
        scatter_sending_lossy_plain(
            ring, sending, dst, slot, ok, thr, key, seed, fanout, topo_thr,
            topo_key, dropped, jit, tiers,
        )
        return
    d, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (d, n, w))
    check("sending", sending, torch.int32, (n, w))
    check("dst", dst, torch.int32, (e,))
    check("slot", slot, torch.int32, (e,))
    check("ok", ok, torch.bool, (e,))
    if thr is not None:
        check("thr", thr, torch.uint8, (e,))
    if jit is not None:
        check("jit", jit, torch.int32, (e,))
    if thr is not None or jit is not None:
        check("key", key, torch.int64, (2,))
    if 0 < topo_thr < 256 or tiers is not None:
        check("topo_key", topo_key, torch.int64, (2,))
    if dropped is not None:
        check("dropped", dropped, torch.int64, ())
    span, mult = rng.scalar_span(0, JITTER_MAX)
    ptrs = [ring, sending, dst, slot, ok, thr,
            None if thr is None and jit is None else key,
            topo_key if 0 < topo_thr < 256 or tiers is not None else None,
            dropped, jit]
    ints = [n, d, w, fanout, seed, WIRE_LOSS_TAG, topo_thr, JITTER_TAG,
            i32(span), i32(mult)]
    if tiers is not None:
        if topo_thr != 0:
            raise ValueError("tiered loss replaces the flat threshold")
        kernels.BROADCAST_SCATTER_TIERED.launch(
            ptrs + [topo_table(tiers, n, ring.device)], ints)
        return
    kernel = (kernels.BROADCAST_SCATTER_LOSSY if jit is None
              else kernels.BROADCAST_SCATTER_JITTER)
    kernel.launch(ptrs, ints)


def scatter_pull_plain(
    ring, sending, dst, slot, ok_pull, thr_rev, k_drop, seed: int,
    fanout: int, topo_thr: int = 0, dropped=None,
    tiers: Optional[Topology] = None,
) -> None:
    """Plain version of K10p, in place: for every ok_pull edge e, OR the
    responder's words sending[dst[e]] into ring[slot[e], e // fanout],
    less what the pull's streams drop — the topology stream on ``k_pull
    = fold_in(k_drop, 1)`` (flat ``topo_thr``, or the reverse edge's tier
    under ``tiers``) and the fault stream on ``fold_in(fold_in(k_pull,
    seed), 101)`` below ``thr_rev[e]``; the dropped frames are added to
    ``dropped`` when given."""
    from ..proto.dissemination import pull_key

    n = sending.shape[0]
    dev = sending.device
    src = torch.arange(n, dtype=torch.int32,
                       device=dev).repeat_interleave(fanout)
    words = torch.where(ok_pull[:, None], sending[dst.long()], 0)
    sent = words.clone() if dropped is not None else None
    k_pull = pull_key(k_drop) if k_drop is not None else None
    if tiers is not None:
        region = regions(n, tiers.n_regions, dev)
        raw = edge_loss_thresholds_raw(tiers, region, dst, src)
        words[raw >= 256] = 0
        _keep_stream_(words, torch.where(raw >= 256, 0, raw), k_pull)
    elif topo_thr >= 256:
        words.zero_()
    elif topo_thr > 0:
        _keep_stream_(words, torch.full_like(dst, topo_thr), k_pull)
    if thr_rev is not None:
        _keep_stream_(words, thr_rev, fault_key(k_pull, seed, WIRE_LOSS_TAG))
    if dropped is not None:
        dropped += popcount(sent & ~words).sum()
    _or_rows_plain(ring, words, src, slot)


def scatter_pull(
    ring, sending, dst, slot, ok_pull, thr_rev, k_drop, seed: int,
    fanout: int, topo_thr: int = 0, dropped=None,
    tiers: Optional[Topology] = None,
) -> None:
    """The push-pull response scatter, in place: every ok_pull edge e
    carries its responder's sending words (``sending`` [N, W], the
    governor's, before the spend) back to the puller e // fanout, into
    the push's slot slot[e], less the pull's loss (`scatter_pull_plain`;
    JAX ``packed.py:514-538`` with ``proto/dissemination.py``'s
    ``pull_wire_drop``).  ``k_drop`` is the broadcast key's second split
    (the kernel folds the pull key from it); ``thr_rev`` the reverse
    edges' fault thresholds (None: no fault loss); ``tiers`` a tiered
    topology (``topo_thr`` then 0).  K10p on the card, counted as
    ``broadcast_pull`` without a stream, ``broadcast_pull_lossy`` with the
    flat or fault stream, ``broadcast_pull_tiered`` under tiers."""
    if ring.device.type == "cpu":
        scatter_pull_plain(ring, sending, dst, slot, ok_pull, thr_rev,
                           k_drop, seed, fanout, topo_thr, dropped, tiers)
        return
    d, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (d, n, w))
    check("sending", sending, torch.int32, (n, w))
    check("dst", dst, torch.int32, (e,))
    check("slot", slot, torch.int32, (e,))
    check("ok_pull", ok_pull, torch.bool, (e,))
    if thr_rev is not None:
        check("thr_rev", thr_rev, torch.uint8, (e,))
    draws = thr_rev is not None or tiers is not None or 0 < topo_thr < 256
    if draws:
        check("k_drop", k_drop, torch.int64, (2,))
    if dropped is not None:
        check("dropped", dropped, torch.int64, ())
    if tiers is not None and topo_thr != 0:
        raise ValueError("tiered loss replaces the flat threshold")
    table = None if tiers is None else topo_table(tiers, n, ring.device)
    kernel = (kernels.BROADCAST_PULL_TIERED if tiers is not None
              else kernels.BROADCAST_PULL_LOSSY if draws or topo_thr >= 256
              else kernels.BROADCAST_PULL)
    kernel.launch(
        [ring, sending, dst, slot, ok_pull, thr_rev,
         k_drop if draws else None, dropped, table],
        [n, d, w, fanout, seed, WIRE_LOSS_TAG, topo_thr])


def broadcast_packed(
    carry: PackedCarry, injected_p: torch.Tensor, state: SimState,
    cfg: SimConfig, topo: Topology, region: torch.Tensor, key: torch.Tensor,
    meta: PayloadMeta, faults: Optional[AnyRoundFaults] = None,
    trace: Optional[RoundTrace] = None, active: Optional[RoundActivity] = None,
) -> PackedCarry:
    """Fan-out push: draw targets (capped by the topology's degree
    classes, K20), spend the relay budget (K8, metered by K16 under the
    byte governor) and OR the sent words into the delay ring (K2) at each
    edge's slot (a geo-tiered or measured-matrix delay class: K20), in
    place.  Under ``faults`` cuts clear edges and the plan's fixed delay
    adds to each edge's slot (K9).  Under the topology's loss (flat or
    tiered) or the plan's loss the scatter drops payloads per (edge,
    payload) from the topology's and the plan's loss draws, and
    under the plan's jitter each surviving payload of a jittered edge
    lands in its own slot (K10's streams in place of K2); the relay
    still spends on the attempt.  ``active`` (the host's copy of the
    round's loss and jitter activity, `faults.host_activity`) leaves out
    the streams of classes that do not apply this round, so a round with
    neither runs K2; without it every class the plan has runs.  JAX
    scatters per payload in every round of a plan with a jitter factor;
    with a jitter bound of 0 everywhere that is the row scatter, so the
    port's choice changes no bit.  With a ``trace`` the wire's telemetry
    goes to its accumulators: the frames and bytes sent on live edges
    (K18), the cut edges (K9) and the frames the loss ate (K10)."""
    n, f = cfg.n_nodes, cfg.fanout
    k_targets, k_drop, k_ring0 = rng.split(key, 3)
    targets = sample_member_targets(state, cfg, k_targets, f)  # [N, F]
    targets = ring0_targets(state, cfg, topo, region, k_ring0, targets)
    # the degree caps, then the fan-out schedule: the spend below reads
    # the scheduled targets
    targets = capped_schedule(targets, topo, cfg, int(state.t))
    sending = spend_relay(carry, injected_p, targets, state.alive,
                          cfg.rate_limit_bytes_round, meta.nbytes)
    t, d_slots = int(state.t), carry.inflight.shape[0]
    tiers = wire_tiers(topo)
    topo_thr = (loss_threshold(topo.loss)
                if topo.loss > 0 and tiers is None else 0)
    # the flat delay without a plan: the edge pass writes the slots too
    flat = faults is None and not topo.delay_classes
    dst, ok, slot = edge_list(targets, state.group, state.alive, None,
                              topo if flat else None, region, t, d_slots)
    # the senders, for K9's queries and K20's edge entry only
    src = None if flat else senders(n, f, targets.device)
    thr = jit = fdelay = None
    if faults is not None:
        ok, thr, fdelay, jit = fault_wire_effects(
            faults, src, dst, ok,
            cut=None if trace is None else acc_slot(trace, "bcast_cut"))
        if active is not None:
            thr = thr if active.loss else None
            jit = jit if active.jitter else None
    if trace is not None:
        wire_words_(trace.acc[WIRE], sending, meta.nbytes, ok, f)
    if slot is None:
        slot = edge_slot(topo, region, src, dst, t, d_slots, fdelay)
    if thr is None and jit is None and topo_thr == 0 and tiers is None:
        scatter_sending(carry.inflight, sending, dst, slot, ok, f)
    else:
        # the tiers ride a keyword only when present: the flat call keeps
        # its arguments
        scatter_sending_lossy(
            carry.inflight, sending, dst, slot, ok, thr, key,
            0 if faults is None else int(faults.seed), f, topo_thr, k_drop,
            None if trace is None or not wire_loss_active(topo, faults)
            else acc_slot(trace, "bcast_dropped"), jit,
            **({} if tiers is None else {"tiers": tiers}),
        )
    if cfg.dissemination == "push-pull":
        # src is read there only under a plan, which builds it above
        _pull_packed(carry, sending, state, cfg, topo, faults, trace, src,
                     dst, ok, slot, thr, k_drop, topo_thr, tiers, meta)
    return carry


def _pull_packed(carry, sending, state, cfg, topo, faults, trace, src, dst,
                 ok, slot, thr, k_drop, topo_thr, tiers, meta) -> None:
    """The push-pull response leg of `broadcast_packed`: the session
    refusal across a cut in either direction (K9), the reverse fault
    thresholds when this round's loss applies (K9 on the swapped edges),
    the response scatter (K10p) and, with a ``trace``, the pull's frames
    and bytes over its edges (K18's pull entry)."""
    from ..proto.dissemination import pull_session_ok, reverse_loss

    f = cfg.fanout
    ok_pull = pull_session_ok(ok, faults, src, dst)
    thr_rev = reverse_loss(faults, src, dst) if thr is not None else None
    scatter_pull(
        carry.inflight, sending, dst, slot, ok_pull, thr_rev, k_drop,
        0 if faults is None else int(faults.seed), f, topo_thr,
        None if trace is None or not wire_loss_active(topo, faults)
        else acc_slot(trace, "bcast_dropped"), tiers)
    if trace is not None:
        wire_words_pull_(trace.acc[WIRE], sending, meta.nbytes, ok_pull, dst)


def deliver_packed_plain(
    carry: PackedCarry, t: int, cfg: SimConfig
) -> PackedCarry:
    """Plain version of K8's deliver and of K8f (its FIFO gate), in
    place."""
    slot = t % carry.inflight.shape[0]
    arriving = carry.inflight[slot]
    pending = carry.sync_buf[slot]
    if order_enforced(cfg):
        admit = admit_words(carry.have, cfg)
        arriving = arriving & admit
        pending = pending & admit
    newly = arriving & ~carry.have
    carry.have.bitwise_or_(arriving | pending)
    planes_set_(carry.relay, newly, max(cfg.max_transmissions - 1, 1))
    carry.inflight[slot] = 0
    carry.sync_buf[slot] = 0
    return carry


def deliver_packed(carry: PackedCarry, t: int, cfg: SimConfig) -> PackedCarry:
    """Broadcast arrivals re-arm the relay budget; the sync ring's slot t
    merges into have without re-arming; both slots are cleared.  Under
    ``ordering="fifo"`` both slots arrive only where the row's admit
    words (`..proto.ordering.admit_words`, from ``have`` before the
    merge) let them; the rest is dropped.  In place; K8 on the card, K8f
    under FIFO."""
    if carry.have.device.type == "cpu":
        return deliver_packed_plain(carry, t, cfg)
    n, w = carry.have.shape
    d_slots = carry.inflight.shape[0]
    _check_words(carry, n, w)
    check("inflight", carry.inflight, torch.int32, (d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (d_slots, n, w))
    if order_enforced(cfg):
        c = cfg.chunks_per_version
        kernels.WORD_DELIVER_FIFO.launch(
            [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
            [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1),
             c, cfg.n_writers * c],
        )
        return carry
    kernels.WORD_DELIVER.launch(
        [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
        [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1)],
    )
    return carry


def sync_pull_plain(masks, miss, peers, ok, slot_words, budget=None,
                    nbytes=None, granted=None, sdelay=None,
                    slot: int = 0) -> torch.Tensor:
    """Plain version of K3: OR the need words pulled from every ok peer,
    each edge metered by `budget_prefix_words_plain`, into
    ``slot_words`` in place — with ``sdelay`` each delay class d < D - 1
    into ring slot (slot + d) % D (JAX's class loop) — and each edge's
    granted words into ``granted`` when given; returns bool[N] fruitful."""
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
    n, s, w = need.shape
    need = budget_prefix_words_plain(need.reshape(n * s, w), budget,
                                     nbytes).reshape(n, s, w)
    if granted is not None:
        granted.copy_(need.reshape(n * s, w))
    if sdelay is None:
        slot_words |= _fold_peers(need)
    else:
        d_slots = slot_words.shape[0]
        classes = sdelay.reshape(n, s, 1)
        for c in range(d_slots - 1):
            slot_words[(slot + c) % d_slots] |= _fold_peers(
                torch.where(classes == c, need, 0))
    return (need != 0).any(dim=2).any(dim=1)


def _fold_peers(need: torch.Tensor) -> torch.Tensor:
    """OR of [N, S, W] over the peers."""
    pulled = need[:, 0]
    for s in range(1, need.shape[1]):
        pulled = pulled | need[:, s]
    return pulled


def sync_masks_plain(heads, gap_lo, gap_hi, have, cfg: SimConfig):
    """Plain version of K3's mask pass (JAX ``sync_packed``'s
    packed.py:1201-1218): each node's group-uniform word masks from its
    advertised heads [..., A] and gap runs [..., A, G] and its ``have``
    words [..., W] — (masks [..., 4, W] = (haves, partial, below, have),
    miss [..., W]); any leading shape (the lanes' [K, N] too)."""
    v = cfg.n_versions
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=have.device)
    miss_w = grid_to_words(gaps_to_mask(gap_lo, gap_hi, v), cfg)
    below_w = grid_to_words(v_idx <= heads[..., None], cfg)
    comp_w = all_chunks_words(have, cfg)
    haves_w = below_w & ~miss_w & comp_w
    partial_w = below_w & ~miss_w & ~comp_w
    return torch.stack([haves_w, partial_w, below_w, have], dim=-2), miss_w


def sync_masks(heads, gap_lo, gap_hi, have, cfg: SimConfig):
    """The sync pull's node masks, `sync_masks_plain`'s (masks, miss): K3's
    mask pass on the card, one launch over every row — the lanes' [K, N]
    folded into K * N rows (counted as its lane entry)."""
    if have.device.type == "cpu":
        return sync_masks_plain(heads, gap_lo, gap_hi, have, cfg)
    *lead, w = have.shape
    a, g = gap_lo.shape[-2:]
    check("heads", heads, torch.int32, (*lead, a))
    check("gap_lo", gap_lo, torch.int32, (*lead, a, g))
    check("gap_hi", gap_hi, torch.int32, (*lead, a, g))
    check("have", have, torch.int32, (*lead, w))
    rows = math.prod(lead)
    masks = torch.empty((*lead, 4, w), dtype=torch.int32, device=have.device)
    miss = torch.empty((*lead, w), dtype=torch.int32, device=have.device)
    kernel = kernels.SYNC_MASKS_LANES if len(lead) == 2 else kernels.SYNC_MASKS
    kernel.launch([heads, gap_lo, gap_hi, have, masks, miss],
                  [rows, a, g, cfg.n_versions, cfg.chunks_per_version, w])
    return masks, miss


def sync_pull(masks, miss, peers, ok, slot_words, budget=None,
              nbytes=None, granted=None, sdelay=None,
              slot: int = 0) -> torch.Tensor:
    """Gather the S peers' mask rows, apply the need algebra, meter each
    edge by ``budget`` (None: unmetered) and OR the pulled words into
    ``slot_words`` [N, W] in place; returns bool[N] fruitful.  With
    ``sdelay`` (i32[N * S] session delays, K9's) ``slot_words`` is the
    whole sync ring [D, N, W] and edge e's grant lands in slot (slot +
    sdelay[e]) % D, a read-OR-write: the slot may hold an earlier
    round's slower grant (classes past D - 2 land nowhere, as in JAX).
    With ``granted`` [N * S, W] each edge's granted words are written
    there too (the flight recorder's grant counts, every class).  K3 on
    the card — its delay entry with ``sdelay``, its metered entry (K16's
    row scan per edge, delay classes too) under a budget."""
    if masks.device.type == "cpu":
        return sync_pull_plain(masks, miss, peers, ok, slot_words, budget,
                               nbytes, granted, sdelay, slot)
    n, _, w = masks.shape
    s = peers.shape[1]
    check("masks", masks, torch.int32, (n, 4, w))
    check("miss", miss, torch.int32, (n, w))
    check("peers", peers, torch.int32, (n, s))
    check("ok", ok, torch.bool, (n, s))
    if sdelay is None:
        check("slot_words", slot_words, torch.int32, (n, w))
        d_slots, slot = 1, 0
    else:
        d_slots = slot_words.shape[0]
        check("sync ring", slot_words, torch.int32, (d_slots, n, w))
        check("sdelay", sdelay, torch.int32, (n * s,))
        if not 0 <= slot < d_slots:
            raise ValueError(f"slot {slot} outside the ring of {d_slots}")
    if granted is not None:
        check("granted", granted, torch.int32, (n * s, w))
    # every node's flag is written by the kernel: no fill, no cast
    fruitful = torch.empty(n, dtype=torch.bool, device=masks.device)
    args = [masks, miss, peers, ok, slot_words, fruitful]
    if budget is None:
        kernel = (kernels.SYNC_PULL if sdelay is None
                  else kernels.SYNC_PULL_DELAY)
        kernel.launch([*args, granted, sdelay], [n, w, s, d_slots, slot])
        return fruitful
    _check_budget(budget, nbytes, w)
    kernels.SYNC_PULL_METERED.launch([*args, nbytes, granted, sdelay],
                                     [n, w, s, d_slots, slot, budget])
    return fruitful


def sync_packed(
    carry: PackedCarry, state: SimState, cfg: SimConfig, topo: Topology,
    key: torch.Tensor, meta: PayloadMeta,
    faults: Optional[AnyRoundFaults] = None,
    trace: Optional[RoundTrace] = None,
):
    """Anti-entropy on packed words: per-node group-uniform masks from the
    advertised heads/gaps, the per-edge pull into the sync ring's slot
    t + 1 (K3, in place), and the fruitfulness-adaptive backoff.  Under
    ``faults`` a session dies on a cut in either direction, and under a
    plan with delay factors each session's grant lands its session delay
    (the slower direction's fault delay) later, in slot t + 1 + d (K9,
    then K3's delay entry); loss and jitter never bite the reliable
    bi-stream.  Returns (carry, countdown, backoff); with a ``trace``
    the refused sessions (K9) and the per-payload grant counts of K3's
    granted words (K17) go to its accumulators, and the sessions' ok
    mask bool[N * S] comes back
    fourth."""
    n, s = cfg.n_nodes, cfg.sync_peers
    ks = rng.split(key, 3)
    k_peers, k_rearm = ks[0], ks[2]
    # the cadence before every use of due: the sessions' ok and the re-arm
    due = cadence_due(state.sync_countdown <= 0, cfg)
    peers = sample_member_targets(state, cfg, k_peers, s)
    dst, ok, _ = edge_list(peers, state.group, state.alive, due)
    sdelay = None
    if faults is not None:
        src = senders(n, s, peers.device)
        if trace is None:
            refused, sdelay = fault_session_effects(faults, src, dst)
        else:
            refused, sdelay = fault_session_effects(
                faults, src, dst, ok, acc_slot(trace, "sync_refused"))
        if refused is not None:
            ok &= ~refused

    masks, miss_w = sync_masks(state.heads, state.gap_lo, state.gap_hi,
                               carry.have, cfg)
    d_slots = carry.sync_buf.shape[0]
    granted = (None if trace is None else
               torch.empty((n * s, carry.have.shape[1]), dtype=torch.int32,
                           device=peers.device))
    slot = (int(state.t) + 1) % d_slots
    fruitful = sync_pull(
        masks, miss_w, dst.reshape(n, s), ok.reshape(n, s),
        carry.sync_buf[slot] if sdelay is None else carry.sync_buf,
        cfg.sync_budget_bytes, meta.nbytes, granted, sdelay, slot,
    )
    if trace is not None:
        count_words_(trace.counts[GRANTS], granted)

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
    if trace is not None:
        return carry, countdown, backoff, ok
    return carry, countdown, backoff


# -- the convergence record -------------------------------------------------

_CONVERGE_SCRATCH = {}


def converge_scratch(device: torch.device, lanes: int, w: int) -> torch.Tensor:
    """K7's self-clearing scratch for ``lanes`` lanes of ``w`` words on
    ``device``: each lane's eight accumulator rows (the column AND and the
    settled word, ones) and its ticket (0), each row W + 1 words rounded
    up to a 128-byte line, allocated at its first use and kept,
    so later calls (and CUDA graphs that captured one) find it clean with
    no fill.  Its first allocation must not fall inside a CUDA-graph
    capture; call this (or the record) once before capturing."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, lanes, w)
    scratch = _CONVERGE_SCRATCH.get(key)
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"converge_record: K7's scratch for {lanes} lanes of {w} "
                "words would first be allocated under CUDA-graph capture; "
                "call packed.converge_scratch(device, lanes, w) (or the "
                "record once) before capturing")
        scratch = _fresh_converge_scratch(device, lanes, w)
        _CONVERGE_SCRATCH[key] = scratch
    return scratch


# K7's accumulator rows a lane (converge_fold.cu kReplicas)
_CONVERGE_ROWS = 8


def _fresh_converge_scratch(device, lanes: int, w: int) -> torch.Tensor:
    stride = -(-(w + 1) // 32) * 32
    scratch = torch.full((lanes, (_CONVERGE_ROWS + 1) * stride), -1,
                         dtype=torch.int32, device=device)
    scratch[:, _CONVERGE_ROWS * stride:] = 0
    return scratch


def launch_converge_record(kernel, have, injected_p, alive, metrics,
                           n_overflow, t: int, cfg: SimConfig, horizon,
                           last_round: int, lanes: int):
    """One K7 launch on ``lanes`` lanes ([N, W] words solo, [K, N, W] on
    the lanes): fresh outputs, the device's scratch, the cell count's f32
    reciprocal as bits.  A launch that fails at once refills the scratch,
    which it may have left dirty, in place, so graphs that captured it
    stay valid."""
    w = have.shape[-1]
    scratch = converge_scratch(have.device, lanes, w)
    converged_at = torch.empty_like(metrics.converged_at)
    coverage_at = torch.empty_like(metrics.coverage_at)
    overflow_frac = torch.empty_like(metrics.overflow_frac)
    done = torch.empty(metrics.overflow_frac.shape, dtype=torch.bool,
                       device=have.device)
    recip = np.float32(1.0) / np.float32(cfg.n_nodes * cfg.n_writers)
    try:
        kernel.launch(
            [have, injected_p, alive, metrics.converged_at, converged_at,
             metrics.coverage_at, coverage_at, n_overflow,
             metrics.overflow_frac, overflow_frac, done, scratch],
            [cfg.n_nodes, w, cfg.chunks_per_version, cfg.n_payloads, t,
             last_round, -1 if horizon is None else horizon,
             int(horizon is not None), int(recip.view(np.int32)), lanes])
    except RuntimeError:
        scratch.copy_(_fresh_converge_scratch(have.device, lanes, w))
        raise
    return coverage_at, converged_at, overflow_frac, done


def converge_record_plain(
    have: torch.Tensor, injected_p: torch.Tensor, alive: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, t: int, cfg: SimConfig,
    n_overflow: torch.Tensor, last_round: int,
    horizon: Optional[int] = None,
):
    """Plain version of K7 (``last_round`` is the kernel's: the plain
    version reads meta.round as JAX does)."""
    up = alive == ALIVE
    c = cfg.chunks_per_version
    overflow_frac = torch.maximum(
        metrics.overflow_frac,
        overflow_fraction(n_overflow, cfg.n_nodes * cfg.n_writers))
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
    settled = (converged_at >= 0) if horizon is None else node_done
    done = (meta.round <= t + 1).all() & (settled | ~up).all()
    if horizon is not None and t + 1 < horizon:
        done = torch.zeros_like(done)
    return coverage_at, converged_at, overflow_frac, done


def converge_record(
    have: torch.Tensor, injected_p: torch.Tensor, alive: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, t: int, cfg: SimConfig,
    n_overflow: torch.Tensor, last_round: int,
    horizon: Optional[int] = None,
):
    """Round t's convergence record on words: (coverage_at i32[P],
    converged_at i32[N], overflow_frac f32, done) — the stamps of payloads
    complete on every up node and of nodes holding every active version,
    the run's overflow fraction folded with this round's K6 count
    ``n_overflow`` (JAX's max with ``overflow.mean(f32)``), and the run's
    exit flag for round t + 1, a bool scalar that stays on the device:
    `_converged_done` on the new metrics, or with a fault plan's
    ``horizon`` the fault loop's flag — t + 1 ≥ horizon and the FRESH
    all-have predicate (`all_have_words`), which a wipe after a node's
    sticky stamp can undo.  ``last_round`` is max(meta.round), which a
    loop reads once a run.  K7 on the card, one launch
    (its last block finishes)."""
    if have.device.type == "cpu":
        return converge_record_plain(
            have, injected_p, alive, metrics, meta, t, cfg, n_overflow,
            last_round, horizon)
    n, w = have.shape
    p = cfg.n_payloads
    check("have", have, torch.int32, (n, w))
    check("injected_p", injected_p, torch.int32, (w,))
    check("alive", alive, torch.uint8, (n,))
    check("converged_at", metrics.converged_at, torch.int32, (n,))
    check("coverage_at", metrics.coverage_at, torch.int32, (p,))
    check("overflow_frac", metrics.overflow_frac, torch.float32, ())
    check("n_overflow", n_overflow, torch.int32, ())
    return launch_converge_record(
        kernels.CONVERGE_RECORD, have, injected_p, alive, metrics,
        n_overflow, t, cfg, horizon, last_round, 1)


# -- the round and the loop --------------------------------------------------


def packed_round_step(
    state: SimState, carry: PackedCarry, injected_p: torch.Tensor,
    metrics: RunMetrics, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    region: torch.Tensor, faults: Optional[AnyRoundFaults] = None,
    horizon: Optional[int] = None, trace: Optional[RoundTrace] = None,
    active: Optional[RoundActivity] = None, *, last_round: int,
):
    """One gossip tick on packed words, phase-for-phase and PRNG-stream
    identical to JAX's ``packed_round_step``: (under PeerSwap the view
    swap, `..topo.sampler.peerswap_step`, on a fifth phase key) inject →
    broadcast → sync → deliver → SWIM → bookkeeping refresh →
    convergence record, with the round's ``faults`` in the swap,
    broadcast, sync and SWIM.  Updates ``carry``
    and ``injected_p`` in place and returns (state, carry, injected_p,
    metrics, done), where ``done`` is the loop's exit flag after the
    round, on the device: JAX's ``_converged_done``, or with a fault
    plan's ``horizon`` its fault loop's (`converge_record`).  With a
    ``trace`` the round's row is recorded in it, in place: the phases
    feed its accumulators, then K17 counts coverage and delivered and
    K19 writes the row (with the fault slice's crashes and wipes).
    ``active`` is the host's copy of the round's loss and jitter activity
    (`broadcast_packed`); ``last_round`` is max(meta.round), read once a
    run by the loops (`converge_record`)."""
    peerswap = cfg.peer_sampler == "peerswap"
    ks = rng.split(state.key, 5 if peerswap else 4)
    state = state._replace(key=ks[0])
    k_bcast, k_sync, k_swim = ks[1], ks[2], ks[3]
    if peerswap:
        # the view swap tick, before inject, so this round's target
        # draws sample the swapped views (JAX's phase order)
        from ..topo.sampler import peerswap_step

        state = peerswap_step(state, cfg, topo, ks[4], faults)
    t = int(state.t)
    have0_w = None if trace is None else carry.have.clone()

    carry, injected_p = inject_packed(
        carry, injected_p, t, meta, cfg, state.alive
    )
    carry = broadcast_packed(
        carry, injected_p, state, cfg, topo, region, k_bcast, meta, faults,
        trace, active,
    )
    sync_ok = None
    if trace is None:
        carry, countdown, backoff = sync_packed(
            carry, state, cfg, topo, k_sync, meta, faults
        )
    else:
        carry, countdown, backoff, sync_ok = sync_packed(
            carry, state, cfg, topo, k_sync, meta, faults, trace
        )
    state = state._replace(sync_countdown=countdown, sync_backoff=backoff)
    carry = deliver_packed(carry, t, cfg)
    state = swim_step(state, cfg, topo, k_swim, faults)

    heads, gap_lo, gap_hi, n_overflow = refresh_gaps(carry.have, cfg)
    state = state._replace(heads=heads, gap_lo=gap_lo, gap_hi=gap_hi)
    coverage_at, converged_at, overflow_frac, done = converge_record(
        carry.have, injected_p, state.alive, metrics, meta, t, cfg,
        n_overflow, last_round, horizon)
    if order_checked(cfg):
        count_order_violations_(metrics.order_violations, carry.have, meta,
                                cfg)
    out_metrics = RunMetrics(
        coverage_at=coverage_at,
        converged_at=converged_at,
        overflow_frac=overflow_frac,
        order_violations=metrics.order_violations,
    )
    if trace is not None:
        coverage_delivered_(trace.counts[COVERAGE:GRANTS], carry.have,
                            have0_w, state.alive)
        record_row(trace, trace_row(trace, t, cfg.trace_every),
                   alive=state.alive, state=state, cfg=cfg, rf=faults,
                   sync_ok=sync_ok, n_overflow=n_overflow, nbytes=meta.nbytes)
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
    max_rounds: int, telemetry: bool = False,
):
    """Pack once, loop rounds on words until convergence or
    ``max_rounds``, unpack once.  Returns (SimState, RunMetrics), and
    with ``telemetry`` the run's `RoundTrace` third."""
    dev = state.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    carry = pack_state(state, cfg)
    inj = pack_bits(state.injected)
    slim = shrink_state(state)
    trace = new_trace(cfg, max_rounds, dev) if telemetry else None
    done = _converged_done(slim, metrics, meta)
    last_round = int(meta.round.max())
    while int(slim.t) < max_rounds and not bool(done):
        slim, carry, inj, metrics, done = packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region, trace=trace,
            last_round=last_round,
        )
    full = unpack_into_state(carry, slim, cfg)
    full = full._replace(
        injected=unpack_bits(inj, cfg.n_payloads).to(torch.uint8)
    )
    if telemetry:
        return full, metrics, trace
    return full, metrics


# -- the packed fault seam ---------------------------------------------------


def apply_carry_faults(
    carry: PackedCarry, rf: AnyRoundFaults
) -> PackedCarry:
    """Packed twin of `faults.apply_node_faults`' payload wipe, IN PLACE:
    a crash-with-wipe zeroes the node's have words, its four relay
    planes and its row in every slot of both word rings."""
    w = rf.wipe
    for x in (carry.have, *carry.relay):
        x.copy_(torch.where(w[:, None], 0, x))
    for x in (carry.inflight, carry.sync_buf):
        x.copy_(torch.where(w[None, :, None], 0, x))
    return carry


def apply_round_faults(
    slim: SimState, carry: PackedCarry, rf: AnyRoundFaults
) -> Tuple[SimState, PackedCarry]:
    """A round's node faults before its phases, IN PLACE on the slim
    state (alive override; a wipe's heads, gaps, member table,
    full-view row and PeerSwap view row) and on the carry (a wipe's
    payload words).  The plain version is
    `faults.apply_node_faults_plain` then `apply_carry_faults`; K11's
    word entry does both in one launch on the card."""
    if carry.have.device.type == "cpu":
        return (apply_node_faults_plain(slim, rf),
                apply_carry_faults(carry, rf))
    n, w = carry.have.shape
    d_slots = carry.inflight.shape[0]
    a = slim.heads.shape[1]
    ak = slim.gap_lo.shape[1] * slim.gap_lo.shape[2]
    m = slim.pid.shape[1]
    _check_words(carry, n, w)
    check("inflight", carry.inflight, torch.int32, (d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (d_slots, n, w))
    check("rf.alive", rf.alive, torch.int8, (n,))
    check("rf.wipe", rf.wipe, torch.bool, (n,))
    check("alive", slim.alive, torch.uint8, (n,))
    check("heads", slim.heads, torch.int32, (n, a))
    for name in ("gap_lo", "gap_hi"):
        check(name, getattr(slim, name), torch.int32, slim.gap_lo.shape)
    for name in ("pid", "pkey", "psince"):
        check(name, getattr(slim, name), torch.int32, (n, m))
    fv = slim.view.shape[0]
    check("view", slim.view, torch.int8, (fv, fv))
    for name in ("vinc", "suspect_since"):
        check(name, getattr(slim, name), torch.int32, (fv, fv))
    v = slim.pview.shape[1]
    check("pview", slim.pview, torch.int32, (n, v))
    kernels.NODE_FAULTS.launch(
        [rf.alive, rf.wipe, slim.alive, carry.have, *carry.relay,
         carry.inflight, carry.sync_buf, slim.heads, slim.gap_lo,
         slim.gap_hi, slim.pid, slim.pkey, slim.psince, slim.view,
         slim.vinc, slim.suspect_since, slim.pview],
        [n, w, d_slots, a, ak, m, fv, v],
    )
    return slim, carry


def all_have_words(
    carry: PackedCarry, injected_p: torch.Tensor, state: SimState,
    meta: PayloadMeta, cfg: SimConfig,
) -> torch.Tensor:
    """Every up node holds every injected version completely, computed
    FRESH from the words (the sticky metrics must not mask a wipe after
    convergence); a device bool.  The loop takes it from K7 after each
    round and evaluates it here only before the first."""
    up = state.alive == ALIVE
    c = cfg.chunks_per_version
    comp_w = all_chunks_words(carry.have, cfg)
    act_w = smear_groups(fold_any(injected_p, c) & group_low_bits_mask(c), c)
    node_done = ((comp_w | ~act_w[None, :]) == ONES).all(dim=1) | ~up
    return (meta.round <= int(state.t)).all() & node_done.all()


def run_packed_faults(
    state: SimState, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    fplan: AnyFaultPlan, max_rounds: int, telemetry: bool = False,
):
    """`run_packed` under a fault schedule: before every round the
    round's node faults hit the slim state and the carry
    (`apply_round_faults`), and the round runs with its fault slice.
    The loop never exits before the plan's horizon, then only on the
    fresh all-have predicate.  It copies the plan's loss and jitter
    activity to the host once, before the first round
    (`faults.host_activity`), for each round's choice of ring scatter.  Returns (SimState, RunMetrics), and with
    ``telemetry`` the run's `RoundTrace` third (each row with its
    round's crashes and wipes)."""
    dev = state.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    carry = pack_state(state, cfg)
    inj = pack_bits(state.injected)
    slim = shrink_state(state)
    # the node faults write these in place: give the loop its own
    slim = slim._replace(**{
        name: getattr(slim, name).clone()
        for name in ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey",
                     "psince", "view", "vinc", "suspect_since", "pview")
    })
    horizon = fplan.horizon
    activity = host_activity(fplan)
    trace = new_trace(cfg, max_rounds, dev) if telemetry else None
    done = (torch.zeros((), dtype=torch.bool, device=dev)
            if int(slim.t) < horizon
            else all_have_words(carry, inj, slim, meta, cfg))
    last_round = int(meta.round.max())
    while int(slim.t) < max_rounds and not bool(done):
        t = int(slim.t)
        rf = round_faults(fplan, t)
        slim, carry = apply_round_faults(slim, carry, rf)
        slim, carry, inj, metrics, done = packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region, rf, horizon,
            trace, activity[min(t, horizon)], last_round=last_round,
        )
    full = unpack_into_state(carry, slim, cfg)
    full = full._replace(
        injected=unpack_bits(inj, cfg.n_payloads).to(torch.uint8)
    )
    if telemetry:
        return full, metrics, trace
    return full, metrics
