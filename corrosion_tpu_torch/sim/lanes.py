"""Seed ensembles on the packed round: K lanes of one configuration as
one lane-batched program — the port of ``jax.vmap`` over
``corrosion_tpu/sim/packed.py:911 run_packed`` and ``:1027
run_packed_faults`` as ``corrosion_tpu/campaign/ensemble.py:114
run_ensemble`` applies it (B16, packed half).

Every per-node tensor of the state and the carry gets a leading lane
axis: ``have [K, N, W]``, the rings ``[K, D, N, W]``, the member tables
``[K, N, M]``, the keys ``[K, 2]``; the payload metadata and a fault
plan's schedule are shared, and only the plan's seed is batched
(``seeds`` i32[K], `campaign.ensemble.lane_plan_seeds`).  Node ids stay
lane-local.  Every phase runs all live lanes at once: the draws are K5's
lane entry (`.rng`), the sampler and the merge K1's and K4's
(`.pswim`), the word phases K8's, the ring scatter K2's or K10's, the
pull K3's, the gap refresh K6's (`.gaps`), the record K7's (one done
flag a lane), the node faults K11's and the probe reach K9's lane entry
(`.faults`); K9's edge queries take the lanes folded into their edge
axis.  Each wrapper runs its plain torch version on a CPU tensor.

**Freezing finished lanes.**  All lanes start at t = 0 and share
``max_rounds``, so every live lane is at the same t and the host keeps
one t.  JAX freezes a finished lane by select inside the batched
while_loop; here the loop reads the ``[K]`` done flags once a round (as
the solo loop reads one), writes a finished lane's slices out — its
carry after that round, which is what JAX's frozen carry holds — and
keeps the live lanes by ``index_select``.  That happens at most K − 1
times a run and is exact: no other lane's tensors change, and every
draw of a live lane depends on its own key alone.

The lane path covers what the two 100k storm cells run: the flat
lossless topology, partial-view SWIM, the baseline protocol, unmetered
budgets and factored fault plans without latency.  `check_packed_lanes`
refuses everything else, naming the ROADMAP item that ports it; the
dense round's lanes (`.dense_lanes`) have `check_dense_lanes`, and share
this module's batch and loop (`_Batch`, `_run_batch`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..device import ONES
from ..kernels.build import check
from . import rng
from .faults import (
    WIRE_LOSS_TAG,
    FactoredFaultPlan,
    FactoredRoundFaults,
    _zero_rows_,
    fault_session_refused,
    fault_wire_effects,
    host_activity,
    round_faults,
)
from .gaps import gaps_to_mask, refresh_gaps_lanes
from .packed import (
    CONVERGE_ROWS_PER_BLOCK,
    PackedCarry,
    Planes,
    planes_dec_,
    pack_state,
    planes_set_,
    unpack_into_state,
)
from .pswim import psample_member_targets_lanes, pswim_step_lanes
from .round import RunMetrics, overflow_fraction
from .state import ALIVE, PayloadMeta, SimConfig, SimState, packed_supported
from .topology import Topology, edge_slot_plain, regions
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


def _check_shared(cfg: SimConfig, topo: Topology, telemetry: bool) -> None:
    """The refusals both rounds' lanes share: the recorder, topology
    keys, PeerSwap and the protocol variants."""
    if telemetry:
        raise NotImplementedError(
            "the flight recorder on lanes is not ported yet (K17-K19 "
            "lanes, ROADMAP B16d)")
    if topo != Topology():
        raise NotImplementedError(
            "topology families and keys on lanes are not ported yet "
            "(ROADMAP B16d)")
    if cfg.peer_sampler != "uniform":
        raise NotImplementedError(
            "the PeerSwap sampler on lanes is not ported yet (ROADMAP "
            "B16d)")
    if (cfg.dissemination, cfg.fanout_schedule, cfg.sync_cadence,
            cfg.ordering) != ("push", "flat", "periodic", "none"):
        raise NotImplementedError(
            "protocol variants on lanes are not ported yet (ROADMAP "
            "B16d)")


def check_packed_lanes(cfg: SimConfig, topo: Topology, fplan=None,
                       telemetry: bool = False) -> None:
    """Refuse, loudly and naming the ROADMAP item that ports it, every
    configuration the packed round's lanes do not run: the recorder,
    metered budgets, topology keys, samplers and protocols other than
    the defaults, full view or ground-truth membership, matrix plans and
    plans with delay or jitter."""
    if not packed_supported(cfg, topo):
        raise ValueError("a dense configuration on the packed round's "
                         "lanes: run it through `.dense_lanes`")
    _check_shared(cfg, topo, telemetry)
    if cfg.rate_limit_bytes_round is not None or (
            cfg.sync_budget_bytes is not None):
        raise NotImplementedError(
            "metered budgets on the packed round's lanes are not ported "
            "yet (K16 and K3's metered entry, ROADMAP B16d): "
            "set rate_limit_bytes_round and sync_budget_bytes to None")
    if not (cfg.swim_partial_view and cfg.couple_membership):
        raise NotImplementedError(
            "the packed round's lanes run partial-view SWIM only; full "
            "view and ground-truth membership run on the dense round's "
            "lanes (force the dense round with allow_packed=False), not "
            "on the packed round's (ROADMAP B16d)")
    if fplan is not None:
        if not isinstance(fplan, FactoredFaultPlan):
            raise NotImplementedError(
                "matrix fault plans on lanes are not ported yet (ROADMAP "
                "B16d); compile the plan factored")
        if fplan.delay_src.shape[0] or fplan.jitter_src.shape[0]:
            raise NotImplementedError(
                "delay and jitter on lanes are not ported yet (K9's "
                "latency entry, K10j, K3's delay entry: ROADMAP B16d)")


def check_dense_lanes(cfg: SimConfig, topo: Topology, fplan=None,
                      telemetry: bool = False) -> None:
    """Refuse, naming the ROADMAP item that ports it, every configuration
    the dense round's lanes do not run: fault plans, the recorder,
    topology keys, PeerSwap and the protocol variants.  Both byte
    budgets run (inside K12's and K13's lane entries), and so do full
    view, partial view and ground-truth membership."""
    if packed_supported(cfg, topo):
        raise ValueError("a packed configuration on the dense round's "
                         "lanes: run it through `run_lanes`")
    if fplan is not None:
        raise NotImplementedError(
            "fault plans on the dense round's lanes are not ported yet "
            "(K9m, K11d, K12f, K13d and K14x lanes: the next item of "
            "ROADMAP B16d)")
    _check_shared(cfg, topo, telemetry)


# -- the word phases (K8) ----------------------------------------------------


def _check_lane_words(carry: PackedCarry, lanes: int, n: int, w: int):
    check("have", carry.have, torch.int32, (lanes, n, w))
    for k, plane in enumerate(carry.relay):
        check(f"relay.r{k}", plane, torch.int32, (lanes, n, w))


def inject_lanes_plain(carry: PackedCarry, inj: torch.Tensor, t: int,
                       meta: PayloadMeta, cfg: SimConfig,
                       alive: torch.Tensor) -> None:
    """Plain version of K8's inject lane entry, in place."""
    lanes, n, w = carry.have.shape
    p = cfg.n_payloads
    dev = carry.have.device
    up_w = torch.gather(alive, 1, meta.actor.long()[None].expand(
        lanes, p)) == ALIVE
    injecting = (meta.round == t)[None] & up_w
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    bit = torch.bitwise_left_shift(torch.ones_like(idx), idx % 32)
    contrib = torch.where(injecting, bit, 0)
    own = torch.zeros((lanes, n * w), dtype=torch.int32,
                      device=dev).index_add_(
        1, (meta.actor * w + idx // 32).long(), contrib
    ).reshape(lanes, n, w)
    newly = own & ~carry.have
    carry.have.bitwise_or_(own)
    planes_set_(carry.relay, newly, cfg.max_transmissions)
    inj |= pack_bits(injecting)


def inject_lanes(carry: PackedCarry, inj: torch.Tensor, t: int,
                 meta: PayloadMeta, cfg: SimConfig,
                 alive: torch.Tensor) -> None:
    """`packed.inject_packed` over the lanes, in place (``inj`` [K, W]);
    K8's inject lane entry on the card."""
    if carry.have.device.type == "cpu":
        inject_lanes_plain(carry, inj, t, meta, cfg, alive)
        return
    lanes, n, w = carry.have.shape
    p = cfg.n_payloads
    _check_lane_words(carry, lanes, n, w)
    check("injected_p", inj, torch.int32, (lanes, w))
    check("meta.round", meta.round, torch.int32, (p,))
    check("meta.actor", meta.actor, torch.int32, (p,))
    check("alive", alive, torch.uint8, (lanes, n))
    kernels.WORD_INJECT_LANES.launch(
        [meta.round, meta.actor, alive, carry.have, *carry.relay, inj],
        [n, w, p, t, cfg.max_transmissions, lanes],
    )


def spend_lanes_plain(carry: PackedCarry, inj: torch.Tensor,
                      targets: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's spend lane entry."""
    n = carry.have.shape[1]
    sending = carry.have & carry.relay.nonzero & inj[:, None, :]
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    attempted = (targets >= 0) & (targets != me[None, :, None])
    any_attempt = attempted.any(dim=2) & (alive == ALIVE)
    planes_dec_(carry.relay, torch.where(any_attempt[..., None], sending, 0))
    return sending


def spend_lanes(carry: PackedCarry, inj: torch.Tensor,
                targets: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """`packed.spend_relay` over the lanes, unmetered: the sending words
    [K, N, W]; the relay planes count down in place where an up row
    attempted a send.  K8's spend lane entry on the card."""
    if carry.have.device.type == "cpu":
        return spend_lanes_plain(carry, inj, targets, alive)
    lanes, n, w = carry.have.shape
    f = targets.shape[2]
    _check_lane_words(carry, lanes, n, w)
    check("injected_p", inj, torch.int32, (lanes, w))
    check("targets", targets, torch.int32, (lanes, n, f))
    check("alive", alive, torch.uint8, (lanes, n))
    sending = torch.empty_like(carry.have)
    kernels.WORD_SPEND_LANES.launch(
        [carry.have, *carry.relay, inj, targets, alive, sending],
        [n, w, f, 0, lanes])
    return sending


def deliver_lanes_plain(carry: PackedCarry, t: int, cfg: SimConfig) -> None:
    """Plain version of K8's deliver lane entry, in place."""
    slot = t % carry.inflight.shape[1]
    arriving = carry.inflight[:, slot]
    pending = carry.sync_buf[:, slot]
    newly = arriving & ~carry.have
    carry.have.bitwise_or_(arriving | pending)
    planes_set_(carry.relay, newly, max(cfg.max_transmissions - 1, 1))
    carry.inflight[:, slot] = 0
    carry.sync_buf[:, slot] = 0


def deliver_lanes(carry: PackedCarry, t: int, cfg: SimConfig) -> None:
    """`packed.deliver_packed` over the lanes, in place; K8's deliver
    lane entry on the card."""
    if carry.have.device.type == "cpu":
        deliver_lanes_plain(carry, t, cfg)
        return
    lanes, n, w = carry.have.shape
    d_slots = carry.inflight.shape[1]
    _check_lane_words(carry, lanes, n, w)
    check("inflight", carry.inflight, torch.int32, (lanes, d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (lanes, d_slots, n, w))
    kernels.WORD_DELIVER_LANES.launch(
        [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
        [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1),
         lanes])


# -- the ring scatter (K2, K10) ---------------------------------------------


def _lane_edge_words(sending, ok, fanout: int) -> torch.Tensor:
    words = sending.repeat_interleave(fanout, dim=1)  # [K, E, W]
    return torch.where(ok[..., None], words, 0)


def _or_rows_lanes(ring, words, dst, slot) -> None:
    """OR each lane's edge words [K, E, W] into its ring [K, D, N, W] at
    (slot, dst), in place: the solo plain scatter on the lanes folded
    into the ring's slot axis."""
    from .packed import _or_rows_plain

    lanes, d_slots, n, w = ring.shape
    base = (torch.arange(lanes, dtype=torch.int32,
                         device=ring.device) * d_slots)[:, None]
    _or_rows_plain(ring.view(lanes * d_slots, n, w),
                   words.reshape(-1, w), dst.reshape(-1),
                   (slot + base).reshape(-1))


def _keep_stream_lanes_(words, thr, keys) -> None:
    """`packed._keep_stream_` over the lanes, in place on [K, E, W]:
    lane k's payload 32j + b of edge e survives where byte e*P + 32j + b
    of ``aligned_u8_bits(keys[k], [E, P])`` is at least thr[k, e] — the
    lane's own key, lane-local counters."""
    w = words.shape[2]
    need = (words != 0) & (thr > 0)[..., None]
    l_idx, e_idx, k_idx = torch.nonzero(need, as_tuple=True)
    if l_idx.numel() == 0:
        return
    dev = words.device
    j = torch.arange(8, dtype=torch.int64, device=dev)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=dev)
    ctr = ((e_idx * 8 * w + 8 * k_idx)[:, None] + j).reshape(-1)
    k1 = keys[l_idx, 0].repeat_interleave(8)
    k2 = keys[l_idx, 1].repeat_interleave(8)
    b1, b2 = rng.threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    byte = (((b1 ^ b2)[:, None] >> shifts) & 0xFF).reshape(-1, 32)
    keep = pack_bits(byte >= thr[l_idx, e_idx, None].to(torch.int64))
    words[l_idx, e_idx, k_idx] &= keep.reshape(-1)


def scatter_lanes_plain(ring, sending, dst, slot, ok, fanout: int,
                        thr=None, keys=None, seeds=None) -> None:
    """Plain version of K2's lane entry (and with ``thr`` K10's), in
    place."""
    words = _lane_edge_words(sending, ok, fanout)
    if thr is not None:
        fk = rng.fold_in_lanes_plain(rng.fold_in_lanes_plain(keys, seeds),
                                     WIRE_LOSS_TAG)
        _keep_stream_lanes_(words, thr, fk)
    _or_rows_lanes(ring, words, dst, slot)


def scatter_lanes(ring, sending, dst, slot, ok, fanout: int, thr=None,
                  keys=None, seeds=None) -> None:
    """`packed.scatter_sending` (and with ``thr`` the fault stream of
    `packed.scatter_sending_lossy`) over the lanes, in place on the rings
    [K, D, N, W]: lane k's ok edges OR its sending words into its ring,
    less what its wire-loss draw ``fold_in(fold_in(keys[k], seeds[k]),
    101)`` drops under thr[k, e].  K2's lane entry, or K10's."""
    if ring.device.type == "cpu":
        scatter_lanes_plain(ring, sending, dst, slot, ok, fanout, thr, keys,
                            seeds)
        return
    lanes, d_slots, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (lanes, d_slots, n, w))
    check("sending", sending, torch.int32, (lanes, n, w))
    check("dst", dst, torch.int32, (lanes, e))
    check("slot", slot, torch.int32, (lanes, e))
    check("ok", ok, torch.bool, (lanes, e))
    if thr is None:
        kernels.BROADCAST_SCATTER_LANES.launch(
            [ring, sending, dst, slot, ok], [n, d_slots, w, fanout, lanes])
        return
    check("thr", thr, torch.uint8, (lanes, e))
    check("keys", keys, torch.int64, (lanes, 2))
    check("seeds", seeds, torch.int32, (lanes,))
    kernels.BROADCAST_SCATTER_LOSSY_LANES.launch(
        [ring, sending, dst, slot, ok, thr, keys, seeds],
        [n, d_slots, w, fanout, WIRE_LOSS_TAG, lanes])


# -- the sync pull (K3) ------------------------------------------------------


def sync_pull_lanes_plain(masks, miss, peers, ok, ring,
                          slot: int) -> torch.Tensor:
    """Plain version of K3's lane entry: the need algebra on each lane's
    gathered peer rows, the grants ORed into its ring's slot in place."""
    lanes, n, _, w = masks.shape
    s = peers.shape[2]
    haves_w, partial_w, below_w, have_w = masks.unbind(dim=2)
    off = (torch.arange(lanes, device=masks.device) * n)[:, None, None]
    d = masks.reshape(lanes * n, 4, w)[peers.long() + off]
    haves_d, partial_d, below_d, have_d = d.unbind(dim=3)
    wanted = (
        (miss[:, :, None, :] & haves_d)
        | (partial_w[:, :, None, :] & (haves_d | partial_d))
        | (~below_w[:, :, None, :] & below_d)
    )
    need = wanted & have_d & ~have_w[:, :, None, :]
    need = torch.where(ok[..., None], need, 0)
    pulled = need[:, :, 0]
    for j in range(1, s):
        pulled = pulled | need[:, :, j]
    ring[:, slot] |= pulled
    return (need != 0).any(dim=3).any(dim=2)


def sync_pull_lanes(masks, miss, peers, ok, ring, slot: int) -> torch.Tensor:
    """`packed.sync_pull` over the lanes, unmetered and without session
    delays: each lane's sessions pull from its own rows (``peers``
    [K, N, S] lane-local) into slot ``slot`` of its sync ring [K, D, N, W]
    in place; returns bool [K, N] fruitful.  K3's lane entry on the
    card."""
    if masks.device.type == "cpu":
        return sync_pull_lanes_plain(masks, miss, peers, ok, ring, slot)
    lanes, n, _, w = masks.shape
    s = peers.shape[2]
    d_slots = ring.shape[1]
    check("masks", masks, torch.int32, (lanes, n, 4, w))
    check("miss", miss, torch.int32, (lanes, n, w))
    check("peers", peers, torch.int32, (lanes, n, s))
    check("ok", ok, torch.bool, (lanes, n, s))
    check("sync ring", ring, torch.int32, (lanes, d_slots, n, w))
    if not 0 <= slot < d_slots:
        raise ValueError(f"slot {slot} outside the ring of {d_slots}")
    fruitful = torch.zeros((lanes, n), dtype=torch.uint8,
                           device=masks.device)
    kernels.SYNC_PULL_LANES.launch(
        [masks, miss, peers, ok, ring, fruitful],
        [n, w, s, d_slots, slot, lanes])
    return fruitful.to(torch.bool)


# -- the convergence record (K7) ---------------------------------------------


def converge_record_lanes_plain(have, inj, alive, metrics: RunMetrics,
                                meta: PayloadMeta, t: int, cfg: SimConfig,
                                horizon: Optional[int] = None):
    """Plain version of K7's lane entries: the solo record per lane."""
    p = cfg.n_payloads
    c = cfg.chunks_per_version
    up = alive == ALIVE
    comp_w = all_chunks_words(have, cfg)
    act_w = smear_groups(fold_any(inj, c) & group_low_bits_mask(c), c)
    masked = torch.where(up[..., None], comp_w, ONES)
    payload_done = unpack_bits(and_rows(masked.transpose(0, 1)) & act_w, p)
    coverage_at = torch.where(
        (metrics.coverage_at < 0) & payload_done, t, metrics.coverage_at
    ).to(torch.int32)
    node_done = ((comp_w | ~act_w[:, None, :]) == ONES).all(dim=2) & up
    all_injected = (meta.round <= t).all()
    converged_at = torch.where(
        (metrics.converged_at < 0) & node_done & all_injected,
        t, metrics.converged_at,
    ).to(torch.int32)
    settled = (converged_at >= 0) if horizon is None else node_done
    done = (meta.round <= t + 1).all() & (settled | ~up).all(dim=1)
    if horizon is not None and t + 1 < horizon:
        done = torch.zeros_like(done)
    return coverage_at, converged_at, done


def converge_record_lanes(have, inj, alive, metrics: RunMetrics,
                          meta: PayloadMeta, t: int, cfg: SimConfig,
                          horizon: Optional[int] = None):
    """`packed.converge_record` per lane: (coverage_at i32[K, P],
    converged_at i32[K, N], done bool[K]) — each lane's stamps and exit
    flag from its own rows only, in the faultless or (with ``horizon``)
    the fault loop's mode.  K7's lane entries on the card."""
    if have.device.type == "cpu":
        return converge_record_lanes_plain(have, inj, alive, metrics, meta,
                                           t, cfg, horizon)
    lanes, n, w = have.shape
    p = cfg.n_payloads
    c = cfg.chunks_per_version
    check("have", have, torch.int32, (lanes, n, w))
    check("injected_p", inj, torch.int32, (lanes, w))
    check("alive", alive, torch.uint8, (lanes, n))
    check("meta.round", meta.round, torch.int32, (p,))
    check("converged_at", metrics.converged_at, torch.int32, (lanes, n))
    check("coverage_at", metrics.coverage_at, torch.int32, (lanes, p))
    rows = CONVERGE_ROWS_PER_BLOCK
    blocks = -(-n // rows)
    dev = have.device
    partial = torch.empty((lanes, blocks, w + 1), dtype=torch.int32,
                          device=dev)
    converged_at = torch.empty_like(metrics.converged_at)
    coverage_at = torch.empty_like(metrics.coverage_at)
    done = torch.empty((lanes,), dtype=torch.bool, device=dev)
    kernels.CONVERGE_ROWS_LANES.launch(
        [have, inj, alive, meta.round, metrics.converged_at, converged_at,
         partial],
        [n, w, c, p, t, rows, int(horizon is not None), lanes],
    )
    kernels.CONVERGE_FINISH_LANES.launch(
        [partial, inj, meta.round, metrics.coverage_at, coverage_at, done],
        [blocks, w, c, p, t, -1 if horizon is None else horizon, lanes],
    )
    return coverage_at, converged_at, done


# -- the node faults (K11) ---------------------------------------------------


def apply_round_faults_lanes_plain(slim: SimState, carry: PackedCarry,
                                   rf: FactoredRoundFaults) -> None:
    """Plain version of K11's lane entry, in place."""
    slim.alive.copy_(torch.where(
        rf.alive[None] >= 0, rf.alive.to(slim.alive.dtype)[None],
        slim.alive))
    wipe = rf.wipe
    for x in (carry.have, *carry.relay, slim.heads, slim.gap_lo,
              slim.gap_hi):
        _zero_rows_(x, wipe, 1)
    for x in (carry.inflight, carry.sync_buf):
        _zero_rows_(x, wipe, 2)
    for x in (slim.pid, slim.pkey, slim.psince, slim.pview):
        _zero_rows_(x, wipe, 1, -1)


def apply_round_faults_lanes(slim: SimState, carry: PackedCarry,
                             rf: FactoredRoundFaults) -> None:
    """`packed.apply_round_faults` over the lanes, in place: the round's
    shared alive overrides and wipes hit every lane's rows (JAX shares
    the schedule unbatched, ``ensemble.py:147-158``).  K11's lane entry
    on the card."""
    if carry.have.device.type == "cpu":
        apply_round_faults_lanes_plain(slim, carry, rf)
        return
    lanes, n, w = carry.have.shape
    d_slots = carry.inflight.shape[1]
    a = slim.heads.shape[2]
    ak = slim.gap_lo.shape[2] * slim.gap_lo.shape[3]
    m = slim.pid.shape[2]
    v = slim.pview.shape[2]
    _check_lane_words(carry, lanes, n, w)
    check("inflight", carry.inflight, torch.int32, (lanes, d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (lanes, d_slots, n, w))
    check("rf.alive", rf.alive, torch.int8, (n,))
    check("rf.wipe", rf.wipe, torch.bool, (n,))
    check("alive", slim.alive, torch.uint8, (lanes, n))
    check("heads", slim.heads, torch.int32, (lanes, n, a))
    for name in ("gap_lo", "gap_hi"):
        check(name, getattr(slim, name), torch.int32, slim.gap_lo.shape)
    for name in ("pid", "pkey", "psince"):
        check(name, getattr(slim, name), torch.int32, (lanes, n, m))
    check("pview", slim.pview, torch.int32, (lanes, n, v))
    kernels.NODE_FAULTS_LANES.launch(
        [rf.alive, rf.wipe, slim.alive, carry.have, *carry.relay,
         carry.inflight, carry.sync_buf, slim.heads, slim.gap_lo,
         slim.gap_hi, slim.pid, slim.pkey, slim.psince, None, None, None,
         slim.pview],
        [n, w, d_slots, a, ak, m, 0, v, lanes],
    )


# -- the round ----------------------------------------------------------------


def _edge_alive_lanes(state: SimState, src, dst) -> torch.Tensor:
    """`topology.edge_alive` per lane, src [1 or K, E] and dst [K, E]."""
    lanes = state.alive.shape[0]
    src = src.expand(lanes, -1).long()
    dst = dst.long()
    return ((torch.gather(state.group, 1, src)
             == torch.gather(state.group, 1, dst))
            & (torch.gather(state.alive, 1, src) == ALIVE)
            & (torch.gather(state.alive, 1, dst) == ALIVE))


def broadcast_lanes(carry: PackedCarry, inj, state: SimState,
                    cfg: SimConfig, topo: Topology, region, keys,
                    faults=None, seeds=None, loss: bool = True) -> None:
    """`packed.broadcast_packed` over the lanes, in place: each lane's
    targets (K1's lane entry), its spend (K8) and its ring scatter (K2,
    or under this round's fault loss K10 with its own key and seed);
    cuts clear edges through K9 on the lanes folded into its edge axis.
    ``loss`` is the host's copy of the round's loss activity."""
    lanes = keys.shape[0]
    n, f = cfg.n_nodes, cfg.fanout
    ks = rng.split_lanes(keys, 3)
    targets = psample_member_targets_lanes(state, cfg,
                                           ks[:, 0].contiguous(), f)
    sending = spend_lanes(carry, inj, targets, state.alive)
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    src = me.repeat_interleave(f)[None]
    dst = targets.reshape(lanes, n * f)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= _edge_alive_lanes(state, src, dst)
    ok &= dst != src
    thr = None
    if faults is not None:
        flat_ok = ok.reshape(-1)
        flat_ok, thr, _, _ = fault_wire_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            flat_ok)
        ok = flat_ok.reshape(lanes, -1)
        thr = thr.reshape(lanes, -1) if thr is not None and loss else None
    slot = edge_slot_plain(topo, region, src, dst, int(state.t),
                           carry.inflight.shape[1])
    scatter_lanes(carry.inflight, sending, dst, slot, ok, f, thr, keys,
                  seeds)


def sync_lanes(carry: PackedCarry, state: SimState, cfg: SimConfig,
               keys, faults=None):
    """`packed.sync_packed` over the lanes: each lane's peers (K1), the
    need masks from its heads and gaps, the pull into its sync ring's
    slot t + 1 (K3's lane entry) and its backoff and re-arm draws (K5);
    a cut in either direction refuses a session (K9, folded).  Returns
    (countdown, backoff), [K, N] each."""
    lanes = keys.shape[0]
    n, s = cfg.n_nodes, cfg.sync_peers
    ks = rng.split_lanes(keys, 3)
    k_peers, k_rearm = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    due = state.sync_countdown <= 0
    peers = psample_member_targets_lanes(state, cfg, k_peers, s)
    me = torch.arange(n, dtype=torch.int32, device=peers.device)
    src = me.repeat_interleave(s)[None]
    dst = peers.reshape(lanes, n * s)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= _edge_alive_lanes(state, src, dst)
    ok &= due[:, src[0].long()]
    ok &= dst != src
    if faults is not None:
        refused = fault_session_refused(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1))
        if refused is not None:
            ok &= ~refused.reshape(lanes, -1)

    v = cfg.n_versions
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=peers.device)
    miss_w = grid_to_words(gaps_to_mask(state.gap_lo, state.gap_hi, v), cfg)
    below_w = grid_to_words(v_idx <= state.heads[..., None], cfg)
    comp_w = all_chunks_words(carry.have, cfg)
    haves_w = below_w & ~miss_w & comp_w
    partial_w = below_w & ~miss_w & ~comp_w
    masks = torch.stack([haves_w, partial_w, below_w, carry.have], dim=2)
    slot = (int(state.t) + 1) % carry.sync_buf.shape[1]
    fruitful = sync_pull_lanes(masks, miss_w, dst.reshape(lanes, n, s),
                               ok.reshape(lanes, n, s), carry.sync_buf, slot)
    backoff = torch.where(
        due & fruitful,
        cfg.sync_interval_rounds,
        torch.where(
            due,
            torch.clamp(state.sync_backoff * 2, max=cfg.sync_backoff_cap()),
            state.sync_backoff,
        ),
    ).to(torch.int32)
    rearm = rng.randint_lanes(k_rearm, (n,), 1, backoff + 1)
    countdown = torch.where(due, rearm, state.sync_countdown - 1)
    return countdown, backoff


def packed_round_step_lanes(state: SimState, carry: PackedCarry, inj,
                            metrics: RunMetrics, meta: PayloadMeta,
                            cfg: SimConfig, topo: Topology, region,
                            faults=None, horizon: Optional[int] = None,
                            seeds=None, loss: bool = True):
    """One gossip tick of every lane, phase for phase the solo
    `packed.packed_round_step` with lane k's keys: inject → broadcast →
    sync → deliver → SWIM → gap refresh → convergence record, the
    round's shared fault slice in the broadcast, sync and SWIM.  Updates
    ``carry`` and ``inj`` in place; returns (state, metrics, done) with
    done bool[K] on the device."""
    ks = rng.split_lanes(state.key, 4)
    state = state._replace(key=ks[:, 0].contiguous())
    k_bcast, k_sync, k_swim = (ks[:, i].contiguous() for i in (1, 2, 3))
    t = int(state.t)
    inject_lanes(carry, inj, t, meta, cfg, state.alive)
    broadcast_lanes(carry, inj, state, cfg, topo, region, k_bcast, faults,
                    seeds, loss)
    countdown, backoff = sync_lanes(carry, state, cfg, k_sync, faults)
    state = state._replace(sync_countdown=countdown, sync_backoff=backoff)
    deliver_lanes(carry, t, cfg)
    state = pswim_step_lanes(state, cfg, topo, k_swim, faults, seeds)
    heads, gap_lo, gap_hi, n_overflow = refresh_gaps_lanes(carry.have, cfg)
    state = state._replace(heads=heads, gap_lo=gap_lo, gap_hi=gap_hi)
    overflow_frac = torch.maximum(
        metrics.overflow_frac,
        overflow_fraction(n_overflow, heads[0].numel()))
    coverage_at, converged_at, done = converge_record_lanes(
        carry.have, inj, state.alive, metrics, meta, t, cfg, horizon)
    metrics = RunMetrics(coverage_at=coverage_at, converged_at=converged_at,
                         overflow_frac=overflow_frac,
                         order_violations=metrics.order_violations)
    return state._replace(t=state.t + 1), metrics, done


# -- the loops ----------------------------------------------------------------


class _Batch(NamedTuple):
    """The live lanes: state, carry and injected words (the packed
    round's; None on the dense round, whose state holds them), metrics,
    plan seeds, their indices in the ensemble, and a loop's own per-lane
    tensors (``extra``, each [K, ...], kept and dropped with the
    lanes)."""

    slim: SimState
    carry: Optional[PackedCarry]
    inj: Optional[torch.Tensor]
    metrics: RunMetrics
    seeds: Optional[torch.Tensor]
    lanes: List[int]
    extra: Tuple[torch.Tensor, ...] = ()


def _select(x, idx):
    if x is None or x.dim() == 0:
        return x
    return x.index_select(0, idx)


def _keep(batch: _Batch, keep: List[int]) -> _Batch:
    """The batch restricted to its rows ``keep`` (index_select: new
    tensors, so the dropped lanes' slices stay as they were)."""
    idx = torch.tensor(keep, dtype=torch.long,
                       device=batch.slim.alive.device)
    slim = batch.slim._replace(**{
        name: _select(getattr(batch.slim, name), idx)
        for name in SimState._fields if name != "t"})
    carry = None if batch.carry is None else PackedCarry(
        have=_select(batch.carry.have, idx),
        inflight=_select(batch.carry.inflight, idx),
        relay=Planes(*(_select(p, idx) for p in batch.carry.relay)),
        sync_buf=_select(batch.carry.sync_buf, idx),
    )
    return _Batch(slim, carry, _select(batch.inj, idx),
                  RunMetrics(*(_select(x, idx) for x in batch.metrics)),
                  _select(batch.seeds, idx),
                  [batch.lanes[i] for i in keep],
                  tuple(_select(x, idx) for x in batch.extra))


def _lane_slice(batch: _Batch, i: int):
    """Row i of the batch, cloned: the lane's frozen result (state,
    carry, injected words, metrics, its rows of ``extra``)."""
    slim = batch.slim._replace(**{
        name: getattr(batch.slim, name)[i].clone()
        for name in SimState._fields if name != "t"})
    slim = slim._replace(t=batch.slim.t.clone())
    carry = None if batch.carry is None else PackedCarry(
        have=batch.carry.have[i].clone(),
        inflight=batch.carry.inflight[i].clone(),
        relay=Planes(*(p[i].clone() for p in batch.carry.relay)),
        sync_buf=batch.carry.sync_buf[i].clone(),
    )
    metrics = RunMetrics(*(x[i].clone() for x in batch.metrics))
    inj = None if batch.inj is None else batch.inj[i].clone()
    return slim, carry, inj, metrics, tuple(x[i].clone()
                                            for x in batch.extra)


def _stack_results(finished, cfg: SimConfig):
    """The lanes' frozen results in lane order as one stacked
    (SimState, RunMetrics): every field [K, ...], ``t`` i32[K]; the
    packed round's words unpacked into the state."""
    slims, carries, injs, metrics, _ = zip(*finished)

    def stack(xs):
        return torch.stack(list(xs))

    full = SimState(*(stack(getattr(s, name) for s in slims)
                      for name in SimState._fields))
    if carries[0] is not None:
        carry = PackedCarry(
            have=stack(c.have for c in carries),
            inflight=stack(c.inflight for c in carries),
            relay=Planes(*(stack(c.relay[k] for c in carries)
                           for k in range(4))),
            sync_buf=stack(c.sync_buf for c in carries),
        )
        full = unpack_into_state(carry, full, cfg)
        full = full._replace(
            injected=unpack_bits(stack(injs), cfg.n_payloads).to(torch.uint8))
    return full, RunMetrics(*(stack(x) for x in zip(*metrics)))


def _run_batch(batch: _Batch, max_rounds: int, done, step):
    """The lanes' loop: once a round the ``[K]`` done flags come to the
    host (the one read of a round); a lane that is done, or every lane
    at ``max_rounds``, leaves the batch with its state after that round;
    ``step(batch)`` runs one round of the live lanes and returns (batch,
    done).  Returns the finished lanes in ensemble order."""
    finished = [None] * len(batch.lanes)
    while True:
        flags = done.tolist()  # the one host read of a round
        if int(batch.slim.t) >= max_rounds:
            flags = [True] * len(flags)
        ended = [i for i, f in enumerate(flags) if f]
        for i in ended:
            finished[batch.lanes[i]] = _lane_slice(batch, i)
        if len(ended) == len(flags):
            return finished
        if ended:
            batch = _keep(batch, [i for i, f in enumerate(flags) if not f])
        batch, done = step(batch)


def _shrink_lanes(states: SimState) -> SimState:
    """`packed.shrink_state` of stacked states: zero-width payload axes
    (the loop carries the packed words)."""
    lanes, n = states.have.shape[:2]
    d = states.inflight.shape[1]
    dev = states.have.device
    u8 = torch.uint8
    return states._replace(
        have=torch.zeros((lanes, n, 0), dtype=u8, device=dev),
        injected=torch.zeros((lanes, 0), dtype=u8, device=dev),
        relay_left=torch.zeros((lanes, n, 0), dtype=u8, device=dev),
        inflight=torch.zeros((lanes, d, n, 0), dtype=torch.int32,
                             device=dev),
        sync_inflight=torch.zeros((lanes, d, n, 0), dtype=u8, device=dev),
    )


def _new_lane_metrics(cfg: SimConfig, lanes: int, device) -> RunMetrics:
    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return RunMetrics(
        coverage_at=full((lanes, cfg.n_payloads), -1),
        converged_at=full((lanes, cfg.n_nodes), -1),
        overflow_frac=full((lanes,), 0.0, torch.float32),
        order_violations=full((lanes,), 0),
    )


def run_lanes(states: SimState, meta: PayloadMeta, cfg: SimConfig,
              topo: Topology, max_rounds: int,
              fplan: Optional[FactoredFaultPlan] = None,
              seeds: Optional[torch.Tensor] = None):
    """Run every lane of stacked initial states (every field [K, ...],
    ``t`` 0 in all) to its own exit or ``max_rounds``: faultless, the
    solo `packed.run_packed`'s loop per lane; under ``fplan`` (a factored
    plan, its seed replaced per lane by ``seeds`` i32[K]) the solo
    `packed.run_packed_faults`' — the round's node faults first (K11),
    no exit before the horizon, then the fresh all-have predicate.
    Returns the lanes' final (SimState, RunMetrics), stacked in lane
    order with ``t`` i32[K] on the host; lane k equals the solo run of
    its initial state and seed."""
    check_packed_lanes(cfg, topo, fplan)
    dev = states.have.device
    k_lanes = states.have.shape[0]
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    # `pack_state` and `pack_bits` act on the last axis: lanes ride along
    carry, inj = pack_state(states, cfg), pack_bits(states.injected)
    slim = _shrink_lanes(states)._replace(t=torch.zeros((),
                                                        dtype=torch.int32))
    if fplan is not None:
        # the node faults write these in place: the loop owns its own
        slim = slim._replace(**{
            name: getattr(slim, name).clone()
            for name in ("alive", "heads", "gap_lo", "gap_hi", "pid",
                         "pkey", "psince", "pview")})
        if seeds is None:
            seeds = torch.full((k_lanes,), int(fplan.seed),
                               dtype=torch.int32, device=dev)
        horizon = fplan.horizon
        activity = host_activity(fplan)
    batch = _Batch(slim, carry, inj, _new_lane_metrics(cfg, k_lanes, dev),
                   seeds, list(range(k_lanes)))

    def step(batch: _Batch):
        t = int(batch.slim.t)
        rf = None
        if fplan is not None:
            rf = round_faults(fplan, t)
            apply_round_faults_lanes(batch.slim, batch.carry, rf)
        slim, metrics, done = packed_round_step_lanes(
            batch.slim, batch.carry, batch.inj, batch.metrics, meta, cfg,
            topo, region, rf, None if fplan is None else horizon,
            batch.seeds,
            True if fplan is None else activity[min(t, horizon)].loss)
        return batch._replace(slim=slim, metrics=metrics), done

    finished = _run_batch(batch, max_rounds,
                          _initial_done(batch, meta, cfg, fplan), step)
    return _stack_results(finished, cfg)


def _initial_done(batch: _Batch, meta: PayloadMeta, cfg: SimConfig,
                  fplan) -> torch.Tensor:
    """The lanes' exit flags before the first round (the solo loops'
    `_converged_done`, or the fault loop's false before its horizon)."""
    slim, metrics = batch.slim, batch.metrics
    t = int(slim.t)
    up = slim.alive == ALIVE
    if fplan is not None:
        if t < fplan.horizon:
            return torch.zeros(up.shape[0], dtype=torch.bool,
                               device=up.device)
        c = cfg.chunks_per_version
        comp_w = all_chunks_words(batch.carry.have, cfg)
        act_w = smear_groups(fold_any(batch.inj, c)
                             & group_low_bits_mask(c), c)
        node_done = ((comp_w | ~act_w[:, None, :]) == ONES).all(dim=2) | ~up
        return (meta.round <= t).all() & node_done.all(dim=1)
    all_injected = (meta.round <= t).all()
    return all_injected & ((metrics.converged_at >= 0) | ~up).all(dim=1)
