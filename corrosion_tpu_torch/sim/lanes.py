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
(`.pswim`), the word phases K8's, the ring scatter K2's, K10's or K10j's,
the pull K3's (its delay entry under session delays), the gap refresh
K6's (`.gaps`), the record K7's (one done flag a lane), the node faults
K11's and the probe reach K9's lane entry (`.faults`); K9's edge queries
(its latency entry too) take the lanes folded into their edge axis.
Each wrapper runs its plain torch version on a CPU tensor.

**Freezing finished lanes.**  All lanes start at t = 0 and share
``max_rounds``, so every live lane is at the same t and the host keeps
one t.  JAX freezes a finished lane by select inside the batched
while_loop; here the loop reads the ``[K]`` done flags once a round (as
the solo loop reads one), writes a finished lane's slices out — its
carry after that round, which is what JAX's frozen carry holds — and
keeps the live lanes by ``index_select``.  That happens at most K − 1
times a run and is exact: no other lane's tensors change, and every
draw of a live lane depends on its own key alone.

**Latency plans** (B16l): under a plan with delay factors each edge's
fixed delay adds to its slot and each session's delay sends its grants
to a later slot of the sync ring (K9's latency entry on the lanes
folded; K3's delay lane entry), and in a round with jitter each surviving
payload of a jittered edge lands in its own slot (K10j's lane entry, each
lane under its phase key and plan seed).  The host's copy of the plan's
loss and jitter activity picks each round's scatter, as the solo round's
does, so a round with neither runs K2's lane entry.

**The flight recorder** (B16r, packed half): with ``telemetry`` the loop
carries a lane trace (`.telemetry.new_trace_lanes`) in the batch's
``extra``, so a finished lane leaves with its trace, as JAX's
select-frozen lane does.  Each round records every lane's row as the solo
packed round records its own: the cut edges and refused sessions (K9's
lane-strided counts), the frames and bytes each lane sends over its ok
edges (K18's words lane entry), the frames its loss ate (the recording
forms of K10's and K10j's lane entries), its grant counts (the recording
forms of K3's lane entries, then K17's grant lane entry), coverage and
delivered (K17's coverage lane entry), and K19's lane entry writes the
rows.

The lane path covers what the 100k storm cells run: the flat lossless
topology, partial-view SWIM, the baseline protocol, unmetered budgets and
factored fault plans with delay and jitter, with or without the
recorder.  `check_packed_lanes` refuses everything else, naming the
ROADMAP item that ports it; the dense round's lanes (`.dense_lanes`:
fault plans of either form, the topology families, PeerSwap, the
protocol variants) have `check_dense_lanes`, and share this module's
batch and loop (`_Batch`, `_run_batch`, `trace_of`, `stack_traces`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..device import ONES, i32
from ..kernels.build import check
from . import rng
from .faults import (
    JITTER_TAG,
    WIRE_LOSS_TAG,
    FactoredFaultPlan,
    FactoredRoundFaults,
    _zero_rows_,
    fault_session_effects,
    fault_wire_effects,
    host_activity,
    round_faults,
)
from .gaps import gaps_to_mask, refresh_gaps_lanes
from .packed import (
    CONVERGE_ROWS_PER_BLOCK,
    JITTER_MAX,
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
from .telemetry import (
    COVERAGE,
    GRANTS,
    WIRE,
    RoundTrace,
    acc_slot,
    count_words_lanes_,
    coverage_delivered_lanes_,
    new_trace_lanes,
    record_row_lanes,
    trace_row,
    wire_loss_active,
    wire_words_lanes_,
)
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


def check_packed_lanes(cfg: SimConfig, topo: Topology, fplan=None) -> None:
    """Refuse, loudly and naming the ROADMAP item that ports it, every
    configuration the packed round's lanes do not run: topology keys,
    the protocol variants and metered budgets (B16m), PeerSwap (B16s's
    packed half) and matrix plans (B16x); full view and ground-truth
    membership run on the dense round's lanes instead.  Factored plans
    with delay and jitter (B16l) and the flight recorder (B16r) run."""
    if not packed_supported(cfg, topo):
        raise ValueError("a dense configuration on the packed round's "
                         "lanes: run it through `.dense_lanes`")
    if topo != Topology():
        raise NotImplementedError(
            "topology families and keys on the packed round's lanes are "
            "not ported yet (K10t on lanes, ROADMAP B16m); the dense "
            "round's lanes run them (allow_packed=False)")
    if cfg.peer_sampler != "uniform":
        raise NotImplementedError(
            "the PeerSwap sampler on the packed round's lanes is not ported "
            "yet (ROADMAP B16s, its packed half); the dense round's lanes "
            "run it (allow_packed=False)")
    if (cfg.dissemination, cfg.fanout_schedule, cfg.sync_cadence,
            cfg.ordering) != ("push", "flat", "periodic", "none"):
        raise NotImplementedError(
            "protocol variants on the packed round's lanes are not ported "
            "yet (K10p, K8f and K22's words entry on lanes, ROADMAP B16m); "
            "the dense round's lanes run them (allow_packed=False)")
    if cfg.rate_limit_bytes_round is not None or (
            cfg.sync_budget_bytes is not None):
        raise NotImplementedError(
            "metered budgets on the packed round's lanes are not ported "
            "yet (K16 and K3's metered entry, ROADMAP B16m): "
            "set rate_limit_bytes_round and sync_budget_bytes to None")
    if not (cfg.swim_partial_view and cfg.couple_membership):
        raise NotImplementedError(
            "the packed round's lanes run partial-view SWIM only; full "
            "view and ground-truth membership run on the dense round's "
            "lanes (force the dense round with allow_packed=False)")
    if fplan is not None and not isinstance(fplan, FactoredFaultPlan):
        raise NotImplementedError(
            "matrix fault plans on the packed round's lanes are not "
            "ported yet (ROADMAP B16x); compile the plan factored")


def check_dense_lanes(cfg: SimConfig, topo: Topology, fplan=None,
                      telemetry: bool = False) -> None:
    """The dense round's lanes run every configuration of the dense
    round: both byte budgets (inside K12's and K13's lane entries), full
    view, partial view, ground-truth membership, every topology family
    and key, either peer sampler, every protocol family and knob, fault
    plans of either form, with delay and jitter, PeerSwap under them
    (``fplan`` is accepted), and the flight recorder (``telemetry``).  A
    packed configuration belongs to `run_lanes` and raises."""
    if packed_supported(cfg, topo):
        raise ValueError("a packed configuration on the dense round's "
                         "lanes: run it through `run_lanes`")


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


def scatter_lanes_plain(ring, sending, dst, slot, ok, fanout: int,
                        thr=None, keys=None, seeds=None, jit=None,
                        dropped=None) -> None:
    """Plain version of K2's lane entry (with ``thr`` K10's, with ``jit``
    K10j's, with ``dropped`` their recording forms), in place: the solo
    plain version on each lane under its key and plan seed."""
    from .packed import scatter_sending_lossy_plain, scatter_sending_plain

    for k in range(ring.shape[0]):
        if thr is None and jit is None:
            scatter_sending_plain(ring[k], sending[k], dst[k], slot[k], ok[k],
                                  fanout)
            continue
        scatter_sending_lossy_plain(
            ring[k], sending[k], dst[k], slot[k], ok[k],
            None if thr is None else thr[k], keys[k], int(seeds[k]), fanout,
            dropped=None if dropped is None else dropped[k],
            jit=None if jit is None else jit[k])


def scatter_lanes(ring, sending, dst, slot, ok, fanout: int, thr=None,
                  keys=None, seeds=None, jit=None, dropped=None) -> None:
    """`packed.scatter_sending` (and with ``thr`` or ``jit`` the fault
    streams of `packed.scatter_sending_lossy`) over the lanes, in place on
    the rings [K, D, N, W]: lane k's ok edges OR its sending words into its
    ring, less what its wire-loss draw ``fold_in(fold_in(keys[k],
    seeds[k]), 101)`` drops under thr[k, e]; with ``jit`` (i32[K, E], K9's
    jitter bounds) each surviving payload q of an edge with jit[k, e] > 0
    lands element e*P + q of ``randint(fold_in(fold_in(keys[k], seeds[k]),
    102), [E, P], 0, 2^31 - 1)`` mod (jit[k, e] + 1) rounds past slot[k,
    e].  With ``dropped`` (a lane trace's ``[K]`` accumulator view) each
    lane's lost frames are added to its slot.  K2's lane entry, K10's, or
    K10j's with ``jit``; their recording forms, counted apart, with
    ``dropped``."""
    if ring.device.type == "cpu":
        scatter_lanes_plain(ring, sending, dst, slot, ok, fanout, thr, keys,
                            seeds, jit, dropped)
        return
    lanes, d_slots, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (lanes, d_slots, n, w))
    check("sending", sending, torch.int32, (lanes, n, w))
    check("dst", dst, torch.int32, (lanes, e))
    check("slot", slot, torch.int32, (lanes, e))
    check("ok", ok, torch.bool, (lanes, e))
    if thr is None and jit is None:
        if dropped is not None:
            raise ValueError("dropped needs a loss or jitter stream")
        kernels.BROADCAST_SCATTER_LANES.launch(
            [ring, sending, dst, slot, ok], [n, d_slots, w, fanout, lanes])
        return
    if thr is not None:
        check("thr", thr, torch.uint8, (lanes, e))
    if jit is not None:
        check("jit", jit, torch.int32, (lanes, e))
    check("keys", keys, torch.int64, (lanes, 2))
    check("seeds", seeds, torch.int32, (lanes,))
    stride = 0
    if dropped is not None:
        _check_lane_slot("dropped", dropped, lanes)
        stride = dropped.stride(0)
    kernel = {(False, False): kernels.BROADCAST_SCATTER_LOSSY_LANES,
              (True, False): kernels.BROADCAST_SCATTER_JITTER_LANES,
              (False, True): kernels.BROADCAST_SCATTER_LOSSY_LANES_TRACE,
              (True, True): kernels.BROADCAST_SCATTER_JITTER_LANES_TRACE}[
        (jit is not None, dropped is not None)]
    span, mult = rng.scalar_span(0, JITTER_MAX)
    kernel.launch(
        [ring, sending, dst, slot, ok, thr, keys, seeds, dropped, jit],
        [n, d_slots, w, fanout, WIRE_LOSS_TAG, JITTER_TAG, i32(span),
         i32(mult), stride, lanes])


def _check_lane_slot(name: str, t: torch.Tensor, lanes: int) -> None:
    """A lane trace's ``[K]`` view of one int64 accumulator slot."""
    if (not t.is_cuda or t.dtype != torch.int64
            or tuple(t.shape) != (lanes,)):
        raise ValueError(f"{name} must be a CUDA int64 [K] view")


# -- the sync pull (K3) ------------------------------------------------------


def sync_pull_lanes_plain(masks, miss, peers, ok, ring, slot: int,
                          sdelay=None, granted=None) -> torch.Tensor:
    """Plain version of K3's lane entry (with ``sdelay`` its delay lane
    entry, with ``granted`` their recording forms): the solo plain version
    on each lane's rows and its ring's slot (or whole ring), in place."""
    from .packed import sync_pull_plain

    return torch.stack([
        sync_pull_plain(
            masks[k], miss[k], peers[k], ok[k],
            ring[k, slot] if sdelay is None else ring[k],
            granted=None if granted is None else granted[k],
            sdelay=None if sdelay is None else sdelay[k], slot=slot)
        for k in range(masks.shape[0])])


def sync_pull_lanes(masks, miss, peers, ok, ring, slot: int, sdelay=None,
                    granted=None) -> torch.Tensor:
    """`packed.sync_pull` over the lanes, unmetered: each lane's sessions
    pull from its own rows (``peers`` [K, N, S] lane-local) into slot
    ``slot`` of its sync ring [K, D, N, W] in place; returns bool [K, N]
    fruitful.  With ``sdelay`` (i32[K, N * S], the lanes' session delays)
    edge e of lane k lands in slot (slot + sdelay[k, e]) % D, a
    read-OR-write (a class past D - 2 lands nowhere); with ``granted``
    ([K, N * S, W]) each lane's granted words are copied there too (every
    class).  K3's lane entry on the card, its delay lane entry with
    ``sdelay``; their recording forms, counted apart, with ``granted``."""
    if masks.device.type == "cpu":
        return sync_pull_lanes_plain(masks, miss, peers, ok, ring, slot,
                                     sdelay, granted)
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
    if sdelay is not None:
        check("sdelay", sdelay, torch.int32, (lanes, n * s))
    if granted is not None:
        check("granted", granted, torch.int32, (lanes, n * s, w))
    fruitful = torch.zeros((lanes, n), dtype=torch.uint8,
                           device=masks.device)
    kernel = {(False, False): kernels.SYNC_PULL_LANES,
              (True, False): kernels.SYNC_PULL_DELAY_LANES,
              (False, True): kernels.SYNC_PULL_LANES_TRACE,
              (True, True): kernels.SYNC_PULL_DELAY_LANES_TRACE}[
        (sdelay is not None, granted is not None)]
    kernel.launch([masks, miss, peers, ok, ring, fruitful, granted, sdelay],
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
                    meta: PayloadMeta, faults=None, seeds=None,
                    active=None, trace: Optional[RoundTrace] = None) -> None:
    """`packed.broadcast_packed` over the lanes, in place: each lane's
    targets (K1's lane entry), its spend (K8) and its ring scatter (K2;
    under this round's fault loss K10, under its jitter K10j, each lane
    with its own key and seed).  Under ``faults`` cuts clear edges and the
    plan's fixed delay adds to each edge's slot (K9, its latency entry
    under delay or jitter factors, on the lanes folded into its edge
    axis).  ``active`` is the host's copy of the round's loss and jitter
    activity (None: every class the plan has).  With a lane ``trace``
    each lane's cut edges (K9's lane-strided count), the frames and bytes
    it sends on its ok edges (K18's words lane entry) and the frames its
    loss ate (the scatter's recording form) go to its accumulators."""
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
    thr = jit = fdelay = None
    if faults is not None:
        # ok is contiguous [K, E]: its flat view is cleared in place
        _, thr, fdelay, jit = fault_wire_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            cut=None if trace is None else acc_slot(trace, "bcast_cut"))
        thr, fdelay, jit = (None if x is None else x.view(lanes, -1)
                            for x in (thr, fdelay, jit))
        if active is not None:
            thr = thr if active.loss else None
            jit = jit if active.jitter else None
    if trace is not None:
        wire_words_lanes_(trace.acc[:, WIRE], sending, meta.nbytes, ok, f)
    slot = edge_slot_plain(topo, region, src, dst, int(state.t),
                           carry.inflight.shape[1], fdelay)
    scatter_lanes(carry.inflight, sending, dst, slot, ok, f, thr, keys,
                  seeds, jit,
                  None if trace is None or (thr is None and jit is None)
                  or not wire_loss_active(topo, faults)
                  else acc_slot(trace, "bcast_dropped"))


def sync_lanes(carry: PackedCarry, state: SimState, cfg: SimConfig,
               keys, faults=None, trace: Optional[RoundTrace] = None):
    """`packed.sync_packed` over the lanes: each lane's peers (K1), the
    need masks from its heads and gaps, the pull into its sync ring's
    slot t + 1 (K3's lane entry) and its backoff and re-arm draws (K5);
    a cut in either direction refuses a session, and under a plan with
    delay factors each session's grants land its session delay later
    (K9, its latency entry, folded; K3's delay lane entry).  Returns
    (countdown, backoff, ok): [K, N] each and the sessions' ok mask
    bool[K, N * S]; with a lane ``trace`` each lane's refused sessions
    (K9's lane-strided count) and grant counts (K3's recording form, then
    K17's grant lane entry) go to its accumulators."""
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
    sdelay = None
    if faults is not None:
        # the refused count is taken before the mask clears them
        _, sdelay = fault_session_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            None if trace is None else acc_slot(trace, "sync_refused"))
        if sdelay is not None:
            sdelay = sdelay.view(lanes, n * s)

    v = cfg.n_versions
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=peers.device)
    miss_w = grid_to_words(gaps_to_mask(state.gap_lo, state.gap_hi, v), cfg)
    below_w = grid_to_words(v_idx <= state.heads[..., None], cfg)
    comp_w = all_chunks_words(carry.have, cfg)
    haves_w = below_w & ~miss_w & comp_w
    partial_w = below_w & ~miss_w & ~comp_w
    masks = torch.stack([haves_w, partial_w, below_w, carry.have], dim=2)
    slot = (int(state.t) + 1) % carry.sync_buf.shape[1]
    granted = (None if trace is None else torch.empty(
        (lanes, n * s, carry.have.shape[2]), dtype=torch.int32,
        device=peers.device))
    fruitful = sync_pull_lanes(masks, miss_w, dst.reshape(lanes, n, s),
                               ok.reshape(lanes, n, s), carry.sync_buf, slot,
                               sdelay, granted)
    if trace is not None:
        count_words_lanes_(trace.counts[:, GRANTS], granted)
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
    return countdown, backoff, ok


def packed_round_step_lanes(state: SimState, carry: PackedCarry, inj,
                            metrics: RunMetrics, meta: PayloadMeta,
                            cfg: SimConfig, topo: Topology, region,
                            faults=None, horizon: Optional[int] = None,
                            seeds=None, active=None,
                            trace: Optional[RoundTrace] = None):
    """One gossip tick of every lane, phase for phase the solo
    `packed.packed_round_step` with lane k's keys: inject → broadcast →
    sync → deliver → SWIM → gap refresh → convergence record, the
    round's shared fault slice in the broadcast, sync and SWIM, and
    ``active`` (the host's copy of its loss and jitter activity) picking
    the scatter.  Updates ``carry`` and ``inj`` in place; returns (state,
    metrics, done) with done bool[K] on the device.  With a lane
    ``trace`` (`.telemetry.new_trace_lanes`) every lane's row is recorded
    in it, in place, as the solo round records its own: the phases feed
    each lane's accumulators, then K17's coverage lane entry counts
    coverage and delivered and K19's lane entry writes the rows (with the
    shared fault slice's crashes and wipes)."""
    ks = rng.split_lanes(state.key, 4)
    state = state._replace(key=ks[:, 0].contiguous())
    k_bcast, k_sync, k_swim = (ks[:, i].contiguous() for i in (1, 2, 3))
    t = int(state.t)
    have0 = None if trace is None else carry.have.clone()
    inject_lanes(carry, inj, t, meta, cfg, state.alive)
    broadcast_lanes(carry, inj, state, cfg, topo, region, k_bcast, meta,
                    faults, seeds, active, trace)
    countdown, backoff, sync_ok = sync_lanes(carry, state, cfg, k_sync,
                                             faults, trace)
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
    if trace is not None:
        coverage_delivered_lanes_(trace.counts[:, COVERAGE:GRANTS],
                                  carry.have, have0, state.alive)
        record_row_lanes(trace, trace_row(trace, t, cfg.trace_every),
                         alive=state.alive, state=state, cfg=cfg, rf=faults,
                         sync_ok=sync_ok, n_overflow=n_overflow,
                         nbytes=meta.nbytes)
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


def trace_of(extra, start: int = 0) -> RoundTrace:
    """The lane trace carried in a batch's ``extra`` from ``start``."""
    return RoundTrace(*extra[start:start + len(RoundTrace._fields)])


def stack_traces(finished, start: int = 0) -> RoundTrace:
    """The finished lanes' traces (each its frozen rows of ``extra``
    from ``start``), stacked in lane order: a lane trace [K, ...]."""
    extras = [extra for *_, extra in finished]
    return RoundTrace(*(
        torch.stack([x[start + j] for x in extras])
        for j in range(len(RoundTrace._fields))))


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


def packed_lane_batch(states: SimState, cfg: SimConfig, seeds=None,
                      trace: Optional[RoundTrace] = None) -> _Batch:
    """The packed lane loop's batch of every lane of stacked initial
    states: the packed carry and injected words, the slim state (``t`` a
    host scalar 0), fresh metrics; with plan ``seeds`` (i32[K], a fault
    loop's) the tables the node faults write are the loop's own; a lane
    ``trace`` rides in ``extra`` (`trace_of`)."""
    dev = states.have.device
    k_lanes = states.have.shape[0]
    # `pack_state` and `pack_bits` act on the last axis: lanes ride along
    carry, inj = pack_state(states, cfg), pack_bits(states.injected)
    slim = _shrink_lanes(states)._replace(t=torch.zeros((),
                                                        dtype=torch.int32))
    if seeds is not None:
        # the node faults write these in place: the loop owns its own
        slim = slim._replace(**{
            name: getattr(slim, name).clone()
            for name in ("alive", "heads", "gap_lo", "gap_hi", "pid",
                         "pkey", "psince", "pview")})
    return _Batch(slim, carry, inj, _new_lane_metrics(cfg, k_lanes, dev),
                  seeds, list(range(k_lanes)),
                  () if trace is None else tuple(trace))


def packed_lane_step(batch: _Batch, meta: PayloadMeta, cfg: SimConfig,
                     topo: Topology, region,
                     fplan: Optional[FactoredFaultPlan] = None,
                     activity=None, telemetry: bool = False):
    """One round of the packed lane loop's live lanes: under ``fplan``
    the round's node faults first (K11's lane entry) and the scatter
    picked from ``activity`` (`.faults.host_activity` of the plan), then
    the lane round, recording into the batch's trace with ``telemetry``.
    Returns (batch, done) with done bool[K] on the device."""
    t = int(batch.slim.t)
    rf = active = horizon = None
    if fplan is not None:
        rf = round_faults(fplan, t)
        apply_round_faults_lanes(batch.slim, batch.carry, rf)
        horizon = fplan.horizon
        active = activity[min(t, horizon)]
    slim, metrics, done = packed_round_step_lanes(
        batch.slim, batch.carry, batch.inj, batch.metrics, meta, cfg, topo,
        region, rf, horizon, batch.seeds, active,
        trace_of(batch.extra) if telemetry else None)
    return batch._replace(slim=slim, metrics=metrics), done


def run_lanes(states: SimState, meta: PayloadMeta, cfg: SimConfig,
              topo: Topology, max_rounds: int,
              fplan: Optional[FactoredFaultPlan] = None,
              seeds: Optional[torch.Tensor] = None, telemetry: bool = False):
    """Run every lane of stacked initial states (every field [K, ...],
    ``t`` 0 in all) to its own exit or ``max_rounds``: faultless, the
    solo `packed.run_packed`'s loop per lane; under ``fplan`` (a factored
    plan, delay and jitter factors included, its seed replaced per lane by
    ``seeds`` i32[K]) the solo `packed.run_packed_faults`' — the round's
    node faults first (K11), each round's scatter picked from the plan's
    host activity, no exit before the horizon, then the fresh all-have
    predicate.  Returns the lanes' final (SimState, RunMetrics), stacked
    in lane order with ``t`` i32[K] on the host; lane k equals the solo
    run of its initial state and seed.  With ``telemetry`` the flight
    recorder runs on every lane (a lane trace of ``max_rounds`` rows,
    `.telemetry.new_trace_lanes`, carried in the batch's ``extra``) and
    the lanes' traces come back third, stacked in lane order: lane k's
    is its solo run's trace (rows past its exit stay zero)."""
    check_packed_lanes(cfg, topo, fplan)
    dev = states.have.device
    k_lanes = states.have.shape[0]
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    activity = None
    if fplan is not None:
        if seeds is None:
            seeds = torch.full((k_lanes,), int(fplan.seed),
                               dtype=torch.int32, device=dev)
        activity = host_activity(fplan)
    trace = (new_trace_lanes(cfg, max_rounds, k_lanes, dev) if telemetry
             else None)
    batch = packed_lane_batch(states, cfg, None if fplan is None else seeds,
                              trace)

    finished = _run_batch(
        batch, max_rounds, _initial_done(batch, meta, cfg, fplan),
        lambda b: packed_lane_step(b, meta, cfg, topo, region, fplan,
                                   activity, telemetry))
    finals, metrics = _stack_results(finished, cfg)
    if telemetry:
        return finals, metrics, stack_traces(finished)
    return finals, metrics


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
