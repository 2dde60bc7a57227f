"""Seed ensembles on the dense round: K lanes of one configuration as one
lane-batched program — the port of ``jax.vmap`` over
``corrosion_tpu/sim/round.py:272 run_to_convergence``'s dense loop (and,
through `..sim.telemetry.run_membership_detect_lanes`, over
``telemetry.py:318 run_membership_detect``) as
``corrosion_tpu/campaign/ensemble.py:114 run_ensemble`` and ``:187
run_detect_ensemble`` apply it (B16, dense half).

Every per-node tensor of JAX's u8 state gets a leading lane axis:
``have``, ``relay_left`` ``[K, N, P]``, ``injected [K, P]``, the rings
``[K, D, N, P]``, the full view's beliefs ``[K, N, N]``, the member
tables ``[K, N, M]``, the keys ``[K, 2]``; the payload metadata is
shared.  Node ids and draw counters stay lane-local.  One dense round of
every live lane is phase for phase the solo `.round.round_step_`: inject,
broadcast and deliver are K12's lane entries, the sync pull K13's, the
bookkeeping refresh and convergence record K14's (a done flag a lane),
the uniform sampler K1's uniform lane entry, full-view SWIM K15's three
lane entries and partial-view SWIM `.pswim.pswim_step_lanes` (K1's and
K4's lane entries), the draws and the tick picked by `.swim_lanes`, which
the packed round's lanes share; every draw is K5's lane entry.  The byte budgets run
inside K12 and K13, per lane and per row, so the default budgets need no
`optimize_budgets`.

**Fault plans** (B16d, faults): the dense branch of JAX's
``faults.py:797-842 run_fault_plan`` under the same vmap.  The plan's
schedule, of either form, is shared by every lane and only its seed is
batched (``seeds`` i32[K]): each round's slice is taken once, its node
faults hit every lane (K11d's lane entry, `.faults.
apply_node_faults_lanes`), the per-edge queries take the lanes folded
into their edge axis (K9 or K9m, K9's latency entry: they draw nothing),
the per-(edge, payload) loss and jitter are K12's fault lane entry under
each lane's phase key and seed, the session delays K13's delay lane
entry, the probe loss K9's or K9m's reach lane entry, and the exit
K14's lane entries in their exit mode (a fresh done flag a lane, never
before the horizon).

**The flight recorder** (B16r, dense half): with ``telemetry`` the
loop carries a lane trace (`.telemetry.new_trace_lanes`: JAX's sixteen
channels ``[K, R, ...]``, each lane's int64 accumulators and count
rows) in the batch's ``extra``, so a finished lane leaves with its
trace, as JAX's select-frozen lane does.  Each round records every
lane's row as the solo round records its own: the broadcast's cut
edges and refused sessions go to each lane's slots (K9/K9m with a
lane-strided count), its lost frames and per-row frames and bytes come
from the recording forms of K12's and K12f's lane entries and are
folded by K18's rows lane entry, its grant counts from K13's and K13d's
recording forms, coverage and delivered from K17's dense lane entry,
and K19's lane entry writes the rows (a ticket a lane) with the shared
fault slice's crashes and wipes.

**Topology families and PeerSwap** (B16t, B16s): the broadcast takes
ring0 tiering under each lane's ``k_ring0`` (`.broadcast.
ring0_targets_lanes`), the degree caps (K20's caps lane entry), AZ and
matrix delay slots (K20's edge lane entry), the flat loss threshold or
the tiered loss (K12t's lane entry); every reach draws the topology's
loss (K20's reach lane entry, or the flat bernoulli); under PeerSwap
each lane's key splits five ways, the swap tick runs first (K21's lane
entries) and every target draw samples the view (K1's view lane
entry).

**The protocol variants** (B16v): the fan-out schedule after the caps
(K20's schedule lane entry, `..proto.schedule.capped_schedule_lanes`),
the push-pull response leg before the push's spend (K12p's lane entry,
`.broadcast.pull_send_lanes`, each lane under its own pull key; its
session check and reverse loss are K9's or K9m's queries on the lanes
folded) with its frames and bytes on a recording run (K18's rows-pull
lane entry), the eager cadence on the sync's due mask (glue over K13's
and K5's lane entries), the FIFO gate at delivery (K12f-o's lane entry,
each lane's mask from its own pre-merge ``have``) and the delivery-order
count after the record (K22's u8 lane entry, a count a lane in
``RunMetrics.order_violations``).  PeerSwap runs under a plan of either
form too (B16s-f): K11d's lane entry empties a wiped node's view row in
every lane, and the swap message's reach takes each lane's plan seed.

Each wrapper runs its plain torch version on a CPU tensor: the solo
plain version on each lane's slices, so lane k of a plain lane call IS
the solo call on lane k's inputs.  A finished lane leaves the batch as
on the packed round's lanes (`.lanes._run_batch`), its plan seed and
its order count with it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..device import i32
from ..kernels.build import check
from . import rng
from .faults import (
    JITTER_TAG,
    NODE_FAULT_TABLES,
    WIRE_LOSS_TAG,
    _lane_states,
    all_have,
    apply_node_faults_lanes,
    fault_session_effects,
    fault_wire_effects,
    host_activity,
    round_faults,
)
from ..proto.ordering import order_checked, order_enforced
from ..topo.sampler import peerswap_step_lanes
from .invariants import count_order_violations_lanes_
from .lanes import (
    _Batch,
    _edges,
    _new_lane_metrics,
    _run_batch,
    _stack_results,
    broadcast_targets_lanes,
    check_dense_lanes,
    stack_traces,
    trace_of,
)
from .round import (
    _OWNED,
    DENSE_ROWS_PER_BLOCK,
    RunMetrics,
    dense_record_plain,
    overflow_fraction,
)
from .state import ALIVE, PayloadMeta, SimConfig, SimState
from .swim_lanes import (
    _check_lanes_count,
    sample_member_targets_lanes,
    swim_step_lanes,
)
from .telemetry import (
    COVERAGE,
    GRANTS,
    WIRE,
    RoundTrace,
    _check_lane_rows,
    acc_slot,
    coverage_delivered_dense_lanes_,
    new_trace_lanes,
    record_row_lanes,
    trace_row,
    wire_loss_active,
    wire_rows_lanes_,
    wire_rows_pull_lanes_,
)
from .topology import (
    Topology,
    edge_slot_lanes,
    loss_threshold,
    regions,
    topo_table,
    wire_tiers,
)

_I32_MAX = (1 << 31) - 1  # the jitter draw's span, as `broadcast`'s


# -- K12: inject, broadcast, deliver ------------------------------------------


def _check_rows_lanes(have, relay, lanes: int, n: int, p: int) -> None:
    check("have", have, torch.uint8, (lanes, n, p))
    check("relay_left", relay, torch.uint8, (lanes, n, p))


def inject_dense_lanes_plain(have, relay, injected, meta: PayloadMeta,
                             alive, t: int, max_tx: int) -> None:
    """Plain version of K12's inject lane entry: the solo plain version
    on each lane, in place."""
    from .broadcast import inject_dense_plain

    for k in range(have.shape[0]):
        inject_dense_plain(have[k], relay[k], injected[k], meta, alive[k], t,
                           max_tx)


def inject_dense_lanes(have, relay, injected, meta: PayloadMeta, alive,
                       t: int, max_tx: int) -> None:
    """`broadcast.inject_dense` over the lanes, in place (``injected``
    [K, P], ``alive`` [K, N]); K12's inject lane entry on the card."""
    if have.device.type == "cpu":
        inject_dense_lanes_plain(have, relay, injected, meta, alive, t,
                                 max_tx)
        return
    lanes, n, p = have.shape
    _check_lanes_count(lanes)
    _check_rows_lanes(have, relay, lanes, n, p)
    check("injected", injected, torch.uint8, (lanes, p))
    check("meta.round", meta.round, torch.int32, (p,))
    check("meta.actor", meta.actor, torch.int32, (p,))
    check("alive", alive, torch.uint8, (lanes, n))
    kernels.DENSE_INJECT_LANES.launch(
        [meta.round, meta.actor, alive, have, relay, injected],
        [n, p, t, max_tx, lanes])


def broadcast_send_lanes_plain(have, relay, injected, nbytes, budget,
                               targets, dst, slot, ok, alive, keys,
                               thr: int, ring, phase_keys=None, fthr=None,
                               jit=None, seeds=None, row_frames=None,
                               row_bytes=None, dropped=None,
                               tiers: Optional[Topology] = None) -> None:
    """Plain version of K12's broadcast lane entry, of its fault and
    tiered lane entries (and of their recording forms): the solo plain
    version on each lane under its keys and plan seed, in place."""
    from .broadcast import broadcast_send_plain

    def lane(x, k):
        return None if x is None else x[k]

    for k in range(have.shape[0]):
        broadcast_send_plain(
            have[k], relay[k], injected[k], nbytes, budget, targets[k],
            dst[k], slot[k], ok[k], alive[k], keys[k], thr, ring[k],
            row_frames=lane(row_frames, k), row_bytes=lane(row_bytes, k),
            dropped=lane(dropped, k), phase_key=lane(phase_keys, k),
            fthr=lane(fthr, k), jit=lane(jit, k),
            seed=0 if seeds is None else int(seeds[k]), tiers=tiers)


def broadcast_send_lanes(have, relay, injected, nbytes,
                         budget: Optional[int], targets, dst, slot, ok,
                         alive, keys, thr: int, ring, phase_keys=None,
                         fthr=None, jit=None, seeds=None, row_frames=None,
                         row_bytes=None, dropped=None,
                         tiers: Optional[Topology] = None) -> None:
    """`broadcast.broadcast_send` over the lanes, in place on ``relay``
    and the rings [K, D, N, P]: each lane's eligible payloads, its
    oldest-first budget prefix per row (lane-local), its edges' ring
    writes less the flat loss under its key ``keys[k]`` (byte e*P + q of
    its own draw, e lane-local) and its relay spend.  Under a fault plan
    (``fthr`` u8[K, E] and/or ``jit`` i32[K, E], K9's per-edge outputs
    on the lanes folded) lane k also draws the plan's loss and jitter
    from ``fold_in(fold_in(phase_keys[k], seeds[k]), 101 | 102)``, its
    broadcast phase key and plan seed.  The flight recorder's outputs,
    when given: each lane's per-node sent frames and bytes i32[K, N]
    (``row_frames``, ``row_bytes``) and the frames each lane's loss ate
    on its ok edges, added to its int64 slot of ``dropped`` (a lane
    trace's ``[K]`` accumulator view).  Under tiered topology loss
    (``tiers``, the topology, `topology.wire_tiers`; ``thr`` then 0) lane
    k compares byte e*P + q of its own ``keys[k]`` draw against the tier
    threshold of its edge e, and a tier at certainty loses every payload
    of its edges (JAX ``tiered_edge_drop`` under the vmap).  K12's
    broadcast lane entry on the card, its fault lane entry under a plan's
    loss or jitter, its tiered lane entry under tiers (with or without
    the plan's draws); their recording forms, counted apart, with the
    recorder's outputs."""
    if have.device.type == "cpu":
        broadcast_send_lanes_plain(have, relay, injected, nbytes, budget,
                                   targets, dst, slot, ok, alive, keys, thr,
                                   ring, phase_keys, fthr, jit, seeds,
                                   row_frames, row_bytes, dropped, tiers)
        return
    lanes, n, p = have.shape
    f = targets.shape[2]
    e = n * f
    d = ring.shape[1]
    _check_lanes_count(lanes)
    _check_rows_lanes(have, relay, lanes, n, p)
    check("injected", injected, torch.uint8, (lanes, p))
    check("nbytes", nbytes, torch.int32, (p,))
    check("targets", targets, torch.int32, (lanes, n, f))
    for name, x, dtype in (("dst", dst, torch.int32),
                           ("slot", slot, torch.int32),
                           ("ok", ok, torch.bool)):
        check(name, x, dtype, (lanes, e))
    check("alive", alive, torch.uint8, (lanes, n))
    check("keys", keys, torch.int64, (lanes, 2))
    check("ring", ring, torch.uint8, (lanes, d, n, p))
    recording = row_frames is not None
    stride = 0
    if recording:
        check("row_frames", row_frames, torch.int32, (lanes, n))
        check("row_bytes", row_bytes, torch.int32, (lanes, n))
    if dropped is not None:
        if not recording:
            raise ValueError("dropped needs the row outputs")
        if (not dropped.is_cuda or dropped.dtype != torch.int64
                or tuple(dropped.shape) != (lanes,)):
            raise ValueError("dropped must be a CUDA int64 [K] view")
        stride = dropped.stride(0)
    ptrs = [have, relay, injected, nbytes, targets, dst, slot, ok, alive,
            keys, ring, row_frames, row_bytes, dropped]
    ints = [n, p, f, d, -1 if budget is None else budget, min(thr, 256)]
    fault = fthr is not None or jit is not None
    if not fault and tiers is None:
        kernel = (kernels.DENSE_BROADCAST_LANES_TRACE if recording
                  else kernels.DENSE_BROADCAST_LANES)
        kernel.launch(ptrs, ints + [stride, lanes])
        return
    if fault:
        check("phase_keys", phase_keys, torch.int64, (lanes, 2))
        check("seeds", seeds, torch.int32, (lanes,))
    if fthr is not None:
        check("fthr", fthr, torch.uint8, (lanes, e))
    if jit is not None:
        check("jit", jit, torch.int32, (lanes, e))
    span, mult = rng.scalar_span(0, _I32_MAX)
    ints += [WIRE_LOSS_TAG, JITTER_TAG, i32(span), i32(mult), stride, lanes]
    ptrs += [phase_keys if fault else None, fthr, jit,
             seeds if fault else None]
    if tiers is not None:
        if thr != 0:
            raise ValueError("tiered loss replaces the flat threshold")
        kernel = (kernels.DENSE_BROADCAST_TIERED_LANES_TRACE if recording
                  else kernels.DENSE_BROADCAST_TIERED_LANES)
        kernel.launch(ptrs + [topo_table(tiers, n, have.device)], ints)
        return
    kernel = (kernels.DENSE_BROADCAST_FAULT_LANES_TRACE if recording
              else kernels.DENSE_BROADCAST_FAULT_LANES)
    kernel.launch(ptrs, ints)


def deliver_dense_lanes_plain(ring, sync_ring, have, relay, slot: int,
                              relay_init: int, fifo=None) -> None:
    """Plain version of K12's deliver lane entry and, with ``fifo``, of
    K12f-o's: the solo plain version on each lane (its admit mask from its
    own pre-merge ``have``), in place."""
    from ..proto.ordering import admit_payload_mask
    from .broadcast import deliver_dense_plain

    for k in range(have.shape[0]):
        admit = None if fifo is None else admit_payload_mask(have[k], fifo)
        deliver_dense_plain(ring[k], sync_ring[k], have[k], relay[k], slot,
                            relay_init, admit)


def deliver_dense_lanes(ring, sync_ring, have, relay, slot: int,
                        relay_init: int, fifo=None) -> None:
    """`broadcast.deliver_dense` over the lanes: slot ``slot`` of every
    lane's two rings [K, D, N, P] into its ``have``, in place.  With
    ``fifo`` (the config, under ``ordering="fifo"``) both of a lane's
    slots arrive only where `..proto.ordering.admit_payload_mask` of that
    lane's pre-merge ``have`` admits them; the rest is dropped and the
    slots are cleared.  K12's deliver lane entry on the card, K12f-o's
    lane entry under FIFO."""
    if have.device.type == "cpu":
        deliver_dense_lanes_plain(ring, sync_ring, have, relay, slot,
                                  relay_init, fifo)
        return
    lanes, n, p = have.shape
    d = ring.shape[1]
    _check_lanes_count(lanes)
    _check_rows_lanes(have, relay, lanes, n, p)
    check("inflight", ring, torch.uint8, (lanes, d, n, p))
    check("sync_inflight", sync_ring, torch.uint8, (lanes, d, n, p))
    if not 0 <= slot < d:
        raise ValueError(f"slot {slot} outside the ring of {d}")
    if fifo is not None:
        c = fifo.chunks_per_version
        kernels.DENSE_DELIVER_FIFO_LANES.launch(
            [ring, sync_ring, have, relay],
            [n, p, d, slot, relay_init, c, fifo.n_writers * c, lanes])
        return
    kernels.DENSE_DELIVER_LANES.launch(
        [ring, sync_ring, have, relay], [n, p, d, slot, relay_init, lanes])


# -- K13: the sync pull -----------------------------------------------------


def sync_pull_dense_lanes_plain(have, heads, gap_lo, gap_hi, peers, ok,
                                nbytes, budget, ring, cfg: SimConfig,
                                slot: int, sdelay=None,
                                counts=None) -> torch.Tensor:
    """Plain version of K13's lane entry (and with ``sdelay`` of its
    delay lane entry, with ``counts`` of their recording forms): the solo
    plain version on each lane's rows and its ring's slot (or its whole
    ring), in place."""
    from .sync import sync_pull_dense_plain

    return torch.stack([
        sync_pull_dense_plain(
            have[k], heads[k], gap_lo[k], gap_hi[k], peers[k], ok[k], nbytes,
            budget, ring[k, slot] if sdelay is None else ring[k], cfg,
            counts=None if counts is None else counts[k],
            sdelay=None if sdelay is None else sdelay[k], slot=slot)
        for k in range(have.shape[0])])


def sync_pull_dense_lanes(have, heads, gap_lo, gap_hi, peers, ok, nbytes,
                          budget: Optional[int], ring, cfg: SimConfig,
                          slot: int, sdelay=None,
                          counts=None) -> torch.Tensor:
    """`sync.sync_pull_dense` over the lanes: each lane's pullers pull
    from its own rows (``peers`` [K, N, S] lane-local) under the sync
    budget per edge into slot ``slot`` of its sync ring [K, D, N, P], in
    place; returns bool [K, N] fruitful.  With ``sdelay`` (i32[K, N*S],
    the lanes' session delays) edge e of lane k lands in slot (slot +
    sdelay[k, e]) % D.  With ``counts`` (i32 [K, P], a lane trace's
    grant rows ``counts[:, GRANTS]``) each payload's granting edges of
    lane k are added to row k.  K13's lane entry on the card, its delay
    lane entry with session delays; their recording forms, counted
    apart, with ``counts``."""
    if have.device.type == "cpu":
        return sync_pull_dense_lanes_plain(have, heads, gap_lo, gap_hi,
                                           peers, ok, nbytes, budget, ring,
                                           cfg, slot, sdelay, counts)
    lanes, n, p = have.shape
    s = peers.shape[2]
    a, k = cfg.n_writers, cfg.gap_slots
    d = ring.shape[1]
    _check_lanes_count(lanes)
    check("have", have, torch.uint8, (lanes, n, p))
    check("heads", heads, torch.int32, (lanes, n, a))
    check("gap_lo", gap_lo, torch.int32, (lanes, n, a, k))
    check("gap_hi", gap_hi, torch.int32, (lanes, n, a, k))
    check("peers", peers, torch.int32, (lanes, n, s))
    check("ok", ok, torch.bool, (lanes, n, s))
    check("nbytes", nbytes, torch.int32, (p,))
    check("sync ring", ring, torch.uint8, (lanes, d, n, p))
    if not 0 <= slot < d:
        raise ValueError(f"slot {slot} outside the ring of {d}")
    if sdelay is not None:
        check("sdelay", sdelay, torch.int32, (lanes, n * s))
    stride = 0
    if counts is not None:
        _check_lane_rows("counts", counts, torch.int32, (lanes, p))
        stride = counts.stride(0)
    fruitful = torch.empty((lanes, n), dtype=torch.bool, device=have.device)
    kernel = {(False, False): kernels.DENSE_SYNC_LANES,
              (True, False): kernels.DENSE_SYNC_DELAY_LANES,
              (False, True): kernels.DENSE_SYNC_LANES_TRACE,
              (True, True): kernels.DENSE_SYNC_DELAY_LANES_TRACE}[
        (sdelay is not None, counts is not None)]
    kernel.launch(
        [have, heads, gap_lo, gap_hi, peers, ok, nbytes, ring, fruitful,
         counts, sdelay],
        [n, p, s, a, cfg.chunks_per_version, k,
         -1 if budget is None else budget, d, slot, stride, lanes])
    return fruitful


# -- K14: the bookkeeping refresh and convergence record ----------------------


def dense_record_lanes_plain(have, injected, alive, metrics: RunMetrics,
                             meta: PayloadMeta, t: int, cfg: SimConfig,
                             horizon: Optional[int] = None):
    """Plain version of K14's lane entries and of their exit mode: the
    solo plain record per lane, stacked."""
    outs = [dense_record_plain(
        have[k], injected[k], alive[k],
        RunMetrics(*(x[k] for x in metrics)), meta, t, cfg, horizon)
        for k in range(have.shape[0])]
    return tuple(torch.stack(list(x)) for x in zip(*outs))


def dense_record_lanes(have, injected, alive, metrics: RunMetrics,
                       meta: PayloadMeta, t: int, cfg: SimConfig,
                       horizon: Optional[int] = None):
    """`round.dense_record` per lane: (heads i32[K, N, A], gap_lo, gap_hi
    i32[K, N, A, Kg], the overflow counts i32[K], coverage_at i32[K, P],
    converged_at i32[K, N], done bool[K]) — each lane's bookkeeping,
    stamps and exit flag from its own rows only; with a fault plan's
    ``horizon`` each lane's flag is the fault loop's (t + 1 ≥ horizon and
    fresh completeness over its up nodes).  K14's lane entries on the
    card: a rows pass with a lane grid dimension and a one-block finish a
    lane, in their exit mode under a plan."""
    if have.device.type == "cpu":
        return dense_record_lanes_plain(have, injected, alive, metrics, meta,
                                        t, cfg, horizon)
    lanes, n, p = have.shape
    a, v = cfg.n_writers, cfg.n_versions
    c, kg = cfg.chunks_per_version, cfg.gap_slots
    _check_lanes_count(lanes)
    check("have", have, torch.uint8, (lanes, n, p))
    check("injected", injected, torch.uint8, (lanes, p))
    check("alive", alive, torch.uint8, (lanes, n))
    check("meta.round", meta.round, torch.int32, (p,))
    check("converged_at", metrics.converged_at, torch.int32, (lanes, n))
    check("coverage_at", metrics.coverage_at, torch.int32, (lanes, p))
    dev = have.device
    blocks = -(-n // DENSE_ROWS_PER_BLOCK)
    words = -(-v // 32)
    heads = torch.empty((lanes, n, a), dtype=torch.int32, device=dev)
    lo = torch.empty((lanes, n, a, kg), dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    n_overflow = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    partial = torch.empty((lanes, blocks, a * words + 1), dtype=torch.int32,
                          device=dev)
    converged_at = torch.empty_like(metrics.converged_at)
    coverage_at = torch.empty_like(metrics.coverage_at)
    done = torch.empty((lanes,), dtype=torch.bool, device=dev)
    exit_mode = horizon is not None
    rows_k, finish_k = ((kernels.DENSE_GAPS_ROWS_EXIT_LANES,
                         kernels.DENSE_GAPS_FINISH_EXIT_LANES) if exit_mode
                        else (kernels.DENSE_GAPS_ROWS_LANES,
                              kernels.DENSE_GAPS_FINISH_LANES))
    rows_k.launch(
        [have, injected, alive, meta.round, metrics.converged_at, heads, lo,
         hi, n_overflow, converged_at, partial],
        [n, p, a, v, c, kg, t, DENSE_ROWS_PER_BLOCK, int(exit_mode), lanes])
    finish_k.launch(
        [partial, injected, meta.round, metrics.coverage_at, coverage_at,
         done],
        [blocks, p, a, v, c, t, horizon if exit_mode else -1, lanes])
    return heads, lo, hi, n_overflow, coverage_at, converged_at, done


# -- the round ------------------------------------------------------------------


def broadcast_step_lanes(state: SimState, meta: PayloadMeta, cfg: SimConfig,
                         topo: Topology, region, keys, faults=None,
                         seeds=None, active=None,
                         trace: Optional[RoundTrace] = None) -> None:
    """`broadcast.broadcast_step` over the lanes, in place on
    ``relay_left`` and ``inflight``: each lane's targets, ring0 tiering
    under its ``k_ring0`` (`.broadcast.ring0_targets_lanes`), the
    topology's degree caps (K20's caps lane entry), its edges and their
    slots (K20's edge lane entry on AZ or matrix delay classes), and
    K12's broadcast lane entry under its ``k_drop`` with the topology's
    flat loss threshold, or its tiered lane entry under tiered loss.
    Under ``faults`` (the round's shared slice) cuts clear the lanes'
    edges and the plan's fixed delay adds to their slots (K9 or K9m, the
    lanes folded into the edge axis), and the plan's loss and jitter are
    drawn per (edge, payload) under each lane's phase key ``keys[k]`` and
    plan seed ``seeds[k]`` (K12's fault lane entry); ``active`` (the
    host's copy of the round's loss and jitter activity) leaves out the
    classes that do not apply this round.  With a lane ``trace``
    (`.telemetry.new_trace_lanes`) each lane's cut edges (K9), lost
    frames and per-node frames and bytes (K12's recording form), folded
    over its ok edges (K18's rows lane entry), go to its accumulators."""
    lanes = keys.shape[0]
    ks = rng.split_lanes(keys, 3)
    k_targets, k_drop, k_ring0 = (ks[:, i].contiguous() for i in range(3))
    targets = broadcast_targets_lanes(state, cfg, topo, region, k_targets,
                                      k_ring0)
    src, dst, ok = _edges(state, targets)
    fthr = jit = fdelay = None
    if faults is not None:
        # ok is contiguous [K, E]: its flat view is cleared in place
        _, fthr, fdelay, jit = fault_wire_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            cut=None if trace is None else acc_slot(trace, "bcast_cut"))
        fthr, fdelay, jit = (None if x is None else x.view(lanes, -1)
                             for x in (fthr, fdelay, jit))
        if active is not None:
            fthr = fthr if active.loss else None
            jit = jit if active.jitter else None
    slot = edge_slot_lanes(topo, region, src[0], dst.contiguous(),
                           int(state.t), state.inflight.shape[1], fdelay)
    tiers = wire_tiers(topo)
    thr = (loss_threshold(topo.loss)
           if topo.loss > 0 and tiers is None else 0)
    row_frames = row_bytes = dropped = None
    if trace is not None:
        n = state.alive.shape[1]
        row_frames = torch.empty((lanes, n), dtype=torch.int32,
                                 device=ok.device)
        row_bytes = torch.empty_like(row_frames)
        if wire_loss_active(topo, faults):
            dropped = acc_slot(trace, "bcast_dropped")
    dst, slot = dst.contiguous(), slot.contiguous()
    ok_pull = None
    if cfg.dissemination == "push-pull":
        # the responses read the relay budget before the push spends it
        from ..proto.dissemination import (
            pull_session_ok_lanes, reverse_loss_lanes)
        from .broadcast import pull_send_lanes

        ok_pull = pull_session_ok_lanes(ok, faults, src, dst)
        pull_send_lanes(
            state.have, state.relay_left, state.injected, meta.nbytes,
            cfg.rate_limit_bytes_round, dst, slot, ok_pull, k_drop, thr,
            state.inflight, dropped,
            reverse_loss_lanes(faults, src, dst) if fthr is not None
            else None, seeds, tiers)
    broadcast_send_lanes(
        state.have, state.relay_left, state.injected, meta.nbytes,
        cfg.rate_limit_bytes_round, targets.contiguous(), dst, slot, ok,
        state.alive, k_drop, thr, state.inflight, keys, fthr, jit, seeds,
        row_frames, row_bytes, dropped, tiers)
    if trace is not None:
        wire_rows_lanes_(trace.acc[:, WIRE], row_frames, row_bytes, ok,
                         cfg.fanout)
        if ok_pull is not None:
            wire_rows_pull_lanes_(trace.acc[:, WIRE], row_frames, row_bytes,
                                  ok_pull, dst)


def sync_step_lanes(state: SimState, meta: PayloadMeta, cfg: SimConfig,
                    keys, faults=None, trace: Optional[RoundTrace] = None):
    """`sync.sync_step` over the lanes: each lane's peers (its PeerSwap
    view under that sampler), K13's lane entry into slot t + 1 of its
    sync ring (in place), then the backoff and the re-arm draw (K5's
    lane entry).  Under ``faults`` a session dies on a cut in either
    direction, and under a plan with delay factors each edge's grants
    land in slot t + 1 + its session delay (K9 or K9m on the lanes
    folded, one launch; K13's delay lane entry).  Returns the state; with a lane ``trace`` each lane's refused
    sessions (K9, lane-strided) and grant counts (K13's recording form)
    go to its accumulators and the sessions' ok mask bool[K, N * S] comes
    back second."""
    from ..proto.schedule import cadence_due

    lanes, n = state.alive.shape
    s = cfg.sync_peers
    ks = rng.split_lanes(keys, 3)
    k_peers, k_rearm = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    # the cadence before every use of due: the sessions' ok and the re-arm
    due = cadence_due(state.sync_countdown <= 0, cfg)
    peers = sample_member_targets_lanes(state, cfg, k_peers, s)
    src, dst, ok = _edges(state, peers)
    ok &= due[:, src[0].long()]
    sdelay = None
    if faults is not None:
        # the refused count is taken before the mask clears them
        _, sdelay = fault_session_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            None if trace is None else acc_slot(trace, "sync_refused"))
        if sdelay is not None:
            sdelay = sdelay.view(lanes, n * s)
    slot = (int(state.t) + 1) % state.sync_inflight.shape[1]
    fruitful = sync_pull_dense_lanes(
        state.have, state.heads, state.gap_lo, state.gap_hi,
        dst.reshape(lanes, n, s), ok.reshape(lanes, n, s), meta.nbytes,
        cfg.sync_budget_bytes, state.sync_inflight, cfg, slot, sdelay,
        None if trace is None else trace.counts[:, GRANTS])
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
    state = state._replace(sync_countdown=countdown.to(torch.int32),
                           sync_backoff=backoff)
    if trace is not None:
        return state, ok
    return state


def dense_round_step_lanes(state: SimState, metrics: RunMetrics,
                           meta: PayloadMeta, cfg: SimConfig,
                           topo: Topology, region, faults=None,
                           horizon: Optional[int] = None, seeds=None,
                           active=None, trace: Optional[RoundTrace] = None):
    """One dense round of every lane, phase for phase the solo
    `.round.round_step_` with lane k's keys: inject → broadcast → sync →
    deliver → SWIM → bookkeeping refresh and convergence record.  Under
    ``faults`` (the round's slice of either plan form, shared; its node
    faults applied by the caller) every phase takes the plan as the solo
    round does, each lane's draws under its plan seed ``seeds[k]``, the
    record's flag is the fault loop's (``horizon``), and ``active`` (the
    host's copy of the round's loss and jitter activity) picks the
    broadcast's entry.  The payload tensors and beliefs update in place
    (the loop owns them); returns (state, metrics, done) with done
    bool[K] on the device.  With a lane ``trace`` (`.telemetry.
    new_trace_lanes`) every lane's row is recorded in it, in place, as
    the solo round records its own: the phases feed each lane's
    accumulators, then K17's dense lane entry counts coverage and
    delivered and K19's lane entry writes the rows (with the shared
    fault slice's crashes and wipes).  Under ``peer_sampler="peerswap"``
    each lane's key splits five ways and the fifth drives the view swap
    tick (`..topo.sampler.peerswap_step_lanes`, K21's lane entries)
    before the phases, as in JAX's ``round_step``."""
    peerswap = cfg.peer_sampler == "peerswap"
    ks = rng.split_lanes(state.key, 5 if peerswap else 4)
    state = state._replace(key=ks[:, 0].contiguous())
    k_bcast, k_sync, k_swim = (ks[:, i].contiguous() for i in (1, 2, 3))
    if peerswap:
        state = peerswap_step_lanes(state, cfg, topo, ks[:, 4].contiguous(),
                                    faults, seeds)
    t = int(state.t)
    have0 = None if trace is None else state.have.clone()
    inject_dense_lanes(state.have, state.relay_left, state.injected, meta,
                       state.alive, t, cfg.max_transmissions)
    broadcast_step_lanes(state, meta, cfg, topo, region, k_bcast, faults,
                         seeds, active, trace)
    sync_ok = None
    if trace is None:
        state = sync_step_lanes(state, meta, cfg, k_sync, faults)
    else:
        state, sync_ok = sync_step_lanes(state, meta, cfg, k_sync, faults,
                                         trace)
    deliver_dense_lanes(state.inflight, state.sync_inflight, state.have,
                        state.relay_left, t % state.inflight.shape[1],
                        max(cfg.max_transmissions - 1, 1),
                        cfg if order_enforced(cfg) else None)
    state = swim_step_lanes(state, cfg, topo, k_swim, faults, seeds)
    heads, lo, hi, n_overflow, coverage_at, converged_at, done = (
        dense_record_lanes(state.have, state.injected, state.alive, metrics,
                           meta, t, cfg, horizon))
    overflow_frac = torch.maximum(
        metrics.overflow_frac,
        overflow_fraction(n_overflow, heads[0].numel()))
    if order_checked(cfg):
        # in place on the batch's own [K] counts
        count_order_violations_lanes_(metrics.order_violations, state.have,
                                      meta, cfg)
    if trace is not None:
        coverage_delivered_dense_lanes_(trace.counts[:, COVERAGE:GRANTS],
                                        state.have, have0, state.alive)
        record_row_lanes(trace, trace_row(trace, t, cfg.trace_every),
                         alive=state.alive, state=state, cfg=cfg, rf=faults,
                         sync_ok=sync_ok, n_overflow=n_overflow,
                         nbytes=meta.nbytes)
    state = state._replace(heads=heads, gap_lo=lo, gap_hi=hi, t=state.t + 1)
    return state, RunMetrics(coverage_at=coverage_at,
                             converged_at=converged_at,
                             overflow_frac=overflow_frac,
                             order_violations=metrics.order_violations), done


# -- the loop -------------------------------------------------------------------


def own_lanes(states: SimState) -> SimState:
    """Stacked states with tensors of their own where the round writes in
    place, ``t`` a host scalar 0."""
    return states._replace(
        t=torch.zeros((), dtype=torch.int32),
        **{f: getattr(states, f).clone() for f in _OWNED})


def lane_batch(states: SimState, cfg: SimConfig, seeds=None,
               trace: Optional[RoundTrace] = None) -> _Batch:
    """The dense lane loop's batch of every lane of stacked initial
    states (owned), with fresh metrics; with plan ``seeds`` (i32[K], a
    fault loop's) the tables the node faults write are owned too; a lane
    ``trace`` rides in ``extra`` (its fields, `trace_of`), so a lane that
    finishes leaves the batch with its trace."""
    lanes = states.alive.shape[0]
    slim = own_lanes(states)
    if seeds is not None:
        slim = slim._replace(**{f: getattr(slim, f).clone()
                                for f in NODE_FAULT_TABLES})
    return _Batch(slim, None, None,
                  _new_lane_metrics(cfg, lanes, states.alive.device), seeds,
                  list(range(lanes)), () if trace is None else tuple(trace))


def run_dense_lanes(states: SimState, meta: PayloadMeta, cfg: SimConfig,
                    topo: Topology, max_rounds: int, fplan=None,
                    plan_seeds=None, telemetry: bool = False):
    """Run every lane of stacked initial states (every field [K, ...],
    ``t`` 0 in all) on the dense round to its own exit or ``max_rounds``:
    faultless, the solo `.round.run_dense` loop per lane; under ``fplan``
    (either plan form, its schedule shared, its seed replaced per lane by
    ``plan_seeds`` i32[K]) the dense branch of the solo
    `.faults.run_fault_plan` — the round's node faults first (K11d's
    lane entry), the round with its fault slice, no exit before the
    horizon, then each lane's fresh all-have predicate (K14x's lane
    entries).  Returns the lanes' final (SimState, RunMetrics), stacked
    in lane order with ``t`` i32[K]; lane k equals the solo run of its
    initial state and seed.  With ``telemetry`` the flight recorder runs
    on every lane (a lane trace of ``max_rounds`` rows, `.telemetry.
    new_trace_lanes`), and the lanes' traces come back third, stacked in
    lane order: lane k's is its solo run's trace (rows past its exit
    stay zero)."""
    check_dense_lanes(cfg, topo, fplan)
    dev = states.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    lanes = states.alive.shape[0]
    horizon = None
    if fplan is not None:
        if plan_seeds is None:
            plan_seeds = torch.full((lanes,), int(fplan.seed),
                                    dtype=torch.int32, device=dev)
        horizon = fplan.horizon
        activity = host_activity(fplan)  # read once a run
    trace = (new_trace_lanes(cfg, max_rounds, lanes, dev) if telemetry
             else None)
    batch = lane_batch(states, cfg, None if fplan is None else plan_seeds,
                       trace)

    def step(batch: _Batch):
        t = int(batch.slim.t)
        rf = active = None
        if fplan is not None:
            rf = round_faults(fplan, t)
            apply_node_faults_lanes(batch.slim, rf)
            active = activity[min(t, horizon)]
        state, metrics, done = dense_round_step_lanes(
            batch.slim, batch.metrics, meta, cfg, topo, region, rf, horizon,
            batch.seeds, active,
            trace_of(batch.extra) if telemetry else None)
        return batch._replace(slim=state, metrics=metrics), done

    up = batch.slim.alive == ALIVE
    if fplan is None:
        done = (meta.round <= 0).all() & (
            (batch.metrics.converged_at >= 0) | ~up).all(dim=1)
    elif horizon > 0:  # t = 0: the solo loop's flag is false before it
        done = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    else:
        done = torch.stack([all_have(lane, meta, cfg)
                            for lane in _lane_states(batch.slim)])
    finished = _run_batch(batch, max_rounds, done, step)
    finals, metrics = _stack_results(finished, cfg)
    if telemetry:
        return finals, metrics, stack_traces(finished)
    return finals, metrics
