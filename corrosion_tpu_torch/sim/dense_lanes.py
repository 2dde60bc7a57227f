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
K4's lane entries); every draw is K5's lane entry.  The byte budgets run
inside K12 and K13, per lane and per row, so the default budgets need no
`optimize_budgets`.

Each wrapper runs its plain torch version on a CPU tensor: the solo
plain version on each lane's slices, so lane k of a plain lane call IS
the solo call on lane k's inputs.  A finished lane leaves the batch as
on the packed round's lanes (`.lanes._run_batch`).  `check_dense_lanes`
refuses what this round's lanes do not run yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..kernels.build import check
from . import rng
from .lanes import (
    _Batch,
    _edge_alive_lanes,
    _new_lane_metrics,
    _run_batch,
    _stack_results,
    check_dense_lanes,
)
from .pswim import (
    _cells,
    psample_member_targets_lanes,
    pswim_step_lanes,
    reachable_lanes,
)
from .round import (
    _OWNED,
    DENSE_ROWS_PER_BLOCK,
    RunMetrics,
    dense_record_plain,
    overflow_fraction,
)
from .state import ALIVE, DOWN, SUSPECT, PayloadMeta, SimConfig, SimState
from .topology import Topology, edge_slot_plain, regions

_LANES_MAX = 65535  # the grid's y dimension


def _check_lanes_count(lanes: int) -> None:
    if not 0 < lanes <= _LANES_MAX:
        raise ValueError(f"{lanes} lanes: the lane grid takes 1 to "
                         f"{_LANES_MAX}")


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
                               thr: int, ring) -> None:
    """Plain version of K12's broadcast lane entry: the solo plain
    version on each lane under its key, in place."""
    from .broadcast import broadcast_send_plain

    for k in range(have.shape[0]):
        broadcast_send_plain(have[k], relay[k], injected[k], nbytes, budget,
                             targets[k], dst[k], slot[k], ok[k], alive[k],
                             keys[k], thr, ring[k])


def broadcast_send_lanes(have, relay, injected, nbytes,
                         budget: Optional[int], targets, dst, slot, ok,
                         alive, keys, thr: int, ring) -> None:
    """`broadcast.broadcast_send` over the lanes, in place on ``relay``
    and the rings [K, D, N, P]: each lane's eligible payloads, its
    oldest-first budget prefix per row (lane-local), its edges' ring
    writes less the flat loss under its key ``keys[k]`` (byte e*P + q of
    its own draw, e lane-local) and its relay spend.  K12's broadcast
    lane entry on the card (no fault, tiered or recorder outputs)."""
    if have.device.type == "cpu":
        broadcast_send_lanes_plain(have, relay, injected, nbytes, budget,
                                   targets, dst, slot, ok, alive, keys, thr,
                                   ring)
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
    kernels.DENSE_BROADCAST_LANES.launch(
        [have, relay, injected, nbytes, targets, dst, slot, ok, alive, keys,
         ring],
        [n, p, f, d, -1 if budget is None else budget, min(thr, 256),
         lanes])


def deliver_dense_lanes_plain(ring, sync_ring, have, relay, slot: int,
                              relay_init: int) -> None:
    """Plain version of K12's deliver lane entry, in place."""
    from .broadcast import deliver_dense_plain

    for k in range(have.shape[0]):
        deliver_dense_plain(ring[k], sync_ring[k], have[k], relay[k], slot,
                            relay_init)


def deliver_dense_lanes(ring, sync_ring, have, relay, slot: int,
                        relay_init: int) -> None:
    """`broadcast.deliver_dense` over the lanes: slot ``slot`` of every
    lane's two rings [K, D, N, P] into its ``have``, in place.  K12's
    deliver lane entry on the card."""
    if have.device.type == "cpu":
        deliver_dense_lanes_plain(ring, sync_ring, have, relay, slot,
                                  relay_init)
        return
    lanes, n, p = have.shape
    d = ring.shape[1]
    _check_lanes_count(lanes)
    _check_rows_lanes(have, relay, lanes, n, p)
    check("inflight", ring, torch.uint8, (lanes, d, n, p))
    check("sync_inflight", sync_ring, torch.uint8, (lanes, d, n, p))
    if not 0 <= slot < d:
        raise ValueError(f"slot {slot} outside the ring of {d}")
    kernels.DENSE_DELIVER_LANES.launch(
        [ring, sync_ring, have, relay], [n, p, d, slot, relay_init, lanes])


# -- K13: the sync pull -----------------------------------------------------


def sync_pull_dense_lanes_plain(have, heads, gap_lo, gap_hi, peers, ok,
                                nbytes, budget, ring, cfg: SimConfig,
                                slot: int) -> torch.Tensor:
    """Plain version of K13's lane entry: the solo plain version on each
    lane's rows and its ring's slot, in place."""
    from .sync import sync_pull_dense_plain

    return torch.stack([
        sync_pull_dense_plain(have[k], heads[k], gap_lo[k], gap_hi[k],
                              peers[k], ok[k], nbytes, budget,
                              ring[k, slot], cfg)
        for k in range(have.shape[0])])


def sync_pull_dense_lanes(have, heads, gap_lo, gap_hi, peers, ok, nbytes,
                          budget: Optional[int], ring, cfg: SimConfig,
                          slot: int) -> torch.Tensor:
    """`sync.sync_pull_dense` over the lanes: each lane's pullers pull
    from its own rows (``peers`` [K, N, S] lane-local) under the sync
    budget per edge into slot ``slot`` of its sync ring [K, D, N, P], in
    place; returns bool [K, N] fruitful.  K13's lane entry on the card."""
    if have.device.type == "cpu":
        return sync_pull_dense_lanes_plain(have, heads, gap_lo, gap_hi,
                                           peers, ok, nbytes, budget, ring,
                                           cfg, slot)
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
    fruitful = torch.empty((lanes, n), dtype=torch.bool, device=have.device)
    kernels.DENSE_SYNC_LANES.launch(
        [have, heads, gap_lo, gap_hi, peers, ok, nbytes, ring, fruitful],
        [n, p, s, a, cfg.chunks_per_version, k,
         -1 if budget is None else budget, d, slot, lanes])
    return fruitful


# -- K14: the bookkeeping refresh and convergence record ----------------------


def dense_record_lanes_plain(have, injected, alive, metrics: RunMetrics,
                             meta: PayloadMeta, t: int, cfg: SimConfig):
    """Plain version of K14's lane entries: the solo plain record per
    lane, stacked."""
    outs = [dense_record_plain(
        have[k], injected[k], alive[k],
        RunMetrics(*(x[k] for x in metrics)), meta, t, cfg)
        for k in range(have.shape[0])]
    return tuple(torch.stack(list(x)) for x in zip(*outs))


def dense_record_lanes(have, injected, alive, metrics: RunMetrics,
                       meta: PayloadMeta, t: int, cfg: SimConfig):
    """`round.dense_record` per lane, faultless: (heads i32[K, N, A],
    gap_lo, gap_hi i32[K, N, A, Kg], the overflow counts i32[K],
    coverage_at i32[K, P], converged_at i32[K, N], done bool[K]) — each
    lane's bookkeeping, stamps and exit flag from its own rows only.
    K14's lane entries on the card: a rows pass with a lane grid
    dimension and a one-block finish a lane."""
    if have.device.type == "cpu":
        return dense_record_lanes_plain(have, injected, alive, metrics, meta,
                                        t, cfg)
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
    kernels.DENSE_GAPS_ROWS_LANES.launch(
        [have, injected, alive, meta.round, metrics.converged_at, heads, lo,
         hi, n_overflow, converged_at, partial],
        [n, p, a, v, c, kg, t, DENSE_ROWS_PER_BLOCK, 0, lanes])
    kernels.DENSE_GAPS_FINISH_LANES.launch(
        [partial, injected, meta.round, metrics.coverage_at, coverage_at,
         done],
        [blocks, p, a, v, c, t, -1, lanes])
    return heads, lo, hi, n_overflow, coverage_at, converged_at, done


# -- K1's uniform lane entry --------------------------------------------------


def sample_uniform_lanes_plain(cand, view, count: int) -> torch.Tensor:
    """Plain version of K1's uniform lane entry: the solo plain version
    per lane."""
    from .swim import sample_uniform_plain

    return torch.stack([
        sample_uniform_plain(cand[k], None if view is None else view[k],
                             count)
        for k in range(cand.shape[0])])


def sample_uniform_lanes(cand, view, count: int) -> torch.Tensor:
    """`swim.sample_uniform` over the lanes: i32[K, N, count] lane-local
    targets from candidates [K, over, N] (K5's lane draw), filtered by
    each lane's beliefs ``view`` [K, N, N] (None: ground truth).  K1's
    uniform lane entry on the card."""
    if cand.device.type == "cpu":
        return sample_uniform_lanes_plain(cand, view, count)
    lanes, over, n = cand.shape
    _check_lanes_count(lanes)
    check("cand", cand, torch.int32, (lanes, over, n))
    if view is not None:
        check("view", view, torch.int8, (lanes, n, n))
    out = torch.empty((lanes, n, count), dtype=torch.int32,
                      device=cand.device)
    kernels.SAMPLE_UNIFORM_LANES.launch([cand, view, out],
                                        [n, over, count, lanes])
    return out


def sample_member_targets_lanes(state: SimState, cfg: SimConfig, keys,
                                count: int) -> torch.Tensor:
    """`swim.sample_member_targets` over the lanes: the partial-view
    tables (`.pswim.psample_member_targets_lanes`) when coupled, else
    ``4 * count`` uniform candidates a node (K5's lane draw) through
    K1's uniform lane entry, filtered by the lane's full-view beliefs
    when coupled."""
    if cfg.swim_partial_view and cfg.couple_membership:
        return psample_member_targets_lanes(state, cfg, keys, count)
    n = state.alive.shape[1]
    cand = rng.randint_lanes(keys, (4 * count, n), 0, n)
    coupled = cfg.swim_full_view and cfg.couple_membership
    return sample_uniform_lanes(cand, state.view if coupled else None,
                                count)


# -- K15: the full-view belief update ------------------------------------------


def _check_beliefs_lanes(view, vinc, since, lanes: int, n: int) -> None:
    check("view", view, torch.int8, (lanes, n, n))
    check("vinc", vinc, torch.int32, (lanes, n, n))
    check("suspect_since", since, torch.int32, (lanes, n, n))


def swim_timeout_lanes_plain(view, vinc, since, t: int, timeout: int):
    """Plain version of K15's timeout lane entry, in place on ``view``."""
    from .swim import swim_timeout_plain

    return torch.stack([swim_timeout_plain(view[k], vinc[k], since[k], t,
                                           timeout)
                        for k in range(view.shape[0])])


def swim_timeout_lanes_(view, vinc, since, t: int,
                        timeout: int) -> torch.Tensor:
    """`swim.swim_timeout_` over the lanes: each lane's expired suspects
    turn DOWN in place; returns the belief keys i32[K, N, N].  K15's
    timeout lane entry on the card."""
    if view.device.type == "cpu":
        return swim_timeout_lanes_plain(view, vinc, since, t, timeout)
    lanes, n, _ = view.shape
    _check_lanes_count(lanes)
    _check_beliefs_lanes(view, vinc, since, lanes, n)
    key = torch.empty_like(vinc)
    kernels.SWIM_TIMEOUT_LANES.launch([view, vinc, since, key],
                                      [n, t, timeout, lanes])
    return key


def swim_merge_lanes_plain(belief_key, gdst, g_ok, fanout: int, ann_target,
                           ann_claim) -> torch.Tensor:
    """Plain version of K15's merge lane entry."""
    from .swim import swim_merge_plain

    return torch.stack([swim_merge_plain(belief_key[k], gdst[k], g_ok[k],
                                         fanout, ann_target[k], ann_claim[k])
                        for k in range(belief_key.shape[0])])


def swim_merge_lanes(belief_key, gdst, g_ok, fanout: int, ann_target,
                     ann_claim) -> torch.Tensor:
    """`swim.swim_merge` over the lanes: each lane's gossip rows and
    announce claims scatter-max into a copy of its own keys (lane-local
    receivers).  K15's merge lane entry on the card."""
    if belief_key.device.type == "cpu":
        return swim_merge_lanes_plain(belief_key, gdst, g_ok, fanout,
                                      ann_target, ann_claim)
    lanes, n, _ = belief_key.shape
    e = n * fanout
    _check_lanes_count(lanes)
    check("belief_key", belief_key, torch.int32, (lanes, n, n))
    check("gdst", gdst, torch.int32, (lanes, e))
    check("g_ok", g_ok, torch.bool, (lanes, e))
    check("ann_target", ann_target, torch.int32, (lanes, n))
    check("ann_claim", ann_claim, torch.int32, (lanes, n))
    merged = belief_key.clone()
    kernels.SWIM_MERGE_LANES.launch(
        [belief_key, gdst, g_ok, ann_target, ann_claim, merged],
        [n, fanout, lanes])
    return merged


def swim_apply_lanes_plain(view, vinc, since, belief_key, merged,
                           incarnation, up, heard_down, fb_inc,
                           t: int) -> torch.Tensor:
    """Plain version of K15's apply lane entry, in place on the
    beliefs."""
    from .swim import swim_apply_plain

    return torch.stack([swim_apply_plain(
        view[k], vinc[k], since[k], belief_key[k], merged[k],
        incarnation[k], up[k], heard_down[k], fb_inc[k], t)
        for k in range(view.shape[0])])


def swim_apply_lanes_(view, vinc, since, belief_key, merged, incarnation,
                      up, heard_down, fb_inc, t: int) -> torch.Tensor:
    """`swim.swim_apply_` over the lanes, in place on each lane's
    beliefs; returns the new incarnations i32[K, N].  K15's apply lane
    entry on the card."""
    if view.device.type == "cpu":
        return swim_apply_lanes_plain(view, vinc, since, belief_key, merged,
                                      incarnation, up, heard_down, fb_inc, t)
    lanes, n, _ = view.shape
    _check_lanes_count(lanes)
    _check_beliefs_lanes(view, vinc, since, lanes, n)
    check("belief_key", belief_key, torch.int32, (lanes, n, n))
    check("merged", merged, torch.int32, (lanes, n, n))
    for name, x in (("incarnation", incarnation), ("fb_inc", fb_inc)):
        check(name, x, torch.int32, (lanes, n))
    for name, x in (("up", up), ("heard_down", heard_down)):
        check(name, x, torch.bool, (lanes, n))
    out = incarnation.clone()
    kernels.SWIM_APPLY_LANES.launch(
        [view, vinc, since, belief_key, merged, up, heard_down, fb_inc, out],
        [n, t, lanes])
    return out


def swim_full_step_lanes(state: SimState, cfg: SimConfig, topo: Topology,
                         keys: torch.Tensor) -> SimState:
    """`swim.swim_step`'s full-view tick over the lanes, phase for phase
    and draw for draw the solo tick with lane k's key: the probe, the
    timeout (K15), the gossip edges and announces, the merge and the
    apply with its refute (K15), in place on ``view``, ``vinc`` and
    ``suspect_since`` [K, N, N]; every sample through K1's uniform lane
    entry, every draw K5's.  Flat lossless topology: reach draws
    nothing."""
    lanes, n = state.alive.shape
    ks = rng.split_lanes(keys, 8)
    k_probe, k_relay = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    k_gossip, k_ann = ks[:, 4].contiguous(), ks[:, 6].contiguous()
    t = int(state.t)
    dev = state.alive.device
    me = torch.arange(n, dtype=torch.int32, device=dev)
    up = state.alive == ALIVE
    view, vinc, since = state.view, state.vinc, state.suspect_since
    f = cfg.fanout
    g_targets = sample_member_targets_lanes(state, cfg, k_gossip, f)

    # -- 1. probe
    target = sample_member_targets_lanes(state, cfg, k_probe, 1)[:, :, 0]
    do_probe = up & (t % cfg.probe_period_rounds == 0) & (target >= 0)
    target = torch.clamp(target, min=0)
    direct = reachable_lanes(state, topo, None, me[None], target)
    ip = cfg.indirect_probes
    relays = sample_member_targets_lanes(state, cfg, k_relay, ip)
    relay_ok = relays >= 0
    relays = torch.clamp(relays, min=0).reshape(lanes, n * ip)
    leg1 = reachable_lanes(state, topo, None, me.repeat_interleave(ip)[None],
                           relays).reshape(lanes, n, ip)
    leg2 = reachable_lanes(state, topo, None, relays,
                           target.repeat_interleave(ip, dim=1)).reshape(
        lanes, n, ip)
    acked = direct | (leg1 & leg2 & relay_ok).any(dim=2)
    probe_failed = do_probe & ~acked & (target != me)
    cell = (me.long() * n)[None] + target.long()  # [K, N]
    flat_view = view.view(lanes, n * n)
    flat_since = since.view(lanes, n * n)
    cur = torch.gather(flat_view, 1, cell)
    newly_suspect = probe_failed & (cur == ALIVE)
    flat_view.scatter_(1, cell, torch.where(newly_suspect, SUSPECT,
                                            cur).to(torch.int8))
    flat_since.scatter_(1, cell, torch.where(
        newly_suspect, t, torch.gather(flat_since, 1, cell)).to(torch.int32))

    # -- 2. suspicion timeout, and the belief keys
    belief_key = swim_timeout_lanes_(view, vinc, since, t,
                                     cfg.suspect_timeout_rounds)

    # -- 3. gossip edges; receivers ignore senders they believe DOWN
    gsrc = me.repeat_interleave(f)[None].expand(lanes, -1)
    gdst = g_targets.reshape(lanes, n * f)
    g_valid = gdst >= 0
    gdst = torch.clamp(gdst, min=0)
    g_ok = reachable_lanes(state, topo, None, gsrc, gdst) & g_valid
    g_ok &= _cells(view, gdst, gsrc) != DOWN

    # -- 3b. announce, with the receiver's belief fed back
    stagger = (t + me) % cfg.announce_interval_rounds == 0
    ann_target = rng.randint_lanes(k_ann, (n,), 0, n)
    ann_ok = (stagger & up & (ann_target != me)
              & reachable_lanes(state, topo, None, me[None], ann_target))
    self_claim = state.incarnation * 4 + ALIVE
    mine = me[None].expand(lanes, n)
    ann_fb = ann_ok & (_cells(view, ann_target, mine) == DOWN)
    fb_inc = torch.where(ann_fb, _cells(vinc, ann_target, mine), -1)
    merged = swim_merge_lanes(
        belief_key, gdst.contiguous(), g_ok, f, ann_target,
        torch.where(ann_ok, self_claim, -1).to(torch.int32))

    # -- 3c + 4. apply, then refute
    incarnation = swim_apply_lanes_(
        view, vinc, since, belief_key, merged, state.incarnation, up,
        ann_fb, fb_inc.to(torch.int32), t)
    return state._replace(incarnation=incarnation)


def swim_step_lanes(state: SimState, cfg: SimConfig, topo: Topology,
                    keys: torch.Tensor) -> SimState:
    """One SWIM tick of every lane: partial view
    (`.pswim.pswim_step_lanes`), full view (`swim_full_step_lanes`), or
    nothing under ground-truth membership."""
    if cfg.swim_partial_view:
        return pswim_step_lanes(state, cfg, topo, keys)
    if not cfg.swim_full_view:
        return state
    return swim_full_step_lanes(state, cfg, topo, keys)


# -- the round ------------------------------------------------------------------


def _edges(state: SimState, targets: torch.Tensor):
    """The lanes' edge list from targets [K, N, F]: (src [1, E], dst
    [K, E] clamped, ok [K, E]) — a real target, both ends in one group
    and up, and not the sender itself."""
    lanes, n, f = targets.shape
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    src = me.repeat_interleave(f)[None]
    dst = targets.reshape(lanes, n * f)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= _edge_alive_lanes(state, src, dst)
    ok &= dst != src
    return src, dst, ok


def broadcast_step_lanes(state: SimState, meta: PayloadMeta, cfg: SimConfig,
                         topo: Topology, region, keys) -> None:
    """`broadcast.broadcast_step` over the lanes, in place on
    ``relay_left`` and ``inflight``: each lane's targets, its edges and
    their slots, and K12's broadcast lane entry under its ``k_drop``."""
    ks = rng.split_lanes(keys, 3)
    k_targets, k_drop = ks[:, 0].contiguous(), ks[:, 1].contiguous()
    targets = sample_member_targets_lanes(state, cfg, k_targets, cfg.fanout)
    src, dst, ok = _edges(state, targets)
    slot = edge_slot_plain(topo, region, src, dst, int(state.t),
                           state.inflight.shape[1])
    broadcast_send_lanes(
        state.have, state.relay_left, state.injected, meta.nbytes,
        cfg.rate_limit_bytes_round, targets.contiguous(), dst.contiguous(),
        slot.contiguous(), ok, state.alive, k_drop, 0, state.inflight)


def sync_step_lanes(state: SimState, meta: PayloadMeta, cfg: SimConfig,
                    keys) -> SimState:
    """`sync.sync_step` over the lanes: each lane's peers, K13's lane
    entry into slot t + 1 of its sync ring (in place), then the backoff
    and the re-arm draw (K5's lane entry)."""
    lanes, n = state.alive.shape
    s = cfg.sync_peers
    ks = rng.split_lanes(keys, 3)
    k_peers, k_rearm = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    due = state.sync_countdown <= 0
    peers = sample_member_targets_lanes(state, cfg, k_peers, s)
    src, dst, ok = _edges(state, peers)
    ok &= due[:, src[0].long()]
    slot = (int(state.t) + 1) % state.sync_inflight.shape[1]
    fruitful = sync_pull_dense_lanes(
        state.have, state.heads, state.gap_lo, state.gap_hi,
        dst.reshape(lanes, n, s), ok.reshape(lanes, n, s), meta.nbytes,
        cfg.sync_budget_bytes, state.sync_inflight, cfg, slot)
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
    return state._replace(sync_countdown=countdown.to(torch.int32),
                          sync_backoff=backoff)


def dense_round_step_lanes(state: SimState, metrics: RunMetrics,
                           meta: PayloadMeta, cfg: SimConfig,
                           topo: Topology, region):
    """One dense round of every lane, phase for phase the solo
    `.round.round_step_` with lane k's keys: inject → broadcast → sync →
    deliver → SWIM → bookkeeping refresh and convergence record.  The
    payload tensors and beliefs update in place (the loop owns them);
    returns (state, metrics, done) with done bool[K] on the device."""
    ks = rng.split_lanes(state.key, 4)
    state = state._replace(key=ks[:, 0].contiguous())
    k_bcast, k_sync, k_swim = (ks[:, i].contiguous() for i in (1, 2, 3))
    t = int(state.t)
    inject_dense_lanes(state.have, state.relay_left, state.injected, meta,
                       state.alive, t, cfg.max_transmissions)
    broadcast_step_lanes(state, meta, cfg, topo, region, k_bcast)
    state = sync_step_lanes(state, meta, cfg, k_sync)
    deliver_dense_lanes(state.inflight, state.sync_inflight, state.have,
                        state.relay_left, t % state.inflight.shape[1],
                        max(cfg.max_transmissions - 1, 1))
    state = swim_step_lanes(state, cfg, topo, k_swim)
    heads, lo, hi, n_overflow, coverage_at, converged_at, done = (
        dense_record_lanes(state.have, state.injected, state.alive, metrics,
                           meta, t, cfg))
    overflow_frac = torch.maximum(
        metrics.overflow_frac,
        overflow_fraction(n_overflow, heads[0].numel()))
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


def lane_batch(states: SimState, cfg: SimConfig) -> _Batch:
    """The dense lane loop's batch of every lane of stacked initial
    states (owned), with fresh metrics."""
    lanes = states.alive.shape[0]
    return _Batch(own_lanes(states), None, None,
                  _new_lane_metrics(cfg, lanes, states.alive.device), None,
                  list(range(lanes)))


def run_dense_lanes(states: SimState, meta: PayloadMeta, cfg: SimConfig,
                    topo: Topology, max_rounds: int, fplan=None):
    """Run every lane of stacked initial states (every field [K, ...],
    ``t`` 0 in all) on the dense round to its own convergence or
    ``max_rounds``: the solo `.round.run_dense` loop per lane.  Returns
    the lanes' final (SimState, RunMetrics), stacked in lane order with
    ``t`` i32[K]; lane k equals the solo run of its initial state.  A
    fault plan (``fplan``) is refused: the dense fault lanes are the
    next item of ROADMAP B16d."""
    check_dense_lanes(cfg, topo, fplan)
    dev = states.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    batch = lane_batch(states, cfg)

    def step(batch: _Batch):
        state, metrics, done = dense_round_step_lanes(
            batch.slim, batch.metrics, meta, cfg, topo, region)
        return batch._replace(slim=state, metrics=metrics), done

    up = batch.slim.alive == ALIVE
    done = (meta.round <= 0).all() & (
        (batch.metrics.converged_at >= 0) | ~up).all(dim=1)
    return _stack_results(_run_batch(batch, max_rounds, done, step), cfg)
