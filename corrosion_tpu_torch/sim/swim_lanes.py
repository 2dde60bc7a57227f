"""Membership on the lanes, shared by the dense round's lanes
(`.dense_lanes`) and the packed round's (`.lanes`): the lanes' target
and peer draws (`sample_member_targets_lanes`, the port of ``jax.vmap``
over ``corrosion_tpu/sim/swim.py sample_member_targets``) and their SWIM
tick (`swim_step_lanes`, over ``swim.py swim_step``), with K1's uniform
lane entry and K15's three lane entries (timeout, merge, apply) under
them.  Partial-view SWIM and its sampler are `.pswim`'s lane entries,
the PeerSwap view sampler `..topo.sampler`'s; this module picks between
them by the configuration's membership mode and sampler, as the solo
`.swim` does.

Each wrapper runs its plain torch version on a CPU tensor: the solo
plain version on each lane's slices.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.build import check
from ..topo.sampler import psample_view_targets_lanes
from . import rng
from .pswim import (
    _cells,
    psample_member_targets_lanes,
    pswim_step_lanes,
    reachable_lanes,
)
from .state import ALIVE, DOWN, SUSPECT, SimConfig, SimState
from .topology import Topology, loss_tiered

_LANES_MAX = 65535  # the grid's y dimension


def _check_lanes_count(lanes: int) -> None:
    if not 0 < lanes <= _LANES_MAX:
        raise ValueError(f"{lanes} lanes: the lane grid takes 1 to "
                         f"{_LANES_MAX}")


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
    under ``peer_sampler="peerswap"`` each lane's view
    (`..topo.sampler.psample_view_targets_lanes`, K1's view lane entry),
    else ``4 * count`` uniform candidates a node (K5's lane draw) through
    K1's uniform lane entry, filtered by the lane's full-view beliefs
    when coupled."""
    if cfg.swim_partial_view and cfg.couple_membership:
        return psample_member_targets_lanes(state, cfg, keys, count)
    if cfg.peer_sampler == "peerswap":
        return psample_view_targets_lanes(state, cfg, keys, count)
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
                         keys: torch.Tensor, faults=None,
                         seeds=None) -> SimState:
    """`swim.swim_step`'s full-view tick over the lanes, phase for phase
    and draw for draw the solo tick with lane k's key: the probe, the
    timeout (K15), the gossip edges and announces, the merge and the
    apply with its refute (K15), in place on ``view``, ``vinc`` and
    ``suspect_since`` [K, N, N]; every sample through K1's uniform lane
    entry, every draw K5's.  Every reach (`.pswim.reachable_lanes`)
    draws the topology's loss under each lane's loss keys (K20's reach
    lane entry under tiers, the flat bernoulli otherwise) and, under
    ``faults``, the plan's probe loss under each lane's loss keys and
    plan seed (K9's or K9m's reach lane entry)."""
    lanes, n = state.alive.shape
    ks = rng.split_lanes(keys, 8)
    k_probe, k_relay = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    k_gossip, k_ann = ks[:, 4].contiguous(), ks[:, 6].contiguous()
    # the reach draws only under a plan or the topology's loss
    k_ploss = k_gloss = k_aloss = k_hop1 = k_hop2 = None
    if faults is not None or topo.loss > 0 or loss_tiered(topo):
        k_ploss, k_gloss, k_aloss = (ks[:, i].contiguous()
                                     for i in (1, 5, 7))
        hop = rng.split_lanes(ks[:, 3].contiguous(), 2)
        k_hop1, k_hop2 = hop[:, 0].contiguous(), hop[:, 1].contiguous()
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
    direct = reachable_lanes(state, topo, k_ploss, me[None], target, faults,
                             seeds)
    ip = cfg.indirect_probes
    relays = sample_member_targets_lanes(state, cfg, k_relay, ip)
    relay_ok = relays >= 0
    relays = torch.clamp(relays, min=0).reshape(lanes, n * ip)
    leg1 = reachable_lanes(state, topo, k_hop1,
                           me.repeat_interleave(ip)[None], relays, faults,
                           seeds).reshape(lanes, n, ip)
    leg2 = reachable_lanes(state, topo, k_hop2, relays,
                           target.repeat_interleave(ip, dim=1), faults,
                           seeds).reshape(lanes, n, ip)
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
    g_ok = reachable_lanes(state, topo, k_gloss, gsrc, gdst, faults,
                           seeds) & g_valid
    g_ok &= _cells(view, gdst, gsrc) != DOWN

    # -- 3b. announce, with the receiver's belief fed back
    stagger = (t + me) % cfg.announce_interval_rounds == 0
    ann_target = rng.randint_lanes(k_ann, (n,), 0, n)
    ann_ok = (stagger & up & (ann_target != me)
              & reachable_lanes(state, topo, k_aloss, me[None], ann_target,
                                faults, seeds))
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
                    keys: torch.Tensor, faults=None,
                    seeds=None) -> SimState:
    """One SWIM tick of every lane: partial view
    (`.pswim.pswim_step_lanes`), full view (`swim_full_step_lanes`), or
    nothing under ground-truth membership; ``faults`` (the round's shared
    slice) and ``seeds`` (the lanes' plan seeds) reach every probe."""
    if cfg.swim_partial_view:
        return pswim_step_lanes(state, cfg, topo, keys, faults, seeds)
    if not cfg.swim_full_view:
        return state
    return swim_full_step_lanes(state, cfg, topo, keys, faults, seeds)
