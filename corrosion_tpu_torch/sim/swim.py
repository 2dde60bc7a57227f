"""SWIM membership — the port of ``corrosion_tpu/sim/swim.py``: the
transposed ``[over, N]`` dedup/compaction helpers, ground-truth
reachability (the topology's flat or tiered loss, and a fault plan's
cuts and probe loss), the member sampler in all its modes (partial
view, PeerSwap view, uniform with or without full-view beliefs), and
the full-view `swim_step` on ``[N, N]`` belief matrices (the
partial-view step is `.pswim.pswim_step`).

Two hot functions run hand-written kernels on the card:

- the uniform sampler (`sample_uniform`, K1's second entry point,
  ``kernels/csrc/sample_targets.cu``): candidates come from a ``[4c, N]``
  randint draw instead of the member tables, and in coupled full view
  each is filtered by the drawing node's belief ``view[me, cand] !=
  DOWN``;
- the full-view belief update (K15, ``kernels/csrc/swim_full.cu``), in
  three passes: `swim_timeout_` (the suspicion timeout, then the belief
  keys ``vinc * 4 + view``), `swim_merge` (the gossip rows' and the
  announce claims' scatter-max into a copy of the keys) and
  `swim_apply_` (changed cells take the merged belief; the diagonal
  refutes).

Each wrapper takes the plain torch version beside it for a CPU tensor.
The probe, the gossip edge list and the announce draws stay torch (and
K1, K5).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..kernels.build import check
from . import rng
from .faults import fault_reach_
from .state import ALIVE, DOWN, SUSPECT, SimConfig, SimState
from .topology import Topology, loss_tiered, tiered_reach_


def _compact_targets(
    cand: torch.Tensor, valid: torch.Tensor, count: int
) -> torch.Tensor:
    """Prefix-compact each node's valid candidates into the first
    ``count`` slots (-1 pads); inputs are ``[over, N]``, output
    ``[N, count]``."""
    rank = torch.cumsum(valid.to(torch.int32), dim=0)  # [over, N]
    slot = torch.arange(
        1, count + 1, dtype=torch.int32, device=cand.device
    )[None, :, None]
    sel = valid[:, None, :] & (rank[:, None, :] == slot)  # [over, count, N]
    picked = torch.where(sel, cand[:, None, :], -1)
    return picked.amax(dim=0).T.contiguous()


def _dup_before(cand: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[over, N]: candidate j repeats an EARLIER valid candidate."""
    over = cand.shape[0]
    eq = cand[None, :, :] == cand[:, None, :]  # [j, i, N]
    earlier = torch.tril(
        torch.ones((over, over), dtype=torch.bool, device=cand.device),
        diagonal=-1,
    )  # [j, i]: i < j
    return (eq & earlier[:, :, None] & valid[None, :, :]).any(dim=1)


def _reachable(
    state: SimState, topo: Topology, key: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, faults=None,
) -> torch.Tensor:
    """Ground-truth reachability of a probe src→dst: same partition group,
    both ends up, and not lost — under tiered loss to the aligned u8
    draw of ``fold_in(key, 104)`` against each edge's tier threshold
    (`topology.tiered_reach_`, K20's reach entry on the card), on a flat
    lossy topology to ``bernoulli(key, loss, src.shape)`` (JAX's legacy
    flat branch).  ``faults`` (a round slice of either plan form) adds the
    plan's directed cuts and its per-edge loss, drawn from
    ``fold_in(fold_in(key, seed), 103)`` (`faults.fault_reach_`, K9's
    reach entry or K9m's on the card)."""
    ok = (
        (state.group[src] == state.group[dst])
        & (state.alive[src] == ALIVE)
        & (state.alive[dst] == ALIVE)
    )
    if loss_tiered(topo):
        ok = tiered_reach_(ok, topo, state.alive.shape[0], key, src, dst)
    elif topo.loss > 0:
        ok &= ~rng.bernoulli(key, topo.loss, tuple(src.shape))
    if faults is not None:
        ok = fault_reach_(ok, faults, key, src, dst)
    return ok


# -- K1, second entry: the uniform sampler -----------------------------------


def sample_uniform_plain(
    cand: torch.Tensor, view: Optional[torch.Tensor], count: int
) -> torch.Tensor:
    """Plain version of K1's uniform entry: drop self, believed-DOWN
    candidates (when ``view`` is given) and repeats of an earlier valid
    candidate, then compact."""
    n = cand.shape[1]
    me = torch.arange(n, dtype=torch.int32, device=cand.device)[None, :]
    valid = cand != me
    if view is not None:
        valid &= view[me.long(), cand.long()] != DOWN
    valid &= ~_dup_before(cand, valid)
    return _compact_targets(cand, valid, count)


def sample_uniform(
    cand: torch.Tensor, view: Optional[torch.Tensor], count: int
) -> torch.Tensor:
    """i32[N, count] targets from uniform candidates ``[over, N]``,
    filtered by the drawing node's beliefs ``view`` (i8[N, N], or None
    for ground-truth membership); K1 on the card."""
    if cand.device.type == "cpu":
        return sample_uniform_plain(cand, view, count)
    over, n = cand.shape
    check("cand", cand, torch.int32, (over, n))
    if view is not None:
        check("view", view, torch.int8, (n, n))
    out = torch.empty((n, count), dtype=torch.int32, device=cand.device)
    kernels.SAMPLE_UNIFORM.launch([cand, view, out], [n, over, count])
    return out


def sample_member_targets(
    state: SimState, cfg: SimConfig, key: torch.Tensor, count: int
) -> torch.Tensor:
    """i32[N, count] targets from each node's believed member list
    (-1 marks unfilled slots): the partial-view tables when coupled,
    else the PeerSwap view under ``peer_sampler="peerswap"``
    (`..topo.sampler.psample_view_targets`), else ``4 * count`` uniform
    candidates (JAX ``swim.sample_member_targets``)."""
    if cfg.swim_partial_view and cfg.couple_membership:
        from .pswim import psample_member_targets

        return psample_member_targets(state, cfg, key, count)
    if cfg.peer_sampler == "peerswap":
        from ..topo.sampler import psample_view_targets

        return psample_view_targets(state, cfg, key, count)
    n = state.alive.shape[0]
    cand = rng.randint(key, (4 * count, n), 0, n)
    coupled = cfg.swim_full_view and cfg.couple_membership
    return sample_uniform(cand, state.view if coupled else None, count)


# -- K15: the full-view belief update ----------------------------------------


def swim_timeout_plain(view, vinc, since, t: int, timeout: int):
    """Plain version of K15's first pass, in place on ``view``."""
    expired = (view == SUSPECT) & (since >= 0) & (t - since >= timeout)
    view.copy_(torch.where(expired, DOWN, view).to(torch.int8))
    return vinc * 4 + view.to(torch.int32)


def swim_timeout_(view, vinc, since, t: int, timeout: int) -> torch.Tensor:
    """The suspicion timeout (SUSPECT older than ``timeout`` rounds turns
    DOWN, in place on ``view``), then the belief keys ``vinc * 4 +
    view`` (i32[N, N]), whose max is SWIM's precedence.  K15 on the
    card."""
    if view.device.type == "cpu":
        return swim_timeout_plain(view, vinc, since, t, timeout)
    n = view.shape[0]
    _check_beliefs(view, vinc, since, n)
    key = torch.empty_like(vinc)
    kernels.SWIM_TIMEOUT.launch([view, vinc, since, key], [n, t, timeout])
    return key


def _check_beliefs(view, vinc, since, n: int) -> None:
    check("view", view, torch.int8, (n, n))
    check("vinc", vinc, torch.int32, (n, n))
    check("suspect_since", since, torch.int32, (n, n))


def swim_merge_plain(belief_key, gdst, g_ok, fanout: int, ann_target,
                     ann_claim) -> torch.Tensor:
    """Plain version of K15's merge pass."""
    n = belief_key.shape[0]
    gsrc = torch.arange(n, device=gdst.device).repeat_interleave(fanout)
    contrib = torch.where(g_ok[:, None], belief_key[gsrc], -1)  # [E, N]
    merged = belief_key.scatter_reduce(
        0, gdst.long()[:, None].expand(-1, n), contrib, "amax"
    )
    flat = ann_target.long() * n + torch.arange(n, device=gdst.device)
    return merged.reshape(-1).scatter_reduce(
        0, flat, ann_claim, "amax"
    ).reshape(n, n)


def swim_merge(belief_key, gdst, g_ok, fanout: int, ann_target,
               ann_claim) -> torch.Tensor:
    """The gossip merge: every ok edge e (sender e // fanout) pushes its
    sender's row of the PRE-merge ``belief_key`` into its receiver's row
    by scatter-max, and every node's announce claim (-1 where it sends
    none) lands at ``[ann_target, me]``; returns the merged keys.  K15
    on the card."""
    if belief_key.device.type == "cpu":
        return swim_merge_plain(belief_key, gdst, g_ok, fanout, ann_target,
                                ann_claim)
    n = belief_key.shape[0]
    e = n * fanout
    check("belief_key", belief_key, torch.int32, (n, n))
    check("gdst", gdst, torch.int32, (e,))
    check("g_ok", g_ok, torch.bool, (e,))
    check("ann_target", ann_target, torch.int32, (n,))
    check("ann_claim", ann_claim, torch.int32, (n,))
    merged = belief_key.clone()
    kernels.SWIM_MERGE.launch(
        [belief_key, gdst, g_ok, ann_target, ann_claim, merged], [n, fanout]
    )
    return merged


def swim_apply_plain(view, vinc, since, belief_key, merged, incarnation, up,
                     heard_down, fb_inc, t: int) -> torch.Tensor:
    """Plain version of K15's apply pass, in place on the beliefs."""
    n = view.shape[0]
    changed = merged > belief_key
    new_view = (merged % 4).to(torch.int8)
    view.copy_(torch.where(changed, new_view, view))
    vinc.copy_(torch.where(changed, merged // 4, vinc))
    since.copy_(torch.where(changed & (new_view == SUSPECT), t, since))
    diag = torch.arange(n, device=view.device)
    self_belief = view[diag, diag]
    refuting = up & ((self_belief != ALIVE) | heard_down)
    bumped = torch.maximum(torch.maximum(incarnation, fb_inc),
                           vinc[diag, diag]) + 1
    incarnation = torch.where(refuting, bumped, incarnation)
    view[diag, diag] = torch.where(refuting, ALIVE, self_belief).to(
        torch.int8)
    vinc[diag, diag] = torch.where(refuting, incarnation, vinc[diag, diag])
    return incarnation.to(torch.int32)


def swim_apply_(view, vinc, since, belief_key, merged, incarnation, up,
                heard_down, fb_inc, t: int) -> torch.Tensor:
    """Cells whose merged key beats the pre-merge key take its belief
    (view, incarnation; a new SUSPECT is stamped with t), in place; then
    each up node that believes itself not ALIVE, or heard it is DOWN
    (``heard_down``), refutes: its incarnation rises past every belief
    it knows of (``fb_inc``, its own cell) and its own cell turns ALIVE.
    Returns the new incarnations.  K15 on the card."""
    if view.device.type == "cpu":
        return swim_apply_plain(view, vinc, since, belief_key, merged,
                                incarnation, up, heard_down, fb_inc, t)
    n = view.shape[0]
    _check_beliefs(view, vinc, since, n)
    check("belief_key", belief_key, torch.int32, (n, n))
    check("merged", merged, torch.int32, (n, n))
    for name, x in (("incarnation", incarnation), ("fb_inc", fb_inc)):
        check(name, x, torch.int32, (n,))
    for name, x in (("up", up), ("heard_down", heard_down)):
        check(name, x, torch.bool, (n,))
    out = incarnation.clone()
    kernels.SWIM_APPLY.launch(
        [view, vinc, since, belief_key, merged, up, heard_down, fb_inc, out],
        [n, t],
    )
    return out


# -- the step ----------------------------------------------------------------


def swim_step(
    state: SimState, cfg: SimConfig, topo: Topology, key: torch.Tensor,
    faults=None,
) -> SimState:
    """One SWIM tick: partial view (`.pswim.pswim_step`), full view here,
    or nothing for ground-truth membership.  The full-view tick updates
    ``view``, ``vinc`` and ``suspect_since`` IN PLACE (the dense round
    owns them) and returns the state with the new incarnations.  Under
    ``faults`` every reach it asks — the direct probe, both relay legs,
    gossip and announce — takes the plan's cuts and probe loss
    (`_reachable`, K9's reach entry)."""
    if cfg.swim_partial_view:
        from .pswim import pswim_step

        return pswim_step(state, cfg, topo, key, faults)
    if not cfg.swim_full_view:
        return state
    n = state.alive.shape[0]
    ks = rng.split(key, 8)
    k_probe, k_ploss, k_relay, k_rloss = ks[0], ks[1], ks[2], ks[3]
    k_gossip, k_gloss, k_ann, k_aloss = ks[4], ks[5], ks[6], ks[7]
    t = int(state.t)
    dev = state.alive.device
    me = torch.arange(n, dtype=torch.int32, device=dev)
    rows = me.long()
    up = state.alive == ALIVE
    view, vinc, since = state.view, state.vinc, state.suspect_since

    # every draw samples the beliefs the round started with: draw the
    # gossip targets too before the probe writes ``view`` in place
    f = cfg.fanout
    g_targets = sample_member_targets(state, cfg, k_gossip, f)

    # -- 1. probe
    target = sample_member_targets(state, cfg, k_probe, 1)[:, 0]
    do_probe = up & (t % cfg.probe_period_rounds == 0) & (target >= 0)
    target = torch.clamp(target, min=0)
    direct = _reachable(state, topo, k_ploss, me, target, faults)
    ip = cfg.indirect_probes
    relays = sample_member_targets(state, cfg, k_relay, ip)
    relay_ok = relays >= 0
    relays = torch.clamp(relays, min=0)
    hop_keys = rng.split(k_rloss, 2)
    leg1 = _reachable(
        state, topo, hop_keys[0], me.repeat_interleave(ip),
        relays.reshape(-1), faults,
    ).reshape(n, ip)
    leg2 = _reachable(
        state, topo, hop_keys[1], relays.reshape(-1),
        target.repeat_interleave(ip), faults,
    ).reshape(n, ip)
    acked = direct | (leg1 & leg2 & relay_ok).any(dim=1)
    probe_failed = do_probe & ~acked & (target != me)
    tl = target.long()
    cur = view[rows, tl]
    newly_suspect = probe_failed & (cur == ALIVE)
    view[rows, tl] = torch.where(newly_suspect, SUSPECT, cur).to(torch.int8)
    since[rows, tl] = torch.where(newly_suspect, t, since[rows, tl])

    # -- 2. suspicion timeout, and the belief keys
    belief_key = swim_timeout_(view, vinc, since, t,
                               cfg.suspect_timeout_rounds)

    # -- 3. gossip edges; receivers ignore senders they believe DOWN
    gsrc = me.repeat_interleave(f)
    gdst = g_targets.reshape(-1)
    g_valid = gdst >= 0
    gdst = torch.clamp(gdst, min=0)
    g_ok = _reachable(state, topo, k_gloss, gsrc, gdst, faults) & g_valid
    g_ok &= view[gdst.long(), gsrc.long()] != DOWN

    # -- 3b. announce, with the receiver's belief fed back
    stagger = (t + me) % cfg.announce_interval_rounds == 0
    ann_target = rng.randint(k_ann, (n,), 0, n)
    ann_ok = (
        stagger & up & (ann_target != me)
        & _reachable(state, topo, k_aloss, me, ann_target, faults)
    )
    self_claim = state.incarnation * 4 + ALIVE
    at = ann_target.long()
    ann_fb = ann_ok & (view[at, rows] == DOWN)
    fb_inc = torch.where(ann_fb, vinc[at, rows], -1)
    merged = swim_merge(
        belief_key, gdst.contiguous(), g_ok, f, ann_target,
        torch.where(ann_ok, self_claim, -1).to(torch.int32),
    )

    # -- 3c + 4. apply, then refute
    incarnation = swim_apply_(
        view, vinc, since, belief_key, merged, state.incarnation, up,
        ann_fb, fb_inc.to(torch.int32), t,
    )
    return state._replace(incarnation=incarnation)
