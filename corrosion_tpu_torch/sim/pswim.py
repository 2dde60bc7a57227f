"""Partial-view SWIM on direct-mapped member tables — the port of
``corrosion_tpu/sim/pswim.py`` (same state machine, same RNG stream).

Two hot functions run hand-written kernels on the card: the member
sampler (`sample_candidates`, K1) and the table merge (`merge_entries`,
K4).  Each wrapper takes the plain torch version, beside it here, for a
CPU tensor and the kernel for a CUDA tensor.  The ``heard`` scatter-max,
the announce feedback and the bucket refill stay plain torch.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import shr
from ..kernels.build import check
from . import rng
from .state import ALIVE, DOWN, SUSPECT, SimConfig, SimState
from .swim import _compact_targets, _dup_before, _reachable
from .topology import Topology, loss_tiered, tiered_reach_lanes_

ID_BITS = 18
ID_CAP = 1 << ID_BITS
INC_CLAMP = 2046
PACK_SHIFT = ID_BITS + 1
PACK_MASK = (1 << PACK_SHIFT) - 1


def _pack_tables(pid: torch.Tensor, pkey: torch.Tensor) -> torch.Tensor:
    """One u32 word per bucket, ``(pkey+1) << PACK_SHIFT | (pid+1)``, in
    its int32 carrier (the top bit is set once pkey+1 >= 4096)."""
    return ((pkey + 1) << PACK_SHIFT) | (pid + 1)


def _unpack_word(w: torch.Tensor):
    pid = (w & PACK_MASK) - 1
    pkey = shr(w, PACK_SHIFT) - 1
    return pid, pkey


# -- K1: member-table sampler ------------------------------------------------


def sample_candidates_plain(
    table: torch.Tensor, slots: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of K1: gather the drawn buckets' packed words, keep
    valid distinct candidates, compact into ``count`` slots."""
    over, n = slots.shape
    m = table.shape[1]
    me = torch.arange(n, dtype=torch.int32, device=table.device)[None, :]
    words = table.reshape(-1)[(me * m + slots).long()]  # [over, N]
    cand, ckey = _unpack_word(words)
    valid = (cand >= 0) & (cand != me) & (ckey % 4 != DOWN) & (ckey >= 0)
    valid &= ~_dup_before(cand, valid)
    return _compact_targets(cand, valid, count)


def sample_candidates(
    table: torch.Tensor, slots: torch.Tensor, count: int
) -> torch.Tensor:
    """i32[N, count] targets from packed tables ``[N, M]`` and bucket
    draws ``[over, N]``; K1 on the card."""
    if table.device.type == "cpu":
        return sample_candidates_plain(table, slots, count)
    n, m = table.shape
    over = slots.shape[0]
    check("table", table, torch.int32, (n, m))
    check("slots", slots, torch.int32, (over, n))
    out = torch.empty((n, count), dtype=torch.int32, device=table.device)
    kernels.SAMPLE_TARGETS.launch([table, slots, out], [n, m, over, count])
    return out


def psample_member_targets(
    state: SimState, cfg: SimConfig, key: torch.Tensor, count: int
) -> torch.Tensor:
    """i32[N, count] targets drawn from each node's member table (believed
    not-DOWN buckets); -1 marks unfilled slots."""
    n, m = state.pid.shape
    slots = rng.randint(key, (4 * count, n), 0, m)
    return sample_candidates(_pack_tables(state.pid, state.pkey), slots, count)


# -- K4: table merge ---------------------------------------------------------


def merge_entries_plain(pid, pkey, psince, e_dst, e_id, e_key, e_ok, t, gc):
    """Plain version of K4 (JAX ``_merge_entries``)."""
    n, m = pid.shape
    old_pkey = pkey
    bucket = torch.where(e_id >= 0, e_id % m, 0).long()
    dst = e_dst.long()
    cur_id = pid[dst, bucket]
    cur_key = pkey[dst, bucket]
    cur_since = psince[dst, bucket]

    match = e_ok & (cur_id == e_id)
    flat = dst * m + bucket
    pkey = pkey.reshape(-1).scatter_reduce(
        0, flat, torch.where(match, e_key, -1), "amax"
    ).reshape(n, m)

    aged_down = (cur_key % 4 == DOWN) & (
        (cur_since < 0) | (t - cur_since >= gc)
    )
    repl_ok = (
        e_ok & ~match & (e_key % 4 == ALIVE) & ((cur_id < 0) | aged_down)
    )
    packed = torch.where(repl_ok, e_key * ID_CAP + e_id, -1)
    winner = torch.full((n * m,), -1, dtype=torch.int32, device=pid.device)
    winner = winner.scatter_reduce(0, flat, packed, "amax").reshape(n, m)
    still_free = (pid < 0) | (pkey % 4 == DOWN)
    do_repl = (winner >= 0) & still_free
    pid = torch.where(do_repl, winner % ID_CAP, pid)
    pkey = torch.where(do_repl, winner // ID_CAP, pkey)
    psince = torch.where(do_repl, -1, psince)

    changed = pkey != old_pkey
    st = pkey % 4
    psince = torch.where(changed & (st != ALIVE), t, psince)
    psince = torch.where(changed & (st == ALIVE), -1, psince)
    return pid, pkey, psince.to(torch.int32)


def merge_entries(pid, pkey, psince, e_dst, e_id, e_key, e_ok, t: int,
                  gc: int):
    """Merge flat gossip/announce entries into the receivers' tables;
    returns new (pid, pkey, psince).  K4 on the card."""
    if pid.device.type == "cpu":
        return merge_entries_plain(
            pid, pkey, psince, e_dst, e_id, e_key, e_ok, t, gc
        )
    n, m = pid.shape
    e = e_dst.shape[0]
    for name, x in (("pid", pid), ("pkey", pkey), ("psince", psince)):
        check(name, x, torch.int32, (n, m))
    for name, x in (("e_dst", e_dst), ("e_id", e_id), ("e_key", e_key)):
        check(name, x, torch.int32, (e,))
    check("e_ok", e_ok, torch.bool, (e,))
    pkey_out = pkey.clone()
    pid_out = torch.empty_like(pid)
    psince_out = torch.empty_like(psince)
    winner = torch.full_like(pid, -1)
    kernels.MERGE_ENTRIES.launch(
        [pid, pkey, psince, pid_out, pkey_out, psince_out, winner,
         e_dst, e_id, e_key, e_ok],
        [e, n, m, t, gc],
    )
    return pid_out, pkey_out, psince_out


# -- the step ----------------------------------------------------------------


def pswim_step(
    state: SimState, cfg: SimConfig, topo: Topology, key: torch.Tensor,
    faults=None,
) -> SimState:
    """One partial-view SWIM tick: probe, suspicion timeout, gossip and
    announce merge, bucket refill, refute (JAX ``pswim_step``).  Under
    ``faults`` every probe, relay leg, gossip and announce message
    passes the plan's cuts and loss in `_reachable`, each with its own
    loss key of the split."""
    n, m = state.pid.shape
    k = cfg.gossip_entries
    ks = rng.split(key, 11)
    k_probe, k_ploss, k_relay, k_rloss = ks[0], ks[1], ks[2], ks[3]
    k_gossip, k_pick, k_gloss, k_ann = ks[4], ks[5], ks[6], ks[7]
    k_aloss, k_rot, k_rid = ks[8], ks[9], ks[10]
    dev = state.pid.device
    t = int(state.t)
    me = torch.arange(n, dtype=torch.int32, device=dev)
    up = state.alive == ALIVE
    pid, pkey, psince = state.pid, state.pkey, state.psince

    # -- 1. probe
    target = psample_member_targets(state, cfg, k_probe, 1)[:, 0]
    do_probe = up & (t % cfg.probe_period_rounds == 0) & (target >= 0)
    target = torch.clamp(target, min=0)
    direct = _reachable(state, topo, k_ploss, me, target, faults)
    ip = cfg.indirect_probes
    relays = psample_member_targets(state, cfg, k_relay, ip)
    relay_ok = relays >= 0
    relays = torch.clamp(relays, min=0)
    # split is pure: skipping it when no loss draws uses the keys moves
    # no other draw
    draws = faults is not None or topo.loss > 0 or loss_tiered(topo)
    hop_keys = rng.split(k_rloss, 2) if draws else (k_rloss, k_rloss)
    leg1 = _reachable(
        state, topo, hop_keys[0], me.repeat_interleave(ip),
        relays.reshape(-1), faults,
    ).reshape(n, ip)
    leg2 = _reachable(
        state, topo, hop_keys[1], relays.reshape(-1),
        target.repeat_interleave(ip), faults,
    ).reshape(n, ip)
    acked = direct | (leg1 & leg2 & relay_ok).any(dim=1)
    probe_failed = do_probe & ~acked

    rows = me.long()
    t_bucket = (target % m).long()
    cur = pkey[rows, t_bucket]
    newly_suspect = (
        probe_failed & (pid[rows, t_bucket] == target) & (cur % 4 == ALIVE)
    )
    pkey = pkey.clone()
    psince = psince.clone()
    pkey[rows, t_bucket] = torch.where(newly_suspect, cur - ALIVE + SUSPECT, cur)
    psince[rows, t_bucket] = torch.where(
        newly_suspect, t, psince[rows, t_bucket]
    )

    # -- 2. suspicion timeout
    expired = (
        (pkey >= 0)
        & (pkey % 4 == SUSPECT)
        & (psince >= 0)
        & (t - psince >= cfg.suspect_timeout_rounds)
    )
    pkey = torch.where(expired, pkey - SUSPECT + DOWN, pkey)
    psince = torch.where(expired, t, psince)

    # -- 3. gossip + announce entries
    f = cfg.fanout
    g_targets = psample_member_targets(state, cfg, k_gossip, f)  # [N, F]
    gsrc = me.repeat_interleave(f)
    gdst = g_targets.reshape(-1)
    g_valid = gdst >= 0
    gdst = torch.clamp(gdst, min=0)
    g_ok = _reachable(state, topo, k_gloss, gsrc, gdst, faults) & g_valid
    ptbl = _pack_tables(pid, pkey)
    snd_id, snd_key = _unpack_word(ptbl[gdst.long(), (gsrc % m).long()])
    g_ok &= ~((snd_id == gsrc) & (snd_key % 4 == DOWN))

    picks = rng.randint(k_pick, (n, k), 0, m)
    sel_id, sel_key = _unpack_word(torch.gather(ptbl, 1, picks.long()))
    self_claim = torch.clamp(state.incarnation, max=INC_CLAMP) * 4 + ALIVE
    ent_id = torch.cat([sel_id, me[:, None]], dim=1)  # [N, k+1]
    ent_key = torch.cat([sel_key, self_claim[:, None]], dim=1)
    e_dst = gdst.reshape(n, f, 1).expand(n, f, k + 1).reshape(-1)
    e_id = ent_id[:, None, :].expand(n, f, k + 1).reshape(-1)
    e_key = ent_key[:, None, :].expand(n, f, k + 1).reshape(-1)
    e_ok = (
        g_ok.reshape(n, f, 1).expand(n, f, k + 1).reshape(-1)
        & (e_id >= 0)
        & (e_key >= 0)
    )
    # an entry about the receiver is a refutation trigger
    self_hit = e_ok & (e_id == e_dst) & (e_key % 4 != ALIVE)
    heard = torch.full((n,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, e_dst.long(), torch.where(self_hit, e_key, -1), "amax"
    )
    heard_suspect = heard >= 0
    heard_inc = torch.where(heard_suspect, heard // 4, -1)
    e_ok &= e_id != e_dst

    stagger = (t + me) % cfg.announce_interval_rounds == 0
    ann_target = rng.randint(k_ann, (n,), 0, n)
    ann_ok = (
        stagger & up & (ann_target != me)
        & _reachable(state, topo, k_aloss, me, ann_target, faults)
    )
    all_dst = torch.cat([e_dst, ann_target])
    all_id = torch.cat([e_id, me])
    all_ok = torch.cat([e_ok, ann_ok])

    tgt_id, tgt_key = _unpack_word(ptbl[ann_target.long(), (me % m).long()])
    ann_fb = ann_ok & (tgt_id == me) & (tgt_key % 4 != ALIVE)
    fb_inc = torch.where(ann_fb, tgt_key // 4, -1)
    refuted_claim = (
        torch.clamp(torch.maximum(self_claim // 4, fb_inc) + 1, max=INC_CLAMP)
        * 4 + ALIVE
    )
    all_key = torch.cat(
        [e_key, torch.where(ann_fb, refuted_claim, self_claim)]
    )

    pid, pkey, psince = merge_entries(
        pid, pkey, psince, all_dst.contiguous(), all_id.contiguous(),
        all_key.contiguous(), all_ok.contiguous(), t, cfg.down_gc_rounds,
    )

    # -- 3c. bucket refill
    rb = rng.randint(k_rot, (n,), 0, m)
    rbl = rb.long()
    cur_rb_key = pkey[rows, rbl]
    cur_rb_since = psince[rows, rbl]
    rb_aged_down = (cur_rb_key % 4 == DOWN) & (
        (cur_rb_since < 0) | (t - cur_rb_since >= cfg.down_gc_rounds)
    )
    per = (n + m - 1) // m
    rid = rb + m * rng.randint(k_rid, (n,), 0, per)
    refill = (
        stagger & up & ((pid[rows, rbl] < 0) | rb_aged_down)
        & (rid < n) & (rid != me)
    )
    pid[rows, rbl] = torch.where(refill, rid, pid[rows, rbl])
    pkey[rows, rbl] = torch.where(refill, ALIVE, pkey[rows, rbl])
    psince[rows, rbl] = torch.where(refill, -1, psince[rows, rbl])

    # -- 4. refute
    refuting = (ann_fb | heard_suspect) & up
    bumped = torch.clamp(
        torch.maximum(torch.maximum(state.incarnation, fb_inc), heard_inc) + 1,
        max=INC_CLAMP,
    )
    incarnation = torch.where(refuting, bumped, state.incarnation)
    return state._replace(
        pid=pid, pkey=pkey, psince=psince,
        incarnation=incarnation.to(torch.int32),
    )


# -- the lane path (seed ensembles, B16) -------------------------------------


def sample_candidates_lanes_plain(table: torch.Tensor, slots: torch.Tensor,
                                  count: int) -> torch.Tensor:
    """Plain version of K1's lane entry: the solo plain version per lane,
    the lanes folded into its column axis (every step is per column)."""
    lanes, n, _ = table.shape
    over = slots.shape[1]
    words = torch.gather(table, 2, slots.transpose(1, 2).long())
    cand, ckey = _unpack_word(words.transpose(1, 2))  # [K, over, N]
    me = torch.arange(n, dtype=torch.int32, device=table.device)
    valid = (cand >= 0) & (cand != me) & (ckey % 4 != DOWN) & (ckey >= 0)
    cand = cand.transpose(0, 1).reshape(over, lanes * n)
    valid = valid.transpose(0, 1).reshape(over, lanes * n)
    valid &= ~_dup_before(cand, valid)
    return _compact_targets(cand, valid, count).reshape(lanes, n, count)


def sample_candidates_lanes(table: torch.Tensor, slots: torch.Tensor,
                            count: int) -> torch.Tensor:
    """`sample_candidates` over the lanes: i32[K, N, count] lane-local
    targets from packed tables [K, N, M] and bucket draws [K, over, N];
    K1's lane entry on the card."""
    if table.device.type == "cpu":
        return sample_candidates_lanes_plain(table, slots, count)
    lanes, n, m = table.shape
    over = slots.shape[1]
    check("table", table, torch.int32, (lanes, n, m))
    check("slots", slots, torch.int32, (lanes, over, n))
    out = torch.empty((lanes, n, count), dtype=torch.int32,
                      device=table.device)
    kernels.SAMPLE_TARGETS_LANES.launch([table, slots, out],
                                        [n, m, over, count, lanes])
    return out


def psample_member_targets_lanes(state: SimState, cfg: SimConfig,
                                 keys: torch.Tensor,
                                 count: int) -> torch.Tensor:
    """`psample_member_targets` over the lanes: the [K, 4c, N] bucket
    draws (K5's lane entry) and K1's lane entry."""
    _, n, m = state.pid.shape
    slots = rng.randint_lanes(keys, (4 * count, n), 0, m)
    return sample_candidates_lanes(_pack_tables(state.pid, state.pkey),
                                   slots, count)


def _fold_merge(pid, pkey, psince, e_dst, e_id, e_key, e_ok):
    """The lanes folded into the merge's rows: tables [K * N, M], lane
    k's receivers at rows k * N + dst."""
    lanes, n, m = pid.shape
    dst = (e_dst + (torch.arange(lanes, dtype=torch.int32,
                                 device=pid.device) * n)[:, None]).reshape(-1)
    flat = [x.reshape(lanes * n, m) for x in (pid, pkey, psince)]
    return flat, (dst, e_id.reshape(-1), e_key.reshape(-1), e_ok.reshape(-1))


def merge_entries_lanes_plain(pid, pkey, psince, e_dst, e_id, e_key, e_ok,
                              t: int, gc: int):
    """Plain version of K4's lane entry: the solo plain merge on the
    folded rows."""
    lanes, n, m = pid.shape
    flat, args = _fold_merge(pid, pkey, psince, e_dst, e_id, e_key, e_ok)
    out = merge_entries_plain(*flat, *args, t, gc)
    return tuple(x.reshape(lanes, n, m) for x in out)


def merge_entries_lanes(pid, pkey, psince, e_dst, e_id, e_key, e_ok, t: int,
                        gc: int):
    """`merge_entries` over the lanes: tables [K, N, M], entries [K, E]
    with lane-local receivers and ids.  The merge is per receiver row, so
    the lanes fold into its rows: lane k's receivers move to rows k·N +
    dst, their ids stay lane-local (a bucket and a match read only ids of
    one lane).  K4's launcher on the card, counted as its lane entry."""
    if pid.device.type == "cpu":
        return merge_entries_lanes_plain(pid, pkey, psince, e_dst, e_id,
                                         e_key, e_ok, t, gc)
    lanes, n, m = pid.shape
    flat, args = _fold_merge(pid, pkey, psince, e_dst, e_id, e_key, e_ok)
    e = args[0].shape[0]
    for name, x in zip(("e_id", "e_key"), args[1:3]):
        check(name, x, torch.int32, (e,))
    check("e_ok", args[3], torch.bool, (e,))
    pkey_out = flat[1].clone()
    pid_out = torch.empty_like(flat[0])
    psince_out = torch.empty_like(flat[2])
    winner = torch.full_like(flat[0], -1)
    kernels.MERGE_ENTRIES_LANES.launch(
        [flat[0], flat[1], flat[2], pid_out, pkey_out, psince_out, winner,
         *args],
        [e, lanes * n, m, t, gc],
    )
    return tuple(x.reshape(lanes, n, m)
                 for x in (pid_out, pkey_out, psince_out))


def _lane_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[k, idx[k, e]] for x [K, N] and lane-local idx [K, E]."""
    return torch.gather(x, 1, idx.long())


def _cells(x: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor) -> torch.Tensor:
    """x[k, rows[k, e], cols[k, e]] for tables x [K, N, M]."""
    lanes, n, m = x.shape
    return torch.gather(x.reshape(lanes, n * m), 1,
                        (rows.long() * m + cols.long()))


def reachable_lanes(state: SimState, topo: Topology, keys: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor, faults=None,
                    seeds=None) -> torch.Tensor:
    """`swim._reachable` over the lanes, for bool [K, E] edges: same
    group, both ends up, not lost to the topology — under tiered loss to
    lane k's aligned u8 draw of ``fold_in(keys[k], 104)`` against each
    edge's tier (K20's reach lane entry), on a flat lossy topology to
    ``bernoulli(keys[k], loss, [E])`` (JAX's legacy flat branch, K5's
    lane entry) — and (under ``faults``) not cut nor lost to lane k's
    probe-loss draw under its key and plan seed (K9's reach lane
    entry)."""
    lanes = state.alive.shape[0]
    src = src.expand(lanes, -1).contiguous()
    dst = dst.expand(lanes, -1).contiguous()
    ok = ((_lane_rows(state.group, src) == _lane_rows(state.group, dst))
          & (_lane_rows(state.alive, src) == ALIVE)
          & (_lane_rows(state.alive, dst) == ALIVE))
    if loss_tiered(topo):
        ok = tiered_reach_lanes_(ok, topo, state.alive.shape[1], keys, src,
                                 dst)
    elif topo.loss > 0:
        ok &= ~rng.bernoulli_lanes(keys, topo.loss, (src.shape[1],))
    if faults is not None:
        from .faults import fault_reach_lanes_

        ok = fault_reach_lanes_(ok, faults, keys, src, dst, seeds)
    return ok


def pswim_step_lanes(state: SimState, cfg: SimConfig, topo: Topology,
                     keys: torch.Tensor, faults=None,
                     seeds=None) -> SimState:
    """`pswim_step` over the seed ensemble's lanes: ``state`` holds every
    per-node tensor with a leading lane axis [K, ...] (``t`` shared),
    ``keys`` [K, 2] the lanes' SWIM keys and ``seeds`` i32[K] their plan
    seeds.  The same phases, draws and merges as the solo step, lane k's
    under key k: every draw is K5's lane entry, the sampler K1's, the
    merge K4's and the fault reach K9's; the glue is batched torch."""
    lanes, n, m = state.pid.shape
    kk = cfg.gossip_entries
    ks = rng.split_lanes(keys, 11)
    k_probe, k_ploss, k_relay, k_rloss = (ks[:, i].contiguous()
                                          for i in range(4))
    k_gossip, k_pick, k_gloss, k_ann = (ks[:, i].contiguous()
                                        for i in range(4, 8))
    k_aloss, k_rot, k_rid = (ks[:, i].contiguous() for i in range(8, 11))
    dev = state.pid.device
    t = int(state.t)
    me = torch.arange(n, dtype=torch.int32, device=dev)
    up = state.alive == ALIVE
    pid, pkey, psince = state.pid, state.pkey, state.psince

    # -- 1. probe
    target = psample_member_targets_lanes(state, cfg, k_probe, 1)[:, :, 0]
    do_probe = up & (t % cfg.probe_period_rounds == 0) & (target >= 0)
    target = torch.clamp(target, min=0)
    direct = reachable_lanes(state, topo, k_ploss, me[None], target, faults,
                             seeds)
    ip = cfg.indirect_probes
    relays = psample_member_targets_lanes(state, cfg, k_relay, ip)
    relay_ok = relays >= 0
    relays = torch.clamp(relays, min=0).reshape(lanes, n * ip)
    # split is pure: skipping it when no loss draws uses the keys moves
    # no draw (the solo step's rule)
    if faults is not None or topo.loss > 0 or loss_tiered(topo):
        hop = rng.split_lanes(k_rloss, 2)
        hop_keys = (hop[:, 0].contiguous(), hop[:, 1].contiguous())
    else:
        hop_keys = (k_rloss, k_rloss)
    leg1 = reachable_lanes(state, topo, hop_keys[0],
                           me.repeat_interleave(ip)[None], relays, faults,
                           seeds).reshape(lanes, n, ip)
    leg2 = reachable_lanes(state, topo, hop_keys[1], relays,
                           target.repeat_interleave(ip, dim=1), faults,
                           seeds).reshape(lanes, n, ip)
    acked = direct | (leg1 & leg2 & relay_ok).any(dim=2)
    probe_failed = do_probe & ~acked

    t_bucket = (target % m).long()[..., None]
    cur = torch.gather(pkey, 2, t_bucket)[..., 0]
    cur_id = torch.gather(pid, 2, t_bucket)[..., 0]
    newly_suspect = probe_failed & (cur_id == target) & (cur % 4 == ALIVE)
    pkey = pkey.clone()
    psince = psince.clone()
    since_t = torch.gather(psince, 2, t_bucket)[..., 0]
    pkey.scatter_(2, t_bucket, torch.where(
        newly_suspect, cur - ALIVE + SUSPECT, cur)[..., None])
    psince.scatter_(2, t_bucket, torch.where(
        newly_suspect, t, since_t).to(torch.int32)[..., None])

    # -- 2. suspicion timeout
    expired = (
        (pkey >= 0)
        & (pkey % 4 == SUSPECT)
        & (psince >= 0)
        & (t - psince >= cfg.suspect_timeout_rounds)
    )
    pkey = torch.where(expired, pkey - SUSPECT + DOWN, pkey)
    psince = torch.where(expired, t, psince).to(torch.int32)

    # -- 3. gossip + announce entries
    f = cfg.fanout
    g_targets = psample_member_targets_lanes(state, cfg, k_gossip, f)
    gsrc = me.repeat_interleave(f)[None].expand(lanes, -1)
    gdst = g_targets.reshape(lanes, n * f)
    g_valid = gdst >= 0
    gdst = torch.clamp(gdst, min=0)
    g_ok = reachable_lanes(state, topo, k_gloss, gsrc, gdst, faults,
                           seeds) & g_valid
    ptbl = _pack_tables(pid, pkey)
    snd_id, snd_key = _unpack_word(_cells(ptbl, gdst, gsrc % m))
    g_ok &= ~((snd_id == gsrc) & (snd_key % 4 == DOWN))

    picks = rng.randint_lanes(k_pick, (n, kk), 0, m)
    sel_id, sel_key = _unpack_word(torch.gather(ptbl, 2, picks.long()))
    self_claim = torch.clamp(state.incarnation, max=INC_CLAMP) * 4 + ALIVE
    ent_id = torch.cat([sel_id, me[None, :, None].expand(lanes, n, 1)],
                       dim=2)
    ent_key = torch.cat([sel_key, self_claim[..., None]], dim=2)
    e_dst = gdst.reshape(lanes, n, f, 1).expand(
        lanes, n, f, kk + 1).reshape(lanes, -1)
    e_id = ent_id[:, :, None, :].expand(lanes, n, f, kk + 1).reshape(
        lanes, -1)
    e_key = ent_key[:, :, None, :].expand(lanes, n, f, kk + 1).reshape(
        lanes, -1)
    e_ok = (
        g_ok.reshape(lanes, n, f, 1).expand(lanes, n, f, kk + 1).reshape(
            lanes, -1)
        & (e_id >= 0)
        & (e_key >= 0)
    )
    self_hit = e_ok & (e_id == e_dst) & (e_key % 4 != ALIVE)
    heard = torch.full((lanes, n), -1, dtype=torch.int32,
                       device=dev).scatter_reduce(
        1, e_dst.long(), torch.where(self_hit, e_key, -1), "amax")
    heard_suspect = heard >= 0
    heard_inc = torch.where(heard_suspect, heard // 4, -1)
    e_ok &= e_id != e_dst

    stagger = (t + me) % cfg.announce_interval_rounds == 0
    ann_target = rng.randint_lanes(k_ann, (n,), 0, n)
    ann_ok = (
        stagger & up & (ann_target != me)
        & reachable_lanes(state, topo, k_aloss, me[None], ann_target,
                          faults, seeds)
    )
    all_dst = torch.cat([e_dst, ann_target], dim=1)
    all_id = torch.cat([e_id, me[None].expand(lanes, n)], dim=1)
    all_ok = torch.cat([e_ok, ann_ok], dim=1)

    tgt_id, tgt_key = _unpack_word(_cells(ptbl, ann_target,
                                          (me % m)[None].expand(lanes, n)))
    ann_fb = ann_ok & (tgt_id == me) & (tgt_key % 4 != ALIVE)
    fb_inc = torch.where(ann_fb, tgt_key // 4, -1)
    refuted_claim = (
        torch.clamp(torch.maximum(self_claim // 4, fb_inc) + 1, max=INC_CLAMP)
        * 4 + ALIVE
    )
    all_key = torch.cat(
        [e_key, torch.where(ann_fb, refuted_claim, self_claim)], dim=1)

    pid, pkey, psince = merge_entries_lanes(
        pid, pkey, psince, all_dst.contiguous(), all_id.contiguous(),
        all_key.to(torch.int32).contiguous(), all_ok.contiguous(), t,
        cfg.down_gc_rounds,
    )

    # -- 3c. bucket refill
    rb = rng.randint_lanes(k_rot, (n,), 0, m)
    rbl = rb.long()[..., None]
    cur_rb_id = torch.gather(pid, 2, rbl)[..., 0]
    cur_rb_key = torch.gather(pkey, 2, rbl)[..., 0]
    cur_rb_since = torch.gather(psince, 2, rbl)[..., 0]
    rb_aged_down = (cur_rb_key % 4 == DOWN) & (
        (cur_rb_since < 0) | (t - cur_rb_since >= cfg.down_gc_rounds)
    )
    per = (n + m - 1) // m
    rid = rb + m * rng.randint_lanes(k_rid, (n,), 0, per)
    refill = (
        stagger & up & ((cur_rb_id < 0) | rb_aged_down)
        & (rid < n) & (rid != me)
    )
    pid.scatter_(2, rbl, torch.where(refill, rid, cur_rb_id)[..., None])
    pkey.scatter_(2, rbl, torch.where(refill, ALIVE, cur_rb_key).to(
        torch.int32)[..., None])
    psince.scatter_(2, rbl, torch.where(refill, -1, cur_rb_since).to(
        torch.int32)[..., None])

    # -- 4. refute
    refuting = (ann_fb | heard_suspect) & up
    bumped = torch.clamp(
        torch.maximum(torch.maximum(state.incarnation, fb_inc), heard_inc) + 1,
        max=INC_CLAMP,
    )
    incarnation = torch.where(refuting, bumped, state.incarnation)
    return state._replace(
        pid=pid, pkey=pkey, psince=psince,
        incarnation=incarnation.to(torch.int32),
    )
