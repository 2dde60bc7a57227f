"""The dense broadcast phases — the port of
``corrosion_tpu/sim/broadcast.py`` (``broadcast_step`` with its wire
telemetry, its push-pull leg and the fan-out schedule, ``deliver_step``
with the FIFO gate, ``inject_step``), with its fault branch, on JAX's
u8 state: ``have``, ``relay_left`` ``[N, P]``, ``injected [P]`` and
the delay rings ``inflight``, ``sync_inflight`` ``[D, N, P]``.

Each phase is one launch of K12 (``kernels/csrc/dense_phases.cu``) on the
card and the plain torch version beside its wrapper on the CPU:

- `inject_dense` — origin nodes take round t's payloads;
- `broadcast_send` — the eligible mask, the oldest-first byte budget,
  the wire loss per (edge, payload) (flat, or per-edge tier thresholds
  in its tiered instantiation), the ring write and the relay spend;
  under a fault plan its fault entry also draws the plan's loss and
  jitter per (edge, payload);
- `pull_send` — push-pull's response leg (K12p, before the push's
  spend);
- `deliver_dense` — pop slot t of both rings (K12f-o behind the FIFO
  admit gate).

The target draw, ring0 tiering (`ring0_targets`, shared with the packed
round) and the edge list stay torch (and K1, K5).

**In place.**  The phases update the state's tensors in place, plain
versions too: the dense round owns them (`.round.own_state`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..device import i32
from ..kernels.build import check
from . import rng
from .state import (
    ALIVE,
    DOWN,
    PayloadMeta,
    SimConfig,
    SimState,
    budget_prefix_mask,
)
from ..proto.ordering import order_enforced
from ..proto.schedule import capped_schedule
from .faults import JITTER_TAG, WIRE_LOSS_TAG, fault_key, fault_wire_effects
from .fused import dense_send_stats
from .swim import sample_member_targets
from .telemetry import (
    WIRE,
    RoundTrace,
    acc_slot,
    wire_loss_active,
    wire_rows_,
    wire_rows_pull_,
)
from .topology import (
    Topology,
    aligned_u8_bits,
    edge_alive,
    edge_slot,
    loss_threshold,
    regions,
    tiered_edge_drop,
    topo_table,
    wire_tiers,
)

_I32_MAX = (1 << 31) - 1


def ring0_targets(
    state: SimState, cfg: SimConfig, topo: Topology, region: torch.Tensor,
    key: torch.Tensor, targets: torch.Tensor,
) -> torch.Tensor:
    """Ring0-first tiering (JAX ``broadcast_step``, ``:67-97``): with
    more than one region, fanout slot 0 targets a uniformly drawn member
    of the sender's own region when the sender believes it a live member
    (full view: not DOWN; partial view: in its table and not DOWN).  The
    draw spans ``[0, 2^31 - 1)``, past 2^16, so it takes randint's u32
    wrap."""
    if not (cfg.ring0_first and topo.n_regions > 1):
        return targets
    n = targets.shape[0]
    dev = targets.device
    me = torch.arange(n, dtype=torch.int32, device=dev)
    per = max(1, n // topo.n_regions)
    start = region * per
    size = torch.where(region == topo.n_regions - 1, n - start, per)
    local = start + rng.randint(key, (n,), 0, _I32_MAX) % torch.clamp(
        size, min=1
    )
    ok_local = local != me
    rows, cols = me.long(), local.long()
    if cfg.couple_membership and cfg.swim_full_view:
        ok_local &= state.view[rows, cols] != DOWN
    elif cfg.couple_membership and cfg.swim_partial_view:
        bucket = (local % state.pid.shape[1]).long()
        known = state.pid[rows, bucket] == local
        ok_local &= known & (state.pkey[rows, bucket] % 4 != DOWN)
    targets = targets.clone()
    targets[:, 0] = torch.where(ok_local, local, targets[:, 0])
    return targets


def ring0_targets_lanes(
    state: SimState, cfg: SimConfig, topo: Topology, region: torch.Tensor,
    keys: torch.Tensor, targets: torch.Tensor,
) -> torch.Tensor:
    """`ring0_targets` over the lanes (B16t): targets i32[K, N, F], each
    lane's slot-0 candidate drawn under its own ``keys[k]`` (its
    ``k_ring0``; K5's lane entry, with randint's u32 wrap) and checked
    against that lane's beliefs; the regions are shared."""
    if not (cfg.ring0_first and topo.n_regions > 1):
        return targets
    lanes, n, _ = targets.shape
    dev = targets.device
    me = torch.arange(n, dtype=torch.int32, device=dev)
    per = max(1, n // topo.n_regions)
    start = region * per
    size = torch.where(region == topo.n_regions - 1, n - start, per)
    local = start + rng.randint_lanes(keys, (n,), 0, _I32_MAX) % torch.clamp(
        size, min=1)
    ok_local = local != me
    if cfg.couple_membership and cfg.swim_full_view:
        cell = me.long() * n + local.long()
        ok_local &= torch.gather(state.view.reshape(lanes, n * n), 1,
                                 cell) != DOWN
    elif cfg.couple_membership and cfg.swim_partial_view:
        m = state.pid.shape[2]
        bucket = (local % m).long()[..., None]
        known = torch.gather(state.pid, 2, bucket)[..., 0] == local
        ok_local &= known & (torch.gather(state.pkey, 2, bucket)[..., 0] % 4
                             != DOWN)
    targets = targets.clone()
    targets[:, :, 0] = torch.where(ok_local, local, targets[:, :, 0])
    return targets


# -- K12: inject -------------------------------------------------------------


def inject_dense_plain(have, relay, injected, meta: PayloadMeta, alive,
                       t: int, max_tx: int) -> None:
    """Plain version of K12's inject, in place."""
    injecting = (meta.round == t) & (alive[meta.actor.long()] == ALIVE)
    p = injected.shape[0]
    cols = torch.arange(p, device=have.device)
    rows = meta.actor.long()
    own = torch.zeros_like(have)
    own[rows, cols] = injecting.to(torch.uint8)
    newly = (own > 0) & (have == 0)
    have.copy_(torch.maximum(have, own))
    relay.copy_(torch.where(newly, max_tx, relay).to(torch.uint8))
    injected.copy_(torch.maximum(injected, injecting.to(torch.uint8)))


def inject_dense(have, relay, injected, meta: PayloadMeta, alive, t: int,
                 max_tx: int) -> None:
    """Origin nodes that are up take round t's payloads: ``have`` set,
    the relay budget armed to ``max_tx`` where new, ``injected`` set; in
    place.  K12 on the card."""
    if have.device.type == "cpu":
        inject_dense_plain(have, relay, injected, meta, alive, t, max_tx)
        return
    n, p = have.shape
    _check_rows(have, relay, n, p)
    check("injected", injected, torch.uint8, (p,))
    check("meta.round", meta.round, torch.int32, (p,))
    check("meta.actor", meta.actor, torch.int32, (p,))
    check("alive", alive, torch.uint8, (n,))
    kernels.DENSE_INJECT.launch(
        [meta.round, meta.actor, alive, have, relay, injected],
        [n, p, t, max_tx],
    )


def _check_rows(have, relay, n: int, p: int) -> None:
    check("have", have, torch.uint8, (n, p))
    check("relay_left", relay, torch.uint8, (n, p))


# -- K12: broadcast ----------------------------------------------------------


def broadcast_send_plain(have, relay, injected, nbytes, budget, targets, dst,
                         slot, ok, alive, key, thr: int, ring, row_frames=None,
                         row_bytes=None, dropped=None, phase_key=None,
                         fthr=None, jit=None, seed: int = 0,
                         tiers: Optional[Topology] = None) -> None:
    """Plain version of K12's broadcast, of its fault entry and of its
    tiered instantiation, in place on ``relay`` and ``ring`` (and the
    telemetry outputs when given)."""
    n, p = have.shape
    f = targets.shape[1]
    d = ring.shape[0]
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    sending = budget_prefix_mask(eligible, budget, nbytes)
    if tiers is not None:
        src = torch.arange(n, dtype=torch.int32,
                           device=have.device).repeat_interleave(f)
        region = regions(n, tiers.n_regions, have.device)
        drop = tiered_edge_drop(tiers, key, region, src, dst,
                                (n * f, p))
    elif thr <= 0:
        drop = torch.zeros((n * f, p), dtype=torch.bool, device=have.device)
    elif thr >= 256:
        drop = torch.ones((n * f, p), dtype=torch.bool, device=have.device)
    else:
        drop = aligned_u8_bits(key, (n * f, p)) < thr
    if fthr is not None:
        fbits = aligned_u8_bits(
            fault_key(phase_key, seed, WIRE_LOSS_TAG), (n * f, p))
        drop |= fbits < fthr[:, None]
    sent = torch.where(
        ok.reshape(n, f, 1) & ~drop.reshape(n, f, p), sending[:, None, :],
        False,
    ).to(torch.uint8).reshape(n * f, p)
    if jit is None:
        rows = (slot.long() * n + dst.long())[:, None].expand(-1, p)
        ring.view(d * n, p).scatter_reduce_(0, rows, sent, "amax")
    else:
        cells = torch.arange(n * f * p, dtype=torch.int64,
                             device=have.device).reshape(n * f, p)
        draw = rng.randint_at_plain(
            fault_key(phase_key, seed, JITTER_TAG), cells, 0, _I32_MAX)
        j = torch.where(jit[:, None] > 0, draw % (jit[:, None] + 1), 0)
        slot_ep = (slot[:, None] + j) % d
        flat = (slot_ep.long() * n + dst.long()[:, None]) * p + torch.arange(
            p, device=have.device)
        ring.view(-1).scatter_reduce_(0, flat.reshape(-1), sent.reshape(-1),
                                      "amax")
    if row_frames is not None:
        frames, byte_tot = dense_send_stats(sending, nbytes)
        row_frames.copy_(frames)
        row_bytes.copy_(byte_tot)
    if dropped is not None:
        dropped += (ok.reshape(n, f, 1) & drop.reshape(n, f, p)
                    & sending[:, None, :]).sum()
    me = torch.arange(n, dtype=torch.int32, device=have.device)
    attempted = (targets >= 0) & (targets != me[:, None])
    any_attempt = attempted.any(dim=1) & (alive == ALIVE)
    relay.sub_((sending & any_attempt[:, None]).to(torch.uint8))


def broadcast_send(have, relay, injected, nbytes, budget: Optional[int],
                   targets, dst, slot, ok, alive, key, thr: int,
                   ring, row_frames=None, row_bytes=None,
                   dropped=None, phase_key=None, fthr=None, jit=None,
                   seed: int = 0, tiers: Optional[Topology] = None) -> None:
    """The broadcast's sends, in place: each node's eligible payloads
    (held, relay budget left, injected), cut to the oldest-first prefix
    within ``budget`` bytes (None: unmetered), go to each ok edge's ring
    row ``ring[slot[e], dst[e]]`` unless lost — payload q of edge e is
    lost where byte e*P + q of ``aligned_u8_bits(key, [E, P])`` is below
    ``thr`` (0: no loss, ≥ 256: all lost) — and where an up node
    attempted a send (a target neither -1 nor itself) its relay budget
    drops by one at every sent payload.  The flight recorder's outputs,
    when given: each node's sent frames and bytes i32[N] (``row_frames``,
    ``row_bytes``) and the frames lost on ok edges, added to the int64
    accumulator ``dropped``.

    Under a fault plan (JAX ``fault_wire_effects``' per-(edge, payload)
    half, K12's fault entry): with ``fthr`` (u8[E], K9's thresholds) the
    payload is also lost where byte e*P + q of ``aligned_u8_bits(
    fold_in(fold_in(phase_key, seed), 101), [E, P])`` is below fthr[e];
    with ``jit`` (i32[E], K9's jitter bounds) a payload of an edge with
    jit[e] > 0 lands in slot (slot[e] + j) % D, j = element e*P + q of
    ``randint(fold_in(fold_in(phase_key, seed), 102), [E, P], 0,
    2^31 - 1)`` mod (jit[e] + 1).  ``phase_key`` is the broadcast phase
    key (not ``key``, its ``k_drop`` split).

    Under tiered topology loss (``tiers``, the topology,
    `topology.wire_tiers`; ``thr``
    is then 0) the topology stream compares the same ``key`` draw against
    each edge's tier threshold, and a tier at certainty (256 or more)
    loses every payload of its edges (JAX ``tiered_edge_drop`` via
    ``edge_payload_drop``): K12's tiered instantiation, with or without
    the fault draws.  K12 on the card, which draws the bits itself."""
    fault = fthr is not None or jit is not None
    if have.device.type == "cpu":
        broadcast_send_plain(have, relay, injected, nbytes, budget, targets,
                             dst, slot, ok, alive, key, thr, ring, row_frames,
                             row_bytes, dropped, phase_key, fthr, jit, seed,
                             tiers)
        return
    n, p = have.shape
    f = targets.shape[1]
    e = n * f
    d = ring.shape[0]
    _check_rows(have, relay, n, p)
    check("injected", injected, torch.uint8, (p,))
    check("nbytes", nbytes, torch.int32, (p,))
    check("targets", targets, torch.int32, (n, f))
    check("dst", dst, torch.int32, (e,))
    check("slot", slot, torch.int32, (e,))
    check("ok", ok, torch.bool, (e,))
    check("alive", alive, torch.uint8, (n,))
    check("key", key, torch.int64, (2,))
    check("ring", ring, torch.uint8, (d, n, p))
    if row_frames is not None:
        check("row_frames", row_frames, torch.int32, (n,))
        check("row_bytes", row_bytes, torch.int32, (n,))
    if dropped is not None:
        check("dropped", dropped, torch.int64, ())
    ptrs = [have, relay, injected, nbytes, targets, dst, slot, ok, alive, key,
            ring, row_frames, row_bytes, dropped]
    ints = [n, p, f, d, -1 if budget is None else budget, min(thr, 256)]
    if not fault and tiers is None:
        kernels.DENSE_BROADCAST.launch(ptrs, ints)
        return
    if fault:
        check("phase_key", phase_key, torch.int64, (2,))
    if fthr is not None:
        check("fthr", fthr, torch.uint8, (e,))
    if jit is not None:
        check("jit", jit, torch.int32, (e,))
    span, mult = rng.scalar_span(0, _I32_MAX)
    ptrs += [phase_key if fault else None, fthr, jit]
    ints += [seed, WIRE_LOSS_TAG, JITTER_TAG, i32(span), i32(mult)]
    if tiers is not None:
        if thr != 0:
            raise ValueError("tiered loss replaces the flat threshold")
        kernels.DENSE_BROADCAST_TIERED.launch(
            ptrs + [topo_table(tiers, n, have.device)], ints)
        return
    kernels.DENSE_BROADCAST_FAULT.launch(ptrs, ints)


# -- K12p: the push-pull response leg -----------------------------------------


def pull_send_plain(have, relay, injected, nbytes, budget, dst, slot,
                    ok_pull, k_drop, thr: int, ring, dropped=None,
                    fthr=None, seed: int = 0,
                    tiers: Optional[Topology] = None) -> None:
    """Plain version of K12p, in place on ``ring`` (and ``dropped``)."""
    from ..proto.dissemination import pull_drop_bits

    n, p = have.shape
    e = dst.shape[0]
    f = e // n
    d = ring.shape[0]
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    sending = budget_prefix_mask(eligible, budget, nbytes)
    src = torch.arange(n, dtype=torch.int32,
                       device=have.device).repeat_interleave(f)
    region = None if tiers is None else regions(n, tiers.n_regions,
                                                have.device)
    drop = pull_drop_bits(thr, tiers, fthr, seed, k_drop, src, dst, p,
                          region)
    answer = ok_pull[:, None] & sending[dst.long()]
    resp = (answer & ~drop).to(torch.uint8)
    rows = (slot.long() * n + src.long())[:, None].expand(-1, p)
    ring.view(d * n, p).scatter_reduce_(0, rows, resp, "amax")
    if dropped is not None:
        dropped += (answer & drop).sum()


def pull_send(have, relay, injected, nbytes, budget: Optional[int], dst,
              slot, ok_pull, k_drop, thr: int, ring, dropped=None,
              fthr=None, seed: int = 0,
              tiers: Optional[Topology] = None) -> None:
    """The push-pull responses on the dense ring, in place: every ok_pull
    edge e carries its responder dst[e]'s sending payloads — eligible
    (held, relay budget left, injected) and inside the oldest-first
    ``budget`` prefix, read BEFORE the push spends the budget — to the
    puller e // F's row ``ring[slot[e], src]``, less the pull's loss:
    byte e*P + q of ``aligned_u8_bits(fold_in(k_drop, 1), [E, P])``
    below ``thr`` (or below the reverse edge's tier under ``tiers``, thr
    then 0), or of the fault stream ``fold_in(fold_in(k_pull, seed),
    101)`` below ``fthr[e]`` (the reverse edges' fault thresholds).  The
    frames the streams ate go to the int64 ``dropped`` when given (JAX
    ``broadcast.py:187-216``, ``proto/dissemination.py``).  K12p on the
    card, counted as ``dense_pull`` without a stream,
    ``dense_pull_lossy`` with the flat or fault stream and
    ``dense_pull_tiered`` under tiers; the caller launches it before
    `broadcast_send`."""
    if have.device.type == "cpu":
        pull_send_plain(have, relay, injected, nbytes, budget, dst, slot,
                        ok_pull, k_drop, thr, ring, dropped, fthr, seed,
                        tiers)
        return
    n, p = have.shape
    e = dst.shape[0]
    f = e // n
    d = ring.shape[0]
    _check_rows(have, relay, n, p)
    check("injected", injected, torch.uint8, (p,))
    check("nbytes", nbytes, torch.int32, (p,))
    check("dst", dst, torch.int32, (e,))
    check("slot", slot, torch.int32, (e,))
    check("ok_pull", ok_pull, torch.bool, (e,))
    check("ring", ring, torch.uint8, (d, n, p))
    if fthr is not None:
        check("fthr", fthr, torch.uint8, (e,))
    if dropped is not None:
        check("dropped", dropped, torch.int64, ())
    draws = fthr is not None or tiers is not None or 0 < thr < 256
    if draws:
        check("k_drop", k_drop, torch.int64, (2,))
    if tiers is not None and thr != 0:
        raise ValueError("tiered loss replaces the flat threshold")
    kernel = (kernels.DENSE_PULL_TIERED if tiers is not None
              else kernels.DENSE_PULL_LOSSY if draws or thr >= 256
              else kernels.DENSE_PULL)
    kernel.launch(
        [have, relay, injected, nbytes, dst, slot, ok_pull,
         k_drop if draws else None, ring, dropped, fthr,
         None if tiers is None else topo_table(tiers, n, have.device)],
        [n, p, f, d, -1 if budget is None else budget, min(thr, 256), seed,
         WIRE_LOSS_TAG])


def pull_send_lanes_plain(have, relay, injected, nbytes, budget, dst, slot,
                          ok_pull, k_drop, thr: int, ring, dropped=None,
                          fthr=None, seeds=None,
                          tiers: Optional[Topology] = None) -> None:
    """Plain version of K12p's lane entry (and of its recording forms):
    the solo plain version on each lane under its k_drop and plan seed,
    in place."""

    def lane(x, k):
        return None if x is None else x[k]

    for k in range(have.shape[0]):
        pull_send_plain(
            have[k], relay[k], injected[k], nbytes, budget, dst[k], slot[k],
            ok_pull[k], k_drop[k], thr, ring[k], lane(dropped, k),
            lane(fthr, k), 0 if seeds is None else int(seeds[k]), tiers)


def pull_send_lanes(have, relay, injected, nbytes, budget: Optional[int],
                    dst, slot, ok_pull, k_drop, thr: int, ring, dropped=None,
                    fthr=None, seeds=None,
                    tiers: Optional[Topology] = None) -> None:
    """`pull_send` over a seed ensemble's lanes (B16v), in place on the
    rings [K, D, N, P]: lane k's ok_pull edges [K, E] carry its
    responders' sending payloads (its own have, relay and budget prefix,
    read before the push spends) to its pullers, less its pull's streams
    — the flat or tiered draw under its own pull key ``fold_in(k_drop[k],
    1)``, and with the reverse edges' fault thresholds ``fthr`` u8[K, E]
    the fault draw under ``fold_in(fold_in(k_pull, seeds[k]), 101)``, its
    plan seed — at its lane-local e*P + q.  The frames its streams ate
    add to its int64 slot of ``dropped`` (a lane trace's ``[K]``
    accumulator view) when given.  K12p's lane entry on the card, counted
    as ``dense_pull_lanes`` without a stream, ``dense_pull_lossy_lanes``
    with the flat or fault stream and ``dense_pull_tiered_lanes`` under
    tiers, and as the ``_trace`` forms of the last two with ``dropped``;
    the caller launches it before `..sim.dense_lanes.
    broadcast_send_lanes`."""
    if have.device.type == "cpu":
        pull_send_lanes_plain(have, relay, injected, nbytes, budget, dst,
                              slot, ok_pull, k_drop, thr, ring, dropped,
                              fthr, seeds, tiers)
        return
    lanes, n, p = have.shape
    e = dst.shape[1]
    f = e // n
    d = ring.shape[1]
    check("have", have, torch.uint8, (lanes, n, p))
    check("relay_left", relay, torch.uint8, (lanes, n, p))
    check("injected", injected, torch.uint8, (lanes, p))
    check("nbytes", nbytes, torch.int32, (p,))
    check("dst", dst, torch.int32, (lanes, n * f))
    check("slot", slot, torch.int32, (lanes, e))
    check("ok_pull", ok_pull, torch.bool, (lanes, e))
    check("ring", ring, torch.uint8, (lanes, d, n, p))
    if fthr is not None:
        check("fthr", fthr, torch.uint8, (lanes, e))
        check("seeds", seeds, torch.int32, (lanes,))
    stride = 0
    if dropped is not None:
        if (not dropped.is_cuda or dropped.dtype != torch.int64
                or tuple(dropped.shape) != (lanes,)):
            raise ValueError("dropped must be a CUDA int64 [K] view")
        stride = dropped.stride(0)
    draws = fthr is not None or tiers is not None or 0 < thr < 256
    if draws:
        check("k_drop", k_drop, torch.int64, (lanes, 2))
    if tiers is not None and thr != 0:
        raise ValueError("tiered loss replaces the flat threshold")
    trace = dropped is not None
    if tiers is not None:
        kernel = (kernels.DENSE_PULL_TIERED_LANES_TRACE if trace
                  else kernels.DENSE_PULL_TIERED_LANES)
    elif draws or thr >= 256:
        kernel = (kernels.DENSE_PULL_LOSSY_LANES_TRACE if trace
                  else kernels.DENSE_PULL_LOSSY_LANES)
    else:
        kernel = kernels.DENSE_PULL_LANES
    kernel.launch(
        [have, relay, injected, nbytes, dst, slot, ok_pull,
         k_drop if draws else None, ring, dropped, fthr,
         None if tiers is None else topo_table(tiers, n, have.device),
         seeds if fthr is not None else None],
        [n, p, f, d, -1 if budget is None else budget, min(thr, 256),
         WIRE_LOSS_TAG, stride, lanes])


def broadcast_step(
    state: SimState, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    region: torch.Tensor, key: torch.Tensor, faults=None,
    trace: Optional[RoundTrace] = None, active=None,
) -> SimState:
    """Fan-out push over the dense state, in place on ``relay_left`` and
    ``inflight`` (JAX ``broadcast_step``: targets from the believed
    member list, ring0 tiering, the topology's degree caps (K20), flat or
    tiered per-(edge, payload) loss from ``k_drop`` (K12, or its tiered
    instantiation), delivery slot t + edge delay (K20 for AZ or matrix
    delay classes)).  Under ``faults`` (JAX's
    fault branch, ``fault_wire_effects``) cuts clear edges and the
    plan's fixed delay adds to each edge's (K9), and the plan's loss and
    jitter are drawn per (edge, payload) by K12's fault entry; ``active``
    (the host's copy of the round's loss and jitter activity) leaves out
    the classes that do not apply this round, which changes no bit.
    With a ``trace`` the wire's frames, bytes (K12's per-node outputs,
    folded over the ok edges by K18), cut edges (K9) and lost frames
    (K12) go to its accumulators."""
    n = state.have.shape[0]
    f = cfg.fanout
    ks = rng.split(key, 3)
    k_targets, k_drop, k_ring0 = ks[0], ks[1], ks[2]
    targets = sample_member_targets(state, cfg, k_targets, f)  # [N, F]
    targets = ring0_targets(state, cfg, topo, region, k_ring0, targets)
    targets = capped_schedule(targets, topo, cfg, int(state.t))
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    src = me.repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst)
    ok &= dst != src
    fthr = jit = fdelay = None
    if faults is not None:
        ok, fthr, fdelay, jit = fault_wire_effects(
            faults, src, dst, ok,
            cut=None if trace is None else acc_slot(trace, "bcast_cut"))
        if active is not None:
            fthr = fthr if active.loss else None
            jit = jit if active.jitter else None
    slot = edge_slot(topo, region, src, dst, int(state.t),
                     state.inflight.shape[0], fdelay)
    tiers = wire_tiers(topo)
    thr = (loss_threshold(topo.loss)
           if topo.loss > 0 and tiers is None else 0)
    row_frames = row_bytes = dropped = None
    if trace is not None:
        row_frames = torch.empty(n, dtype=torch.int32, device=me.device)
        row_bytes = torch.empty_like(row_frames)
        if wire_loss_active(topo, faults):
            dropped = acc_slot(trace, "bcast_dropped")
    seed = 0 if faults is None else int(faults.seed)
    ok_pull = None
    if cfg.dissemination == "push-pull":
        # the responses read the relay budget before the push spends it
        from ..proto.dissemination import pull_session_ok, reverse_loss

        ok_pull = pull_session_ok(ok, faults, src, dst)
        pull_send(
            state.have, state.relay_left, state.injected, meta.nbytes,
            cfg.rate_limit_bytes_round, dst, slot, ok_pull, k_drop, thr,
            state.inflight, dropped,
            reverse_loss(faults, src, dst) if fthr is not None else None,
            seed, tiers)
    broadcast_send(
        state.have, state.relay_left, state.injected, meta.nbytes,
        cfg.rate_limit_bytes_round, targets.contiguous(), dst, slot, ok,
        state.alive, k_drop, thr, state.inflight, row_frames, row_bytes,
        dropped, key, fthr, jit, seed, tiers,
    )
    if trace is not None:
        wire_rows_(trace.acc[WIRE], row_frames, row_bytes, ok, f)
        if ok_pull is not None:
            wire_rows_pull_(trace.acc[WIRE], row_frames, row_bytes, ok_pull,
                            dst)
    return state


# -- K12: deliver ------------------------------------------------------------


def deliver_dense_plain(ring, sync_ring, have, relay, slot: int,
                        relay_init: int, admit=None) -> None:
    """Plain version of K12's deliver and, with the admit mask ``admit``
    (bool[N, P]), of K12f-o; in place."""
    arriving = ring[slot]
    pulled = sync_ring[slot]
    if admit is not None:
        arriving = torch.where(admit, arriving, 0)
        pulled = torch.where(admit, pulled, 0)
    newly = (arriving > 0) & (have == 0)
    have.copy_(torch.maximum(torch.maximum(have, arriving), pulled))
    relay.copy_(torch.where(newly, relay_init, relay).to(torch.uint8))
    ring[slot] = 0
    sync_ring[slot] = 0


def deliver_dense(ring, sync_ring, have, relay, slot: int,
                  relay_init: int, fifo=None) -> None:
    """Pop slot ``slot`` of both rings into ``have``: broadcast arrivals
    that are new arm the relay budget to ``relay_init``, sync arrivals
    do not; both slots are cleared.  With ``fifo`` (the config, under
    ``ordering="fifo"``) both slots arrive only where
    `..proto.ordering.admit_payload_mask` of the pre-merge ``have``
    admits them; the rest is dropped.  In place; K12 on the card, K12f-o
    under FIFO."""
    if have.device.type == "cpu":
        admit = None
        if fifo is not None:
            from ..proto.ordering import admit_payload_mask

            admit = admit_payload_mask(have, fifo)
        deliver_dense_plain(ring, sync_ring, have, relay, slot, relay_init,
                            admit)
        return
    n, p = have.shape
    d = ring.shape[0]
    _check_rows(have, relay, n, p)
    check("inflight", ring, torch.uint8, (d, n, p))
    check("sync_inflight", sync_ring, torch.uint8, (d, n, p))
    if fifo is not None:
        c = fifo.chunks_per_version
        kernels.DENSE_DELIVER_FIFO.launch(
            [ring, sync_ring, have, relay],
            [n, p, slot, relay_init, c, fifo.n_writers * c])
        return
    kernels.DENSE_DELIVER.launch(
        [ring, sync_ring, have, relay], [n, p, slot, relay_init]
    )


def deliver_step(state: SimState, cfg: SimConfig) -> SimState:
    """Pop this round's slot of both rings (JAX ``deliver_step``)."""
    d_slots = state.inflight.shape[0]
    deliver_dense(
        state.inflight, state.sync_inflight, state.have, state.relay_left,
        int(state.t) % d_slots, max(cfg.max_transmissions - 1, 1),
        cfg if order_enforced(cfg) else None,
    )
    return state


def inject_step(state: SimState, meta: PayloadMeta,
                cfg: SimConfig) -> SimState:
    """Origin nodes learn their own commits the round they are injected
    (JAX ``inject_step``)."""
    inject_dense(
        state.have, state.relay_left, state.injected, meta, state.alive,
        int(state.t), cfg.max_transmissions,
    )
    return state
