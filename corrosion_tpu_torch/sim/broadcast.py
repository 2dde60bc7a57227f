"""The dense broadcast phases — the port of
``corrosion_tpu/sim/broadcast.py`` (``broadcast_step`` in its push,
flat-schedule form with its wire telemetry, ``deliver_step`` with ordering
"none", ``inject_step``) on JAX's u8 state: ``have``, ``relay_left``
``[N, P]``, ``injected [P]`` and the delay rings ``inflight``,
``sync_inflight`` ``[D, N, P]``.

Each phase is one launch of K12 (``kernels/csrc/dense_phases.cu``) on the
card and the plain torch version beside its wrapper on the CPU:

- `inject_dense` — origin nodes take round t's payloads;
- `broadcast_send` — the eligible mask, the oldest-first byte budget,
  the flat wire loss per (edge, payload), the ring write and the relay
  spend;
- `deliver_dense` — pop slot t of both rings.

The target draw, ring0 tiering (`ring0_targets`, shared with the packed
round) and the edge list stay torch (and K1, K5).

**In place.**  The phases update the state's tensors in place, plain
versions too: the dense round owns them (`.round.own_state`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
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
from .fused import dense_send_stats
from .swim import sample_member_targets
from .telemetry import (
    WIRE,
    RoundTrace,
    acc_slot,
    wire_loss_active,
    wire_rows_,
)
from .topology import (
    Topology,
    aligned_u8_bits,
    apply_degree_caps,
    edge_alive,
    edge_delay,
    loss_threshold,
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
                         row_bytes=None, dropped=None) -> None:
    """Plain version of K12's broadcast, in place on ``relay`` and
    ``ring`` (and the telemetry outputs when given)."""
    n, p = have.shape
    f = targets.shape[1]
    d = ring.shape[0]
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    sending = budget_prefix_mask(eligible, budget, nbytes)
    if thr <= 0:
        drop = torch.zeros((n * f, p), dtype=torch.bool, device=have.device)
    elif thr >= 256:
        drop = torch.ones((n * f, p), dtype=torch.bool, device=have.device)
    else:
        drop = aligned_u8_bits(key, (n * f, p)) < thr
    sent = torch.where(
        ok.reshape(n, f, 1) & ~drop.reshape(n, f, p), sending[:, None, :],
        False,
    ).to(torch.uint8).reshape(n * f, p)
    rows = (slot.long() * n + dst.long())[:, None].expand(-1, p)
    ring.view(d * n, p).scatter_reduce_(0, rows, sent, "amax")
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
                   dropped=None) -> None:
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
    accumulator ``dropped``.  K12 on the card, which draws the loss bits
    itself."""
    if have.device.type == "cpu":
        broadcast_send_plain(have, relay, injected, nbytes, budget, targets,
                             dst, slot, ok, alive, key, thr, ring, row_frames,
                             row_bytes, dropped)
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
    kernels.DENSE_BROADCAST.launch(
        [have, relay, injected, nbytes, targets, dst, slot, ok, alive, key,
         ring, row_frames, row_bytes, dropped],
        [n, p, f, d, -1 if budget is None else budget, min(thr, 256)],
    )


def broadcast_step(
    state: SimState, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    region: torch.Tensor, key: torch.Tensor, faults=None,
    trace: Optional[RoundTrace] = None,
) -> SimState:
    """Fan-out push over the dense state, in place on ``relay_left`` and
    ``inflight`` (JAX ``broadcast_step``: targets from the believed
    member list, ring0 tiering, flat per-(edge, payload) loss from
    ``k_drop``, delivery slot t + edge delay).  With a ``trace`` the
    wire's frames, bytes (K12's per-node outputs, folded over the ok
    edges by K18) and lost frames (K12) go to its accumulators."""
    if faults is not None:
        raise NotImplementedError(
            "faults on the dense round are not ported yet (ROADMAP B12 "
            "rest)"
        )
    n = state.have.shape[0]
    f = cfg.fanout
    ks = rng.split(key, 3)
    k_targets, k_drop, k_ring0 = ks[0], ks[1], ks[2]
    targets = sample_member_targets(state, cfg, k_targets, f)  # [N, F]
    targets = ring0_targets(state, cfg, topo, region, k_ring0, targets)
    targets = apply_degree_caps(targets, topo)
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    src = me.repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst)
    ok &= dst != src
    delay = edge_delay(topo, region, src, dst)
    d_slots = state.inflight.shape[0]
    slot = ((int(state.t) + delay) % d_slots).to(torch.int32)
    thr = loss_threshold(topo.loss) if topo.loss > 0 else 0
    row_frames = row_bytes = dropped = None
    if trace is not None:
        row_frames = torch.empty(n, dtype=torch.int32, device=me.device)
        row_bytes = torch.empty_like(row_frames)
        if wire_loss_active(topo, None):
            dropped = acc_slot(trace, "bcast_dropped")
    broadcast_send(
        state.have, state.relay_left, state.injected, meta.nbytes,
        cfg.rate_limit_bytes_round, targets.contiguous(), dst, slot, ok,
        state.alive, k_drop, thr, state.inflight, row_frames, row_bytes,
        dropped,
    )
    if trace is not None:
        wire_rows_(trace.acc[WIRE], row_frames, row_bytes, ok, f)
    return state


# -- K12: deliver ------------------------------------------------------------


def deliver_dense_plain(ring, sync_ring, have, relay, slot: int,
                        relay_init: int) -> None:
    """Plain version of K12's deliver, in place."""
    arriving = ring[slot]
    newly = (arriving > 0) & (have == 0)
    have.copy_(torch.maximum(torch.maximum(have, arriving), sync_ring[slot]))
    relay.copy_(torch.where(newly, relay_init, relay).to(torch.uint8))
    ring[slot] = 0
    sync_ring[slot] = 0


def deliver_dense(ring, sync_ring, have, relay, slot: int,
                  relay_init: int) -> None:
    """Pop slot ``slot`` of both rings into ``have``: broadcast arrivals
    that are new arm the relay budget to ``relay_init``, sync arrivals
    do not; both slots are cleared.  In place; K12 on the card."""
    if have.device.type == "cpu":
        deliver_dense_plain(ring, sync_ring, have, relay, slot, relay_init)
        return
    n, p = have.shape
    d = ring.shape[0]
    _check_rows(have, relay, n, p)
    check("inflight", ring, torch.uint8, (d, n, p))
    check("sync_inflight", sync_ring, torch.uint8, (d, n, p))
    kernels.DENSE_DELIVER.launch(
        [ring, sync_ring, have, relay], [n, p, slot, relay_init]
    )


def deliver_step(state: SimState, cfg: SimConfig) -> SimState:
    """Pop this round's slot of both rings (JAX ``deliver_step``)."""
    d_slots = state.inflight.shape[0]
    deliver_dense(
        state.inflight, state.sync_inflight, state.have, state.relay_left,
        int(state.t) % d_slots, max(cfg.max_transmissions - 1, 1),
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
