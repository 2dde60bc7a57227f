"""FaultPlan → sim tensors — the port of the factored half of
``corrosion_tpu/sim/faults.py``: the compiled plan, the per-edge fault
queries the round asks, the node faults, and `run_fault_plan` over the
packed envelope.

**The compiled plan.**  `compile_plan` lowers a `..faults.FaultPlan`
straight from its events into a `FactoredFaultPlan`: each link event is
one rank-1 term (active rounds ``[R+1]``, a source mask ``[N]``, a
destination mask ``[N]``); crash windows are a dense ``alive`` override
``i8[R+1, N]`` (-1 leaves the scenario's value) and ``wipe
bool[R+1, N]``.  It is numpy until one transfer to ``device``, and gives
JAX's fields, dtypes and shapes.  ``seed`` is the plan seed's fold
``derive_seed(seed, "sim") & 0x7FFFFFFF``; it lives on the host, like
the round counter, because every fault key is
``fold_in(fold_in(phase_key, seed), tag)``.  The matrix form
(``SimFaultPlan``/``RoundFaults``, ``compile_plan(factored=False)``) is
not ported (ROADMAP B12) and raises.

**The edge queries.**  `fault_edge_block`, `fault_edge_loss`,
`fault_session_refused`, the cut and threshold half of
`fault_wire_effects`, and `fault_reach_` (`swim._reachable`'s fault
branch) run K9 (``kernels/csrc/fault_edges.cu``) on the card and the
plain versions beside them on the CPU.  The per-(edge, payload) wire
loss draw itself rides the ring scatter (K10,
`packed.scatter_sending_lossy`).  Delay and jitter factors are not
ported (ROADMAP B12): a plan that has them compiles, and the round
raises when it reaches them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..faults import FaultPlan, derive_seed, sel_indices
from ..kernels.build import check
from . import rng
from .state import ALIVE, DOWN, PayloadMeta, SimConfig, SimState
from .topology import Topology, aligned_u8_bits

#: fold_in tags of the fault draws (jax's, `fault_wire_effects` and
#: `swim._reachable`): per-(edge, payload) wire loss, per-edge probe loss
WIRE_LOSS_TAG = 101
PROBE_LOSS_TAG = 103

#: auto-factor threshold: `compile_plan` lowers to the factored form at
#: or above this node count (JAX's FACTORED_MIN_NODES)
FACTORED_MIN_NODES = 1024

#: largest mutually-overlapping loss-event set the factored compiler
#: composes exactly (one factor per pairwise-overlapping subset)
MAX_OVERLAPPING_LOSS = 8


class FactoredFaultPlan(NamedTuple):
    """Rank-1-factored fault schedule; field order is JAX's."""

    alive: torch.Tensor          # i8[R+1, N]
    wipe: torch.Tensor           # bool[R+1, N]
    seed: torch.Tensor           # i32 scalar, on the host
    block_active: torch.Tensor   # bool[Kb, R+1]
    block_src: torch.Tensor      # bool[Kb, N]
    block_dst: torch.Tensor      # bool[Kb, N]
    loss_active: torch.Tensor    # bool[Kl, R+1]
    loss_src: torch.Tensor       # bool[Kl, N]
    loss_dst: torch.Tensor       # bool[Kl, N]
    loss_thr: torch.Tensor       # u8[Kl]
    delay_active: torch.Tensor   # bool[Kd, R+1]
    delay_src: torch.Tensor      # bool[Kd, N]
    delay_dst: torch.Tensor      # bool[Kd, N]
    delay_rounds: torch.Tensor   # i32[Kd]
    jitter_active: torch.Tensor  # bool[Kj, R+1]
    jitter_src: torch.Tensor     # bool[Kj, N]
    jitter_dst: torch.Tensor     # bool[Kj, N]
    jitter_rounds: torch.Tensor  # i32[Kj]

    @property
    def horizon(self) -> int:
        """The plan's last row: every round from here on is fault-free."""
        return self.alive.shape[0] - 1


class FactoredRoundFaults(NamedTuple):
    """One round's slice of a FactoredFaultPlan (views of its tensors:
    the ``*_on`` columns are strided); field order is JAX's."""

    alive: torch.Tensor          # i8[N]
    wipe: torch.Tensor           # bool[N]
    seed: torch.Tensor           # i32 scalar, on the host
    block_on: torch.Tensor       # bool[Kb]
    block_src: torch.Tensor      # bool[Kb, N]
    block_dst: torch.Tensor      # bool[Kb, N]
    loss_on: torch.Tensor        # bool[Kl]
    loss_src: torch.Tensor       # bool[Kl, N]
    loss_dst: torch.Tensor       # bool[Kl, N]
    loss_thr: torch.Tensor       # u8[Kl]
    delay_on: torch.Tensor       # bool[Kd]
    delay_src: torch.Tensor      # bool[Kd, N]
    delay_dst: torch.Tensor      # bool[Kd, N]
    delay_rounds: torch.Tensor   # i32[Kd]
    jitter_on: torch.Tensor      # bool[Kj]
    jitter_src: torch.Tensor     # bool[Kj, N]
    jitter_dst: torch.Tensor     # bool[Kj, N]
    jitter_rounds: torch.Tensor  # i32[Kj]


# -- the compiled plan -------------------------------------------------------


def _refuse_slow(plan: FaultPlan) -> None:
    if any(ev.kind == "slow" for ev in plan.events):
        raise ValueError(
            "the sim tier cannot express `slow` (wall-clock node stall); "
            "replay it on the host or devcluster seam"
        )


def compile_plan(
    plan: FaultPlan,
    cfg: SimConfig,
    topo: Topology = Topology(),
    factored: Optional[bool] = None,
    device="cuda",
) -> FactoredFaultPlan:
    """Lower ``plan`` into a `FactoredFaultPlan` on ``device``.
    ``factored=None`` picks the factored form at ≥ FACTORED_MIN_NODES
    nodes, as JAX does; the matrix form below that (or on request) is
    not ported and raises."""
    if plan.n_nodes != cfg.n_nodes:
        raise ValueError(
            f"plan is for {plan.n_nodes} nodes, SimConfig has {cfg.n_nodes}"
        )
    _refuse_slow(plan)
    if factored is None:
        factored = cfg.n_nodes >= FACTORED_MIN_NODES
    if not factored:
        raise NotImplementedError(
            "the matrix fault plan (SimFaultPlan/RoundFaults) is not ported "
            "yet (ROADMAP B12); pass factored=True"
        )
    return compile_plan_factored(plan, cfg, topo, device)


def _sel_mask(sel, n: int) -> np.ndarray:
    m = np.zeros(n, np.bool_)
    r = sel_indices(sel, n)
    m[r.start:r.stop] = True
    return m


def _events_overlap(a, b, n: int) -> bool:
    """Can events a and b affect the same (round, directed link)?"""
    if a.end <= b.start or b.end <= a.start:
        return False

    def hits(x, y):
        return max(x.start, y.start) < min(x.stop, y.stop)

    return hits(sel_indices(a.src, n), sel_indices(b.src, n)) and hits(
        sel_indices(a.dst, n), sel_indices(b.dst, n)
    )


def _compose_overlapping_losses(losses, loss_events, blocks, n: int) -> None:
    """Exact composition of overlapping loss events: one extra factor per
    pairwise-overlapping subset, over the subset's intersection, carrying
    the matrix compiler's merged threshold (the plan-order float64 fold
    of ``1-(1-a)(1-b)``, quantized once); `fault_edge_loss`'s max over
    hitting factors then equals the merged value.  A subset that folds
    to certainty becomes a cut."""
    k = len(loss_events)
    if k < 2:
        return
    neighbors = [
        {
            j
            for j in range(k)
            if j != i and _events_overlap(loss_events[i], loss_events[j], n)
        }
        for i in range(k)
    ]

    def _emit(combo):
        act = np.logical_and.reduce([losses[i][0] for i in combo])
        sm = np.logical_and.reduce([losses[i][1] for i in combo])
        dm = np.logical_and.reduce([losses[i][2] for i in combo])
        if not (act.any() and sm.any() and dm.any()):
            return
        p = 0.0
        for i in combo:
            p = 1.0 - (1.0 - p) * (1.0 - loss_events[i].p)
        thr = int(round(p * 256.0))
        if thr >= 256:
            blocks.append((act, sm, dm))
        elif thr > 0:
            losses.append((act, sm, dm, thr))

    def _extend(combo, cands):
        if not cands:
            return
        if len(combo) >= MAX_OVERLAPPING_LOSS:
            raise ValueError(
                f"factored loss composition caps at {MAX_OVERLAPPING_LOSS} "
                "mutually-overlapping loss events (subset composition is "
                "exponential in the clique size)"
            )
        for j in sorted(cands):
            grown = combo + (j,)
            if len(grown) >= 2:
                _emit(grown)
            _extend(grown, {c for c in cands if c > j and c in neighbors[j]})

    _extend((), set(range(k)))


def _max_extra_delay(plan: FaultPlan, n: int) -> int:
    """The ring envelope's bound on a link's extra delay in any round:
    each active delay event plus every other one it can share a link
    with, plus the largest active jitter."""
    delay_events = [ev for ev in plan.events if ev.kind == "delay"]
    max_extra = 0
    for r in range(plan.horizon + 1):
        active = [ev for ev in delay_events if ev.start <= r < ev.end]
        d = max(
            (
                ev.delay_rounds
                + sum(
                    o.delay_rounds for o in active
                    if o is not ev and _events_overlap(ev, o, n)
                )
                for ev in active
            ),
            default=0,
        )
        j = max(
            (ev.delay_rounds for ev in plan.events
             if ev.kind == "jitter" and ev.start <= r < ev.end),
            default=0,
        )
        max_extra = max(max_extra, d + j)
    return max_extra


def compile_plan_factored(
    plan: FaultPlan, cfg: SimConfig, topo: Topology = Topology(),
    device="cuda",
) -> FactoredFaultPlan:
    """Lower the plan into rank-1 link-event factors straight from its
    events: partitions OR (a symmetric one is two factors), losses
    compose exactly (`_compose_overlapping_losses`), a loss of p·256 ≥
    256 is a cut, delays add, jitter takes the max; crashes write the
    alive override (down over the window, then the restart, which wins
    a round two windows share) and the wipe row."""
    if plan.n_nodes != cfg.n_nodes:
        raise ValueError(
            f"plan is for {plan.n_nodes} nodes, SimConfig has {cfg.n_nodes}"
        )
    _refuse_slow(plan)
    dev = resolve_device(device)
    n, rounds = plan.n_nodes, plan.horizon
    alive = np.full((rounds + 1, n), -1, np.int8)
    wipe = np.zeros((rounds + 1, n), np.bool_)
    blocks, losses, delays, jitters = [], [], [], []
    loss_events = []

    def _act(ev):
        a = np.zeros(rounds + 1, np.bool_)
        a[ev.start:ev.end] = True
        return a

    crash_events = [ev for ev in plan.events if ev.kind == "crash"]
    for ev in crash_events:
        sel = sel_indices(ev.node, n)
        alive[ev.start:ev.end, sel.start:sel.stop] = DOWN
    for ev in crash_events:
        sel = sel_indices(ev.node, n)
        alive[ev.end, sel.start:sel.stop] = ALIVE
        if ev.wipe:
            wipe[ev.end, sel.start:sel.stop] = True

    for ev in plan.events:
        if ev.kind in ("crash", "clock_skew", "duplicate"):
            # crash is above; clock_skew is host-only; duplicate is a
            # no-op under idempotent OR delivery
            continue
        term = (_act(ev), _sel_mask(ev.src, n), _sel_mask(ev.dst, n))
        if ev.kind == "partition":
            blocks.append(term)
            if ev.symmetric:
                blocks.append((term[0], term[2], term[1]))
        elif ev.kind == "loss":
            thr = int(round(ev.p * 256.0))
            if thr >= 256:
                blocks.append(term)  # certainty cannot ride a u8: sever
            elif thr > 0:
                losses.append(term + (thr,))
                loss_events.append(ev)
        elif ev.kind == "delay":
            delays.append(term + (ev.delay_rounds,))
        elif ev.kind == "jitter":
            jitters.append(term + (ev.delay_rounds,))

    _compose_overlapping_losses(losses, loss_events, blocks, n)

    base = max(topo.max_delay, 1)
    max_extra = _max_extra_delay(plan, n)
    if base + max_extra >= cfg.n_delay_slots:
        raise ValueError(
            f"max edge delay {base + max_extra} rounds (topology {base} + "
            f"fault {max_extra}) needs n_delay_slots > {base + max_extra}, "
            f"got {cfg.n_delay_slots}"
        )

    def put(a):
        return torch.from_numpy(a).to(dev)

    def _stack(terms, extra_dtype=None):
        k = len(terms)
        act = np.zeros((k, rounds + 1), np.bool_)
        sm = np.zeros((k, n), np.bool_)
        dm = np.zeros((k, n), np.bool_)
        vals = np.zeros((k,), extra_dtype) if extra_dtype else None
        for i, t in enumerate(terms):
            act[i], sm[i], dm[i] = t[0], t[1], t[2]
            if extra_dtype:
                vals[i] = t[3]
        out = [put(act), put(sm), put(dm)]
        if extra_dtype:
            out.append(put(vals))
        return out

    b_act, b_src, b_dst = _stack(blocks)
    l_act, l_src, l_dst, l_thr = _stack(losses, np.uint8)
    d_act, d_src, d_dst, d_val = _stack(delays, np.int32)
    j_act, j_src, j_dst, j_val = _stack(jitters, np.int32)
    return FactoredFaultPlan(
        alive=put(alive), wipe=put(wipe),
        seed=torch.tensor(derive_seed(plan.seed, "sim") & 0x7FFFFFFF,
                          dtype=torch.int32),
        block_active=b_act, block_src=b_src, block_dst=b_dst,
        loss_active=l_act, loss_src=l_src, loss_dst=l_dst, loss_thr=l_thr,
        delay_active=d_act, delay_src=d_src, delay_dst=d_dst,
        delay_rounds=d_val,
        jitter_active=j_act, jitter_src=j_src, jitter_dst=j_dst,
        jitter_rounds=j_val,
    )


def round_faults(fplan: FactoredFaultPlan, t: int) -> FactoredRoundFaults:
    """Round ``t``'s slice; past the horizon every round reads the final
    all-clear row (an index clamp, not a wrap)."""
    i = min(int(t), fplan.horizon)
    return FactoredRoundFaults(
        alive=fplan.alive[i], wipe=fplan.wipe[i], seed=fplan.seed,
        block_on=fplan.block_active[:, i],
        block_src=fplan.block_src, block_dst=fplan.block_dst,
        loss_on=fplan.loss_active[:, i],
        loss_src=fplan.loss_src, loss_dst=fplan.loss_dst,
        loss_thr=fplan.loss_thr,
        delay_on=fplan.delay_active[:, i],
        delay_src=fplan.delay_src, delay_dst=fplan.delay_dst,
        delay_rounds=fplan.delay_rounds,
        jitter_on=fplan.jitter_active[:, i],
        jitter_src=fplan.jitter_src, jitter_dst=fplan.jitter_dst,
        jitter_rounds=fplan.jitter_rounds,
    )


# -- per-edge fault evaluation ------------------------------------------------


def _require_no_delay(faults: FactoredRoundFaults) -> None:
    if faults.delay_src.shape[0] or faults.jitter_src.shape[0]:
        raise NotImplementedError(
            "fault delay and jitter (fault_edge_delay/jitter, the "
            "per-(edge, payload) ring scatter, sync delay classes) are not "
            "ported yet (ROADMAP B12)"
        )


def _factored_hits(on, src_m, dst_m, src, dst) -> torch.Tensor:
    """bool[K, E]: factor k applies to edge e this round.  Self-edges
    never fault (the probe relay legs do evaluate (x, x) edges)."""
    s, d = src.long(), dst.long()
    return on[:, None] & src_m[:, s] & dst_m[:, d] & (src != dst)[None, :]


def _block_plain(faults, src, dst) -> torch.Tensor:
    return _factored_hits(
        faults.block_on, faults.block_src, faults.block_dst, src, dst
    ).any(dim=0)


def _loss_plain(faults, src, dst) -> torch.Tensor:
    hit = _factored_hits(
        faults.loss_on, faults.loss_src, faults.loss_dst, src, dst
    )
    zero = torch.zeros((), dtype=torch.uint8, device=src.device)
    return torch.where(hit, faults.loss_thr[:, None], zero).amax(dim=0)


def _k9_args(faults, src, dst, blocks: bool, losses: bool):
    """K9's factor pointers and ints (kb, b_stride, kl, l_stride, n, e)
    after the wrapper-side checks; a class left out passes K = 0."""
    n = faults.alive.shape[0]
    e = src.shape[0]
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (e,))
    ints = []
    for on, sm, dm, use in (
        (faults.block_on, faults.block_src, faults.block_dst, blocks),
        (faults.loss_on, faults.loss_src, faults.loss_dst, losses),
    ):
        k = sm.shape[0] if use else 0
        check("factor src mask", sm, torch.bool, (sm.shape[0], n))
        check("factor dst mask", dm, torch.bool, (sm.shape[0], n))
        if not on.is_cuda or on.dtype != torch.bool or on.shape != (
                sm.shape[0],):
            raise ValueError("factor on bits must be a CUDA bool [K] view")
        ints += [k, on.stride(0) if on.numel() else 0]
    check("loss_thr", faults.loss_thr, torch.uint8,
          (faults.loss_src.shape[0],))
    ptrs = [faults.block_on, faults.block_src, faults.block_dst,
            faults.loss_on, faults.loss_src, faults.loss_dst,
            faults.loss_thr, src, dst]
    return ptrs, ints + [n, e]


def _fault_edges(faults, src, dst, blocks, losses, cut=False, thr=False,
                 ok=None, sym=False, count=None):
    """One K9 query launch: the cut (with ``sym`` OR the reversed edge's)
    and/or the threshold as new tensors, and/or ``ok`` cleared in place
    on a cut, adding the ok edges it clears to the int64 accumulator
    ``count`` when given."""
    ptrs, ints = _k9_args(faults, src, dst, blocks, losses)
    e = src.shape[0]
    cut_out = (torch.empty(e, dtype=torch.bool, device=src.device)
               if cut else None)
    thr_out = (torch.empty(e, dtype=torch.uint8, device=src.device)
               if thr else None)
    if ok is not None:
        check("ok", ok, torch.bool, (e,))
    if count is not None:
        check("count", count, torch.int64, ())
    kernels.FAULT_EDGES.launch(ptrs + [cut_out, thr_out, ok, count],
                               ints + [int(sym)])
    return cut_out, thr_out


def fault_edge_block(faults: FactoredRoundFaults, src, dst):
    """bool[E] directed-cut mask at the given edges, or None when the
    plan schedules no cuts.  K9 on the card."""
    if faults.block_src.shape[0] == 0:
        return None
    if src.device.type == "cpu":
        return _block_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, True, False, cut=True)[0]


def fault_edge_loss(faults: FactoredRoundFaults, src, dst):
    """u8[E] extra-loss threshold (p·256) at the given edges — the max
    of the hitting factors' thresholds — or None when the plan has no
    loss.  K9 on the card."""
    if faults.loss_src.shape[0] == 0:
        return None
    if src.device.type == "cpu":
        return _loss_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, False, True, thr=True)[1]


def fault_session_refused(faults: FactoredRoundFaults, src, dst, ok=None,
                          count=None):
    """bool[E] (or None): the sync session is refused — a cut in EITHER
    direction kills the bidirectional stream.  With ``ok`` the refused
    sessions are also cleared from it in place, and with ``count`` (an
    int64 accumulator, the flight recorder's) the ok sessions refused
    are added to it.  K9 on the card."""
    if faults.block_src.shape[0] == 0:
        return None
    if src.device.type == "cpu":
        refused = _block_plain(faults, src, dst) | _block_plain(faults, dst,
                                                                src)
        if ok is not None:
            if count is not None:
                count += (ok & refused).sum()
            ok &= ~refused
        return refused
    return _fault_edges(faults, src, dst, True, False, cut=True, sym=True,
                        ok=ok, count=count)[0]


def fault_session_delay(faults: FactoredRoundFaults, src, dst):
    """Extra sync-session RTT: None without delay factors (the only
    ported case)."""
    _require_no_delay(faults)
    return None


def fault_wire_effects(faults: FactoredRoundFaults, src, dst, ok, cut=None):
    """The broadcast's fault seam, its per-edge half: cuts clear ``ok``
    IN PLACE (adding the ok edges they sever to the int64 accumulator
    ``cut`` when given, the flight recorder's), and the extra-loss
    thresholds come back as u8[E] (None when the plan has no loss).  The
    per-(edge, payload) loss draw that JAX ORs into ``drop`` here
    (fold_in key 101 on the broadcast phase key) is made by the ring
    scatter that consumes the thresholds (`packed.scatter_sending_lossy`,
    K10).  K9 on the card."""
    _require_no_delay(faults)
    has_block = faults.block_src.shape[0] > 0
    has_loss = faults.loss_src.shape[0] > 0
    if not (has_block or has_loss):
        return ok, None
    if src.device.type == "cpu":
        if has_block:
            hit = _block_plain(faults, src, dst)
            if cut is not None:
                cut += (ok & hit).sum()
            ok &= ~hit
        return ok, _loss_plain(faults, src, dst) if has_loss else None
    _, thr = _fault_edges(faults, src, dst, has_block, has_loss,
                          thr=has_loss, ok=ok,
                          count=cut if has_block else None)
    return ok, thr


def fault_key(key: torch.Tensor, seed: int, tag: int) -> torch.Tensor:
    """``fold_in(fold_in(key, seed), tag)``: the key of a fault draw, from
    its phase key, the plan's seed and the draw's tag."""
    return rng.fold_in(rng.fold_in(key, seed), tag)


def fault_reach_plain(ok, faults, key, src, dst) -> torch.Tensor:
    """Plain version of K9's reach entry, in place."""
    if faults.block_src.shape[0]:
        ok &= ~_block_plain(faults, src, dst)
    if faults.loss_src.shape[0]:
        thr = _loss_plain(faults, src, dst)
        bits = aligned_u8_bits(
            fault_key(key, int(faults.seed), PROBE_LOSS_TAG),
            tuple(src.shape),
        )
        ok &= ~(bits < thr)
    return ok


def fault_reach_(ok, faults: FactoredRoundFaults, key, src, dst):
    """The fault branch of `swim._reachable`, in place on bool[E] ``ok``:
    directed cuts, then the per-edge loss draw (fold_in key 103 on the
    probe's loss key) against the edge's threshold.  K9 on the card."""
    if src.device.type == "cpu":
        return fault_reach_plain(ok, faults, key, src, dst)
    kb, kl = faults.block_src.shape[0], faults.loss_src.shape[0]
    if not (kb or kl):
        return ok
    ptrs, ints = _k9_args(faults, src, dst, True, True)
    check("ok", ok, torch.bool, (src.shape[0],))
    check("key", key, torch.int64, (2,))
    kernels.FAULT_REACH.launch(
        ptrs + [key, ok], ints + [int(faults.seed), PROBE_LOSS_TAG]
    )
    return ok


# -- node faults --------------------------------------------------------------


def _zero_rows_(x: torch.Tensor, rows: torch.Tensor, node_dim: int,
                fill=0) -> None:
    if x.numel() == 0:
        return
    shape = [1] * x.dim()
    shape[node_dim] = rows.shape[0]
    x.copy_(torch.where(rows.reshape(shape), fill, x))


def apply_node_faults(state: SimState, rf: FactoredRoundFaults) -> SimState:
    """Crash, restart and wipe, before the round's phases, IN PLACE: the
    alive override, then on wiped nodes zeroed payload rows (have, relay
    budgets, both delivery rings), bookkeeping (heads, gaps) and an
    empty member table, so the node rejoins cold and recovers through
    anti-entropy.  On the packed loop's slim state the payload tensors
    are zero-width and `packed.apply_carry_faults` wipes the carry; K11
    (`packed.apply_round_faults`) does both on the card."""
    state.alive.copy_(torch.where(
        rf.alive >= 0, rf.alive.to(state.alive.dtype), state.alive
    ))
    w = rf.wipe
    for x in (state.have, state.relay_left, state.heads, state.gap_lo,
              state.gap_hi):
        _zero_rows_(x, w, 0)
    for x in (state.inflight, state.sync_inflight):
        _zero_rows_(x, w, 1)
    for x in (state.pid, state.pkey, state.psince, state.pview):
        _zero_rows_(x, w, 0, -1)
    return state


# -- the run loop ------------------------------------------------------------


def run_fault_plan(
    state: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology,
    fplan: FactoredFaultPlan,
    max_rounds: int = 1000,
    telemetry: bool = False,
):
    """Advance rounds under the fault schedule until the cluster holds
    every payload AND the schedule is exhausted (a plan may crash a node
    after convergence), or ``max_rounds``; returns (SimState,
    RunMetrics), and with ``telemetry`` the run's `.telemetry.RoundTrace`
    third.  Only the packed envelope is ported (faults on the dense
    round are ROADMAP B12 rest)."""
    from .packed import run_packed_faults
    from .state import packed_supported
    from .round import validate

    validate(cfg, topo)
    if not packed_supported(cfg, topo):
        raise NotImplementedError(
            "faults on the dense round are not ported yet (ROADMAP B12 "
            "rest); this configuration is outside the packed envelope"
        )
    return run_packed_faults(state, meta, cfg, topo, fplan, max_rounds,
                             telemetry)
