"""FaultPlan → sim tensors — the port of ``corrosion_tpu/sim/faults.py``:
both compiled forms of a plan, the per-edge fault queries the round
asks, the node faults, `run_fault_plan` on the packed round and on the
dense one, and the test-tier driver `run_fault_plan_checked`.

**The compiled plan.**  `compile_plan` lowers a `..faults.FaultPlan`
straight from its events, in numpy until one transfer to ``device``,
into JAX's fields, dtypes and shapes, in one of two forms:

- the matrix `SimFaultPlan` (JAX's below 1024 nodes): per-round
  ``[R+1, N, N]`` slabs — ``block`` (bool directed cut), ``loss`` (u8
  threshold p·256), ``delay`` and ``jitter`` (u8 rounds) — each None
  when the plan has none of its class.  Each distinct set of active link
  events is lowered once, by rectangles: every event merges into its
  ``src × dst`` cells (a symmetric partition into the transpose too,
  the diagonal never), as ``LinkFault.merge`` does pair by pair — the
  float64 loss fold from 0.0 in plan order, quantized once, delays
  adding, jitter taking the max, cuts OR-ing — so the slabs equal JAX's
  ``schedule()`` expansion byte for byte without its O(R·N²) Python;
- the factored `FactoredFaultPlan` (JAX's at storm scale): each link
  event one rank-1 term (active rounds ``[R+1]``, source and
  destination masks ``[N]``).

Both carry crash windows as a dense ``alive`` override ``i8[R+1, N]``
(-1 leaves the scenario's value) and ``wipe bool[R+1, N]``.  ``seed`` is
the plan seed's fold ``derive_seed(seed, "sim") & 0x7FFFFFFF``; it
lives on the host, like the round counter, because every fault key is
``fold_in(fold_in(phase_key, seed), tag)``.  `round_faults` slices a
round from either (`RoundFaults`, whose slabs are views of the plan's
rows, or `FactoredRoundFaults`).

**The edge queries.**  `fault_edge_block`, `fault_edge_loss`,
`fault_edge_delay` (overlapping delays add), `fault_edge_jitter`
(overlapping jitters take the max), `fault_session_refused`,
`fault_session_delay` (the slower direction of the pair), their
one-launch pairings `fault_wire_effects` (the broadcast's cuts,
thresholds, fault delay and jitter bound) and `fault_session_effects`,
and `fault_reach_` (`swim._reachable`'s fault branch) take either slice
and give the same per-edge outputs.  On the card a factored slice runs
K9 (``kernels/csrc/fault_edges.cu``; its latency entry when a call asks
for a delay, jitter or session delay) and a matrix slice K9's matrix
entry (gathers from the round's slabs), the plain versions beside them
on the CPU.  The per-(edge, payload) draws, wire loss and jitter, ride
the ring scatter (K10's streams, `packed.scatter_sending_lossy`), and
the session delays the sync's delay classes (K3's delay entry,
`packed.sync_pull`).  On the dense round the same draws ride K12's
fault entry (`broadcast.broadcast_send`) and the session delays K13's
delay entry (`sync.sync_pull_dense`).  `host_activity` is the host's
copy of each round's loss and jitter activity, which picks the round's
ring scatter without a device read.

**The node faults** (`apply_node_faults`) are K11's dense entry on the
dense state and its word entry (`packed.apply_round_faults`) on the
packed carry; a seed ensemble's lanes take their lane forms
(`apply_node_faults_lanes`, `fault_reach_lanes_`; the edge queries take
the lanes folded into their edge axis).

**The checked driver** `run_fault_plan_checked` runs the dense round a
round at a time with the sim invariant catalog
(`.invariants.check_state`) and the plan's coverage markers, and
returns a per-round digest list (the replay-determinism contract).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..faults import (
    NODE_KINDS,
    FaultPlan,
    _event_link_fault,
    derive_seed,
    sel_indices,
)
from ..kernels.build import check
from . import rng
from .state import (
    ALIVE,
    DOWN,
    PayloadMeta,
    SimConfig,
    SimState,
    complete_versions,
    version_active,
)
from .topology import Topology, aligned_u8_bits

#: fold_in tags of the fault draws (jax's, `fault_wire_effects` and
#: `swim._reachable`): per-(edge, payload) wire loss and jitter, per-edge
#: probe loss
WIRE_LOSS_TAG = 101
JITTER_TAG = 102
PROBE_LOSS_TAG = 103

#: auto-factor threshold: `compile_plan` lowers to the factored form at
#: or above this node count (JAX's FACTORED_MIN_NODES)
FACTORED_MIN_NODES = 1024

#: largest mutually-overlapping loss-event set the factored compiler
#: composes exactly (one factor per pairwise-overlapping subset)
MAX_OVERLAPPING_LOSS = 8


class SimFaultPlan(NamedTuple):
    """Stacked per-round fault slabs; a class the plan lacks is None
    (JAX's pytree structure).  Field order is JAX's."""

    block: Optional[torch.Tensor]   # bool[R+1, N, N] directed src→dst cut
    loss: Optional[torch.Tensor]    # u8[R+1, N, N] extra drop threshold
    delay: Optional[torch.Tensor]   # u8[R+1, N, N] fixed extra delay
    jitter: Optional[torch.Tensor]  # u8[R+1, N, N] max per-message delay
    alive: torch.Tensor   # i8[R+1, N] override: -1 none, else ALIVE/DOWN
    wipe: torch.Tensor    # bool[R+1, N]
    seed: torch.Tensor    # i32 scalar, on the host

    @property
    def horizon(self) -> int:
        """The plan's last row: every round from here on is fault-free."""
        return self.alive.shape[0] - 1


class RoundFaults(NamedTuple):
    """One round's slice of a SimFaultPlan: views of the plan's row (each
    slab a contiguous ``[N, N]``), None where the class is absent."""

    block: Optional[torch.Tensor]   # bool[N, N]
    loss: Optional[torch.Tensor]    # u8[N, N]
    delay: Optional[torch.Tensor]   # u8[N, N]
    jitter: Optional[torch.Tensor]  # u8[N, N]
    alive: torch.Tensor   # i8[N]
    wipe: torch.Tensor    # bool[N]
    seed: torch.Tensor    # i32 scalar, on the host


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


#: a compiled plan of either form, and a round's slice of either
AnyFaultPlan = Union[SimFaultPlan, FactoredFaultPlan]
AnyRoundFaults = Union[RoundFaults, FactoredRoundFaults]


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
) -> AnyFaultPlan:
    """Lower ``plan`` onto ``device``: a `FactoredFaultPlan`, or with
    ``factored=False`` the matrix `SimFaultPlan`; ``factored=None`` picks
    the factored form at ≥ FACTORED_MIN_NODES nodes and the matrix form
    below, as JAX does.  Both refuse a ring too short for the plan's
    delays (a wrapped slot would deliver early)."""
    if plan.n_nodes != cfg.n_nodes:
        raise ValueError(
            f"plan is for {plan.n_nodes} nodes, SimConfig has {cfg.n_nodes}"
        )
    _refuse_slow(plan)
    if factored is None:
        factored = cfg.n_nodes >= FACTORED_MIN_NODES
    if factored:
        return compile_plan_factored(plan, cfg, topo, device)
    return compile_plan_matrix(plan, cfg, topo, device)


def _node_rows(plan: FaultPlan, rounds: int):
    """The crash windows as the alive override i8[R+1, N] (DOWN over
    each window, then ALIVE at each restart, which wins a round two
    windows share) and the wipe rows bool[R+1, N]."""
    n = plan.n_nodes
    alive = np.full((rounds + 1, n), -1, np.int8)
    wipe = np.zeros((rounds + 1, n), np.bool_)
    crash_events = [ev for ev in plan.events if ev.kind == "crash"]
    for ev in crash_events:
        sel = sel_indices(ev.node, n)
        alive[ev.start:ev.end, sel.start:sel.stop] = DOWN
    for ev in crash_events:
        sel = sel_indices(ev.node, n)
        alive[ev.end, sel.start:sel.stop] = ALIVE
        if ev.wipe:
            wipe[ev.end, sel.start:sel.stop] = True
    return alive, wipe


def _check_envelope(topo: Topology, max_extra: int, cfg: SimConfig) -> None:
    base = max(topo.max_delay, 1)
    if base + max_extra >= cfg.n_delay_slots:
        raise ValueError(
            f"max edge delay {base + max_extra} rounds (topology {base} + "
            f"fault {max_extra}) needs n_delay_slots > {base + max_extra}, "
            f"got {cfg.n_delay_slots}"
        )


def _link_rects(plan: FaultPlan):
    """Each link event with its directed rectangles, in plan order: its
    ``src × dst`` ranges, and for a symmetric partition the transpose
    too (`FaultPlan._pairs` yields both (s, d) and (d, s), so a cell in
    both merges twice).  ``clock_skew`` and ``slow`` are node kinds;
    ``duplicate`` stays, merging as JAX's expansion merges it."""
    n = plan.n_nodes
    rects = []
    for ev in plan.events:
        if ev.kind in NODE_KINDS:
            continue
        sr, dr = sel_indices(ev.src, n), sel_indices(ev.dst, n)
        pieces = [(sr, dr)]
        if ev.kind == "partition" and ev.symmetric:
            pieces.append((dr, sr))
        rects.append((ev, pieces))
    return rects


def _matrix_round(active, n: int):
    """One round's merged link faults from its active link events, by
    rectangles: (block bool, loss u8, delay, jitter), the last two int32
    before the 255 check, or None where no active event carries one.
    Every cell folds its loss ``1 - (1 - p)(1 - pₑ)`` over the events
    covering it in plan order, from 0.0 (`LinkFault.merge` from CLEAR,
    also for events of other kinds, whose pₑ is 0: a fold that changes
    no p of 0, so it starts at the first loss event), then quantizes
    once: ``round(p·256)``, a cut at ≥ 256.  A cut cell keeps no
    threshold; the diagonal is clear."""
    p = delay = jitter = None
    blocked = np.zeros((n, n), np.bool_)
    for ev, pieces in active:
        lf = _event_link_fault(ev)
        for sr, dr in pieces:
            cells = (slice(sr.start, sr.stop), slice(dr.start, dr.stop))
            if lf.loss and p is None:
                p = np.zeros((n, n), np.float64)
            if p is not None:
                p[cells] = 1.0 - (1.0 - p[cells]) * (1.0 - lf.loss)
            if lf.delay_rounds:
                if delay is None:
                    delay = np.zeros((n, n), np.int32)
                delay[cells] += lf.delay_rounds
            if lf.jitter_rounds:
                if jitter is None:
                    jitter = np.zeros((n, n), np.int32)
                np.maximum(jitter[cells], lf.jitter_rounds,
                           out=jitter[cells])
            if lf.blocked:
                blocked[cells] = True
    loss = np.zeros((n, n), np.uint8)
    if p is not None:
        thr = np.rint(p * 256.0)
        blocked |= thr >= 256
        loss = np.where(blocked, 0, thr).astype(np.uint8)
    for x in (blocked, loss, delay, jitter):
        if x is not None:
            np.fill_diagonal(x, 0)
    return blocked, loss, delay, jitter


def _refuse_wide_delay(plan: FaultPlan, r: int) -> None:
    """JAX's refusal of a merged delay or jitter past 255 rounds, naming
    the first offending link of round r in its expansion order."""
    for f in plan.schedule_at(r).links.values():
        if f.delay_rounds > 255 or f.jitter_rounds > 255:
            raise ValueError(
                f"merged link delay/jitter ({f.delay_rounds}/"
                f"{f.jitter_rounds} rounds at round {r}) exceeds the "
                "255-round schedule grain"
            )


def compile_plan_matrix(
    plan: FaultPlan, cfg: SimConfig, topo: Topology = Topology(),
    device="cuda",
) -> SimFaultPlan:
    """Lower the plan into the matrix form straight from its events'
    rectangles (`_matrix_round`, once per distinct set of active link
    events), byte-equal to JAX's ``compile_plan(factored=False)``: the
    same slabs, the same None classes, the same refusals (a merged delay
    or jitter past 255 rounds, then the ring envelope)."""
    if plan.n_nodes != cfg.n_nodes:
        raise ValueError(
            f"plan is for {plan.n_nodes} nodes, SimConfig has {cfg.n_nodes}"
        )
    _refuse_slow(plan)
    dev = resolve_device(device)
    n, rounds = plan.n_nodes, plan.horizon
    rects = _link_rects(plan)
    sig_of, rows = [], {}
    for r in range(rounds + 1):
        sig = tuple(i for i, (ev, _) in enumerate(rects)
                    if ev.start <= r < ev.end)
        sig_of.append(sig)
        if sig not in rows:
            rows[sig] = _matrix_round([rects[i] for i in sig], n)
    max_extra = 0
    for sig, (_, _, delay, jitter) in rows.items():
        if any(x is not None and int(x.max()) > 255
               for x in (delay, jitter)):
            _refuse_wide_delay(plan, sig_of.index(sig))
        extra = sum(x for x in (delay, jitter) if x is not None)
        if not isinstance(extra, int):
            extra = int(extra.max())
        max_extra = max(max_extra, extra)
    _check_envelope(topo, max_extra, cfg)

    def slabs(cls, dtype):
        """The class's [R+1, N, N] tensor on the device from its distinct
        rows, or None when no row holds any of it."""
        held = {sig: row[cls] for sig, row in rows.items()
                if row[cls] is not None and row[cls].any()}
        if not held:
            return None
        on_dev = {sig: torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)
                  for sig, x in held.items()}
        out = torch.zeros((rounds + 1, n, n),
                          dtype=next(iter(on_dev.values())).dtype, device=dev)
        for r, sig in enumerate(sig_of):
            if sig in on_dev:
                out[r].copy_(on_dev[sig])
        return out

    alive, wipe = _node_rows(plan, rounds)
    fplan = SimFaultPlan(
        block=slabs(0, np.bool_), loss=slabs(1, np.uint8),
        delay=slabs(2, np.uint8), jitter=slabs(3, np.uint8),
        alive=torch.from_numpy(alive).to(dev),
        wipe=torch.from_numpy(wipe).to(dev),
        seed=torch.tensor(derive_seed(plan.seed, "sim") & 0x7FFFFFFF,
                          dtype=torch.int32),
    )
    active = {sig: RoundActivity(bool(row[1].any()), row[3] is not None
                                 and bool(row[3].any()))
              for sig, row in rows.items()}
    setattr(fplan.alive, _ACTIVITY_ATTR, [active[sig] for sig in sig_of])
    return fplan


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
    alive, wipe = _node_rows(plan, rounds)
    blocks, losses, delays, jitters = [], [], [], []
    loss_events = []

    def _act(ev):
        a = np.zeros(rounds + 1, np.bool_)
        a[ev.start:ev.end] = True
        return a

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

    _check_envelope(topo, _max_extra_delay(plan, n), cfg)

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
    fplan = FactoredFaultPlan(
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

    def rounds_of(terms):
        on = np.zeros(rounds + 1, np.bool_)
        for term in terms:
            on |= term[0]
        return on.tolist()

    setattr(fplan.alive, _ACTIVITY_ATTR, [
        RoundActivity(a, b)
        for a, b in zip(rounds_of(losses), rounds_of(jitters))])
    return fplan


def round_faults(fplan: AnyFaultPlan, t: int) -> AnyRoundFaults:
    """Round ``t``'s slice of either form; past the horizon every round
    reads the final all-clear row (an index clamp, not a wrap).  A
    matrix slice's slabs are views of the plan's row ``t``."""
    i = min(int(t), fplan.horizon)
    if isinstance(fplan, SimFaultPlan):
        return RoundFaults(
            block=None if fplan.block is None else fplan.block[i],
            loss=None if fplan.loss is None else fplan.loss[i],
            delay=None if fplan.delay is None else fplan.delay[i],
            jitter=None if fplan.jitter is None else fplan.jitter[i],
            alive=fplan.alive[i], wipe=fplan.wipe[i], seed=fplan.seed,
        )
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


class RoundActivity(NamedTuple):
    """Host bools of one round: does any loss, or any jitter, apply in
    it."""

    loss: bool
    jitter: bool


#: the attribute of a compiled plan's ``alive`` tensor that carries its
#: `host_activity` (the plan's fields are JAX's, so it rides a tensor)
_ACTIVITY_ATTR = "host_activity"


def host_activity(fplan: AnyFaultPlan) -> list:
    """Each round's `RoundActivity`, rounds 0..horizon, on the host, for
    each round's choice of ring scatter (`packed.broadcast_packed`).
    `compile_plan` keeps the copy from the numpy it compiled, so no run
    reads the device for it; a plan made elsewhere (`convert.
    fault_plan_from_numpy`) is read once."""
    known = getattr(fplan.alive, _ACTIVITY_ATTR, None)
    if known is not None:
        return known
    rows = fplan.alive.shape[0]
    if isinstance(fplan, SimFaultPlan):
        def any_row(x):
            if x is None:
                return [False] * rows
            return x.reshape(rows, -1).any(dim=1).cpu().tolist()

        loss, jitter = any_row(fplan.loss), any_row(fplan.jitter)
    else:
        loss = fplan.loss_active.any(dim=0).cpu().tolist()
        jitter = fplan.jitter_active.any(dim=0).cpu().tolist()
    return [RoundActivity(a, b) for a, b in zip(loss, jitter)]


# -- per-edge fault evaluation ------------------------------------------------


def _has(faults, cls: str) -> bool:
    """Does the plan hold any fault of class ``cls`` ("block", "loss",
    "delay", "jitter")?  A plan's fact, not a round's: JAX's trace-time
    None (matrix) or K = 0 (factored)."""
    if isinstance(faults, RoundFaults):
        return getattr(faults, cls) is not None
    return getattr(faults, f"{cls}_src").shape[0] > 0


def _factored_hits(on, src_m, dst_m, src, dst) -> torch.Tensor:
    """bool[K, E]: factor k applies to edge e this round.  Self-edges
    never fault (the probe relay legs do evaluate (x, x) edges)."""
    s, d = src.long(), dst.long()
    return on[:, None] & src_m[:, s] & dst_m[:, d] & (src != dst)[None, :]


def _gather(slab, src, dst) -> torch.Tensor:
    """A matrix slab's cells at the edges (JAX's ``slab[src, dst]``)."""
    return slab[src.long(), dst.long()]


def _block_plain(faults, src, dst) -> torch.Tensor:
    if isinstance(faults, RoundFaults):
        return _gather(faults.block, src, dst)
    return _factored_hits(
        faults.block_on, faults.block_src, faults.block_dst, src, dst
    ).any(dim=0)


def _loss_plain(faults, src, dst) -> torch.Tensor:
    if isinstance(faults, RoundFaults):
        return _gather(faults.loss, src, dst)
    hit = _factored_hits(
        faults.loss_on, faults.loss_src, faults.loss_dst, src, dst
    )
    zero = torch.zeros((), dtype=torch.uint8, device=src.device)
    return torch.where(hit, faults.loss_thr[:, None], zero).amax(dim=0)


def _delay_plain(faults, src, dst) -> torch.Tensor:
    """i32[E]: overlapping delay factors ADD (the matrix cell holds the
    merged sum)."""
    if isinstance(faults, RoundFaults):
        return _gather(faults.delay, src, dst).to(torch.int32)
    hit = _factored_hits(
        faults.delay_on, faults.delay_src, faults.delay_dst, src, dst
    )
    return torch.where(hit, faults.delay_rounds[:, None], 0).sum(
        dim=0, dtype=torch.int32)


def _jitter_plain(faults, src, dst) -> torch.Tensor:
    """i32[E]: overlapping jitter factors take the max (0 where none
    hits; the matrix cell holds the merged max)."""
    if isinstance(faults, RoundFaults):
        return _gather(faults.jitter, src, dst).to(torch.int32)
    hit = _factored_hits(
        faults.jitter_on, faults.jitter_src, faults.jitter_dst, src, dst
    )
    vals = torch.where(hit, faults.jitter_rounds[:, None], 0)
    if vals.shape[0] == 0:
        return torch.zeros(src.shape, dtype=torch.int32, device=src.device)
    return vals.amax(dim=0).to(torch.int32)


def _session_delay_plain(faults, src, dst) -> torch.Tensor:
    return torch.maximum(_delay_plain(faults, src, dst),
                         _delay_plain(faults, dst, src))


def _factor_args(name, on, sm, dm, use: bool, n: int):
    """One factor class's pointers (on bits, masks) and ints (K, the on
    column's stride) after the wrapper-side checks; a class left out
    passes K = 0."""
    check(f"{name} src mask", sm, torch.bool, (sm.shape[0], n))
    check(f"{name} dst mask", dm, torch.bool, (sm.shape[0], n))
    if not on.is_cuda or on.dtype != torch.bool or on.shape != (
            sm.shape[0],):
        raise ValueError("factor on bits must be a CUDA bool [K] view")
    k = sm.shape[0] if use else 0
    return [on, sm, dm], [k, on.stride(0) if on.numel() else 0]


def _k9_args(faults, src, dst, blocks: bool, losses: bool):
    """K9's block and loss factor pointers and ints (kb, b_stride, kl,
    l_stride) after the wrapper-side checks, then n and e."""
    n = faults.alive.shape[0]
    e = src.shape[0]
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (e,))
    bp, bi = _factor_args("block", faults.block_on, faults.block_src,
                          faults.block_dst, blocks, n)
    lp, li = _factor_args("loss", faults.loss_on, faults.loss_src,
                          faults.loss_dst, losses, n)
    check("loss_thr", faults.loss_thr, torch.uint8,
          (faults.loss_src.shape[0],))
    return bp + lp + [faults.loss_thr, src, dst], bi + li + [n, e]


def _slab_args(faults, src, dst, use):
    """K9m's slab pointers (block, loss, delay, jitter; None for a class
    absent or left out by ``use``) after the wrapper-side checks, and
    n, e."""
    n = faults.alive.shape[0]
    e = src.shape[0]
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (e,))
    ptrs = []
    for cls, dtype in (("block", torch.bool), ("loss", torch.uint8),
                       ("delay", torch.uint8), ("jitter", torch.uint8)):
        slab = getattr(faults, cls)
        if slab is None or cls not in use:
            ptrs.append(None)
            continue
        check(cls, slab, dtype, (n, n))
        ptrs.append(slab)
    return ptrs, n, e


def _count_into(count, cleared) -> None:
    """Add the ok edges a cut clears (bool[E]) to the flight recorder's
    int64 accumulator ``count``, in place: a 0-d slot, or on a seed
    ensemble's lanes (the lanes folded into the edge axis) a ``[K]``
    view of the lanes' slots, lane k counting its own E / K edges."""
    if count.dim() == 0:
        count += cleared.sum()
    else:
        count += cleared.view(count.shape[0], -1).sum(dim=1)


def _count_args(count, e: int):
    """K9's count stride ints (lane_edges, count_stride): one lane of all
    ``e`` edges for a 0-d accumulator, else ``count``'s K lanes (a
    strided [K] view of the lanes' int64 slots) of e / K edges each."""
    if count is None or count.dim() == 0:
        if count is not None:
            check("count", count, torch.int64, ())
        return [0, 0]
    lanes = count.shape[0]
    if (not count.is_cuda or count.dtype != torch.int64 or count.dim() != 1
            or lanes <= 0 or e % lanes):
        raise ValueError(f"count must be a CUDA int64 [K] view with K "
                         f"dividing the {e} edges, got {tuple(count.shape)}")
    return [e // lanes, count.stride(0)]


def _fault_edges(faults, src, dst, blocks, losses, cut=False, thr=False,
                 ok=None, sym=False, count=None, delay=False, jit=False,
                 sdelay=False):
    """One K9 query launch (a factored slice) or K9m launch (a matrix
    slice): the cut (with ``sym`` OR the reversed edge's) and/or the
    threshold as new tensors, and/or ``ok`` cleared in place on a cut,
    adding the ok edges it clears to the int64 accumulator ``count`` when
    given (a ``[K]`` view on lanes: each lane's edges into its own slot,
    through the recording launchers counted apart); with ``delay``,
    ``jit`` or ``sdelay`` also the fault delay, jitter bound or session
    delay as new i32[E] tensors (K9's latency entry).  Returns (cut,
    thr, delay, jit, sdelay), None for each output not asked for."""
    e = src.shape[0]

    def out(want, dtype):
        return torch.empty(e, dtype=dtype, device=src.device) if want else None

    outs = (out(cut, torch.bool), out(thr, torch.uint8),
            out(delay, torch.int32), out(jit, torch.int32),
            out(sdelay, torch.int32))
    if ok is not None:
        check("ok", ok, torch.bool, (e,))
    lane_ints = _count_args(count, e)
    lanes = lane_ints[0] > 0
    if isinstance(faults, RoundFaults):
        use = {c for c, on in (("block", blocks), ("loss", losses),
                               ("delay", delay or sdelay), ("jitter", jit))
               if on}
        slabs, n, _ = _slab_args(faults, src, dst, use)
        kernel = (kernels.FAULT_EDGES_MATRIX_LANES_COUNT if lanes
                  else kernels.FAULT_EDGES_MATRIX)
        kernel.launch(
            slabs + [src, dst, outs[0], outs[1], ok, count, *outs[2:]],
            [n, e, int(sym)] + lane_ints)
        return outs
    ptrs, ints = _k9_args(faults, src, dst, blocks, losses)
    n = ints[-2]
    latency = delay or jit or sdelay
    dp, di = _factor_args("delay", faults.delay_on, faults.delay_src,
                          faults.delay_dst, delay or sdelay, n)
    jp, ji = _factor_args("jitter", faults.jitter_on, faults.jitter_src,
                          faults.jitter_dst, jit, n)
    check("delay_rounds", faults.delay_rounds, torch.int32,
          (faults.delay_src.shape[0],))
    check("jitter_rounds", faults.jitter_rounds, torch.int32,
          (faults.jitter_src.shape[0],))
    if lanes:
        kernel = (kernels.FAULT_EDGES_DELAY_LANES_COUNT if latency
                  else kernels.FAULT_EDGES_LANES_COUNT)
    else:
        kernel = (kernels.FAULT_EDGES_DELAY if latency
                  else kernels.FAULT_EDGES)
    kernel.launch(
        ptrs[:7] + dp + [faults.delay_rounds] + jp + [faults.jitter_rounds]
        + ptrs[7:] + [outs[0], outs[1], ok, count, *outs[2:]],
        ints[:4] + di + ji + [n, e, int(sym)] + lane_ints,
    )
    return outs


def fault_edge_block(faults: AnyRoundFaults, src, dst):
    """bool[E] directed-cut mask at the given edges, or None when the
    plan schedules no cuts.  K9 (K9m on a matrix slice) on the card."""
    if not _has(faults, "block"):
        return None
    if src.device.type == "cpu":
        return _block_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, True, False, cut=True)[0]


def fault_edge_loss(faults: AnyRoundFaults, src, dst):
    """u8[E] extra-loss threshold (p·256) at the given edges — the
    matrix cell, or the max of the hitting factors' thresholds — or None
    when the plan has no loss.  K9 (K9m) on the card."""
    if not _has(faults, "loss"):
        return None
    if src.device.type == "cpu":
        return _loss_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, False, True, thr=True)[1]


def fault_edge_delay(faults: AnyRoundFaults, src, dst):
    """i32[E] extra fixed delay (rounds) at the given edges — the SUM of
    the hitting delay events' rounds — or None when the plan has no
    delay.  K9's latency entry (K9m) on the card."""
    if not _has(faults, "delay"):
        return None
    if src.device.type == "cpu":
        return _delay_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, False, False, delay=True)[2]


def fault_edge_jitter(faults: AnyRoundFaults, src, dst):
    """i32[E] bound on the per-message extra delay at the given edges —
    the MAX of the hitting jitter events' rounds — or None when the plan
    has no jitter.  K9's latency entry (K9m) on the card."""
    if not _has(faults, "jitter"):
        return None
    if src.device.type == "cpu":
        return _jitter_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, False, False, jit=True)[3]


def fault_session_refused(faults: AnyRoundFaults, src, dst, ok=None,
                          count=None):
    """bool[E] (or None): the sync session is refused — a cut in EITHER
    direction kills the bidirectional stream.  With ``ok`` the refused
    sessions are also cleared from it in place, and with ``count`` (an
    int64 accumulator, the flight recorder's; a ``[K]`` view of the
    lanes' slots when the edges are K lanes folded) the ok sessions
    refused are added to it.  K9 (K9m) on the card."""
    if not _has(faults, "block"):
        return None
    if src.device.type == "cpu":
        refused = _block_plain(faults, src, dst) | _block_plain(faults, dst,
                                                                src)
        if ok is not None:
            if count is not None:
                _count_into(count, ok & refused)
            ok &= ~refused
        return refused
    return _fault_edges(faults, src, dst, True, False, cut=True, sym=True,
                        ok=ok, count=count)[0]


def fault_session_delay(faults: AnyRoundFaults, src, dst):
    """i32[E] (or None without delay): the extra sync-session RTT — the
    slower direction of the pair, max(delay(src, dst), delay(dst, src)),
    bounds the bidirectional stream; jitter stays out (the reliable
    stream smooths it).  K9's latency entry (K9m) on the card."""
    if not _has(faults, "delay"):
        return None
    if src.device.type == "cpu":
        return _session_delay_plain(faults, src, dst)
    return _fault_edges(faults, src, dst, False, False, sdelay=True)[4]


def fault_session_effects(faults: AnyRoundFaults, src, dst, ok=None,
                          count=None):
    """(`fault_session_refused`, `fault_session_delay`) of the same
    edges, with the same ``ok`` and ``count``, from one K9 (K9m) launch
    on the card (two queries' work in one pass).  A plan without delay
    makes exactly `fault_session_refused`'s call."""
    if not _has(faults, "delay"):
        return fault_session_refused(faults, src, dst, ok, count), None
    if src.device.type == "cpu":
        return (fault_session_refused(faults, src, dst, ok, count),
                _session_delay_plain(faults, src, dst))
    has_block = _has(faults, "block")
    outs = _fault_edges(faults, src, dst, has_block, False, cut=has_block,
                        sym=True, ok=ok if has_block else None,
                        count=count if has_block else None, sdelay=True)
    return outs[0], outs[4]


def fault_wire_effects(faults: AnyRoundFaults, src, dst, ok, cut=None):
    """The broadcast's fault seam, its per-edge half: cuts clear ``ok``
    IN PLACE (adding the ok edges they sever to the int64 accumulator
    ``cut`` when given, the flight recorder's: a ``[K]`` view of the
    lanes' slots when the edges are K lanes folded); returns (ok, thr,
    delay, jit) — the u8[E] extra-loss thresholds, the i32[E] fault
    delay that adds to the topology's, and the i32[E] jitter bound, each
    None when the plan has no fault of its class.  The per-(edge,
    payload) draws JAX makes here — the loss bits it ORs into ``drop``
    (fold_in key 101 on the broadcast phase key) and the jitter it adds
    to each payload's delay (fold_in key 102, ``randint(0, 2^31 - 1) %
    (jit + 1)`` where jit > 0) — are made by the ring scatter that
    consumes these
    (`packed.scatter_sending_lossy`, K10's streams).  One K9 launch on
    the card (the latency entry when the plan has delay or jitter), or
    one K9m launch for a matrix slice."""
    has_block = _has(faults, "block")
    has_loss = _has(faults, "loss")
    has_delay = _has(faults, "delay")
    has_jit = _has(faults, "jitter")
    if not (has_block or has_loss or has_delay or has_jit):
        return ok, None, None, None
    if src.device.type == "cpu":
        if has_block:
            hit = _block_plain(faults, src, dst)
            if cut is not None:
                _count_into(cut, ok & hit)
            ok &= ~hit
        return (ok,
                _loss_plain(faults, src, dst) if has_loss else None,
                _delay_plain(faults, src, dst) if has_delay else None,
                _jitter_plain(faults, src, dst) if has_jit else None)
    _, thr, delay, jit, _ = _fault_edges(
        faults, src, dst, has_block, has_loss, thr=has_loss,
        ok=ok if has_block else None, count=cut if has_block else None,
        delay=has_delay, jit=has_jit,
    )
    return ok, thr, delay, jit


def fault_key(key: torch.Tensor, seed: int, tag: int) -> torch.Tensor:
    """``fold_in(fold_in(key, seed), tag)``: the key of a fault draw, from
    its phase key, the plan's seed and the draw's tag."""
    return rng.fold_in(rng.fold_in(key, seed), tag)


def fault_reach_plain(ok, faults, key, src, dst) -> torch.Tensor:
    """Plain version of K9's reach entry and K9m's, in place."""
    if _has(faults, "block"):
        ok &= ~_block_plain(faults, src, dst)
    if _has(faults, "loss"):
        thr = _loss_plain(faults, src, dst)
        bits = aligned_u8_bits(
            fault_key(key, int(faults.seed), PROBE_LOSS_TAG),
            tuple(src.shape),
        )
        ok &= ~(bits < thr)
    return ok


def fault_reach_(ok, faults: AnyRoundFaults, key, src, dst):
    """The fault branch of `swim._reachable`, in place on bool[E] ``ok``:
    directed cuts, then the per-edge loss draw (fold_in key 103 on the
    probe's loss key) against the edge's threshold.  K9's reach entry on
    the card, K9m's for a matrix slice."""
    if src.device.type == "cpu":
        return fault_reach_plain(ok, faults, key, src, dst)
    if not (_has(faults, "block") or _has(faults, "loss")):
        return ok
    check("ok", ok, torch.bool, (src.shape[0],))
    check("key", key, torch.int64, (2,))
    if isinstance(faults, RoundFaults):
        slabs, n, e = _slab_args(faults, src, dst, ("block", "loss"))
        kernels.FAULT_REACH_MATRIX.launch(
            slabs[:2] + [src, dst, key, ok],
            [n, e, int(faults.seed), PROBE_LOSS_TAG])
        return ok
    ptrs, ints = _k9_args(faults, src, dst, True, True)
    kernels.FAULT_REACH.launch(
        ptrs + [key, ok], ints + [int(faults.seed), PROBE_LOSS_TAG]
    )
    return ok


def fault_reach_lanes_plain(ok, faults, keys, src, dst,
                            seeds) -> torch.Tensor:
    """Plain version of K9's reach lane entry and K9m's, in place on ok
    [K, E]: the plan's cuts and thresholds at the lanes' edges
    (lane-local ids; the plan is shared), and lane k's loss draw
    ``aligned_u8_bits(fold_in(fold_in(keys[k], seeds[k]), 103), [E])``."""
    lanes, e = src.shape
    src, dst = src.reshape(-1), dst.reshape(-1)
    if _has(faults, "block"):
        ok &= ~_block_plain(faults, src, dst).reshape(lanes, e)
    if _has(faults, "loss"):
        thr = _loss_plain(faults, src, dst).reshape(lanes, e)
        fk = rng.fold_in_lanes_plain(rng.fold_in_lanes_plain(keys, seeds),
                                     PROBE_LOSS_TAG)
        words = rng.bits_lanes_plain(fk, (-(-e // 4),))
        shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=ok.device)
        bits = ((words[..., None] >> shifts) & 0xFF).to(torch.uint8)
        ok &= ~(bits.reshape(lanes, -1)[:, :e] < thr)
    return ok


def fault_reach_lanes_(ok, faults: AnyRoundFaults, keys, src, dst, seeds):
    """`fault_reach_` over the seed ensemble's lanes, in place on bool
    [K, E] ``ok``: src and dst [K, E] lane-local ids, ``keys`` [K, 2] the
    lanes' loss keys and ``seeds`` i32[K] their plan seeds (only the seed
    is batched; the round slice, of either form, is shared).  K9's reach
    lane entry on the card, K9m's for a matrix slice."""
    if src.device.type == "cpu":
        return fault_reach_lanes_plain(ok, faults, keys, src, dst, seeds)
    if not (_has(faults, "block") or _has(faults, "loss")):
        return ok
    lanes, e = src.shape
    check("ok", ok, torch.bool, (lanes, e))
    check("keys", keys, torch.int64, (lanes, 2))
    check("seeds", seeds, torch.int32, (lanes,))
    check("dst", dst, torch.int32, (lanes, e))
    if isinstance(faults, RoundFaults):
        slabs, n, _ = _slab_args(faults, src.reshape(-1), dst.reshape(-1),
                                 ("block", "loss"))
        kernels.FAULT_REACH_MATRIX_LANES.launch(
            slabs[:2] + [src, dst, keys, ok, seeds],
            [n, e, PROBE_LOSS_TAG, lanes])
        return ok
    ptrs, ints = _k9_args(faults, src.reshape(-1), dst.reshape(-1), True,
                          True)
    # _k9_args checked the flattened edges; the lane entry takes [K, e]
    kernels.FAULT_REACH_LANES.launch(
        ptrs + [keys, ok, seeds], ints[:4] + [ints[4], e, PROBE_LOSS_TAG,
                                               lanes])
    return ok


# -- node faults --------------------------------------------------------------


def _zero_rows_(x: torch.Tensor, rows: torch.Tensor, node_dim: int,
                fill=0) -> None:
    if x.numel() == 0:
        return
    shape = [1] * x.dim()
    shape[node_dim] = rows.shape[0]
    x.copy_(torch.where(rows.reshape(shape), fill, x))


def apply_node_faults_plain(state: SimState,
                            rf: AnyRoundFaults) -> SimState:
    """Plain version of K11's dense entry (and, on the packed loop's
    slim state, whose payload tensors are zero-width, of its node half),
    in place."""
    state.alive.copy_(torch.where(
        rf.alive >= 0, rf.alive.to(state.alive.dtype), state.alive
    ))
    w = rf.wipe
    for x in (state.have, state.relay_left, state.heads, state.gap_lo,
              state.gap_hi, state.view, state.vinc):
        _zero_rows_(x, w, 0)
    for x in (state.inflight, state.sync_inflight):
        _zero_rows_(x, w, 1)
    for x in (state.suspect_since, state.pid, state.pkey, state.psince,
              state.pview):
        _zero_rows_(x, w, 0, -1)
    return state


#: the tables `apply_node_faults` writes in place beyond the dense round's
#: own: a fault loop gives each a tensor of its own first
NODE_FAULT_TABLES = ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey",
                     "psince", "pview")


def apply_node_faults(state: SimState, rf: AnyRoundFaults) -> SimState:
    """Crash, restart and wipe, before the round's phases, IN PLACE: the
    alive override, then on wiped nodes zeroed payload rows (have, relay
    budgets, their row in every slot of both delivery rings),
    bookkeeping (heads, gaps), the full view's row back to its
    optimistic init (view and vinc 0, suspect_since -1), an empty
    member table (pid, pkey, psince -1) and an empty PeerSwap view
    (pview -1), so the node rejoins cold and recovers through
    anti-entropy.  K11's dense entry on the card
    (the dense state's u8 rows); the packed loop's slim state and carry
    take K11's word entry (`packed.apply_round_faults`)."""
    if state.alive.device.type == "cpu":
        return apply_node_faults_plain(state, rf)
    _launch_node_faults_dense(state, rf)
    return state


def _launch_node_faults_dense(state: SimState, rf: AnyRoundFaults,
                              lanes: Optional[int] = None) -> None:
    """K11's dense entry on a solo state, or with ``lanes`` its lane entry
    on stacked states (every per-node tensor [K, ...]), after the
    wrapper-side checks."""
    lead = () if lanes is None else (lanes,)
    n, p = state.have.shape[-2:]
    d = state.inflight.shape[-3]
    a = state.heads.shape[-1]
    ak = state.gap_lo.shape[-2] * state.gap_lo.shape[-1]
    m = state.pid.shape[-1]
    fv = state.view.shape[-1]
    v = state.pview.shape[-1]
    check("rf.alive", rf.alive, torch.int8, (n,))
    check("rf.wipe", rf.wipe, torch.bool, (n,))
    check("alive", state.alive, torch.uint8, lead + (n,))
    for name in ("have", "relay_left"):
        check(name, getattr(state, name), torch.uint8, lead + (n, p))
    for name in ("inflight", "sync_inflight"):
        check(name, getattr(state, name), torch.uint8, lead + (d, n, p))
    check("heads", state.heads, torch.int32, lead + (n, a))
    for name in ("gap_lo", "gap_hi"):
        check(name, getattr(state, name), torch.int32, state.gap_lo.shape)
    for name in ("pid", "pkey", "psince"):
        check(name, getattr(state, name), torch.int32, lead + (n, m))
    check("view", state.view, torch.int8, lead + (fv, fv))
    for name in ("vinc", "suspect_since"):
        check(name, getattr(state, name), torch.int32, lead + (fv, fv))
    if fv not in (0, n):
        raise ValueError("the full view must be [N, N] or empty")
    check("pview", state.pview, torch.int32, lead + (n, v))
    kernel = (kernels.NODE_FAULTS_DENSE if lanes is None
              else kernels.NODE_FAULTS_DENSE_LANES)
    kernel.launch(
        [rf.alive, rf.wipe, state.alive, state.have, state.relay_left,
         state.inflight, state.sync_inflight, state.heads, state.gap_lo,
         state.gap_hi, state.pid, state.pkey, state.psince, state.view,
         state.vinc, state.suspect_since, state.pview],
        [n, p, d, a, ak, m, fv, v] + list(lead),
    )


def _lane_states(states: SimState):
    """Each lane of stacked states as a solo state of views (``t``, one
    host scalar, shared): what the solo plain versions take."""
    lanes = states.alive.shape[0]
    return [SimState(*(states.t if name == "t" else getattr(states, name)[k]
                       for name in SimState._fields))
            for k in range(lanes)]


def apply_node_faults_lanes_plain(states: SimState,
                                  rf: AnyRoundFaults) -> SimState:
    """Plain version of K11d's lane entry: the solo plain version on each
    lane's slices, in place."""
    for lane in _lane_states(states):
        apply_node_faults_plain(lane, rf)
    return states


def apply_node_faults_lanes(states: SimState,
                            rf: AnyRoundFaults) -> SimState:
    """`apply_node_faults` over the seed ensemble's lanes on the dense
    round, IN PLACE: the round's shared alive overrides and wipes
    (``rf.alive``, ``rf.wipe`` [N]; JAX shares the schedule unbatched,
    ``ensemble.py:147-158``) hit every lane's rows — have and relay
    [K, N, P], both rings [K, D, N, P], heads, gaps, the member tables,
    the full view [K, N, N] and the PeerSwap view.  K11d's lane entry on
    the card."""
    if states.alive.device.type == "cpu":
        return apply_node_faults_lanes_plain(states, rf)
    _launch_node_faults_dense(states, rf, states.alive.shape[0])
    return states


def all_have(state: SimState, meta: PayloadMeta, cfg: SimConfig):
    """Every up node holds every injected version completely, computed
    FRESH from ``have`` (JAX ``_all_have``: the sticky ``converged_at``
    must not mask a wipe after convergence); a device bool.  The dense
    fault loop takes it from K14's exit mode after each round and
    evaluates it here only before the first."""
    up = state.alive == ALIVE
    comp = complete_versions(state.have, cfg)
    act = version_active(state.injected, cfg)
    node_done = (comp | ~act[None]).all(dim=2).all(dim=1) | ~up
    return (meta.round <= int(state.t)).all() & node_done.all()


# -- the run loops -----------------------------------------------------------


def _own_fault_state(state: SimState) -> SimState:
    """``state`` with tensors of its own wherever the dense round and the
    node faults write in place."""
    from .round import own_state

    state = own_state(state)
    return state._replace(**{name: getattr(state, name).clone()
                             for name in NODE_FAULT_TABLES})


def run_fault_plan(
    state: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology,
    fplan: AnyFaultPlan,
    max_rounds: int = 1000,
    telemetry: bool = False,
):
    """Advance rounds under the fault schedule until the cluster holds
    every payload AND the schedule is exhausted (a plan may crash a node
    after convergence), or ``max_rounds``; returns (SimState,
    RunMetrics), and with ``telemetry`` the run's `.telemetry.RoundTrace`
    third (each row with its round's crashes and wipes).  The packed
    envelope runs `.packed.run_packed_faults`, every other configuration
    the dense round: before each round its node faults
    (`apply_node_faults`), then the round with its fault slice; the loop
    never exits before the plan's horizon, then only on the fresh
    all-have predicate (`all_have`, K14's exit mode).  Each round's loss
    and jitter activity is copied to the host once (`host_activity`)."""
    from .packed import run_packed_faults
    from .round import new_metrics, round_step_, validate
    from .state import packed_supported
    from .telemetry import new_trace
    from .topology import regions

    validate(cfg, topo)
    if packed_supported(cfg, topo):
        return run_packed_faults(state, meta, cfg, topo, fplan, max_rounds,
                                 telemetry)
    dev = state.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    state = _own_fault_state(state)
    horizon = fplan.horizon
    activity = host_activity(fplan)
    trace = new_trace(cfg, max_rounds, dev) if telemetry else None
    done = (torch.zeros((), dtype=torch.bool, device=dev)
            if int(state.t) < horizon else all_have(state, meta, cfg))
    while int(state.t) < max_rounds and not bool(done):
        t = int(state.t)
        rf = round_faults(fplan, t)
        state = apply_node_faults(state, rf)
        state, metrics, done = round_step_(
            state, metrics, meta, cfg, topo, region, trace, faults=rf,
            horizon=horizon, active=activity[min(t, horizon)],
        )
    if telemetry:
        return state, metrics, trace
    return state, metrics


def run_fault_plan_checked(
    plan: FaultPlan,
    state: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology = Topology(),
    max_rounds: int = 1000,
    check_every: int = 1,
    catalog=None,
):
    """The test-tier driver (JAX ``run_fault_plan_checked``): the same
    schedule, compiled in JAX's default form (`compile_plan` with
    ``factored=None``: the matrix form below 1024 nodes), one dense
    round at a time whatever the envelope, with the sim invariant
    catalog (`.invariants.check_state`) asserted every ``check_every``
    rounds and the plan's coverage markers fired on ``catalog`` (the
    port's `..invariants.CATALOG` by default) as its faults take effect
    (``fault-<kind>-active``, from ``schedule_at(min(r, horizon))``).
    Stops past the horizon once every up node holds every injected
    version (fresh), or after ``max_rounds``.  Returns (state, metrics,
    digests): ``digests`` is each round's blake2b-8 over ``have``,
    ``alive`` and ``heads`` in JAX's dtypes and byte order — the same
    seed gives the same list (the replay-determinism contract).  The
    catalog gets the payloads' ``meta``, so under ``ordering="fifo"`` it
    also asserts the delivery-order property every checked round (JAX's
    driver leaves ``meta`` out, and with it that check)."""
    import hashlib

    from ..invariants import CATALOG
    from .invariants import check_state
    from .round import new_metrics, round_step_, validate
    from .topology import regions
    from .words import unpack_bits

    catalog = catalog or CATALOG
    validate(cfg, topo)
    dev = state.have.device
    fplan = compile_plan(plan, cfg, topo, device=dev)
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    state = _own_fault_state(state)
    if state.inflight.dtype != torch.uint8:  # built for the packed round
        state = state._replace(inflight=unpack_bits(
            state.inflight, cfg.n_payloads).to(torch.uint8))
    digests = []
    for r in range(max_rounds):
        rf = round_faults(fplan, int(state.t))
        state = apply_node_faults(state, rf)
        for kind in plan.schedule_at(min(r, plan.horizon)).active_kinds():
            catalog.sometimes(True, f"fault-{kind}-active")
        state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                        region, faults=rf)
        h = hashlib.blake2b(digest_size=8)
        for name in ("have", "alive", "heads"):
            h.update(getattr(state, name).cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        if r % check_every == 0:
            check_state(state, cfg, meta=meta)
        if r >= plan.horizon and bool(all_have(state, meta, cfg)):
            break
    return state, metrics, digests
