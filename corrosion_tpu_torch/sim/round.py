"""The round and its run loop — the port of ``corrosion_tpu/sim/round.py``:
`round_step` (the dense round on JAX's u8 state, with or without a fault
plan's round slice) and `run_to_convergence`,
which takes the packed envelope to `.packed.run_packed` and runs the
dense round otherwise, either with the flight recorder
(``telemetry=True``, `.telemetry`).  Mesh sharding (ROADMAP B17) is not
ported; asking for it raises instead of silently running something
else.

One dense round is (under PeerSwap the view swap, then) inject →
broadcast → sync → deliver → SWIM → bookkeeping refresh → convergence
record, phase for phase and draw for
draw JAX's.  Its last two phases are one function here,
`dense_record`: heads, the K gap slots, the overflow count, both
convergence stamps and the run's exit flag, from ``have`` in one pass —
K14 (``kernels/csrc/dense_gaps.cu``, a rows pass and a one-block finish)
on the card, the JAX composition on the CPU.

The phases update the state's payload tensors and beliefs in place:
`round_step` clones a caller's state first, `run_to_convergence` once
for the whole loop, which reads K14's done flag once per round.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..kernels.build import check
from ..proto.ordering import order_checked
from . import rng
from .state import (
    ALIVE,
    PayloadMeta,
    SimConfig,
    SimState,
    complete_versions,
    grid_to_payload,
    init_state,
    packed_supported,
    touched_versions,
    version_active,
    version_heads,
)
from .telemetry import (
    COVERAGE,
    GRANTS,
    coverage_delivered_dense_,
    new_trace,
    record_row,
    trace_row,
)
from .topology import Topology, regions


class RunMetrics(NamedTuple):
    """Per-run convergence record; field order is JAX's ``RunMetrics``."""

    coverage_at: torch.Tensor  # i32[P]
    converged_at: torch.Tensor  # i32[N]
    overflow_frac: torch.Tensor  # f32 scalar
    # i32 scalar: the delivery-order count of an ordering variant (K22,
    # `.invariants.count_order_violations_`), summed every round; 0 under
    # ordering="none"
    order_violations: torch.Tensor


def new_metrics(cfg: SimConfig, device) -> RunMetrics:
    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return RunMetrics(
        coverage_at=full((cfg.n_payloads,), -1),
        converged_at=full((cfg.n_nodes,), -1),
        overflow_frac=full((), 0.0, torch.float32),
        order_violations=full((), 0),
    )


def validate(cfg: SimConfig, topo: Topology) -> None:
    """The delay ring must represent every edge delay (sync uses t+1),
    and the degree classes must fit inside the fan-out slots."""
    max_delay = max(topo.max_delay, 1)
    if max_delay >= cfg.n_delay_slots:
        raise ValueError(
            f"max edge delay {max_delay} rounds needs n_delay_slots > "
            f"{max_delay}, got {cfg.n_delay_slots}"
        )
    if topo.degree_classes and max(topo.degree_classes) > cfg.fanout:
        raise ValueError(
            f"degree_classes {topo.degree_classes} exceed fanout="
            f"{cfg.fanout}; degree caps mask fan-out slots, they cannot "
            "add slots"
        )


def overflow_fraction(n_overflow: torch.Tensor, cells: int) -> torch.Tensor:
    """JAX's ``overflow.mean(f32)`` as XLA computes it: the f32 count
    times the f32 reciprocal of the cell count.  That is not the count
    over the cell count: at 25 600 × 8 cells, 81 852 / 204 800 rounds
    one f32 ulp above XLA's product."""
    recip = np.float32(1.0) / np.float32(cells)
    return n_overflow.to(torch.float32) * torch.full(
        (), float(recip), dtype=torch.float32, device=n_overflow.device
    )


# -- K14: the dense bookkeeping refresh and convergence record ---------------

# K14's rows pass: nodes per block (one warp per node, 8 warps, each
# taking a node in turn), so the wrapper sizes the partial rows
DENSE_ROWS_PER_BLOCK = 64


def dense_record_plain(have, injected, alive, metrics: RunMetrics,
                       meta: PayloadMeta, t: int, cfg: SimConfig,
                       horizon=None):
    """Plain version of K14: JAX's gaps and converge blocks, and the
    exit predicate of its dense loop (`round._converged_done` of the new
    metrics, or with ``horizon`` the fault loop's ``_done``)."""
    from .gaps import extract_gaps

    touched = touched_versions(have, cfg)
    heads = version_heads(touched)
    gaps = extract_gaps(touched, heads, cfg)
    up = alive == ALIVE
    comp = complete_versions(have, cfg)
    act = version_active(injected, cfg)
    version_done = (comp | ~up[:, None, None]).all(dim=0) & act
    payload_done = grid_to_payload(version_done, cfg)
    coverage_at = torch.where(
        (metrics.coverage_at < 0) & payload_done, t, metrics.coverage_at
    ).to(torch.int32)
    node_done = (comp | ~act[None]).all(dim=2).all(dim=1) & up
    all_injected = (meta.round <= t).all()
    converged_at = torch.where(
        (metrics.converged_at < 0) & node_done & all_injected, t,
        metrics.converged_at,
    ).to(torch.int32)
    if horizon is None:
        done = (meta.round <= t + 1).all() & ((converged_at >= 0) | ~up).all()
    else:
        node_all = (comp | ~act[None]).all(dim=2).all(dim=1)
        done = (meta.round <= t + 1).all() & (node_all | ~up).all()
        if t + 1 < horizon:
            done = torch.zeros_like(done)
    return (heads, gaps.lo, gaps.hi, gaps.overflow.sum(dtype=torch.int32),
            coverage_at, converged_at, done)


def dense_record(have, injected, alive, metrics: RunMetrics,
                 meta: PayloadMeta, t: int, cfg: SimConfig, horizon=None):
    """Round t's bookkeeping and convergence record from the dense state:
    (heads i32[N, A], gap_lo, gap_hi i32[N, A, K], the overflow count
    i32, coverage_at i32[P], converged_at i32[N], done) — the advertised
    heads and gap runs of every (node, actor) with the overflow clamp,
    the stamps of payloads complete on every up node and of nodes
    holding every active version, and the loop's exit flag for round
    t + 1 (every payload injected, every up node converged), a bool that
    stays on the device.  With a fault plan's ``horizon`` the flag is
    the fault loop's (K14's exit mode): t + 1 ≥ horizon and every up
    node holding every active version FRESH from ``have`` (JAX
    ``faults._all_have``), which a wipe after a node's sticky stamp
    undoes.  K14 on the card: a rows pass and a one-block finish."""
    if have.device.type == "cpu":
        return dense_record_plain(have, injected, alive, metrics, meta, t,
                                  cfg, horizon)
    n, p = have.shape
    a, v = cfg.n_writers, cfg.n_versions
    c, k = cfg.chunks_per_version, cfg.gap_slots
    check("have", have, torch.uint8, (n, p))
    check("injected", injected, torch.uint8, (p,))
    check("alive", alive, torch.uint8, (n,))
    check("meta.round", meta.round, torch.int32, (p,))
    check("converged_at", metrics.converged_at, torch.int32, (n,))
    check("coverage_at", metrics.coverage_at, torch.int32, (p,))
    dev = have.device
    blocks = -(-n // DENSE_ROWS_PER_BLOCK)
    words = -(-v // 32)
    heads = torch.empty((n, a), dtype=torch.int32, device=dev)
    lo = torch.empty((n, a, k), dtype=torch.int32, device=dev)
    hi = torch.empty((n, a, k), dtype=torch.int32, device=dev)
    n_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    partial = torch.empty((blocks, a * words + 1), dtype=torch.int32,
                          device=dev)
    converged_at = torch.empty_like(metrics.converged_at)
    coverage_at = torch.empty_like(metrics.coverage_at)
    done = torch.empty((), dtype=torch.bool, device=dev)
    exit_mode = horizon is not None
    rows_k, finish_k = ((kernels.DENSE_GAPS_ROWS_EXIT,
                         kernels.DENSE_GAPS_FINISH_EXIT) if exit_mode
                        else (kernels.DENSE_GAPS_ROWS,
                              kernels.DENSE_GAPS_FINISH))
    rows_k.launch(
        [have, injected, alive, meta.round, metrics.converged_at, heads, lo,
         hi, n_overflow, converged_at, partial],
        [n, p, a, v, c, k, t, DENSE_ROWS_PER_BLOCK, int(exit_mode)],
    )
    finish_k.launch(
        [partial, injected, meta.round, metrics.coverage_at, coverage_at,
         done],
        [blocks, p, a, v, c, t, horizon if exit_mode else -1],
    )
    return heads, lo, hi, n_overflow, coverage_at, converged_at, done


# -- the dense round ---------------------------------------------------------

# the fields the dense phases update in place
_OWNED = ("have", "injected", "relay_left", "inflight", "sync_inflight",
          "view", "vinc", "suspect_since")


def own_state(state: SimState) -> SimState:
    """``state`` with tensors of its own where the round writes in place."""
    return state._replace(**{f: getattr(state, f).clone() for f in _OWNED})


def round_step_(state: SimState, metrics: RunMetrics, meta: PayloadMeta,
                cfg: SimConfig, topo: Topology, region: torch.Tensor,
                trace=None, faults=None, horizon=None, active=None):
    """One dense round on a state whose tensors it owns (`own_state`),
    updating them in place: (state, metrics, done), where ``done`` is
    the loop's exit flag after the round, on the device.  ``faults`` (a
    round slice of either plan form, `.faults.round_faults`, whose node
    faults the caller has applied) reaches every phase: cuts, loss, delay and jitter on
    the broadcast wire, refused sessions and session delays on the sync,
    cuts and loss on SWIM's probes; with the plan's ``horizon`` the flag
    is the fault loop's (`dense_record`), and ``active`` (the host's copy
    of the round's loss and jitter activity) leaves the classes that do
    not apply this round out of the broadcast.  With a ``trace`` the
    round's row is recorded in it, in place: the phases feed its
    accumulators, then K17's dense entry counts coverage and delivered
    and K19 writes the row (with the fault slice's crashes and
    wipes)."""
    from .broadcast import broadcast_step, deliver_step, inject_step
    from .swim import swim_step
    from .sync import sync_step

    if state.inflight.dtype != torch.uint8:
        raise ValueError("the dense round needs the u8 ring (this state "
                         "was built for the packed envelope)")
    peerswap = cfg.peer_sampler == "peerswap"
    ks = rng.split(state.key, 5 if peerswap else 4)
    state = state._replace(key=ks[0])
    k_bcast, k_sync, k_swim = ks[1], ks[2], ks[3]
    if peerswap:
        # the view swap tick before the phases (JAX's order)
        from ..topo.sampler import peerswap_step

        state = peerswap_step(state, cfg, topo, ks[4], faults)
    t = int(state.t)
    have0 = None if trace is None else state.have.clone()
    state = inject_step(state, meta, cfg)
    state = broadcast_step(state, meta, cfg, topo, region, k_bcast, faults,
                           trace=trace, active=active)
    sync_ok = None
    if trace is None:
        state = sync_step(state, meta, cfg, topo, k_sync, faults)
    else:
        state, sync_ok = sync_step(state, meta, cfg, topo, k_sync, faults,
                                   trace=trace)
    state = deliver_step(state, cfg)
    state = swim_step(state, cfg, topo, k_swim, faults)
    heads, lo, hi, n_overflow, coverage_at, converged_at, done = dense_record(
        state.have, state.injected, state.alive, metrics, meta, t, cfg,
        horizon,
    )
    overflow_frac = torch.maximum(
        metrics.overflow_frac, overflow_fraction(n_overflow, heads.numel())
    )
    if order_checked(cfg):
        from .invariants import count_order_violations_

        count_order_violations_(metrics.order_violations, state.have, meta,
                                cfg)
    if trace is not None:
        coverage_delivered_dense_(trace.counts[COVERAGE:GRANTS], state.have,
                                  have0, state.alive)
        record_row(trace, trace_row(trace, t, cfg.trace_every),
                   alive=state.alive, state=state, cfg=cfg, rf=faults,
                   sync_ok=sync_ok, n_overflow=n_overflow, nbytes=meta.nbytes)
    state = state._replace(heads=heads, gap_lo=lo, gap_hi=hi, t=state.t + 1)
    metrics = RunMetrics(
        coverage_at=coverage_at,
        converged_at=converged_at,
        overflow_frac=overflow_frac,
        order_violations=metrics.order_violations,
    )
    return state, metrics, done


def round_step(
    state: SimState, metrics: RunMetrics, meta: PayloadMeta, cfg: SimConfig,
    topo: Topology, region: torch.Tensor, faults=None, trace=None,
):
    """One gossip tick for the whole cluster on the dense state (JAX
    ``round_step``): returns the new (state, metrics), and with a
    ``trace`` (a `.telemetry.RoundTrace`, whose row of this round is
    written in place) the trace third; ``state`` itself is left as it
    was.  ``faults`` (a plan's round slice, matrix or factored, `.faults.
    round_faults`) threads the plan through every phase; its node
    faults are the caller's (`.faults.apply_node_faults`), as in JAX."""
    validate(cfg, topo)
    if order_checked(cfg):
        # the order count adds into the metrics in place: give it its own
        metrics = metrics._replace(
            order_violations=metrics.order_violations.clone())
    state, metrics, _ = round_step_(own_state(state), metrics, meta, cfg,
                                    topo, region, trace, faults)
    if trace is not None:
        return state, metrics, trace
    return state, metrics


def _converged_done(state: SimState, metrics: RunMetrics,
                    meta: PayloadMeta) -> torch.Tensor:
    """Exit predicate: every payload injected and every up node
    converged (a device bool); the loop takes it from K14 after each
    round and evaluates it here only before the first."""
    all_injected = (meta.round <= int(state.t)).all()
    return all_injected & (
        (metrics.converged_at >= 0) | (state.alive != ALIVE)
    ).all()


def run_dense(state: SimState, meta: PayloadMeta, cfg: SimConfig,
              topo: Topology, max_rounds: int, telemetry: bool = False):
    """The dense round until convergence or ``max_rounds``: a Python loop
    with one host read of the device done flag per round.  Returns
    (state, metrics), and with ``telemetry`` the run's trace third."""
    dev = state.have.device
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    metrics = new_metrics(cfg, dev)
    state = own_state(state)
    trace = new_trace(cfg, max_rounds, dev) if telemetry else None
    done = _converged_done(state, metrics, meta)
    while int(state.t) < max_rounds and not bool(done):
        state, metrics, done = round_step_(state, metrics, meta, cfg, topo,
                                           region, trace)
    if telemetry:
        return state, metrics, trace
    return state, metrics


def run_to_convergence(
    state: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology,
    max_rounds: int = 1000,
    telemetry: bool = False,
    mesh=None,
):
    """Advance rounds until every up node holds every injected version or
    ``max_rounds``; returns (SimState, RunMetrics), and with
    ``telemetry`` the run's `.telemetry.RoundTrace` third.  The packed
    envelope runs `.packed.run_packed`, every other configuration the
    dense round; both on one device."""
    from .packed import run_packed

    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (B17)")
    validate(cfg, topo)
    if packed_supported(cfg, topo):
        return run_packed(state, meta, cfg, topo, max_rounds, telemetry)
    return run_dense(state, meta, cfg, topo, max_rounds, telemetry)


def new_sim(cfg: SimConfig, seed: int = 0, device="cuda") -> SimState:
    return init_state(cfg, rng.prng_key(seed, resolve_device(device)))

