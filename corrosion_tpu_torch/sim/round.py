"""The round and its run loop — the port of ``corrosion_tpu/sim/round.py``:
`round_step` (the dense round on JAX's u8 state) and `run_to_convergence`,
which takes the packed envelope to `.packed.run_packed` and runs the
dense round otherwise, either with the flight recorder
(``telemetry=True``, `.telemetry`).  Mesh sharding (ROADMAP B17) is not
ported; asking for it raises instead of silently running something
else.

One dense round is inject → broadcast → sync → deliver → SWIM →
bookkeeping refresh → convergence record, phase for phase and draw for
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
    order_violations: torch.Tensor  # i32 scalar


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
    """The delay ring must represent every edge delay (sync uses t+1)."""
    max_delay = max(topo.max_delay, 1)
    if max_delay >= cfg.n_delay_slots:
        raise ValueError(
            f"max edge delay {max_delay} rounds needs n_delay_slots > "
            f"{max_delay}, got {cfg.n_delay_slots}"
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
                       meta: PayloadMeta, t: int, cfg: SimConfig):
    """Plain version of K14: JAX's gaps and converge blocks."""
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
    done = (meta.round <= t + 1).all() & ((converged_at >= 0) | ~up).all()
    return (heads, gaps.lo, gaps.hi, gaps.overflow.sum(dtype=torch.int32),
            coverage_at, converged_at, done)


def dense_record(have, injected, alive, metrics: RunMetrics,
                 meta: PayloadMeta, t: int, cfg: SimConfig):
    """Round t's bookkeeping and convergence record from the dense state:
    (heads i32[N, A], gap_lo, gap_hi i32[N, A, K], the overflow count
    i32, coverage_at i32[P], converged_at i32[N], done) — the advertised
    heads and gap runs of every (node, actor) with the overflow clamp,
    the stamps of payloads complete on every up node and of nodes
    holding every active version, and the loop's exit flag for round
    t + 1 (every payload injected, every up node converged), a bool that
    stays on the device.  K14 on the card: a rows pass and a one-block
    finish."""
    if have.device.type == "cpu":
        return dense_record_plain(have, injected, alive, metrics, meta, t,
                                  cfg)
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
    kernels.DENSE_GAPS_ROWS.launch(
        [have, injected, alive, meta.round, metrics.converged_at, heads, lo,
         hi, n_overflow, converged_at, partial],
        [n, p, a, v, c, k, t, DENSE_ROWS_PER_BLOCK],
    )
    kernels.DENSE_GAPS_FINISH.launch(
        [partial, injected, meta.round, metrics.coverage_at, coverage_at,
         done],
        [blocks, p, a, v, c, t],
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
                trace=None):
    """One dense round on a state whose tensors it owns (`own_state`),
    updating them in place: (state, metrics, done), where ``done`` is
    the loop's exit flag after the round, on the device.  With a
    ``trace`` the round's row is recorded in it, in place: the phases
    feed its accumulators, then K17's dense entry counts coverage and
    delivered and K19 writes the row."""
    from .broadcast import broadcast_step, deliver_step, inject_step
    from .swim import swim_step
    from .sync import sync_step

    if state.inflight.dtype != torch.uint8:
        raise ValueError("the dense round needs the u8 ring (this state "
                         "was built for the packed envelope)")
    ks = rng.split(state.key, 4)
    state = state._replace(key=ks[0])
    k_bcast, k_sync, k_swim = ks[1], ks[2], ks[3]
    t = int(state.t)
    have0 = None if trace is None else state.have.clone()
    state = inject_step(state, meta, cfg)
    state = broadcast_step(state, meta, cfg, topo, region, k_bcast,
                           trace=trace)
    sync_ok = None
    if trace is None:
        state = sync_step(state, meta, cfg, topo, k_sync)
    else:
        state, sync_ok = sync_step(state, meta, cfg, topo, k_sync,
                                   trace=trace)
    state = deliver_step(state, cfg)
    state = swim_step(state, cfg, topo, k_swim)
    heads, lo, hi, n_overflow, coverage_at, converged_at, done = dense_record(
        state.have, state.injected, state.alive, metrics, meta, t, cfg
    )
    overflow_frac = torch.maximum(
        metrics.overflow_frac, overflow_fraction(n_overflow, heads.numel())
    )
    if trace is not None:
        coverage_delivered_dense_(trace.counts[COVERAGE:GRANTS], state.have,
                                  have0, state.alive)
        record_row(trace, trace_row(trace, t, cfg.trace_every),
                   alive=state.alive, state=state, cfg=cfg, rf=None,
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
    was."""
    if faults is not None:
        raise NotImplementedError(
            "faults on the dense round are not ported yet (ROADMAP B12 "
            "rest)"
        )
    validate(cfg, topo)
    state, metrics, _ = round_step_(own_state(state), metrics, meta, cfg,
                                    topo, region, trace)
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

