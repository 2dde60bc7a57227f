"""Seed ensembles: K replicas of one configuration as one lane-batched
program — the port of ``corrosion_tpu/campaign/ensemble.py``: the packed
round's lanes (B16, packed half), the dense round's and the
membership-detect loop's (dense half).

JAX ``vmap``s the whole while_loop; the port gives every tensor an
explicit leading lane axis and runs each kernel once for all live lanes
(`..sim.lanes`, `..sim.dense_lanes`, and the detect loop
`..sim.telemetry.run_membership_detect_lanes`).  Lane k is exactly the
solo run of seed k:

- its initial state is ``new_sim(cfg, seeds[k])`` (`seed_states`
  stacks them);
- a fault plan's schedule is shared by every lane and only its seed is
  batched (`lane_plan_seeds`: ``derive_seed(s, "sim") & 0x7FFFFFFF``,
  the derivation `compile_plan` applies to a solo plan), so lane k's
  fault draws are those of the plan re-seeded with seeds[k];
- a finished (converged, or detected) lane leaves the batch with its
  state after that round, which is what JAX's select-frozen lane holds.

The dense round's lanes run every topology family and key, either peer
sampler (B16t, B16s) and every protocol family (B16v); the packed
round's every topology family and key, both byte budgets, every
membership mode and either sampler (B16m's budgets and topology, B16s's
packed half) and every protocol family and knob (B16m's rest).  Fault
plans run on both rounds' lanes, a churn schedule's events among them
(B16c): of either form, with delay and jitter, on the dense round's
(under PeerSwap too: B16s-f) and on the packed round's (factored with
delay and jitter since B16l, matrix since B16x); a mesh is A13.  The
flight recorder (``telemetry``) runs on both rounds' lanes and the
detect loop's (B16r): each lane records its own trace, equal to its solo
run's, and the stacked traces come back last, as JAX's vmapped recorder
returns them.  Each refusal raises, naming its item.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..device import resolve_device
from ..faults import FaultPlan, derive_seed
from ..sim.faults import compile_plan
from ..sim.dense_lanes import run_dense_lanes
from ..sim.lanes import run_lanes
from ..sim.round import new_sim
from ..sim.state import (
    ALIVE,
    DOWN,
    PayloadMeta,
    SimConfig,
    SimState,
    packed_supported,
)
from ..sim.topology import Topology


def seed_states(cfg: SimConfig, seeds: Sequence[int],
                device="cuda") -> SimState:
    """Stack K solo initial states along a new leading lane axis: lane k
    IS ``new_sim(cfg, seeds[k])`` (``t`` stays one host scalar, 0 in
    every lane)."""
    dev = resolve_device(device)
    states = [new_sim(cfg, int(s), dev) for s in seeds]
    return SimState(*(
        states[0].t if name == "t" else torch.stack(
            [getattr(s, name) for s in states])
        for name in SimState._fields))


def lane_state(finals: SimState, k: int) -> SimState:
    """Lane k of stacked states as a solo state (``t`` a host scalar), the
    form `convert.state_digest` and the solo runs use."""
    return SimState(*(x[k] for x in finals))


def lane_plan_seeds(seeds: Sequence[int], device="cuda") -> torch.Tensor:
    """i32[K] per-lane fault-stream seeds: the derivation `compile_plan`
    applies to one plan, so lane k's fault draws equal a solo run of the
    plan re-seeded with ``seeds[k]``."""
    return torch.tensor(
        [derive_seed(int(s), "sim") & 0x7FFFFFFF for s in seeds],
        dtype=torch.int32, device=resolve_device(device))


def ensemble_mesh(cfg: SimConfig, n_devices: Optional[int]):
    """The cell's mesh for a requested device count: None for one device
    or none requested; more devices (node sharding across cards) are
    ROADMAP A13."""
    if not n_devices or n_devices <= 1:
        return None
    raise NotImplementedError(
        "mesh × lane batching across several cards is not ported yet "
        "(ROADMAP A13)")


def run_ensemble(
    states: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology,
    fplan=None,
    plan_seeds: Optional[torch.Tensor] = None,
    max_rounds: int = 1000,
    telemetry: bool = False,
    mesh=None,
):
    """Run every lane of stacked states to convergence (or
    ``max_rounds``) as one lane-batched program on the round the
    configuration takes: on the packed envelope the packed round's
    convergence loop per lane, otherwise the dense round's
    (`..sim.dense_lanes.run_dense_lanes`); under ``fplan`` (shared) the
    round's fault loop, each lane re-seeded by ``plan_seeds`` (i32[K];
    None: every lane keeps the plan's seed).  Returns the stacked final
    (SimState, RunMetrics), ``t`` i32[K], and with ``telemetry`` the
    lanes' stacked `..sim.telemetry.RoundTrace` third (either round)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh × lane batching is not ported yet (ROADMAP A13)")
    if packed_supported(cfg, topo):
        return run_lanes(states, meta, cfg, topo, max_rounds, fplan,
                         plan_seeds, telemetry)
    return run_dense_lanes(states, meta, cfg, topo, max_rounds, fplan,
                           plan_seeds, telemetry)


def run_seed_ensemble(
    plan: Optional[FaultPlan],
    cfg: SimConfig,
    topo: Topology,
    meta: PayloadMeta,
    seeds: Sequence[int],
    max_rounds: int = 1000,
    telemetry: bool = False,
    mesh=None,
    device="cuda",
):
    """Seeds → stacked states (and, under a plan, the compiled plan and
    the per-lane plan seeds) → one lane-batched run; with ``telemetry``
    the stacked traces come back last."""
    dev = resolve_device(device)
    states = seed_states(cfg, seeds, dev)
    if plan is None:
        return run_ensemble(states, meta, cfg, topo, max_rounds=max_rounds,
                            telemetry=telemetry, mesh=mesh)
    fplan = compile_plan(plan, cfg, topo, device=dev)
    return run_ensemble(
        states, meta, cfg, topo, fplan=fplan,
        plan_seeds=lane_plan_seeds(seeds, dev), max_rounds=max_rounds,
        telemetry=telemetry, mesh=mesh,
    )


def run_detect_ensemble(
    cfg: SimConfig,
    topo: Topology,
    meta: PayloadMeta,
    seeds: Sequence[int],
    kill_every: int = 0,
    max_rounds: int = 400,
    telemetry: bool = False,
    mesh=None,
    device="cuda",
):
    """Membership-churn seed ensemble (JAX ``ensemble.py:187``, runner
    configs #2/#2b through the engine): kill every ``kill_every``-th
    node at t = 0 on every lane, then the detect loop on lanes
    (`..sim.telemetry.run_membership_detect_lanes`), which drops each
    lane once it detects.  Returns (finals, metrics, detect_rounds
    i32[K]), and with ``telemetry`` the lanes' stacked traces fourth."""
    from ..sim.telemetry import run_membership_detect_lanes

    if mesh is not None:
        raise NotImplementedError(
            "mesh × lane batching is not ported yet (ROADMAP A13)")
    dev = resolve_device(device)
    states = seed_states(cfg, seeds, dev)
    if kill_every:
        kill = torch.arange(cfg.n_nodes, device=dev) % kill_every == 0
        alive = torch.where(kill, DOWN, ALIVE).to(torch.uint8)
        states = states._replace(
            alive=alive.expand(states.alive.shape).contiguous())
    return run_membership_detect_lanes(states, meta, cfg, topo, max_rounds,
                                       telemetry=telemetry, device=dev)
