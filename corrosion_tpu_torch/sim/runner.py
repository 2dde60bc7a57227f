"""Scenario runner for the port: `run_scenario`, the 100k-node write
storm and the packed fault storm (``corrosion_tpu/sim/runner.py``
``run_scenario``, ``_write_storm``, ``config_write_storm_100k``,
``storm_fault_plan``, ``config_packed_fault_storm``), returning the same
result keys.  One device, no mesh; the wall clock brackets a run with
``torch.cuda.synchronize()`` on both ends when it runs on the card."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..faults import FaultEvent, FaultPlan
from .faults import compile_plan, run_fault_plan
from .packed import packed_supported
from .round import RunMetrics, new_sim, run_to_convergence
from .state import ALIVE, PayloadMeta, SimConfig, optimize_budgets, uniform_payloads
from .topology import Topology

ROUND_SECONDS = 0.5


def _percentile(arr: np.ndarray, q: float) -> float:
    valid = arr[arr >= 0]
    if valid.size == 0:
        return float("nan")
    return float(np.percentile(valid, q))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _node_convergence(metrics: RunMetrics, final) -> Dict[str, float]:
    node_conv = metrics.converged_at.cpu().numpy()
    alive = final.alive.cpu().numpy()
    return {
        "unconverged_nodes": int(((node_conv < 0) & (alive == ALIVE)).sum()),
        "p99_node_convergence_round": _percentile(node_conv, 99),
    }


def run_scenario(
    cfg: SimConfig,
    meta: PayloadMeta,
    topo: Topology = Topology(),
    seed: int = 0,
    max_rounds: int = 2000,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Run one scenario to convergence on ``device``.  With
    ``return_state`` the record also carries the final ``state`` and
    ``metrics`` (for digests and comparisons)."""
    dev = resolve_device(device)
    state = new_sim(cfg, seed, dev)
    _sync(dev)
    t0 = time.monotonic()
    final, metrics = run_to_convergence(state, meta, cfg, topo, max_rounds)
    _sync(dev)
    wall = time.monotonic() - t0

    cov = metrics.coverage_at.cpu().numpy()
    inj = meta.round.cpu().numpy()
    lat = np.where(cov >= 0, cov - inj, -1)
    rounds = int(final.t)
    conv = _node_convergence(metrics, final)
    unconverged = conv["unconverged_nodes"]
    result = {
        "n_nodes": cfg.n_nodes,
        "n_payloads": cfg.n_payloads,
        "n_devices": 1,
        "mesh": None,
        "round_path": "packed" if packed_supported(cfg, topo) else "dense",
        "rounds": rounds,
        "wall_clock_s": wall,
        "converged": unconverged == 0,
        "unconverged_nodes": unconverged,
        "p50_payload_latency_rounds": _percentile(lat, 50),
        "p99_payload_latency_rounds": _percentile(lat, 99),
        "p99_payload_latency_sim_s": _percentile(lat, 99) * ROUND_SECONDS,
        "p99_node_convergence_round": conv["p99_node_convergence_round"],
        "gap_overflow_frac_max": float(metrics.overflow_frac),
        "rounds_per_sec": rounds / wall if wall > 0 else float("inf"),
        "node_rounds_per_sec": rounds * cfg.n_nodes / wall if wall > 0 else 0.0,
    }
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
    return result


def _write_storm(n_nodes: int, n_payloads: int, device="cuda",
                 topo: Topology = Topology()):
    """The multi-writer chunked write storm's config and payloads: 16
    writers × 4 chunks, partial-view SWIM up to 2^18 nodes."""
    cfg = SimConfig.wan_tuned(
        n_nodes,
        n_payloads=n_payloads,
        n_writers=16,
        chunks_per_version=4,
        fanout=3,
        sync_interval_rounds=8,
        sync_peers=3,
        swim_partial_view=n_nodes <= 262144,
        member_slots=64,
        n_delay_slots=max(2, topo.max_delay + 1),
    )
    meta = uniform_payloads(cfg, resolve_device(device), inject_every=2)
    return optimize_budgets(cfg, meta), meta


def config_write_storm_100k(
    seed: int = 0,
    n_nodes: int = 100_000,
    n_payloads: int = 512,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Config #5: 100k nodes, multi-writer chunked write storm, p99
    time-to-convergence."""
    cfg, meta = _write_storm(n_nodes, n_payloads, device)
    return run_scenario(
        cfg, meta, seed=seed, max_rounds=3000, device=device,
        return_state=return_state,
    )


def storm_fault_plan(n_nodes: int, seed: int = 0) -> FaultPlan:
    """The fault-storm schedule: a cluster-wide loss burst (p = 0.15,
    rounds 0-11), a symmetric half-split partition over its middle
    (rounds 4-15), and one crash-with-wipe of node 1 (down 8-19, back
    empty at 20).  Range selectors keep it O(K) at 100k nodes."""
    half = n_nodes // 2
    return FaultPlan(
        n_nodes=n_nodes, seed=seed,
        events=(
            FaultEvent("loss", 0, 12, p=0.15),
            FaultEvent(
                "partition", 4, 16,
                src=f"0:{half}", dst=f"{half}:{n_nodes}", symmetric=True,
            ),
            FaultEvent("crash", 8, 20, node=1, wipe=True),
        ),
    )


def config_packed_fault_storm(
    seed: int = 0,
    n_nodes: int = 100_000,
    n_payloads: int = 512,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, object]:
    """The fault-storm rung: the headline storm's shape under
    `storm_fault_plan`, run through `run_fault_plan` on the packed
    round, then the faultless storm of the same scenario on the same
    device, so ``fault_over_faultless`` compares like with like.
    Returns JAX's result keys but ``sanity``, ``faultless_sanity`` and
    ``phase_profile``, which need a port of ``sim/perf.py``'s wall
    protocol and profiler (ROADMAP A11).  With ``return_state`` the
    record also carries the fault run's final ``state`` and
    ``metrics``."""
    dev = resolve_device(device)
    cfg, meta = _write_storm(n_nodes, n_payloads, dev)
    topo = Topology()
    plan = storm_fault_plan(n_nodes, seed)
    fplan = compile_plan(plan, cfg, topo, device=dev)
    state = new_sim(cfg, seed, dev)
    _sync(dev)
    t0 = time.monotonic()
    final, metrics = run_fault_plan(
        state, meta, cfg, topo, fplan, max_rounds=3000
    )
    _sync(dev)
    wall = time.monotonic() - t0
    rounds = int(final.t)
    conv = _node_convergence(metrics, final)

    faultless = run_scenario(cfg, meta, topo=topo, seed=seed,
                             max_rounds=3000, device=dev)
    fl_wall = faultless["wall_clock_s"]
    result = {
        "n_nodes": n_nodes,
        "n_payloads": n_payloads,
        "n_devices": 1,
        "mesh": None,
        "round_path": "packed" if packed_supported(cfg, topo) else "dense",
        "plan_horizon": plan.horizon,
        "plan_seed": seed,
        "rounds": rounds,
        "converged": (conv["unconverged_nodes"] == 0
                      and rounds >= plan.horizon),
        **conv,
        "wall_clock_s": wall,
        "faultless_wall_clock_s": fl_wall,
        "fault_over_faultless": (wall / fl_wall if fl_wall > 0
                                 else float("inf")),
    }
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
    return result
