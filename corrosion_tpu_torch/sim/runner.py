"""Scenario runner for the port: `run_scenario` and the runner's configs
(``corrosion_tpu/sim/runner.py``): the 3-node ground truth and its fault
campaign (`config_fault_campaign_3node`, through the campaign engine),
broadcast-1k and partition-heal-10k on the dense round, the 100k-node
write storm (broadcast-1k and the storm also over a named topology
family, under the PeerSwap sampler, `_resolve_topo`, and under a named
protocol family, `_resolve_proto`) and its packed-against-dense A/B
(`config_storm_ab`), the packed fault storm and its flight-recorder rung
(`config_fault_storm_telemetry`) with their setup `fault_storm` (which
also puts the storm on the dense round, or on full-view SWIM), the
1M-node tier (`config_fault_storm_1m`: the fault storm at a million
nodes, ground-truth membership), and the
gapstress storm (config #5b, on the packed round from 1280 nodes) with
its K-clamp distortion pair, membership churn (configs #2 and #2b
through the campaign engine's detect cells, as JAX routes them, and
`membership_churn`), the uniform-vs-PeerSwap frontier rung
(`config_peer_sampler_frontier`, the engine's dense lanes) and the
protocol frontier rung (`config_protocol_frontier`, the same lanes under
the protocol families),
returning the same result keys.  The configs JAX lets record a trace
take ``telemetry`` and ``trace_path`` (`.telemetry`): the record gains
the ``telemetry`` summary block and the path the flight-recorder JSONL.
One device, no mesh; the wall clock brackets a run with
``torch.cuda.synchronize()`` on both ends when it runs on the card."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..faults import FaultEvent, FaultPlan
from .faults import compile_plan, run_fault_plan
from .round import (
    RunMetrics,
    new_metrics,
    new_sim,
    own_state,
    round_step_,
    run_to_convergence,
    validate,
)
from .state import (
    ALIVE,
    DOWN,
    PayloadMeta,
    SimConfig,
    optimize_budgets,
    packed_supported,
    uniform_payloads,
)
from .telemetry import (
    trace_host,
    trace_summary,
    write_flight_jsonl,
)
from ..proto.families import family_proto
from ..topo.families import family_topology
from .topology import Topology, regions

ROUND_SECONDS = 0.5
CHURN_MAX_ROUNDS = 400  # `membership_churn`'s cap; 4096 nodes detect at 46


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


def _timed_s(fn, dev: torch.device) -> float:
    """Seconds ``fn()`` takes: CUDA events around it on the card (then a
    wait for the end event), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _telemetry_record(result, trace, rounds: int, cfg: SimConfig,
                      trace_path, header) -> None:
    """A run's ``telemetry`` summary block, and its flight JSONL."""
    host = trace_host(trace, rounds)
    result["telemetry"] = trace_summary(host, rounds, cfg)
    if trace_path:
        write_flight_jsonl(trace_path, host, rounds, cfg, header=header)


def run_scenario(
    cfg: SimConfig,
    meta: PayloadMeta,
    topo: Topology = Topology(),
    seed: int = 0,
    max_rounds: int = 2000,
    telemetry: bool = False,
    trace_path: Optional[str] = None,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Run one scenario to convergence on ``device``.  ``telemetry`` (or
    a ``trace_path``) records the flight recorder: the record gains the
    deterministic ``telemetry`` summary and ``trace_path`` the per-round
    JSONL.  With ``return_state`` the record also carries the final
    ``state``, ``metrics`` and the ``trace`` (None without telemetry),
    for digests and comparisons."""
    telemetry = telemetry or trace_path is not None
    dev = resolve_device(device)
    state = new_sim(cfg, seed, dev)
    _sync(dev)
    t0 = time.monotonic()
    out = run_to_convergence(state, meta, cfg, topo, max_rounds, telemetry)
    _sync(dev)
    wall = time.monotonic() - t0
    final, metrics = out[0], out[1]
    trace = out[2] if telemetry else None

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
    if trace is not None:
        _telemetry_record(result, trace, rounds, cfg, trace_path,
                          {"seed": seed, "scenario": "run_scenario"})
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
        result["trace"] = trace
    return result


def config_ground_truth_3node(
    seed: int = 0, telemetry: bool = False, trace_path: Optional[str] = None,
    device="cuda", return_state: bool = False,
) -> Dict[str, float]:
    """Config #1: three nodes, 64 payloads, ground-truth membership, both
    byte budgets metered (they cannot bind, but the prefix runs)."""
    cfg = SimConfig(n_nodes=3, n_payloads=64, fanout=2, sync_interval_rounds=4)
    meta = uniform_payloads(cfg, resolve_device(device), inject_every=1)
    return run_scenario(cfg, meta, seed=seed, telemetry=telemetry,
                        trace_path=trace_path, device=device,
                        return_state=return_state)


def config_fault_campaign_3node(seed: int = 0, device="cuda"
                                ) -> Dict[str, object]:
    """The fault-plan demo campaign on three nodes (JAX ``runner.py:199``):
    a loss burst, an asymmetric cut, delay and jitter on one link and a
    crash-with-wipe, all from one plan seed, as a one-seed cell of the
    `fault-campaign-3node` spec through the campaign engine (the dense
    round's lanes, its matrix plan).  JAX's keys: the cell's round path,
    plan horizon, rounds, convergence, p99, wall, ``spec_hash`` and
    ``result_digest``."""
    from ..campaign.engine import run_campaign
    from ..campaign.spec import fault_campaign_3node_spec

    spec = fault_campaign_3node_spec(seed=seed)
    artifact = run_campaign(spec, out_path=None, device=device)
    cell = artifact["cells"][0]
    per_seed = cell["per_seed"]
    return {
        "n_nodes": cell["n_nodes"],
        "round_path": cell["round_path"],
        "plan_seed": seed,
        "plan_horizon": cell["plan_horizon"],
        "rounds": per_seed["rounds"][0],
        "wall_clock_s": cell["wall_clock_s"],
        "converged": per_seed["converged"][0],
        "unconverged_nodes": per_seed["unconverged_nodes"][0],
        "p99_node_convergence_round": per_seed[
            "p99_node_convergence_round"
        ][0],
        "spec_hash": artifact["spec_hash"],
        "result_digest": artifact["result_digest"],
    }


def _resolve_topo(topo_family: Optional[str]) -> Topology:
    """Named topology family → Topology (None: the flat default)."""
    if not topo_family:
        return Topology()
    return Topology(**family_topology(topo_family))


def _resolve_proto(proto_family: Optional[str]) -> Dict[str, object]:
    """Named protocol family → SimConfig protocol kwargs (None: the
    baseline point, an empty overlay)."""
    if not proto_family:
        return {}
    return family_proto(proto_family)


def config_broadcast_1k(
    seed: int = 0,
    telemetry: bool = False,
    trace_path: Optional[str] = None,
    topo_family: Optional[str] = None,
    sampler: Optional[str] = None,
    proto_family: Optional[str] = None,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Config #3: 1000 nodes, 8 writers × 32 versions, ground-truth
    membership, on the dense round; ``topo_family`` names a topology
    family (`..topo.families`, default flat), ``sampler`` the peer
    sampler ("peerswap" or the uniform default) and ``proto_family`` a
    protocol family (`..proto.families`), overlaid on the config."""
    topo = _resolve_topo(topo_family)
    cfg = SimConfig(n_nodes=1000, n_payloads=256, n_writers=8, fanout=3,
                    n_delay_slots=max(4, topo.max_delay + 1),
                    peer_sampler=sampler or "uniform",
                    **_resolve_proto(proto_family))
    meta = uniform_payloads(cfg, resolve_device(device), inject_every=2)
    return run_scenario(optimize_budgets(cfg, meta), meta, topo=topo,
                        seed=seed, telemetry=telemetry, trace_path=trace_path,
                        device=device, return_state=return_state)


def heal_config(n_nodes: int, device="cuda"):
    """Partition-heal's config and payloads: 4 writers × 64 versions,
    partial-view SWIM with 32 buckets, 3 ring slots (inter-region delay
    2 plus sync's t + 1)."""
    cfg = SimConfig.wan_tuned(
        n_nodes, n_payloads=256, n_writers=4, fanout=3,
        swim_partial_view=True, member_slots=32, n_delay_slots=3,
    )
    meta = uniform_payloads(cfg, resolve_device(device), inject_every=1)
    return optimize_budgets(cfg, meta), meta


def config_partition_heal_10k(
    seed: int = 0, device="cuda", return_state: bool = False
) -> Dict[str, float]:
    """Config #4: 10 000 nodes in two regions, the two halves partitioned
    for the first 60 rounds with writers on both sides, then healed and
    run to convergence; the convergence record is the healed run's."""
    dev = resolve_device(device)
    cfg, meta = heal_config(10_000, dev)
    topo = Topology(n_regions=2, inter_delay=2)
    validate(cfg, topo)
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    state = new_sim(cfg, seed, dev)
    half = torch.arange(cfg.n_nodes, device=dev) >= cfg.n_nodes // 2
    state = own_state(state._replace(group=half.to(torch.int32)))
    metrics = new_metrics(cfg, dev)
    _sync(dev)
    t0 = time.monotonic()
    for _ in range(60):
        state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                        region)
    state = state._replace(group=torch.zeros_like(state.group))
    heal_round = int(state.t)
    final, metrics = run_to_convergence(state, meta, cfg, topo, 2000)
    _sync(dev)
    wall = time.monotonic() - t0
    rounds = int(final.t)
    conv = _node_convergence(metrics, final)
    result = {
        "n_nodes": cfg.n_nodes,
        "heal_round": heal_round,
        "rounds": rounds,
        "rounds_after_heal": rounds - heal_round,
        "p99_node_convergence_round": conv["p99_node_convergence_round"],
        "converged": conv["unconverged_nodes"] == 0,
        "unconverged_nodes": conv["unconverged_nodes"],
        "wall_clock_s": wall,
    }
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
    return result


def churn_setup(cfg: SimConfig, seed: int, dev: torch.device):
    """A membership-churn run's payloads and initial state: one payload a
    round (``inject_every=1``), ``new_sim(cfg, seed)`` with every third
    node DOWN at t = 0 (the kill of JAX ``run_detect_ensemble``,
    ``kill_every=3``)."""
    meta = uniform_payloads(cfg, dev, inject_every=1)
    kill = torch.arange(cfg.n_nodes, device=dev) % 3 == 0
    state = new_sim(cfg, seed, dev)
    state = state._replace(
        alive=torch.where(kill, DOWN, ALIVE).to(torch.uint8))
    return meta, state


def membership_lane_stats(final, cfg: SimConfig) -> Dict[str, float]:
    """Detection quality of one run's final state, host-side (JAX
    ``campaign/engine.py`` ``_membership_lane_stats`` for one lane):
    ``detected_fraction``, the share of watched entries marked DOWN (1.0
    when nothing is watched), and on full view ``false_positive_downs``,
    the (up, up) pairs believed DOWN."""
    alive = final.alive.cpu().numpy()
    up = alive == ALIVE
    out: Dict[str, float] = {}
    if cfg.swim_full_view:
        view = final.view.cpu().numpy()
        watched = view[np.ix_(up, ~up)]
        out["detected_fraction"] = (
            float((watched == DOWN).mean()) if watched.size else 1.0)
        out["false_positive_downs"] = int(
            (view[np.ix_(up, up)] == DOWN).sum())
    else:
        pid = final.pid.cpu().numpy()
        pkey = final.pkey.cpu().numpy()
        watched = (pid >= 0) & ~up[np.maximum(pid, 0)] & up[:, None]
        marked = pkey % 4 == DOWN
        out["detected_fraction"] = (
            float((watched & marked).sum() / watched.sum())
            if watched.any() else 1.0)
    return out


def _churn_record(spec, n: int, device, return_state: bool
                  ) -> Dict[str, object]:
    """Run a one-seed detect spec through the campaign engine and give
    JAX's legacy config #2/#2b record (``runner.py:233 _churn_record``):
    ``detect_round`` -1 where the engine's lane never detected, the
    cell's wall, the artifact's ``spec_hash`` and ``result_digest``; with
    ``return_state`` the lane's final state and metrics too."""
    from ..campaign.engine import run_campaign
    from ..campaign.ensemble import lane_state

    lanes: Dict[int, Dict] = {}
    artifact = run_campaign(spec, device=device, lanes_out=lanes)
    cell = artifact["cells"][0]
    ps = cell["per_seed"]
    dr = ps["detect_round"][0]
    dr = -1 if dr is None else int(dr)
    rec = {
        "n_nodes": n,
        "detect_round": dr,
        "detect_sim_s": dr * ROUND_SECONDS if dr >= 0 else -1,
        "detected_fraction": float(ps["detected_fraction"][0]),
        "wall_clock_s": cell["wall_clock_s"],
        "converged": bool(ps["converged"][0]),
        "spec_hash": artifact["spec_hash"],
        "result_digest": artifact["result_digest"],
    }
    if "false_positive_downs" in ps:
        rec["false_positive_downs"] = int(ps["false_positive_downs"][0])
    if return_state:
        kept = lanes[0]
        rec["state"] = lane_state(kept["finals"], 0)
        rec["metrics"] = RunMetrics(*(x[0] for x in kept["metrics"]))
    return rec


def config_swim_churn_64(
    seed: int = 0, max_rounds: int = 400, n: int = 64, device="cuda",
    return_state: bool = False,
) -> Dict[str, object]:
    """Config #2: membership only — kill a third of an ``n``-node
    full-view cluster at t = 0 and count the rounds until every survivor
    marks every dead node DOWN.  As in JAX, through the campaign engine:
    a one-seed cell of the `swim-churn-64` spec (the detect loop on one
    lane, K23's full lane entry), JAX's legacy keys with
    ``false_positive_downs``, ``spec_hash`` and ``result_digest``."""
    from ..campaign.spec import swim_churn_64_spec

    spec = swim_churn_64_spec(seeds=(seed,), n=n, max_rounds=max_rounds)
    return _churn_record(spec, n, device, return_state)


def config_swim_churn_partial(
    seed: int = 0, max_rounds: int = 600, n: int = 4096, device="cuda",
    return_state: bool = False,
) -> Dict[str, object]:
    """Config #2b, config #2 at the partial-view scale tier: ``n`` nodes
    on O(N·M) member tables, probing every round, until every live table
    entry of an up watcher that names a dead member is marked DOWN.
    Engine-routed like config #2 (the `swim-churn-partial` spec, K23's
    partial lane entry); JAX's legacy keys and ``member_slots``."""
    from ..campaign.spec import swim_churn_partial_spec

    spec = swim_churn_partial_spec(seeds=(seed,), n=n, max_rounds=max_rounds)
    rec = _churn_record(spec, n, device, return_state)
    rec["member_slots"] = spec.sim_config({}).member_slots
    return rec


def membership_churn(
    n_nodes: int, seed: int = 0, device="cuda", return_state: bool = False
) -> Dict[str, object]:
    """Config #2 (`config_swim_churn_64`) at any size, capped at
    `CHURN_MAX_ROUNDS`, under its earlier keys: ``detect_round`` (-1 if
    the cap passes first) and ``false_downs``, the (up, up) pairs
    believed DOWN then."""
    rec = config_swim_churn_64(seed, CHURN_MAX_ROUNDS, n_nodes, device,
                               return_state)
    result = {
        "n_nodes": n_nodes,
        "detect_round": rec["detect_round"],
        "false_downs": rec["false_positive_downs"],
        "wall_clock_s": rec["wall_clock_s"],
    }
    if return_state:
        result["state"] = rec["state"]
        result["metrics"] = rec["metrics"]
    return result


def _write_storm(n_nodes: int, n_payloads: int, device="cuda",
                 topo: Topology = Topology(), sampler: Optional[str] = None,
                 proto_family: Optional[str] = None):
    """The multi-writer chunked write storm's config and payloads: 16
    writers × 4 chunks, partial-view SWIM up to 2^18 nodes — except under
    the PeerSwap ``sampler``, whose view is the sampler, so the storm
    runs ground-truth membership — a ring deep enough for the topology's
    deepest delay class, and the protocol family ``proto_family``
    overlaid."""
    peerswap = (sampler or "uniform") == "peerswap"
    cfg = SimConfig.wan_tuned(
        n_nodes,
        n_payloads=n_payloads,
        n_writers=16,
        chunks_per_version=4,
        fanout=3,
        sync_interval_rounds=8,
        sync_peers=3,
        swim_partial_view=n_nodes <= 262144 and not peerswap,
        member_slots=64,
        peer_sampler=sampler or "uniform",
        n_delay_slots=max(2, topo.max_delay + 1),
        **_resolve_proto(proto_family),
    )
    meta = uniform_payloads(cfg, resolve_device(device), inject_every=2)
    return optimize_budgets(cfg, meta), meta


def config_write_storm_100k(
    seed: int = 0,
    n_nodes: int = 100_000,
    n_payloads: int = 512,
    telemetry: bool = False,
    trace_path: Optional[str] = None,
    topo_family: Optional[str] = None,
    sampler: Optional[str] = None,
    proto_family: Optional[str] = None,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Config #5: 100k nodes, multi-writer chunked write storm, p99
    time-to-convergence; ``topo_family`` runs it over a named topology
    family, ``sampler="peerswap"`` under the PeerSwap sampler (with
    ground-truth membership) and ``proto_family`` under a named protocol
    variant."""
    topo = _resolve_topo(topo_family)
    cfg, meta = _write_storm(n_nodes, n_payloads, device, topo, sampler,
                             proto_family)
    return run_scenario(
        cfg, meta, topo=topo, seed=seed, max_rounds=3000,
        telemetry=telemetry, trace_path=trace_path, device=device,
        return_state=return_state,
    )


def config_storm_ab(
    seed: int = 0,
    n_nodes: int = 25_000,
    n_payloads: int = 512,
    device="cuda",
) -> Dict[str, object]:
    """Packed against dense on the same write storm (JAX
    ``runner.py:474``): `_write_storm` run twice to convergence (3000
    rounds at most), once with the packed envelope forced open
    (``packed_min_cells=0``) and once on the dense round
    (``allow_packed=False``).  The two must agree on rounds, p99 payload
    latency and unconverged nodes (``results_identical``, the keys that
    differ in ``mismatched_keys``); ``packed_speedup`` is the dense wall
    over the packed one, each bracketed by synchronizes on the card."""
    dev = resolve_device(device)
    cfg, meta = _write_storm(n_nodes, n_payloads, dev)
    packed = run_scenario(dataclasses.replace(cfg, packed_min_cells=0), meta,
                          seed=seed, max_rounds=3000, device=dev)
    dense = run_scenario(dataclasses.replace(cfg, allow_packed=False), meta,
                         seed=seed, max_rounds=3000, device=dev)
    assert packed["round_path"] == "packed" and dense["round_path"] == "dense"
    mismatch = [
        k
        for k in ("rounds", "p99_payload_latency_rounds", "unconverged_nodes")
        if packed[k] != dense[k]
    ]
    return {
        "n_nodes": n_nodes,
        "n_payloads": n_payloads,
        "rounds": packed["rounds"],
        "converged": packed["converged"] and dense["converged"],
        "results_identical": not mismatch,
        "mismatched_keys": mismatch,
        "wall_clock_s_packed": packed["wall_clock_s"],
        "wall_clock_s_dense": dense["wall_clock_s"],
        "packed_speedup": (
            dense["wall_clock_s"] / packed["wall_clock_s"]
            if packed["wall_clock_s"] > 0
            else float("inf")
        ),
    }


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


def fault_storm(n_nodes: int, n_payloads: int = 512, plan_seed: int = 0,
                device="cuda", factored: Optional[bool] = None, **changes):
    """The fault storm's (cfg, meta, compiled plan): `_write_storm`'s
    config with ``changes`` applied as JAX's callers apply them
    (``dataclasses.replace``: ``allow_packed=False`` puts the storm on
    the dense round, as JAX's 4096-node acceptance test does), under
    ``storm_fault_plan(n_nodes, plan_seed)`` compiled as ``factored``
    asks: None lets `compile_plan` choose, as JAX's
    ``config_packed_fault_storm`` does (the matrix form below 1024
    nodes, the factored one at storm scale)."""
    dev = resolve_device(device)
    cfg, meta = _write_storm(n_nodes, n_payloads, dev)
    cfg = dataclasses.replace(cfg, **changes)
    plan = storm_fault_plan(n_nodes, plan_seed)
    return cfg, meta, compile_plan(plan, cfg, Topology(), factored=factored,
                                   device=dev)


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
    cfg, meta, fplan = fault_storm(n_nodes, n_payloads, seed, dev)
    result, final, metrics = _fault_storm_run(cfg, meta, fplan, seed, dev)
    wall = result.pop("wall_clock_s")
    faultless = run_scenario(cfg, meta, seed=seed, max_rounds=3000,
                             device=dev)
    fl_wall = faultless["wall_clock_s"]
    result.update(
        wall_clock_s=wall,
        faultless_wall_clock_s=fl_wall,
        fault_over_faultless=(wall / fl_wall if fl_wall > 0
                              else float("inf")),
    )
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
    return result


def _fault_storm_run(cfg: SimConfig, meta: PayloadMeta, fplan, seed: int,
                     dev: torch.device, membership: bool = False):
    """One `run_fault_plan` of the storm under its compiled plan from
    ``new_sim(cfg, seed)``, its wall bracketed by synchronizes: (the
    fault rungs' record in JAX's key order, with the ``membership`` key
    where asked, final state, metrics)."""
    topo = Topology()
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
    result = {
        "n_nodes": cfg.n_nodes,
        "n_payloads": cfg.n_payloads,
        "n_devices": 1,
        "mesh": None,
        "round_path": "packed" if packed_supported(cfg, topo) else "dense",
        **({"membership": ("partial-view" if cfg.swim_partial_view
                           else "ground-truth")} if membership else {}),
        "plan_horizon": fplan.horizon,
        "plan_seed": seed,
        "rounds": rounds,
        "converged": (conv["unconverged_nodes"] == 0
                      and rounds >= fplan.horizon),
        **conv,
        "wall_clock_s": wall,
    }
    return result, final, metrics


def config_fault_storm_1m(
    seed: int = 0,
    n_nodes: int = 1_000_000,
    n_payloads: int = 512,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, object]:
    """The 1M-node tier (JAX ``runner.py:753``) on one device, no mesh:
    `storm_fault_plan` at a million nodes, compiled factored, through one
    `run_fault_plan` (max 3000 rounds), the fault side only.  Above 2^18
    nodes `_write_storm` drops partial-view SWIM, so the path is the
    packed round with ground-truth membership: no SWIM step, and the
    targets come from the uniform sampler (K5's [4c, N] draw, then K1's
    uniform entry with no view).  Returns JAX's result keys but
    ``sanity`` and ``phase_profile``, which need a port of
    ``sim/perf.py``'s wall protocol and profiler (ROADMAP A11); with
    ``return_state`` the record also carries the final ``state`` and
    ``metrics``."""
    dev = resolve_device(device)
    cfg, meta, fplan = fault_storm(n_nodes, n_payloads, seed, dev)
    result, final, metrics = _fault_storm_run(cfg, meta, fplan, seed, dev,
                                              membership=True)
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
    return result


def measure_overhead_pair(
    cfg: SimConfig,
    meta: PayloadMeta,
    topo: Topology = Topology(),
    seed: int = 17,
    k_rounds: int = 8,
    reps: int = 5,
    fplan=None,
    device="cuda",
) -> Tuple[float, float]:
    """Interleaved plain/telemetry per-round seconds (JAX
    ``perf.measure_overhead_pair``): the first ``k_rounds`` rounds of a
    fresh state, through `run_fault_plan` under ``fplan`` or
    `run_to_convergence` without, with and without the flight recorder,
    each timed whole (packing and the trace included, as JAX's jitted
    k-round body is) with CUDA events on the card; one warm-up of each,
    then ``reps`` plain/telemetry pairs in turn, and the per-variant
    minimum over k.  Returns ``(per_round_plain_s,
    per_round_telemetry_s)``."""
    dev = resolve_device(device)

    def run_once(telemetry: bool) -> float:
        state = new_sim(cfg, seed, dev)
        if fplan is not None:
            return _timed_s(lambda: run_fault_plan(
                state, meta, cfg, topo, fplan, k_rounds, telemetry), dev)
        return _timed_s(lambda: run_to_convergence(
            state, meta, cfg, topo, k_rounds, telemetry), dev)

    run_once(False)
    run_once(True)
    plain, tel = [], []
    for _ in range(reps):
        plain.append(run_once(False))
        tel.append(run_once(True))
    return min(plain) / k_rounds, min(tel) / k_rounds


def config_fault_storm_telemetry(
    seed: int = 0,
    n_nodes: int = 100_000,
    n_payloads: int = 512,
    microbench_rounds: int = 4,
    trace_path: Optional[str] = None,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, object]:
    """The packed fault storm with the flight recorder on: the
    interleaved per-round microbench of the telemetry round against the
    plain one (`measure_overhead_pair`, ``per_round_overhead_frac``),
    then a full telemetry-on run of the storm schedule with its summary
    block (and ``trace_path``'s JSONL).  JAX's record keys but
    ``sanity``, which waits for a port of ``sim/perf.py``'s wall check
    (ROADMAP A11).  With ``return_state`` the record also carries the
    run's final ``state``, ``metrics`` and ``trace``."""
    dev = resolve_device(device)
    cfg, meta, fplan = fault_storm(n_nodes, n_payloads, seed, dev)
    topo = Topology()
    packed = packed_supported(cfg, topo)
    pr_plain, pr_tel = measure_overhead_pair(
        cfg, meta, seed=seed + 1000, k_rounds=microbench_rounds,
        fplan=fplan, device=dev,
    )
    state = new_sim(cfg, seed, dev)
    _sync(dev)
    t0 = time.monotonic()
    final, metrics, trace = run_fault_plan(
        state, meta, cfg, topo, fplan, max_rounds=3000, telemetry=True
    )
    _sync(dev)
    wall = time.monotonic() - t0
    rounds = int(final.t)
    conv = _node_convergence(metrics, final)
    result = {
        "n_nodes": n_nodes,
        "n_payloads": n_payloads,
        "round_path": "packed" if packed else "dense",
        "plan_seed": seed,
        "rounds": rounds,
        "converged": (conv["unconverged_nodes"] == 0
                      and rounds >= fplan.horizon),
        "unconverged_nodes": conv["unconverged_nodes"],
        "wall_clock_s": wall,
        "per_round_plain_ms": round(pr_plain * 1e3, 3),
        "per_round_telemetry_ms": round(pr_tel * 1e3, 3),
        "per_round_overhead_frac": (round(pr_tel / pr_plain - 1.0, 4)
                                    if pr_plain > 0 else None),
    }
    _telemetry_record(result, trace, rounds, cfg, trace_path,
                      {"scenario": "packed_fault_storm", "seed": seed})
    if return_state:
        result["state"] = final
        result["metrics"] = metrics
        result["trace"] = trace
    return result


def _gapstress_cfg(n_nodes: int, gap_slots: int) -> SimConfig:
    return SimConfig.wan_tuned(
        n_nodes,
        n_payloads=8192,  # 128 versions × 8 writers × 8 chunks: V ≫ K
        n_writers=8,
        chunks_per_version=8,
        gap_slots=gap_slots,
        fanout=3,
        sync_interval_rounds=8,
        sync_peers=3,
        swim_partial_view=True,
        member_slots=64,
    )


def gapstress_payload_sizes(p: int) -> np.ndarray:
    """Mixed 1 B – 8 KiB changeset sizes in a deterministic cycle (JAX
    ``gapstress_payload_sizes``)."""
    cycle = np.array([1, 64, 512, 1024, 4096, 8192], np.int32)
    return np.resize(cycle, p)


def config_write_storm_gapstress(
    seed: int = 0,
    n_nodes: int = 10_000,
    gap_slots: int = 8,
    loss: float = 0.3,
    max_rounds: int = 4000,
    telemetry: bool = False,
    trace_path: Optional[str] = None,
    device="cuda",
    return_state: bool = False,
) -> Dict[str, float]:
    """Config #5b, the storm that stresses the gap machinery: 8 writers ×
    128 versions × 8 chunks (V = 128 over K = 8 gap slots), every version
    injected at round 0, 30 % flat wire loss, mixed 1 B – 8 KiB payloads
    (about 19 MB in all, so the 5 MiB broadcast governor and the 4 MiB
    sync grant both bind).  Reports ``gap_overflow_frac_max``.  JAX's
    compile-only prime has nothing to do here."""
    dev = resolve_device(device)
    cfg = _gapstress_cfg(n_nodes, gap_slots)
    meta = uniform_payloads(
        cfg, dev, inject_every=0,
        payload_bytes=gapstress_payload_sizes(cfg.n_payloads),
    )
    return run_scenario(
        cfg, meta, topo=Topology(loss=loss), seed=seed,
        max_rounds=max_rounds, telemetry=telemetry, trace_path=trace_path,
        device=dev, return_state=return_state,
    )


def config_gapstress_distortion(
    seed: int = 0, n_nodes: int = 1024, control_slots: int = 64,
    device="cuda", return_state: bool = False,
) -> Dict[str, object]:
    """The K-clamp distortion: the gapstress scenario at K = 8 (overflow
    forced) against a control at ``control_slots`` where every gap run
    fits; distortion is the extra rounds and p99 latency K = 8 costs.
    With ``return_state`` both records carry their final state."""
    stressed = config_write_storm_gapstress(
        seed, n_nodes, gap_slots=8, device=device, return_state=return_state
    )
    control = config_write_storm_gapstress(
        seed, n_nodes, gap_slots=control_slots, device=device,
        return_state=return_state,
    )
    return {
        "stressed": stressed,
        "control": control,
        "overflow_frac_max_stressed": stressed["gap_overflow_frac_max"],
        "overflow_frac_max_control": control["gap_overflow_frac_max"],
        "distortion_rounds": stressed["rounds"] - control["rounds"],
        "distortion_p99_latency_rounds": (
            stressed["p99_payload_latency_rounds"]
            - control["p99_payload_latency_rounds"]
        ),
    }


def config_peer_sampler_frontier(
    seed: int = 0, n_nodes: int = 96, n_seeds: int = 4,
    max_rounds: int = 400, device="cuda", lanes_out=None,
) -> Dict[str, object]:
    """The uniform-vs-PeerSwap frontier rung (JAX ``runner.py:1141``): the
    `peer-sampler-frontier` campaign — both samplers × two topology
    families, ``n_seeds`` lanes from ``seed``, wire bytes banded per lane
    — through the campaign engine's dense lanes, reduced to JAX's record:
    per family each sampler's rounds p50/p99, ``wire_bytes_p50`` and
    ``converged``, their ratios (peerswap / uniform, below 1.0 PeerSwap
    wins that axis), ``spec_hash``, ``result_digest`` and the wall.
    ``lanes_out`` (a dict) keeps each cell's stacked finals."""
    from ..campaign.engine import run_campaign
    from ..campaign.spec import peer_sampler_frontier_spec

    spec = peer_sampler_frontier_spec(
        seeds=tuple(seed + i for i in range(n_seeds)), n=n_nodes,
        max_rounds=max_rounds)
    t0 = time.monotonic()
    artifact = run_campaign(spec, out_path=None, device=device,
                            lanes_out=lanes_out)
    families: Dict[str, Dict[str, object]] = {}
    for cell in artifact["cells"]:
        fam = cell["params"]["topo_family"]
        samp = cell["params"]["peer_sampler"]
        families.setdefault(fam, {})[samp] = {
            "rounds_p50": cell["bands"]["rounds"]["p50"],
            "rounds_p99": cell["bands"]["rounds"]["p99"],
            "wire_bytes_p50": cell["bands"]["wire_bytes"]["p50"],
            "converged": cell["all_converged"],
        }
    for d in families.values():
        uni, ps = d.get("uniform"), d.get("peerswap")
        if uni and ps and uni["rounds_p50"]:
            d["rounds_ratio"] = round(ps["rounds_p50"] / uni["rounds_p50"],
                                      3)
        if uni and ps and uni["wire_bytes_p50"]:
            d["wire_ratio"] = round(
                ps["wire_bytes_p50"] / uni["wire_bytes_p50"], 3)
    return {
        "n_nodes": n_nodes,
        "seeds": n_seeds,
        "converged": all(c["all_converged"] for c in artifact["cells"]),
        "families": families,
        "spec_hash": artifact["spec_hash"],
        "result_digest": artifact["result_digest"],
        "wall_clock_s": round(time.monotonic() - t0, 3),
    }


def config_protocol_frontier(
    seed: int = 0, n_nodes: int = 96, n_seeds: int = 4,
    max_rounds: int = 500, sampler_storm_nodes: int = 25_600,
    sampler_storm_payloads: int = 512,
    proto_families: Optional[Sequence[str]] = None,
    topo_families: Optional[Sequence[str]] = None, device="cuda",
) -> Dict[str, object]:
    """The protocol-variant frontier rung (JAX ``runner.py:1195``): the
    `protocol-frontier` campaign — four protocol families × two topology
    families, ``n_seeds`` lanes from ``seed``, wire bytes banded per lane
    — through the campaign engine's dense lanes (B16v), reduced to JAX's
    record: per topology family each variant's rounds p50/p99,
    ``wire_bytes_p50`` and ``converged``, on ordering cells
    ``order_violations_max``, and ``rounds_ratio``/``wire_ratio`` against
    ``baseline``; ``spec_hash``, ``result_digest`` and the wall.  With
    ``sampler_storm_nodes`` the record also carries the storm-scale
    sampler cell, the solo PeerSwap write storm (`config_write_storm_100k`
    under ``sampler="peerswap"``).  ``proto_families``/``topo_families``
    shrink the grid."""
    from ..campaign.engine import run_campaign
    from ..campaign.spec import protocol_frontier_spec

    spec = protocol_frontier_spec(
        seeds=tuple(seed + i for i in range(n_seeds)), n=n_nodes,
        max_rounds=max_rounds)
    if proto_families is not None or topo_families is not None:
        grid = dict(spec.grid)
        if proto_families is not None:
            grid["proto_family"] = list(proto_families)
        if topo_families is not None:
            grid["topo_family"] = list(topo_families)
        spec = dataclasses.replace(spec, grid=grid)
    t0 = time.monotonic()
    artifact = run_campaign(spec, out_path=None, device=device)
    families: Dict[str, Dict[str, object]] = {}
    for cell in artifact["cells"]:
        entry = {
            "rounds_p50": cell["bands"]["rounds"]["p50"],
            "rounds_p99": cell["bands"]["rounds"]["p99"],
            "wire_bytes_p50": cell["bands"]["wire_bytes"]["p50"],
            "converged": cell["all_converged"],
        }
        if "order_violations" in cell["bands"]:
            entry["order_violations_max"] = cell["bands"][
                "order_violations"]["max"]
        families.setdefault(cell["params"]["topo_family"], {})[
            cell["params"]["proto_family"]] = entry
    for d in families.values():
        base = d.get("baseline")
        if not base:
            continue
        for proto, entry in d.items():
            if proto == "baseline":
                continue
            if base["rounds_p50"]:
                entry["rounds_ratio"] = round(
                    entry["rounds_p50"] / base["rounds_p50"], 3)
            if base["wire_bytes_p50"]:
                entry["wire_ratio"] = round(
                    entry["wire_bytes_p50"] / base["wire_bytes_p50"], 3)
    converged = all(c["all_converged"] for c in artifact["cells"])
    sampler_storm = None
    if sampler_storm_nodes:
        storm = config_write_storm_100k(
            seed=seed, n_nodes=sampler_storm_nodes,
            n_payloads=sampler_storm_payloads, sampler="peerswap",
            device=device)
        sampler_storm = {
            "sampler": "peerswap",
            "n_nodes": sampler_storm_nodes,
            "n_payloads": sampler_storm_payloads,
            "round_path": storm["round_path"],
            "rounds": storm["rounds"],
            "wall_clock_s": storm["wall_clock_s"],
            "converged": storm["converged"],
            "p99_node_convergence_round": storm[
                "p99_node_convergence_round"],
        }
        converged = converged and bool(storm["converged"])
    out = {
        "n_nodes": n_nodes,
        "seeds": n_seeds,
        "converged": converged,
        "families": families,
        "spec_hash": artifact["spec_hash"],
        "result_digest": artifact["result_digest"],
        "wall_clock_s": round(time.monotonic() - t0, 3),
    }
    if sampler_storm is not None:
        out["sampler_storm"] = sampler_storm
    return out
