"""Campaign engine: grid cells → lane-batched seed ensembles → banded,
resumable JSON artifacts — the port of the sim cell of
``corrosion_tpu/campaign/engine.py`` (`_run_cell`, `run_campaign` and
the artifact helpers).

One `run_campaign` call turns a `CampaignSpec` into an artifact whose
``spec_hash`` and ``result_digest`` equal what JAX's ``run_campaign``
gives for the same spec: the same per-seed records (rounds, converged,
unconverged nodes, the p99 node-convergence round, None for a lane that
never converged), the same bands, the same cell keys.  Each cell's wall
is timed between ``torch.cuda.synchronize()`` calls and checked against
the analytic floor of `..sim.perf` (K lanes × executed rounds × the
round's minimum carry writes), as JAX's is.  Artifacts are written after
every cell (atomic replace) and resume from a file of the same spec
hash.

The engine runs sim cells on both rounds — faultless or under a
factored plan (delay and jitter included, B16l) on the packed round,
with both byte budgets, over every topology family and key, under every
membership mode and either peer sampler (B16m's budgets and topology,
B16s's packed half) and under every protocol family (B16m's rest);
faultless or under a plan of either form (delay and jitter included) on
the dense round, over every topology family, under either peer sampler
and under every protocol family, which is where every fault cell outside
the packed envelope goes
(the 3-node fault campaigns, fault storms below the envelope,
``allow_packed: False``),
reporting ``round_path: "dense"`` and the plan's horizon as JAX does —
and detect cells (``detect_membership``: configs #2/#2b, the detect loop
on lanes, banding ``detect_round`` with JAX's per-lane detection
quality).  A detect cell is refused with JAX's ValueErrors for what it
cannot measure.

The flight recorder runs on every sim and detect cell, on either
round's lanes (B16r): ``telemetry`` (the argument, the spec's key, or
``trace_dir``) gives each cell JAX's ``telemetry`` block, one
`..sim.telemetry.trace_summary` a lane, and with ``trace_dir`` one
flight-recorder JSONL a lane under JAX's file name
(`_lane_trace_path`) and header; a ``measure_wire`` cell arms the
recorder itself and bands each lane's ``wire_bytes``, the broadcast
and sync byte channels' host sums, exactly as JAX computes them — part
of the result digest.  Every cell whose ``ordering`` is not "none"
bands each lane's ``order_violations`` (its standing delivery-order
count, K22), part of the digest, as JAX's does.  A ``churn`` cell (B16c)
appends its churn events to the cell's plan (`.spec.CampaignSpec.
fault_plan`), which either round's lanes run, in either form: a matrix
plan below 1024 nodes, a factored one above (the packed round's lanes
run matrix plans since B16x).  The rest raises NotImplementedError,
naming its ROADMAP item: a mesh is A13, host-serving cells and host
parity are host tier (not queued).  The cell's ``traceparent``
and its span tree belong to the host tracing tier and are left out (the
digest excludes them; a flight-recorder header carries ``traceparent:
None``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .report import BAND_METRICS, artifact_digest, bands
from .spec import CampaignSpec

#: a cell's wall against the analytic floor (`..sim.perf`)
WALL_OK, WALL_VIOLATED = "ok", "hbm-bound-violated"


def _percentile_lower(arr: np.ndarray, q: float):
    """Percentile over the converged entries; None when nothing
    converged (a -1 would band as a spuriously good observation)."""
    valid = arr[arr >= 0]
    if valid.size == 0:
        return None
    return float(np.percentile(valid, q, method="lower"))


def _refuse(spec: CampaignSpec, cell: Dict[str, object], cfg) -> None:
    """The cells the engine does not run.  First JAX's own ValueErrors
    (``engine.py:190-231``), word for word: what a detect cell, or a
    wire measurement, cannot measure.  Then the port's
    NotImplementedErrors, each naming its ROADMAP item.  Whatever a cell
    resolves to on the packed round runs on its lanes
    (`..sim.lanes.check_packed_lanes`: every protocol family and knob,
    both byte budgets, every topology family and key, every membership
    mode, PeerSwap and, since B16x, a matrix plan; JAX's ``jax.vmap`` of
    ``sim/packed.py:681 packed_round_step`` in ``campaign/ensemble.py:114
    run_ensemble``).
    A ``churn`` cell runs (B16c) but on a detect cell, which keeps JAX's
    ValueError."""
    from .spec import _PROTO_KEYS

    if spec.serving(cell):
        raise NotImplementedError(
            "host-serving cells drive the host agent tier, which the port "
            "does not carry (ROADMAP A, not queued)")
    detect = spec.detect_membership(cell)
    measure_wire = spec.measure_wire(cell)
    if measure_wire and detect:
        raise ValueError(
            "measure_wire is not supported on detect_membership cells "
            "(the detection loop bands detect_round, not wire cost)"
        )
    if measure_wire and cfg.trace_every > 1:
        raise ValueError(
            "measure_wire needs trace_every == 1 (wire totals are "
            "exact per-round sums, not stride samples)"
        )
    if detect and spec._meta(cell, "churn"):
        raise ValueError(
            "churn schedules are not supported on detect_membership "
            "cells (the detection ensemble runs without a FaultPlan)"
        )
    if detect:
        for key in ("proto_family",) + _PROTO_KEYS:
            if spec._meta(cell, key):
                raise ValueError(
                    f"{key!r} is not supported on detect_membership "
                    "cells (the detection loop measures membership, "
                    "not payload dissemination)"
                )
    if spec.host_parity:
        raise NotImplementedError(
            "host_parity replays a plan on the host agent tier, which the "
            "port does not carry (ROADMAP A, not queued)")


def _membership_lane_stats(finals, cfg) -> Dict[str, List]:
    """Host-side per-lane detection quality of a detect cell (JAX
    ``engine.py:65``): each lane's `..sim.runner.membership_lane_stats`,
    ``detected_fraction`` and on full view ``false_positive_downs``."""
    from ..campaign.ensemble import lane_state
    from ..sim.runner import membership_lane_stats

    stats = [membership_lane_stats(lane_state(finals, k), cfg)
             for k in range(finals.alive.shape[0])]
    return {key: [s[key] for s in stats] for key in stats[0]}


def _run_cell(
    spec: CampaignSpec,
    cell: Dict[str, object],
    cell_index: int = 0,
    telemetry: bool = False,
    trace_dir: Optional[str] = None,
    mesh_devices: Optional[int] = None,
    device="cuda",
    lanes_out: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """One parameter point: the whole seed set as one lane-batched
    ensemble, reduced to per-seed records and cross-seed bands (JAX
    ``engine.py:106 _run_cell``, sim and detect cells).  A detect cell
    runs `.ensemble.run_detect_ensemble` and bands ``detect_round`` per
    seed, None for a lane that never detected.  ``telemetry`` or a
    ``measure_wire`` cell runs the recorder on the lanes: the latter
    bands each lane's ``wire_bytes``, the former adds the ``telemetry``
    block (`_cell_telemetry`, with ``trace_dir`` the per-lane JSONL).
    With ``lanes_out`` the cell's stacked finals and metrics (a detect
    cell's detect rounds, a recording cell's stacked traces) are stored
    in it."""
    from ..device import resolve_device
    from ..sim.perf import analytic_min_round_s
    from ..sim.state import ALIVE, packed_supported, uniform_payloads
    from .ensemble import (
        ensemble_mesh,
        run_detect_ensemble,
        run_seed_ensemble,
    )

    dev = resolve_device(device)
    cfg = spec.sim_config(cell) if not spec.serving(cell) else None
    _refuse(spec, cell, cfg)
    topo = spec.topo(cell)
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every(cell))
    detect = spec.detect_membership(cell)
    # measure_wire arms the recorder itself: its wire totals are banded
    # and digested whether or not telemetry was asked for (JAX's rule)
    measure_wire = spec.measure_wire(cell)
    run_telemetry = bool(telemetry or measure_wire)
    plan = None if detect else spec.fault_plan(cell, seed=spec.seeds[0])
    round_path = "packed" if packed_supported(cfg, topo) else "dense"
    mesh = ensemble_mesh(cfg, mesh_devices)
    n_devices = 1

    k = len(spec.seeds)
    traces = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    if detect:
        out = run_detect_ensemble(
            cfg, topo, meta, spec.seeds, kill_every=spec.kill_every(cell),
            max_rounds=spec.max_rounds, telemetry=run_telemetry, mesh=mesh,
            device=dev)
        finals, metrics, detect_rounds = out[:3]
    else:
        out = run_seed_ensemble(
            plan, cfg, topo, meta, spec.seeds, max_rounds=spec.max_rounds,
            telemetry=run_telemetry, mesh=mesh, device=dev,
        )
        finals, metrics = out[:2]
    if run_telemetry:
        traces = out[-1]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    finals.have[0, 0, 0].item()  # a real host read
    wall = time.monotonic() - t0
    if lanes_out is not None:
        lanes_out.update(finals=finals, metrics=metrics)
        if detect:
            lanes_out["detect_rounds"] = detect_rounds
        if traces is not None:
            lanes_out["traces"] = traces

    rounds = finals.t.cpu().numpy()  # [K]
    alive = finals.alive.cpu().numpy()  # [K, N]
    if detect:
        dr = detect_rounds.cpu().numpy()  # [K]
        converged = dr >= 0
        per_seed = {
            "rounds": [int(r) for r in rounds],
            "converged": [bool(c) for c in converged],
            "detect_round": [int(d) if d >= 0 else None for d in dr],
        }
        per_seed.update(_membership_lane_stats(finals, cfg))
    else:
        node_conv = metrics.converged_at.cpu().numpy()  # [K, N]
        unconverged = ((node_conv < 0) & (alive == ALIVE)).sum(axis=1)
        heads = finals.heads.cpu().numpy()  # [K, N, A]
        heads_ok = (
            (heads == cfg.n_versions) | (alive[:, :, None] != ALIVE)
        ).all(axis=(1, 2))
        converged = (unconverged == 0) & heads_ok
        per_seed = {
            "rounds": [int(r) for r in rounds],
            "converged": [bool(c) for c in converged],
            "unconverged_nodes": [int(u) for u in unconverged],
            "p99_node_convergence_round": [
                _percentile_lower(node_conv[i], 99) for i in range(k)
            ],
        }
        if measure_wire:
            # each lane's broadcast + sync bytes from its host rows, as
            # JAX sums them (numpy f32 sums, rounded to 0.1); the host
            # dicts then stand in for the traces, one copy a lane
            from ..sim.telemetry import lane_trace, trace_host

            every = max(int(cfg.trace_every), 1)
            wire, hosts = [], []
            for i in range(k):
                h = trace_host(lane_trace(traces, i), int(rounds[i]), every)
                hosts.append(h)
                wire.append(round(float(h["bcast_bytes"].sum())
                                  + float(h["sync_bytes"].sum()), 1))
            per_seed["wire_bytes"] = wire
            traces = hosts
        if cfg.ordering != "none":
            # each lane's standing delivery-order count, banded and
            # digested on ordering cells only (JAX's rule)
            per_seed["order_violations"] = [
                int(v) for v in metrics.order_violations.cpu().numpy()]
    cell_bands = {
        m: bands(per_seed[m]) for m in BAND_METRICS if m in per_seed
    }
    executed = int(rounds.max()) if k else 0
    floor = executed * k * analytic_min_round_s(cfg, n_devices)
    verdict = WALL_OK if wall >= floor else WALL_VIOLATED
    result = {
        "params": dict(cell),
        "n_nodes": cfg.n_nodes,
        "n_payloads": cfg.n_payloads,
        "round_path": round_path,
        "mesh": None,
        "n_devices": n_devices,
        "seeds": list(spec.seeds),
        "plan_horizon": plan.horizon if plan is not None else 0,
        "per_seed": per_seed,
        "bands": cell_bands,
        "all_converged": bool(converged.all()),
        "wall_clock_s": round(wall, 4),
        "wall_defensible_s": round(max(wall, floor), 4),
        "wall_verdict": verdict,
    }
    if traces is not None and telemetry:
        # the block follows the telemetry argument (a run config, out of
        # the digest); a measure_wire-only run recorded for wire_bytes
        result["telemetry"] = _cell_telemetry(spec, cell_index, traces,
                                              rounds, cfg, trace_dir)
    return result


def _cell_telemetry(spec: CampaignSpec, cell_index: int, traces, rounds,
                    cfg, trace_dir: Optional[str]) -> Dict[str, object]:
    """The cell's flight-recorder export (JAX ``engine.py:649``): one
    `..sim.telemetry.trace_summary` a lane for the artifact and, with
    ``trace_dir``, one JSONL a lane (`_lane_trace_path`) with JAX's
    header; ``traces`` is the stacked lane trace or, on a measure_wire
    cell, the lanes' host dicts already made."""
    from ..sim.telemetry import (
        lane_trace, trace_host, trace_summary, write_flight_jsonl)

    summaries = []
    for i, seed in enumerate(spec.seeds):
        lane = traces[i] if isinstance(traces, list) else lane_trace(
            traces, i)
        r = int(rounds[i])
        host = trace_host(lane, r)
        summaries.append(trace_summary(host, r, cfg))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            write_flight_jsonl(
                _lane_trace_path(trace_dir, spec, cell_index, seed), host, r,
                cfg, header={
                    "campaign": spec.name,
                    "spec_hash": spec.spec_hash(),
                    "cell_index": cell_index,
                    "seed": int(seed),
                    "traceparent": None,
                })
    return {"per_seed": summaries}


def _lane_trace_path(trace_dir: str, spec: CampaignSpec, cell_index: int,
                     seed) -> str:
    """One flight-recorder JSONL a (cell, lane), JAX's name: the one
    naming scheme of the writer (`_cell_telemetry`) and the resume check
    (`_cached_cell_satisfies`)."""
    return os.path.join(
        trace_dir, f"{spec.name}_cell{cell_index}_seed{int(seed)}.jsonl")


def _load_artifact(path: str, spec_hash: str) -> Optional[Dict]:
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if art.get("spec_hash") != spec_hash:
        return None  # a different campaign: never resume across specs
    return art


def _write_artifact(path: str, artifact: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True, default=float)
        f.write("\n")
    os.replace(tmp, path)  # atomic: a killed run never corrupts


def _cached_cell_satisfies(cached: Dict, spec: CampaignSpec,
                           cell_index: int, telemetry: bool,
                           trace_dir: Optional[str]) -> bool:
    """Resume reuses a cached cell only when it carries what this run
    asks for (JAX's rule): the telemetry block, and under ``trace_dir``
    every lane's flight-recorder JSONL on disk; otherwise the cell runs
    again (a recording run's digest is the plain run's)."""
    if not telemetry:
        return True
    if "telemetry" not in cached:
        return False
    if trace_dir:
        for seed in spec.seeds:
            if not os.path.exists(
                    _lane_trace_path(trace_dir, spec, cell_index, seed)):
                return False
    return True


def _artifact(spec, spec_hash, results, skipped, t0) -> Dict:
    return {
        "spec": spec.to_dict(),
        "spec_hash": spec_hash,
        "cells": results,
        "skipped_cells": skipped,
        "wall_clock_s": round(time.monotonic() - t0, 4),
        "result_digest": artifact_digest(results),
    }


def run_campaign(
    spec: CampaignSpec,
    out_path: Optional[str] = None,
    wall_budget_s: Optional[float] = None,
    resume: bool = True,
    telemetry: Optional[bool] = None,
    trace_dir: Optional[str] = None,
    mesh_devices: Optional[int] = None,
    device="cuda",
    lanes_out: Optional[Dict[int, Dict]] = None,
) -> Dict:
    """Run every cell of the campaign (JAX ``engine.py:766``): with
    ``out_path`` the artifact is written after every cell and a re-run
    of the same spec hash resumes from it; ``wall_budget_s`` stops
    starting cells once spent (the rest land in ``skipped_cells``);
    ``telemetry`` None defers to the spec, and ``trace_dir`` asks for it
    and writes one flight-recorder JSONL a (cell, lane) there.  With
    ``lanes_out`` (a dict, the port's own) each cell that runs stores
    its lanes' stacked finals and metrics (a detect cell's detect
    rounds, a recording cell's traces) under its cell index, for digests
    and checks."""
    if telemetry is None:
        telemetry = spec.telemetry
    if trace_dir:
        telemetry = True
    spec_hash = spec.spec_hash()
    cells = spec.cells()
    done: Dict[int, Dict] = {}
    if resume and out_path:
        prior = _load_artifact(out_path, spec_hash)
        if prior:
            done = {int(c["cell_index"]): c for c in prior.get("cells", [])}

    t0 = time.monotonic()
    results: List[Dict] = []
    skipped: List[int] = []
    for i, cell in enumerate(cells):
        if i in done and _cached_cell_satisfies(done[i], spec, i, telemetry,
                                                trace_dir):
            results.append(done[i])
            continue
        if wall_budget_s is not None and time.monotonic() - t0 > wall_budget_s:
            skipped.append(i)
            continue
        kept = None if lanes_out is None else lanes_out.setdefault(i, {})
        res = _run_cell(spec, cell, cell_index=i, telemetry=telemetry,
                        trace_dir=trace_dir, mesh_devices=mesh_devices,
                        device=device, lanes_out=kept)
        res["cell_index"] = i
        results.append(res)
        if out_path:
            _write_artifact(out_path, _artifact(spec, spec_hash, results,
                                                skipped, t0))
    artifact = _artifact(spec, spec_hash, results, skipped, t0)
    if out_path:
        _write_artifact(out_path, artifact)
    return artifact
