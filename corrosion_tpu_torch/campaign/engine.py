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
factored plan on the packed round, faultless on the dense round — and
detect cells (``detect_membership``: configs #2/#2b, the detect loop on
lanes, banding ``detect_round`` with JAX's per-lane detection quality).
A detect cell is refused with JAX's ValueErrors for what it cannot
measure.  The rest raises NotImplementedError, naming its ROADMAP item:
fault plans on the dense round and the recorder on lanes
(``measure_wire``, ``telemetry``) are B16d, a mesh is A13, host-serving
cells and host parity are host tier (not queued).  The cell's
``traceparent`` and its span tree belong to the host tracing tier and
are left out (the digest excludes them).
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


def _refuse(spec: CampaignSpec, cell: Dict[str, object], cfg,
            telemetry: bool) -> None:
    """The cells the engine does not run.  First JAX's own ValueErrors
    (``engine.py:190-231``), word for word: what a detect cell, or a
    wire measurement, cannot measure.  Then the port's
    NotImplementedErrors, each naming its ROADMAP item; the refusals of
    what a cell resolves to — budgets on the packed round, a topology,
    sampler or protocol other than the defaults, fault plans on the
    dense round, matrix and latency plans — follow in
    `..sim.lanes.check_packed_lanes` and `check_dense_lanes`."""
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
    if telemetry or measure_wire:
        raise NotImplementedError(
            "telemetry and measure_wire cells (the recorder's lanes, "
            "K17-K19) are not ported yet (ROADMAP B16d)")
    if spec._meta(cell, "churn"):
        raise NotImplementedError(
            "the churn key on lanes is not ported yet (ROADMAP B16d)")


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
    telemetry: bool = False,
    mesh_devices: Optional[int] = None,
    device="cuda",
    lanes_out: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """One parameter point: the whole seed set as one lane-batched
    ensemble, reduced to per-seed records and cross-seed bands (JAX
    ``engine.py:106 _run_cell``, sim and detect cells).  A detect cell
    runs `.ensemble.run_detect_ensemble` and bands ``detect_round`` per
    seed, None for a lane that never detected.  With ``lanes_out`` the
    cell's stacked finals and metrics (and a detect cell's detect
    rounds) are stored in it."""
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
    _refuse(spec, cell, cfg, telemetry)
    topo = spec.topo(cell)
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every(cell))
    detect = spec.detect_membership(cell)
    plan = None if detect else spec.fault_plan(cell, seed=spec.seeds[0])
    round_path = "packed" if packed_supported(cfg, topo) else "dense"
    mesh = ensemble_mesh(cfg, mesh_devices)
    n_devices = 1

    k = len(spec.seeds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    if detect:
        finals, metrics, detect_rounds = run_detect_ensemble(
            cfg, topo, meta, spec.seeds, kill_every=spec.kill_every(cell),
            max_rounds=spec.max_rounds, mesh=mesh, device=dev)
    else:
        finals, metrics = run_seed_ensemble(
            plan, cfg, topo, meta, spec.seeds, max_rounds=spec.max_rounds,
            mesh=mesh, device=dev,
        )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    finals.have[0, 0, 0].item()  # a real host read
    wall = time.monotonic() - t0
    if lanes_out is not None:
        lanes_out.update(finals=finals, metrics=metrics)
        if detect:
            lanes_out["detect_rounds"] = detect_rounds

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
    cell_bands = {
        m: bands(per_seed[m]) for m in BAND_METRICS if m in per_seed
    }
    executed = int(rounds.max()) if k else 0
    floor = executed * k * analytic_min_round_s(cfg, n_devices)
    verdict = WALL_OK if wall >= floor else WALL_VIOLATED
    return {
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


def _cached_cell_satisfies(telemetry: bool) -> bool:
    """A cached cell is reused unless this run asks for the recorder (JAX's
    rule: a cached cell lacks a telemetry block, and telemetry cells are
    B16d here, so such a run re-runs the cell and refuses it)."""
    return not telemetry


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
    (both are B16d: a cell that would record is refused).  With
    ``lanes_out`` (a dict, the port's own) each cell that runs stores
    its lanes' stacked finals and metrics (and a detect cell's detect
    rounds) under its cell index, for digests and checks."""
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
        if i in done and _cached_cell_satisfies(telemetry):
            results.append(done[i])
            continue
        if wall_budget_s is not None and time.monotonic() - t0 > wall_budget_s:
            skipped.append(i)
            continue
        kept = None if lanes_out is None else lanes_out.setdefault(i, {})
        res = _run_cell(spec, cell, telemetry=telemetry,
                        mesh_devices=mesh_devices, device=device,
                        lanes_out=kept)
        res["cell_index"] = i
        results.append(res)
        if out_path:
            _write_artifact(out_path, _artifact(spec, spec_hash, results,
                                                skipped, t0))
    artifact = _artifact(spec, spec_hash, results, skipped, t0)
    if out_path:
        _write_artifact(out_path, artifact)
    return artifact
