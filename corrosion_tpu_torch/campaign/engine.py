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

This slice runs the packed sim cells.  The rest raises, naming its
ROADMAP item: the dense round, detect cells and the recorder on lanes
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


def _refuse(spec: CampaignSpec, cell: Dict[str, object],
            telemetry: bool) -> None:
    """The cells this slice does not run, each naming its ROADMAP item;
    the refusals of what a cell resolves to — the dense round, budgets,
    a topology, sampler or protocol other than the defaults, matrix and
    latency plans — follow in `..sim.lanes.check_lanes`."""
    if spec.serving(cell):
        raise NotImplementedError(
            "host-serving cells drive the host agent tier, which the port "
            "does not carry (ROADMAP A, not queued)")
    if spec.host_parity:
        raise NotImplementedError(
            "host_parity replays a plan on the host agent tier, which the "
            "port does not carry (ROADMAP A, not queued)")
    if spec.detect_membership(cell):
        raise NotImplementedError(
            "detect_membership cells (run_detect_ensemble, K23's lanes) "
            "are not ported yet (ROADMAP B16d)")
    if telemetry or spec.measure_wire(cell):
        raise NotImplementedError(
            "telemetry and measure_wire cells (the recorder's lanes, "
            "K17-K19) are not ported yet (ROADMAP B16d)")
    if spec._meta(cell, "churn"):
        raise NotImplementedError(
            "the churn key on lanes is not ported yet (ROADMAP B16d)")


def _run_cell(
    spec: CampaignSpec,
    cell: Dict[str, object],
    telemetry: bool = False,
    mesh_devices: Optional[int] = None,
    device="cuda",
) -> Dict[str, object]:
    """One parameter point: the whole seed set as one lane-batched
    ensemble, reduced to per-seed records and cross-seed bands (JAX
    ``engine.py:106 _run_cell``, sim cells)."""
    from ..device import resolve_device
    from ..sim.perf import analytic_min_round_s
    from ..sim.state import ALIVE, packed_supported, uniform_payloads
    from .ensemble import ensemble_mesh, run_seed_ensemble

    dev = resolve_device(device)
    _refuse(spec, cell, telemetry)
    cfg = spec.sim_config(cell)
    topo = spec.topo(cell)
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every(cell))
    plan = spec.fault_plan(cell, seed=spec.seeds[0])
    round_path = "packed" if packed_supported(cfg, topo) else "dense"
    mesh = ensemble_mesh(cfg, mesh_devices)
    n_devices = 1

    k = len(spec.seeds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    finals, metrics = run_seed_ensemble(
        plan, cfg, topo, meta, spec.seeds, max_rounds=spec.max_rounds,
        mesh=mesh, device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    finals.have[0, 0, 0].item()  # a real host read
    wall = time.monotonic() - t0

    rounds = finals.t.cpu().numpy()  # [K]
    alive = finals.alive.cpu().numpy()  # [K, N]
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
) -> Dict:
    """Run every cell of the campaign (JAX ``engine.py:766``): with
    ``out_path`` the artifact is written after every cell and a re-run
    of the same spec hash resumes from it; ``wall_budget_s`` stops
    starting cells once spent (the rest land in ``skipped_cells``);
    ``telemetry`` None defers to the spec, and ``trace_dir`` asks for it
    (both are B16d: a cell that would record is refused)."""
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
        res = _run_cell(spec, cell, telemetry=telemetry,
                        mesh_devices=mesh_devices, device=device)
        res["cell_index"] = i
        results.append(res)
        if out_path:
            _write_artifact(out_path, _artifact(spec, spec_hash, results,
                                                skipped, t0))
    artifact = _artifact(spec, spec_hash, results, skipped, t0)
    if out_path:
        _write_artifact(out_path, artifact)
    return artifact
