"""Convergence bands, the result digest and the regression compare — the
port's copy of ``corrosion_tpu/campaign/report.py``.

A band is the cross-seed summary (p50/p95/p99/min/max/mean, 'lower'
percentiles, so always an observed value) of one per-seed metric.
`artifact_digest` folds a campaign's deterministic cell payloads into
its replay identity: the port's artifact of a spec has the digest JAX's
artifact of the same spec has.  `compare` holds a candidate artifact
against a baseline with JAX's tolerance rule.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .spec import canonical_json, content_hash

#: per-seed metrics that band and regression-compare (higher = worse)
BAND_METRICS = (
    "rounds", "p99_node_convergence_round", "detect_round",
    "publish_visible_p50_s", "publish_visible_p95_s",
    "publish_visible_p99_s",
    "wire_bytes", "order_violations",
)
#: cell keys left out of the result digest: measurements, run
#: configuration and span ids
NONDETERMINISTIC_KEYS = (
    "wall_clock_s", "wall_defensible_s", "wall_verdict", "walls",
    "host_parity", "traceparent", "telemetry",
    "mesh", "n_devices",
)


def bands(values) -> Dict[str, float]:
    """Distribution summary of one per-seed vector; None and NaN entries
    are left out, and an all-None vector gives an all-None band."""
    arr = np.asarray(
        [v for v in np.asarray(values, dtype=float) if np.isfinite(v)]
    )
    if arr.size == 0:
        return {"p50": None, "p95": None, "p99": None, "min": None,
                "max": None, "mean": None}
    return {
        "p50": float(np.percentile(arr, 50, method="lower")),
        "p95": float(np.percentile(arr, 95, method="lower")),
        "p99": float(np.percentile(arr, 99, method="lower")),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "mean": float(arr.mean()),
    }


#: a host-serving cell's measured payload, left out of its digest
_SERVING_MEASURED_KEYS = ("per_seed", "bands", "all_converged")


def _strip_nondeterministic(cell: Dict) -> Dict:
    drop = set(NONDETERMINISTIC_KEYS)
    if cell.get("kind") == "host-serving":
        drop.update(_SERVING_MEASURED_KEYS)
    return {k: v for k, v in cell.items() if k not in drop}


def artifact_digest(cells: List[Dict]) -> str:
    """The blake2b fold over the cells' deterministic payloads."""
    return content_hash(
        [_strip_nondeterministic(c) for c in cells], digest_size=16
    )


def _cell_key(cell: Dict) -> str:
    return canonical_json(cell.get("params", {}))


def compare(
    baseline: Dict,
    candidate: Dict,
    tol_frac: float = 0.10,
    tol_abs: float = 2.0,
    metrics=BAND_METRICS,
    quantiles=("p50", "p95", "p99"),
) -> Dict:
    """Hold ``candidate`` against ``baseline`` (two `run_campaign`
    artifacts): a (cell, metric, quantile) regresses when the candidate's
    band exceeds baseline · (1 + tol_frac) + tol_abs (``order_violations``
    on any increase, its max band too); a baseline cell missing from the
    candidate, or a lost ``all_converged``, regresses.  ``verdict`` is
    "pass" or "regress"."""
    base_cells = {_cell_key(c): c for c in baseline.get("cells", [])}
    cand_cells = {_cell_key(c): c for c in candidate.get("cells", [])}
    report: Dict[str, object] = {
        "baseline_spec_hash": baseline.get("spec_hash"),
        "candidate_spec_hash": candidate.get("spec_hash"),
        "same_spec": baseline.get("spec_hash") == candidate.get("spec_hash"),
        "identical_results": (
            baseline.get("result_digest") is not None
            and baseline.get("result_digest")
            == candidate.get("result_digest")
        ),
        "cells": [],
        "regressions": [],
        "missing_cells": [],
        "extra_cells": sorted(set(cand_cells) - set(base_cells)),
    }
    for key, base in base_cells.items():
        cand = cand_cells.get(key)
        if cand is None:
            report["missing_cells"].append(key)
            continue
        entry = {"params": base.get("params", {}), "deltas": {}}
        for m in metrics:
            b = base.get("bands", {}).get(m)
            c = cand.get("bands", {}).get(m)
            if not b or not c:
                continue
            qs = (
                quantiles + ("max",)
                if m == "order_violations"
                else quantiles
            )
            for q in qs:
                bv, cv = b.get(q), c.get(q)
                if bv is None and cv is None:
                    worse, delta = False, None
                elif cv is None:
                    worse, delta = True, None
                elif bv is None:
                    worse, delta = False, None
                elif m == "order_violations":
                    delta = cv - bv
                    worse = cv > bv
                else:
                    delta = cv - bv
                    worse = cv > bv * (1.0 + tol_frac) + tol_abs
                entry["deltas"][f"{m}.{q}"] = {
                    "baseline": bv, "candidate": cv, "delta": delta,
                    "regressed": bool(worse),
                }
                if worse:
                    report["regressions"].append(
                        {"cell": key, "metric": f"{m}.{q}",
                         "baseline": bv, "candidate": cv}
                    )
        if base.get("all_converged", True) and not cand.get(
            "all_converged", True
        ):
            report["regressions"].append(
                {"cell": key, "metric": "all_converged",
                 "baseline": True, "candidate": False}
            )
        report["cells"].append(entry)
    report["verdict"] = (
        "pass"
        if not report["regressions"] and not report["missing_cells"]
        else "regress"
    )
    return report
