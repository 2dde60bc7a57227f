"""The port's command line: the ``sim`` command of
``corrosion_tpu/cli/main.py`` over the port's runner, campaign engine,
flight-recorder artifacts and topology and protocol registries.

    python -m corrosion_tpu_torch.cli.main sim write-storm-100k --seed 0
    python -m corrosion_tpu_torch.cli.main sim ground-truth-3node --device cpu
    python -m corrosion_tpu_torch.cli.main sim campaign run --spec fault-parity-3node
    python -m corrosion_tpu_torch.cli.main sim trace show --in run.jsonl
    python -m corrosion_tpu_torch.cli.main sim topo show --topology wan-3x2

A scenario run prints the runner's record as one JSON line, with JAX's
scenario names, flags and refusals.  ``--device`` (``cuda`` by default,
or ``cpu``) is the port's own flag: it goes to every config and to
`run_campaign`, and without a card a run fails unless it asks for the
CPU.  The trace, topo and proto views and the campaign compare and
report read files and registries only, and never touch a device.

JAX flags whose counterpart the port does not carry yet exit 2 with the
ROADMAP item that brings it (`_UNPORTED_FLAGS`), as do JAX scenarios the
port lacks (`_UNPORTED_SCENARIOS`) and ``sim profile``; nothing is
ignored silently.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
from typing import List, Optional

#: scenario name → `..sim.runner` config-fn attribute, JAX's names for
#: the scenarios the port carries: the CLI's choices derive from the keys
#: and each scenario's flags from its fn's signature
_SIM_SCENARIOS = {
    "ground-truth-3node": "config_ground_truth_3node",
    # the fault-plan demo campaign, one seed through the campaign engine
    "fault-campaign-3node": "config_fault_campaign_3node",
    "swim-churn-64": "config_swim_churn_64",
    "swim-churn-partial-4k": "config_swim_churn_partial",
    "broadcast-1k": "config_broadcast_1k",
    "partition-heal-10k": "config_partition_heal_10k",
    "write-storm-100k": "config_write_storm_100k",
    "gapstress": "config_write_storm_gapstress",
    "gapstress-distortion": "config_gapstress_distortion",
    # packed against dense on the storm shape (results must be identical;
    # reports the realized speedup)
    "storm-ab": "config_storm_ab",
    # the storm shape under a loss + partition + crash fault plan on the
    # packed round, against its faultless twin
    "packed-fault-storm": "config_packed_fault_storm",
    # the fault storm with the flight recorder on: per-round telemetry
    # overhead against plain, and the coverage-curve summary
    "fault-storm-telemetry": "config_fault_storm_telemetry",
    # the 1M-node tier on one card, ground-truth membership
    "fault-storm-1m": "config_fault_storm_1m",
    # the uniform-vs-PeerSwap frontier campaign, reduced to ratios
    "peer-sampler-frontier": "config_peer_sampler_frontier",
    # the protocol-variant frontier campaign and its sampler storm
    "protocol-frontier": "config_protocol_frontier",
}

#: JAX scenarios the port does not carry, and the ROADMAP item that
#: brings each (or says why none will)
_UNPORTED_SCENARIOS = {
    "packed-fault-storm-sharded": (
        "config_packed_fault_storm_sharded: node sharding over several "
        "cards is not ported yet (ROADMAP A13)"),
    "serving-loadgen": (
        "config_serving_loadgen drives the host agent tier, which the "
        "port does not carry (ROADMAP A, not queued)"),
    "serving-loadgen-mp": (
        "config_serving_loadgen_mp drives the host agent tier, which the "
        "port does not carry (ROADMAP A, not queued)"),
    "phase-profile": (
        "config_phase_profile needs the port's profiler (ROADMAP A11)"),
    "memory-budget": (
        "config_memory_budget needs the port's memory budget "
        "(ROADMAP A11)"),
}

_SHARDING = "sharding over several cards is not ported yet (ROADMAP A13)"
_PARITY = ("the host-parity join needs the host agent tier, which the port "
           "does not carry (ROADMAP A, not queued)")
_SERVING = ("the serving rungs drive the host agent tier, which the port "
            "does not carry (ROADMAP A, not queued)")
#: JAX flags whose counterpart the port does not carry: (argparse dest,
#: flag, value type, why it is refused)
_UNPORTED_FLAGS = (
    ("devices", "--devices", int, _SHARDING),
    ("mesh_devices", "--mesh-devices", int, _SHARDING),
    ("xla_profile", "--xla-profile", str,
     "the port's profiler capture is not ported yet (ROADMAP A11)"),
    ("parity", "--parity", str, _PARITY),
    ("round_s", "--round-s", float, _PARITY),
    ("workers", "--workers", int, _SERVING),
    ("writers", "--writers", int, _SERVING),
)


def _print_json(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


def _refuse(message: str) -> int:
    print(f"error: {message}", file=sys.stderr)
    return 2


def _check_device(device: str) -> Optional[int]:
    """None when ``device`` can run here, else the exit code after the
    device error (`..device.resolve_device`'s message) is printed."""
    from ..device import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    return None


def cmd_sim(args) -> int:
    """Run a simulator config, or dispatch `sim campaign ...`,
    `sim trace show`, `sim topo show` or `sim proto show`."""
    if args.scenario == "profile":
        return _refuse(
            "sim profile reads the phase-attribution ledgers of the "
            "port's profiler, which is not ported yet (ROADMAP A11)")
    if args.scenario in _UNPORTED_SCENARIOS:
        return _refuse(f"scenario {args.scenario!r} is not in the port: "
                       f"{_UNPORTED_SCENARIOS[args.scenario]}")
    for dest, flag, _, why in _UNPORTED_FLAGS:
        if getattr(args, dest) is not None:
            return _refuse(f"{flag} is not in the port: {why}")
    if args.scenario == "trace":
        return cmd_trace(args)
    if args.scenario == "topo":
        return cmd_topo(args)
    if args.scenario == "proto":
        return cmd_proto(args)
    # --trace-out is the scenario form (one JSONL per run or seed),
    # --trace-dir the campaign form (one JSONL per cell and lane)
    if args.scenario == "campaign" and args.trace_out:
        return _refuse("campaign runs write per-cell traces via "
                       "--trace-dir DIR, not --trace-out")
    if args.scenario != "campaign" and args.trace_dir:
        return _refuse("--trace-dir is a campaign flag; scenario runs "
                       "take --trace-out FILE")
    if args.scenario == "campaign":
        return cmd_campaign(args)
    return _run_sim_scenario(args)


def _run_sim_scenario(args) -> int:
    from ..sim import runner

    fn = getattr(runner, _SIM_SCENARIOS[args.scenario])
    kwargs = {}
    # what a scenario takes comes from its config fn's signature
    params = inspect.signature(fn).parameters
    if args.nodes and "n_nodes" in params:
        kwargs["n_nodes"] = args.nodes
    # the topology and sampler axes: a silently ignored topology would
    # fake a WAN measurement, so scenarios without the axis refuse it
    if args.topology:
        if "topo_family" not in params:
            return _refuse(
                f"scenario {args.scenario!r} does not take --topology "
                "(axis-aware scenarios: broadcast-1k, write-storm-100k; "
                "`sim topo show` lists families)")
        kwargs["topo_family"] = args.topology
    if args.sampler:
        if "sampler" not in params:
            return _refuse(
                f"scenario {args.scenario!r} does not take --sampler "
                "(axis-aware scenarios: broadcast-1k, write-storm-100k)")
        kwargs["sampler"] = args.sampler
    # the protocol axis: refused where absent, and an unknown family
    # exits 2 with the list
    if args.proto:
        if "proto_family" not in params:
            return _refuse(
                f"scenario {args.scenario!r} does not take --proto "
                "(axis-aware scenarios: broadcast-1k, write-storm-100k; "
                "`sim proto show` lists families)")
        from ..proto import FAMILIES as _PROTO_FAMILIES

        if args.proto not in _PROTO_FAMILIES:
            return _refuse(f"unknown protocol family {args.proto!r} "
                           f"(have {sorted(_PROTO_FAMILIES)})")
        kwargs["proto_family"] = args.proto
    # the flight recorder: a scenario records if its config fn takes
    # `telemetry` or `trace_path` (fault-storm-telemetry always records:
    # `trace_path` only); anything else refuses the flags
    if (args.telemetry or args.trace_out) and not (
        "telemetry" in params or "trace_path" in params
    ):
        return _refuse(f"scenario {args.scenario!r} does not support "
                       "--telemetry/--trace-out")
    if args.trace_out and "trace_path" not in params:
        return _refuse(f"scenario {args.scenario!r} supports --telemetry "
                       "but not --trace-out")
    if (args.telemetry or args.trace_out) and "telemetry" in params:
        kwargs["telemetry"] = True
    failed = _check_device(args.device)
    if failed is not None:
        return failed
    kwargs["device"] = args.device
    trace_out = args.trace_out
    base_seed = args.seed if args.seed is not None else 0
    n_seeds = args.seeds or 1
    if n_seeds <= 1:
        if trace_out:
            kwargs["trace_path"] = trace_out
        print(json.dumps(fn(seed=base_seed, **kwargs), default=float))
        return 0

    def seed_trace_path(seed: int):
        # one artifact a seed: a shared path would keep the last only
        if not trace_out:
            return None
        root, ext = os.path.splitext(trace_out)
        return f"{root}.seed{seed}{ext or '.jsonl'}"

    # several seeds: the per-seed records and the cross-seed percentiles
    # of every numeric field
    runs = [
        fn(
            seed=base_seed + i,
            **(
                dict(kwargs, trace_path=seed_trace_path(base_seed + i))
                if trace_out
                else kwargs
            ),
        )
        for i in range(n_seeds)
    ]
    numeric = {
        k for k in runs[0]
        if all(isinstance(r.get(k), (int, float)) for r in runs)
    }
    summary = {}
    for k in sorted(numeric):
        vals = sorted(float(r[k]) for r in runs)
        summary[k] = {
            "p50": vals[len(vals) // 2],
            "p99": vals[min(len(vals) - 1, int(len(vals) * 0.99))],
            "min": vals[0],
            "max": vals[-1],
        }
    print(json.dumps(
        {"seeds": args.seeds, "summary": summary, "runs": runs},
        default=float,
    ))
    return 0


def cmd_topo(args) -> int:
    """`sim topo show [--topology FAM] [--nodes N] [--json]`: a topology
    family's tier table (region and AZ blocks, delay and loss classes,
    degree histogram, the count of its link events), or without
    ``--topology`` the registry."""
    from ..topo import (
        FAMILIES,
        az_blocks,
        family_topology,
        topology_link_events,
    )

    if args.campaign_cmd != "show":
        raise SystemExit("usage: sim topo show [--topology FAM] [--nodes N]")
    if not args.topology:
        out = {name: dict(kw) for name, kw in sorted(FAMILIES.items())}
        if args.json:
            _print_json({"families": out})
        else:
            print("topology families (sim topo show --topology NAME):")
            for name, kw in out.items():
                print(f"  {name}: {json.dumps(kw, sort_keys=True)}")
        return 0
    try:
        kw = family_topology(args.topology)
    except KeyError:
        return _refuse(f"unknown topology family {args.topology!r} "
                       f"(have {sorted(FAMILIES)})")
    n = args.nodes or 96
    from ..sim.topology import Topology, loss_tiers

    topo = Topology(**kw)
    blocks = az_blocks(n, topo.n_regions, topo.n_azs)
    base, az_t, inter_t = loss_tiers(topo)
    if topo.region_delay_matrix:
        # a measured-RTT family: the matrix is the delay rule
        tiers = {
            "in-region": {"delay_rounds": 0, "loss": base / 256.0},
            "cross-region": {
                "delay_rounds": "matrix", "loss": inter_t / 256.0,
            },
            "delay_matrix_rounds": [
                list(row) for row in topo.region_delay_matrix
            ],
        }
    else:
        tiers = {
            "same-az": {
                "delay_rounds": topo.intra_delay, "loss": base / 256.0,
            },
            "cross-az": {"delay_rounds": topo.az_delay, "loss": az_t / 256.0},
            "cross-region": {
                "delay_rounds": topo.inter_delay, "loss": inter_t / 256.0,
            },
        }
    degrees = {}
    if topo.degree_classes:
        k = len(topo.degree_classes)
        for i, d in enumerate(topo.degree_classes):
            share = len(range(i, n, k))
            degrees[str(d)] = degrees.get(str(d), 0) + share
    events = topology_link_events(topo, n, end=1)
    out = {
        "family": args.topology,
        "topology": kw,
        "n_nodes": n,
        "az_blocks": [
            {"region": r, "range": f"{lo}:{hi}"} for r, lo, hi in blocks
        ],
        "tiers": tiers,
        "degree_histogram": degrees or None,
        "host_link_events": len(events),
    }
    if args.json:
        _print_json(out)
        return 0
    print(f"topology family {args.topology!r} at {n} nodes:")
    print(f"  {json.dumps(kw, sort_keys=True)}")
    print("  az blocks: " + ", ".join(
        f"r{r}[{lo}:{hi}]" for r, lo, hi in blocks
    ))
    for name, t in tiers.items():
        if not isinstance(t, dict):
            print(f"  {name}: {json.dumps(t)}")
            continue
        print(
            f"  {name:>13}: delay {t['delay_rounds']} rounds, "
            f"loss {t['loss']:.3f}"
        )
    if degrees:
        print(f"  degree histogram: {json.dumps(degrees, sort_keys=True)}")
    print(f"  host-tier link events (range rectangles): {len(events)}")
    return 0


def cmd_proto(args) -> int:
    """`sim proto show [--proto FAM] [--json]`: one protocol family's
    knob overlay and its resolved point (the family over the defaults),
    or without ``--proto`` the registry."""
    from ..proto import DEFAULTS, FAMILIES, family_proto

    if args.campaign_cmd != "show":
        raise SystemExit("usage: sim proto show [--proto FAM]")
    if not args.proto:
        out = {name: dict(kw) for name, kw in sorted(FAMILIES.items())}
        if args.json:
            _print_json({"families": out, "defaults": dict(DEFAULTS)})
        else:
            print("protocol families (sim proto show --proto NAME):")
            for name, kw in out.items():
                print(f"  {name}: {json.dumps(kw, sort_keys=True)}")
            print(f"  defaults: {json.dumps(DEFAULTS, sort_keys=True)}")
        return 0
    try:
        kw = family_proto(args.proto)
    except KeyError:
        return _refuse(f"unknown protocol family {args.proto!r} "
                       f"(have {sorted(FAMILIES)})")
    resolved = dict(DEFAULTS)
    resolved.update(kw)
    out = {
        "family": args.proto,
        "overlay": kw,
        "resolved": resolved,
    }
    if args.json:
        _print_json(out)
        return 0
    print(f"protocol family {args.proto!r}:")
    print(f"  overlay:  {json.dumps(kw, sort_keys=True)}")
    print(f"  resolved: {json.dumps(resolved, sort_keys=True)}")
    return 0


def cmd_trace(args) -> int:
    """`sim trace show --in FILE [--json]`: a flight-recorder JSONL
    artifact's header, summary and a compact table of its rows (per
    round for the simulator's files, per write for the host tier's)."""
    if args.campaign_cmd != "show":
        raise SystemExit("usage: sim trace show --in FILE [--json]")
    if not args.in_path:
        raise SystemExit("sim trace show needs --in FILE")
    with open(args.in_path) as f:
        head = json.loads(f.readline())
        rows = [json.loads(line) for line in f if line.strip()]
    if head.get("kind") != "flight_recorder":
        raise SystemExit(f"{args.in_path} is not a flight-recorder artifact")
    if args.json:
        _print_json({"header": head, "rounds": rows})
        return 0
    host_tier = head.get("tier") == "host"
    if host_tier:
        print(
            f"flight recorder v{head.get('version')} (host tier): "
            f"{head.get('n_nodes', '?')} nodes, "
            f"{head.get('writes', len(rows))} writes"
        )
    else:
        print(
            f"flight recorder v{head.get('version')}: "
            f"{head['n_nodes']} nodes × {head['n_payloads']} payloads, "
            f"{head['rounds']} rounds"
        )
    for k in (
        "campaign", "cell_index", "seed", "scenario", "writers",
        "watchers", "traceparent",
    ):
        if k in head:
            print(f"  {k}: {head[k]}")
    _print_json(head.get("summary", {}))
    if host_tier:
        cols = (
            "t", "actor", "version", "node", "n_changes",
            "broadcast_out_ms", "publish_to_visible_ms", "hlc_lag_ms",
        )
    else:
        cols = (
            "t", "coverage_frac", "delivered", "bcast_bytes", "sync_bytes",
            "sync_sessions", "bcast_dropped", "bcast_cut", "swim_down",
            "crashes", "wipes", "gap_overflow",
        )
    print("  ".join(f"{c:>13}" for c in cols))
    for row in rows:
        print("  ".join(f"{row.get(c, ''):>13}" for c in cols))
    return 0


def _cell_round_path(c: dict) -> str:
    """The path a campaign cell ran: its round ("packed" or "dense"),
    the host serving path, or "unknown" for a cell resumed from an
    artifact older than the key."""
    if c.get("kind") == "host-serving":
        return "host"
    return c.get("round_path", "unknown")


def cmd_campaign(args) -> int:
    """`sim campaign run|compare|report` (`..campaign`): declarative
    seed-ensemble campaigns with convergence bands.

    - ``run``: run a spec (a builtin name or a JSON file) and write its
      band artifact, resumable through the artifact path, with a wall
      budget (``--budget-s``); ``--telemetry`` and ``--trace-dir``
      record every cell;
    - ``compare``: hold a candidate artifact against a baseline; exits 1
      on a regress verdict;
    - ``report``: an artifact's bands, with ``--telemetry`` each cell's
      flight-recorder block too.
    """
    from ..campaign import BUILTIN_SPECS, builtin_spec, load_spec
    from ..campaign.report import compare

    if args.campaign_cmd == "report":
        path = args.in_path or args.candidate
        if not path:
            raise SystemExit("sim campaign report needs --in ARTIFACT")
        with open(path) as f:
            art = json.load(f)
        out = {
            "name": art.get("spec", {}).get("name"),
            "spec_hash": art.get("spec_hash"),
            "result_digest": art.get("result_digest"),
            "skipped_cells": art.get("skipped_cells", []),
            "cells": [],
        }
        for c in art.get("cells", []):
            serving = c.get("kind") == "host-serving"
            entry = {
                "params": c.get("params", {}),
                "round_path": _cell_round_path(c),
                "mesh": c.get("mesh"),
                "all_converged": c.get("all_converged"),
                "bands": c.get("bands", {}),
            }
            if serving:
                entry["kind"] = "host-serving"
                entry["consistent"] = c.get("per_seed", {}).get(
                    "consistent"
                )
                entry["use_faults"] = c.get("use_faults")
            if c.get("traceparent"):
                entry["traceparent"] = c["traceparent"]
            if args.telemetry and "telemetry" in c:
                entry["telemetry"] = c["telemetry"]
            out["cells"].append(entry)
        _print_json(out)
        return 0

    if args.campaign_cmd == "compare":
        if not (args.baseline and args.candidate):
            raise SystemExit(
                "sim campaign compare needs --baseline and --candidate"
            )
        with open(args.baseline) as f:
            base = json.load(f)
        with open(args.candidate) as f:
            cand = json.load(f)
        report = compare(
            base, cand, tol_frac=args.tol_frac, tol_abs=args.tol_abs
        )
        print(json.dumps(report, indent=2, default=float))
        return 0 if report["verdict"] == "pass" else 1

    if args.campaign_cmd != "run":
        raise SystemExit("usage: sim campaign {run|compare|report} ...")
    for flag, val in (
        ("--proto", args.proto),
        ("--topology", args.topology),
        ("--sampler", args.sampler),
    ):
        if val:
            # campaign cells take an axis as a spec key, never a flag
            raise SystemExit(
                f"error: {flag} is a scenario-run flag; campaign cells "
                "take the axis as a spec scenario/grid key "
                f"(e.g. proto_family / topo_family / peer_sampler)"
            )
    if not args.spec:
        raise SystemExit(
            f"--spec required: a JSON spec file or one of "
            f"{sorted(BUILTIN_SPECS)}"
        )
    # --seeds/--seed replace the spec's seeds only when given (`--seed 0`
    # counts as given): a spec keeps its own seed set otherwise
    seed_override = None
    if args.seeds is not None or args.seed is not None:
        base = args.seed if args.seed is not None else 0
        seed_override = [base + i for i in range(max(1, args.seeds or 1))]
    if os.path.exists(args.spec):
        spec = load_spec(args.spec)
        if seed_override is not None:
            import dataclasses as _dc

            spec = _dc.replace(spec, seeds=tuple(seed_override))
    else:
        spec = builtin_spec(args.spec, seeds=seed_override)
    failed = _check_device(args.device)
    if failed is not None:
        return failed
    from ..campaign.engine import run_campaign

    out = args.out or f"CAMPAIGN_{spec.name}_{spec.spec_hash()}.json"
    artifact = run_campaign(
        spec, out_path=out, wall_budget_s=args.budget_s,
        resume=not args.no_resume,
        telemetry=args.telemetry or None,
        trace_dir=args.trace_dir,
        device=args.device,
    )
    summary = {
        "spec_hash": artifact["spec_hash"],
        "result_digest": artifact["result_digest"],
        "artifact": out,
        "cells": len(artifact["cells"]),
        "skipped_cells": artifact["skipped_cells"],
        "all_converged": all(
            c.get("all_converged", False) for c in artifact["cells"]
        ),
        "bands": {
            json.dumps(c.get("params", {}), sort_keys=True): (
                c["bands"].get("rounds")
                or c["bands"].get("publish_visible_p99_s")
            )
            for c in artifact["cells"]
        },
        # the round each grid point ran, so a dense fallback shows
        "kernel_paths": {
            json.dumps(c.get("params", {}), sort_keys=True): (
                _cell_round_path(c)
                + (
                    "@nodes={}".format(c["mesh"]["axes"]["nodes"])
                    if c.get("mesh")
                    else ""
                )
            )
            for c in artifact["cells"]
        },
    }
    print(json.dumps(summary, indent=2, default=float))
    return 0


# -- parser ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="corrosion-tpu-torch",
        description="the gossip simulator's PyTorch/CUDA port",
    )
    sp = p.add_subparsers(dest="command", required=True)
    sm = sp.add_parser(
        "sim",
        help="run a simulator config, `sim campaign run|compare|report` "
        "for declarative seed-ensemble campaigns, `sim trace show` for "
        "flight-recorder artifacts, `sim topo show` for topology "
        "families or `sim proto show` for protocol-variant families",
    )
    sm.add_argument(
        "scenario",
        choices=sorted(list(_SIM_SCENARIOS) + list(_UNPORTED_SCENARIOS))
        + ["campaign", "trace", "topo", "proto", "profile"],
    )
    sm.add_argument(
        "campaign_cmd", nargs="?",
        choices=["run", "compare", "report", "show", "baseline"],
        help="campaign action (scenario=campaign), or `show` "
        "(scenario=trace | topo | proto)",
    )
    sm.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where scenario and campaign runs compute: the card "
        "(default; without one the run fails) or the CPU's plain torch "
        "versions",
    )
    # default None so "explicitly given" is detectable: campaign run
    # tells `--seed 0` (one seed) from no seed flag (the spec's seeds)
    sm.add_argument("--seed", type=int, default=None)
    sm.add_argument(
        "--seeds", type=int, default=None,
        help="run N seeds and report cross-seed percentiles "
        "(campaign run: the ensemble seed set, seed..seed+N-1; "
        "omitted = the spec's own seed set)",
    )
    sm.add_argument("--nodes", type=int, default=None)
    sm.add_argument(
        "--topology", metavar="FAMILY",
        help="topology family: axis-aware scenario runs take it as the "
        "cell topology; `sim topo show --topology F` renders its tier "
        "table (omit to list families)",
    )
    sm.add_argument(
        "--sampler", choices=["uniform", "peerswap"],
        help="peer-selection seam on axis-aware scenarios",
    )
    sm.add_argument(
        "--proto", metavar="FAMILY",
        help="protocol-variant family: axis-aware scenario runs take it "
        "as the cell's protocol point; `sim proto show --proto F` "
        "renders its resolved knobs (omit to list families)",
    )
    sm.add_argument(
        "--spec", help="campaign run: JSON spec file or builtin name"
    )
    sm.add_argument(
        "--out", help="campaign run: artifact path (resumable)"
    )
    sm.add_argument(
        "--budget-s", type=float, default=None,
        help="campaign run: wall-clock budget; leftover cells are "
        "skipped and resumed next run",
    )
    sm.add_argument(
        "--no-resume", action="store_true",
        help="campaign run: ignore an existing artifact",
    )
    sm.add_argument("--baseline", help="campaign compare: baseline artifact")
    sm.add_argument("--candidate", help="campaign compare: candidate artifact")
    sm.add_argument(
        "--telemetry", action="store_true",
        help="flight recorder: record per-round telemetry (scenario runs "
        "gain a summary block; campaign run records every cell; campaign "
        "report prints it)",
    )
    sm.add_argument(
        "--trace-out",
        help="scenario runs: write the flight-recorder JSONL here "
        "(implies --telemetry)",
    )
    sm.add_argument(
        "--trace-dir",
        help="campaign run: write per-(cell, lane) flight-recorder "
        "JSONL traces here (implies --telemetry)",
    )
    sm.add_argument(
        "--in", dest="in_path",
        help="trace show / campaign report: input artifact path",
    )
    sm.add_argument(
        "--json", action="store_true",
        help="trace, topo and proto show: raw JSON instead of the table",
    )
    sm.add_argument(
        "--tol-frac", type=float, default=0.10,
        help="campaign compare: fractional band tolerance",
    )
    sm.add_argument(
        "--tol-abs", type=float, default=2.0,
        help="campaign compare: absolute band tolerance (rounds)",
    )
    # JAX's flags the port refuses (`_UNPORTED_FLAGS`), parsed so the
    # refusal names the ROADMAP item instead of argparse's usage line
    for dest, flag, kind, why in _UNPORTED_FLAGS:
        sm.add_argument(flag, dest=dest, type=kind, default=None,
                        help=f"refused: {why}")
    sm.set_defaults(fn=cmd_sim)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
