"""CampaignSpec: a declarative, serializable, content-hashed experiment —
the port's copy of ``corrosion_tpu/campaign/spec.py``.

A campaign is scenario × topology × fault events × parameter grid × seed
set.  The spec serializes to canonical JSON, and its blake2b fold
(`CampaignSpec.spec_hash`) is the campaign's replay identity: the same
spec gives the same hash here and in the JAX package, byte for byte, so
an artifact of either package names the same experiment.

Lane seed ``s`` drives both the scenario's PRNG (``new_sim(cfg, s)``)
and the lane's fault plan (its seed ``s``, whose sim stream is
``derive_seed(s, "sim")``).  The per-cell methods resolve the scenario
into the port's `SimConfig`, `Topology` and `FaultPlan`, with JAX's
refusals; they import the simulator lazily, so the spec layer loads
without a card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..faults import FaultEvent, FaultPlan

#: scenario/grid keys that route to Topology, not SimConfig
_TOPOLOGY_KEYS = (
    "n_regions", "intra_delay", "inter_delay", "loss",
    "n_azs", "az_delay", "az_loss", "inter_loss", "degree_classes",
    "region_delay_matrix",
)
#: the named-topology axis (`..topo.family_topology`)
_TOPO_FAMILY_KEY = "topo_family"
#: the named-protocol axis (`..proto.family_proto`)
_PROTO_FAMILY_KEY = "proto_family"
#: the SimConfig protocol knobs a family bundles (real SimConfig fields)
_PROTO_KEYS = (
    "dissemination", "fanout_schedule", "fanout_decay_rounds",
    "sync_cadence", "ordering",
)
#: spec-level scenario keys that are not SimConfig fields (JAX's list,
#: ``spec.py:102``): the injection cadence, the detect and serving cells'
#: knobs, the topology, churn, wire and protocol axes
_SCENARIO_META_KEYS = (
    "inject_every", "detect_membership", "kill_every",
    "serving", "n_writes", "n_writers", "n_watchers", "rate_hz",
    "settle_timeout_s", "use_faults",
    "topo_family", "churn", "churn_frac", "churn_round", "churn_seed",
    "measure_wire", "proto_family",
    "mp_workers", "api_max_inflight_tx", "global_settle_s",
)
#: serving-cell workload knobs
_SERVING_PARAM_KEYS = (
    "n_writes", "n_writers", "n_watchers", "rate_hz", "settle_timeout_s",
)
#: meta keys that are also SimConfig fields on purpose: a sim cell
#: forwards them; any other collision is refused by `sim_config`
FORWARDED_META_KEYS = ("n_writers",)


def canonical_json(obj) -> str:
    """Deterministic JSON (sorted keys, no whitespace): the bytes every
    content hash here folds."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def content_hash(obj, digest_size: int = 8) -> str:
    return hashlib.blake2b(
        canonical_json(obj).encode(), digest_size=digest_size
    ).hexdigest()


_EVENT_FIELDS = [f.name for f in dataclasses.fields(FaultEvent)]


def event_to_dict(ev: FaultEvent) -> Dict[str, object]:
    return {k: getattr(ev, k) for k in _EVENT_FIELDS}


def event_from_dict(d: Dict[str, object]) -> FaultEvent:
    return FaultEvent(**{k: d[k] for k in _EVENT_FIELDS if k in d})


@dataclass(frozen=True)
class CampaignSpec:
    """One declarative campaign (JAX ``CampaignSpec``, same fields and
    serialization): ``scenario`` holds SimConfig kwargs and the meta keys
    above, ``topology`` Topology kwargs, ``events`` the fault events
    (re-seeded per lane), ``grid`` the axes whose cartesian product gives
    the cells, ``seeds`` the lanes.  ``telemetry``, ``parity_seeds`` and
    ``parity_budget_s`` serialize only when not their defaults."""

    name: str
    scenario: Dict[str, object]
    topology: Dict[str, object] = field(default_factory=dict)
    events: Tuple[FaultEvent, ...] = ()
    grid: Dict[str, List[object]] = field(default_factory=dict)
    seeds: Tuple[int, ...] = (0,)
    max_rounds: int = 1000
    host_parity: bool = False
    round_s: float = 0.05
    telemetry: bool = False
    parity_seeds: int = 1
    parity_budget_s: float = 120.0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        if not self.seeds:
            raise ValueError("a campaign needs at least one seed")
        for k in self.grid:
            if not self.grid[k]:
                raise ValueError(f"grid axis {k!r} has no values")

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        d = {
            "name": self.name,
            "scenario": dict(self.scenario),
            "topology": dict(self.topology),
            "events": [event_to_dict(ev) for ev in self.events],
            "grid": {k: list(v) for k, v in self.grid.items()},
            "seeds": list(self.seeds),
            "max_rounds": self.max_rounds,
            "host_parity": self.host_parity,
            "round_s": self.round_s,
        }
        if self.telemetry:
            d["telemetry"] = True
        if self.parity_seeds != 1:
            d["parity_seeds"] = self.parity_seeds
        if self.parity_budget_s != 120.0:
            d["parity_budget_s"] = self.parity_budget_s
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "CampaignSpec":
        return cls(
            name=d["name"],
            scenario=dict(d.get("scenario", {})),
            topology=dict(d.get("topology", {})),
            events=tuple(event_from_dict(e) for e in d.get("events", [])),
            grid={k: list(v) for k, v in d.get("grid", {}).items()},
            seeds=tuple(d.get("seeds", (0,))),
            max_rounds=int(d.get("max_rounds", 1000)),
            host_parity=bool(d.get("host_parity", False)),
            round_s=float(d.get("round_s", 0.05)),
            telemetry=bool(d.get("telemetry", False)),
            parity_seeds=int(d.get("parity_seeds", 1)),
            parity_budget_s=float(d.get("parity_budget_s", 120.0)),
        )

    def spec_hash(self) -> str:
        """The campaign's replay identity."""
        return content_hash(self.to_dict(), digest_size=8)

    # -- grid expansion -----------------------------------------------------

    def cells(self) -> List[Dict[str, object]]:
        """The grid's cartesian product in sorted-key order (cell i always
        names the same point; the resumable artifact keys on it)."""
        if not self.grid:
            return [{}]
        keys = sorted(self.grid)
        return [
            dict(zip(keys, combo))
            for combo in itertools.product(*(self.grid[k] for k in keys))
        ]

    # -- per-cell constructors ----------------------------------------------

    def sim_config(self, cell: Dict[str, object]):
        """The cell's SimConfig: scenario overlaid by the cell, topology
        and meta keys stripped (a meta key that shadows a SimConfig field
        without being declared forwarded is refused), the protocol
        family's knobs under explicit keys, and ``wan_tuned`` through
        `SimConfig.wan_tuned`."""
        from ..sim.state import SimConfig

        kw = dict(self.scenario)
        kw.update(cell)
        wan = bool(kw.pop("wan_tuned", False))
        proto_fam = kw.pop(_PROTO_FAMILY_KEY, None)
        fields = SimConfig.__dataclass_fields__
        shadowed = sorted(
            k
            for k in _TOPOLOGY_KEYS + _SCENARIO_META_KEYS
            if k in fields and k not in FORWARDED_META_KEYS
        )
        if shadowed:
            raise ValueError(
                f"meta key(s) {shadowed} shadow real SimConfig fields "
                "but are not declared in FORWARDED_META_KEYS — a sim "
                "cell would silently strip them (declare the "
                "forwarding, or rename the meta key)"
            )
        for k in _TOPOLOGY_KEYS + _SCENARIO_META_KEYS + (_TOPO_FAMILY_KEY,):
            if k not in fields:
                kw.pop(k, None)
        if proto_fam:
            from ..proto import family_proto

            for k, v in family_proto(str(proto_fam)).items():
                kw.setdefault(k, v)
        if wan:
            return SimConfig.wan_tuned(kw.pop("n_nodes"), **kw)
        return SimConfig(**kw)

    def topo(self, cell: Dict[str, object]):
        """The cell's Topology: topology keys from ``topology``, the
        scenario (refused in both) and the cell, over a named family."""
        from ..sim.topology import Topology

        kw = dict(self.topology)
        for k in _TOPOLOGY_KEYS + (_TOPO_FAMILY_KEY,):
            if k in self.scenario:
                if k in self.topology:
                    raise ValueError(
                        f"{k!r} appears in both scenario and topology"
                    )
                kw[k] = self.scenario[k]
        kw.update(
            {
                k: cell[k]
                for k in _TOPOLOGY_KEYS + (_TOPO_FAMILY_KEY,)
                if k in cell
            }
        )
        fam = kw.pop(_TOPO_FAMILY_KEY, None)
        if fam:
            from ..topo import family_topology

            base = family_topology(str(fam))
            base.update(kw)
            kw = base
        return Topology(**kw)

    def inject_every(self, cell: Dict[str, object]) -> int:
        return int(
            cell.get("inject_every", self.scenario.get("inject_every", 1))
        )

    def detect_membership(self, cell: Dict[str, object]) -> bool:
        return bool(
            cell.get(
                "detect_membership",
                self.scenario.get("detect_membership", False),
            )
        )

    def kill_every(self, cell: Dict[str, object]) -> int:
        return int(
            cell.get("kill_every", self.scenario.get("kill_every", 0))
        )

    def _meta(self, cell: Dict[str, object], key: str, default=None):
        return cell.get(key, self.scenario.get(key, default))

    def measure_wire(self, cell: Dict[str, object]) -> bool:
        return bool(self._meta(cell, "measure_wire", False))

    def proto_family(self, cell: Dict[str, object]):
        return self._meta(cell, _PROTO_FAMILY_KEY)

    def churn_events_for(self, cell: Dict[str, object], n_nodes: int):
        """The cell's churn schedule as fault events (empty without a
        ``churn`` key), from spec values only, never the lane seed."""
        name = self._meta(cell, "churn")
        if not name:
            return ()
        from ..topo import churn_events

        return churn_events(
            str(name), n_nodes,
            frac=float(self._meta(cell, "churn_frac", 0.25)),
            round_knob=int(self._meta(cell, "churn_round", 8)),
            seed=int(self._meta(cell, "churn_seed", 0)),
        )

    def serving(self, cell: Dict[str, object]) -> bool:
        return bool(
            cell.get("serving", self.scenario.get("serving", False))
        )

    def serving_params(self, cell: Dict[str, object]) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for k in _SERVING_PARAM_KEYS:
            if k in cell:
                out[k] = cell[k]
            elif k in self.scenario:
                out[k] = self.scenario[k]
        return out

    def mp_workers(self, cell: Dict[str, object]) -> int:
        return int(self._meta(cell, "mp_workers", 0) or 0)

    def serving_faults(self, cell: Dict[str, object]) -> bool:
        return bool(
            cell.get(
                "use_faults",
                self.scenario.get("use_faults", bool(self.events)),
            )
        )

    def fault_plan(
        self, cell: Dict[str, object], seed: int
    ) -> Optional[FaultPlan]:
        """The cell's plan at a lane seed (None: fault-free), the churn
        axis's events appended to the spec's own."""
        n = int(cell.get("n_nodes", self.scenario["n_nodes"]))
        churn = self.churn_events_for(cell, n)
        if not self.events and not churn:
            return None
        return FaultPlan(
            n_nodes=n, seed=int(seed),
            events=tuple(self.events) + tuple(churn),
            round_s=self.round_s,
        )


def load_spec(path: str) -> CampaignSpec:
    with open(path) as f:
        return CampaignSpec.from_dict(json.load(f))


def save_spec(spec: CampaignSpec, path: str) -> None:
    with open(path, "w") as f:
        json.dump(spec.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


# -- the 100k storm as a seed campaign ---------------------------------------


def storm_scenario(n_nodes: int = 100_000) -> Dict[str, object]:
    """The write storm's scenario keys (``sim.runner._write_storm`` at
    512 payloads, ``inject_every`` 2).  Both byte budgets are null: the
    engine never calls ``optimize_budgets``, so a spec reaches the
    unmetered storm only by saying so."""
    return {
        "n_nodes": n_nodes, "n_payloads": 512, "n_writers": 16,
        "chunks_per_version": 4, "fanout": 3, "sync_interval_rounds": 8,
        "sync_peers": 3, "swim_partial_view": True, "member_slots": 64,
        "n_delay_slots": 2, "inject_every": 2, "wan_tuned": True,
        "rate_limit_bytes_round": None, "sync_budget_bytes": None,
    }


def storm_fault_events(n_nodes: int = 100_000) -> Tuple[FaultEvent, ...]:
    """``sim.runner.storm_fault_plan``'s events: loss 0.15 in rounds
    0–11, a symmetric half split in 4–15, node 1 down in 8–19 and back
    empty."""
    half = n_nodes // 2
    return (
        FaultEvent("loss", 0, 12, p=0.15),
        FaultEvent("partition", 4, 16, src=f"0:{half}",
                   dst=f"{half}:{n_nodes}", symmetric=True),
        FaultEvent("crash", 8, 20, node=1, wipe=True),
    )


def storm_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)), n_nodes: int = 100_000,
    faults: bool = False,
) -> CampaignSpec:
    """The 100k storm (or, with ``faults``, the fault storm) over a seed
    set as one campaign cell: ``storm-100k-seeds8`` and
    ``fault-storm-100k-seeds8`` at the defaults.  Not a builtin of the
    JAX package: its name and keys are this package's, and the JAX
    package's `CampaignSpec` of the same dict has the same hash."""
    tag = "100k" if n_nodes == 100_000 else str(n_nodes)
    kind = "fault-storm" if faults else "storm"
    return CampaignSpec(
        name=f"{kind}-{tag}-seeds{len(tuple(seeds))}",
        scenario=storm_scenario(n_nodes),
        events=storm_fault_events(n_nodes) if faults else (),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def storm_latency_events(n_nodes: int = 100_000) -> Tuple[FaultEvent, ...]:
    """The latency storm's pair (JAX's "storm-mix" latency events of
    tests/sim/test_packed_equivalence.py over the first sixth of the
    nodes): one round of delay and up to one of jitter on every link out
    of ``0:n//6``, rounds 2–15."""
    sel = f"0:{n_nodes // 6}"
    return (
        FaultEvent("delay", 2, 16, src=sel, dst="*", delay_rounds=1),
        FaultEvent("jitter", 2, 16, src=sel, dst="*", delay_rounds=1),
    )


def dense_storm_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)), latency: bool = False,
) -> CampaignSpec:
    """The fault storm on the dense round (``allow_packed: False``) over
    a seed set as one campaign cell: ``dense-fault-storm-100k-seeds8``,
    or with ``latency`` the latency storm (four delay slots and
    `storm_latency_events` after the fault storm's events),
    ``dense-latency-storm-100k-seeds8``.  Not a builtin of the JAX
    package: the JAX package's `CampaignSpec` of the same dict has the
    same hash."""
    scenario = dict(storm_scenario(), allow_packed=False)
    events = storm_fault_events()
    if latency:
        scenario["n_delay_slots"] = 4
        events += storm_latency_events()
    kind = "latency" if latency else "fault"
    return CampaignSpec(
        name=f"dense-{kind}-storm-100k-seeds{len(tuple(seeds))}",
        scenario=scenario,
        events=events,
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def latency_storm_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)), measure_wire: bool = False,
) -> CampaignSpec:
    """The latency storm on the packed round over a seed set as one
    campaign cell (B16l): `dense_storm_seeds_spec(latency=True)`'s
    scenario and events inside the packed envelope —
    ``latency-storm-100k-seeds8`` at the default, and with
    ``measure_wire`` (its lanes' ``wire_bytes`` banded, B16r's packed
    half) ``latency-storm-100k-seeds8-wire``.  Not a builtin of the JAX
    package: the JAX package's `CampaignSpec` of the same dict has the
    same hash."""
    scenario = dict(storm_scenario(), n_delay_slots=4)
    if measure_wire:
        scenario["measure_wire"] = 1
    return CampaignSpec(
        name=f"latency-storm-100k-seeds{len(tuple(seeds))}"
        + ("-wire" if measure_wire else ""),
        scenario=scenario,
        events=storm_fault_events() + storm_latency_events(),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def broadcast_seeds_spec(seeds: Sequence[int] = tuple(range(8))
                         ) -> CampaignSpec:
    """``config_broadcast_1k`` (config #3: 1000 nodes, 8 writers x 32
    versions, fanout 3, 4 ring slots, a wave every 2 rounds, ground-truth
    membership, the dense round) over a seed set as one campaign cell:
    ``broadcast-1k-seeds8`` at the default.  The byte budgets stay at the
    SimConfig defaults (the engine never calls ``optimize_budgets``; 256
    payloads of 8 KiB cannot reach either).  Not a builtin of the JAX
    package: the JAX package's `CampaignSpec` of the same dict has the
    same hash."""
    return CampaignSpec(
        name=f"broadcast-1k-seeds{len(tuple(seeds))}",
        scenario={"n_nodes": 1000, "n_payloads": 256, "n_writers": 8,
                  "fanout": 3, "n_delay_slots": 4, "inject_every": 2},
        seeds=tuple(seeds),
        max_rounds=2000,
    )


def broadcast_wire_seeds_spec(seeds: Sequence[int] = tuple(range(8))
                              ) -> CampaignSpec:
    """`broadcast_seeds_spec` with ``measure_wire`` (B16r): the same cell
    that also bands each lane's ``wire_bytes``, the broadcast and sync
    byte channels of its flight recorder — ``broadcast-1k-seeds8-wire``
    at the default.  Every payload is 8 KiB and every round's bytes stay
    under 2^37, so both packages' f32 sums are exact and the digest is
    JAX's bit for bit."""
    spec = broadcast_seeds_spec(seeds)
    return dataclasses.replace(
        spec, name=f"{spec.name}-wire",
        scenario=dict(spec.scenario, measure_wire=1))


def broadcast_topology_seeds_spec(
    topo_family: str, peer_sampler: str = "uniform",
    seeds: Sequence[int] = tuple(range(8)), measure_wire: bool = False,
    n_delay_slots: Optional[int] = None,
) -> CampaignSpec:
    """`broadcast_seeds_spec` over a topology family under a peer sampler
    (B16t, B16s): config #3 with ``topo_family`` and ``peer_sampler``
    (and ``measure_wire``, and a deeper ring for a family whose delays
    pass the default four slots) — ``broadcast-1k-wan-3x2-peerswap-
    seeds8-wire``, ``broadcast-1k-flat-lossy-uniform-seeds8-wire`` and
    ``broadcast-1k-wan-fly-6r-uniform-seeds8`` among them.  Not a builtin
    of the JAX package: the JAX package's `CampaignSpec` of the same dict
    has the same hash."""
    spec = broadcast_seeds_spec(seeds)
    scenario = dict(spec.scenario, topo_family=topo_family,
                    peer_sampler=peer_sampler)
    if measure_wire:
        scenario["measure_wire"] = 1
    if n_delay_slots is not None:
        scenario["n_delay_slots"] = n_delay_slots
    name = (f"broadcast-1k-{topo_family}-{peer_sampler}-seeds"
            f"{len(tuple(seeds))}" + ("-wire" if measure_wire else ""))
    return dataclasses.replace(spec, name=name, scenario=scenario)


def dense_storm_wan_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    """The 100k write storm on the dense round over wan-3x2 (three
    regions of two AZs, delays 0/1/2 in three ring slots, loss 0 / 2 % /
    10 % by tier) as one campaign cell: ``dense-storm-wan-3x2-100k-
    seeds8`` at the default — every topology lane entry at the storm's
    width (B16t).  Not a builtin of the JAX package: the JAX package's
    `CampaignSpec` of the same dict has the same hash."""
    return CampaignSpec(
        name=f"dense-storm-wan-3x2-100k-seeds{len(tuple(seeds))}",
        scenario=dict(storm_scenario(), allow_packed=False,
                      topo_family="wan-3x2", n_delay_slots=3),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def broadcast_proto_seeds_spec(
    proto_family: str, seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    """`broadcast_wire_seeds_spec` under a protocol family (B16v): config
    #3 with ``proto_family`` and ``measure_wire`` —
    ``broadcast-1k-fanout-decay-seeds8-wire`` and
    ``broadcast-1k-lab-ordered-broken-seeds8-wire`` among them.  Not a
    builtin of the JAX package: the JAX package's `CampaignSpec` of the
    same dict has the same hash."""
    spec = broadcast_wire_seeds_spec(seeds)
    return dataclasses.replace(
        spec,
        name=f"broadcast-1k-{proto_family}-seeds{len(tuple(seeds))}-wire",
        scenario=dict(spec.scenario, proto_family=proto_family))


def broadcast_peerswap_fault_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    """Config #3 over wan-3x2 under PeerSwap with the fault storm's
    events at its width (`storm_fault_events`: loss 0.15, the half split,
    node 1's crash and wipe) as one campaign cell (B16s-f):
    ``broadcast-1k-wan-3x2-peerswap-fault-seeds8`` at the default.  Not a
    builtin of the JAX package: the JAX package's `CampaignSpec` of the
    same dict has the same hash."""
    spec = broadcast_topology_seeds_spec("wan-3x2", "peerswap", seeds)
    return dataclasses.replace(
        spec, name=f"broadcast-1k-wan-3x2-peerswap-fault-seeds"
                   f"{len(tuple(seeds))}",
        events=storm_fault_events(spec.scenario["n_nodes"]))


def dense_storm_push_pull_seeds_spec(
    seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    """The 100k write storm on the dense round under push-pull as one
    campaign cell: ``dense-storm-push-pull-100k-seeds8`` at the default —
    K12p's lane entry at the storm's width (B16v).  Not a builtin of the
    JAX package: the JAX package's `CampaignSpec` of the same dict has the
    same hash."""
    return CampaignSpec(
        name=f"dense-storm-push-pull-100k-seeds{len(tuple(seeds))}",
        scenario=dict(storm_scenario(), allow_packed=False,
                      proto_family="push-pull"),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def storm_topology_seeds_spec(
    topo_family: str, seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    """The 100k write storm on the packed round over a topology family as
    one campaign cell (B16m's topology): ``storm-wan-3x2-100k-seeds8``,
    ``storm-wan-fly-6r-100k-seeds8`` and ``storm-hetero-degree-100k-
    seeds8`` at the default, each with `sim.runner._write_storm`'s ring,
    deep enough for the family's deepest delay class.  Not a builtin of
    the JAX package: the JAX package's `CampaignSpec` of the same dict
    has the same hash."""
    from ..sim.topology import Topology
    from ..topo.families import family_topology

    deepest = Topology(**family_topology(topo_family)).max_delay
    return CampaignSpec(
        name=f"storm-{topo_family}-100k-seeds{len(tuple(seeds))}",
        scenario=dict(storm_scenario(), topo_family=topo_family,
                      n_delay_slots=max(2, deepest + 1)),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def storm_proto_seeds_spec(
    proto_family: str, seeds: Sequence[int] = tuple(range(8)),
    topo_family: Optional[str] = None, faults: bool = False,
) -> CampaignSpec:
    """The 100k write storm on the packed round under a protocol family
    as one campaign cell (B16m's rest): ``storm-push-pull-100k-seeds8``,
    ``storm-lab-ordered-100k-seeds8`` and the like at the default; over a
    topology family (`storm_topology_seeds_spec`'s ring) as
    ``storm-wan-3x2-push-pull-100k-seeds8``; with ``faults`` under the
    fault storm's events as ``fault-storm-push-pull-100k-seeds8``.  Not a
    builtin of the JAX package: the JAX package's `CampaignSpec` of the
    same dict has the same hash."""
    scenario = dict(storm_scenario(), proto_family=proto_family)
    topo = ""
    if topo_family is not None:
        scenario = dict(storm_topology_seeds_spec(topo_family).scenario,
                        proto_family=proto_family)
        topo = f"{topo_family}-"
    kind = "fault-storm" if faults else "storm"
    return CampaignSpec(
        name=f"{kind}-{topo}{proto_family}-100k-seeds{len(tuple(seeds))}",
        scenario=scenario,
        events=storm_fault_events() if faults else (),
        seeds=tuple(seeds),
        max_rounds=3000,
    )


def protocol_frontier_push_pull_spec(
    seeds: Sequence[int] = (0, 1, 2, 3),
) -> CampaignSpec:
    """The committed `protocol-frontier` campaign's push-pull cells
    (wan-3x2 and flat-lossy) without the recorder, as a user's push-pull
    seed ensemble runs them: ``protocol-frontier-push-pull`` — K12p's
    lane entry under the tiers and under the flat stream with no dropped
    slot (B16v).  Not a builtin of the JAX package: the JAX package's
    `CampaignSpec` of the same dict has the same hash."""
    spec = protocol_frontier_spec(seeds)
    scenario = {k: v for k, v in spec.scenario.items()
                if k != "measure_wire"}
    return dataclasses.replace(
        spec, name="protocol-frontier-push-pull", scenario=scenario,
        grid=dict(spec.grid, proto_family=["push-pull"]))


# -- builtin specs (JAX ``spec.py:481-791``, as data) -------------------------


def fault_parity_3node_spec(
    seeds: Sequence[int] = tuple(range(8)),
) -> CampaignSpec:
    return CampaignSpec(
        name="fault-parity-3node",
        scenario={
            "n_nodes": 3, "n_payloads": 12, "fanout": 2,
            "sync_interval_rounds": 4, "n_delay_slots": 4,
            "inject_every": 1,
        },
        events=(
            FaultEvent("loss", 0, 36, p=0.4),
            FaultEvent("partition", 6, 18, src=2, dst=0),
            FaultEvent("delay", 4, 24, src=0, dst=1, delay_rounds=1),
            FaultEvent("jitter", 4, 24, src=0, dst=1, delay_rounds=1),
            FaultEvent("duplicate", 0, 24, src=1, dst=2, p=0.3),
            FaultEvent("crash", 24, 34, node=2, wipe=True),
            FaultEvent("clock_skew", 0, 36, node=1, skew_ns=100_000_000),
        ),
        seeds=tuple(seeds),
        max_rounds=400,
    )


def fault_campaign_3node_spec(seed: int = 0) -> CampaignSpec:
    from ..faults import demo_plan

    plan = demo_plan(seed=seed)
    return CampaignSpec(
        name="fault-campaign-3node",
        scenario={
            "n_nodes": plan.n_nodes, "n_payloads": 16, "fanout": 2,
            "sync_interval_rounds": 4, "n_delay_slots": 4,
            "inject_every": 1,
        },
        events=plan.events,
        seeds=(seed,),
        max_rounds=1000,
    )


def swim_churn_64_spec(
    seeds: Sequence[int] = (0,), n: int = 64, max_rounds: int = 400
) -> CampaignSpec:
    return CampaignSpec(
        name="swim-churn-64",
        scenario={
            "n_nodes": n, "n_payloads": 1, "swim_full_view": True,
            "wan_tuned": True, "detect_membership": True, "kill_every": 3,
        },
        seeds=tuple(seeds),
        max_rounds=max_rounds,
    )


def swim_churn_partial_spec(
    seeds: Sequence[int] = (0,), n: int = 4096, max_rounds: int = 600
) -> CampaignSpec:
    return CampaignSpec(
        name="swim-churn-partial",
        scenario={
            "n_nodes": n, "n_payloads": 1, "swim_partial_view": True,
            "probe_period_rounds": 1,
            "wan_tuned": True, "detect_membership": True, "kill_every": 3,
        },
        seeds=tuple(seeds),
        max_rounds=max_rounds,
    )


def serving_3node_spec(
    seeds: Sequence[int] = (0, 1),
    n: int = 3,
    n_writes: int = 48,
    rate_hz: float = 120.0,
) -> CampaignSpec:
    return CampaignSpec(
        name="serving-3node",
        scenario={
            "n_nodes": n, "serving": True,
            "n_writes": n_writes, "n_writers": 2, "n_watchers": 2,
            "rate_hz": rate_hz, "settle_timeout_s": 30.0,
        },
        events=(
            FaultEvent("loss", 0, 16, p=0.3),
            FaultEvent("partition", 4, 12, src=2, dst=0),
            FaultEvent("delay", 2, 14, src=0, dst=1, delay_rounds=1),
        ),
        grid={"use_faults": [0, 1]},
        seeds=tuple(seeds),
        round_s=0.05,
    )


def peer_sampler_frontier_spec(
    seeds: Sequence[int] = (0, 1, 2, 3),
    n: int = 96,
    max_rounds: int = 400,
) -> CampaignSpec:
    return CampaignSpec(
        name="peer-sampler-frontier",
        scenario={
            "n_nodes": n, "n_payloads": 64, "n_writers": 4, "fanout": 3,
            "sync_interval_rounds": 6, "n_delay_slots": 4,
            "inject_every": 1, "measure_wire": 1,
        },
        grid={
            "peer_sampler": ["uniform", "peerswap"],
            "topo_family": ["wan-3x2", "hetero-degree"],
        },
        seeds=tuple(seeds),
        max_rounds=max_rounds,
    )


def protocol_frontier_spec(
    seeds: Sequence[int] = (0, 1, 2, 3),
    n: int = 96,
    max_rounds: int = 500,
) -> CampaignSpec:
    return CampaignSpec(
        name="protocol-frontier",
        scenario={
            "n_nodes": n, "n_payloads": 64, "n_writers": 4, "fanout": 3,
            "sync_interval_rounds": 6, "n_delay_slots": 4,
            "inject_every": 1, "measure_wire": 1,
        },
        grid={
            "proto_family": [
                "baseline", "swarm-aggressive", "push-pull", "lab-ordered",
            ],
            "topo_family": ["wan-3x2", "flat-lossy"],
        },
        seeds=tuple(seeds),
        max_rounds=max_rounds,
    )


def serving_loadgen_spec(
    seeds: Sequence[int] = (0, 1),
    n: int = 3,
    n_writers: int = 192,
    n_writes: int = 576,
    mp_workers: int = 4,
    overload_inflight: int = 48,
    crash_node: Optional[int] = None,
) -> CampaignSpec:
    kill = (n - 1) if crash_node is None else crash_node
    return CampaignSpec(
        name="serving-loadgen",
        scenario={
            "n_nodes": n, "serving": True, "mp_workers": mp_workers,
            "n_writes": n_writes, "n_writers": n_writers,
            "n_watchers": 4, "rate_hz": 0.0,
            "settle_timeout_s": 45.0, "global_settle_s": 60.0,
        },
        events=(FaultEvent("crash", 8, 40, node=kill),),
        grid={
            "use_faults": [0, 1],
            "api_max_inflight_tx": [0, overload_inflight],
        },
        seeds=tuple(seeds),
        round_s=0.05,
    )


def serving_chaos_spec(
    seeds: Sequence[int] = (0,),
    n: int = 3,
    n_writers: int = 1024,
    n_writes: int = 1536,
    mp_workers: int = 8,
) -> CampaignSpec:
    return CampaignSpec(
        name="serving-chaos",
        scenario={
            "n_nodes": n, "serving": True, "mp_workers": mp_workers,
            "n_writes": n_writes, "n_writers": n_writers,
            "n_watchers": 4, "rate_hz": 0.0,
            "settle_timeout_s": 60.0, "global_settle_s": 90.0,
        },
        events=(
            FaultEvent("partition", 4, 44, src=1, dst=0),
            FaultEvent("slow", 4, 44, node=1, delay_rounds=2),
            FaultEvent("crash", 8, 40, node=2),
        ),
        seeds=tuple(seeds),
        round_s=0.05,
    )


BUILTIN_SPECS = {
    "fault-parity-3node": fault_parity_3node_spec,
    "fault-campaign-3node": fault_campaign_3node_spec,
    "swim-churn-64": swim_churn_64_spec,
    "swim-churn-partial": swim_churn_partial_spec,
    "serving-3node": serving_3node_spec,
    "serving-loadgen": serving_loadgen_spec,
    "serving-chaos": serving_chaos_spec,
    "peer-sampler-frontier": peer_sampler_frontier_spec,
    "protocol-frontier": protocol_frontier_spec,
}


def builtin_spec(name: str,
                 seeds: Optional[Sequence[int]] = None) -> CampaignSpec:
    if name not in BUILTIN_SPECS:
        raise KeyError(
            f"unknown builtin campaign {name!r} (have {sorted(BUILTIN_SPECS)})"
        )
    spec = BUILTIN_SPECS[name]()
    if seeds is not None:
        spec = dataclasses.replace(spec, seeds=tuple(int(s) for s in seeds))
    return spec
