"""The declarative fault schedule — the port's copy of the parts of
``corrosion_tpu/faults.py`` the sim tier reads: `sel_indices`,
`derive_seed`, `FaultEvent`, `LinkFault` (with ``merge`` and `CLEAR`),
`RoundSchedule` and `FaultPlan` (fields, validation, ``horizon``, the
pairwise ``schedule_at``/``schedule`` expansion, ``active_kinds_at``
and ``coverage_markers``), and `demo_plan`, the fault campaign's plan.

A plan is denominated in rounds: each `FaultEvent` is active over
``[start, end)``; a crash keeps its node down over that window and
restarts it at round ``end``, empty when ``wipe`` is set.
``schedule_at(r)`` is round r's resolved state, pair by pair: the
checked driver (`sim.faults.run_fault_plan_checked`) fires its coverage
markers from it.  Neither of `sim.faults.compile_plan`'s forms expands
pairs: both lower a plan straight from its events' rectangles.  The
host-tier drivers and the per-link epoch machinery of the JAX module
are not copied.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple, Union

#: event kinds a plan may schedule
KINDS = (
    "loss",        # per-link Bernoulli drop of fire-and-forget payloads
    "delay",       # fixed added latency, in rounds
    "jitter",      # per-message uniform extra delay 0..delay_rounds
    "duplicate",   # per-link Bernoulli duplication of delivered payloads
    "partition",   # directed (or symmetric) edge cut
    "crash",       # node down [start, end); restarts at `end`, maybe wiped
    "clock_skew",  # HLC physical-clock offset on one node (host tier only)
    "slow",        # wall-clock stall on a live node (host tier only)
)

#: node-level kinds (selected via ``node=``, no link rectangle)
NODE_KINDS = ("crash", "clock_skew", "slow")

NodeSel = Union[int, str]  # node index, "*", or a "lo:hi" half-open range


def sel_indices(sel: NodeSel, n: int) -> range:
    """Node selector → index range: an int selects one node, ``"*"``
    every node, and ``"lo:hi"`` the half-open range [lo, hi)."""
    if sel == "*":
        return range(n)
    if isinstance(sel, str) and ":" in sel:
        lo, hi = sel.split(":", 1)
        return range(int(lo), int(hi))
    i = int(sel)
    return range(i, i + 1)


def derive_seed(seed: int, *tokens) -> int:
    """Stable 63-bit child seed from the plan seed and a token path:
    blake2b over the repr of ``(seed, *tokens)``, so it is the same in
    every process."""
    h = hashlib.blake2b(
        repr((int(seed),) + tokens).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") & (2**63 - 1)


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault, active over rounds ``[start, end)``."""

    kind: str
    start: int
    end: int
    src: NodeSel = "*"   # link faults: sending side ("*" = every node)
    dst: NodeSel = "*"   # link faults: receiving side
    node: Optional[NodeSel] = None  # crash / clock_skew / slow target
    p: float = 0.0       # loss / duplicate probability
    delay_rounds: int = 0  # fixed for `delay`, the max for `jitter`
    wipe: bool = False   # crash: lose durable state at restart
    skew_ns: int = 0     # clock_skew offset (may be negative)
    symmetric: bool = False  # partition: cut both directions

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (use one of {KINDS})"
            )
        if self.end <= self.start:
            raise ValueError(
                f"{self.kind}: end {self.end} must be > start {self.start}"
            )
        if self.kind in NODE_KINDS and self.node is None:
            raise ValueError(f"{self.kind} needs node=")
        if self.kind == "slow" and self.delay_rounds <= 0:
            raise ValueError("slow needs delay_rounds= (the stall magnitude)")
        if self.kind in ("loss", "duplicate") and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"{self.kind}: p={self.p} outside [0, 1]")
        if self.delay_rounds > 255:
            raise ValueError(
                f"{self.kind}: delay_rounds={self.delay_rounds} exceeds "
                "the 255-round schedule grain"
            )


@dataclass(frozen=True)
class LinkFault:
    """Resolved per-(directed-link, round) fault parameters."""

    loss: float = 0.0
    delay_rounds: int = 0
    jitter_rounds: int = 0
    duplicate: float = 0.0
    blocked: bool = False

    def merge(self, other: "LinkFault") -> "LinkFault":
        """Overlapping events compose: losses combine as independent
        drops, delays add, jitter/duplicate take the max, block ORs."""
        return LinkFault(
            loss=1.0 - (1.0 - self.loss) * (1.0 - other.loss),
            delay_rounds=self.delay_rounds + other.delay_rounds,
            jitter_rounds=max(self.jitter_rounds, other.jitter_rounds),
            duplicate=max(self.duplicate, other.duplicate),
            blocked=self.blocked or other.blocked,
        )


CLEAR = LinkFault()


def _event_link_fault(ev: "FaultEvent") -> LinkFault:
    """The LinkFault one active link event contributes."""
    if ev.kind == "loss":
        return LinkFault(loss=ev.p)
    if ev.kind == "delay":
        return LinkFault(delay_rounds=ev.delay_rounds)
    if ev.kind == "jitter":
        return LinkFault(jitter_rounds=ev.delay_rounds)
    if ev.kind == "duplicate":
        return LinkFault(duplicate=ev.p)
    return LinkFault(blocked=True)  # partition


@dataclass(frozen=True)
class RoundSchedule:
    """The resolved fault state of one round."""

    links: Dict[Tuple[int, int], LinkFault]  # directed (src, dst) -> fault
    down: FrozenSet[int]        # nodes down this round
    restart: FrozenSet[int]     # nodes restarting this round (were down)
    wipe: FrozenSet[int]        # restarting nodes that lost durable state
    skews: Dict[int, int]       # node -> HLC offset (ns) active this round
    # node -> stall magnitude in rounds (`slow`; overlaps take the max)
    slow: Dict[int, int] = field(default_factory=dict)

    def active_kinds(self) -> List[str]:
        """Fault kinds in effect this round: the source of the
        ``fault-<kind>-active`` coverage markers."""
        kinds = set()
        for f in self.links.values():
            if f.blocked:
                kinds.add("partition")
            if f.loss > 0:
                kinds.add("loss")
            if f.delay_rounds > 0:
                kinds.add("delay")
            if f.jitter_rounds > 0:
                kinds.add("jitter")
            if f.duplicate > 0:
                kinds.add("duplicate")
        if self.down:
            kinds.add("crash")
        if self.skews:
            kinds.add("clock_skew")
        if self.slow:
            kinds.add("slow")
        return sorted(kinds)


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative fault schedule for an ``n_nodes`` cluster."""

    n_nodes: int
    seed: int
    events: Tuple[FaultEvent, ...]
    round_s: float = 0.05  # host wall-clock per round

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            for sel in (ev.src, ev.dst):
                r = sel_indices(sel, self.n_nodes)
                if len(r) == 0 or r.start < 0 or r.stop > self.n_nodes:
                    raise ValueError(
                        f"node selector {sel} outside 0..{self.n_nodes - 1}"
                    )
            if ev.node is not None:
                r = sel_indices(ev.node, self.n_nodes)
                if len(r) == 0 or r.start < 0 or r.stop > self.n_nodes:
                    raise ValueError(
                        f"node {ev.node} outside 0..{self.n_nodes - 1}"
                    )

    @property
    def horizon(self) -> int:
        """First round with no scheduled fault activity left (restart
        rounds included, so a crash's rejoin is inside the horizon)."""
        return max((ev.end for ev in self.events), default=0) + 1

    def _pairs(self, ev: FaultEvent):
        srcs = sel_indices(ev.src, self.n_nodes)
        dsts = sel_indices(ev.dst, self.n_nodes)
        for s in srcs:
            for d in dsts:
                if s != d:
                    yield (s, d)
                    if ev.kind == "partition" and ev.symmetric:
                        yield (d, s)

    def schedule_at(self, r: int) -> RoundSchedule:
        """The resolved fault state of round ``r``, a pure function of the
        plan: every directed pair's merged `LinkFault` (in event order,
        from `CLEAR`), the nodes down, restarting and wiped, the clock
        skews and stalls."""
        links: Dict[Tuple[int, int], LinkFault] = {}
        down, restart, wipe = set(), set(), set()
        skews: Dict[int, int] = {}
        slow: Dict[int, int] = {}
        for ev in self.events:
            if ev.kind == "crash":
                sel = sel_indices(ev.node, self.n_nodes)
                if ev.start <= r < ev.end:
                    down.update(sel)
                elif r == ev.end:
                    restart.update(sel)
                    if ev.wipe:
                        wipe.update(sel)
                continue
            if not ev.start <= r < ev.end:
                continue
            if ev.kind == "clock_skew":
                for i in sel_indices(ev.node, self.n_nodes):
                    skews[i] = skews.get(i, 0) + ev.skew_ns
                continue
            if ev.kind == "slow":
                for i in sel_indices(ev.node, self.n_nodes):
                    slow[i] = max(slow.get(i, 0), ev.delay_rounds)
                continue
            f = _event_link_fault(ev)
            for pair in self._pairs(ev):
                links[pair] = links.get(pair, CLEAR).merge(f)
        return RoundSchedule(
            links=links, down=frozenset(down), restart=frozenset(restart),
            wipe=frozenset(wipe), skews=skews, slow=slow,
        )

    def _has_pair(self, ev: FaultEvent) -> bool:
        """Whether an event's src × dst rectangle holds any s != d pair
        (only a 1×1 rectangle on the diagonal holds none)."""
        sr = sel_indices(ev.src, self.n_nodes)
        dr = sel_indices(ev.dst, self.n_nodes)
        return not (len(sr) == 1 and len(dr) == 1 and sr.start == dr.start)

    def active_kinds_at(self, r: int) -> List[str]:
        """Fault kinds in effect at round ``r`` from the event table:
        ``schedule_at(r).active_kinds()`` in O(events)."""
        kinds = set()
        for ev in self.events:
            if not ev.start <= r < ev.end:
                continue
            if ev.kind in ("loss", "duplicate") and ev.p <= 0:
                continue
            if ev.kind in ("delay", "jitter") and ev.delay_rounds <= 0:
                continue
            if ev.kind not in NODE_KINDS and not self._has_pair(ev):
                continue
            kinds.add(ev.kind)
        return sorted(kinds)

    def schedule(self) -> List[RoundSchedule]:
        """Every round of the plan, rounds ``0..horizon`` inclusive (the
        last is all-clear by construction)."""
        return [self.schedule_at(r) for r in range(self.horizon + 1)]

    def coverage_markers(self) -> List[str]:
        """The ``sometimes`` markers this plan is expected to fire: one
        per fault kind present."""
        return sorted({f"fault-{ev.kind}-active" for ev in self.events})


def demo_plan(n_nodes: int = 3, seed: int = 0, rounds: int = 36) -> FaultPlan:
    """The fault campaign's plan (the JAX CLI's ``sim
    fault-campaign-3node``): a loss burst over everything, a mid-run
    asymmetric partition, delay and jitter on one link, and a
    crash-with-wipe of the last node in the final third."""
    third = rounds // 3
    return FaultPlan(
        n_nodes=n_nodes, seed=seed,
        events=(
            FaultEvent("loss", 0, rounds, p=0.4),
            FaultEvent("partition", third // 2, third, src=n_nodes - 1, dst=0),
            FaultEvent("delay", 2, 2 * third, src=0, dst=1, delay_rounds=1),
            FaultEvent("jitter", 2, 2 * third, src=0, dst=1, delay_rounds=1),
            FaultEvent(
                "crash", 2 * third, rounds - 2, node=n_nodes - 1, wipe=True
            ),
        ),
    )
