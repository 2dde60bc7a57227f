"""The declarative fault schedule — the port's copy of the parts of
``corrosion_tpu/faults.py`` the sim's factored compiler reads:
`sel_indices`, `derive_seed`, `FaultEvent` and `FaultPlan` (fields,
validation and ``horizon``).

A plan is denominated in rounds: each `FaultEvent` is active over
``[start, end)``; a crash keeps its node down over that window and
restarts it at round ``end``, empty when ``wipe`` is set.
`sim.faults.compile_plan` lowers a plan straight from its events, so
the host-tier replay classes, ``schedule()`` and the per-link epoch
machinery of the JAX module are not copied.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple, Union

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
