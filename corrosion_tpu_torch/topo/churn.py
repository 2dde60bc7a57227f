"""Churn schedules and the host compilation of a geo-tiered topology —
the port's own copy of ``corrosion_tpu/topo/churn.py``.

Every generator returns `..faults.FaultEvent`s with range selectors
(``"lo:hi"``), which both of `..sim.faults.compile_plan`'s forms lower
straight from their rectangles, so a schedule stays O(events) at any
cluster size:

- `flash_crowd_events` — a cold-join wave: the tail ``frac`` of the id
  space is down from round 0 and restarts wiped at ``join_round``;
- `diurnal_events` — follow-the-sun churn: each cycle a seed-derived
  contiguous block sleeps through the night window;
- `churn_events` — the two families by name (`CHURN_FAMILIES`);
- `az_blocks`, `topology_link_events` — a geo-tiered
  `..sim.topology.Topology` as per-tier delay and loss link events over
  its contiguous region/AZ blocks.
"""

from __future__ import annotations

from typing import List, Tuple

from ..faults import FaultEvent, derive_seed


def flash_crowd_events(
    n_nodes: int,
    frac: float = 0.25,
    join_round: int = 8,
    wipe: bool = True,
) -> Tuple[FaultEvent, ...]:
    """The tail ``frac`` of the cluster joins cold at ``join_round``: one
    range-selector crash event."""
    k = max(1, min(n_nodes - 1, int(round(n_nodes * frac))))
    lo = n_nodes - k
    return (
        FaultEvent(
            "crash", 0, max(1, int(join_round)),
            node=f"{lo}:{n_nodes}", wipe=wipe,
        ),
    )


def diurnal_events(
    n_nodes: int,
    frac: float = 0.25,
    day_rounds: int = 12,
    night_rounds: int = 6,
    cycles: int = 2,
    seed: int = 0,
    wipe: bool = False,
) -> Tuple[FaultEvent, ...]:
    """Per cycle, a seed-derived contiguous block of ``frac``·N nodes
    sleeps for ``night_rounds`` after each ``day_rounds`` window (a
    contiguous block is a region under the contiguous-region rule)."""
    k = max(1, min(n_nodes - 1, int(round(n_nodes * frac))))
    evs: List[FaultEvent] = []
    for c in range(cycles):
        start = day_rounds + c * (day_rounds + night_rounds)
        lo = derive_seed(seed, "diurnal", c) % (n_nodes - k + 1)
        evs.append(
            FaultEvent(
                "crash", start, start + night_rounds,
                node=f"{lo}:{lo + k}", wipe=wipe,
            )
        )
    return tuple(evs)


#: the churn families `churn_events` resolves by name
CHURN_FAMILIES = ("flash-crowd", "diurnal")


def churn_events(
    name: str,
    n_nodes: int,
    frac: float = 0.25,
    round_knob: int = 8,
    seed: int = 0,
) -> Tuple[FaultEvent, ...]:
    """A churn family by name.  ``round_knob`` is its one timing knob
    (flash-crowd: the join round; diurnal: the day length, with nights
    of half a day)."""
    if name == "flash-crowd":
        return flash_crowd_events(n_nodes, frac=frac, join_round=round_knob)
    if name == "diurnal":
        return diurnal_events(
            n_nodes, frac=frac, day_rounds=max(2, int(round_knob)),
            night_rounds=max(2, int(round_knob) // 2), seed=seed,
        )
    raise KeyError(
        f"unknown churn family {name!r} (have {sorted(CHURN_FAMILIES)})"
    )


def az_blocks(n_nodes: int, n_regions: int,
              n_azs: int) -> List[Tuple[int, int, int]]:
    """(region, lo, hi) contiguous AZ blocks, by the block rule of
    `..sim.topology.regions` and ``azs``."""
    per_r = max(1, n_nodes // n_regions)
    out: List[Tuple[int, int, int]] = []
    for r in range(n_regions):
        r_lo = r * per_r
        r_hi = n_nodes if r == n_regions - 1 else (r + 1) * per_r
        if r_lo >= n_nodes:
            break
        per_az = max(1, per_r // n_azs)
        for a in range(n_azs):
            a_lo = r_lo + a * per_az
            a_hi = (r_hi if a == n_azs - 1
                    else min(r_hi, r_lo + (a + 1) * per_az))
            if a_lo >= r_hi:
                break
            out.append((r, a_lo, a_hi))
    return out


def topology_link_events(
    topo, n_nodes: int, end: int, start: int = 0
) -> Tuple[FaultEvent, ...]:
    """A geo-tiered Topology as link events over ``[start, end)``: per
    ordered AZ-block pair, a delay event for its tier's delay class and a
    loss event for its drop probability.  Rectangles of one kind are
    disjoint, so the factored compiler takes them too."""
    from ..sim.topology import Topology, loss_tiers

    assert isinstance(topo, Topology)
    base, az_t, inter_t = loss_tiers(topo)
    blocks = az_blocks(n_nodes, topo.n_regions, topo.n_azs)
    evs: List[FaultEvent] = []
    for r_i, lo_i, hi_i in blocks:
        for r_j, lo_j, hi_j in blocks:
            same_block = (lo_i, hi_i) == (lo_j, hi_j)
            if topo.region_delay_matrix:
                # the measured-RTT matrix is the delay rule (one AZ a
                # region); loss keeps the two-tier rule
                delay = topo.region_delay_matrix[r_i][r_j]
                thr = base if r_i == r_j else inter_t
            elif same_block:
                delay, thr = topo.intra_delay, base
            elif r_i == r_j:
                delay, thr = topo.az_delay, az_t
            else:
                delay, thr = topo.inter_delay, inter_t
            if same_block and hi_i - lo_i <= 1:
                continue  # a one-node diagonal block has no pairs
            src, dst = f"{lo_i}:{hi_i}", f"{lo_j}:{hi_j}"
            if delay > 0:
                evs.append(
                    FaultEvent(
                        "delay", start, end, src=src, dst=dst,
                        delay_rounds=int(delay),
                    )
                )
            if thr > 0:
                evs.append(
                    FaultEvent(
                        "loss", start, end, src=src, dst=dst,
                        p=min(1.0, thr / 256.0),
                    )
                )
    return tuple(evs)
