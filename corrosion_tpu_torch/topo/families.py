"""Named topology families — the port's own copy of
``corrosion_tpu/topo/families.py``: each family is a dict of `Topology`
keyword arguments (not an instance), so callers overlay their own
fields before building one.

- ``flat`` — the single tier every default runs;
- ``flat-lossy`` — one tier, 10 % wire loss everywhere;
- ``wan-3x2`` — 3 regions × 2 AZs (the Fly.io geo shape): free same-AZ
  links, one round across AZs, two across regions, loss growing with
  distance;
- ``wan-2region`` — two regions with a long, lossy trunk;
- ``hetero-degree`` — flat latency with fan-out caps 3/2/1 round-robin;
- ``wan-fly-6r`` — six Fly.io regions whose measured median RTTs
  (`FLY_RTT_MS`) are quantized into per-(region, region) delay classes
  (`Topology.region_delay_matrix`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

#: Fly.io region slugs, in matrix order
FLY_REGIONS = ("iad", "ord", "sjc", "lhr", "fra", "nrt")

#: median region-to-region RTTs in milliseconds (symmetric; the diagonal
#: is the in-region RTT)
FLY_RTT_MS: Tuple[Tuple[float, ...], ...] = (
    #  iad    ord    sjc    lhr    fra    nrt
    (   2.0,  20.0,  65.0,  75.0,  90.0, 165.0),  # iad
    (  20.0,   2.0,  50.0,  90.0, 100.0, 145.0),  # ord
    (  65.0,  50.0,   2.0, 140.0, 150.0, 105.0),  # sjc
    (  75.0,  90.0, 140.0,   2.0,  15.0, 220.0),  # lhr
    (  90.0, 100.0, 150.0,  15.0,   2.0, 235.0),  # fra
    ( 165.0, 145.0, 105.0, 220.0, 235.0,   2.0),  # nrt
)

#: one simulated round is this much wall RTT when quantizing the table
FLY_MS_PER_ROUND = 40.0


def rtt_matrix_to_delay_classes(
    rtt_ms: Sequence[Sequence[float]], ms_per_round: float
) -> Tuple[Tuple[int, ...], ...]:
    """Quantize an RTT matrix (ms) into round-delay classes:
    ``ceil(rtt / ms_per_round) - 1``, floored at 0."""
    out: List[Tuple[int, ...]] = []
    for row in rtt_ms:
        out.append(tuple(
            max(0, math.ceil(ms / ms_per_round) - 1) for ms in row))
    return tuple(out)


FAMILIES: Dict[str, Dict[str, object]] = {
    "flat": {},
    "flat-lossy": {"loss": 0.1},
    "wan-3x2": {
        "n_regions": 3, "n_azs": 2,
        "intra_delay": 0, "az_delay": 1, "inter_delay": 2,
        "loss": 0.0, "az_loss": 0.02, "inter_loss": 0.1,
    },
    "wan-2region": {
        "n_regions": 2,
        "intra_delay": 0, "inter_delay": 2,
        "loss": 0.01, "inter_loss": 0.2,
    },
    "hetero-degree": {"degree_classes": (3, 2, 1)},
    "wan-fly-6r": {
        "n_regions": len(FLY_REGIONS),
        "region_delay_matrix": rtt_matrix_to_delay_classes(
            FLY_RTT_MS, FLY_MS_PER_ROUND
        ),
        "loss": 0.0, "inter_loss": 0.05,
    },
}


def family_topology(name: str) -> Dict[str, object]:
    """Topology keyword arguments of a named family (a fresh dict)."""
    if name not in FAMILIES:
        raise KeyError(
            f"unknown topology family {name!r} (have {sorted(FAMILIES)})"
        )
    return dict(FAMILIES[name])


def min_delay_slots(topo_kwargs: Dict[str, object]) -> int:
    """Smallest ``n_delay_slots`` a family's delay classes fit in: every
    delay, and sync's t + 1 slot, without the ring wrapping."""
    matrix = topo_kwargs.get("region_delay_matrix") or ()
    d = max(
        int(topo_kwargs.get("intra_delay", 0)),
        int(topo_kwargs.get("az_delay", 0)),
        int(topo_kwargs.get("inter_delay", 1)),
        max((int(v) for row in matrix for v in row), default=0),
        1,
    )
    return d + 1
