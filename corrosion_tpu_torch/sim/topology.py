"""Topology and link model — the port of ``corrosion_tpu/sim/topology.py``:
regions, geo tiers (availability zones inside regions, each edge in one
of three delay and loss classes: same AZ, cross-AZ, cross-region), a
measured per-(region, region) delay matrix in place of the tier delays,
heterogeneous fan-out caps (``degree_classes``), and the u8 loss draws.

Regions and AZs are contiguous blocks of node ids (`regions`, `azs`),
so a node's tier is arithmetic on its id.  Tiered loss compares the
SAME aligned u8 draw the flat loss uses against per-edge tier
thresholds (`edge_loss_thresholds_raw`, one tier-selection expression;
a tier at certainty, p·256 ≥ 256, pins its edges dropped).

On the card the topology's per-edge work runs K20
(``kernels/csrc/edge_classes.cu``), three entries that read the
topology's int32 table (`topo_table`):

- `edge_slot` — the ring slot ``(t + delay + fault delay) % D`` of each
  edge on a geo-tiered or measured-matrix topology (a flat topology's
  two-class delay stays the torch expression it always was);
- `apply_degree_caps` — the fan-out slots past each node's degree cap
  set to -1, in place;
- `tiered_reach_` — `swim._reachable`'s tiered branch, in place.

The wire's tiered loss is drawn inside the ring scatters (K10's and
K12's tiered instantiations), from the same table.  Each wrapper takes
the plain torch version beside it for a CPU tensor.

On a seed ensemble's lanes (B16t, the dense round's) each entry has a
lane entry, the solo body with a lane grid dimension:
`apply_degree_caps_lanes`, `edge_slot_lanes` and `tiered_reach_lanes_`,
each with its plain version, the solo plain version on every lane.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import kernels
from ..kernels.build import check
from . import rng
from .state import ALIVE


@dataclasses.dataclass(frozen=True)
class Topology:
    n_regions: int = 1
    intra_delay: int = 0  # rounds, same AZ
    inter_delay: int = 1  # rounds, cross-region
    loss: float = 0.0  # drop probability, same-AZ edges
    n_azs: int = 1  # availability zones per region
    az_delay: int = 0  # rounds, cross-AZ within a region
    az_loss: float = 0.0  # 0.0 inherits ``loss``
    inter_loss: float = 0.0  # 0.0 inherits ``loss``
    # fan-out caps assigned round-robin over node ids; () = full fanout
    degree_classes: Tuple[int, ...] = ()
    # per-(region, region) delay classes in rounds; () = the tier model
    region_delay_matrix: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "degree_classes",
            tuple(int(d) for d in self.degree_classes),
        )
        object.__setattr__(
            self, "region_delay_matrix",
            tuple(tuple(int(d) for d in row)
                  for row in self.region_delay_matrix),
        )
        if self.n_regions < 1 or self.n_azs < 1:
            raise ValueError("n_regions and n_azs must be >= 1")
        for name in ("loss", "az_loss", "inter_loss"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")
        if any(d < 1 for d in self.degree_classes):
            raise ValueError("degree_classes entries must be >= 1")
        if self.region_delay_matrix:
            m = self.region_delay_matrix
            if len(m) != self.n_regions or any(
                len(row) != self.n_regions for row in m
            ):
                raise ValueError(
                    f"region_delay_matrix must be {self.n_regions}×"
                    f"{self.n_regions} (n_regions rows and columns)"
                )
            if self.n_azs != 1:
                raise ValueError(
                    "region_delay_matrix replaces the tier model — it "
                    "needs n_azs == 1 (AZ classes would double-count)"
                )
            if any(d < 0 for row in m for d in row):
                raise ValueError("region_delay_matrix entries must be >= 0")

    @property
    def max_delay(self) -> int:
        if self.region_delay_matrix:
            return max(d for row in self.region_delay_matrix for d in row)
        return max(self.intra_delay, self.az_delay, self.inter_delay)

    @property
    def delay_classes(self) -> bool:
        """Whether edge delays take more than the flat two-class
        expression: AZ tiers or a measured matrix (K20's edge entry)."""
        return self.n_azs > 1 or bool(self.region_delay_matrix)


def loss_threshold(p: float) -> int:
    """Loss probability → the u8 compare threshold (JAX ``_thr``)."""
    return int(round(p * 256.0))


def loss_tiers(topo: Topology) -> Tuple[int, int, int]:
    """(same-AZ, cross-AZ, cross-region) raw u8 drop thresholds; a tier
    loss of 0.0 inherits the base ``loss``."""
    base = loss_threshold(topo.loss)
    az = loss_threshold(topo.az_loss) if topo.az_loss > 0 else base
    inter = loss_threshold(topo.inter_loss) if topo.inter_loss > 0 else base
    return base, az, inter


def loss_tiered(topo: Topology) -> bool:
    """Whether the loss tiers that apply differ (JAX ``loss_tiered``)."""
    base, az, inter = loss_tiers(topo)
    tiers = {base}
    if topo.n_azs > 1:
        tiers.add(az)
    if topo.n_regions > 1:
        tiers.add(inter)
    return len(tiers) > 1


def regions(n_nodes: int, n_regions: int, device) -> torch.Tensor:
    """Contiguous region assignment."""
    per = max(1, n_nodes // n_regions)
    idx = torch.arange(n_nodes, dtype=torch.int32, device=device)
    return torch.clamp(idx // per, max=n_regions - 1)


def azs(n_nodes: int, topo: Topology, device) -> torch.Tensor:
    """i32[N] global AZ id, region * n_azs + local AZ: contiguous AZ
    blocks inside each region block, the last AZ of a region taking its
    remainder."""
    per_r = max(1, n_nodes // topo.n_regions)
    reg = regions(n_nodes, topo.n_regions, device)
    local = torch.arange(n_nodes, dtype=torch.int32, device=device) - reg * per_r
    per_az = max(1, per_r // topo.n_azs)
    return reg * topo.n_azs + torch.clamp(local // per_az, max=topo.n_azs - 1)


def node_degrees(n_nodes: int, topo: Topology, device) -> torch.Tensor:
    """i32[N] fan-out caps, ``degree_classes`` round-robin over ids."""
    off = _T_HEADER + len(topo.region_delay_matrix) ** 2
    classes = topo_table(topo, n_nodes, device)[off:]
    idx = torch.arange(n_nodes, device=device) % len(topo.degree_classes)
    return classes[idx]


# -- the topology's table, read by K20 and the tiered scatters ---------------

# `topo_table`'s layout (kernels/csrc/topo_tiers.cuh reads the same): N,
# the region block, R, the AZ block, A, the three raw tier thresholds
# (same AZ, cross-AZ, cross-region), the three tier delays, whether a
# matrix follows, the number of degree classes and their offset; zeros to
# the 16-int header; the R × R matrix row-major if any; the classes
_T_HEADER = 16

_TABLES: Dict[tuple, torch.Tensor] = {}


def _table_host(topo: Topology, n_nodes: int) -> list:
    per = max(1, n_nodes // topo.n_regions)
    matrix = [d for row in topo.region_delay_matrix for d in row]
    head = [n_nodes, per, topo.n_regions, max(1, per // topo.n_azs),
            topo.n_azs, *loss_tiers(topo), topo.intra_delay, topo.az_delay,
            topo.inter_delay, int(bool(matrix)), len(topo.degree_classes),
            _T_HEADER + len(matrix)]
    head += [0] * (_T_HEADER - len(head))
    return head + matrix + list(topo.degree_classes)


def topo_table(topo: Topology, n_nodes: int, device) -> torch.Tensor:
    """The topology as one int32 tensor on ``device`` (built once per
    topology, node count and device, so a call after the first copies
    nothing to the card): the block sizes of `regions` and `azs`, the raw
    tier thresholds (`loss_tiers`), the tier delays, the delay matrix
    row-major and the degree classes."""
    dev = torch.device(device)
    key = (topo, n_nodes, str(dev))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(_table_host(topo, n_nodes),
                                    dtype=torch.int32, device=dev)
    return _TABLES[key]


def wire_tiers(topo: Topology) -> Optional[Topology]:
    """``topo`` when its loss is tiered (the ring scatters' tiered
    instantiations then draw the wire's loss), else None."""
    return topo if loss_tiered(topo) else None


# -- K20: degree caps --------------------------------------------------------


def apply_degree_caps_plain(targets: torch.Tensor,
                            topo: Topology) -> torch.Tensor:
    """Plain version of K20's caps entry."""
    n, f = targets.shape
    deg = node_degrees(n, topo, targets.device)
    slot = torch.arange(f, dtype=torch.int32, device=targets.device)
    return torch.where(slot[None, :] < deg[:, None], targets, -1)


def apply_degree_caps(targets: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Fan-out slots past each node's degree cap become -1 (JAX
    ``apply_degree_caps``); identity without degree classes.  K20's caps
    entry on the card, in place on ``targets`` (i32[N, F])."""
    if not topo.degree_classes:
        return targets
    if targets.device.type == "cpu":
        return apply_degree_caps_plain(targets, topo)
    n, f = targets.shape
    check("targets", targets, torch.int32, (n, f))
    kernels.DEGREE_CAPS.launch(
        [topo_table(topo, n, targets.device), targets], [n, f])
    return targets


def apply_degree_caps_lanes_plain(targets: torch.Tensor,
                                  topo: Topology) -> torch.Tensor:
    """Plain version of K20's caps lane entry: the solo plain version on
    each lane."""
    return torch.stack([apply_degree_caps_plain(x, topo) for x in targets])


def apply_degree_caps_lanes(targets: torch.Tensor,
                            topo: Topology) -> torch.Tensor:
    """`apply_degree_caps` over the lanes' targets i32[K, N, F]: row r of
    every lane capped by node r's degree class; identity without degree
    classes.  K20's caps lane entry on the card, in place."""
    if not topo.degree_classes:
        return targets
    if targets.device.type == "cpu":
        return apply_degree_caps_lanes_plain(targets, topo)
    lanes, n, f = targets.shape
    check("targets", targets, torch.int32, (lanes, n, f))
    kernels.DEGREE_CAPS_LANES.launch(
        [topo_table(topo, n, targets.device), targets], [n, f, lanes])
    return targets


# -- K20: edge delay classes -------------------------------------------------


def edge_delay(
    topo: Topology, region: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """Delay class (rounds) per edge (JAX ``edge_delay``): the measured
    matrix's entry for the two regions, else intra / cross-AZ /
    cross-region by distance."""
    if topo.region_delay_matrix:
        r = topo.n_regions
        m = topo_table(topo, region.shape[0], region.device)[
            _T_HEADER:_T_HEADER + r * r].reshape(r, r)
        return m[region[src].long(), region[dst].long()]
    same_r = region[src] == region[dst]
    if topo.n_azs <= 1:
        return torch.where(same_r, topo.intra_delay, topo.inter_delay).to(
            torch.int32)
    az = azs(region.shape[0], topo, region.device)
    same_az = az[src] == az[dst]
    return torch.where(
        same_r, torch.where(same_az, topo.intra_delay, topo.az_delay),
        topo.inter_delay,
    ).to(torch.int32)


def edge_slot_plain(topo, region, src, dst, t: int, d_slots: int,
                    fdelay=None) -> torch.Tensor:
    """Plain version of K20's edge entry (and the flat topology's slot
    on the card)."""
    delay = edge_delay(topo, region, src, dst)
    if fdelay is not None:
        delay = delay + fdelay
    return ((t + delay) % d_slots).to(torch.int32)


def edge_slot(topo: Topology, region: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, t: int, d_slots: int,
              fdelay: Optional[torch.Tensor] = None) -> torch.Tensor:
    """i32[E] ring slot of each edge, ``(t + edge_delay + fdelay) % D``
    (``fdelay``: a fault plan's fixed delay per edge, or None).  On the
    card a geo-tiered or measured-matrix topology runs K20's edge entry;
    the flat two-class delay keeps its torch expression."""
    if region.device.type == "cpu" or not topo.delay_classes:
        return edge_slot_plain(topo, region, src, dst, t, d_slots, fdelay)
    e = src.shape[0]
    n = region.shape[0]
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (e,))
    if fdelay is not None:
        check("fdelay", fdelay, torch.int32, (e,))
    slot = torch.empty(e, dtype=torch.int32, device=src.device)
    kernels.EDGE_SLOTS.launch(
        [topo_table(topo, n, src.device), src, dst, fdelay, slot],
        [e, t, d_slots])
    return slot


def edge_slot_lanes_plain(topo, region, src, dst, t: int, d_slots: int,
                          fdelay=None) -> torch.Tensor:
    """Plain version of K20's edge lane entry: the solo plain version on
    each lane."""
    return torch.stack([
        edge_slot_plain(topo, region, src, dst[k], t, d_slots,
                        None if fdelay is None else fdelay[k])
        for k in range(dst.shape[0])])


def edge_slot_lanes(topo: Topology, region: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, t: int, d_slots: int,
                    fdelay: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`edge_slot` over the lanes: i32[K, E] slots of the shared senders
    ``src`` i32[E] and each lane's receivers ``dst`` i32[K, E] (and fixed
    fault delays ``fdelay`` i32[K, E], or None).  On the card a geo-tiered
    or measured-matrix topology runs K20's edge lane entry; the flat
    two-class delay keeps its torch expression, as the solo slot does,
    over every lane at once."""
    if region.device.type == "cpu":
        return edge_slot_lanes_plain(topo, region, src, dst, t, d_slots,
                                     fdelay)
    if not topo.delay_classes:
        return edge_slot_plain(topo, region, src[None], dst, t, d_slots,
                               fdelay)
    lanes, e = dst.shape
    n = region.shape[0]
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (lanes, e))
    if fdelay is not None:
        check("fdelay", fdelay, torch.int32, (lanes, e))
    slot = torch.empty((lanes, e), dtype=torch.int32, device=src.device)
    kernels.EDGE_SLOTS_LANES.launch(
        [topo_table(topo, n, src.device), src, dst, fdelay, slot],
        [e, t, d_slots, lanes])
    return slot


def edge_alive(
    group: torch.Tensor, alive: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Reachability per edge: same partition group, both endpoints up."""
    return (
        (group[src] == group[dst])
        & (alive[src] == ALIVE)
        & (alive[dst] == ALIVE)
    )


# -- tiered loss -------------------------------------------------------------


def edge_loss_thresholds_raw(
    topo: Topology, region: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """i32[E] unclamped tier thresholds (JAX
    ``edge_loss_thresholds_raw``), the one tier-selection expression."""
    base, az_t, inter_t = loss_tiers(topo)
    same_r = region[src] == region[dst]
    if topo.n_azs > 1:
        az = azs(region.shape[0], topo, region.device)
        same_az = az[src] == az[dst]
    else:
        same_az = same_r
    return torch.where(
        same_r, torch.where(same_az, base, az_t), inter_t
    ).to(torch.int32)


def edge_loss_thresholds(
    topo: Topology, region: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """u8[E] per-edge drop thresholds, saturated at 255 (JAX
    ``edge_loss_thresholds``)."""
    raw = edge_loss_thresholds_raw(topo, region, src, dst)
    return torch.clamp(raw, max=255).to(torch.uint8)


def tiered_edge_drop(
    topo: Topology, key: torch.Tensor, region: torch.Tensor,
    src: torch.Tensor, dst: torch.Tensor, shape,
) -> torch.Tensor:
    """bool[shape] tiered drops (JAX ``tiered_edge_drop``): the aligned
    u8 draw of ``shape`` (edge axis first) below each edge's saturated
    threshold, OR its raw threshold at 256 or more when some tier is at
    certainty."""
    extra = (1,) * (len(shape) - 1)
    thr = edge_loss_thresholds(topo, region, src, dst)
    drop = aligned_u8_bits(key, shape) < thr.reshape(thr.shape + extra)
    if max(loss_tiers(topo)) >= 256:
        raw = edge_loss_thresholds_raw(topo, region, src, dst)
        drop = drop | (raw >= 256).reshape(raw.shape + extra)
    return drop


def edge_payload_drop(
    topo: Topology, key: torch.Tensor, n_edges: int, n_payloads: int,
    src: Optional[torch.Tensor] = None, dst: Optional[torch.Tensor] = None,
    region: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[E, P] per-(edge, payload) wire loss (JAX
    ``edge_payload_drop``): under tiered loss, with ``src``/``dst``/
    ``region``, the tiered drops of ``key``; else the flat branch —
    nothing below a threshold of 1 (no draw), everything at 256 or more,
    else ``aligned_u8_bits`` of ``key`` below the threshold.  The ring
    scatters draw these bits themselves (K10, K12)."""
    if loss_tiered(topo) and src is not None:
        return tiered_edge_drop(topo, key, region, src, dst,
                                (n_edges, n_payloads))
    thr = loss_threshold(topo.loss)
    dev = key.device
    if topo.loss <= 0.0 or thr == 0:
        return torch.zeros((n_edges, n_payloads), dtype=torch.bool, device=dev)
    if thr >= 256:
        return torch.ones((n_edges, n_payloads), dtype=torch.bool, device=dev)
    return aligned_u8_bits(key, (n_edges, n_payloads)) < thr


#: the tag `swim._reachable` folds into the probe's loss key under tiers
REACH_TAG = 104


def tiered_reach_plain(ok, topo: Topology, n_nodes: int, key, src,
                       dst) -> torch.Tensor:
    """Plain version of K20's reach entry, in place."""
    region = regions(n_nodes, topo.n_regions, ok.device)
    ok &= ~tiered_edge_drop(topo, rng.fold_in(key, REACH_TAG), region, src,
                            dst, tuple(src.shape))
    return ok


def tiered_reach_(ok: torch.Tensor, topo: Topology, n_nodes: int,
                  key: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """`swim._reachable`'s tiered branch, in place on bool[E] ``ok``:
    ``ok &= ~tiered_edge_drop(fold_in(key, 104), [E])`` over the tiers of
    ``n_nodes`` nodes.  K20's reach entry on the card."""
    if ok.device.type == "cpu":
        return tiered_reach_plain(ok, topo, n_nodes, key, src, dst)
    e = src.shape[0]
    check("ok", ok, torch.bool, (e,))
    check("src", src, torch.int32, (e,))
    check("dst", dst, torch.int32, (e,))
    check("key", key, torch.int64, (2,))
    kernels.EDGE_REACH.launch(
        [topo_table(topo, n_nodes, ok.device), src, dst, key, ok],
        [e, REACH_TAG])
    return ok


def tiered_reach_lanes_plain(ok, topo: Topology, n_nodes: int, keys, src,
                             dst) -> torch.Tensor:
    """Plain version of K20's reach lane entry: the solo plain version on
    each lane, in place."""
    for k in range(ok.shape[0]):
        tiered_reach_plain(ok[k], topo, n_nodes, keys[k], src[k], dst[k])
    return ok


def tiered_reach_lanes_(ok: torch.Tensor, topo: Topology, n_nodes: int,
                        keys: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """`tiered_reach_` over the lanes, in place on bool[K, E] ``ok``: lane
    k's edges ``src[k]`` → ``dst[k]`` (i32[K, E], lane-local ids) against
    the aligned u8 draw of ``fold_in(keys[k], 104)``.  K20's reach lane
    entry on the card."""
    if ok.device.type == "cpu":
        return tiered_reach_lanes_plain(ok, topo, n_nodes, keys, src, dst)
    lanes, e = ok.shape
    check("ok", ok, torch.bool, (lanes, e))
    check("src", src, torch.int32, (lanes, e))
    check("dst", dst, torch.int32, (lanes, e))
    check("keys", keys, torch.int64, (lanes, 2))
    kernels.EDGE_REACH_LANES.launch(
        [topo_table(topo, n_nodes, ok.device), src, dst, keys, ok],
        [e, REACH_TAG, lanes])
    return ok


def aligned_u8_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """u8 threefry draw of ``shape`` (JAX ``topology.aligned_u8_bits``):
    u32 words from ``bits``, each unpacked into four little-endian
    bytes.  A flat size that is not a multiple of 128 draws the next
    multiple and keeps the prefix (jax's padding rule; under the
    partitionable counters word i never depends on the draw's length,
    so the kept bytes are those of the shorter draw)."""
    size = 1
    for d in shape:
        size *= int(d)
    pad = size if size % 128 == 0 else -(-size // 128) * 128
    words = rng.bits(key, (pad // 4,))  # int64 holding u32 words
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=key.device)
    flat = ((words[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(pad)
    return flat[:size].reshape(tuple(shape))
