"""Topology and link model — the port's copy of the flat paths of
``corrosion_tpu/sim/topology.py``: regions with intra/inter delays and
one loss class for every edge.

The `Topology` dataclass keeps every JAX field, so a configuration reads
the same in both packages; the paths the port does not take yet (geo
tiers with their own loss, degree caps, a measured delay matrix) raise
`NotImplementedError` naming the ROADMAP item that brings them.
`aligned_u8_bits` is the u8 draw the flat wire loss (`edge_payload_drop`)
and the fault plan's loss paths compare against their thresholds.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import rng
from .state import ALIVE


@dataclasses.dataclass(frozen=True)
class Topology:
    n_regions: int = 1
    intra_delay: int = 0
    inter_delay: int = 1
    loss: float = 0.0
    n_azs: int = 1
    az_delay: int = 0
    az_loss: float = 0.0
    inter_loss: float = 0.0
    degree_classes: Tuple[int, ...] = ()
    region_delay_matrix: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if self.n_regions < 1 or self.n_azs < 1:
            raise ValueError("n_regions and n_azs must be >= 1")
        for name in ("loss", "az_loss", "inter_loss"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")

    @property
    def max_delay(self) -> int:
        if self.region_delay_matrix:
            return max(d for row in self.region_delay_matrix for d in row)
        return max(self.intra_delay, self.az_delay, self.inter_delay)


def loss_threshold(p: float) -> int:
    """Loss probability → the u8 compare threshold (JAX ``_thr``)."""
    return int(round(p * 256.0))


def loss_tiered(topo: Topology) -> bool:
    """Whether the loss tiers differ (JAX ``loss_tiered``)."""
    base = loss_threshold(topo.loss)
    tiers = {base}
    if topo.n_azs > 1:
        tiers.add(loss_threshold(topo.az_loss) if topo.az_loss > 0 else base)
    if topo.n_regions > 1:
        tiers.add(
            loss_threshold(topo.inter_loss) if topo.inter_loss > 0 else base
        )
    return len(tiers) > 1


def require_flat(topo: Topology) -> None:
    """Refuse the topology paths the port has not reached yet: one loss
    class over every edge is flat, tiers of their own are not."""
    if loss_tiered(topo):
        raise NotImplementedError(
            "tiered topology loss is not ported yet (ROADMAP B12 rest, "
            "tiered_edge_drop)"
        )
    if topo.n_azs > 1 or topo.region_delay_matrix:
        raise NotImplementedError(
            "geo-tiered topologies are not ported yet (ROADMAP B15)"
        )
    if topo.degree_classes:
        raise NotImplementedError(
            "heterogeneous degree caps are not ported yet (ROADMAP B15)"
        )


def regions(n_nodes: int, n_regions: int, device) -> torch.Tensor:
    """Contiguous region assignment."""
    per = max(1, n_nodes // n_regions)
    idx = torch.arange(n_nodes, dtype=torch.int32, device=device)
    return torch.clamp(idx // per, max=n_regions - 1)


def apply_degree_caps(targets: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Identity on topologies without degree classes (the only kind the
    port runs; `require_flat` refuses the others)."""
    require_flat(topo)
    return targets


def edge_delay(
    topo: Topology, region: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """Delay class (rounds) per edge from region distance (single AZ)."""
    require_flat(topo)
    same_r = region[src] == region[dst]
    return torch.where(same_r, topo.intra_delay, topo.inter_delay).to(
        torch.int32
    )


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


def edge_payload_drop(
    topo: Topology, key: torch.Tensor, n_edges: int, n_payloads: int
) -> torch.Tensor:
    """bool[E, P] per-(edge, payload) loss of the flat topology (JAX
    ``edge_payload_drop``'s legacy branch): nothing below a threshold of
    1 (no draw), everything at 256 or more, else ``aligned_u8_bits`` of
    ``key`` below the threshold."""
    require_flat(topo)
    thr = loss_threshold(topo.loss)
    dev = key.device
    if topo.loss <= 0.0 or thr == 0:
        return torch.zeros((n_edges, n_payloads), dtype=torch.bool, device=dev)
    if thr >= 256:
        return torch.ones((n_edges, n_payloads), dtype=torch.bool, device=dev)
    return aligned_u8_bits(key, (n_edges, n_payloads)) < thr


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
