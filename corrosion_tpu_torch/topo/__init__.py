"""The topology axis of the port: the named family registry
(`families`), the churn schedules and the host compilation of a tiered
topology (`churn`), and the PeerSwap peer sampler (`sampler`, imported
on its own: it needs the simulator's state)."""

from .churn import (
    CHURN_FAMILIES,
    az_blocks,
    churn_events,
    diurnal_events,
    flash_crowd_events,
    topology_link_events,
)
from .families import FAMILIES, family_topology, min_delay_slots

__all__ = [
    "CHURN_FAMILIES",
    "FAMILIES",
    "az_blocks",
    "churn_events",
    "diurnal_events",
    "family_topology",
    "flash_crowd_events",
    "min_delay_slots",
    "topology_link_events",
]
