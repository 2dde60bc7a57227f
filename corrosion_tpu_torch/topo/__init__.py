"""The topology axis of the port: the named family registry
(`families`) and the PeerSwap peer sampler (`sampler`, imported on its
own: it needs the simulator's state)."""

from .families import FAMILIES, family_topology, min_delay_slots

__all__ = ["FAMILIES", "family_topology", "min_delay_slots"]
