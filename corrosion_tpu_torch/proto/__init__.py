"""The protocol axis of the port: the named family registry
(`families`).  The variants' device functions live in `schedule`,
`ordering` and `dissemination`, imported on their own: they need the
simulator's state."""

from .families import DEFAULTS, FAMILIES, PROTO_KEYS, family_proto

__all__ = ["DEFAULTS", "FAMILIES", "PROTO_KEYS", "family_proto"]
