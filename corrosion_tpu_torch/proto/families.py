"""Named protocol-variant families: the port's copy of
``corrosion_tpu/proto/families.py`` (the registry only; the port's
configs overlay a family the way JAX's do, `..sim.runner._resolve_proto`).

A family is a dict of `..sim.state.SimConfig` protocol-knob kwargs, not
a config, so callers overlay their own keys on it.  The knobs, each
defaulting to the legacy point:

- ``dissemination``   — "push" (fire-and-forget fan-out) or
  "push-pull" (every broadcast contact also pulls the contacted node's
  sending buffer back over the same edge, `.dissemination`);
- ``fanout_schedule`` — "flat" (every fan-out slot every round) or
  "decay" (the live slot count halves every ``fanout_decay_rounds``,
  floored at 1, `.schedule`);
- ``sync_cadence``    — "periodic" (the countdown and backoff loop) or
  "eager" (every node syncs every round, the SWARM-style limit, arXiv
  2409.16258);
- ``ordering``        — "none", "fifo" (per-origin FIFO delivery
  enforced at the delivery seam, arXiv 1708.08309, `.ordering`) or
  "fifo-unchecked" (the delivery-order invariant measured, nothing
  enforced: the negative control).
"""

from __future__ import annotations

from typing import Dict

#: SimConfig protocol knobs a family may set
PROTO_KEYS = (
    "dissemination",
    "fanout_schedule",
    "fanout_decay_rounds",
    "sync_cadence",
    "ordering",
)

#: the legacy protocol point, equal to the SimConfig field defaults
DEFAULTS: Dict[str, object] = {
    "dissemination": "push",
    "fanout_schedule": "flat",
    "fanout_decay_rounds": 8,
    "sync_cadence": "periodic",
    "ordering": "none",
}

FAMILIES: Dict[str, Dict[str, object]] = {
    "baseline": {},
    "swarm-aggressive": {"sync_cadence": "eager"},
    "push-pull": {"dissemination": "push-pull"},
    "fanout-decay": {"fanout_schedule": "decay", "fanout_decay_rounds": 8},
    "lab-ordered": {"ordering": "fifo"},
    "lab-ordered-broken": {"ordering": "fifo-unchecked"},
}


def family_proto(name: str) -> Dict[str, object]:
    """SimConfig protocol kwargs for a named family (a fresh dict)."""
    if name not in FAMILIES:
        raise KeyError(
            f"unknown protocol family {name!r} (have {sorted(FAMILIES)})"
        )
    return dict(FAMILIES[name])
