"""Per-origin FIFO delivery ordering — the port of
``corrosion_tpu/proto/ordering.py``.

Under ``ordering="fifo"`` a node delivers (merges into ``have``) a chunk
of version v from origin a only once version v - 1 from a is completely
held BEFORE this round's merge; an out-of-order arrival is discarded and
re-served later.  Both rings are gated on the one mask.
``"fifo-unchecked"`` measures the delivery-order invariant
(`..sim.invariants.order_violation_count`) without gating.

The admit masks below are the plain versions.  On the card the gate is
an instantiation of the deliver kernels themselves — K8f
(``word_phases.cu``, `..sim.packed.deliver_packed`) and K12f-o
(``dense_phases.cu``, `..sim.broadcast.deliver_dense`) — which compute
each row's mask from its pre-merge ``have`` before they touch it.

Version-major layout: payload p = (v * A + a) * C + c, so the
predecessor of p's version is the group A * C bits (one "wave") earlier,
and the first wave (v = 0) has none: its slot is always admitted.
"""

from __future__ import annotations

import torch

from ..sim.state import SimConfig, complete_versions, grid_to_payload


def prev_complete(comp: torch.Tensor) -> torch.Tensor:
    """bool[..., A, V]: version v's predecessor is completely held (the
    first version has none, so its slot is always True)."""
    head = torch.ones_like(comp[..., :1])
    return torch.cat([head, comp[..., :-1]], dim=-1)


def order_enforced(cfg: SimConfig) -> bool:
    """Does this scenario gate deliveries on order?"""
    return cfg.ordering == "fifo"


def order_checked(cfg: SimConfig) -> bool:
    """Does this scenario count the delivery-order invariant?"""
    return cfg.ordering in ("fifo", "fifo-unchecked")


def admit_payload_mask(have: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[N, P] dense-domain admit mask from the current holdings:
    payload p may be delivered iff its version's predecessor (same
    origin) is complete in ``have``."""
    return grid_to_payload(prev_complete(complete_versions(have, cfg)), cfg)


def admit_words(have_w: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Words [N, W], the packed twin of `admit_payload_mask`: the same
    predecessor predicate smeared back to group-uniform words."""
    from ..sim.words import grid_to_words, group_grid

    return grid_to_words(prev_complete(group_grid(have_w, cfg, "all")), cfg)
