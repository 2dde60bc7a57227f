"""The fan-out schedule and the sync cadence — the port of
``corrosion_tpu/proto/schedule.py``.

Both are identities on the default knobs and consume no randomness: a
schedule is a function of the round counter, which the port keeps on the
host, so this round's live slot count is a host int.

On the card the schedule is an instantiation of K20's caps entry
(``kernels/csrc/edge_classes.cu``, counted as ``degree_caps_sched``, and
on a seed ensemble's lanes as ``degree_caps_sched_lanes``):
one launch keeps the slots below min(the node's degree cap, this round's
live count), the caps first and the schedule after them, as JAX applies
``apply_degree_caps`` and then ``scheduled_fanout_targets``.  The eager
cadence launches nothing of its own: it only changes the sync's due
mask, which K3 and K13 already read through the sessions' ``ok``, and
which the countdown re-arm reads.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.build import check


def active_fanout(cfg, t: int) -> int:
    """Fan-out slots live at round ``t`` under the halving schedule:
    ``fanout >> min(t // fanout_decay_rounds, 30)``, floored at 1 (JAX
    ``active_fanout``)."""
    steps = min(t // cfg.fanout_decay_rounds, 30)
    return max(cfg.fanout >> steps, 1)


def scheduled_fanout_targets(targets: torch.Tensor, cfg,
                             t: int) -> torch.Tensor:
    """Slots at or past this round's live count become the -1
    unfilled-slot sentinel (JAX ``scheduled_fanout_targets``); identity
    on the flat schedule."""
    if cfg.fanout_schedule == "flat":
        return targets
    f = targets.shape[1]
    keep = torch.arange(f, device=targets.device)[None, :] < active_fanout(
        cfg, t)
    return torch.where(keep, targets, -1)


def capped_schedule_plain(targets: torch.Tensor, topo, cfg,
                          t: int) -> torch.Tensor:
    """Plain version of K20's schedule instantiation: the degree caps,
    then the schedule."""
    from ..sim.topology import apply_degree_caps_plain

    if topo.degree_classes:
        targets = apply_degree_caps_plain(targets, topo)
    return scheduled_fanout_targets(targets, cfg, t)


def capped_schedule(targets: torch.Tensor, topo, cfg, t: int) -> torch.Tensor:
    """The broadcast's fan-out slots after the topology's degree caps and
    the protocol's schedule: under the flat schedule
    `..sim.topology.apply_degree_caps` alone; under "decay" slot s of
    node i stays only where s < min(cap(i), `active_fanout`), the cap F
    without degree classes.  K20's schedule instantiation on the card,
    in place on ``targets`` (i32[N, F])."""
    from ..sim.topology import apply_degree_caps, topo_table

    if cfg.fanout_schedule == "flat":
        return apply_degree_caps(targets, topo)
    if targets.device.type == "cpu":
        return capped_schedule_plain(targets, topo, cfg, t)
    n, f = targets.shape
    check("targets", targets, torch.int32, (n, f))
    table = (topo_table(topo, n, targets.device) if topo.degree_classes
             else None)
    kernels.DEGREE_CAPS_SCHED.launch([table, targets],
                                     [n, f, active_fanout(cfg, t)])
    return targets


def capped_schedule_lanes_plain(targets: torch.Tensor, topo, cfg,
                                t: int) -> torch.Tensor:
    """Plain version of K20's schedule lane entry: the solo plain version
    on each lane."""
    return torch.stack([capped_schedule_plain(x, topo, cfg, t)
                        for x in targets])


def capped_schedule_lanes(targets: torch.Tensor, topo, cfg,
                          t: int) -> torch.Tensor:
    """`capped_schedule` over the lanes' targets i32[K, N, F] (B16v): the
    caps of row r's degree class and this round's live slot count, both
    shared by every lane (they share ``t``); under the flat schedule
    `..sim.topology.apply_degree_caps_lanes` alone.  K20's schedule lane
    entry on the card, in place."""
    from ..sim.topology import apply_degree_caps_lanes, topo_table

    if cfg.fanout_schedule == "flat":
        return apply_degree_caps_lanes(targets, topo)
    if targets.device.type == "cpu":
        return capped_schedule_lanes_plain(targets, topo, cfg, t)
    lanes, n, f = targets.shape
    check("targets", targets, torch.int32, (lanes, n, f))
    table = (topo_table(topo, n, targets.device) if topo.degree_classes
             else None)
    kernels.DEGREE_CAPS_SCHED_LANES.launch(
        [table, targets], [n, f, active_fanout(cfg, t), lanes])
    return targets


def cadence_due(due: torch.Tensor, cfg) -> torch.Tensor:
    """The sync's due mask (bool[N], or [K, N] on the lanes) under the
    cadence: "periodic" passes it through, "eager" makes every node due
    every round; the countdown
    and backoff keep running, and keep drawing, either way (JAX
    ``cadence_due``)."""
    if cfg.sync_cadence == "periodic":
        return due
    return torch.ones_like(due)
