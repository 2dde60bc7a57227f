"""Push-pull dissemination, the pull half of the exchange — the port of
``corrosion_tpu/proto/dissemination.py``.

Under ``dissemination="push-pull"`` every broadcast contact is a
request and a response: the contacted node ``dst`` sends its own
sending buffer (after the byte governor, before the relay spend) back
to the contacting node ``src`` over the same sampled edge.

- The exchange is a round trip: a fault plan's cut in EITHER direction
  refuses the response (`pull_session_ok`, the sync session's rule),
  while the push still flows in the hearing direction.
- The response draws its own loss (`pull_wire_drop`): the reverse
  direction's topology tiers on ``k_pull = fold_in(k_drop, 1)``, ORed
  with the reverse direction's fault loss on ``fold_in(fold_in(k_pull,
  plan seed), 101)``.  The draw index stays the edge index e.
- It lands at the puller in the push's per-edge slot (the fixed delay;
  a response is request-paced, so never the plan's jitter).
- It spends no relay budget; receivers re-arm relay on delivery like
  any broadcast arrival.

The plain versions here are the reference the kernels are held to.  On
the card the response scatter is K10p (`..sim.packed.scatter_pull`,
``broadcast_scatter.cu``) on the packed round and K12p
(`..sim.broadcast.pull_send`, ``dense_phases.cu``; on a seed ensemble's
lanes `..sim.broadcast.pull_send_lanes`, its lane entry) on the dense one,
both drawing these bits themselves; the session refusal is K9's (K9m's)
existing session entry and the reverse thresholds K9's wire query on
the swapped edge arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sim import rng
from ..sim.faults import (
    WIRE_LOSS_TAG,
    _block_plain,
    _has,
    fault_edge_loss,
    fault_key,
    fault_session_refused,
)
from ..sim.topology import (
    Topology,
    aligned_u8_bits,
    loss_threshold,
    tiered_edge_drop,
    wire_tiers,
)

#: the tag the pull folds into the broadcast's k_drop
PULL_TAG = 1


def pull_key(k_drop: torch.Tensor) -> torch.Tensor:
    """``fold_in(k_drop, 1)``: the pull's loss key."""
    return rng.fold_in(k_drop, PULL_TAG)


def pull_session_ok_plain(ok: torch.Tensor, faults, src: torch.Tensor,
                          dst: torch.Tensor) -> torch.Tensor:
    """Plain version: ``ok & ~block(dst, src)`` (JAX
    ``pull_session_ok``)."""
    if faults is None or not _has(faults, "block"):
        return ok
    return ok & ~_block_plain(faults, dst, src)


def pull_session_ok(ok: torch.Tensor, faults, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """bool[E]: the response can flow — the push's edge mask ``ok``
    (already without the forward cuts) minus the edges whose reverse
    direction a fault plan cuts.  Because ``ok`` carries the forward cut,
    that is ``ok`` minus the sessions a cut in either direction refuses:
    K9's (K9m's) session entry on the card, in place on a copy of
    ``ok``, counted nowhere."""
    if faults is None or not _has(faults, "block"):
        return ok
    if ok.device.type == "cpu":
        return pull_session_ok_plain(ok, faults, src, dst)
    ok_pull = ok.clone()
    fault_session_refused(faults, src, dst, ok=ok_pull)
    return ok_pull


def reverse_loss(faults, src: torch.Tensor, dst: torch.Tensor):
    """u8[E] the reverse edges' fault-loss thresholds (the plan's loss of
    dst → src), or None when the plan has no loss: K9's wire query on the
    swapped edge arrays on the card."""
    if faults is None:
        return None
    return fault_edge_loss(faults, dst, src)


def pull_session_ok_lanes(ok: torch.Tensor, faults, src: torch.Tensor,
                          dst: torch.Tensor) -> torch.Tensor:
    """`pull_session_ok` over a seed ensemble's lanes (B16v): ok and dst
    [K, E] (lane-local ids), src [1, E]; the plan's round slice is shared,
    so the lanes fold into the edge axis of one K9 (K9m) session query,
    which draws nothing; src may be None without a plan."""
    if faults is None:
        return ok
    lanes = ok.shape[0]
    return pull_session_ok(ok.reshape(-1), faults,
                           src.expand(lanes, -1).reshape(-1),
                           dst.reshape(-1)).view(lanes, -1)


def reverse_loss_lanes(faults, src: torch.Tensor, dst: torch.Tensor):
    """`reverse_loss` over the lanes: u8[K, E] from dst [K, E] and src
    [1, E], the lanes folded into one K9 wire query; None without a
    plan."""
    if faults is None:
        return None
    lanes = dst.shape[0]
    thr = reverse_loss(faults, src.expand(lanes, -1).reshape(-1),
                       dst.reshape(-1))
    return None if thr is None else thr.view(lanes, -1)


def pull_drop_bits(topo_thr: int, tiers: Optional[Topology],
                   thr_rev: Optional[torch.Tensor], seed: int,
                   k_drop: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n_payloads: int, region=None) -> torch.Tensor:
    """bool[E, P] the response's loss as the kernels take it: the flat
    threshold ``topo_thr`` (0 none, 256 or more all) or the reverse
    edges' tiers under ``tiers`` (with the nodes' ``region``), on the
    pull key; ORed with the fault stream below the reverse thresholds
    ``thr_rev`` (None: no fault loss)."""
    e = src.shape[0]
    k_pull = pull_key(k_drop)
    if tiers is not None:
        drop = tiered_edge_drop(tiers, k_pull, region, dst, src,
                                (e, n_payloads))
    elif topo_thr >= 256:
        drop = torch.ones((e, n_payloads), dtype=torch.bool,
                          device=src.device)
    elif topo_thr > 0:
        drop = aligned_u8_bits(k_pull, (e, n_payloads)) < topo_thr
    else:
        drop = torch.zeros((e, n_payloads), dtype=torch.bool,
                           device=src.device)
    if thr_rev is not None:
        bits = aligned_u8_bits(fault_key(k_pull, seed, WIRE_LOSS_TAG),
                               (e, n_payloads))
        drop = drop | (bits < thr_rev[:, None])
    return drop


def pull_wire_drop(topo: Topology, faults, k_drop: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor, n_payloads: int,
                   region: torch.Tensor) -> torch.Tensor:
    """bool[E, P] wire loss on the pull responses (JAX
    ``pull_wire_drop``): the reverse direction's topology tiers (or the
    flat loss) on the pull key, ORed with the reverse direction's fault
    loss."""
    thr_rev = None
    if faults is not None and _has(faults, "loss"):
        from ..sim.faults import _loss_plain

        thr_rev = _loss_plain(faults, dst, src)
    tiers = wire_tiers(topo)
    topo_thr = (loss_threshold(topo.loss)
                if topo.loss > 0 and tiers is None else 0)
    seed = 0 if faults is None else int(faults.seed)
    return pull_drop_bits(topo_thr, tiers, thr_rev, seed, k_drop, src, dst,
                          n_payloads, region)
