"""The PeerSwap peer sampler — the port of ``corrosion_tpu/topo/sampler.py``.

Each node keeps a view of V peer ids (``SimState.pview``, i32[N, V], -1
empty), seeded at init (`init_peer_view`), mixed by one swap tick a round
(`peerswap_step`) and sampled for every fan-out, sync and probe target
draw (`psample_view_targets`, which `..sim.swim.sample_member_targets`
dispatches to under ``peer_sampler="peerswap"``).

Two hand-written kernels run it on the card:

- K1's view entry (`sample_view`, ``corro_sample_view`` in
  ``kernels/csrc/sample_targets.cu``): the candidates ``pview[i,
  slots[o, i]]`` of a ``[4·count, N]`` slot draw, filtered (empty, self,
  believed DOWN in coupled full view, repeats) and prefix-compacted by
  K1's shared device code;
- K21 (``kernels/csrc/peerswap.cu``), the swap tick in three passes:
  `peerswap_partner` (each node's partner, and the offer buffer set to
  -1), then — after the swap message's reachability (`swim._reachable`,
  over the topology's tiers and a fault plan's cuts) — `peerswap_apply`:
  the take into slot ``g = (c + 1) % V`` with the offers' scatter-max
  into the partners' buffer, then each landed offer into slot ``t % V``
  and the staggered refill of an empty slot.

Each wrapper takes the plain torch version beside it for a CPU tensor.
The draws (slots, partner slots, refill slots and ids) are K5's randint.

On a seed ensemble's lanes (B16s, the dense round's) every view gets a
leading lane axis (``pview`` i32[K, N, V]) and each kernel has a lane
entry, the solo body with a lane grid dimension: `sample_view_lanes`
(K1's view lane entry), `peerswap_partner_lanes` and
`peerswap_apply_lanes` (K21's three passes), under
`psample_view_targets_lanes` and `peerswap_step_lanes`; every draw is
K5's lane entry, and a lane's offers land in its own view only.  Each
plain lane version is the solo plain version on every lane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from ..kernels.build import check
from ..sim import rng
from ..sim.state import ALIVE, DOWN, SimConfig, SimState


def init_peer_view(cfg: SimConfig, key: torch.Tensor) -> torch.Tensor:
    """i32[N, V] initial views: uniform random peer ids, -1 where the
    draw landed on the node itself (JAX ``init_peer_view``)."""
    n, v = cfg.n_nodes, cfg.view_slots
    pid = rng.randint(key, (n, v), 0, n)
    me = torch.arange(n, dtype=torch.int32, device=key.device)[:, None]
    return torch.where(pid != me, pid, -1).to(torch.int32)


# -- K1's view entry ---------------------------------------------------------


def sample_view_plain(pview: torch.Tensor, slots: torch.Tensor,
                      view: Optional[torch.Tensor],
                      count: int) -> torch.Tensor:
    """Plain version of K1's view entry."""
    from ..sim.swim import _compact_targets, _dup_before

    n = pview.shape[0]
    me = torch.arange(n, dtype=torch.int32, device=pview.device)[None, :]
    cand = pview[me.long(), slots.long()]  # [over, N]
    valid = (cand >= 0) & (cand != me)
    if view is not None:
        safe = torch.clamp(cand, min=0)
        valid &= view[me.long(), safe.long()] != DOWN
    valid &= ~_dup_before(cand, valid)
    return _compact_targets(cand, valid, count)


def sample_view(pview: torch.Tensor, slots: torch.Tensor,
                view: Optional[torch.Tensor], count: int) -> torch.Tensor:
    """i32[N, count] targets from each node's view: candidate o of node i
    is ``pview[i, slots[o, i]]`` (``slots`` i32[over, N]); empty slots,
    the node itself, peers it believes DOWN (``view``, i8[N, N], or None)
    and repeats of an earlier valid candidate drop out, the rest are
    prefix-compacted, -1 pads.  K1's view entry on the card."""
    if pview.device.type == "cpu":
        return sample_view_plain(pview, slots, view, count)
    n, v = pview.shape
    over = slots.shape[0]
    check("pview", pview, torch.int32, (n, v))
    check("slots", slots, torch.int32, (over, n))
    if view is not None:
        check("view", view, torch.int8, (n, n))
    out = torch.empty((n, count), dtype=torch.int32, device=pview.device)
    kernels.SAMPLE_VIEW.launch([pview, slots, view, out],
                               [n, v, over, count])
    return out


def psample_view_targets(state: SimState, cfg: SimConfig, key: torch.Tensor,
                         count: int) -> torch.Tensor:
    """i32[N, count] fan-out targets drawn from each node's PeerSwap view
    (JAX ``psample_view_targets``): ``4 * count`` slot draws, filtered as
    the uniform sampler filters (believed DOWN only in coupled full
    view), prefix-compacted."""
    n, v = state.pview.shape
    slots = rng.randint(key, (4 * count, n), 0, v)
    coupled = cfg.couple_membership and cfg.swim_full_view
    return sample_view(state.pview, slots, state.view if coupled else None,
                       count)


# -- K21: the swap tick ------------------------------------------------------


def peerswap_partner_plain(pview: torch.Tensor, c: torch.Tensor):
    """Plain version of K21's partner pass."""
    n = pview.shape[0]
    rows = torch.arange(n, device=pview.device)
    pc = torch.clamp(pview[rows, c.long()], min=0).to(torch.int32)
    return pc, torch.full((n,), -1, dtype=torch.int32, device=pview.device)


def peerswap_partner(pview: torch.Tensor,
                     c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each node's swap partner ``max(pview[i, c[i]], 0)`` (i32[N]), and
    the offer buffer i32[N] set to -1.  K21's first pass on the card."""
    if pview.device.type == "cpu":
        return peerswap_partner_plain(pview, c)
    n, v = pview.shape
    check("pview", pview, torch.int32, (n, v))
    check("c", c, torch.int32, (n,))
    pc = torch.empty(n, dtype=torch.int32, device=pview.device)
    winner = torch.empty_like(pc)
    kernels.PEERSWAP_PARTNER.launch([pview, c, pc, winner], [n, v])
    return pc, winner


def peerswap_apply_plain(pview, c, reach, alive, rb, rid, winner, t: int,
                         interval: int) -> torch.Tensor:
    """Plain version of K21's swap and land passes (JAX
    ``peerswap_step``'s three writes); fills ``winner`` in place."""
    n, v = pview.shape
    dev = pview.device
    me = torch.arange(n, dtype=torch.int32, device=dev)
    rows = me.long()
    up = alive == ALIVE
    partner = pview[rows, c.long()]
    pc = torch.clamp(partner, min=0)
    ok = (partner >= 0) & (pc != me) & up & reach
    g = ((c + 1) % v).long()
    offer = pview[rows, g]
    take = pview[pc.long(), t % v]
    take_ok = ok & (take >= 0) & (take != me)
    out = pview.clone()
    out[rows, g] = torch.where(take_ok, take, pview[rows, g])
    give = torch.where(ok & (offer >= 0) & (offer != pc), offer, -1)
    winner.scatter_reduce_(0, pc.long(), give.to(torch.int32), "amax")
    w = t % v
    out[:, w] = torch.where(winner >= 0, winner, out[:, w])
    stagger = (t + me) % interval == 0
    cur = out[rows, rb.long()]
    refill = stagger & up & (cur < 0) & (rid != me)
    out[rows, rb.long()] = torch.where(refill, rid, cur)
    return out


def peerswap_apply(pview, c, reach, alive, rb, rid, winner, t: int,
                   interval: int) -> torch.Tensor:
    """One swap tick's writes from the OLD view ``pview`` (left as it
    is), into a new view: node i with an ok swap (its partner slot c[i]
    holds a peer other than i, i is up, the message reached, ``reach``)
    takes the partner's slot ``t % V`` into its slot ``g = (c[i] + 1) %
    V`` (not an empty entry, not itself), and offers its old slot g to
    the partner; each partner's slot ``t % V`` takes the largest offer
    it received (``winner``, i32[N] from `peerswap_partner`, filled here);
    then every up node on its announce stagger ``(t + i) % interval ==
    0`` refills slot rb[i] with rid[i] if that slot is empty and rid[i]
    is not itself.  K21's swap and land passes on the card."""
    if pview.device.type == "cpu":
        return peerswap_apply_plain(pview, c, reach, alive, rb, rid, winner,
                                    t, interval)
    n, v = pview.shape
    check("pview", pview, torch.int32, (n, v))
    for name, x in (("c", c), ("rb", rb), ("rid", rid), ("winner", winner)):
        check(name, x, torch.int32, (n,))
    check("reach", reach, torch.bool, (n,))
    check("alive", alive, torch.uint8, (n,))
    out = torch.empty_like(pview)
    kernels.PEERSWAP_SWAP.launch([pview, c, reach, alive, out, winner],
                                 [n, v, t])
    kernels.PEERSWAP_LAND.launch([out, winner, rb, rid, alive],
                                 [n, v, t, interval])
    return out


def peerswap_step(state: SimState, cfg: SimConfig, topo, key: torch.Tensor,
                  faults=None) -> SimState:
    """One swap tick (JAX ``peerswap_step``): the key splits four ways
    (partner slot, the swap message's loss, refill slot, refill id); the
    swap message rides the wire (`swim._reachable`: both ends up, one
    partition group, the topology's loss, a fault plan's cuts and
    loss).  Returns the state with the new view."""
    from ..sim.swim import _reachable

    pview = state.pview
    n, v = pview.shape
    ks = rng.split(key, 4)
    k_slot, k_loss, k_rb, k_rid = ks[0], ks[1], ks[2], ks[3]
    me = torch.arange(n, dtype=torch.int32, device=pview.device)
    c = rng.randint(k_slot, (n,), 0, v)
    pc, winner = peerswap_partner(pview, c)
    reach = _reachable(state, topo, k_loss, me, pc, faults)
    rb = rng.randint(k_rb, (n,), 0, v)
    rid = rng.randint(k_rid, (n,), 0, n)
    out = peerswap_apply(pview, c, reach, state.alive, rb, rid, winner,
                         int(state.t), cfg.announce_interval_rounds)
    return state._replace(pview=out)


# -- the lane entries (B16s) -------------------------------------------------


def sample_view_lanes_plain(pview, slots, view, count: int) -> torch.Tensor:
    """Plain version of K1's view lane entry: the solo plain version per
    lane."""
    return torch.stack([
        sample_view_plain(pview[k], slots[k], None if view is None
                          else view[k], count)
        for k in range(pview.shape[0])])


def sample_view_lanes(pview: torch.Tensor, slots: torch.Tensor,
                      view: Optional[torch.Tensor],
                      count: int) -> torch.Tensor:
    """`sample_view` over the lanes: i32[K, N, count] lane-local targets
    from each lane's views ``pview`` [K, N, V] at its slot draws
    ``slots`` [K, over, N], filtered by its beliefs ``view`` [K, N, N]
    (or None).  K1's view lane entry on the card."""
    if pview.device.type == "cpu":
        return sample_view_lanes_plain(pview, slots, view, count)
    lanes, n, v = pview.shape
    over = slots.shape[1]
    check("pview", pview, torch.int32, (lanes, n, v))
    check("slots", slots, torch.int32, (lanes, over, n))
    if view is not None:
        check("view", view, torch.int8, (lanes, n, n))
    out = torch.empty((lanes, n, count), dtype=torch.int32,
                      device=pview.device)
    kernels.SAMPLE_VIEW_LANES.launch([pview, slots, view, out],
                                     [n, v, over, count, lanes])
    return out


def psample_view_targets_lanes(state: SimState, cfg: SimConfig, keys,
                               count: int) -> torch.Tensor:
    """`psample_view_targets` over the lanes: ``4 * count`` slot draws a
    node under each lane's key ``keys[k]`` (K5's lane entry), then K1's
    view lane entry."""
    lanes, n, v = state.pview.shape
    slots = rng.randint_lanes(keys, (4 * count, n), 0, v)
    coupled = cfg.couple_membership and cfg.swim_full_view
    return sample_view_lanes(state.pview, slots,
                             state.view if coupled else None, count)


def peerswap_partner_lanes_plain(pview, c):
    """Plain version of K21's partner lane entry."""
    outs = [peerswap_partner_plain(pview[k], c[k])
            for k in range(pview.shape[0])]
    return (torch.stack([pc for pc, _ in outs]),
            torch.stack([w for _, w in outs]))


def peerswap_partner_lanes(pview: torch.Tensor, c: torch.Tensor):
    """`peerswap_partner` over the lanes: each lane's partners i32[K, N]
    and its offer buffer i32[K, N] set to -1.  K21's partner lane entry
    on the card."""
    if pview.device.type == "cpu":
        return peerswap_partner_lanes_plain(pview, c)
    lanes, n, v = pview.shape
    check("pview", pview, torch.int32, (lanes, n, v))
    check("c", c, torch.int32, (lanes, n))
    pc = torch.empty((lanes, n), dtype=torch.int32, device=pview.device)
    winner = torch.empty_like(pc)
    kernels.PEERSWAP_PARTNER_LANES.launch([pview, c, pc, winner],
                                          [n, v, lanes])
    return pc, winner


def peerswap_apply_lanes_plain(pview, c, reach, alive, rb, rid, winner,
                               t: int, interval: int) -> torch.Tensor:
    """Plain version of K21's swap and land lane entries (fills
    ``winner`` in place)."""
    return torch.stack([
        peerswap_apply_plain(pview[k], c[k], reach[k], alive[k], rb[k],
                             rid[k], winner[k], t, interval)
        for k in range(pview.shape[0])])


def peerswap_apply_lanes(pview, c, reach, alive, rb, rid, winner, t: int,
                         interval: int) -> torch.Tensor:
    """`peerswap_apply` over the lanes: each lane's tick from its OLD
    view [K, N, V] into a new one, its offers scatter-maxed into its own
    offer buffer (``winner`` [K, N], lane-local partners).  K21's swap
    and land lane entries on the card."""
    if pview.device.type == "cpu":
        return peerswap_apply_lanes_plain(pview, c, reach, alive, rb, rid,
                                          winner, t, interval)
    lanes, n, v = pview.shape
    check("pview", pview, torch.int32, (lanes, n, v))
    for name, x in (("c", c), ("rb", rb), ("rid", rid), ("winner", winner)):
        check(name, x, torch.int32, (lanes, n))
    check("reach", reach, torch.bool, (lanes, n))
    check("alive", alive, torch.uint8, (lanes, n))
    out = torch.empty_like(pview)
    kernels.PEERSWAP_SWAP_LANES.launch([pview, c, reach, alive, out, winner],
                                       [n, v, t, lanes])
    kernels.PEERSWAP_LAND_LANES.launch([out, winner, rb, rid, alive],
                                       [n, v, t, interval, lanes])
    return out


def peerswap_step_lanes(state: SimState, cfg: SimConfig, topo,
                        keys: torch.Tensor, faults=None,
                        seeds=None) -> SimState:
    """`peerswap_step` over the lanes, draw for draw the solo tick with
    lane k's key: each key splits four ways (partner slot, the swap
    message's loss, refill slot, refill id; K5's lane entries), the
    partner pass, the swap message's reach (`..sim.pswim.reachable_lanes`:
    the topology's loss through K20's reach lane entry or the flat
    bernoulli, a fault plan's cuts and loss under each lane's plan seed),
    then the swap and land passes.  Returns the state with the lanes' new
    views."""
    from ..sim.pswim import reachable_lanes

    pview = state.pview
    lanes, n, v = pview.shape
    ks = rng.split_lanes(keys, 4)
    k_slot, k_loss, k_rb, k_rid = (ks[:, i].contiguous() for i in range(4))
    me = torch.arange(n, dtype=torch.int32, device=pview.device)
    c = rng.randint_lanes(k_slot, (n,), 0, v)
    pc, winner = peerswap_partner_lanes(pview, c)
    reach = reachable_lanes(state, topo, k_loss, me[None], pc, faults,
                            seeds)
    rb = rng.randint_lanes(k_rb, (n,), 0, v)
    rid = rng.randint_lanes(k_rid, (n,), 0, n)
    out = peerswap_apply_lanes(pview, c, reach, state.alive, rb, rid, winner,
                               int(state.t), cfg.announce_interval_rounds)
    return state._replace(pview=out)
