"""Anti-entropy sync on the dense state — the port of
``corrosion_tpu/sim/sync.py`` (``node_sync_masks``, ``edge_needs``,
``sync_step``) in the periodic cadence without faults, metered or
unmetered, with its session telemetry.

A due node pulls from ``sync_peers`` sampled members; per edge the
wanted versions are the three need classes of the advertised
bookkeeping (my gap ranges the peer fully holds, my partial versions
the peer holds, the peer's head catch-up), granted at chunk level
(held by the server, lacking at the puller), cut per edge to the
oldest-first prefix within the sync byte budget, and ORed into the
sync ring's slot t + 1.  That per-edge pull is one launch of K13
(``kernels/csrc/dense_sync.cu``) on the card (`sync_pull_dense`); the
plain version beside it composes `edge_needs` and
`.state.budget_prefix_mask` as JAX does.  The peer draw, the backoff and
the re-arm stay torch (and K1, K5).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..kernels.build import check
from . import rng
from .gaps import gaps_to_mask
from .state import (
    PayloadMeta,
    SimConfig,
    SimState,
    budget_prefix_mask,
    complete_versions,
    grid_to_payload,
)
from .swim import sample_member_targets
from .telemetry import GRANTS, RoundTrace
from .topology import Topology, edge_alive


def _node_masks(have, heads, gap_lo, gap_hi, cfg: SimConfig):
    v = cfg.n_versions
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=have.device)
    miss_full = gaps_to_mask(gap_lo, gap_hi, v)  # [N, A, V]
    below_head = v_idx[None, None, :] <= heads[:, :, None]
    comp = complete_versions(have, cfg)
    partial = below_head & ~miss_full & ~comp
    haves = below_head & ~miss_full & comp
    return miss_full, partial, haves


def node_sync_masks(state: SimState, cfg: SimConfig):
    """Per-node version masks [N, A, V] from the advertised bookkeeping:
    (miss_full, partial, haves) — JAX ``node_sync_masks``."""
    return _node_masks(state.have, state.heads, state.gap_lo, state.gap_hi,
                       cfg)


def _edge_needs(have, heads, gap_lo, gap_hi, cfg: SimConfig, src, dst):
    miss_full, partial, haves = _node_masks(have, heads, gap_lo, gap_hi, cfg)
    v_idx = torch.arange(
        1, cfg.n_versions + 1, dtype=torch.int32, device=have.device
    )[None, None, :]
    s, d = src.long(), dst.long()
    full_need = miss_full[s] & haves[d]
    partial_need = partial[s] & (haves[d] | partial[d])
    catchup = (v_idx > heads[s][:, :, None]) & (v_idx <= heads[d][:, :, None])
    wanted = full_need | partial_need | catchup
    return grid_to_payload(wanted, cfg) & (have[d] > 0) & (have[s] == 0)


def edge_needs(
    state: SimState, cfg: SimConfig, src: torch.Tensor, dst: torch.Tensor,
    regular_fanout: Optional[int] = None,
) -> torch.Tensor:
    """bool[E, P]: chunks server ``dst`` can supply to puller ``src``
    (JAX ``edge_needs``; ``regular_fanout`` only picks JAX's gather
    layout, the result is the same)."""
    return _edge_needs(state.have, state.heads, state.gap_lo, state.gap_hi,
                       cfg, src, dst)


# -- K13: the per-edge pull --------------------------------------------------


def sync_pull_dense_plain(have, heads, gap_lo, gap_hi, peers, ok, nbytes,
                          budget, slot_ring, cfg: SimConfig,
                          counts=None) -> torch.Tensor:
    """Plain version of K13, in place on ``slot_ring`` (and ``counts``
    when given)."""
    n, s = peers.shape
    p = have.shape[1]
    src = torch.arange(n, dtype=torch.int32, device=have.device)
    src = src.repeat_interleave(s)
    need = _edge_needs(have, heads, gap_lo, gap_hi, cfg, src,
                       peers.reshape(-1)) & ok.reshape(-1)[:, None]
    granted = budget_prefix_mask(need, budget, nbytes).reshape(n, s, p)
    if counts is not None:
        counts += granted.sum(dim=(0, 1), dtype=torch.int32)
    slot_ring |= granted.any(dim=1).to(torch.uint8)
    return granted.any(dim=2).any(dim=1)


def sync_pull_dense(have, heads, gap_lo, gap_hi, peers, ok, nbytes,
                    budget: Optional[int], slot_ring, cfg: SimConfig,
                    counts=None) -> torch.Tensor:
    """Each node n pulls from its peers ``peers[n, s]`` where ``ok``:
    per edge the needs (`edge_needs`), cut to the oldest-first prefix
    within ``budget`` bytes (None: unmetered), are ORed into ``slot_ring``
    (the sync ring's slot t + 1, u8 [N, P]) in place; returns bool[N]
    fruitful (some edge granted something).  With ``counts`` i32[P] (the
    flight recorder's grant row) each payload's granting edges are added
    to it.  K13 on the card."""
    if have.device.type == "cpu":
        return sync_pull_dense_plain(have, heads, gap_lo, gap_hi, peers, ok,
                                     nbytes, budget, slot_ring, cfg, counts)
    n, p = have.shape
    s = peers.shape[1]
    a, k = cfg.n_writers, cfg.gap_slots
    check("have", have, torch.uint8, (n, p))
    check("heads", heads, torch.int32, (n, a))
    check("gap_lo", gap_lo, torch.int32, (n, a, k))
    check("gap_hi", gap_hi, torch.int32, (n, a, k))
    check("peers", peers, torch.int32, (n, s))
    check("ok", ok, torch.bool, (n, s))
    check("nbytes", nbytes, torch.int32, (p,))
    check("slot_ring", slot_ring, torch.uint8, (n, p))
    if counts is not None:
        check("counts", counts, torch.int32, (p,))
    fruitful = torch.empty(n, dtype=torch.bool, device=have.device)
    kernels.DENSE_SYNC.launch(
        [have, heads, gap_lo, gap_hi, peers, ok, nbytes, slot_ring,
         fruitful, counts],
        [n, p, s, a, cfg.chunks_per_version, k,
         -1 if budget is None else budget],
    )
    return fruitful


def sync_step(
    state: SimState, meta: PayloadMeta, cfg: SimConfig, topo: Topology,
    key: torch.Tensor, faults=None, trace: Optional[RoundTrace] = None,
):
    """Anti-entropy round (JAX ``sync_step``): due nodes pull into the
    sync ring's slot t + 1 (in place), then the fruitfulness-adaptive
    backoff and the re-arm draw.  Returns the state; with a ``trace``
    the per-payload grant counts go to its grant row (K13) and the
    sessions' ok mask bool[N * S] comes back second."""
    if faults is not None:
        raise NotImplementedError(
            "faults on the dense round are not ported yet (ROADMAP B12 "
            "rest)"
        )
    n = state.have.shape[0]
    s = cfg.sync_peers
    ks = rng.split(key, 3)
    k_peers, k_rearm = ks[0], ks[2]
    due = state.sync_countdown <= 0
    peers = sample_member_targets(state, cfg, k_peers, s)  # [N, S]
    me = torch.arange(n, dtype=torch.int32, device=peers.device)
    src = me.repeat_interleave(s)
    dst = peers.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst)
    ok &= due[src.long()]
    ok &= dst != src
    d_slots = state.sync_inflight.shape[0]
    fruitful = sync_pull_dense(
        state.have, state.heads, state.gap_lo, state.gap_hi,
        dst.reshape(n, s), ok.reshape(n, s), meta.nbytes,
        cfg.sync_budget_bytes,
        state.sync_inflight[(int(state.t) + 1) % d_slots], cfg,
        None if trace is None else trace.counts[GRANTS],
    )
    backoff = torch.where(
        due & fruitful,
        cfg.sync_interval_rounds,
        torch.where(
            due,
            torch.clamp(state.sync_backoff * 2, max=cfg.sync_backoff_cap()),
            state.sync_backoff,
        ),
    ).to(torch.int32)
    rearm = rng.randint(k_rearm, (n,), 1, backoff + 1)
    countdown = torch.where(due, rearm, state.sync_countdown - 1)
    state = state._replace(sync_countdown=countdown.to(torch.int32),
                           sync_backoff=backoff)
    if trace is not None:
        return state, ok
    return state
