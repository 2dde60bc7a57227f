"""SWIM sampling helpers and dispatch — the port's copy of the parts of
``corrosion_tpu/sim/swim.py`` the partial-view storm runs: the
transposed ``[over, N]`` dedup/compaction helpers, reachability on a
flat loss-free topology with the fault plan's cuts and probe loss, and
the partial-view dispatch of `sample_member_targets` and `swim_step`.
Full-view SWIM (ROADMAP B14) is not ported; the uniform ground-truth
sampler (ROADMAP A4) raises."""

from __future__ import annotations

import torch

from .faults import fault_reach_
from .state import ALIVE, SimConfig, SimState
from .topology import Topology, require_flat


def _compact_targets(
    cand: torch.Tensor, valid: torch.Tensor, count: int
) -> torch.Tensor:
    """Prefix-compact each node's valid candidates into the first
    ``count`` slots (-1 pads); inputs are ``[over, N]``, output
    ``[N, count]``."""
    rank = torch.cumsum(valid.to(torch.int32), dim=0)  # [over, N]
    slot = torch.arange(
        1, count + 1, dtype=torch.int32, device=cand.device
    )[None, :, None]
    sel = valid[:, None, :] & (rank[:, None, :] == slot)  # [over, count, N]
    picked = torch.where(sel, cand[:, None, :], -1)
    return picked.amax(dim=0).T.contiguous()


def _dup_before(cand: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[over, N]: candidate j repeats an EARLIER valid candidate."""
    over = cand.shape[0]
    eq = cand[None, :, :] == cand[:, None, :]  # [j, i, N]
    earlier = torch.tril(
        torch.ones((over, over), dtype=torch.bool, device=cand.device),
        diagonal=-1,
    )  # [j, i]: i < j
    return (eq & earlier[:, :, None] & valid[None, :, :]).any(dim=1)


def _reachable(
    state: SimState, topo: Topology, key: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, faults=None,
) -> torch.Tensor:
    """Ground-truth reachability of a probe src→dst on a flat, loss-free
    topology (topology loss is ROADMAP B15).  ``faults`` (a
    `faults.FactoredRoundFaults`) adds the plan's directed cuts and its
    per-edge loss, drawn from ``fold_in(fold_in(key, seed), 103)``
    (`faults.fault_reach_`, K9 on the card); without it ``key`` draws
    nothing."""
    require_flat(topo)
    ok = (
        (state.group[src] == state.group[dst])
        & (state.alive[src] == ALIVE)
        & (state.alive[dst] == ALIVE)
    )
    if faults is not None:
        ok = fault_reach_(ok, faults, key, src, dst)
    return ok


def sample_member_targets(
    state: SimState, cfg: SimConfig, key: torch.Tensor, count: int
) -> torch.Tensor:
    """i32[N, count] targets from each node's believed member list."""
    if cfg.swim_partial_view:
        from .pswim import psample_member_targets

        return psample_member_targets(state, cfg, key, count)
    raise NotImplementedError(
        "only the partial-view sampler is ported; the uniform "
        "ground-truth sampler is ROADMAP A4"
    )


def swim_step(
    state: SimState, cfg: SimConfig, topo: Topology, key: torch.Tensor,
    faults=None,
) -> SimState:
    if cfg.swim_partial_view:
        from .pswim import pswim_step

        return pswim_step(state, cfg, topo, key, faults)
    return state  # ground-truth membership
