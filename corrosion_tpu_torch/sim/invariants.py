"""The sim's invariant catalog — the port of ``corrosion_tpu/sim/
invariants.py`` `check_state`: always-properties over a state snapshot,
evaluated between rounds by the checked fault driver
(`.faults.run_fault_plan_checked`) and by tests.

- **no-phantom-data** — ``have ⊆ injected``: no node holds a chunk that
  never entered the system.
- **bookkeeping-heads** — ``heads`` equals the max touched version per
  (node, actor) derived from ``have``.
- **bookkeeping-gaps** — the gap intervals cover EXACTLY the missing
  runs of touched versions below the head when the runs fit in K slots,
  a superset (never a subset) under K-overflow clamping, and never a
  version above the head.
- **relay-budget** — ``relay_left ≤ max_transmissions``.
- **dead-nodes-inert** — nodes down since round 0 hold nothing.

The snapshot is host numpy (`convert.state_to_numpy`, JAX's layout and
dtypes); the version grids come from the port's own helpers on CPU
tensors.  JAX's delivery-order property (`order_violation_count`)
applies only under a FIFO ordering, which the port's `SimConfig` does
not take yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert import state_to_numpy
from .gaps import gaps_to_mask
from .state import SimConfig, SimState, touched_versions, version_heads


def check_state(
    state: SimState,
    cfg: SimConfig,
    dead_since_start: Optional[np.ndarray] = None,
) -> None:
    """Assert the always-properties on a snapshot of ``state``; raises
    AssertionError naming the violated property, in JAX's words."""
    snap = state_to_numpy(state)
    have = snap["have"]
    injected = snap["injected"]
    assert (have <= injected[None, :]).all(), (
        "no-phantom-data: a node holds a never-injected chunk"
    )

    touched_t = touched_versions(torch.from_numpy(have), cfg)
    touched = touched_t.numpy()
    heads = snap["heads"]
    expect_heads = version_heads(touched_t).numpy()
    assert (heads == expect_heads).all(), (
        "bookkeeping-heads: state.heads diverged from chunk truth"
    )

    v = cfg.n_versions
    v_idx = np.arange(1, v + 1)
    missing = (~touched) & (v_idx[None, None, :] <= heads[:, :, None])
    covered = gaps_to_mask(torch.from_numpy(snap["gap_lo"]),
                           torch.from_numpy(snap["gap_hi"]), v).numpy()
    # never under-cover (would starve sync); exact when runs fit in K
    assert (covered >= missing).all(), (
        "bookkeeping-gaps: gap tensors under-cover the missing runs"
    )
    n_runs = (missing & ~np.pad(missing[:, :, :-1],
                                ((0, 0), (0, 0), (1, 0)))).sum(axis=2)
    fits = n_runs <= cfg.gap_slots
    assert (covered[fits] == missing[fits]).all(), (
        "bookkeeping-gaps: inexact coverage without K-overflow"
    )
    assert not (covered & (v_idx[None, None, :] > heads[:, :, None])).any(), (
        "bookkeeping-gaps: gap covers a version above the head"
    )

    assert (snap["relay_left"] <= cfg.max_transmissions).all(), (
        "relay-budget exceeded"
    )

    if dead_since_start is not None:
        dead = np.asarray(dead_since_start, bool)
        assert (have[dead] == 0).all(), (
            "dead-nodes-inert: a node down since round 0 holds data"
        )
