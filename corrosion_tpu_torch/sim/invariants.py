"""The sim's invariant catalog — the port of ``corrosion_tpu/sim/
invariants.py``: `check_state`, always-properties over a state snapshot
evaluated between rounds by the checked fault driver
(`.faults.run_fault_plan_checked`) and by tests, and the delivery-order
count `order_violation_count`, which also runs on the card every round
of an ordering-variant run.

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
- **delivery-order agreement** (ordering variants) — every node's
  touched versions per origin form a gapless prefix: no node holds
  version v without having completely delivered v - 1 from the same
  origin.  Counted on the card inside the round loops
  (`count_order_violations_`, K22, added to
  ``RunMetrics.order_violations`` with no host read): an enforced
  ``ordering="fifo"`` run ends at 0, the ``fifo-unchecked`` control
  trips it; and asserted on snapshots by `check_state` under "fifo"
  when given the payloads' ``meta``.

The snapshot is host numpy (`convert.state_to_numpy`, JAX's layout and
dtypes); the version grids come from the port's own helpers on CPU
tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..convert import state_to_numpy
from ..kernels.build import check
from .gaps import gaps_to_mask
from .state import (
    PayloadMeta,
    SimConfig,
    SimState,
    complete_versions,
    touched_versions,
    version_heads,
)


def order_violation_count(touched: torch.Tensor, comp: torch.Tensor,
                          meta: PayloadMeta, cfg: SimConfig) -> torch.Tensor:
    """i32 scalar: (node, origin, version) triples violating FIFO
    delivery — version v touched while v - 1 from the same origin is not
    completely held — over the [N, A, V] grids ``touched`` and ``comp``;
    the origin's own row (``meta.actor[a * C]``) is exempt (JAX
    ``order_violation_count``).  The plain version of K22."""
    from ..proto.ordering import prev_complete

    viol = touched & ~prev_complete(comp)
    n = touched.shape[0]
    dev = touched.device
    a_idx = torch.arange(cfg.n_writers, device=dev)
    origin = meta.actor[a_idx * cfg.chunks_per_version]
    not_origin = torch.arange(n, dtype=torch.int32,
                              device=dev)[:, None] != origin[None, :]
    return (viol & not_origin[:, :, None]).sum(dtype=torch.int32)


def _grids(have: torch.Tensor, cfg: SimConfig):
    """(touched, comp) [N, A, V] of the dense u8 ``have`` or of packed
    words (int32 [N, W], W * 32 == P)."""
    if have.dtype == torch.uint8:
        return touched_versions(have, cfg), complete_versions(have, cfg)
    from .words import group_grid

    return group_grid(have, cfg, "any"), group_grid(have, cfg, "all")


def count_order_violations_(acc: torch.Tensor, have: torch.Tensor,
                            meta: PayloadMeta, cfg: SimConfig) -> None:
    """Add this round's `order_violation_count` of ``have`` — the dense
    u8 [N, P] or the packed words [N, W] — to the i32 scalar ``acc``
    (``RunMetrics.order_violations``) in place: a standing count, summed
    every round.  K22 on the card (its word entry or its u8 entry), one
    launch, no host read."""
    if have.device.type == "cpu":
        acc += order_violation_count(*_grids(have, cfg), meta, cfg)
        return
    n = have.shape[0]
    a, c = cfg.n_writers, cfg.chunks_per_version
    check("order_violations", acc, torch.int32, ())
    check("meta.actor", meta.actor, torch.int32, (cfg.n_payloads,))
    if have.dtype == torch.uint8:
        check("have", have, torch.uint8, (n, cfg.n_payloads))
        kernels.ORDER_CHECK_DENSE.launch([have, meta.actor, acc],
                                         [n, cfg.n_payloads, a, c])
        return
    w = have.shape[1]
    check("have", have, torch.int32, (n, w))
    kernels.ORDER_CHECK_WORDS.launch([have, meta.actor, acc], [n, w, a, c])


def count_order_violations_lanes_plain(acc: torch.Tensor,
                                       have: torch.Tensor,
                                       meta: PayloadMeta,
                                       cfg: SimConfig) -> None:
    """Plain version of K22's lane entries: the solo count of each lane's
    rows (dense u8 or packed words) added to its slot ``acc[k]``, in
    place."""
    for k in range(have.shape[0]):
        acc[k] += order_violation_count(*_grids(have[k], cfg), meta, cfg)


def count_order_violations_lanes_(acc: torch.Tensor, have: torch.Tensor,
                                  meta: PayloadMeta, cfg: SimConfig) -> None:
    """`count_order_violations_` over a seed ensemble's lanes: the count
    of each lane's rows ``have`` — the dense u8 [K, N, P] (B16v) or the
    packed words [K, N, W] (B16m) — added to its own slot of ``acc``
    (i32[K], the lanes' ``RunMetrics.order_violations``), in place, no
    host read.  K22's u8 or words lane entry on the card (one count a
    lane)."""
    if have.device.type == "cpu":
        count_order_violations_lanes_plain(acc, have, meta, cfg)
        return
    lanes, n, p = have.shape
    check("order_violations", acc, torch.int32, (lanes,))
    check("meta.actor", meta.actor, torch.int32, (cfg.n_payloads,))
    if have.dtype == torch.uint8:
        check("have", have, torch.uint8, (lanes, n, cfg.n_payloads))
        kernel = kernels.ORDER_CHECK_DENSE_LANES
    else:
        check("have", have, torch.int32, (lanes, n, cfg.n_payloads // 32))
        kernel = kernels.ORDER_CHECK_WORDS_LANES
    kernel.launch([have, meta.actor, acc],
                  [n, p, cfg.n_writers, cfg.chunks_per_version, lanes])


def check_state(
    state: SimState,
    cfg: SimConfig,
    dead_since_start: Optional[np.ndarray] = None,
    meta: Optional[PayloadMeta] = None,
) -> None:
    """Assert the always-properties on a snapshot of ``state``; raises
    AssertionError naming the violated property, in JAX's words.
    ``meta`` arms the delivery-order check under ``ordering="fifo"``
    (the snapshot twin of the on-card count)."""
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

    if meta is not None and cfg.ordering == "fifo":
        have_t = torch.from_numpy(have)
        meta_cpu = PayloadMeta(*(x.cpu() for x in meta))
        viol = int(order_violation_count(
            touched_t, complete_versions(have_t, cfg), meta_cpu, cfg))
        assert viol == 0, (
            f"delivery-order: {viol} (node, origin, version) triples "
            "hold a version whose predecessor was never delivered"
        )
