"""Flight recorder: per-round telemetry of both rounds, and the
membership-churn driver `run_membership_detect` with its detect
predicates (K23) — the port of ``corrosion_tpu/sim/telemetry.py``
without ``trace_to_registry`` (ROADMAP A7).

`RoundTrace` holds JAX's sixteen channels, preallocated ``[R, ·]``
device buffers written row by row inside the run loop: ``coverage`` and
``delivered`` i32[R, P], ``up_nodes``, the broadcast wire
(``bcast_bytes`` f32, ``bcast_frames``, ``bcast_dropped``,
``bcast_cut``), the sync sessions (``sync_bytes`` f32, ``sync_frames``,
``sync_sessions``, ``sync_refused``), the fault seam (``crashes``,
``wipes``), the SWIM beliefs (``swim_suspect``, ``swim_down``) and
``gap_overflow``.  With ``cfg.trace_every`` > 1 row t // every holds
sample round t and the extra last row absorbs the other rounds
(`trace_row`).

**How a row is made.**  JAX computes each channel where its tensors
live and writes the row with one indexed update per channel.  The port
accumulates instead, in two more buffers of the trace: ``acc``, int64
totals named by `ACC`, and ``counts`` i32[3, P], the per-payload
coverage, delivered and grant counts.  The round's kernels add their
parts as they run — K18 the broadcast's frames and bytes, K10 or K12
the frames the loss ate, K9 the cut edges and refused sessions, K17 or
K13 the grant counts, K17 coverage and delivered — and K19 (`record_row`)
reduces the rest (up nodes, SWIM beliefs, crashes, wipes, sessions),
folds the grants, writes the whole row and zeroes both buffers for the
next round.  Recording reads nothing back to the host: the row index is
a host int, like the round counter.  A run without a trace launches
none of this and takes exactly the path it took before.

**The f32 channels** are the exact int64 byte totals rounded once to
f32 (`.fused`); JAX sums f32 terms, so the two agree within m·2⁻²⁴ of
the total for m terms, and every integer channel is exact.

The host exporters (`trace_host`, `coverage_curve_digest`,
`coverage_latency_rounds`, `trace_summary`, `trace_rows`,
`write_flight_jsonl`) are the port's own copies of JAX's, numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels.build import check
from .fused import (
    fold_over_edges,
    grant_fold,
    word_bit_counts,
    word_send_stats,
)
from .state import ALIVE, DOWN, SUSPECT, SimConfig

#: the int64 accumulator slots of `RoundTrace.acc`, in K19's order: the
#: round's kernels add the first five, K19 the next six and its ticket
ACC = (
    "bcast_frames", "bcast_bytes", "bcast_dropped", "bcast_cut",
    "sync_refused", "up_nodes", "swim_suspect", "swim_down", "crashes",
    "wipes", "sync_sessions", "ticket",
)
_SLOT = {name: i for i, name in enumerate(ACC)}
#: the broadcast's frames and bytes, the slots K18 adds into
WIRE = slice(0, 2)
#: the rows of `RoundTrace.counts`
COVERAGE, DELIVERED, GRANTS = 0, 1, 2


class WireTel(NamedTuple):
    """One round's broadcast-wire telemetry: payload frames and bytes
    transmitted on live edges (lost frames included), the frames the
    wire's loss ate, the edges the fault plan's cuts severed."""

    frames: torch.Tensor  # i32
    bytes: torch.Tensor  # f32
    dropped: torch.Tensor  # i32
    cut: torch.Tensor  # i32


class SyncTel(NamedTuple):
    """One round's sync-session telemetry."""

    sessions: torch.Tensor  # i32 due sessions established
    refused: torch.Tensor  # i32 sessions refused by fault cuts
    frames: torch.Tensor  # i32 chunk frames granted
    bytes: torch.Tensor  # f32 bytes granted


class RoundTrace(NamedTuple):
    """Preallocated per-round telemetry buffers: JAX's sixteen channels
    (`CHANNELS`), then the round's accumulators (see the module doc)."""

    coverage: torch.Tensor  # i32[R, P]
    delivered: torch.Tensor  # i32[R, P]
    up_nodes: torch.Tensor  # i32[R]
    bcast_bytes: torch.Tensor  # f32[R]
    bcast_frames: torch.Tensor  # i32[R]
    bcast_dropped: torch.Tensor  # i32[R]
    bcast_cut: torch.Tensor  # i32[R]
    sync_bytes: torch.Tensor  # f32[R]
    sync_frames: torch.Tensor  # i32[R]
    sync_sessions: torch.Tensor  # i32[R]
    sync_refused: torch.Tensor  # i32[R]
    swim_suspect: torch.Tensor  # i32[R]
    swim_down: torch.Tensor  # i32[R]
    crashes: torch.Tensor  # i32[R]
    wipes: torch.Tensor  # i32[R]
    gap_overflow: torch.Tensor  # i32[R]
    acc: torch.Tensor  # int64[len(ACC)]
    counts: torch.Tensor  # i32[3, P]


CHANNELS = RoundTrace._fields[:16]
_F32 = ("bcast_bytes", "sync_bytes")


def trace_rows_for(max_rounds: int, every: int = 1) -> int:
    """Sampled rows a decimated trace holds for ``max_rounds`` executed
    rounds: the rounds t with t % every == 0 in [0, max_rounds)."""
    return -(-int(max_rounds) // max(int(every), 1))


def trace_row(trace: RoundTrace, t: int, every: int) -> int:
    """Buffer row of round ``t`` (a host int) under a ``trace_every``
    stride: t // every on a sample round, else the scratch row (the last
    row `new_trace` allocates when every > 1), which no exporter reads."""
    if every <= 1:
        return t
    return t // every if t % every == 0 else trace.up_nodes.shape[0] - 1


def new_trace(cfg: SimConfig, max_rounds: int, device) -> RoundTrace:
    """Zeroed trace buffers: ``max_rounds`` rows, or with
    ``cfg.trace_every`` > 1 one row per sample round plus the scratch
    row."""
    every = max(int(cfg.trace_every), 1)
    r = max_rounds if every == 1 else trace_rows_for(max_rounds, every) + 1
    p = cfg.n_payloads
    chans = {
        name: torch.zeros(
            (r, p) if name in ("coverage", "delivered") else (r,),
            dtype=torch.float32 if name in _F32 else torch.int32,
            device=device,
        )
        for name in CHANNELS
    }
    return RoundTrace(
        **chans,
        acc=torch.zeros(len(ACC), dtype=torch.int64, device=device),
        counts=torch.zeros((3, p), dtype=torch.int32, device=device),
    )


def acc_slot(trace: RoundTrace, name: str) -> torch.Tensor:
    """The 0-d view of accumulator ``name`` that a phase adds into."""
    return trace.acc[_SLOT[name]]


def wire_loss_active(topo, faults) -> bool:
    """Can the broadcast wire drop frames in this scenario: the flat
    topology loss, tiered topology loss (some applicable tier differs,
    so one is nonzero), or a fault plan with loss (a matrix slice's
    ``loss`` slab, or loss factors)."""
    from .topology import loss_tiered

    if int(round(topo.loss * 256.0)) > 0 or loss_tiered(topo):
        return True
    if faults is None:
        return False
    from .faults import RoundFaults

    if isinstance(faults, RoundFaults):
        return faults.loss is not None
    return faults.loss_thr.shape[0] > 0


def swim_belief_counts(state, cfg: SimConfig):
    """(suspect, down) i32 belief totals of either SWIM tier."""
    if cfg.swim_full_view:
        return ((state.view == SUSPECT).sum(dtype=torch.int32),
                (state.view == DOWN).sum(dtype=torch.int32))
    if cfg.swim_partial_view:
        valid = state.pid >= 0
        st = state.pkey & 3
        return ((valid & (st == SUSPECT)).sum(dtype=torch.int32),
                (valid & (st == DOWN)).sum(dtype=torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=state.alive.device)
    return zero, zero.clone()


def record_round(
    trace: RoundTrace, row: int, *, coverage, delivered, up_nodes,
    wire: WireTel, sync: SyncTel, swim_suspect, swim_down, gap_overflow,
) -> RoundTrace:
    """Write one row of every round channel, in place (JAX
    ``record_round``; crashes and wipes are `record_node_faults`')."""
    trace.coverage[row] = coverage
    trace.delivered[row] = delivered
    trace.up_nodes[row] = up_nodes
    trace.bcast_bytes[row] = wire.bytes
    trace.bcast_frames[row] = wire.frames
    trace.bcast_dropped[row] = wire.dropped
    trace.bcast_cut[row] = wire.cut
    trace.sync_bytes[row] = sync.bytes
    trace.sync_frames[row] = sync.frames
    trace.sync_sessions[row] = sync.sessions
    trace.sync_refused[row] = sync.refused
    trace.swim_suspect[row] = swim_suspect
    trace.swim_down[row] = swim_down
    trace.gap_overflow[row] = gap_overflow
    return trace


def record_node_faults(trace: RoundTrace, row: int, rf) -> RoundTrace:
    """The fault seam's node channels of one row, in place: nodes the
    schedule holds DOWN and wipes fired (JAX ``record_node_faults``)."""
    trace.crashes[row] = (rf.alive == DOWN).sum(dtype=torch.int32)
    trace.wipes[row] = rf.wipe.sum(dtype=torch.int32)
    return trace


# -- K17: per-payload counts -------------------------------------------------


def word_coverage_delivered(
    held_w: torch.Tensor, held0_w: torch.Tensor, up: torch.Tensor,
    n_payloads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coverage, delivered) i32[P] from payload words at round end
    (``held_w``) and start (``held0_w``): bits held by up nodes, and
    bits newly held this round.  Plain version of K17's coverage
    entry."""
    return (
        word_bit_counts(torch.where(up[:, None], held_w, 0), n_payloads),
        word_bit_counts(held_w & ~held0_w, n_payloads),
    )


def count_words_(out: torch.Tensor, words: torch.Tensor) -> None:
    """Add the per-payload bit counts of ``words`` [R, W] to ``out``
    i32[W * 32] in place (the sync grant counts).  K17 on the card."""
    if words.device.type == "cpu":
        out += word_bit_counts(words, out.shape[0])
        return
    rows, w = words.shape
    check("words", words, torch.int32, (rows, w))
    check("out", out, torch.int32, (w * 32,))
    kernels.TRACE_COUNTS.launch([words, out], [rows, w])


def coverage_delivered_(out: torch.Tensor, have_w: torch.Tensor,
                        have0_w: torch.Tensor, alive: torch.Tensor) -> None:
    """Add coverage and delivered counts of the packed round to ``out``
    i32[2, P] in place (`word_coverage_delivered`).  K17 on the card."""
    if have_w.device.type == "cpu":
        cov, dlv = word_coverage_delivered(have_w, have0_w, alive == ALIVE,
                                           out.shape[1])
        out[0] += cov
        out[1] += dlv
        return
    n, w = have_w.shape
    check("have_w", have_w, torch.int32, (n, w))
    check("have0_w", have0_w, torch.int32, (n, w))
    check("alive", alive, torch.uint8, (n,))
    check("out", out, torch.int32, (2, w * 32))
    kernels.TRACE_COVERAGE.launch([have_w, have0_w, alive, out[0], out[1]],
                                  [n, w])


def coverage_delivered_dense_plain(
    have: torch.Tensor, have0: torch.Tensor, alive: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K17's dense entry: (coverage, delivered) i32[P]
    from u8 ``have`` and ``have0`` [N, P]."""
    held = have > 0
    return ((held & (alive == ALIVE)[:, None]).sum(dim=0, dtype=torch.int32),
            (held & (have0 == 0)).sum(dim=0, dtype=torch.int32))


def coverage_delivered_dense_(out: torch.Tensor, have: torch.Tensor,
                              have0: torch.Tensor,
                              alive: torch.Tensor) -> None:
    """The dense round's coverage and delivered counts from u8 ``have``
    and ``have0`` [N, P], added to ``out`` i32[2, P] in place — the same
    integers as the word form.  K17's dense entry on the card."""
    if have.device.type == "cpu":
        cov, dlv = coverage_delivered_dense_plain(have, have0, alive)
        out[0] += cov
        out[1] += dlv
        return
    n, p = have.shape
    check("have", have, torch.uint8, (n, p))
    check("have0", have0, torch.uint8, (n, p))
    check("alive", alive, torch.uint8, (n,))
    check("out", out, torch.int32, (2, p))
    kernels.TRACE_COVERAGE_DENSE.launch([have, have0, alive, out[0], out[1]],
                                        [n, p])


# -- K18: the broadcast wire's frames and bytes ------------------------------


def wire_words_plain(sending: torch.Tensor, nbytes: torch.Tensor,
                     ok: torch.Tensor, fanout: int):
    """Plain version of K18: (frames, bytes) int64 that the packed
    broadcast's ``sending`` words [N, W] put on the ok edges ``ok``
    [N * fanout]."""
    frames, byte_tot = word_send_stats(sending, nbytes)
    return fold_over_edges(frames, byte_tot, ok, fanout)


def wire_words_(acc: torch.Tensor, sending: torch.Tensor,
                nbytes: torch.Tensor, ok: torch.Tensor, fanout: int) -> None:
    """Add `wire_words_plain`'s frames and bytes to ``acc`` int64[2] in
    place (a trace's ``acc[WIRE]``).  K18 on the card."""
    if sending.device.type == "cpu":
        f, b = wire_words_plain(sending, nbytes, ok, fanout)
        acc[0] += f
        acc[1] += b
        return
    n, w = sending.shape
    check("acc", acc, torch.int64, (2,))
    check("sending", sending, torch.int32, (n, w))
    check("nbytes", nbytes, torch.int32, (w * 32,))
    check("ok", ok, torch.bool, (n * fanout,))
    kernels.TRACE_WIRE_WORDS.launch([sending, nbytes, ok, acc], [n, w, fanout])


def wire_rows_(acc: torch.Tensor, row_frames: torch.Tensor,
               row_bytes: torch.Tensor, ok: torch.Tensor, fanout: int) -> None:
    """Add the dense broadcast's per-node frames and bytes i32[N] (K12's
    telemetry outputs), folded over the ok edges (`.fused.fold_over_edges`
    is the plain version), to ``acc`` int64[2] in place.  K18's rows
    entry on the card."""
    if row_frames.device.type == "cpu":
        f, b = fold_over_edges(row_frames, row_bytes, ok, fanout)
        acc[0] += f
        acc[1] += b
        return
    n = row_frames.shape[0]
    check("acc", acc, torch.int64, (2,))
    check("row_frames", row_frames, torch.int32, (n,))
    check("row_bytes", row_bytes, torch.int32, (n,))
    check("ok", ok, torch.bool, (n * fanout,))
    kernels.TRACE_WIRE_ROWS.launch([row_frames, row_bytes, ok, acc],
                                   [n, fanout])


def pull_fold(frames: torch.Tensor, byte_tot: torch.Tensor,
              ok_pull: torch.Tensor, dst: torch.Tensor):
    """(frames, bytes) int64 of the responders' per-node totals [N] over
    the ok_pull edges: edge e carries node dst[e]'s (JAX's pull fold,
    ``packed.py:584-607``, ``broadcast.py:285-305``)."""
    rows = dst.long()
    return (torch.where(ok_pull, frames.to(torch.int64)[rows], 0).sum(),
            torch.where(ok_pull, byte_tot.to(torch.int64)[rows], 0).sum())


def wire_words_pull_(acc: torch.Tensor, sending: torch.Tensor,
                     nbytes: torch.Tensor, ok_pull: torch.Tensor,
                     dst: torch.Tensor) -> None:
    """Add the push-pull responses' frames and bytes — each ok_pull edge
    e carries the responder dst[e]'s sending words — to ``acc`` int64[2]
    in place (a trace's ``acc[WIRE]``, beside the push's).  K18's pull
    entry on the card."""
    if sending.device.type == "cpu":
        f, b = pull_fold(*word_send_stats(sending, nbytes), ok_pull, dst)
        acc[0] += f
        acc[1] += b
        return
    n, w = sending.shape
    e = dst.shape[0]
    check("acc", acc, torch.int64, (2,))
    check("sending", sending, torch.int32, (n, w))
    check("nbytes", nbytes, torch.int32, (w * 32,))
    check("ok_pull", ok_pull, torch.bool, (e,))
    check("dst", dst, torch.int32, (e,))
    kernels.TRACE_WIRE_WORDS_PULL.launch([sending, nbytes, ok_pull, dst, acc],
                                         [e, w])


def wire_rows_pull_(acc: torch.Tensor, row_frames: torch.Tensor,
                    row_bytes: torch.Tensor, ok_pull: torch.Tensor,
                    dst: torch.Tensor) -> None:
    """The dense twin of `wire_words_pull_` from the dense broadcast's
    per-node frames and bytes i32[N] (K12's telemetry outputs).  K18's
    rows pull entry on the card."""
    if row_frames.device.type == "cpu":
        f, b = pull_fold(row_frames, row_bytes, ok_pull, dst)
        acc[0] += f
        acc[1] += b
        return
    n = row_frames.shape[0]
    e = dst.shape[0]
    check("acc", acc, torch.int64, (2,))
    check("row_frames", row_frames, torch.int32, (n,))
    check("row_bytes", row_bytes, torch.int32, (n,))
    check("ok_pull", ok_pull, torch.bool, (e,))
    check("dst", dst, torch.int32, (e,))
    kernels.TRACE_WIRE_ROWS_PULL.launch(
        [row_frames, row_bytes, ok_pull, dst, acc], [e])


# -- K19: the row ------------------------------------------------------------


def record_row_plain(trace: RoundTrace, row: int, *, alive, state,
                     cfg: SimConfig, rf, sync_ok, n_overflow,
                     nbytes) -> RoundTrace:
    """Plain version of K19."""
    acc, counts = trace.acc, trace.counts
    frames, byte_tot = grant_fold(counts[GRANTS], nbytes)
    susp, dn = swim_belief_counts(state, cfg)
    wire = WireTel(
        frames=acc[_SLOT["bcast_frames"]].to(torch.int32),
        bytes=acc[_SLOT["bcast_bytes"]].to(torch.float32),
        dropped=acc[_SLOT["bcast_dropped"]].to(torch.int32),
        cut=acc[_SLOT["bcast_cut"]].to(torch.int32),
    )
    sync = SyncTel(
        sessions=sync_ok.sum(dtype=torch.int32),
        refused=acc[_SLOT["sync_refused"]].to(torch.int32),
        frames=frames,
        bytes=byte_tot,
    )
    record_round(
        trace, row, coverage=counts[COVERAGE], delivered=counts[DELIVERED],
        up_nodes=(alive == ALIVE).sum(dtype=torch.int32), wire=wire,
        sync=sync, swim_suspect=susp, swim_down=dn, gap_overflow=n_overflow,
    )
    if rf is not None:
        record_node_faults(trace, row, rf)
    else:
        trace.crashes[row] = 0
        trace.wipes[row] = 0
    acc.zero_()
    counts.zero_()
    return trace


def record_row(trace: RoundTrace, row: int, *, alive, state, cfg: SimConfig,
               rf, sync_ok, n_overflow, nbytes) -> RoundTrace:
    """Write round row ``row`` of every channel from what the round's
    kernels accumulated and the end-of-round state — up nodes of
    ``alive``, the SWIM beliefs of ``state``, the fault slice ``rf``'s
    crashes and wipes (None: 0), the sessions of the sync edges'
    ``sync_ok``, the gap refresh's ``n_overflow`` — with the grant fold
    over ``nbytes``; then zero the accumulators.  K19 on the card."""
    if alive.device.type == "cpu":
        return record_row_plain(trace, row, alive=alive, state=state, cfg=cfg,
                                rf=rf, sync_ok=sync_ok, n_overflow=n_overflow,
                                nbytes=nbytes)
    n = alive.shape[0]
    p = cfg.n_payloads
    check("alive", alive, torch.uint8, (n,))
    pid = pkey = view = None
    swim, cells = 0, 0
    if cfg.swim_full_view:
        swim, cells, view = 2, n * n, state.view
        check("view", view, torch.int8, (n, n))
    elif cfg.swim_partial_view:
        swim, pid, pkey = 1, state.pid, state.pkey
        cells = pid.numel()
        check("pid", pid, torch.int32, tuple(pid.shape))
        check("pkey", pkey, torch.int32, tuple(pid.shape))
    rf_alive = rf_wipe = None
    if rf is not None:
        rf_alive, rf_wipe = rf.alive, rf.wipe
        check("rf.alive", rf_alive, torch.int8, (n,))
        check("rf.wipe", rf_wipe, torch.bool, (n,))
    check("sync_ok", sync_ok, torch.bool, (sync_ok.numel(),))
    check("n_overflow", n_overflow, torch.int32, ())
    check("nbytes", nbytes, torch.int32, (p,))
    check("acc", trace.acc, torch.int64, (len(ACC),))
    check("counts", trace.counts, torch.int32, (3, p))
    if not 0 <= row < trace.up_nodes.shape[0]:
        raise ValueError(f"trace row {row} is outside the trace")
    for name in CHANNELS:
        t = getattr(trace, name)
        check(name, t, torch.float32 if name in _F32 else torch.int32,
              tuple(t.shape))
    kernels.TRACE_ROW.launch(
        [alive, pid, pkey, view, rf_alive, rf_wipe, sync_ok, n_overflow,
         nbytes, trace.acc, trace.counts,
         *(getattr(trace, name) for name in CHANNELS)],
        [n, cells, swim, sync_ok.numel(), p, row],
    )
    return trace


# -- the membership-churn driver (runner configs #2/#2b) ---------------------


def new_detect(device) -> torch.Tensor:
    """The detect loop's device word: i32[3], ``detect_round`` (-1 until
    the predicate holds) then K23's two scratch words, which it keeps at
    0 between launches."""
    return torch.tensor([-1, 0, 0], dtype=torch.int32, device=device)


def detect_full_plain(detect: torch.Tensor, view: torch.Tensor,
                      up: torch.Tensor, t: int) -> torch.Tensor:
    """Plain version of K23's full entry, in place on ``detect[0]``."""
    watched = up[:, None] & ~up[None, :]
    held = ((view == DOWN) | ~watched).all()
    detect[0] = torch.where((detect[0] < 0) & held, t, detect[0])
    return detect


def detect_partial_plain(detect: torch.Tensor, pid: torch.Tensor,
                         pkey: torch.Tensor, up: torch.Tensor,
                         t: int) -> torch.Tensor:
    """Plain version of K23's partial entry, in place on ``detect[0]``;
    ``pkey & 3`` is JAX's ``pkey % 4`` for every i32."""
    watched = up[:, None] & (pid >= 0) & ~up[pid.clamp(min=0).long()]
    held = (((pkey & 3) == DOWN) | ~watched).all()
    detect[0] = torch.where((detect[0] < 0) & held, t, detect[0])
    return detect


def _check_detect(detect: torch.Tensor, up: torch.Tensor, n: int) -> None:
    check("detect", detect, torch.int32, (3,))
    check("up", up, torch.bool, (n,))


def detect_full_(detect: torch.Tensor, view: torch.Tensor, up: torch.Tensor,
                 t: int) -> torch.Tensor:
    """Full-view detection after round ``t``, in place: ``detect[0]``
    becomes ``t`` when it is < 0 and every (up, dead) pair of ``view`` is
    believed DOWN.  K23's full entry on the card."""
    if view.device.type == "cpu":
        return detect_full_plain(detect, view, up, t)
    n = up.shape[0]
    _check_detect(detect, up, n)
    check("view", view, torch.int8, (n, n))
    kernels.DETECT_FULL.launch([view, up, detect], [n, t])
    return detect


def detect_partial_(detect: torch.Tensor, pid: torch.Tensor,
                    pkey: torch.Tensor, up: torch.Tensor,
                    t: int) -> torch.Tensor:
    """Partial-view detection after round ``t``, in place: ``detect[0]``
    becomes ``t`` when it is < 0 and every member-table entry of an up
    watcher that names a dead member is marked DOWN.  K23's partial entry
    on the card."""
    if pid.device.type == "cpu":
        return detect_partial_plain(detect, pid, pkey, up, t)
    n, m = pid.shape
    _check_detect(detect, up, n)
    check("pid", pid, torch.int32, (n, m))
    check("pkey", pkey, torch.int32, (n, m))
    kernels.DETECT_PARTIAL.launch([pid, pkey, up, detect], [n, m, t])
    return detect


def _detect_setup(state, cfg: SimConfig, topo, device):
    """Both detect loops' preamble: (the device, the region map), after
    JAX's refusal of a run without a SWIM tier and the port's of a state
    on another device than ``device``."""
    from ..device import resolve_device
    from .round import validate
    from .topology import regions

    dev = resolve_device(device)
    if state.have.device.type != dev.type:
        raise ValueError(f"the state lies on {state.have.device}, not {dev}")
    if not (cfg.swim_full_view or cfg.swim_partial_view):
        raise ValueError(
            "membership detection needs a SWIM tier "
            "(swim_full_view or swim_partial_view)"
        )
    validate(cfg, topo)
    return dev, regions(cfg.n_nodes, topo.n_regions, dev)


def run_membership_detect(state, meta, cfg: SimConfig, topo,
                          max_rounds: int = 400, telemetry: bool = False,
                          device="cuda"):
    """Membership-churn run (JAX ``run_membership_detect``): dense rounds
    until every survivor marks every dead node DOWN — full view: every
    (up, dead) pair; partial view: every member-table entry of an up
    watcher that names a dead member — or ``max_rounds``.  ``up`` is the
    state's at entry (the kill is pre-applied).  After each round K23
    sets the device word's ``detect_round`` to the round counter when the
    predicate first holds; the loop reads that one i32 a round.  Returns
    (state, metrics, detect_round[, trace]): ``detect_round`` a 0-d i32
    tensor, -1 if ``max_rounds`` passed first, and with ``telemetry`` the
    run's `RoundTrace`.  ``state`` must lie on ``device``."""
    from .round import new_metrics, own_state, round_step_

    dev, region = _detect_setup(state, cfg, topo, device)
    metrics = new_metrics(cfg, dev)
    up = state.alive == ALIVE
    state = own_state(state)
    detect = new_detect(dev)
    trace = new_trace(cfg, max_rounds, dev) if telemetry else None
    while int(state.t) < max_rounds and int(detect[0]) < 0:
        state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                        region, trace)
        if cfg.swim_full_view:
            detect_full_(detect, state.view, up, int(state.t))
        else:
            detect_partial_(detect, state.pid, state.pkey, up, int(state.t))
    out = (state, metrics, detect[0].clone())
    return out + (trace,) if telemetry else out


# -- the detect loop on lanes (seed ensembles, B16) ---------------------------


def new_detect_lanes(lanes: int, device) -> torch.Tensor:
    """The lane detect loop's device words: i32[K, 3], each lane's
    `new_detect` word."""
    return torch.tensor([[-1, 0, 0]] * lanes, dtype=torch.int32,
                        device=device)


def detect_full_lanes_plain(detect: torch.Tensor, view: torch.Tensor,
                            up: torch.Tensor, t: int) -> torch.Tensor:
    """Plain version of K23's full lane entry: the solo plain version on
    each lane's word, in place."""
    for k in range(detect.shape[0]):
        detect_full_plain(detect[k], view[k], up[k], t)
    return detect


def detect_partial_lanes_plain(detect: torch.Tensor, pid: torch.Tensor,
                               pkey: torch.Tensor, up: torch.Tensor,
                               t: int) -> torch.Tensor:
    """Plain version of K23's partial lane entry, in place."""
    for k in range(detect.shape[0]):
        detect_partial_plain(detect[k], pid[k], pkey[k], up[k], t)
    return detect


def _check_detect_lanes(detect: torch.Tensor, up: torch.Tensor, lanes: int,
                        n: int) -> None:
    check("detect", detect, torch.int32, (lanes, 3))
    check("up", up, torch.bool, (lanes, n))


def detect_full_lanes_(detect: torch.Tensor, view: torch.Tensor,
                       up: torch.Tensor, t: int) -> torch.Tensor:
    """`detect_full_` per lane, in place on ``detect`` [K, 3]: lane k's
    ``detect_round`` becomes ``t`` when it is < 0 and every (up, dead)
    pair of its ``view`` [K, N, N] is believed DOWN.  K23's full lane
    entry on the card: each lane's blocks vote into its own word."""
    if view.device.type == "cpu":
        return detect_full_lanes_plain(detect, view, up, t)
    lanes, n = up.shape
    _check_detect_lanes(detect, up, lanes, n)
    check("view", view, torch.int8, (lanes, n, n))
    kernels.DETECT_FULL_LANES.launch([view, up, detect], [n, t, lanes])
    return detect


def detect_partial_lanes_(detect: torch.Tensor, pid: torch.Tensor,
                          pkey: torch.Tensor, up: torch.Tensor,
                          t: int) -> torch.Tensor:
    """`detect_partial_` per lane, in place on ``detect`` [K, 3], over
    each lane's member tables [K, N, M].  K23's partial lane entry on
    the card."""
    if pid.device.type == "cpu":
        return detect_partial_lanes_plain(detect, pid, pkey, up, t)
    lanes, n, m = pid.shape
    _check_detect_lanes(detect, up, lanes, n)
    check("pid", pid, torch.int32, (lanes, n, m))
    check("pkey", pkey, torch.int32, (lanes, n, m))
    kernels.DETECT_PARTIAL_LANES.launch([pid, pkey, up, detect],
                                        [n, m, t, lanes])
    return detect


def run_membership_detect_lanes(states, meta, cfg: SimConfig, topo,
                                max_rounds: int = 400,
                                telemetry: bool = False, device="cuda"):
    """`run_membership_detect` over a seed ensemble's stacked states (the
    kill pre-applied, every field [K, ...]): the dense round's lanes
    (`.dense_lanes.dense_round_step_lanes`), then K23's lane entry on
    each lane's own ``up`` (its alive at entry); the loop reads the
    ``[K]`` detect rounds once a round, and a lane whose ``detect_round``
    became >= 0 leaves the batch with its state after that round, as
    JAX's select-frozen lane does; the rest run to ``max_rounds``.
    Returns (finals, metrics, detect_rounds i32[K]), -1 for a lane that
    never detected; the recorder on lanes is not ported."""
    from .dense_lanes import dense_round_step_lanes, lane_batch
    from .lanes import _run_batch, _stack_results, check_dense_lanes

    dev, region = _detect_setup(states, cfg, topo, device)
    check_dense_lanes(cfg, topo, telemetry=telemetry)
    lanes = states.alive.shape[0]
    batch = lane_batch(states, cfg)
    detect = new_detect_lanes(lanes, dev)
    batch = batch._replace(extra=(detect, batch.slim.alive == ALIVE))

    def step(batch):
        state, metrics, _ = dense_round_step_lanes(
            batch.slim, batch.metrics, meta, cfg, topo, region)
        detect, up = batch.extra
        t = int(state.t)
        if cfg.swim_full_view:
            detect_full_lanes_(detect, state.view, up, t)
        else:
            detect_partial_lanes_(detect, state.pid, state.pkey, up, t)
        return (batch._replace(slim=state, metrics=metrics),
                detect[:, 0] >= 0)

    finished = _run_batch(batch, max_rounds, detect[:, 0] >= 0, step)
    finals, metrics = _stack_results(finished, cfg)
    detect_rounds = torch.stack([extra[0][0] for *_, extra in finished])
    return finals, metrics, detect_rounds


# -- host-side exports -------------------------------------------------------


FLIGHT_VERSION = 1


def trace_host(trace, rounds: int, every: int = 1):
    """Host copies of every channel, sliced to the executed rounds
    (``every`` > 1: to the sampled rows, which excludes the scratch
    row).  A dict from an earlier call passes through, re-sliced."""
    r = trace_rows_for(rounds, every)
    if isinstance(trace, dict):
        return {f: v[:r] for f, v in trace.items()}
    return {f: getattr(trace, f).cpu().numpy()[:r] for f in CHANNELS}


def coverage_curve_digest(trace, rounds: int, every: int = 1) -> str:
    """Replay identity of the per-round per-payload coverage curve."""
    r = trace_rows_for(rounds, every)
    cov = (
        trace["coverage"][:r]
        if isinstance(trace, dict)
        else trace.coverage.cpu().numpy()[:r]
    )
    cov = np.ascontiguousarray(cov, np.int32)
    return hashlib.blake2b(cov.tobytes(), digest_size=8).hexdigest()


def trace_digest(trace, rounds: int, every: int = 1) -> str:
    """blake2b-8 over every channel's name and executed rows, in
    `CHANNELS` order (i32, and f32 for the byte channels): a whole trace
    held exactly, where every f32 byte total is exact on both sides (all
    payloads of one size, so JAX's f32 sums of multiples of it are)."""
    host = trace_host(trace, rounds, every)
    h = hashlib.blake2b(digest_size=8)
    for name in CHANNELS:
        h.update(name.encode())
        h.update(np.ascontiguousarray(host[name]).tobytes())
    return h.hexdigest()


def coverage_latency_rounds(
    trace, rounds: int, every: int = 1
) -> np.ndarray:
    """i32[P] first round each payload reached full coverage (held by
    every up node), -1 if never; decimated traces give the first sampled
    round."""
    t = trace_host(trace, rounds, every)
    full = (t["coverage"] == t["up_nodes"][:, None]) & (
        t["up_nodes"][:, None] > 0
    )  # [R, P]
    if full.shape[0] == 0:  # zero-round run: argmax chokes on an empty axis
        return np.full(full.shape[1], -1, np.int32)
    any_full = full.any(axis=0)
    first = full.argmax(axis=0) * every
    return np.where(any_full, first, -1).astype(np.int32)


def trace_summary(trace, rounds: int, cfg: SimConfig) -> dict:
    """Deterministic per-run summary block: coverage-curve digest,
    coverage-latency percentiles, bytes and frames on the wire, fault
    and SWIM totals; ``cfg.trace_every`` > 1 summarizes the sampled
    rows and says so."""
    r = int(rounds)
    every = max(int(cfg.trace_every), 1)
    t = trace_host(trace, r, every)
    lat = coverage_latency_rounds(t, r, every)
    covered = lat[lat >= 0]

    def pct(q):
        if covered.size == 0:
            return None
        return float(np.percentile(covered, q, method="lower"))

    bcast = float(t["bcast_bytes"].sum())
    sync = float(t["sync_bytes"].sum())
    sampled = trace_rows_for(r, every)
    out = {
        "rounds": r,
        "coverage_curve_digest": coverage_curve_digest(t, r),
        "coverage_latency_rounds": {
            "p50": pct(50), "p95": pct(95), "p99": pct(99),
            "uncovered_payloads": int((lat < 0).sum()),
        },
        "wire_bytes": {
            "broadcast": round(bcast, 1),
            "sync": round(sync, 1),
            "per_round_mean": round((bcast + sync) / max(sampled, 1), 1),
        },
        "wire_frames": {
            "broadcast": int(t["bcast_frames"].sum()),
            "sync": int(t["sync_frames"].sum()),
        },
        "fault": {
            "dropped_frames": int(t["bcast_dropped"].sum()),
            "cut_edges": int(t["bcast_cut"].sum()),
            "refused_sessions": int(t["sync_refused"].sum()),
            "crash_node_rounds": int(t["crashes"].sum()),
            "wipes": int(t["wipes"].sum()),
        },
        "sync_sessions": int(t["sync_sessions"].sum()),
        "swim": {
            "peak_suspect": int(t["swim_suspect"].max(initial=0)),
            "peak_down": int(t["swim_down"].max(initial=0)),
        },
        "gap_overflow_rounds": int((t["gap_overflow"] > 0).sum()),
    }
    if every > 1:
        out["trace_every"] = every
    return out


def trace_rows(trace, rounds: int, cfg: SimConfig, per_payload: bool = None):
    """Per-round dict rows for the flight-recorder JSONL (sampled rows
    when ``cfg.trace_every`` > 1, each with the round ``t`` it
    recorded); ``per_payload`` adds the coverage vector (default: P ≤
    256)."""
    every = max(int(cfg.trace_every), 1)
    t = trace_host(trace, rounds, every)
    r = trace_rows_for(rounds, every)
    if per_payload is None:
        per_payload = cfg.n_payloads <= 256
    rows = []
    for i in range(r):
        up = int(t["up_nodes"][i])
        cov = t["coverage"][i]
        row = {
            "t": i * every,
            "up_nodes": up,
            "coverage_frac": round(
                float(cov.sum()) / max(up * cfg.n_payloads, 1), 6
            ),
            "delivered": int(t["delivered"][i].sum()),
            "bcast_bytes": round(float(t["bcast_bytes"][i]), 1),
            "bcast_frames": int(t["bcast_frames"][i]),
            "bcast_dropped": int(t["bcast_dropped"][i]),
            "bcast_cut": int(t["bcast_cut"][i]),
            "sync_bytes": round(float(t["sync_bytes"][i]), 1),
            "sync_frames": int(t["sync_frames"][i]),
            "sync_sessions": int(t["sync_sessions"][i]),
            "sync_refused": int(t["sync_refused"][i]),
            "swim_suspect": int(t["swim_suspect"][i]),
            "swim_down": int(t["swim_down"][i]),
            "crashes": int(t["crashes"][i]),
            "wipes": int(t["wipes"][i]),
            "gap_overflow": int(t["gap_overflow"][i]),
        }
        if per_payload:
            row["coverage"] = [int(c) for c in cov]
        rows.append(row)
    return rows


def write_flight_jsonl(
    path: str,
    trace,
    rounds: int,
    cfg: SimConfig,
    header: Optional[dict] = None,
    per_payload: bool = None,
) -> None:
    """The flight-recorder artifact: a header line (shape, summary, the
    caller's context), then one JSON line per recorded round; written to
    a temporary file and moved into place."""
    t = trace_host(trace, rounds, max(int(cfg.trace_every), 1))
    head = {
        "kind": "flight_recorder",
        "version": FLIGHT_VERSION,
        "n_nodes": cfg.n_nodes,
        "n_payloads": cfg.n_payloads,
        "rounds": int(rounds),
        "summary": trace_summary(t, rounds, cfg),
    }
    if cfg.trace_every > 1:
        head["trace_every"] = int(cfg.trace_every)
    if header:
        head.update(header)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(head, sort_keys=True, default=float) + "\n")
        for row in trace_rows(t, rounds, cfg, per_payload=per_payload):
            f.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, path)
