"""Seed ensembles on the packed round: K lanes of one configuration as
one lane-batched program — the port of ``jax.vmap`` over
``corrosion_tpu/sim/packed.py:911 run_packed`` and ``:1027
run_packed_faults`` as ``corrosion_tpu/campaign/ensemble.py:114
run_ensemble`` applies it (B16, packed half).

Every per-node tensor of the state and the carry gets a leading lane
axis: ``have [K, N, W]``, the rings ``[K, D, N, W]``, the member tables
``[K, N, M]``, the keys ``[K, 2]``; the payload metadata and a fault
plan's schedule are shared, and only the plan's seed is batched
(``seeds`` i32[K], `campaign.ensemble.lane_plan_seeds`).  Node ids stay
lane-local.  Every phase runs all live lanes at once: the draws are K5's
lane entry (`.rng`), the sampler and the merge K1's and K4's
(`.pswim`), the word phases K8's, the ring scatter K2's, K10's or K10j's,
the pull K3's (its delay entry under session delays, K3m's under the
sync budget), the gap refresh
K6's (`.gaps`), the record K7's (one done flag a lane), the node faults
K11's and the probe reach K9's lane entry (`.faults`); K9's edge queries
(its latency entry too) take the lanes folded into their edge axis.
Each wrapper runs its plain torch version on a CPU tensor.

**Freezing finished lanes.**  All lanes start at t = 0 and share
``max_rounds``, so every live lane is at the same t and the host keeps
one t.  JAX freezes a finished lane by select inside the batched
while_loop; here the loop reads the ``[K]`` done flags once a round (as
the solo loop reads one), writes a finished lane's slices out — its
carry after that round, which is what JAX's frozen carry holds — and
keeps the live lanes by ``index_select``.  That happens at most K − 1
times a run and is exact: no other lane's tensors change, and every
draw of a live lane depends on its own key alone.

**Latency plans** (B16l): under a plan with delay factors each edge's
fixed delay adds to its slot and each session's delay sends its grants
to a later slot of the sync ring (K9's latency entry on the lanes
folded; K3's delay lane entry), and in a round with jitter each surviving
payload of a jittered edge lands in its own slot (K10j's lane entry, each
lane under its phase key and plan seed).  The host's copy of the plan's
loss and jitter activity picks each round's scatter, as the solo round's
does, so a round with neither runs K2's lane entry.

**The flight recorder** (B16r, packed half): with ``telemetry`` the loop
carries a lane trace (`.telemetry.new_trace_lanes`) in the batch's
``extra``, so a finished lane leaves with its trace, as JAX's
select-frozen lane does.  Each round records every lane's row as the solo
packed round records its own: the cut edges and refused sessions (K9's
lane-strided counts), the frames and bytes each lane sends over its ok
edges (K18's words lane entry), the frames its loss ate (the recording
forms of K10's and K10j's lane entries), its grant counts (the recording
forms of K3's lane entries, then K17's grant lane entry), coverage and
delivered (K17's coverage lane entry), and K19's lane entry writes the
rows.

**Metered budgets** (B16m's budgets): the broadcast governor meters each
lane's sending words as the solo `packed.spend_relay` does — K8's spend
lane entry in mode 1, K16 on the lanes' rows (`budget_prefix_words_lanes`:
the sending words [K, N, W] folded to K·N rows, the budget and the sizes
shared), K8's spend in mode 2 — and the sync grant meters each session's
need row inside K3m's lane entry (its delay classes and recording form
too).  JAX: ``packed.py:102 budget_prefix_words`` at ``:389`` and the
per-edge grant at ``:1238`` under the vmap.

**Topology families and keys** (B16m's topology): each lane's targets
take ring0 tiering under its ``k_ring0`` (`.broadcast.ring0_targets_lanes`)
and the degree caps (K20's caps lane entry), its edges the AZ and matrix
delay classes (K20's slots lane entry), its wire the topology's loss —
the flat stream under its ``k_drop`` or the tiered lane instantiation,
both K10's lane launcher, with or without the plan's loss and jitter —
and every SWIM reach the topology's loss (K20's reach lane entry, or the
flat bernoulli).  JAX: ``topology.py:267 edge_payload_drop`` at
``packed.py:451`` and ``:240 tiered_edge_drop``.

**Every membership mode and PeerSwap** (B16s's packed half): the lanes
draw their targets and peers as the dense round's lanes do
(`.swim_lanes.sample_member_targets_lanes`: K1's lane entry under
partial view, its uniform lane entry under full view or ground truth, its
view lane entry under PeerSwap) and tick SWIM through
`.swim_lanes.swim_step_lanes` (pswim, K15's lane entries, or nothing);
under PeerSwap each lane's key splits five ways and the swap tick (K21's
lane entries) runs before inject.  A wiped node's full-view row goes
back to 0, 0, -1 in K11's lane entry (JAX ``faults.py:729-734``).

**The protocol variants** (B16m's rest): under push-pull each lane's
response leg follows its push (`_pull_lanes`: K9's session and wire
queries on the lanes folded, K10p's lane entry under the lane's pull key
and plan seed, K18's words-pull lane entry with the recorder), under FIFO
ordering K8f's lane entry gates each lane's delivery on its own pre-merge
``have``, the delivery-order count adds each lane's standing count into
its own slot (K22's words lane entry), the eager cadence makes every node
due in the sync, and the fan-out schedule is K20's schedule lane entry
after the degree caps (`broadcast_targets_lanes`).  JAX: ``packed.py:
514-538`` and ``:584-607``, ``:644-653``, ``:821-832`` and ``:1168-1170``
under the vmap.

**Matrix plans** (B16x): a matrix plan's round slice (`.faults.
RoundFaults`, the shared [N, N] slabs of its row t) reaches the same
queries as a factored one, each picking K9m's entry for it: the
broadcast's cut, loss threshold, delay and jitter and the pull's session
refusal and reverse thresholds through K9m's edge entry, the lanes folded
into its edge axis; the sync's session refusal and delay through the
same; the probe reach through K9m's reach lane entry, each lane folding
its phase key with its plan seed; the crashes and wipes through K11's
lane entry.  JAX: the matrix branches of ``faults.py:195-256`` and
``:303-312`` under the vmap.

The lane path runs every configuration of the solo packed round
(`check_packed_lanes`).  The dense round's lanes (`.dense_lanes`) have
`check_dense_lanes`, and share this module's batch and loop (`_Batch`,
`_run_batch`, `trace_of`, `stack_traces`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..device import ONES, i32
from ..kernels.build import check
from ..proto.ordering import admit_words, order_checked, order_enforced
from ..proto.schedule import cadence_due, capped_schedule_lanes
from ..topo.sampler import peerswap_step_lanes
from . import rng
from .broadcast import ring0_targets_lanes
from .faults import (
    JITTER_TAG,
    WIRE_LOSS_TAG,
    AnyFaultPlan,
    AnyRoundFaults,
    _zero_rows_,
    fault_session_effects,
    fault_wire_effects,
    host_activity,
    round_faults,
)
from .gaps import refresh_gaps_lanes
from .invariants import count_order_violations_lanes_
from .packed import (
    JITTER_MAX,
    PackedCarry,
    Planes,
    _check_budget,
    budget_prefix_words_plain,
    edge_list,
    launch_converge_record,
    planes_dec_,
    pack_state,
    planes_set_,
    scatter_pull_plain,
    senders,
    sync_masks,
    unpack_into_state,
)
from .round import RunMetrics, overflow_fraction
from .state import ALIVE, PayloadMeta, SimConfig, SimState, packed_supported
from .swim_lanes import sample_member_targets_lanes, swim_step_lanes
from .telemetry import (
    COVERAGE,
    GRANTS,
    WIRE,
    RoundTrace,
    acc_slot,
    count_words_lanes_,
    coverage_delivered_lanes_,
    new_trace_lanes,
    record_row_lanes,
    trace_row,
    wire_loss_active,
    wire_words_lanes_,
    wire_words_pull_lanes_,
)
from .topology import (
    Topology,
    edge_slot_lanes,
    loss_threshold,
    regions,
    topo_table,
    wire_tiers,
)
from .words import (
    all_chunks_words,
    and_rows,
    fold_any,
    group_low_bits_mask,
    pack_bits,
    smear_groups,
    unpack_bits,
)


def check_packed_lanes(cfg: SimConfig, topo: Topology, fplan=None) -> None:
    """The packed round's lanes run every configuration of the solo
    packed round: every protocol family and knob (K10p's, K8f's, K22's
    words and K18's words-pull lane entries, the eager cadence, K20's
    schedule lane entry), both metered budgets (K16 on the lanes' rows,
    K3m's lane entry), every topology family and key (K10's flat and
    tiered streams on lanes, K20's lane entries), every membership mode
    and PeerSwap (K1's, K15's and K21's lane entries), fault plans of
    either form with delay and jitter (B16l; a matrix plan's slices
    through K9m's edge and reach lane entries, B16x) and the flight
    recorder (B16r): JAX's ``jax.vmap`` of
    ``corrosion_tpu/sim/packed.py:681 packed_round_step`` in
    ``corrosion_tpu/campaign/ensemble.py:114-158 run_ensemble``; so
    ``fplan``, of either form, is accepted.  A dense configuration
    belongs to `.dense_lanes`.  Bound on the H100: K
    times the solo round's bytes and hashes (the lanes share no work);
    the design runs each phase's kernel once for all live lanes (a lane
    grid dimension, or the lanes folded into a kernel's rows), so a lane
    round makes the launches of one solo round."""
    if not packed_supported(cfg, topo):
        raise ValueError("a dense configuration on the packed round's "
                         "lanes: run it through `.dense_lanes`")


def check_dense_lanes(cfg: SimConfig, topo: Topology, fplan=None,
                      telemetry: bool = False) -> None:
    """The dense round's lanes run every configuration of the dense
    round: both byte budgets (inside K12's and K13's lane entries), full
    view, partial view, ground-truth membership, every topology family
    and key, either peer sampler, every protocol family and knob, fault
    plans of either form, with delay and jitter, PeerSwap under them
    (``fplan`` is accepted), and the flight recorder (``telemetry``).  A
    packed configuration belongs to `run_lanes` and raises."""
    if packed_supported(cfg, topo):
        raise ValueError("a packed configuration on the dense round's "
                         "lanes: run it through `run_lanes`")


# -- the word phases (K8) ----------------------------------------------------


def _check_lane_words(carry: PackedCarry, lanes: int, n: int, w: int):
    check("have", carry.have, torch.int32, (lanes, n, w))
    for k, plane in enumerate(carry.relay):
        check(f"relay.r{k}", plane, torch.int32, (lanes, n, w))


def inject_lanes_plain(carry: PackedCarry, inj: torch.Tensor, t: int,
                       meta: PayloadMeta, cfg: SimConfig,
                       alive: torch.Tensor) -> None:
    """Plain version of K8's inject lane entry, in place."""
    lanes, n, w = carry.have.shape
    p = cfg.n_payloads
    dev = carry.have.device
    up_w = torch.gather(alive, 1, meta.actor.long()[None].expand(
        lanes, p)) == ALIVE
    injecting = (meta.round == t)[None] & up_w
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    bit = torch.bitwise_left_shift(torch.ones_like(idx), idx % 32)
    contrib = torch.where(injecting, bit, 0)
    own = torch.zeros((lanes, n * w), dtype=torch.int32,
                      device=dev).index_add_(
        1, (meta.actor * w + idx // 32).long(), contrib
    ).reshape(lanes, n, w)
    newly = own & ~carry.have
    carry.have.bitwise_or_(own)
    planes_set_(carry.relay, newly, cfg.max_transmissions)
    inj |= pack_bits(injecting)


def inject_lanes(carry: PackedCarry, inj: torch.Tensor, t: int,
                 meta: PayloadMeta, cfg: SimConfig,
                 alive: torch.Tensor) -> None:
    """`packed.inject_packed` over the lanes, in place (``inj`` [K, W]);
    K8's inject lane entry on the card."""
    if carry.have.device.type == "cpu":
        inject_lanes_plain(carry, inj, t, meta, cfg, alive)
        return
    lanes, n, w = carry.have.shape
    p = cfg.n_payloads
    _check_lane_words(carry, lanes, n, w)
    check("injected_p", inj, torch.int32, (lanes, w))
    check("meta.round", meta.round, torch.int32, (p,))
    check("meta.actor", meta.actor, torch.int32, (p,))
    check("alive", alive, torch.uint8, (lanes, n))
    kernels.WORD_INJECT_LANES.launch(
        [meta.round, meta.actor, alive, carry.have, *carry.relay, inj],
        [n, w, p, t, cfg.max_transmissions, lanes],
    )


def budget_prefix_words_lanes_plain(elig_w: torch.Tensor, budget_bytes,
                                    nbytes: torch.Tensor) -> torch.Tensor:
    """Plain version of K16 on the lanes' rows: the solo plain version on
    each lane's rows."""
    if budget_bytes is None:
        return elig_w
    return torch.stack([budget_prefix_words_plain(x, budget_bytes, nbytes)
                        for x in elig_w])


def budget_prefix_words_lanes(elig_w: torch.Tensor, budget_bytes,
                              nbytes: torch.Tensor) -> torch.Tensor:
    """`packed.budget_prefix_words` over the lanes' rows ``elig_w`` [K, N,
    W]: each row's payload-index prefix of set bits whose bytes fit the
    shared ``budget_bytes``; None is unmetered.  The row scan never
    crosses rows and the budget and sizes are shared, so the lanes fold
    into K·N rows: K16's launcher on the card, counted as its lane
    entry."""
    if budget_bytes is None:
        return elig_w
    if elig_w.device.type == "cpu":
        return budget_prefix_words_lanes_plain(elig_w, budget_bytes, nbytes)
    lanes, n, w = elig_w.shape
    check("elig_w", elig_w, torch.int32, (lanes, n, w))
    _check_budget(budget_bytes, nbytes, w)
    if lanes * n >= 1 << 31:
        raise ValueError(f"{lanes} x {n} rows pass K16's int row index")
    out = torch.empty_like(elig_w)
    kernels.BUDGET_WORDS_LANES.launch([elig_w, nbytes, out],
                                      [lanes * n, w, budget_bytes])
    return out


def spend_lanes_plain(carry: PackedCarry, inj: torch.Tensor,
                      targets: torch.Tensor, alive: torch.Tensor,
                      budget=None, nbytes=None) -> torch.Tensor:
    """Plain version of K8's spend lane entry (metered: around K16's
    plain version)."""
    n = carry.have.shape[1]
    sending = carry.have & carry.relay.nonzero & inj[:, None, :]
    sending = budget_prefix_words_lanes_plain(sending, budget, nbytes)
    me = torch.arange(n, dtype=torch.int32, device=targets.device)
    attempted = (targets >= 0) & (targets != me[None, :, None])
    any_attempt = attempted.any(dim=2) & (alive == ALIVE)
    planes_dec_(carry.relay, torch.where(any_attempt[..., None], sending, 0))
    return sending


def spend_lanes(carry: PackedCarry, inj: torch.Tensor,
                targets: torch.Tensor, alive: torch.Tensor, budget=None,
                nbytes=None) -> torch.Tensor:
    """`packed.spend_relay` over the lanes: the sending words [K, N, W],
    metered by the broadcast governor (``budget`` bytes of ``nbytes``,
    shared; None is unmetered); the relay planes count down in place where
    an up row attempted a send.  K8's spend lane entry on the card; metered,
    its mode 1 (the eligible words), K16 on the lanes' rows, then its mode
    2 (the spend of the metered words), as the solo spend."""
    if carry.have.device.type == "cpu":
        return spend_lanes_plain(carry, inj, targets, alive, budget, nbytes)
    lanes, n, w = carry.have.shape
    f = targets.shape[2]
    _check_lane_words(carry, lanes, n, w)
    check("injected_p", inj, torch.int32, (lanes, w))
    check("targets", targets, torch.int32, (lanes, n, f))
    check("alive", alive, torch.uint8, (lanes, n))
    sending = torch.empty_like(carry.have)
    args = [carry.have, *carry.relay, inj, targets, alive]
    if budget is None:
        kernels.WORD_SPEND_LANES.launch([*args, sending], [n, w, f, 0, lanes])
        return sending
    kernels.WORD_SPEND_LANES.launch([*args, sending], [n, w, f, 1, lanes])
    sending = budget_prefix_words_lanes(sending, budget, nbytes)
    kernels.WORD_SPEND_LANES.launch([*args, sending], [n, w, f, 2, lanes])
    return sending


def deliver_lanes_plain(carry: PackedCarry, t: int, cfg: SimConfig) -> None:
    """Plain version of K8's deliver lane entry and of K8f's (its FIFO
    gate: `..proto.ordering.admit_words` of each lane's pre-merge have),
    in place."""
    slot = t % carry.inflight.shape[1]
    arriving = carry.inflight[:, slot]
    pending = carry.sync_buf[:, slot]
    if order_enforced(cfg):
        admit = torch.stack([admit_words(h, cfg) for h in carry.have])
        arriving = arriving & admit
        pending = pending & admit
    newly = arriving & ~carry.have
    carry.have.bitwise_or_(arriving | pending)
    planes_set_(carry.relay, newly, max(cfg.max_transmissions - 1, 1))
    carry.inflight[:, slot] = 0
    carry.sync_buf[:, slot] = 0


def deliver_lanes(carry: PackedCarry, t: int, cfg: SimConfig) -> None:
    """`packed.deliver_packed` over the lanes, in place; K8's deliver
    lane entry on the card, K8f's under ``ordering="fifo"`` (each lane's
    slots admitted by its own pre-merge have; c and the wave shared)."""
    if carry.have.device.type == "cpu":
        deliver_lanes_plain(carry, t, cfg)
        return
    lanes, n, w = carry.have.shape
    d_slots = carry.inflight.shape[1]
    _check_lane_words(carry, lanes, n, w)
    check("inflight", carry.inflight, torch.int32, (lanes, d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (lanes, d_slots, n, w))
    if order_enforced(cfg):
        c = cfg.chunks_per_version
        kernels.WORD_DELIVER_FIFO_LANES.launch(
            [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
            [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1),
             c, cfg.n_writers * c, lanes])
        return
    kernels.WORD_DELIVER_LANES.launch(
        [carry.inflight, carry.sync_buf, carry.have, *carry.relay],
        [n, w, d_slots, t % d_slots, max(cfg.max_transmissions - 1, 1),
         lanes])


# -- the ring scatter (K2, K10) ---------------------------------------------


def _streams_live(thr, jit, topo_thr: int, tiers) -> bool:
    """Whether any drop or jitter stream runs on the wire: the fault
    loss, the jitter, the flat topology loss or tiered loss (K10's lane
    entry then, K2's otherwise; for the pull, K10p's lossy or tiered
    lane form, its plain form otherwise)."""
    return not (thr is None and jit is None and topo_thr == 0
                and tiers is None)


def scatter_lanes_plain(ring, sending, dst, slot, ok, fanout: int,
                        thr=None, keys=None, seeds=None, jit=None,
                        dropped=None, topo_thr: int = 0, topo_keys=None,
                        tiers: Optional[Topology] = None) -> None:
    """Plain version of K2's lane entry (with a stream K10's, with ``jit``
    K10j's, with ``tiers`` the tiered lane instantiation, with ``dropped``
    their recording forms), in place: the solo plain version on each lane
    under its keys and plan seed."""
    from .packed import scatter_sending_lossy_plain, scatter_sending_plain

    lossy = _streams_live(thr, jit, topo_thr, tiers)
    for k in range(ring.shape[0]):
        if not lossy:
            scatter_sending_plain(ring[k], sending[k], dst[k], slot[k], ok[k],
                                  fanout)
            continue
        scatter_sending_lossy_plain(
            ring[k], sending[k], dst[k], slot[k], ok[k],
            None if thr is None else thr[k],
            None if keys is None else keys[k],
            0 if seeds is None else int(seeds[k]), fanout, topo_thr,
            None if topo_keys is None else topo_keys[k],
            dropped=None if dropped is None else dropped[k],
            jit=None if jit is None else jit[k], tiers=tiers)


def scatter_lanes(ring, sending, dst, slot, ok, fanout: int, thr=None,
                  keys=None, seeds=None, jit=None, dropped=None,
                  topo_thr: int = 0, topo_keys=None,
                  tiers: Optional[Topology] = None) -> None:
    """`packed.scatter_sending` (and with a stream
    `packed.scatter_sending_lossy`) over the lanes, in place on the rings
    [K, D, N, W]: lane k's ok edges OR its sending words into its ring,
    less what its streams drop — its wire-loss draw ``fold_in(fold_in(
    keys[k], seeds[k]), 101)`` under thr[k, e], and the topology's loss,
    byte e*P + q of ``aligned_u8_bits(topo_keys[k], [E, P])`` (the lane's
    ``k_drop``) below the shared ``topo_thr`` or, with ``tiers``, below
    the edge's tier threshold (256 or more drops all).  With ``jit``
    (i32[K, E], K9's jitter bounds) each surviving payload q of an edge
    with jit[k, e] > 0 lands element e*P + q of ``randint(fold_in(fold_in(
    keys[k], seeds[k]), 102), [E, P], 0, 2^31 - 1)`` mod (jit[k, e] + 1)
    rounds past slot[k, e].  With ``dropped`` (a lane trace's ``[K]``
    accumulator view) each lane's lost frames are added to its slot.  K2's
    lane entry without a stream; K10's lane entry (K10j's with ``jit``) or
    the tiered lane instantiation with ``tiers``, their recording forms,
    counted apart, with ``dropped``."""
    if ring.device.type == "cpu":
        scatter_lanes_plain(ring, sending, dst, slot, ok, fanout, thr, keys,
                            seeds, jit, dropped, topo_thr, topo_keys, tiers)
        return
    lanes, d_slots, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (lanes, d_slots, n, w))
    check("sending", sending, torch.int32, (lanes, n, w))
    check("dst", dst, torch.int32, (lanes, e))
    check("slot", slot, torch.int32, (lanes, e))
    check("ok", ok, torch.bool, (lanes, e))
    if not _streams_live(thr, jit, topo_thr, tiers):
        if dropped is not None:
            raise ValueError("dropped needs a loss or jitter stream")
        kernels.BROADCAST_SCATTER_LANES.launch(
            [ring, sending, dst, slot, ok], [n, d_slots, w, fanout, lanes])
        return
    fault = thr is not None or jit is not None
    if thr is not None:
        check("thr", thr, torch.uint8, (lanes, e))
    if jit is not None:
        check("jit", jit, torch.int32, (lanes, e))
    if fault:
        check("keys", keys, torch.int64, (lanes, 2))
        check("seeds", seeds, torch.int32, (lanes,))
    draws = 0 < topo_thr < 256 or tiers is not None
    if draws:
        check("topo_keys", topo_keys, torch.int64, (lanes, 2))
    if tiers is not None and topo_thr != 0:
        raise ValueError("tiered loss replaces the flat threshold")
    stride = 0
    if dropped is not None:
        _check_lane_slot("dropped", dropped, lanes)
        stride = dropped.stride(0)
    if tiers is not None:
        kernel = (kernels.BROADCAST_SCATTER_TIERED_LANES if dropped is None
                  else kernels.BROADCAST_SCATTER_TIERED_LANES_TRACE)
    else:
        kernel = {(False, False): kernels.BROADCAST_SCATTER_LOSSY_LANES,
                  (True, False): kernels.BROADCAST_SCATTER_JITTER_LANES,
                  (False, True): kernels.BROADCAST_SCATTER_LOSSY_LANES_TRACE,
                  (True, True): kernels.BROADCAST_SCATTER_JITTER_LANES_TRACE}[
            (jit is not None, dropped is not None)]
    span, mult = rng.scalar_span(0, JITTER_MAX)
    table = None if tiers is None else topo_table(tiers, n, ring.device)
    kernel.launch(
        [ring, sending, dst, slot, ok, thr, keys if fault else None,
         seeds if fault else None, topo_keys if draws else None, dropped,
         jit, table],
        [n, d_slots, w, fanout, WIRE_LOSS_TAG, topo_thr, JITTER_TAG,
         i32(span), i32(mult), stride, lanes])


def _check_lane_slot(name: str, t: torch.Tensor, lanes: int) -> None:
    """A lane trace's ``[K]`` view of one int64 accumulator slot."""
    if (not t.is_cuda or t.dtype != torch.int64
            or tuple(t.shape) != (lanes,)):
        raise ValueError(f"{name} must be a CUDA int64 [K] view")


# -- the push-pull response (K10p) -------------------------------------------


def scatter_pull_lanes_plain(ring, sending, dst, slot, ok_pull, thr_rev,
                             k_drop, seeds, fanout: int, topo_thr: int = 0,
                             dropped=None,
                             tiers: Optional[Topology] = None) -> None:
    """Plain version of K10p's lane entry (its recording forms with
    ``dropped``), in place: `packed.scatter_pull_plain` on each lane under
    its ``k_drop`` and plan seed."""
    for k in range(ring.shape[0]):
        scatter_pull_plain(
            ring[k], sending[k], dst[k], slot[k], ok_pull[k],
            None if thr_rev is None else thr_rev[k],
            None if k_drop is None else k_drop[k],
            0 if seeds is None else int(seeds[k]), fanout, topo_thr,
            None if dropped is None else dropped[k], tiers)


def scatter_pull_lanes(ring, sending, dst, slot, ok_pull, thr_rev, k_drop,
                       seeds, fanout: int, topo_thr: int = 0, dropped=None,
                       tiers: Optional[Topology] = None) -> None:
    """`packed.scatter_pull` over the lanes, in place on the rings [K, D,
    N, W]: lane k's ok_pull edges carry its responders' sending words
    sending[k, dst[k, e]] back to the puller e // fanout, into the push's
    slot slot[k, e], less what its pull streams drop — the topology stream
    on its pull key ``fold_in(k_drop[k], 1)`` (the shared flat
    ``topo_thr``, or the reverse edge's tier under ``tiers``) and the fault
    stream on ``fold_in(fold_in(k_pull, seeds[k]), 101)`` below thr_rev[k,
    e] (None: no fault loss this round).  With ``dropped`` (a lane trace's
    ``[K]`` accumulator view) each lane's lost frames are added to its
    slot.  K10p's lane entry on the card, counted by its streams as
    ``broadcast_pull_lanes``, ``broadcast_pull_lossy_lanes`` and
    ``broadcast_pull_tiered_lanes``, and their recording forms apart."""
    if ring.device.type == "cpu":
        scatter_pull_lanes_plain(ring, sending, dst, slot, ok_pull, thr_rev,
                                 k_drop, seeds, fanout, topo_thr, dropped,
                                 tiers)
        return
    lanes, d_slots, n, w = ring.shape
    e = n * fanout
    check("ring", ring, torch.int32, (lanes, d_slots, n, w))
    check("sending", sending, torch.int32, (lanes, n, w))
    check("dst", dst, torch.int32, (lanes, e))
    check("slot", slot, torch.int32, (lanes, e))
    check("ok_pull", ok_pull, torch.bool, (lanes, e))
    if thr_rev is not None:
        check("thr_rev", thr_rev, torch.uint8, (lanes, e))
        check("seeds", seeds, torch.int32, (lanes,))
    draws = thr_rev is not None or tiers is not None or 0 < topo_thr < 256
    if draws:
        check("k_drop", k_drop, torch.int64, (lanes, 2))
    if tiers is not None and topo_thr != 0:
        raise ValueError("tiered loss replaces the flat threshold")
    lossy = _streams_live(thr_rev, None, topo_thr, tiers)
    stride = 0
    if dropped is not None:
        if not lossy:
            raise ValueError("dropped needs a loss stream")
        _check_lane_slot("dropped", dropped, lanes)
        stride = dropped.stride(0)
    if tiers is not None:
        kernel = (kernels.BROADCAST_PULL_TIERED_LANES if dropped is None
                  else kernels.BROADCAST_PULL_TIERED_LANES_TRACE)
    elif lossy:
        kernel = (kernels.BROADCAST_PULL_LOSSY_LANES if dropped is None
                  else kernels.BROADCAST_PULL_LOSSY_LANES_TRACE)
    else:
        kernel = kernels.BROADCAST_PULL_LANES
    table = None if tiers is None else topo_table(tiers, n, ring.device)
    kernel.launch(
        [ring, sending, dst, slot, ok_pull, thr_rev,
         k_drop if draws else None, seeds if thr_rev is not None else None,
         dropped, table],
        [n, d_slots, w, fanout, WIRE_LOSS_TAG, topo_thr, stride, lanes])


# -- the sync pull (K3) ------------------------------------------------------


def sync_pull_lanes_plain(masks, miss, peers, ok, ring, slot: int,
                          sdelay=None, granted=None, budget=None,
                          nbytes=None) -> torch.Tensor:
    """Plain version of K3's lane entry (with ``sdelay`` its delay lane
    entry, with ``budget`` K3m's, with ``granted`` their recording forms):
    the solo plain version on each lane's rows and its ring's slot (or
    whole ring), in place."""
    from .packed import sync_pull_plain

    return torch.stack([
        sync_pull_plain(
            masks[k], miss[k], peers[k], ok[k],
            ring[k, slot] if sdelay is None else ring[k], budget, nbytes,
            granted=None if granted is None else granted[k],
            sdelay=None if sdelay is None else sdelay[k], slot=slot)
        for k in range(masks.shape[0])])


def sync_pull_lanes(masks, miss, peers, ok, ring, slot: int, sdelay=None,
                    granted=None, budget=None, nbytes=None) -> torch.Tensor:
    """`packed.sync_pull` over the lanes: each lane's sessions pull from
    its own rows (``peers`` [K, N, S] lane-local) into slot ``slot`` of its
    sync ring [K, D, N, W] in place, each edge's grant metered by the
    shared sync ``budget`` of ``nbytes`` (None: unmetered); returns bool[K,
    N] fruitful.  With ``sdelay`` (i32[K, N * S], the lanes' session
    delays) edge e of lane k lands in slot (slot + sdelay[k, e]) % D, a
    read-OR-write (a class past D - 2 lands nowhere); with ``granted``
    ([K, N * S, W]) each lane's granted words are copied there too (every
    class).  K3's lane entry on the card, its delay lane entry with
    ``sdelay``, K3m's lane entry under a budget (delays too); their
    recording forms, counted apart, with ``granted``."""
    if masks.device.type == "cpu":
        return sync_pull_lanes_plain(masks, miss, peers, ok, ring, slot,
                                     sdelay, granted, budget, nbytes)
    lanes, n, _, w = masks.shape
    s = peers.shape[2]
    d_slots = ring.shape[1]
    check("masks", masks, torch.int32, (lanes, n, 4, w))
    check("miss", miss, torch.int32, (lanes, n, w))
    check("peers", peers, torch.int32, (lanes, n, s))
    check("ok", ok, torch.bool, (lanes, n, s))
    check("sync ring", ring, torch.int32, (lanes, d_slots, n, w))
    if not 0 <= slot < d_slots:
        raise ValueError(f"slot {slot} outside the ring of {d_slots}")
    if sdelay is not None:
        check("sdelay", sdelay, torch.int32, (lanes, n * s))
    if granted is not None:
        check("granted", granted, torch.int32, (lanes, n * s, w))
    # every node's flag is written by the kernel: no fill, no cast
    fruitful = torch.empty((lanes, n), dtype=torch.bool, device=masks.device)
    args = [masks, miss, peers, ok, ring, fruitful]
    if budget is not None:
        _check_budget(budget, nbytes, w)
        kernel = (kernels.SYNC_PULL_METERED_LANES if granted is None
                  else kernels.SYNC_PULL_METERED_LANES_TRACE)
        kernel.launch([*args, nbytes, granted, sdelay],
                      [n, w, s, d_slots, slot, budget, lanes])
        return fruitful
    kernel = {(False, False): kernels.SYNC_PULL_LANES,
              (True, False): kernels.SYNC_PULL_DELAY_LANES,
              (False, True): kernels.SYNC_PULL_LANES_TRACE,
              (True, True): kernels.SYNC_PULL_DELAY_LANES_TRACE}[
        (sdelay is not None, granted is not None)]
    kernel.launch([*args, granted, sdelay], [n, w, s, d_slots, slot, lanes])
    return fruitful


# -- the convergence record (K7) ---------------------------------------------


def converge_record_lanes_plain(have, inj, alive, metrics: RunMetrics,
                                meta: PayloadMeta, t: int, cfg: SimConfig,
                                n_overflow, last_round: int,
                                horizon: Optional[int] = None):
    """Plain version of K7's lane entry: the solo record per lane."""
    p = cfg.n_payloads
    c = cfg.chunks_per_version
    up = alive == ALIVE
    overflow_frac = torch.maximum(
        metrics.overflow_frac,
        overflow_fraction(n_overflow, cfg.n_nodes * cfg.n_writers))
    comp_w = all_chunks_words(have, cfg)
    act_w = smear_groups(fold_any(inj, c) & group_low_bits_mask(c), c)
    masked = torch.where(up[..., None], comp_w, ONES)
    payload_done = unpack_bits(and_rows(masked.transpose(0, 1)) & act_w, p)
    coverage_at = torch.where(
        (metrics.coverage_at < 0) & payload_done, t, metrics.coverage_at
    ).to(torch.int32)
    node_done = ((comp_w | ~act_w[:, None, :]) == ONES).all(dim=2) & up
    all_injected = (meta.round <= t).all()
    converged_at = torch.where(
        (metrics.converged_at < 0) & node_done & all_injected,
        t, metrics.converged_at,
    ).to(torch.int32)
    settled = (converged_at >= 0) if horizon is None else node_done
    done = (meta.round <= t + 1).all() & (settled | ~up).all(dim=1)
    if horizon is not None and t + 1 < horizon:
        done = torch.zeros_like(done)
    return coverage_at, converged_at, overflow_frac, done


def converge_record_lanes(have, inj, alive, metrics: RunMetrics,
                          meta: PayloadMeta, t: int, cfg: SimConfig,
                          n_overflow, last_round: int,
                          horizon: Optional[int] = None):
    """`packed.converge_record` per lane: (coverage_at i32[K, P],
    converged_at i32[K, N], overflow_frac f32[K], done bool[K]) — each
    lane's stamps, overflow fold (K6's i32[K] ``n_overflow``) and exit
    flag from its own rows only, in the faultless or (with ``horizon``)
    the fault loop's mode.  K7's lane entry on the card, one launch."""
    if have.device.type == "cpu":
        return converge_record_lanes_plain(have, inj, alive, metrics, meta,
                                           t, cfg, n_overflow, last_round,
                                           horizon)
    lanes, n, w = have.shape
    p = cfg.n_payloads
    check("have", have, torch.int32, (lanes, n, w))
    check("injected_p", inj, torch.int32, (lanes, w))
    check("alive", alive, torch.uint8, (lanes, n))
    check("converged_at", metrics.converged_at, torch.int32, (lanes, n))
    check("coverage_at", metrics.coverage_at, torch.int32, (lanes, p))
    check("overflow_frac", metrics.overflow_frac, torch.float32, (lanes,))
    check("n_overflow", n_overflow, torch.int32, (lanes,))
    return launch_converge_record(
        kernels.CONVERGE_RECORD_LANES, have, inj, alive, metrics, n_overflow,
        t, cfg, horizon, last_round, lanes)


# -- the node faults (K11) ---------------------------------------------------


def apply_round_faults_lanes_plain(slim: SimState, carry: PackedCarry,
                                   rf: AnyRoundFaults) -> None:
    """Plain version of K11's lane entry, in place."""
    slim.alive.copy_(torch.where(
        rf.alive[None] >= 0, rf.alive.to(slim.alive.dtype)[None],
        slim.alive))
    wipe = rf.wipe
    for x in (carry.have, *carry.relay, slim.heads, slim.gap_lo,
              slim.gap_hi, slim.view, slim.vinc):
        _zero_rows_(x, wipe, 1)
    for x in (carry.inflight, carry.sync_buf):
        _zero_rows_(x, wipe, 2)
    for x in (slim.pid, slim.pkey, slim.psince, slim.suspect_since,
              slim.pview):
        _zero_rows_(x, wipe, 1, -1)


def apply_round_faults_lanes(slim: SimState, carry: PackedCarry,
                             rf: AnyRoundFaults) -> None:
    """`packed.apply_round_faults` over the lanes, in place: the round's
    shared alive overrides and wipes hit every lane's rows (JAX shares
    the schedule unbatched, ``ensemble.py:147-158``), a wiped node's
    full-view row going back to 0, 0, -1 (JAX ``faults.py:729-734``) and
    its PeerSwap view emptied.  K11's lane entry on the card."""
    if carry.have.device.type == "cpu":
        apply_round_faults_lanes_plain(slim, carry, rf)
        return
    lanes, n, w = carry.have.shape
    d_slots = carry.inflight.shape[1]
    a = slim.heads.shape[2]
    ak = slim.gap_lo.shape[2] * slim.gap_lo.shape[3]
    m = slim.pid.shape[2]
    v = slim.pview.shape[2]
    _check_lane_words(carry, lanes, n, w)
    check("inflight", carry.inflight, torch.int32, (lanes, d_slots, n, w))
    check("sync_buf", carry.sync_buf, torch.int32, (lanes, d_slots, n, w))
    check("rf.alive", rf.alive, torch.int8, (n,))
    check("rf.wipe", rf.wipe, torch.bool, (n,))
    check("alive", slim.alive, torch.uint8, (lanes, n))
    check("heads", slim.heads, torch.int32, (lanes, n, a))
    for name in ("gap_lo", "gap_hi"):
        check(name, getattr(slim, name), torch.int32, slim.gap_lo.shape)
    for name in ("pid", "pkey", "psince"):
        check(name, getattr(slim, name), torch.int32, (lanes, n, m))
    check("pview", slim.pview, torch.int32, (lanes, n, v))
    fv = slim.view.shape[1]
    check("view", slim.view, torch.int8, (lanes, fv, fv))
    for name in ("vinc", "suspect_since"):
        check(name, getattr(slim, name), torch.int32, (lanes, fv, fv))
    kernels.NODE_FAULTS_LANES.launch(
        [rf.alive, rf.wipe, slim.alive, carry.have, *carry.relay,
         carry.inflight, carry.sync_buf, slim.heads, slim.gap_lo,
         slim.gap_hi, slim.pid, slim.pkey, slim.psince,
         slim.view if fv else None, slim.vinc if fv else None,
         slim.suspect_since if fv else None, slim.pview],
        [n, w, d_slots, a, ak, m, fv, v, lanes],
    )


# -- the round ----------------------------------------------------------------


def _edges(state: SimState, targets: torch.Tensor, due=None):
    """The lanes' edge list from targets [K, N, F] (`packed.edge_list`,
    K2's edge pass; with ``due`` [K, N] the sync's) and the senders the
    dense lanes' consumers read: (src [1, E], dst [K, E] clamped, ok
    [K, E])."""
    n, f = targets.shape[1:]
    dst, ok, _ = edge_list(targets.contiguous(), state.group, state.alive,
                           None if due is None else due.contiguous())
    return senders(n, f, targets.device)[None], dst, ok


def broadcast_targets_lanes(state: SimState, cfg: SimConfig,
                            topo: Topology, region, k_targets,
                            k_ring0) -> torch.Tensor:
    """Each lane's broadcast targets i32[K, N, F], drawn as the solo
    round draws them: the member sample under its ``k_targets``
    (`.swim_lanes.sample_member_targets_lanes`), ring0 tiering under its
    ``k_ring0`` (`.broadcast.ring0_targets_lanes`), then the topology's
    degree caps and the fan-out schedule (K20's caps lane entry,
    `..proto.schedule.capped_schedule_lanes`); shared by both lane
    rounds."""
    targets = sample_member_targets_lanes(state, cfg, k_targets, cfg.fanout)
    targets = ring0_targets_lanes(state, cfg, topo, region, k_ring0, targets)
    return capped_schedule_lanes(targets.contiguous(), topo, cfg,
                                 int(state.t))


def broadcast_lanes(carry: PackedCarry, inj, state: SimState,
                    cfg: SimConfig, topo: Topology, region, keys,
                    meta: PayloadMeta, faults=None, seeds=None,
                    active=None, trace: Optional[RoundTrace] = None) -> None:
    """`packed.broadcast_packed` over the lanes, in place: each lane's
    targets (`broadcast_targets_lanes`: K1's lane entry,
    its view entry under PeerSwap, its uniform entry under ground truth
    or full view), ring0 tiering under its ``k_ring0``
    (`.broadcast.ring0_targets_lanes`), the topology's degree caps (K20's
    caps lane entry), its spend (K8, metered by K16 on the lanes' rows
    under the governor), its edges' slots (K20's edge lane entry on AZ or
    matrix delay classes) and its ring scatter: K2's lane entry, or under
    the topology's loss, this round's fault loss or its jitter K10's lane
    entry (the flat stream under the lane's ``k_drop``, the tiered lane
    instantiation under tiered loss, K10j's stream with jitter), each lane
    with its own keys and plan seed.  Under ``faults`` cuts clear edges
    and the plan's fixed delay adds to each edge's slot (K9, its latency
    entry under delay or jitter factors, K9m on a matrix slice, on the
    lanes folded into its edge axis).  ``active`` is the host's copy of
    the round's loss and jitter activity (None: every class the plan
    has).  With a lane ``trace``
    each lane's cut edges (K9's lane-strided count), the frames and bytes
    it sends on its ok edges (K18's words lane entry) and the frames its
    loss ate (the scatter's recording form) go to its accumulators."""
    lanes = keys.shape[0]
    f = cfg.fanout
    t = int(state.t)
    ks = rng.split_lanes(keys, 3)
    k_targets, k_drop, k_ring0 = (ks[:, i].contiguous() for i in range(3))
    targets = broadcast_targets_lanes(state, cfg, topo, region, k_targets,
                                      k_ring0)
    sending = spend_lanes(carry, inj, targets, state.alive,
                          cfg.rate_limit_bytes_round, meta.nbytes)
    d_slots = carry.inflight.shape[1]
    tiers = wire_tiers(topo)
    topo_thr = (loss_threshold(topo.loss)
                if topo.loss > 0 and tiers is None else 0)
    # the flat delay without a plan: the edge pass writes the slots too
    flat = faults is None and not topo.delay_classes
    dst, ok, slot = edge_list(targets, state.group, state.alive, None,
                              topo if flat else None, region, t, d_slots)
    # the senders [1, E], for K9's queries and K20's edge entry only
    src = None if flat else senders(cfg.n_nodes, f, targets.device)[None]
    thr = jit = fdelay = None
    if faults is not None:
        # ok is contiguous [K, E]: its flat view is cleared in place
        _, thr, fdelay, jit = fault_wire_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            cut=None if trace is None else acc_slot(trace, "bcast_cut"))
        thr, fdelay, jit = (None if x is None else x.view(lanes, -1)
                            for x in (thr, fdelay, jit))
        if active is not None:
            thr = thr if active.loss else None
            jit = jit if active.jitter else None
    if trace is not None:
        wire_words_lanes_(trace.acc[:, WIRE], sending, meta.nbytes, ok, f)
    if slot is None:
        slot = edge_slot_lanes(topo, region, src[0], dst, t, d_slots,
                               fdelay).contiguous()
    dropped = None
    if (trace is not None and _streams_live(thr, jit, topo_thr, tiers)
            and wire_loss_active(topo, faults)):
        dropped = acc_slot(trace, "bcast_dropped")
    scatter_lanes(carry.inflight, sending, dst, slot, ok, f, thr, keys,
                  seeds, jit, dropped, topo_thr, k_drop, tiers)
    if cfg.dissemination == "push-pull":
        _pull_lanes(carry, sending, cfg, meta, faults, trace, topo, src,
                    dst, ok, slot, thr, k_drop, seeds, topo_thr, tiers)


def _pull_lanes(carry: PackedCarry, sending, cfg: SimConfig,
                meta: PayloadMeta, faults, trace, topo: Topology, src, dst,
                ok, slot, thr, k_drop, seeds, topo_thr: int, tiers) -> None:
    """The push-pull response leg of `broadcast_lanes`, as the solo
    `packed._pull_packed`: the session refusal across a cut in either
    direction (K9's session query, K9m's on a matrix slice, the lanes
    folded), the reverse fault thresholds when this round's loss applies
    (K9's or K9m's wire query on the swapped edges), the response scatter (K10p's lane entry) and, with a
    lane ``trace``, the pull's frames and bytes (K18's words-pull lane
    entry) and its lost frames (K10p's recording form)."""
    from ..proto.dissemination import pull_session_ok_lanes, reverse_loss_lanes

    ok_pull = pull_session_ok_lanes(ok, faults, src, dst).contiguous()
    thr_rev = (reverse_loss_lanes(faults, src, dst) if thr is not None
               else None)
    dropped = None
    if (trace is not None and _streams_live(thr_rev, None, topo_thr, tiers)
            and wire_loss_active(topo, faults)):
        dropped = acc_slot(trace, "bcast_dropped")
    scatter_pull_lanes(carry.inflight, sending, dst, slot, ok_pull, thr_rev,
                       k_drop, seeds, cfg.fanout, topo_thr, dropped, tiers)
    if trace is not None:
        wire_words_pull_lanes_(trace.acc[:, WIRE], sending, meta.nbytes,
                               ok_pull, dst)


def sync_lanes(carry: PackedCarry, state: SimState, cfg: SimConfig,
               keys, meta: PayloadMeta, faults=None,
               trace: Optional[RoundTrace] = None):
    """`packed.sync_packed` over the lanes: each lane's peers
    (`.swim_lanes.sample_member_targets_lanes`, as the broadcast's), the
    need masks from its heads and gaps (K3's mask pass, the lanes folded
    into its rows), the pull into its sync ring's
    slot t + 1 (K3's lane entry; K3m's under the sync budget, each edge's
    grant metered) and its backoff and re-arm draws (K5); a cut in either
    direction refuses a session, and under a plan with delay factors each
    session's grants land its session delay later (K9, its latency entry,
    or K9m on a matrix slice, folded; K3's delay lane entry, or K3m's with
    the delays).  Returns
    (countdown, backoff, ok): [K, N] each and the sessions' ok mask
    bool[K, N * S]; with a lane ``trace`` each lane's refused sessions
    (K9's lane-strided count) and grant counts (K3's or K3m's recording
    form, then K17's grant lane entry) go to its accumulators."""
    lanes = keys.shape[0]
    n, s = cfg.n_nodes, cfg.sync_peers
    ks = rng.split_lanes(keys, 3)
    k_peers, k_rearm = ks[:, 0].contiguous(), ks[:, 2].contiguous()
    # the cadence before every use of due: the sessions' ok, the backoff
    # and the re-arm (the countdown still draws every round)
    due = cadence_due(state.sync_countdown <= 0, cfg)
    peers = sample_member_targets_lanes(state, cfg, k_peers, s)
    dst, ok, _ = edge_list(peers.contiguous(), state.group, state.alive,
                           due.contiguous())
    sdelay = None
    if faults is not None:
        src = senders(n, s, peers.device)[None]
        # the refused count is taken before the mask clears them
        _, sdelay = fault_session_effects(
            faults, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1),
            None if trace is None else acc_slot(trace, "sync_refused"))
        if sdelay is not None:
            sdelay = sdelay.view(lanes, n * s)

    masks, miss_w = sync_masks(state.heads, state.gap_lo, state.gap_hi,
                               carry.have, cfg)
    slot = (int(state.t) + 1) % carry.sync_buf.shape[1]
    granted = (None if trace is None else torch.empty(
        (lanes, n * s, carry.have.shape[2]), dtype=torch.int32,
        device=peers.device))
    fruitful = sync_pull_lanes(masks, miss_w, dst.reshape(lanes, n, s),
                               ok.reshape(lanes, n, s), carry.sync_buf, slot,
                               sdelay, granted, cfg.sync_budget_bytes,
                               meta.nbytes)
    if trace is not None:
        count_words_lanes_(trace.counts[:, GRANTS], granted)
    backoff = torch.where(
        due & fruitful,
        cfg.sync_interval_rounds,
        torch.where(
            due,
            torch.clamp(state.sync_backoff * 2, max=cfg.sync_backoff_cap()),
            state.sync_backoff,
        ),
    ).to(torch.int32)
    rearm = rng.randint_lanes(k_rearm, (n,), 1, backoff + 1)
    countdown = torch.where(due, rearm, state.sync_countdown - 1)
    return countdown, backoff, ok


def packed_round_step_lanes(state: SimState, carry: PackedCarry, inj,
                            metrics: RunMetrics, meta: PayloadMeta,
                            cfg: SimConfig, topo: Topology, region,
                            faults=None, horizon: Optional[int] = None,
                            seeds=None, active=None,
                            trace: Optional[RoundTrace] = None, *,
                            last_round: int):
    """One gossip tick of every lane, phase for phase the solo
    `packed.packed_round_step` with lane k's keys: (under PeerSwap the
    view swap, K21's lane entries, on a fifth phase key) inject →
    broadcast → sync → deliver → SWIM (partial view, full view through
    K15's lane entries, or nothing under ground truth) → gap refresh →
    convergence record, the round's shared fault slice in the swap,
    broadcast, sync and SWIM, and
    ``active`` (the host's copy of its loss and jitter activity) picking
    the scatter.  Updates ``carry`` and ``inj`` in place; returns (state,
    metrics, done) with done bool[K] on the device.  With a lane
    ``trace`` (`.telemetry.new_trace_lanes`) every lane's row is recorded
    in it, in place, as the solo round records its own: the phases feed
    each lane's accumulators, then K17's coverage lane entry counts
    coverage and delivered and K19's lane entry writes the rows (with the
    shared fault slice's crashes and wipes).  ``last_round`` is
    max(meta.round), read once a run by the loop (`converge_record_lanes`).
    """
    peerswap = cfg.peer_sampler == "peerswap"
    ks = rng.split_lanes(state.key, 5 if peerswap else 4)
    state = state._replace(key=ks[:, 0].contiguous())
    k_bcast, k_sync, k_swim = (ks[:, i].contiguous() for i in (1, 2, 3))
    if peerswap:
        # the view swap tick before inject, so this round's draws sample
        # the swapped views (JAX's phase order)
        state = peerswap_step_lanes(state, cfg, topo, ks[:, 4].contiguous(),
                                    faults, seeds)
    t = int(state.t)
    have0 = None if trace is None else carry.have.clone()
    inject_lanes(carry, inj, t, meta, cfg, state.alive)
    broadcast_lanes(carry, inj, state, cfg, topo, region, k_bcast, meta,
                    faults, seeds, active, trace)
    countdown, backoff, sync_ok = sync_lanes(carry, state, cfg, k_sync, meta,
                                             faults, trace)
    state = state._replace(sync_countdown=countdown, sync_backoff=backoff)
    deliver_lanes(carry, t, cfg)
    state = swim_step_lanes(state, cfg, topo, k_swim, faults, seeds)
    heads, gap_lo, gap_hi, n_overflow = refresh_gaps_lanes(carry.have, cfg)
    state = state._replace(heads=heads, gap_lo=gap_lo, gap_hi=gap_hi)
    coverage_at, converged_at, overflow_frac, done = converge_record_lanes(
        carry.have, inj, state.alive, metrics, meta, t, cfg, n_overflow,
        last_round, horizon)
    if order_checked(cfg):
        # each live lane's standing count, into its own slot in place
        count_order_violations_lanes_(metrics.order_violations, carry.have,
                                      meta, cfg)
    metrics = RunMetrics(coverage_at=coverage_at, converged_at=converged_at,
                         overflow_frac=overflow_frac,
                         order_violations=metrics.order_violations)
    if trace is not None:
        coverage_delivered_lanes_(trace.counts[:, COVERAGE:GRANTS],
                                  carry.have, have0, state.alive)
        record_row_lanes(trace, trace_row(trace, t, cfg.trace_every),
                         alive=state.alive, state=state, cfg=cfg, rf=faults,
                         sync_ok=sync_ok, n_overflow=n_overflow,
                         nbytes=meta.nbytes)
    return state._replace(t=state.t + 1), metrics, done


# -- the loops ----------------------------------------------------------------


class _Batch(NamedTuple):
    """The live lanes: state, carry and injected words (the packed
    round's; None on the dense round, whose state holds them), metrics,
    plan seeds, their indices in the ensemble, and a loop's own per-lane
    tensors (``extra``, each [K, ...], kept and dropped with the
    lanes)."""

    slim: SimState
    carry: Optional[PackedCarry]
    inj: Optional[torch.Tensor]
    metrics: RunMetrics
    seeds: Optional[torch.Tensor]
    lanes: List[int]
    extra: Tuple[torch.Tensor, ...] = ()


def _select(x, idx):
    if x is None or x.dim() == 0:
        return x
    return x.index_select(0, idx)


def _keep(batch: _Batch, keep: List[int]) -> _Batch:
    """The batch restricted to its rows ``keep`` (index_select: new
    tensors, so the dropped lanes' slices stay as they were)."""
    idx = torch.tensor(keep, dtype=torch.long,
                       device=batch.slim.alive.device)
    slim = batch.slim._replace(**{
        name: _select(getattr(batch.slim, name), idx)
        for name in SimState._fields if name != "t"})
    carry = None if batch.carry is None else PackedCarry(
        have=_select(batch.carry.have, idx),
        inflight=_select(batch.carry.inflight, idx),
        relay=Planes(*(_select(p, idx) for p in batch.carry.relay)),
        sync_buf=_select(batch.carry.sync_buf, idx),
    )
    return _Batch(slim, carry, _select(batch.inj, idx),
                  RunMetrics(*(_select(x, idx) for x in batch.metrics)),
                  _select(batch.seeds, idx),
                  [batch.lanes[i] for i in keep],
                  tuple(_select(x, idx) for x in batch.extra))


def _lane_slice(batch: _Batch, i: int):
    """Row i of the batch, cloned: the lane's frozen result (state,
    carry, injected words, metrics, its rows of ``extra``)."""
    slim = batch.slim._replace(**{
        name: getattr(batch.slim, name)[i].clone()
        for name in SimState._fields if name != "t"})
    slim = slim._replace(t=batch.slim.t.clone())
    carry = None if batch.carry is None else PackedCarry(
        have=batch.carry.have[i].clone(),
        inflight=batch.carry.inflight[i].clone(),
        relay=Planes(*(p[i].clone() for p in batch.carry.relay)),
        sync_buf=batch.carry.sync_buf[i].clone(),
    )
    metrics = RunMetrics(*(x[i].clone() for x in batch.metrics))
    inj = None if batch.inj is None else batch.inj[i].clone()
    return slim, carry, inj, metrics, tuple(x[i].clone()
                                            for x in batch.extra)


def trace_of(extra, start: int = 0) -> RoundTrace:
    """The lane trace carried in a batch's ``extra`` from ``start``."""
    return RoundTrace(*extra[start:start + len(RoundTrace._fields)])


def stack_traces(finished, start: int = 0) -> RoundTrace:
    """The finished lanes' traces (each its frozen rows of ``extra``
    from ``start``), stacked in lane order: a lane trace [K, ...]."""
    extras = [extra for *_, extra in finished]
    return RoundTrace(*(
        torch.stack([x[start + j] for x in extras])
        for j in range(len(RoundTrace._fields))))


def _stack_results(finished, cfg: SimConfig):
    """The lanes' frozen results in lane order as one stacked
    (SimState, RunMetrics): every field [K, ...], ``t`` i32[K]; the
    packed round's words unpacked into the state."""
    slims, carries, injs, metrics, _ = zip(*finished)

    def stack(xs):
        return torch.stack(list(xs))

    full = SimState(*(stack(getattr(s, name) for s in slims)
                      for name in SimState._fields))
    if carries[0] is not None:
        carry = PackedCarry(
            have=stack(c.have for c in carries),
            inflight=stack(c.inflight for c in carries),
            relay=Planes(*(stack(c.relay[k] for c in carries)
                           for k in range(4))),
            sync_buf=stack(c.sync_buf for c in carries),
        )
        full = unpack_into_state(carry, full, cfg)
        full = full._replace(
            injected=unpack_bits(stack(injs), cfg.n_payloads).to(torch.uint8))
    return full, RunMetrics(*(stack(x) for x in zip(*metrics)))


def _run_batch(batch: _Batch, max_rounds: int, done, step):
    """The lanes' loop: once a round the ``[K]`` done flags come to the
    host (the one read of a round); a lane that is done, or every lane
    at ``max_rounds``, leaves the batch with its state after that round;
    ``step(batch)`` runs one round of the live lanes and returns (batch,
    done).  Returns the finished lanes in ensemble order."""
    finished = [None] * len(batch.lanes)
    while True:
        flags = done.tolist()  # the one host read of a round
        if int(batch.slim.t) >= max_rounds:
            flags = [True] * len(flags)
        ended = [i for i, f in enumerate(flags) if f]
        for i in ended:
            finished[batch.lanes[i]] = _lane_slice(batch, i)
        if len(ended) == len(flags):
            return finished
        if ended:
            batch = _keep(batch, [i for i, f in enumerate(flags) if not f])
        batch, done = step(batch)


def _shrink_lanes(states: SimState) -> SimState:
    """`packed.shrink_state` of stacked states: zero-width payload axes
    (the loop carries the packed words)."""
    lanes, n = states.have.shape[:2]
    d = states.inflight.shape[1]
    dev = states.have.device
    u8 = torch.uint8
    return states._replace(
        have=torch.zeros((lanes, n, 0), dtype=u8, device=dev),
        injected=torch.zeros((lanes, 0), dtype=u8, device=dev),
        relay_left=torch.zeros((lanes, n, 0), dtype=u8, device=dev),
        inflight=torch.zeros((lanes, d, n, 0), dtype=torch.int32,
                             device=dev),
        sync_inflight=torch.zeros((lanes, d, n, 0), dtype=u8, device=dev),
    )


def _new_lane_metrics(cfg: SimConfig, lanes: int, device) -> RunMetrics:
    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return RunMetrics(
        coverage_at=full((lanes, cfg.n_payloads), -1),
        converged_at=full((lanes, cfg.n_nodes), -1),
        overflow_frac=full((lanes,), 0.0, torch.float32),
        order_violations=full((lanes,), 0),
    )


def packed_lane_batch(states: SimState, cfg: SimConfig, seeds=None,
                      trace: Optional[RoundTrace] = None) -> _Batch:
    """The packed lane loop's batch of every lane of stacked initial
    states: the packed carry and injected words, the slim state (``t`` a
    host scalar 0), fresh metrics; the full view's beliefs are the loop's
    own, and with plan ``seeds`` (i32[K], a fault loop's) so are the
    tables the node faults write; a lane ``trace`` rides in ``extra``
    (`trace_of`)."""
    dev = states.have.device
    k_lanes = states.have.shape[0]
    # `pack_state` and `pack_bits` act on the last axis: lanes ride along
    carry, inj = pack_state(states, cfg), pack_bits(states.injected)
    slim = _shrink_lanes(states)._replace(t=torch.zeros((),
                                                        dtype=torch.int32))
    # full-view SWIM writes the beliefs in place: the loop owns its own
    owned = ("view", "vinc", "suspect_since")
    if seeds is not None:
        # and so do the node faults these
        owned += ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey",
                  "psince", "pview")
    slim = slim._replace(**{name: getattr(slim, name).clone()
                            for name in owned})
    return _Batch(slim, carry, inj, _new_lane_metrics(cfg, k_lanes, dev),
                  seeds, list(range(k_lanes)),
                  () if trace is None else tuple(trace))


def packed_lane_step(batch: _Batch, meta: PayloadMeta, cfg: SimConfig,
                     topo: Topology, region,
                     fplan: Optional[AnyFaultPlan] = None,
                     activity=None, telemetry: bool = False, *,
                     last_round: int):
    """One round of the packed lane loop's live lanes: under ``fplan``
    the round's node faults first (K11's lane entry) and the scatter
    picked from ``activity`` (`.faults.host_activity` of the plan), then
    the lane round, recording into the batch's trace with ``telemetry``;
    ``last_round`` is max(meta.round), read once a run.  Returns
    (batch, done) with done bool[K] on the device."""
    t = int(batch.slim.t)
    rf = active = horizon = None
    if fplan is not None:
        rf = round_faults(fplan, t)
        apply_round_faults_lanes(batch.slim, batch.carry, rf)
        horizon = fplan.horizon
        active = activity[min(t, horizon)]
    slim, metrics, done = packed_round_step_lanes(
        batch.slim, batch.carry, batch.inj, batch.metrics, meta, cfg, topo,
        region, rf, horizon, batch.seeds, active,
        trace_of(batch.extra) if telemetry else None, last_round=last_round)
    return batch._replace(slim=slim, metrics=metrics), done


def run_lanes(states: SimState, meta: PayloadMeta, cfg: SimConfig,
              topo: Topology, max_rounds: int,
              fplan: Optional[AnyFaultPlan] = None,
              seeds: Optional[torch.Tensor] = None, telemetry: bool = False):
    """Run every lane of stacked initial states (every field [K, ...],
    ``t`` 0 in all) to its own exit or ``max_rounds`` — any configuration
    of the solo packed round (every protocol family and knob, both byte
    budgets, every topology family and key, every membership mode,
    PeerSwap; `check_packed_lanes`): faultless, the solo
    `packed.run_packed`'s loop per lane; under ``fplan`` (either form,
    delay and jitter included, its seed replaced per lane by ``seeds``
    i32[K]) the solo `packed.run_packed_faults`' — the round's
    node faults first (K11), each round's scatter picked from the plan's
    host activity, no exit before the horizon, then the fresh all-have
    predicate.  Returns the lanes' final (SimState, RunMetrics), stacked
    in lane order with ``t`` i32[K] on the host; lane k equals the solo
    run of its initial state and seed.  With ``telemetry`` the flight
    recorder runs on every lane (a lane trace of ``max_rounds`` rows,
    `.telemetry.new_trace_lanes`, carried in the batch's ``extra``) and
    the lanes' traces come back third, stacked in lane order: lane k's
    is its solo run's trace (rows past its exit stay zero).  JAX:
    ``jax.vmap`` of ``packed.py:911 run_packed`` and ``:1027
    run_packed_faults`` in ``campaign/ensemble.py:114 run_ensemble``, whose
    batched while_loop runs every lane to the slowest; here a finished
    lane leaves the batch, so a round costs the live lanes' share of K
    times the solo round's bytes and hashes."""
    check_packed_lanes(cfg, topo, fplan)
    dev = states.have.device
    k_lanes = states.have.shape[0]
    region = regions(cfg.n_nodes, topo.n_regions, dev)
    activity = None
    if fplan is not None:
        if seeds is None:
            seeds = torch.full((k_lanes,), int(fplan.seed),
                               dtype=torch.int32, device=dev)
        activity = host_activity(fplan)
    trace = (new_trace_lanes(cfg, max_rounds, k_lanes, dev) if telemetry
             else None)
    batch = packed_lane_batch(states, cfg, None if fplan is None else seeds,
                              trace)

    last_round = int(meta.round.max())
    finished = _run_batch(
        batch, max_rounds, _initial_done(batch, meta, cfg, fplan),
        lambda b: packed_lane_step(b, meta, cfg, topo, region, fplan,
                                   activity, telemetry,
                                   last_round=last_round))
    finals, metrics = _stack_results(finished, cfg)
    if telemetry:
        return finals, metrics, stack_traces(finished)
    return finals, metrics


def _initial_done(batch: _Batch, meta: PayloadMeta, cfg: SimConfig,
                  fplan) -> torch.Tensor:
    """The lanes' exit flags before the first round (the solo loops'
    `_converged_done`, or the fault loop's false before its horizon)."""
    slim, metrics = batch.slim, batch.metrics
    t = int(slim.t)
    up = slim.alive == ALIVE
    if fplan is not None:
        if t < fplan.horizon:
            return torch.zeros(up.shape[0], dtype=torch.bool,
                               device=up.device)
        c = cfg.chunks_per_version
        comp_w = all_chunks_words(batch.carry.have, cfg)
        act_w = smear_groups(fold_any(batch.inj, c)
                             & group_low_bits_mask(c), c)
        node_done = ((comp_w | ~act_w[:, None, :]) == ONES).all(dim=2) | ~up
        return (meta.round <= t).all() & node_done.all(dim=1)
    all_injected = (meta.round <= t).all()
    return all_injected & ((metrics.converged_at >= 0) | ~up).all(dim=1)
