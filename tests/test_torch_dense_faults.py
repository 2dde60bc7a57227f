"""Fault plans on the port's dense round and on full-view SWIM
(corrosion_tpu_torch/sim/faults.py ``run_fault_plan`` off the packed
envelope, ``round_step(faults=)``, broadcast.py, sync.py and swim.py's
fault branches) against the live JAX reference, exact: every field in
JAX's dtypes, the flight recorder's channels too (every payload is
8 KiB, so the f32 byte rows are exact sums on both sides).

First the pieces, each from a state made with numpy from a seed: the
node faults (a wiped node's full-view row back to its init, the repair
of this slice), the broadcast's fault branch (both loss streams, a cut,
a fixed delay, jitter bounds 0, 1 and 4), the sync's (a one-way cut
refusing sessions, session delays up to D - 2), full-view SWIM's reach
and the fault loop's exit predicate (a wipe after convergence).  Then
whole runs: tests/sim/test_topo.py's 12-node fault run, the five
48-node plans of tests/sim/test_packed_equivalence.py round by round,
the fault campaign's demo plan with and without the recorder, and a
64-node full-view storm.  JAX compiles its default form — the matrix
plan below 1024 nodes — and the port the factored one, which JAX pins
as equal (tests/sim/test_fault_plan.py).  ``-m slow`` re-derives the
goldens chip_smoke.py holds the card to (the dense 100k fault storm and
its trace, the dense 100k latency storm, the 4096-node full-view storm)
from live JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import broadcast as jbc
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import sync as jsync
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.state import SimConfig as JaxSimConfig
from corrosion_tpu.sim.state import uniform_payloads as jax_uniform_payloads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import (
    fault_plan_from_numpy,
    meta_from_numpy,
    state_digest,
)
from corrosion_tpu_torch.sim import broadcast, faults, swim, sync, telemetry
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim.fused import grant_fold
from corrosion_tpu_torch.sim.runner import fault_storm
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import (
    FAULT_PLANS_48,
    assert_fields_equal,
    assert_metrics_equal,
    assert_states_equal,
    demo_events,
    fields,
    jax_digest,
    jax_telemetry,
    plan_pair,
    port_config,
    to_port,
)


def _metas(jcfg, **kw):
    jmeta = jax_uniform_payloads(jcfg, **kw)
    return jmeta, meta_from_numpy(fields(jmeta), "cpu")


def _key(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _factored(jplan, jcfg, topo=JaxTopology()):
    """JAX's factored plan and the very same plan on the port."""
    jf = jfaults.compile_plan(jplan, jcfg, topo, factored=True)
    return jf, fault_plan_from_numpy(fields(jf), "cpu")


def _mid_run_state(jcfg, g, seed, t):
    """A JAX dense state at round t with numpy-random payload rows, relay
    budgets, rings, bookkeeping, countdowns and (full view) beliefs —
    inputs for one phase — and the port's copy."""
    s = jround.new_sim(jcfg, seed)
    n, p = jcfg.n_nodes, jcfg.n_payloads
    d, a, k = jcfg.n_delay_slots, jcfg.n_writers, jcfg.gap_slots
    u8 = np.uint8
    v = jcfg.n_payloads // (a * jcfg.chunks_per_version)
    lo = g.integers(0, v + 1, (n, a, k)).astype(np.int32)
    rep = dict(
        t=jnp.int32(t),
        have=jnp.asarray((g.random((n, p)) < 0.5).astype(u8)),
        injected=jnp.asarray((g.random(p) < 0.8).astype(u8)),
        relay_left=jnp.asarray(g.integers(0, 4, (n, p)).astype(u8)),
        inflight=jnp.asarray((g.random((d, n, p)) < 0.1).astype(u8)),
        sync_inflight=jnp.asarray((g.random((d, n, p)) < 0.1).astype(u8)),
        sync_countdown=jnp.asarray(g.integers(-1, 3, n).astype(np.int32)),
        heads=jnp.asarray(g.integers(0, v + 1, (n, a)).astype(np.int32)),
        gap_lo=jnp.asarray(lo),
        gap_hi=jnp.asarray(np.minimum(lo + g.integers(0, 3, lo.shape),
                                      v).astype(np.int32)),
    )
    if jcfg.swim_full_view:
        rep.update(
            view=jnp.asarray(g.integers(0, 3, (n, n)).astype(np.int8)),
            vinc=jnp.asarray(g.integers(0, 3, (n, n)).astype(np.int32)),
            suspect_since=jnp.asarray(
                np.where(g.random((n, n)) < 0.3, g.integers(0, t + 1, (n, n)),
                         -1).astype(np.int32)),
            incarnation=jnp.asarray(g.integers(0, 3, n).astype(np.uint32)),
        )
    s = s._replace(**rep)
    return s, to_port(s, port_config(jcfg))


# -- the pieces ------------------------------------------------------------------


def _empty_factors(n):
    def z(*shape, dtype=torch.bool):
        return torch.zeros(shape, dtype=dtype)

    return dict(block_on=z(0), block_src=z(0, n), block_dst=z(0, n),
                loss_on=z(0), loss_src=z(0, n), loss_dst=z(0, n),
                loss_thr=z(0, dtype=torch.uint8), delay_on=z(0),
                delay_src=z(0, n), delay_dst=z(0, n),
                delay_rounds=z(0, dtype=torch.int32), jitter_on=z(0),
                jitter_src=z(0, n), jitter_dst=z(0, n),
                jitter_rounds=z(0, dtype=torch.int32))


@pytest.mark.parametrize("kind", ("partial", "full"))
def test_wiped_node_rows_match_jax(kind):
    """tests/sim/test_pswim_faults.py's 6-node wipe (node 2, node 4 held
    down): the full view's row goes back to view 0, vinc 0,
    suspect_since -1 — the row the port left as it was before this
    slice — and every payload row, ring slot, bookkeeping row and member
    table as JAX's."""
    n = 6
    if kind == "partial":
        jcfg = JaxSimConfig.wan_tuned(n, n_payloads=8, swim_partial_view=True,
                                      member_slots=4, n_delay_slots=3)
    else:
        jcfg = JaxSimConfig(n_nodes=n, n_payloads=8, fanout=2,
                            swim_full_view=True, n_delay_slots=3)
    jstate, pstate = _mid_run_state(jcfg, np.random.default_rng(6), 1, 5)
    alive = np.full(n, -1, np.int8)
    alive[4] = 1
    wipe = np.arange(n) == 2
    jrf = jfaults.RoundFaults(
        block=jnp.zeros((n, n), bool), loss=jnp.zeros((n, n), jnp.uint8),
        delay=jnp.zeros((n, n), jnp.uint8),
        jitter=jnp.zeros((n, n), jnp.uint8), alive=jnp.asarray(alive),
        wipe=jnp.asarray(wipe), seed=jnp.int32(0))
    prf = faults.FactoredRoundFaults(
        alive=torch.from_numpy(alive), wipe=torch.from_numpy(wipe),
        seed=torch.tensor(0, dtype=torch.int32), **_empty_factors(n))
    want = jfaults.apply_node_faults(jstate, jrf)
    got = faults.apply_node_faults(pstate, prf)
    assert_states_equal(want, got, f"wipe[{kind}]")
    if kind == "full":
        assert (np.asarray(want.view)[2] == 0).all()
        assert (np.asarray(jstate.view)[2] != 0).any()  # the reset shows
        assert (np.asarray(want.suspect_since)[2] == -1).all()


def _broadcast_plan(ev):
    """Both loss streams, a one-way cut, a fixed delay and jitter bounds
    1 and 4 (bounds of 0 everywhere else), at 48 nodes."""
    return (
        ev("loss", 0, 10, p=0.3),
        ev("partition", 0, 10, src="0:12", dst="12:24"),
        ev("delay", 0, 10, src="24:36", dst="*", delay_rounds=1),
        ev("jitter", 0, 10, src="36:48", dst="*", delay_rounds=4),
        ev("jitter", 0, 10, src="24:30", dst="*", delay_rounds=1),
    )


@pytest.mark.parametrize("loss", (0.0, 0.2))
@pytest.mark.parametrize("t", (3, 12))
def test_broadcast_fault_branch_matches_jax(loss, t):
    """``broadcast_step`` under the plan's slice (round 3: every class on;
    12: past the plan, no factor applies) with the flat topology loss
    off and on: the ring, the relay budgets and the wire telemetry (cut
    edges, lost frames of both streams, frames and bytes) equal JAX's."""
    jcfg = JaxSimConfig(n_nodes=48, n_payloads=24, n_writers=2,
                        chunks_per_version=3, fanout=3, n_delay_slots=8)
    pcfg = port_config(jcfg)
    jtopo, ptopo = JaxTopology(loss=loss), Topology(loss=loss)
    jplan, _ = plan_pair(48, 4, _broadcast_plan)
    jf, pf = _factored(jplan, jcfg, jtopo)
    jmeta, pmeta = _metas(jcfg, inject_every=1)
    jstate, pstate = _mid_run_state(jcfg, np.random.default_rng(t), 2, t)
    jkey, pkey = _key(t)
    jrf = jfaults.round_faults(jf, jnp.int32(t))
    with jax_telemetry():  # telem=True imports JAX's recorder
        want, tel = jbc.broadcast_step(
            jstate, jmeta, jcfg, jtopo, jax_regions(48, 1), jkey, jrf,
            telem=True)
    trace = telemetry.new_trace(pcfg, 4, "cpu")
    got = broadcast.broadcast_step(
        pstate, pmeta, pcfg, ptopo, regions(48, 1, "cpu"), pkey,
        faults.round_faults(pf, t), trace=trace)
    assert_states_equal(want, got, f"broadcast t={t}")
    acc = {name: int(telemetry.acc_slot(trace, name))
           for name in ("bcast_frames", "bcast_cut", "bcast_dropped")}
    assert acc == {"bcast_frames": int(tel.frames), "bcast_cut": int(tel.cut),
                   "bcast_dropped": int(tel.dropped)}
    assert float(telemetry.acc_slot(trace, "bcast_bytes")) == float(tel.bytes)
    if t == 3:
        assert acc["bcast_cut"] > 0 and acc["bcast_dropped"] > 0


def _sync_plan(ev):
    """A one-way cut (sessions refused from both ends) and delays that
    add to 3 = D - 2 rounds on the links into nodes 0:4 from 16:24."""
    return (
        ev("partition", 0, 10, src="0:8", dst="8:16"),
        ev("delay", 0, 10, src="16:24", dst="*", delay_rounds=2),
        ev("delay", 0, 10, src="*", dst="0:4", delay_rounds=1),
    )


@pytest.mark.parametrize("budget", (None, 3 * 8192))
def test_sync_fault_branch_matches_jax(budget):
    """``sync_step`` under cuts and session delays (0, 1, 2 and 3 = D - 2
    rounds), unmetered and under a byte budget that binds: the sync
    ring's slots, the countdowns and backoffs, the sessions, the refused
    count (taken before the cut clears them) and the grant fold equal
    JAX's."""
    jcfg = JaxSimConfig(n_nodes=48, n_payloads=24, n_writers=2,
                        chunks_per_version=3, fanout=3, n_delay_slots=5,
                        sync_budget_bytes=budget)
    pcfg = port_config(jcfg)
    jplan, _ = plan_pair(48, 4, _sync_plan)
    jf, pf = _factored(jplan, jcfg)
    jmeta, pmeta = _metas(jcfg, inject_every=1)
    jstate, pstate = _mid_run_state(jcfg, np.random.default_rng(9), 3, 4)
    jkey, pkey = _key(4)
    rf = faults.round_faults(pf, 4)
    with jax_telemetry():
        want, tel = jsync.sync_step(jstate, jmeta, jcfg, JaxTopology(), jkey,
                                    jfaults.round_faults(jf, jnp.int32(4)),
                                    telem=True)
    trace = telemetry.new_trace(pcfg, 4, "cpu")
    got, ok = sync.sync_step(pstate, pmeta, pcfg, Topology(), pkey, rf,
                             trace=trace)
    assert_states_equal(want, got, "sync")
    assert int(ok.sum()) == int(tel.sessions)
    assert int(telemetry.acc_slot(trace, "sync_refused")) == int(tel.refused)
    frames, byte_tot = grant_fold(trace.counts[telemetry.GRANTS],
                                  pmeta.nbytes)
    assert int(frames) == int(tel.frames)
    assert float(byte_tot) == float(tel.bytes)
    src = torch.arange(16, 24, dtype=torch.int32)
    sdelay = faults.fault_session_delay(rf, src, src % 4)
    assert int(sdelay.max()) == jcfg.n_delay_slots - 2
    assert int(tel.refused) > 0


def test_full_view_swim_fault_branch_matches_jax():
    """Full-view ``swim_step`` under a cut and probe loss: every reach it
    asks (the direct probe, both relay legs, gossip, announce) takes the
    plan's cuts and loss draws (fold_in 103 on each leg's key), and the
    beliefs and incarnations equal JAX's."""
    jcfg = JaxSimConfig(n_nodes=40, n_payloads=8, fanout=3,
                        swim_full_view=True, n_delay_slots=3)
    jplan, _ = plan_pair(40, 8, lambda ev: (
        ev("loss", 0, 10, p=0.5),
        ev("partition", 0, 10, src="0:20", dst="20:40")))
    jf, pf = _factored(jplan, jcfg)
    jstate, _ = _mid_run_state(jcfg, np.random.default_rng(2), 4, 6)
    pcfg = port_config(jcfg)
    for seed in range(3):
        jkey, pkey = _key(seed)
        want = jswim.swim_step(jstate, jcfg, JaxTopology(), jkey,
                               jfaults.round_faults(jf, jnp.int32(6)))
        got = swim.swim_step(to_port(jstate, pcfg), pcfg, Topology(), pkey,
                             faults.round_faults(pf, 6))
        assert_states_equal(want, got, f"swim seed={seed}")
    plain = jswim.swim_step(jstate, jcfg, JaxTopology(), jkey)
    assert not np.array_equal(np.asarray(plain.view), np.asarray(want.view))


@pytest.mark.parametrize("t, horizon", ((9, 5), (3, 5), (4, 5)))
def test_dense_exit_mode_matches_jax_done(t, horizon):
    """K14's exit mode (`round.dense_record_plain` with the horizon) and
    `faults.all_have`: the fault loop's ``_done`` after round t — t + 1
    >= horizon and every up node holding every active version fresh —
    where one node was wiped after its sticky stamp (so the plain mode
    would exit and the fault loop must not), then with the wipe
    healed."""
    jcfg = JaxSimConfig(n_nodes=30, n_payloads=24, n_writers=2,
                        chunks_per_version=3, n_delay_slots=3)
    pcfg = port_config(jcfg)
    jmeta, pmeta = _metas(jcfg, inject_every=0)
    n, p = 30, 24
    have = np.ones((n, p), np.uint8)
    have[7, :5] = 0  # wiped after it converged
    alive = np.zeros(n, np.uint8)
    alive[11] = 1
    converged = np.full(n, 2, np.int32)
    metrics = pround.RunMetrics(
        coverage_at=torch.full((p,), 2, dtype=torch.int32),
        converged_at=torch.from_numpy(converged),
        overflow_frac=torch.zeros((), dtype=torch.float32),
        order_violations=torch.zeros((), dtype=torch.int32))
    for h in (have, np.ones_like(have)):
        jstate = jround.new_sim(jcfg, 0)._replace(
            have=jnp.asarray(h), injected=jnp.ones(p, jnp.uint8),
            alive=jnp.asarray(alive), t=jnp.int32(t + 1))
        fresh = bool(jfaults._all_have(jstate, jmeta, jcfg))
        assert bool(faults.all_have(to_port(jstate, pcfg), pmeta,
                                    pcfg)) == fresh
        want = (t + 1 >= horizon) and fresh
        args = (torch.from_numpy(h), torch.ones(p, dtype=torch.uint8),
                torch.from_numpy(alive), metrics, pmeta, t, pcfg)
        got = pround.dense_record_plain(*args, horizon=horizon)
        assert bool(got[-1]) == want
        sticky = pround.dense_record_plain(*args)
        assert bool(sticky[-1])  # the sticky stamps say converged
        assert all(torch.equal(x, y) for x, y in zip(got[:-1], sticky[:-1]))


# -- whole runs ------------------------------------------------------------------


def test_topo_12_node_fault_run_matches_jax():
    """tests/sim/test_topo.py's fault run (12 nodes, P = 12, loss, a
    symmetric cut, a crash-with-wipe; plan seed 7, sim seed 7) through
    `run_fault_plan`: the dense round, JAX's matrix plan against the
    port's factored one — the live digest, not the constant pinned
    there, which jax 0.9.0 no longer reproduces."""
    kw = dict(n_nodes=12, n_payloads=12, fanout=2, sync_interval_rounds=4,
              n_delay_slots=4)
    jcfg = JaxSimConfig(**kw)
    pcfg = port_config(jcfg)
    jplan, pplan = plan_pair(12, 7, lambda ev: (
        ev("loss", 0, 12, p=0.3),
        ev("partition", 2, 8, src="0:4", dst="8:12", symmetric=True),
        ev("crash", 6, 10, node=1, wipe=True)))
    jmeta, pmeta = _metas(jcfg, inject_every=1)
    jfinal, jmet = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 7), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jplan, jcfg, JaxTopology()), 300)
    pfinal, pmet = faults.run_fault_plan(
        pround.new_sim(pcfg, 7, "cpu"), pmeta, pcfg, Topology(),
        faults.compile_plan(pplan, pcfg, Topology(), factored=True,
                            device="cpu"), 300)
    assert jax_digest(jfinal) == state_digest(pfinal)
    assert int(pfinal.t) >= 10  # the loop ran past the plan's horizon
    assert_metrics_equal(jmet, pmet, "metrics")


def _lockstep_cfg():
    """tests/sim/test_packed_equivalence.py's ``_fault_cfg``, its dense
    round (the port's u8 ring: ``allow_packed=False``)."""
    return JaxSimConfig.wan_tuned(
        48, n_payloads=128, n_writers=4, chunks_per_version=4, fanout=3,
        sync_interval_rounds=4, swim_partial_view=True, member_slots=16,
        rate_limit_bytes_round=None, sync_budget_bytes=None,
        packed_min_cells=0, n_delay_slots=4, allow_packed=False)


@pytest.mark.parametrize("kind", sorted(FAULT_PLANS_48))
def test_fault_plans_48_dense_lockstep_match_jax(kind):
    """The five 48-node plans of JAX's packed == dense test on the dense
    round, round by round for 30 rounds: node faults, then
    ``round_step(faults=)`` — JAX's jitted matrix-plan round against the
    port's factored one; every field of the state and the metrics equal
    after every round."""
    jcfg = _lockstep_cfg()
    pcfg = port_config(jcfg)
    topo, ptopo = JaxTopology(), Topology()
    jplan, pplan = plan_pair(48, 5, FAULT_PLANS_48[kind])
    jf = jfaults.compile_plan(jplan, jcfg, topo, factored=False)
    pf = faults.compile_plan(pplan, pcfg, ptopo, factored=True, device="cpu")
    jmeta, pmeta = _metas(jcfg, inject_every=2)
    region, pregion = jax_regions(48, 1), regions(48, 1, "cpu")

    @jax.jit
    def dense(state, metrics):
        rf = jfaults.round_faults(jf, state.t)
        state = jfaults.apply_node_faults(state, rf)
        return jround.round_step(state, metrics, jmeta, jcfg, topo, region,
                                 faults=rf)

    js, jm = jround.new_sim(jcfg, 9), jround.new_metrics(jcfg)
    ps, pm = to_port(js, pcfg), pround.new_metrics(pcfg, "cpu")
    for t in range(30):
        js, jm = dense(js, jm)
        rf = faults.round_faults(pf, t)
        ps = faults.apply_node_faults(ps, rf)
        ps, pm = pround.round_step(ps, pm, pmeta, pcfg, ptopo, pregion,
                                   faults=rf)
        assert_states_equal(js, ps, f"{kind} round {t}")
        assert_metrics_equal(jm, pm, f"{kind} round {t}")


def _demo_cfg():
    """``fault_campaign_3node_spec``'s scenario (3 nodes, P = 16)."""
    return JaxSimConfig(n_nodes=3, n_payloads=16, fanout=2,
                        sync_interval_rounds=4, n_delay_slots=4)


@pytest.mark.parametrize("record", (False, True))
def test_demo_plan_3_node_matches_jax(record):
    """The fault campaign's demo plan (``corrosion_tpu/faults.py``
    ``demo_plan(3)``: a loss burst, an asymmetric cut, delay and jitter
    on the link 0 -> 1, the last node crashed and wiped in the final
    third) on its 3-node scenario through `run_fault_plan`, with and
    without the flight recorder: the final state, the metrics and every
    RoundTrace channel equal JAX's."""
    jcfg = _demo_cfg()
    pcfg = port_config(jcfg)
    jplan, pplan = plan_pair(3, 0, demo_events)
    jmeta, pmeta = _metas(jcfg, inject_every=1)
    jfp = jfaults.compile_plan(jplan, jcfg, JaxTopology())
    pfp = faults.compile_plan(pplan, pcfg, Topology(), factored=True,
                              device="cpu")
    pout = faults.run_fault_plan(pround.new_sim(pcfg, 0, "cpu"), pmeta, pcfg,
                                 Topology(), pfp, 1000, record)
    if record:
        with jax_telemetry():
            jout = jfaults.run_fault_plan(
                jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp,
                1000, telemetry=True)
            want = {f: np.asarray(getattr(jout[2], f))
                    for f in telemetry.CHANNELS}
        for f in telemetry.CHANNELS:
            got = getattr(pout[2], f).numpy()
            assert got.dtype == want[f].dtype, f
            np.testing.assert_array_equal(got, want[f], err_msg=f)
        rounds = int(pout[0].t)
        assert want["wipes"][:rounds].sum() == 1
        assert want["bcast_dropped"][:rounds].any()
    else:
        jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 0), jmeta, jcfg,
                                      JaxTopology(), jfp, 1000)
    assert jax_digest(jout[0]) == state_digest(pout[0])
    assert_metrics_equal(jout[1], pout[1], "metrics")
    assert int(pout[0].t) >= jplan.horizon


def _full_view_storm(n, n_payloads=512):
    jcfg, jmeta = jax_write_storm(n, n_payloads)
    return dataclasses.replace(jcfg, swim_partial_view=False,
                               swim_full_view=True, allow_packed=False), jmeta


@pytest.mark.parametrize("record", (False, True))
def test_full_view_fault_storm_64_matches_jax(record):
    """The full-view fault storm at 64 nodes (the 4096-node card path's
    config cut to size: ``_write_storm(64, 128)`` on full-view SWIM and
    the dense round, ``storm_fault_plan(64, 3)``, sim seed 7) through
    `run_fault_plan`: state, metrics and trace equal JAX's; the port's
    setup `fault_storm` builds the same config."""
    jcfg, jmeta = _full_view_storm(64, 128)
    pcfg, pmeta, pfp = fault_storm(
        64, 128, 3, "cpu", factored=True, swim_partial_view=False,
        swim_full_view=True, allow_packed=False)
    assert pcfg == port_config(jcfg)
    assert_fields_equal(fields(jmeta), fields(pmeta), "meta")
    from corrosion_tpu.sim.runner import storm_fault_plan as jplan_of

    jfp = jfaults.compile_plan(jplan_of(64, 3), jcfg, JaxTopology())
    pout = faults.run_fault_plan(pround.new_sim(pcfg, 7, "cpu"), pmeta, pcfg,
                                 Topology(), pfp, 500, record)
    if record:
        with jax_telemetry():
            jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 7), jmeta,
                                          jcfg, JaxTopology(), jfp, 500,
                                          telemetry=True)
            want = {f: np.asarray(getattr(jout[2], f))
                    for f in telemetry.CHANNELS}
        for f in telemetry.CHANNELS:
            np.testing.assert_array_equal(getattr(pout[2], f).numpy(),
                                          want[f], err_msg=f)
        assert want["swim_suspect"].any() and want["bcast_cut"].any()
    else:
        jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 7), jmeta, jcfg,
                                      JaxTopology(), jfp, 500)
    assert jax_digest(jout[0]) == state_digest(pout[0])
    assert_metrics_equal(jout[1], pout[1], "metrics")


def test_dense_fault_entry_points_default_to_the_card():
    """`fault_storm` (and through it the dense and full-view storms)
    places its tensors on the card unless the caller asks for the CPU,
    and refuses without one; below 1024 nodes it compiles JAX's default,
    the matrix plan, now ported (tests/test_torch_matrix_faults.py)."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fault_storm(64, 128, allow_packed=False)
    cfg, _, fplan = fault_storm(64, 128, device="cpu", allow_packed=False)
    assert isinstance(fplan, faults.SimFaultPlan)
    from corrosion_tpu_torch.sim.runner import storm_fault_plan

    assert isinstance(faults.compile_plan(storm_fault_plan(64, 0), cfg,
                                          device="cpu"), faults.SimFaultPlan)


# -- the card's goldens, from live JAX -------------------------------------------


@pytest.mark.slow
def test_dense_fault_storm_100k_golden_matches_live_jax():
    """``DENSE_FAULT_STORM_100K_SEED0`` and its telemetry entry (what
    chip_smoke.py holds the card to) from live JAX: the 100k fault storm
    on the dense round (about a minute each on 8 cores)."""
    jcfg, jmeta = jax_write_storm(100_000, 512)
    jcfg = dataclasses.replace(jcfg, allow_packed=False)
    from corrosion_tpu.sim.runner import storm_fault_plan as jplan_of

    jfp = jfaults.compile_plan(jplan_of(100_000, 0), jcfg, JaxTopology())
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000)
    assert goldens.DENSE_FAULT_STORM_100K_SEED0 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99),
        "digest": jax_digest(final),
    }
    with jax_telemetry() as jtel:
        final, _, trace = jfaults.run_fault_plan(
            jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000,
            telemetry=True)
        rounds = int(final.t)
        summary = jtel.trace_summary(jtel.trace_host(trace, rounds), rounds,
                                     jcfg)
    golden = goldens.DENSE_FAULT_STORM_100K_SEED0_TELEMETRY
    assert golden["summary"] == {k: v for k, v in summary.items()
                                 if k != "wire_bytes"}
    assert golden["wire_bytes"] == summary["wire_bytes"]
    for channel in ("bcast_bytes", "sync_bytes"):
        assert golden[channel] == [
            float(x) for x in np.asarray(getattr(trace, channel))[:rounds]]


@pytest.mark.slow
def test_dense_latency_storm_100k_golden_matches_live_jax():
    """``DENSE_LATENCY_STORM_100K_SEED0`` from live JAX: the latency storm
    (tests/torch_parity.py ``latency_storm_plans``, four delay slots) on
    the dense round (about two minutes on 8 cores)."""
    from tests.torch_parity import latency_storm_plans

    jcfg, jmeta = jax_write_storm(100_000, 512)
    jcfg = dataclasses.replace(jcfg, n_delay_slots=4, allow_packed=False)
    jplan, _ = latency_storm_plans(100_000, 0)
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jplan, jcfg, JaxTopology()), 3000)
    assert goldens.DENSE_LATENCY_STORM_100K_SEED0 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99),
        "digest": jax_digest(final),
    }


@pytest.mark.slow
def test_full_view_fault_storm_4096_golden_matches_live_jax():
    """``FULL_VIEW_FAULT_STORM_4096_SEED7`` from live JAX: JAX's 4096-node
    acceptance storm (tests/sim/test_packed_equivalence.py) on full-view
    SWIM and the dense round (about 15 s on 8 cores)."""
    jcfg, jmeta = _full_view_storm(4096)
    from corrosion_tpu.sim.runner import storm_fault_plan as jplan_of

    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 7), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jplan_of(4096, 3), jcfg, JaxTopology()), 1000)
    assert goldens.FULL_VIEW_FAULT_STORM_4096_SEED7 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99),
        "digest": jax_digest(final),
    }
