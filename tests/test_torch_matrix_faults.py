"""Matrix fault plans on the port (corrosion_tpu_torch/sim/faults.py
``SimFaultPlan``/``RoundFaults``, ``compile_plan(factored=False)`` — JAX's
form below 1024 nodes — and ``run_fault_plan_checked`` with the sim
invariant catalog) against the live JAX reference, exact.

First the compiled plan: every slab, ``alive``, ``wipe``, ``seed`` and
the None class structure byte-equal to JAX's ``compile_plan(...,
factored=False)`` for the fault campaign's demo plan, the fault-parity
plan, the five 48-node plans, the 128-node fault storm, overlapping
losses that fold to a cut and a range-selector crash with wipe; JAX's
refusals; the host schedule (``schedule_at``, ``active_kinds_at``,
``coverage_markers``); the per-edge queries at random edge lists with
(x, x) legs, against JAX's matrix queries and the port's own factored
form.  Then whole runs: the five 48-node plans round by round on the
dense and the packed round, the 3-node fault campaign with and without
the flight recorder, the eight fault-parity seeds, the 64-node
full-view storm, and the checked driver's digests, replay, markers and
invariant messages.  ``-m slow`` re-derives the card's goldens
(fault-storm-1000, the 3-node campaign, the packed 4096 storm) from
live JAX.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu import faults as jfaults_mod
from corrosion_tpu import invariants as jinvariants
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import invariants as jinv
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_plan
from corrosion_tpu.sim.state import SimConfig as JaxSimConfig
from corrosion_tpu.sim.state import uniform_payloads as jax_uniform_payloads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import faults as pfaults_mod
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import (
    fault_plan_from_numpy,
    meta_from_numpy,
    state_digest,
)
from corrosion_tpu_torch.invariants import Catalog
from corrosion_tpu_torch.sim import faults, packed, telemetry
from corrosion_tpu_torch.sim import invariants as pinv
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim.runner import (
    config_packed_fault_storm,
    fault_storm,
    storm_fault_plan,
)
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import (
    FAULT_PLANS_48,
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

# -- plans and configurations ---------------------------------------------------


def _parity_events(ev):
    """``campaign/spec.py`` ``fault_parity_3node_spec``'s events: with a
    ``duplicate`` (a no-op in the sim) and a ``clock_skew`` (host only)."""
    return (
        ev("loss", 0, 36, p=0.4),
        ev("partition", 6, 18, src=2, dst=0),
        ev("delay", 4, 24, src=0, dst=1, delay_rounds=1),
        ev("jitter", 4, 24, src=0, dst=1, delay_rounds=1),
        ev("duplicate", 0, 24, src=1, dst=2, p=0.3),
        ev("crash", 24, 34, node=2, wipe=True),
        ev("clock_skew", 0, 36, node=1, skew_ns=100_000_000),
    )


def _overlap_events(ev):
    """Three overlapping losses (0.9, 0.95, 0.99: where all three meet the
    fold reaches 256 — a cut), a symmetric partition whose rectangle
    overlaps its transpose, delays that add and jitters that take the
    max, at 12 nodes."""
    return (
        ev("loss", 0, 8, src="0:6", dst="*", p=0.9),
        ev("loss", 2, 10, src="*", dst="0:8", p=0.95),
        ev("loss", 3, 6, src="3:9", dst="2:12", p=0.99),
        ev("partition", 1, 4, src="0:8", dst="4:12", symmetric=True),
        ev("delay", 0, 5, src="0:6", dst="*", delay_rounds=2),
        ev("delay", 1, 7, src="*", dst="3:9", delay_rounds=1),
        ev("jitter", 0, 6, src="0:4", dst="*", delay_rounds=1),
        ev("jitter", 2, 9, src="2:12", dst="0:6", delay_rounds=2),
    )


def _range_crash_events(ev):
    """A range-selector crash with wipe overlapping a single-node one."""
    return (
        ev("crash", 2, 7, node="10:20", wipe=True),
        ev("crash", 4, 9, node=15),
        ev("loss", 0, 5, src="0:10", dst="10:40", p=0.25),
    )


def _demo48(ev):
    return demo_events(ev, 48)


#: name -> (n_nodes, seed, events(FaultEvent), n_delay_slots)
PLANS = {
    "demo-3": (3, 0, demo_events, 4),
    "demo-48": (48, 0, _demo48, 4),
    "parity-3": (3, 0, _parity_events, 4),
    **{f"plan48-{k}": (48, 5, f, 4) for k, f in FAULT_PLANS_48.items()},
    "overlap-12": (12, 4, _overlap_events, 8),
    "range-crash-40": (40, 2, _range_crash_events, 3),
}


def _plan_and_cfgs(name):
    n, seed, events, slots = PLANS[name]
    jplan, pplan = plan_pair(n, seed, events)
    jcfg = JaxSimConfig(n_nodes=n, n_payloads=8, fanout=2,
                        n_delay_slots=slots)
    return jplan, pplan, jcfg, port_config(jcfg)


def _compile_both(jplan, pplan, jcfg, pcfg, topo=JaxTopology(),
                  ptopo=Topology()):
    return (jfaults.compile_plan(jplan, jcfg, topo, factored=False),
            faults.compile_plan(pplan, pcfg, ptopo, factored=False,
                                device="cpu"))


def _plan_fields(fp) -> dict:
    """A compiled plan's fields, with None kept as None."""
    out = {}
    for name, value in zip(type(fp)._fields, fp):
        if value is None:
            out[name] = None
        elif isinstance(value, torch.Tensor):
            out[name] = value.numpy()
        else:
            out[name] = np.asarray(value)
    return out


def _assert_plans_equal(jf, pf, label):
    want, got = _plan_fields(jf), _plan_fields(pf)
    assert type(pf).__name__ == "SimFaultPlan", label
    assert want.keys() == got.keys(), label
    for name in want:
        if want[name] is None or got[name] is None:
            assert want[name] is None and got[name] is None, (label, name)
            continue
        np.testing.assert_array_equal(want[name], got[name],
                                      err_msg=f"{label}: {name}")
        assert want[name].dtype == got[name].dtype, (label, name)
    # the host copy of each round's activity, from the compiled numpy
    rows = jf.alive.shape[0]
    for r, act in enumerate(faults.host_activity(pf)):
        for cls, on in (("loss", act.loss), ("jitter", act.jitter)):
            slab = getattr(jf, cls)
            assert on == (slab is not None and bool(np.asarray(slab[r]).any()))
    assert len(faults.host_activity(pf)) == rows == pf.horizon + 1


# -- the compiled plan ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
def test_matrix_compile_matches_jax(name):
    """Every slab, alive, wipe, seed and the None structure equal JAX's
    ``compile_plan(..., factored=False)``; ``convert.fault_plan_from_numpy``
    carries JAX's plan across unchanged."""
    jplan, pplan, jcfg, pcfg = _plan_and_cfgs(name)
    jf, pf = _compile_both(jplan, pplan, jcfg, pcfg)
    _assert_plans_equal(jf, pf, name)
    crossed = fault_plan_from_numpy(
        {k: (None if v is None else np.asarray(v)) for k, v in
         zip(jf._fields, jf)}, "cpu")
    for a, b in zip(crossed, pf):
        assert (a is None and b is None) or torch.equal(a, b), name
    for view, row in ((faults.round_faults(pf, 2).alive, pf.alive[2]),
                      (faults.round_faults(pf, 99).wipe, pf.wipe[-1])):
        assert view.data_ptr() == row.data_ptr()  # a view, never a copy
    if name == "overlap-12":
        block = np.asarray(jf.block)
        assert block[3, 3, 2] and not block[0, 3, 2]  # the fold's cut
        assert np.asarray(jf.loss)[3, 3, 2] == 0  # a cut keeps no threshold


def test_matrix_compile_storm_128_matches_jax():
    """The fault storm at 128 nodes (a half split, a loss burst, a wiped
    node): JAX's pair-by-pair expansion against the port's rectangles."""
    jcfg, _ = jax_write_storm(128, 128)
    pcfg = port_config(jcfg)
    jf = jfaults.compile_plan(jax_storm_plan(128, 0), jcfg, JaxTopology(),
                              factored=False)
    pf = faults.compile_plan(storm_fault_plan(128, 0), pcfg, Topology(),
                             factored=False, device="cpu")
    _assert_plans_equal(jf, pf, "storm-128")
    assert pf.delay is None and pf.jitter is None
    rf = faults.round_faults(pf, 50)  # past the horizon: the clear row
    assert not rf.block.any() and not rf.loss.any()
    assert rf.block.data_ptr() == pf.block[pf.horizon].data_ptr()


def _refusal(mod, compile_fn, cfg, events):
    """The message of the ValueError ``compile_fn`` raises on a 3-node
    plan of ``events`` built with ``mod``'s classes."""
    plan = mod.FaultPlan(n_nodes=3, seed=0,
                         events=tuple(events(mod.FaultEvent)))
    with pytest.raises(ValueError) as err:
        compile_fn(plan, cfg)
    return str(err.value)


@pytest.mark.parametrize("case", ("delay-overflow", "jitter-overflow",
                                  "envelope", "slow"))
def test_matrix_compile_refusals_match_jax(case):
    """A merged delay past the u8 grain (two delays of 200 on one link),
    the ring envelope (a fault delay of 6 in a 4-slot ring) and the
    `slow` gray failure raise JAX's messages."""
    events = {
        "delay-overflow": lambda ev: (
            ev("loss", 0, 3, p=0.1),
            ev("delay", 1, 4, src="0:2", dst="*", delay_rounds=200),
            ev("delay", 0, 4, src="*", dst=1, delay_rounds=200)),
        "jitter-overflow": lambda ev: (
            ev("jitter", 2, 4, src=0, dst=2, delay_rounds=255),
            ev("delay", 2, 4, src=0, dst=2, delay_rounds=1),
            ev("delay", 3, 4, src=0, dst=2, delay_rounds=255)),
        "envelope": lambda ev: (ev("delay", 0, 4, delay_rounds=6),),
        "slow": lambda ev: (ev("slow", 0, 4, node=1, delay_rounds=2),),
    }[case]
    jcfg = JaxSimConfig(n_nodes=3, n_payloads=8, fanout=2, n_delay_slots=4)
    want = _refusal(jfaults_mod, lambda p, c: jfaults.compile_plan(
        p, c, JaxTopology(), factored=False), jcfg, events)
    got = _refusal(pfaults_mod, lambda p, c: faults.compile_plan(
        p, c, Topology(), factored=False, device="cpu"), port_config(jcfg),
        events)
    assert got == want


# -- the host schedule ------------------------------------------------------------


def _links(sched):
    return {pair: dataclasses.astuple(f) for pair, f in sched.links.items()}


@pytest.mark.parametrize("name", sorted(PLANS) + ["storm-128"])
def test_schedule_matches_jax(name):
    """``schedule()`` and ``schedule_at(r)`` (links in expansion order,
    down, restart, wipe, skews), ``active_kinds()``,
    ``active_kinds_at(r)`` and ``coverage_markers()`` equal JAX's for
    every round of the plan (and one past it)."""
    if name == "storm-128":
        jplan, pplan = jax_storm_plan(128, 0), storm_fault_plan(128, 0)
    else:
        jplan, pplan, _, _ = _plan_and_cfgs(name)
    assert pplan.coverage_markers() == jplan.coverage_markers()
    assert len(pplan.schedule()) == jplan.horizon + 1
    for r, ps in enumerate(pplan.schedule() + [pplan.schedule_at(
            jplan.horizon + 1)]):
        js = jplan.schedule_at(r)
        assert list(_links(ps).items()) == list(_links(js).items()), (name, r)
        for attr in ("down", "restart", "wipe", "skews", "slow"):
            assert getattr(ps, attr) == getattr(js, attr), (name, r, attr)
        assert ps.active_kinds() == js.active_kinds(), (name, r)
        assert pplan.active_kinds_at(r) == jplan.active_kinds_at(r) \
            == js.active_kinds(), (name, r)
    assert pfaults_mod.demo_plan(48, 5) == pfaults_mod.FaultPlan(
        48, 5, demo_events(pfaults_mod.FaultEvent, 48))


# -- the per-edge queries ---------------------------------------------------------


def _edges(g, n, e=400):
    """A random edge list with (x, x) legs and every node on both ends."""
    src = g.integers(0, n, e)
    dst = np.where(g.random(e) < 0.15, src, g.integers(0, n, e))
    return (src.astype(np.int32), dst.astype(np.int32))


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("name", ("demo-48", "overlap-12", "plan48-storm-mix",
                                  "parity-3"))
def test_matrix_edge_queries_match_jax(name):
    """Every matrix query equals JAX's matrix query at the same edges in
    every round (None where JAX's is None), and the port's factored form
    (the threshold off cut edges: the matrix folds a cut edge's loss into
    its cut); the session pairings and the wire effects too."""
    jplan, pplan, jcfg, pcfg = _plan_and_cfgs(name)
    jf, pf = _compile_both(jplan, pplan, jcfg, pcfg)
    pff = faults.compile_plan(pplan, pcfg, Topology(), factored=True,
                              device="cpu")
    g = np.random.default_rng(len(name))
    n = jplan.n_nodes
    for r in range(jplan.horizon + 2):
        s, d = _edges(g, n)
        js, jd = jnp.asarray(s), jnp.asarray(d)
        ps, pd = torch.from_numpy(s), torch.from_numpy(d)
        jrf = jfaults.round_faults(jf, jnp.int32(r))
        prf, pff_r = faults.round_faults(pf, r), faults.round_faults(pff, r)
        cut = np.zeros(len(s), bool)
        for fn in ("fault_edge_block", "fault_edge_loss", "fault_edge_delay",
                   "fault_edge_jitter", "fault_session_refused",
                   "fault_session_delay"):
            want = _np(getattr(jfaults, fn)(jrf, js, jd))
            got = getattr(faults, fn)(prf, ps, pd)
            assert (want is None) == (got is None), (name, r, fn)
            if want is None:
                continue
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} r={r} {fn}")
            assert got.dtype == {np.bool_: torch.bool, np.uint8: torch.uint8,
                                 np.int32: torch.int32}[want.dtype.type]
            if fn == "fault_edge_block":
                cut = want
            fac = getattr(faults, fn)(pff_r, ps, pd).numpy()
            keep = ~cut if fn == "fault_edge_loss" else slice(None)
            np.testing.assert_array_equal(got.numpy()[keep], fac[keep],
                                          err_msg=f"{name} r={r} {fn} fac")
        ok = torch.from_numpy(g.random(len(s)) < 0.8)
        count = torch.zeros((), dtype=torch.int64)
        ok2, thr, delay, jit = faults.fault_wire_effects(prf, ps, pd,
                                                         ok.clone(), count)
        np.testing.assert_array_equal(ok2.numpy(), ok.numpy() & ~cut)
        assert int(count) == int((ok.numpy() & cut).sum())
        for got, fn in ((thr, "fault_edge_loss"), (delay, "fault_edge_delay"),
                        (jit, "fault_edge_jitter")):
            want = _np(getattr(jfaults, fn)(jrf, js, jd))
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), want)
        ok3 = ok.clone()
        refused, sdelay = faults.fault_session_effects(prf, ps, pd, ok3)
        want = _np(jfaults.fault_session_refused(jrf, js, jd))
        if want is not None:
            np.testing.assert_array_equal(ok3.numpy(), ok.numpy() & ~want)


@pytest.mark.parametrize("t", (0, 6, 40))
def test_matrix_reach_matches_jax(t):
    """`swim._reachable`'s fault branch on a matrix slice (cuts, then the
    tag-103 probe draw against the cell's threshold, with (x, x) legs):
    the port's plain reach on JAX's ``_reachable`` with every node up."""
    jplan, pplan, jcfg, pcfg = _plan_and_cfgs("plan48-storm-mix")
    jf, pf = _compile_both(jplan, pplan, jcfg, pcfg)
    jstate = jround.new_sim(jcfg, 0)
    s, d = _edges(np.random.default_rng(t), 48, 301)
    for seed in range(3):
        jkey = jax.random.PRNGKey(seed)
        want = jswim._reachable(jstate, JaxTopology(), jkey, jnp.asarray(s),
                                jnp.asarray(d),
                                jfaults.round_faults(jf, jnp.int32(t)))
        ok = torch.ones(len(s), dtype=torch.bool)
        got = faults.fault_reach_(
            ok, faults.round_faults(pf, t),
            torch.from_numpy(np.asarray(jkey).astype(np.int64)),
            torch.from_numpy(s), torch.from_numpy(d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if t == 6:
            assert not got.all()


# -- whole runs ---------------------------------------------------------------------


def _lockstep_cfg(**kw):
    """tests/sim/test_packed_equivalence.py's ``_fault_cfg``."""
    return JaxSimConfig.wan_tuned(
        48, n_payloads=128, n_writers=4, chunks_per_version=4, fanout=3,
        sync_interval_rounds=4, swim_partial_view=True, member_slots=16,
        rate_limit_bytes_round=None, sync_budget_bytes=None,
        packed_min_cells=0, n_delay_slots=4, **kw)


@pytest.mark.parametrize("kind", sorted(FAULT_PLANS_48))
def test_fault_plans_48_matrix_lockstep_match_jax(kind):
    """The five 48-node plans of JAX's packed == dense test on the matrix
    form, round by round for 30 rounds: JAX's jitted dense round against
    the port's dense round (``allow_packed=False``) and the port's packed
    round (node faults, then the round with its matrix slice); every
    state equal to JAX's each round, and the final RunMetrics."""
    jcfg = _lockstep_cfg()
    pcfg = port_config(jcfg)
    dcfg = dataclasses.replace(pcfg, allow_packed=False)
    topo, ptopo = JaxTopology(), Topology()
    jplan, pplan = plan_pair(48, 5, FAULT_PLANS_48[kind])
    jf = jfaults.compile_plan(jplan, jcfg, topo, factored=False)
    pf = faults.compile_plan(pplan, pcfg, ptopo, factored=False, device="cpu")
    jmeta = jax_uniform_payloads(jcfg, inject_every=2)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    region, pregion = jax_regions(48, 1), regions(48, 1, "cpu")
    horizon, activity = pf.horizon, faults.host_activity(pf)

    @jax.jit
    def dense(state, metrics):
        rf = jfaults.round_faults(jf, state.t)
        state = jfaults.apply_node_faults(state, rf)
        return jround.round_step(state, metrics, jmeta, jcfg, topo, region,
                                 faults=rf)

    js, jm = jround.new_sim(jcfg, 9), jround.new_metrics(jcfg)
    ds = faults._own_fault_state(pround.new_sim(dcfg, 9, "cpu"))
    dm = pround.new_metrics(dcfg, "cpu")
    ps = pround.new_sim(pcfg, 9, "cpu")
    carry, inj = packed.pack_state(ps, pcfg), packed.pack_bits(ps.injected)
    slim, pm = packed.shrink_state(ps), pround.new_metrics(pcfg, "cpu")
    last_round = int(pmeta.round.max())
    for t in range(30):
        js, jm = dense(js, jm)
        rf = faults.round_faults(pf, t)
        ds = faults.apply_node_faults(ds, rf)
        ds, dm, _ = pround.round_step_(ds, dm, pmeta, dcfg, ptopo, pregion,
                                       faults=rf)
        assert jax_digest(js) == state_digest(ds), f"{kind} dense round {t}"
        slim, carry = packed.apply_round_faults(slim, carry, rf)
        slim, carry, inj, pm, _ = packed.packed_round_step(
            slim, carry, inj, pm, pmeta, pcfg, ptopo, pregion, rf, horizon,
            None, activity[min(t, horizon)], last_round=last_round)
        full = packed.unpack_into_state(carry, slim, pcfg)._replace(
            injected=packed.unpack_bits(inj, 128).to(torch.uint8))
        assert jax_digest(js) == state_digest(full), f"{kind} packed round {t}"
    assert_metrics_equal(jm, dm, f"{kind} dense metrics")
    assert_metrics_equal(jm, pm, f"{kind} packed metrics")


def _campaign_cfg():
    """``fault_campaign_3node_spec(0)``'s scenario."""
    return JaxSimConfig(n_nodes=3, n_payloads=16, fanout=2,
                        sync_interval_rounds=4, n_delay_slots=4)


@pytest.mark.parametrize("record", (False, True))
def test_fault_campaign_3node_matches_jax(record):
    """The 3-node fault campaign (``demo_plan(seed=0)``, the matrix plan)
    through `run_fault_plan`, with and without the flight recorder: the
    rounds, final state, RunMetrics and every RoundTrace channel equal
    live JAX's (the recorder's loss channel reads the matrix slice:
    ``telemetry.wire_loss_active``)."""
    jcfg = _campaign_cfg()
    pcfg = port_config(jcfg)
    jplan = jfaults_mod.demo_plan(seed=0)
    pplan = pfaults_mod.demo_plan(seed=0)
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jfp = jfaults.compile_plan(jplan, jcfg, JaxTopology())
    pfp = faults.compile_plan(pplan, pcfg, Topology(), device="cpu")
    assert isinstance(jfp, jfaults.SimFaultPlan)
    assert isinstance(pfp, faults.SimFaultPlan)
    pout = faults.run_fault_plan(pround.new_sim(pcfg, 0, "cpu"), pmeta, pcfg,
                                 Topology(), pfp, 1000, record)
    if record:
        with jax_telemetry():
            jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 0), jmeta,
                                          jcfg, JaxTopology(), jfp, 1000,
                                          telemetry=True)
            want = {f: np.asarray(getattr(jout[2], f))
                    for f in telemetry.CHANNELS}
        for f in telemetry.CHANNELS:
            got = getattr(pout[2], f).numpy()
            assert got.dtype == want[f].dtype, f
            np.testing.assert_array_equal(got, want[f], err_msg=f)
        assert want["bcast_dropped"].any() and want["wipes"].sum() == 1
    else:
        jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 0), jmeta, jcfg,
                                      JaxTopology(), jfp, 1000)
    assert int(pout[0].t) == int(jout[0].t) == 41
    assert_states_equal(jout[0], pout[0], "campaign")
    assert_metrics_equal(jout[1], pout[1], "campaign metrics")


def test_wire_loss_active_reads_the_matrix_slice():
    """Step 0's repair: the recorder asks a matrix slice for its ``loss``
    slab (None: no loss channel), as JAX's branch does."""
    _, pplan, _, pcfg = _plan_and_cfgs("plan48-crash-wipe")
    pf = faults.compile_plan(pplan, pcfg, Topology(), factored=False,
                             device="cpu")
    assert pf.loss is None
    assert not telemetry.wire_loss_active(Topology(), faults.round_faults(
        pf, 0))
    assert telemetry.wire_loss_active(Topology(loss=0.1),
                                      faults.round_faults(pf, 0))
    _, pplan, _, pcfg = _plan_and_cfgs("plan48-loss")
    pf = faults.compile_plan(pplan, pcfg, Topology(), factored=False,
                             device="cpu")
    assert telemetry.wire_loss_active(Topology(), faults.round_faults(pf, 30))


@pytest.mark.parametrize("seed", range(8))
def test_fault_parity_seeds_match_jax(seed):
    """``fault_parity_3node_spec``'s plan (loss, an asymmetric cut, the
    latency pair, a duplicate, a wipe, a clock skew) on the spec's
    scenario, seed s driving both ``new_sim(cfg, s)`` and the plan's
    seed, as the campaign does: each solo run equal to JAX's solo run."""
    jcfg = JaxSimConfig(n_nodes=3, n_payloads=12, fanout=2,
                        sync_interval_rounds=4, n_delay_slots=4)
    pcfg = port_config(jcfg)
    jplan, pplan = plan_pair(3, 0, _parity_events)
    jplan = dataclasses.replace(jplan, seed=seed)
    pplan = dataclasses.replace(pplan, seed=seed)
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jfinal, jmet = jfaults.run_fault_plan(
        jround.new_sim(jcfg, seed), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jplan, jcfg, JaxTopology()), 400)
    pfinal, pmet = faults.run_fault_plan(
        pround.new_sim(pcfg, seed, "cpu"), pmeta, pcfg, Topology(),
        faults.compile_plan(pplan, pcfg, Topology(), device="cpu"), 400)
    assert_states_equal(jfinal, pfinal, f"seed {seed}")
    assert_metrics_equal(jmet, pmet, f"seed {seed} metrics")


def test_full_view_matrix_storm_64_matches_jax():
    """Full-view SWIM on a matrix plan: ``storm_fault_plan(64, 3)`` on
    ``_write_storm(64, 128)`` with full-view membership and the dense
    round (the port's `fault_storm` with JAX's default form), sim seed
    7: state and metrics equal live JAX's."""
    jcfg, jmeta = jax_write_storm(64, 128)
    jcfg = dataclasses.replace(jcfg, swim_partial_view=False,
                               swim_full_view=True, allow_packed=False)
    pcfg, pmeta, pfp = fault_storm(
        64, 128, 3, "cpu", swim_partial_view=False, swim_full_view=True,
        allow_packed=False)
    assert isinstance(pfp, faults.SimFaultPlan)
    jfp = jfaults.compile_plan(jax_storm_plan(64, 3), jcfg, JaxTopology())
    _assert_plans_equal(jfp, pfp, "full-view-64")
    jout = jfaults.run_fault_plan(jround.new_sim(jcfg, 7), jmeta, jcfg,
                                  JaxTopology(), jfp, 500)
    pout = faults.run_fault_plan(pround.new_sim(pcfg, 7, "cpu"), pmeta, pcfg,
                                 Topology(), pfp, 500)
    assert_states_equal(jout[0], pout[0], "full view")
    assert_metrics_equal(jout[1], pout[1], "full view metrics")
    assert (np.asarray(jout[0].view) != 0).any()


def test_fault_storm_picks_jax_form():
    """Step 0's repair: `fault_storm` lets `compile_plan` choose, as JAX's
    ``config_packed_fault_storm`` does — the matrix form below 1024 nodes
    (fault-storm-1000: [22, 1000, 1000], cut and loss), the factored one
    at 1024 — and a caller may still force either; the port's
    ``config_packed_fault_storm(n_nodes=1000)`` runs the matrix plan to
    live JAX's state, JAX's run taking the port's slabs (byte-equal to
    JAX's own compile: the compile tests above; ``-m slow`` runs JAX's
    own)."""
    cfg, meta, fp = fault_storm(1000, 512, 0, "cpu")
    assert isinstance(fp, faults.SimFaultPlan)
    assert fp.block.shape == (22, 1000, 1000) and fp.loss is not None
    assert fp.delay is None and fp.jitter is None
    assert 1000 < jfaults.FACTORED_MIN_NODES <= 1024
    _, _, big = fault_storm(1024, 512, 0, "cpu")
    assert isinstance(big, faults.FactoredFaultPlan)
    _, _, forced = fault_storm(64, 128, 0, "cpu", factored=True)
    assert isinstance(forced, faults.FactoredFaultPlan)
    record = config_packed_fault_storm(seed=0, n_nodes=1000, device="cpu",
                                       return_state=True)
    assert record["round_path"] == "dense" and record["converged"]
    jcfg, jmeta = jax_write_storm(1000, 512)
    jfp = jfaults.SimFaultPlan(**{
        k: (None if v is None else jnp.asarray(v.numpy()))
        for k, v in zip(fp._fields, fp)})
    jfinal, jmet = jfaults.run_fault_plan(jround.new_sim(jcfg, 0), jmeta,
                                          jcfg, JaxTopology(), jfp, 3000)
    assert_states_equal(jfinal, record["state"], "fault-storm-1000")
    assert_metrics_equal(jmet, record["metrics"], "fault-storm-1000 metrics")
    assert record["rounds"] == int(jfinal.t)
    assert record["p99_node_convergence_round"] == _percentile(
        np.asarray(jmet.converged_at), 99)


def test_matrix_entry_points_default_to_the_card():
    """``compile_plan(factored=False)`` and `fault_storm` place their
    tensors on the card unless the caller asks for the CPU, and refuse
    without one; the checked driver runs on its state's device."""
    if torch.cuda.is_available():
        return
    _, pplan, _, pcfg = _plan_and_cfgs("demo-3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        faults.compile_plan(pplan, pcfg, factored=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        faults.compile_plan(pplan, pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fault_storm(1000, 512)


# -- the checked driver -------------------------------------------------------------


def _checked_pair(plan_seed=0, sim_seed=0, **kw):
    jcfg = _campaign_cfg()
    pcfg = port_config(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jcat, pcat = jinvariants.Catalog(), Catalog()
    jout = jfaults.run_fault_plan_checked(
        jfaults_mod.demo_plan(seed=plan_seed), jround.new_sim(jcfg, sim_seed),
        jmeta, jcfg, catalog=jcat, **kw)
    pout = faults.run_fault_plan_checked(
        pfaults_mod.demo_plan(seed=plan_seed),
        pround.new_sim(pcfg, sim_seed, "cpu"), pmeta, pcfg, catalog=pcat,
        **kw)
    return jout, pout, jcat, pcat


def test_checked_driver_matches_jax():
    """`run_fault_plan_checked` on the 3-node campaign: JAX's per-round
    digest list entry for entry (41 rounds), its final state and metrics,
    and the coverage markers it fired (every kind of the plan, each as
    often as JAX's)."""
    jout, pout, jcat, pcat = _checked_pair(max_rounds=400)
    assert pout[2] == jout[2]
    assert len(pout[2]) == 41
    assert_states_equal(jout[0], pout[0], "checked")
    assert_metrics_equal(jout[1], pout[1], "checked metrics")
    assert pcat.report() == jcat.report()
    assert pcat.unfired_sometimes() == jcat.unfired_sometimes() == []
    assert sorted(pcat.report()) == pfaults_mod.demo_plan().coverage_markers()


def test_checked_driver_replays():
    """The replay-determinism contract (tests/sim/test_fault_plan.py's
    twin): the same seeds give the same digest list, plan seed 99 a
    different one, each equal to JAX's."""
    kw = dict(max_rounds=40, check_every=8)
    runs = [_checked_pair(sim_seed=11, **kw) for _ in range(2)]
    assert runs[0][1][2] == runs[1][1][2] == runs[0][0][2]
    jout, pout, _, _ = _checked_pair(plan_seed=99, sim_seed=11, **kw)
    assert pout[2] == jout[2]
    assert pout[2] != runs[0][1][2]


def test_catalog_matches_jax():
    """The port's invariant `Catalog` against JAX's: the same calls give
    the same report and unfired markers; a strict ``always`` raises."""
    from corrosion_tpu_torch.invariants import InvariantViolation

    cats = (jinvariants.Catalog(), Catalog())
    for cat in cats:
        cat.sometimes(False, "fault-loss-active")
        cat.sometimes(True, "fault-crash-active")
        cat.always(True, "relay-budget")
        cat.always(False, "relay-budget", {"node": 3})
    assert cats[1].report() == cats[0].report()
    assert cats[1].unfired_sometimes() == cats[0].unfired_sometimes() == [
        "fault-loss-active"]
    cats[1].strict = True
    with pytest.raises(InvariantViolation, match="relay-budget"):
        cats[1].always(False, "relay-budget")


def _corrupt(case, s, cfg):
    """A copy of JAX state ``s`` broken to violate one property."""
    have = np.asarray(s.have).copy()
    heads = np.asarray(s.heads).copy()
    lo, hi = np.asarray(s.gap_lo).copy(), np.asarray(s.gap_hi).copy()
    relay = np.asarray(s.relay_left).copy()
    injected = np.asarray(s.injected).copy()
    if case == "phantom":
        injected[5] = 0
        have[1, 5] = 1
    elif case == "heads":
        heads[2, 0] += 1
    elif case == "gaps-under":
        # node 1 loses every chunk of writer 0's version 2: a missing run
        # the gaps miss
        first = cfg.n_writers * cfg.chunks_per_version
        have[1, first:first + cfg.chunks_per_version] = 0
    elif case == "gaps-inexact":
        lo[0, 0, 0], hi[0, 0, 0] = 1, 1
    elif case == "gaps-above":
        # node 0 holds writer 0's versions 2, 4, 6 only: three missing runs
        # below its head 6 (more than K = 2 slots, so a superset may
        # cover them), covered by 1-5 — and a slot on version 7
        a, c = cfg.n_writers, cfg.chunks_per_version
        for v in range(cfg.n_versions):
            have[0, v * a * c:v * a * c + c] = v in (1, 3, 5)
        heads[0, 0] = 6
        lo[0, 0, :2], hi[0, 0, :2] = (1, 7), (5, 7)
    elif case == "relay":
        relay[0, 0] = cfg.max_transmissions + 1
    return s._replace(have=jnp.asarray(have), heads=jnp.asarray(heads),
                      gap_lo=jnp.asarray(lo), gap_hi=jnp.asarray(hi),
                      relay_left=jnp.asarray(relay),
                      injected=jnp.asarray(injected))


@pytest.mark.parametrize("case", ("phantom", "heads", "gaps-under",
                                  "gaps-inexact", "gaps-above", "relay",
                                  "dead"))
def test_check_state_raises_jax_messages(case):
    """`check_state` on a state broken to violate each property raises
    JAX's AssertionError message; on the unbroken state it passes."""
    jcfg = JaxSimConfig(n_nodes=4, n_payloads=32, n_writers=2,
                        chunks_per_version=2, fanout=2, gap_slots=2,
                        n_delay_slots=3)
    pcfg = port_config(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    s, _ = jround.run_to_convergence(jround.new_sim(jcfg, 1), jmeta, jcfg,
                                     JaxTopology(), 200)
    jinv.check_state(s, jcfg)
    pinv.check_state(to_port(s, pcfg), pcfg)
    dead = None
    if case == "dead":
        dead = np.array([False, False, True, False])
    else:
        s = _corrupt(case, s, jcfg)
    with pytest.raises(AssertionError) as want:
        jinv.check_state(s, jcfg, dead)
    with pytest.raises(AssertionError) as got:
        pinv.check_state(to_port(s, pcfg), pcfg, dead)
    assert str(got.value) == str(want.value)
    assert str(want.value).startswith({
        "phantom": "no-phantom", "heads": "bookkeeping-heads",
        "gaps-under": "bookkeeping-gaps: gap tensors under",
        "gaps-inexact": "bookkeeping-gaps: inexact",
        "gaps-above": "bookkeeping-gaps: gap covers",
        "relay": "relay-budget", "dead": "dead-nodes"}[case])


# -- the card's goldens, from live JAX ------------------------------------------------


def _golden_of(final, metrics):
    return {"rounds": int(final.t),
            "p99_node_convergence_round": _percentile(
                np.asarray(metrics.converged_at), 99),
            "digest": jax_digest(final)}


@pytest.mark.slow
def test_fault_storm_1000_golden_matches_live_jax():
    """``FAULT_STORM_1000_SEED0`` from live JAX with JAX's own matrix
    compile (its pair-by-pair expansion: about two minutes on the CPU),
    and that compile byte-equal to the port's."""
    jcfg, jmeta = jax_write_storm(1000, 512)
    jfp = jfaults.compile_plan(jax_storm_plan(1000, 0), jcfg, JaxTopology())
    _, _, pfp = fault_storm(1000, 512, 0, "cpu")
    _assert_plans_equal(jfp, pfp, "fault-storm-1000")
    final, metrics = jfaults.run_fault_plan(jround.new_sim(jcfg, 0), jmeta,
                                            jcfg, JaxTopology(), jfp, 3000)
    assert goldens.FAULT_STORM_1000_SEED0 == _golden_of(final, metrics)


@pytest.mark.slow
def test_fault_campaign_3node_goldens_match_live_jax():
    """``FAULT_CAMPAIGN_3NODE_SEED0`` and its checked entry from live
    JAX: `run_fault_plan` and `run_fault_plan_checked` on the campaign."""
    jcfg = _campaign_cfg()
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    plan = jfaults_mod.demo_plan(seed=0)
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(plan, jcfg, JaxTopology()), 1000)
    assert goldens.FAULT_CAMPAIGN_3NODE_SEED0 == _golden_of(final, metrics)
    final, _, digests = jfaults.run_fault_plan_checked(
        plan, jround.new_sim(jcfg, 0), jmeta, jcfg, max_rounds=400,
        catalog=jinvariants.Catalog())
    h = hashlib.blake2b(digest_size=8)
    for d in digests:
        h.update(d.encode())
    assert goldens.FAULT_CAMPAIGN_3NODE_SEED0_CHECKED == {
        "n_digests": len(digests), "last_digest": digests[-1],
        "digest_list": h.hexdigest()}
    assert jax_digest(final) == goldens.FAULT_CAMPAIGN_3NODE_SEED0["digest"]


@pytest.mark.slow
def test_packed_fault_storm_4096_golden_matches_live_jax():
    """``PACKED_FAULT_STORM_4096_SEED0`` from live JAX's packed run on the
    factored plan, and JAX's packed run on the port's matrix slabs (JAX's
    own matrix compile would expand 4096² pairs a round) to the same
    state (about a minute and 2 GB)."""
    jcfg, jmeta = jax_write_storm(4096, 512)
    jcfg = dataclasses.replace(jcfg, packed_min_cells=0)
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jax_storm_plan(4096, 0), jcfg, JaxTopology(),
                             factored=True), 3000)
    assert goldens.PACKED_FAULT_STORM_4096_SEED0 == _golden_of(final, metrics)
    pfp = faults.compile_plan(storm_fault_plan(4096, 0), port_config(jcfg),
                              Topology(), factored=False, device="cpu")
    jfp = jfaults.SimFaultPlan(**{
        k: (None if v is None else jnp.asarray(v.numpy()))
        for k, v in zip(pfp._fields, pfp)})
    del pfp
    mfinal, mmetrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000)
    assert _golden_of(mfinal, mmetrics) == goldens.PACKED_FAULT_STORM_4096_SEED0
