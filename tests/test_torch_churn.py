"""Churn in the port against the live JAX reference, exact: every
generator of `corrosion_tpu_torch/topo/churn.py` (flash crowd, diurnal,
the family registry, the AZ blocks and the tiered topology's link
events) over a grid of sizes, fractions, round knobs and seeds; a
flash-crowd and a diurnal run through `run_fault_plan` at 300 nodes;
fault plans under the PeerSwap sampler (flat and wan-3x2, packed and
dense, the port's plan factored and in matrix form, under loss, a
partition and crash-with-wipe — K11's view row); and the flight
recorder under PeerSwap (every RoundTrace channel and the summary).
``-m slow`` re-derives the card's flash-crowd goldens from live JAX."""

import dataclasses

import numpy as np
import pytest

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu import faults as jfaults_host
from corrosion_tpu import topo as jtopo_pkg
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch import topo as ptopo_pkg
from corrosion_tpu_torch.faults import FaultPlan
from corrosion_tpu_torch.sim import faults as pfaults
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import runner as prunner
from corrosion_tpu_torch.sim import telemetry
from corrosion_tpu_torch.topo.families import FAMILIES
from tests.torch_parity import (
    N_RUN,
    P_RUN,
    SEED,
    assert_metrics_equal,
    assert_states_equal,
    fault_plan_pair,
    jax_digest,
    jax_telemetry,
    topology_storm,
)


def _events(evs):
    return [dataclasses.asdict(ev) for ev in evs]


# -- the generators --------------------------------------------------------------


@pytest.mark.parametrize("n", (2, 7, 300, 100_000))
@pytest.mark.parametrize("frac", (0.0, 0.1, 0.25, 0.5, 1.0))
@pytest.mark.parametrize("knob", (0, 1, 8, 13))
def test_churn_generators_match_jax(n, frac, knob):
    """Flash crowd (wiped and not), diurnal over 1-3 cycles and three
    seeds, and both families by name: the same events, field for field;
    an unknown family raises KeyError in both."""
    j, p = jtopo_pkg, ptopo_pkg
    for wipe in (True, False):
        assert _events(p.flash_crowd_events(n, frac, knob, wipe)) == _events(
            j.flash_crowd_events(n, frac, knob, wipe))
    for seed in (0, 3, 41):
        for cycles in (1, 3):
            kw = dict(frac=frac, day_rounds=knob + 2, night_rounds=knob // 2
                      + 1, cycles=cycles, seed=seed, wipe=bool(seed % 2))
            assert _events(p.diurnal_events(n, **kw)) == _events(
                j.diurnal_events(n, **kw))
        for name in p.CHURN_FAMILIES:
            assert _events(p.churn_events(name, n, frac, knob, seed)) == (
                _events(j.churn_events(name, n, frac, knob, seed)))
    assert p.CHURN_FAMILIES == j.CHURN_FAMILIES
    for mod in (p, j):
        with pytest.raises(KeyError, match="unknown churn family"):
            mod.churn_events("tidal", n)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("n", (7, 300, 1001, 100_000))
def test_topology_link_events_match_jax(family, n):
    """Each family's AZ blocks and its tiers as delay and loss link
    events over [2, 30): equal to JAX's, and a plan of them compiles."""
    jt, pt = jrunner._resolve_topo(family), prunner._resolve_topo(family)
    assert ptopo_pkg.az_blocks(n, pt.n_regions, pt.n_azs) == (
        jtopo_pkg.az_blocks(n, jt.n_regions, jt.n_azs))
    want = jtopo_pkg.topology_link_events(jt, n, 30, 2)
    got = ptopo_pkg.topology_link_events(pt, n, 30, 2)
    assert _events(got) == _events(want)
    FaultPlan(n_nodes=n, seed=0, events=got)


# -- churn runs ----------------------------------------------------------------------


def _churn_run_pair(packed, events, seed=5):
    """Both packages' `run_fault_plan` of `_write_storm` at N_RUN nodes
    under ``events`` (each package's own events and compile, JAX's
    default form: the matrix one at this size), equal field for field."""
    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm(None, None, packed)
    jplan = jfaults_host.FaultPlan(n_nodes=N_RUN, seed=seed,
                                   events=events(jtopo_pkg))
    pplan = FaultPlan(n_nodes=N_RUN, seed=seed, events=events(ptopo_pkg))
    jout = jfaults.run_fault_plan(
        jround.new_sim(jcfg, SEED), jmeta, jcfg, jt,
        jfaults.compile_plan(jplan, jcfg, jt), 400)
    pf = pfaults.compile_plan(pplan, pcfg, pt, device="cpu")
    assert isinstance(pf, pfaults.SimFaultPlan)
    pout = pfaults.run_fault_plan(pround.new_sim(pcfg, SEED, "cpu"), pmeta,
                                  pcfg, pt, pf, 400)
    assert_states_equal(jout[0], pout[0], "churn run")
    assert_metrics_equal(jout[1], pout[1], "churn run metrics")
    return pout


def test_flash_crowd_run_matches_jax():
    """The tail quarter down over rounds 0-7, back wiped at round 8, on
    the packed round: JAX's final state and metrics, every joiner
    converged."""
    final, metrics = _churn_run_pair(
        True, lambda mod: mod.flash_crowd_events(N_RUN))
    tail = slice(N_RUN - N_RUN // 4, N_RUN)
    assert (metrics.converged_at[tail] >= 0).all()


def test_diurnal_run_matches_jax():
    """Two nights of a seed-derived quarter of the cluster (rounds 6-8
    and 15-17) on the dense round: JAX's final state and metrics."""
    final, metrics = _churn_run_pair(
        False, lambda mod: mod.diurnal_events(N_RUN, day_rounds=6,
                                              night_rounds=3, seed=4))
    assert int(final.t) > 18


# -- fault plans under PeerSwap: K11's view row -------------------------------------


def _peerswap_events(ev):
    half = N_RUN // 2
    return (
        ev("loss", 0, 12, p=0.2),
        ev("partition", 3, 10, src=f"0:{half}", dst=f"{half}:{N_RUN}",
           symmetric=True),
        ev("crash", 4, 12, node=f"{N_RUN - 20}:{N_RUN}", wipe=True),
        ev("crash", 6, 14, node=7, wipe=True),
    )


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", (None, "wan-3x2"))
def test_peerswap_fault_plan_matches_jax(family, packed):
    """Loss, a symmetric half split and two crash-with-wipe restarts
    under PeerSwap: the wiped nodes' views are emptied and refilled, and
    the run equals JAX's — the view included — on both rounds and both
    plan forms."""
    _, pout = fault_plan_pair(family, "peerswap", packed, _peerswap_events)
    up = pout[0].alive.numpy() == 0
    assert ((pout[1].converged_at.numpy() >= 0) | ~up).all()


# -- the flight recorder under PeerSwap ---------------------------------------------


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", (None, "wan-3x2"))
def test_peerswap_trace_matches_jax(family, packed):
    """Every RoundTrace channel of a PeerSwap storm's run and its
    trace_summary equal JAX's; the two f32 byte channels within
    (m + 1)·2⁻²⁴ of JAX's rows (m the f32 terms JAX adds: N·F edges, P
    grants), and wire_bytes within the rows' bounds."""
    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm(family, "peerswap",
                                                      packed)
    with jax_telemetry() as jtel:
        jout = jround.run_to_convergence(jround.new_sim(jcfg, SEED), jmeta,
                                         jcfg, jt, 400, telemetry=True)
        rounds = int(jout[0].t)
        jhost = jtel.trace_host(jout[2], rounds)
        want = jtel.trace_summary(jhost, rounds, jcfg)
    pout = pround.run_to_convergence(pround.new_sim(pcfg, SEED, "cpu"),
                                     pmeta, pcfg, pt, 400, True)
    label = f"{family}/{'packed' if packed else 'dense'}"
    assert_states_equal(jout[0], pout[0], label)
    assert_metrics_equal(jout[1], pout[1], label)
    phost = telemetry.trace_host(pout[2], rounds)
    bound = {"bcast_bytes": (N_RUN * pcfg.fanout + 1) * 2.0 ** -24,
             "sync_bytes": (P_RUN + 1) * 2.0 ** -24}
    for name in telemetry.CHANNELS:
        if name in bound:
            np.testing.assert_allclose(np.asarray(jhost[name]), phost[name],
                                       rtol=bound[name], err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(jhost[name]),
                                          phost[name], err_msg=name)
    got = telemetry.trace_summary(phost, rounds, pcfg)
    wire_w, wire_g = want.pop("wire_bytes"), got.pop("wire_bytes")
    assert got == want
    for key in ("broadcast", "sync"):
        assert abs(wire_w[key] - wire_g[key]) <= (
            (N_RUN * pcfg.fanout + 2 * rounds) * 2.0 ** -24 * wire_w[key]
            + 0.1)


# -- the card's goldens --------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name, n, sampler", (
    ("FLASH_CROWD_STORM_100K_SEED0", 100_000, None),
    ("FLASH_CROWD_PEERSWAP_25600_SEED0", 25_600, "peerswap")))
def test_flash_crowd_goldens_match_live_jax(name, n, sampler):
    """The card's flash-crowd goldens against live JAX (~20 s at 100k,
    ~10 s at 25 600 on 8 cores)."""
    golden = getattr(goldens, name)
    jcfg, jmeta = jrunner._write_storm(n, 512, sampler=sampler)
    plan = jfaults_host.FaultPlan(n_nodes=n, seed=0,
                                  events=jtopo_pkg.flash_crowd_events(n))
    jt = jrunner.Topology()
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, jt,
        jfaults.compile_plan(plan, jcfg, jt), 3000)
    cov = np.asarray(metrics.coverage_at)
    lat = np.where(cov >= 0, cov - np.asarray(jmeta.round), -1)
    live = {
        "rounds": int(final.t),
        "p99_node_convergence_round": jrunner._percentile(
            np.asarray(metrics.converged_at), 99),
        "p99_payload_latency_rounds": jrunner._percentile(lat, 99),
        "digest": jax_digest(final),
    }
    if "pview_digest" in golden:
        live["pview_digest"] = jax_digest(
            final, skip=[f for f in type(final)._fields if f != "pview"])
    assert live == golden
