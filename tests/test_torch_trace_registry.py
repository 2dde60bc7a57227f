"""`trace_to_registry` of the port against JAX's: the same run's trace
exported onto a fresh registry renders the same Prometheus text.

Runs, each on both packages from the same seed: the packed fault storm
at 1280 nodes under its factored plan (where JAX's runs agree with
themselves), the fault storm on the dense round at 256 nodes under its
matrix plan, the 3-node ground truth with ``trace_every`` = 2, and lane 1
of the port's two-lane 3-node ensemble under the same decimation
(through `lane_trace`) against JAX's solo run of that seed.  JAX's
recorder only imports inside `tests.torch_parity.jax_telemetry`.

Tolerance: every line exact but the two ``sim_wire_bytes_total``
samples.  The port rounds each round's exact byte total once to f32,
JAX adds m f32 terms a round; the totals over R rounds lie within
(m + 1 + 2R)·2⁻²⁴·S of each other (S the total), as chip_smoke.py holds
the recorder's ``wire_bytes``.
"""

import dataclasses
import uuid

import numpy as np
import pytest

from corrosion_tpu import metrics as jax_metrics
from corrosion_tpu.sim import faults as jf
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim.state import SimConfig as JaxConfig
from corrosion_tpu.sim.state import uniform_payloads as jax_payloads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch import metrics as port_metrics
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.sim import faults as pf
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import telemetry as ptel
from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import (
    jax_storm_fault_plan,
    jax_telemetry,
    jax_write_storm,
    port_write_storm,
    storm_configs,
    storm_fault_plan,
)

U = 2.0 ** -24
N_PACKED, N_DENSE, P = 1280, 256, 64
THREE = dict(n_nodes=3, n_payloads=64, fanout=2, sync_interval_rounds=4)

#: case → (labels, broadcast terms a round, sync terms a round)
CASES = {
    "packed-fault-1280": ({"run": "packed_fault_storm"}, 3 * N_PACKED, P),
    "dense-fault-256": ({"run": "dense", "cell": 'a"b\\c'}, 3 * N_DENSE, P),
    "every2-3node": ({}, 6, 64),
    "lane1-3node": ({"lane": "1"}, 6, 64),
}


def _three(cfg_cls, **extra):
    return cfg_cls(**THREE, **extra)


def _jax_side(jtel):
    """Each case's JAX render, from one recording session."""
    out = {}
    jcfg, jmeta, _, _ = storm_configs(N_PACKED, P)
    jfp = jf.compile_plan(jax_storm_fault_plan(N_PACKED, 0), jcfg,
                          JaxTopology(), factored=True)
    runs = {"packed-fault-1280": (jcfg, jf.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000,
        telemetry=True))}
    jcfg, jmeta = jax_write_storm(N_DENSE, P)
    jcfg = dataclasses.replace(jcfg, allow_packed=False)
    jfp = jf.compile_plan(jax_storm_fault_plan(N_DENSE, 0), jcfg,
                          JaxTopology())
    runs["dense-fault-256"] = (jcfg, jf.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000,
        telemetry=True))
    jcfg = _three(JaxConfig, trace_every=2)
    jmeta = jax_payloads(jcfg, inject_every=1)
    for case, seed in (("every2-3node", 0), ("lane1-3node", 1)):
        runs[case] = (jcfg, jround.run_to_convergence(
            jround.new_sim(jcfg, seed), jmeta, jcfg, JaxTopology(), 2000,
            telemetry=True))
    for case, (jcfg, (final, _, trace)) in runs.items():
        reg = jax_metrics.Registry()
        jtel.trace_to_registry(trace, int(final.t), jcfg, registry=reg,
                               **CASES[case][0])
        out[case] = reg.render()
    return out


@pytest.fixture(scope="module")
def jax_renders():
    with jax_telemetry() as jtel:
        return _jax_side(jtel)


def _port_run(case):
    """(trace, rounds, cfg) of the port's run of ``case`` on the CPU."""
    if case == "packed-fault-1280":
        _, _, cfg, meta = storm_configs(N_PACKED, P)
        fplan = pf.compile_plan(storm_fault_plan(N_PACKED, 0), cfg,
                                Topology(), factored=True, device="cpu")
        final, _, trace = pf.run_fault_plan(
            pround.new_sim(cfg, 0, "cpu"), meta, cfg, Topology(), fplan,
            3000, True)
        assert isinstance(fplan, pf.FactoredFaultPlan)
        return trace, int(final.t), cfg
    if case == "dense-fault-256":
        cfg, meta = port_write_storm(N_DENSE, P, "cpu")
        cfg = dataclasses.replace(cfg, allow_packed=False)
        fplan = pf.compile_plan(storm_fault_plan(N_DENSE, 0), cfg,
                                Topology(), device="cpu")
        assert isinstance(fplan, pf.SimFaultPlan)  # the matrix form
        final, _, trace = pf.run_fault_plan(
            pround.new_sim(cfg, 0, "cpu"), meta, cfg, Topology(), fplan,
            3000, True)
        return trace, int(final.t), cfg
    cfg = _three(SimConfig, trace_every=2)
    meta = uniform_payloads(cfg, "cpu", inject_every=1)
    if case == "every2-3node":
        final, _, trace = pround.run_to_convergence(
            pround.new_sim(cfg, 0, "cpu"), meta, cfg, Topology(), 2000, True)
        return trace, int(final.t), cfg
    finals, _, traces = run_seed_ensemble(None, cfg, Topology(), meta, (0, 1),
                                          max_rounds=2000, telemetry=True,
                                          device="cpu")
    with pytest.raises(ValueError, match="lane_trace"):
        ptel.trace_to_registry(traces, int(finals.t[1]), cfg,
                               registry=port_metrics.Registry())
    return ptel.lane_trace(traces, 1), int(finals.t[1]), cfg


def _assert_renders_agree(want, got, m_bcast, m_sync, rows, label):
    wl, gl = want.splitlines(), got.splitlines()
    assert len(gl) == len(wl), label
    wire = 0
    for w, g in zip(wl, gl):
        if not w.startswith("sim_wire_bytes_total{"):
            assert g == w, label
            continue
        wire += 1
        wk, wv = w.rsplit(" ", 1)
        gk, gv = g.rsplit(" ", 1)
        assert gk == wk, label
        m = m_bcast if 'path="broadcast"' in wk else m_sync
        total = abs(float(wv)) * (1 + U)
        limit = (m + 1 + 2 * rows) * U * total + 0.1
        assert abs(float(gv) - float(wv)) <= limit, (label, g, w, limit)
    assert wire == 2, label


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_to_registry_renders_as_jax(case, jax_renders):
    labels, m_bcast, m_sync = CASES[case]
    trace, rounds, cfg = _port_run(case)
    reg = port_metrics.Registry()
    ptel.trace_to_registry(trace, rounds, cfg, registry=reg, **labels)
    got = reg.render()
    want = jax_renders[case]
    rows = ptel.trace_rows_for(rounds, max(cfg.trace_every, 1))
    _assert_renders_agree(want, got, m_bcast, m_sync, rows, case)
    assert "sim_coverage_latency_rounds_count" in got
    if case.endswith("fault-1280") or case.endswith("fault-256"):
        wipes = [ln for ln in got.splitlines()
                 if ln.startswith("sim_fault_wipes_total")]
        assert wipes and wipes[0].endswith(" 1"), wipes
    # without a registry the families land on the process-wide one
    run = f"default-{uuid.uuid4().hex}"
    ptel.trace_to_registry(trace, rounds, cfg, run=run)
    assert port_metrics.REGISTRY.counter("sim_rounds_total").get(
        run=run) == rounds


@pytest.mark.slow
def test_fault_storm_100k_registry_golden_matches_live_jax():
    """``FAULT_STORM_100K_SEED0_REGISTRY`` (what chip_smoke.py holds the
    card's export to) from live JAX: the 100k fault storm on the packed
    round with the recorder, exported onto a fresh registry (about two
    minutes on 8 cores)."""
    jcfg, jmeta = jax_write_storm(100_000, 512)
    jfp = jf.compile_plan(jax_storm_fault_plan(100_000, 0), jcfg,
                          JaxTopology())
    with jax_telemetry() as jtel:
        final, _, trace = jf.run_fault_plan(
            jround.new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jfp, 3000,
            telemetry=True)
        reg = jax_metrics.Registry()
        jtel.trace_to_registry(trace, int(final.t), jcfg, registry=reg,
                               run="fault_storm_100k")
    assert int(final.t) == goldens.FAULT_STORM_100K_SEED0["rounds"]
    assert reg.render() == goldens.FAULT_STORM_100K_SEED0_REGISTRY
    assert np.isfinite(float(reg.counter("sim_wire_bytes_total").get(
        path="broadcast", run="fault_storm_100k")))
