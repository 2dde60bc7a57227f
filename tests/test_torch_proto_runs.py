"""Whole runs of the port's protocol axis against live JAX, exact: every
protocol family on the packed round (``packed_min_cells=0``) and on the
dense round (``allow_packed=False``) with the flight recorder on —
final state, every RunMetrics field (``order_violations`` included) and
every RoundTrace channel.

The shapes are JAX's ``test_variant_packed_matches_dense`` (64 nodes, 64
payloads, 4 writers) and, for the two ordering families,
``_lossy_order_run`` (48 nodes, 32 payloads, 2 writers, 30 % loss, seed
3: per-payload loss reorders deliveries, so the unchecked control trips
the invariant and the enforced one holds it at 0).  Push-pull runs over
flat, ``flat-lossy`` and ``wan-3x2`` (the reverse tier stream), the
other families over one topology each.

The f32 byte channels: under push-pull JAX adds two f32 sums of N·F
terms each (push, then pull) and rounds their sum, so |JAX − S| ≤
(N·F + 1)·2⁻²⁴·S for the exact int64 total S that the port rounds once
(each sum of m nonnegative terms is within (m − 1)·2⁻²⁴ of its exact
value, relatively, and the final add one more 2⁻²⁴); with every payload
8 KiB all three are exact here, and the runs are held to equality.
``-m slow`` re-derives the card's protocol goldens (`goldens.py`) from
live JAX.
"""

import dataclasses

import numpy as np
import pytest

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu.proto import family_proto as jax_family_proto
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.topo import family_topology as jax_family_topology
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import telemetry
from corrosion_tpu_torch.sim import topology as ptopo
from corrosion_tpu_torch.topo import family_topology
from tests.torch_parity import (
    assert_metrics_equal,
    assert_states_equal,
    jax_digest,
    jax_telemetry,
    port_config,
)

U = 2.0 ** -24
F32 = ("bcast_bytes", "sync_bytes")

#: (family, topology family) of each run
RUNS = (
    ("baseline", "flat"),
    ("push-pull", "flat"),
    ("push-pull", "flat-lossy"),
    ("push-pull", "wan-3x2"),
    ("swarm-aggressive", "flat-lossy"),
    ("fanout-decay", "wan-3x2"),
    ("lab-ordered", "lossy-order"),
    ("lab-ordered-broken", "lossy-order"),
)


def _shape(family, topo_family, packed):
    """(jax cfg, meta, topo, port cfg, meta, topo, seed) of one run."""
    if topo_family == "lossy-order":
        kw = dict(n_nodes=48, n_payloads=32, n_writers=2, fanout=3,
                  sync_interval_rounds=4)
        topo_kw, seed = dict(loss=0.3), 3
    else:
        kw = dict(n_nodes=64, n_payloads=64, n_writers=4, fanout=3)
        topo_kw, seed = jax_family_topology(topo_family), 5
    kw.update(jax_family_proto(family))
    ch = dict(packed_min_cells=0) if packed else dict(allow_packed=False)
    jcfg = dataclasses.replace(jstate.SimConfig(**kw), **ch)
    pcfg = port_config(jcfg)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = pstate.uniform_payloads(pcfg, "cpu", inject_every=1)
    ptopo_kw = (family_topology(topo_family)
                if topo_family != "lossy-order" else topo_kw)
    return (jcfg, jmeta, jtopo.Topology(**topo_kw), pcfg, pmeta,
            ptopo.Topology(**ptopo_kw), seed)


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family, topo_family", RUNS)
def test_family_run_matches_jax(family, topo_family, packed):
    jcfg, jmeta, jt, pcfg, pmeta, pt, seed = _shape(family, topo_family,
                                                    packed)
    with jax_telemetry():
        jfinal, jm, jtrace = jround.run_to_convergence(
            jround.new_sim(jcfg, seed), jmeta, jcfg, jt, 800, telemetry=True)
    final, m, trace = pround.run_to_convergence(
        pround.new_sim(pcfg, seed, "cpu"), pmeta, pcfg, pt, 800,
        telemetry=True)
    label = f"{family}/{topo_family}/{'packed' if packed else 'dense'}"
    assert_states_equal(jfinal, final, label)
    assert_metrics_equal(jm, m, label)
    for f in telemetry.CHANNELS:
        want = np.asarray(getattr(jtrace, f))
        got = getattr(trace, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        if f in F32:
            # (N·F + 1)·2⁻²⁴·S: the bound of the module doc; exact here
            bound = (pcfg.n_nodes * pcfg.fanout + 1) * U * np.abs(got)
            assert (np.abs(want - got) <= bound).all(), (label, f)
        np.testing.assert_array_equal(got, want, err_msg=f"{label}: {f}")
    rounds = int(final.t)
    assert rounds < 800 and (m.converged_at >= 0).all(), label
    if family == "lab-ordered":
        assert int(m.order_violations) == 0
    if family == "lab-ordered-broken":
        # the negative control trips the invariant, as JAX's does
        assert int(m.order_violations) > 0
    if family == "push-pull" and topo_family != "flat":
        # the pull leg's own losses reach the dropped-frames channel
        assert int(trace.bcast_dropped[:rounds].sum()) > 0


# -- the card's goldens, from live JAX ----------------------------------------


def _jax_record(final, metrics, meta):
    cov = np.asarray(metrics.coverage_at)
    lat = np.where(cov >= 0, cov - np.asarray(meta.round), -1)
    return {
        "rounds": int(final.t),
        "p99_node_convergence_round": jrunner._percentile(
            np.asarray(metrics.converged_at), 99),
        "p99_payload_latency_rounds": jrunner._percentile(lat, 99),
        "digest": jax_digest(final),
        "order_violations": int(metrics.order_violations),
    }


_STORM_GOLDENS = {
    "baseline": "STORM_BASELINE_100K_SEED0",
    "swarm-aggressive": "STORM_SWARM_AGGRESSIVE_100K_SEED0",
    "push-pull": "STORM_PUSH_PULL_100K_SEED0",
    "fanout-decay": "STORM_FANOUT_DECAY_100K_SEED0",
    "lab-ordered": "STORM_LAB_ORDERED_100K_SEED0",
    "lab-ordered-broken": "STORM_LAB_ORDERED_BROKEN_100K_SEED0",
}


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(_STORM_GOLDENS))
def test_protocol_storm_goldens_match_live_jax(family):
    """``config_write_storm_100k(proto_family=...)``'s goldens (~20 s each
    at 100k on 8 cores; lab-ordered's 240 rounds ~95 s); baseline equals
    the storm's own golden."""
    topo = jtopo.Topology()
    jcfg, jmeta = jrunner._write_storm(100_000, 512, topo=topo,
                                       proto_family=family)
    final, metrics = jround.run_to_convergence(jround.new_sim(jcfg, 0),
                                               jmeta, jcfg, topo, 3000)
    golden = getattr(goldens, _STORM_GOLDENS[family])
    assert _jax_record(final, metrics, jmeta) == golden
    if family == "baseline":
        assert {k: golden[k] for k in goldens.STORM_100K_SEED0} == \
            goldens.STORM_100K_SEED0


@pytest.mark.slow
@pytest.mark.parametrize("family, name", (
    ("push-pull", "BROADCAST_1K_PUSH_PULL_SEED0"),
    ("lab-ordered", "BROADCAST_1K_LAB_ORDERED_SEED0"),
    ("lab-ordered-broken", "BROADCAST_1K_LAB_ORDERED_BROKEN_SEED0"),
))
def test_protocol_broadcast_1k_goldens_match_live_jax(family, name):
    cfg = jstate.SimConfig(n_nodes=1000, n_payloads=256, n_writers=8,
                           fanout=3, n_delay_slots=4,
                           **jrunner._resolve_proto(family))
    meta = jstate.uniform_payloads(cfg, inject_every=2)
    cfg = jstate.optimize_budgets(cfg, meta)
    final, metrics = jround.run_to_convergence(
        jround.new_sim(cfg, 0), meta, cfg, jtopo.Topology(), 2000)
    assert _jax_record(final, metrics, meta) == getattr(goldens, name)


@pytest.mark.slow
def test_push_pull_wan_3x2_telemetry_golden_matches_live_jax():
    """``STORM_WAN_3X2_PUSH_PULL_100K_SEED0`` and its telemetry golden:
    the summary (``wire_bytes`` apart) and the per-round f32 byte
    channels, both directions of the exchange (~40 s)."""
    topo = jrunner._resolve_topo("wan-3x2")
    jcfg, jmeta = jrunner._write_storm(100_000, 512, topo=topo,
                                       proto_family="push-pull")
    with jax_telemetry() as jtel:
        final, metrics, trace = jround.run_to_convergence(
            jround.new_sim(jcfg, 0), jmeta, jcfg, topo, 3000, telemetry=True)
        rounds = int(final.t)
        summary = jtel.trace_summary(jtel.trace_host(trace, rounds), rounds,
                                     jcfg)
    assert _jax_record(final, metrics, jmeta) == \
        goldens.STORM_WAN_3X2_PUSH_PULL_100K_SEED0
    golden = goldens.STORM_WAN_3X2_PUSH_PULL_100K_SEED0_TELEMETRY
    assert golden["summary"] == {k: v for k, v in summary.items()
                                 if k != "wire_bytes"}
    assert golden["wire_bytes"] == summary["wire_bytes"]
    for channel in F32:
        assert golden[channel] == [
            float(x) for x in np.asarray(getattr(trace, channel))[:rounds]]
