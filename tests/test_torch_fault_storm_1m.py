"""The 1M-node tier's path (`config_fault_storm_1m`) against the JAX
reference.

Above 2^18 nodes `_write_storm` drops partial-view SWIM, so the 1M storm
is the packed round with ground-truth membership: no SWIM step, the
targets from the uniform sampler (a [4c, N] randint, then K1's uniform
entry with no view), under `storm_fault_plan` compiled factored.  That
path runs here at 1280 nodes (the 1M configuration with the packed
envelope forced open) in both packages, field for field; the full-width
configuration and its compiled plan are compared without running a
round; the rung's record keys are JAX's less the wall protocol's.  Under
``-m slow`` the small path runs to convergence and the 1M pin
`goldens.FAULT_STORM_1M_SEED0` is held against live JAX's unsharded run
(about 200 s on 8 CPU cores); chip_smoke.py holds the port's 1M run on
the card to the same pin."""

import dataclasses

import numpy as np
import pytest

from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_fault_plan
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim import faults
from corrosion_tpu_torch.sim.round import new_sim
from corrosion_tpu_torch.sim.runner import _write_storm as port_write_storm
from corrosion_tpu_torch.sim.runner import (
    config_fault_storm_1m,
    storm_fault_plan,
)
from corrosion_tpu_torch.sim.state import packed_supported
from corrosion_tpu_torch.sim.topology import Topology
from tests.test_torch_storm import _assert_metrics, _jax_digest
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    port_fields,
)

N, P, SEED = 1280, 512, 0
#: the rounds tier 1 runs of the small path (the loss burst from round
#: 0, the split from 4, node 1 down from 8)
TIER1_ROUNDS = 10


def _ground_truth(cfg):
    """The 1M configuration's membership and round at a small N."""
    return dataclasses.replace(cfg, swim_partial_view=False,
                               packed_min_cells=0)


@pytest.fixture(scope="module")
def small():
    """(jax cfg, meta, plan; port cfg, meta, plan) of the 1M path at
    1280 nodes."""
    jcfg, jmeta = jax_write_storm(N, P)
    pcfg, pmeta = port_write_storm(N, P, "cpu")
    jcfg, pcfg = _ground_truth(jcfg), _ground_truth(pcfg)
    jplan = jfaults.compile_plan(jax_storm_fault_plan(N, SEED), jcfg,
                                 JaxTopology())
    pplan = faults.compile_plan(storm_fault_plan(N, SEED), pcfg, Topology(),
                                device="cpu")
    return jcfg, jmeta, jplan, pcfg, pmeta, pplan


def _record(final, metrics, digest):
    """Rounds, p99 (None before any node converged: JAX's NaN) and
    digest."""
    p99 = _percentile(np.asarray(metrics.converged_at), 99)
    return {
        "rounds": int(final.t),
        "p99_node_convergence_round": None if np.isnan(p99) else p99,
        "digest": digest,
    }


def _run_both(small, max_rounds: int):
    jcfg, jmeta, jplan, pcfg, pmeta, pplan = small
    jfinal, jmetrics = jfaults.run_fault_plan(
        jax_new_sim(jcfg, SEED), jmeta, jcfg, JaxTopology(), jplan,
        max_rounds=max_rounds)
    pfinal, pmetrics = faults.run_fault_plan(
        new_sim(pcfg, SEED, "cpu"), pmeta, pcfg, Topology(), pplan,
        max_rounds=max_rounds)
    assert_fields_equal(fields(jfinal), port_fields(pfinal), "final")
    _assert_metrics(jmetrics, pmetrics, "metrics")
    want = _record(jfinal, jmetrics, _jax_digest(jfinal))
    assert _record(pfinal, pmetrics, state_digest(pfinal)) == want
    return want


def test_small_path_is_the_1m_path(small):
    """At 1280 nodes the forced configuration takes the 1M path: the
    packed round, ground-truth membership, a factored plan."""
    _, _, _, pcfg, _, pplan = small
    assert packed_supported(pcfg, Topology())
    assert not pcfg.swim_partial_view and not pcfg.swim_full_view
    assert isinstance(pplan, faults.FactoredFaultPlan)


def test_small_path_first_rounds_match_jax(small):
    """The 1M path's first rounds at 1280 nodes (the loss burst, then the
    split) in both packages: every state field, the metrics, rounds, p99
    and digest equal."""
    got = _run_both(small, TIER1_ROUNDS)
    assert got["rounds"] == TIER1_ROUNDS


@pytest.mark.slow
def test_small_path_to_convergence_matches_jax(small):
    """The same run to the fault loop's exit (past the plan's horizon,
    the wipe of node 1 healed)."""
    got = _run_both(small, 3000)
    assert got["rounds"] >= small[5].horizon


def test_full_width_config_and_plan_match_jax():
    """At 1 000 000 nodes, without a round: `_write_storm`'s config and
    payloads and `compile_plan`'s factored fields equal JAX's field by
    field (ground-truth membership above 2^18 nodes)."""
    n = 1_000_000
    jcfg, jmeta = jax_write_storm(n, P)
    pcfg, pmeta = port_write_storm(n, P, "cpu")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert not pcfg.swim_partial_view
    assert packed_supported(pcfg, Topology())
    assert_fields_equal(fields(jmeta), fields(pmeta), "meta")
    jplan = jfaults.compile_plan(jax_storm_fault_plan(n, SEED), jcfg,
                                 JaxTopology())
    pplan = faults.compile_plan(storm_fault_plan(n, SEED), pcfg, Topology(),
                                device="cpu")
    assert isinstance(pplan, faults.FactoredFaultPlan)
    assert_fields_equal(fields(jplan), fields(pplan), "compile_plan 1M")
    assert pplan.horizon == jax_storm_fault_plan(n, SEED).horizon


def test_record_keys_are_jax_less_the_wall_protocol(monkeypatch):
    """`config_fault_storm_1m`'s record at a small N on the CPU: JAX's
    keys, in JAX's order, less ``sanity`` and ``phase_profile`` (the wall
    protocol and the profiler, ROADMAP A11), and JAX's values for the
    keys that describe the rung.  JAX's rung always runs on a mesh (one
    device here), whose runs are not its unsharded ones ("Reference
    health" in ROADMAP), so its outcomes are not compared: its per-round
    microbench and its measured run are stubbed (the record is built
    around them)."""
    from corrosion_tpu.sim import perf as jperf

    n = N
    monkeypatch.setattr(jperf, "measure_per_round", lambda *a, **k: 1.0)
    monkeypatch.setattr(jrunner, "_measured_fault_storm", lambda *a, **k: {
        "rounds": 0, "wall": 0.0, "report": {}, "unconverged": 0,
        "node_conv": np.zeros(n, np.int32)})
    want = jrunner.config_fault_storm_1m(seed=SEED, n_nodes=n, n_payloads=64,
                                         n_devices=1)
    got = config_fault_storm_1m(seed=SEED, n_nodes=n, n_payloads=64,
                                device="cpu")
    assert list(got) == [k for k in want
                         if k not in ("sanity", "phase_profile")]
    for key in ("n_nodes", "n_payloads", "n_devices", "round_path",
                "membership", "plan_horizon", "plan_seed"):
        assert got[key] == want[key], key
    assert got["mesh"] is None


def test_record_carries_the_state_when_asked():
    """``return_state`` adds the final state and metrics, whose digest
    and rounds agree with the record."""
    out = config_fault_storm_1m(seed=SEED, n_nodes=N, n_payloads=64,
                                device="cpu", return_state=True)
    assert int(out["state"].t) == out["rounds"]
    assert out["converged"] and out["unconverged_nodes"] == 0
    assert out["membership"] == "partial-view"


def test_without_a_card_it_raises():
    """The default device is the card: without one the rung raises and
    nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        config_fault_storm_1m(n_nodes=N, n_payloads=64)


@pytest.mark.slow
def test_1m_pin_matches_live_jax():
    """`goldens.FAULT_STORM_1M_SEED0`: live JAX's unsharded 1M fault
    storm (rounds, p99, digest), the call its comment names."""
    n = 1_000_000
    jcfg, jmeta = jax_write_storm(n, P)
    jplan = jfaults.compile_plan(jax_storm_fault_plan(n, SEED), jcfg,
                                 JaxTopology())
    final, metrics = jfaults.run_fault_plan(
        jax_new_sim(jcfg, SEED), jmeta, jcfg, JaxTopology(), jplan,
        max_rounds=3000)
    assert _record(final, metrics, _jax_digest(final)) == \
        goldens.FAULT_STORM_1M_SEED0
