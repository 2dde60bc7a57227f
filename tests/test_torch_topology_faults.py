"""Fault plans over the topology families, against the live JAX
reference, exact: tests/sim/test_packed_equivalence.py's "storm-mix"
plan (loss, a symmetric half split, delay and jitter out of the first
sixth, a crash with wipe) scaled to 300 nodes, over wan-3x2, wan-fly-6r
and hetero-degree, on the packed and the dense round, the port's plan
factored and in matrix form.  The ring is deepened to the topology's
deepest delay plus 3: the tier delay, the fault delay and its jitter
share it, and both packages refuse a shallower one alike.  ``-m slow``
re-derives the card's golden of the 100k fault storm over wan-3x2."""

import pytest

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from tests.torch_parity import N_RUN, fault_plan_pair


def _storm_mix(ev):
    half, sixth = N_RUN // 2, N_RUN // 6
    return (
        ev("loss", 0, 20, p=0.3),
        ev("partition", 4, 14, src=f"0:{half}", dst=f"{half}:{N_RUN}",
           symmetric=True),
        ev("delay", 2, 16, src=f"0:{sixth}", dst="*", delay_rounds=1),
        ev("jitter", 2, 16, src=f"0:{sixth}", dst="*", delay_rounds=1),
        ev("crash", 10, 22, node=2, wipe=True),
    )


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", ("wan-3x2", "wan-fly-6r",
                                    "hetero-degree"))
def test_fault_plan_over_family_matches_jax(family, packed):
    """The final state and RunMetrics of both plan forms equal JAX's run,
    and every up node converged past the crash's wipe."""
    _, pout = fault_plan_pair(family, None, packed, _storm_mix, deepen=3)
    up = pout[0].alive.numpy() == 0
    assert ((pout[1].converged_at.numpy() >= 0) | ~up).all()


@pytest.mark.slow
def test_fault_storm_wan_3x2_golden_matches_live_jax():
    """The card's golden of the 100k fault storm over wan-3x2 against
    live JAX (~50 s on 8 cores)."""
    import numpy as np

    from corrosion_tpu.sim import faults as jfaults
    from corrosion_tpu.sim import round as jround
    from corrosion_tpu.sim import runner as jrunner
    from corrosion_tpu_torch import goldens
    from tests.torch_parity import jax_digest

    topo = jrunner._resolve_topo("wan-3x2")
    jcfg, jmeta = jrunner._write_storm(100_000, 512, topo=topo)
    final, metrics = jfaults.run_fault_plan(
        jround.new_sim(jcfg, 0), jmeta, jcfg, topo,
        jfaults.compile_plan(jrunner.storm_fault_plan(100_000, 0), jcfg,
                             topo), 3000)
    cov = np.asarray(metrics.coverage_at)
    lat = np.where(cov >= 0, cov - np.asarray(jmeta.round), -1)
    assert {
        "rounds": int(final.t),
        "p99_node_convergence_round": jrunner._percentile(
            np.asarray(metrics.converged_at), 99),
        "p99_payload_latency_rounds": jrunner._percentile(lat, 99),
        "digest": jax_digest(final),
    } == goldens.FAULT_STORM_WAN_3X2_100K_SEED0
