"""The protocol axis under fault plans, against live JAX, exact:
push-pull and ``lab-ordered`` on both rounds under a loss burst, a
one-way partition and a crash with wipe (the pull refused across the
one-way cut, the reverse fault loss on the pull's own key, FIFO
composing with the wipe as in JAX's
``test_ordering_composes_with_fault_plans``), with the flight recorder.
JAX compiles the plan in its default form at 48 nodes (the matrix
form); the port runs it in the matrix form and in the factored one, and
both equal JAX's run — state, RunMetrics and every RoundTrace channel.
"""

import dataclasses

import numpy as np
import pytest

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu.proto import family_proto as jax_family_proto
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu_torch.sim import faults as pfaults
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import telemetry
from corrosion_tpu_torch.sim import topology as ptopo
from tests.torch_parity import (
    assert_metrics_equal,
    assert_states_equal,
    jax_telemetry,
    plan_pair,
    port_config,
)


def _events(ev):
    return (
        ev("loss", 0, 12, p=0.3),
        ev("partition", 2, 8, src="0:16", dst="24:48"),
        ev("crash", 6, 10, node=1, wipe=True),
    )


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", ("push-pull", "lab-ordered"))
def test_protocol_under_fault_plan_matches_jax(family, packed):
    kw = dict(n_nodes=48, n_payloads=32, n_writers=2, fanout=3,
              sync_interval_rounds=4, n_delay_slots=4)
    kw.update(jax_family_proto(family))
    ch = dict(packed_min_cells=0) if packed else dict(allow_packed=False)
    jcfg = dataclasses.replace(jstate.SimConfig(**kw), **ch)
    pcfg = port_config(jcfg)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = pstate.uniform_payloads(pcfg, "cpu", inject_every=1)
    jplan, pplan = plan_pair(48, 7, _events)
    jt, pt = jtopo.Topology(), ptopo.Topology()
    jf = jfaults.compile_plan(jplan, jcfg, jt)
    assert isinstance(jf, jfaults.SimFaultPlan)
    with jax_telemetry():
        jfinal, jm, jtrace = jfaults.run_fault_plan(
            jround.new_sim(jcfg, 7), jmeta, jcfg, jt, jf, 800,
            telemetry=True)
    for factored in (False, True):
        pf = pfaults.compile_plan(pplan, pcfg, pt, factored=factored,
                                  device="cpu")
        final, m, trace = pfaults.run_fault_plan(
            pround.new_sim(pcfg, 7, "cpu"), pmeta, pcfg, pt, pf, 800,
            telemetry=True)
        label = (f"{family}/{'packed' if packed else 'dense'}/"
                 f"{'factored' if factored else 'matrix'}")
        assert_states_equal(jfinal, final, label)
        assert_metrics_equal(jm, m, label)
        for f in telemetry.CHANNELS:
            np.testing.assert_array_equal(
                getattr(trace, f).numpy(), np.asarray(getattr(jtrace, f)),
                err_msg=f"{label}: {f}")
    rounds = int(final.t)
    up = final.alive.numpy() == pstate.ALIVE
    assert ((m.converged_at.numpy() >= 0) | ~up).all()
    assert int(trace.bcast_cut[:rounds].sum()) > 0
    if family == "lab-ordered":
        # FIFO composes with the wipe: origin rows are exempt
        assert int(m.order_violations) == 0
