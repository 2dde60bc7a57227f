"""The latency storm at 600 nodes, four seeds, on the dense round under
a FACTORED plan (``compile_plan(..., factored=True)`` on both sides: the
fault storm's loss, half split and crash with wipe, then a delay and a
jitter of one round out of the first sixth): the port's lane-batched
fault loop (K9's folded edge queries and latency entry, K9's reach lane
entry, K11d, K12f with its jitter stream, K13d, K14x lanes) against
JAX's ``run_ensemble`` of the same compiled form, lane by lane, field by
field.  Alone in its file: JAX's compile of the vmapped loop takes most
of a minute."""

import numpy as np
import pytest

from corrosion_tpu.campaign.ensemble import lane_plan_seeds as jseeds
from corrosion_tpu.campaign.ensemble import run_ensemble as jrun_ensemble
from corrosion_tpu.campaign.ensemble import seed_states as jstates
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu.sim.faults import compile_plan as jcompile
from corrosion_tpu.sim.state import uniform_payloads as jpayloads
from corrosion_tpu_torch.campaign.ensemble import (
    lane_plan_seeds,
    run_ensemble,
    seed_states,
)
from corrosion_tpu_torch.sim.faults import FactoredFaultPlan, compile_plan
from corrosion_tpu_torch.sim.state import uniform_payloads
from tests.torch_parity import assert_lanes_equal_jax, dense_storm_spec_at


@pytest.mark.campaign
def test_factored_latency_storm_600_equals_live_jax():
    """Every lane's state and stamps equal JAX's vmapped lane, the lanes
    finishing at different rounds."""
    seeds = (0, 1, 2, 3)
    spec = dense_storm_spec_at(seeds, 600)
    jspec = JaxSpec.from_dict(spec.to_dict())
    jcfg, jtopo = jspec.sim_config({}), jspec.topo({})
    jfp = jcompile(jspec.fault_plan({}, seed=0), jcfg, jtopo, factored=True)
    jf, jm = jrun_ensemble(jstates(jcfg, seeds),
                           jpayloads(jcfg, inject_every=2), jcfg, jtopo,
                           fplan=jfp, plan_seeds=jseeds(seeds),
                           max_rounds=spec.max_rounds)
    cfg, topo = spec.sim_config({}), spec.topo({})
    fplan = compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                         factored=True, device="cpu")
    assert isinstance(fplan, FactoredFaultPlan)
    assert fplan.delay_src.shape[0] and fplan.jitter_src.shape[0]
    pf, pm = run_ensemble(seed_states(cfg, seeds, "cpu"),
                          uniform_payloads(cfg, "cpu", inject_every=2),
                          cfg, topo, fplan, lane_plan_seeds(seeds, "cpu"),
                          max_rounds=spec.max_rounds)
    assert len(set(np.asarray(jf.t).tolist())) > 1
    assert_lanes_equal_jax(jf, jm, pf, pm, "factored-latency-600")
