"""The ``churn`` key on both lane rounds (B16c): a campaign cell's churn
schedule (`corrosion_tpu_torch/topo/churn.py`'s flash crowd and diurnal
families) becomes events of the cell's fault plan
(`campaign.spec.CampaignSpec.fault_plan`), which the dense round's lanes
run as a matrix plan below 1024 nodes and the packed round's lanes as a
factored one.  Each cell through the port's engine against live JAX's
``run_campaign`` on the CPU, two seeds, field for field; a detect cell
keeps JAX's ValueError."""

import dataclasses

import numpy as np
import pytest

from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.sim.faults import FactoredFaultPlan, compile_plan
from tests.torch_parity import assert_lanes_equal_jax, jax_campaign_kept


def _churn_spec(churn, n):
    """The write storm at ``n`` × 64 under a churn family: at 512 nodes on
    the dense round (a matrix plan), at 1280 inside the packed envelope
    (``packed_min_cells`` 0, a factored plan)."""
    scenario = dict(spec_mod.storm_scenario(n), n_payloads=64, churn=churn)
    if n >= 1024:
        scenario["packed_min_cells"] = 0
    return spec_mod.CampaignSpec(name=f"churn-{churn}-lanes",
                                 scenario=scenario, seeds=(0, 1),
                                 max_rounds=400)


@pytest.mark.parametrize("churn,n,round_path", [
    ("flash-crowd", 512, "dense"), ("flash-crowd", 1280, "packed"),
    ("diurnal", 512, "dense"), ("diurnal", 1280, "packed")])
def test_churn_cell_on_lanes_equals_live_jax(churn, n, round_path):
    """A flash-crowd and a diurnal cell, two seeds, through the port's
    engine: live JAX's spec_hash, result_digest, per-seed records, bands,
    round path and plan horizon, and every lane's state and stamps field
    for field; the plan the cell compiles to is the matrix form on the
    dense round and the factored form on the packed round, as JAX's."""
    spec = _churn_spec(churn, n)
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = spec.fault_plan({}, seed=0)
    assert len(plan.events) > 0
    factored = isinstance(compile_plan(plan, cfg, topo, device="cpu"),
                          FactoredFaultPlan)
    assert factored == (round_path == "packed")
    want, jout = jax_campaign_kept(spec)
    kept = {}
    got = run_campaign(spec, device="cpu", lanes_out=kept)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "plan_horizon",
                "all_converged"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == round_path and cell["plan_horizon"] > 0
    assert_lanes_equal_jax(jout[0], jout[1], kept[0]["finals"],
                           kept[0]["metrics"], f"{churn}/{n}")
    # the fault loop ran every lane to the churn plan's horizon
    assert int(np.asarray(jout[0].t).min()) >= cell["plan_horizon"]


def test_churn_on_a_detect_cell_keeps_jaxs_value_error():
    """A ``churn`` key on a detect cell raises JAX's ValueError word for
    word, before anything runs."""
    spec = spec_mod.swim_churn_64_spec(seeds=(0,))
    spec = dataclasses.replace(spec, scenario=dict(spec.scenario,
                                                   churn="flash-crowd"))
    with pytest.raises(ValueError) as want:
        jrun_campaign(JaxSpec.from_dict(spec.to_dict()), out_path=None)
    with pytest.raises(ValueError) as got:
        run_campaign(spec, device="cpu")
    assert str(got.value) == str(want.value)
    assert "churn" in str(got.value)
