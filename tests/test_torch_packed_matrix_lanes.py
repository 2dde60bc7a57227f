"""Matrix fault plans on the packed round's lanes (B16x: ``sim/lanes.py``
under a matrix plan's round slices, through ``campaign/ensemble.py`` and
``campaign/engine.py``) against JAX's ``campaign`` package on the CPU.

JAX compiles a plan to the matrix form below 1024 nodes, and the packed
round needs ``packed_min_cells`` lowered to run there: the engine's
packed matrix cell (512 nodes, a loss burst) against live JAX's engine,
field for field, every lane; the golden of chip smoke's path 70 (the
fault storm at 512 nodes x 512 payloads under its matrix plan, eight
lanes): its construction in JAX's terms, and its first and last lanes
run by the port here; under ``-m slow`` each of its lanes against live
JAX's one-seed run."""

import jax
import numpy as np
import pytest

import chip_smoke
from corrosion_tpu.campaign import ensemble as jens
from corrosion_tpu.campaign.report import BAND_METRICS, artifact_digest, bands
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.state import uniform_payloads as jax_payloads
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import lane_state
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim import faults
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_campaign_kept,
    jax_digest,
)

GOLDEN = goldens.PACKED_FAULT_STORM_512_MATRIX_SEEDS8


def _engine_matrix_cell(seeds):
    """The engine's packed matrix cell: the storm at 512 nodes x 64
    payloads inside the packed envelope under a loss burst (rounds 0-4,
    p = 0.2), run to convergence."""
    scenario = dict(spec_mod.storm_scenario(512), n_payloads=64,
                    packed_min_cells=0)
    return spec_mod.CampaignSpec(
        name="matrix", scenario=scenario,
        events=(spec_mod.FaultEvent("loss", 0, 4, p=0.2),),
        seeds=tuple(seeds), max_rounds=3000)


def test_engine_packed_matrix_cell_equals_live_jax():
    """The engine's packed matrix cell over three seeds: the port's
    spec_hash, result_digest and every lane's state and stamps are live
    JAX's, and the plan is the matrix form."""
    spec = _engine_matrix_cell((0, 1, 2))
    cfg, topo = spec.sim_config({}), spec.topo({})
    plan = faults.compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                               device="cpu")
    assert isinstance(plan, faults.SimFaultPlan)
    want, (jf, jm) = jax_campaign_kept(spec)
    kept = {}
    got = run_campaign(spec, device="cpu", lanes_out=kept)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    assert got["cells"][0]["round_path"] == "packed"
    assert got["cells"][0]["per_seed"] == want["cells"][0]["per_seed"]
    assert_lanes_equal_jax(jf, jm, kept[0]["finals"], kept[0]["metrics"],
                           "the packed matrix cell")


def _cell_of(spec, lanes):
    """The engine's packed cell (JAX's keys) that ``lanes`` make."""
    keys = ["rounds", "converged", "unconverged_nodes",
            "p99_node_convergence_round"]
    ps = {k: [lane[k] for lane in lanes] for k in keys}
    return {"params": {}, "n_nodes": chip_smoke.MATRIX_LANE_N,
            "n_payloads": 512, "round_path": "packed", "mesh": None,
            "n_devices": 1, "seeds": [lane["seed"] for lane in lanes],
            "plan_horizon": spec.fault_plan({}, seed=0).horizon,
            "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": all(ps["converged"]), "cell_index": 0}


def test_matrix_lanes_golden_is_jaxs_construction():
    """Path 70's golden: its spec_hash is JAX's CampaignSpec of the
    cell's dict, its result_digest JAX's ``artifact_digest`` over the cell
    its eight lanes make, every lane converged; the cell's plan compiles
    to the matrix form."""
    spec = chip_smoke.packed_matrix_spec()
    assert spec.spec_hash() == JaxSpec.from_dict(
        spec.to_dict()).spec_hash() == GOLDEN["spec_hash"]
    lanes = GOLDEN["lanes"]
    assert [lane["seed"] for lane in lanes] == list(range(8))
    assert artifact_digest([_cell_of(spec, lanes)]) == GOLDEN["result_digest"]
    assert all(lane["converged"] and lane["unconverged_nodes"] == 0
               for lane in lanes)
    cfg = spec.sim_config({})
    assert cfg.packed_min_cells == 0
    assert isinstance(faults.compile_plan(spec.fault_plan({}, seed=0), cfg,
                                          spec.topo({}), device="cpu"),
                      faults.SimFaultPlan)


def test_matrix_lanes_first_and_last_lane_match_golden():
    """The port's packed lanes of path 70's cell for seeds 0 and 7 on the
    CPU give the golden's lanes 0 and 7: rounds, p99, convergence and
    state digest."""
    spec = chip_smoke.packed_matrix_spec(seeds=(0, 7))
    kept = {}
    art = run_campaign(spec, device="cpu", lanes_out=kept)
    ps = art["cells"][0]["per_seed"]
    finals = kept[0]["finals"]
    for i, k in enumerate((0, 7)):
        got = {"seed": k, "rounds": ps["rounds"][i],
               "p99_node_convergence_round":
                   ps["p99_node_convergence_round"][i],
               "converged": ps["converged"][i],
               "unconverged_nodes": ps["unconverged_nodes"][i],
               "digest": state_digest(lane_state(finals, i))}
        assert got == GOLDEN["lanes"][k]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_matrix_lane_matches_live_jax(seed):
    """Lane ``seed`` of path 70's golden is live JAX's one-seed run of the
    cell (the call its comment names)."""
    jspec = JaxSpec.from_dict(chip_smoke.packed_matrix_spec().to_dict())
    cfg, topo = jspec.sim_config({}), jspec.topo({})
    meta = jax_payloads(cfg, inject_every=jspec.inject_every({}))
    fplan = jfaults.compile_plan(jspec.fault_plan({}, seed=0), cfg, topo)
    f, m = jens.run_ensemble(
        jens.seed_states(cfg, [seed]), meta, cfg, topo, fplan=fplan,
        plan_seeds=jens.lane_plan_seeds([seed]), max_rounds=3000)
    final = jax.tree.map(lambda x: x[0], f)
    conv = np.asarray(m.converged_at)[0]
    lane = GOLDEN["lanes"][seed]
    unconverged = int(((conv < 0) & (np.asarray(final.alive) == 0)).sum())
    assert {"seed": seed, "rounds": int(final.t),
            "p99_node_convergence_round": _percentile(conv, 99),
            "converged": unconverged == 0, "unconverged_nodes": unconverged,
            "digest": jax_digest(final)} == lane
