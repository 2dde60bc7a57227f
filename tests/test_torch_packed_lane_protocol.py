"""The protocol variants on the packed round's lanes (B16m's rest:
``sim/lanes.py``'s K10p, K8f, K22's words and K18's words-pull lane
entries, the eager cadence and the fan-out schedule in the packed lane
round, through ``campaign/ensemble.py`` and ``campaign/engine.py``) against
JAX's ``campaign`` package on the CPU: every new lane entry's plain
version against the solo entry on its lane's inputs (chip smoke's phase
3lq at 3 lanes with its shapes shrunk, every trap reached); the six
protocol families at 1280 nodes through the port's engine against live
JAX, field for field; push-pull under a matrix plan (B16x) through the
engine against live JAX; the goldens of chip smoke's paths 67-68.  ``-m slow`` holds every lane of
those goldens to live JAX's one-seed campaign of its seed.  The recorder,
the dense == packed contract, a plan and every knob at once are
``tests/test_torch_packed_lane_protocol_runs.py``."""

import dataclasses
from itertools import product
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign.report import BAND_METRICS, artifact_digest, bands
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.proto.families import FAMILIES
from corrosion_tpu_torch.sim.faults import compile_plan
from corrosion_tpu_torch.sim.lanes import check_packed_lanes
from corrosion_tpu_torch.sim.state import uniform_payloads
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_campaign_kept,
    jax_digest,
    proto_storm_spec_at,
)


def test_packed_lane_protocol_entries_equal_the_solo_entries():
    """K10p's lane entry (its three streams and their recording forms),
    K18's words-pull, K8f's and K22's words lane entries equal their plain
    versions through their wrappers and, on lanes 0 and K - 1, the solo
    entries: phase 3lq at 3 lanes of 301 nodes (pulls of 4 words) and its
    odd check at 203, every trap reached (lanes whose k_drop and seeds
    differ, a reverse tier at certainty, a severed flat channel, reverse
    fault loss where the forward edge has none, a pull refused by a
    one-way cut, a lane without edges, a FIFO gate that drops in one lane
    what it admits in another, order counts that differ by lane with one
    0, a partial last block in every lane)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_packed_lane_protocol_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert [r["name"] for r in rows] == [
        "broadcast_pull_lanes", "broadcast_pull_lossy_lanes",
        "broadcast_pull_lossy_lanes_trace", "broadcast_pull_tiered_lanes",
        "broadcast_pull_tiered_lanes_trace", "trace_wire_pull_lanes",
        "word_deliver_fifo_lanes", "order_check_words_lanes"]
    assert all(r["equal"] for r in rows)


# -- the families and the knobs against live JAX -----------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_on_the_packed_lanes_equals_live_jax(family):
    """Each protocol family's storm at 1280 nodes, two seeds, through the
    port's engine on the packed round's lanes: live JAX's spec_hash,
    result_digest, per-seed records (order counts on the ordering cells)
    and bands, and every lane's state, stamps and order count field for
    field.  The lab-ordered lanes count no violation; the broken ones
    count JAX's, which differ by lane."""
    spec = proto_storm_spec_at(family)
    want, jout = jax_campaign_kept(spec)
    kept = {}
    got = run_campaign(spec, device="cpu", lanes_out=kept)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "all_converged"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "packed"
    pf, pm = kept[0]["finals"], kept[0]["metrics"]
    assert_lanes_equal_jax(jout[0], jout[1], pf, pm, family)
    np.testing.assert_array_equal(np.asarray(jout[1].order_violations),
                                  pm.order_violations.numpy())
    if family == "lab-ordered":
        assert cell["per_seed"]["order_violations"] == [0, 0]
    if family == "lab-ordered-broken":
        counts = cell["per_seed"]["order_violations"]
        assert min(counts) > 0 and len(set(counts)) > 1


def test_packed_lanes_accept_every_knob_and_a_matrix_plan():
    """``check_packed_lanes`` takes every family and every combination of
    the protocol knobs, with a factored plan or a matrix one (B16x); a
    push-pull cell under a matrix plan (the pull's session refusal and
    reverse thresholds through K9m's edge entry) runs through the
    ensemble and the engine, whose artifact and lanes are live JAX's."""
    base = proto_storm_spec_at("baseline").sim_config({})
    plan = spec_mod.FaultPlan(n_nodes=1280, seed=0, events=())
    fplan = compile_plan(plan, base, factored=True, device="cpu")
    for family in FAMILIES:
        spec = proto_storm_spec_at(family)
        check_packed_lanes(spec.sim_config({}), spec.topo({}))
    for dis, sched, cad, order in product(
            ("push", "push-pull"), ("flat", "decay"), ("periodic", "eager"),
            ("none", "fifo", "fifo-unchecked")):
        cfg = dataclasses.replace(
            base, n_payloads=128, dissemination=dis, fanout_schedule=sched,
            fanout_decay_rounds=4, sync_cadence=cad, ordering=order)
        check_packed_lanes(cfg, proto_storm_spec_at("baseline").topo({}),
                           fplan)
    spec = spec_mod.CampaignSpec(
        name="matrix", scenario=dict(spec_mod.storm_scenario(512),
                                     n_payloads=64, packed_min_cells=0,
                                     proto_family="push-pull"),
        events=(spec_mod.FaultEvent("loss", 0, 4, p=0.2),
                spec_mod.FaultEvent("partition", 1, 3, src="0:256",
                                    dst="256:512")),
        seeds=(0, 1), max_rounds=6)
    cfg, topo = spec.sim_config({}), spec.topo({})
    matrix = compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                          factored=False, device="cpu")
    check_packed_lanes(cfg, topo, matrix)
    finals, _ = run_seed_ensemble(
        spec.fault_plan({}, seed=0), cfg, topo,
        uniform_payloads(cfg, "cpu", inject_every=2), (0,), max_rounds=6,
        device="cpu")
    assert finals.t.tolist() == [6]
    want, (jf, jm) = jax_campaign_kept(spec)
    kept = {}
    got = run_campaign(spec, device="cpu", lanes_out=kept)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    assert_lanes_equal_jax(jf, jm, kept[0]["finals"], kept[0]["metrics"],
                           "push-pull under a matrix plan")


# -- the goldens of paths 67-68 ---------------------------------------------

#: each path's golden and its lane 0's solo golden
PROTO_CELLS = chip_smoke._PROTO_GOLDENS


def _cell_of(spec, lanes):
    """The engine's packed cell (JAX's keys) of a golden's lanes of
    ``spec``'s storm."""
    keys = ["rounds", "converged", "unconverged_nodes",
            "p99_node_convergence_round"]
    if "order_violations" in lanes[0]:
        keys.append("order_violations")
    ps = {k: [lane[k] for lane in lanes] for k in keys}
    plan = spec.fault_plan({}, seed=spec.seeds[0])
    return {"params": {}, "n_nodes": 100_000, "n_payloads": 512,
            "round_path": "packed", "mesh": None, "n_devices": 1,
            "seeds": [lane["seed"] for lane in lanes],
            "plan_horizon": plan.horizon if plan is not None else 0,
            "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": all(ps["converged"]), "cell_index": 0}


@pytest.mark.parametrize("which", sorted(PROTO_CELLS))
def test_packed_proto_golden_is_jaxs_construction(which):
    """Each golden of paths 67-68: its spec_hash is JAX's CampaignSpec of
    the packed cell's dict, its result_digest JAX's ``artifact_digest``
    over the packed cell its eight lanes make (lane 0's alone gives its
    seed0_result_digest, the one-seed run's), lane 0 is the solo golden
    of its configuration; the push-pull cell's lanes are the dense
    push-pull lanes' pins (the dense == packed contract)."""
    golden_name, solo_name = PROTO_CELLS[which]
    golden = getattr(goldens, golden_name)
    spec = chip_smoke.packed_proto_spec(which)
    assert spec.spec_hash() == JaxSpec.from_dict(
        spec.to_dict()).spec_hash() == golden["spec_hash"]
    lanes = golden["lanes"]
    assert [lane["seed"] for lane in lanes] == list(range(8))
    assert artifact_digest([_cell_of(spec, lanes)]) == \
        golden["result_digest"]
    one = dataclasses.replace(spec, seeds=(0,))
    assert artifact_digest([_cell_of(one, lanes[:1])]) == \
        golden["seed0_result_digest"]
    solo = getattr(goldens, solo_name)
    assert {k: lanes[0][k] for k in ("rounds", "digest")} == {
        k: solo[k] for k in ("rounds", "digest")}
    if "order_violations" in lanes[0]:
        assert lanes[0]["order_violations"] == solo["order_violations"]
    if which == "push-pull":
        assert lanes == goldens.DENSE_STORM_PUSH_PULL_100K_SEEDS8["lanes"]
    if which == "lab-ordered":
        assert all(lane["order_violations"] == 0 for lane in lanes)
    cfg = spec.sim_config({})
    assert (cfg.n_nodes, cfg.n_payloads) == (100_000, 512)
    assert spec.topo({}) == chip_smoke._topo(
        "wan-3x2" if which == "wan-push-pull" else None)


@pytest.mark.slow
@pytest.mark.parametrize("which,seed", list(product(sorted(PROTO_CELLS),
                                                    range(8))))
def test_packed_proto_100k_lane_matches_live_jax(which, seed):
    """Lane ``seed`` of a path 67-68 golden from live JAX's engine: the
    one-seed run_campaign of ``seed`` (100 000 x 512 on the packed round,
    ten seconds to two minutes on the CPU) gives the golden's lane —
    rounds, the engine's p99, convergence, state digest, order count —
    and its cell is the one `_cell_of` builds from that lane."""
    from corrosion_tpu.campaign.report import _strip_nondeterministic

    golden = getattr(goldens, PROTO_CELLS[which][0])
    spec = dataclasses.replace(chip_smoke.packed_proto_spec(which),
                               seeds=(seed,))
    art, jout = jax_campaign_kept(spec)
    cell = art["cells"][0]
    ps = cell["per_seed"]
    lane = {"seed": seed, "rounds": ps["rounds"][0],
            "p99_node_convergence_round":
                ps["p99_node_convergence_round"][0],
            "converged": ps["converged"][0],
            "unconverged_nodes": ps["unconverged_nodes"][0],
            "digest": jax_digest(jax.tree.map(lambda x: x[0], jout[0]))}
    if "order_violations" in ps:
        lane["order_violations"] = ps["order_violations"][0]
    assert lane == golden["lanes"][seed]
    assert cell["round_path"] == "packed"
    assert _strip_nondeterministic(cell) == _strip_nondeterministic(
        _cell_of(spec, [lane]))
    if seed == 0:
        assert art["result_digest"] == golden["seed0_result_digest"]
