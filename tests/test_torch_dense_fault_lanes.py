"""The port's fault plans on the dense round's lanes (``sim/dense_lanes.py``
under a plan, through ``campaign/ensemble.py`` and ``campaign/engine.py``)
against JAX's ``campaign`` package (``jax.vmap`` of the dense branch of
``sim/faults.py run_fault_plan``) and against the port's own solo runs,
on the CPU: every new lane entry's plain version against the solo entry
on each lane's inputs (chip smoke's phase 3lf at shrunken shapes, every
trap reached), both committed 3-node fault campaigns through
``run_campaign`` (artifact, result_digest, per-seed records, every lane
field), the per-lane plan seeds, full-view fault lanes against the solo
runs, and the dense storm specs.  The 600-node storms are in
``test_torch_dense_fault_storm_matrix.py`` and
``test_torch_dense_fault_storm_factored.py``; ``-m slow`` re-derives
the goldens of paths 41-45 from live JAX."""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign import ensemble as jens
from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu.campaign.spec import builtin_spec as jbuiltin
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import (
    lane_plan_seeds,
    lane_state,
    run_ensemble,
    seed_states,
)
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
from corrosion_tpu_torch.sim.lanes import check_dense_lanes
from corrosion_tpu_torch.sim.round import new_sim
from corrosion_tpu_torch.sim.state import uniform_payloads
from tests.torch_parity import (
    assert_lanes_equal_jax,
    dense_storm_spec_at,
    jax_digest,
)

#: live JAX (jax 0.9.0) on the committed 3-node campaigns
PARITY_DIGEST = "884a69ea6075917ccc919f86e69c10fb"
PARITY_ROUNDS = [45, 50, 37, 42, 45, 41, 46, 38]
CAMPAIGN_DIGEST = "da302472016956218f82e72af2b14dfd"


def test_dense_fault_lane_entries_equal_the_solo_entries():
    """Every new lane entry's plain version (the CPU's) equals itself
    through its wrapper and, on lanes 0 and K - 1 (or the last), the
    solo entry: chip smoke's phase 3lf at 3 lanes, its 100k and 1000
    shapes shrunk to 1200 and 333 nodes, every trap reached (a wipe of
    lanes holding payloads beside an empty one, a jitter slot and a
    session delay that wrap the ring, a session refused in one direction
    only, done flags that flip at the horizon in some lanes, a wipe after
    convergence, lanes whose reach draws differ by plan seed)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_dense_fault_lane_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert [r["kernel"] for r in rows] == [
        "fault_reach_matrix_lanes", "node_faults_dense_lanes",
        "dense_broadcast_fault_lanes", "dense_sync_delay_lanes",
        "dense_gaps_exit_lanes"]
    assert all(r["equal"] for r in rows)


def _keeping_jax_finals():
    """JAX's `run_seed_ensemble` wrapped so a campaign keeps its finals;
    returns (store, restore)."""
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["finals"], kept["metrics"] = out[0], out[1]
        return out

    jens.run_seed_ensemble = keeping
    return kept, lambda: setattr(jens, "run_seed_ensemble", orig)


@pytest.mark.parametrize("name, golden", (
    ("fault-parity-3node", "FAULT_PARITY_3NODE_SEEDS8"),
    ("fault-campaign-3node", "FAULT_CAMPAIGN_3NODE_ENGINE")))
def test_fault_campaign_equals_live_jax(name, golden):
    """Both committed 3-node fault campaigns (matrix plans: loss, a
    one-way partition, delay, jitter, a crash with wipe) through the
    port's ``run_campaign`` on the CPU give live JAX's artifact — the
    spec_hash, the result_digest, the per-seed records — and every lane's
    state and stamps equal JAX's vmapped lane; the golden of paths 41-42
    (each lane's digest from JAX's finals) holds."""
    kept, restore = _keeping_jax_finals()
    try:
        want = jrun_campaign(jbuiltin(name), out_path=None)
    finally:
        restore()
    lanes_out = {}
    got = run_campaign(spec_mod.builtin_spec(name), device="cpu",
                       lanes_out=lanes_out)
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "plan_horizon",
                "all_converged", "seeds"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "dense"
    if name == "fault-parity-3node":
        assert got["result_digest"] == PARITY_DIGEST
        assert cell["per_seed"]["rounds"] == PARITY_ROUNDS
    else:
        assert got["result_digest"] == CAMPAIGN_DIGEST
    pf, pm = lanes_out[0]["finals"], lanes_out[0]["metrics"]
    assert_lanes_equal_jax(kept["finals"], kept["metrics"], pf, pm, name)
    lanes = [{"seed": s, "rounds": cell["per_seed"]["rounds"][i],
              "p99_node_convergence_round":
                  cell["per_seed"]["p99_node_convergence_round"][i],
              "digest": jax_digest(jax.tree.map(lambda x, i=i: x[i],
                                                kept["finals"]))}
             for i, s in enumerate(cell["seeds"])]
    assert getattr(goldens, golden) == {
        "spec_hash": want["spec_hash"],
        "result_digest": want["result_digest"], "lanes": lanes}
    assert [state_digest(lane_state(pf, i)) for i in range(len(lanes))] == [
        lane["digest"] for lane in lanes]


def _parity_setup(seeds):
    spec = spec_mod.fault_parity_3node_spec(seeds)
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=spec.inject_every({}))
    return spec, cfg, topo, meta


def _solo(spec, cfg, topo, meta, state_seed, plan_seed):
    fplan = compile_plan(spec.fault_plan({}, seed=plan_seed), cfg, topo,
                         device="cpu")
    return run_fault_plan(new_sim(cfg, state_seed, "cpu"), meta, cfg, topo,
                          fplan, spec.max_rounds)


def test_plan_seeds_reseed_each_dense_lane():
    """``run_ensemble`` hands its per-lane plan seeds to the dense lanes:
    lane k under ``plan_seeds`` is the solo run of the plan re-seeded
    with seed k, and without them every lane draws under the plan's own
    seed (the solo run of that seed's plan on lane k's state) — the two
    differ."""
    spec, cfg, topo, meta = _parity_setup((0, 1))
    fplan = compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                         device="cpu")
    states = seed_states(cfg, (0, 1), "cpu")
    seeded, _ = run_ensemble(states, meta, cfg, topo, fplan,
                             lane_plan_seeds((0, 1), "cpu"),
                             max_rounds=spec.max_rounds)
    shared, _ = run_ensemble(states, meta, cfg, topo, fplan,
                             max_rounds=spec.max_rounds)
    own, _ = _solo(spec, cfg, topo, meta, 1, 1)
    theirs, _ = _solo(spec, cfg, topo, meta, 1, 0)
    assert state_digest(lane_state(seeded, 1)) == state_digest(own)
    assert state_digest(lane_state(shared, 1)) == state_digest(theirs)
    assert state_digest(own) != state_digest(theirs)


@pytest.mark.parametrize("view", ("full", "partial"))
def test_fault_lanes_equal_the_solo_runs(view):
    """Three lanes of the fault storm with the latency pair on the dense
    round at 64 nodes (factored plan; full-view SWIM or partial view;
    the 3-node campaigns run ground truth) and one lane of it: each lane
    equals the port's solo ``run_fault_plan`` of its seed, field for
    field, with the stamps."""
    spec = dense_storm_spec_at((0, 2, 4), 64)
    extra = {"full": dict(swim_partial_view=False, swim_full_view=True),
             "partial": dict(member_slots=16)}[view]
    spec = dataclasses.replace(spec, scenario=dict(
        spec.scenario, n_payloads=64, **extra))
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=2)
    plan = spec.fault_plan({}, seed=0)
    fplan = compile_plan(plan, cfg, topo, factored=True, device="cpu")

    def lanes(seeds):
        return run_ensemble(seed_states(cfg, seeds, "cpu"), meta, cfg, topo,
                            fplan, lane_plan_seeds(seeds, "cpu"),
                            max_rounds=spec.max_rounds)

    finals, metrics = lanes(spec.seeds)
    for k, s in enumerate(spec.seeds):
        fp = compile_plan(dataclasses.replace(plan, seed=s), cfg, topo,
                          factored=True, device="cpu")
        solo, sm = run_fault_plan(new_sim(cfg, s, "cpu"), meta, cfg, topo,
                                  fp, spec.max_rounds)
        for name, a, b in zip(solo._fields, solo, lane_state(finals, k)):
            assert torch.equal(a, b), (k, name)
        for name in ("coverage_at", "converged_at", "overflow_frac"):
            assert torch.equal(getattr(sm, name), getattr(metrics, name)[k])
    one, _ = lanes((2,))
    assert state_digest(lane_state(one, 0)) == state_digest(
        lane_state(finals, 1))


def test_dense_check_accepts_fault_plans():
    """The dense lane check no longer refuses a plan, matrix or factored
    (with delay and jitter), nor the recorder under it (B16r)."""
    spec = dense_storm_spec_at((0,), 96)
    cfg, topo = spec.sim_config({}), spec.topo({})
    for factored in (False, True):
        fplan = compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                             factored=factored, device="cpu")
        check_dense_lanes(cfg, topo, fplan)
        check_dense_lanes(cfg, topo, fplan, telemetry=True)


@pytest.mark.parametrize("latency", (False, True))
def test_dense_storm_seeds_spec_is_jax_data(latency):
    """``dense_storm_seeds_spec`` is data: the JAX package's CampaignSpec
    of the same dict has the same hash (the golden's), the cell takes the
    dense round under the storm's events (and the latency pair with four
    delay slots), and the plan compiles factored at 100k."""
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.dense_storm_seeds_spec(latency=latency)
    assert spec.name == ("dense-latency-storm-100k-seeds8" if latency
                         else "dense-fault-storm-100k-seeds8")
    assert JaxSpec.from_dict(spec.to_dict()).spec_hash() == spec.spec_hash()
    golden = (goldens.DENSE_LATENCY_STORM_100K_SEEDS8 if latency
              else goldens.DENSE_FAULT_STORM_100K_SEEDS8)
    assert spec.spec_hash() == golden["spec_hash"]
    cfg = spec.sim_config({})
    assert not packed_supported(cfg, spec.topo({}))
    assert cfg.n_delay_slots == (4 if latency else 2)
    kinds = [ev.kind for ev in spec.events]
    assert kinds == ["loss", "partition", "crash"] + (
        ["delay", "jitter"] if latency else [])
    if latency:
        assert spec.events[3].src == "0:16666"


def test_storm_1000_spec_is_the_golden_cell():
    """``storm_seeds_spec(n_nodes=1000, faults=True)`` (path 43) takes the
    dense round under a matrix plan, with the golden's hash."""
    from corrosion_tpu_torch.sim.faults import SimFaultPlan
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.storm_seeds_spec(n_nodes=1000, faults=True)
    assert spec.spec_hash() == goldens.FAULT_STORM_1000_SEEDS8["spec_hash"]
    cfg, topo = spec.sim_config({}), spec.topo({})
    assert not packed_supported(cfg, topo)
    assert isinstance(compile_plan(spec.fault_plan({}, seed=0), cfg, topo,
                                   device="cpu"), SimFaultPlan)
    assert goldens.FAULT_STORM_1000_SEEDS8["lanes"][0] == dict(
        seed=0, **goldens.FAULT_STORM_1000_SEED0)


# -- the card's goldens, from live JAX ---------------------------------------


def _jax_campaign(spec_dict):
    """Live JAX's run_campaign of a spec dict: its artifact and its lanes
    in the goldens' form (seed, rounds, p99 and state digest)."""
    kept, restore = _keeping_jax_finals()
    try:
        art = jrun_campaign(JaxSpec.from_dict(spec_dict), out_path=None)
    finally:
        restore()
    cell = art["cells"][0]
    ps = cell["per_seed"]
    return art, [{"seed": s, "rounds": ps["rounds"][i],
                  "p99_node_convergence_round":
                      ps["p99_node_convergence_round"][i],
                  "digest": jax_digest(jax.tree.map(
                      lambda x, i=i: x[i], kept["finals"]))}
                 for i, s in enumerate(cell["seeds"])]


def _jax_golden(spec_dict):
    """Live JAX's run_campaign of a spec dict: (spec_hash, result_digest,
    lanes) in the goldens' form."""
    art, lanes = _jax_campaign(spec_dict)
    return {"spec_hash": art["spec_hash"],
            "result_digest": art["result_digest"], "lanes": lanes}


@pytest.mark.slow
def test_fault_storm_1000_seeds8_golden_matches_live_jax():
    """``FAULT_STORM_1000_SEEDS8`` (path 43) from live JAX's engine (about
    two minutes on the CPU), and the port's CPU run gives it too."""
    spec = spec_mod.storm_seeds_spec(n_nodes=1000, faults=True)
    assert _jax_golden(spec.to_dict()) == goldens.FAULT_STORM_1000_SEEDS8
    lanes_out = {}
    got = run_campaign(spec, device="cpu", lanes_out=lanes_out)
    assert got["result_digest"] == goldens.FAULT_STORM_1000_SEEDS8[
        "result_digest"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("latency", (False, True))
def test_dense_storm_100k_seeds8_golden_matches_live_jax(latency, seed):
    """``DENSE_FAULT_STORM_100K_SEEDS8`` and
    ``DENSE_LATENCY_STORM_100K_SEEDS8`` (paths 44-45) from live JAX's
    engine one seed at a time: the one-seed run_campaign of ``seed``
    (100 000 × 512 on the dense round, one to two minutes on the CPU; N
    is not a power of two, where JAX's vmapped lanes leave its solo
    runs) gives the golden's lane, and its cell is the one `_cell_of`
    builds from that lane, so
    `test_storm_golden_digest_is_jaxs_over_its_lanes` makes the 8-seed
    result digest JAX's too."""
    from corrosion_tpu.campaign.report import _strip_nondeterministic

    golden = (goldens.DENSE_LATENCY_STORM_100K_SEEDS8 if latency
              else goldens.DENSE_FAULT_STORM_100K_SEEDS8)
    spec = spec_mod.dense_storm_seeds_spec(latency=latency)
    assert JaxSpec.from_dict(spec.to_dict()).spec_hash() == golden[
        "spec_hash"]
    art, lanes = _jax_campaign(dataclasses.replace(
        spec, seeds=(seed,)).to_dict())
    lane = golden["lanes"][seed]
    assert lanes == [lane]
    assert _strip_nondeterministic(art["cells"][0]) == \
        _strip_nondeterministic(_cell_of({"lanes": [lane]}, 100_000, 21))


def _cell_of(golden, n_nodes, horizon):
    """The engine's cell (JAX's keys) of a sim golden whose lanes all
    converged, rebuilt from its lanes."""
    from corrosion_tpu.campaign.report import BAND_METRICS, bands

    lanes = golden["lanes"]
    ps = {"rounds": [lane["rounds"] for lane in lanes],
          "converged": [True] * len(lanes),
          "unconverged_nodes": [0] * len(lanes),
          "p99_node_convergence_round": [
              lane["p99_node_convergence_round"] for lane in lanes]}
    return {"params": {}, "n_nodes": n_nodes, "n_payloads": 512,
            "round_path": "dense", "mesh": None, "n_devices": 1,
            "seeds": [lane["seed"] for lane in lanes],
            "plan_horizon": horizon, "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": True, "cell_index": 0}


@pytest.mark.parametrize("name, n_nodes", (
    ("FAULT_STORM_1000_SEEDS8", 1000),
    ("DENSE_FAULT_STORM_100K_SEEDS8", 100_000),
    ("DENSE_LATENCY_STORM_100K_SEEDS8", 100_000)))
def test_storm_golden_digest_is_jaxs_over_its_lanes(name, n_nodes):
    """Each storm golden's result_digest is JAX's ``artifact_digest`` over
    the cell its lanes make (horizon 21): checked on the 1000-node golden
    pinned from live JAX, it ties the 100k goldens' digests to their
    lanes, which ``-m slow`` pins from live JAX one seed at a time."""
    from corrosion_tpu.campaign.report import artifact_digest

    golden = getattr(goldens, name)
    assert artifact_digest([_cell_of(golden, n_nodes, 21)]) == golden[
        "result_digest"]


def test_dense_fault_storm_lanes_are_the_packed_ensembles():
    """The dense fault storm's lanes (path 44) are the packed fault
    storm ensemble's (JAX's dense == packed contract): the same rounds,
    p99s and state digests, lane 0 JAX's solo dense golden; the latency
    storm's lane 0 is JAX's solo dense latency golden."""
    assert goldens.DENSE_FAULT_STORM_100K_SEEDS8["lanes"] == \
        goldens.FAULT_STORM_100K_SEEDS8["lanes"]
    for seeds8, solo in (
            (goldens.DENSE_FAULT_STORM_100K_SEEDS8,
             goldens.DENSE_FAULT_STORM_100K_SEED0),
            (goldens.DENSE_LATENCY_STORM_100K_SEEDS8,
             goldens.DENSE_LATENCY_STORM_100K_SEED0)):
        assert {k: seeds8["lanes"][0][k] for k in solo} == solo
