"""Metered budgets, topology families and every membership mode on the
packed round's lanes (B16m's budgets and topology, B16s's packed half:
``sim/lanes.py``'s K16 on the lanes' rows, K3m's lane entry, K10's flat
and tiered lane streams, and the sampler, SWIM and PeerSwap lane entries
in the packed lane round, through ``campaign/ensemble.py`` and
``campaign/engine.py``) against JAX's ``campaign`` package on the CPU:
every new lane entry's plain version against the solo entry on its lane's
inputs (chip smoke's phase 3lm at 3 lanes with its shapes shrunk, every
trap reached); the topology families, PeerSwap under ground truth and
full view at a forced-packed small shape through the port's engine and
ensemble against live JAX, field for field; full view and the WAN family
under a factored plan with delay and jitter at 1280 nodes (at 1024 JAX's
vmapped factored lanes leave its own solo runs); what the lanes once
refused by name (the protocol variants, a matrix plan) through the engine
against live JAX; the goldens of chip smoke's paths 63-66.  The metered gapstress cell is
``tests/test_torch_packed_lane_metered.py``.  ``-m slow`` holds every
lane of path 66 to live JAX's one-seed run of its seed."""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign import ensemble as jens
from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu.campaign.report import BAND_METRICS, artifact_digest, bands
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.telemetry import CHANNELS
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_digest,
    jax_telemetry,
)


def test_packed_lane_axis_entries_equal_the_solo_entries():
    """K16 on the lanes' rows, K3m's lane entry (its delay classes and its
    recording form), K10's flat lane stream and the tiered lane
    instantiation (with and without the fault loss and the jitter, and
    as recording forms) equal their plain versions through their wrappers
    and, on lanes 0 and K - 1, the solo entries: phase 3lm at 3 lanes of
    163 gapstress nodes and 300 WAN storm nodes, every trap reached (a
    budget that binds in one lane and not in another, a prefix that stops
    mid-word, a payload larger than the budget, a delay class past D - 2
    under metering, a tier at certainty, lanes whose keys and seeds
    differ, K16's blocks spanning two lanes, a lane without edges); and
    K1's view lane entry and K21's lane entries at 3 lanes of 333 nodes,
    the last lane held to the solo entry."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_packed_lane_metered_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert [r["name"] for r in rows] == [
        "budget_words_lanes", "sync_pull_metered_lanes",
        "sync_pull_metered_lanes_trace", "broadcast_scatter_lossy_lanes_topo",
        "broadcast_scatter_lossy_lanes_trace_topo",
        "broadcast_scatter_tiered_lanes",
        "broadcast_scatter_tiered_lanes_trace", "sample_view_lanes_25600",
        "peerswap_lanes_25600"]
    assert all(r["equal"] for r in rows)


# -- the topology families and the membership modes against live JAX --------


def _jax_campaign(spec, telemetry=False):
    """Live JAX's run_campaign of a port spec and its lanes' finals and
    metrics (JAX's run_seed_ensemble, kept from inside the call)."""
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["out"] = out
        return out

    with mock.patch.object(jens, "run_seed_ensemble", keeping), (
            jax_telemetry() if telemetry else contextlib.nullcontext()):
        art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                            telemetry=telemetry)
    return art, kept["out"]


def _small_spec(name, extra, seeds=(0, 1), n=192, events=()):
    """The write storm at ``n`` × 64 inside the packed envelope
    (``packed_min_cells`` 0) with ``extra`` scenario keys."""
    scenario = dict(spec_mod.storm_scenario(n), n_payloads=64,
                    packed_min_cells=0, **extra)
    return spec_mod.CampaignSpec(name=name, scenario=scenario,
                                 events=tuple(events), seeds=tuple(seeds),
                                 max_rounds=400)


#: the cells of the packed lanes' new axes at a small forced-packed shape
AXIS_CELLS = {
    "wan-3x2": dict(topo_family="wan-3x2", n_delay_slots=3),
    "wan-fly-6r": dict(topo_family="wan-fly-6r", n_delay_slots=6),
    "hetero-degree": dict(topo_family="hetero-degree"),
    "flat-lossy": dict(topo_family="flat-lossy"),
    "peerswap": dict(peer_sampler="peerswap", swim_partial_view=False),
    "full_view": dict(swim_partial_view=False, swim_full_view=True),
}


def _hold_cell(spec, telemetry=False):
    """The port's engine on ``spec`` against live JAX's: spec_hash,
    result_digest, the cell's records, bands and round_path "packed",
    every lane's state and stamps field for field (and, recording, the
    telemetry block and every lane's trace)."""
    want, jout = _jax_campaign(spec, telemetry)
    lanes_out = {}
    got = run_campaign(spec, device="cpu", telemetry=telemetry,
                       lanes_out=lanes_out)
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    cell, jcell = got["cells"][0], want["cells"][0]
    keys = ["per_seed", "bands", "round_path", "all_converged", "seeds"]
    if telemetry:
        keys.append("telemetry")
    for key in keys:
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "packed"
    assert_lanes_equal_jax(jout[0], jout[1], lanes_out[0]["finals"],
                           lanes_out[0]["metrics"], spec.name)
    if telemetry:
        for name in CHANNELS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jout[2], name)),
                getattr(lanes_out[0]["traces"], name).numpy(),
                err_msg=f"{spec.name}: {name}")
    return cell


@pytest.mark.parametrize("case", sorted(AXIS_CELLS))
def test_packed_lane_axes_equal_live_jax(case):
    """Each topology family (wan-3x2, wan-fly-6r, hetero-degree,
    flat-lossy), PeerSwap under ground-truth membership and full view on
    the packed round's lanes (two seeds at 192 × 64, the envelope forced
    open) through the port's ``run_campaign(..., device="cpu")``: live
    JAX's artifact and every lane field for field, round_path "packed".
    The WAN cell records, so its dropped frames come from the tiered
    stream, and its lanes leave in different rounds."""
    cell = _hold_cell(_small_spec(case, AXIS_CELLS[case]),
                      telemetry=case == "wan-3x2")
    if case == "wan-3x2":
        assert len(set(cell["per_seed"]["rounds"])) > 1


def _plan_events(n):
    """The fault storm's events at ``n`` nodes (loss, the half split, node
    1 down 8-19 and back wiped) and the latency pair (delay and jitter
    out of the first sixth)."""
    return spec_mod.storm_fault_events(n) + spec_mod.storm_latency_events(n)


@pytest.mark.parametrize("case", ("full_view", "wan-3x2"))
def test_packed_lanes_under_a_latency_plan_equal_live_jax(case):
    """Full view, and the wan-3x2 family, under a factored plan with
    delay and jitter that wipes node 1 at round 20, at 1280 × 64 on the
    packed round's lanes (two seeds) through the port's recording
    ``run_seed_ensemble`` against JAX's: every lane's state (the wiped
    full-view row back to 0, 0, -1, K11's lane entry with its full-view
    tables) and every trace channel field for field."""
    extra = dict(AXIS_CELLS[case], n_delay_slots=5)
    spec = _small_spec(case, extra, seeds=(0, 1), n=1280,
                       events=_plan_events(1280))
    jspec = JaxSpec.from_dict(spec.to_dict())
    with jax_telemetry():
        from corrosion_tpu.sim.state import uniform_payloads as jpayloads

        jcfg = jspec.sim_config({})
        jf, jm, jtrace = jens.run_seed_ensemble(
            jspec.fault_plan({}, seed=0), jcfg, jspec.topo({}),
            jpayloads(jcfg, inject_every=2), jspec.seeds, max_rounds=60,
            telemetry=True)
        jtrace = {name: np.asarray(getattr(jtrace, name))
                  for name in CHANNELS}
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=2)
    pf, pm, trace = run_seed_ensemble(
        spec.fault_plan({}, seed=0), cfg, topo, meta, spec.seeds,
        max_rounds=60, telemetry=True, device="cpu")
    assert_lanes_equal_jax(jf, jm, pf, pm, case)
    for name in CHANNELS:
        np.testing.assert_array_equal(jtrace[name],
                                      getattr(trace, name).numpy(),
                                      err_msg=f"{case}: {name}")
    assert min(pf.t.tolist()) > 20  # past node 1's wiped restart
    assert int(trace.bcast_dropped.sum()) > 0


# -- what the lanes refused by name ------------------------------------------


@pytest.mark.parametrize("case", ("protocol", "matrix"))
def test_packed_lanes_still_refuse_by_name(case):
    """What the packed round's lanes refused by name runs there now,
    through the engine, giving live JAX's artifact lane for lane: the
    protocol variants, refused naming B16m and the four kernels it
    lacked, since B16m's rest (the push-pull cell); a matrix plan,
    refused naming B16x, since B16x (a loss burst over 512 nodes, below
    the factored form's 1024)."""
    if case == "protocol":
        spec = _small_spec(case, {"proto_family": "push-pull"})
    else:
        spec = _small_spec(case, {}, n=512, events=(
            spec_mod.FaultEvent("loss", 0, 4, p=0.2),))
    want, jout = _jax_campaign(spec)
    kept = {}
    got = run_campaign(spec, device="cpu", lanes_out=kept)
    assert got["result_digest"] == want["result_digest"]
    assert got["cells"][0]["round_path"] == "packed"
    assert_lanes_equal_jax(jout[0], jout[1], kept[0]["finals"],
                           kept[0]["metrics"], case)


# -- the goldens of paths 63-66 -----------------------------------------------


def _cell_of(lanes, round_path):
    """The engine's faultless 100k storm cell (JAX's keys) of a golden's
    lanes."""
    ps = {"rounds": [lane["rounds"] for lane in lanes],
          "converged": [lane["converged"] for lane in lanes],
          "unconverged_nodes": [lane["unconverged_nodes"] for lane in lanes],
          "p99_node_convergence_round": [
              lane["p99_node_convergence_round"] for lane in lanes]}
    return {"params": {}, "n_nodes": 100_000, "n_payloads": 512,
            "round_path": round_path, "mesh": None, "n_devices": 1,
            "seeds": [lane["seed"] for lane in lanes], "plan_horizon": 0,
            "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": True, "cell_index": 0}


def test_packed_wan_storm_golden_is_jaxs_construction():
    """``STORM_WAN_3X2_100K_SEEDS8`` (path 64): its spec_hash is JAX's
    CampaignSpec of the packed cell's dict, its result_digest JAX's
    ``artifact_digest`` over the packed cell the dense lanes' pins make
    (the same construction gives the dense golden's digest, and lane 0's
    one-seed digest); lane 0 is the solo golden's.  The family cells of
    path 65 resolve to their solo goldens' configurations."""
    from corrosion_tpu_torch.sim.runner import _resolve_topo
    from corrosion_tpu_torch.sim.state import packed_supported

    golden = goldens.STORM_WAN_3X2_100K_SEEDS8
    dense = goldens.DENSE_STORM_WAN_3X2_100K_SEEDS8
    spec = spec_mod.storm_topology_seeds_spec("wan-3x2")
    assert spec.spec_hash() == JaxSpec.from_dict(
        spec.to_dict()).spec_hash() == golden["spec_hash"]
    assert golden["lanes"] == dense["lanes"]
    assert artifact_digest([_cell_of(dense["lanes"], "dense")]) == \
        dense["result_digest"]
    assert artifact_digest([_cell_of(golden["lanes"], "packed")]) == \
        golden["result_digest"]
    assert artifact_digest([_cell_of(golden["lanes"][:1], "packed")]) == \
        golden["seed0_result_digest"]
    solo = goldens.STORM_WAN_3X2_100K_SEED0
    assert {k: golden["lanes"][0][k] for k in
            ("rounds", "p99_node_convergence_round", "digest")} == {
        k: solo[k] for k in ("rounds", "p99_node_convergence_round",
                             "digest")}
    for family, slots in (("wan-3x2", 3), ("wan-fly-6r", 6),
                          ("hetero-degree", 2)):
        spec = spec_mod.storm_topology_seeds_spec(family)
        cfg, topo = spec.sim_config({}), spec.topo({})
        assert spec.name == f"storm-{family}-100k-seeds8"
        assert (cfg.n_nodes, cfg.n_payloads, cfg.n_delay_slots) == (
            100_000, 512, slots)
        assert topo == _resolve_topo(family) and packed_supported(cfg, topo)
        assert spec.spec_hash() == JaxSpec.from_dict(
            spec.to_dict()).spec_hash()


def test_dense_and_packed_wan_lanes_agree_in_jax_and_the_port():
    """The dense == packed contract the packed WAN cell's pins rest on,
    at 1280 nodes: JAX's vmapped dense lanes of the wan-3x2 storm
    (``allow_packed`` False) and the port's packed lanes of the same cell
    (``packed_min_cells`` 0) end in the same states, digest for digest,
    two seeds."""
    base = dict(spec_mod.storm_scenario(1280), n_payloads=64,
                topo_family="wan-3x2", n_delay_slots=3)
    dense = spec_mod.CampaignSpec(
        name="wan", scenario=dict(base, allow_packed=False), seeds=(0, 1),
        max_rounds=400)
    packed = dataclasses.replace(dense, scenario=dict(base,
                                                      packed_min_cells=0))
    jart, jout = _jax_campaign(dense)
    assert jart["cells"][0]["round_path"] == "dense"
    lanes_out = {}
    art = run_campaign(packed, device="cpu", lanes_out=lanes_out)
    assert art["cells"][0]["round_path"] == "packed"
    import jax

    from corrosion_tpu_torch.campaign.ensemble import lane_state

    for k in range(2):
        jlane = jax.tree.map(lambda x, k=k: x[k], jout[0])
        assert state_digest(lane_state(lanes_out[0]["finals"], k)) == \
            jax_digest(jlane)
    assert art["cells"][0]["per_seed"] == jart["cells"][0]["per_seed"]


def test_peerswap_golden_lane0_is_the_solo_golden():
    """``STORM_PEERSWAP_25600_SEEDS8`` (path 66): eight lanes in seed
    order, lane 0 ``STORM_PEERSWAP_25600_SEED0``."""
    lanes = goldens.STORM_PEERSWAP_25600_SEEDS8["lanes"]
    assert [lane["seed"] for lane in lanes] == list(range(8))
    solo = goldens.STORM_PEERSWAP_25600_SEED0
    assert {k: lanes[0][k] for k in solo} == solo


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_peerswap_storm_lane_matches_live_jax(seed):
    """Lane ``seed`` of ``STORM_PEERSWAP_25600_SEEDS8`` (path 66) from live
    JAX: the one-seed run of the PeerSwap storm at 25 600 × 512 (ground
    truth membership, the packed round; a few seconds on the CPU) gives
    its rounds, p99s, state digest and view digest."""
    from corrosion_tpu.sim import round as jround
    from corrosion_tpu.sim import runner as jrunner

    topo = jrunner._resolve_topo(None)
    jcfg, jmeta = jrunner._write_storm(25_600, 512, topo=topo,
                                       sampler="peerswap")
    final, metrics = jround.run_to_convergence(
        jround.new_sim(jcfg, seed), jmeta, jcfg, topo, 3000)
    cov = np.asarray(metrics.coverage_at)
    lat = np.where(cov >= 0, cov - np.asarray(jmeta.round), -1)
    assert {"seed": seed, "rounds": int(final.t),
            "p99_node_convergence_round": jrunner._percentile(
                np.asarray(metrics.converged_at), 99),
            "p99_payload_latency_rounds": jrunner._percentile(lat, 99),
            "digest": jax_digest(final),
            "pview_digest": jax_digest(final, skip=[
                f for f in type(final)._fields if f != "pview"])} == \
        goldens.STORM_PEERSWAP_25600_SEEDS8["lanes"][seed]
