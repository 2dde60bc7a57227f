"""Latency plans on the packed round's lanes (B16l: ``sim/lanes.py``'s
lane entries of K10j and K3's delay entry, through
``campaign/ensemble.py`` and ``campaign/engine.py``) against JAX's
``campaign`` package on the CPU: every new lane entry's plain version
against the solo entry on its lane's inputs (chip smoke's phase 3lp at 3
lanes with its 100k shapes shrunk to 1200 nodes, every trap reached),
the latency storm's cell at 1280 × 64 through the port's engine against
live JAX's artifact and vmapped lanes, field for field (1280, not 1024:
at 1024 nodes JAX's vmapped factored lanes leave its own solo runs), and
the 100k golden's construction.  ``-m slow`` holds every lane of
latency-storm-100k-seeds8 to live JAX's one-seed campaign of its seed."""

import dataclasses
from unittest import mock

import jax
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
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_digest,
    latency_storm_spec_at,
)


def test_packed_lane_latency_entries_equal_the_solo_entries():
    """K10j's lane entry, K3's delay lane entry, the recording forms of
    K10's, K10j's and K3's lane entries, and K17's and K18's word lane
    entries equal their plain versions through their wrappers and, on
    lanes 0 and K - 1, the solo entries: phase 3lp at 3 lanes of 1200
    nodes, every trap reached (lanes whose draws differ by key and plan
    seed, a block of jittered and unjittered edges, loss and jitter on one
    edge, a slot holding an earlier round's slower grant, a class past
    D - 2, a session refused one way, fruitful from delayed classes only,
    counts that differ by lane with one 0, a lane without edges)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_packed_lane_latency_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert [r["name"] for r in rows] == [
        "broadcast_scatter_jitter_lanes",
        "broadcast_scatter_jitter_lanes_trace",
        "broadcast_scatter_lossy_lanes_trace", "sync_pull_delay_lanes",
        "sync_pull_delay_lanes_trace", "sync_pull_lanes_trace",
        "trace_counts_lanes", "trace_coverage_lanes", "trace_wire_lanes"]
    assert all(r["equal"] for r in rows)


def _jax_campaign(spec_dict):
    """Live JAX's run_campaign of a spec dict and its lanes' finals and
    metrics (JAX's run_seed_ensemble, kept from inside the call)."""
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["finals"], kept["metrics"] = out[0], out[1]
        return out

    with mock.patch.object(jens, "run_seed_ensemble", keeping):
        art = jrun_campaign(JaxSpec.from_dict(spec_dict), out_path=None)
    return art, kept["finals"], kept["metrics"]


def test_latency_storm_lanes_equal_live_jax():
    """The latency storm's cell at 1280 nodes × 64 payloads, seeds 0-2,
    through the port's ``run_campaign(..., device="cpu")``: live JAX's
    spec_hash, result_digest, per-seed records and bands on the packed
    round (``LATENCY_STORM_LANES_1280``), and every lane's state and
    stamps equal to JAX's vmapped lane, field for field."""
    spec = latency_storm_spec_at((0, 1, 2))
    want, jf, jm = _jax_campaign(spec.to_dict())
    lanes_out = {}
    got = run_campaign(spec, device="cpu", lanes_out=lanes_out)
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "plan_horizon",
                "all_converged", "seeds"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "packed"
    pin = goldens.LATENCY_STORM_LANES_1280
    assert {"spec_hash": got["spec_hash"],
            "result_digest": got["result_digest"],
            "rounds": cell["per_seed"]["rounds"],
            "p99_node_convergence_round":
                cell["per_seed"]["p99_node_convergence_round"]} == pin
    assert_lanes_equal_jax(jf, jm, lanes_out[0]["finals"],
                           lanes_out[0]["metrics"], "latency-storm-lanes")


def _cell_of(lanes):
    """The engine's cell (JAX's keys) of the 100k latency storm's lanes,
    every one converged, on the packed round (plan horizon 21)."""
    ps = {"rounds": [lane["rounds"] for lane in lanes],
          "converged": [True] * len(lanes),
          "unconverged_nodes": [0] * len(lanes),
          "p99_node_convergence_round": [
              lane["p99_node_convergence_round"] for lane in lanes]}
    return {"params": {}, "n_nodes": 100_000, "n_payloads": 512,
            "round_path": "packed", "mesh": None, "n_devices": 1,
            "seeds": [lane["seed"] for lane in lanes], "plan_horizon": 21,
            "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": True, "cell_index": 0}


def test_latency_storm_golden_is_jaxs_construction():
    """``LATENCY_STORM_100K_SEEDS8`` (path 60): its spec_hash is JAX's
    CampaignSpec of the 8-seed dict (and the wire cell's of its one-seed
    dict), its result_digest JAX's ``artifact_digest`` over the cell its
    lanes make (the construction gives lane 0's one-seed digest too);
    its lanes are the dense latency storm ensemble's (JAX's dense ==
    packed contract) and lane 0 the solo golden's."""
    golden = goldens.LATENCY_STORM_100K_SEEDS8
    spec = spec_mod.latency_storm_seeds_spec()
    assert spec.spec_hash() == JaxSpec.from_dict(
        spec.to_dict()).spec_hash() == golden["spec_hash"]
    wire = spec_mod.latency_storm_seeds_spec((0,), measure_wire=True)
    assert wire.spec_hash() == JaxSpec.from_dict(
        wire.to_dict()).spec_hash() == \
        goldens.LATENCY_STORM_100K_SEEDS1_WIRE["spec_hash"]
    assert artifact_digest([_cell_of(golden["lanes"])]) == golden[
        "result_digest"]
    assert artifact_digest([_cell_of(golden["lanes"][:1])]) == golden[
        "seed0_result_digest"]
    keys = ("seed", "rounds", "p99_node_convergence_round", "digest")
    assert [{k: lane[k] for k in keys} for lane in golden["lanes"]] == \
        goldens.DENSE_LATENCY_STORM_100K_SEEDS8["lanes"]
    solo = goldens.LATENCY_STORM_100K_SEED0
    assert {k: golden["lanes"][0][k] for k in solo} == solo


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_latency_storm_100k_lane_matches_live_jax(seed):
    """Lane ``seed`` of ``LATENCY_STORM_100K_SEEDS8`` (path 60) from live
    JAX's engine: the one-seed run_campaign of ``seed`` (100 000 × 512 on
    the packed round, about ninety seconds on the CPU) gives the golden's
    lane — rounds, p99, convergence, state digest — and its cell is the
    one `_cell_of` builds from that lane (lane 0's digest is the golden's
    seed0_result_digest)."""
    from corrosion_tpu.campaign.report import _strip_nondeterministic

    golden = goldens.LATENCY_STORM_100K_SEEDS8
    spec = dataclasses.replace(spec_mod.latency_storm_seeds_spec(),
                               seeds=(seed,))
    art, jf, _ = _jax_campaign(spec.to_dict())
    cell = art["cells"][0]
    ps = cell["per_seed"]
    lane = {"seed": seed, "rounds": ps["rounds"][0],
            "p99_node_convergence_round":
                ps["p99_node_convergence_round"][0],
            "converged": ps["converged"][0],
            "unconverged_nodes": ps["unconverged_nodes"][0],
            "digest": jax_digest(jax.tree.map(lambda x: x[0], jf))}
    assert lane == golden["lanes"][seed]
    assert cell["round_path"] == "packed"
    assert _strip_nondeterministic(cell) == _strip_nondeterministic(
        _cell_of([lane]))
    if seed == 0:
        assert art["result_digest"] == golden["seed0_result_digest"]
