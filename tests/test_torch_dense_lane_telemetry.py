"""The flight recorder on the dense round's lanes (B16r, dense half:
``sim/dense_lanes.py`` and ``sim/telemetry.py`` with a lane trace,
through ``campaign/ensemble.py`` and ``campaign/engine.py``'s
``telemetry``, ``measure_wire`` and ``trace_dir``) against JAX's
``campaign`` package (``jax.vmap`` of the recording runs) and against
the port's own solo recording runs, on the CPU: every new lane entry's
plain version against the solo entry on each lane's inputs (chip
smoke's phase 3lr at shrunken shapes, every trap reached), recording
campaigns — a fault cell, a detect cell, a ``measure_wire`` cell and a
``trace_every`` 2 cell — whose artifact, per-lane summaries and
flight-recorder JSONL equal live JAX's, each lane's trace equal to its
solo run, and the refusals that stand.  ``-m slow`` re-derives the
goldens of paths 46-49 from live JAX."""

import dataclasses
import json
import os
from unittest import mock

import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
from corrosion_tpu_torch.sim.lanes import check_dense_lanes
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.runner import churn_setup
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.telemetry import lane_trace, run_membership_detect
from tests.torch_parity import jax_telemetry


def test_recorder_lane_entries_equal_the_solo_entries():
    """Every lane entry the recorder adds to the dense lanes — K17's dense
    lane entry, K18's rows lane entry, K19's lane entry, the recording
    forms of K12, K12f, K13 and K13d, and K9's, K9's latency entry's and
    K9m's lane-strided counts — equals its plain version through its
    wrapper and, on the last lane, the solo entry: chip smoke's phase
    3lr at 3 lanes with its 100k, 4096 and 1000 shapes shrunk to 1200,
    96 and 333 nodes, every trap reached (lanes counting different
    totals into their own slots, bytes past 2^31, a decimated scratch
    row, a shared fault slice, blocks spanning two lanes and one block
    holding every lane of the 3-node plan)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_dense_lane_trace_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert [r["name"] for r in rows] == [
        "trace_counts_dense_lanes", "trace_wire_rows_lanes",
        "trace_row_lanes", "dense_broadcast_lanes_trace",
        "dense_broadcast_fault_lanes_trace", "dense_sync_lanes_trace",
        "dense_sync_delay_lanes_trace", "fault_edges_lanes_count",
        "fault_edges_delay_lanes_count", "fault_edges_matrix_lanes_count"]
    assert all(r["equal"] for r in rows)


def _cell(case):
    """A recording cell at test scale, one spec dict for both packages."""
    if case == "parity":
        return spec_mod.fault_parity_3node_spec()
    if case == "churn64":
        return spec_mod.swim_churn_64_spec(seeds=(0, 1, 2))
    if case == "wire":
        return spec_mod.broadcast_wire_seeds_spec((0, 1))
    spec = spec_mod.fault_parity_3node_spec((0, 1))
    return dataclasses.replace(spec, scenario=dict(spec.scenario,
                                                   trace_every=2))


def _flight_files(directory):
    """Each flight-recorder JSONL under ``directory``, parsed, with the
    header's traceparent left out (the host tracing tier's)."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            lines = [json.loads(line) for line in f]
        lines[0].pop("traceparent")
        out[name] = lines
    return out


def _port_solo_trace(spec, seed):
    """The port's solo recording run of one seed on the CPU: the detect
    loop, the fault loop under the spec's plan re-seeded, or the dense
    convergence loop; (rounds, trace)."""
    cfg, topo = spec.sim_config({}), spec.topo({})
    if spec.detect_membership({}):
        meta, state = churn_setup(cfg, seed, "cpu")
        final, _, _, trace = run_membership_detect(
            state, meta, cfg, topo, spec.max_rounds, telemetry=True,
            device="cpu")
        return int(final.t), trace
    meta = uniform_payloads(cfg, "cpu", inject_every=spec.inject_every({}))
    state = new_sim(cfg, seed, "cpu")
    plan = spec.fault_plan({}, seed=seed)
    if plan is None:
        final, _, trace = run_to_convergence(state, meta, cfg, topo,
                                             spec.max_rounds, telemetry=True)
    else:
        final, _, trace = run_fault_plan(
            state, meta, cfg, topo, compile_plan(plan, cfg, topo,
                                                 device="cpu"),
            spec.max_rounds, telemetry=True)
    return int(final.t), trace


@pytest.mark.parametrize("case", ("parity", "churn64", "wire", "every2"))
def test_recording_campaign_equals_live_jax(case, tmp_path):
    """A recording campaign through the port's ``run_campaign(...,
    telemetry=True, trace_dir=..., device="cpu")`` gives live JAX's
    artifact — spec_hash, result_digest, per-seed records (the wire
    cell's ``wire_bytes`` exactly: every payload is 8 KiB), the
    ``telemetry`` block's per-lane summaries — and JAX's flight-recorder
    files, line for line, under JAX's names (the header's traceparent
    aside): fault-parity-3node (8 lanes, matrix plan with a one-way cut,
    delay, jitter and a wipe), swim-churn-64 (a detect cell, 3 lanes),
    broadcast-1k with ``measure_wire`` (2 lanes) and the parity cell at
    ``trace_every`` 2 (2 lanes).  Each lane's trace equals the port's
    solo recording run of its seed (the wire cell's lanes are JAX's, and
    lane 0 the broadcast golden's)."""
    spec = _cell(case)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    with jax_telemetry():
        from corrosion_tpu.campaign.engine import run_campaign as jrun

        want = jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                    telemetry=True, trace_dir=str(jdir))
    kept = {}
    got = run_campaign(spec, telemetry=True, trace_dir=str(pdir),
                       device="cpu", lanes_out=kept)
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "telemetry"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "dense"
    assert _flight_files(pdir) == _flight_files(jdir)
    assert len(os.listdir(pdir)) == len(spec.seeds)
    traces = kept[0]["traces"]
    if case == "parity":
        assert got["result_digest"] == goldens.FAULT_PARITY_3NODE_SEEDS8[
            "result_digest"]
        assert cell["telemetry"]["per_seed"] == \
            goldens.FAULT_PARITY_3NODE_SEEDS8_TELEMETRY["summaries"]
    if case == "wire":
        tel = goldens.BROADCAST_1K_SEED0_TELEMETRY
        assert cell["per_seed"]["wire_bytes"] == \
            goldens.BROADCAST_1K_SEEDS8_WIRE["wire_bytes"][:2]
        assert cell["telemetry"]["per_seed"][0] == dict(
            tel["summary"], wire_bytes=tel["wire_bytes"])
        return
    rounds = cell["per_seed"]["rounds"]
    assert len(set(rounds)) > 1  # lanes leave the batch in different rounds
    for k, seed in enumerate(spec.seeds):
        r, solo = _port_solo_trace(spec, seed)
        assert r == rounds[k]
        for name, a, b in zip(solo._fields, lane_trace(traces, k), solo):
            assert torch.equal(a, b), (case, seed, name)


def test_detect_ensemble_returns_traces_last():
    """``run_detect_ensemble(telemetry=True)`` returns the lanes' stacked
    traces fourth (JAX ``ensemble.py:187``), ``run_seed_ensemble`` third
    on the dense round; without the recorder they return what they did."""
    from corrosion_tpu_torch.campaign.ensemble import run_detect_ensemble

    spec = spec_mod.swim_churn_64_spec(seeds=(0, 1))
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=1)
    out = run_detect_ensemble(cfg, topo, meta, (0, 1), kill_every=3,
                              max_rounds=40, telemetry=True, device="cpu")
    assert len(out) == 4 and out[3].up_nodes.shape == (2, 40)
    assert len(run_detect_ensemble(cfg, topo, meta, (0, 1), kill_every=3,
                                   max_rounds=4, device="cpu")) == 3
    spec = spec_mod.fault_parity_3node_spec((0, 1))
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=spec.inject_every({}))
    out = run_seed_ensemble(spec.fault_plan({}, seed=0), cfg, topo, meta,
                            (0, 1), max_rounds=30, telemetry=True,
                            device="cpu")
    assert len(out) == 3 and out[2].acc.shape == (2, 12)


def test_packed_lanes_refuse_the_recorder_naming_b16m():
    """The recorder runs on the packed round's lanes since B16r's packed
    half (three rounds of a packed cell return the lanes' traces last),
    on a metered cell since B16m's budgets, and on a protocol variant,
    which it refused naming B16m, since B16m's rest: a push-pull packed
    cell with ``telemetry`` returns the lane's trace through the ensemble
    and gives live JAX's artifact and telemetry block through the engine,
    and with ``measure_wire`` JAX's wire bytes; the dense lanes accept the
    recorder."""
    from corrosion_tpu.campaign.engine import run_campaign as jrun

    from corrosion_tpu_torch.campaign import engine

    spec = spec_mod.storm_seeds_spec((0,), n_nodes=512)
    scenario = dict(spec.scenario, n_payloads=64, packed_min_cells=0)
    plain = dataclasses.replace(spec, scenario=scenario)
    cfg, topo = plain.sim_config({}), plain.topo({})
    out = run_seed_ensemble(None, cfg, topo,
                            uniform_payloads(cfg, "cpu", inject_every=2),
                            (0, 1), max_rounds=3, telemetry=True,
                            device="cpu")
    assert len(out) == 3 and out[2].acc.shape == (2, 12)
    metered = dataclasses.replace(cfg, rate_limit_bytes_round=64 * 1024)
    out = run_seed_ensemble(None, metered, topo,
                            uniform_payloads(metered, "cpu",
                                             inject_every=2),
                            (0, 1), max_rounds=3, telemetry=True,
                            device="cpu")
    assert len(out) == 3 and out[2].acc.shape == (2, 12)
    spec = dataclasses.replace(spec, scenario=dict(
        scenario, proto_family="push-pull"))
    cfg = spec.sim_config({})
    out = run_seed_ensemble(None, cfg, topo,
                            uniform_payloads(cfg, "cpu", inject_every=2),
                            (0,), max_rounds=3, telemetry=True,
                            device="cpu")
    assert int(out[0].t[0]) == 3 and out[2].acc.shape == (1, 12)
    wire = dataclasses.replace(spec, scenario=dict(spec.scenario,
                                                   measure_wire=1))
    for case, telemetry in ((spec, True), (wire, False)):
        with jax_telemetry():
            want = jrun(JaxSpec.from_dict(case.to_dict()), out_path=None,
                        telemetry=telemetry)
        got = engine.run_campaign(case, telemetry=telemetry, device="cpu")
        assert got["result_digest"] == want["result_digest"]
        cell, jcell = got["cells"][0], want["cells"][0]
        assert cell["round_path"] == "packed"
        assert cell["per_seed"] == jcell["per_seed"]
        assert cell.get("telemetry") == jcell.get("telemetry")
    dense = spec_mod.fault_parity_3node_spec((0,))
    check_dense_lanes(dense.sim_config({}), dense.topo({}), telemetry=True)


@pytest.mark.parametrize("extra", ({"measure_wire": 1,
                                    "detect_membership": 1},
                                   {"measure_wire": 1, "trace_every": 2}))
def test_measure_wire_value_errors_are_jax_word_for_word(extra):
    """JAX's two ValueErrors of a ``measure_wire`` cell — on a detect
    cell, and at ``trace_every`` > 1 — stay word for word, before
    anything runs."""
    spec = (spec_mod.swim_churn_64_spec() if "detect_membership" in extra
            else spec_mod.broadcast_seeds_spec((0,)))
    spec = dataclasses.replace(spec, scenario=dict(spec.scenario, **extra))
    with jax_telemetry():
        from corrosion_tpu.campaign.engine import run_campaign as jrun

        with pytest.raises(ValueError) as want:
            jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None)
    with pytest.raises(ValueError) as got:
        run_campaign(spec, device="cpu")
    assert str(got.value) == str(want.value)


def test_resume_reuses_a_cell_only_with_its_recording(tmp_path):
    """JAX's resume rule: a cached cell serves a recording run only when
    it carries the telemetry block and, under ``trace_dir``, every
    lane's JSONL on disk; otherwise it runs again."""
    spec = spec_mod.fault_parity_3node_spec((0, 1))
    out = str(tmp_path / "art.json")
    plain = run_campaign(spec, out_path=out, device="cpu")
    assert "telemetry" not in plain["cells"][0]
    tdir = str(tmp_path / "flight")
    rec = run_campaign(spec, out_path=out, telemetry=True, trace_dir=tdir,
                       device="cpu")
    assert "telemetry" in rec["cells"][0]
    assert rec["result_digest"] == plain["result_digest"]
    os.remove(os.path.join(tdir, sorted(os.listdir(tdir))[0]))
    with mock.patch("corrosion_tpu_torch.campaign.engine._run_cell",
                    side_effect=AssertionError("re-ran")) as never:
        with pytest.raises(AssertionError, match="re-ran"):
            run_campaign(spec, out_path=out, telemetry=True, trace_dir=tdir,
                         device="cpu")
        assert never.called
        again = run_campaign(spec, out_path=out, telemetry=True,
                             device="cpu")
    assert again["cells"] == rec["cells"]


# -- the card's goldens, from live JAX ---------------------------------------


def _jax_recording(spec, telemetry=True):
    with jax_telemetry():
        from corrosion_tpu.campaign.engine import run_campaign as jrun

        return jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                    telemetry=telemetry)


@pytest.mark.slow
def test_broadcast_seeds8_wire_golden_matches_live_jax():
    """``BROADCAST_1K_SEEDS8_WIRE`` (path 47) from live JAX's engine
    (about 20 s on the CPU), and ``BROADCAST_1K_SEEDS8_TELEMETRY`` (path
    46's per-lane summaries, lane 0 the solo golden's)."""
    art = _jax_recording(spec_mod.broadcast_wire_seeds_spec(), False)
    assert {"spec_hash": art["spec_hash"],
            "result_digest": art["result_digest"],
            "wire_bytes": art["cells"][0]["per_seed"]["wire_bytes"]} == \
        goldens.BROADCAST_1K_SEEDS8_WIRE
    art = _jax_recording(spec_mod.broadcast_seeds_spec())
    assert art["result_digest"] == goldens.BROADCAST_1K_SEEDS8[
        "result_digest"]
    assert art["cells"][0]["telemetry"]["per_seed"] == \
        goldens.BROADCAST_1K_SEEDS8_TELEMETRY["summaries"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(1, 8))
def test_dense_fault_storm_100k_lane_telemetry_matches_live_jax(seed):
    """``DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY`` (path 49's lanes 1-7)
    from live JAX's engine one seed at a time: the one-seed recording
    run_campaign of ``seed`` (100 000 × 512 on the dense round, about a
    minute on the CPU) gives the golden lane's summary, and its
    result_digest is the plain one-seed run's (the block is out of the
    digest)."""
    spec = dataclasses.replace(spec_mod.dense_storm_seeds_spec(),
                               seeds=(seed,))
    art = _jax_recording(spec)
    assert art["cells"][0]["telemetry"]["per_seed"] == [
        goldens.DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY["summaries"][
            seed - 1]]
    assert art["cells"][0]["per_seed"]["rounds"] == [
        goldens.DENSE_FAULT_STORM_100K_SEEDS8["lanes"][seed]["rounds"]]


def test_partial_4096_lane_trace_digests_are_the_goldens():
    """Path 50's pinned lane trace digests belong to its cell: the rounds
    are ``SWIM_CHURN_PARTIAL_4096_SEEDS8``'s lanes' and lane 0's digest is
    JAX's solo telemetry golden's."""
    pinned = goldens.SWIM_CHURN_PARTIAL_4096_SEEDS8_TRACES
    assert pinned["rounds"] == [
        lane["rounds"] for lane in goldens.SWIM_CHURN_PARTIAL_4096_SEEDS8[
            "lanes"]]
    assert pinned["trace_digests"][0] == \
        goldens.SWIM_CHURN_PARTIAL_4096_SEED0_TELEMETRY["trace_digest"]
    assert len(set(pinned["trace_digests"])) == 8
