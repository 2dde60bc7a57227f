"""The flight recorder on the packed round's lanes (B16r, packed half:
``sim/lanes.py`` with a lane trace — K17's grant and coverage lane
entries, K18's words lane entry, K19's lane entry, the recording forms of
K10's, K10j's and K3's lane entries, K9's lane-strided counts — through
``campaign/ensemble.py`` and ``campaign/engine.py``'s ``telemetry``,
``measure_wire`` and ``trace_dir``) against JAX's ``campaign`` package
(``jax.vmap`` of the recording packed runs) on the CPU, at 1280 × 64:
a recording fault-storm ensemble and a recording latency ensemble, every
lane's trace field for field, and a ``measure_wire`` latency cell with a
``trace_dir`` whose artifact and flight-recorder files equal JAX's.
``-m slow`` holds the packed recording summaries of lanes 1-7 of the
100k fault storm and lane 0's wire bytes of the 100k latency storm to
live JAX, one seed a case."""

import json
import os

import numpy as np
import pytest

from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.telemetry import CHANNELS
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_telemetry,
    latency_storm_spec_at,
    storm_campaign_pair,
)


def _spec(case, seeds=(0, 1)):
    """The recording cell of ``case`` at 1280 × 64 inside the packed
    envelope: the fault storm's events, or the latency storm's."""
    if case == "latency":
        return latency_storm_spec_at(seeds)
    return storm_campaign_pair(1280, 64, seeds, faults=True)[1]


@pytest.mark.parametrize("case", ("fault", "latency"))
def test_recording_ensemble_equals_live_jax(case):
    """``run_seed_ensemble(..., telemetry=True)`` on the packed round's
    lanes (two seeds) against JAX's vmapped recording run of the same
    dict: every lane's state and stamps, and every channel of every
    lane's trace, field for field over all ``max_rounds`` rows (rows past
    a lane's exit zero on both sides).  Every payload is 8 KiB and a
    round's bytes stay below 2^37, so JAX's f32 partial sums are exact
    and the byte channels are held exactly too."""
    spec = _spec(case)
    jspec = JaxSpec.from_dict(spec.to_dict())
    max_rounds = 60
    with jax_telemetry():
        from corrosion_tpu.campaign.ensemble import run_seed_ensemble as jrun
        from corrosion_tpu.sim.state import uniform_payloads as jpayloads

        jcfg = jspec.sim_config({})
        jf, jm, jtrace = jrun(
            jspec.fault_plan({}, seed=jspec.seeds[0]), jcfg, jspec.topo({}),
            jpayloads(jcfg, inject_every=jspec.inject_every({})),
            jspec.seeds, max_rounds=max_rounds, telemetry=True)
        jtrace = {name: np.asarray(getattr(jtrace, name))
                  for name in CHANNELS}
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=spec.inject_every({}))
    pf, pm, trace = run_seed_ensemble(
        spec.fault_plan({}, seed=spec.seeds[0]), cfg, topo, meta,
        spec.seeds, max_rounds=max_rounds, telemetry=True, device="cpu")
    assert_lanes_equal_jax(jf, jm, pf, pm, case)
    rounds = pf.t.tolist()
    assert len(set(rounds)) > 1  # the lanes leave in different rounds
    for name in CHANNELS:
        np.testing.assert_array_equal(jtrace[name],
                                      getattr(trace, name).numpy(),
                                      err_msg=f"{case}: {name}")
    assert bool((trace.acc == 0).all()) and bool((trace.counts == 0).all())
    # the recorder saw what the cell is about
    assert int(trace.bcast_dropped.sum()) > 0
    assert int(trace.bcast_cut.sum()) > 0
    assert int(trace.sync_refused.sum()) > 0


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


def test_measure_wire_cell_with_trace_dir_equals_live_jax(tmp_path):
    """The latency cell at 1280 × 64 with ``measure_wire: 1`` and a
    ``trace_dir`` (two seeds) through the port's engine on the packed
    round's lanes gives live JAX's artifact — spec_hash, result_digest
    (which carries each lane's ``wire_bytes``, exact here), per-seed
    records and the ``telemetry`` block — and JAX's flight-recorder files
    line for line, one a lane, under JAX's names."""
    spec = latency_storm_spec_at((0, 1), measure_wire=1)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    with jax_telemetry():
        from corrosion_tpu.campaign.engine import run_campaign as jrun

        want = jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                    trace_dir=str(jdir))
    got = run_campaign(spec, trace_dir=str(pdir), device="cpu")
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "telemetry"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "packed"
    assert all(w > 0 for w in cell["per_seed"]["wire_bytes"])
    assert _flight_files(pdir) == _flight_files(jdir)
    assert len(os.listdir(pdir)) == len(spec.seeds)


# -- the card's goldens, from live JAX ---------------------------------------


def _jax_recording(spec, telemetry=True):
    with jax_telemetry():
        from corrosion_tpu.campaign.engine import run_campaign as jrun

        return jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                    telemetry=telemetry)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(1, 8))
def test_fault_storm_100k_packed_lane_telemetry_matches_live_jax(seed):
    """Path 61's lanes 1-7: live JAX's one-seed recording run_campaign of
    fault-storm-100k at ``seed`` on the packed round (about a minute on
    the CPU) gives the summary pinned from the dense round
    (``DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY``, JAX's dense == packed
    contract) and the packed golden's rounds."""
    spec = spec_mod.storm_seeds_spec(seeds=(seed,), faults=True)
    art = _jax_recording(spec)
    cell = art["cells"][0]
    assert cell["round_path"] == "packed"
    assert cell["telemetry"]["per_seed"] == [
        goldens.DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY["summaries"][
            seed - 1]]
    assert cell["per_seed"]["rounds"] == [
        goldens.FAULT_STORM_100K_SEEDS8["lanes"][seed]["rounds"]]


@pytest.mark.slow
def test_latency_storm_100k_wire_lane0_matches_live_jax():
    """``LATENCY_STORM_100K_SEEDS1_WIRE`` (path 62's lane 0) from live
    JAX's engine: the one-seed measure_wire cell of the 100k latency storm
    (about ninety-five seconds on the CPU), its spec_hash, result_digest,
    rounds and f32 wire_bytes."""
    spec = spec_mod.latency_storm_seeds_spec((0,), measure_wire=True)
    art = _jax_recording(spec, telemetry=False)
    cell = art["cells"][0]
    assert {"spec_hash": art["spec_hash"],
            "result_digest": art["result_digest"],
            "rounds": cell["per_seed"]["rounds"],
            "wire_bytes": cell["per_seed"]["wire_bytes"]} == \
        goldens.LATENCY_STORM_100K_SEEDS1_WIRE
    tel = goldens.LATENCY_STORM_100K_SEED0_TELEMETRY["wire_bytes"]
    assert cell["per_seed"]["wire_bytes"] == [tel["broadcast"] + tel["sync"]]


def test_wire_golden_is_the_solo_recording_golden():
    """Path 62's lane 0 pins agree: the one-seed wire cell's rounds and
    wire_bytes are the solo latency storm's (its rounds, and its
    recording golden's broadcast plus sync bytes)."""
    wire = goldens.LATENCY_STORM_100K_SEEDS1_WIRE
    tel = goldens.LATENCY_STORM_100K_SEED0_TELEMETRY
    assert wire["rounds"] == [goldens.LATENCY_STORM_100K_SEED0["rounds"]]
    assert wire["wire_bytes"] == [tel["wire_bytes"]["broadcast"]
                                  + tel["wire_bytes"]["sync"]]
    assert spec_mod.latency_storm_seeds_spec(measure_wire=True).name == \
        "latency-storm-100k-seeds8-wire"
