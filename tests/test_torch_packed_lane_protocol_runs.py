"""The protocol variants on the packed round's lanes (B16m's rest) in the
round's company, against JAX's ``campaign`` package on the CPU at 1280
nodes, two seeds: push-pull with the recorder over flat-lossy and wan-3x2
(K10p's flat and tiered lane forms, K18's words-pull lane entry); the
dense == packed contract the 100k push-pull pins rest on; push-pull under
a factored plan with delay and jitter, with and without the recorder;
and under ``-m slow`` every protocol knob at once over a topology family
under PeerSwap, both byte budgets and a plan, with the recorder.  The
lane entries, the families and the goldens are
``tests/test_torch_packed_lane_protocol.py``."""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest

from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import (
    lane_state,
    run_seed_ensemble,
)
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.telemetry import CHANNELS
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_campaign_kept,
    jax_digest,
    jax_telemetry,
    latency_storm_spec_at,
    proto_storm_spec_at,
)


#: the rounds a run under the latency storm's plan is held to: past the
#: plan's last event (the crash ends at round 20) and short of convergence
PLAN_ROUNDS = 32


#: JAX's recording runs by (spec hash, rounds): the plan's cases with and
#: without the recorder hold the port to one JAX run, whose states are
#: those of JAX's run without the recorder
_JAX_RUNS = {}


def _jax_lanes(spec, telemetry, max_rounds):
    """JAX's run_seed_ensemble of ``spec``'s one cell (its plan re-seeded
    per lane), with or without the recorder."""
    from corrosion_tpu.campaign.ensemble import run_seed_ensemble as jrun
    from corrosion_tpu.sim.state import uniform_payloads as jpayloads

    key = (spec.spec_hash(), telemetry, max_rounds)
    if key not in _JAX_RUNS:
        jspec = JaxSpec.from_dict(spec.to_dict())
        jcfg = jspec.sim_config({})
        with jax_telemetry() if telemetry else contextlib.nullcontext():
            _JAX_RUNS[key] = jrun(
                jspec.fault_plan({}, seed=jspec.seeds[0]), jcfg,
                jspec.topo({}),
                jpayloads(jcfg, inject_every=jspec.inject_every({})),
                jspec.seeds, max_rounds=max_rounds, telemetry=telemetry)
    return _JAX_RUNS[key]


def _port_lanes(spec, telemetry, max_rounds):
    """The port's run_seed_ensemble of the same cell on the CPU."""
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=spec.inject_every({}))
    return run_seed_ensemble(
        spec.fault_plan({}, seed=spec.seeds[0]), cfg, topo, meta,
        spec.seeds, max_rounds=max_rounds, telemetry=telemetry, device="cpu")


def _ensemble_pair(spec, telemetry, max_rounds=60):
    """JAX's and the port's run_seed_ensemble of ``spec``'s one cell, with
    or without the recorder: (JAX's outputs, the port's)."""
    return (_jax_lanes(spec, telemetry, max_rounds),
            _port_lanes(spec, telemetry, max_rounds))


def _assert_pair(jout, pout, label, telemetry):
    """Every lane's state, stamps and order count, and with the recorder
    every channel of every lane's trace over all rows, exactly: every
    payload is 8 KiB and a round's bytes stay below 2^37, so JAX's f32
    partial sums are exact and the byte channels are held exactly too."""
    assert_lanes_equal_jax(jout[0], jout[1], pout[0], pout[1], label)
    np.testing.assert_array_equal(np.asarray(jout[1].order_violations),
                                  pout[1].order_violations.numpy())
    if telemetry:
        for name in CHANNELS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jout[2], name)),
                getattr(pout[2], name).numpy(), err_msg=f"{label}: {name}")


@pytest.mark.parametrize("topo_family", ("flat-lossy", "wan-3x2"))
def test_push_pull_recorder_on_the_packed_lanes_equals_live_jax(topo_family):
    """Push-pull over the flat lossy topology (K10p's flat stream on the
    lanes) and over wan-3x2 (its tiered lane instantiation) with the
    recorder, two seeds at 1280 nodes: every lane and every channel of its
    trace JAX's vmapped recording run's, the pull's frames and bytes (K18's
    words-pull lane entry) and its dropped frames (K10p's recording forms)
    in them."""
    extra = ({"topo_family": topo_family, "n_delay_slots": 3}
             if topo_family == "wan-3x2" else {"topo_family": topo_family})
    spec = proto_storm_spec_at("push-pull", **extra)
    jout, pout = _ensemble_pair(spec, True)
    _assert_pair(jout, pout, topo_family, True)
    assert int(pout[2].bcast_dropped.sum()) > 0


def test_dense_and_packed_push_pull_lanes_agree_in_jax_and_the_port():
    """The dense == packed contract the packed push-pull cell's pins rest
    on, at 1280 nodes: JAX's vmapped dense lanes of the push-pull storm
    (``allow_packed`` False) and the port's packed lanes of the same cell
    (``packed_min_cells`` 0) end in the same states, digest for digest,
    two seeds, with the same per-seed records."""
    base = dict(spec_mod.storm_scenario(1280), n_payloads=64,
                proto_family="push-pull")
    dense = spec_mod.CampaignSpec(
        name="pp", scenario=dict(base, allow_packed=False), seeds=(0, 1),
        max_rounds=400)
    packed = dataclasses.replace(dense, scenario=dict(base,
                                                      packed_min_cells=0))
    jart, jout = jax_campaign_kept(dense)
    assert jart["cells"][0]["round_path"] == "dense"
    kept = {}
    art = run_campaign(packed, device="cpu", lanes_out=kept)
    assert art["cells"][0]["round_path"] == "packed"
    for k in range(2):
        jlane = jax.tree.map(lambda x, k=k: x[k], jout[0])
        assert state_digest(lane_state(kept[0]["finals"], k)) == \
            jax_digest(jlane)
    assert art["cells"][0]["per_seed"] == jart["cells"][0]["per_seed"]


@pytest.mark.parametrize("telemetry", (False, True))
def test_push_pull_under_a_factored_plan_equals_live_jax(telemetry):
    """Push-pull under the latency storm's factored plan (a loss window,
    a half split, a crash with wipe, one round of delay and of jitter) at
    1280 nodes, two seeds, with and without the recorder, held at
    ``PLAN_ROUNDS``: every lane (and trace) JAX's vmapped recording lanes'
    — the pull's fault stream under each lane's plan seed, the refusals
    across the split."""
    spec = latency_storm_spec_at((0, 1), proto_family="push-pull")
    jout = _jax_lanes(spec, True, PLAN_ROUNDS)
    pout = _port_lanes(spec, telemetry, PLAN_ROUNDS)
    _assert_pair(jout, pout, "push-pull plan", telemetry)
    if telemetry:
        assert int(pout[2].sync_refused.sum()) > 0
        assert int(pout[2].bcast_dropped.sum()) > 0


@pytest.mark.slow
def test_every_knob_at_once_on_the_packed_lanes_equals_live_jax():
    """Push-pull, the fan-out decay, the eager cadence and FIFO ordering at
    once, over wan-3x2 under PeerSwap (ground truth), with both byte
    budgets binding and the latency storm's factored plan, with the
    recorder: two seeds at 1280 nodes held at ``PLAN_ROUNDS``, every lane,
    order count and trace channel JAX's."""
    spec = latency_storm_spec_at(
        (0, 1), n_payloads=128, dissemination="push-pull",
        fanout_schedule="decay", fanout_decay_rounds=4,
        sync_cadence="eager", ordering="fifo", topo_family="wan-3x2",
        n_delay_slots=6, peer_sampler="peerswap", swim_partial_view=False,
        rate_limit_bytes_round=40 * 8192, sync_budget_bytes=20 * 8192)
    jout, pout = _ensemble_pair(spec, True, PLAN_ROUNDS)
    _assert_pair(jout, pout, "every knob", True)
