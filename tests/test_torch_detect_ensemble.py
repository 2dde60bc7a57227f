"""The port's membership-detect ensembles (``campaign.ensemble.
run_detect_ensemble`` over ``sim.telemetry.run_membership_detect_lanes``:
the dense round's lanes, then K23's lane entries) against JAX's
``run_detect_ensemble`` (``jax.vmap`` of ``run_membership_detect``, run
under ``tests.torch_parity.jax_telemetry``) on the CPU: both SWIM tiers
lane by lane and field by field, with lanes that detect at different
rounds and one that never detects; ``run_campaign`` on the builtin detect
specs (JAX's spec_hash and result_digest); each lane against the port's
solo detect run; configs #2/#2b through the engine; and the engine's
refusals of detect cells, word for word JAX's."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from corrosion_tpu.campaign import engine as jengine
from corrosion_tpu.campaign import spec as jspec_mod
from corrosion_tpu_torch.campaign import engine
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.ensemble import (
    lane_state,
    run_detect_ensemble,
)
from corrosion_tpu_torch.sim.runner import churn_setup
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.telemetry import run_membership_detect
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import assert_lanes_equal_jax, jax_telemetry

SPECS = {
    # 64-node full view: lanes detect at different rounds
    "swim-churn-64": (jspec_mod.swim_churn_64_spec,
                      spec_mod.swim_churn_64_spec, {}),
    # the partial-view tier at 512 nodes, 600 rounds
    "swim-churn-partial-512": (jspec_mod.swim_churn_partial_spec,
                               spec_mod.swim_churn_partial_spec,
                               {"n": 512}),
}


def _pair(name, seeds=(0, 1, 2)):
    jbuild, pbuild, kw = SPECS[name]
    return jbuild(seeds=seeds, **kw), pbuild(seeds=seeds, **kw)


@functools.lru_cache(maxsize=None)
def _campaigns(name):
    """Both engines' ``run_campaign`` on the spec, once a worker: (JAX
    artifact, JAX lanes (finals, metrics, detect rounds), port artifact,
    port lanes)."""
    from corrosion_tpu.campaign import ensemble as jens

    jspec, pspec = _pair(name)
    kept = {}
    orig = jens.run_detect_ensemble

    def keep(*args, **kwargs):
        kept["out"] = tuple(orig(*args, **kwargs))
        return kept["out"]

    with jax_telemetry():
        jens.run_detect_ensemble = keep
        try:
            want = jengine.run_campaign(jspec, out_path=None)
        finally:
            jens.run_detect_ensemble = orig
    lanes = {}
    got = engine.run_campaign(pspec, device="cpu", lanes_out=lanes)
    return want, kept["out"], got, lanes[0]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_detect_ensemble_equals_jax(name):
    """Every final state field, both stamps and the detect rounds of
    three lanes equal JAX's vmapped detect ensemble, in JAX's dtypes,
    with lanes that stop at different rounds."""
    _, (jf, jm, jd), _, lanes = _campaigns(name)
    pf, pm, pd = lanes["finals"], lanes["metrics"], lanes["detect_rounds"]
    np.testing.assert_array_equal(np.asarray(jd), pd.numpy())
    assert np.asarray(jd).dtype == pd.numpy().dtype
    rounds = pf.t.tolist()
    assert len(set(rounds)) > 1, rounds
    assert_lanes_equal_jax(jf, jm, pf, pm, name)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_detect_campaign_equals_jax(name):
    """``run_campaign`` on the detect spec: JAX's spec_hash,
    result_digest and per-seed record (detect_round None for a lane that
    never detected, detected_fraction, false_positive_downs on full
    view), its bands, and ``round_path`` dense."""
    want, _, got, _ = _campaigns(name)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    cell, jcell = got["cells"][0], want["cells"][0]
    assert cell["per_seed"] == jcell["per_seed"]
    assert cell["bands"] == jcell["bands"]
    assert cell["round_path"] == jcell["round_path"] == "dense"


def test_detect_lanes_equal_the_solo_runs():
    """Each lane of the 64-node detect ensemble is the port's solo
    `run_membership_detect` of its seed: every field and the detect
    round; a detected lane stops in the round it detected."""
    _, pspec = _pair("swim-churn-64", seeds=(3, 4, 5))
    cfg = pspec.sim_config({})
    finals, _, detect = run_detect_ensemble(
        cfg, Topology(), uniform_payloads(cfg, "cpu", inject_every=1),
        pspec.seeds, kill_every=3, max_rounds=400, device="cpu")
    for k, s in enumerate(pspec.seeds):
        meta, state = churn_setup(cfg, s, torch.device("cpu"))
        solo, _, det = run_membership_detect(state, meta, cfg, Topology(),
                                             400, device="cpu")
        assert int(det) == int(detect[k]) == int(finals.t[k])
        for fname, a, b in zip(solo._fields, solo, lane_state(finals, k)):
            assert torch.equal(a, b), (k, fname)


def test_detect_ensemble_runs_to_max_rounds_undetected():
    """A cap below every detect round: every lane runs to it and keeps
    detect_round -1."""
    _, pspec = _pair("swim-churn-64")
    cfg = pspec.sim_config({})
    finals, _, detect = run_detect_ensemble(
        cfg, Topology(), uniform_payloads(cfg, "cpu", inject_every=1),
        (0, 1), kill_every=3, max_rounds=5, device="cpu")
    assert finals.t.tolist() == [5, 5] and detect.tolist() == [-1, -1]


def _detect_spec(**extra):
    spec = spec_mod.swim_churn_64_spec(seeds=(0,))
    return dataclasses.replace(spec, scenario=dict(spec.scenario, **extra))


@pytest.mark.parametrize("key, value", (
    ("measure_wire", True), ("churn", "flash-crowd"),
    ("proto_family", "push-pull"), ("sync_cadence", "eager")))
def test_detect_cell_value_errors_are_jax_word_for_word(key, value):
    """A detect cell that names what it cannot measure raises JAX's
    ValueError, word for word, before anything runs."""
    spec = _detect_spec(**{key: value})
    jspec = jspec_mod.CampaignSpec.from_dict(spec.to_dict())
    with pytest.raises(ValueError) as want:
        jengine.run_campaign(jspec, out_path=None)
    with pytest.raises(ValueError) as got:
        engine.run_campaign(spec, device="cpu")
    assert str(got.value) == str(want.value)


def test_measure_wire_stride_value_error_is_jax():
    """A wire measurement at trace_every > 1 raises JAX's ValueError."""
    spec = spec_mod.CampaignSpec(
        name="w", scenario={"n_nodes": 64, "n_payloads": 8,
                            "measure_wire": True, "trace_every": 2})
    jspec = jspec_mod.CampaignSpec.from_dict(spec.to_dict())
    with pytest.raises(ValueError) as want:
        jengine.run_campaign(jspec, out_path=None)
    with pytest.raises(ValueError) as got:
        engine.run_campaign(spec, device="cpu")
    assert str(got.value) == str(want.value)


def test_detect_cell_with_the_recorder_is_refused_by_name():
    """The recorder on lanes is not ported: a detect cell asked for
    telemetry raises NotImplementedError naming ROADMAP B16d, and so does
    `run_detect_ensemble` with ``telemetry``."""
    spec = _detect_spec()
    with pytest.raises(NotImplementedError, match="recorder's lanes.*B16d"):
        engine.run_campaign(spec, telemetry=True, device="cpu")
    cfg = spec.sim_config({})
    with pytest.raises(NotImplementedError, match="B16d"):
        run_detect_ensemble(cfg, Topology(), None, (0,), telemetry=True,
                            device="cpu")


def test_detect_needs_a_swim_tier_on_lanes():
    """Without either SWIM tier the lane loop raises JAX's ValueError."""
    from corrosion_tpu_torch.campaign.ensemble import seed_states
    from corrosion_tpu_torch.sim.state import SimConfig
    from corrosion_tpu_torch.sim.telemetry import (
        run_membership_detect_lanes)

    cfg = SimConfig(n_nodes=16, n_payloads=1)
    with pytest.raises(ValueError, match="needs a SWIM tier"):
        run_membership_detect_lanes(seed_states(cfg, (0,), "cpu"), None, cfg,
                                    Topology(), 5, device="cpu")
