"""The port's seed ensembles on the packed round (``campaign/ensemble.py``
over ``sim/lanes.py``) against JAX's ``campaign.ensemble`` and against
the port's own solo runs, on the CPU: the lane RNG against ``jax.vmap``
of ``jax.random``, every lane entry's plain version against the solo
entry on each lane's inputs, and whole 3-lane ensembles (faultless at
512 nodes, under a factored plan at 1280 and 1024) lane by lane, field
by field, with lanes that finish at different rounds."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu_torch.campaign.ensemble import (
    lane_plan_seeds,
    lane_state,
    seed_states,
)
from corrosion_tpu_torch.convert import state_to_numpy
from corrosion_tpu_torch.sim import rng
from corrosion_tpu_torch.sim.lanes import run_lanes
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import (
    LANE_FIELDS,
    port_solo_runs,
    run_both_ensembles,
    storm_campaign_pair,
)

KEYS = ((0, 7), (0, 123456), (0, 2 ** 31 - 1), (5, 9))


def _jax_keys():
    return jnp.asarray(np.array(KEYS, dtype=np.uint32))


def _port_keys():
    return torch.tensor(KEYS, dtype=torch.int64)


@pytest.mark.parametrize("draw", ("split", "fold_in", "bits", "randint",
                                  "randint_per_element"))
def test_lane_draws_equal_vmapped_jax(draw):
    """K5's lane entries' plain versions equal jax.vmap of jax.random
    over the same [K, 2] keys, and each lane the solo draw under its
    key."""
    jk, pk = _jax_keys(), _port_keys()
    maxval = torch.tensor(np.arange(1, 4 * 300 + 1).reshape(4, 300) % 70,
                          dtype=torch.int32)
    if draw == "split":
        want = jax.vmap(lambda k: jax.random.split(k, 11))(jk)
        got = rng.split_lanes(pk, 11)
        solo = [rng.split(pk[i], 11) for i in range(4)]
    elif draw == "fold_in":
        want = jax.vmap(lambda k: jax.random.fold_in(k, 101))(jk)
        got = rng.fold_in_lanes(pk, 101)
        solo = [rng.fold_in(pk[i], 101) for i in range(4)]
    elif draw == "bits":
        want = jax.vmap(lambda k: jax.random.bits(k, (3, 129)))(jk)
        got = rng.bits_lanes(pk, (3, 129))
        solo = [rng.bits(pk[i], (3, 129)) for i in range(4)]
    elif draw == "randint":
        want = jax.vmap(lambda k: jax.random.randint(k, (12, 100), 0,
                                                     100000))(jk)
        got = rng.randint_lanes(pk, (12, 100), 0, 100000)
        solo = [rng.randint(pk[i], (12, 100), 0, 100000) for i in range(4)]
    else:
        want = jax.vmap(lambda k, m: jax.random.randint(k, (300,), 1,
                                                        m + 1))(
            jk, jnp.asarray(maxval.numpy()))
        got = rng.randint_lanes(pk, (300,), 1, maxval + 1)
        solo = [rng.randint(pk[i], (300,), 1, maxval[i] + 1)
                for i in range(4)]
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy().astype(np.int64))
    for i in range(4):
        assert torch.equal(got[i], solo[i]), f"lane {i} != its solo draw"
    # per-lane seeds folded in one call: each lane its own value
    seeds = lane_plan_seeds(range(4), "cpu")
    both = rng.fold_in_lanes_plain(pk, seeds)
    for i in range(4):
        assert torch.equal(both[i], rng.fold_in(pk[i], int(seeds[i])))


def test_lane_entries_equal_the_solo_entries():
    """Every lane entry's plain version (the CPU's) equals itself through
    its wrapper and, on the last lane's inputs, the solo entry: chip
    smoke's phase 3k at 3 lanes of 1200 nodes, every trap reached."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12):
        rows = chip_smoke.compare_lane_kernels(torch.device("cpu"), lanes=3,
                                               n=1200, timed=False)
    assert {r["name"] for r in rows} == {
        "threefry_lanes", "sample_targets_lanes", "merge_entries_lanes",
        "broadcast_scatter_lanes", "broadcast_scatter_lossy_lanes",
        "edge_list_lanes", "edge_list_sync_lanes",
        "sync_masks_lanes", "sync_pull_lanes", "gaps_refresh_lanes",
        "converge_fold_lanes", "word_phases_lanes", "fault_reach_lanes",
        "node_faults_lanes"}
    assert all(r["equal"] for r in rows)


def _assert_lanes(jf, jm, pf, pm, fields, label):
    pn = state_to_numpy(pf)
    for name in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jf, name)), pn[name],
            err_msg=f"{label}: field {name}")
    for name in ("converged_at", "coverage_at"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jm, name)), getattr(pm, name).numpy(),
            err_msg=f"{label}: metrics {name}")


def _assert_solo(pf, pm, solos, label):
    """Each lane equals the port's solo run of its seed, every field."""
    for k, (solo, sm) in enumerate(solos):
        lane = lane_state(pf, k)
        for name, a, b in zip(solo._fields, solo, lane):
            assert torch.equal(a.cpu(), b.cpu()), f"{label}: lane {k} {name}"
        for name in ("converged_at", "coverage_at", "overflow_frac"):
            assert torch.equal(getattr(sm, name), getattr(pm, name)[k]), (
                f"{label}: lane {k} metrics {name}")


@pytest.mark.parametrize("n, payloads, seeds, faults", (
    (512, 256, (0, 5, 7), False),
    (1280, 64, (0, 3, 5), True),
), ids=("faultless-512", "factored-1280"))
def test_ensemble_equals_jax_and_solo_runs(n, payloads, seeds, faults):
    """Three lanes finishing at different rounds: every state field and
    the stamps equal JAX's vmapped ensemble lane by lane (and JAX's
    LANE_FIELDS in particular), and each lane the port's solo run."""
    jspec, pspec = storm_campaign_pair(n, payloads, seeds, faults)
    jf, jm, pf, pm, cfg, meta, plan = run_both_ensembles(jspec, pspec)
    rounds = pf.t.tolist()
    assert len(set(rounds)) > 1, f"lanes all finish at round {rounds[0]}"
    _assert_lanes(jf, jm, pf, pm, type(jf)._fields, f"{n} nodes")
    assert set(LANE_FIELDS) <= set(type(jf)._fields)
    _assert_solo(pf, pm, port_solo_runs(cfg, meta, plan, seeds),
                 f"{n} nodes")


def test_factored_ensemble_at_1024_equals_jax_solo_runs():
    """At 1024 nodes (a power of two) JAX's own vmapped fault ensemble
    leaves its solo runs in the SWIM tables (pkey, psince, incarnation)
    from three lanes on (ROADMAP "Reference health"); the port's lanes
    are held to JAX's solo runs, every field and both stamps."""
    from corrosion_tpu.sim import faults as jf_
    from corrosion_tpu.sim.round import new_sim as jnew_sim
    from corrosion_tpu.sim.state import uniform_payloads as jpayloads
    from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
    from corrosion_tpu_torch.sim.state import uniform_payloads

    seeds = (0, 1, 2)
    jspec, pspec = storm_campaign_pair(1024, 64, seeds, True)
    cfg = pspec.sim_config({})
    pf, pm = run_seed_ensemble(
        pspec.fault_plan({}, seed=0), cfg, pspec.topo({}),
        uniform_payloads(cfg, "cpu", inject_every=2), seeds,
        max_rounds=3000, device="cpu")
    jcfg, jtopo = jspec.sim_config({}), jspec.topo({})
    jmeta = jpayloads(jcfg, inject_every=2)
    jplan = jspec.fault_plan({}, seed=0)
    pn = state_to_numpy(pf)
    for k, s in enumerate(seeds):
        fp = jf_.compile_plan(dataclasses.replace(jplan, seed=s), jcfg,
                              jtopo)
        solo, sm = jf_.run_fault_plan(jnew_sim(jcfg, s), jmeta, jcfg, jtopo,
                                      fp, 3000)
        for name in solo._fields:
            np.testing.assert_array_equal(np.asarray(getattr(solo, name)),
                                          pn[name][k],
                                          err_msg=f"lane {k}: {name}")
        for name in ("converged_at", "coverage_at"):
            np.testing.assert_array_equal(np.asarray(getattr(sm, name)),
                                          getattr(pm, name)[k].numpy())


def test_one_lane_equals_the_solo_run():
    """K = 1: the lane path gives the solo packed run, state and
    metrics."""
    from corrosion_tpu_torch.campaign.spec import storm_scenario
    from corrosion_tpu_torch.campaign.spec import CampaignSpec
    from corrosion_tpu_torch.sim.state import uniform_payloads

    spec = CampaignSpec(name="one", scenario=dict(
        storm_scenario(512), n_payloads=256, packed_min_cells=0))
    cfg = spec.sim_config({})
    meta = uniform_payloads(cfg, "cpu", inject_every=2)
    finals, metrics = run_lanes(seed_states(cfg, [5], "cpu"), meta, cfg,
                                Topology(), 3000)
    _assert_solo(finals, metrics, port_solo_runs(cfg, meta, None, [5]),
                 "one lane")
