"""The PeerSwap sampler on the dense round's lanes (B16s: K1's view lane
entry, K21's three lane entries, the five-way key split and the swap
tick before the phases) against JAX (``jax.vmap`` of ``topo/sampler.py
psample_view_targets`` and ``peerswap_step``, its vmapped ensembles and
its runner rung) and the port's solo runs, on the CPU: each lane
function field for field in JAX's dtypes, 2-seed PeerSwap ensembles at
96 nodes under ground truth and full view over a flat and a tiered
topology, the frontier rung's record, the refusal that stays (PeerSwap
on the packed lanes), and PeerSwap under a fault plan on lanes
(B16s-f) against JAX's vmapped fault ensembles in the plan's matrix and
factored forms.  ``-m slow`` holds the port's rung to JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import round as jround
from corrosion_tpu.topo import sampler as jsampler
from corrosion_tpu_torch.campaign.ensemble import lane_state, run_seed_ensemble
from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
from corrosion_tpu_torch.sim.lanes import check_dense_lanes, check_packed_lanes
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.topo import sampler as psampler
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_telemetry,
    lane_keys,
    lane_of,
    peerswap_fault_spec_at,
    run_both_ensembles,
    spec_pair,
    stack_lane_states,
)

BASE = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4, "fanout": 3,
        "n_delay_slots": 4, "inject_every": 2, "peer_sampler": "peerswap"}
LANES = 3


def _cfgs(family=None, **kw):
    scenario = dict(BASE, **kw)
    if family:
        scenario["topo_family"] = family
    jspec, pspec = spec_pair("ps", scenario, (0,))
    return (jspec.sim_config({}), jspec.topo({}), pspec.sim_config({}),
            pspec.topo({}))


def _view_lanes(jcfg, pcfg, t, seed=0):
    """K states whose PeerSwap views hold empty, self and repeated slots,
    a wiped row and a hub many views name, with 5 % dead nodes (and
    random beliefs in full view): JAX's stacked pytree and the port's
    stacked state."""
    rng = np.random.default_rng(seed)
    n, v = jcfg.n_nodes, jcfg.view_slots
    lanes = []
    for s in range(LANES):
        st = jround.new_sim(jcfg, s)
        ids = rng.integers(0, n, (n, v))
        ids = np.where(rng.random((n, v)) < 0.15, -1, ids)
        ids = np.where(rng.random((n, v)) < 0.03, np.arange(n)[:, None], ids)
        ids[:, 0] = np.where(rng.random(n) < 0.1, 5, ids[:, 0])
        ids[7] = -1
        rep = dict(t=jnp.int32(t), pview=ids.astype(np.int32),
                   alive=((rng.random(n) < 0.05) * 2).astype(np.uint8))
        if jcfg.swim_full_view:
            rep["view"] = rng.integers(0, 3, (n, n)).astype(np.int8)
        lanes.append(st._replace(**{k: jnp.asarray(x)
                                    for k, x in rep.items()}))
    return stack_lane_states(lanes, pcfg)


@pytest.mark.parametrize("tier", ("ground", "full_view"))
def test_view_sampler_lanes_equal_jax_vmap(tier):
    """K1's view lane entry's plain version under each lane's key: the
    targets of ``vmap(psample_view_targets)`` for counts 3 and 1, the
    believed-DOWN filter in coupled full view."""
    kw = {"swim_full_view": True} if tier == "full_view" else {}
    jcfg, _, pcfg, _ = _cfgs(**kw)
    jstates, pstates = _view_lanes(jcfg, pcfg, 5)
    jk, pk = lane_keys(LANES, 70)
    for count in (3, 1):
        want = np.asarray(jax.vmap(lambda st, k: jsampler.psample_view_targets(
            st, jcfg, k, count))(jstates, jk))
        got = psampler.psample_view_targets_lanes(pstates, pcfg, pk,
                                                  count).numpy()
        np.testing.assert_array_equal(want, got)
        assert want.dtype == got.dtype
        assert (want == -1).any()


@pytest.mark.parametrize("family", (None, "wan-3x2"))
def test_peerswap_tick_lanes_equal_jax_vmap(family):
    """The swap tick on lanes (`peerswap_step_lanes`: the four-way key
    split, K21's partner, swap and land lane entries, the message's
    reach over the topology's tiers) equals ``vmap(peerswap_step)``: each
    lane's new view, with dead nodes and partners, a wiped view, offers
    colliding on a hub, at a round whose rotating slot is 1."""
    jcfg, jt, pcfg, pt = _cfgs(family)
    jstates, pstates = _view_lanes(jcfg, pcfg, 17)
    jk, pk = lane_keys(LANES, 80)
    want = jax.vmap(lambda st, k: jsampler.peerswap_step(st, jcfg, jt, k))(
        jstates, jk)
    got = psampler.peerswap_step_lanes(pstates, pcfg, pt, pk)
    np.testing.assert_array_equal(np.asarray(want.pview), got.pview.numpy())
    assert not torch.equal(got.pview, pstates.pview)
    for k in range(LANES):
        solo = psampler.peerswap_step(lane_of(pstates, k), pcfg, pt,
                                      pk[k])
        assert torch.equal(solo.pview, got.pview[k]), k


@pytest.mark.parametrize("case", (("wan-3x2", "ground"),
                                  ("hetero-degree", "full_view"),
                                  ("flat-lossy", "full_view")))
def test_peerswap_ensemble_equals_jax(case):
    """2-seed PeerSwap ensembles at 96 nodes on the dense round (the swap
    tick first each round, the view sampler for every fan-out, sync and
    probe target): every state field (the views too) and the stamps
    equal JAX's vmapped ensemble lane by lane, lane 1 the port's solo run
    of its seed."""
    family, tier = case
    kw = {"swim_full_view": True} if tier == "full_view" else {}
    jspec, pspec = spec_pair(f"ps-{family}-{tier}", dict(
        BASE, topo_family=family, **kw), (0, 1))
    jf, jm, pf, pm, cfg, meta, _ = run_both_ensembles(jspec, pspec)
    assert_lanes_equal_jax(jf, jm, pf, pm, f"{family}/{tier}")
    solo, _ = run_to_convergence(new_sim(cfg, 1, "cpu"), meta, cfg,
                                 pspec.topo({}), pspec.max_rounds)
    for name, a, b in zip(solo._fields, solo, lane_state(pf, 1)):
        assert torch.equal(a, b), name


def test_frontier_rung_record():
    """`config_peer_sampler_frontier`'s record: JAX's keys, one entry a
    family with both samplers and their ratios, every cell converged."""
    from corrosion_tpu_torch.sim.runner import config_peer_sampler_frontier

    rec = config_peer_sampler_frontier(seed=0, n_seeds=2, device="cpu")
    assert set(rec) == {"n_nodes", "seeds", "converged", "families",
                        "spec_hash", "result_digest", "wall_clock_s"}
    assert set(rec["families"]) == {"wan-3x2", "hetero-degree"}
    for fam in rec["families"].values():
        assert set(fam) == {"uniform", "peerswap", "rounds_ratio",
                            "wire_ratio"}
        assert set(fam["uniform"]) == {"rounds_p50", "rounds_p99",
                                       "wire_bytes_p50", "converged"}
    assert rec["converged"] and rec["seeds"] == 2


@pytest.mark.slow
def test_frontier_rung_equals_jaxs():
    """The port's `config_peer_sampler_frontier` gives JAX's
    `runner.config_peer_sampler_frontier` record but for the wall (about
    forty seconds on the CPU)."""
    from corrosion_tpu.sim.runner import config_peer_sampler_frontier as jrec
    from corrosion_tpu_torch.sim.runner import config_peer_sampler_frontier

    with jax_telemetry():
        want = jrec()
    got = config_peer_sampler_frontier(device="cpu")
    want.pop("wall_clock_s")
    got.pop("wall_clock_s")
    assert got == want


def test_peerswap_under_a_fault_plan_on_lanes_names_b16s_f():
    """PeerSwap under a fault plan on lanes (B16s-f) runs: the dense check
    takes it, and a 2-seed ensemble under a crash with a wipe (K11d's
    lane entry empties node 3's view row in every lane at its restart)
    gives, lane by lane, the port's solo fault run of its seed, the view
    included."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan

    _, jt, pcfg, pt = _cfgs("wan-3x2")
    plan = FaultPlan(n_nodes=96, seed=0,
                     events=(FaultEvent("crash", 2, 6, node=3, wipe=True),))
    check_dense_lanes(pcfg, pt)
    check_dense_lanes(pcfg, pt, plan)
    meta = uniform_payloads(pcfg, "cpu")
    finals, _ = run_seed_ensemble(plan, pcfg, pt, meta, (0, 1),
                                  max_rounds=8, device="cpu")
    seeds = lane_plan_seeds((0, 1), "cpu")
    for k in range(2):
        fplan = compile_plan(dataclasses.replace(plan, seed=int(seeds[k])),
                             pcfg, pt, device="cpu")
        solo, _ = run_fault_plan(new_sim(pcfg, k, "cpu"), meta, pcfg, pt,
                                 fplan, 8)
        for name, a, b in zip(solo._fields, solo, lane_state(finals, k)):
            assert torch.equal(a, b), (k, name)


@pytest.mark.parametrize("n_nodes", (96, 1280))
def test_peerswap_fault_ensemble_equals_jax(n_nodes):
    """PeerSwap under the fault storm's plan over wan-3x2 (path 57's
    cell, `broadcast_peerswap_fault_seeds_spec`) at 96 nodes, where both
    packages compile the plan's matrix form (K9m's reach lane entry for
    the swap message), and at 1280, its factored form: 2 seeds, every
    lane field — the views too — and the stamps equal JAX's vmapped
    fault ensemble, and lane 1 the port's solo fault run of its seed."""
    from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
    from corrosion_tpu_torch.sim.faults import (
        FactoredFaultPlan, compile_plan, run_fault_plan)

    pspec = peerswap_fault_spec_at((0, 1), n_nodes)
    jspec = JaxSpec.from_dict(pspec.to_dict())
    jf, jm, pf, pm, cfg, meta, _ = run_both_ensembles(jspec, pspec)
    assert_lanes_equal_jax(jf, jm, pf, pm, f"peerswap fault {n_nodes}")
    fplan = compile_plan(pspec.fault_plan({}, seed=1), cfg, pspec.topo({}),
                         device="cpu")
    assert isinstance(fplan, FactoredFaultPlan) == (n_nodes >= 1024)
    solo, _ = run_fault_plan(new_sim(cfg, 1, "cpu"), meta, cfg,
                             pspec.topo({}), fplan, pspec.max_rounds)
    for name, a, b in zip(solo._fields, solo, lane_state(pf, 1)):
        assert torch.equal(a, b), name


def test_peerswap_on_the_packed_lanes_names_b16s():
    """The packed round's lanes run PeerSwap since B16s's packed half:
    the check accepts it, with or without a plan, factored or (since
    B16x) matrix."""
    from corrosion_tpu_torch.campaign.spec import storm_scenario
    from corrosion_tpu_torch.sim.faults import compile_plan
    from corrosion_tpu_torch.sim.topology import Topology

    _, spec = spec_pair("p", dict(storm_scenario(1280), n_payloads=64,
                                  packed_min_cells=0, peer_sampler="peerswap",
                                  swim_partial_view=False), (0,))
    cfg = spec.sim_config({})
    plan = FaultPlan(n_nodes=1280, seed=0, events=())
    check_packed_lanes(cfg, Topology())
    check_packed_lanes(cfg, Topology(),
                       compile_plan(plan, cfg, device="cpu"))
    check_packed_lanes(cfg, Topology(), compile_plan(
        plan, cfg, factored=False, device="cpu"))

