"""The port's seed ensembles on the dense round (``sim/dense_lanes.py``
through ``campaign/ensemble.py``) against JAX's ``campaign.ensemble``
(``jax.vmap`` of the dense ``run_to_convergence``) and against the
port's own solo runs, on the CPU: every lane entry's plain version
against the solo entry on each lane's inputs (chip smoke's phase 3l at
shrunken shapes), whole 3-lane ensembles at 96 nodes x 64 payloads under
each membership tier and under binding byte budgets, lane by lane and
field by field, with lanes that finish at different rounds, their
``run_campaign`` artifacts, one lane against the solo run, the
``broadcast-1k-seeds8`` spec, and the dense check's refusals."""

import dataclasses
from unittest import mock

import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import (
    lane_state,
    run_seed_ensemble,
    seed_states,
)
from corrosion_tpu_torch.faults import FaultPlan
from corrosion_tpu_torch.sim.dense_lanes import run_dense_lanes
from corrosion_tpu_torch.sim.lanes import check_dense_lanes
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.state import uniform_payloads
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import (
    assert_lanes_equal_jax,
    run_both_ensembles,
    spec_pair,
)

BASE = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4, "fanout": 3,
        "n_delay_slots": 4, "inject_every": 2}
TIERS = {
    "ground": {},
    "full_view": {"swim_full_view": True},
    "partial_view": {"swim_partial_view": True, "member_slots": 16},
    # both byte budgets bind: 3 and 2 payloads of 8 KiB a row and edge
    "binding_budgets": {"rate_limit_bytes_round": 3 * 8192 + 100,
                        "sync_budget_bytes": 2 * 8192},
}


def test_dense_lane_entries_equal_the_solo_entries():
    """Every dense lane entry's plain version (the CPU's) equals itself
    through its wrapper and, on the last lane's inputs, the solo entry:
    chip smoke's phase 3l at 3 lanes, its 100k and 4096 shapes shrunk to
    3000 and 300 nodes, every trap reached (binding budgets, done flags
    that differ by lane, a lane of dead watchers, a detect round already
    set)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12):
        rows = chip_smoke.compare_dense_lane_kernels(
            torch.device("cpu"), lanes=3, timed=False, big=False)
    assert {r["kernel"] for r in rows} == {
        "dense_phases_lanes", "dense_sync_lanes", "dense_gaps_lanes",
        "swim_full_lanes", "sample_uniform_lanes", "detect_full_lanes",
        "detect_partial_lanes"}
    assert all(r["equal"] for r in rows)


def _port_solo(cfg, meta, seeds):
    return [run_to_convergence(new_sim(cfg, int(s), "cpu"), meta, cfg,
                               Topology(), 3000) for s in seeds]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_dense_ensemble_equals_jax_and_solo_runs(tier):
    """Three lanes on the dense round finishing at different rounds:
    every state field and the stamps equal JAX's vmapped ensemble lane by
    lane, each lane the port's solo run of its seed, and the campaign
    artifact JAX's spec_hash and result_digest."""
    seeds = (0, 2, 4)
    jspec, pspec = spec_pair(f"dense-{tier}", dict(BASE, **TIERS[tier]),
                             seeds)
    jf, jm, pf, pm, cfg, meta, _ = run_both_ensembles(jspec, pspec)
    rounds = pf.t.tolist()
    assert len(set(rounds)) > 1, f"lanes all finish at round {rounds[0]}"
    assert_lanes_equal_jax(jf, jm, pf, pm, tier)
    for k, (solo, sm) in enumerate(_port_solo(cfg, meta, seeds)):
        lane = lane_state(pf, k)
        for name, a, b in zip(solo._fields, solo, lane):
            assert torch.equal(a, b), f"lane {k}: {name}"
        assert torch.equal(sm.converged_at, pm.converged_at[k])
    want = jrun_campaign(jspec, out_path=None)
    got = run_campaign(pspec, device="cpu")
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    assert got["cells"][0]["round_path"] == "dense"
    assert got["cells"][0]["per_seed"] == want["cells"][0]["per_seed"]


def test_binding_budgets_bind():
    """The binding tier's budgets change the run: its lanes differ from
    the same seeds unmetered."""
    _, metered = spec_pair("m", dict(BASE, **TIERS["binding_budgets"]),
                           (0,))
    _, free = spec_pair("f", dict(BASE, rate_limit_bytes_round=None,
                                  sync_budget_bytes=None), (0,))
    runs = []
    for spec in (metered, free):
        cfg = spec.sim_config({})
        runs.append(run_seed_ensemble(
            None, cfg, Topology(), uniform_payloads(cfg, "cpu",
                                                    inject_every=2),
            (0,), max_rounds=3000, device="cpu"))
    assert not torch.equal(runs[0][1].converged_at, runs[1][1].converged_at)


def test_one_dense_lane_equals_the_solo_run():
    """K = 1: the dense lane path gives the solo dense run."""
    _, spec = spec_pair("one", dict(BASE, swim_full_view=True), (4,))
    cfg = spec.sim_config({})
    meta = uniform_payloads(cfg, "cpu", inject_every=2)
    finals, metrics = run_dense_lanes(seed_states(cfg, [4], "cpu"), meta,
                                      cfg, Topology(), 3000)
    (solo, sm), = _port_solo(cfg, meta, (4,))
    for name, a, b in zip(solo._fields, solo, lane_state(finals, 0)):
        assert torch.equal(a, b), name
    for name in ("coverage_at", "converged_at", "overflow_frac"):
        assert torch.equal(getattr(sm, name), getattr(metrics, name)[0])


def test_broadcast_seeds_spec_hash_is_jax_and_golden():
    """``broadcast_seeds_spec`` is config_broadcast_1k as a cell: the
    JAX package's CampaignSpec of the same dict has the same hash (the
    golden's), the default budgets stay, and the cell takes the dense
    round."""
    from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
    from corrosion_tpu_torch import goldens
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.broadcast_seeds_spec()
    want = JaxSpec.from_dict(spec.to_dict()).spec_hash()
    assert spec.spec_hash() == want == goldens.BROADCAST_1K_SEEDS8[
        "spec_hash"]
    cfg = spec.sim_config({})
    assert (cfg.n_nodes, cfg.n_payloads, cfg.n_writers, cfg.fanout,
            cfg.n_delay_slots) == (1000, 256, 8, 3, 4)
    assert cfg.rate_limit_bytes_round == 5 * 1024 * 1024
    assert cfg.sync_budget_bytes == 4 * 1024 * 1024
    assert not packed_supported(cfg, spec.topo({}))
    assert spec.inject_every({}) == 2


def _dense_cfg(**kw):
    _, spec = spec_pair("r", dict(BASE, **kw), (0,))
    return spec.sim_config({})


@pytest.mark.parametrize("case", ("fault_plan", "telemetry", "topology",
                                  "peerswap", "protocol"))
def test_dense_check_refuses_by_name(case):
    """The dense lane check runs what the packed lanes' check once
    refused, each naming its ROADMAP item there.  The ``fault_plan`` case
    holds the check's acceptance of a plan, and the ensemble's run under
    it (two seeds of the 3-node parity campaign's matrix plan) equal to
    JAX's, lane by lane; the ``telemetry`` case its acceptance of the
    recorder, which the packed lanes' check accepts too (B16r's packed
    half), a metered budget too since B16m's budgets and the eager
    cadence since B16m's rest; the ``topology`` case its acceptance of a
    topology key, which the packed lanes' check accepts since B16m's
    topology, and a matrix plan over it since B16x; the
    ``peerswap`` case its acceptance of PeerSwap with and without a plan
    (B16s-f); the ``protocol`` case its acceptance of push-pull (B16v),
    which the packed lanes' check accepts too since B16m's rest, and
    under a matrix plan since B16x."""
    from corrosion_tpu_torch.sim.lanes import check_packed_lanes

    cfg, topo, plan, kw = _dense_cfg(), Topology(), None, {}
    packed = _dense_cfg(packed_min_cells=0, rate_limit_bytes_round=None,
                        sync_budget_bytes=None)
    if case == "fault_plan":
        from corrosion_tpu.campaign.spec import builtin_spec as jbuiltin

        check_dense_lanes(cfg, topo, FaultPlan(n_nodes=96, seed=0,
                                               events=()))
        jspec = dataclasses.replace(jbuiltin("fault-parity-3node"),
                                    seeds=(0, 1))
        pspec = spec_mod.fault_parity_3node_spec((0, 1))
        jf, jm, pf, pm, *_ = run_both_ensembles(jspec, pspec)
        assert_lanes_equal_jax(jf, jm, pf, pm, "fault_plan")
        return
    if case == "telemetry":
        check_dense_lanes(cfg, topo, plan, telemetry=True)
        packed = dataclasses.replace(packed, swim_partial_view=True,
                                     member_slots=16)
        check_packed_lanes(packed, topo)
        check_packed_lanes(dataclasses.replace(
            packed, sync_budget_bytes=4 * 1024 * 1024), topo)
        check_packed_lanes(dataclasses.replace(packed, sync_cadence="eager"),
                           topo)
        return
    if case == "topology":
        from corrosion_tpu_torch.sim.faults import compile_plan

        check_dense_lanes(cfg, Topology(n_regions=2))
        check_packed_lanes(packed, Topology(n_regions=2))
        matrix = compile_plan(FaultPlan(n_nodes=96, seed=0, events=()),
                              packed, Topology(n_regions=2), factored=False,
                              device="cpu")
        check_packed_lanes(packed, Topology(n_regions=2), matrix)
        return
    if case == "peerswap":
        cfg = _dense_cfg(peer_sampler="peerswap")
        check_dense_lanes(cfg, topo)
        check_dense_lanes(cfg, topo, FaultPlan(n_nodes=96, seed=0,
                                               events=()), **kw)
        return
    from corrosion_tpu_torch.sim.faults import compile_plan

    check_dense_lanes(_dense_cfg(dissemination="push-pull"), topo, plan)
    push_pull = dataclasses.replace(packed, dissemination="push-pull")
    check_packed_lanes(push_pull, topo)
    matrix = compile_plan(FaultPlan(n_nodes=96, seed=0, events=()),
                          push_pull, topo, factored=False, device="cpu")
    check_packed_lanes(push_pull, topo, matrix)


def test_dense_check_accepts_default_budgets_and_every_tier():
    """Both default byte budgets and all three membership tiers pass
    the dense check; a packed configuration belongs to the packed
    check."""
    for tier in TIERS.values():
        check_dense_lanes(_dense_cfg(**tier), Topology())
    with pytest.raises(ValueError, match="packed configuration"):
        check_dense_lanes(_dense_cfg(packed_min_cells=0, n_payloads=64),
                          Topology())


def test_packed_check_names_its_refusals():
    """The packed check's refusal, worded to point at the dense lanes: a
    dense configuration handed to it.  Full view, the protocol variants
    and a matrix plan, which it pointed there before, run on the packed
    round's lanes since B16s's packed half, B16m's rest and B16x."""
    from corrosion_tpu_torch.sim.faults import compile_plan
    from corrosion_tpu_torch.sim.lanes import check_packed_lanes

    full = _dense_cfg(packed_min_cells=0, rate_limit_bytes_round=None,
                      sync_budget_bytes=None, swim_full_view=True)
    check_packed_lanes(full, Topology())
    push_pull = dataclasses.replace(full, dissemination="push-pull")
    check_packed_lanes(push_pull, Topology())
    matrix = compile_plan(FaultPlan(n_nodes=96, seed=0, events=()),
                          push_pull, Topology(), factored=False,
                          device="cpu")
    check_packed_lanes(push_pull, Topology(), matrix)
    with pytest.raises(ValueError, match="dense configuration"):
        check_packed_lanes(_dense_cfg(), Topology())
