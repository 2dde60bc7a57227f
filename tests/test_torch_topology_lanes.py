"""The topology families on the dense round's lanes (B16t: ring0 tiering,
K20's caps, slots and reach lane entries, K12t's lane entry, the flat
loss on lanes) against JAX (``jax.vmap`` of ``sim/topology.py``,
``sim/swim.py _reachable`` and ``sim/broadcast.py broadcast_step``, and
its ``campaign`` engine) and against the port's own solo entries, on the
CPU: chip smoke's phase 3lt at shrunken shapes (every new lane entry's
plain version, every trap), each lane function field for field in JAX's
dtypes, a 2-seed ensemble a family at 96 nodes, the frontier campaign
and the 1000-node cells against their pins, and the refusals that stay.
``-m slow`` runs the 1000-node cells through the port and re-derives
every pin of paths 51-54 from live JAX, the 100k dense WAN storm one
seed a case."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.campaign import ensemble as jens
from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu.campaign.report import artifact_digest
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu.campaign.spec import builtin_spec as jbuiltin
from corrosion_tpu.sim import broadcast as jbc
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import topology as jtp
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import lane_state
from corrosion_tpu_torch.sim import broadcast as pbc
from corrosion_tpu_torch.sim import dense_lanes as dl
from corrosion_tpu_torch.sim import topology as ptp
from corrosion_tpu_torch.sim.lanes import check_dense_lanes, check_packed_lanes
from corrosion_tpu_torch.sim.pswim import reachable_lanes
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.runner import _resolve_topo
from corrosion_tpu_torch.sim.state import uniform_payloads
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_digest,
    jax_telemetry,
    lane_keys,
    lane_of,
    run_both_ensembles,
    spec_pair,
    stack_lane_states,
)

BASE = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4, "fanout": 3,
        "n_delay_slots": 4, "inject_every": 2}
#: each family with the membership tier its 2-seed case runs: ring0's
#: partial-view and full-view belief checks, the tiered reach of both
#: SWIM tiers, the flat bernoulli reach, caps, matrix delays
FAMILIES = {
    "wan-3x2": {"swim_partial_view": True, "member_slots": 16},
    "wan-2region": {"swim_full_view": True},
    "wan-fly-6r": {"n_delay_slots": 6},
    "hetero-degree": {"swim_partial_view": True, "member_slots": 16},
    "flat-lossy": {"swim_full_view": True},
}
LANES = 3


def test_topology_lane_entries_equal_the_solo_entries():
    """Every new lane entry's plain version (the CPU's) equals itself
    through its wrapper and, on the last lane's inputs, the solo entry:
    chip smoke's phase 3lt at 3 lanes, its 100k and 1000 shapes shrunk to
    1200 and 333 nodes, every trap reached (lanes whose draws differ by
    key alone, a tier at certainty beside a tier at 0, matrix delays and
    a fault delay that wrap the ring, caps below F in some rows, offers
    that collide in one lane, a dead partner, a lane without edges)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_topology_lane_kernels(
            torch.device("cpu"), lanes=LANES, timed=False, big=False)
    assert [r["kernel"] for r in rows] == [
        "edge_slots_lanes", "edge_slots_lanes", "degree_caps_lanes",
        "edge_reach_lanes", "edge_reach_lanes", "edge_reach_lanes",
        "dense_broadcast_tiered_lanes", "dense_broadcast_tiered_lanes_trace",
        "sample_view_lanes", "sample_view_lanes", "peerswap_lanes"]
    assert all(r["equal"] for r in rows)


# -- each lane function against JAX's vmap ------------------------------------


def _family_cfgs(family, **kw):
    jspec, pspec = spec_pair("f", dict(BASE, topo_family=family,
                                       **FAMILIES[family], **kw), (0,))
    return (jspec.sim_config({}), jspec.topo({}), pspec.sim_config({}),
            pspec.topo({}))


def _mid_run_lanes(jcfg, pcfg, seeds, t, seed=0):
    """K mid-run dense states, stacked: JAX's (a pytree [K, ...]) and the
    port's (every field [K, ...], ``t`` one host scalar) — new_sim of
    each seed with numpy holdings, relay budgets, rings, 5 % dead nodes
    and random member tables or beliefs."""
    rng = np.random.default_rng(seed)
    n, p, d = jcfg.n_nodes, jcfg.n_payloads, jcfg.n_delay_slots
    lanes = []
    for s in seeds:
        st = jround.new_sim(jcfg, int(s))
        have = (rng.random((n, p)) < 0.5).astype(np.uint8)
        rep = dict(
            t=jnp.int32(t), have=have,
            relay_left=(rng.integers(0, 4, (n, p)) * have).astype(np.uint8),
            injected=(rng.random(p) < 0.9).astype(np.uint8),
            inflight=(rng.random((d, n, p)) < 0.05).astype(np.uint8),
            alive=((rng.random(n) < 0.05) * 2).astype(np.uint8))
        if jcfg.swim_partial_view:
            m = jcfg.member_slots
            ids = np.arange(m)[None, :] + m * rng.integers(
                0, -(-n // m), (n, m))
            pid = np.where((ids < n) & (rng.random((n, m)) < 0.8), ids, -1)
            rep.update(pid=pid.astype(np.int32), pkey=np.where(
                pid >= 0, rng.integers(0, 12, (n, m)), -1).astype(np.int32))
        if jcfg.swim_full_view:
            rep["view"] = rng.integers(0, 3, (n, n)).astype(np.int8)
        lanes.append(st._replace(**{k: jnp.asarray(v)
                                    for k, v in rep.items()}))
    return stack_lane_states(lanes, pcfg)


@pytest.mark.parametrize("family", ("hetero-degree", "wan-3x2",
                                    "wan-fly-6r"))
def test_caps_and_slots_equal_jax_vmap(family):
    """K20's caps and edge lane entries' plain versions: each lane's
    capped targets (``vmap(apply_degree_caps)``) and slots ``(t +
    vmap(edge_delay) + fdelay) % D`` equal JAX's, in JAX's dtypes."""
    jcfg, jt, pcfg, pt = _family_cfgs(family)
    n, f, d = jcfg.n_nodes, jcfg.fanout, jcfg.n_delay_slots
    rng = np.random.default_rng(1)
    tg = np.where(rng.random((LANES, n, f)) < 0.05, -1,
                  rng.integers(0, n, (LANES, n, f))).astype(np.int32)
    want = np.asarray(jax.vmap(lambda x: jtp.apply_degree_caps(x, jt))(tg))
    got = ptp.apply_degree_caps_lanes(torch.as_tensor(tg), pt).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.dtype == got.dtype
    src = np.repeat(np.arange(n, dtype=np.int32), f)
    dst = rng.integers(0, n, (LANES, n * f)).astype(np.int32)
    fdelay = rng.integers(0, 3, (LANES, n * f)).astype(np.int32)
    jregion = jtp.regions(n, jt.n_regions)
    delay = jax.vmap(lambda x: jtp.edge_delay(jt, jregion, src, x))(dst)
    t = 9
    want = np.asarray((t + delay + fdelay) % d).astype(np.int32)
    got = ptp.edge_slot_lanes(pt, ptp.regions(n, pt.n_regions, "cpu"),
                              torch.as_tensor(src), torch.as_tensor(dst), t,
                              d, torch.as_tensor(fdelay)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("family", ("wan-3x2", "flat-lossy"))
def test_reach_equals_jax_vmap(family):
    """The lanes' reach (`pswim.reachable_lanes`): group, both ends up and
    the topology's loss — K20's reach lane entry's tiered draw under
    wan-3x2, the flat bernoulli under flat-lossy — equal to
    ``vmap(swim._reachable)`` on the same states, keys and edges."""
    jcfg, jt, pcfg, pt = _family_cfgs(family)
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 6)
    n = jcfg.n_nodes
    rng = np.random.default_rng(2)
    src = rng.integers(0, n, (LANES, 3 * n)).astype(np.int32)
    dst = rng.integers(0, n, (LANES, 3 * n)).astype(np.int32)
    jk, pk = lane_keys(LANES, 40)
    want = np.asarray(jax.vmap(lambda st, k, s, d: jswim._reachable(
        st, jt, k, s, d))(jstates, jk, src, dst))
    got = reachable_lanes(pstates, pt, pk, torch.as_tensor(src),
                          torch.as_tensor(dst)).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any() and not want.all()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_broadcast_step_equals_jax_vmap(family):
    """The lanes' broadcast step (targets, ring0 tiering against each
    lane's beliefs, caps, edges, slots, the flat or tiered wire loss
    under each lane's k_drop; K12 or K12t's lane entry) equal to
    ``vmap(broadcast_step)``: relay budgets and both rings, exactly."""
    jcfg, jt, pcfg, pt = _family_cfgs(family)
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 12)
    n = jcfg.n_nodes
    jmeta = uniform_payloads_jax(jcfg)
    pmeta = uniform_payloads(pcfg, "cpu", inject_every=2)
    jk, pk = lane_keys(LANES, 50)
    jregion = jtp.regions(n, jt.n_regions)
    want = jax.vmap(lambda st, k: jbc.broadcast_step(
        st, jmeta, jcfg, jt, jregion, k))(jstates, jk)
    dl.broadcast_step_lanes(pstates, pmeta, pcfg, pt,
                            ptp.regions(n, pt.n_regions, "cpu"), pk)
    for name in ("relay_left", "inflight"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(pstates, name).numpy(),
                                      err_msg=name)


def uniform_payloads_jax(jcfg):
    from corrosion_tpu.sim.state import uniform_payloads as jpayloads

    return jpayloads(jcfg, inject_every=2)


def test_ring0_lanes_equal_the_solo_ring0():
    """Ring0 tiering on lanes is the solo `ring0_targets` on each lane
    with its own key (randint's u32 wrap included), under both belief
    checks, and leaves a one-region topology's targets alone."""
    for family in ("wan-3x2", "wan-2region"):
        _, _, pcfg, pt = _family_cfgs(family)
        _, pstates = _mid_run_lanes(_family_cfgs(family)[0], pcfg,
                                    range(LANES), 4)
        n = pcfg.n_nodes
        region = ptp.regions(n, pt.n_regions, "cpu")
        targets = torch.randint(0, n, (LANES, n, 3), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(3))
        _, pk = lane_keys(LANES, 60)
        got = pbc.ring0_targets_lanes(pstates, pcfg, pt, region, pk, targets)
        changed = False
        for k in range(LANES):
            solo = pbc.ring0_targets(lane_of(pstates, k), pcfg, pt,
                                     region, pk[k], targets[k])
            assert torch.equal(got[k], solo), (family, k)
            changed |= not torch.equal(solo, targets[k])
        assert changed
    flat = ptp.Topology()
    assert pbc.ring0_targets_lanes(pstates, pcfg, flat, region, pk,
                                   targets) is targets


# -- whole ensembles and campaigns ---------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_ensemble_equals_jax(family):
    """A 2-seed ensemble a family at 96 nodes on the dense round: every
    state field and the stamps equal JAX's vmapped ensemble lane by
    lane, and lane 1 the port's solo run of its seed."""
    jspec, pspec = spec_pair(f"lanes-{family}", dict(
        BASE, topo_family=family, **FAMILIES[family]), (0, 1))
    jf, jm, pf, pm, cfg, meta, _ = run_both_ensembles(jspec, pspec)
    assert_lanes_equal_jax(jf, jm, pf, pm, family)
    solo, _ = run_to_convergence(new_sim(cfg, 1, "cpu"), meta, cfg,
                                 pspec.topo({}), pspec.max_rounds)
    for name, a, b in zip(solo._fields, solo, lane_state(pf, 1)):
        assert torch.equal(a, b), name


def test_family_ensemble_with_the_recorder_equals_jax():
    """The recorder on the tiered lanes: wan-3x2 with ``telemetry``, each
    lane's summary (the dropped frames from K12t's recording form) equal
    to live JAX's, and the digest the plain run's."""
    scenario = dict(BASE, topo_family="wan-3x2", **FAMILIES["wan-3x2"])
    jspec, pspec = spec_pair("rec-wan-3x2", scenario, (0, 1))
    with jax_telemetry():
        want = jrun_campaign(jspec, out_path=None, telemetry=True)
    got = run_campaign(pspec, telemetry=True, device="cpu")
    assert got["result_digest"] == want["result_digest"]
    assert got["cells"][0]["telemetry"] == want["cells"][0]["telemetry"]


def _frontier_got(art):
    """An artifact in the goldens' form: its hashes, each cell's per-seed
    rounds and, on measure_wire cells, wire_bytes."""
    cells = art["cells"]
    got = {"spec_hash": art["spec_hash"],
           "result_digest": art["result_digest"],
           "rounds": [c["per_seed"]["rounds"] for c in cells]}
    if "wire_bytes" in cells[0]["per_seed"]:
        got["wire_bytes"] = [c["per_seed"]["wire_bytes"] for c in cells]
    return got


def test_peer_sampler_frontier_equals_its_pin():
    """The committed `peer-sampler-frontier` campaign (both samplers ×
    wan-3x2 and hetero-degree, 96 nodes, 4 seeds, measure_wire) through
    the port's engine: live JAX's spec_hash and result_digest and every
    cell's per-seed rounds and wire_bytes (path 51's golden), and
    `config_peer_sampler_frontier` reduces it as JAX's rung does."""
    from corrosion_tpu_torch.sim.runner import config_peer_sampler_frontier

    lanes = {}
    art = run_campaign(spec_mod.builtin_spec("peer-sampler-frontier"),
                       device="cpu", lanes_out=lanes)
    assert _frontier_got(art) == goldens.PEER_SAMPLER_FRONTIER
    assert all(c["round_path"] == "dense" for c in art["cells"])
    rec = config_peer_sampler_frontier(seed=0, device="cpu")
    assert rec["result_digest"] == goldens.PEER_SAMPLER_FRONTIER[
        "result_digest"]
    fam = rec["families"]["wan-3x2"]
    assert fam["uniform"]["rounds_p50"] == 24.0
    assert fam["rounds_ratio"] == round(fam["peerswap"]["rounds_p50"]
                                        / fam["uniform"]["rounds_p50"], 3)
    assert rec["converged"] and rec["spec_hash"] == "ef38d63b3804deb8"


CELLS_1K = {
    "BROADCAST_1K_WAN_3X2_PEERSWAP_SEEDS8_WIRE":
        dict(topo_family="wan-3x2", peer_sampler="peerswap",
             measure_wire=True),
    "BROADCAST_1K_FLAT_LOSSY_UNIFORM_SEEDS8_WIRE":
        dict(topo_family="flat-lossy", peer_sampler="uniform",
             measure_wire=True),
    "BROADCAST_1K_WAN_FLY_6R_UNIFORM_SEEDS8":
        dict(topo_family="wan-fly-6r", peer_sampler="uniform",
             n_delay_slots=6),
}


@pytest.mark.parametrize("golden", sorted(CELLS_1K))
def test_1k_cell_specs_are_the_goldens(golden):
    """Each 1000-node cell's spec (paths 52-53) has its golden's hash, the
    JAX package's `CampaignSpec` of the same dict the same, and takes the
    dense round."""
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.broadcast_topology_seeds_spec(**CELLS_1K[golden])
    assert spec.spec_hash() == getattr(goldens, golden)["spec_hash"] == \
        JaxSpec.from_dict(spec.to_dict()).spec_hash()
    assert not packed_supported(spec.sim_config({}), spec.topo({}))


@pytest.mark.slow
@pytest.mark.parametrize("golden", sorted(CELLS_1K))
def test_1k_cell_equals_its_pin(golden):
    """Each 1000-node cell through the port's engine on the CPU (about a
    minute each) gives its golden: spec_hash, result_digest, the
    per-seed rounds and, on a measure_wire cell, wire_bytes; the
    PeerSwap cell's lane 0 is JAX's solo ``config_broadcast_1k`` run
    (its state's and its view's digests)."""
    from corrosion_tpu_torch.convert import pview_digest, state_digest

    spec = spec_mod.broadcast_topology_seeds_spec(**CELLS_1K[golden])
    lanes = {}
    art = run_campaign(spec, device="cpu", lanes_out=lanes)
    assert _frontier_got(art) == getattr(goldens, golden)
    if golden == "BROADCAST_1K_WAN_3X2_PEERSWAP_SEEDS8_WIRE":
        solo = goldens.BROADCAST_1K_WAN_3X2_PEERSWAP_SEED0
        lane0 = lane_state(lanes[0]["finals"], 0)
        assert (state_digest(lane0), pview_digest(lane0)) == (
            solo["digest"], solo["pview_digest"])


@pytest.mark.slow
def test_frontier_and_1k_goldens_match_live_jax():
    """Paths 51-53's goldens from live JAX's engine: the frontier campaign
    and the three 1000-node cells (about two minutes on the CPU)."""
    with jax_telemetry():
        art = jrun_campaign(jbuiltin("peer-sampler-frontier"),
                            out_path=None)
        assert _frontier_got(art) == goldens.PEER_SAMPLER_FRONTIER
        for golden, kw in CELLS_1K.items():
            spec = spec_mod.broadcast_topology_seeds_spec(**kw)
            art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                                out_path=None)
            assert _frontier_got(art) == getattr(goldens, golden), golden


# -- the 100k dense WAN storm (path 54) ----------------------------------------


def test_wan_storm_spec_is_the_golden_cell():
    """``dense_storm_wan_seeds_spec`` (path 54) is finding 4's scenario
    over seeds 0-7: the JAX package's hash of the same dict, the dense
    round at 100 000 × 512 over wan-3x2 with three ring slots; lane 0 is
    the packed solo golden's run (the dense == packed contract)."""
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.dense_storm_wan_seeds_spec()
    golden = goldens.DENSE_STORM_WAN_3X2_100K_SEEDS8
    assert spec.spec_hash() == golden["spec_hash"] == \
        JaxSpec.from_dict(spec.to_dict()).spec_hash()
    cfg, topo = spec.sim_config({}), spec.topo({})
    assert (cfg.n_nodes, cfg.n_payloads, cfg.n_delay_slots) == (
        100_000, 512, 3)
    assert topo == _resolve_topo("wan-3x2") and topo.max_delay == 2
    assert not packed_supported(cfg, topo)
    solo = goldens.STORM_WAN_3X2_100K_SEED0
    lane0 = golden["lanes"][0]
    assert (lane0["rounds"], lane0["p99_node_convergence_round"],
            lane0["digest"]) == (solo["rounds"],
                                 solo["p99_node_convergence_round"],
                                 solo["digest"])


def _cell_of(lanes, n_nodes):
    """The engine's faultless dense cell (JAX's keys) of a golden's
    lanes."""
    from corrosion_tpu.campaign.report import BAND_METRICS, bands

    ps = {"rounds": [lane["rounds"] for lane in lanes],
          "converged": [lane["converged"] for lane in lanes],
          "unconverged_nodes": [lane["unconverged_nodes"] for lane in lanes],
          "p99_node_convergence_round": [
              lane["p99_node_convergence_round"] for lane in lanes]}
    return {"params": {}, "n_nodes": n_nodes, "n_payloads": 512,
            "round_path": "dense", "mesh": None, "n_devices": 1,
            "seeds": [lane["seed"] for lane in lanes], "plan_horizon": 0,
            "per_seed": ps,
            "bands": {m: bands(ps[m]) for m in BAND_METRICS if m in ps},
            "all_converged": all(ps["converged"]), "cell_index": 0}


def test_wan_storm_golden_digest_is_jaxs_over_its_lanes():
    """The 8-lane result_digest of path 54 is JAX's ``artifact_digest``
    over the cell its eight lanes make, each lane pinned from a one-seed
    JAX campaign (``-m slow``); the same construction gives lane 0's
    one-seed digest (finding 4's), which ties the construction to JAX's
    engine."""
    golden = goldens.DENSE_STORM_WAN_3X2_100K_SEEDS8
    assert artifact_digest([_cell_of(golden["lanes"], 100_000)]) == golden[
        "result_digest"]
    assert artifact_digest([_cell_of(golden["lanes"][:1], 100_000)]) == \
        golden["seed0_result_digest"]


def _jax_one_seed(seed):
    """Live JAX's one-seed run_campaign of path 54's cell: the artifact
    and the lane in the golden's form."""
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["finals"] = out[0]
        return out

    spec = spec_mod.dense_storm_wan_seeds_spec(seeds=(seed,))
    jens.run_seed_ensemble = keeping
    try:
        with jax_telemetry():
            art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                                out_path=None)
    finally:
        jens.run_seed_ensemble = orig
    ps = art["cells"][0]["per_seed"]
    return art, {"seed": seed, "rounds": ps["rounds"][0],
                 "p99_node_convergence_round":
                     ps["p99_node_convergence_round"][0],
                 "converged": ps["converged"][0],
                 "unconverged_nodes": ps["unconverged_nodes"][0],
                 "digest": jax_digest(jax.tree.map(lambda x: x[0],
                                                   kept["finals"]))}


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_wan_storm_100k_lane_matches_live_jax(seed):
    """Lane ``seed`` of ``DENSE_STORM_WAN_3X2_100K_SEEDS8`` (path 54) from
    live JAX's one-seed run_campaign of the cell (100 000 × 512 on the
    dense round over wan-3x2, about two and a half minutes on the CPU);
    seed 0's artifact digest is finding 4's."""
    art, lane = _jax_one_seed(seed)
    golden = goldens.DENSE_STORM_WAN_3X2_100K_SEEDS8
    assert lane == golden["lanes"][seed]
    if seed == 0:
        assert art["result_digest"] == golden["seed0_result_digest"]


# -- the refusals that stay -----------------------------------------------------


def test_dense_lanes_take_every_family_and_key():
    """The dense check accepts every topology family and a bare topology
    key (the flat lossy topology), with or without a plan."""
    from corrosion_tpu_torch.faults import FaultPlan

    cfg = spec_pair("r", BASE, (0,))[1].sim_config({})
    plan = FaultPlan(n_nodes=96, seed=0, events=())
    for family in (*FAMILIES, "wan-2region"):
        check_dense_lanes(cfg, _resolve_topo(family), plan)
    check_dense_lanes(cfg, ptp.Topology(loss=0.1))


def test_packed_lanes_refuse_topology_naming_b16m():
    """The packed round's lanes take every topology family since B16m's
    topology, and over one the protocol variants, which they refused
    naming B16m, since B16m's rest (the eager cadence over wan-3x2 is
    accepted), and a matrix plan over a family since B16x."""
    from corrosion_tpu_torch.campaign.spec import storm_scenario
    from corrosion_tpu_torch.faults import FaultPlan
    from corrosion_tpu_torch.sim.faults import compile_plan

    _, spec = spec_pair("p", dict(storm_scenario(1280), n_payloads=64,
                                  packed_min_cells=0), (0,))
    cfg = spec.sim_config({})
    for family in FAMILIES:
        check_packed_lanes(cfg, _resolve_topo(family))
    wan = _resolve_topo("wan-3x2")
    eager = dataclasses.replace(cfg, sync_cadence="eager", n_delay_slots=3)
    check_packed_lanes(eager, wan)
    matrix = compile_plan(FaultPlan(n_nodes=1280, seed=0, events=()),
                          eager, wan, factored=False, device="cpu")
    check_packed_lanes(eager, wan, matrix)


def test_protocol_variants_on_lanes_name_b16v():
    """The protocol variants (B16v) run on the dense round's lanes over a
    topology family; the packed round's lanes, which refused them naming
    B16m, take them since B16m's rest (their lane entries of K10p, K8f and
    K22's words entry): the fan-out decay over hetero-degree's caps
    (K20's schedule lane entry) is accepted."""
    from corrosion_tpu_torch.campaign.spec import storm_scenario

    dense = spec_pair("d", dict(BASE, dissemination="push-pull"),
                      (0,))[1].sim_config({})
    check_dense_lanes(dense, _resolve_topo("wan-3x2"))
    packed = spec_pair("p", dict(storm_scenario(1280), n_payloads=64,
                                 packed_min_cells=0,
                                 fanout_schedule="decay"),
                       (0,))[1].sim_config({})
    check_packed_lanes(packed, ptp.Topology())
    check_packed_lanes(packed, _resolve_topo("hetero-degree"))

