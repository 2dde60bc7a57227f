"""The protocol variants on the dense round's lanes (B16v: K20's schedule
lane entry, K12p's lane entry with the pull's session and reverse loss
on the folded lanes, K18's rows-pull lane entry, the eager cadence,
K12f-o's and K22's u8 lane entries) against JAX (``jax.vmap`` of
``proto/schedule.py``, ``sim/broadcast.py`` ``broadcast_step``'s
push-pull leg and ``deliver_step``'s FIFO gate, ``sim/sync.py``
``sync_step`` under the eager cadence, ``sim/invariants.py
order_violation_count``, its vmapped ensembles and its engine) and
against the port's own solo entries, on the CPU: chip smoke's phase 3lv
at shrunken shapes (every new lane entry's plain version, every trap),
each lane function field for field in JAX's dtypes, a 2-seed ensemble a
family at 96 nodes (push-pull under a fault plan too), a recording
push-pull campaign, the frontier rung's record, the pins of paths 55-58
and the refusals that stay.  ``-m slow`` runs the frontier one cell a
case, the 1000-node cells through the port, and re-derives the pins
from live JAX, the 100k push-pull storm one seed a case."""

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
from corrosion_tpu.proto import schedule as jsch
from corrosion_tpu.sim import broadcast as jbc
from corrosion_tpu.sim import invariants as jinv
from corrosion_tpu.sim import state as jst
from corrosion_tpu.sim import sync as jsync
from corrosion_tpu.sim import topology as jtp
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.ensemble import lane_state
from corrosion_tpu_torch.proto import schedule as psch
from corrosion_tpu_torch.sim import broadcast as pbc
from corrosion_tpu_torch.sim import dense_lanes as dl
from corrosion_tpu_torch.sim import faults as pfaults
from corrosion_tpu_torch.sim import invariants as pinv
from corrosion_tpu_torch.sim import topology as ptp
from corrosion_tpu_torch.sim.lanes import check_dense_lanes, check_packed_lanes
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.state import uniform_payloads
from tests.test_torch_topology_lanes import _cell_of, _mid_run_lanes
from tests.torch_parity import (
    assert_lanes_equal_jax,
    jax_digest,
    jax_telemetry,
    lane_keys,
    lane_of,
    run_both_ensembles,
    spec_pair,
)

BASE = {"n_nodes": 96, "n_payloads": 64, "n_writers": 4, "fanout": 3,
        "n_delay_slots": 4, "inject_every": 2}
LANES = 3


def test_protocol_lane_entries_equal_the_solo_entries():
    """Every new lane entry's plain version (the CPU's) equals itself
    through its wrapper and, on the last lane's inputs, the solo entry:
    chip smoke's phase 3lv at 3 lanes, its 100k and 1000 shapes shrunk to
    1200 and 333 nodes, every trap reached (lanes whose pull keys,
    reverse draws and plan seeds differ, a pull cut in the reverse
    direction only, a tier at certainty on the pull leg, the relay budget
    read before the push's spend, a FIFO gate rejecting in one lane what
    it admits in another, violation counts differing by lane with one 0,
    a schedule round where the slot count drops below caps, blocks
    spanning two lanes, a lane without edges)."""
    with mock.patch.object(chip_smoke, "_int32_ops_per_s",
                           return_value=1e12), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        rows = chip_smoke.compare_protocol_lane_kernels(
            torch.device("cpu"), lanes=LANES, timed=False, big=False)
    assert [r["kernel"] for r in rows] == [
        "dense_pull_lanes", "dense_pull_tiered_lanes_trace",
        "dense_pull_tiered_lanes", "dense_pull_lossy_lanes_trace",
        "dense_pull_lossy_lanes", "dense_deliver_fifo_lanes",
        "order_check_dense_lanes", "order_check_dense_lanes",
        "degree_caps_sched_lanes", "trace_wire_rows_pull_lanes"]
    assert all(r["equal"] for r in rows)
    # the pull's frontier rows and the FIFO row at the frontier's width
    assert {r["n"] for r in rows[1:6]} == {96}


# -- each lane function against JAX's vmap ------------------------------------


def _cfgs(family=None, **kw):
    scenario = dict(BASE, **kw)
    if family:
        scenario["topo_family"] = family
    jspec, pspec = spec_pair("p", scenario, (0,))
    return (jspec.sim_config({}), jspec.topo({}), pspec.sim_config({}),
            pspec.topo({}))


@pytest.mark.parametrize("family", (None, "hetero-degree"))
def test_schedule_lanes_equal_jax_vmap(family):
    """K20's schedule lane entry's plain version: each lane's targets
    after the caps and the decay schedule (``vmap(scheduled_fanout_
    targets ∘ apply_degree_caps)``) at rounds 7 and 8, where the live
    count drops from 3 to 1, in JAX's dtypes."""
    jcfg, jt, pcfg, pt = _cfgs(family, fanout_schedule="decay",
                               fanout_decay_rounds=8)
    n, f = jcfg.n_nodes, jcfg.fanout
    rng = np.random.default_rng(4)
    tg = np.where(rng.random((LANES, n, f)) < 0.05, -1,
                  rng.integers(0, n, (LANES, n, f))).astype(np.int32)
    for t in (7, 8):
        want = np.asarray(jax.vmap(lambda x: jsch.scheduled_fanout_targets(
            jtp.apply_degree_caps(x, jt), jcfg, jnp.int32(t)))(tg))
        got = psch.capped_schedule_lanes(torch.as_tensor(tg), pt, pcfg,
                                         t).numpy()
        np.testing.assert_array_equal(want, got)
        assert want.dtype == got.dtype
    assert (got[:, :, 1:] == -1).all()


@pytest.mark.parametrize("family", ("flat-lossy", "wan-3x2"))
def test_push_pull_broadcast_step_equals_jax_vmap(family):
    """The lanes' broadcast step under push-pull (the response leg
    before the push's spend, each lane's pull key, the flat or the
    reverse edges' tiered loss; K12p's lane entry, then K12's or K12t's)
    equal to ``vmap(broadcast_step)``: relay budgets and both rings,
    exactly."""
    jcfg, jt, pcfg, pt = _cfgs(family, dissemination="push-pull")
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 12)
    n = jcfg.n_nodes
    jmeta = jst.uniform_payloads(jcfg, inject_every=2)
    pmeta = uniform_payloads(pcfg, "cpu", inject_every=2)
    jk, pk = lane_keys(LANES, 90)
    jregion = jtp.regions(n, jt.n_regions)
    want = jax.vmap(lambda st, k: jbc.broadcast_step(
        st, jmeta, jcfg, jt, jregion, k))(jstates, jk)
    before = pstates.inflight.clone()
    dl.broadcast_step_lanes(pstates, pmeta, pcfg, pt,
                            ptp.regions(n, pt.n_regions, "cpu"), pk)
    for name in ("relay_left", "inflight"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(pstates, name).numpy(),
                                      err_msg=name)
    assert not torch.equal(before, pstates.inflight)


def test_push_pull_step_under_a_plan_equals_the_solo_step():
    """Under a fault slice with a one-way cut and reverse-direction loss,
    the lanes' push-pull broadcast step (the session and the reverse
    loss through K9's queries on the folded lanes, each lane's fault
    stream under its k_pull and plan seed) is, lane for lane, the solo
    `broadcast_step` of that lane's state, key and re-seeded slice."""
    jcfg, _, pcfg, pt = _cfgs("flat-lossy", dissemination="push-pull")
    _, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 2)
    n = pcfg.n_nodes
    meta = uniform_payloads(pcfg, "cpu", inject_every=2)
    plan = pfaults.compile_plan(chip_smoke.one_way_plan(n), pcfg,
                                device="cpu")
    rf = pfaults.round_faults(plan, 2)
    seeds = torch.tensor([5, 6, 7], dtype=torch.int32)
    _, pk = lane_keys(LANES, 95)
    region = ptp.regions(n, pt.n_regions, "cpu")
    solos = []
    for k in range(LANES):
        lane = lane_of(pstates, k)
        lane = lane._replace(**{f: getattr(lane, f).clone()
                                for f in ("relay_left", "inflight")})
        solos.append(pbc.broadcast_step(
            lane, meta, pcfg, pt, region, pk[k],
            rf._replace(seed=torch.tensor(int(seeds[k]),
                                              dtype=torch.int32))))
    dl.broadcast_step_lanes(pstates, meta, pcfg, pt, region, pk, rf, seeds)
    for k, solo in enumerate(solos):
        for name in ("relay_left", "inflight"):
            assert torch.equal(getattr(solo, name),
                               getattr(pstates, name)[k]), (k, name)


def test_fifo_deliver_lanes_equal_jax_vmap():
    """K12f-o's lane entry's plain version: ``vmap(deliver_step)`` under
    ``ordering="fifo"`` — both rings gated on each lane's pre-merge
    have, the rejected arrivals dropped and the slots cleared."""
    jcfg, _, pcfg, _ = _cfgs(ordering="fifo")
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 5, seed=3)
    want = jax.vmap(lambda st: jbc.deliver_step(st, jcfg))(jstates)
    d = pcfg.n_delay_slots
    dl.deliver_dense_lanes(pstates.inflight, pstates.sync_inflight,
                           pstates.have, pstates.relay_left, 5 % d,
                           max(pcfg.max_transmissions - 1, 1), pcfg)
    for name in ("have", "relay_left", "inflight", "sync_inflight"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(pstates, name).numpy(),
                                      err_msg=name)


def test_order_count_lanes_equal_jax_vmap():
    """K22's u8 lane entry's plain version: each lane's count added to
    its own slot equals ``vmap(order_violation_count)`` over the lanes'
    grids, lanes differing."""
    jcfg, _, pcfg, _ = _cfgs(ordering="fifo-unchecked")
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 5, seed=6)
    jmeta = jst.uniform_payloads(jcfg, inject_every=2)
    pmeta = uniform_payloads(pcfg, "cpu", inject_every=2)
    want = np.asarray(jax.vmap(lambda h: jinv.order_violation_count(
        jst.touched_versions(h, jcfg), jst.complete_versions(h, jcfg),
        jmeta, jcfg))(jstates.have))
    acc = torch.tensor([3, 0, 9], dtype=torch.int32)
    pinv.count_order_violations_lanes_(acc, pstates.have, pmeta, pcfg)
    np.testing.assert_array_equal(want + np.array([3, 0, 9]), acc.numpy())
    assert len(set(want.tolist())) > 1 and want.dtype == np.int32


def test_eager_sync_lanes_equal_jax_vmap():
    """The eager cadence on lanes: ``vmap(sync_step)`` under
    ``sync_cadence="eager"`` — every node due, the countdown and its
    re-arm drawing on — equal to `sync_step_lanes`: the sync ring, the
    countdowns and backoffs."""
    jcfg, jt, pcfg, _ = _cfgs(sync_cadence="eager")
    jstates, pstates = _mid_run_lanes(jcfg, pcfg, range(LANES), 7, seed=8)
    rng = np.random.default_rng(9)
    cd = rng.integers(-1, 4, (LANES, jcfg.n_nodes)).astype(np.int32)
    jstates = jstates._replace(sync_countdown=jnp.asarray(cd))
    pstates = pstates._replace(sync_countdown=torch.as_tensor(cd))
    jmeta = jst.uniform_payloads(jcfg, inject_every=2)
    pmeta = uniform_payloads(pcfg, "cpu", inject_every=2)
    jk, pk = lane_keys(LANES, 120)
    want = jax.vmap(lambda st, k: jsync.sync_step(st, jmeta, jcfg, jt, k))(
        jstates, jk)
    got = dl.sync_step_lanes(pstates, pmeta, pcfg, pk)
    for name in ("sync_inflight", "sync_countdown", "sync_backoff"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    periodic = dl.sync_step_lanes(
        pstates._replace(sync_inflight=pstates.sync_inflight.clone()),
        pmeta, dataclasses.replace(pcfg, sync_cadence="periodic"), pk)
    late = torch.as_tensor(cd > 0)
    assert torch.equal(periodic.sync_countdown[late],
                       torch.as_tensor(cd)[late] - 1)
    assert not torch.equal(got.sync_countdown, periodic.sync_countdown)


# -- whole ensembles and campaigns -------------------------------------------

#: one 2-seed case a family (the topology and membership tier each runs)
FAMILY_CASES = {
    "baseline": ("baseline", "wan-3x2", {}),
    "swarm-aggressive": ("swarm-aggressive", "wan-3x2",
                         {"swim_partial_view": True, "member_slots": 16}),
    "push-pull": ("push-pull", "flat-lossy", {"swim_full_view": True}),
    "push-pull-wan": ("push-pull", "wan-3x2", {}),
    "fanout-decay": ("fanout-decay", "hetero-degree", {}),
    "lab-ordered": ("lab-ordered", None, {}),
    "lab-ordered-broken": ("lab-ordered-broken", "flat-lossy", {}),
}


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_ensemble_equals_jax(case):
    """A 2-seed ensemble a protocol family at 96 nodes on the dense
    round: every state field, the stamps and the order counts equal
    JAX's vmapped ensemble lane by lane (the unchecked control's
    nonzero), and lane 1 the port's solo run of its seed."""
    family, topo, kw = FAMILY_CASES[case]
    scenario = dict(BASE, proto_family=family, **kw)
    if topo:
        scenario["topo_family"] = topo
    jspec, pspec = spec_pair(f"proto-{case}", scenario, (0, 1))
    jf, jm, pf, pm, cfg, meta, _ = run_both_ensembles(jspec, pspec)
    assert_lanes_equal_jax(jf, jm, pf, pm, case)
    np.testing.assert_array_equal(np.asarray(jm.order_violations),
                                  pm.order_violations.numpy())
    if family == "lab-ordered-broken":
        assert (pm.order_violations > 0).all()
    solo, metrics = run_to_convergence(new_sim(cfg, 1, "cpu"), meta, cfg,
                                       pspec.topo({}), pspec.max_rounds)
    for name, a, b in zip(solo._fields, solo, lane_state(pf, 1)):
        assert torch.equal(a, b), name
    assert int(metrics.order_violations) == int(pm.order_violations[1])


def test_push_pull_under_a_plan_equals_jax():
    """Push-pull under the fault storm's plan at 96 nodes over
    flat-lossy (the split refuses pulls both ways, the loss burst draws
    the reverse direction's fault stream per lane): 2 seeds, every lane
    field equal to JAX's vmapped fault ensemble."""
    jspec, pspec = spec_pair("pp-fault", dict(
        BASE, proto_family="push-pull", topo_family="flat-lossy"), (0, 1))
    events = spec_mod.storm_fault_events(96)
    pspec = dataclasses.replace(pspec, events=events)
    jspec = JaxSpec.from_dict(pspec.to_dict())
    jf, jm, pf, pm, *_ = run_both_ensembles(jspec, pspec)
    assert_lanes_equal_jax(jf, jm, pf, pm, "push-pull fault")


def test_recording_push_pull_campaign_equals_live_jax():
    """A recording push-pull cell over wan-3x2 (both legs' tiered drops
    in each lane's dropped slot, the answered pulls' frames and bytes
    through K18's rows-pull lane entry): the artifact and every lane's
    ``telemetry`` summary equal live JAX's, and ``wire_bytes`` banded."""
    jspec, pspec = spec_pair("pp-rec", dict(
        BASE, proto_family="push-pull", topo_family="wan-3x2",
        measure_wire=1), (0, 1))
    with jax_telemetry():
        want = jrun_campaign(jspec, out_path=None, telemetry=True)
    got = run_campaign(pspec, telemetry=True, device="cpu")
    for key in ("spec_hash", "result_digest"):
        assert got[key] == want[key], key
    for key in ("per_seed", "bands", "telemetry"):
        assert got["cells"][0][key] == want["cells"][0][key], key
    assert "wire_bytes" in got["cells"][0]["per_seed"]


def test_frontier_rung_record_equals_jaxs():
    """`config_protocol_frontier` on a shrunken grid (baseline and
    push-pull over flat-lossy, 2 seeds, no sampler storm) gives JAX's
    `runner.config_protocol_frontier` record but for the wall: the
    ratios against baseline, the digest; and an ordering grid carries
    ``order_violations_max``."""
    from corrosion_tpu.sim.runner import config_protocol_frontier as jrec
    from corrosion_tpu_torch.sim.runner import config_protocol_frontier

    kw = dict(n_seeds=2, sampler_storm_nodes=0,
              proto_families=["baseline", "push-pull"],
              topo_families=["flat-lossy"])
    with jax_telemetry():
        want = jrec(**kw)
    got = config_protocol_frontier(device="cpu", **kw)
    want.pop("wall_clock_s")
    got.pop("wall_clock_s")
    assert got == want
    entry = got["families"]["flat-lossy"]["push-pull"]
    assert set(entry) == {"rounds_p50", "rounds_p99", "wire_bytes_p50",
                          "converged", "rounds_ratio", "wire_ratio"}


# -- the pins of paths 55-59 -------------------------------------------------


def _frontier_cells():
    """The committed frontier's cells (grid order) rebuilt from the
    golden's per-seed records, JAX's keys."""
    from corrosion_tpu.campaign.report import BAND_METRICS, bands

    golden = goldens.PROTOCOL_FRONTIER
    spec = spec_mod.builtin_spec("protocol-frontier")
    out = []
    for i, (cell, ps) in enumerate(zip(spec.cells(), golden["per_seed"])):
        out.append({"params": dict(cell), "n_nodes": 96, "n_payloads": 64,
                    "round_path": "dense", "mesh": None, "n_devices": 1,
                    "seeds": list(spec.seeds), "plan_horizon": 0,
                    "per_seed": ps,
                    "bands": {m: bands(ps[m]) for m in BAND_METRICS
                              if m in ps},
                    "all_converged": all(ps["converged"]), "cell_index": i})
    return out


def test_frontier_golden_is_jaxs_digest():
    """The committed `protocol-frontier` spec has its golden's hash, and
    JAX's ``artifact_digest`` over the cells the golden's per-seed
    records make is the golden's result_digest (live JAX's);
    the golden's rounds, wire_bytes and order_violations are those
    records'."""
    golden = goldens.PROTOCOL_FRONTIER
    spec = spec_mod.builtin_spec("protocol-frontier")
    assert spec.spec_hash() == golden["spec_hash"] == \
        JaxSpec.from_dict(spec.to_dict()).spec_hash()
    assert artifact_digest(_frontier_cells()) == golden["result_digest"]
    for key in ("rounds", "wire_bytes"):
        assert golden[key] == [ps[key] for ps in golden["per_seed"]]
    assert golden["order_violations"] == [ps.get("order_violations")
                                          for ps in golden["per_seed"]]


def test_frontier_equals_its_pin():
    """The committed `protocol-frontier` campaign (four protocol families
    × wan-3x2 and flat-lossy, 96 nodes, 4 seeds, measure_wire) through
    the port's engine, reduced by `config_protocol_frontier` (no sampler
    storm): live JAX's spec_hash and result_digest (path 55's golden;
    every per-seed record is in the digest), lab-ordered's
    violation bands at 0, push-pull's rounds ratio below 1 and its wire
    ratio above 1 on both families."""
    from corrosion_tpu_torch.sim.runner import config_protocol_frontier

    rec = config_protocol_frontier(seed=0, sampler_storm_nodes=0,
                                   device="cpu")
    golden = goldens.PROTOCOL_FRONTIER
    assert (rec["spec_hash"], rec["result_digest"]) == (
        golden["spec_hash"], golden["result_digest"])
    assert rec["converged"] and "sampler_storm" not in rec
    for fam in ("wan-3x2", "flat-lossy"):
        entry = rec["families"][fam]
        assert entry["lab-ordered"]["order_violations_max"] == 0
        assert entry["push-pull"]["rounds_ratio"] < 1
        assert entry["push-pull"]["wire_ratio"] > 1


@pytest.mark.slow
@pytest.mark.parametrize("index", range(8))
def test_frontier_cell_equals_its_pin(index):
    """Cell ``index`` of the committed `protocol-frontier` campaign
    through the port's engine on the CPU (a minute or less each): its
    whole per-seed record is the golden's (path 55's), so the port's
    8-cell artifact digests to live JAX's."""
    spec = spec_mod.builtin_spec("protocol-frontier")
    cell = spec.cells()[index]
    one = dataclasses.replace(spec, grid={k: [v] for k, v in cell.items()})
    art = run_campaign(one, device="cpu")
    assert art["cells"][0]["per_seed"] == goldens.PROTOCOL_FRONTIER[
        "per_seed"][index]
    assert art["cells"][0]["round_path"] == "dense"


def test_frontier_push_pull_equals_its_pin():
    """The frontier's push-pull cells without the recorder (path 59,
    `protocol_frontier_push_pull_spec`: K12p's lossy and tiered lane
    forms without a dropped slot) through the port's engine: live JAX's
    spec_hash (the JAX package's of the same dict) and result_digest,
    each cell's per-seed record the frontier's push-pull cell's less its
    wire_bytes."""
    spec = spec_mod.protocol_frontier_push_pull_spec()
    golden = goldens.PROTOCOL_FRONTIER_PUSH_PULL
    assert JaxSpec.from_dict(spec.to_dict()).spec_hash() == \
        golden["spec_hash"]
    art = run_campaign(spec, device="cpu")
    assert _got(art) == golden
    full = spec_mod.builtin_spec("protocol-frontier").cells()
    for cell in art["cells"]:
        ps = dict(goldens.PROTOCOL_FRONTIER["per_seed"][
            full.index(cell["params"])])
        del ps["wire_bytes"]
        assert cell["per_seed"] == ps
        assert cell["round_path"] == "dense"


def test_frontier_push_pull_golden_matches_live_jax():
    """Path 59's golden from live JAX's engine (about ten seconds)."""
    spec = spec_mod.protocol_frontier_push_pull_spec()
    with jax_telemetry():
        art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                            out_path=None)
    assert _got(art) == goldens.PROTOCOL_FRONTIER_PUSH_PULL


CELLS_1K = {
    "BROADCAST_1K_FANOUT_DECAY_SEEDS8_WIRE":
        lambda: spec_mod.broadcast_proto_seeds_spec("fanout-decay"),
    "BROADCAST_1K_LAB_ORDERED_BROKEN_SEEDS8_WIRE":
        lambda: spec_mod.broadcast_proto_seeds_spec("lab-ordered-broken"),
    "BROADCAST_1K_WAN_3X2_PEERSWAP_FAULT_SEEDS8":
        lambda: spec_mod.broadcast_peerswap_fault_seeds_spec(),
}


@pytest.mark.parametrize("golden", sorted(CELLS_1K))
def test_1k_cell_specs_are_the_goldens(golden):
    """Each 1000-node cell's spec (paths 56-57) has its golden's hash, the
    JAX package's `CampaignSpec` of the same dict the same, and takes the
    dense round."""
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = CELLS_1K[golden]()
    assert spec.spec_hash() == getattr(goldens, golden)["spec_hash"] == \
        JaxSpec.from_dict(spec.to_dict()).spec_hash()
    assert not packed_supported(spec.sim_config({}), spec.topo({}))


def _got(art):
    cells = art["cells"]
    got = {"spec_hash": art["spec_hash"],
           "result_digest": art["result_digest"],
           "rounds": [c["per_seed"]["rounds"] for c in cells]}
    for key in ("wire_bytes", "order_violations"):
        if key in cells[0]["per_seed"]:
            got[key] = [c["per_seed"][key] for c in cells]
    return got


@pytest.mark.slow
@pytest.mark.parametrize("golden", sorted(CELLS_1K))
def test_1k_cell_equals_its_pin(golden):
    """Each 1000-node cell through the port's engine on the CPU (one to
    three minutes each) gives its golden: spec_hash, result_digest, the
    per-seed rounds and, where the golden has them, wire_bytes and
    order_violations; the broken-ordering cell's lane 0 is JAX's solo
    ``config_broadcast_1k`` run (its digest and its 38 violations)."""
    from corrosion_tpu_torch.convert import state_digest

    lanes = {}
    art = run_campaign(CELLS_1K[golden](), device="cpu", lanes_out=lanes)
    assert _got(art) == getattr(goldens, golden)
    if golden == "BROADCAST_1K_LAB_ORDERED_BROKEN_SEEDS8_WIRE":
        solo = goldens.BROADCAST_1K_LAB_ORDERED_BROKEN_SEED0
        lane0 = lane_state(lanes[0]["finals"], 0)
        assert (state_digest(lane0), int(lane0.t),
                int(lanes[0]["metrics"].order_violations[0])) == (
            solo["digest"], solo["rounds"], solo["order_violations"])


@pytest.mark.slow
@pytest.mark.parametrize("golden", ("PROTOCOL_FRONTIER", *sorted(CELLS_1K)))
def test_frontier_and_1k_goldens_match_live_jax(golden):
    """Paths 55-57's goldens from live JAX's engine, one case a cell
    under the 300 s watchdog: the frontier campaign (its per-seed
    records whole; ~40 s) and each 1000-node cell (15-160 s)."""
    spec = (spec_mod.builtin_spec("protocol-frontier")
            if golden == "PROTOCOL_FRONTIER" else CELLS_1K[golden]())
    with jax_telemetry():
        art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                            out_path=None)
    if golden == "PROTOCOL_FRONTIER":
        assert [c["per_seed"] for c in art["cells"]] == \
            goldens.PROTOCOL_FRONTIER["per_seed"]
        assert art["result_digest"] == goldens.PROTOCOL_FRONTIER[
            "result_digest"]
    else:
        assert _got(art) == getattr(goldens, golden)


# -- the 100k dense push-pull storm (path 58) --------------------------------


def test_push_pull_storm_spec_is_the_golden_cell():
    """``dense_storm_push_pull_seeds_spec`` (path 58) is the storm's
    scenario on the dense round under push-pull over seeds 0-7: the JAX
    package's hash of the same dict, the dense round at 100 000 × 512;
    lane 0 is the packed solo golden's run (the dense == packed
    contract), and the 8-lane result_digest is JAX's ``artifact_digest``
    over the cell the eight one-seed pins make (the construction that
    gives lane 0's one-seed digest)."""
    from corrosion_tpu_torch.sim.state import packed_supported

    spec = spec_mod.dense_storm_push_pull_seeds_spec()
    golden = goldens.DENSE_STORM_PUSH_PULL_100K_SEEDS8
    assert spec.spec_hash() == golden["spec_hash"] == \
        JaxSpec.from_dict(spec.to_dict()).spec_hash()
    cfg, topo = spec.sim_config({}), spec.topo({})
    assert (cfg.n_nodes, cfg.n_payloads, cfg.dissemination) == (
        100_000, 512, "push-pull")
    assert not packed_supported(cfg, topo)
    solo = goldens.STORM_PUSH_PULL_100K_SEED0
    lane0 = golden["lanes"][0]
    assert (lane0["rounds"], lane0["p99_node_convergence_round"],
            lane0["digest"]) == (solo["rounds"],
                                 solo["p99_node_convergence_round"],
                                 solo["digest"])
    assert artifact_digest([_cell_of(golden["lanes"], 100_000)]) == golden[
        "result_digest"]
    assert artifact_digest([_cell_of(golden["lanes"][:1], 100_000)]) == \
        golden["seed0_result_digest"]
    assert golden["rounds"] == [[lane["rounds"] for lane in golden["lanes"]]]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_push_pull_storm_100k_lane_matches_live_jax(seed):
    """Lane ``seed`` of ``DENSE_STORM_PUSH_PULL_100K_SEEDS8`` (path 58)
    from live JAX's one-seed run_campaign of the cell (100 000 × 512 on
    the dense round under push-pull, about eighty seconds on the CPU);
    seed 0's artifact digest is the golden's seed0_result_digest."""
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["finals"] = out[0]
        return out

    spec = spec_mod.dense_storm_push_pull_seeds_spec(seeds=(seed,))
    jens.run_seed_ensemble = keeping
    try:
        with jax_telemetry():
            art = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                                out_path=None)
    finally:
        jens.run_seed_ensemble = orig
    ps = art["cells"][0]["per_seed"]
    lane = {"seed": seed, "rounds": ps["rounds"][0],
            "p99_node_convergence_round": ps["p99_node_convergence_round"][0],
            "converged": ps["converged"][0],
            "unconverged_nodes": ps["unconverged_nodes"][0],
            "digest": jax_digest(jax.tree.map(lambda x: x[0],
                                              kept["finals"]))}
    golden = goldens.DENSE_STORM_PUSH_PULL_100K_SEEDS8
    assert lane == golden["lanes"][seed]
    if seed == 0:
        assert art["result_digest"] == golden["seed0_result_digest"]


# -- the refusals that stay --------------------------------------------------


def test_dense_lanes_take_every_family_and_knob():
    """The dense check accepts all six families and every combination of
    the five protocol knobs, with or without a plan, under either
    sampler."""
    from itertools import product

    from corrosion_tpu_torch.faults import FaultPlan
    from corrosion_tpu_torch.proto.families import FAMILIES

    plan = FaultPlan(n_nodes=96, seed=0, events=())
    for family in FAMILIES:
        cfg = _cfgs(proto_family=family)[2]
        check_dense_lanes(cfg, ptp.Topology(), plan)
    for dis, sched, cad, order in product(
            ("push", "push-pull"), ("flat", "decay"), ("periodic", "eager"),
            ("none", "fifo", "fifo-unchecked")):
        cfg = _cfgs(dissemination=dis, fanout_schedule=sched,
                    fanout_decay_rounds=4, sync_cadence=cad, ordering=order,
                    peer_sampler="peerswap")[2]
        check_dense_lanes(cfg, ptp.Topology(), plan)


@pytest.mark.parametrize("knob", ("dissemination", "fanout_schedule",
                                  "sync_cadence", "ordering"))
def test_packed_lanes_refuse_the_protocol_variants_naming_b16m(knob):
    """Each protocol knob off the legacy point, which the packed round's
    lanes refused naming B16m until its rest was ported, now runs there:
    the check accepts it, and a one-seed cell at 1280 nodes through the
    port's engine on the packed round equals live JAX's artifact (its
    order count too on the ordering cell)."""
    value = {"dissemination": "push-pull", "fanout_schedule": "decay",
             "sync_cadence": "eager", "ordering": "fifo"}[knob]
    jspec, spec = spec_pair("p", dict(spec_mod.storm_scenario(1280),
                                      n_payloads=128, packed_min_cells=0,
                                      **{knob: value}), (0,))
    check_packed_lanes(spec.sim_config({}), ptp.Topology())
    want = jrun_campaign(jspec, out_path=None)
    got = run_campaign(spec, device="cpu")
    assert got["result_digest"] == want["result_digest"]
    assert got["cells"][0]["per_seed"] == want["cells"][0]["per_seed"]
    assert got["cells"][0]["round_path"] == "packed"


@pytest.mark.parametrize("key", ("proto_family", "ordering"))
def test_detect_cell_protocol_keys_are_jaxs_value_error(key):
    """A protocol key on a detect cell raises JAX's ValueError, word for
    word, before anything runs."""
    from corrosion_tpu.campaign.engine import run_campaign as jrun

    spec = spec_mod.swim_churn_64_spec(seeds=(0,))
    value = "push-pull" if key == "proto_family" else "fifo"
    spec = dataclasses.replace(spec, scenario=dict(spec.scenario,
                                                   **{key: value}))
    with pytest.raises(ValueError) as want:
        jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None)
    with pytest.raises(ValueError) as got:
        run_campaign(spec, device="cpu")
    assert str(got.value) == str(want.value)
