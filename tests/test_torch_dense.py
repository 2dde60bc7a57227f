"""The port's dense round (corrosion_tpu_torch/sim/broadcast.py, sync.py,
gaps.py, round.py) against the live JAX reference, exact: every field in
JAX's dtypes with assert_array_equal (overflow_frac too: one f32 mean on
both sides).

Each phase on its own from mid-run JAX states (inject, broadcast,
deliver, sync's edge needs and step, the gap extraction at V = 32 — JAX's
word branch — and V = 64, the byte budget with its two-lane branch, the
bookkeeping record K14 replaces), the flat loss and its draws; then
whole runs round by round at the configurations of tests/sim/test_topo.py
(dense, seed 3, P = 16; the packed round with the uniform sampler, seed
5) against the live JAX digests — not the constants pinned there, which
jax 0.9.0 no longer reproduces — and the runner's configs: the 3-node
ground truth, broadcast-1k, partition-heal at 512 nodes (``-m slow``:
at 10 000, against the golden chip_smoke.py holds the card to).  The
full-view configurations are in tests/test_torch_swim_full.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import broadcast as jbc
from corrosion_tpu.sim import gaps as jgaps
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import sync as jsync
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import meta_from_numpy, state_digest
from corrosion_tpu_torch.sim import broadcast, gaps, rng, runner, swim, sync
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import topology as ptopo
from tests.torch_parity import (
    assert_metrics_equal,
    assert_states_equal,
    fields,
    jax_digest,
    port_config,
    to_port,
)

# (SimConfig kwargs, Topology kwargs, seed): test_topo.py:71-78's dense
# run; a metered two-region ground-truth run whose byte budgets bind,
# with three chunks per version
DENSE3 = (dict(n_nodes=24, n_payloads=16, fanout=2, sync_interval_rounds=4),
          {}, 3)
METERED = (dict(n_nodes=40, n_payloads=24, n_writers=2, chunks_per_version=3,
                fanout=3, rate_limit_bytes_round=5 * 8192,
                sync_budget_bytes=4 * 8192, n_delay_slots=3),
           dict(n_regions=2, inter_delay=2), 11)
LOSSY9 = (dict(n_nodes=24, n_payloads=16, fanout=2, n_delay_slots=4,
               swim_full_view=True),
          dict(n_regions=2, inter_delay=2, loss=0.2), 9)
CASES = {"dense3": DENSE3, "metered": METERED, "lossy9": LOSSY9}


def pair(cfg_kw, topo_kw, inject_every=1):
    """(jax cfg, meta, topo, region; port cfg, meta, topo, region)."""
    jcfg = jstate.SimConfig(**cfg_kw)
    pcfg = pstate.SimConfig(**cfg_kw)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=inject_every)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jt, pt = jtopo.Topology(**topo_kw), ptopo.Topology(**topo_kw)
    n = cfg_kw["n_nodes"]
    return (jcfg, jmeta, jt, jtopo.regions(n, jt.n_regions),
            pcfg, pmeta, pt, ptopo.regions(n, pt.n_regions, "cpu"))


def jax_rounds(jcfg, jmeta, jt, jreg, state, rounds):
    step = jax.jit(lambda s, m: jround.round_step(s, m, jmeta, jcfg, jt, jreg))
    metrics = jround.new_metrics(jcfg)
    for _ in range(rounds):
        state, metrics = step(state, metrics)
    return state, metrics


# -- pieces ------------------------------------------------------------------


def test_grid_views_match_jax():
    g = np.random.default_rng(0)
    kw = dict(n_nodes=9, n_payloads=36, n_writers=3, chunks_per_version=3)
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    have = (g.random((9, 36)) < 0.6).astype(np.uint8)
    inj = (g.random(36) < 0.5).astype(np.uint8)
    av = g.random((9, 3, 4)) < 0.5
    for name in ("chunk_grid", "complete_versions", "touched_versions"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jstate, name)(jnp.asarray(have), jcfg)),
            getattr(pstate, name)(torch.as_tensor(have), pcfg).numpy(),
            err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(jstate.grid_to_payload(jnp.asarray(av), jcfg)),
        pstate.grid_to_payload(torch.as_tensor(av), pcfg).numpy())
    np.testing.assert_array_equal(
        np.asarray(jstate.version_active(jnp.asarray(inj), jcfg)),
        pstate.version_active(torch.as_tensor(inj), pcfg).numpy())


@pytest.mark.parametrize("p", (16, 200, 256, 40_000))
def test_budget_prefix_mask_matches_jax(p):
    """Both of JAX's sums: i32 up to 32 767 payloads (blocked when P is a
    multiple of 64), two exact lanes past it."""
    g = np.random.default_rng(p)
    rows = 3 if p > 1000 else 8
    mask = g.random((rows, p)) < 0.6
    nbytes = np.where(g.random(p) < 0.1, 65536,
                      g.integers(1, 65537, p)).astype(np.int32)
    total = int(nbytes.sum())
    for budget in (None, 0, 500, 3 * 8192, total // 3, 2 * total):
        want = jstate.budget_prefix_mask(jnp.asarray(mask), budget,
                                         jnp.asarray(nbytes))
        got = pstate.budget_prefix_mask(torch.as_tensor(mask), budget,
                                        torch.as_tensor(nbytes))
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=f"budget {budget}")
    x = g.integers(0, 65537, (rows, p)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jstate._cumsum_last(jnp.asarray(x))),
        pstate._cumsum_last(torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("seed", (0, 5))
@pytest.mark.parametrize("shape", ((7,), (300,), (12, 33)))
def test_uniform_and_bernoulli_match_jax(seed, shape):
    key, pkey = jax.random.PRNGKey(seed), rng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, shape)),
        rng.uniform(pkey, shape).numpy())
    for p in (1e-9, 0.2, 0.5, 0.999):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(key, p, shape)),
            rng.bernoulli(pkey, p, shape).numpy(), err_msg=f"p={p}")


@pytest.mark.parametrize("loss", (0.0, 0.001, 0.2, 0.999, 1.0))
def test_edge_payload_drop_flat_matches_jax(loss):
    """Thresholds 0 (no draw), 51 and the certainty pin 256."""
    key = jax.random.PRNGKey(4)
    want = jtopo.edge_payload_drop(jtopo.Topology(loss=loss), key, 50, 16)
    got = ptopo.edge_payload_drop(ptopo.Topology(loss=loss),
                                  rng.prng_key(4, "cpu"), 50, 16)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_tiered_loss_and_scenario_axes_refuse():
    """Tiered loss, the PeerSwap sampler and the protocol axis, which all
    refused here before their axes were ported, now equal JAX: the tiered
    wire draw, the PeerSwap initial state, each of the four protocol
    knobs' configurations field for field, and the runner's
    ``proto_family`` overlay on both entry points' configs
    (tests/test_torch_topology_tiers.py, test_torch_peerswap.py and
    test_torch_proto*.py hold the rest of the axes)."""
    topo_kw = dict(n_regions=2, loss=0.1, inter_loss=0.3)
    src = np.repeat(np.arange(40), 3).astype(np.int32)
    dst = np.random.default_rng(0).integers(0, 40, 120).astype(np.int32)
    want = jtopo.edge_payload_drop(
        jtopo.Topology(**topo_kw), jax.random.PRNGKey(4), 120, 16,
        src=jnp.asarray(src), dst=jnp.asarray(dst),
        region=jtopo.regions(40, 2))
    got = ptopo.edge_payload_drop(
        ptopo.Topology(**topo_kw), rng.prng_key(4, "cpu"), 120, 16,
        src=torch.as_tensor(src), dst=torch.as_tensor(dst),
        region=ptopo.regions(40, 2, "cpu"))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    jcfg = jstate.SimConfig(n_nodes=4, n_payloads=4, peer_sampler="peerswap")
    pcfg = pstate.SimConfig(n_nodes=4, n_payloads=4, peer_sampler="peerswap")
    assert_states_equal(jstate.init_state(jcfg, jax.random.PRNGKey(2)),
                        pstate.init_state(pcfg, rng.prng_key(2, "cpu")),
                        "peerswap init")
    for name, value in (("dissemination", "push-pull"),
                        ("fanout_schedule", "decay"),
                        ("sync_cadence", "eager"), ("ordering", "fifo")):
        kw = dict(n_nodes=4, n_payloads=4, **{name: value})
        assert pstate.SimConfig(**kw) == port_config(jstate.SimConfig(**kw))
    from corrosion_tpu.sim import runner as jrunner

    for family in ("push-pull", "lab-ordered"):
        assert runner._resolve_proto(family) == jrunner._resolve_proto(family)
        jcfg, _ = jrunner._write_storm(64, 128, proto_family=family)
        pcfg, _ = runner._write_storm(64, 128, "cpu", proto_family=family)
        assert pcfg == port_config(jcfg)


def test_fault_plan_under_peerswap_refuses():
    """A fault plan under the PeerSwap sampler is no longer refused: K11
    now empties a wiped node's view row on the card, as JAX's
    crash-with-wipe does (``faults.py:742-745``), so `run_fault_plan` and
    the checked driver run it on both devices — to JAX's final state and
    metrics, the view included, with the wiped node's row empty at its
    restart."""
    from corrosion_tpu import faults as jhost
    from corrosion_tpu.sim import faults as jfaults
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
    from corrosion_tpu_torch.sim import faults as pfaults

    kw = dict(n_nodes=12, n_payloads=8, peer_sampler="peerswap")
    cfg, jcfg = pstate.SimConfig(**kw), jstate.SimConfig(**kw)
    meta, jmeta = pstate.uniform_payloads(cfg, "cpu"), jstate.uniform_payloads(
        jcfg)
    plan = FaultPlan(n_nodes=12, seed=0, events=(
        FaultEvent("crash", 2, 6, node=1, wipe=True),))
    jplan = jhost.FaultPlan(n_nodes=12, seed=0, events=(
        jhost.FaultEvent("crash", 2, 6, node=1, wipe=True),))
    state = pround.new_sim(cfg, 0, "cpu")
    before = state.pview[1].clone()
    restart = pfaults.apply_node_faults(state, pfaults.round_faults(
        pfaults.compile_plan(plan, cfg, device="cpu"), 6))
    assert (before >= 0).any() and (restart.pview[1] == -1).all()
    jstate0 = jround.new_sim(jcfg, 0)
    got = pfaults.run_fault_plan(
        pround.new_sim(cfg, 0, "cpu"), meta, cfg, ptopo.Topology(),
        pfaults.compile_plan(plan, cfg, device="cpu"))
    want = jfaults.run_fault_plan(jstate0, jmeta, jcfg, jtopo.Topology(),
                                  jfaults.compile_plan(jplan, jcfg))
    assert_states_equal(want[0], got[0], "run_fault_plan")
    assert_metrics_equal(want[1], got[1], "run_fault_plan metrics")
    got = pfaults.run_fault_plan_checked(plan, pround.new_sim(cfg, 0, "cpu"),
                                         meta, cfg)
    want = jfaults.run_fault_plan_checked(jplan, jstate0, jmeta, jcfg)
    assert_states_equal(want[0], got[0], "checked driver")
    assert got[2] == want[2]


@pytest.mark.parametrize("v, k", ((32, 8), (32, 2), (64, 8), (64, 3),
                                  (40, 16)))
def test_extract_gaps_matches_jax(v, k):
    """V = 32 takes JAX's word branch, V > 32 its dense one; the port's
    `GapTensors` are the same either way."""
    g = np.random.default_rng(v * k)
    n, a = 50, 3
    touched = g.random((n, a, v)) < 0.5
    touched[0] = False
    touched[1] = True
    kw = dict(n_nodes=n, n_payloads=a * v, n_writers=a, gap_slots=k)
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jt = jnp.asarray(touched)
    want = jgaps.extract_gaps(jt, jstate.version_heads(jt), jcfg)
    pt = torch.as_tensor(touched)
    got = gaps.extract_gaps(pt, pstate.version_heads(pt), pcfg)
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    if k <= 3:
        assert bool(got.overflow.any())


@pytest.mark.parametrize("v", (32, 64))
def test_dense_record_matches_jax(v):
    """K14's function: the round's gaps and converge blocks (JAX's), on
    rows with holes and dead nodes, then complete rows (node stamps and
    the exit flag)."""
    g = np.random.default_rng(v)
    n, a = 60, 4
    kw = dict(n_nodes=n, n_payloads=a * v, n_writers=a)
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    alive = ((g.random(n) < 0.1) * 2).astype(np.uint8)
    conv = np.where(g.random(n) < 0.2, 3, -1).astype(np.int32)
    cov = np.where(g.random(a * v) < 0.2, 2, -1).astype(np.int32)
    for have, t in (((g.random((n, a * v)) < 0.5), 10),
                    (np.ones((n, a * v), bool), v + 2)):
        have = have.astype(np.uint8)
        inj = (np.asarray(jmeta.round) <= t).astype(np.uint8)
        jh = jnp.asarray(have)
        touched = jstate.touched_versions(jh, jcfg)
        heads = jstate.version_heads(touched)
        jg = jgaps.extract_gaps(touched, heads, jcfg)
        up = alive == 0
        comp = np.asarray(jstate.complete_versions(jh, jcfg))
        act = np.asarray(jstate.version_active(jnp.asarray(inj), jcfg))
        vdone = np.all(comp | ~up[:, None, None], axis=0) & act
        pdone = np.asarray(jstate.grid_to_payload(jnp.asarray(vdone), jcfg))
        node_done = np.all(comp | ~act[None], axis=(1, 2)) & up
        rounds = np.asarray(jmeta.round)
        w_conv = np.where((conv < 0) & node_done & np.all(rounds <= t), t,
                          conv)
        want = (np.asarray(heads), np.asarray(jg.lo), np.asarray(jg.hi),
                np.int32(np.asarray(jg.overflow).sum()),
                np.where((cov < 0) & pdone, t, cov).astype(np.int32),
                w_conv.astype(np.int32),
                np.all(rounds <= t + 1) & np.all((w_conv >= 0) | ~up))
        metrics = pround.RunMetrics(
            coverage_at=torch.as_tensor(cov),
            converged_at=torch.as_tensor(conv),
            overflow_frac=torch.zeros(()),
            order_violations=torch.zeros((), dtype=torch.int32))
        got = pround.dense_record(torch.as_tensor(have), torch.as_tensor(inj),
                                  torch.as_tensor(alive), metrics, pmeta, t,
                                  pcfg)
        for i, (w, x) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(w, x.numpy(), err_msg=str(i))


# -- the phases, each from a mid-run JAX state -------------------------------


@pytest.mark.parametrize("case", ("dense3", "metered", "lossy9"))
@pytest.mark.parametrize("rounds", (2, 7))
def test_phases_match_jax(case, rounds):
    """inject → broadcast → sync → deliver → SWIM, compared after each
    phase, on a state JAX ran ``rounds`` rounds: ring0 tiering with its
    belief filter, the flat loss, binding byte budgets and C = 3 chunks
    are all on some case's path."""
    cfg_kw, topo_kw, seed = CASES[case]
    jcfg, jmeta, jt, jreg, pcfg, pmeta, pt, preg = pair(cfg_kw, topo_kw)
    js, _ = jax_rounds(jcfg, jmeta, jt, jreg, jround.new_sim(jcfg, seed),
                       rounds)
    ps = pround.own_state(to_port(js, pcfg))
    kb, ks, kw = (jax.random.PRNGKey(100 + rounds + i) for i in range(3))
    pkb, pks, pkw = (rng.prng_key(100 + rounds + i, "cpu") for i in range(3))

    js = jax.jit(jbc.inject_step, static_argnums=(2,))(js, jmeta, jcfg)
    ps = broadcast.inject_step(ps, pmeta, pcfg)
    assert_states_equal(js, ps, "inject")
    js = jax.jit(jbc.broadcast_step, static_argnums=(2, 3))(
        js, jmeta, jcfg, jt, jreg, kb)
    ps = broadcast.broadcast_step(ps, pmeta, pcfg, pt, preg, pkb)
    assert_states_equal(js, ps, "broadcast")
    js = jax.jit(jsync.sync_step, static_argnums=(2, 3))(
        js, jmeta, jcfg, jt, ks)
    ps = sync.sync_step(ps, pmeta, pcfg, pt, pks)
    assert_states_equal(js, ps, "sync")
    js = jax.jit(jbc.deliver_step, static_argnums=(1,))(js, jcfg)
    ps = broadcast.deliver_step(ps, pcfg)
    assert_states_equal(js, ps, "deliver")
    js = jax.jit(jswim.swim_step, static_argnums=(1, 2))(js, jcfg, jt, kw)
    ps = swim.swim_step(ps, pcfg, pt, pkw)
    assert_states_equal(js, ps, "swim")


@pytest.mark.parametrize("case", ("dense3", "metered"))
def test_edge_needs_and_masks_match_jax(case):
    cfg_kw, topo_kw, seed = CASES[case]
    jcfg, jmeta, jt, jreg, pcfg, pmeta, pt, preg = pair(cfg_kw, topo_kw)
    js, _ = jax_rounds(jcfg, jmeta, jt, jreg, jround.new_sim(jcfg, seed), 6)
    ps = to_port(js, pcfg)
    for w, x in zip(jsync.node_sync_masks(js, jcfg),
                    sync.node_sync_masks(ps, pcfg)):
        np.testing.assert_array_equal(np.asarray(w), x.numpy())
    g = np.random.default_rng(seed)
    n = cfg_kw["n_nodes"]
    src, dst = g.integers(0, n, 300), g.integers(0, n, 300)
    want = jsync.edge_needs(js, jcfg, jnp.asarray(src, jnp.int32),
                            jnp.asarray(dst, jnp.int32))
    got = sync.edge_needs(ps, pcfg, torch.as_tensor(src, dtype=torch.int32),
                          torch.as_tensor(dst, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert bool(got.any())


# -- whole runs --------------------------------------------------------------


@pytest.mark.parametrize("case", ("dense3", "metered"))
def test_round_by_round_matches_live_jax(case):
    """test_topo.py:71-78's dense run (seed 3, P = 16) and the metered
    run: every round's state and metrics, then the run to convergence
    against the live JAX digest."""
    cfg_kw, topo_kw, seed = CASES[case]
    jcfg, jmeta, jt, jreg, pcfg, pmeta, pt, preg = pair(cfg_kw, topo_kw)
    js, ps = jround.new_sim(jcfg, seed), pround.new_sim(pcfg, seed, "cpu")
    assert_states_equal(js, ps, "new_sim")
    step = jax.jit(lambda s, m: jround.round_step(s, m, jmeta, jcfg, jt, jreg))
    jm, pm = jround.new_metrics(jcfg), pround.new_metrics(pcfg, "cpu")
    for r in range(12):
        js, jm = step(js, jm)
        ps, pm = pround.round_step(ps, pm, pmeta, pcfg, pt, preg)
        assert_states_equal(js, ps, f"round {r}")
        assert_metrics_equal(jm, pm, f"round {r}")
    jf, jmf = jround.run_to_convergence(jround.new_sim(jcfg, seed), jmeta,
                                        jcfg, jt, 400)
    pf, pmf = pround.run_to_convergence(pround.new_sim(pcfg, seed, "cpu"),
                                        pmeta, pcfg, pt, 400)
    assert int(pf.t) == int(jf.t)
    assert state_digest(pf) == jax_digest(jf)
    assert_metrics_equal(jmf, pmf, "final")


@pytest.mark.parametrize("topo_kw", ({}, dict(n_regions=2, inter_delay=1)))
def test_packed_uniform_sampler_matches_live_jax(topo_kw):
    """ROADMAP A4's configuration (test_topo.py:81-88): the packed round
    at 64 × 64 with the uniform ground-truth sampler, seed 5, metered
    (the plain word budget on the CPU); and the same over two regions,
    where the packed round takes the dense round's ring0 tiering."""
    kw = dict(n_nodes=64, n_payloads=64, fanout=3)
    jcfg = dataclasses.replace(jstate.SimConfig(**kw), packed_min_cells=0)
    pcfg = dataclasses.replace(pstate.SimConfig(**kw), packed_min_cells=0)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jf, jm = jround.run_to_convergence(jround.new_sim(jcfg, 5), jmeta, jcfg,
                                       jtopo.Topology(**topo_kw), 300)
    pf, pm = pround.run_to_convergence(pround.new_sim(pcfg, 5, "cpu"), pmeta,
                                       pcfg, ptopo.Topology(**topo_kw), 300)
    assert int(pf.t) == int(jf.t)
    assert_states_equal(jf, pf, "final")
    assert_metrics_equal(jm, pm, "final")
    assert state_digest(pf) == jax_digest(jf)


def _jax_final(cfg_kw, inject_every, budgets=False, seed=0):
    jcfg = jstate.SimConfig(**cfg_kw)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=inject_every)
    if budgets:
        jcfg = jstate.optimize_budgets(jcfg, jmeta)
    return jround.run_to_convergence(jround.new_sim(jcfg, seed), jmeta, jcfg,
                                     jtopo.Topology(), 2000)


@pytest.mark.parametrize("name", ("3node", "1k"))
def test_runner_configs_match_live_jax(name):
    """config_ground_truth_3node (metered budgets, V = 64) and
    config_broadcast_1k (V = 32) against JAX's final state, metrics and
    the goldens chip_smoke.py holds the card to."""
    if name == "3node":
        jf, jm = _jax_final(dict(n_nodes=3, n_payloads=64, fanout=2,
                                 sync_interval_rounds=4), 1)
        rec = runner.config_ground_truth_3node(0, device="cpu",
                                               return_state=True)
        golden = goldens.GROUND_TRUTH_3NODE_SEED0
    else:
        jf, jm = _jax_final(dict(n_nodes=1000, n_payloads=256, n_writers=8,
                                 fanout=3, n_delay_slots=4), 2, budgets=True)
        rec = runner.config_broadcast_1k(0, device="cpu", return_state=True)
        golden = goldens.BROADCAST_1K_SEED0
    assert_states_equal(jf, rec["state"], "final")
    assert_metrics_equal(jm, rec["metrics"], "final")
    assert rec["round_path"] == "dense"
    assert rec["converged"]
    live = {"rounds": int(jf.t), "digest": jax_digest(jf),
            "p99_node_convergence_round": _percentile(
                np.asarray(jm.converged_at), 99)}
    assert live == golden
    assert {k: rec[k] for k in ("rounds", "p99_node_convergence_round")} == {
        k: live[k] for k in ("rounds", "p99_node_convergence_round")}
    assert state_digest(rec["state"]) == live["digest"]


def jax_partition_heal(n, partition_rounds, seed=0):
    """JAX ``config_partition_heal_10k``'s body at any size, returning
    its final state and metrics (the runner returns only the record)."""
    jcfg = jstate.SimConfig.wan_tuned(
        n, n_payloads=256, n_writers=4, fanout=3, swim_partial_view=True,
        member_slots=32, n_delay_slots=3)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    jcfg = jstate.optimize_budgets(jcfg, jmeta)
    jt = jtopo.Topology(n_regions=2, inter_delay=2)
    jreg = jtopo.regions(n, 2)
    state = jround.new_sim(jcfg, seed)
    state = state._replace(group=(jnp.arange(n) >= n // 2).astype(jnp.int32))

    @jax.jit
    def run_partitioned(state, metrics):
        return jax.lax.fori_loop(
            0, partition_rounds,
            lambda _, c: jround.round_step(*c, jmeta, jcfg, jt, jreg),
            (state, metrics))

    state, _ = run_partitioned(state, jround.new_metrics(jcfg))
    state = state._replace(group=jnp.zeros((n,), jnp.int32))
    heal_round = int(state.t)
    final, metrics = jround.run_to_convergence(state, jmeta, jcfg, jt, 2000)
    return heal_round, final, metrics


def port_partition_heal(n, partition_rounds, seed=0):
    """The port's side of `jax_partition_heal`: `runner.heal_config` and
    the public `round_step`, then `run_to_convergence`, on the CPU."""
    cfg, meta = runner.heal_config(n, "cpu")
    topo = ptopo.Topology(n_regions=2, inter_delay=2)
    region = ptopo.regions(n, 2, "cpu")
    state = pround.new_sim(cfg, seed, "cpu")
    state = state._replace(group=(torch.arange(n) >= n // 2).to(torch.int32))
    metrics = pround.new_metrics(cfg, "cpu")
    for _ in range(partition_rounds):
        state, metrics = pround.round_step(state, metrics, meta, cfg, topo,
                                           region)
    state = state._replace(group=torch.zeros_like(state.group))
    heal_round = int(state.t)
    final, metrics = pround.run_to_convergence(state, meta, cfg, topo, 2000)
    return heal_round, final, metrics


def _live_heal(n, partition_rounds):
    """JAX's final state and metrics and the record keys they give."""
    heal_round, jf, jm = jax_partition_heal(n, partition_rounds)
    live = {"heal_round": heal_round, "rounds": int(jf.t),
            "rounds_after_heal": int(jf.t) - heal_round,
            "p99_node_convergence_round": _percentile(
                np.asarray(jm.converged_at), 99),
            "digest": jax_digest(jf)}
    return jf, jm, live


def test_partition_heal_512_matches_live_jax():
    """The heal-10k shape at 512 nodes × 256 payloads (V = 64, two
    regions, partial view): 20 partitioned rounds, then heal."""
    jf, jm, live = _live_heal(512, 20)
    heal_round, pf, pm = port_partition_heal(512, 20)
    assert_states_equal(jf, pf, "final")
    assert_metrics_equal(jm, pm, "final")
    assert heal_round == live["heal_round"]
    assert int(pf.t) == live["rounds"]
    assert state_digest(pf) == live["digest"]
    assert bool(((pm.converged_at >= 0) | (pf.alive != pstate.ALIVE)).all())


@pytest.mark.slow
def test_partition_heal_10k_matches_golden_and_live_jax():
    jf, jm, live = _live_heal(10_000, 60)
    rec = runner.config_partition_heal_10k(0, device="cpu",
                                           return_state=True)
    assert_states_equal(jf, rec["state"], "final")
    assert_metrics_equal(jm, rec["metrics"], "final")
    assert {k: rec[k] for k in live if k != "digest"} == {
        k: v for k, v in live.items() if k != "digest"}
    assert state_digest(rec["state"]) == live["digest"]
    assert rec["converged"]
    assert live == goldens.PARTITION_HEAL_10K_SEED0
