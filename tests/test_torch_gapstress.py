"""The gapstress storm (config #5b) in the port against the JAX reference.

Gapstress runs the packed round with both byte budgets binding, the flat
30 % wire loss on every round and 128 versions per writer over K = 8 gap
slots.  Inputs are made from numpy seeds and handed to both packages;
everything is compared exactly:

- (a) the word byte budget (`budget_prefix_words`, K16's plain version)
  against JAX's word form, the two-lane branch at P = 65 536 included;
- (b) one broadcast under Topology(loss=0.3), alone and composed with a
  factored fault plan's loss, from mid-run JAX states;
- (c) the gap refresh past 32 versions against JAX's group_grid →
  version_heads → extract_gaps;
- (d) the gapstress class round by round against JAX's packed round, at
  JAX's own lockstep shape (tests/sim/test_packed_equivalence.py
  test_metered_lossy_gapstress_class) and at a V = 64 variant, plus the
  class under a fault plan to the end;
- (e) `config_write_storm_gapstress` and `config_gapstress_distortion`
  at 64 nodes, record for record (the wall clock aside).

``-m slow`` adds the port's CPU run of the bench's CPU rung (4096
nodes, seed 1) against its golden, and the golden against live JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.faults import FaultEvent as JaxFaultEvent
from corrosion_tpu.faults import FaultPlan as JaxFaultPlan
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import gaps as jgaps
from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim.round import new_metrics as jax_new_metrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.round import run_to_convergence as jax_run
from corrosion_tpu.sim.state import SimConfig as JaxSimConfig
from corrosion_tpu.sim.state import uniform_payloads as jax_uniform_payloads
from corrosion_tpu.sim.state import version_heads as jax_version_heads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
from corrosion_tpu_torch.sim import faults, gaps, packed, runner
from corrosion_tpu_torch.sim.round import new_metrics, new_sim
from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import (
    assert_fields_equal,
    assert_metrics_equal,
    fields,
    jax_digest,
    port_fields,
    to_port,
)

# JAX's lockstep gapstress class: 16 versions x 4 writers x 4 chunks over
# K = 4, binding 32 KiB / 24 KiB budgets; and its V = 64 variant
SHAPES = {
    "lockstep24": (24, 29, dict(n_payloads=256, n_writers=4,
                                chunks_per_version=4, n_delay_slots=2)),
    "v64": (64, 3, dict(n_payloads=512, n_writers=4, chunks_per_version=2)),
}
COMMON = dict(gap_slots=4, fanout=2, sync_interval_rounds=3,
              swim_partial_view=True, member_slots=8,
              rate_limit_bytes_round=32 * 1024, sync_budget_bytes=24 * 1024,
              packed_min_cells=0)
LOSS = 0.3


def _configs(name):
    """(n, seed, jax cfg, jax meta, port cfg, port meta) of a shape."""
    n, seed, kw = SHAPES[name]
    jcfg = JaxSimConfig.wan_tuned(n, **COMMON, **kw)
    pcfg = SimConfig.wan_tuned(n, **COMMON, **kw)
    sizes = jrunner.gapstress_payload_sizes(jcfg.n_payloads)
    np.testing.assert_array_equal(
        sizes, runner.gapstress_payload_sizes(pcfg.n_payloads))
    jmeta = jax_uniform_payloads(jcfg, inject_every=0, payload_bytes=sizes)
    pmeta = uniform_payloads(pcfg, "cpu", inject_every=0, payload_bytes=sizes)
    assert jpacked.packed_supported(jcfg, JaxTopology(loss=LOSS))
    return n, seed, jcfg, jmeta, pcfg, pmeta


def _u32_to_i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _port_carry(jc):
    """A JAX packed carry in the port's layout (the u8 ring as words)."""
    return packed.PackedCarry(
        have=_u32_to_i32(jc.have),
        inflight=packed.pack_bits(torch.from_numpy(np.array(jc.inflight))),
        relay=packed.Planes(*(_u32_to_i32(p) for p in jc.relay)),
        sync_buf=_u32_to_i32(jc.sync_buf),
    )


def _assert_carry_equal(jc, pc, p, label):
    want = {"have": np.asarray(jc.have), "inflight": np.asarray(jc.inflight),
            "sync_buf": np.asarray(jc.sync_buf)}
    got = {"have": pc.have.numpy().view(np.uint32),
           "inflight": packed.unpack_bits(pc.inflight, p).numpy()
           .astype(np.uint8),
           "sync_buf": pc.sync_buf.numpy().view(np.uint32)}
    for k in range(4):
        want[f"r{k}"] = np.asarray(jc.relay[k])
        got[f"r{k}"] = pc.relay[k].numpy().view(np.uint32)
    assert_fields_equal(want, got, label)


# -- (a) the word byte budget -------------------------------------------------


@pytest.mark.parametrize("p, budget", (
    (256, None), (256, 1), (256, 17_000), (1024, 300_000),
    (8192, 5 * 1024 * 1024), (8192, 4 * 1024 * 1024), (8192, 0),
    (65536, 9_000_000),  # 65 536 > 32 767: JAX's two-lane branch
))
def test_budget_prefix_words_matches_jax(p, budget):
    g = np.random.default_rng(p + (budget or 0) % 1000)
    sizes = jrunner.gapstress_payload_sizes(p)
    mask = g.random((9, p)) < 0.6
    mask[4] = False  # a row with no bits
    words = np.asarray(jpacked.pack_bits(jnp.asarray(mask)))
    want = jpacked.budget_prefix_words(jnp.asarray(words), budget,
                                       jnp.asarray(sizes, jnp.int32))
    port_words = torch.from_numpy(words.view(np.int32).copy())
    got = packed.budget_prefix_words(port_words, budget,
                                     torch.from_numpy(sizes))
    np.testing.assert_array_equal(np.asarray(want),
                                  got.numpy().view(np.uint32))
    if budget not in (None, 0):
        assert (np.asarray(want) != words).any()  # the budget binds


# -- (b) one broadcast under the flat loss, alone and with a fault plan -------


def _jax_mid_run(jcfg, jmeta, seed, rounds):
    """The JAX packed loop's (slim, carry, injected) after ``rounds``."""
    state = jax_new_sim(jcfg, seed)
    carry = jpacked.pack_state(state, jcfg)
    inj = jpacked.pack_bits(state.injected)
    slim = jpacked.shrink_state(state)
    metrics = jax_new_metrics(jcfg)
    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    n = jcfg.n_nodes
    for _ in range(rounds):
        slim, carry, inj, metrics = step(
            slim, carry, inj, metrics, jmeta, jcfg, JaxTopology(loss=LOSS),
            jax_regions(n, 1))
    return slim, carry, inj


def _fault_plans(n, seed):
    """The same loss burst and one-way cut as a JAX and a port plan."""
    events = dict(loss=dict(kind="loss", start=0, end=18, p=0.25),
                  cut=dict(kind="partition", start=0, end=12, src="0:8",
                           dst=f"8:{n}"))
    return (JaxFaultPlan(n_nodes=n, seed=seed, events=tuple(
                JaxFaultEvent(**kw) for kw in events.values())),
            FaultPlan(n_nodes=n, seed=seed, events=tuple(
                FaultEvent(**kw) for kw in events.values())))


@pytest.mark.parametrize("with_faults", (False, True))
@pytest.mark.parametrize("rounds", (2, 5))
def test_broadcast_packed_lossy_matches_jax(with_faults, rounds):
    n, seed, jcfg, jmeta, pcfg, pmeta = _configs("lockstep24")
    slim, jc, inj = _jax_mid_run(jcfg, jmeta, seed, rounds)
    jtopo, ptopo = JaxTopology(loss=LOSS), Topology(loss=LOSS)
    jrf = prf = None
    if with_faults:
        jplan, pplan = _fault_plans(n, 11)
        jrf = jfaults.round_faults(
            jfaults.compile_plan(jplan, jcfg, jtopo, factored=True), rounds)
        prf = faults.round_faults(
            faults.compile_plan(pplan, pcfg, ptopo, factored=True,
                                device="cpu"), rounds)
    key = jax.random.PRNGKey(100 + rounds)
    jout = jax.jit(jpacked.broadcast_packed, static_argnums=(3, 4))(
        jc, inj, slim, jcfg, jtopo, jax_regions(n, 1), key, jmeta, jrf)
    full = jpacked.unpack_into_state(jc, slim, jcfg)
    pout = packed.broadcast_packed(
        _port_carry(jc), _u32_to_i32(inj), to_port(full, pcfg), pcfg, ptopo,
        regions(n, 1, "cpu"), torch.from_numpy(np.asarray(key).astype(
            np.int64)), pmeta, prf)
    _assert_carry_equal(jout, pout, jcfg.n_payloads, "broadcast")
    assert (np.asarray(jout.inflight) != np.asarray(jc.inflight)).any()


# -- (c) gaps past 32 versions ------------------------------------------------


@pytest.mark.parametrize("v", (64, 96, 128))
@pytest.mark.parametrize("k, p_bit", ((2, 0.3), (8, 0.06)))
def test_refresh_gaps_wide_matches_jax(v, k, p_bit):
    a, c, n = 4, 8, 200
    cfg_kw = dict(n_nodes=n, n_payloads=a * v * c, n_writers=a,
                  chunks_per_version=c, gap_slots=k)
    jcfg, pcfg = JaxSimConfig(**cfg_kw), SimConfig(**cfg_kw)
    g = np.random.default_rng(v + k)
    bits = g.random((n, a * v * c)) < p_bit
    bits[::17] = False  # empty rows
    words = np.asarray(jpacked.pack_bits(jnp.asarray(bits)))
    touched = jpacked.group_grid(jnp.asarray(words), jcfg, "any")
    heads = jax_version_heads(touched)
    gp = jgaps.extract_gaps(touched, heads, jcfg)
    got = gaps.refresh_gaps(torch.from_numpy(words.view(np.int32).copy()),
                            pcfg)
    assert_fields_equal(
        {"heads": np.asarray(heads), "lo": np.asarray(gp.lo),
         "hi": np.asarray(gp.hi),
         "overflow": np.asarray(gp.overflow.sum(dtype=jnp.int32))},
        {"heads": got[0].numpy(), "lo": got[1].numpy(), "hi": got[2].numpy(),
         "overflow": got[3].numpy()},
        f"refresh_gaps v={v} k={k}")
    assert int(got[3]) > 0  # rows with more than K runs


# -- (d) the gapstress class round by round -----------------------------------


@pytest.mark.parametrize("name", tuple(SHAPES))
def test_gapstress_class_round_by_round(name):
    """Step JAX's jitted packed_round_step and the port side by side
    under both budgets and the loss; a failure names the first diverging
    round and field."""
    n, seed, jcfg, jmeta, pcfg, pmeta = _configs(name)
    jtopo, ptopo = JaxTopology(loss=LOSS), Topology(loss=LOSS)
    jstate, pstate = jax_new_sim(jcfg, seed), new_sim(pcfg, seed, "cpu")
    jcarry = jpacked.pack_state(jstate, jcfg)
    pcarry = packed.pack_state(pstate, pcfg)
    jinj = jpacked.pack_bits(jstate.injected)
    pinj = packed.pack_bits(pstate.injected)
    jslim, pslim = jpacked.shrink_state(jstate), packed.shrink_state(pstate)
    jmet, pmet = jax_new_metrics(jcfg), new_metrics(pcfg, "cpu")
    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    jregion, pregion = jax_regions(n, 1), regions(n, 1, "cpu")
    for r in range(200):
        jslim, jcarry, jinj, jmet = step(
            jslim, jcarry, jinj, jmet, jmeta, jcfg, jtopo, jregion)
        pslim, pcarry, pinj, pmet, pdone = packed.packed_round_step(
            pslim, pcarry, pinj, pmet, pmeta, pcfg, ptopo, pregion)
        label = f"{name} round {r}"
        assert_fields_equal(fields(jslim), port_fields(pslim), label)
        _assert_carry_equal(jcarry, pcarry, jcfg.n_payloads, label)
        np.testing.assert_array_equal(
            np.asarray(jinj), pinj.numpy().view(np.uint32), err_msg=label)
        assert_metrics_equal(jmet, pmet, label)
        jdone = bool(jpacked._converged_done(jslim, jmet, jmeta))
        assert jdone == bool(pdone), f"{label}: the round's done flag"
        if jdone:
            break
    assert jdone
    final_j = jpacked.unpack_into_state(jcarry, jslim, jcfg)
    final_p = packed.unpack_into_state(pcarry, pslim, pcfg)
    assert jax_digest(final_j) == state_digest(final_p)


def test_gapstress_class_under_fault_plan_matches_jax():
    """The class composed with a factored plan's loss burst and cut, the
    flat loss beside it, through run_fault_plan to the end."""
    n, seed, jcfg, jmeta, pcfg, pmeta = _configs("lockstep24")
    jtopo, ptopo = JaxTopology(loss=0.2), Topology(loss=0.2)
    jplan, pplan = _fault_plans(n, 17)
    jfinal, jmet = jfaults.run_fault_plan(
        jax_new_sim(jcfg, seed), jmeta, jcfg, jtopo,
        jfaults.compile_plan(jplan, jcfg, jtopo, factored=True), 400)
    pfinal, pmet = faults.run_fault_plan(
        new_sim(pcfg, seed, "cpu"), pmeta, pcfg, ptopo,
        faults.compile_plan(pplan, pcfg, ptopo, factored=True, device="cpu"),
        400)
    assert_fields_equal(fields(jfinal), port_fields(pfinal), "final")
    assert_metrics_equal(jmet, pmet, "metrics")


# -- (e) the runner's configs -------------------------------------------------

_WALL = ("wall_clock_s", "rounds_per_sec", "node_rounds_per_sec")


def _record(out):
    return {k: v for k, v in out.items()
            if k not in _WALL and k not in ("state", "metrics")}


def test_config_write_storm_gapstress_matches_jax():
    want = jrunner.config_write_storm_gapstress(seed=1, n_nodes=64)
    got = runner.config_write_storm_gapstress(seed=1, n_nodes=64,
                                              device="cpu")
    assert _record(got) == _record(want)


def test_config_gapstress_distortion_matches_jax():
    want = jrunner.config_gapstress_distortion(seed=0, n_nodes=64)
    got = runner.config_gapstress_distortion(seed=0, n_nodes=64,
                                             device="cpu")
    for run in ("stressed", "control"):
        assert _record(got[run]) == _record(want[run]), run
    for key in want:
        if key not in ("stressed", "control"):
            assert got[key] == want[key], key


# -- the bench's CPU rung -----------------------------------------------------


@pytest.mark.slow
def test_gapstress_4096_matches_golden():
    out = runner.config_write_storm_gapstress(seed=1, n_nodes=4096,
                                              device="cpu", return_state=True)
    golden = goldens.GAPSTRESS_4096_SEED1
    assert out["round_path"] == "packed"
    assert {k: state_digest(out["state"]) if k == "digest" else out[k]
            for k in golden} == golden


@pytest.mark.slow
def test_gapstress_4096_golden_matches_live_jax():
    cfg = jrunner._gapstress_cfg(4096, 8)
    meta = jax_uniform_payloads(
        cfg, inject_every=0,
        payload_bytes=jrunner.gapstress_payload_sizes(cfg.n_payloads))
    final, metrics = jax_run(jax_new_sim(cfg, 1), meta, cfg,
                             JaxTopology(loss=LOSS), 4000)
    cov, inj = np.asarray(metrics.coverage_at), np.asarray(meta.round)
    assert goldens.GAPSTRESS_4096_SEED1 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": jrunner._percentile(
            np.asarray(metrics.converged_at), 99),
        "p99_payload_latency_rounds": jrunner._percentile(
            np.where(cov >= 0, cov - inj, -1), 99),
        "gap_overflow_frac_max": float(metrics.overflow_frac),
        "digest": jax_digest(final),
    }
