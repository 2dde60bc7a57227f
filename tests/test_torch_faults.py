"""The port's fault seam (corrosion_tpu_torch/faults.py, sim/faults.py
and its uses in sim/topology.py, swim.py and packed.py) against the JAX
reference: the compiled factored plan field for field, its round
slices, the per-edge queries (K9's plain versions), the aligned u8
draw, the fault branch of `_reachable`, the node faults (K11's plain
version), K7's fault-loop exit mode, and one faulted packed round.
Everything is integer or boolean and compared exactly: tolerance 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu import faults as jfaults_mod
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim.round import new_metrics as jax_new_metrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_fault_plan
from corrosion_tpu.sim.swim import _reachable as jax_reachable
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import aligned_u8_bits as jax_aligned_u8_bits
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import faults as pfaults_mod
from corrosion_tpu_torch.convert import fault_plan_from_numpy
from corrosion_tpu_torch.sim import faults, packed, rng
from corrosion_tpu_torch.sim.round import RunMetrics, new_metrics
from corrosion_tpu_torch.sim.runner import storm_fault_plan
from corrosion_tpu_torch.sim.swim import _reachable
from corrosion_tpu_torch.sim.topology import Topology, aligned_u8_bits, regions
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    port_fields,
    random_tables,
    storm_configs,
    to_port,
)

N, P = 512, 256
W = P // 32


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, P)


def _overlap_events(mod):
    """Two overlapping loss events (their composite factor carries the
    merged threshold), a one-way partition, a range-selector crash with
    a wipe and a single-node crash without one."""
    ev = mod.FaultEvent
    return (
        ev("loss", 0, 10, p=0.2),
        ev("loss", 5, 15, src="0:300", dst="100:512", p=0.3),
        ev("partition", 3, 9, src="0:256", dst="256:512"),
        ev("crash", 4, 12, node="10:50", wipe=True),
        ev("crash", 6, 8, node=300),
    )


PLANS = {
    "storm": lambda mod, n: (
        jax_storm_fault_plan(n, 7) if mod is jfaults_mod
        else storm_fault_plan(n, 7)
    ),
    "overlap": lambda mod, n: mod.FaultPlan(
        n_nodes=n, seed=11, events=_overlap_events(mod)
    ),
}


def _plans(name, cfgs):
    jcfg, _, pcfg, _ = cfgs
    jplan = PLANS[name](jfaults_mod, N)
    pplan = PLANS[name](pfaults_mod, N)
    assert jplan.horizon == pplan.horizon
    jf = jfaults.compile_plan(jplan, jcfg, JaxTopology(), factored=True)
    pf = faults.compile_plan(pplan, pcfg, Topology(), factored=True,
                             device="cpu")
    return jf, pf


@pytest.mark.parametrize("name", sorted(PLANS))
def test_compile_plan_matches_jax(cfgs, name):
    jf, pf = _plans(name, cfgs)
    want = fields(jf)
    assert_fields_equal(want, fields(pf), f"compile_plan[{name}]")
    assert_fields_equal(
        want, fields(fault_plan_from_numpy(want, "cpu")), "from_numpy"
    )
    assert pf.horizon == jf.alive.shape[0] - 1
    if name == "overlap":  # the composite of the two losses is a factor
        assert pf.loss_thr.tolist() == [51, 77, 113]


def test_compile_plan_matrix_form_is_not_ported(cfgs):
    """The matrix form is ported now (tests/test_torch_matrix_faults.py
    holds it against JAX's): ``factored=False`` and ``None`` (below 1024
    nodes) compile a `SimFaultPlan` whose slabs give the factored form's
    per-edge answers at every edge of every round (the threshold off cut
    edges), as JAX pins the two forms equal."""
    _, _, pcfg, _ = cfgs
    plan = storm_fault_plan(N, 7)
    fac = faults.compile_plan(plan, pcfg, Topology(), factored=True,
                              device="cpu")
    for factored in (False, None):  # None picks the matrix form below 1024
        mat = faults.compile_plan(plan, pcfg, Topology(), factored=factored,
                                  device="cpu")
        assert isinstance(mat, faults.SimFaultPlan)
        assert mat.block.shape == (mat.horizon + 1, N, N)
        assert torch.equal(mat.alive, fac.alive)
        assert torch.equal(mat.wipe, fac.wipe) and int(mat.seed) == int(
            fac.seed)
    src = torch.arange(N, dtype=torch.int32).repeat_interleave(N)
    dst = torch.arange(N, dtype=torch.int32).repeat(N)
    for t in (0, 5, 21, 40):
        rm, rf = faults.round_faults(mat, t), faults.round_faults(fac, t)
        cut = faults.fault_edge_block(rm, src, dst)
        assert torch.equal(cut, faults.fault_edge_block(rf, src, dst))
        assert torch.equal(faults.fault_edge_loss(rm, src, dst)[~cut],
                           faults.fault_edge_loss(rf, src, dst)[~cut])


def test_derive_seed_and_selectors_match_jax():
    for seed in (0, 7, 2**40 + 3):
        assert pfaults_mod.derive_seed(seed, "sim") == \
            jfaults_mod.derive_seed(seed, "sim")
    for sel in (3, "*", "10:50"):
        assert pfaults_mod.sel_indices(sel, 100) == \
            jfaults_mod.sel_indices(sel, 100)
    with pytest.raises(ValueError):
        pfaults_mod.FaultEvent("crash", 3, 5)  # no node
    with pytest.raises(ValueError):
        pfaults_mod.FaultPlan(n_nodes=10, seed=0, events=(
            pfaults_mod.FaultEvent("loss", 0, 2, src="5:12", p=0.1),))


@pytest.mark.parametrize("t", (0, 5, 21, 40))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_round_faults_match_jax(cfgs, name, t):
    jf, pf = _plans(name, cfgs)
    assert_fields_equal(
        fields(jfaults.round_faults(jf, jnp.int32(t))),
        fields(faults.round_faults(pf, t)), f"round_faults[{name}] t={t}",
    )


def _edges(g, e):
    """Random edges with self-edges and both sides of the half split."""
    src = g.integers(0, N, e).astype(np.int32)
    dst = g.integers(0, N, e).astype(np.int32)
    self_edge = g.random(e) < 0.1
    dst[self_edge] = src[self_edge]
    return src, dst


@pytest.mark.parametrize("t", (0, 5, 7, 13))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_edge_queries_match_jax(cfgs, name, t):
    jf, pf = _plans(name, cfgs)
    jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), faults.round_faults(
        pf, t)
    g = np.random.default_rng(t)
    src, dst = _edges(g, 3000)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    ps, pd = torch.from_numpy(src), torch.from_numpy(dst)
    for fn in ("fault_edge_block", "fault_edge_loss",
               "fault_session_refused"):
        want = getattr(jfaults, fn)(jrf, js, jd)
        got = getattr(faults, fn)(prf, ps, pd)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=fn)
        assert np.asarray(want).dtype == got.numpy().dtype, fn
    blk = np.asarray(jfaults.fault_edge_block(jrf, js, jd))
    assert not blk[src == dst].any()
    if name == "storm" and 4 <= t < 12:
        assert blk.any() and (~blk & (src != dst)).any()
        thr = np.asarray(jfaults.fault_edge_loss(jrf, js, jd))
        assert set(np.unique(thr)) == {0, 38}
    # the wire's half: cuts clear ok in place, thresholds come back
    ok0 = g.random(3000) < 0.9
    jok, _, _, _ = jfaults.fault_wire_effects(
        jrf, jax.random.PRNGKey(0), js, jd, P, jnp.asarray(ok0),
        jnp.zeros((3000, P), bool), jnp.zeros(3000, jnp.int32),
    )
    pok = torch.from_numpy(ok0.copy())
    pok2, pthr, pdelay, pjit = faults.fault_wire_effects(prf, ps, pd, pok)
    assert pok2 is pok and pdelay is None and pjit is None
    np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
    np.testing.assert_array_equal(
        np.asarray(jfaults.fault_edge_loss(jrf, js, jd)), pthr.numpy())


@pytest.mark.parametrize("shape", ((1000,), (300, 7), (1536, 256), (128,)))
@pytest.mark.parametrize("seed", (0, 3))
def test_aligned_u8_bits_matches_jax(shape, seed):
    want = jax_aligned_u8_bits(jax.random.PRNGKey(seed), shape)
    got = aligned_u8_bits(rng.prng_key(seed, "cpu"), shape)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_bits_word_does_not_depend_on_draw_length():
    """What lets K9 and K10 (and their plain versions) hash word i of a
    padded draw directly: under jax's partitionable threefry a u32 word
    of a bits draw is the same whatever the draw's length."""
    key = jax.random.PRNGKey(3)
    short = np.asarray(jax.random.bits(key, (25000,), jnp.uint32))
    longer = np.asarray(jax.random.bits(key, (25024,), jnp.uint32))
    np.testing.assert_array_equal(short, longer[:25000])
    pkey = rng.prng_key(3, "cpu")
    for size, want in ((25000, short), (25024, longer)):
        got = rng.bits(pkey, (size,)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (0, 1))
def test_lossy_scatter_matches_jax_drop(seed):
    """K10's plain version against JAX's wire seam on the dense ring:
    the drop bits of `fault_wire_effects` (aligned u8 draw under
    fold_in(fold_in(key, plan seed), 101), below the edge's threshold)
    masking the sender's payloads before the scatter-max."""
    g = np.random.default_rng(seed)
    f, d = 3, 2
    e = N * f
    sending = g.integers(0, 1 << 32, (N, W), dtype=np.uint32)
    sending[g.random(N) < 0.3] = 0
    dst = g.integers(0, N, e).astype(np.int32)
    slot = g.integers(0, d, e).astype(np.int32)
    ok = g.random(e) < 0.9
    thr = np.where(g.random(e) < 0.8, g.integers(1, 256, e), 0).astype(
        np.uint8)
    ring0 = (g.random((d, N, P)) < 0.05).astype(np.uint8)
    plan_seed = 12345
    key = jax.random.PRNGKey(seed)

    kf = jax.random.fold_in(jax.random.fold_in(key, plan_seed), 101)
    drop = jax_aligned_u8_bits(kf, (e, P)) < jnp.asarray(thr)[:, None]
    sent8 = jpacked.unpack_bits(jnp.asarray(sending), P).astype(jnp.uint8)
    sent = jnp.where(jnp.asarray(ok)[:, None] & ~drop,
                     jnp.repeat(sent8, f, axis=0), jnp.uint8(0))
    rows = jnp.asarray(slot) * N + jnp.asarray(dst)
    want = jnp.asarray(ring0).reshape(d * N, P).at[rows].max(sent)

    ring = packed.pack_bits(torch.from_numpy(ring0))
    packed.scatter_sending_lossy_plain(
        ring, torch.from_numpy(sending.view(np.int32)),
        torch.from_numpy(dst), torch.from_numpy(slot), torch.from_numpy(ok),
        torch.from_numpy(thr), rng.prng_key(seed, "cpu"), plan_seed, f,
    )
    got = packed.unpack_bits(ring, P).numpy().astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(want).reshape(d, N, P), got)
    lossless = jnp.asarray(ring0).reshape(d * N, P).at[rows].max(
        jnp.where(jnp.asarray(ok)[:, None], jnp.repeat(sent8, f, axis=0),
                  jnp.uint8(0)))
    assert (np.asarray(lossless) != np.asarray(want)).any()


def _jax_state(jcfg, g, t):
    """A storm state at round t with random tables, some down nodes and
    random bookkeeping."""
    pid, pkey, psince = random_tables(g, N, 64, t)
    a, v, k = jcfg.n_writers, jcfg.n_versions, jcfg.gap_slots
    d = jcfg.n_delay_slots
    state = jax_new_sim(jcfg, 3)
    return state._replace(
        t=jnp.int32(t), pid=jnp.asarray(pid), pkey=jnp.asarray(pkey),
        psince=jnp.asarray(psince),
        alive=jnp.asarray((g.random(N) < 0.1).astype(np.uint8) * 2),
        have=jnp.asarray((g.random((N, P)) < 0.5).astype(np.uint8)),
        relay_left=jnp.asarray(g.integers(0, 16, (N, P)).astype(np.uint8)),
        inflight=jnp.asarray((g.random((d, N, P)) < 0.1).astype(np.uint8)),
        sync_inflight=jnp.asarray(
            (g.random((d, N, P)) < 0.1).astype(np.uint8)),
        heads=jnp.asarray(g.integers(0, v + 1, (N, a)).astype(np.int32)),
        gap_lo=jnp.asarray(g.integers(0, v, (N, a, k)).astype(np.int32)),
        gap_hi=jnp.asarray(g.integers(0, v, (N, a, k)).astype(np.int32)),
    )


@pytest.mark.parametrize("t", (5, 9, 13))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_reachable_with_faults_matches_jax(cfgs, name, t):
    """The probe path: cuts, then the per-edge loss draw on [E] edge
    sets whose size is not a multiple of 128 (the padded draw)."""
    jcfg, _, pcfg, _ = cfgs
    jf, pf = _plans(name, cfgs)
    g = np.random.default_rng(t)
    jstate = _jax_state(jcfg, g, t)
    pstate = to_port(jstate, pcfg)
    jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), faults.round_faults(
        pf, t)
    for e in (N, 3 * N, 1000):
        src, dst = _edges(g, e)
        key = jax.random.PRNGKey(t + e)
        want = jax_reachable(jstate, JaxTopology(), key, jnp.asarray(src),
                             jnp.asarray(dst), jrf)
        got = _reachable(pstate, Topology(), rng.prng_key(t + e, "cpu"),
                         torch.from_numpy(src), torch.from_numpy(dst), prf)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=f"E={e}")
        no_faults = jax_reachable(jstate, JaxTopology(), key,
                                  jnp.asarray(src), jnp.asarray(dst))
        if name == "storm" and t < 12:  # the loss drew and bit
            assert (np.asarray(no_faults) & ~np.asarray(want)).any()


def _slim_and_carry(mod, state, cfg):
    return mod.shrink_state(state), mod.pack_state(state, cfg)


@pytest.mark.parametrize("t", (8, 12, 20))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_node_faults_match_jax(cfgs, name, t):
    """apply_node_faults + apply_carry_faults on the packed loop's slim
    state and carry (K11's plain version), and apply_node_faults on a
    full state, on rounds with overrides and with wipes."""
    jcfg, _, pcfg, _ = cfgs
    jf, pf = _plans(name, cfgs)
    g = np.random.default_rng(t)
    jstate = _jax_state(jcfg, g, t)
    jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), faults.round_faults(
        pf, t)

    jslim, jcarry = _slim_and_carry(jpacked, jstate, jcfg)
    jslim = jfaults.apply_node_faults(jslim, jrf)
    jcarry = jpacked.apply_carry_faults(jcarry, jrf)
    pslim, pcarry = _slim_and_carry(packed, to_port(jstate, pcfg), pcfg)
    pslim, pcarry = packed.apply_round_faults(pslim, pcarry, prf)
    assert_fields_equal(
        fields(jpacked.unpack_into_state(jcarry, jslim, jcfg)),
        port_fields(packed.unpack_into_state(pcarry, pslim, pcfg)),
        f"slim+carry t={t}",
    )
    assert_fields_equal(
        fields(jfaults.apply_node_faults(jstate, jrf)),
        port_fields(faults.apply_node_faults(to_port(jstate, pcfg), prf)),
        f"full state t={t}",
    )
    if (name, t) in (("storm", 20), ("overlap", 12)):
        assert np.asarray(jrf.wipe).any()


def _bits_to_words(bits):
    n, p = bits.shape
    b = bits.reshape(n, p // 32, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("t, horizon", ((5, 21), (19, 21), (20, 21),
                                        (30, 21)))
@pytest.mark.parametrize("wiped", (False, True))
def test_converge_record_fault_exit_matches_jax(cfgs, t, horizon, wiped):
    """K7's exit mode (plain version): the fault loop's flag is t + 1 ≥
    horizon and JAX's fresh all_have_words, never the sticky stamps —
    with ``wiped`` a node stamped converged earlier has lost its words."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(t)
    have = np.full((N, W), 0xFFFFFFFF, dtype=np.uint32)
    dead = g.random(N) < 0.1
    alive = (dead * 2).astype(np.uint8)
    have[dead] &= _bits_to_words(g.random((int(dead.sum()), P)) < 0.7)
    conv = np.where(g.random(N) < 0.9, g.integers(0, t + 1, N), -1)
    conv = conv.astype(np.int32)
    if wiped:
        victim = int(np.flatnonzero(~dead)[0])
        have[victim] = 0
        conv[victim] = 3
    inj = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    cov = np.full(P, -1, np.int32)
    metrics = RunMetrics(
        coverage_at=torch.from_numpy(cov), converged_at=torch.from_numpy(conv),
        overflow_frac=torch.zeros(()), order_violations=torch.zeros(()),
    )
    i32 = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    none = torch.zeros((), dtype=torch.int32)
    _, pconv, _, done = packed.converge_record(
        i32(have), i32(inj), torch.from_numpy(alive), metrics, pmeta, t,
        pcfg, none, int(pmeta.round.max()), horizon=horizon,
    )
    jcarry = jpacked.PackedCarry(
        have=jnp.asarray(have), inflight=None, relay=None, sync_buf=None)
    slim = jax_new_sim(jcfg, 0)._replace(t=jnp.int32(t + 1),
                                         alive=jnp.asarray(alive))
    want = (t + 1 >= horizon) and bool(jpacked.all_have_words(
        jcarry, jnp.asarray(inj), slim, jmeta, jcfg))
    assert bool(done) == want
    assert want == (t + 1 >= horizon and not wiped)
    # the stamps are the faultless mode's
    _, fconv, _, _ = packed.converge_record(
        i32(have), i32(inj), torch.from_numpy(alive), metrics, pmeta, t, pcfg,
        none, int(pmeta.round.max()))
    assert torch.equal(pconv, fconv)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_packed_round_step_with_faults_matches_jax(cfgs, name):
    """One faulted packed round at t = 5 (loss and partition both on) from
    the state JAX's fault loop reached after five rounds, on the plan JAX
    compiled: state, carry, injected words and metrics equal."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    jf, _ = _plans(name, cfgs)
    pf = fault_plan_from_numpy(fields(jf), "cpu")
    t = 5
    state, _ = jfaults.run_fault_plan(
        jax_new_sim(jcfg, 7), jmeta, jcfg, JaxTopology(), jf, max_rounds=t
    )
    assert int(state.t) == t
    jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), faults.round_faults(
        pf, t)
    assert bool(np.asarray(jrf.block_on).any())
    assert bool(np.asarray(jrf.loss_on).any())

    jslim, jcarry = _slim_and_carry(jpacked, state, jcfg)
    jinj = jpacked.pack_bits(state.injected)
    jmet = jax_new_metrics(jcfg)
    jslim = jfaults.apply_node_faults(jslim, jrf)
    jcarry = jpacked.apply_carry_faults(jcarry, jrf)
    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    jslim, jcarry, jinj, jmet = step(
        jslim, jcarry, jinj, jmet, jmeta, jcfg, JaxTopology(),
        jax_regions(N, 1), jrf,
    )

    pstate = to_port(state, pcfg)
    pslim, pcarry = _slim_and_carry(packed, pstate, pcfg)
    pinj = packed.pack_bits(pstate.injected)
    pmet = new_metrics(pcfg, "cpu")
    pslim, pcarry = packed.apply_round_faults(pslim, pcarry, prf)
    pslim, pcarry, pinj, pmet, _ = packed.packed_round_step(
        pslim, pcarry, pinj, pmet, pmeta, pcfg, Topology(),
        regions(N, 1, "cpu"), prf, pf.horizon,
        last_round=int(pmeta.round.max()),
    )
    assert_fields_equal(fields(jslim), port_fields(pslim), "slim")
    assert_fields_equal(
        fields(jpacked.unpack_into_state(jcarry, jslim, jcfg)),
        port_fields(packed.unpack_into_state(pcarry, pslim, pcfg)), "carry",
    )
    np.testing.assert_array_equal(np.asarray(jinj),
                                  pinj.numpy().view(np.uint32))
    for f in ("coverage_at", "converged_at", "order_violations"):
        np.testing.assert_array_equal(np.asarray(getattr(jmet, f)),
                                      getattr(pmet, f).numpy(), err_msg=f)


def test_delay_factors_in_the_round_match_jax(cfgs):
    """A plan with a delay factor (of 0 rounds, beside a loss) reaches
    the round: the wire seam's cut, thresholds and fault delay, and the
    session delay, equal JAX's on random edges inside and past the
    window; the plan has no jitter factor, so neither side jitters."""
    jcfg, _, pcfg, _ = cfgs

    def plan(mod):
        return mod.FaultPlan(n_nodes=N, seed=1, events=(
            mod.FaultEvent("delay", 0, 4, delay_rounds=0),
            mod.FaultEvent("loss", 0, 4, p=0.1),
        ))

    jf = jfaults.compile_plan(plan(jfaults_mod),
                              dataclasses.replace(jcfg, n_delay_slots=4),
                              JaxTopology(), factored=True)
    pf = faults.compile_plan(plan(pfaults_mod),
                             dataclasses.replace(pcfg, n_delay_slots=4),
                             Topology(), factored=True, device="cpu")
    g = np.random.default_rng(4)
    for t in (0, 3, 4):
        jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), \
            faults.round_faults(pf, t)
        src, dst = _edges(g, 1000)
        js, jd = jnp.asarray(src), jnp.asarray(dst)
        ok0 = g.random(1000) < 0.9
        jok, _, jdelay, jdelay_ep = jfaults.fault_wire_effects(
            jrf, jax.random.PRNGKey(t), js, jd, P, jnp.asarray(ok0),
            jnp.zeros((1000, P), bool), jnp.zeros(1000, jnp.int32),
        )
        pok, pthr, pdelay, pjit = faults.fault_wire_effects(
            prf, torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(ok0.copy()))
        np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
        np.testing.assert_array_equal(
            np.asarray(jfaults.fault_edge_loss(jrf, js, jd)), pthr.numpy())
        np.testing.assert_array_equal(np.asarray(jdelay), pdelay.numpy())
        assert jdelay_ep is None and pjit is None
        np.testing.assert_array_equal(
            np.asarray(jfaults.fault_session_delay(jrf, js, jd)),
            faults.fault_session_delay(prf, torch.from_numpy(src),
                                       torch.from_numpy(dst)).numpy())
