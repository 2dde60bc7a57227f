"""The port's fault latency (delay and jitter factors) on the packed
round against the JAX reference.

Delay factors add to each edge's ring slot and split the sync grants
into delay classes; jitter factors give each payload of a jittered edge
its own slot from a per-(edge, payload) draw.  Covered here, all exact:
the per-edge queries (fault delay, jitter bound, session delay) at
JAX's overlapping 3-node plan and at random edges; the jitter draws and
``delay_ep``; one jittered broadcast into the ring (a shape whose draw
is not 128-aligned too); the sync ring over two consecutive rounds with
mixed delay classes; JAX's 48-node "latency" and "storm-mix" lockstep
plans and the delay-only pair, round by round to convergence; this
slice's plan at 1024 nodes; the flight recorder under JAX's 32-node
telemetry plan.  ``-m slow`` re-derives ``LATENCY_STORM_100K_SEED0``
and its telemetry entry from live JAX.  The matrix form is not ported: both sides compile
``factored=True`` below 1024 nodes."""

import dataclasses
import itertools

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
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.state import SimConfig as JaxSimConfig
from corrosion_tpu.sim.state import uniform_payloads as jax_uniform_payloads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import faults as pfaults_mod
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import meta_from_numpy, state_digest
from corrosion_tpu_torch.sim import faults, packed, rng, telemetry
from corrosion_tpu_torch.sim.round import new_metrics, new_sim
from corrosion_tpu_torch.sim.state import SimConfig
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.test_torch_gapstress import (
    _assert_carry_equal,
    _port_carry,
    _u32_to_i32,
)
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    jax_digest,
    jax_telemetry,
    latency_storm_plans,
    port_fields,
    random_tables,
    storm_configs,
    to_port,
)

# -- configurations and plans ---------------------------------------------------


def _pair(jcfg):
    """The port's SimConfig with every field of ``jcfg``."""
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(SimConfig)})


def _lockstep_cfg(n=48, **kw):
    """tests/sim/test_packed_equivalence.py's ``_fault_cfg``."""
    kw.setdefault("n_payloads", 128)
    kw.setdefault("n_writers", 4)
    kw.setdefault("chunks_per_version", 4)
    kw.setdefault("fanout", 3)
    kw.setdefault("sync_interval_rounds", 4)
    kw.setdefault("swim_partial_view", True)
    kw.setdefault("member_slots", 16)
    kw.setdefault("rate_limit_bytes_round", None)
    kw.setdefault("sync_budget_bytes", None)
    kw.setdefault("packed_min_cells", 0)
    kw.setdefault("n_delay_slots", 4)
    return JaxSimConfig.wan_tuned(n, **kw)


def _latency_pair(ev):
    return (ev("delay", 2, 16, src="0:8", dst="*", delay_rounds=1),
            ev("jitter", 2, 16, src="0:8", dst="*", delay_rounds=1))


#: test_packed_equivalence.py's latency plans, and the delay-only pair
LOCKSTEP = {
    "latency": lambda ev: _latency_pair(ev),
    "storm-mix": lambda ev, n: (
        ev("loss", 0, 20, p=0.3),
        ev("partition", 4, 14, src=f"0:{n // 2}", dst=f"{n // 2}:{n}",
           symmetric=True),
        *_latency_pair(ev),
        ev("crash", 10, 22, node=2, wipe=True),
    ),
    "delay-only": lambda ev: _latency_pair(ev)[:1],
}


def _plans(name, n=48, seed=5):
    """(jax FaultPlan, port FaultPlan) of a LOCKSTEP plan (the storm-mix
    halves at n // 2)."""
    def events(ev):
        if name == "storm-mix":
            return LOCKSTEP[name](ev, n)
        return LOCKSTEP[name](ev)

    return tuple(
        mod.FaultPlan(n_nodes=n, seed=seed, events=events(mod.FaultEvent))
        for mod in (jfaults_mod, pfaults_mod))


def _compile(jplan, pplan, jcfg, pcfg, factored=True):
    return (jfaults.compile_plan(jplan, jcfg, JaxTopology(),
                                 factored=factored),
            faults.compile_plan(pplan, pcfg, Topology(), factored=factored,
                                device="cpu"))


# -- (a) the per-edge queries ---------------------------------------------------


def _overlap3(mod):
    """tests/sim/test_fault_plan.py's overlapping 3-node plan: delays that
    add, a jitter over every destination of node 0, cuts both ways."""
    ev = mod.FaultEvent
    return mod.FaultPlan(n_nodes=3, seed=3, events=(
        ev("loss", 0, 10, p=0.4),
        ev("partition", 2, 8, src=2, dst=0),
        ev("partition", 4, 9, src="0:2", dst="2:3", symmetric=True),
        ev("delay", 1, 6, src=0, dst=1, delay_rounds=1),
        ev("delay", 3, 7, src="*", dst=1, delay_rounds=2),
        ev("jitter", 2, 6, src=0, dst="*", delay_rounds=2),
        ev("crash", 5, 9, node=1, wipe=True),
    ))


def _query_cases(name):
    """(jax round faults per round, port's, src, dst) of a query case."""
    if name == "overlap3":
        jcfg = JaxSimConfig(n_nodes=3, n_payloads=8, fanout=2,
                            sync_interval_rounds=4, n_delay_slots=8)
        jplan, pplan = _overlap3(jfaults_mod), _overlap3(pfaults_mod)
        pairs = list(itertools.product(range(3), range(3)))
        src = np.array([p[0] for p in pairs], np.int32)
        dst = np.array([p[1] for p in pairs], np.int32)
    else:
        jcfg = _lockstep_cfg()
        jplan, pplan = _plans("storm-mix")
        g = np.random.default_rng(1)
        src = g.integers(0, 48, 2000).astype(np.int32)
        dst = g.integers(0, 48, 2000).astype(np.int32)
        self_edge = g.random(2000) < 0.1
        dst[self_edge] = src[self_edge]
    jf, pf = _compile(jplan, pplan, jcfg, _pair(jcfg))
    return jf, pf, src, dst


@pytest.mark.parametrize("name", ("overlap3", "storm-mix"))
def test_latency_queries_match_jax(name):
    """fault_edge_delay (overlapping delays add), fault_edge_jitter
    (jitters take the max), fault_session_delay (the slower direction),
    and the wire seam's and session's one-launch forms, every round of
    the plan and past it: equal to JAX's, 0 on self-edges."""
    jf, pf, src, dst = _query_cases(name)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    ps, pd = torch.from_numpy(src), torch.from_numpy(dst)
    seen = set()
    for t in range(jf.alive.shape[0] + 1):
        jrf = jfaults.round_faults(jf, jnp.int32(t))
        prf = faults.round_faults(pf, t)
        for fn in ("fault_edge_delay", "fault_edge_jitter",
                   "fault_session_delay"):
            want = np.asarray(getattr(jfaults, fn)(jrf, js, jd))
            got = getattr(faults, fn)(prf, ps, pd).numpy()
            np.testing.assert_array_equal(want, got, err_msg=f"{fn} t={t}")
            assert want.dtype == got.dtype, fn
            assert not got[src == dst].any(), fn
            seen.update((fn, int(v)) for v in np.unique(got))
        ok0 = np.arange(src.shape[0]) % 7 != 3
        jok, _, jdelay, _ = jfaults.fault_wire_effects(
            jrf, jax.random.PRNGKey(t), js, jd, 8, jnp.asarray(ok0),
            jnp.zeros((src.shape[0], 8), bool),
            jnp.zeros(src.shape[0], jnp.int32))
        pok, _, pdelay, pjit = faults.fault_wire_effects(
            prf, ps, pd, torch.from_numpy(ok0.copy()))
        np.testing.assert_array_equal(np.asarray(jok), pok.numpy())
        np.testing.assert_array_equal(np.asarray(jdelay), pdelay.numpy())
        np.testing.assert_array_equal(
            np.asarray(jfaults.fault_edge_jitter(jrf, js, jd)), pjit.numpy())
        refused, sdelay = faults.fault_session_effects(prf, ps, pd)
        np.testing.assert_array_equal(
            np.asarray(jfaults.fault_session_refused(jrf, js, jd)),
            refused.numpy())
        np.testing.assert_array_equal(
            np.asarray(jfaults.fault_session_delay(jrf, js, jd)),
            sdelay.numpy())
    # the overlap reached: delays that add, jitter, both directions
    if name == "overlap3":
        assert {("fault_edge_delay", 3), ("fault_edge_jitter", 2),
                ("fault_session_delay", 3)} <= seen
    else:
        assert ("fault_session_delay", 1) in seen


# -- (b) the jitter draws and one jittered broadcast ----------------------------


@pytest.mark.parametrize("shape", ((129, 96), (144, 64), (7, 33)))
def test_randint_at_matches_jax(shape):
    """randint's draws at chosen elements equal the whole draw's (element
    i hashes counter i whatever the shape) — at span 2^31 - 1, where
    randint's multiplier (2^16)^2 wraps to 0 in u32."""
    key = jax.random.PRNGKey(shape[0])
    want = np.asarray(jax.random.randint(key, shape, 0, packed.JITTER_MAX,
                                         jnp.int32)).reshape(-1)
    idx = np.random.default_rng(0).permutation(want.size)[:500]
    got = rng.randint_at_plain(rng.prng_key(shape[0], "cpu"),
                               torch.from_numpy(idx), 0, packed.JITTER_MAX)
    np.testing.assert_array_equal(want[idx], got.numpy())
    assert rng.scalar_span(0, packed.JITTER_MAX) == (packed.JITTER_MAX, 0)


def _random_state(jcfg, g, t):
    """A packed-envelope state at round t: random tables, a few down
    nodes, random have/relay and both rings partly full."""
    n, p, d = jcfg.n_nodes, jcfg.n_payloads, jcfg.n_delay_slots
    pid, pkey, psince = random_tables(g, n, jcfg.member_slots, t)
    a, v, k = jcfg.n_writers, jcfg.n_versions, jcfg.gap_slots
    return jax_new_sim(jcfg, 3)._replace(
        t=jnp.int32(t), pid=jnp.asarray(pid), pkey=jnp.asarray(pkey),
        psince=jnp.asarray(psince),
        alive=jnp.asarray(np.where(g.random(n) < 0.1, 2, 0).astype(np.uint8)),
        have=jnp.asarray((g.random((n, p)) < 0.5).astype(np.uint8)),
        relay_left=jnp.asarray(g.integers(0, 16, (n, p)).astype(np.uint8)),
        inflight=jnp.asarray((g.random((d, n, p)) < 0.1).astype(np.uint8)),
        sync_inflight=jnp.asarray(
            (g.random((d, n, p)) < 0.1).astype(np.uint8)),
        heads=jnp.asarray(g.integers(0, v + 1, (n, a)).astype(np.int32)),
        gap_lo=jnp.asarray(g.integers(0, v, (n, a, k)).astype(np.int32)),
        gap_hi=jnp.asarray(g.integers(0, v, (n, a, k)).astype(np.int32)),
    )


#: (nodes, payloads): the lockstep shape, and one whose [E, P] draws are
#: not a multiple of 128 bytes (the loss stream's padded draw)
BCAST_SHAPES = ((48, 128), (43, 96))


@pytest.mark.parametrize("name", ("latency", "storm-mix"))
@pytest.mark.parametrize("n, p", BCAST_SHAPES)
def test_jittered_broadcast_matches_jax(name, n, p):
    """delay_ep — the edge's topology delay plus fault delay plus each
    payload's draw mod (jitter + 1) — from the port's pieces equals JAX's
    fault_wire_effects', and one jittered broadcast (round 6, inside the
    delay, jitter, loss and cut windows) leaves the word ring equal to JAX's
    u8 ring packed; bits of one word land in two slots and D = 4 wraps."""
    jcfg = _lockstep_cfg(n, n_payloads=p, n_writers=4 if p % 64 == 0 else 3,
                         chunks_per_version=4 if p % 64 == 0 else 2)
    pcfg = _pair(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=2)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jplan, pplan = _plans(name, n)
    jf, pf = _compile(jplan, pplan, jcfg, pcfg)
    t = 6
    g = np.random.default_rng(n + p)
    jstate = _random_state(jcfg, g, t)
    jc = jpacked.pack_state(jstate, jcfg)
    inj = jpacked.pack_bits(jnp.asarray(g.random(p) < 0.8))
    slim = jpacked.shrink_state(jstate)
    jrf, prf = jfaults.round_faults(jf, jnp.int32(t)), faults.round_faults(
        pf, t)
    key = jax.random.PRNGKey(77)
    pkey = torch.from_numpy(np.asarray(key).astype(np.int64))

    # delay_ep on every edge of a random edge set
    e = 3 * n
    src = g.integers(0, n, e).astype(np.int32)
    dst = g.integers(0, n, e).astype(np.int32)
    _, _, jdelay, jdelay_ep = jfaults.fault_wire_effects(
        jrf, key, jnp.asarray(src), jnp.asarray(dst), p,
        jnp.ones(e, bool), jnp.zeros((e, p), bool), jnp.ones(e, jnp.int32))
    _, _, fdelay, jit = faults.fault_wire_effects(
        prf, torch.from_numpy(src), torch.from_numpy(dst),
        torch.ones(e, dtype=torch.bool))
    draw = rng.randint_at_plain(
        faults.fault_key(pkey, int(prf.seed), faults.JITTER_TAG),
        torch.arange(e * p, dtype=torch.int64), 0, packed.JITTER_MAX,
    ).reshape(e, p)
    delay_ep = (1 + fdelay)[:, None] + torch.where(
        jit[:, None] > 0, draw % (jit[:, None] + 1), 0)
    np.testing.assert_array_equal(np.asarray(jdelay_ep), delay_ep.numpy())
    assert len(np.unique(np.asarray(jdelay_ep))) == 3  # 1, 2 and 3

    jout = jax.jit(jpacked.broadcast_packed, static_argnums=(3, 4))(
        jc, inj, slim, jcfg, JaxTopology(), jax_regions(n, 1), key, jmeta,
        jrf)
    full = jpacked.unpack_into_state(jc, slim, jcfg)
    pout = packed.broadcast_packed(
        _port_carry(jc), _u32_to_i32(inj), to_port(full, pcfg), pcfg,
        Topology(), regions(n, 1, "cpu"), pkey, pmeta, prf,
        active=faults.host_activity(pf)[t])
    _assert_carry_equal(jout, pout, p, "broadcast")
    # the topology's delay is 0: the fault delay sends the first sixth's
    # bits to slot t + 1, the jitter some of them one slot further, past
    # D - 1 = 3 at t = 6 ((6 + 1 + 1) % 4 = 0)
    new = np.asarray(jout.inflight) & ~np.asarray(jc.inflight)
    assert new[(t + 1) % 4].any() and new[(t + 2) % 4].any()


# -- (c) the sync ring over two rounds ------------------------------------------


def test_sync_ring_two_rounds_mixed_classes():
    """Two consecutive syncs in the delay window of the storm-mix plan,
    on a ring whose slots already hold words: sessions touching the
    first eight nodes land one slot late, the slot round t + 1's fast
    sessions also write (read-OR-write, never an overwrite or a word
    max); fruitful, countdown and backoff equal JAX's every round."""
    jcfg = _lockstep_cfg()
    pcfg = _pair(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=2)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jf, pf = _compile(*_plans("storm-mix"), jcfg, pcfg)
    g = np.random.default_rng(8)
    t = 6
    jstate = _random_state(jcfg, g, t)._replace(
        sync_countdown=jnp.asarray(
            np.where(g.random(48) < 0.7, 0, 2).astype(np.int32)))
    jc = jpacked.pack_state(jstate, jcfg)
    pc = _port_carry(jc)
    pstate = to_port(jstate, pcfg)
    jslim = jstate
    step = jax.jit(jpacked.sync_packed, static_argnums=(2, 3))
    late = 0
    for r in range(2):
        jrf = jfaults.round_faults(jf, jnp.int32(t + r))
        prf = faults.round_faults(pf, t + r)
        key = jax.random.PRNGKey(30 + r)
        before = np.asarray(jc.sync_buf)
        jc, jcd, jbo = step(jc, jslim, jcfg, JaxTopology(), key, jmeta, jrf)
        pc, pcd, pbo = packed.sync_packed(
            pc, pstate, pcfg, Topology(),
            torch.from_numpy(np.asarray(key).astype(np.int64)), pmeta, prf)
        np.testing.assert_array_equal(np.asarray(jc.sync_buf),
                                      pc.sync_buf.numpy().view(np.uint32),
                                      err_msg=f"sync ring, round {r}")
        np.testing.assert_array_equal(np.asarray(jcd), pcd.numpy())
        np.testing.assert_array_equal(np.asarray(jbo), pbo.numpy())
        grew = np.asarray(jc.sync_buf) & ~before
        late += int(grew[(t + r + 2) % 4].any())
        # the slot this round's fast class writes held the last round's
        # slow grants (or the seeded words) already
        assert before[(t + r + 1) % 4].any()
        # most sessions due again next round (a rearm would idle them)
        due = np.where(g.random(48) < 0.7, 0, np.asarray(jcd)).astype(
            np.int32)
        jslim = jslim._replace(t=jnp.int32(t + r + 1),
                               sync_countdown=jnp.asarray(due),
                               sync_backoff=jbo)
        pstate = pstate._replace(t=pstate.t + 1,
                                 sync_countdown=torch.from_numpy(due),
                                 sync_backoff=pbo)
    assert late == 2  # both rounds had slow sessions that pulled


# -- (d) whole runs -------------------------------------------------------------


def _lockstep(name, rounds=40):
    """Step JAX's jitted node faults + packed_round_step and the port's
    fault loop body side by side; every round's state, carry and metrics
    must be equal.  Returns the port's scatter calls per round."""
    jcfg = _lockstep_cfg()
    pcfg = _pair(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=2)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jf, pf = _compile(*_plans(name), jcfg, pcfg)
    horizon = pf.horizon
    activity = faults.host_activity(pf)
    jstate, pstate = jax_new_sim(jcfg, 9), new_sim(pcfg, 9, "cpu")
    jcarry, pcarry = (jpacked.pack_state(jstate, jcfg),
                      packed.pack_state(pstate, pcfg))
    jinj = jpacked.pack_bits(jstate.injected)
    pinj = packed.pack_bits(pstate.injected)
    jslim, pslim = jpacked.shrink_state(jstate), packed.shrink_state(pstate)
    jmet, pmet = jax_new_metrics(jcfg), new_metrics(pcfg, "cpu")

    @jax.jit
    def node_faults(slim, carry, t):
        rf = jfaults.round_faults(jf, t)
        return (jfaults.apply_node_faults(slim, rf),
                jpacked.apply_carry_faults(carry, rf), rf)

    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    region = jax_regions(48, 1)
    calls = []
    last_round = int(pmeta.round.max())
    for r in range(rounds):
        jslim, jcarry, jrf = node_faults(jslim, jcarry, jslim.t)
        jslim, jcarry, jinj, jmet = step(
            jslim, jcarry, jinj, jmet, jmeta, jcfg, JaxTopology(), region,
            jrf)
        prf = faults.round_faults(pf, r)
        pslim, pcarry = packed.apply_round_faults(pslim, pcarry, prf)
        with _scatter_spy() as spy:
            pslim, pcarry, pinj, pmet, pdone = packed.packed_round_step(
                pslim, pcarry, pinj, pmet, pmeta, pcfg, Topology(),
                regions(48, 1, "cpu"), prf, horizon, None,
                activity[min(r, horizon)], last_round=last_round)
        calls.append(spy.calls)
        label = f"{name} round {r}"
        assert jax_digest(jslim) == state_digest(pslim), label
        assert_fields_equal(
            fields(jpacked.unpack_into_state(jcarry, jslim, jcfg)),
            port_fields(packed.unpack_into_state(pcarry, pslim, pcfg)),
            f"{label} carry")
        np.testing.assert_array_equal(np.asarray(jinj),
                                      pinj.numpy().view(np.uint32))
        assert_fields_equal(fields(jmet), fields(pmet), label)
        jdone = bool((jslim.t >= horizon) & jpacked.all_have_words(
            jcarry, jinj, jslim, jmeta, jcfg))
        assert jdone == bool(pdone), label
        if jdone:
            break
    assert jdone, f"{name} did not converge in {rounds} rounds"
    # the port's whole loop ends in the same state
    final, _ = faults.run_fault_plan(new_sim(pcfg, 9, "cpu"), pmeta, pcfg,
                                     Topology(), pf, rounds)
    assert int(final.t) == r + 1
    assert state_digest(final) == state_digest(
        packed.unpack_into_state(pcarry, pslim, pcfg)._replace(
            injected=packed.unpack_bits(pinj, pcfg.n_payloads).to(
                torch.uint8)))
    return calls


class _scatter_spy:
    """Records which ring scatter each broadcast ran: "K2", or K10 with
    the streams it was given ("loss", "jitter")."""

    def __enter__(self):
        self.calls = []
        self._k2, self._k10 = packed.scatter_sending, \
            packed.scatter_sending_lossy

        def k2(*a, **kw):
            self.calls.append("K2")
            return self._k2(*a, **kw)

        def k10(ring, sending, dst, slot, ok, thr, key, seed, fanout,
                topo_thr=0, topo_key=None, dropped=None, jit=None):
            self.calls.append(("K10", thr is not None, jit is not None))
            return self._k10(ring, sending, dst, slot, ok, thr, key, seed,
                             fanout, topo_thr, topo_key, dropped, jit)

        packed.scatter_sending, packed.scatter_sending_lossy = k2, k10
        return self

    def __exit__(self, *exc):
        packed.scatter_sending = self._k2
        packed.scatter_sending_lossy = self._k10


@pytest.mark.parametrize("name", sorted(LOCKSTEP))
def test_latency_plans_lockstep_48(name):
    """JAX's lockstep plans at 48 nodes, round by round to convergence;
    each round's scatter follows the host's activity copy: K10 with the
    jitter stream in rounds 2-15 (its loss stream only while the loss
    lasts: the "latency" plan jitters without loss), K10's loss stream
    alone outside the jitter window, and K2 once neither applies — under
    the delay-only plan always, with the fault delay in its slots."""
    calls = _lockstep(name)
    for r, c in enumerate(calls):
        jitter = name != "delay-only" and 2 <= r < 16
        loss = name == "storm-mix" and r < 20
        want = [("K10", loss, jitter)] if loss or jitter else ["K2"]
        assert c == want, (name, r, c)


def test_latency_storm_1024_matches_jax():
    """This slice's plan (the fault storm plus the latency pair over the
    first sixth) at 1024 nodes, auto-factored, on the storm config with
    four delay slots and the packed envelope forced open: run_fault_plan
    gives JAX's final state, metrics, rounds, p99 and digest."""
    jcfg, jmeta, pcfg, pmeta = storm_configs(1024, 512)
    jcfg = dataclasses.replace(jcfg, n_delay_slots=4)
    pcfg = dataclasses.replace(pcfg, n_delay_slots=4)
    jplan, pplan = latency_storm_plans(1024, 0)
    jf = jfaults.compile_plan(jplan, jcfg, JaxTopology())
    pf = faults.compile_plan(pplan, pcfg, Topology(), device="cpu")
    assert isinstance(pf, faults.FactoredFaultPlan)
    assert_fields_equal(fields(jf), fields(pf), "compile_plan 1024")
    jfinal, jmet = jfaults.run_fault_plan(jax_new_sim(jcfg, 0), jmeta, jcfg,
                                          JaxTopology(), jf, max_rounds=600)
    pfinal, pmet = faults.run_fault_plan(new_sim(pcfg, 0, "cpu"), pmeta,
                                         pcfg, Topology(), pf, 600)
    assert_fields_equal(fields(jfinal), port_fields(pfinal), "final")
    assert_fields_equal(fields(jmet), fields(pmet), "metrics")
    assert int(pfinal.t) >= pf.horizon
    assert _percentile(np.asarray(jmet.converged_at), 99) == _percentile(
        pmet.converged_at.numpy(), 99)


# -- (e) the flight recorder ----------------------------------------------------


def _telemetry_cfg():
    """tests/sim/test_telemetry.py's ``_cfg`` and its fault plan."""
    jcfg = JaxSimConfig.wan_tuned(
        32, n_payloads=64, n_writers=2, chunks_per_version=2, fanout=2,
        sync_interval_rounds=3, swim_partial_view=True, member_slots=8,
        rate_limit_bytes_round=None, sync_budget_bytes=None,
        packed_min_cells=0, n_delay_slots=4)

    def plan(mod):
        ev = mod.FaultEvent
        return mod.FaultPlan(n_nodes=32, seed=5, events=(
            ev("loss", 0, 12, p=0.3),
            ev("partition", 2, 10, src="0:16", dst="16:32"),
            ev("delay", 2, 10, src="0:8", dst="*", delay_rounds=1),
            ev("jitter", 2, 10, src="0:8", dst="*", delay_rounds=1),
            ev("crash", 6, 14, node=2, wipe=True),
        ))

    return jcfg, plan(jfaults_mod), plan(pfaults_mod)


def test_latency_telemetry_32_matches_jax():
    """The recorder under JAX's telemetry plan (loss, a one-way cut, the
    latency pair and a crash-with-wipe) at 32 nodes: the same run as
    JAX's with every RoundTrace channel equal (the f32 byte channels too:
    every payload is 8 KiB, so both sides' totals are exact)."""
    jcfg, jplan, pplan = _telemetry_cfg()
    pcfg = _pair(jcfg)
    jmeta = jax_uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jf, pf = _compile(jplan, pplan, jcfg, pcfg)
    with jax_telemetry():
        jfinal, jmet, jtrace = jfaults.run_fault_plan(
            jax_new_sim(jcfg, 7), jmeta, jcfg, JaxTopology(), jf, 300,
            telemetry=True)
        want = {f: np.asarray(getattr(jtrace, f))
                for f in telemetry.CHANNELS}
    pfinal, pmet, ptrace = faults.run_fault_plan(
        new_sim(pcfg, 7, "cpu"), pmeta, pcfg, Topology(), pf, 300, True)
    assert jax_digest(jfinal) == state_digest(pfinal)
    assert_fields_equal(fields(jmet), fields(pmet), "metrics")
    for f in telemetry.CHANNELS:
        got = getattr(ptrace, f).numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    rounds = int(pfinal.t)
    assert want["bcast_dropped"][:rounds].any()
    off, _ = faults.run_fault_plan(new_sim(pcfg, 7, "cpu"), pmeta, pcfg,
                                   Topology(), pf, 300)
    assert state_digest(off) == state_digest(pfinal)


# -- the 100k golden -------------------------------------------------------------


@pytest.mark.slow
def test_latency_storm_100k_golden_matches_live_jax():
    """``LATENCY_STORM_100K_SEED0`` (what chip_smoke.py holds the card
    to) from live JAX: the storm at 100k with four delay slots under
    this slice's plan (about a minute and a half on 8 cores)."""
    from corrosion_tpu.sim.runner import _write_storm as jax_write_storm

    jcfg, jmeta = jax_write_storm(100_000, 512)
    jcfg = dataclasses.replace(jcfg, n_delay_slots=4)
    jplan, _ = latency_storm_plans(100_000, 0)
    final, metrics = jfaults.run_fault_plan(
        jax_new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(),
        jfaults.compile_plan(jplan, jcfg, JaxTopology()), max_rounds=3000)
    assert goldens.LATENCY_STORM_100K_SEED0 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99),
        "digest": jax_digest(final),
    }


@pytest.mark.slow
def test_latency_storm_100k_telemetry_golden_matches_live_jax():
    """``LATENCY_STORM_100K_SEED0_TELEMETRY`` from live JAX: the same run
    with telemetry=True, its trace_summary (``wire_bytes`` apart) and the
    per-round f32 byte channels (another minute and a half)."""
    from corrosion_tpu.sim.runner import _write_storm as jax_write_storm

    jcfg, jmeta = jax_write_storm(100_000, 512)
    jcfg = dataclasses.replace(jcfg, n_delay_slots=4)
    jplan, _ = latency_storm_plans(100_000, 0)
    with jax_telemetry() as jtel:
        final, _, trace = jfaults.run_fault_plan(
            jax_new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(),
            jfaults.compile_plan(jplan, jcfg, JaxTopology()),
            max_rounds=3000, telemetry=True)
        rounds = int(final.t)
        summary = jtel.trace_summary(jtel.trace_host(trace, rounds), rounds,
                                     jcfg)
    golden = goldens.LATENCY_STORM_100K_SEED0_TELEMETRY
    assert golden["summary"] == {k: v for k, v in summary.items()
                                 if k != "wire_bytes"}
    assert golden["wire_bytes"] == summary["wire_bytes"]
    for channel in ("bcast_bytes", "sync_bytes"):
        assert golden[channel] == [
            float(x) for x in np.asarray(getattr(trace, channel))[:rounds]]
