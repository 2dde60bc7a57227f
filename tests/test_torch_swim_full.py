"""Full-view SWIM in the port (corrosion_tpu_torch/sim/swim.py) against
the live JAX reference, exact: the uniform member sampler (K1's uniform
entry) with and without the belief filter, flat-loss reachability (the
bernoulli probes), whole swim_step ticks (K15's three passes) on random
belief matrices, test_topo.py:115-125's lossy two-region full-view run
(seed 9) round by round against the live JAX digest, and the membership
churn (every third node killed at t = 0) to its detect round at 64 nodes
(``-m slow``: at 4096, against the golden chip_smoke.py holds the card
to)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import meta_from_numpy, state_digest
from corrosion_tpu_torch.sim import rng, runner, swim
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import topology as ptopo
from tests.torch_parity import (
    assert_metrics_equal,
    assert_states_equal,
    fields,
    jax_digest,
    to_port,
)


def _beliefs(n, seed, t=40, dead=0.1, kw=None):
    """(jax cfg, port cfg, jax state) of an n-node full-view cluster
    whose beliefs, liveness and incarnations are drawn from ``seed``:
    ALIVE, SUSPECT (with and without a stamp) and DOWN cells,
    incarnations up to 9, dead nodes, round ``t``."""
    g = np.random.default_rng(seed)
    kw = dict(n_nodes=n, n_payloads=8, swim_full_view=True, **(kw or {}))
    jcfg = jstate.SimConfig.wan_tuned(**kw)
    pcfg = pstate.SimConfig.wan_tuned(**kw)
    view = g.choice(3, (n, n), p=[0.75, 0.15, 0.1]).astype(np.int8)
    since = np.where(g.random((n, n)) < 0.6, g.integers(0, t + 1, (n, n)), -1)
    state = jround.new_sim(jcfg, seed)._replace(
        t=jnp.int32(t),
        view=jnp.asarray(view),
        vinc=jnp.asarray(g.integers(0, 10, (n, n)), jnp.int32),
        suspect_since=jnp.asarray(since, jnp.int32),
        alive=jnp.asarray((g.random(n) < dead) * 2, jnp.uint8),
        incarnation=jnp.asarray(g.integers(0, 10, n), jnp.uint32),
    )
    return jcfg, pcfg, state


@pytest.mark.parametrize("coupled", (True, False))
@pytest.mark.parametrize("count", (1, 3))
@pytest.mark.parametrize("seed", (0, 1))
def test_uniform_sampler_matches_jax(coupled, count, seed):
    jcfg, pcfg, js = _beliefs(300, seed)
    if not coupled:  # ground-truth membership: no belief filter
        js = js._replace(view=jnp.zeros((0, 0), jnp.int8))
        jcfg = jstate.SimConfig(n_nodes=300, n_payloads=8)
        pcfg = pstate.SimConfig(n_nodes=300, n_payloads=8)
    key = jax.random.PRNGKey(50 + seed)
    want = jax.jit(jswim.sample_member_targets, static_argnums=(1, 3))(
        js, jcfg, key, count)
    got = swim.sample_member_targets(to_port(js, pcfg), pcfg,
                                     rng.prng_key(50 + seed, "cpu"), count)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got >= 0).any()


@pytest.mark.parametrize("loss", (0.0, 0.2, 0.7))
def test_reachable_flat_loss_matches_jax(loss):
    jcfg, pcfg, js = _beliefs(200, 3)
    js = js._replace(group=jnp.asarray(
        (np.arange(200) >= 150).astype(np.int32)))
    g = np.random.default_rng(8)
    src, dst = g.integers(0, 200, 601), g.integers(0, 200, 601)
    topo_kw = dict(n_regions=2, inter_delay=2, loss=loss)
    want = jswim._reachable(js, jtopo.Topology(**topo_kw),
                            jax.random.PRNGKey(9), jnp.asarray(src),
                            jnp.asarray(dst))
    got = swim._reachable(to_port(js, pcfg), ptopo.Topology(**topo_kw),
                          rng.prng_key(9, "cpu"), torch.as_tensor(src),
                          torch.as_tensor(dst))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("t", (40, 41))  # a probe round and an off round
@pytest.mark.parametrize("topo_kw", ({}, dict(n_regions=2, inter_delay=2,
                                              loss=0.2)))
@pytest.mark.parametrize("seed", (0, 1))
def test_swim_step_matches_jax(t, topo_kw, seed):
    """One full-view tick on random beliefs: probes and their suspicion,
    timeouts, the gossip merge with its DOWN-receiver filter, announces
    with feedback, refutes."""
    jcfg, pcfg, js = _beliefs(80, seed, t=t)
    key = jax.random.PRNGKey(70 + seed)
    want = jax.jit(jswim.swim_step, static_argnums=(1, 2))(
        js, jcfg, jtopo.Topology(**topo_kw), key)
    ps = pround.own_state(to_port(js, pcfg))
    got = swim.swim_step(ps, pcfg, ptopo.Topology(**topo_kw),
                         rng.prng_key(70 + seed, "cpu"))
    assert_states_equal(want, got, "swim_step")
    assert not np.array_equal(np.asarray(want.view), np.asarray(js.view))
    assert not np.array_equal(np.asarray(want.incarnation),
                              np.asarray(js.incarnation))


def test_lossy_full_view_round_by_round_matches_live_jax():
    """test_topo.py:115-125: two regions, inter-region delay 2, loss 0.2,
    full-view SWIM, seed 9 — every round, then the run to convergence
    against the live JAX digest."""
    kw = dict(n_nodes=24, n_payloads=16, fanout=2, n_delay_slots=4,
              swim_full_view=True)
    topo_kw = dict(n_regions=2, inter_delay=2, loss=0.2)
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    jt, pt = jtopo.Topology(**topo_kw), ptopo.Topology(**topo_kw)
    jreg, preg = jtopo.regions(24, 2), ptopo.regions(24, 2, "cpu")
    js, ps = jround.new_sim(jcfg, 9), pround.new_sim(pcfg, 9, "cpu")
    assert_states_equal(js, ps, "new_sim")
    step = jax.jit(lambda s, m: jround.round_step(s, m, jmeta, jcfg, jt, jreg))
    jm, pm = jround.new_metrics(jcfg), pround.new_metrics(pcfg, "cpu")
    for r in range(12):
        js, jm = step(js, jm)
        ps, pm = pround.round_step(ps, pm, pmeta, pcfg, pt, preg)
        assert_states_equal(js, ps, f"round {r}")
        assert_metrics_equal(jm, pm, f"round {r}")
    jf, jmf = jround.run_to_convergence(jround.new_sim(jcfg, 9), jmeta, jcfg,
                                        jt, 400)
    pf, pmf = pround.run_to_convergence(pround.new_sim(pcfg, 9, "cpu"),
                                        pmeta, pcfg, pt, 400)
    assert int(pf.t) == int(jf.t)
    assert state_digest(pf) == jax_digest(jf)
    assert_metrics_equal(jmf, pmf, "final")


def jax_churn(n, seed=0, max_rounds=400):
    """The churn run in JAX: wan_tuned full view, one payload, every
    third node killed at t = 0, round_step until the
    run_membership_detect predicate holds.  Returns (detect round,
    undetected watched pairs one round earlier, final state, (up, up)
    DOWN beliefs)."""
    jcfg = jstate.SimConfig.wan_tuned(n, n_payloads=1, swim_full_view=True)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    jt = jtopo.Topology()
    kill = jnp.arange(n) % 3 == 0
    state = jround.new_sim(jcfg, seed)._replace(
        alive=jnp.where(kill, jnp.uint8(jstate.DOWN), jnp.uint8(jstate.ALIVE)))
    up = ~np.asarray(kill)
    watched = up[:, None] & ~up[None, :]
    step = jax.jit(lambda s, m: jround.round_step(s, m, jmeta, jcfg, jt,
                                                  jtopo.regions(n, 1)))
    metrics = jround.new_metrics(jcfg)
    missing_before = missing = int(watched.sum())
    while int(state.t) < max_rounds:
        state, metrics = step(state, metrics)
        missing_before = missing
        missing = int((watched & (np.asarray(state.view) != jstate.DOWN))
                      .sum())
        if missing == 0:
            break
    view = np.asarray(state.view)
    false_downs = int(((view == jstate.DOWN) & up[:, None] & up[None, :])
                      .sum())
    return int(state.t), missing_before, state, false_downs


def _check_churn(n):
    detect, missing_before, jf, false_downs = jax_churn(n)
    rec = runner.membership_churn(n, 0, device="cpu", return_state=True)
    assert missing_before > 0  # the predicate was false one round earlier
    assert rec["detect_round"] == detect
    assert rec["false_downs"] == false_downs
    assert_states_equal(jf, rec["state"], "detect round")
    assert state_digest(rec["state"]) == jax_digest(jf)
    return {"detect_round": detect, "digest": jax_digest(jf),
            "false_downs": false_downs}


def test_churn_64_matches_live_jax():
    """BENCH_CONFIGS.json's swim-churn-64 shape detects at round 18."""
    assert _check_churn(64)["detect_round"] == 18


@pytest.mark.slow
def test_churn_4096_matches_golden_and_live_jax():
    assert _check_churn(4096) == goldens.CHURN_FULL_4096_SEED0
