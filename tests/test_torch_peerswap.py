"""The port's PeerSwap sampler (corrosion_tpu_torch/topo/sampler.py, the
sampler branches of SimConfig, init_state, swim.sample_member_targets and
both rounds' phase keys) against the live JAX reference, exact.

The configuration's validation; the
initial state under both samplers (the uniform default keeps its three-
way key split, PeerSwap splits four ways and draws the view from the
last key); `init_peer_view`; `psample_view_targets` on views with empty
slots, self entries and repeats, with and without coupled full-view
beliefs; `peerswap_step` on views and states that reach every branch (g
== t % V, several offers to one partner, down nodes, unreachable
partners across a split and through flat, tiered and no loss, wiped
views); then the write storm at a few hundred nodes under PeerSwap for
every topology family on both rounds, field for field with the view,
the dense one round by round, and broadcast-1k on wan-3x2 under
PeerSwap against its golden (the card's) and live JAX.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.topo import families as jfam
from corrosion_tpu.topo import sampler as jsampler
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import pview_digest, state_digest
from corrosion_tpu_torch.sim import rng, runner, swim
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import topology as ptopo
from corrosion_tpu_torch.topo import sampler as psampler
from tests.torch_parity import (
    N_RUN,
    SEED,
    assert_metrics_equal,
    assert_states_equal,
    jax_digest,
    port_config,
    run_topology_pair,
    to_port,
    topology_storm,
)

FAMILIES = sorted(jfam.FAMILIES)


# -- configuration and initial state -----------------------------------------


@pytest.mark.parametrize("kw", (
    dict(peer_sampler="peerswap", view_slots=1),
    dict(peer_sampler="peerswap", swim_partial_view=True),
    dict(peer_sampler="gossip"),
))
def test_sampler_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jstate.SimConfig(n_nodes=8, n_payloads=4, **kw)
    with pytest.raises(ValueError) as got:
        pstate.SimConfig(n_nodes=8, n_payloads=4, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sampler, n, v, extra", (
    *((sampler, n, v, extra) for sampler in ("uniform", "peerswap")
      for n, v, extra in ((5, 2, {}), (97, 16, {}),
                          (300, 7, dict(swim_full_view=True)))),
    ("uniform", 300, 16, dict(swim_partial_view=True, member_slots=16)),
))
def test_init_state_matches_jax(sampler, n, v, extra):
    """Every field, the view included: PeerSwap's four-way split and the
    uniform default's three-way one (partial view only with the uniform
    sampler: PeerSwap refuses it)."""
    jcfg = jstate.SimConfig(n_nodes=n, n_payloads=32, peer_sampler=sampler,
                            view_slots=v, **extra)
    pcfg = port_config(jcfg)
    for seed in (0, 11):
        want = jstate.init_state(jcfg, jax.random.PRNGKey(seed))
        got = pstate.init_state(pcfg, rng.prng_key(seed, "cpu"))
        assert_states_equal(want, got, f"seed {seed}")
        assert got.pview.shape == ((n, v) if sampler == "peerswap"
                                   else (n, 0))


def test_init_peer_view_matches_jax():
    for n, v in ((3, 2), (1000, 16), (333, 5)):
        jcfg = jstate.SimConfig(n_nodes=n, n_payloads=4,
                                peer_sampler="peerswap", view_slots=v)
        want = jsampler.init_peer_view(jcfg, jax.random.PRNGKey(n))
        got = psampler.init_peer_view(port_config(jcfg),
                                      rng.prng_key(n, "cpu"))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert got.dtype == torch.int32


# -- the view sampler --------------------------------------------------------


def _views(g, n, v, wiped=0.05):
    """Views with one slot in eight empty, self entries, repeats and
    wiped rows."""
    ids = g.integers(0, n, (n, v))
    ids = np.where(g.random((n, v)) < 0.125, -1, ids)
    ids = np.where(g.random((n, v)) < 0.05, np.arange(n)[:, None], ids)
    ids[:, 1] = np.where(g.random(n) < 0.3, ids[:, 0], ids[:, 1])
    ids[g.random(n) < wiped] = -1
    return ids.astype(np.int32)


def _states(g, n, v, full_view=False, **cfg_kw):
    """A JAX state under PeerSwap with random views, 5% dead nodes, a
    split, and (full view) random beliefs; and its port twin."""
    jcfg = jstate.SimConfig(n_nodes=n, n_payloads=32, peer_sampler="peerswap",
                            view_slots=v, swim_full_view=full_view, **cfg_kw)
    js = jstate.init_state(jcfg, jax.random.PRNGKey(2))
    js = js._replace(
        pview=jnp.asarray(_views(g, n, v)),
        alive=jnp.asarray((g.random(n) < 0.05).astype(np.uint8) * 2),
        group=jnp.asarray((np.arange(n) >= n // 3 + 5).astype(np.int32)),
        t=jnp.int32(13),
    )
    if full_view:
        js = js._replace(view=jnp.asarray(
            g.integers(0, 3, (n, n)).astype(np.int8)))
    return jcfg, js, port_config(jcfg), to_port(js, jcfg)


@pytest.mark.parametrize("count", (1, 3))
@pytest.mark.parametrize("full_view", (False, True))
def test_psample_view_targets_matches_jax(count, full_view):
    g = np.random.default_rng(count + 10 * full_view)
    jcfg, js, pcfg, ps = _states(g, 301, 16, full_view)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jsampler.psample_view_targets(js, jcfg, key, count))
    got = psampler.psample_view_targets(ps, pcfg, rng.prng_key(4, "cpu"),
                                        count)
    np.testing.assert_array_equal(want, got.numpy())
    assert (want == -1).any()
    # the dispatch of sample_member_targets reaches the view sampler
    np.testing.assert_array_equal(
        np.asarray(jswim.sample_member_targets(js, jcfg, key, count)),
        swim.sample_member_targets(ps, pcfg, rng.prng_key(4, "cpu"),
                                   count).numpy())


@pytest.mark.parametrize("t", (13, 16, 30))
@pytest.mark.parametrize("topo_kw", ({}, {"loss": 0.2},
                                     jfam.family_topology("wan-3x2")))
def test_peerswap_step_matches_jax(t, topo_kw):
    """A swap tick against JAX's on 401 nodes, whose partner slots c
    (drawn from the key) give g == t % V for about one node in 16: a hub
    many views hold (several offers to one partner), down nodes, a split
    (unreachable partners), flat, bernoulli-lossy and tiered
    reachability, wiped views."""
    g = np.random.default_rng(t)
    n, v = 401, 16
    jcfg, js, pcfg, ps = _states(g, n, v)
    pv = np.asarray(js.pview).copy()
    pv[g.random(n) < 0.05, :] = 7  # a hub
    js = js._replace(pview=jnp.asarray(pv), t=jnp.int32(t))
    ps = ps._replace(pview=torch.as_tensor(pv),
                     t=torch.tensor(t, dtype=torch.int32))
    jt, pt = jtopo.Topology(**topo_kw), ptopo.Topology(**topo_kw)
    want = jsampler.peerswap_step(js, jcfg, jt, jax.random.PRNGKey(t))
    got = psampler.peerswap_step(ps, pcfg, pt, rng.prng_key(t, "cpu"))
    np.testing.assert_array_equal(np.asarray(want.pview), got.pview.numpy())
    assert not np.array_equal(np.asarray(want.pview), pv)


# -- whole runs --------------------------------------------------------------


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", FAMILIES)
def test_peerswap_storm_family_matches_jax(family, packed):
    jout, pout = run_topology_pair(family, "peerswap", packed)
    assert pout[0].pview.shape == (N_RUN, 16)
    np.testing.assert_array_equal(np.asarray(jout[0].pview),
                                  pout[0].pview.numpy())


def test_peerswap_dense_round_by_round():
    """wan-3x2 under PeerSwap on the dense round, JAX's jitted round_step
    beside the port's, the view compared every round."""
    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm("wan-3x2", "peerswap", False)
    js, ps = jround.new_sim(jcfg, SEED), pround.new_sim(pcfg, SEED, "cpu")
    jm, pm = jround.new_metrics(jcfg), pround.new_metrics(pcfg, "cpu")
    step = jax.jit(jround.round_step, static_argnums=(3, 4))
    jreg = jtopo.regions(N_RUN, jt.n_regions)
    preg = ptopo.regions(N_RUN, pt.n_regions, "cpu")
    for r in range(80):
        js, jm = step(js, jm, jmeta, jcfg, jt, jreg)
        ps, pm = pround.round_step(ps, pm, pmeta, pcfg, pt, preg)
        assert_states_equal(js, ps, f"round {r}")
        assert_metrics_equal(jm, pm, f"round {r}")
        if bool(pround._converged_done(ps, pm, pmeta)):
            break
    else:
        raise AssertionError("the dense PeerSwap storm did not converge")


def test_broadcast_1k_wan_3x2_peerswap_matches_golden():
    """config_broadcast_1k(topo_family="wan-3x2", sampler="peerswap"):
    the port's CPU run, the golden the card is held to, and live JAX."""
    golden = goldens.BROADCAST_1K_WAN_3X2_PEERSWAP_SEED0
    got = runner.config_broadcast_1k(seed=0, topo_family="wan-3x2",
                                     sampler="peerswap", device="cpu",
                                     return_state=True)
    assert got["round_path"] == "dense"
    assert {k: got[k] for k in golden if "digest" not in k} == {
        k: v for k, v in golden.items() if "digest" not in k}
    assert state_digest(got["state"]) == golden["digest"]
    assert pview_digest(got["state"]) == golden["pview_digest"]
    topo = jrunner._resolve_topo("wan-3x2")
    jcfg = jstate.SimConfig(n_nodes=1000, n_payloads=256, n_writers=8,
                            fanout=3, n_delay_slots=max(4, topo.max_delay + 1),
                            peer_sampler="peerswap")
    jmeta = jstate.uniform_payloads(jcfg, inject_every=2)
    jcfg = jstate.optimize_budgets(jcfg, jmeta)
    final, _ = jround.run_to_convergence(jround.new_sim(jcfg, 0), jmeta, jcfg,
                                         topo, 2000)
    assert jax_digest(final) == golden["digest"]
    assert jax_digest(final, skip=[f for f in type(final)._fields
                                   if f != "pview"]) == golden["pview_digest"]
    assert_states_equal(final, got["state"], "broadcast-1k")


@pytest.mark.slow
@pytest.mark.parametrize("name, kw", (
    ("STORM_WAN_3X2_100K_SEED0", dict(topo_family="wan-3x2")),
    ("STORM_WAN_FLY_6R_100K_SEED0", dict(topo_family="wan-fly-6r")),
    ("STORM_HETERO_DEGREE_100K_SEED0", dict(topo_family="hetero-degree")),
    ("STORM_PEERSWAP_25600_SEED0", dict(n_nodes=25_600, sampler="peerswap")),
))
def test_topology_storm_goldens_match_live_jax(name, kw):
    """The card's storm goldens against live JAX (~40 s each at 100k on 8
    cores); the PeerSwap storm also on the port's CPU path."""
    golden = getattr(goldens, name)
    n = kw.get("n_nodes", 100_000)
    topo = jrunner._resolve_topo(kw.get("topo_family"))
    jcfg, jmeta = jrunner._write_storm(n, 512, topo=topo,
                                       sampler=kw.get("sampler"))
    final, metrics = jround.run_to_convergence(jround.new_sim(jcfg, 0), jmeta,
                                               jcfg, topo, 3000)
    cov = np.asarray(metrics.coverage_at)
    lat = np.where(cov >= 0, cov - np.asarray(jmeta.round), -1)
    live = {
        "rounds": int(final.t),
        "p99_node_convergence_round": jrunner._percentile(
            np.asarray(metrics.converged_at), 99),
        "p99_payload_latency_rounds": jrunner._percentile(lat, 99),
        "digest": jax_digest(final),
    }
    if "pview_digest" in golden:
        live["pview_digest"] = jax_digest(
            final, skip=[f for f in type(final)._fields if f != "pview"])
    assert live == golden
    if kw.get("sampler"):
        got = runner.config_write_storm_100k(seed=0, device="cpu",
                                             return_state=True, **kw)
        assert_states_equal(final, got["state"], name)
