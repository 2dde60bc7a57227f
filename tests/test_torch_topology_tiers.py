"""The port's topology axis (corrosion_tpu_torch/topo/families.py,
sim/topology.py, the tiered branches of swim._reachable and of both
rounds' broadcasts) against the live JAX reference, exact.

The registries equal JAX's; then each function on inputs made from a
seed with numpy — `azs` and `edge_delay`'s three branches at node counts
the regions do not divide (every block boundary among the edges),
`apply_degree_caps`, the tier thresholds, `tiered_edge_drop` at [E, P]
sizes that are and are not a multiple of 128 bytes, with and without
the certainty pin (a synthetic topology whose cross-region tier is at
p = 1: no family reaches it), `_reachable`'s tiered branch on random
states — against JAX's; then the write storm at a few hundred nodes for
every family under the uniform sampler, on the packed round and on the
dense round, field for field, one of them round by round, and the
tiered storm's flight-recorder trace.  The PeerSwap runs are in
tests/test_torch_peerswap.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import swim as jswim
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.topo import families as jfam
from corrosion_tpu_torch.sim import rng, swim
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import telemetry
from corrosion_tpu_torch.sim import topology as ptopo
from corrosion_tpu_torch.topo import families as pfam
from tests.torch_parity import (
    N_RUN,
    P_RUN,
    SEED,
    assert_metrics_equal,
    assert_states_equal,
    jax_telemetry,
    run_topology_pair,
    to_port,
    topology_storm,
)

FAMILIES = sorted(jfam.FAMILIES)
#: the cross-region tier at certainty (raw threshold 256): JAX's pin
PIN = dict(n_regions=2, inter_loss=1.0)
#: a wider grid than any family: 5 regions × 3 AZs, all three loss tiers
GRID = dict(n_regions=5, n_azs=3, intra_delay=0, az_delay=1, inter_delay=3,
            loss=0.05, az_loss=0.2, inter_loss=0.6)


def _topos(kw):
    return jtopo.Topology(**kw), ptopo.Topology(**kw)


def _family(name):
    return _topos(jfam.family_topology(name))


# -- the registries ----------------------------------------------------------


def test_family_registry_matches_jax():
    assert pfam.FAMILIES == jfam.FAMILIES
    assert pfam.FLY_REGIONS == jfam.FLY_REGIONS
    assert pfam.FLY_RTT_MS == jfam.FLY_RTT_MS
    assert pfam.FLY_MS_PER_ROUND == jfam.FLY_MS_PER_ROUND
    for ms in (40.0, 25.0, 100.0):
        assert pfam.rtt_matrix_to_delay_classes(pfam.FLY_RTT_MS, ms) == \
            jfam.rtt_matrix_to_delay_classes(jfam.FLY_RTT_MS, ms)
    for name in FAMILIES:
        assert pfam.family_topology(name) == jfam.family_topology(name)
        assert pfam.min_delay_slots(pfam.family_topology(name)) == \
            jfam.min_delay_slots(jfam.family_topology(name))
        j, p = _family(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.max_delay == j.max_delay
        assert ptopo.loss_tiers(p) == jtopo.loss_tiers(j)
        assert ptopo.loss_tiered(p) == jtopo.loss_tiered(j)
    with pytest.raises(KeyError, match="unknown topology family"):
        pfam.family_topology("mesh")


@pytest.mark.parametrize("kw", (
    dict(degree_classes=(3, 0)),
    dict(n_regions=2, region_delay_matrix=((0, 1),)),
    dict(n_regions=2, n_azs=2, region_delay_matrix=((0, 1), (1, 0))),
    dict(n_regions=2, region_delay_matrix=((0, -1), (1, 0))),
    dict(n_azs=0),
    dict(az_loss=1.5),
))
def test_topology_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jtopo.Topology(**kw)
    with pytest.raises(ValueError) as got:
        ptopo.Topology(**kw)
    assert str(got.value) == str(want.value)


# -- blocks, delays, caps ----------------------------------------------------


@pytest.mark.parametrize("n", (7, 100, 1001, 100_000))
@pytest.mark.parametrize("kw", ({"n_regions": 3, "n_azs": 2}, GRID,
                                {"n_regions": 6}, {"n_regions": 4,
                                                   "n_azs": 5}))
def test_regions_and_azs_match_jax(n, kw):
    """Every node id, so every block boundary: the last region takes the
    remainder and its local AZ index clamps."""
    j, p = _topos(kw)
    np.testing.assert_array_equal(
        np.asarray(jtopo.regions(n, j.n_regions)),
        ptopo.regions(n, p.n_regions, "cpu").numpy())
    np.testing.assert_array_equal(np.asarray(jtopo.azs(n, j)),
                                  ptopo.azs(n, p, "cpu").numpy())


def _edges(g, n, e):
    """E random edges with every pair of block-boundary ids among them."""
    b = sorted({0, n - 1, *range(0, n, max(1, n // 12)),
                *range(max(0, n // 3 - 2), n // 3 + 2)})
    pairs = np.array([(s, d) for s in b for d in b])
    src = g.integers(0, n, e)
    dst = np.where(g.random(e) < 0.05, src, g.integers(0, n, e))
    k = min(len(pairs), e)
    src[:k], dst[:k] = pairs[:k, 0], pairs[:k, 1]
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("kw", (
    {"n_regions": 2, "inter_delay": 2},  # the flat two-class branch
    jfam.family_topology("wan-3x2"),  # the AZ branch
    GRID,
    jfam.family_topology("wan-fly-6r"),  # the measured matrix
))
def test_edge_delay_and_slot_match_jax(kw):
    g = np.random.default_rng(3)
    n, e = 1001, 6000
    j, p = _topos(kw)
    src, dst = _edges(g, n, e)
    jreg = jtopo.regions(n, j.n_regions)
    preg = ptopo.regions(n, p.n_regions, "cpu")
    want = np.asarray(jtopo.edge_delay(j, jreg, jnp.asarray(src),
                                       jnp.asarray(dst)))
    ts, td = torch.as_tensor(src), torch.as_tensor(dst)
    got = ptopo.edge_delay(p, preg, ts, td)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int32
    d = max(j.max_delay, 1) + 1
    fdelay = g.integers(0, 2, e).astype(np.int32)
    for t in (0, 5, 17):
        np.testing.assert_array_equal(
            (t + want + fdelay) % d,
            ptopo.edge_slot(p, preg, ts, td, t, d,
                            torch.as_tensor(fdelay)).numpy())


@pytest.mark.parametrize("classes", ((3, 2, 1), (2,), (1, 3), (3, 3, 2, 1)))
def test_apply_degree_caps_matches_jax(classes):
    g = np.random.default_rng(len(classes))
    n, f = 101, 3
    targets = np.where(g.random((n, f)) < 0.1, -1,
                       g.integers(0, n, (n, f))).astype(np.int32)
    j, p = _topos({"degree_classes": classes})
    want = np.asarray(jtopo.apply_degree_caps(jnp.asarray(targets), j))
    got = ptopo.apply_degree_caps(torch.as_tensor(targets), p)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(np.asarray(jtopo.node_degrees(n, j)),
                                  ptopo.node_degrees(n, p, "cpu").numpy())
    flat = ptopo.Topology()
    t = torch.as_tensor(targets)
    assert ptopo.apply_degree_caps(t, flat) is t


# -- tiered loss -------------------------------------------------------------


@pytest.mark.parametrize("kw", (jfam.family_topology("wan-3x2"),
                                jfam.family_topology("wan-2region"),
                                jfam.family_topology("wan-fly-6r"), GRID,
                                PIN))
def test_edge_loss_thresholds_match_jax(kw):
    g = np.random.default_rng(5)
    n, e = 1001, 4000
    j, p = _topos(kw)
    src, dst = _edges(g, n, e)
    jreg = jtopo.regions(n, j.n_regions)
    preg = ptopo.regions(n, p.n_regions, "cpu")
    args_j = (j, jreg, jnp.asarray(src), jnp.asarray(dst))
    args_p = (p, preg, torch.as_tensor(src), torch.as_tensor(dst))
    raw = ptopo.edge_loss_thresholds_raw(*args_p)
    np.testing.assert_array_equal(
        np.asarray(jtopo.edge_loss_thresholds_raw(*args_j)), raw.numpy())
    assert raw.dtype == torch.int32
    clamped = ptopo.edge_loss_thresholds(*args_p)
    np.testing.assert_array_equal(
        np.asarray(jtopo.edge_loss_thresholds(*args_j)), clamped.numpy())
    assert clamped.dtype == torch.uint8


@pytest.mark.parametrize("kw", (jfam.family_topology("wan-3x2"), GRID, PIN))
@pytest.mark.parametrize("e, p", ((96, 16), (97, 13), (1000, 1), (3003, 7)))
def test_tiered_edge_drop_matches_jax(kw, e, p):
    """[E, P] sizes that are (96·16, 1000 = not: 1000 % 128 = 104) and are
    not multiples of 128 bytes; PIN pins its cross-region edges."""
    g = np.random.default_rng(e * p)
    n = 333
    j, pt = _topos(kw)
    src, dst = _edges(g, n, e)
    jreg = jtopo.regions(n, j.n_regions)
    preg = ptopo.regions(n, pt.n_regions, "cpu")
    shape = (e, p) if p > 1 else (e,)
    want = np.asarray(jtopo.tiered_edge_drop(
        j, jax.random.PRNGKey(e), jreg, jnp.asarray(src), jnp.asarray(dst),
        shape))
    got = ptopo.tiered_edge_drop(pt, rng.prng_key(e, "cpu"), preg,
                                 torch.as_tensor(src), torch.as_tensor(dst),
                                 shape)
    np.testing.assert_array_equal(want, got.numpy())
    if kw is PIN:
        raw = ptopo.edge_loss_thresholds_raw(
            pt, preg, torch.as_tensor(src), torch.as_tensor(dst))
        assert bool(got[raw >= 256].all()) and bool((raw >= 256).any())
    if p > 1:
        wantp = np.asarray(jtopo.edge_payload_drop(
            j, jax.random.PRNGKey(e), e, p, src=jnp.asarray(src),
            dst=jnp.asarray(dst), region=jreg))
        gotp = ptopo.edge_payload_drop(
            pt, rng.prng_key(e, "cpu"), e, p, src=torch.as_tensor(src),
            dst=torch.as_tensor(dst), region=preg)
        np.testing.assert_array_equal(wantp, gotp.numpy())


def _random_state(g, cfg):
    """A JAX state with 5% dead nodes and a split off the block edges."""
    st = jstate.init_state(cfg, jax.random.PRNGKey(1))
    n = cfg.n_nodes
    alive = (g.random(n) < 0.05).astype(np.uint8) * 2
    group = (np.arange(n) >= n // 3 + 7).astype(np.int32)
    return st._replace(alive=jnp.asarray(alive), group=jnp.asarray(group))


@pytest.mark.parametrize("kw", (jfam.family_topology("wan-3x2"),
                                jfam.family_topology("wan-fly-6r"), GRID,
                                PIN))
@pytest.mark.parametrize("fan", (1, 3))
def test_reachable_tiered_matches_jax(kw, fan):
    """E = N (1000 bytes: not a multiple of 128) and E = 3N."""
    g = np.random.default_rng(fan)
    n = 1000
    cfg = jstate.SimConfig(n_nodes=n, n_payloads=32)
    js = _random_state(g, cfg)
    ps = to_port(js, cfg)
    j, p = _topos(kw)
    src = np.repeat(np.arange(n), fan).astype(np.int32)
    dst = g.integers(0, n, n * fan).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jswim._reachable(js, j, key, jnp.asarray(src),
                                       jnp.asarray(dst)))
    got = swim._reachable(ps, p, rng.prng_key(9, "cpu"),
                          torch.as_tensor(src), torch.as_tensor(dst))
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.bool


# -- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("packed", (True, False), ids=("packed", "dense"))
@pytest.mark.parametrize("family", FAMILIES)
def test_write_storm_family_matches_jax(family, packed):
    run_topology_pair(family, None, packed)


def test_tiered_storm_packed_round_by_round():
    """wan-3x2 on the packed round, JAX's jitted packed_round_step beside
    the port's: the first diverging round and field are named."""
    from corrosion_tpu.sim import packed as jpacked
    from corrosion_tpu.sim.round import new_metrics as jnew_metrics
    from corrosion_tpu_torch.sim import packed as ppacked

    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm("wan-3x2", None, True)
    js, ps = jround.new_sim(jcfg, SEED), pround.new_sim(pcfg, SEED, "cpu")
    jc, pc = jpacked.pack_state(js, jcfg), ppacked.pack_state(ps, pcfg)
    ji, pi = jpacked.pack_bits(js.injected), ppacked.pack_bits(ps.injected)
    js, ps = jpacked.shrink_state(js), ppacked.shrink_state(ps)
    jm, pm = jnew_metrics(jcfg), pround.new_metrics(pcfg, "cpu")
    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    jreg = jtopo.regions(N_RUN, jt.n_regions)
    preg = ptopo.regions(N_RUN, pt.n_regions, "cpu")
    for r in range(60):
        js, jc, ji, jm = step(js, jc, ji, jm, jmeta, jcfg, jt, jreg)
        ps, pc, pi, pm, done = ppacked.packed_round_step(
            ps, pc, pi, pm, pmeta, pcfg, pt, preg)
        label = f"round {r}"
        assert_states_equal(js, ps, label)
        assert_states_equal(jpacked.unpack_into_state(jc, js, jcfg),
                            ppacked.unpack_into_state(pc, ps, pcfg),
                            f"{label} carry")
        assert_metrics_equal(jm, pm, label)
        jdone = bool(jpacked._converged_done(js, jm, jmeta))
        assert jdone == bool(done), label
        if jdone:
            break
    assert jdone


def test_tiered_storm_trace_matches_jax():
    """The recorder on wan-3x2 (packed): every RoundTrace channel of the
    port's run equals JAX's — the dropped frames from the tiered stream
    included — and the two f32 byte channels lie within (m + 1)·2⁻²⁴ of
    JAX's rows, m the f32 terms JAX adds (N·F edges, P grants)."""
    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm("wan-3x2", None, True)
    with jax_telemetry() as jtel:
        jout = jround.run_to_convergence(jround.new_sim(jcfg, SEED), jmeta,
                                         jcfg, jt, 400, telemetry=True)
        rounds = int(jout[0].t)
        jhost = jtel.trace_host(jout[2], rounds)
        want = jtel.trace_summary(jhost, rounds, jcfg)
    pout = pround.run_to_convergence(pround.new_sim(pcfg, SEED, "cpu"),
                                     pmeta, pcfg, pt, 400, True)
    assert_states_equal(jout[0], pout[0], "trace run")
    assert telemetry.wire_loss_active(pt, None)
    phost = telemetry.trace_host(pout[2], rounds)
    bound = {"bcast_bytes": (N_RUN * pcfg.fanout + 1) * 2.0 ** -24,
             "sync_bytes": (P_RUN + 1) * 2.0 ** -24}
    for name in telemetry.CHANNELS:
        if name in bound:
            np.testing.assert_allclose(np.asarray(jhost[name]), phost[name],
                                       rtol=bound[name], err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(jhost[name]),
                                          phost[name], err_msg=name)
    got = telemetry.trace_summary(phost, rounds, pcfg)
    assert got["fault"]["dropped_frames"] > 0
    wire_w, wire_g = want.pop("wire_bytes"), got.pop("wire_bytes")
    assert got == want
    for key in ("broadcast", "sync"):
        assert abs(wire_w[key] - wire_g[key]) <= (
            (N_RUN * pcfg.fanout + 2 * rounds) * 2.0 ** -24 * wire_w[key]
            + 0.1)
