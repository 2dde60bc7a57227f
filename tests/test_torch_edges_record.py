"""K2's edge pass and K2 on its edge lists, and K7's one-launch record with its
overflow fold (corrosion_tpu_torch/sim/packed.py, lanes.py), their plain
versions against the JAX reference: the edge lists of JAX's broadcast and
sync (packed.py:435-441 with topology.py:157 edge_delay's flat branch,
and :1178-1184 with due), the broadcast's ring scatter (packed.py:497-512)
and the converge block with the overflow fold (packed.py:779-819, both
exit modes); then the lane wrappers at K = 3 against their solo runs,
lane by lane.  Ids, masks, slots, words and stamps are integers and the
overflow fraction one f32 product and max: exact, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim import topology as jtopology
from corrosion_tpu.sim.round import RunMetrics as JaxRunMetrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu_torch.sim import lanes as ln
from corrosion_tpu_torch.sim import packed
from corrosion_tpu_torch.sim.round import RunMetrics
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import storm_configs

# N * A = 300 * 16 = 4800 cells, not a power of two (the f32 product
# XLA's mean takes is then not the quotient)
N, P, F = 300, 256, 3
W = P // 32
T, D = 5, 3
LANES = 3


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, P)


def _topos():
    """Two regions with different intra- and inter-region delays."""
    kw = dict(n_regions=2, intra_delay=1, inter_delay=2)
    return jtopology.Topology(**kw), Topology(**kw)


def _edge_inputs(g, lead=()):
    """Targets with -1 and self entries, two partition groups, SUSPECT
    and DOWN rows, a due mask."""
    targets = g.integers(-1, N, (*lead, N, F)).astype(np.int32)
    me = np.arange(N, dtype=np.int32)[:, None]
    targets = np.where(g.random((*lead, N, F)) < 0.1, me, targets)
    group = (g.random((*lead, N)) < 0.4).astype(np.int32)
    alive = g.choice(np.array([0, 0, 0, 0, 1, 2], np.uint8), (*lead, N))
    due = g.random((*lead, N)) < 0.6
    return targets, group, alive, due


def _jax_edges(targets, group, alive, due, topo, t, d):
    """JAX's edge list: packed.py:435-441 and the slot of :510 (the
    broadcast), or :1178-1184 with ``due`` (the sync)."""
    n, f = targets.shape
    src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), f)
    dst = jnp.asarray(targets).reshape(-1)
    ok = dst >= 0
    dst = jnp.maximum(dst, 0)
    ok &= jtopology.edge_alive(jnp.asarray(group), jnp.asarray(alive), src,
                               dst)
    if due is not None:
        ok &= jnp.asarray(due)[src]
    ok &= dst != src
    region = jtopology.regions(n, topo.n_regions)
    slot = (t + jtopology.edge_delay(topo, region, src, dst)) % d
    return np.asarray(dst), np.asarray(ok), np.asarray(slot)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", ("broadcast", "sync"))
def test_edge_list_matches_jax(seed, kind):
    """The edge pass's plain version (through its wrapper on CPU tensors)
    against JAX's edge lists, every trap reached: -1 and self targets,
    cross-group, SUSPECT and DOWN ends, due and not due senders, both
    delay classes."""
    g = np.random.default_rng(seed)
    targets, group, alive, due = _edge_inputs(g)
    jtopo, topo = _topos()
    due = due if kind == "sync" else None
    want = _jax_edges(targets, group, alive, due, jtopo, T, D)
    region = regions(N, topo.n_regions, "cpu")
    got = packed.edge_list(
        torch.from_numpy(targets), torch.from_numpy(group),
        torch.from_numpy(alive), None if due is None
        else torch.from_numpy(due), topo if kind == "broadcast" else None,
        region, T, D)
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg="dst")
    np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg="ok")
    if kind == "broadcast":
        np.testing.assert_array_equal(got[2].numpy(), want[2],
                                      err_msg="slot")
        assert len(set(want[2].tolist())) == 2, "one delay class only"
    else:
        assert got[2] is None
    ok = want[1]
    assert ok.any() and not ok.all()
    self_edge = targets.reshape(-1) == np.repeat(np.arange(N), F)
    assert self_edge.any() and not ok[self_edge].any()


@pytest.mark.parametrize("seed", (2, 3))
def test_broadcast_scatter_matches_jax(seed):
    """The edge pass then K2 (plain versions, through their wrappers on
    CPU tensors) against JAX's ring scatter over its own edge list: sent
    words ORed into the u8 ring at slot[e] * N + dst[e] by scatter-max."""
    g = np.random.default_rng(seed)
    targets, group, alive, _ = _edge_inputs(g)
    jtopo, topo = _topos()
    sending = g.integers(0, 1 << 32, (N, W), dtype=np.uint32)
    sending[g.random(N) < 0.3] = 0
    ring = (g.random((D, N, P)) < 0.05).astype(np.uint8)
    dst, ok, slot = _jax_edges(targets, group, alive, None, jtopo, T, D)
    elig8 = jpacked.unpack_bits(jnp.asarray(sending), P).astype(jnp.uint8)
    sent = jnp.where(jnp.asarray(ok).reshape(N, F, 1), elig8[:, None, :],
                     jnp.uint8(0)).reshape(N * F, P)
    want = (jnp.asarray(ring).reshape(D * N, P)
            .at[jnp.asarray(slot) * N + jnp.asarray(dst)].max(sent)
            .reshape(D, N, P))
    words = packed.pack_bits(torch.from_numpy(ring))
    pdst, pok, pslot = packed.edge_list(
        torch.from_numpy(targets), torch.from_numpy(group),
        torch.from_numpy(alive), None, topo, regions(N, 2, "cpu"), T, D)
    packed.scatter_sending(words, torch.from_numpy(sending.view(np.int32)),
                           pdst, pslot, pok, F)
    got = packed.unpack_bits(words, P).numpy().astype(np.uint8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != ring).any(), "the scatter set no bit"


def test_edge_lanes_match_solo():
    """The edge pass and K2's lane entry at K = 3: each lane equal to the
    solo call on its own targets, groups, alive rows and due mask."""
    g = np.random.default_rng(4)
    targets, group, alive, due = (torch.from_numpy(x) for x in
                                  _edge_inputs(g, (LANES,)))
    _, topo = _topos()
    region = regions(N, 2, "cpu")
    sending = torch.from_numpy(g.integers(0, 1 << 32, (LANES, N, W),
                                          dtype=np.uint32).view(np.int32))
    ring0 = torch.from_numpy(g.integers(0, 1 << 32, (LANES, D, N, W),
                                        dtype=np.uint32).view(np.int32))
    ring0 &= torch.from_numpy(g.integers(0, 1 << 32, (LANES, D, N, W),
                                         dtype=np.uint32).view(np.int32))
    for lane_due, lane_topo in ((None, topo), (due, None)):
        got = packed.edge_list(targets, group, alive, lane_due, lane_topo,
                               region, T, D)
        for k in range(LANES):
            want = packed.edge_list(
                targets[k], group[k], alive[k],
                None if lane_due is None else lane_due[k], lane_topo, region,
                T, D)
            for name, a, b in zip(("dst", "ok", "slot"), got, want):
                if b is None:
                    assert a is None, name
                else:
                    assert torch.equal(a[k], b), f"lane {k} {name}"
    dst, ok, slot = packed.edge_list(targets, group, alive, None, topo,
                                     region, T, D)
    ring = ring0.clone()
    ln.scatter_lanes(ring, sending, dst, slot, ok, F)
    for k in range(LANES):
        solo = ring0[k].clone()
        packed.scatter_sending(solo, sending[k], dst[k], slot[k], ok[k], F)
        assert torch.equal(ring[k], solo), f"lane {k} ring"


def _record_inputs(g, t, a, lead=()):
    """Have words with dead rows and holes (bit 31 set where held),
    injected words, stamps, and per-(node, actor) overflow flags."""
    have = np.full((*lead, N, W), 0xFFFFFFFF, dtype=np.uint32)
    dead = g.random((*lead, N)) < 0.15
    alive = (dead * 2).astype(np.uint8)
    have[dead] &= g.integers(0, 1 << 32, (int(dead.sum()), W),
                             dtype=np.uint32)
    rows = ~dead & (g.random((*lead, N)) < 0.3)
    have[rows, : W // 2] &= g.integers(0, 1 << 32, (int(rows.sum()), W // 2),
                                       dtype=np.uint32)
    inj = g.integers(0, 1 << 32, (*lead, W), dtype=np.uint32)
    inj |= g.integers(0, 1 << 32, (*lead, W), dtype=np.uint32)
    cov = np.where(g.random((*lead, P)) < 0.3, g.integers(0, t + 1, P), -1)
    conv = np.where(g.random((*lead, N)) < 0.3, g.integers(0, t + 1, N), -1)
    overflow = g.random((*lead, N, a)) < g.uniform(0.01, 0.2)
    return (have, alive, inj, cov.astype(np.int32), conv.astype(np.int32),
            overflow)


def _jax_record(have, alive, inj, cov, conv, overflow, old, meta, t, cfg,
                horizon):
    """JAX's overflow fold (packed.py:779-781), converge block
    (:789-819) and the loop's flag after the round: _converged_done at
    t + 1, or the fault loop's (t + 1 >= horizon and all_have_words)."""
    c = cfg.chunks_per_version
    have = jnp.asarray(have)
    inj = jnp.asarray(inj)
    up = jnp.asarray(alive) == 0
    frac = jnp.maximum(jnp.float32(old),
                       jnp.asarray(overflow).mean(dtype=jnp.float32))
    comp_w = jpacked.all_chunks_words(have, cfg)
    act_w = jpacked._smear_groups(
        jpacked._fold_any(inj, c) & jpacked._group_low_bits_mask(c), c)
    masked = jnp.where(up[:, None], comp_w, jpacked.ONES)
    payload_done = (jnp.all(jpacked.unpack_bits(masked, cfg.n_payloads),
                            axis=0)
                    & jpacked.unpack_bits(act_w, cfg.n_payloads))
    cov = jnp.where((cov < 0) & payload_done, t, cov)
    node_done = ((comp_w | ~act_w[None, :]) == jpacked.ONES).all(axis=1) & up
    conv = jnp.where((conv < 0) & node_done & jnp.all(meta.round <= t), t,
                     conv)
    slim = jax_new_sim(cfg, 0)._replace(t=jnp.int32(t + 1),
                                        alive=jnp.asarray(alive))
    if horizon is None:
        metrics = JaxRunMetrics(coverage_at=cov, converged_at=conv,
                                overflow_frac=frac,
                                order_violations=jnp.int32(0))
        done = bool(jpacked._converged_done(slim, metrics, meta))
    else:
        carry = jpacked.PackedCarry(have=have, inflight=None, relay=None,
                                    sync_buf=None)
        done = t + 1 >= horizon and bool(
            jpacked.all_have_words(carry, inj, slim, meta, cfg))
    return np.asarray(cov), np.asarray(conv), np.asarray(frac), done


def _metrics(cov, conv, old):
    return RunMetrics(
        coverage_at=torch.from_numpy(cov), converged_at=torch.from_numpy(conv),
        overflow_frac=torch.tensor(old, dtype=torch.float32),
        order_violations=torch.zeros(cov.shape[:-1], dtype=torch.int32))


def _u32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("horizon", (None, 8))
@pytest.mark.parametrize("t, old", ((4, 0.0), (7, 0.0), (7, 0.5),
                                    (12, 0.0)))
def test_converge_record_overflow_matches_jax(cfgs, t, old, horizon):
    """K7's plain version with the overflow fold against JAX's, in the
    faultless and the fault loop's exit mode: stamps, the overflow
    fraction bit for bit (one f32 product with the cell count's
    reciprocal, then the max, at 4800 cells) and the done flag."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(100 + t)
    have, alive, inj, cov, conv, overflow = _record_inputs(
        g, t, pcfg.n_writers)
    if t >= 7:
        inj[:] = 0xFFFFFFFF  # every version active: done can come
        have[alive == 0] = 0xFFFFFFFF
    want = _jax_record(have, alive, inj, cov, conv, overflow, old, jmeta, t,
                       jcfg, horizon)
    count = torch.tensor(int(overflow.sum()), dtype=torch.int32)
    got = packed.converge_record(
        _u32(have), _u32(inj), torch.from_numpy(alive),
        _metrics(cov, conv, old), pmeta, t, pcfg, count,
        int(pmeta.round.max()), horizon)
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg="cov")
    np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg="conv")
    assert got[2].dtype == torch.float32
    assert got[2].numpy().view(np.int32) == want[2].view(np.int32), (
        float(got[2]), float(want[2]))
    assert bool(got[3]) == want[3]
    # both flag values come: early, and once every payload is injected
    assert want[3] == (t >= 7), (t, horizon)
    assert float(want[2]) == max(old, float(want[2])) > 0.0


@pytest.mark.parametrize("horizon", (None, 13))
def test_converge_record_lanes_match_solo(cfgs, horizon):
    """K7's lane wrapper at K = 3 against the solo record lane by lane:
    lanes with different overflow counts, one of them done."""
    _, _, pcfg, pmeta = cfgs
    g = np.random.default_rng(7)
    t = 12
    have, alive, inj, cov, conv, overflow = _record_inputs(
        g, t, pcfg.n_writers, (LANES,))
    have[0][alive[0] == 0] = 0xFFFFFFFF
    inj[0] = 0xFFFFFFFF
    olds = np.array([0.0, 0.25, 0.0], np.float32)
    counts = torch.from_numpy(overflow.sum(axis=(1, 2)).astype(np.int32))
    got = ln.converge_record_lanes(
        _u32(have), _u32(inj), torch.from_numpy(alive),
        _metrics(cov, conv, olds), pmeta, t, pcfg, counts,
        int(pmeta.round.max()), horizon)
    assert len(set(got[3].tolist())) == 2, "done takes one value only"
    for k in range(LANES):
        want = packed.converge_record(
            _u32(have[k]), _u32(inj[k]), torch.from_numpy(alive[k]),
            _metrics(cov[k], conv[k], olds[k]), pmeta, t, pcfg, counts[k],
            int(pmeta.round.max()), horizon)
        for name, a, b in zip(("coverage_at", "converged_at",
                               "overflow_frac", "done"), got, want):
            assert torch.equal(a[k], b), f"lane {k} {name}"
