"""The port's packed round phases (corrosion_tpu_torch/sim/packed.py,
gaps.py) against the JAX reference on seeded random carries: inject,
broadcast (K8's spend, K2's scatter), the spend on its own, sync (K3's
pull), deliver, the gap refresh (K6's plain version), gap extraction,
gaps_to_mask and the convergence record (K7's plain version).  Words,
counters and stamps are integers: exact, tolerance 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import gaps as jgaps
from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim import state as jstate_mod
from corrosion_tpu.sim.round import RunMetrics as JaxRunMetrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch.sim import gaps, packed, rng
from corrosion_tpu_torch.sim.round import RunMetrics
from corrosion_tpu_torch.sim.state import version_heads
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import random_tables, storm_configs, to_port

N, P = 512, 256
W = P // 32


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, P)


def _words(g, shape, ands=1):
    w = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    for _ in range(ands):
        w &= g.integers(0, 1 << 32, shape, dtype=np.uint32)
    return w


def _jax_carry(g, t):
    """Random packed carry; the sync slot (t+1) % D is zero, as the real
    loop leaves it (deliver cleared it the round before)."""
    sync_buf = _words(g, (2, N, W), 3)
    sync_buf[(t + 1) % 2] = 0
    return jpacked.PackedCarry(
        have=jnp.asarray(_words(g, (N, W))),
        inflight=jnp.asarray((g.random((2, N, P)) < 0.05).astype(np.uint8)),
        relay=jpacked.Planes(*(jnp.asarray(_words(g, (N, W), 2))
                               for _ in range(4))),
        sync_buf=jnp.asarray(sync_buf),
    )


def _port_carry(jc):
    def i32(a):
        return torch.from_numpy(np.array(a).view(np.int32))

    return packed.PackedCarry(
        have=i32(jc.have),
        inflight=packed.pack_bits(torch.from_numpy(np.array(jc.inflight))),
        relay=packed.Planes(*(i32(p) for p in jc.relay)),
        sync_buf=i32(jc.sync_buf),
    )


def _carry_numpy(c):
    """A JAX or port carry in JAX's layout (u32 words, u8 ring)."""
    if isinstance(c.have, torch.Tensor):
        def u32(x):
            return x.numpy().view(np.uint32)

        ring = packed.unpack_bits(c.inflight, P).numpy().astype(np.uint8)
    else:
        def u32(x):
            return np.asarray(x)

        ring = np.asarray(c.inflight)
    out = {"have": u32(c.have), "inflight": ring,
           "sync_buf": u32(c.sync_buf)}
    out.update({f"r{k}": u32(p) for k, p in enumerate(c.relay)})
    return out


def _assert_carry_equal(jc, pc, label):
    want, got = _carry_numpy(jc), _carry_numpy(pc)
    for name in want:
        np.testing.assert_array_equal(want[name], got[name],
                                      err_msg=f"{label}: {name}")


def _state(jcfg, g, t):
    """A storm state with random member tables, countdowns, backoffs and
    gap bookkeeping (from a random touched grid)."""
    pid, pkey, psince = random_tables(g, N, 64, t)
    a, v = jcfg.n_writers, jcfg.n_versions
    touched = g.random((N, a, v)) < 0.6
    heads = np.asarray((touched * np.arange(1, v + 1)).max(axis=2), np.int32)
    gp = jgaps.extract_gaps(jnp.asarray(touched), jnp.asarray(heads), jcfg)
    state = jax_new_sim(jcfg, 3)
    return state._replace(
        t=jnp.int32(t), pid=jnp.asarray(pid), pkey=jnp.asarray(pkey),
        psince=jnp.asarray(psince),
        alive=jnp.asarray((g.random(N) < 0.05).astype(np.uint8) * 2),
        sync_countdown=jnp.asarray(g.integers(-1, 3, N).astype(np.int32)),
        sync_backoff=jnp.asarray(g.integers(8, 33, N).astype(np.int32)),
        heads=jnp.asarray(heads), gap_lo=gp.lo, gap_hi=gp.hi,
    )


@pytest.mark.parametrize("t", (0, 2, 6))
def test_inject_packed(cfgs, t):
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(t)
    jc = _jax_carry(g, t)
    inj = _words(g, (W,), 2)
    alive = (g.random(N) < 0.3).astype(np.uint8) * 2  # some writers down
    jout, jinj = jax.jit(jpacked.inject_packed, static_argnums=(4,))(
        jc, jnp.asarray(inj), jnp.int32(t), jmeta, jcfg, jnp.asarray(alive)
    )
    pout, pinj = packed.inject_packed(
        _port_carry(jc), torch.from_numpy(inj.view(np.int32)), t, pmeta,
        pcfg, torch.from_numpy(alive),
    )
    _assert_carry_equal(jout, pout, "inject")
    np.testing.assert_array_equal(np.asarray(jinj),
                                  pinj.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_broadcast_packed(cfgs, seed):
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(seed)
    t = 4 + seed
    jc = _jax_carry(g, t)
    inj = _words(g, (W,))
    jstate = _state(jcfg, g, t)
    jout = jax.jit(jpacked.broadcast_packed, static_argnums=(3, 4))(
        jc, jnp.asarray(inj), jstate, jcfg, JaxTopology(),
        jax_regions(N, 1), jax.random.PRNGKey(seed), jmeta,
    )
    pout = packed.broadcast_packed(
        _port_carry(jc), torch.from_numpy(inj.view(np.int32)),
        to_port(jstate, pcfg), pcfg, Topology(), regions(N, 1, "cpu"),
        rng.prng_key(seed, "cpu"), pmeta,
    )
    _assert_carry_equal(jout, pout, "broadcast")
    assert (np.asarray(jout.inflight) != np.asarray(jc.inflight)).any()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_sync_packed(cfgs, seed):
    """Includes the unsigned-max trap: JAX writes the pulled words with
    a u32 max into the (zero) slot; words with bit 31 set must survive,
    which a signed max on the int32 carriers would lose."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(seed)
    t = 3 + seed
    jc = _jax_carry(g, t)
    jstate = _state(jcfg, g, t)
    jout, jcount, jback = jax.jit(jpacked.sync_packed, static_argnums=(2, 3))(
        jc, jstate, jcfg, JaxTopology(), jax.random.PRNGKey(seed), jmeta
    )
    pout, pcount, pback = packed.sync_packed(
        _port_carry(jc), to_port(jstate, pcfg), pcfg, Topology(),
        rng.prng_key(seed, "cpu"), pmeta,
    )
    _assert_carry_equal(jout, pout, "sync")
    np.testing.assert_array_equal(np.asarray(jcount), pcount.numpy())
    np.testing.assert_array_equal(np.asarray(jback), pback.numpy())

    slot = (t + 1) % 2
    pulled = np.asarray(jout.sync_buf[slot])
    assert (pulled >= 1 << 31).any(), "no pulled word carries bit 31"
    # the pull updates the slot in place; it held zeros before (_jax_carry)
    before = torch.zeros_like(pout.sync_buf[slot])
    signed_max = torch.maximum(before, pout.sync_buf[slot])  # 0 vs negative
    assert not torch.equal(signed_max, pout.sync_buf[slot])


@pytest.mark.parametrize("t", (1, 2))
def test_deliver_packed(cfgs, t):
    jcfg, _, pcfg, _ = cfgs
    g = np.random.default_rng(10 + t)
    jc = _jax_carry(g, t + 1)  # any slot pattern: deliver pops slot t % D
    jout = jax.jit(jpacked.deliver_packed, static_argnums=(2,))(
        jc, jnp.int32(t), jcfg
    )
    pout = packed.deliver_packed(_port_carry(jc), t, pcfg)
    _assert_carry_equal(jout, pout, "deliver")


@pytest.mark.parametrize("v", (8, 32))
@pytest.mark.parametrize("seed", (0, 1))
def test_extract_gaps(cfgs, v, seed):
    jcfg = cfgs[0]
    g = np.random.default_rng(seed)
    touched = g.random((N, 16, v)) < (0.5 if v == 32 else 0.7)
    heads_t = version_heads(torch.from_numpy(touched))
    heads = np.asarray((touched * np.arange(1, v + 1)).max(axis=2), np.int32)
    np.testing.assert_array_equal(heads, heads_t.numpy())
    want = jgaps.extract_gaps(jnp.asarray(touched), jnp.asarray(heads), jcfg)
    got = gaps.extract_gaps(torch.from_numpy(touched), heads_t, jcfg)
    for name in ("lo", "hi", "overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name)), getattr(got, name).numpy(),
            err_msg=name,
        )
    if v == 32:
        assert np.asarray(want.overflow).any()  # the clamp path ran


@pytest.mark.parametrize("seed", (0, 1))
def test_gaps_to_mask(seed):
    g = np.random.default_rng(seed)
    lo = g.integers(0, 9, (N, 16, 8)).astype(np.int32)
    hi = np.minimum(lo + g.integers(0, 4, lo.shape), 8).astype(np.int32)
    want = jgaps.gaps_to_mask(jnp.asarray(lo), jnp.asarray(hi), 8)
    got = gaps.gaps_to_mask(torch.from_numpy(lo), torch.from_numpy(hi), 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _bits_to_words(bits):
    """bool[..., P] → u32 words [..., P/32], LSB-first (numpy)."""
    *lead, p = bits.shape
    b = bits.reshape(*lead, p // 32, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("c, a, v, k, p_bit", (
    (1, 16, 32, 8, 0.6),  # V = 32: the full word, most rows overflow
    (4, 16, 8, 2, 0.2),  # the storm's grid with K cut to 2 runs
    (32, 2, 16, 3, 0.03),  # one group per word
))
def test_refresh_gaps(c, a, v, k, p_bit):
    """K6's plain version against JAX's group_grid → version_heads →
    _extract_gaps_words, with rows that overflow K."""
    n, p = 300, a * v * c
    jcfg = jstate_mod.SimConfig(n_nodes=n, n_payloads=p, n_writers=a,
                                chunks_per_version=c, gap_slots=k)
    pcfg = dataclasses.replace(storm_configs(N, P)[2], n_nodes=n,
                               n_payloads=p, n_writers=a,
                               chunks_per_version=c, gap_slots=k)
    g = np.random.default_rng(c)
    words = _bits_to_words(g.random((n, p)) < p_bit)
    touched = jpacked.group_grid(jnp.asarray(words), jcfg, "any")
    heads = jstate_mod.version_heads(touched)
    want = jgaps._extract_gaps_words(touched, heads, jcfg)
    got = gaps.refresh_gaps(_t32(words), pcfg)
    for name, w, x in zip(("heads", "lo", "hi"),
                          (heads, want.lo, want.hi), got[:3]):
        np.testing.assert_array_equal(np.asarray(w), x.numpy(), err_msg=name)
    n_overflow = int(np.asarray(want.overflow).sum())
    assert n_overflow > 0, "no row overflowed K"
    assert got[3].dtype == torch.int32 and int(got[3]) == n_overflow


def _jax_converge(have, inj, alive, cov, conv, meta, t, cfg):
    """JAX's converge block (packed.py:789-819) and the run's exit flag
    after the round (_converged_done at t + 1), from JAX's own folds."""
    c = cfg.chunks_per_version
    up = alive == 0
    comp_w = jpacked.all_chunks_words(have, cfg)
    act_w = jpacked._smear_groups(
        jpacked._fold_any(inj, c) & jpacked._group_low_bits_mask(c), c
    )
    masked = jnp.where(up[:, None], comp_w, jpacked.ONES)
    payload_done = (
        jnp.all(jpacked.unpack_bits(masked, cfg.n_payloads), axis=0)
        & jpacked.unpack_bits(act_w, cfg.n_payloads)
    )
    cov = jnp.where((cov < 0) & payload_done, t, cov)
    node_done = ((comp_w | ~act_w[None, :]) == jpacked.ONES).all(axis=1) & up
    conv = jnp.where(
        (conv < 0) & node_done & jnp.all(meta.round <= t), t, conv
    )
    metrics = JaxRunMetrics(coverage_at=cov, converged_at=conv,
                            overflow_frac=jnp.float32(0),
                            order_violations=jnp.int32(0))
    slim = jax_new_sim(cfg, 0)._replace(t=jnp.int32(t + 1),
                                        alive=jnp.asarray(alive))
    return cov, conv, jpacked._converged_done(slim, metrics, meta)


@pytest.mark.parametrize("t, holes", ((2, True), (5, True), (5, False),
                                      (13, False)))
def test_converge_record(cfgs, t, holes):
    """K7's plain version against JAX's converge block, with dead rows
    (whose holes must not count) and words with bit 31 set."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    g = np.random.default_rng(t)
    have = np.full((N, W), 0xFFFFFFFF, dtype=np.uint32)
    dead = g.random(N) < 0.2
    alive = (dead * 2).astype(np.uint8)
    # dead rows miss bits everywhere; with holes, half the up rows miss
    # bits in the first words only, so later versions still complete
    have[dead] &= _bits_to_words(g.random((int(dead.sum()), P)) < 0.7)
    if holes:
        rows = ~dead & (g.random(N) < 0.5)
        half = W // 2
        have[rows, :half] &= _bits_to_words(
            g.random((int(rows.sum()), half * 32)) < 0.9)
    inj = _bits_to_words(g.random(P) < 0.8)
    cov = np.where(g.random(P) < 0.3, g.integers(0, t + 1, P), -1)
    conv = np.where(g.random(N) < 0.3, g.integers(0, t + 1, N), -1)
    cov, conv = cov.astype(np.int32), conv.astype(np.int32)

    want = _jax_converge(jnp.asarray(have), jnp.asarray(inj), alive,
                         jnp.asarray(cov), jnp.asarray(conv), jmeta, t, jcfg)
    metrics = RunMetrics(
        coverage_at=torch.from_numpy(cov), converged_at=torch.from_numpy(conv),
        overflow_frac=torch.zeros(()), order_violations=torch.zeros(()),
    )
    coverage_at, converged_at, _, done = packed.converge_record(
        _t32(have), _t32(inj), torch.from_numpy(alive), metrics, pmeta, t,
        pcfg, torch.zeros((), dtype=torch.int32), int(pmeta.round.max()))
    got = (coverage_at, converged_at, done)
    for name, w, x in zip(("coverage_at", "converged_at", "done"), want, got):
        np.testing.assert_array_equal(np.asarray(w), x.numpy(), err_msg=name)
    # the last payload is injected at round 6 of the storm's 4 versions
    last = int(np.asarray(jmeta.round).max())
    assert (np.asarray(want[0]) != cov).any(), "no payload stamp moved"
    if t >= last:
        assert (np.asarray(want[1]) != conv).any(), "no node stamp moved"
    if not holes:
        assert bool(want[2]) == (t >= last)


@pytest.mark.parametrize("seed", (0, 1))
def test_spend_relay(cfgs, seed):
    """K8's spend against the broadcast's sending mask and planes_dec
    (packed.py:369-505): targets with -1 and self entries, dead rows."""
    g = np.random.default_rng(20 + seed)
    jc = _jax_carry(g, 0)
    inj = _words(g, (W,))
    me = np.arange(N)[:, None]
    targets = g.integers(0, N, (N, 3))
    targets = np.where(g.random((N, 3)) < 0.3, -1, targets)
    targets = np.where(g.random((N, 3)) < 0.2, me, targets).astype(np.int32)
    targets[:20] = -1  # rows that attempt nothing
    alive = ((g.random(N) < 0.1) * 2).astype(np.uint8)

    sending = jc.have & jc.relay.nonzero & jnp.asarray(inj)[None, :]
    attempted = (targets >= 0) & (targets != me)
    any_attempt = jnp.asarray(attempted.any(axis=1) & (alive == 0))
    planes = jpacked.planes_dec(
        jc.relay, jnp.where(any_attempt[:, None], sending, jnp.uint32(0))
    )

    pc = _port_carry(jc)
    got = packed.spend_relay(pc, _t32(inj), torch.from_numpy(targets),
                             torch.from_numpy(alive))
    np.testing.assert_array_equal(np.asarray(sending),
                                  got.numpy().view(np.uint32))
    for k, (w, x) in enumerate(zip(planes, pc.relay)):
        np.testing.assert_array_equal(np.asarray(w), x.numpy().view(np.uint32),
                                      err_msg=f"r{k}")
    assert (np.asarray(planes.r0) != np.asarray(jc.relay.r0)).any()
