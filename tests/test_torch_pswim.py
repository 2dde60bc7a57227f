"""Partial-view SWIM in the port (corrosion_tpu_torch/sim/pswim.py)
against the JAX reference: the member sampler (K1's function), the
table merge (K4's function) and whole pswim steps.  Integer state
throughout, so every comparison is exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import pswim as jpswim
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu_torch.sim import pswim, rng
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    port_fields,
    random_tables,
    storm_configs,
    to_port,
)

N = 512
M = 64


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, 256)


def _state_with_tables(jcfg, seed, t=40, dead_frac=0.0):
    """A JAX storm state whose member tables, liveness and incarnations
    are drawn from ``seed`` (DOWN buckets, -1 empties, high
    incarnations, dead nodes)."""
    g = np.random.default_rng(seed)
    pid, pkey, psince = random_tables(g, N, M, t)
    alive = np.where(g.random(N) < dead_frac, 2, 0).astype(np.uint8)
    inc = g.integers(0, 2047, N).astype(np.uint32)
    state = jax_new_sim(jcfg, seed)
    return state._replace(
        t=jnp.int32(t), pid=jnp.asarray(pid), pkey=jnp.asarray(pkey),
        psince=jnp.asarray(psince), alive=jnp.asarray(alive),
        incarnation=jnp.asarray(inc),
    )


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("count", (1, 3))
def test_psample_member_targets(cfgs, seed, count):
    jcfg, _, pcfg, _ = cfgs
    state = _state_with_tables(jcfg, seed)
    key = jax.random.PRNGKey(100 + seed)
    want = jax.jit(jpswim.psample_member_targets, static_argnums=(1, 3))(
        state, jcfg, key, count
    )
    got = pswim.psample_member_targets(
        to_port(state, pcfg), pcfg, rng.prng_key(100 + seed, "cpu"), count
    )
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got >= 0).any() and (got == -1).any()


def _entries(g, pid, n_entries, n):
    """Gossip-like entries: half carry an id already in the receiver's
    bucket (precedence merges), the rest compete for buckets; many land
    on the same (dst, bucket) cell."""
    e_dst = g.integers(0, n // 8, n_entries)  # crowd few receivers
    picked = pid[e_dst, g.integers(0, M, n_entries)]
    same = g.random(n_entries) < 0.5
    e_id = np.where(same & (picked >= 0), picked, g.integers(0, n, n_entries))
    e_key = g.integers(0, 2047, n_entries) * 4 + g.integers(0, 3, n_entries)
    e_ok = g.random(n_entries) < 0.85
    return (e_dst.astype(np.int32), e_id.astype(np.int32),
            e_key.astype(np.int32), e_ok)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_merge_entries(cfgs, seed):
    jcfg = cfgs[0]
    g = np.random.default_rng(seed)
    t = 700  # past down_gc_rounds for old stamps: aged-DOWN reclaims
    pid, pkey, psince = random_tables(g, N, M, t)
    ent = _entries(g, pid, 20_000, N)
    want = jax.jit(jpswim._merge_entries, static_argnums=(8,))(
        *(jnp.asarray(x) for x in (pid, pkey, psince, *ent)),
        jnp.int32(t), jcfg,
    )
    tables = [torch.from_numpy(x) for x in (pid, pkey, psince)]
    got = pswim.merge_entries(
        *tables, *(torch.from_numpy(x) for x in ent), t,
        jcfg.down_gc_rounds, pswim._pack_tables(tables[0], tables[1]),
    )
    for name, w, p in zip(("pid", "pkey", "psince"), want, got):
        np.testing.assert_array_equal(np.asarray(w), p.numpy(), err_msg=name)
    # the draw really exercised both scatters and the recheck
    assert (np.asarray(want[0]) != pid).any()
    assert (np.asarray(want[1]) != pkey).any()


@pytest.mark.parametrize("seed", (0, 5))
def test_pswim_steps(cfgs, seed):
    """Eight consecutive steps from tables with dead nodes: probes fail,
    suspicion times out to DOWN, announces refute — every field equal
    after every step."""
    jcfg, _, pcfg, _ = cfgs
    jstate = _state_with_tables(jcfg, seed, t=8, dead_frac=0.1)
    pstate = to_port(jstate, pcfg)
    step = jax.jit(jpswim.pswim_step, static_argnums=(1, 2))
    keys = jax.random.split(jax.random.PRNGKey(seed), 8)
    pkeys = rng.split(rng.prng_key(seed, "cpu"), 8)
    for i in range(8):
        jstate = step(jstate, jcfg, JaxTopology(), keys[i])
        pstate = pswim.pswim_step(pstate, pcfg, Topology(), pkeys[i])
        assert_fields_equal(
            fields(jstate), port_fields(pstate), f"pswim step {i}"
        )
        jstate = jstate._replace(t=jstate.t + 1)
        pstate = pstate._replace(t=pstate.t + 1)
    start = _state_with_tables(jcfg, seed, t=8, dead_frac=0.1)
    # the steps suspected, downed or refuted something
    assert (np.asarray(jstate.pkey) % 4 != np.asarray(start.pkey) % 4).any()
