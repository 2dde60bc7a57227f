"""K1's and K3's redesigned functions in the port against live JAX on
the CPU: the member sampler with its bucket draw and unpacked tables
(`pswim.sample_members`, JAX ``psample_member_targets``) at M = 64 and
M = 48 (randint's `higher` hash), and K3's mask pass
(`packed.sync_masks`, the gaps_to_mask / grid_to_words /
all_chunks_words block of JAX ``sync_packed``) at the storm's and
gapstress's layouts; both lane wrappers at K = 3 against their solo runs
lane by lane.  Integer outputs, so every comparison is exact
(tolerance 0)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.sim import gaps as jgaps
from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim import pswim as jpswim
from corrosion_tpu.sim.runner import _gapstress_cfg as jax_gapstress_cfg
from corrosion_tpu_torch.sim import packed, pswim, rng
from corrosion_tpu_torch.sim.runner import _gapstress_cfg
from tests.torch_parity import random_tables, storm_configs

N = 512
CPU = torch.device("cpu")


class _Tables(NamedTuple):
    """The fields of a JAX state ``psample_member_targets`` reads."""
    pid: jnp.ndarray
    pkey: jnp.ndarray


def _trap_tables(seed, n, m):
    """Storm-like tables [n, m] with K1's traps: keys at INC_CLAMP (the
    packed word's top bit), every key class (DOWN among them), empty
    buckets and buckets repeating another of their row."""
    g = np.random.default_rng(seed)
    pid, pkey, _ = random_tables(g, n, m, 40)
    clamp = (g.random((n, m)) < 0.1) & (pid >= 0)
    pkey = np.where(clamp, pswim.INC_CLAMP * 4 + g.integers(0, 4, (n, m)),
                    pkey)
    dup = g.random((n, m)) < 0.05
    src = g.integers(0, m, (n, m))
    rows = np.arange(n)[:, None]
    pid = np.where(dup, pid[rows, src], pid)
    pkey = np.where(dup, pkey[rows, src], pkey)
    return pid.astype(np.int32), pkey.astype(np.int32)


@pytest.fixture(scope="module")
def jcfg():
    return storm_configs(N, 256)[0]


@pytest.mark.parametrize("m", (64, 48))
@pytest.mark.parametrize("count", (1, 3))
@pytest.mark.parametrize("seed", (0, 1))
def test_sample_members_against_jax(jcfg, m, count, seed):
    assert (rng.scalar_span(0, m)[1] != 0) == (m == 48)
    pid, pkey = _trap_tables(seed, N, m)
    want = jax.jit(jpswim.psample_member_targets, static_argnums=(1, 3))(
        _Tables(jnp.asarray(pid), jnp.asarray(pkey)), jcfg,
        jax.random.PRNGKey(300 + seed), count)
    got = pswim.sample_members(torch.from_numpy(pid), torch.from_numpy(pkey),
                               rng.prng_key(300 + seed, "cpu"), count)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    slots = rng.randint_plain(rng.prng_key(300 + seed, "cpu"),
                              (4 * count, N), 0, m).numpy()
    drawn = pkey[np.arange(N)[None, :], slots]
    assert (drawn + 1 >= 4096).any() and (drawn % 4 == 2).any()
    assert (got >= 0).any() and (got == -1).any()


def _jax_masks(heads, gap_lo, gap_hi, have, cfg):
    """JAX ``sync_packed``'s node masks (corrosion_tpu/sim/packed.py
    1201-1218), on the JAX package's own functions."""
    v = cfg.n_versions
    v_idx = jnp.arange(1, v + 1, dtype=jnp.int32)
    miss_w = jpacked.grid_to_words(jgaps.gaps_to_mask(gap_lo, gap_hi, v), cfg)
    below_w = jpacked.grid_to_words(
        v_idx[None, None, :] <= heads[:, :, None], cfg)
    comp_w = jpacked.all_chunks_words(have, cfg)
    haves_w = below_w & ~miss_w & comp_w
    partial_w = below_w & ~miss_w & ~comp_w
    return jnp.stack([haves_w, partial_w, below_w, have], axis=1), miss_w


def _layout(name):
    """(JAX cfg, port cfg, rows) of a layout: the storm's (A 16, V 8, C 4,
    G 8, W 16), gapstress's (A 8, V 128, C 8, W 256) with its 8 gap slots
    and with the distortion control's 64."""
    if name == "storm":
        jc, _, pc, _ = storm_configs(N, 512)
        return jc, pc, N
    slots = 64 if name == "gapstress_k64" else 8
    return jax_gapstress_cfg(128, slots), _gapstress_cfg(128, slots), 128


@pytest.mark.parametrize("layout", ("storm", "gapstress", "gapstress_k64"))
@pytest.mark.parametrize("seed", (0, 1))
def test_sync_masks_against_jax(layout, seed):
    jc, pc, rows = _layout(layout)
    row, got = chip_smoke.compare_sync_masks(
        CPU, np.random.default_rng(seed), pc, (rows,), timed=False,
        keep=True)
    heads, lo, hi, have = (x.numpy() for x in row["inputs"])
    want = jax.jit(_jax_masks, static_argnums=4)(
        jnp.asarray(heads), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(have.view(np.uint32)), jc)
    for w, p in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).view(np.int32),
                                      p.numpy())


def test_lane_wrappers_equal_solo_runs():
    lanes = 3
    tabs = [_trap_tables(10 + k, N, 64) for k in range(lanes)]
    pid, pkey = (torch.from_numpy(np.stack([t[i] for t in tabs]))
                 for i in range(2))
    keys = torch.stack([rng.prng_key(20 + k, "cpu") for k in range(lanes)])
    got = pswim.sample_members_lanes(pid, pkey, keys, 3)
    for k in range(lanes):
        assert torch.equal(got[k], pswim.sample_members(pid[k], pkey[k],
                                                        keys[k], 3))
    assert not torch.equal(got[0], got[1])

    _, pc, _ = _layout("storm")
    inputs = chip_smoke.advertised_rows(np.random.default_rng(5),
                                        (lanes, N), pc, CPU)
    masks, miss = packed.sync_masks(*inputs, pc)
    for k in range(lanes):
        solo = packed.sync_masks(*(x[k] for x in inputs), pc)
        assert torch.equal(masks[k], solo[0]) and torch.equal(miss[k],
                                                              solo[1])
