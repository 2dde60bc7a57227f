"""The port's write storm end to end against the JAX reference.

The storm at test scale (_write_storm(512, 256), packed envelope forced
open, seed 7 — the shape of tests/sim/test_packed_sharded.py) must give
the same final state and RunMetrics field for field, and the same state
round by round; the goldens pinned in the port for runs without JAX
(chip_smoke.py) must equal the live JAX run.  Everything is integer and
compared exactly, except RunMetrics.overflow_frac (see _assert_metrics).
"""

import hashlib

import jax
import numpy as np
import pytest

from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim.round import new_metrics as jax_new_metrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.round import run_to_convergence as jax_run
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import meta_from_numpy, state_digest
from corrosion_tpu_torch.sim import packed
from corrosion_tpu_torch.sim.round import new_metrics, new_sim
from corrosion_tpu_torch.sim.runner import config_write_storm_100k, run_scenario
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    port_fields,
    storm_configs,
)

N, P, SEED = 512, 256, 7


def _jax_digest(state, skip=("pview",)):
    """tests/sim/test_topo.py's _digest (blake2b over the state fields)."""
    h = hashlib.blake2b(digest_size=8)
    for f, v in zip(type(state)._fields, state):
        if f in skip:
            continue
        h.update(f.encode())
        h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()


def _assert_metrics(want, got, label):
    want, got = fields(want), fields(got)
    for name in want:
        if name == "overflow_frac":
            # an f32 mean of a bool mask: the sum is an exact integer in
            # f32 and both sides divide once in f32, so the values agree;
            # rtol 1e-6 (a few f32 ulps) only admits a backend that
            # divides through a reciprocal
            np.testing.assert_allclose(want[name], got[name], rtol=1e-6,
                                       err_msg=f"{label}: {name}")
            assert got[name].dtype == np.float32
        else:
            np.testing.assert_array_equal(want[name], got[name],
                                          err_msg=f"{label}: {name}")


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, P)


@pytest.fixture(scope="module")
def jax_storm(cfgs):
    jcfg, jmeta = cfgs[0], cfgs[1]
    final, metrics = jax_run(
        jax_new_sim(jcfg, SEED), jmeta, jcfg, JaxTopology(), 600
    )
    jax.block_until_ready(final)
    return final, metrics


def test_new_sim_matches_jax(cfgs):
    jcfg, _, pcfg, _ = cfgs
    assert_fields_equal(
        fields(jax_new_sim(jcfg, SEED)), port_fields(new_sim(pcfg, SEED, "cpu")),
        "new_sim",
    )


def test_uniform_payloads_match_jax(cfgs):
    _, jmeta, _, pmeta = cfgs
    assert_fields_equal(
        fields(jmeta), fields(meta_from_numpy(fields(jmeta), "cpu")),
        "meta_from_numpy",
    )
    assert_fields_equal(fields(jmeta), fields(pmeta), "uniform_payloads")


def test_storm_512_matches_jax(cfgs, jax_storm):
    _, _, pcfg, pmeta = cfgs
    final, metrics = jax_storm
    out = run_scenario(pcfg, pmeta, seed=SEED, max_rounds=600, device="cpu",
                       return_state=True)
    assert_fields_equal(fields(final), port_fields(out["state"]), "final")
    _assert_metrics(metrics, out["metrics"], "metrics")
    assert out["converged"] and out["round_path"] == "packed"


def test_storm_512_round_by_round(cfgs):
    """Step JAX's jitted packed_round_step and the port side by side;
    a failure names the first diverging round and field."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    jstate = jax_new_sim(jcfg, SEED)
    pstate = new_sim(pcfg, SEED, "cpu")
    jcarry, pcarry = jpacked.pack_state(jstate, jcfg), packed.pack_state(
        pstate, pcfg)
    jinj = jpacked.pack_bits(jstate.injected)
    pinj = packed.pack_bits(pstate.injected)
    jslim, pslim = jpacked.shrink_state(jstate), packed.shrink_state(pstate)
    jmet, pmet = jax_new_metrics(jcfg), new_metrics(pcfg, "cpu")
    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    jregion, pregion = jax_regions(N, 1), regions(N, 1, "cpu")
    for r in range(40):
        jslim, jcarry, jinj, jmet = step(
            jslim, jcarry, jinj, jmet, jmeta, jcfg, JaxTopology(), jregion
        )
        pslim, pcarry, pinj, pmet = packed.packed_round_step(
            pslim, pcarry, pinj, pmet, pmeta, pcfg, Topology(), pregion
        )
        label = f"round {r}"
        assert_fields_equal(fields(jslim), port_fields(pslim), label)
        assert_fields_equal(
            fields(jpacked.unpack_into_state(jcarry, jslim, jcfg)),
            port_fields(packed.unpack_into_state(pcarry, pslim, pcfg)),
            f"{label} carry",
        )
        np.testing.assert_array_equal(
            np.asarray(jinj), pinj.numpy().view(np.uint32), err_msg=label
        )
        _assert_metrics(jmet, pmet, label)
        jdone = bool(jpacked._converged_done(jslim, jmet, jmeta))
        assert jdone == bool(packed._converged_done(pslim, pmet, pmeta))
        if jdone:
            break
    assert jdone and int(jslim.t) == goldens.STORM_512_SEED7["rounds"]


def test_goldens_match_live_jax(jax_storm):
    final, metrics = jax_storm
    assert goldens.STORM_512_SEED7 == {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99
        ),
        "digest": _jax_digest(final),
    }


@pytest.mark.slow
def test_storm_100k_matches_jax_goldens():
    """config_write_storm_100k(seed=0) in both packages: rounds, p99 and
    final-state digest equal, and equal to the goldens pinned in the
    port (a few minutes on a CPU)."""
    jcfg, jmeta = jax_write_storm(100_000, 512)
    final, metrics = jax_run(
        jax_new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), 3000
    )
    live = {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99
        ),
        "digest": _jax_digest(final),
    }
    assert live == goldens.STORM_100K_SEED0
    out = config_write_storm_100k(seed=0, device="cpu", return_state=True)
    assert {
        "rounds": out["rounds"],
        "p99_node_convergence_round": out["p99_node_convergence_round"],
        "digest": state_digest(out["state"]),
    } == live
