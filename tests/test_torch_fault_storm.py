"""The port's packed fault storm end to end against the JAX reference.

`storm_fault_plan` (a loss burst, a half-split partition, a
crash-with-wipe) on the storm at test scale (_write_storm(512, 256),
packed envelope forced open, seed 7, factored plan) must give the same
final state and RunMetrics field for field, and the same state round by
round; the fault goldens pinned in the port for runs without JAX
(chip_smoke.py) must equal the live JAX runs.  Exact, except
RunMetrics.overflow_frac (see tests/test_torch_storm.py)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import packed as jpacked
from corrosion_tpu.sim.round import new_metrics as jax_new_metrics
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.runner import _percentile
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_fault_plan
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu.sim.topology import regions as jax_regions
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import fault_plan_from_numpy, state_digest
from corrosion_tpu_torch.sim import faults, packed
from corrosion_tpu_torch.sim.round import new_metrics, new_sim
from corrosion_tpu_torch.sim.runner import _write_storm as port_write_storm
from corrosion_tpu_torch.sim.runner import (
    config_packed_fault_storm,
    storm_fault_plan,
)
from corrosion_tpu_torch.sim.topology import Topology, regions
from tests.test_torch_storm import _assert_metrics, _jax_digest
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    port_fields,
    storm_configs,
)

N, P, SEED = 512, 256, 7


@pytest.fixture(scope="module")
def cfgs():
    return storm_configs(N, P)


@pytest.fixture(scope="module")
def jax_plan(cfgs):
    return jfaults.compile_plan(
        jax_storm_fault_plan(N, SEED), cfgs[0], JaxTopology(), factored=True
    )


@pytest.fixture(scope="module")
def jax_fault_storm(cfgs, jax_plan):
    jcfg, jmeta = cfgs[0], cfgs[1]
    final, metrics = jfaults.run_fault_plan(
        jax_new_sim(jcfg, SEED), jmeta, jcfg, JaxTopology(), jax_plan,
        max_rounds=600,
    )
    jax.block_until_ready(final)
    return final, metrics


def _record(final, metrics, digest):
    return {
        "rounds": int(final.t),
        "p99_node_convergence_round": _percentile(
            np.asarray(metrics.converged_at), 99
        ),
        "digest": digest,
    }


def test_fault_storm_512_matches_jax(cfgs, jax_fault_storm):
    """The port's own compiled plan, its loop and its kernels' plain
    versions reproduce JAX's run: state, metrics, rounds, p99, digest."""
    _, _, pcfg, pmeta = cfgs
    final, metrics = jax_fault_storm
    pplan = faults.compile_plan(storm_fault_plan(N, SEED), pcfg, Topology(),
                                factored=True, device="cpu")
    pfinal, pmetrics = faults.run_fault_plan(
        new_sim(pcfg, SEED, "cpu"), pmeta, pcfg, Topology(), pplan,
        max_rounds=600,
    )
    assert_fields_equal(fields(final), port_fields(pfinal), "final")
    _assert_metrics(metrics, pmetrics, "metrics")
    got = _record(pfinal, pmetrics, state_digest(pfinal))
    assert got == goldens.FAULT_STORM_512_SEED7
    # the horizon holds the loop: the faultless storm is done at 14
    assert got["rounds"] >= pplan.horizon == 21


def test_fault_storm_512_round_by_round(cfgs, jax_plan):
    """Step JAX's jitted node faults + packed_round_step and the port
    side by side on the same plan; a failure names the first diverging
    round and field."""
    jcfg, jmeta, pcfg, pmeta = cfgs
    pplan = fault_plan_from_numpy(fields(jax_plan), "cpu")
    jstate, pstate = jax_new_sim(jcfg, SEED), new_sim(pcfg, SEED, "cpu")
    jcarry = jpacked.pack_state(jstate, jcfg)
    pcarry = packed.pack_state(pstate, pcfg)
    jinj = jpacked.pack_bits(jstate.injected)
    pinj = packed.pack_bits(pstate.injected)
    jslim, pslim = jpacked.shrink_state(jstate), packed.shrink_state(pstate)
    jmet, pmet = jax_new_metrics(jcfg), new_metrics(pcfg, "cpu")
    horizon = pplan.horizon

    @jax.jit
    def node_faults(slim, carry, t):
        rf = jfaults.round_faults(jax_plan, t)
        return (jfaults.apply_node_faults(slim, rf),
                jpacked.apply_carry_faults(carry, rf), rf)

    step = jax.jit(jpacked.packed_round_step, static_argnums=(5, 6))
    jregion, pregion = jax_regions(N, 1), regions(N, 1, "cpu")
    for r in range(60):
        jslim, jcarry, jrf = node_faults(jslim, jcarry, jslim.t)
        jslim, jcarry, jinj, jmet = step(
            jslim, jcarry, jinj, jmet, jmeta, jcfg, JaxTopology(), jregion,
            jrf,
        )
        prf = faults.round_faults(pplan, int(pslim.t))
        pslim, pcarry = packed.apply_round_faults(pslim, pcarry, prf)
        pslim, pcarry, pinj, pmet, pdone = packed.packed_round_step(
            pslim, pcarry, pinj, pmet, pmeta, pcfg, Topology(), pregion,
            prf, horizon,
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
        jdone = bool((jslim.t >= horizon) & jpacked.all_have_words(
            jcarry, jinj, jslim, jmeta, jcfg))
        assert jdone == bool(pdone), f"{label}: the fault loop's done flag"
        assert jdone == bool(
            int(pslim.t) >= horizon
            and packed.all_have_words(pcarry, pinj, pslim, pmeta, pcfg)
        )
        if jdone:
            break
    assert jdone and int(jslim.t) == goldens.FAULT_STORM_512_SEED7["rounds"]


def test_fault_goldens_match_live_jax(jax_fault_storm):
    final, metrics = jax_fault_storm
    assert goldens.FAULT_STORM_512_SEED7 == _record(
        final, metrics, _jax_digest(final))


def test_config_packed_fault_storm_keys(monkeypatch):
    """The rung's record, at test scale with the packed envelope forced
    open and the plan factored: JAX's keys but the wall-protocol ones,
    the fault run's rounds and p99 as in the whole-storm test, and the
    faultless twin run."""
    from corrosion_tpu_torch.sim import runner

    write_storm = runner._write_storm

    def forced_open(n_nodes, n_payloads, device="cuda", topo=Topology()):
        cfg, meta = write_storm(n_nodes, n_payloads, device, topo)
        return dataclasses.replace(cfg, packed_min_cells=0), meta

    monkeypatch.setattr(runner, "_write_storm", forced_open)
    monkeypatch.setattr(faults, "FACTORED_MIN_NODES", N)
    out = config_packed_fault_storm(seed=SEED, n_nodes=N, n_payloads=P,
                                    device="cpu")
    assert set(out) == {
        "n_nodes", "n_payloads", "n_devices", "mesh", "round_path",
        "plan_horizon", "plan_seed", "rounds", "converged",
        "unconverged_nodes", "p99_node_convergence_round", "wall_clock_s",
        "faultless_wall_clock_s", "fault_over_faultless",
    }
    gold = goldens.FAULT_STORM_512_SEED7
    assert out["round_path"] == "packed" and out["n_devices"] == 1
    assert out["plan_horizon"] == 21 and out["plan_seed"] == SEED
    assert out["rounds"] == gold["rounds"]
    assert out["p99_node_convergence_round"] == gold[
        "p99_node_convergence_round"]
    assert out["converged"] and out["unconverged_nodes"] == 0
    assert out["fault_over_faultless"] == (
        out["wall_clock_s"] / out["faultless_wall_clock_s"])


@pytest.mark.slow
def test_fault_storm_100k_matches_jax_goldens():
    """The 100k seed-0 fault storm (config_packed_fault_storm's fault run)
    in both packages: rounds, p99 and the final-state digest equal, and
    equal to the goldens pinned in the port (minutes on a CPU)."""
    jcfg, jmeta = jax_write_storm(100_000, 512)
    jplan = jfaults.compile_plan(jax_storm_fault_plan(100_000, 0), jcfg,
                                 JaxTopology())
    final, metrics = jfaults.run_fault_plan(
        jax_new_sim(jcfg, 0), jmeta, jcfg, JaxTopology(), jplan,
        max_rounds=3000,
    )
    live = _record(final, metrics, _jax_digest(final))
    assert live == goldens.FAULT_STORM_100K_SEED0
    pcfg, pmeta = port_write_storm(100_000, 512, "cpu")
    pplan = faults.compile_plan(storm_fault_plan(100_000, 0), pcfg,
                                Topology(), device="cpu")
    assert_fields_equal(fields(jplan), fields(pplan), "compile_plan 100k")
    # the suite keeps torch on one thread (tests/torch_parity.py); this
    # test runs alone under -m slow and needs the cores to stay inside
    # the watchdog's 300 s
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        pfinal, pmetrics = faults.run_fault_plan(
            new_sim(pcfg, 0, "cpu"), pmeta, pcfg, Topology(), pplan,
            max_rounds=3000,
        )
    finally:
        torch.set_num_threads(threads)
    assert _record(pfinal, pmetrics, state_digest(pfinal)) == live
