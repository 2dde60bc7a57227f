"""The runner configs the command line needed: `config_storm_ab` and
`config_fault_campaign_3node` of the port against JAX's records.

The storm A/B runs both packages in this process at 512 nodes.  JAX's
fault campaign runs in a subprocess (``python -m corrosion_tpu.cli.main
sim fault-campaign-3node``): a JAX ``run_campaign`` in a test worker
leaves state behind that another file's test trips on.  Walls (and the
speedup made of them) are the only keys left out; every other key is
equal, and the record's key set is JAX's."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from corrosion_tpu.sim import runner as jax_runner
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.sim import runner
from tests.torch_parity import jax_write_storm  # noqa: F401 (sets threads)

WALLS = ("wall_clock_s", "wall_clock_s_packed", "wall_clock_s_dense",
         "packed_speedup")


def _less_walls(record):
    return {k: v for k, v in record.items() if k not in WALLS}


def test_storm_ab_matches_jax():
    want = jax_runner.config_storm_ab(n_nodes=512)
    got = runner.config_storm_ab(n_nodes=512, device="cpu")
    assert got.keys() == want.keys()
    assert _less_walls(got) == _less_walls(want)
    assert got["results_identical"] and got["mismatched_keys"] == []
    assert got["packed_speedup"] == (got["wall_clock_s_dense"]
                                     / got["wall_clock_s_packed"])


def test_fault_campaign_3node_matches_jax():
    out = subprocess.run(
        [sys.executable, "-m", "corrosion_tpu.cli.main", "sim",
         "fault-campaign-3node", "--seed", "0"],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout)
    got = runner.config_fault_campaign_3node(seed=0, device="cpu")
    assert list(got) == list(want)
    assert _less_walls(got) == _less_walls(want)
    # the engine's one-seed lane is the solo run FAULT_CAMPAIGN_3NODE_SEED0
    # pins (its p99 there interpolates; the engine's percentile does not)
    engine = goldens.FAULT_CAMPAIGN_3NODE_ENGINE
    assert got["rounds"] == goldens.FAULT_CAMPAIGN_3NODE_SEED0["rounds"]
    assert (got["spec_hash"], got["result_digest"]) == (
        engine["spec_hash"], engine["result_digest"])
    assert got["p99_node_convergence_round"] == engine["lanes"][0][
        "p99_node_convergence_round"]
    assert got["round_path"] == "dense" and got["converged"]


@pytest.mark.slow
def test_storm_ab_25000_golden_matches_live_jax():
    """``STORM_AB_25000_SEED0`` (what chip_smoke.py holds the card's
    ``sim storm-ab`` to) from live JAX: config_storm_ab's two runs at its
    default 25 000 nodes (about 45 s on 8 cores)."""
    cfg, meta = jax_write_storm(25_000, 512)
    keys = ("rounds", "p99_payload_latency_rounds",
            "p99_node_convergence_round", "unconverged_nodes")
    for path, change in (("packed", dict(packed_min_cells=0)),
                         ("dense", dict(allow_packed=False))):
        rec = jax_runner.run_scenario(dataclasses.replace(cfg, **change),
                                      meta, seed=0, max_rounds=3000)
        assert rec["round_path"] == path
        assert {k: rec[k] for k in keys} == goldens.STORM_AB_25000_SEED0[
            path]
