"""The port's campaign layer (``corrosion_tpu_torch/campaign``) against
JAX's ``corrosion_tpu/campaign`` on the CPU: every builtin spec's hash,
serialization, cells, SimConfig and Topology; the refusals of
``sim_config``; the report's bands, digest and compare on crafted
artifacts; ``run_campaign`` on a small packed spec with a two-point grid
(the artifact less its measured keys and JAX's ``traceparent``, and the
same ``result_digest``), its resume and wall budget; every refusal of the
ensemble slice; and the new entry points' device default."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from corrosion_tpu.campaign import engine as jengine
from corrosion_tpu.campaign import report as jreport
from corrosion_tpu.campaign import spec as jspec_mod
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.campaign import engine, report
from corrosion_tpu_torch.campaign import spec as spec_mod
from corrosion_tpu_torch.campaign.ensemble import (
    run_detect_ensemble,
    run_seed_ensemble,
    seed_states,
)
from corrosion_tpu_torch.faults import FaultEvent
from tests.torch_parity import storm_campaign_pair

BUILTINS = sorted(jspec_mod.BUILTIN_SPECS)


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_spec_equals_jax(name):
    j, p = jspec_mod.builtin_spec(name), spec_mod.builtin_spec(name)
    assert p.to_dict() == j.to_dict()
    assert p.spec_hash() == j.spec_hash()
    assert p.cells() == j.cells()
    again = spec_mod.CampaignSpec.from_dict(json.loads(json.dumps(
        p.to_dict())))
    assert again == p and again.spec_hash() == j.spec_hash()
    seeded = spec_mod.builtin_spec(name, seeds=(3, 4))
    assert seeded.spec_hash() == jspec_mod.builtin_spec(
        name, seeds=(3, 4)).spec_hash()


@pytest.mark.parametrize("name", [n for n in BUILTINS
                                  if not n.startswith("serving")])
def test_builtin_cells_build_jax_config(name):
    """Every sim cell of a builtin resolves to JAX's SimConfig (the
    fields the port has), Topology and fault plan."""
    j, p = jspec_mod.builtin_spec(name), spec_mod.builtin_spec(name)
    for cell in p.cells():
        jc, pc = j.sim_config(cell), p.sim_config(cell)
        for f in dataclasses.fields(pc):
            assert getattr(pc, f.name) == getattr(jc, f.name), (cell, f.name)
        assert dataclasses.asdict(p.topo(cell)) == dataclasses.asdict(
            j.topo(cell))
        jp, pp = j.fault_plan(cell, seed=5), p.fault_plan(cell, seed=5)
        assert (jp is None) == (pp is None)
        if pp is not None:
            assert [dataclasses.asdict(e) for e in pp.events] == [
                dataclasses.asdict(e) for e in jp.events]
            assert (pp.n_nodes, pp.seed, pp.round_s) == (
                jp.n_nodes, jp.seed, jp.round_s)
        for m in ("inject_every", "detect_membership", "kill_every",
                  "measure_wire", "proto_family", "serving"):
            assert getattr(p, m)(cell) == getattr(j, m)(cell)


@pytest.mark.parametrize("faults", (False, True), ids=("storm", "fault"))
def test_storm_seeds_spec_hash_is_jax_and_golden(faults):
    p = spec_mod.storm_seeds_spec(faults=faults)
    j = jspec_mod.CampaignSpec.from_dict(p.to_dict())
    golden = (goldens.FAULT_STORM_100K_SEEDS8 if faults
              else goldens.STORM_100K_SEEDS8)
    assert p.spec_hash() == j.spec_hash() == golden["spec_hash"]
    cfg, jcfg = p.sim_config({}), j.sim_config({})
    assert cfg.rate_limit_bytes_round is None and cfg.sync_budget_bytes is None
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def _refusal(mod, case):
    if case == "shadow":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "_SCENARIO_META_KEYS",
                       mod._SCENARIO_META_KEYS + ("fanout",))
            mod.builtin_spec("fault-parity-3node").sim_config({})
    elif case == "both":
        mod.CampaignSpec(name="x", scenario={"n_nodes": 8, "loss": 0.1},
                         topology={"loss": 0.2}).topo({})
    elif case == "no-seeds":
        mod.CampaignSpec(name="x", scenario={"n_nodes": 8}, seeds=())
    elif case == "empty-axis":
        mod.CampaignSpec(name="x", scenario={"n_nodes": 8},
                         grid={"fanout": []})
    else:
        mod.CampaignSpec(name="x", scenario={"n_nodes": 8, "n_payloads": 7,
                                             "n_writers": 2}).sim_config({})


@pytest.mark.parametrize("case", ("shadow", "both", "no-seeds", "empty-axis",
                                  "bad-config"))
def test_spec_refusals_raise_as_jax(case):
    with pytest.raises(ValueError) as want:
        _refusal(jspec_mod, case)
    with pytest.raises(ValueError) as got:
        _refusal(spec_mod, case)
    assert str(got.value) == str(want.value)


_CELLS = [
    {"params": {"fanout": 2}, "per_seed": {"rounds": [3, 5, 4],
     "p99_node_convergence_round": [2.0, None, 3.0]},
     "bands": {"rounds": {"p50": 4.0, "p95": 5.0, "p99": 5.0},
               "p99_node_convergence_round": {"p50": None, "p95": None,
                                              "p99": None}},
     "all_converged": True, "wall_clock_s": 1.5, "traceparent": "00-x",
     "mesh": None, "n_devices": 1},
    {"params": {"fanout": 3}, "kind": "host-serving",
     "per_seed": {"consistent": [True]}, "bands": {}, "all_converged": False,
     "n_nodes": 3, "wall_clock_s": 9.0},
    {"params": {"fanout": 4}, "per_seed": {"order_violations": [0, 2]},
     "bands": {"order_violations": {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                                    "max": 2.0}},
     "all_converged": False},
]


@pytest.mark.parametrize("values", (
    [3, 5, 4, 4, 9], [None, None], [2.0, None, float("nan"), 7.0], [1],
    [], [0.25, 0.5, 0.125],
))
def test_bands_equal_jax(values):
    assert report.bands(values) == jreport.bands(values)


def test_digest_and_compare_equal_jax():
    assert report.artifact_digest(_CELLS) == jreport.artifact_digest(_CELLS)
    assert report.NONDETERMINISTIC_KEYS == jreport.NONDETERMINISTIC_KEYS
    assert report.BAND_METRICS == jreport.BAND_METRICS
    base = {"spec_hash": "a", "result_digest": "d", "cells": _CELLS}
    worse = json.loads(json.dumps(_CELLS))
    worse[0]["bands"]["rounds"]["p99"] = 9.0
    worse[0]["bands"]["p99_node_convergence_round"]["p50"] = 1.0
    worse[2]["bands"]["order_violations"]["max"] = 3.0
    for cand in ({"spec_hash": "a", "result_digest": "d", "cells": _CELLS},
                 {"spec_hash": "b", "cells": worse},
                 {"spec_hash": "a", "cells": _CELLS[:1]},
                 {"spec_hash": "a", "cells": worse + [
                     {"params": {"fanout": 9}}]}):
        assert report.compare(base, cand) == jreport.compare(base, cand)
        assert report.compare(base, cand, tol_frac=0.0, tol_abs=0.0) == (
            jreport.compare(base, cand, tol_frac=0.0, tol_abs=0.0))


def _strip(cell):
    return {k: v for k, v in cell.items()
            if k not in report.NONDETERMINISTIC_KEYS}


def test_run_campaign_equals_jax_and_resumes(tmp_path, monkeypatch):
    """A packed 512-node spec with a two-point grid, 3 lanes: JAX's
    artifact less its measured keys (and JAX's traceparent), the same
    spec_hash and result_digest; then a re-run on the same out_path
    resumes every cell, and a spent wall budget skips them."""
    jspec, pspec = storm_campaign_pair(512, 64, (0, 5, 7), False,
                                       grid={"fanout": [2, 3]})
    want = jengine.run_campaign(jspec, out_path=None)
    out = tmp_path / "artifact.json"
    got = engine.run_campaign(pspec, out_path=str(out), device="cpu")
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    assert got["spec"] == want["spec"]
    assert got["skipped_cells"] == want["skipped_cells"] == []
    assert [_strip(c) for c in got["cells"]] == [_strip(c)
                                                 for c in want["cells"]]
    for cell in got["cells"]:
        assert cell["wall_verdict"] == engine.WALL_OK
        assert cell["wall_defensible_s"] >= cell["wall_clock_s"]
    assert json.loads(out.read_text())["result_digest"] == got[
        "result_digest"]

    def no_run(*args, **kwargs):
        raise AssertionError("a cached cell ran again")

    monkeypatch.setattr(engine, "_run_cell", no_run)
    again = engine.run_campaign(pspec, out_path=str(out), device="cpu")
    assert again["result_digest"] == got["result_digest"]
    fresh = engine.run_campaign(pspec, out_path=None, wall_budget_s=-1.0,
                                device="cpu")
    assert fresh["skipped_cells"] == [0, 1] and fresh["cells"] == []


def _refused_spec(case):
    n = 1280
    base = dict(spec_mod.storm_scenario(n), n_payloads=64,
                packed_min_cells=0)
    kw = {}
    if case == "dense":
        # a fault plan on the dense round (its lanes are the next slice)
        base = dict(base, packed_min_cells=10 * 1024 * 1024)
        kw["events"] = (FaultEvent("loss", 0, 4, p=0.2),)
    elif case == "metered":
        base = dict(base, rate_limit_bytes_round=5 * 1024 * 1024)
    elif case == "matrix":
        base = dict(base, n_nodes=512)
        kw["events"] = (FaultEvent("loss", 0, 4, p=0.2),)
    elif case == "latency":
        base["n_delay_slots"] = 4
        kw["events"] = (FaultEvent("delay", 0, 4, delay_rounds=1),)
    elif case == "jitter":
        base["n_delay_slots"] = 4
        kw["events"] = (FaultEvent("jitter", 0, 4, delay_rounds=1),)
    elif case == "measure_wire":
        base["measure_wire"] = 1
    elif case == "peerswap":
        base = dict(base, peer_sampler="peerswap", swim_partial_view=False)
    elif case == "topo_family":
        base["topo_family"] = "wan-3x2"
    elif case == "topology_key":
        base["loss"] = 0.1
    elif case == "proto_family":
        base["proto_family"] = "push-pull"
    elif case == "proto_key":
        base["sync_cadence"] = "eager"
    elif case == "churn":
        base["churn"] = "flash-crowd"
    elif case == "host_parity":
        kw["host_parity"] = True
        kw["events"] = (FaultEvent("loss", 0, 4, p=0.2),)
    elif case == "full_view":
        base = dict(base, swim_partial_view=False, swim_full_view=True)
    if case == "detect":
        # a detect cell with the recorder (the recorder's lanes)
        return dataclasses.replace(spec_mod.swim_churn_64_spec(),
                                   telemetry=True)
    if case == "serving":
        return spec_mod.serving_3node_spec()
    return spec_mod.CampaignSpec(name=case, scenario=base, seeds=(0, 1),
                                 max_rounds=3, **kw)


REFUSED = ("dense", "metered", "matrix", "latency", "jitter", "telemetry",
           "measure_wire", "peerswap", "topo_family", "topology_key",
           "proto_family", "proto_key", "churn", "host_parity", "detect",
           "serving", "full_view", "mesh")


@pytest.mark.parametrize("case", REFUSED)
def test_engine_refuses_what_the_slice_does_not_run(case):
    """Each raises NotImplementedError naming its ROADMAP item; none runs
    some other way."""
    spec = _refused_spec(case)
    kw = {"device": "cpu"}
    if case == "telemetry":
        kw["telemetry"] = True
    if case == "mesh":
        kw["mesh_devices"] = 2
    with pytest.raises(NotImplementedError, match=r"ROADMAP (B16d|A13|A,)"):
        engine.run_campaign(spec, **kw)


def test_baseline_family_and_default_keys_run():
    """The refusals read what a cell resolves to: the baseline protocol
    family and explicit default knobs run, as the plain storm does."""
    base = dict(spec_mod.storm_scenario(512), n_payloads=64,
                packed_min_cells=0)
    arts = [engine.run_campaign(spec_mod.CampaignSpec(
        name="b", scenario=dict(base, **extra), seeds=(3,)), device="cpu")
        for extra in ({}, {"proto_family": "baseline"},
                      {"dissemination": "push", "loss": 0.0})]
    per_seed = [a["cells"][0]["per_seed"] for a in arts]
    assert per_seed[0] == per_seed[1] == per_seed[2]


def test_ensemble_refusals():
    spec = spec_mod.swim_churn_64_spec()
    with pytest.raises(NotImplementedError, match="B16d"):
        run_detect_ensemble(spec.sim_config({}), spec.topo({}), None, (0,),
                            telemetry=True, device="cpu")
    spec = _refused_spec("latency")
    with pytest.raises(NotImplementedError, match="B16d"):
        run_seed_ensemble(None, spec.sim_config({}), spec.topo({}), None,
                          (0,), telemetry=True, device="cpu")


def test_new_entry_points_default_to_the_card():
    """The campaign's entry points take device="cuda" by default and
    raise without a card (the port's device rule)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = spec_mod.storm_seeds_spec(range(2), n_nodes=512)
    cfg = spec.sim_config({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.run_campaign(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seed_states(cfg, (0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_seed_ensemble(None, cfg, spec.topo({}), None, (0,))


def test_percentile_lower_equals_jax():
    arr = np.array([-1, 3, 9, 4, -1, 12, 5], dtype=np.int32)
    assert engine._percentile_lower(arr, 99) == jengine._percentile_lower(
        arr, 99)
    none = np.full(4, -1, dtype=np.int32)
    assert engine._percentile_lower(none, 99) is None
