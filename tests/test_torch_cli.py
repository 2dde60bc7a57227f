"""The port's command line (`corrosion_tpu_torch.cli.main`) against JAX's
(`corrosion_tpu.cli.main`), both called in this process with their
output captured: the same argv (the port's with ``--device cpu``) prints
the same record, less the wall fields, the same flight-recorder JSONL
(the f32 byte channels within their bound), the same trace, topo, proto
and campaign views, and the same refusals with exit 2.  The port's own
refusals (JAX's flags and scenarios it does not carry) exit 2 naming the
ROADMAP item, and a run that does not ask for the CPU fails without a
card.  No JAX campaign runs here."""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from corrosion_tpu.cli import main as jax_cli
from corrosion_tpu_torch.cli import main as port_cli
from tests.torch_parity import jax_telemetry

ROOT = Path(__file__).resolve().parent.parent
BASELINES = ROOT / "doc" / "experiments"
U = 2.0 ** -24
#: a record's keys made of the wall clock
WALL = ("wall_clock_s", "rounds_per_sec", "node_rounds_per_sec")
CPU = ["--device", "cpu"]


def _run(cli, argv, capsys):
    """(exit code, stdout, stderr) of ``cli.main(argv)``."""
    try:
        rc = cli.main(argv)
    except SystemExit as exc:  # argparse, and the usage exits
        rc = exc.code if isinstance(exc.code, int) else 1
    out, err = capsys.readouterr()
    return rc, out, err


def _less_walls(record):
    return {k: v for k, v in record.items() if k not in WALL}


def test_ground_truth_record_matches_jax(capsys):
    argv = ["sim", "ground-truth-3node", "--seed", "0"]
    rc, out, _ = _run(jax_cli, argv, capsys)
    assert rc == 0
    want = json.loads(out)
    rc, out, _ = _run(port_cli, argv + CPU, capsys)
    assert rc == 0
    assert out.count("\n") == 1  # one JSON line
    got = json.loads(out)
    assert list(got) == list(want)
    assert _less_walls(got) == _less_walls(want)


def test_seeds_summary_and_runs_match_jax(capsys):
    argv = ["sim", "ground-truth-3node", "--seeds", "2", "--seed", "3"]
    rc, out, _ = _run(jax_cli, argv, capsys)
    assert rc == 0
    want = json.loads(out)
    rc, out, _ = _run(port_cli, argv + CPU, capsys)
    assert rc == 0
    got = json.loads(out)
    assert got["seeds"] == want["seeds"] == 2
    assert [_less_walls(r) for r in got["runs"]] == [
        _less_walls(r) for r in want["runs"]]
    assert _less_walls(got["summary"]) == _less_walls(want["summary"])
    assert got["summary"].keys() == want["summary"].keys()


def _within(got, want, m, label):
    assert abs(got - want) <= (m + 1) * U * abs(want) * (1 + U) + 0.1, label


def _assert_flight_equal(got_path, want_path, label):
    """Two flight-recorder JSONL files line by line: every key exactly
    but the f32 byte channels, each row's within its bound (m terms a
    round: N·F for the broadcast, P for the sync) and the summary's
    totals within the rows' bounds over the rounds."""
    got = [json.loads(x) for x in Path(got_path).read_text().splitlines()]
    want = [json.loads(x) for x in Path(want_path).read_text().splitlines()]
    assert len(got) == len(want), label
    head = want[0]
    m_bcast, m_sync = 3 * 2, head["n_payloads"]
    gh, wh = dict(got[0]), dict(want[0])
    gw = gh["summary"].pop("wire_bytes")
    ww = wh["summary"].pop("wire_bytes")
    assert gh == wh, label
    rounds = head["rounds"]
    for key, m in (("broadcast", m_bcast), ("sync", m_sync)):
        _within(gw[key], ww[key], m + 2 * rounds, f"{label} {key}")
    for g, w in zip(got[1:], want[1:]):
        g, w = dict(g), dict(w)
        for key, m in (("bcast_bytes", m_bcast), ("sync_bytes", m_sync)):
            _within(g.pop(key), w.pop(key), m, f"{label} t={w['t']} {key}")
        assert g == w, label


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The directory of both CLIs' two-seed recording runs of the 3-node
    ground truth (``jax.seed{0,1}.jsonl``, ``port.seed{0,1}.jsonl``)."""
    tmp = tmp_path_factory.mktemp("traces")
    jpath, ppath = tmp / "jax.jsonl", tmp / "port.jsonl"
    argv = ["sim", "ground-truth-3node", "--seeds", "2", "--trace-out"]
    with jax_telemetry():
        assert jax_cli.main(argv + [str(jpath)]) == 0
    assert port_cli.main(argv + [str(ppath)] + CPU) == 0
    return tmp


def test_trace_out_jsonl_matches_jax(traced):
    for seed in (0, 1):
        jpath = traced / f"jax.seed{seed}.jsonl"
        ppath = traced / f"port.seed{seed}.jsonl"
        assert jpath.is_file() and ppath.is_file()
        _assert_flight_equal(ppath, jpath, f"seed {seed}")
    assert not (traced / "port.jsonl").exists()


@pytest.mark.parametrize("extra", [[], ["--json"]], ids=["table", "json"])
def test_trace_show_prints_as_jax(traced, extra, capsys):
    argv = ["sim", "trace", "show", "--in", str(traced / "port.seed1.jsonl"),
            *extra]
    want = _run(jax_cli, argv, capsys)
    got = _run(port_cli, argv, capsys)
    assert got == want
    assert want[0] == 0 and ("flight recorder v1" in want[1] or extra)


VIEWS = {
    "topo-list": ["sim", "topo", "show"],
    "topo-list-json": ["sim", "topo", "show", "--json"],
    "topo-wan-3x2": ["sim", "topo", "show", "--topology", "wan-3x2",
                     "--nodes", "96"],
    "topo-wan-3x2-json": ["sim", "topo", "show", "--topology", "wan-3x2",
                          "--nodes", "96", "--json"],
    "topo-fly-6r": ["sim", "topo", "show", "--topology", "wan-fly-6r"],
    "topo-hetero-json": ["sim", "topo", "show", "--topology",
                         "hetero-degree", "--nodes", "10", "--json"],
    "proto-list": ["sim", "proto", "show"],
    "proto-list-json": ["sim", "proto", "show", "--json"],
    "proto-push-pull-json": ["sim", "proto", "show", "--proto", "push-pull",
                             "--json"],
    "proto-lab-ordered": ["sim", "proto", "show", "--proto", "lab-ordered"],
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_views_print_as_jax(view, capsys):
    want = _run(jax_cli, VIEWS[view], capsys)
    got = _run(port_cli, VIEWS[view], capsys)
    assert got == want
    assert want[0] == 0 and want[1]


def _worse(path: Path, tmp: Path) -> Path:
    art = json.loads(path.read_text())
    bands = art["cells"][0]["bands"]
    band = bands.get("rounds") or bands[sorted(bands)[0]]
    band["p99"] *= 3
    art["result_digest"] = "0" * 32
    out = tmp / "worse.json"
    out.write_text(json.dumps(art))
    return out


@pytest.mark.parametrize("spec", ["fault-parity-3node", "protocol-frontier",
                                  "serving-3node"])
def test_campaign_compare_and_report_print_as_jax(spec, tmp_path, capsys):
    base = BASELINES / f"CAMPAIGN_BASELINE_{spec}.json"
    worse = _worse(base, tmp_path)
    for argv in (
            ["sim", "campaign", "report", "--in", str(base)],
            ["sim", "campaign", "report", "--in", str(base), "--telemetry"],
            ["sim", "campaign", "compare", "--baseline", str(base),
             "--candidate", str(base)],
            ["sim", "campaign", "compare", "--baseline", str(base),
             "--candidate", str(worse), "--tol-frac", "0.05"]):
        want = _run(jax_cli, argv, capsys)
        got = _run(port_cli, argv, capsys)
        assert got == want, argv
    # the regress verdict; a serving cell's latency bands tolerate 2 s
    assert want[0] == (0 if spec == "serving-3node" else 1)


def test_campaign_run_gives_the_engine_golden(tmp_path, capsys):
    """``sim campaign run`` on the CPU: the fault campaign's one-seed
    cell gives the engine's golden, resumes from its artifact, and JAX's
    ``report`` of the port's artifact prints as the port's."""
    from corrosion_tpu_torch import goldens

    art = tmp_path / "campaign.json"
    argv = ["sim", "campaign", "run", "--spec", "fault-campaign-3node",
            "--seed", "0", "--out", str(art)]
    rc, out, _ = _run(port_cli, argv + CPU, capsys)
    assert rc == 0
    summary = json.loads(out)
    engine = goldens.FAULT_CAMPAIGN_3NODE_ENGINE
    assert (summary["spec_hash"], summary["result_digest"]) == (
        engine["spec_hash"], engine["result_digest"])
    assert summary["kernel_paths"] == {"{}": "dense"}
    assert summary["artifact"] == str(art) and summary["all_converged"]
    rc, again, _ = _run(port_cli, argv + CPU, capsys)  # resumed
    assert rc == 0 and json.loads(again) == summary
    report = ["sim", "campaign", "report", "--in", str(art)]
    assert _run(port_cli, report, capsys) == _run(jax_cli, report, capsys)


#: JAX's refusals (tests/cli/test_cli.py), each exit 2 on both sides
SHARED_REFUSALS = {
    "topology-axisless": ["sim", "swim-churn-64", "--topology", "wan-3x2"],
    "sampler-axisless": ["sim", "partition-heal-10k", "--sampler",
                         "peerswap"],
    "proto-axisless": ["sim", "swim-churn-64", "--proto", "push-pull"],
    "proto-unknown": ["sim", "broadcast-1k", "--proto", "no-such-family"],
    "proto-show-unknown": ["sim", "proto", "show", "--proto",
                           "no-such-family"],
    "topo-show-unknown": ["sim", "topo", "show", "--topology",
                          "no-such-family"],
    "telemetry-unsupported": ["sim", "partition-heal-10k", "--telemetry"],
    "trace-dir-on-scenario": ["sim", "broadcast-1k", "--trace-dir", "d"],
    "trace-out-on-campaign": ["sim", "campaign", "run", "--trace-out", "f"],
}

#: the port's own refusals: argv → what the message must name
PORT_REFUSALS = {
    "devices": (["sim", "fault-storm-1m", "--devices", "4"], "A13"),
    "mesh-devices": (["sim", "campaign", "run", "--spec",
                      "fault-parity-3node", "--mesh-devices", "4"], "A13"),
    "sharded-scenario": (["sim", "packed-fault-storm-sharded"], "A13"),
    "xla-profile": (["sim", "write-storm-100k", "--xla-profile", "d"],
                    "A11"),
    "profile-show": (["sim", "profile", "show", "--in", "f"], "A11"),
    "phase-profile": (["sim", "phase-profile"], "A11"),
    "memory-budget": (["sim", "memory-budget"], "A11"),
    "parity": (["sim", "trace", "show", "--in", "f", "--parity", "h"],
               "not queued"),
    "round-s": (["sim", "trace", "show", "--in", "f", "--round-s", "0.1"],
                "not queued"),
    "workers": (["sim", "write-storm-100k", "--workers", "2"], "not queued"),
    "writers": (["sim", "write-storm-100k", "--writers", "8"], "not queued"),
    "serving": (["sim", "serving-loadgen"], "not queued"),
    "serving-mp": (["sim", "serving-loadgen-mp"], "not queued"),
    "lint": (["sim", "lint"], "invalid choice"),
    "lint-flag": (["sim", "ground-truth-3node", "--no-baseline"],
                  "unrecognized arguments"),
}


@pytest.mark.parametrize(
    "case", [f"jax:{k}" for k in sorted(SHARED_REFUSALS)]
    + [f"port:{k}" for k in sorted(PORT_REFUSALS)])
def test_refusals_exit_2(case, capsys):
    kind, name = case.split(":")
    if kind == "jax":
        argv = SHARED_REFUSALS[name]
        want = _run(jax_cli, argv, capsys)
        got = _run(port_cli, argv, capsys)
        assert want[0] == 2
        assert got == want
        return
    argv, names = PORT_REFUSALS[name]
    rc, out, err = _run(port_cli, argv, capsys)
    assert rc == 2 and out == ""
    assert names in err, err


def test_scenarios_are_jax_names_with_jax_functions():
    """The port's scenarios are JAX's names for JAX's config functions;
    JAX's others are the refused ones, each config ROADMAP names."""
    from corrosion_tpu_torch.sim import runner

    ported = port_cli._SIM_SCENARIOS
    for name, fn in ported.items():
        assert jax_cli._SIM_SCENARIOS[name] == fn
        params = inspect.signature(getattr(runner, fn)).parameters
        assert params["device"].default == "cuda", fn
        assert "seed" in params, fn
    missing = set(jax_cli._SIM_SCENARIOS) - set(ported)
    assert missing == set(port_cli._UNPORTED_SCENARIOS)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name in missing:
        fn = jax_cli._SIM_SCENARIOS[name]
        assert fn in roadmap and fn in port_cli._UNPORTED_SCENARIOS[name]


def test_default_device_fails_without_a_card():
    """As a user starts it, with no ``--device``: the card, and without
    one the device error and a non-zero exit (no CPU fallback)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "corrosion_tpu_torch.cli.main", "sim",
         "ground-truth-3node"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "device='cuda' requested" in out.stderr
    assert "device='cpu'" in out.stderr
