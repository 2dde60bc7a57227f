"""The port's flight recorder against the JAX reference's.

Every RoundTrace channel of the port's runs is held against live JAX
(`tests.torch_parity.jax_telemetry` makes the JAX module importable for
the length of a block): the packed storm and fault storm at 512 nodes
(seed 7), the dense round's 3-node ground truth and broadcast-1k (the
word branch), gapstress at 64 nodes on the dense round (30 % loss, mixed
sizes, both budgets binding), two P % 32 != 0 runs (the bool branch:
full-view SWIM under loss, and metered budgets), and ``trace_every = 3``
(decimation and its scratch row) on both rounds.

Tolerances: every i32 channel, the coverage-curve digest and every
integer key of ``trace_summary`` are exact.  The two f32 byte channels
are exact int64 totals rounded once to f32 in the port, where JAX adds
m f32 terms (m = N·F for the broadcast, P for the sync grant's dot):
each row must equal fl(exact) and lie within m·2⁻²⁴·S of JAX's row for
the exact total S; ``wire_bytes`` (f32 sums of those rows) within the
rows' bounds plus both sums' own rounding.

Then the port against itself: dense and packed traces bit-equal (f32
included), telemetry-off runs unchanged, the exporter copies equal to
JAX's on the same host dict, and the plain versions of K17–K19 against
JAX's ``fused``/``telemetry`` functions at ragged shapes (rows not a
multiple of 15, words with bit 31 set, byte totals past 2^31).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import fused as jfused
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.sim.round import new_sim as jax_new_sim
from corrosion_tpu.sim.round import run_to_convergence as jax_run
from corrosion_tpu.sim.runner import _gapstress_cfg as jax_gapstress_cfg
from corrosion_tpu.sim.runner import (
    config_ground_truth_3node as jax_config_3node,
)
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_fault_plan
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import meta_from_numpy, state_digest
from corrosion_tpu_torch.sim import faults, fused, runner, telemetry
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import topology as ptopo
from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes
from corrosion_tpu_torch.sim.words import pack_bits
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    jax_digest,
    jax_telemetry,
    port_fields,
    storm_configs,
)

U = 2.0 ** -24
F32 = ("bcast_bytes", "sync_bytes")


# -- the scenarios ------------------------------------------------------------


def _dense(cfg_kw, topo_kw, seed, inject_every=1, sizes=None,
           max_rounds=400, optimize=False):
    return dict(cfg=cfg_kw, topo=topo_kw, seed=seed, inject=inject_every,
                sizes=sizes, max_rounds=max_rounds, optimize=optimize)


_GS = dict(jax_gapstress_cfg(64, 8).__dict__)
SCENARIOS = {
    "storm512": dict(storm=True),
    "storm512_every3": dict(storm=True, every=3),
    "fault512": dict(storm=True, faults=True),
    "3node": _dense(dict(n_nodes=3, n_payloads=64, fanout=2,
                         sync_interval_rounds=4), {}, 0, max_rounds=2000),
    "3node_every3": _dense(dict(n_nodes=3, n_payloads=64, fanout=2,
                                sync_interval_rounds=4, trace_every=3),
                           {}, 0, max_rounds=2000),
    "1k": _dense(dict(n_nodes=1000, n_payloads=256, n_writers=8, fanout=3,
                      n_delay_slots=4), {}, 0, inject_every=2,
                 max_rounds=2000, optimize=True),
    # config #5b at 64 nodes: under packed_min_cells, so the dense round
    "gs64": _dense(_GS, dict(loss=0.3), 1, inject_every=0,
                   sizes=gapstress_payload_sizes(8192)),
    # P % 32 != 0: the dense round's bool branch
    "lossy9": _dense(dict(n_nodes=24, n_payloads=16, fanout=2,
                          n_delay_slots=4, swim_full_view=True),
                     dict(n_regions=2, inter_delay=2, loss=0.2), 9),
    "metered": _dense(dict(n_nodes=40, n_payloads=24, n_writers=2,
                           chunks_per_version=3, fanout=3,
                           rate_limit_bytes_round=5 * 8192,
                           sync_budget_bytes=4 * 8192, n_delay_slots=3),
                      dict(n_regions=2, inter_delay=2), 11),
}


def _configs(name):
    """(jax cfg, jax meta, jax topo, port cfg, port meta, port topo, seed,
    max_rounds) of a scenario; the port's meta is JAX's, mapped."""
    sc = SCENARIOS[name]
    if sc.get("storm"):
        jcfg, jmeta, pcfg, pmeta = storm_configs(512, 256)
        every = sc.get("every", 1)
        jcfg = dataclasses.replace(jcfg, trace_every=every)
        pcfg = dataclasses.replace(pcfg, trace_every=every)
        return (jcfg, jmeta, jtopo.Topology(), pcfg, pmeta,
                ptopo.Topology(), 7, 600)
    jcfg = jstate.SimConfig(**sc["cfg"])
    jmeta = jstate.uniform_payloads(jcfg, inject_every=sc["inject"],
                                    payload_bytes=sc["sizes"])
    if sc["optimize"]:
        jcfg = jstate.optimize_budgets(jcfg, jmeta)
    pcfg = pstate.SimConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(pstate.SimConfig)})
    pmeta = meta_from_numpy(fields(jmeta), "cpu")
    return (jcfg, jmeta, jtopo.Topology(**sc["topo"]), pcfg, pmeta,
            ptopo.Topology(**sc["topo"]), sc["seed"], sc["max_rounds"])


def _port_run(name, telemetry_on=True, **cfg_changes):
    _, _, _, pcfg, pmeta, ptopo_, seed, max_rounds = _configs(name)
    pcfg = dataclasses.replace(pcfg, **cfg_changes)
    state = new_sim(pcfg, seed, "cpu")
    if SCENARIOS[name].get("faults"):
        plan = faults.compile_plan(runner.storm_fault_plan(512, seed), pcfg,
                                   ptopo_, factored=True, device="cpu")
        return faults.run_fault_plan(state, pmeta, pcfg, ptopo_, plan,
                                     max_rounds, telemetry_on)
    return run_to_convergence(state, pmeta, pcfg, ptopo_, max_rounds,
                              telemetry_on)


def _jax_run(name):
    jcfg, jmeta, jt, _, _, _, seed, max_rounds = _configs(name)
    state = jax_new_sim(jcfg, seed)
    if SCENARIOS[name].get("faults"):
        plan = jfaults.compile_plan(jax_storm_fault_plan(512, seed), jcfg,
                                    jt, factored=True)
        return jfaults.run_fault_plan(state, jmeta, jcfg, jt, plan,
                                      max_rounds=max_rounds, telemetry=True)
    return jax_run(state, jmeta, jcfg, jt, max_rounds, telemetry=True)


@pytest.fixture(scope="module")
def port_runs():
    """Every scenario's port run with telemetry, and per recorded row the
    exact int64 byte totals the row's f32 channels round."""
    out = {}
    orig = telemetry.record_row_plain

    def spy(trace, row, **kw):
        exact = (int(trace.acc[telemetry.ACC.index("bcast_bytes")]),
                 int((trace.counts[telemetry.GRANTS].long()
                      * kw["nbytes"].long()).sum()))
        spy.exact.append((row, exact))
        return orig(trace, row, **kw)

    telemetry.record_row_plain = spy
    try:
        for name in SCENARIOS:
            spy.exact = []
            final, metrics, trace = _port_run(name)
            out[name] = dict(final=final, metrics=metrics, trace=trace,
                             exact=list(spy.exact))
    finally:
        telemetry.record_row_plain = orig
    return out


@pytest.fixture(scope="module")
def jax_side(port_runs, tmp_path_factory):
    """Inside one shim window: every scenario's JAX run (host copies), and
    JAX's exporters on the port's host dicts."""
    out = {}
    with jax_telemetry() as jtel:
        for name in SCENARIOS:
            jcfg = _configs(name)[0]
            final, metrics, trace = _jax_run(name)
            rounds = int(final.t)
            every = jcfg.trace_every
            port_host = telemetry.trace_host(port_runs[name]["trace"],
                                             rounds, every)
            out[name] = dict(
                rounds=rounds,
                digest=jax_digest(final),
                metrics=fields(metrics),
                channels={f: np.asarray(getattr(trace, f))
                          for f in telemetry.CHANNELS},
                summary=jtel.trace_summary(jtel.trace_host(trace, rounds),
                                           rounds, jcfg),
                rows=jtel.trace_rows(jtel.trace_host(trace, rounds), rounds,
                                     jcfg),
                on_port_host=dict(
                    summary=jtel.trace_summary(port_host, rounds, jcfg),
                    rows=jtel.trace_rows(port_host, rounds, jcfg,
                                         per_payload=True),
                    latency=jtel.coverage_latency_rounds(port_host, rounds,
                                                         every),
                    digest=jtel.coverage_curve_digest(port_host, rounds,
                                                      every),
                ),
            )
            if name in ("storm512", "storm512_every3"):
                path = str(tmp_path_factory.mktemp("jax") / "f.jsonl")
                jtel.write_flight_jsonl(path, port_host, rounds, jcfg,
                                        header={"seed": 7})
                with open(path) as f:
                    out[name]["jsonl"] = f.read()
        out["words"] = _jax_word_functions(jtel)
    return out


# -- the f32 bound ------------------------------------------------------------


def _terms(name, channel):
    """m, the f32 terms JAX adds for one row of ``channel``."""
    pcfg = _configs(name)[3]
    if channel == "bcast_bytes":
        return pcfg.n_nodes * pcfg.fanout
    return pcfg.n_payloads


def _assert_f32_rows(name, port_runs, jax_side):
    """Each recorded f32 row equals fl(exact int64 total) and lies within
    m·2⁻²⁴·S of JAX's row; returns the largest relative gap."""
    worst = 0.0
    trace = port_runs[name]["trace"]
    # a decimated run writes its scratch row again and again: the last
    # write stands
    for row, exact in dict(port_runs[name]["exact"]).items():
        for channel, s in zip(F32, exact):
            got = getattr(trace, channel)[row].item()
            assert np.float32(got) == np.float32(np.int64(s)), (
                name, channel, row, got, s)
            want = float(jax_side[name]["channels"][channel][row])
            m = _terms(name, channel)
            assert abs(want - s) <= m * U * s, (name, channel, row, want, s)
            if s:
                worst = max(worst, abs(want - got) / s)
    return worst


# -- whole runs against JAX -----------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_channels_match_jax(name, port_runs, jax_side):
    """Same rounds and final state as JAX with telemetry on; every i32
    channel equal over the whole buffer (the decimated scratch row too);
    the f32 rows fl(exact) and within the bound of JAX's."""
    run, want = port_runs[name], jax_side[name]
    assert int(run["final"].t) == want["rounds"]
    assert state_digest(run["final"]) == want["digest"]
    assert_fields_equal(want["metrics"], fields(run["metrics"]), "metrics")
    for f in telemetry.CHANNELS:
        got = getattr(run["trace"], f).numpy()
        assert got.dtype == want["channels"][f].dtype, f
        assert got.shape == want["channels"][f].shape, f
        if f not in F32:
            np.testing.assert_array_equal(got, want["channels"][f],
                                          err_msg=f"{name}: {f}")
    worst = _assert_f32_rows(name, port_runs, jax_side)
    # the f32 totals of the 8 KiB-payload runs are exact on both sides;
    # gapstress's mixed sizes round (JAX's f32 sums drift, up to a few
    # parts per million here, inside the bound)
    if name != "gs64":
        assert worst == 0.0, (name, worst)


def _without_bytes(summary):
    return {k: v for k, v in summary.items() if k != "wire_bytes"}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_summary_and_rows_match_jax(name, port_runs, jax_side):
    """trace_summary equal on every key but ``wire_bytes`` (within the
    rows' bound plus both f32 sums' rounding); trace_rows equal but the
    two byte fields."""
    run, want = port_runs[name], jax_side[name]
    cfg = _configs(name)[3]
    rounds = want["rounds"]
    got = telemetry.trace_summary(telemetry.trace_host(run["trace"], rounds),
                                  rounds, cfg)
    assert _without_bytes(got) == _without_bytes(want["summary"])
    for key, channel in (("broadcast", "bcast_bytes"), ("sync", "sync_bytes")):
        s = sum(exact[F32.index(channel)] for _, exact in run["exact"])
        m = _terms(name, channel)
        rows = len(run["exact"])
        bound = (m + 2 * rows) * U * s + 0.1  # and round(., 1)
        assert abs(got["wire_bytes"][key] - want["summary"]["wire_bytes"][
            key]) <= bound, (name, key)
    rows = telemetry.trace_rows(telemetry.trace_host(run["trace"], rounds),
                                rounds, cfg)
    drop = ("bcast_bytes", "sync_bytes")
    assert [{k: v for k, v in r.items() if k not in drop} for r in rows] == [
        {k: v for k, v in r.items() if k not in drop} for r in want["rows"]]


@pytest.mark.parametrize("name, golden", (
    ("3node", goldens.GROUND_TRUTH_3NODE_SEED0_TELEMETRY),
    ("1k", goldens.BROADCAST_1K_SEED0_TELEMETRY),
))
def test_small_telemetry_goldens_match_live_jax(name, golden, jax_side):
    """The telemetry goldens the card is held to, for the runs small
    enough to repeat here, equal live JAX (both are the configs' own
    runs: run_scenario's max_rounds of 2000)."""
    want = jax_side[name]
    assert golden["summary"] == _without_bytes(want["summary"])
    assert golden["wire_bytes"] == want["summary"]["wire_bytes"]
    r = want["rounds"]
    for channel in F32:
        assert golden[channel] == [float(x) for x in
                                   want["channels"][channel][:r]]


def test_config_record_and_flight_jsonl_match_jax(tmp_path):
    """config_ground_truth_3node(telemetry, trace_path): the record's
    summary block and the flight-recorder file equal JAX's."""
    jpath, ppath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    with jax_telemetry():
        want = jax_config_3node(0, trace_path=str(jpath))
    got = runner.config_ground_truth_3node(0, trace_path=str(ppath),
                                           device="cpu")
    assert got["telemetry"] == want["telemetry"]
    assert ppath.read_text() == jpath.read_text()


# -- the port against itself ----------------------------------------------------


@pytest.mark.parametrize("name", ("storm512", "gs64"))
def test_dense_and_packed_traces_bit_equal(name, port_runs):
    """The same run on the packed round and on the dense round
    (packed_min_cells toggled) records bit-equal traces, f32 included."""
    cfg = _configs(name)[3]
    assert cfg.n_payloads % 32 == 0
    if name == "storm512":
        other = dict(packed_min_cells=1 << 40)  # the dense round
    else:
        other = dict(packed_min_cells=0)  # the packed round
    assert pstate.packed_supported(cfg) != pstate.packed_supported(
        dataclasses.replace(cfg, **other))
    _, _, trace = _port_run(name, **other)
    for f in telemetry.CHANNELS:
        assert torch.equal(getattr(trace, f),
                           getattr(port_runs[name]["trace"], f)), f


@pytest.mark.parametrize("name", ("storm512", "fault512", "lossy9"))
def test_telemetry_off_runs_unchanged(name, port_runs):
    """Recording a trace changes neither the final state nor the
    metrics."""
    final, metrics = _port_run(name, telemetry_on=False)
    assert_fields_equal(port_fields(port_runs[name]["final"]),
                        port_fields(final), "final")
    assert_fields_equal(fields(port_runs[name]["metrics"]), fields(metrics),
                        "metrics")


@pytest.mark.parametrize("name", ("storm512", "storm512_every3", "lossy9"))
def test_exporter_copies_equal_jax_on_the_same_host_dict(name, port_runs,
                                                         jax_side, tmp_path):
    """The port's trace_summary, trace_rows, coverage_latency_rounds,
    coverage_curve_digest and write_flight_jsonl give JAX's output on
    one host dict."""
    cfg = _configs(name)[3]
    rounds = jax_side[name]["rounds"]
    every = cfg.trace_every
    host = telemetry.trace_host(port_runs[name]["trace"], rounds, every)
    want = jax_side[name]["on_port_host"]
    assert telemetry.trace_summary(host, rounds, cfg) == want["summary"]
    assert telemetry.trace_rows(host, rounds, cfg,
                                per_payload=True) == want["rows"]
    np.testing.assert_array_equal(
        telemetry.coverage_latency_rounds(host, rounds, every),
        want["latency"])
    assert telemetry.coverage_curve_digest(host, rounds, every) == (
        want["digest"])
    if "jsonl" in jax_side[name]:
        path = tmp_path / "port.jsonl"
        telemetry.write_flight_jsonl(str(path), host, rounds, cfg,
                                     header={"seed": 7})
        assert path.read_text() == jax_side[name]["jsonl"]
        head = json.loads(path.read_text().splitlines()[0])
        assert head.get("trace_every", 1) == every


def test_trace_every_validated():
    with pytest.raises(ValueError, match="trace_every"):
        pstate.SimConfig(n_nodes=4, n_payloads=32, trace_every=0)


# -- the plain versions of K17-K19 against JAX's functions ---------------------

# rows not a multiple of 15 (the nibble chunk), words with bit 31 set
WORD_SHAPES = ((1003, 5), (15, 1), (46, 16), (1, 3), (301, 256))


def _words(g, shape):
    w = g.integers(0, 1 << 32, shape, dtype=np.uint32)
    w[..., 0] |= np.uint32(1 << 31)
    return w


def _jax_word_functions(jtel):
    """JAX's counters on seeded inputs (inside the shim window)."""
    import jax.numpy as jnp

    out = {}
    for rows, w in WORD_SHAPES:
        g = np.random.default_rng(rows * 7 + w)
        words, words0 = _words(g, (rows, w)), _words(g, (rows, w))
        up = g.random(rows) < 0.8
        nbytes = g.integers(1, 65536, w * 32).astype(np.int32)
        ok = g.random((rows, 3)) < 0.7
        cov, dlv = jtel.word_coverage_delivered(
            jnp.asarray(words), jnp.asarray(words0), jnp.asarray(up), w * 32)
        fr, by = jfused.word_send_stats(jnp.asarray(words),
                                        jnp.asarray(nbytes))
        dense = g.random((rows, w * 32)) < 0.3
        dfr, dby = jfused.dense_send_stats(jnp.asarray(dense),
                                           jnp.asarray(nbytes))
        counts = g.integers(0, 3000, w * 32).astype(np.int32)
        gfr, gby = jfused.grant_fold(jnp.asarray(counts),
                                     jnp.asarray(nbytes))
        out[(rows, w)] = dict(
            inputs=(words, words0, up, nbytes, ok, dense, counts),
            bit_counts=np.asarray(jfused.word_bit_counts(
                jnp.asarray(words), w * 32)),
            coverage=np.asarray(cov), delivered=np.asarray(dlv),
            frames=np.asarray(fr), bytes=np.asarray(by),
            dense_frames=np.asarray(dfr), dense_bytes=np.asarray(dby),
            fold_bytes=float(jnp.sum(jnp.where(
                jnp.asarray(ok), by.astype(jnp.float32)[:, None], 0.0))),
            grant=(int(gfr), float(gby)),
        )
    g = np.random.default_rng(5)
    pid, pkey = _random_members(g, 301, 17)
    view = g.integers(-1, 3, (45, 45)).astype(np.int8)
    out["swim"] = dict(pid=pid, pkey=pkey, view=view)
    for kind, kw in (("partial", dict(swim_partial_view=True)),
                     ("full", dict(swim_full_view=True)), ("none", {})):
        cfg = jstate.SimConfig(n_nodes=4, n_payloads=32, **kw)
        st = _FakeState(jnp.asarray(pid), jnp.asarray(pkey),
                        jnp.asarray(view), None)
        s, d = jtel.swim_belief_counts(st, cfg)
        out["swim"][kind] = (int(s), int(d))
    out["rows"] = {every: [int(jtel._trace_row(_RowsOnly(9), t, every))
                           for t in range(20)] for every in (1, 3)}
    out["record"] = _jax_record(jtel)
    return out


class _FakeState:
    def __init__(self, pid, pkey, view, alive):
        self.pid, self.pkey, self.view, self.alive = pid, pkey, view, alive


class _RowsOnly:
    def __init__(self, n):
        self.up_nodes = np.zeros(n)


def _random_members(g, n, m):
    pid = np.where(g.random((n, m)) < 0.8, g.integers(0, n, (n, m)), -1)
    inc = g.integers(0, 2047, (n, m))
    pkey = np.where(pid >= 0, inc * 4 + g.integers(0, 4, (n, m)), -1)
    return pid.astype(np.int32), pkey.astype(np.int32)


@pytest.mark.parametrize("shape", WORD_SHAPES)
def test_word_counters_match_jax(shape, jax_side):
    """K17's and K18's plain versions against JAX's fused counters."""
    want = jax_side["words"][shape]
    words, words0, up, nbytes, ok, dense, counts = want["inputs"]
    rows, w = shape
    p = w * 32
    tw = torch.as_tensor(words.view(np.int32))
    tw0 = torch.as_tensor(words0.view(np.int32))
    tnb = torch.as_tensor(nbytes)
    np.testing.assert_array_equal(fused.word_bit_counts(tw, p).numpy(),
                                  want["bit_counts"])
    cov, dlv = telemetry.word_coverage_delivered(tw, tw0, torch.as_tensor(up),
                                                 p)
    np.testing.assert_array_equal(cov.numpy(), want["coverage"])
    np.testing.assert_array_equal(dlv.numpy(), want["delivered"])
    # the count entries add into a row, as K17 does
    out = torch.full((2, p), 5, dtype=torch.int32)
    alive = torch.as_tensor(np.where(up, 0, 2).astype(np.uint8))
    telemetry.coverage_delivered_(out, tw, tw0, alive)
    np.testing.assert_array_equal(out.numpy() - 5,
                                  np.stack([want["coverage"],
                                            want["delivered"]]))
    grants = torch.zeros(p, dtype=torch.int32)
    telemetry.count_words_(grants, tw)
    np.testing.assert_array_equal(grants.numpy(), want["bit_counts"])
    fr, by = fused.word_send_stats(tw, tnb)
    np.testing.assert_array_equal(fr.numpy(), want["frames"])
    # per-row totals fit i32 here, so JAX's i32 equals the exact int64
    assert by.dtype == torch.int64
    np.testing.assert_array_equal(by.numpy(), want["bytes"].astype(np.int64))
    dfr, dby = fused.dense_send_stats(torch.as_tensor(dense), tnb)
    np.testing.assert_array_equal(dfr.numpy(), want["dense_frames"])
    np.testing.assert_array_equal(dby.numpy(), want["dense_bytes"])
    np.testing.assert_array_equal(
        dby.numpy(),
        fused.word_byte_totals(pack_bits(torch.as_tensor(dense)),
                               tnb).numpy())
    # the fold over ok edges: exact in int64, past 2^31 at the big shapes
    tok = torch.as_tensor(ok.reshape(-1))
    f_tot, b_tot = fused.fold_over_edges(fr, by, tok, 3)
    exact = int((want["bytes"].astype(np.int64)[:, None] * ok).sum())
    assert int(b_tot) == exact
    assert int(f_tot) == int((want["frames"][:, None] * ok).sum())
    assert abs(want["fold_bytes"] - exact) <= rows * 3 * U * exact
    # K18's plain wrapper accumulates the same totals
    trace = telemetry.new_trace(
        pstate.SimConfig(n_nodes=rows, n_payloads=p), 2, "cpu")
    telemetry.wire_words_(trace.acc[telemetry.WIRE], tw, tnb, tok, 3)
    assert trace.acc[:2].tolist() == [int(f_tot), exact]
    # the grant fold: frames exact, bytes fl(exact) within JAX's bound
    gfr, gby = fused.grant_fold(torch.as_tensor(counts), tnb)
    g_exact = int((counts.astype(np.int64) * nbytes).sum())
    assert int(gfr) == want["grant"][0]
    assert gby.item() == float(np.float32(g_exact))
    assert abs(want["grant"][1] - g_exact) <= p * U * g_exact


def test_byte_totals_past_2_31(jax_side):
    """The largest shapes' folds pass 2^31: the int64 path holds them."""
    rows, w = WORD_SHAPES[-1]
    words, _, _, nbytes, ok, _, counts = jax_side["words"][(rows, w)]["inputs"]
    by = jax_side["words"][(rows, w)]["bytes"].astype(np.int64)
    assert int((by[:, None] * ok).sum()) > 1 << 31
    assert int((counts.astype(np.int64) * nbytes).sum()) > 1 << 31


@pytest.mark.parametrize("kind", ("partial", "full", "none"))
def test_swim_belief_counts_match_jax(kind, jax_side):
    want = jax_side["words"]["swim"]
    kw = {"partial": dict(swim_partial_view=True),
          "full": dict(swim_full_view=True), "none": {}}[kind]
    cfg = pstate.SimConfig(n_nodes=4, n_payloads=32, **kw)
    st = _FakeState(torch.as_tensor(want["pid"]),
                    torch.as_tensor(want["pkey"]),
                    torch.as_tensor(want["view"]),
                    torch.zeros(4, dtype=torch.uint8))
    s, d = telemetry.swim_belief_counts(st, cfg)
    assert (int(s), int(d)) == want[kind]
    assert s.dtype == d.dtype == torch.int32


@pytest.mark.parametrize("every", (1, 3))
def test_trace_row_matches_jax(every, jax_side):
    trace = telemetry.new_trace(
        pstate.SimConfig(n_nodes=4, n_payloads=32, trace_every=every),
        (9 - 1) * every if every > 1 else 9, "cpu")
    assert trace.up_nodes.shape[0] == 9
    assert [telemetry.trace_row(trace, t, every) for t in range(20)] == (
        jax_side["words"]["rows"][every])


def _record_inputs():
    g = np.random.default_rng(11)
    n, p, m = 37, 96, 5
    return dict(
        n=n, p=p,
        acc=np.array([g.integers(0, 1 << 31), (1 << 33) + 12345,
                      g.integers(0, 9999), g.integers(0, 999),
                      g.integers(0, 99)], np.int64),
        counts=g.integers(0, 500, (3, p)).astype(np.int32),
        nbytes=g.integers(1, 65536, p).astype(np.int32),
        alive=(g.random(n) < 0.2).astype(np.uint8) * 2,
        pid=np.where(g.random((n, m)) < 0.8, g.integers(0, n, (n, m)), -1)
        .astype(np.int32),
        pkey=g.integers(0, 400, (n, m)).astype(np.int32),
        rf_alive=g.integers(-1, 3, n).astype(np.int8),
        rf_wipe=g.random(n) < 0.1,
        sync_ok=g.random(n * 3) < 0.6,
        n_overflow=np.int32(17),
    )


def _jax_record(jtel):
    """JAX's record_round + record_node_faults on `_record_inputs`, with
    the wire and sync tuples built as the port's plain K19 builds them."""
    import jax.numpy as jnp

    x = _record_inputs()
    cfg = jstate.SimConfig(n_nodes=x["n"], n_payloads=x["p"],
                           swim_partial_view=True, member_slots=5)
    out = {}
    for every in (1, 3):
        trace = jtel.new_trace(dataclasses.replace(cfg, trace_every=every), 8)
        for t in (4, 5):
            acc, counts = x["acc"], x["counts"]
            frames, byte_tot = jfused.grant_fold(jnp.asarray(counts[2]),
                                                 jnp.asarray(x["nbytes"]))
            st = _FakeState(jnp.asarray(x["pid"]), jnp.asarray(x["pkey"]),
                            None, None)
            susp, dn = jtel.swim_belief_counts(st, cfg)
            trace = jtel.record_round(
                trace, jnp.int32(t), coverage=jnp.asarray(counts[0]),
                delivered=jnp.asarray(counts[1]),
                up_nodes=jnp.sum(jnp.asarray(x["alive"]) == 0,
                                 dtype=jnp.int32),
                wire=jtel.WireTel(frames=jnp.int32(acc[0]),
                                  bytes=jnp.float32(np.float32(acc[1])),
                                  dropped=jnp.int32(acc[2]),
                                  cut=jnp.int32(acc[3])),
                sync=jtel.SyncTel(
                    sessions=jnp.sum(jnp.asarray(x["sync_ok"]),
                                     dtype=jnp.int32),
                    refused=jnp.int32(acc[4]), frames=frames,
                    bytes=jnp.float32(np.float32(
                        int((counts[2].astype(np.int64)
                             * x["nbytes"]).sum())))),
                swim_suspect=susp, swim_down=dn,
                gap_overflow=jnp.int32(x["n_overflow"]), every=every)

            class RF:
                alive = jnp.asarray(x["rf_alive"])
                wipe = jnp.asarray(x["rf_wipe"])

            trace = jtel.record_node_faults(trace, jnp.int32(t), RF, every)
        out[every] = {f: np.asarray(getattr(trace, f))
                      for f in telemetry.CHANNELS}
    return out


@pytest.mark.parametrize("every", (1, 3))
def test_record_row_matches_jax_record_round(every, jax_side):
    """K19's plain version writes the row JAX's record_round and
    record_node_faults write from the same totals (rounds 4 and 5; at
    every = 3 both land in the scratch row), and zeroes the
    accumulators."""
    x = _record_inputs()
    cfg = pstate.SimConfig(n_nodes=x["n"], n_payloads=x["p"],
                           swim_partial_view=True, member_slots=5,
                           trace_every=every)
    trace = telemetry.new_trace(cfg, 8, "cpu")
    st = _FakeState(torch.as_tensor(x["pid"]), torch.as_tensor(x["pkey"]),
                    None, torch.as_tensor(x["alive"]))

    class RF:
        alive = torch.as_tensor(x["rf_alive"])
        wipe = torch.as_tensor(x["rf_wipe"])

    for t in (4, 5):
        trace.acc[:5] = torch.as_tensor(x["acc"])
        trace.counts.copy_(torch.as_tensor(x["counts"]))
        telemetry.record_row(
            trace, telemetry.trace_row(trace, t, every),
            alive=torch.as_tensor(x["alive"]), state=st, cfg=cfg, rf=RF,
            sync_ok=torch.as_tensor(x["sync_ok"]),
            n_overflow=torch.as_tensor(x["n_overflow"]),
            nbytes=torch.as_tensor(x["nbytes"]))
        assert not trace.acc.any() and not trace.counts.any()
    want = jax_side["words"]["record"][every]
    for f in telemetry.CHANNELS:
        np.testing.assert_array_equal(getattr(trace, f).numpy(), want[f],
                                      err_msg=f)
