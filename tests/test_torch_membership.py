"""Membership churn in the port (`sim/telemetry.py`
`run_membership_detect` with K23's plain versions, `sim/runner.py`
configs #2 and #2b) against the live JAX reference, exact: the two
detect predicates on random tables that reach K23's traps, whole detect
runs (final state, metrics, detect round, every trace channel) at full
view and partial view, both configs' records less the wall, and the
refusal without a SWIM tier.  Every JAX detect call runs inside
`tests.torch_parity.jax_telemetry()`: JAX's telemetry module, which
holds `run_membership_detect`, imports only under that shim (jax
0.9.0).  ``-m slow`` re-derives the card's detect goldens from live
JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import round as jround
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu_torch import goldens
from corrosion_tpu_torch.convert import state_digest
from corrosion_tpu_torch.sim import round as pround
from corrosion_tpu_torch.sim import runner
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import telemetry as ptel
from corrosion_tpu_torch.sim.pswim import INC_CLAMP
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import (
    assert_metrics_equal,
    assert_states_equal,
    jax_digest,
    jax_telemetry,
    random_tables,
)

DOWN = jstate.DOWN


# -- the predicates -----------------------------------------------------------


def _jax_full(view, up):
    """JAX's full-view predicate (corrosion_tpu/sim/telemetry.py:344-347)
    on ``up`` taken at entry."""
    pair_watched = up[:, None] & ~up[None, :]
    return jnp.all(jnp.where(pair_watched, view == DOWN, True))


def _jax_partial(pid, pkey, up):
    """JAX's partial-view predicate (telemetry.py:351-355)."""
    watcher_up = up[:, None]
    entry_dead = (pid >= 0) & ~up[jnp.maximum(pid, 0)]
    marked = pkey % 4 == DOWN
    return jnp.all(jnp.where(watcher_up & entry_dead, marked, True))


def _jax_update(detect_round, held, t):
    """The loop body's update (telemetry.py:385-387)."""
    return int(jnp.where((detect_round < 0) & held, t, detect_round))


def _port_detect(fn, start, t, *args):
    detect = ptel.new_detect("cpu")
    detect[0] = start
    fn(detect, *args, t)
    assert detect[1:].tolist() == [0, 0]
    return int(detect[0])


@pytest.mark.parametrize("n", (33, 64, 97))
@pytest.mark.parametrize("case", ("held", "suspect", "noise"))
@pytest.mark.parametrize("start", (-1, 5))
def test_full_predicate_matches_jax(n, case, start):
    """Every (up, dead) cell DOWN among random beliefs elsewhere (DOWN on
    (up, up) and (dead, ·) cells among them); the same with one (up,
    dead) cell at SUSPECT; random beliefs throughout.  From detect_round
    -1, and from 5, which must stay."""
    g = np.random.default_rng(n)
    up = np.arange(n) % 3 != 0
    up[g.random(n) < 0.1] = False
    view = g.integers(0, 3, (n, n)).astype(np.int8)
    if case != "noise":
        view[np.ix_(up, ~up)] = DOWN
    if case == "suspect":
        view[np.flatnonzero(up)[-1], np.flatnonzero(~up)[0]] = jstate.SUSPECT
    assert ((view == DOWN) & up[:, None] & up[None, :]).any()
    assert (view[~up] == DOWN).any()
    t = 23
    want = _jax_update(start, _jax_full(jnp.asarray(view), jnp.asarray(up)),
                       t)
    got = _port_detect(ptel.detect_full_plain, start, t, torch.as_tensor(view),
                       torch.as_tensor(up))
    assert got == want
    assert (want == t) == (start < 0 and case == "held")


@pytest.mark.parametrize("n, m", ((40, 8), (301, 16), (1000, 64)))
@pytest.mark.parametrize("case", ("held", "alive", "noise"))
@pytest.mark.parametrize("start", (-1, 5))
def test_partial_predicate_matches_jax(n, m, case, start):
    """Tables where every entry of an up watcher naming a dead member is
    DOWN (some at INC_CLAMP * 4 + 2), dead watchers' rows naming dead
    members unmarked, and empty entries with pid = pkey = -1 — on which
    C's % and JAX's floor-mod differ (-1 against 3), so the mask must
    carry them; then one watched entry ALIVE; then random tables."""
    g = np.random.default_rng(n + m)
    up = np.arange(n) % 3 != 0
    pid, pkey, _ = random_tables(g, n, m, 20)
    watched = up[:, None] & (pid >= 0) & ~up[np.maximum(pid, 0)]
    if case != "noise":
        inc = np.where(g.random((n, m)) < 0.2, INC_CLAMP, pkey >> 2)
        pkey = np.where(watched, inc * 4 + DOWN, pkey).astype(np.int32)
    if case == "alive":
        i, s = (int(x[0]) for x in np.nonzero(watched))
        pkey[i, s] -= DOWN
    empty = (pid < 0) & (pkey == -1)
    assert empty.any() and (np.asarray(jnp.asarray(pkey) % 4)[empty] == 3).all()
    assert (~up[:, None] & (pid >= 0) & ~up[np.maximum(pid, 0)]
            & (pkey % 4 != DOWN)).any()
    if case != "noise":
        assert (watched & (pkey == INC_CLAMP * 4 + DOWN)).any()
    t = 31
    want = _jax_update(start, _jax_partial(jnp.asarray(pid), jnp.asarray(pkey),
                                           jnp.asarray(up)), t)
    got = _port_detect(ptel.detect_partial_plain, start, t,
                       torch.as_tensor(pid), torch.as_tensor(pkey),
                       torch.as_tensor(up))
    assert got == want
    assert (want == t) == (start < 0 and case == "held")


# -- whole detect runs -----------------------------------------------------------


def _tier(partial):
    return (dict(swim_partial_view=True, probe_period_rounds=1) if partial
            else dict(swim_full_view=True))


def _jax_detect(n, partial, seed, max_rounds, telemetry):
    """JAX's run_membership_detect on the churn setup, with the lane
    stats of its engine, and the trace's summary and digest."""
    from corrosion_tpu.campaign.engine import _membership_lane_stats

    with jax_telemetry() as tel:
        cfg = jstate.SimConfig.wan_tuned(n, n_payloads=1, **_tier(partial))
        meta = jstate.uniform_payloads(cfg, inject_every=1)
        kill = jnp.arange(n) % 3 == 0
        state = jround.new_sim(cfg, seed)._replace(alive=jnp.where(
            kill, jnp.uint8(DOWN), jnp.uint8(jstate.ALIVE)))
        out = tel.run_membership_detect(state, meta, cfg, jtopo.Topology(),
                                        max_rounds, telemetry=telemetry)
        final = out[0]
        stats = _membership_lane_stats(jax.tree.map(lambda x: x[None], final),
                                       cfg)
        rec = {"out": out, "stats": {k: v[0] for k, v in stats.items()}}
        if telemetry:
            rounds = int(final.t)
            host = tel.trace_host(out[3], rounds)
            rec["summary"] = tel.trace_summary(host, rounds, cfg)
            rec["host"] = host
        return rec


def _port_detect_run(n, partial, seed, max_rounds, telemetry):
    cfg = pstate.SimConfig.wan_tuned(n, n_payloads=1, **_tier(partial))
    meta, state = runner.churn_setup(cfg, seed, torch.device("cpu"))
    return cfg, ptel.run_membership_detect(state, meta, cfg, Topology(),
                                           max_rounds, telemetry, "cpu")


@pytest.mark.parametrize("n, partial, seed, max_rounds, telemetry", (
    (64, False, 0, 400, False), (64, False, 0, 400, True),
    (256, True, 1, 800, False), (256, True, 1, 800, True),
    (512, True, 1, 800, True)))
def test_run_membership_detect_matches_jax(n, partial, seed, max_rounds,
                                           telemetry):
    """Final state, RunMetrics, detect_round and, with the recorder,
    every trace channel and the summary (exact: the one payload's writer,
    node 0, is killed, so every byte channel is 0 on both sides).  512
    nodes, seed 1, 800 rounds is tests/sim/test_pswim.py
    test_partial_churn_config_detects_all's own case."""
    want = _jax_detect(n, partial, seed, max_rounds, telemetry)
    cfg, got = _port_detect_run(n, partial, seed, max_rounds, telemetry)
    jout = want["out"]
    label = f"{n}/{'partial' if partial else 'full'}"
    assert int(got[2]) == int(jout[2]), label
    assert_states_equal(jout[0], got[0], label)
    assert_metrics_equal(jout[1], got[1], label)
    if n == 64:
        assert int(got[2]) == goldens.SWIM_CHURN_64_SEED0["detect_round"]
    if telemetry:
        rounds = int(got[0].t)
        host = ptel.trace_host(got[3], rounds)
        for name in ptel.CHANNELS:
            np.testing.assert_array_equal(want["host"][name], host[name],
                                          err_msg=f"{label}: {name}")
            assert want["host"][name].dtype == host[name].dtype, name
        assert ptel.trace_summary(got[3], rounds, cfg) == want["summary"]
        assert ptel.trace_digest(got[3], rounds) == ptel.trace_digest(
            want["host"], rounds)


def test_detect_needs_a_swim_tier():
    """Without either SWIM tier JAX raises ValueError at trace time; the
    port raises the same before any round."""
    cfg = pstate.SimConfig.wan_tuned(32, n_payloads=1)
    meta, state = runner.churn_setup(cfg, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a SWIM tier"):
        ptel.run_membership_detect(state, meta, cfg, Topology(),
                                   device="cpu")
    with jax_telemetry() as tel:
        jcfg = jstate.SimConfig.wan_tuned(32, n_payloads=1)
        with pytest.raises(ValueError, match="needs a SWIM tier"):
            tel.run_membership_detect(
                jround.new_sim(jcfg, 0), jstate.uniform_payloads(jcfg),
                jcfg, jtopo.Topology())


def test_detect_state_must_lie_on_device():
    cfg = pstate.SimConfig.wan_tuned(32, n_payloads=1, swim_full_view=True)
    meta, state = runner.churn_setup(cfg, 0, torch.device("cpu"))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on"):
            ptel.run_membership_detect(state, meta, cfg, Topology())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptel.run_membership_detect(state, meta, cfg, Topology())


# -- the configs' records ----------------------------------------------------------


def _record_pair(jax_config, port_config, **kw):
    """Both packages' records of one config, less the wall: the engine's
    spec_hash and result_digest stay in both."""
    with jax_telemetry():
        want = jax_config(**kw)
    got = port_config(device="cpu", return_state=True, **kw)
    state = got.pop("state")
    got.pop("metrics")
    assert got.pop("wall_clock_s") >= 0
    want.pop("wall_clock_s")
    return want, got, state


def test_config_swim_churn_64_record_matches_jax():
    """Config #2's record through the campaign engine, key for key less
    the wall, JAX's spec_hash and result_digest included; it is the
    card's golden."""
    from corrosion_tpu.sim.runner import config_swim_churn_64

    want, got, state = _record_pair(config_swim_churn_64,
                                    runner.config_swim_churn_64, seed=0)
    assert got == want
    golden = dict(goldens.SWIM_CHURN_64_SEED0)
    assert state_digest(state) == golden.pop("digest")
    assert {k: got[k] for k in golden} == golden


@pytest.mark.parametrize("seed, n, max_rounds", ((1, 512, 800),
                                                 (0, 300, 120)))
def test_config_swim_churn_partial_record_matches_jax(seed, n, max_rounds):
    """Config #2b's record at the failing JAX test's own case (512 nodes,
    seed 1, 800 rounds) and at one that stops undetected, key for key
    less the wall (``member_slots``, ``spec_hash`` and ``result_digest``
    included)."""
    from corrosion_tpu.sim.runner import config_swim_churn_partial

    want, got, _ = _record_pair(config_swim_churn_partial,
                                runner.config_swim_churn_partial, seed=seed,
                                n=n, max_rounds=max_rounds)
    assert got == want


def test_membership_churn_keeps_its_record():
    """`membership_churn`, now through the campaign engine's detect
    cell, keeps its keys: the 64-node shape detects at 18 with no false
    DOWNs."""
    rec = runner.membership_churn(64, 0, device="cpu")
    assert set(rec) == {"n_nodes", "detect_round", "false_downs",
                        "wall_clock_s"}
    assert (rec["detect_round"], rec["false_downs"]) == (18, 0)


# -- the card's goldens --------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name, n, partial, max_rounds", (
    ("SWIM_CHURN_PARTIAL_4096_SEED0", 4096, True, 600),
    ("SWIM_CHURN_PARTIAL_100K_SEED0", 100_000, True, 600)))
def test_detect_goldens_match_live_jax(name, n, partial, max_rounds):
    """The card's partial-view detect goldens against live JAX (~10 s at
    4096, ~2 min at 100 000 on 8 cores); at 4096 also the port's CPU run
    and the telemetry golden."""
    golden = getattr(goldens, name)
    want = _jax_detect(n, partial, 0, max_rounds, n == 4096)
    dr = int(want["out"][2])
    live = {
        "detect_round": dr,
        "detect_sim_s": dr * runner.ROUND_SECONDS if dr >= 0 else -1,
        "detected_fraction": want["stats"]["detected_fraction"],
        "member_slots": 64,
        "converged": dr >= 0,
        "digest": jax_digest(want["out"][0]),
    }
    assert live == golden
    if n == 4096:
        tel = goldens.SWIM_CHURN_PARTIAL_4096_SEED0_TELEMETRY
        assert want["summary"] == tel["summary"]
        assert ptel.trace_digest(want["host"], dr) == tel["trace_digest"]
        rec = runner.config_swim_churn_partial(seed=0, device="cpu",
                                               return_state=True)
        assert state_digest(rec["state"]) == golden["digest"]
