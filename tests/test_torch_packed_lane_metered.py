"""Metered budgets on the packed round's lanes (B16m's budgets: K16 on the
lanes' rows under the broadcast governor, K3m's lane entry for the sync
grant, K10's flat topology stream on the lanes) against JAX's vmapped
``campaign/ensemble.py run_seed_ensemble`` on the CPU: the gapstress
cell (config #5b: 8192 payloads in a burst, the mixed 1 B - 8 KiB sizes,
30 % flat loss, both budgets binding) at 1280 nodes, packed by default
(1280 × 8192 = 10 485 760 cells), three lanes (seeds 1-3), with and
without the flight recorder.  The port's plain versions take seconds a
lane-round here on one CPU thread, so tier 1 holds the first four rounds
of every lane: at seed 1 the 4 MiB sync grant first binds in round 3 and
the 5 MiB governor in round 4 (the rounds where the cell's byte channels
first differ from the same cell with that budget off).  Both port runs
are held to one JAX run with the recorder: JAX's recorder leaves the
state and metrics as they are without it, so its finals are the
reference for the port's run without the recorder too.  ``-m slow``
runs the cell to convergence (rounds 37-38, about four and a half
minutes)."""

import functools

import numpy as np
import pytest

from corrosion_tpu.campaign.ensemble import run_seed_ensemble as jrun
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim.state import uniform_payloads as jpayloads
from corrosion_tpu.sim.topology import Topology as JaxTopology
from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
from corrosion_tpu_torch.sim import runner
from corrosion_tpu_torch.sim.state import packed_supported, uniform_payloads
from corrosion_tpu_torch.sim.telemetry import CHANNELS
from corrosion_tpu_torch.sim.topology import Topology
from tests.torch_parity import assert_lanes_equal_jax, jax_telemetry

N, SEEDS, LOSS = 1280, (1, 2, 3), 0.3
#: f32 terms a round of each byte channel sums in JAX: one a broadcast
#: edge, one a payload of the sync grants
M_BCAST, M_SYNC = 3 * N, 8192
F32_ULP = 2.0 ** -24


def _cells():
    jcfg = jrunner._gapstress_cfg(N, 8)
    jmeta = jpayloads(jcfg, inject_every=0,
                      payload_bytes=jrunner.gapstress_payload_sizes(
                          jcfg.n_payloads))
    cfg = runner._gapstress_cfg(N, 8)
    meta = uniform_payloads(cfg, "cpu", inject_every=0,
                            payload_bytes=runner.gapstress_payload_sizes(
                                cfg.n_payloads))
    return jcfg, jmeta, cfg, meta


@functools.lru_cache(maxsize=None)
def _jax_lanes(max_rounds, telemetry):
    """JAX's vmapped three-lane gapstress ensemble to ``max_rounds``:
    (finals, metrics, the trace's channels or None)."""
    jcfg, jmeta, _, _ = _cells()
    with jax_telemetry():
        jout = jrun(None, jcfg, JaxTopology(loss=LOSS), jmeta, SEEDS,
                    max_rounds=max_rounds, telemetry=telemetry)
        jtrace = (None if not telemetry else
                  {name: np.asarray(getattr(jout[2], name))
                   for name in CHANNELS})
    return jout[0], jout[1], jtrace


def _hold(max_rounds, telemetry, jax_telemetry_run=None):
    """Both packages' three-lane gapstress ensembles to ``max_rounds``:
    every lane's state and stamps field for field; with ``telemetry``
    every trace channel exactly but the f32 byte channels, which are
    within (m + 1)·2⁻²⁴ of the port's exact total a round (PERF.md §2:
    JAX sums m f32 terms, the port rounds the exact sum once).  JAX runs
    with the recorder when ``jax_telemetry_run`` says so (default: as
    the port)."""
    _, _, cfg, meta = _cells()
    assert packed_supported(cfg, Topology(loss=LOSS))
    assert cfg.rate_limit_bytes_round is not None
    assert cfg.sync_budget_bytes is not None
    jfinals, jmetrics, jtrace = _jax_lanes(
        max_rounds, telemetry if jax_telemetry_run is None
        else jax_telemetry_run)
    out = run_seed_ensemble(None, cfg, Topology(loss=LOSS), meta, SEEDS,
                            max_rounds=max_rounds, telemetry=telemetry,
                            device="cpu")
    assert_lanes_equal_jax(jfinals, jmetrics, out[0], out[1], "gapstress")
    if not telemetry:
        return out
    trace = out[2]
    for name in CHANNELS:
        got = getattr(trace, name).numpy()
        if name in ("bcast_bytes", "sync_bytes"):
            m = M_BCAST if name == "bcast_bytes" else M_SYNC
            exact = np.abs(got.astype(np.float64)) * (1 + F32_ULP)
            gap = np.abs(jtrace[name].astype(np.float64) - got)
            assert bool((gap <= (m + 1) * F32_ULP * exact).all()), name
        else:
            np.testing.assert_array_equal(jtrace[name], got, err_msg=name)
    # the recorder saw the cell: the topology loss dropped frames and
    # grants flowed
    assert int(trace.bcast_dropped.sum()) > 0
    assert float(trace.sync_bytes.sum()) > 0
    return out


@pytest.mark.parametrize("telemetry", (False, True))
def test_gapstress_lanes_first_rounds_equal_live_jax(telemetry):
    """The first four rounds of every gapstress lane (the sync grant
    binding from round 3 on, the governor from round 4) equal JAX's
    vmapped lanes (its run with the recorder), field for field, with and
    without the port's recorder."""
    _hold(4, telemetry, jax_telemetry_run=True)


@pytest.mark.slow
def test_gapstress_lanes_to_convergence_equal_live_jax():
    """The gapstress cell's three lanes to convergence (rounds 37-38, the
    lanes leaving the batch in different rounds) equal JAX's vmapped
    lanes, field for field."""
    out = _hold(3000, False)
    assert len(set(out[0].t.tolist())) > 1
