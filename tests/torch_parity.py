"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
inputs made from a seed with numpy, handed to the JAX reference and to
the port (device="cpu", plain torch versions), and compared exactly."""

import contextlib
import dataclasses
import hashlib
import importlib
import sys

import numpy as np
import torch

from corrosion_tpu import faults as jax_faults
from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu.sim.runner import storm_fault_plan as jax_storm_fault_plan
from corrosion_tpu_torch import faults as port_faults
from corrosion_tpu_torch.convert import state_from_numpy, state_to_numpy
from corrosion_tpu_torch.sim.runner import _write_storm as port_write_storm
from corrosion_tpu_torch.sim.runner import storm_fault_plan

# the suite runs under xdist beside wall-clock-sensitive tests (the host
# ground-truth calibration skips when its event loop starves): one
# intra-op thread keeps the port's CPU tensors from taking every core
torch.set_num_threads(1)


def fields(named_tuple) -> dict:
    """A JAX or port NamedTuple as {field: numpy array}."""
    out = {}
    for name, value in zip(type(named_tuple)._fields, named_tuple):
        if isinstance(value, torch.Tensor):
            value = value.cpu()
        out[name] = np.asarray(value)
    return out


def assert_fields_equal(want: dict, got: dict, label: str) -> None:
    assert want.keys() == got.keys(), label
    for name in want:
        np.testing.assert_array_equal(
            want[name], got[name], err_msg=f"{label}: field {name}"
        )
        assert want[name].dtype == got[name].dtype, f"{label}: {name} dtype"


def storm_configs(n_nodes: int, n_payloads: int):
    """(jax cfg, jax meta, port cfg, port meta) of the write storm with
    the packed envelope forced open at test scale."""
    jcfg, jmeta = jax_write_storm(n_nodes, n_payloads)
    pcfg, pmeta = port_write_storm(n_nodes, n_payloads, "cpu")
    return (
        dataclasses.replace(jcfg, packed_min_cells=0), jmeta,
        dataclasses.replace(pcfg, packed_min_cells=0), pmeta,
    )


def latency_storm_plans(n_nodes: int, seed: int = 0):
    """(jax FaultPlan, port FaultPlan) of the latency storm:
    `storm_fault_plan`'s events, then JAX's "storm-mix" latency pair
    (tests/sim/test_packed_equivalence.py) over the first sixth of the
    nodes — a delay of one round and a jitter of up to one round on every
    link out of them, rounds 2-15."""
    out = []
    for mod, storm in ((jax_faults, jax_storm_fault_plan),
                       (port_faults, storm_fault_plan)):
        base = storm(n_nodes, seed)
        sel = f"0:{n_nodes // 6}"
        out.append(mod.FaultPlan(n_nodes=n_nodes, seed=base.seed, events=(
            *base.events,
            mod.FaultEvent("delay", 2, 16, src=sel, dst="*", delay_rounds=1),
            mod.FaultEvent("jitter", 2, 16, src=sel, dst="*",
                           delay_rounds=1),
        )))
    return tuple(out)


def to_port(jax_state, cfg):
    return state_from_numpy(fields(jax_state), cfg, "cpu")


def port_fields(state) -> dict:
    return state_to_numpy(state)


def random_tables(rng, n, m, t):
    """Member tables as a long run leaves them: residue-mapped ids with
    -1 empties, keys across ALIVE/SUSPECT/DOWN with incarnations up to
    the clamp (packed words then carry bit 31), psince stamps up to t."""
    ids = np.arange(m)[None, :] + m * rng.integers(0, (n + m - 1) // m, (n, m))
    pid = np.where((ids < n) & (rng.random((n, m)) > 0.15), ids, -1)
    inc = np.where(
        rng.random((n, m)) < 0.2,
        rng.integers(1024, 2047, (n, m)),
        rng.integers(0, 4, (n, m)),
    )
    pkey = np.where(pid >= 0, inc * 4 + rng.integers(0, 3, (n, m)), -1)
    psince = np.where(
        rng.random((n, m)) < 0.5, rng.integers(0, t + 1, (n, m)), -1
    )
    return (pid.astype(np.int32), pkey.astype(np.int32),
            psince.astype(np.int32))


def jax_digest(state, skip=("pview",)) -> str:
    """tests/sim/test_topo.py's _digest of a JAX state (blake2b over its
    fields), live — the port's `convert.state_digest` must equal it."""
    h = hashlib.blake2b(digest_size=8)
    for f, v in zip(type(state)._fields, state):
        if f in skip:
            continue
        h.update(f.encode())
        h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()


def assert_states_equal(jax_state, port_state, label: str) -> None:
    assert_fields_equal(fields(jax_state), port_fields(port_state), label)


def assert_metrics_equal(jax_metrics, port_metrics, label: str) -> None:
    """RunMetrics field for field, exactly: overflow_frac is one f32 mean
    (an exact integer sum over an f32 cell count) on both sides."""
    assert_fields_equal(fields(jax_metrics), fields(port_metrics), label)


_JAX_TELEMETRY = "corrosion_tpu.sim.telemetry"


@contextlib.contextmanager
def jax_telemetry():
    """The JAX flight recorder, importable for the length of a ``with``.

    ``corrosion_tpu/sim/telemetry.py:77`` tests ``_ob_p not in
    batching.primitive_batchers``; under jax 0.9.0 that object is a
    ``PrimitiveBatchersProxy`` without ``__contains__``, so the import
    raises TypeError.  Inside the block the proxy answers ``in`` from
    the batcher table it writes to (jax already registers the
    optimization barrier there, so the module registers nothing) and
    the module is yielded.  On exit the patch is removed, the module is
    dropped from ``sys.modules`` and from its package, and jax's
    in-memory compile caches are cleared, so nothing traced under the
    shim serves a later caller: every other test in the same worker
    sees the JAX package exactly as it would without this block."""
    import jax
    from jax._src.interpreters import batching

    proxy = batching.PrimitiveBatchersProxy
    had = "__contains__" in proxy.__dict__
    old = proxy.__dict__.get("__contains__")
    proxy.__contains__ = lambda self, prim: (
        prim in batching.fancy_primitive_batchers)
    try:
        yield importlib.import_module(_JAX_TELEMETRY)
    finally:
        if had:
            proxy.__contains__ = old
        else:
            del proxy.__contains__
        sys.modules.pop(_JAX_TELEMETRY, None)
        package = sys.modules.get("corrosion_tpu.sim")
        if package is not None and hasattr(package, "telemetry"):
            delattr(package, "telemetry")
        jax.clear_caches()


def port_config(jcfg):
    """The port's SimConfig with every field of JAX's ``jcfg``."""
    from corrosion_tpu_torch.sim.state import SimConfig

    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(SimConfig)})


def plan_pair(n_nodes: int, seed: int, events):
    """(jax FaultPlan, port FaultPlan) of ``events(FaultEvent)``, the same
    events built with each package's own event class."""
    return tuple(
        mod.FaultPlan(n_nodes=n_nodes, seed=seed,
                      events=tuple(events(mod.FaultEvent)))
        for mod in (jax_faults, port_faults))


#: tests/sim/test_packed_equivalence.py's ``_FAULT_PLANS`` (48 nodes), as
#: functions of the event class
FAULT_PLANS_48 = {
    "loss": lambda ev: (ev("loss", 0, 20, p=0.35),),
    "asym-partition": lambda ev: (
        ev("partition", 2, 16, src="0:24", dst="24:48"),),
    "crash-wipe": lambda ev: (ev("crash", 6, 18, node=2, wipe=True),),
    "latency": lambda ev: (
        ev("delay", 2, 16, src="0:8", dst="*", delay_rounds=1),
        ev("jitter", 2, 16, src="0:8", dst="*", delay_rounds=1),
    ),
    "storm-mix": lambda ev: (
        ev("loss", 0, 20, p=0.3),
        ev("partition", 4, 14, src="0:24", dst="24:48", symmetric=True),
        ev("delay", 2, 16, src="0:8", dst="*", delay_rounds=1),
        ev("jitter", 2, 16, src="0:8", dst="*", delay_rounds=1),
        ev("crash", 10, 22, node=2, wipe=True),
    ),
}


def demo_events(ev, n_nodes: int = 3, rounds: int = 36):
    """``corrosion_tpu/faults.py`` ``demo_plan``'s events (the fault
    campaign's): a loss burst, an asymmetric cut, delay and jitter on one
    link, a crash-with-wipe of the last node."""
    third = rounds // 3
    return (
        ev("loss", 0, rounds, p=0.4),
        ev("partition", third // 2, third, src=n_nodes - 1, dst=0),
        ev("delay", 2, 2 * third, src=0, dst=1, delay_rounds=1),
        ev("jitter", 2, 2 * third, src=0, dst=1, delay_rounds=1),
        ev("crash", 2 * third, rounds - 2, node=n_nodes - 1, wipe=True),
    )


#: the topology-axis runs' scale (tests/test_torch_topology_tiers.py and
#: tests/test_torch_peerswap.py): `_write_storm` at a few hundred nodes
N_RUN, P_RUN, SEED = 300, 128, 3


def topology_storm(family, sampler, packed):
    """(jax cfg, meta, topo, port cfg, meta, topo) of `_write_storm` at
    N_RUN nodes over topology ``family`` under ``sampler``, on the packed
    round (the envelope forced open) or the dense one."""
    from corrosion_tpu.sim.runner import _resolve_topo as jax_resolve_topo
    from corrosion_tpu_torch.sim.runner import _resolve_topo

    jt, pt = jax_resolve_topo(family), _resolve_topo(family)
    jcfg, jmeta = jax_write_storm(N_RUN, P_RUN, topo=jt, sampler=sampler)
    pcfg, pmeta = port_write_storm(N_RUN, P_RUN, "cpu", pt, sampler)
    ch = dict(packed_min_cells=0) if packed else dict(allow_packed=False)
    return (dataclasses.replace(jcfg, **ch), jmeta, jt,
            dataclasses.replace(pcfg, **ch), pmeta, pt)


def run_topology_pair(family, sampler, packed):
    """Both packages' runs of `topology_storm` to convergence, final
    state (the view included) and RunMetrics equal field for field."""
    from corrosion_tpu.sim import round as jround
    from corrosion_tpu_torch.sim import round as pround

    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm(family, sampler, packed)
    jout = jround.run_to_convergence(jround.new_sim(jcfg, SEED), jmeta, jcfg,
                                     jt, 400)
    pout = pround.run_to_convergence(pround.new_sim(pcfg, SEED, "cpu"),
                                     pmeta, pcfg, pt, 400)
    label = f"{family}/{sampler or 'uniform'}/{'packed' if packed else 'dense'}"
    assert_states_equal(jout[0], pout[0], label)
    assert_metrics_equal(jout[1], pout[1], label)
    return jout, pout


def fault_plan_pair(family, sampler, packed, events, trace=False, deepen=0):
    """JAX's run of `topology_storm` under ``events`` (its factored
    compile) against the port's on its factored plan and on its matrix
    one: state (the view included), metrics and, with ``trace``, every
    RoundTrace channel equal (exact: every payload is 8 KiB, so JAX's f32
    byte sums are exact too).  ``deepen`` adds ring slots past the
    topology's deepest delay."""
    from corrosion_tpu.sim import faults as jf
    from corrosion_tpu.sim import round as jround
    from corrosion_tpu_torch.sim import faults as pf_
    from corrosion_tpu_torch.sim import round as pround
    from corrosion_tpu_torch.sim.telemetry import CHANNELS

    jcfg, jmeta, jt, pcfg, pmeta, pt = topology_storm(family, sampler,
                                                      packed)
    if deepen:
        jcfg = dataclasses.replace(jcfg, n_delay_slots=jt.max_delay + deepen)
        pcfg = dataclasses.replace(pcfg, n_delay_slots=pt.max_delay + deepen)
    jplan, pplan = plan_pair(N_RUN, 9, events)
    with jax_telemetry():
        jout = jf.run_fault_plan(
            jround.new_sim(jcfg, SEED), jmeta, jcfg, jt,
            jf.compile_plan(jplan, jcfg, jt, factored=True), 400,
            telemetry=trace)
    label = f"{family}/{sampler}/{'packed' if packed else 'dense'}"
    for factored in (True, False):
        pf = pf_.compile_plan(pplan, pcfg, pt, factored=factored,
                              device="cpu")
        pout = pf_.run_fault_plan(pround.new_sim(pcfg, SEED, "cpu"), pmeta,
                                  pcfg, pt, pf, 400, trace)
        at = f"{label}/{'factored' if factored else 'matrix'}"
        assert_states_equal(jout[0], pout[0], at)
        assert_metrics_equal(jout[1], pout[1], at)
        if trace:
            for name in CHANNELS:
                np.testing.assert_array_equal(
                    np.asarray(getattr(jout[2], name)),
                    getattr(pout[2], name).numpy(), err_msg=f"{at}: {name}")
    return jout, pout


# -- the campaign engine and the seed ensembles -------------------------------

#: JAX's tests/campaign/test_ensemble.py LANE_FIELDS: the per-lane state
#: fields its ensemble test holds to the solo runs
LANE_FIELDS = (
    "t", "have", "alive", "heads", "relay_left", "incarnation",
    "sync_backoff", "gap_lo", "gap_hi",
)


def storm_campaign_pair(n_nodes: int, n_payloads: int, seeds, faults: bool,
                        grid=None, name="storm-lanes"):
    """(JAX CampaignSpec, port CampaignSpec) of the storm cell at test
    scale from one dict: `campaign.spec.storm_scenario` with
    ``n_payloads`` and the packed envelope forced open, the fault storm's
    events when ``faults``."""
    from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
    from corrosion_tpu.faults import FaultEvent as JaxEvent
    from corrosion_tpu_torch.campaign.spec import (
        CampaignSpec, storm_fault_events, storm_scenario)

    scenario = dict(storm_scenario(n_nodes), n_payloads=n_payloads,
                    packed_min_cells=0)
    events = storm_fault_events(n_nodes) if faults else ()
    kw = dict(name=name, scenario=scenario, grid=dict(grid or {}),
              seeds=tuple(seeds), max_rounds=3000)
    jax_events = tuple(JaxEvent(**dataclasses.asdict(ev)) for ev in events)
    return (JaxSpec(events=jax_events, **kw),
            CampaignSpec(events=events, **kw))


def run_both_ensembles(jspec, pspec):
    """Each package's `run_seed_ensemble` on its spec's one cell: (JAX
    finals, JAX metrics, port finals, port metrics, port cfg, port meta,
    port plan)."""
    from corrosion_tpu.campaign.ensemble import run_seed_ensemble as jrun
    from corrosion_tpu.sim.state import uniform_payloads as jpayloads
    from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble
    from corrosion_tpu_torch.sim.state import uniform_payloads

    jcfg, jtopo = jspec.sim_config({}), jspec.topo({})
    every = jspec.inject_every({})
    jf, jm = jrun(jspec.fault_plan({}, seed=jspec.seeds[0]), jcfg, jtopo,
                  jpayloads(jcfg, inject_every=every), jspec.seeds,
                  max_rounds=jspec.max_rounds)
    cfg, topo = pspec.sim_config({}), pspec.topo({})
    meta = uniform_payloads(cfg, "cpu", inject_every=every)
    plan = pspec.fault_plan({}, seed=pspec.seeds[0])
    pf, pm = run_seed_ensemble(plan, cfg, topo, meta, pspec.seeds,
                               max_rounds=pspec.max_rounds, device="cpu")
    return jf, jm, pf, pm, cfg, meta, plan


def spec_pair(name, scenario, seeds, max_rounds=3000):
    """(JAX CampaignSpec, port CampaignSpec) of one scenario dict."""
    from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
    from corrosion_tpu_torch.campaign.spec import CampaignSpec

    kw = dict(name=name, scenario=dict(scenario), seeds=tuple(seeds),
              max_rounds=max_rounds)
    return JaxSpec(**kw), CampaignSpec(**kw)


def assert_lanes_equal_jax(jf, jm, pf, pm, label):
    """Every state field and both stamps of every lane, exactly, in
    JAX's dtypes."""
    from corrosion_tpu_torch.convert import state_to_numpy

    pn = state_to_numpy(pf)
    for name in type(jf)._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jf, name)),
                                      pn[name], err_msg=f"{label}: {name}")
        assert np.asarray(getattr(jf, name)).dtype == pn[name].dtype, name
    for name in ("converged_at", "coverage_at", "overflow_frac"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jm, name)), getattr(pm, name).numpy(),
            err_msg=f"{label}: metrics {name}")


def port_solo_runs(cfg, meta, plan, seeds):
    """The port's solo runs of ``seeds`` on the CPU: `run_packed`, or
    `run_fault_plan` under ``plan`` re-seeded per seed (its factored
    compile)."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.topology import Topology

    out = []
    for s in seeds:
        state = new_sim(cfg, int(s), "cpu")
        if plan is None:
            out.append(run_to_convergence(state, meta, cfg, Topology(),
                                          3000))
        else:
            fp = compile_plan(dataclasses.replace(plan, seed=int(s)), cfg,
                              device="cpu")
            out.append(run_fault_plan(state, meta, cfg, Topology(), fp,
                                      3000))
    return out


def dense_storm_spec_at(seeds, n_nodes: int, latency: bool = True):
    """``dense_storm_seeds_spec`` cut to ``n_nodes``: the storm's
    scenario and events rebuilt at that width."""
    from corrosion_tpu_torch.campaign import spec as sp

    events = sp.storm_fault_events(n_nodes)
    if latency:
        events += sp.storm_latency_events(n_nodes)
    spec = sp.dense_storm_seeds_spec(seeds, latency=latency)
    return dataclasses.replace(
        spec, scenario=dict(spec.scenario, n_nodes=n_nodes), events=events)


def latency_storm_spec_at(seeds, n_nodes: int = 1280, n_payloads: int = 64,
                          **scenario):
    """``latency_storm_seeds_spec`` cut to ``n_nodes`` × ``n_payloads``
    inside the packed envelope (``packed_min_cells`` 0): the storm's
    scenario and events rebuilt at that width, named
    ``latency-storm-lanes`` (with ``scenario``'s keys on top)."""
    from corrosion_tpu_torch.campaign import spec as sp

    spec = sp.latency_storm_seeds_spec(seeds)
    return dataclasses.replace(
        spec, name="latency-storm-lanes",
        scenario=dict(spec.scenario, n_nodes=n_nodes, n_payloads=n_payloads,
                      packed_min_cells=0, **scenario),
        events=sp.storm_fault_events(n_nodes)
        + sp.storm_latency_events(n_nodes))


def peerswap_fault_spec_at(seeds, n_nodes: int):
    """``broadcast_peerswap_fault_seeds_spec`` cut to ``n_nodes``: the
    cell's scenario and the fault storm's events rebuilt at that width,
    the name kept."""
    from corrosion_tpu_torch.campaign import spec as sp

    spec = sp.broadcast_peerswap_fault_seeds_spec(seeds)
    return dataclasses.replace(
        spec, scenario=dict(spec.scenario, n_nodes=n_nodes),
        events=sp.storm_fault_events(n_nodes))


def stack_lane_states(jax_lanes, pcfg):
    """K JAX states → (JAX's stacked pytree [K, ...], the port's stacked
    state, every field [K, ...] but ``t``, one host scalar)."""
    import jax
    import jax.numpy as jnp

    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *jax_lanes)
    ports = [to_port(x, pcfg) for x in jax_lanes]
    pstates = ports[0]._replace(**{
        name: torch.stack([getattr(x, name) for x in ports])
        for name in ports[0]._fields if name != "t"})
    return jstates, pstates


def lane_of(states, k):
    """Lane k of stacked port states whose ``t`` is one host scalar."""
    return states._replace(**{name: getattr(states, name)[k]
                              for name in states._fields if name != "t"})


def lane_keys(lanes: int, base: int):
    """``PRNGKey(base + k)`` for k < ``lanes``: (JAX's [K, 2], the port's
    int64 [K, 2])."""
    import jax
    import jax.numpy as jnp

    ks = np.stack([np.asarray(jax.random.PRNGKey(base + k))
                   for k in range(lanes)])
    return jnp.asarray(ks), torch.as_tensor(ks.astype(np.int64))



def jax_campaign_kept(spec, telemetry=False):
    """Live JAX's run_campaign of a port spec and its lanes' outputs (JAX's
    run_seed_ensemble's, kept from inside the call)."""
    from unittest import mock

    from corrosion_tpu.campaign import ensemble as jens
    from corrosion_tpu.campaign.engine import run_campaign as jrun
    from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec

    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["out"] = out
        return out

    with mock.patch.object(jens, "run_seed_ensemble", keeping), (
            jax_telemetry() if telemetry else contextlib.nullcontext()):
        art = jrun(JaxSpec.from_dict(spec.to_dict()), out_path=None,
                   telemetry=telemetry)
    return art, kept["out"]


def proto_storm_spec_at(family, seeds=(0, 1), n=1280, **extra):
    """The write storm at ``n`` nodes inside the packed envelope
    (``packed_min_cells`` 0) under a protocol family, ``extra`` scenario
    keys on top: 64 payloads, or 128 for the ordering families (two
    versions a writer)."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.proto.families import FAMILIES

    p = 128 if FAMILIES[family].get("ordering") else 64
    scenario = dict(sp.storm_scenario(n), n_payloads=p, packed_min_cells=0,
                    proto_family=family, **extra)
    return sp.CampaignSpec(name=f"packed-{family}-lanes", scenario=scenario,
                           events=(), seeds=tuple(seeds), max_rounds=400)
