"""The port's protocol axis (corrosion_tpu_torch/proto, the protocol knobs
of SimConfig and the runner's ``proto_family``) against the live JAX
reference, function by function, exact.

The registry and the configuration's refusals; the fan-out schedule
(with the degree caps before it, K20's schedule instantiation), the
cadence; the FIFO admit masks of both rounds (K8f's and K12f-o's plain
versions) and the delivery-order count (K22's) on JAX's two hand-built
cases and random grids, multi-chunk versions and origin rows included;
the pull leg's session mask, its loss bits, and the response scatters
of both rounds (K10p's and K12p's plain versions) with the pull's
dropped frames and K18's pull fold, under flat and tiered (wan-3x2)
loss and under factored and matrix fault plans with a one-way cut and a
loss class; the runner's configs under every family, and the checked
fault driver's FIFO branch.  Whole runs live in
tests/test_torch_proto_runs.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrosion_tpu.sim.packed  # noqa: F401  (module constants first)
from corrosion_tpu import proto as jproto
from corrosion_tpu.proto import dissemination as jdiss
from corrosion_tpu.proto import ordering as jord
from corrosion_tpu.proto import schedule as jsched
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import invariants as jinv
from corrosion_tpu.sim import runner as jrunner
from corrosion_tpu.sim import state as jstate
from corrosion_tpu.sim import topology as jtopo
from corrosion_tpu.topo import family_topology as jax_family_topology
from corrosion_tpu_torch import proto as pproto
from corrosion_tpu_torch.proto import dissemination as pdiss
from corrosion_tpu_torch.proto import ordering as pord
from corrosion_tpu_torch.proto import schedule as psched
from corrosion_tpu_torch.sim import broadcast, packed, rng, runner
from corrosion_tpu_torch.sim import faults as pfaults
from corrosion_tpu_torch.sim import invariants as pinv
from corrosion_tpu_torch.sim import state as pstate
from corrosion_tpu_torch.sim import telemetry
from corrosion_tpu_torch.sim import topology as ptopo
from corrosion_tpu_torch.sim.words import pack_bits, unpack_bits
from corrosion_tpu_torch.topo import family_topology
from tests.torch_parity import (
    assert_fields_equal,
    fields,
    plan_pair,
    port_config,
)


# -- the registry and the configuration --------------------------------------


def test_registry_matches_jax():
    assert pproto.PROTO_KEYS == jproto.PROTO_KEYS
    assert pproto.DEFAULTS == jproto.DEFAULTS
    assert pproto.FAMILIES == jproto.FAMILIES
    for name in jproto.FAMILIES:
        assert pproto.family_proto(name) == jproto.family_proto(name)
    # the defaults table mirrors the port's SimConfig fields
    fields_ = {f.name: f.default for f in dataclasses.fields(pstate.SimConfig)}
    assert {k: fields_[k] for k in pproto.PROTO_KEYS} == pproto.DEFAULTS
    with pytest.raises(KeyError, match="unknown protocol family"):
        pproto.family_proto("no-such-family")


@pytest.mark.parametrize("kw", (
    dict(dissemination="pull"),
    dict(fanout_schedule="ramp"),
    dict(fanout_schedule="decay", fanout_decay_rounds=0),
    dict(sync_cadence="lazy"),
    dict(ordering="total"),
    dict(n_payloads=1, ordering="fifo"),
    dict(n_payloads=2, n_writers=2, ordering="fifo-unchecked"),
))
def test_protocol_refusals_match_jax(kw):
    base = dict(n_nodes=8, n_payloads=8)
    base.update(kw)
    with pytest.raises(ValueError) as want:
        jstate.SimConfig(**base)
    with pytest.raises(ValueError) as got:
        pstate.SimConfig(**base)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", sorted(jproto.FAMILIES))
def test_runner_configs_take_every_family(family):
    """Both entry points' configs under each family equal JAX's field for
    field (the storm's `_write_storm` and broadcast-1k's overlay), and
    ``baseline`` is the unset config."""
    jcfg, jmeta = jrunner._write_storm(300, 128, proto_family=family)
    pcfg, pmeta = runner._write_storm(300, 128, "cpu", proto_family=family)
    assert pcfg == port_config(jcfg)
    assert_fields_equal(fields(jmeta), fields(pmeta), family)
    assert runner._resolve_proto(family) == jrunner._resolve_proto(family)
    if family == "baseline":
        assert pcfg == runner._write_storm(300, 128, "cpu")[0]


# -- the fan-out schedule and the cadence ------------------------------------


@pytest.mark.parametrize("fanout, every", ((3, 8), (4, 4), (5, 1)))
def test_active_fanout_matches_jax(fanout, every):
    kw = dict(n_nodes=8, n_payloads=8, fanout=fanout,
              fanout_schedule="decay", fanout_decay_rounds=every)
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    for t in (0, 1, every - 1, every, 2 * every, 3 * every + 1, 100, 10**6):
        assert psched.active_fanout(pcfg, t) == int(
            jsched.active_fanout(jcfg, jnp.int32(t))), t


@pytest.mark.parametrize("family", ("flat", "hetero-degree"))
def test_capped_schedule_matches_jax(family):
    """K20's schedule instantiation, plain: the degree caps (3/2/1 under
    hetero-degree), then the schedule, across the decay steps at t = 7,
    8, 16 (R = 8) — a step crossing R composed with the caps."""
    g = np.random.default_rng(2)
    n, f = 90, 3
    tg = np.where(g.random((n, f)) < 0.1, -1, g.integers(0, n, (n, f)))
    targets = tg.astype(np.int32)
    kw = dict(n_nodes=n, n_payloads=8, fanout=f, fanout_schedule="decay")
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jt = jtopo.Topology(**jax_family_topology(family))
    pt = ptopo.Topology(**family_topology(family))
    for t in (0, 7, 8, 15, 16, 40):
        want = jsched.scheduled_fanout_targets(
            jtopo.apply_degree_caps(jnp.asarray(targets), jt), jcfg,
            jnp.int32(t))
        got = psched.capped_schedule(torch.as_tensor(targets), pt, pcfg, t)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=f"t={t}")
    flat = dataclasses.replace(pcfg, fanout_schedule="flat")
    np.testing.assert_array_equal(
        psched.capped_schedule(torch.as_tensor(targets), pt, flat, 40).numpy(),
        np.asarray(jtopo.apply_degree_caps(jnp.asarray(targets), jt)))


@pytest.mark.parametrize("cadence", ("periodic", "eager"))
def test_cadence_due_matches_jax(cadence):
    kw = dict(n_nodes=8, n_payloads=8, sync_cadence=cadence)
    due = np.array([True, False, False, True, False, True, False, False])
    want = jsched.cadence_due(jnp.asarray(due), jstate.SimConfig(**kw))
    got = psched.cadence_due(torch.as_tensor(due), pstate.SimConfig(**kw))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# -- FIFO ordering: the admit masks and the delivery-order count -------------


def _holdings(g, n, cfg, full=0.6, some=0.15):
    """u8 have [N, P]: whole versions held with probability ``full``,
    single chunks with ``some`` — predecessors held but for one chunk,
    gaps below heads, and empty rows."""
    a, v, c = cfg.n_writers, cfg.n_versions, cfg.chunks_per_version
    whole = g.random((n, v, a, 1)) < full
    part = g.random((n, v, a, c)) < some
    have = (whole | part).reshape(n, cfg.n_payloads)
    have[g.random(n) < 0.05] = False
    return have.astype(np.uint8)


@pytest.mark.parametrize("a, c, v", ((4, 1, 16), (2, 4, 8), (16, 4, 8),
                                     (3, 2, 8), (8, 1, 32)))
def test_admit_masks_match_jax(a, c, v):
    """K12f-o's dense mask and K8f's words against JAX's, on holdings with
    a predecessor held but for one chunk (a wave crossing a word where
    A * C is not a multiple of 32)."""
    g = np.random.default_rng(a * 100 + c * 10 + v)
    kw = dict(n_nodes=40, n_payloads=a * c * v, n_writers=a,
              chunks_per_version=c, ordering="fifo")
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    have = _holdings(g, 40, pcfg)
    want = jord.admit_payload_mask(jnp.asarray(have), jcfg)
    got = pord.admit_payload_mask(torch.as_tensor(have), pcfg)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if pcfg.n_payloads % 32 == 0:
        from corrosion_tpu.sim.packed import pack_bits as jax_pack

        jw = jord.admit_words(jax_pack(jnp.asarray(have)), jcfg)
        pw = pord.admit_words(pack_bits(torch.as_tensor(have)), pcfg)
        np.testing.assert_array_equal(
            np.asarray(jw).view(np.int32), pw.numpy())
        np.testing.assert_array_equal(unpack_bits(pw, pcfg.n_payloads),
                                      got)


@pytest.mark.parametrize("fifo", (False, True))
def test_fifo_deliver_plain_packed_equals_dense(fifo):
    """K8f's and K12f-o's plain versions deliver the same bits: both rings
    gated by the one admit mask from the pre-merge have, rejected arrivals
    dropped, relay re-armed only for admitted new broadcast arrivals."""
    g = np.random.default_rng(5)
    n, d = 30, 3
    cfg = pstate.SimConfig(n_nodes=n, n_payloads=64, n_writers=4,
                           chunks_per_version=2,
                           ordering="fifo" if fifo else "none")
    p = cfg.n_payloads
    have = _holdings(g, n, cfg)
    relay = (g.integers(0, 5, (n, p)) * have).astype(np.uint8)
    ring = (g.random((d, n, p)) < 0.3).astype(np.uint8)
    sync = (g.random((d, n, p)) < 0.2).astype(np.uint8)
    slot = 2
    dense = [torch.as_tensor(x.copy()) for x in (ring, sync, have, relay)]
    broadcast.deliver_dense(*dense, slot, 4, cfg if fifo else None)
    carry = packed.PackedCarry(
        have=pack_bits(torch.as_tensor(have)),
        inflight=pack_bits(torch.as_tensor(ring)),
        relay=packed.Planes(*(pack_bits(torch.as_tensor((relay >> k) & 1))
                              for k in range(4))),
        sync_buf=pack_bits(torch.as_tensor(sync)))
    cfg5 = dataclasses.replace(cfg, max_transmissions=5)
    packed.deliver_packed(carry, slot, cfg5)
    np.testing.assert_array_equal(unpack_bits(carry.have, p).numpy(),
                                  dense[2].numpy() > 0)
    relay_w = sum(unpack_bits(pl, p).to(torch.uint8) << k
                  for k, pl in enumerate(carry.relay))
    np.testing.assert_array_equal(relay_w.numpy(), dense[3].numpy())
    assert not dense[0][slot].any() and not carry.inflight[slot].any()
    # against the rule itself: arrivals where admitted (all without FIFO)
    admit = (pord.admit_payload_mask(torch.as_tensor(have), cfg).numpy()
             if fifo else np.ones((n, p), bool))
    arriving = ring[slot].astype(bool) & admit
    want = have.astype(bool) | arriving | (sync[slot].astype(bool) & admit)
    np.testing.assert_array_equal(dense[2].numpy() > 0, want)
    newly = arriving & ~have.astype(bool)
    np.testing.assert_array_equal(dense[3].numpy(),
                                  np.where(newly, 4, relay))
    # the inputs reach the gate: some arrival is refused for a predecessor
    # held but for one chunk
    if fifo:
        assert ((ring[slot] | sync[slot]).astype(bool) & ~admit).any()


def test_order_violation_count_hand_cases_match_jax():
    """JAX's test_order_violation_count_counts_the_gap: one violating
    triple, the origin row exempt, a multi-chunk version counted once."""
    out = []
    for mod, new_meta in ((jstate, None), (pstate, "cpu")):
        cfg = mod.SimConfig(n_nodes=4, n_payloads=4,
                            ordering="fifo-unchecked")
        meta = (mod.uniform_payloads(cfg, inject_every=1) if new_meta is None
                else mod.uniform_payloads(cfg, "cpu", inject_every=1))
        have = np.zeros((4, 4), np.uint8)
        origin = int(np.asarray(meta.actor)[1])
        have[(origin + 1) % 4, 1] = 1
        have[origin, 1] = 1
        cfg2 = mod.SimConfig(n_nodes=4, n_payloads=8, chunks_per_version=2,
                             ordering="fifo-unchecked")
        meta2 = (mod.uniform_payloads(cfg2, inject_every=1)
                 if new_meta is None
                 else mod.uniform_payloads(cfg2, "cpu", inject_every=1))
        have2 = np.zeros((4, 8), np.uint8)
        have2[(int(np.asarray(meta2.actor)[0]) + 1) % 4, 2] = 1
        row = []
        for c_, m_, h in ((cfg, meta, have), (cfg2, meta2, have2)):
            if mod is jstate:
                hj = jnp.asarray(h)
                row.append(int(jinv.order_violation_count(
                    jstate.touched_versions(hj, c_),
                    jstate.complete_versions(hj, c_), m_, c_)))
            else:
                acc = torch.zeros((), dtype=torch.int32)
                pinv.count_order_violations_(acc, torch.as_tensor(h), m_, c_)
                row.append(int(acc))
        out.append(row)
    assert out[0] == out[1] == [1, 1]


@pytest.mark.parametrize("a, c, v", ((16, 4, 8), (2, 1, 16), (3, 2, 8)))
def test_order_violation_count_matches_jax(a, c, v):
    """K22's plain version on random holdings, dense u8 and packed words
    alike, against JAX's grid count: origin rows hold gaps too, and the
    count is a standing count added to the accumulator."""
    g = np.random.default_rng(a + c + v)
    n = 64
    kw = dict(n_nodes=n, n_payloads=a * c * v, n_writers=a,
              chunks_per_version=c, ordering="fifo-unchecked")
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = pstate.uniform_payloads(pcfg, "cpu", inject_every=1)
    have = _holdings(g, n, pcfg, full=0.5, some=0.2)
    origins = np.unique(np.asarray(jmeta.actor))
    have[origins] = _holdings(g, len(origins), pcfg, full=0.3, some=0.3)
    hj = jnp.asarray(have)
    want = int(jinv.order_violation_count(
        jstate.touched_versions(hj, jcfg), jstate.complete_versions(hj, jcfg),
        jmeta, jcfg))
    assert want > 0
    acc = torch.full((), 7, dtype=torch.int32)
    pinv.count_order_violations_(acc, torch.as_tensor(have), pmeta, pcfg)
    assert int(acc) == want + 7
    if pcfg.n_payloads % 32 == 0:
        acc.zero_()
        pinv.count_order_violations_(acc, pack_bits(torch.as_tensor(have)),
                                     pmeta, pcfg)
        assert int(acc) == want


# -- push-pull: the session mask, the loss bits, the response scatters -------

N_PULL, F_PULL, P_PULL = 48, 3, 64


def _pull_plans():
    """A one-way cut (0:16 → 24:48) and a loss class over 8:40 → *, the
    plan both packages compile; JAX's matrix form, the port's matrix and
    factored ones."""
    return plan_pair(N_PULL, 7, lambda ev: (
        ev("loss", 0, 10, src="8:40", dst="*", p=0.4),
        ev("partition", 0, 10, src="0:16", dst="24:48"),
    ))


def _pull_case(g, topo_family, plan_form):
    cfg_kw = dict(n_nodes=N_PULL, n_payloads=P_PULL, n_writers=4,
                  fanout=F_PULL, n_delay_slots=4)
    jcfg, pcfg = jstate.SimConfig(**cfg_kw), pstate.SimConfig(**cfg_kw)
    kw = jax_family_topology(topo_family) if topo_family else {}
    jt, pt = jtopo.Topology(**kw), ptopo.Topology(**family_topology(
        topo_family) if topo_family else {})
    jrf = prf = None
    if plan_form:
        jplan, pplan = _pull_plans()
        jf = jfaults.compile_plan(jplan, jcfg, jt)
        pf = pfaults.compile_plan(pplan, pcfg, pt,
                                  factored=plan_form == "factored",
                                  device="cpu")
        jrf, prf = jfaults.round_faults(jf, jnp.int32(3)), \
            pfaults.round_faults(pf, 3)
    e = N_PULL * F_PULL
    src = np.repeat(np.arange(N_PULL), F_PULL).astype(np.int32)
    dst = g.integers(0, N_PULL, e).astype(np.int32)
    ok = (dst != src) & (g.random(e) < 0.9)
    return dict(jcfg=jcfg, pcfg=pcfg, jt=jt, pt=pt, jrf=jrf, prf=prf,
                src=src, dst=dst, ok=ok,
                slot=g.integers(0, 4, e).astype(np.int32),
                sending=g.random((N_PULL, P_PULL)) < 0.4)


CASES = [(None, None), ("flat-lossy", None), ("wan-3x2", None),
         (None, "matrix"), (None, "factored"), ("wan-3x2", "matrix")]


def _jax_pull(c, key=11):
    """JAX's pull leg on the case: ok_pull, the drop bits, the response."""
    jk = jax.random.PRNGKey(key)
    src, dst = jnp.asarray(c["src"]), jnp.asarray(c["dst"])
    ok = jnp.asarray(c["ok"])
    if c["jrf"] is not None:
        ok = ok & ~jfaults.fault_edge_block(c["jrf"], src, dst)
    ok_pull = jdiss.pull_session_ok(ok, c["jrf"], src, dst)
    drop = jdiss.pull_wire_drop(c["jt"], c["jrf"], jk, src, dst, P_PULL,
                                jtopo.regions(N_PULL, c["jt"].n_regions))
    return np.asarray(ok), np.asarray(ok_pull), np.asarray(drop)


@pytest.mark.parametrize("topo_family, plan_form", CASES)
def test_pull_session_and_drop_match_jax(topo_family, plan_form):
    """A pull refused only by the reverse cut; the reverse tiers on the
    pull key; the reverse fault loss on fold_in(fold_in(k_pull, seed),
    101)."""
    c = _pull_case(np.random.default_rng(1), topo_family, plan_form)
    ok, want_ok, want_drop = _jax_pull(c)
    src, dst = torch.as_tensor(c["src"]), torch.as_tensor(c["dst"])
    got_ok = pdiss.pull_session_ok(torch.as_tensor(ok.copy()), c["prf"],
                                   src, dst)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    got = pdiss.pull_wire_drop(c["pt"], c["prf"], rng.prng_key(11, "cpu"),
                               src, dst, P_PULL,
                               ptopo.regions(N_PULL, c["pt"].n_regions,
                                             "cpu"))
    # a cut cell keeps no loss threshold in the matrix form and keeps one
    # in the factored form: the bits differ only where the pull is refused
    live = want_ok[:, None] if plan_form == "factored" else True
    np.testing.assert_array_equal(got.numpy() & live, want_drop & live)
    if plan_form:
        # the trap: pulls the reverse cut alone refuses
        assert (ok & ~want_ok).any()
        assert want_drop.any()


@pytest.mark.parametrize("topo_family, plan_form", CASES)
def test_pull_scatters_match_jax(topo_family, plan_form):
    """K10p's and K12p's plain versions: the responder's sending rows ORed
    into the puller's ring row at the push's slot, less JAX's
    ``pull_wire_drop``, with the dropped frames and K18's pull fold."""
    g = np.random.default_rng(3)
    c = _pull_case(g, topo_family, plan_form)
    ok, ok_pull, drop = _jax_pull(c)
    n, p, d = N_PULL, P_PULL, 4
    ring0 = (g.random((d, n, p)) < 0.05).astype(np.uint8)
    resp = ok_pull[:, None] & ~drop & c["sending"][c["dst"]]
    want = ring0.copy()
    np.maximum.at(want.reshape(d * n, p), c["slot"] * n + c["src"],
                  resp.astype(np.uint8))
    want_dropped = int((ok_pull[:, None] & drop
                        & c["sending"][c["dst"]]).sum())

    src, dst = torch.as_tensor(c["src"]), torch.as_tensor(c["dst"])
    slot = torch.as_tensor(c["slot"])
    pok = pdiss.pull_session_ok(torch.as_tensor(ok.copy()), c["prf"], src,
                                dst)
    thr_rev = pdiss.reverse_loss(c["prf"], src, dst)
    tiers = ptopo.wire_tiers(c["pt"])
    topo_thr = (ptopo.loss_threshold(c["pt"].loss)
                if c["pt"].loss > 0 and tiers is None else 0)
    seed = 0 if c["prf"] is None else int(c["prf"].seed)
    k_drop = rng.prng_key(11, "cpu")

    ring_w = pack_bits(torch.as_tensor(ring0))
    dropped = torch.zeros((), dtype=torch.int64)
    sending_w = pack_bits(torch.as_tensor(c["sending"]))
    packed.scatter_pull(ring_w, sending_w, dst, slot, pok, thr_rev, k_drop,
                        seed, F_PULL, topo_thr, dropped, tiers)
    np.testing.assert_array_equal(unpack_bits(ring_w, p).numpy(),
                                  want.astype(bool))
    assert int(dropped) == want_dropped

    # the dense leg recomputes the responder's sending from have, relay
    # and injected (the sending rows here), unmetered and metered
    have = torch.as_tensor(c["sending"]).to(torch.uint8)
    relay = have.clone()
    injected = torch.ones(p, dtype=torch.uint8)
    nbytes = torch.full((p,), 8192, dtype=torch.int32)
    for budget in (None, 5 * 8192):
        ring_d = torch.as_tensor(ring0.copy())
        dropped_d = torch.zeros((), dtype=torch.int64)
        broadcast.pull_send(have, relay, injected, nbytes, budget, dst, slot,
                            pok, k_drop, topo_thr, ring_d, dropped_d,
                            thr_rev, seed, tiers)
        sending = np.asarray(jstate.budget_prefix_mask(
            jnp.asarray(c["sending"]), budget, jnp.asarray(nbytes.numpy())))
        resp_b = ok_pull[:, None] & ~drop & sending[c["dst"]]
        want_b = ring0.copy()
        np.maximum.at(want_b.reshape(d * n, p), c["slot"] * n + c["src"],
                      resp_b.astype(np.uint8))
        np.testing.assert_array_equal(ring_d.numpy(), want_b)
        assert int(dropped_d) == int((ok_pull[:, None] & drop
                                      & sending[c["dst"]]).sum())

    # K18's pull fold: the responders' frames and bytes over ok_pull
    acc = torch.zeros(2, dtype=torch.int64)
    telemetry.wire_words_pull_(acc, sending_w, nbytes, pok, dst)
    frames = c["sending"].sum(axis=1)[c["dst"]]
    assert int(acc[0]) == int(np.where(ok_pull, frames, 0).sum())
    assert int(acc[1]) == 8192 * int(acc[0])
    row_frames = torch.as_tensor(c["sending"].sum(axis=1).astype(np.int32))
    acc_rows = torch.zeros(2, dtype=torch.int64)
    telemetry.wire_rows_pull_(acc_rows, row_frames, row_frames * 8192, pok,
                              dst)
    assert acc_rows.tolist() == acc.tolist()


def test_checked_driver_holds_fifo_under_a_wipe():
    """The checked driver's FIFO branch: lab-ordered under a loss burst, a
    one-way cut and a crash with wipe, every round's delivery-order check
    passing (origin rows exempt), digests equal to JAX's driver; and the
    branch fires on a state that breaks the order."""
    from corrosion_tpu.sim.round import new_sim as jax_new_sim
    from corrosion_tpu_torch.sim.round import new_sim

    kw = dict(n_nodes=48, n_payloads=32, n_writers=2, fanout=3,
              sync_interval_rounds=4, n_delay_slots=4, ordering="fifo")
    jcfg, pcfg = jstate.SimConfig(**kw), pstate.SimConfig(**kw)
    jplan, pplan = plan_pair(48, 7, lambda ev: (
        ev("loss", 0, 12, p=0.3),
        ev("partition", 2, 8, src="0:8", dst="24:32"),
        ev("crash", 6, 10, node=1, wipe=True),
    ))
    jmeta = jstate.uniform_payloads(jcfg, inject_every=1)
    pmeta = pstate.uniform_payloads(pcfg, "cpu", inject_every=1)
    jfinal, jm, jd = jfaults.run_fault_plan_checked(
        jplan, jax_new_sim(jcfg, 7), jmeta, jcfg, max_rounds=400)
    final, m, d = pfaults.run_fault_plan_checked(
        pplan, new_sim(pcfg, 7, "cpu"), pmeta, pcfg, max_rounds=400)
    assert d == jd
    assert int(m.order_violations) == int(jm.order_violations) == 0
    from corrosion_tpu_torch.sim.gaps import extract_gaps

    have = final.have.clone()
    have[5] = 0
    have[5, 2 * pcfg.n_writers:] = 1  # every later version, not the first
    touched = pstate.touched_versions(have, pcfg)
    heads = pstate.version_heads(touched)
    gaps = extract_gaps(touched, heads, pcfg)
    broken = final._replace(have=have, heads=heads, gap_lo=gaps.lo,
                            gap_hi=gaps.hi)
    pinv.check_state(broken, dataclasses.replace(pcfg, ordering="none"),
                     meta=pmeta)
    with pytest.raises(AssertionError, match="delivery-order"):
        pinv.check_state(broken, pcfg, meta=pmeta)
