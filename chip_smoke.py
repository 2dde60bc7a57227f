"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the eleven CUDA kernels K1–K11 from the ten sources in
   ``corrosion_tpu_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one
   process per source, in parallel);
3. at the 100k storm's shapes (N = 100000, M = 64, W = 16, F = 3, S = 3,
   k = 8, A = 16, V = 8, C = 4, K = 8; the fault storm's plan: Kb = 2,
   Kl = 1, threshold 38, E up to 300000), call each kernel's wrappers
   and their plain torch versions on the same card tensors, require
   exact equality, and time both (CUDA events around a CUDA-graph replay
   of 20 calls, after warm-up; kernels that update in place are timed
   with their inputs restored before every call, less the restore's own
   time).  The inputs reach each kernel's traps: words with bit 31 set,
   spans 100000, 64 and 1, a per-element maxval and minval 1, gap rows
   with more than K runs, dead rows, self-edges and both sides of the
   partition, probe draws whose size is not a multiple of 128, a wiped
   row, both values of the fault loop's done flag;
4. run the 512-node seed-7 write storm and fault storm on the card and
   hold their final state digests, rounds and p99 against the pinned JAX
   goldens;
5. with every launch counter at 0, run ``config_write_storm_100k(seed=0)``
   on the card, hold rounds, p99 and the state digest against the pinned
   JAX goldens, and require every entry point of K1–K8 to have launched;
6. with every launch counter at 0 again, run
   ``config_packed_fault_storm(seed=0)`` (the fault storm, then its
   faultless twin), hold the fault run's rounds, p99 and digest against
   the goldens, and require every entry point of K1–K11 to have
   launched;
7. profile the first 3 rounds of both storms and the fault storm's
   12-round loss window (host wall, device time by kernel from
   ``torch.profiler``, the device's idle share);
8. print the card line, the kernels JSON line, then the one-line result
   ``{"ok": true, "device": {...}}``.

Nothing runs on the CPU: without a card the script exits at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet): the bound of every
# kernel here but K5 and K10 is the bytes it must move
HBM_BYTES_PER_S = 3.35e12
# K5 and K10 are bound by integer instructions: Hopper issues 64 INT32
# lanes per SM per clock (4 partitions × 16), over the card's SMs at its
# max clock
INT32_LANES_PER_SM = 64
# u32 operations the kernels do, counted from the sources: a threefry2x32
# hash is 2 + 5 × (4 × 3 + 2) adds, xors and funnel shifts; a randint
# draw is two hashes and their xors, three modulos, a multiply and an add
OPS_PER_HASH = 72
OPS_PER_RANDINT = 2 * (OPS_PER_HASH + 1) + 5
WARMUP, REPS = 3, 20


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _card_line() -> str:
    return _smi("name,power.limit")


def _int32_ops_per_s() -> float:
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def _time_ms(fn) -> float:
    """Device milliseconds per call: after WARMUP eager calls, REPS calls
    are captured in one CUDA graph, whose replay is timed with CUDA
    events — the host's launch overhead stays out of the number."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _time_eager_ms(fn) -> float:
    """Device milliseconds per call of a function that syncs with the
    host (and so cannot be captured in a graph): CUDA events around REPS
    eager calls after WARMUP, launch overhead included."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _time_inplace_ms(fn, restore) -> float:
    """`_time_ms` of a function that updates its inputs in place: each
    call runs on inputs ``restore`` put back, and the restore's own time
    is taken off."""
    def both():
        restore()
        fn()

    return _time_ms(both) - _time_ms(restore)


KERNEL_SYMBOLS = (
    "sample_targets_kernel", "broadcast_scatter_kernel", "sync_pull_kernel",
    "merge_scatter_kernel", "merge_apply_kernel", "threefry_kernel",
    "randint_kernel", "gaps_refresh_kernel", "converge_rows_kernel",
    "converge_finish_kernel", "inject_kernel", "spend_kernel",
    "deliver_kernel", "fault_edges_kernel", "fault_reach_kernel",
    "node_faults_kernel",
)


def profile_storm(dev, rounds=3, faults=False):
    """Where a 100k storm round's time goes on the card: the first
    ``rounds`` rounds of the faultless storm, or with ``faults`` of the
    fault storm (inside its loss window), on the host clock, then again
    under torch.profiler for device time by kernel (its own run: the
    profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import _write_storm, storm_fault_plan
    from corrosion_tpu_torch.sim.topology import Topology

    cfg, meta = _write_storm(100_000, 512, dev)
    if faults:
        fplan = compile_plan(storm_fault_plan(100_000, 0), cfg, device=dev)

    def run():
        state = new_sim(cfg, 0, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if faults:
            run_fault_plan(state, meta, cfg, Topology(), fplan, rounds)
        else:
            run_to_convergence(state, meta, cfg, Topology(), rounds)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    run()
    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # device-side events only: an aten op's CPU event also reports the
    # device time of the kernels it launched, which would count twice
    device = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    device.sort(key=lambda row: -row[1])
    total_us = sum(us for _, us, _ in device)
    ours_us = sum(us for key, us, _ in device
                  if any(sym in key for sym in KERNEL_SYMBOLS))
    # int64 elementwise kernels: the threefry's carriers (and index casts)
    long_us = sum(us for key, us, _ in device if "<long" in key)
    return {
        "storm": "fault" if faults else "faultless",
        "device_kernel_names": len(device),
        "rounds": rounds,
        "wall_ms_per_round": wall / rounds * 1e3,
        "device_ms_per_round": total_us / 1e3 / rounds,
        "idle_share": 1.0 - total_us / 1e6 / wall,
        "port_kernels_ms_per_round": ours_us / 1e3 / rounds,
        "port_kernel_ms_per_round": {
            sym: sum(us for key, us, _ in device if sym in key) / 1e3 / rounds
            for sym in KERNEL_SYMBOLS
        },
        "int64_kernels_ms_per_round": long_us / 1e3 / rounds,
        "device_launches_per_round": sum(c for _, _, c in device) / rounds,
        "top": [
            {"kernel": key[:90], "ms_per_round": us / 1e3 / rounds,
             "launches_per_round": count / rounds}
            for key, us, count in device[:10]
        ],
    }


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _random_tables(rng, n, m, t):
    """Member tables shaped like the storm's: residue-mapped ids with -1
    empties, keys across ALIVE/SUSPECT/DOWN with incarnations up to the
    clamp (so packed words carry bit 31), psince stamps up to t."""
    ids = np.arange(m)[None, :] + m * rng.integers(0, (n + m - 1) // m, (n, m))
    pid = np.where((ids < n) & (rng.random((n, m)) > 0.1), ids, -1)
    inc = np.where(rng.random((n, m)) < 0.2, rng.integers(1024, 2047, (n, m)),
                   rng.integers(0, 8, (n, m)))
    pkey = np.where(pid >= 0, inc * 4 + rng.integers(0, 3, (n, m)), -1)
    psince = np.where(rng.random((n, m)) < 0.5, rng.integers(0, t + 1, (n, m)),
                      -1)
    return pid, pkey, psince


def _random_words(g, shape, dev, ands=1):
    """Random u32 words in int32 carriers, each bit set with probability
    2^-ands."""
    w = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    for _ in range(ands):
        w &= g.integers(0, 1 << 32, shape, dtype=np.uint32)
    return torch.as_tensor(w.view(np.int32), device=dev)


def compare_kernels(dev, seed=0, n=100_000):
    """Phase 3: every kernel against its plain version at storm shapes."""
    from corrosion_tpu_torch.sim import packed, pswim

    m, w, f, s, k = 64, 16, 3, 3, 8
    t, gc = 40, 12
    rng = np.random.default_rng(seed)

    def cuda(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    def words(shape, ands=1):
        return _random_words(rng, shape, dev, ands)

    pid, pkey, psince = _random_tables(rng, n, m, t)
    pid_t, pkey_t, psince_t = cuda(pid), cuda(pkey), cuda(psince)
    rows = []

    # K1: member sampler, the storm's fanout/sync/relay draw (count 3)
    table = pswim._pack_tables(pid_t, pkey_t).contiguous()
    slots = cuda(rng.integers(0, m, (4 * 3, n)))
    got = pswim.sample_candidates(table, slots, 3)
    ref = pswim.sample_candidates_plain(table, slots, 3)
    rows.append(dict(
        name="sample_targets",
        source="corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        replaces="corrosion_tpu/sim/pswim.py:82",
        equal=bool(torch.equal(got, ref)), max_abs_err=_max_abs_err(got, ref),
        ms=_time_ms(lambda: pswim.sample_candidates(table, slots, 3)),
        plain_ms=_time_ms(lambda: pswim.sample_candidates_plain(table, slots, 3)),
        # the draws, one gathered word per draw, the output
        bound_ms=_bound_ms(slots.numel() * 4 * 2 + n * 3 * 4),
    ))

    # K2: broadcast ring scatter (one region: every edge lands in slot t%D)
    sending = words((n, w), 4)
    dst = cuda(rng.integers(0, n, n * f))
    slot = cuda(np.full(n * f, t % 2))
    ok = cuda(rng.random(n * f) < 0.95, torch.bool)
    ring0 = words((2, n, w), 6)
    got, ref = ring0.clone(), ring0.clone()
    packed.scatter_sending(got, sending, dst, slot, ok, f)
    packed.scatter_sending_plain(ref, sending, dst, slot, ok, f)
    ring_rows = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    rows.append(dict(
        name="broadcast_scatter",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/packed.py:369",
        equal=bool(torch.equal(got, ref)), max_abs_err=_max_abs_err(got, ref),
        ms=_time_ms(lambda: packed.scatter_sending(
            ring_k, sending, dst, slot, ok, f)),
        plain_ms=_time_ms(lambda: packed.scatter_sending_plain(
            ring_p, sending, dst, slot, ok, f)),
        # sending rows, the edge arrays, the touched ring rows in and out
        bound_ms=_bound_ms(sending.numel() * 4 + n * f * 9
                           + ring_rows * w * 4 * 2),
    ))

    # K3: sync pull, with words that carry bit 31 (the unsigned-max trap)
    masks = words((n, 4, w))
    miss = words((n, w), 2)
    peers = cuda(rng.integers(0, n, (n, s)))
    pok = cuda(rng.random((n, s)) < 0.7, torch.bool)
    buf0 = torch.zeros((n, w), dtype=torch.int32, device=dev)
    got_buf, ref_buf = buf0.clone(), buf0.clone()
    got = packed.sync_pull(masks, miss, peers, pok, got_buf)
    ref = packed.sync_pull_plain(masks, miss, peers, pok, ref_buf)
    eq = torch.equal(got, ref) and torch.equal(got_buf, ref_buf)
    if not bool((ref_buf < 0).any()):
        raise AssertionError("K3 inputs pulled no word with bit 31 set")
    buf_k, buf_p = buf0.clone(), buf0.clone()
    rows.append(dict(
        name="sync_pull",
        source="corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        replaces="corrosion_tpu/sim/packed.py:1138",
        equal=bool(eq), max_abs_err=max(_max_abs_err(got_buf, ref_buf),
                                        _max_abs_err(got, ref)),
        ms=_time_ms(lambda: packed.sync_pull(masks, miss, peers, pok, buf_k)),
        plain_ms=_time_ms(lambda: packed.sync_pull_plain(
            masks, miss, peers, pok, buf_p)),
        # masks and miss once, peers and ok, the slot in and out, fruitful
        bound_ms=_bound_ms(masks.numel() * 4 + miss.numel() * 4 + n * s * 5
                           + n * w * 4 * 2 + n),
    ))

    # K4: table merge over the storm's entry count, with colliding ids
    e = n * f * (k + 1) + n
    e_dst = rng.integers(0, n, e)
    same = rng.random(e) < 0.5
    picked = pid[e_dst, rng.integers(0, m, e)]
    e_id = np.where(same & (picked >= 0), picked, rng.integers(0, n, e))
    e_key = rng.integers(0, 2047, e) * 4 + rng.integers(0, 3, e)
    e_ok = rng.random(e) < 0.8
    args = (pid_t, pkey_t, psince_t, cuda(e_dst), cuda(e_id), cuda(e_key),
            cuda(e_ok, torch.bool), t, gc)
    got = pswim.merge_entries(*args)
    ref = pswim.merge_entries_plain(*args)
    rows.append(dict(
        name="merge_entries",
        source="corrosion_tpu_torch/kernels/csrc/merge_entries.cu",
        replaces="corrosion_tpu/sim/pswim.py:103",
        equal=all(torch.equal(a, b) for a, b in zip(got, ref)),
        max_abs_err=max(_max_abs_err(a, b) for a, b in zip(got, ref)),
        ms=_time_ms(lambda: pswim.merge_entries(*args)),
        plain_ms=_time_ms(lambda: pswim.merge_entries_plain(*args)),
        # the entry arrays, the three tables in and out
        bound_ms=_bound_ms(e * 13 + 3 * n * m * 4 * 2),
    ))
    rows.append(compare_threefry(dev, rng, n, m))
    rows.append(compare_gaps_refresh(dev, rng, n, w))
    rows.append(compare_converge_fold(dev, rng, n, w))
    rows.append(compare_word_phases(dev, rng, n, w, f))
    rows += compare_fault_seam(dev, rng, n, w, f)
    for row in rows:
        row.setdefault("bound_by", "bytes")
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


def _equal_all(got, want):
    eq = all(a.dtype == b.dtype and torch.equal(a, b)
             for a, b in zip(got, want))
    return eq and len(got) == len(want), max(
        _max_abs_err(a, b) for a, b in zip(got, want))


def _round_draws(r, key, backoff, n, m):
    """One storm round's draws (sim/packed.py, sim/pswim.py) through
    ``r``'s split and randint: the splits, then every randint in order."""
    ks = r.split(key, 4)
    kb, ksy, ksw = r.split(ks[1], 3), r.split(ks[2], 3), r.split(ks[3], 11)
    per = (n + m - 1) // m
    return [ks, kb, ksy, ksw] + [
        r.randint(kb[0], (12, n), 0, m),  # broadcast targets
        r.randint(ksy[0], (12, n), 0, m),  # sync peers
        r.randint(ksy[2], (n,), 1, backoff + 1),  # the rearm, per element
        r.randint(ksw[0], (4, n), 0, m),  # probe target
        r.randint(ksw[2], (12, n), 0, m),  # probe relays
        r.randint(ksw[4], (12, n), 0, m),  # gossip targets
        r.randint(ksw[5], (n, 8), 0, m),  # gossip picks
        r.randint(ksw[7], (n,), 0, n),  # announce target: span 100000
        r.randint(ksw[9], (n,), 0, m),  # refill bucket
        r.randint(ksw[10], (n,), 0, per),  # refill id
    ]


def compare_threefry(dev, g, n, m):
    """K5 over a storm round's draws, and randint's span-1 traps."""
    from corrosion_tpu_torch.sim import rng

    plain = SimpleNamespace(split=rng.split_plain, randint=rng.randint_plain)
    key = rng.prng_key(1234, dev)
    # backoffs of 0 make maxval == minval == 1: a per-element span of 1
    backoff = torch.as_tensor(g.integers(0, 33, n), dtype=torch.int32,
                              device=dev)
    got = _round_draws(rng, key, backoff, n, m)
    want = _round_draws(plain, key, backoff, n, m)
    traps = [(key, (n,), 0, 1), (key, (n,), 1, 1), (key, (n,), 5, -3)]
    got += [rng.randint(*a) for a in traps]
    want += [rng.randint_plain(*a) for a in traps]
    equal, err = _equal_all(got, want)
    if not bool((backoff == 0).any()):
        raise AssertionError("K5 inputs reach no per-element span of 1")
    draws = sum(x.numel() for x in got[4:14])
    hashes = sum(x.shape[0] for x in got[:4])
    ops = draws * OPS_PER_RANDINT + hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    return dict(
        name="threefry",
        source="corrosion_tpu_torch/kernels/csrc/threefry.cu",
        replaces="corrosion_tpu/sim/pswim.py:92",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: _round_draws(rng, key, backoff, n, m)),
        plain_ms=_time_ms(lambda: _round_draws(plain, key, backoff, n, m)),
        bound_ms=ops / rate * 1e3, bound_by="operations",
        ops=ops, int32_ops_per_s=rate, draws=draws,
    )


def _storm_cfg(n, dev):
    from corrosion_tpu_torch.sim.runner import _write_storm

    return _write_storm(n, 512, dev)


def compare_gaps_refresh(dev, g, n, w):
    """K6 on mid-storm have words; a second check with K = 2 reaches the
    overflow clamp (at K = 8 a V = 8 row has at most 4 runs)."""
    from corrosion_tpu_torch.sim import gaps

    cfg, _ = _storm_cfg(n, dev)
    bits = (g.random((n, w, 32)) < 0.3).astype(np.uint64)
    have = torch.as_tensor(
        (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        .view(np.int32), device=dev,
    )
    equal, err = _equal_all(gaps.refresh_gaps(have, cfg),
                            gaps.refresh_gaps_plain(have, cfg))
    tight = dataclasses.replace(cfg, gap_slots=2)
    got = gaps.refresh_gaps(have, tight)
    eq2, err2 = _equal_all(got, gaps.refresh_gaps_plain(have, tight))
    if int(got[3]) == 0:
        raise AssertionError("K6 inputs overflow no row at K = 2")
    a, k = cfg.n_writers, cfg.gap_slots
    return dict(
        name="gaps_refresh",
        source="corrosion_tpu_torch/kernels/csrc/gaps_refresh.cu",
        replaces="corrosion_tpu/sim/gaps.py:137",
        equal=equal and eq2, max_abs_err=max(err, err2),
        ms=_time_ms(lambda: gaps.refresh_gaps(have, cfg)),
        plain_ms=_time_ms(lambda: gaps.refresh_gaps_plain(have, cfg)),
        # the have words in; heads, lo, hi and the count out
        bound_ms=_bound_ms(n * w * 4 + n * a * 4 + 2 * n * a * k * 4 + 4),
    )


def compare_converge_fold(dev, g, n, w):
    """K7 with dead rows and all-ones words (bit 31 set): once with holes
    (payload stamps only), once complete past the last injection (node
    stamps and the done flag); then the fault loop's exit mode at the
    fault storm's horizon 21: before it, at it, and at it with an up row
    wiped after its sticky stamp (done must fall back to False)."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.round import RunMetrics

    cfg, meta = _storm_cfg(n, dev)
    p = cfg.n_payloads
    dead = g.random(n) < 0.05
    alive = torch.as_tensor(dead * 2, dtype=torch.uint8, device=dev)
    full = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    holes = full.copy()
    rows = g.random(n) < 0.3
    holes[rows, : w // 2] &= g.integers(0, 1 << 32, (int(rows.sum()), w // 2),
                                        dtype=np.uint32)
    holes[dead] &= g.integers(0, 1 << 32, (int(dead.sum()), w),
                              dtype=np.uint32)
    inj = torch.full((w,), -1, dtype=torch.int32, device=dev)
    metrics = RunMetrics(
        coverage_at=torch.full((p,), -1, dtype=torch.int32, device=dev),
        converged_at=torch.as_tensor(
            np.where(g.random(n) < 0.2, 3, -1), dtype=torch.int32,
            device=dev),
        overflow_frac=torch.zeros((), device=dev),
        order_violations=torch.zeros((), dtype=torch.int32, device=dev),
    )
    wiped = full.copy()
    victim = int(np.flatnonzero(~dead)[0])
    wiped[victim] = 0
    stamped = metrics._replace(converged_at=metrics.converged_at.clone())
    stamped.converged_at[victim] = 3
    cases = []
    for words, t, m, horizon in ((holes, 10, metrics, None),
                                 (full, 20, metrics, None),
                                 (full, 19, metrics, 21),
                                 (full, 20, metrics, 21),
                                 (wiped, 20, stamped, 21)):
        have = torch.as_tensor(words.view(np.int32), device=dev)
        args = (have, inj, alive, m, meta, t, cfg, horizon)
        cases.append((args, packed.converge_record(*args),
                      packed.converge_record_plain(*args)))
    equal, err = True, 0
    for _, got, want in cases:
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
    if [bool(c[2][2]) for c in cases] != [False, True, False, True, False]:
        raise AssertionError("K7 inputs do not reach both done values in "
                             "both modes")
    args = cases[0][0]
    exit_args = cases[3][0]  # the fault loop's exit mode, done reached
    return dict(
        name="converge_fold",
        source="corrosion_tpu_torch/kernels/csrc/converge_fold.cu",
        replaces="corrosion_tpu/sim/packed.py:789",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: packed.converge_record(*args)),
        plain_ms=_time_ms(lambda: packed.converge_record_plain(*args)),
        exit_mode_ms=_time_ms(lambda: packed.converge_record(*exit_args)),
        exit_mode_plain_ms=_time_ms(
            lambda: packed.converge_record_plain(*exit_args)),
        # have, injected_p, alive, meta.round; converged_at and
        # coverage_at in and out; the done flag
        bound_ms=_bound_ms(n * w * 4 + w * 4 + n + p * 4 + n * 4 * 2
                           + p * 4 * 2 + 1),
    )


def _word_phases(ph, c, inj, t, meta, cfg, alive, targets):
    """A round's word phases through ``ph``: inject, spend, deliver."""
    ph.inject(c, inj, t, meta, cfg, alive)
    sending = ph.spend(c, inj, targets, alive)
    ph.deliver(c, t, cfg)
    return sending


def compare_word_phases(dev, g, n, w, f):
    """K8's three entry points on a mid-storm carry, in round order."""
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _storm_cfg(n, dev)
    t = 4

    def words(shape, ands=1):
        return _random_words(g, shape, dev, ands)

    c0 = packed.PackedCarry(
        have=words((n, w)), inflight=words((2, n, w), 5),
        relay=packed.Planes(*(words((n, w), 2) for _ in range(4))),
        sync_buf=words((2, n, w), 6),
    )
    inj0 = words((w,), 2)
    me = np.arange(n)[:, None]
    tg = np.where(g.random((n, f)) < 0.05, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                              dtype=torch.int32, device=dev)
    alive = torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                            device=dev)
    flat0 = [c0.have, c0.inflight, *c0.relay, c0.sync_buf, inj0]
    work = [x.clone() for x in flat0]

    def carry_of(xs):
        return packed.PackedCarry(have=xs[0], inflight=xs[1],
                                  relay=packed.Planes(*xs[2:6]),
                                  sync_buf=xs[6]), xs[7]

    def restore():
        for dst, src in zip(work, flat0):
            dst.copy_(src)

    kern = SimpleNamespace(inject=packed.inject_packed,
                           spend=packed.spend_relay,
                           deliver=packed.deliver_packed)
    plain = SimpleNamespace(inject=packed.inject_packed_plain,
                            spend=packed.spend_relay_plain,
                            deliver=packed.deliver_packed_plain)
    outs = []
    for ph in (kern, plain):
        xs = [x.clone() for x in flat0]
        c, inj = carry_of(xs)
        outs.append([_word_phases(ph, c, inj, t, meta, cfg, alive, targets),
                     *xs])
    equal, err = _equal_all(outs[0], outs[1])

    # bytes: inject's P metadata, W injected words and the cells it arms;
    # spend's have, planes, targets and alive in, sending and the changed
    # plane words out; deliver's two slots in, the cells they touch
    p = cfg.n_payloads
    got = outs[1]
    arms = int(((meta.round == t)
                & (alive[meta.actor.long()] == 0)).sum()) * 5 * 4 * 2
    spent = sum(int((a != b).sum()) for a, b in zip(got[3:7], flat0[2:6]))
    arriving = flat0[1][t % 2]
    pending = flat0[6][t % 2]
    touched = int(((arriving | pending) != 0).sum())
    newly = int(((arriving & ~flat0[0]) != 0).sum())
    nbytes = (p * 9 + w * 4 * 2 + arms
              + n * w * 4 * 6 + n * f * 4 + n + spent * 4
              + 2 * n * w * 4 + touched * 4 * 4 + newly * 4 * 4 * 2)
    c, inj = carry_of(work)
    return dict(
        name="word_phases",
        source="corrosion_tpu_torch/kernels/csrc/word_phases.cu",
        replaces="corrosion_tpu/sim/packed.py:631",
        equal=equal, max_abs_err=err,
        ms=_time_inplace_ms(lambda: _word_phases(
            kern, c, inj, t, meta, cfg, alive, targets), restore),
        plain_ms=_time_inplace_ms(lambda: _word_phases(
            plain, c, inj, t, meta, cfg, alive, targets), restore),
        bound_ms=_bound_ms(nbytes),
    )


def _storm_fault_round(dev, n, t):
    """The 100k fault storm's config, compiled plan and round t's slice."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.runner import storm_fault_plan

    cfg, meta = _storm_cfg(n, dev)
    fplan = faults.compile_plan(storm_fault_plan(n, 0), cfg, device=dev)
    return cfg, meta, fplan, faults.round_faults(fplan, t)


def _fault_edge_calls(fs, rf, key, calls):
    """A fault-storm round's K9 calls through ``fs`` (the wrappers, or the
    plain versions): the five probe reach calls, the sync sessions' cut
    in either direction, and the wire's cuts and thresholds."""
    out = []
    for kind, src, dst, ok in calls:
        if kind == "reach":
            out.append(fs.reach(ok.clone(), rf, key, src, dst))
        elif kind == "session":
            out.append(fs.session(rf, src, dst))
        else:
            out += list(fs.wire(rf, src, dst, ok.clone()))
    return out


def compare_fault_seam(dev, g, n, w, f):
    """K9, K10 and K11 at the 100k fault storm's shapes and plan, on
    round 5 (loss and partition on) and the wipe round 20."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import rng as trng

    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    key = trng.prng_key(99, dev)

    def edges(e, per_node=None):
        src = (torch.arange(n, dtype=torch.int32, device=dev)
               .repeat_interleave(per_node) if per_node
               else torch.as_tensor(g.integers(0, n, e), dtype=torch.int32,
                                    device=dev))
        dst = g.integers(0, n, e)
        self_edge = g.random(e) < 0.05
        dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
        dst = torch.where(torch.as_tensor(self_edge, device=dev), src, dst)
        ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
        return src, dst.contiguous(), ok

    # the round's calls: probe direct, relay legs, gossip, announce;
    # sessions; the wire (E = N, 3N, 3N, 3N, N; 3N; 3N)
    calls = [("reach", *edges(n, 1)), ("reach", *edges(3 * n, 3)),
             ("reach", *edges(3 * n)), ("reach", *edges(3 * n, 3)),
             ("reach", *edges(n, 1)), ("session", *edges(3 * n, 3)),
             ("wire", *edges(3 * n, 3))]
    if all(c[1].shape[0] % 128 == 0 for c in calls if c[0] == "reach"):
        raise AssertionError("K9 inputs reach no padded probe draw")
    kern = SimpleNamespace(reach=faults.fault_reach_,
                           session=faults.fault_session_refused,
                           wire=faults.fault_wire_effects)
    plain = SimpleNamespace(
        reach=faults.fault_reach_plain,
        session=lambda rf, s, d: (faults._block_plain(rf, s, d)
                                  | faults._block_plain(rf, d, s)),
        wire=lambda rf, s, d, ok: (
            ok.__iand__(~faults._block_plain(rf, s, d)),
            faults._loss_plain(rf, s, d)),
    )
    got = _fault_edge_calls(kern, rf, key, calls)
    want = _fault_edge_calls(plain, rf, key, calls)
    equal, err = _equal_all(got, want)
    # the queries on their own, on the wire's edges
    _, ws, wd, _ = calls[-1]
    for q, ref in ((faults.fault_edge_block, faults._block_plain),
                   (faults.fault_edge_loss, faults._loss_plain)):
        e2, x2 = _equal_all([q(rf, ws, wd)], [ref(rf, ws, wd)])
        equal, err = equal and e2, max(err, x2)
    blk, thr = faults._block_plain(rf, ws, wd), want[-1]
    if not (bool(blk.any()) and bool((~blk & (ws != wd)).any())
            and bool((ws == wd).any()) and int(thr.max()) == 38):
        raise AssertionError("K9 inputs miss a partition side, a "
                             "self-edge or the loss threshold")
    kl = int(rf.loss_src.shape[0])
    kb = int(rf.block_src.shape[0])
    nbytes = sum(c[1].shape[0] * 8 for c in calls)  # the edge ids
    nbytes += sum(c[1].shape[0] * (2 if c[0] == "reach" else 1)
                  for c in calls)  # ok in and out, or the cut out
    nbytes += 3 * n + 1 + n * 2 * (kb + kl) * len(calls)  # wire's thr, masks
    # distinct draw words of the reach calls' edges that need one
    words = 0
    for (kind, src, dst, ok), out in zip(calls, got):
        if kind == "reach":
            need = (ok & ~faults._block_plain(rf, src, dst)
                    & (faults._loss_plain(rf, src, dst) > 0))
            idx = torch.nonzero(need).flatten() // 4
            words += int(torch.unique(idx).numel())
    rate = _int32_ops_per_s()
    ops = words * OPS_PER_HASH
    k9 = dict(
        name="fault_edges",
        source="corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
        replaces="corrosion_tpu/sim/faults.py:182",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: _fault_edge_calls(kern, rf, key, calls)),
        plain_ms=_time_ms(lambda: _fault_edge_calls(plain, rf, key, calls)),
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="bytes" if _bound_ms(nbytes) >= ops / rate * 1e3
        else "operations",
        calls=len(calls),
    )

    # K10: the wire's scatter with the loss drawn in the kernel
    sending = _random_words(g, (n, w), dev, 4)
    _, src, dst, ok0 = calls[-1]
    ok = ok0.clone()
    ok, thr = faults.fault_wire_effects(rf, src, dst, ok)
    dst = torch.clamp(dst, min=0)
    slot = torch.full_like(dst, 5 % 2)
    ring0 = _random_words(g, (2, n, w), dev, 6)
    seed = int(rf.seed)
    got_r, want_r = ring0.clone(), ring0.clone()
    packed.scatter_sending_lossy(got_r, sending, dst, slot, ok, thr, key,
                                 seed, f)
    packed.scatter_sending_lossy_plain(want_r, sending, dst, slot, ok, thr,
                                       key, seed, f)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    if torch.equal(lossless, want_r):
        raise AssertionError("K10 inputs drop no payload")
    live = ok & (thr > 0)
    sent_words = (sending.repeat_interleave(f, dim=0) != 0) & live[:, None]
    hashes = int(sent_words.sum()) * 8
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    k10_bytes = (sending.numel() * 4 + src.shape[0] * 10
                 + rows_touched * w * 4 * 2)
    k10_ops = hashes * OPS_PER_HASH
    ring_k, ring_p = ring0.clone(), ring0.clone()
    k10 = dict(
        name="broadcast_scatter_lossy",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/faults.py:260",
        equal=bool(torch.equal(got_r, want_r)),
        max_abs_err=_max_abs_err(got_r, want_r),
        ms=_time_ms(lambda: packed.scatter_sending_lossy(
            ring_k, sending, dst, slot, ok, thr, key, seed, f)),
        # the plain version finds its pairs with a host sync: eager
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, sending, dst, slot, ok, thr, key, seed, f)),
        bound_ms=max(_bound_ms(k10_bytes), k10_ops / rate * 1e3),
        bound_by="operations" if k10_ops / rate * 1e3 > _bound_ms(k10_bytes)
        else "bytes",
        ops=k10_ops, hashes=hashes,
    )
    return [k9, k10, compare_node_faults(dev, g, n, w, cfg, fplan)]


def compare_node_faults(dev, g, n, w, cfg, fplan):
    """K11 on round 20 of the fault storm (node 1's restart: an override
    and a wiped row) and round 8 (its crash: an override only), on a
    mid-storm slim state and carry."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim.state import init_state

    m, t = cfg.member_slots, 20
    slim = packed.shrink_state(init_state(cfg, torch.tensor(
        [0, 5], dtype=torch.int64, device=dev)))
    pid, pkey, psince = _random_tables(g, n, m, t)
    a, k = cfg.n_writers, cfg.gap_slots
    slim = slim._replace(
        pid=torch.as_tensor(pid, dtype=torch.int32, device=dev),
        pkey=torch.as_tensor(pkey, dtype=torch.int32, device=dev),
        psince=torch.as_tensor(psince, dtype=torch.int32, device=dev),
        heads=torch.as_tensor(g.integers(1, 9, (n, a)), dtype=torch.int32,
                              device=dev),
        gap_lo=torch.as_tensor(g.integers(0, 9, (n, a, k)),
                               dtype=torch.int32, device=dev),
        gap_hi=torch.as_tensor(g.integers(0, 9, (n, a, k)),
                               dtype=torch.int32, device=dev),
        alive=torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                              device=dev),
    )
    carry = packed.PackedCarry(
        have=_random_words(g, (n, w), dev),
        inflight=_random_words(g, (2, n, w), dev, 3),
        relay=packed.Planes(*(_random_words(g, (n, w), dev, 2)
                              for _ in range(4))),
        sync_buf=_random_words(g, (2, n, w), dev, 3),
    )
    names = ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey", "psince")

    def flat(sl, c):
        return [getattr(sl, x) for x in names] + [
            c.have, *c.relay, c.inflight, c.sync_buf]

    def unflat(xs):
        sl = slim._replace(**dict(zip(names, xs[:7])))
        return sl, packed.PackedCarry(have=xs[7], relay=packed.Planes(
            *xs[8:12]), inflight=xs[12], sync_buf=xs[13])

    base = flat(slim, carry)
    plain = lambda sl, c, rf: (  # noqa: E731
        faults.apply_node_faults(sl, rf), packed.apply_carry_faults(c, rf))
    equal, err = True, 0
    for r in (20, 8):
        rf = faults.round_faults(fplan, r)
        outs = []
        for fn in (packed.apply_round_faults, plain):
            xs = [x.clone() for x in base]
            fn(*unflat(xs), rf)
            outs.append(xs)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        if r == 20 and (int(rf.wipe.sum()) != 1
                        or torch.equal(outs[0][7], base[7])):
            raise AssertionError("K11 inputs wipe no row")
    rf = faults.round_faults(fplan, t)
    work = [x.clone() for x in base]

    def restore():
        for dst, src in zip(work, base):
            dst.copy_(src)

    wiped = int(rf.wipe.sum())
    row = (w * (5 + 2 * 2) + a + 2 * a * k + 3 * m) * 4
    return dict(
        name="node_faults",
        source="corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        replaces="corrosion_tpu/sim/faults.py:703",
        equal=equal, max_abs_err=err,
        ms=_time_inplace_ms(
            lambda: packed.apply_round_faults(*unflat(work), rf), restore),
        plain_ms=_time_inplace_ms(lambda: plain(*unflat(work), rf), restore),
        # the override, the wipe mask and alive in and out; wiped rows out
        bound_ms=_bound_ms(n * 4 + wiped * row),
    )


def _storm_check(result, golden, label):
    from corrosion_tpu_torch.convert import state_digest

    got = {
        "rounds": result["rounds"],
        "p99_node_convergence_round": result["p99_node_convergence_round"],
        "digest": state_digest(result["state"]),
    }
    print(f"{label}: {json.dumps(got)} wall_clock_s="
          f"{result['wall_clock_s']:.3f}", flush=True)
    for key, want in golden.items():
        if got[key] != want:
            raise AssertionError(f"{label}: {key} {got[key]!r} != golden "
                                 f"{want!r}")
    if not result["converged"]:
        raise AssertionError(f"{label}: did not converge")


def _fault_record(final, metrics, wall):
    """A fault run's record in `_storm_check`'s terms."""
    from corrosion_tpu_torch.sim.runner import _node_convergence

    conv = _node_convergence(metrics, final)
    return {"state": final, "rounds": int(final.t), "wall_clock_s": wall,
            "converged": conv["unconverged_nodes"] == 0, **conv}


def _path_launches(kernels, rows, label):
    """Read every entry point's launch count after a path ran from 0,
    require each entry of ``rows``' kernels to have launched, and return
    the counts of every kernel row."""
    entries = {kern.name: kern.launches for kern in kernels.KERNELS}
    off = [row for row in kernels.PORTED if row not in rows]
    print(f"{label} launches={json.dumps(entries)} off_path={off}",
          flush=True)
    for row in rows:
        for kern in kernels.PORTED[row]:
            if kern.launches <= 0:
                raise AssertionError(f"kernel entry {kern.name} never "
                                     f"launched on the {label} path")
    return {row: sum(k.launches for k in entries_)
            for row, entries_ in kernels.PORTED.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from corrosion_tpu_torch import goldens, kernels
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import (
        _write_storm,
        config_packed_fault_storm,
        config_write_storm_100k,
        run_scenario,
        storm_fault_plan,
    )
    from corrosion_tpu_torch.sim.topology import Topology

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}", flush=True)

    t0 = time.monotonic()
    kernels.build_all(verbose=True)
    print(f"build_s={time.monotonic() - t0:.2f}", flush=True)

    rows = compare_kernels(dev)
    print("kernel comparisons equal at storm shapes", flush=True)

    cfg, meta = _write_storm(512, 256, dev)
    cfg = dataclasses.replace(cfg, packed_min_cells=0)
    small = run_scenario(cfg, meta, seed=7, max_rounds=600, device=dev,
                         return_state=True)
    _storm_check(small, goldens.STORM_512_SEED7, "storm_512_seed7")
    fplan = faults.compile_plan(storm_fault_plan(512, 7), cfg,
                                factored=True, device=dev)
    t0 = time.monotonic()
    final, metrics = faults.run_fault_plan(
        new_sim(cfg, 7, dev), meta, cfg, Topology(), fplan, max_rounds=600)
    torch.cuda.synchronize()
    _storm_check(_fault_record(final, metrics, time.monotonic() - t0),
                 goldens.FAULT_STORM_512_SEED7, "fault_storm_512_seed7")

    # path 1, the faultless storm: K1-K8
    faultless_rows = list(kernels.PORTED)[:8]
    kernels.reset_launch_counts()
    big = config_write_storm_100k(seed=0, device=dev, return_state=True)
    launches = _path_launches(kernels, faultless_rows, "storm_100k")
    _storm_check(big, goldens.STORM_100K_SEED0, "storm_100k_seed0")

    # path 2, the 100k fault storm alone: K1 and K3-K11.  Every fault
    # round scatters through K10, so K2 is off this path.
    cfg, meta = _write_storm(100_000, 512, dev)
    fplan = faults.compile_plan(storm_fault_plan(100_000, 0), cfg,
                                device=dev)
    state = new_sim(cfg, 0, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, metrics = faults.run_fault_plan(
        state, meta, cfg, Topology(), fplan, max_rounds=3000)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    fault_launches = _path_launches(
        kernels, [row for row in kernels.PORTED if row != "broadcast_scatter"],
        "fault_storm_100k")
    _storm_check(_fault_record(final, metrics, wall),
                 goldens.FAULT_STORM_100K_SEED0, "fault_storm_100k")

    # the fault storm's entry point, with its faultless twin
    fault = config_packed_fault_storm(seed=0, device=dev, return_state=True)
    _storm_check(fault, goldens.FAULT_STORM_100K_SEED0,
                 "config_packed_fault_storm")
    print("config_packed_fault_storm: " + json.dumps({
        k: v for k, v in fault.items() if k not in ("state", "metrics")}),
        flush=True)

    print("profile: " + json.dumps(profile_storm(dev)), flush=True)
    print("profile: " + json.dumps(profile_storm(dev, faults=True)),
          flush=True)
    # the whole loss window, where most nodes send and K10 draws most
    print("profile: " + json.dumps(profile_storm(dev, 12, faults=True)),
          flush=True)

    for row in rows:
        row["launches"] = (launches if row["name"] in faultless_rows
                           else fault_launches)[row["name"]]
        row["fault_path_launches"] = fault_launches[row["name"]]
        row["kernel_ms"] = row["ms"]
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
