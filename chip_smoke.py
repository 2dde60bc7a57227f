"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the nineteen CUDA kernels K1–K19 from the eighteen sources in
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
   then K1's uniform entry and K12–K15 the same way at the dense paths'
   shapes — partition-heal-10k's (N = 10000, P = 256, A = 4, V = 64,
   K = 8, F = S = 3, D = 3, two regions) for K12–K14, broadcast-1k's
   (N = 1000, A = 8, V = 32) for K14's word-branch shape, the churn's
   (N = 4096, F = 3) for K15 and K1 — with more than K gap runs, byte
   budgets that bind, a loss threshold of 51, SUSPECT cells past the
   timeout, DOWN receivers and refuting nodes;
   then K16, K3's metered entry, K10's topology stream and K6 past 32
   versions at gapstress-25.6k's shapes (N = 25600, P = 8192, W = 256,
   A = 8, V = 128, C = 8, K = 8, F = S = 3, D = 4) and K14 at the
   distortion control's (N = 1024, K = 64) — budgets that bind, a budget
   of 1, empty rows, P = 65536 (the two-lane branch), needs the grant
   cuts to nothing, both loss streams alone and together, a severed
   channel, runs across version-word edges, heads at 32j, V = 40, more
   than 32 runs in a row;
   then the flight recorder's kernels: K17's grant and coverage entries,
   K18 and K19 at the storm's shapes (E = 300000) and gapstress's (rows
   marked gs), K17's dense entry and K18's rows entry at gapstress-1024's
   (N = 1024, P = 8192), and the telemetry outputs of K3 (granted words;
   its metered entry at gapstress's), K9 (cut and refused counts) and
   K10 (dropped frames) at the fault storm's round 5 and under
   gapstress's topology stream, K12 (per-node frames and bytes, dropped
   frames) and K13 (grant counts) at gapstress-1024's — words with bit
   31 set, byte totals past 2^31, a decimated scratch row, a full-view
   row, drops, cuts and refusals;
4. run the 512-node seed-7 write storm and fault storm on the card and
   hold their final state digests, rounds and p99 against the pinned JAX
   goldens;
5. with every launch counter at 0, run ``config_write_storm_100k(seed=0)``
   on the card, hold rounds, p99 and the state digest against the pinned
   JAX goldens, and require every entry point of K1–K8 to have launched;
6. with every launch counter at 0 again, run the 100k fault storm alone
   (``run_fault_plan``), hold its rounds, p99 and digest against the
   goldens and require every entry point of K1's table sampler and
   K3–K11 to have launched; then ``config_packed_fault_storm(seed=0)``
   (the fault storm, then its faultless twin) for
   ``fault_over_faultless``;
7. each from launch counters at 0: ``config_partition_heal_10k(seed=0)``
   (K1, K4, K5, K12–K14), ``config_broadcast_1k(seed=0)`` and
   ``config_ground_truth_3node(seed=0)`` (K1's uniform entry, K5,
   K12–K14), ``membership_churn(4096, seed=0)`` (those and K15), each
   held against its goldens (heal round, rounds, p99, digest; the
   churn's detect round, digest and false DOWNs);
8. each from launch counters at 0: ``config_write_storm_gapstress(
   seed=1, n_nodes=25600)`` on the packed round (K1, K3's metered
   entry, K4–K8, K10, K16), held against its golden (rounds, both p99s,
   ``gap_overflow_frac_max``, digest), and ``config_gapstress_distortion(
   seed=0, n_nodes=1024)`` on the dense round (K1, K4, K5, K12–K14; K =
   8 and K = 64), held against its golden;
9. the flight recorder: each from launch counters at 0,
   ``config_write_storm_100k(seed=0, telemetry=True)``, the 100k fault
   storm through ``run_fault_plan(telemetry=True)``,
   ``config_write_storm_gapstress(seed=1, n_nodes=25600,
   telemetry=True)``, the same at 1024 nodes and seed 0 (the dense
   round under loss), ``config_broadcast_1k`` and
   ``config_ground_truth_3node`` with ``telemetry=True``: each gives its
   goldens above and its telemetry golden (every summary key but
   ``wire_bytes`` exactly; each round's f32 byte channels within
   (m + 1)·2⁻²⁴ of the total for the m terms JAX adds), K17–K19 launch
   (and on no telemetry-off path above); then
   ``config_fault_storm_telemetry(seed=0)``'s per-round plain and
   telemetry milliseconds, printed with the card;
10. profile the first 3 rounds of both storms, the fault storm's
   12-round loss window, 10 partitioned rounds of partition-heal-10k and
   the first 3 rounds of gapstress-25.6k (host wall, device time by
   kernel from ``torch.profiler``, the device's idle share);
11. print the card line, the kernels JSON line, then the one-line result
   ``{"ok": true, "device": {...}}``.

Nothing runs on the CPU: without a card the script exits at once.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
# calls timed of a plain version that takes a tenth of a second or more
SLOW_PLAIN_REPS = 3
# device launches (kernels, copies, fills) of `profile_storm`'s first 3
# rounds with the flight recorder off, setup included, as the port made
# them before the recorder existed: the faultless storm's and the fault
# storm's.  Recording must add nothing to a run that does not record.
STORM_OFF_LAUNCHES = 1526
FAULT_STORM_OFF_LAUNCHES = 1560


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


def _time_ms(fn, reps=REPS) -> float:
    """Device milliseconds per call: after WARMUP eager calls, ``reps``
    calls are captured in one CUDA graph, whose replay is timed with CUDA
    events — the host's launch overhead stays out of the number."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_eager_ms(fn, reps=REPS) -> float:
    """Device milliseconds per call of a function that syncs with the
    host (and so cannot be captured in a graph): CUDA events around
    ``reps`` eager calls after WARMUP, launch overhead included."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    "node_faults_kernel", "sample_uniform_kernel", "dense_inject_kernel",
    "dense_broadcast_kernel", "dense_deliver_kernel", "dense_sync_kernel",
    "dense_gaps_rows_kernel", "dense_gaps_finish_kernel",
    "swim_timeout_kernel", "swim_merge_kernel", "swim_apply_kernel",
    "budget_words_kernel", "sync_pull_metered_kernel",
    "gaps_refresh_wide_kernel", "trace_counts_words_kernel",
    "trace_counts_dense_kernel", "trace_wire_words_kernel",
    "trace_wire_rows_kernel", "trace_row_kernel",
)


def _is_symbol(sym: str, key: str) -> bool:
    """Whether profiler kernel name ``key`` is kernel ``sym`` (not just
    one that ends in it, as dense_deliver_kernel ends in
    deliver_kernel)."""
    return re.search(r"(?<!\w)" + sym + r"\b", key) is not None


def _profile(run, rounds, label, setup=None):
    """Where a run's time goes on the card: ``run()`` (which returns its
    host wall in seconds) once to warm up, once on the host clock, then
    again under torch.profiler for device time by kernel (its own run:
    the profiler slows the host); per round over ``rounds``.  With
    ``setup`` each run is ``run(setup())``, the setup outside the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def args():
        return () if setup is None else (setup(),)

    run(*args())
    wall = run(*args())
    profiled = args()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(*profiled)
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
                  if any(_is_symbol(sym, key) for sym in KERNEL_SYMBOLS))
    # int64 elementwise kernels: the threefry's carriers (and index casts)
    long_us = sum(us for key, us, _ in device if "<long" in key)
    return {
        "run": label,
        "device_kernel_names": len(device),
        "rounds": rounds,
        "wall_ms_per_round": wall / rounds * 1e3,
        "device_ms_per_round": total_us / 1e3 / rounds,
        "idle_share": 1.0 - total_us / 1e6 / wall,
        "port_kernels_ms_per_round": ours_us / 1e3 / rounds,
        "port_kernel_ms_per_round": {
            sym: sum(us for key, us, _ in device
                     if _is_symbol(sym, key)) / 1e3 / rounds
            for sym in KERNEL_SYMBOLS
            if any(_is_symbol(sym, key) for key, _, _ in device)
        },
        "int64_kernels_ms_per_round": long_us / 1e3 / rounds,
        "device_launches_per_round": sum(c for _, _, c in device) / rounds,
        "top": [
            {"kernel": key[:90], "ms_per_round": us / 1e3 / rounds,
             "launches_per_round": count / rounds}
            for key, us, count in device[:10]
        ],
    }


def profile_storm(dev, rounds=3, faults=False, telemetry=False):
    """The first ``rounds`` rounds of the 100k faultless storm, or with
    ``faults`` of the fault storm (inside its loss window); with
    ``telemetry`` the flight recorder on."""
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
            run_fault_plan(state, meta, cfg, Topology(), fplan, rounds,
                           telemetry)
        else:
            run_to_convergence(state, meta, cfg, Topology(), rounds,
                               telemetry)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = "fault storm-100k" if faults else "storm-100k"
    return _profile(run, rounds, label + (" telemetry" if telemetry else ""))


def profile_heal(dev, rounds=10):
    """``rounds`` partitioned dense rounds of partition-heal-10k through
    `round_step_` on an owned state, as `config_partition_heal_10k`
    runs them, after the state is built (setup is outside the clock)."""
    from corrosion_tpu_torch.sim.round import (
        new_metrics, new_sim, own_state, round_step_)
    from corrosion_tpu_torch.sim.runner import heal_config
    from corrosion_tpu_torch.sim.topology import Topology, regions

    n = 10_000
    cfg, meta = heal_config(n, dev)
    topo = Topology(n_regions=2, inter_delay=2)
    region = regions(n, 2, dev)

    def run():
        state = new_sim(cfg, 0, dev)
        state = own_state(state._replace(
            group=(torch.arange(n, device=dev) >= n // 2).to(torch.int32)))
        metrics = new_metrics(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                            region)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, "partition-heal-10k")


def profile_gapstress(dev, rounds=3):
    """The burst's first ``rounds`` rounds of gapstress-25.6k (seed 1):
    every version injected at round 0, both budgets binding, 30 % loss.
    `run_packed`'s loop, with its setup (new_sim, pack_state: ~210 M
    cells) outside the clock and the profiler."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta = _gapstress(GAPSTRESS_N, dev)
    topo = Topology(loss=0.3)
    region = regions(cfg.n_nodes, 1, dev)

    def setup():
        state = new_sim(cfg, 1, dev)
        out = (packed.shrink_state(state), packed.pack_state(state, cfg),
               packed.pack_bits(state.injected), new_metrics(cfg, dev))
        torch.cuda.synchronize()
        return out

    def run(loop):
        slim, carry, inj, metrics = loop
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            slim, carry, inj, metrics, done = packed.packed_round_step(
                slim, carry, inj, metrics, meta, cfg, topo, region)
            bool(done)  # run_packed's one host read a round
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, "gapstress-25.6k", setup)


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


# -- the dense round's kernels: K1's uniform entry, K12-K15 ------------------


def _u8(g, shape, p_one, dev):
    """u8 0/1 cells, each 1 with probability ``p_one``."""
    return torch.as_tensor((g.random(shape) < p_one).astype(np.uint8),
                           device=dev)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _changed_bytes(before, after) -> int:
    """Bytes of the cells an in-place function changed: what it must
    write at least."""
    return sum(int((a != b).sum()) * a.element_size()
               for a, b in zip(before, after))


def _timed(timed, fn, restore=None):
    if not timed:
        return None
    return _time_inplace_ms(fn, restore) if restore else _time_ms(fn)


def _row(name, source, replaces, equal, err, ms, plain_ms, nbytes, **extra):
    """A kernel row bound by the bytes it must move."""
    return dict(name=name, source=source, replaces=replaces, equal=equal,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes", bytes=nbytes,
                **extra)


def compare_sample_uniform(dev, g, n=4096, count=3, timed=True):
    """K1's uniform entry on a churn-shaped draw (N = 4096, the gossip
    fanout 3): self candidates, beliefs with DOWN cells, repeats, rows
    left short; and on the same draw without beliefs (ground truth)."""
    from corrosion_tpu_torch.sim import swim

    over = 4 * count
    me = np.arange(n)[None, :]
    cand = g.integers(0, n, (over, n))
    cand = np.where(g.random((over, n)) < 0.05, me, cand)
    cand[1] = np.where(g.random(n) < 0.3, cand[0], cand[1])  # repeats
    cand_t = torch.as_tensor(cand, dtype=torch.int32, device=dev)
    view = torch.as_tensor(
        np.where(g.random((n, n)) < 0.5, 2, g.integers(0, 2, (n, n))),
        dtype=torch.int8, device=dev)
    got = [swim.sample_uniform(cand_t, v, count) for v in (view, None)]
    want = [swim.sample_uniform_plain(cand_t, v, count) for v in (view, None)]
    equal, err = _equal_all(got, want)
    if not (bool((want[0] == -1).any()) and bool((cand_t == torch.arange(
            n, device=dev)).any())):
        raise AssertionError("K1 uniform inputs leave no row short or draw "
                             "no self candidate")
    return _row(
        "sample_uniform", "corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        "corrosion_tpu/sim/swim.py:59", equal, err,
        _timed(timed, lambda: swim.sample_uniform(cand_t, view, count)),
        _timed(timed, lambda: swim.sample_uniform_plain(cand_t, view, count)),
        # the draws, one belief byte per draw, the output
        cand_t.numel() * 5 + n * count * 4,
    )


def _dense_round_inputs(g, dev, cfg, meta, t):
    """A mid-run dense state at ``cfg``'s shape: half the cells held,
    relay budgets on held cells, the payloads of rounds <= t injected,
    sparse rings, 3% dead nodes, a quarter split."""
    n, p = cfg.n_nodes, cfg.n_payloads
    have = _u8(g, (n, p), 0.5, dev)
    relay = (torch.as_tensor(g.integers(0, cfg.max_transmissions + 1, (n, p)),
                             dtype=torch.uint8, device=dev) * have)
    injected = (meta.round <= t).to(torch.uint8)
    d = cfg.n_delay_slots
    ring = _u8(g, (d, n, p), 0.05, dev)
    sync_ring = _u8(g, (d, n, p), 0.02, dev)
    alive = torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                            device=dev)
    # a split off the region boundary, so both delay classes carry edges
    group = (torch.arange(n, device=dev) >= n // 4).to(torch.int32)
    return have, relay, injected, ring, sync_ring, alive, group


def _dense_round_phases(bc, xs, meta, cfg, targets, dst, slot, ok, key,
                        budget, thr, t, kernel=True):
    """One round's K12 phases on ``xs`` (have, relay, injected, ring,
    sync_ring, alive), in place: the wrappers, or the plain versions."""
    have, relay, injected, ring, sync_ring, alive = xs
    inj = bc.inject_dense if kernel else bc.inject_dense_plain
    send = bc.broadcast_send if kernel else bc.broadcast_send_plain
    dlv = bc.deliver_dense if kernel else bc.deliver_dense_plain
    inj(have, relay, injected, meta, alive, t, cfg.max_transmissions)
    send(have, relay, injected, meta.nbytes, budget, targets, dst, slot, ok,
         alive, key, thr, ring)
    dlv(ring, sync_ring, have, relay, t % ring.shape[0],
        max(cfg.max_transmissions - 1, 1))


def compare_dense_phases(dev, g, n=10_000, timed=True):
    """K12 at partition-heal-10k's shapes (P = 256, F = 3, D = 3, two
    regions, a partition): the path's case (unmetered, lossless) and a
    trap case with a binding byte budget and a loss threshold 0 < 51 <
    256, each a whole round (inject, broadcast, deliver)."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.runner import heal_config
    from corrosion_tpu_torch.sim.topology import (
        Topology, edge_alive, edge_delay, regions)

    cfg, meta = heal_config(n, dev)
    f, t = cfg.fanout, 20
    have, relay, injected, ring, sync_ring, alive, group = \
        _dense_round_inputs(g, dev, cfg, meta, t)
    me = np.arange(n)[:, None]
    tg = np.where(g.random((n, f)) < 0.05, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                              dtype=torch.int32, device=dev)
    topo = Topology(n_regions=2, inter_delay=2)
    region = regions(n, 2, dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(group, alive, src, dst) & (dst != src)
    slot = ((t + edge_delay(topo, region, src, dst)) % cfg.n_delay_slots).to(
        torch.int32)
    key = trng.prng_key(77, dev)
    base = [have, relay, injected, ring, sync_ring, alive]
    budget_trap = 20 * 8192 + 4096
    equal, err, runs = True, 0, {}
    for label, budget, thr in (("path", None, 0), ("trap", budget_trap, 51),
                               ("lossless_trap", budget_trap, 0)):
        outs = []
        for kernel in (True, False):
            xs = [x.clone() for x in base]
            _dense_round_phases(bc, xs, meta, cfg, targets, dst, slot, ok,
                                key, budget, thr, t, kernel)
            outs.append(xs)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        runs[label] = outs[1]
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    if int(eligible.sum(dim=1).max()) * 8192 <= budget_trap:
        raise AssertionError("K12 inputs: the byte budget never binds")
    if _equal_all(runs["trap"], runs["lossless_trap"])[0]:
        raise AssertionError("K12 inputs: the loss drops no payload")
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    def round_(kernel, budget=None, thr=0):
        return lambda: _dense_round_phases(
            bc, work, meta, cfg, targets, dst, slot, ok, key, budget, thr, t,
            kernel)

    e = n * f
    nbytes = (_nbytes(have, relay, injected, meta.nbytes, meta.round,
                      meta.actor, alive, targets, dst, slot, ok)
              + 2 * n * cfg.n_payloads  # the two ring slots deliver reads
              + _changed_bytes(base[:5], runs["path"][:5]))
    # the trap's hashes: one per sending (edge, payload) cell of an ok edge
    sending = eligible.repeat_interleave(f, dim=0) & ok[:, None]
    hashes = int(sending.sum())
    return _row(
        "dense_phases", "corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:32", equal, err,
        _timed(timed, round_(True), restore),
        _timed(timed, round_(False), restore), nbytes,
        trap_ms=_timed(timed, round_(True, budget_trap, 51), restore),
        trap_plain_ms=_timed(timed, round_(False, budget_trap, 51), restore),
        trap_hash_ops=hashes * OPS_PER_HASH, edges=e,
    )


def _advertised(g, dev, cfg, have, t):
    """heads and gap slots as a node advertises them: from a lagging
    copy of its have rows (the bookkeeping of an earlier round)."""
    from corrosion_tpu_torch.sim.round import dense_record_plain, new_metrics

    lag = have & _u8(g, tuple(have.shape), 0.8, have.device)
    meta_round = torch.zeros(cfg.n_payloads, dtype=torch.int32,
                             device=have.device)
    meta = SimpleNamespace(round=meta_round)
    heads, lo, hi, n_over, *_ = dense_record_plain(
        lag, torch.ones(cfg.n_payloads, dtype=torch.uint8, device=dev),
        torch.zeros(cfg.n_nodes, dtype=torch.uint8, device=dev),
        new_metrics(cfg, dev), meta, t, cfg)
    return heads, lo, hi, int(n_over)


def compare_dense_sync(dev, g, n=10_000, timed=True):
    """K13 at partition-heal-10k's shapes (P = 256, A = 4, V = 64, K = 8,
    S = 3): advertised gaps with more than K runs, self and dead peers,
    unmetered (the path) and under a binding sync budget."""
    from corrosion_tpu_torch.sim import sync
    from corrosion_tpu_torch.sim.runner import heal_config

    cfg, meta = heal_config(n, dev)
    s = cfg.sync_peers
    have = _u8(g, (n, cfg.n_payloads), 0.5, dev)
    heads, lo, hi, n_over = _advertised(g, dev, cfg, have, 40)
    if n_over == 0:
        raise AssertionError("K13 inputs: no advertised row has more than "
                             "K gap runs")
    me = np.arange(n)[:, None]
    peers = np.where(g.random((n, s)) < 0.03, me, g.integers(0, n, (n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=dev) & (
        peers != torch.arange(n, device=dev)[:, None])
    slot0 = _u8(g, (n, cfg.n_payloads), 0.01, dev)
    budget_trap = 6 * 8192 + 100
    equal, err, outs = True, 0, {}
    for budget in (None, budget_trap):
        got_slot, want_slot = slot0.clone(), slot0.clone()
        got = sync.sync_pull_dense(have, heads, lo, hi, peers, ok, meta.nbytes,
                                   budget, got_slot, cfg)
        want = sync.sync_pull_dense_plain(have, heads, lo, hi, peers, ok,
                                          meta.nbytes, budget, want_slot, cfg)
        e, x = _equal_all([got, got_slot], [want, want_slot])
        equal, err = equal and e, max(err, x)
        outs[budget] = want_slot
    if torch.equal(outs[None], outs[budget_trap]):
        raise AssertionError("K13 inputs: the sync budget never binds")
    work = slot0.clone()

    def restore():
        work.copy_(slot0)

    nbytes = (_nbytes(have, heads, lo, hi, peers, ok, meta.nbytes)
              + _changed_bytes([slot0], [outs[None]]) + n)
    return _row(
        "dense_sync", "corrosion_tpu_torch/kernels/csrc/dense_sync.cu",
        "corrosion_tpu/sim/sync.py:122", equal, err,
        _timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, ok, meta.nbytes, None, work, cfg),
            restore),
        _timed(timed, lambda: sync.sync_pull_dense_plain(
            have, heads, lo, hi, peers, ok, meta.nbytes, None, work, cfg),
            restore),
        nbytes,
        trap_ms=_timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, ok, meta.nbytes, budget_trap, work,
            cfg), restore),
    )


def _dense_record_cases(g, dev, cfg, meta, p_one=0.5):
    """K14's cases: holes (each chunk held with probability ``p_one``:
    runs past K, dead rows, stamps set and unset) mid-injection, then
    every cell held after the last injection (node stamps and the done
    flag), and the same with one up row short."""
    from corrosion_tpu_torch.sim.round import RunMetrics

    n, p = cfg.n_nodes, cfg.n_payloads
    last = int(meta.round.max())
    alive = torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                            device=dev)
    metrics = RunMetrics(
        coverage_at=torch.as_tensor(np.where(g.random(p) < 0.2, 2, -1),
                                    dtype=torch.int32, device=dev),
        converged_at=torch.as_tensor(np.where(g.random(n) < 0.2, 3, -1),
                                     dtype=torch.int32, device=dev),
        overflow_frac=torch.zeros((), device=dev),
        order_violations=torch.zeros((), dtype=torch.int32, device=dev),
    )
    holes = _u8(g, (n, p), p_one, dev)
    full = torch.ones((n, p), dtype=torch.uint8, device=dev)
    short = full.clone()
    short[int(np.flatnonzero(alive.cpu().numpy() == 0)[0]), 0] = 0
    inj_mid = (meta.round <= last // 2).to(torch.uint8)
    inj_all = torch.ones(p, dtype=torch.uint8, device=dev)
    return [(holes, inj_mid, alive, metrics, meta, last // 2, cfg),
            (full, inj_all, alive, metrics, meta, last + 2, cfg),
            (short, inj_all, alive, metrics, meta, last + 2, cfg)]


def compare_dense_gaps(dev, g, n=10_000, n_writers=4, n_payloads=256,
                       timed=True, name="dense_gaps", gap_slots=8,
                       chunks=1, p_one=0.5):
    """K14 at partition-heal-10k's shapes (A = 4, V = 64, K = 8: JAX's
    dense branch), broadcast-1k's (A = 8, V = 32: its word branch) or the
    gapstress distortion control's (A = 8, V = 128, C = 8, K = 64: more
    than 32 runs in a row, past the register cap K14 had)."""
    from corrosion_tpu_torch.sim.round import dense_record, dense_record_plain
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    cfg = SimConfig(n_nodes=n, n_payloads=n_payloads, n_writers=n_writers,
                    chunks_per_version=chunks, gap_slots=gap_slots)
    meta = uniform_payloads(cfg, dev, inject_every=1)
    cases = _dense_record_cases(g, dev, cfg, meta, p_one)
    equal, err, dones = True, 0, []
    for args in cases:
        got, want = dense_record(*args), dense_record_plain(*args)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        dones.append(bool(want[6]))
        if args is not cases[0]:
            continue
        if gap_slots <= 32 and int(want[3]) == 0:
            raise AssertionError("K14 inputs overflow no row")
        if gap_slots > 32 and not bool((want[1][..., 32] > 0).any()):
            raise AssertionError("K14 inputs fill no slot past 32")
    if dones != [False, True, False]:
        raise AssertionError("K14 inputs do not reach both done values")
    args = cases[0]
    a, k = cfg.n_writers, cfg.gap_slots
    p = cfg.n_payloads
    nbytes = (n * p + p + n + p * 4 + n * 4 * 2 + p * 4 * 2
              + n * a * 4 * (1 + 2 * k) + 4 + 1)
    return _row(
        name, "corrosion_tpu_torch/kernels/csrc/dense_gaps.cu",
        "corrosion_tpu/sim/gaps.py:64", equal, err,
        _timed(timed, lambda: dense_record(*args)),
        _timed(timed, lambda: dense_record_plain(*args)), nbytes,
        n_versions=cfg.n_versions,
    )


def _swim_passes(sw, xs, gdst, g_ok, f, ann_target, ann_claim, up,
                 heard_down, fb_inc, t, timeout, kernel=True):
    """K15's three passes on ``xs`` (view, vinc, since, incarnation) in
    place, with the gossip receiver filter between them as swim_step
    has it; returns the belief keys, the merged keys and the new
    incarnations."""
    view, vinc, since, inc = xs
    if kernel:
        timeout_, merge, apply_ = (sw.swim_timeout_, sw.swim_merge,
                                   sw.swim_apply_)
    else:
        timeout_, merge, apply_ = (sw.swim_timeout_plain, sw.swim_merge_plain,
                                   sw.swim_apply_plain)
    key = timeout_(view, vinc, since, t, timeout)
    n = view.shape[0]
    gsrc = torch.arange(n, device=view.device).repeat_interleave(f)
    ok = g_ok & (view[gdst.long(), gsrc] != 2)
    merged = merge(key, gdst, ok, f, ann_target, ann_claim)
    return key, merged, apply_(view, vinc, since, key, merged, inc, up,
                               heard_down, fb_inc, t)


def compare_swim_full(dev, g, n=4096, f=3, timed=True):
    """K15 at churn-full-4096's shapes (N = 4096, F = 3): SUSPECT cells
    past the timeout, DOWN receivers, announce claims, refuting nodes."""
    from corrosion_tpu_torch.sim import swim as sw

    t, timeout = 40, 13
    view = torch.as_tensor(g.choice(3, (n, n), p=[0.8, 0.1, 0.1]),
                           dtype=torch.int8, device=dev)
    vinc = torch.as_tensor(g.integers(0, 6, (n, n)), dtype=torch.int32,
                           device=dev)
    since = torch.as_tensor(np.where(g.random((n, n)) < 0.5,
                                     g.integers(0, t + 1, (n, n)), -1),
                            dtype=torch.int32, device=dev)
    inc = torch.as_tensor(g.integers(0, 6, n), dtype=torch.int32, device=dev)
    gdst = torch.as_tensor(g.integers(0, n, n * f), dtype=torch.int32,
                           device=dev)
    g_ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    ann_target = torch.as_tensor(g.integers(0, n, n), dtype=torch.int32,
                                 device=dev)
    ann_claim = torch.where(torch.as_tensor(g.random(n) < 0.3, device=dev),
                            inc * 4, -1).to(torch.int32)
    up = torch.as_tensor(g.random(n) < 0.95, device=dev)
    heard_down = torch.as_tensor(g.random(n) < 0.05, device=dev)
    fb_inc = torch.as_tensor(np.where(g.random(n) < 0.05,
                                      g.integers(0, 8, n), -1),
                             dtype=torch.int32, device=dev)
    base = [view, vinc, since, inc]
    args = (gdst, g_ok, f, ann_target, ann_claim, up, heard_down, fb_inc, t,
            timeout)
    outs = []
    for kernel in (True, False):
        xs = [x.clone() for x in base]
        res = _swim_passes(sw, xs, *args, kernel=kernel)
        outs.append(list(res) + xs)
    equal, err = _equal_all(outs[0], outs[1])
    key, merged, new_inc, v_after = outs[1][:4]
    expired = (view == 1) & (since >= 0) & (t - since >= timeout)
    if not (bool(expired.any()) and bool((new_inc != inc).any())
            and bool((merged > key).any()) and bool((v_after == 2).any())):
        raise AssertionError("K15 inputs time out, refute or merge nothing")
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    # swim_step's belief update reads view, vinc and since once and
    # writes the cells it changes; the belief keys and the merged
    # buffer are the passes' own and do not count
    cells = n * n
    nbytes = (cells * (1 + 4 + 4)  # view, vinc, since
              + n * f * 5  # gossip edges: gdst, g_ok
              + n * 4 * 4 + n * 2  # ann_target, ann_claim, inc, fb_inc;
              # up, heard_down
              + _changed_bytes(base, outs[1][3:]))
    return _row(
        "swim_full", "corrosion_tpu_torch/kernels/csrc/swim_full.cu",
        "corrosion_tpu/sim/swim.py:185", equal, err,
        _timed(timed, lambda: _swim_passes(sw, work, *args), restore),
        _timed(timed, lambda: _swim_passes(sw, work, *args, kernel=False),
               restore),
        nbytes,
    )


def compare_dense_kernels(dev, seed=1):
    """Phase 3b: K1's uniform entry and K12-K15 against their plain
    versions at the dense paths' shapes."""
    g = np.random.default_rng(seed)
    rows = [
        compare_sample_uniform(dev, g),
        compare_dense_phases(dev, g),
        compare_dense_sync(dev, g),
        compare_dense_gaps(dev, g),
        compare_swim_full(dev, g),
    ]
    # broadcast-1k's shapes: K1 without beliefs is checked above on the
    # churn draw; K14 at V = 32 (JAX's word branch) is checked here
    word = compare_dense_gaps(dev, g, n=1000, n_writers=8, timed=False,
                              name="dense_gaps_v32")
    rows[3]["equal"] = rows[3]["equal"] and word["equal"]
    rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"], word["max_abs_err"])
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the gapstress storm's kernels: K16, K3's metered entry, K10's topology
# stream, K6 past 32 versions, and K14 at K = 64 ----------------------------

GAPSTRESS_N = 25_600


def _gapstress(n, dev, gap_slots=8):
    """The gapstress config and payloads (sizes 1 B - 8 KiB)."""
    from corrosion_tpu_torch.sim.runner import (
        _gapstress_cfg, gapstress_payload_sizes)
    from corrosion_tpu_torch.sim.state import uniform_payloads

    cfg = _gapstress_cfg(n, gap_slots)
    meta = uniform_payloads(cfg, dev, inject_every=0,
                            payload_bytes=gapstress_payload_sizes(
                                cfg.n_payloads))
    return cfg, meta


def compare_budget_words(dev, g, n=GAPSTRESS_N, timed=True):
    """K16 on the broadcast governor's rows (N x W = 256 over the
    gapstress sizes, half the bits set: about 9.5 MB a row) under its
    5 MiB budget and a budget of 1, with empty rows; and on 64 rows of
    P = 65 536 (JAX's two-lane branch) under 9 MB."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes

    cfg, meta = _gapstress(n, dev)
    w = cfg.n_payloads // 32
    elig = _random_words(g, (n, w), dev)
    elig[::97] = 0
    big_p = 65_536
    big_sizes = torch.as_tensor(gapstress_payload_sizes(big_p), device=dev)
    cases = [(elig, cfg.rate_limit_bytes_round, meta.nbytes),
             (elig, 1, meta.nbytes),
             (_random_words(g, (64, big_p // 32), dev), 9_000_000,
              big_sizes)]
    equal, err, outs = True, 0, []
    for words, budget, sizes in cases:
        got = packed.budget_prefix_words(words, budget, sizes)
        want = packed.budget_prefix_words_plain(words, budget, sizes)
        e, x = _equal_all([got], [want])
        equal, err = equal and e, max(err, x)
        outs.append(want)
    for (words, _, _), want in zip(cases, outs):
        if torch.equal(words, want) or not bool(want.any()):
            raise AssertionError("K16 inputs: a budget keeps all or nothing")
    budget = cfg.rate_limit_bytes_round
    return _row(
        "budget_words", "corrosion_tpu_torch/kernels/csrc/budget_words.cu",
        "corrosion_tpu/sim/packed.py:102", equal, err,
        _timed(timed, lambda: packed.budget_prefix_words(elig, budget,
                                                         meta.nbytes)),
        _timed(timed, lambda: packed.budget_prefix_words_plain(
            elig, budget, meta.nbytes)),
        # the rows in and out, the sizes
        _nbytes(elig, meta.nbytes) + elig.numel() * 4,
        kernel="budget_words",
    )


def compare_sync_pull_metered(dev, g, n=GAPSTRESS_N, timed=True):
    """K3's metered entry at gapstress's shapes (W = 256, S = 3) under the
    4 MiB grant (it binds: each edge needs megabytes) and a grant of 1
    (edges with a need that pull nothing, so fruitful falls), with self
    and dead peers and words that carry bit 31."""
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _gapstress(n, dev)
    w, s = cfg.n_payloads // 32, cfg.sync_peers
    masks = _random_words(g, (n, 4, w), dev)
    # even rows serve (7 bits in 8 held), odd rows lag (1 in 8), so a
    # lagging puller needs most of a serving peer's megabytes
    serving = ~_random_words(g, (n, w), dev, 3)
    lagging = _random_words(g, (n, w), dev, 3)
    masks[:, 3] = torch.where(torch.arange(n, device=dev)[:, None] % 2 == 0,
                              serving, lagging)
    miss = _random_words(g, (n, w), dev, 2)
    me = np.arange(n)[:, None]
    peers = np.where(g.random((n, s)) < 0.03, me,
                     2 * g.integers(0, n // 2, (n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=dev)
    buf0 = torch.zeros((n, w), dtype=torch.int32, device=dev)
    grant = cfg.sync_budget_bytes
    equal, err, outs = True, 0, {}
    for budget in (None, grant, 1):
        got_buf, want_buf = buf0.clone(), buf0.clone()
        want = packed.sync_pull_plain(masks, miss, peers, ok, want_buf,
                                      budget, meta.nbytes)
        outs[budget] = (want, want_buf)
        if budget is None:
            continue
        got = packed.sync_pull(masks, miss, peers, ok, got_buf, budget,
                               meta.nbytes)
        e, x = _equal_all([got, got_buf], [want, want_buf])
        equal, err = equal and e, max(err, x)
    if torch.equal(outs[None][1], outs[grant][1]):
        raise AssertionError("K3 metered inputs: the grant never binds")
    if not bool((outs[None][0] & ~outs[1][0]).any()):
        raise AssertionError("K3 metered inputs: no need is granted nothing")
    if not bool((outs[grant][1] < 0).any()):
        raise AssertionError("K3 metered inputs pull no word with bit 31")
    work = buf0.clone()

    def restore():
        work.zero_()

    return _row(
        "sync_pull_metered", "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        "corrosion_tpu/sim/packed.py:1238", equal, err,
        _timed(timed, lambda: packed.sync_pull(
            masks, miss, peers, ok, work, grant, meta.nbytes), restore),
        _timed(timed, lambda: packed.sync_pull_plain(
            masks, miss, peers, ok, work, grant, meta.nbytes), restore),
        # masks, miss, peers and ok once, the slot in and out, fruitful,
        # the sizes
        _nbytes(masks, miss, peers, ok, meta.nbytes) + n * w * 4 * 2 + n,
        kernel="sync_pull_metered",
    )


def compare_scatter_topo(dev, g, n=GAPSTRESS_N, timed=True):
    """K10 at gapstress's shapes (E = 3N, W = 256, D = 4): the topology
    stream alone at round(0.3 * 256) = 77 (the path), the fault stream
    alone, both at once, and a severed channel (256) with and without
    fault loss."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import loss_threshold

    cfg, _ = _gapstress(n, dev)
    w, f, d = cfg.n_payloads // 32, cfg.fanout, cfg.n_delay_slots
    e = n * f
    sending = _random_words(g, (n, w), dev, 4)
    dst = torch.as_tensor(g.integers(0, n, e), dtype=torch.int32, device=dev)
    slot = torch.as_tensor(g.integers(0, d, e), dtype=torch.int32,
                           device=dev)
    ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
    thr = torch.as_tensor(np.where(g.random(e) < 0.3, 0,
                                   g.integers(1, 80, e)),
                          dtype=torch.uint8, device=dev)
    key, topo_key = trng.prng_key(5, dev), trng.prng_key(6, dev)
    topo_thr = loss_threshold(0.3)
    ring0 = _random_words(g, (d, n, w), dev, 6)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    cases = {"topology": (None, topo_thr), "fault": (thr, 0),
             "both": (thr, topo_thr), "severed": (None, 256),
             "severed_fault": (thr, 256)}
    equal, err, outs = True, 0, {}
    for name, (t, tt) in cases.items():
        got, want = ring0.clone(), ring0.clone()
        args = (sending, dst, slot, ok, t, key, 11, f, tt, topo_key)
        packed.scatter_sending_lossy(got, *args)
        packed.scatter_sending_lossy_plain(want, *args)
        e_, x = _equal_all([got], [want])
        equal, err = equal and e_, max(err, x)
        outs[name] = want
    if any(torch.equal(outs[k], lossless)
           for k in ("topology", "fault", "both")):
        raise AssertionError("K10 inputs: a lossy stream drops nothing")
    if (torch.equal(outs["both"], outs["topology"])
            or torch.equal(outs["both"], outs["fault"])):
        raise AssertionError("K10 inputs: the two streams do not compose")
    if not (torch.equal(outs["severed"], ring0)
            and torch.equal(outs["severed_fault"], ring0)):
        raise AssertionError("K10: a severed channel let a payload through")
    live = (sending.repeat_interleave(f, dim=0) != 0) & ok[:, None]
    hashes = int(live.sum()) * 8
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    nbytes = sending.numel() * 4 + e * 9 + rows_touched * w * 4 * 2
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    args = (sending, dst, slot, ok, None, key, 11, f, topo_thr, topo_key)
    return dict(
        name="broadcast_scatter_lossy_topo",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/topology.py:267",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: packed.scatter_sending_lossy(ring_k, *args)),
        # the plain version finds its pairs with a host sync: eager, and
        # at ~0.3 s a call, few of them
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, *args), SLOW_PLAIN_REPS) if timed else None,
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes",
        ops=ops, hashes=hashes, bytes=nbytes,
        kernel="broadcast_scatter_lossy",
    )


def compare_gaps_wide(dev, g, n=GAPSTRESS_N, timed=True):
    """K6 past 32 versions at gapstress's shapes (A = 8, V = 128, C = 8,
    K = 8; one chunk bit in 16 set, so 40 % of versions touched: many
    runs, overflow, runs across version-word edges, heads at 32j, empty
    rows) and at V = 40, not a multiple of 32."""
    from corrosion_tpu_torch.sim import gaps

    cfg, _ = _gapstress(n, dev)
    w = cfg.n_payloads // 32
    have = _random_words(g, (n, w), dev, 4)
    have[::101] = 0
    # rows that hold no version past 32, 64 or 96 (a version is 64 bits,
    # two words): their heads land on 32j where that version is touched
    for i, words in enumerate((64, 128, 192)):
        have[i::21, words:] = 0
    narrow = dataclasses.replace(cfg, n_payloads=40 * 64)
    cases = [(have, cfg), (have[:, :narrow.n_payloads // 32].contiguous(),
                           narrow)]
    equal, err = True, 0
    for words, c in cases:
        got = gaps.refresh_gaps(words, c)
        want = gaps.refresh_gaps_plain(words, c)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        heads, lo, hi, n_over = want
        crosses = (lo > 0) & ((lo - 1) // 32 != (hi - 1) // 32)
        if not (int(n_over) > 0 and bool(crosses.any())
                and bool(((heads % 32 == 0) & (heads > 0)).any())
                and bool((heads == 0).any())):
            raise AssertionError(f"K6 inputs at V = {c.n_versions} miss "
                                 "an overflow, a run across a word edge, "
                                 "a head at 32j or an empty row")
    a, k = cfg.n_writers, cfg.gap_slots
    return _row(
        "gaps_refresh_v128",
        "corrosion_tpu_torch/kernels/csrc/gaps_refresh.cu",
        "corrosion_tpu/sim/gaps.py:64", equal, err,
        _timed(timed, lambda: gaps.refresh_gaps(have, cfg)),
        _timed(timed, lambda: gaps.refresh_gaps_plain(have, cfg)),
        # the have words in; heads, lo, hi and the count out
        n * w * 4 + n * a * 4 + 2 * n * a * k * 4 + 4,
        kernel="gaps_refresh",
    )


def compare_gapstress_kernels(dev, seed=2):
    """Phase 3c: K16, K3's metered entry, K10's topology stream and K6
    past 32 versions at gapstress-25.6k's shapes, and K14 at the
    distortion control's (N = 1024, V = 128, C = 8, K = 64)."""
    g = np.random.default_rng(seed)
    rows = [
        compare_budget_words(dev, g),
        compare_sync_pull_metered(dev, g),
        compare_scatter_topo(dev, g),
        compare_gaps_wide(dev, g),
        compare_dense_gaps(dev, g, n=1024, n_writers=8, n_payloads=8192,
                           chunks=8, gap_slots=64, p_one=0.083,
                           name="dense_gaps_k64"),
    ]
    rows[-1]["kernel"] = "dense_gaps"
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the flight recorder: K17-K19 and the telemetry outputs of K3, K9,
# K10, K12 and K13 ---------------------------------------------------------

STORM_N = 100_000
DENSE_GAPSTRESS_N = 1024
_TRACE_SRC = "corrosion_tpu_torch/kernels/csrc/"


def _acc(dev):
    """A zeroed int64 accumulator, as a trace's slots are."""
    return torch.zeros((), dtype=torch.int64, device=dev)


def _alive(g, n, dev):
    return torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                           device=dev)


def compare_trace_counts(dev, g, n, w, e, label="", timed=True):
    """K17's grant and coverage entries as a round runs them: the
    per-payload counts of [E, W] granted words, and the coverage (up
    rows) and delivered (held now, not at round start) counts of [N, W]
    have words, with words that carry bit 31, added to a count row."""
    from corrosion_tpu_torch.sim import fused, telemetry

    p = w * 32
    granted = _random_words(g, (e, w), dev, 2)
    have = _random_words(g, (n, w), dev)
    have0 = have & _random_words(g, (n, w), dev)
    alive = _alive(g, n, dev)
    if not (bool((granted < 0).any()) and bool((have < 0).any())):
        raise AssertionError("K17 inputs carry no word with bit 31")

    def kernel(out):
        telemetry.count_words_(out[2], granted)
        telemetry.coverage_delivered_(out[0:2], have, have0, alive)

    def plain(out):
        out[2] += fused.word_bit_counts(granted, p)
        cov, dlv = telemetry.word_coverage_delivered(have, have0, alive == 0,
                                                     p)
        out[0] += cov
        out[1] += dlv

    got = torch.full((3, p), 7, dtype=torch.int32, device=dev)
    want = got.clone()
    kernel(got)
    plain(want)
    work = torch.zeros_like(got)
    return _row(
        f"trace_counts{label}", _TRACE_SRC + "trace_counts.cu",
        "corrosion_tpu/sim/fused.py:109", bool(torch.equal(got, want)),
        _max_abs_err(got, want), _timed(timed, lambda: kernel(work)),
        _timed(timed, lambda: plain(work)),
        # the words in, the three count rows in and out
        _nbytes(granted, have, have0, alive) + 2 * 3 * p * 4,
        kernel="trace_counts",
    )


def compare_trace_counts_dense(dev, g, n=DENSE_GAPSTRESS_N, p=8192,
                               timed=True):
    """K17's dense entry at gapstress-1024's shape (u8 [N, P])."""
    from corrosion_tpu_torch.sim import telemetry

    have = _u8(g, (n, p), 0.5, dev)
    have0 = have & _u8(g, (n, p), 0.7, dev)
    alive = _alive(g, n, dev)

    def kernel(out):
        telemetry.coverage_delivered_dense_(out, have, have0, alive)

    def plain(out):
        cov, dlv = telemetry.coverage_delivered_dense_plain(have, have0,
                                                            alive)
        out[0] += cov
        out[1] += dlv

    got = torch.full((2, p), 3, dtype=torch.int32, device=dev)
    want = got.clone()
    kernel(got)
    plain(want)
    work = torch.zeros_like(got)
    return _row(
        "trace_counts_dense", _TRACE_SRC + "trace_counts.cu",
        "corrosion_tpu/sim/telemetry.py:290", bool(torch.equal(got, want)),
        _max_abs_err(got, want), _timed(timed, lambda: kernel(work)),
        _timed(timed, lambda: plain(work)),
        _nbytes(have, have0, alive) + 2 * 2 * p * 4,
        kernel="trace_counts_dense",
    )


def compare_trace_wire(dev, g, n, w, f, nbytes, label="", timed=True):
    """K18's words entry: the frames and bytes of [N, W] sending words on
    the ok edges, added to the int64 accumulators; the byte total passes
    2^31."""
    from corrosion_tpu_torch.sim import telemetry

    sending = _random_words(g, (n, w), dev, 3)
    ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    want_f, want_b = telemetry.wire_words_plain(sending, nbytes, ok, f)
    if int(want_b) < 1 << 31:
        raise AssertionError("K18 inputs: the byte total fits 32 bits")
    got = torch.tensor([5, 1 << 40], dtype=torch.int64, device=dev)
    want = got + torch.stack([want_f, want_b])
    telemetry.wire_words_(got, sending, nbytes, ok, f)
    work = torch.zeros(2, dtype=torch.int64, device=dev)

    def plain():
        fr, by = telemetry.wire_words_plain(sending, nbytes, ok, f)
        work[0] += fr
        work[1] += by

    return _row(
        f"trace_wire{label}", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:192", bool(torch.equal(got, want)),
        _max_abs_err(got, want),
        _timed(timed, lambda: telemetry.wire_words_(work, sending, nbytes, ok,
                                                    f)),
        _timed(timed, plain), _nbytes(sending, nbytes, ok) + 2 * 8,
        kernel="trace_wire",
    )


def compare_trace_wire_rows(dev, g, n=DENSE_GAPSTRESS_N, f=3, timed=True):
    """K18's rows entry at gapstress-1024's shape: K12's per-node frames
    and bytes folded over the ok edges."""
    from corrosion_tpu_torch.sim import fused, telemetry

    frames = torch.as_tensor(g.integers(0, 8193, n), dtype=torch.int32,
                             device=dev)
    byte_tot = torch.as_tensor(g.integers(0, 1 << 26, n), dtype=torch.int32,
                               device=dev)
    ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    got = torch.zeros(2, dtype=torch.int64, device=dev)
    telemetry.wire_rows_(got, frames, byte_tot, ok, f)
    want = torch.stack(fused.fold_over_edges(frames, byte_tot, ok, f))
    if int(want[1]) < 1 << 31:
        raise AssertionError("K18 rows inputs: the byte total fits 32 bits")
    work = torch.zeros(2, dtype=torch.int64, device=dev)

    def plain():
        fr, by = fused.fold_over_edges(frames, byte_tot, ok, f)
        work[0] += fr
        work[1] += by

    return _row(
        "trace_wire_rows", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:225", bool(torch.equal(got, want)),
        _max_abs_err(got, want),
        _timed(timed, lambda: telemetry.wire_rows_(work, frames, byte_tot, ok,
                                                   f)),
        _timed(timed, plain), _nbytes(frames, byte_tot, ok) + 2 * 8,
        kernel="trace_wire_rows",
    )


def _trace_row_case(g, dev, n, p, nbytes, swim, faults, every=1,
                    rounds=40, m=64):
    """A trace mid-run and the rest of a row's inputs: accumulators that
    pass 2^31 bytes, count rows, a member table (partial view) or beliefs
    (full view), a fault slice, session and overflow totals."""
    from corrosion_tpu_torch.sim import telemetry
    from corrosion_tpu_torch.sim.state import SimConfig

    kw = ({"swim_partial_view": True, "member_slots": m} if swim == "partial"
          else {"swim_full_view": True} if swim == "full" else {})
    cfg = SimConfig(n_nodes=n, n_payloads=p, trace_every=every, **kw)
    trace = telemetry.new_trace(cfg, rounds, dev)
    for name in telemetry.CHANNELS:
        t = getattr(trace, name)
        t.copy_(torch.as_tensor(g.integers(0, 99, tuple(t.shape)),
                                dtype=t.dtype, device=dev))
    trace.acc[:5] = torch.as_tensor(
        [g.integers(0, 1 << 31), (1 << 36) + int(g.integers(0, 1 << 20)),
         g.integers(0, 1 << 30), g.integers(0, 1 << 20),
         g.integers(0, 1 << 20)], dtype=torch.int64, device=dev)
    trace.counts.copy_(torch.as_tensor(g.integers(0, 3 * n, (3, p)),
                                       dtype=torch.int32, device=dev))
    state = SimpleNamespace(pid=None, pkey=None, view=None)
    if swim == "partial":
        pid, pkey, _ = _random_tables(g, n, m, 40)
        state.pid = torch.as_tensor(pid, dtype=torch.int32, device=dev)
        state.pkey = torch.as_tensor(pkey, dtype=torch.int32, device=dev)
    elif swim == "full":
        state.view = torch.as_tensor(g.integers(-1, 3, (n, n)),
                                     dtype=torch.int8, device=dev)
    rf = None
    if faults:
        rf = SimpleNamespace(
            alive=torch.as_tensor(g.integers(-1, 3, n), dtype=torch.int8,
                                  device=dev),
            wipe=torch.as_tensor(g.random(n) < 0.01, device=dev))
    kw = dict(alive=_alive(g, n, dev), state=state, cfg=cfg, rf=rf,
              sync_ok=torch.as_tensor(g.random(3 * n) < 0.3, device=dev),
              n_overflow=torch.tensor(int(g.integers(0, n)),
                                      dtype=torch.int32, device=dev),
              nbytes=nbytes)
    return trace, kw


def _clone_trace(trace):
    return type(trace)(*(t.clone() for t in trace))


def compare_trace_row(dev, g, n, p, nbytes, label="", timed=True):
    """K19 writing a row of a partial-view fault run (row 7), the scratch
    row of a decimated one, and a full-view row, each against the plain
    version on copies of the same trace: every channel, and the
    accumulators zeroed."""
    from corrosion_tpu_torch.sim import telemetry

    cases = [("partial", True, 1, 7), ("partial", True, 3, 8)]
    if not label:
        cases.append(("full", False, 1, 3))
    equal, err, timed_case = True, 0, None
    for swim, faults, every, t in cases:
        nn = 4096 if swim == "full" else n
        base, kw = _trace_row_case(g, dev, nn, p, nbytes, swim, faults,
                                   every)
        row = telemetry.trace_row(base, t, every)
        got, want = _clone_trace(base), _clone_trace(base)
        telemetry.record_row(got, row, **kw)
        telemetry.record_row_plain(want, row, **kw)
        e, x = _equal_all(list(got), list(want))
        equal, err = equal and e, max(err, x)
        if bool(got.acc.any()) or bool(got.counts.any()):
            raise AssertionError("K19 left an accumulator set")
        timed_case = timed_case or (base, kw)  # the first: row 7, faults
    work = _clone_trace(timed_case[0])
    kw = timed_case[1]
    m = kw["state"].pid.shape[1]
    return _row(
        f"trace_row{label}", _TRACE_SRC + "trace_row.cu",
        "corrosion_tpu/sim/telemetry.py:202", equal, err,
        _timed(timed, lambda: telemetry.record_row(work, 7, **kw)),
        _timed(timed, lambda: telemetry.record_row_plain(work, 7, **kw)),
        # alive, the member table, the fault slice, the sessions, the
        # sizes and count rows in; the row, the zeroed rows and totals out
        n * (1 + 8 * m + 2 + 3) + p * 4 * (1 + 3 + 3 + 2) + 12 * 8 * 2 + 64,
        kernel="trace_row",
    )


def compare_trace_outputs(dev, g, timed=True, n=STORM_N,
                          n_gs=GAPSTRESS_N, n_dense=DENSE_GAPSTRESS_N):
    """The telemetry outputs of kernels already ported, each launch with
    its output against the plain version with it: K3's granted words at
    the storm's shapes and its metered entry's at gapstress's, K9's cut
    and refused counts and K10's dropped frames at the fault storm's
    round 5, K10's dropped frames under gapstress's topology stream, and
    K12's per-node frames, bytes and dropped frames and K13's grant
    counts at gapstress-1024's dense shape."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import faults, packed, sync
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import loss_threshold

    rows = []

    # K3 and its metered entry: the granted words
    for label, nn, w, budget, kern in (
            ("sync_pull_granted", n, 16, None, "sync_pull"),
            ("sync_pull_metered_granted", n_gs, 256, 4 * 1024 * 1024,
             "sync_pull_metered")):
        cfg, meta = (_storm_cfg(nn, dev) if budget is None
                     else _gapstress(nn, dev))
        s = 3
        masks = _random_words(g, (nn, 4, w), dev)
        miss = _random_words(g, (nn, w), dev, 2)
        peers = torch.as_tensor(g.integers(0, nn, (nn, s)), dtype=torch.int32,
                                device=dev)
        ok = torch.as_tensor(g.random((nn, s)) < 0.7, device=dev)
        outs = []
        for fn in (packed.sync_pull, packed.sync_pull_plain):
            buf = torch.zeros((nn, w), dtype=torch.int32, device=dev)
            granted = torch.full((nn * s, w), -1, dtype=torch.int32,
                                 device=dev)
            fr = fn(masks, miss, peers, ok, buf, budget, meta.nbytes, granted)
            outs.append([fr, buf, granted])
        e, x = _equal_all(outs[0], outs[1])
        if not bool((outs[1][2] < 0).any()):
            raise AssertionError(f"{label} inputs grant no word with bit 31")
        work = torch.zeros((nn, w), dtype=torch.int32, device=dev)
        granted = torch.empty((nn * s, w), dtype=torch.int32, device=dev)
        rows.append(_row(
            label, _TRACE_SRC + "sync_pull.cu",
            "corrosion_tpu/sim/packed.py:1238", e, x,
            _timed(timed, lambda: packed.sync_pull(
                masks, miss, peers, ok, work, budget, meta.nbytes, granted)),
            # the metered plain version takes ~0.08 s a call: few calls
            _time_ms(lambda: packed.sync_pull_plain(
                masks, miss, peers, ok, work, budget, meta.nbytes, granted),
                REPS if budget is None else SLOW_PLAIN_REPS)
            if timed else None,
            _nbytes(masks, miss, peers, ok, meta.nbytes, granted)
            + nn * w * 4 * 2 + nn, kernel=kern))

    # K9's counts and K10's dropped frames at the fault storm's round 5
    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    f, w = cfg.fanout, cfg.n_payloads // 32
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.as_tensor(g.integers(0, n, n * f), dtype=torch.int32,
                          device=dev)
    ok0 = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    counts = []
    for kernel in (True, False):
        ok_w, ok_s, cut, refused = (ok0.clone(), ok0.clone(), _acc(dev),
                                    _acc(dev))
        if kernel:
            _, thr = faults.fault_wire_effects(rf, src, dst, ok_w, cut)
            faults.fault_session_refused(rf, src, dst, ok_s, refused)
        else:
            blk = faults._block_plain(rf, src, dst)
            cut += (ok_w & blk).sum()
            ok_w &= ~blk
            thr = faults._loss_plain(rf, src, dst)
            ref = blk | faults._block_plain(rf, dst, src)
            refused += (ok_s & ref).sum()
            ok_s &= ~ref
        counts.append([ok_w, ok_s, cut, refused, thr])
    e9, x9 = _equal_all(counts[0], counts[1])
    if int(counts[1][2]) == 0 or int(counts[1][3]) == 0:
        raise AssertionError("K9 count inputs cut and refuse nothing")

    def k9(kernel):
        ok_w, ok_s, cut, refused = (ok0.clone(), ok0.clone(), _acc(dev),
                                    _acc(dev))
        if kernel:
            faults.fault_wire_effects(rf, src, dst, ok_w, cut)
            faults.fault_session_refused(rf, src, dst, ok_s, refused)
        else:
            blk = faults._block_plain(rf, src, dst)
            cut += (ok_w & blk).sum()
            ref = blk | faults._block_plain(rf, dst, src)
            refused += (ok_s & ref).sum()

    rows.append(_row(
        "fault_edges_counts", _TRACE_SRC + "fault_edges.cu",
        "corrosion_tpu/sim/faults.py:260", e9, x9,
        _timed(timed, lambda: k9(True)), _timed(timed, lambda: k9(False)),
        # two edge lists, the masks, ok in and out twice, thr, the counts
        n * f * (8 + 4 + 1) + 4 * n * 2 + 16, kernel="fault_edges"))

    ok_w, thr = counts[1][0], counts[1][4]
    key = trng.prng_key(99, dev)
    gs_cfg, _ = _gapstress(n_gs, dev)
    gw, gd = gs_cfg.n_payloads // 32, gs_cfg.n_delay_slots
    g_ok = torch.as_tensor(g.random(n_gs * f) < 0.9, device=dev)
    # (label, ring, sending, dst, slot, ok, the streams, the edges hashed)
    cases = (
        ("broadcast_scatter_lossy_dropped",
         _random_words(g, (2, n, w), dev, 6),
         _random_words(g, (n, w), dev, 4), dst, torch.full_like(dst, 1),
         ok_w, dict(thr=thr, key=key, seed=int(rf.seed)), ok_w & (thr > 0)),
        # an empty ring: the drops, not the ring's old words, are the point
        ("broadcast_scatter_lossy_topo_dropped",
         torch.zeros((gd, n_gs, gw), dtype=torch.int32, device=dev),
         _random_words(g, (n_gs, gw), dev, 4),
         torch.as_tensor(g.integers(0, n_gs, n_gs * f), dtype=torch.int32,
                         device=dev),
         torch.as_tensor(g.integers(0, gd, n_gs * f), dtype=torch.int32,
                         device=dev),
         g_ok, dict(thr=None, key=key, seed=0, topo_thr=loss_threshold(0.3),
                    topo_key=trng.prng_key(6, dev)), g_ok),
    )
    rate = _int32_ops_per_s()
    for label, ring0, snd, dst_, slot_, ok_, streams, hashed in cases:

        def scatter(fn, ring, dropped):
            fn(ring, snd, dst_, slot_, ok_, streams["thr"], streams["key"],
               streams["seed"], f, streams.get("topo_thr", 0),
               streams.get("topo_key"), dropped)

        outs = []
        for fn in (packed.scatter_sending_lossy,
                   packed.scatter_sending_lossy_plain):
            ring, dropped = ring0.clone(), _acc(dev)
            scatter(fn, ring, dropped)
            outs.append([ring, dropped])
        e, x = _equal_all(outs[0], outs[1])
        if int(outs[1][1]) == 0:
            raise AssertionError(f"{label} inputs drop nothing")
        live = (snd.repeat_interleave(f, dim=0) != 0) & hashed[:, None]
        ops = int(live.sum()) * 8 * OPS_PER_HASH
        nb = snd.numel() * 4 + dst_.shape[0] * 10 + ring0.numel() * 4 * 2
        ring_k, ring_p, d_k, d_p = (ring0.clone(), ring0.clone(), _acc(dev),
                                    _acc(dev))
        rows.append(dict(
            name=label, source=_TRACE_SRC + "broadcast_scatter.cu",
            replaces="corrosion_tpu/sim/packed.py:369", equal=e,
            max_abs_err=x,
            ms=_timed(timed, lambda: scatter(packed.scatter_sending_lossy,
                                             ring_k, d_k)),
            # the plain version finds its pairs with a host sync: eager,
            # and few calls of it under the topology stream (~0.3 s each)
            plain_ms=_time_eager_ms(lambda: scatter(
                packed.scatter_sending_lossy_plain, ring_p, d_p),
                REPS if streams["thr"] is not None else SLOW_PLAIN_REPS)
            if timed else None,
            bound_ms=max(_bound_ms(nb), ops / rate * 1e3),
            bound_by="operations" if ops / rate * 1e3 > _bound_ms(nb)
            else "bytes",
            kernel="broadcast_scatter_lossy"))

    # K12 and K13 at gapstress-1024's dense shape
    cfg, meta = _gapstress(n_dense, dev)
    t = 0
    have, relay, injected, ring, sync_ring, alive, group = \
        _dense_round_inputs(g, dev, cfg, meta, t)
    f = cfg.fanout
    targets = torch.as_tensor(g.integers(0, n_dense, (n_dense, f)),
                              dtype=torch.int32, device=dev)
    dst = targets.reshape(-1)
    src = torch.arange(n_dense, dtype=torch.int32,
                       device=dev).repeat_interleave(f)
    ok = (dst != src) & (torch.as_tensor(g.random(n_dense * f) < 0.95,
                                         device=dev))
    slot = torch.full_like(dst, t % cfg.n_delay_slots)
    key = trng.prng_key(71, dev)
    thr = loss_threshold(0.3)
    budget = cfg.rate_limit_bytes_round

    def k12(fn, outs):
        rel, rng_ = relay.clone(), ring.clone()
        rf_, rb_, dr_ = outs
        fn(have, rel, injected, meta.nbytes, budget, targets, dst, slot, ok,
           alive, key, thr, rng_, rf_, rb_, dr_)
        return [rel, rng_, rf_, rb_, dr_]

    def k12_outs():
        return (torch.full((n_dense,), -5, dtype=torch.int32, device=dev),
                torch.full((n_dense,), -5, dtype=torch.int32, device=dev),
                _acc(dev))

    got = k12(bc.broadcast_send, k12_outs())
    want = k12(bc.broadcast_send_plain, k12_outs())
    e, x = _equal_all(got, want)
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    heaviest = int((eligible.to(torch.int64) * meta.nbytes.to(torch.int64))
                   .sum(dim=1).max())
    if int(want[4]) == 0 or heaviest <= budget:
        raise AssertionError("K12 telemetry inputs: nothing lost or the "
                             "budget never binds")
    outs_k, outs_p = k12_outs(), k12_outs()
    rows.append(_row(
        "dense_phases_telemetry", _TRACE_SRC + "dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:32", e, x,
        _timed(timed, lambda: k12(bc.broadcast_send, outs_k)),
        _timed(timed, lambda: k12(bc.broadcast_send_plain, outs_p)),
        _nbytes(have, relay, injected, meta.nbytes, targets, dst, slot, ok,
                alive) + n_dense * 8 + 8, kernel="dense_phases"))

    heads, lo, hi, _ = _advertised(g, dev, cfg, have, 10)
    peers = torch.as_tensor(g.integers(0, n_dense, (n_dense, 3)),
                            dtype=torch.int32, device=dev)
    pok = torch.as_tensor(g.random((n_dense, 3)) < 0.7, device=dev)
    outs = []
    for fn in (sync.sync_pull_dense, sync.sync_pull_dense_plain):
        slot_ring = torch.zeros_like(have)
        cnt = torch.full((cfg.n_payloads,), 9, dtype=torch.int32, device=dev)
        fr = fn(have, heads, lo, hi, peers, pok, meta.nbytes,
                cfg.sync_budget_bytes, slot_ring, cfg, cnt)
        outs.append([fr, slot_ring, cnt])
    e, x = _equal_all(outs[0], outs[1])
    work = torch.zeros_like(have)
    cnt = torch.zeros(cfg.n_payloads, dtype=torch.int32, device=dev)
    rows.append(_row(
        "dense_sync_counts", _TRACE_SRC + "dense_sync.cu",
        "corrosion_tpu/sim/sync.py:122", e, x,
        _timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, pok, meta.nbytes,
            cfg.sync_budget_bytes, work, cfg, cnt)),
        _timed(timed, lambda: sync.sync_pull_dense_plain(
            have, heads, lo, hi, peers, pok, meta.nbytes,
            cfg.sync_budget_bytes, work, cfg, cnt)),
        _nbytes(have, heads, lo, hi, peers, pok, meta.nbytes, cnt) * 1
        + n_dense * cfg.n_payloads, kernel="dense_sync"))
    return rows


def compare_trace_kernels(dev, seed=3):
    """Phase 3d: K17-K19 at the storm's shapes (N = 100000, W = 16,
    E = 300000, M = 64) and gapstress's (N = 25600, W = 256, mixed
    sizes; rows marked gs), K17's dense entry and K18's rows entry at
    gapstress-1024's, and the telemetry outputs of K3, K9, K10, K12 and
    K13; every row with a trap (bit 31, byte totals past 2^31, a
    decimated scratch row, a full view, drops and cuts)."""
    from corrosion_tpu_torch.sim.runner import _write_storm

    g = np.random.default_rng(seed)
    _, storm_meta = _write_storm(STORM_N, 512, dev)
    _, gs_meta = _gapstress(GAPSTRESS_N, dev)
    rows = [
        compare_trace_counts(dev, g, STORM_N, 16, 3 * STORM_N),
        compare_trace_counts(dev, g, GAPSTRESS_N, 256, 3 * GAPSTRESS_N,
                             "_gs"),
        compare_trace_counts_dense(dev, g),
        compare_trace_wire(dev, g, STORM_N, 16, 3, storm_meta.nbytes),
        compare_trace_wire(dev, g, GAPSTRESS_N, 256, 3, gs_meta.nbytes,
                           "_gs"),
        compare_trace_wire_rows(dev, g),
        compare_trace_row(dev, g, STORM_N, 512, storm_meta.nbytes),
        compare_trace_row(dev, g, GAPSTRESS_N, 8192, gs_meta.nbytes, "_gs"),
        *compare_trace_outputs(dev, g),
    ]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


_START = time.monotonic()


def _lap(label: str) -> None:
    """Print the seconds the script has run, after ``label``."""
    print(f"elapsed_s={time.monotonic() - _START:.1f} after {label}",
          flush=True)


def _storm_check(result, golden, label):
    """Hold a run's record against its golden: every golden key (the
    digest from the record's final state), then convergence — or, for
    the membership churn, detection."""
    from corrosion_tpu_torch.convert import state_digest

    got = {key: state_digest(result["state"]) if key == "digest"
           else result[key] for key in golden}
    print(f"{label}: {json.dumps(got)} wall_clock_s="
          f"{result['wall_clock_s']:.3f}", flush=True)
    for key, want in golden.items():
        if got[key] != want:
            raise AssertionError(f"{label}: {key} {got[key]!r} != golden "
                                 f"{want!r}")
    if not result.get("converged", result.get("detect_round", -1) >= 0):
        raise AssertionError(f"{label}: did not converge")


def _fault_record(final, metrics, wall):
    """A fault run's record in `_storm_check`'s terms."""
    from corrosion_tpu_torch.sim.runner import _node_convergence

    conv = _node_convergence(metrics, final)
    return {"state": final, "rounds": int(final.t), "wall_clock_s": wall,
            "converged": conv["unconverged_nodes"] == 0, **conv}


def _path_launches(kernels, rows, label, telemetry=False):
    """Read every entry point's launch count after a path ran from 0,
    require each entry of ``rows``' kernels to have launched — and,
    without ``telemetry``, no entry of the flight recorder's kernels —
    and return the counts of every kernel row."""
    entries = {kern.name: kern.launches for kern in kernels.KERNELS}
    off = [row for row in kernels.PORTED if row not in rows]
    print(f"{label} launches={json.dumps(entries)} off_path={off}",
          flush=True)
    for row in rows:
        for kern in kernels.PORTED[row]:
            if kern.launches <= 0:
                raise AssertionError(f"kernel entry {kern.name} never "
                                     f"launched on the {label} path")
    if not telemetry:
        on = [kern.name for row in kernels.TRACE_ROWS
              for kern in kernels.PORTED[row] if kern.launches]
        if on:
            raise AssertionError(f"flight recorder kernels {on} launched "
                                 f"on the telemetry-off {label} path")
    return {row: sum(k.launches for k in entries_)
            for row, entries_ in kernels.PORTED.items()}


F32_ULP = 2.0 ** -24


def _telemetry_check(result, golden, m_bcast, m_sync, label):
    """Hold a telemetry run against its golden: every key of the summary
    block but ``wire_bytes`` exactly (the coverage-curve digest, latency
    percentiles, frames, drops, cuts, refusals, crashes, wipes, sessions,
    SWIM peaks, overflow rounds), and each round's f32 byte channels
    within (m + 1)·2⁻²⁴·S of JAX's for the m f32 terms JAX adds (the
    port's row is the exact total S rounded once); ``wire_bytes`` within
    the rows' bounds plus both sums' rounding.  Returns the largest
    relative gap of a row."""
    from corrosion_tpu_torch.sim.telemetry import trace_host

    got = dict(result["telemetry"])
    wire = got.pop("wire_bytes")
    if got != golden["summary"]:
        raise AssertionError(f"{label}: telemetry summary {got} != golden "
                             f"{golden['summary']}")
    rounds = result["rounds"]
    host = trace_host(result["trace"], rounds)
    worst, bounds = 0.0, {}
    for channel, key, m in (("bcast_bytes", "broadcast", m_bcast),
                            ("sync_bytes", "sync", m_sync)):
        port = host[channel].astype(np.float64)
        want = np.asarray(golden[channel], np.float64)
        exact_hi = np.abs(port) * (1 + F32_ULP)
        bound = (m + 1) * F32_ULP * exact_hi
        gap = np.abs(want - port)
        if want.shape != port.shape or bool((gap > bound).any()):
            raise AssertionError(f"{label}: {channel} outside the f32 bound")
        worst = max(worst, float((gap / np.maximum(port, 1)).max()))
        total = float(exact_hi.sum())
        limit = float(bound.sum()) + 2 * rounds * F32_ULP * total + 0.1
        if abs(wire[key] - golden["wire_bytes"][key]) > limit:
            raise AssertionError(f"{label}: wire_bytes.{key} {wire[key]} vs "
                                 f"golden {golden['wire_bytes'][key]}")
        bounds[key] = limit
    print(f"{label}: telemetry {json.dumps(got)} wire_bytes={json.dumps(wire)}"
          f" f32_worst_relative_gap={worst!r}", flush=True)
    return worst


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
        config_broadcast_1k,
        config_fault_storm_telemetry,
        config_gapstress_distortion,
        config_ground_truth_3node,
        config_packed_fault_storm,
        config_partition_heal_10k,
        config_write_storm_100k,
        config_write_storm_gapstress,
        membership_churn,
        run_scenario,
        storm_fault_plan,
    )
    from corrosion_tpu_torch.sim.telemetry import trace_host, trace_summary
    from corrosion_tpu_torch.sim.topology import Topology

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}", flush=True)

    t0 = time.monotonic()
    kernels.build_all(verbose=True)
    print(f"build_s={time.monotonic() - t0:.2f}", flush=True)

    rows = compare_kernels(dev)
    print("kernel comparisons equal at storm shapes", flush=True)
    _lap("storm kernel comparisons")
    dense_kernel_rows = compare_dense_kernels(dev)
    print("kernel comparisons equal at the dense paths' shapes", flush=True)
    _lap("dense kernel comparisons")
    gap_kernel_rows = compare_gapstress_kernels(dev)
    print("kernel comparisons equal at gapstress's shapes", flush=True)
    _lap("gapstress kernel comparisons")
    trace_kernel_rows = compare_trace_kernels(dev)
    print("kernel comparisons equal for the flight recorder", flush=True)
    _lap("flight recorder kernel comparisons")

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
    faultless_rows = ["sample_targets", "broadcast_scatter", "sync_pull",
                      "merge_entries", "threefry", "gaps_refresh",
                      "converge_fold", "word_phases"]
    kernels.reset_launch_counts()
    big = config_write_storm_100k(seed=0, device=dev, return_state=True)
    launches = _path_launches(kernels, faultless_rows, "storm_100k")
    _storm_check(big, goldens.STORM_100K_SEED0, "storm_100k_seed0")

    # path 2, the 100k fault storm alone: K1's table entry and K3-K11.
    # Every fault round scatters through K10, so K2 is off this path.
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
        kernels, [row for row in faultless_rows if row != "broadcast_scatter"]
        + ["fault_edges", "broadcast_scatter_lossy", "node_faults"],
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

    # path 3, partition-heal-10k: the dense round with partial-view
    # SWIM, two regions (ring0 tiering): K1, K4, K5 and K12-K14
    dense_rows = ["dense_phases", "dense_sync", "dense_gaps"]
    kernels.reset_launch_counts()
    heal = config_partition_heal_10k(seed=0, device=dev, return_state=True)
    heal_launches = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows],
        "partition_heal_10k")
    _storm_check(heal, goldens.PARTITION_HEAL_10K_SEED0, "partition_heal_10k")

    # path 4, broadcast-1k and the 3-node ground truth (metered budgets):
    # ground-truth membership, so the uniform sampler (K1's second
    # entry), K5 and K12-K14
    uniform_rows = ["sample_uniform", "threefry", *dense_rows]
    for label, entry, golden in (
            ("broadcast_1k", config_broadcast_1k, goldens.BROADCAST_1K_SEED0),
            ("ground_truth_3node", config_ground_truth_3node,
             goldens.GROUND_TRUTH_3NODE_SEED0)):
        kernels.reset_launch_counts()
        result = entry(seed=0, device=dev, return_state=True)
        _path_launches(kernels, uniform_rows, label)
        _storm_check(result, golden, label)

    # path 5, churn-full-4096: full-view SWIM on [4096, 4096] beliefs,
    # K1's uniform entry filtering by them, and K15
    kernels.reset_launch_counts()
    churn = membership_churn(4096, seed=0, device=dev, return_state=True)
    churn_launches = _path_launches(kernels, [*uniform_rows, "swim_full"],
                                    "churn_full_4096")
    _storm_check(churn, goldens.CHURN_FULL_4096_SEED0, "churn_full_4096")

    # path 6, gapstress-25.6k: the packed round under both byte budgets
    # (K16, K3's metered entry, K8's metered spend), the flat 30 % loss
    # on every round's scatter (K10's topology stream, so K2 is off the
    # path) and V = 128 gaps (K6's walk)
    gap_rows = ["sample_targets", "merge_entries", "threefry", "gaps_refresh",
                "converge_fold", "word_phases", "sync_pull_metered",
                "budget_words", "broadcast_scatter_lossy"]
    kernels.reset_launch_counts()
    gapstress = config_write_storm_gapstress(seed=1, n_nodes=GAPSTRESS_N,
                                             device=dev, return_state=True)
    gap_launches = _path_launches(kernels, gap_rows, "gapstress_25600")
    if gapstress["round_path"] != "packed":
        raise AssertionError("gapstress_25600 did not take the packed round")
    _storm_check(gapstress, goldens.GAPSTRESS_25600_SEED1, "gapstress_25600")

    # path 7, the K-clamp distortion at 1024 nodes: the dense round at
    # K = 8 and at the K = 64 control (K14 past 32 slots)
    kernels.reset_launch_counts()
    dist = config_gapstress_distortion(seed=0, n_nodes=1024, device=dev,
                                       return_state=True)
    dist_launches = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows],
        "gapstress_distortion_1024")
    golden = goldens.GAPSTRESS_DISTORTION_1024_SEED0
    for run in ("stressed", "control"):
        _storm_check(dist[run], golden[run], f"gapstress_distortion_{run}")
    if dist["distortion_rounds"] != golden["distortion_rounds"]:
        raise AssertionError("gapstress_distortion: distortion_rounds "
                             f"{dist['distortion_rounds']} != golden")

    _lap("paths 1-7")
    # path 8, the flight recorder: every path the JAX runner lets record
    # a trace, with telemetry on, each from zeroed counters — its goldens
    # (rounds, p99s, overflow, digest) do not move, its telemetry golden
    # holds, and K17-K19 launch
    packed_trace = ["trace_counts", "trace_wire", "trace_row"]
    dense_trace = ["trace_counts_dense", "trace_wire_rows", "trace_row"]
    tel_launches, f32_gaps = {}, {}
    kernels.reset_launch_counts()
    run = config_write_storm_100k(seed=0, telemetry=True, device=dev,
                                  return_state=True)
    tel_launches["storm"] = _path_launches(
        kernels, faultless_rows + packed_trace, "storm_100k_telemetry", True)
    _storm_check(run, goldens.STORM_100K_SEED0, "storm_100k_telemetry")
    f32_gaps["storm_100k"] = _telemetry_check(
        run, goldens.STORM_100K_SEED0_TELEMETRY, 300_000, 512,
        "storm_100k_telemetry")

    cfg, meta = _write_storm(100_000, 512, dev)
    fplan = faults.compile_plan(storm_fault_plan(100_000, 0), cfg,
                                device=dev)
    state = new_sim(cfg, 0, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, metrics, trace = faults.run_fault_plan(
        state, meta, cfg, Topology(), fplan, max_rounds=3000,
        telemetry=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel_launches["fault"] = _path_launches(
        kernels, [row for row in faultless_rows if row != "broadcast_scatter"]
        + ["fault_edges", "broadcast_scatter_lossy", "node_faults",
           *packed_trace], "fault_storm_100k_telemetry", True)
    run = _fault_record(final, metrics, wall)
    run["trace"] = trace
    run["telemetry"] = trace_summary(trace_host(trace, run["rounds"]),
                                     run["rounds"], cfg)
    _storm_check(run, goldens.FAULT_STORM_100K_SEED0,
                 "fault_storm_100k_telemetry")
    f32_gaps["fault_storm_100k"] = _telemetry_check(
        run, goldens.FAULT_STORM_100K_SEED0_TELEMETRY, 300_000, 512,
        "fault_storm_100k_telemetry")

    kernels.reset_launch_counts()
    run = config_write_storm_gapstress(seed=1, n_nodes=GAPSTRESS_N,
                                       telemetry=True, device=dev,
                                       return_state=True)
    tel_launches["gapstress"] = _path_launches(
        kernels, gap_rows + packed_trace, "gapstress_25600_telemetry", True)
    _storm_check(run, goldens.GAPSTRESS_25600_SEED1,
                 "gapstress_25600_telemetry")
    f32_gaps["gapstress_25600"] = _telemetry_check(
        run, goldens.GAPSTRESS_25600_SEED1_TELEMETRY, 3 * GAPSTRESS_N, 8192,
        "gapstress_25600_telemetry")

    kernels.reset_launch_counts()
    run = config_write_storm_gapstress(seed=0, n_nodes=DENSE_GAPSTRESS_N,
                                       telemetry=True, device=dev,
                                       return_state=True)
    tel_launches["gapstress_1024"] = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows,
                  *dense_trace], "gapstress_1024_telemetry", True)
    if run["round_path"] != "dense":
        raise AssertionError("gapstress_1024 did not take the dense round")
    _storm_check(run, goldens.GAPSTRESS_DISTORTION_1024_SEED0["stressed"],
                 "gapstress_1024_telemetry")
    f32_gaps["gapstress_1024"] = _telemetry_check(
        run, goldens.GAPSTRESS_1024_SEED0_TELEMETRY, 3 * DENSE_GAPSTRESS_N,
        8192, "gapstress_1024_telemetry")

    for label, entry, golden, tel_golden, m in (
            ("broadcast_1k", config_broadcast_1k, goldens.BROADCAST_1K_SEED0,
             goldens.BROADCAST_1K_SEED0_TELEMETRY, (3000, 256)),
            ("ground_truth_3node", config_ground_truth_3node,
             goldens.GROUND_TRUTH_3NODE_SEED0,
             goldens.GROUND_TRUTH_3NODE_SEED0_TELEMETRY, (6, 64))):
        kernels.reset_launch_counts()
        run = entry(seed=0, telemetry=True, device=dev, return_state=True)
        tel_launches[label] = _path_launches(
            kernels, uniform_rows + dense_trace, f"{label}_telemetry", True)
        _storm_check(run, golden, f"{label}_telemetry")
        f32_gaps[label] = _telemetry_check(run, tel_golden, *m,
                                           f"{label}_telemetry")

    # the bench's telemetry rung: the per-round cost of the recorder
    rung = config_fault_storm_telemetry(seed=0, device=dev)
    summary = {k: v for k, v in rung["telemetry"].items()
               if k != "wire_bytes"}
    if (summary != goldens.FAULT_STORM_100K_SEED0_TELEMETRY["summary"]
            or rung["rounds"] != goldens.FAULT_STORM_100K_SEED0["rounds"]
            or not rung["converged"]):
        raise AssertionError("config_fault_storm_telemetry: its run is not "
                             "the golden fault storm")
    print(f"config_fault_storm_telemetry: {json.dumps(rung)} card={card}",
          flush=True)
    print("f32_worst_relative_gap: " + json.dumps(f32_gaps), flush=True)

    _lap("path 8, the flight recorder")
    storm_profile = profile_storm(dev)
    print("profile: " + json.dumps(storm_profile), flush=True)
    fault_profile = profile_storm(dev, faults=True)
    print("profile: " + json.dumps(fault_profile), flush=True)
    for prof, want in ((storm_profile, STORM_OFF_LAUNCHES),
                       (fault_profile, FAULT_STORM_OFF_LAUNCHES)):
        got = round(prof["device_launches_per_round"] * prof["rounds"])
        if got != want:
            raise AssertionError(f"{prof['run']}: {got} launches in "
                                 f"{prof['rounds']} telemetry-off rounds, "
                                 f"not {want}")
    # the recorder's share of a round: the same rounds with it on
    print("profile: " + json.dumps(profile_storm(dev, telemetry=True)),
          flush=True)
    # the whole loss window, where most nodes send and K10 draws most
    print("profile: " + json.dumps(profile_storm(dev, 12, faults=True)),
          flush=True)
    print("profile: " + json.dumps(profile_heal(dev)), flush=True)
    print("profile_gapstress: " + json.dumps(profile_gapstress(dev)),
          flush=True)

    for row in rows:
        row["launches"] = (launches if row["name"] in faultless_rows
                           else fault_launches)[row["name"]]
        row["fault_path_launches"] = fault_launches[row["name"]]
    for row in dense_kernel_rows:
        path = churn_launches if row["name"] in (
            "sample_uniform", "swim_full") else heal_launches
        row["launches"] = path[row["name"]]
    rows += dense_kernel_rows
    for row in gap_kernel_rows:
        path = dist_launches if row["kernel"] == "dense_gaps" else gap_launches
        row["launches"] = path[row["kernel"]]
    rows += gap_kernel_rows
    # each flight-recorder row reads its kernel's launches on the
    # telemetry path whose shapes it was compared at
    trace_path = {"trace_counts": "storm", "trace_wire": "storm",
                  "trace_row": "storm", "sync_pull_granted": "storm",
                  "fault_edges_counts": "fault",
                  "broadcast_scatter_lossy_dropped": "fault",
                  "sync_pull_metered_granted": "gapstress",
                  "broadcast_scatter_lossy_topo_dropped": "gapstress"}
    for row in trace_kernel_rows:
        path = trace_path.get(row["name"], "gapstress" if row["name"].endswith(
            "_gs") else "gapstress_1024")
        row["launches"] = tel_launches[path][row["kernel"]]
        row["path"] = path
    rows += trace_kernel_rows
    for row in rows:
        row["kernel_ms"] = row["ms"]
    _lap("profiles")
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
