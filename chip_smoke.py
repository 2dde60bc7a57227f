"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the four CUDA kernels from ``corrosion_tpu_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. at the 100k storm's shapes (N = 100000, M = 64, W = 16, F = 3, S = 3,
   k = 8), call each kernel's wrapper and its plain torch version on the
   same card tensors, require exact equality, and time both (CUDA
   events around a CUDA-graph replay of 20 calls, after warm-up);
4. run the 512-node seed-7 write storm on the card and hold its final
   state digest, rounds and p99 against the pinned JAX goldens;
5. with every launch counter at 0, run ``config_write_storm_100k(seed=0)``
   on the card, hold rounds, p99 and the state digest against the pinned
   JAX goldens, and require every kernel to have launched;
6. profile the storm's first rounds (host wall, device time by kernel
   from ``torch.profiler``, the device's idle share);
7. print the card line, the kernels JSON line, then the one-line result
   ``{"ok": true, "device": {...}}``.

Nothing runs on the CPU: without a card the script exits at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet): the bound of every
# kernel here is the bytes it must move
HBM_BYTES_PER_S = 3.35e12
WARMUP, REPS = 3, 20


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


KERNEL_SYMBOLS = (
    "sample_targets_kernel", "broadcast_scatter_kernel", "sync_pull_kernel",
    "merge_scatter_kernel", "merge_apply_kernel",
)


def profile_storm(dev, rounds=3):
    """Where a 100k storm round's time goes on the card: the first
    ``rounds`` rounds on the host clock, then again under torch.profiler
    for device time by kernel (its own run: the profiler slows the
    host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import _write_storm
    from corrosion_tpu_torch.sim.topology import Topology

    cfg, meta = _write_storm(100_000, 512, dev)

    def run():
        state = new_sim(cfg, 0, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
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
        "device_kernel_names": len(device),
        "rounds": rounds,
        "wall_ms_per_round": wall / rounds * 1e3,
        "device_ms_per_round": total_us / 1e3 / rounds,
        "idle_share": 1.0 - total_us / 1e6 / wall,
        "port_kernels_ms_per_round": ours_us / 1e3 / rounds,
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


def compare_kernels(dev, seed=0):
    """Phase 3: every kernel against its plain version at storm shapes."""
    from corrosion_tpu_torch.sim import packed, pswim

    n, m, w, f, s, k = 100_000, 64, 16, 3, 3, 8
    t, gc = 40, 12
    rng = np.random.default_rng(seed)

    def cuda(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    def words(shape, ands=1):
        """Random u32 words, each bit set with probability 2^-ands."""
        w = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
        for _ in range(ands):
            w &= rng.integers(0, 1 << 32, shape, dtype=np.uint32)
        return cuda(w.view(np.int32))

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
    for row in rows:
        row.update(route="cuda", bound_by="bytes", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from corrosion_tpu_torch import goldens, kernels
    from corrosion_tpu_torch.sim.runner import (
        _write_storm,
        config_write_storm_100k,
        run_scenario,
    )

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

    kernels.reset_launch_counts()
    big = config_write_storm_100k(seed=0, device=dev, return_state=True)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    _storm_check(big, goldens.STORM_100K_SEED0, "storm_100k_seed0")
    print(f"storm_100k launches={json.dumps(launches)} "
          f"rounds={big['rounds']} "
          f"p99={big['p99_node_convergence_round']}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    print("profile: " + json.dumps(profile_storm(dev)), flush=True)

    for row in rows:
        row["launches"] = launches[row["name"]]
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
