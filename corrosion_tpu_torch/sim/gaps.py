"""Fixed-K version-gap interval tensors — the port of
``corrosion_tpu/sim/gaps.py``: `extract_gaps` in both of JAX's forms
(``_extract_gaps_words`` for V ≤ 32, ``_extract_gaps_dense`` past it;
the same `GapTensors` either way) and ``gaps_to_mask``.

`refresh_gaps` is the packed round's bookkeeping refresh: heads, gap
intervals and the overflow count straight from the have words.  On the
card it is one launch of K6 (``kernels/csrc/gaps_refresh.cu``: one
version word per (node, actor) up to 32 versions, a walk over version
words past that); on the
CPU it runs `refresh_gaps_plain`, the composition group_grid →
version_heads → `extract_gaps` that JAX runs.  The dense round's refresh
rides K14 with its convergence record (`.round.dense_record`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..device import popcount, shr
from ..kernels.build import check
from .state import SimConfig, version_heads
from .words import group_grid


class GapTensors(NamedTuple):
    lo: torch.Tensor  # i32[N, A, K] 1-based range starts, 0 = empty slot
    hi: torch.Tensor  # i32[N, A, K] inclusive ends
    overflow: torch.Tensor  # bool[N, A] had more than K runs (clamped)


def extract_gaps(
    touched: torch.Tensor, heads: torch.Tensor, cfg: SimConfig
) -> GapTensors:
    """Run-length-extract needed version ranges into K interval slots:
    the maximal runs of untouched versions below each head."""
    if touched.shape[2] <= 32:
        return _extract_gaps_words(touched, heads, cfg)
    return _extract_gaps_dense(touched, heads, cfg)


def _extract_gaps_dense(
    touched: torch.Tensor, heads: torch.Tensor, cfg: SimConfig
) -> GapTensors:
    """The [N, A, V] form: run starts and ends by neighbour compares, the
    run index by a cumsum, one masked max per slot."""
    n, a, v = touched.shape
    k = cfg.gap_slots
    v_idx = torch.arange(1, v + 1, dtype=torch.int32, device=touched.device)
    missing = ~touched & (v_idx[None, None, :] <= heads[:, :, None])
    prev = torch.nn.functional.pad(missing[:, :, :-1], (1, 0))
    nxt = torch.nn.functional.pad(missing[:, :, 1:], (0, 1))
    start = missing & ~prev
    end = missing & ~nxt
    rank = torch.cumsum(start.to(torch.int32), dim=2)
    overflow = rank[:, :, -1] > k
    lo, hi = [], []
    for slot in range(k):
        in_slot = rank == slot + 1
        lo.append(torch.where(start & in_slot, v_idx, 0).amax(dim=2))
        hi.append(torch.where(end & in_slot, v_idx, 0).amax(dim=2))
    lo = torch.stack(lo, dim=-1).to(torch.int32)
    hi = torch.stack(hi, dim=-1).to(torch.int32)
    last_missing = torch.where(missing, v_idx, 0).amax(dim=2)
    hi[:, :, k - 1] = torch.where(overflow, last_missing, hi[:, :, k - 1])
    return GapTensors(lo=lo, hi=hi, overflow=overflow)


def _extract_gaps_words(
    touched: torch.Tensor, heads: torch.Tensor, cfg: SimConfig
) -> GapTensors:
    """The V ≤ 32 form: the version axis packs into one u32 word per
    (node, actor), and the runs are bit operations on [N, A] words."""
    n, a, v = touched.shape
    k = cfg.gap_slots
    dev = touched.device
    shifts = torch.arange(v, dtype=torch.int64, device=dev)
    # version-bit words (bit i = version i+1 touched), built in int64 and
    # carried as int32: V ≤ 32 bits fit the carrier exactly
    tv = (touched.to(torch.int64) << shifts).sum(dim=2).to(torch.int32)
    h = heads.to(torch.int64)
    below = torch.where(
        h >= 32,
        torch.full_like(h, 0xFFFFFFFF),
        torch.bitwise_left_shift(torch.ones_like(h), h.clamp(max=31)) - 1,
    ).to(torch.int32)  # bits [0, head)
    missing = ~tv & below

    start = missing & ~(missing << 1)
    end = missing & ~shr(missing, 1)

    def nth_positions(bits: torch.Tensor, count: int) -> torch.Tensor:
        out = []
        s = bits
        for _ in range(count):
            low = s & (~s + 1)  # lowest set bit
            pos = popcount(low - 1) + 1
            out.append(torch.where(s != 0, pos, 0).to(torch.int32))
            s = s & (s - 1)
        return torch.stack(out, dim=-1)

    lo = nth_positions(start, k)
    hi = nth_positions(end, k)
    overflow = popcount(start) > k
    sm = missing
    for sh in (1, 2, 4, 8, 16):
        sm = sm | shr(sm, sh)
    last_missing = popcount(sm)
    hi[:, :, k - 1] = torch.where(overflow, last_missing, hi[:, :, k - 1])
    return GapTensors(lo=lo, hi=hi, overflow=overflow)


def refresh_gaps_plain(have_w: torch.Tensor, cfg: SimConfig):
    """Plain version of K6."""
    touched = group_grid(have_w, cfg, "any")  # [N, A, V]
    heads = version_heads(touched)
    gaps = extract_gaps(touched, heads, cfg)
    return heads, gaps.lo, gaps.hi, gaps.overflow.sum(dtype=torch.int32)


def refresh_gaps(
    have_w: torch.Tensor, cfg: SimConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(heads i32[N, A], gap_lo i32[N, A, K], gap_hi i32[N, A, K], the
    number of (node, actor) rows that overflowed K as an i32 scalar) from
    the have words [N, W]; K6 on the card."""
    if have_w.device.type == "cpu":
        return refresh_gaps_plain(have_w, cfg)
    n, w = have_w.shape
    a, v = cfg.n_writers, cfg.n_versions
    c, k = cfg.chunks_per_version, cfg.gap_slots
    check("have", have_w, torch.int32, (n, w))
    dev = have_w.device
    heads = torch.empty((n, a), dtype=torch.int32, device=dev)
    lo = torch.empty((n, a, k), dtype=torch.int32, device=dev)
    hi = torch.empty((n, a, k), dtype=torch.int32, device=dev)
    n_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    kernels.GAPS_REFRESH.launch(
        [have_w, heads, lo, hi, n_overflow], [n, w, a, v, c, k]
    )
    return heads, lo, hi, n_overflow


def gaps_to_mask(
    lo: torch.Tensor, hi: torch.Tensor, n_versions: int
) -> torch.Tensor:
    """Expand interval tensors [..., K] to a bool mask [..., V] over
    1-based versions."""
    v_idx = torch.arange(
        1, n_versions + 1, dtype=lo.dtype, device=lo.device
    )
    covered = torch.zeros(
        (*lo.shape[:-1], n_versions), dtype=torch.bool, device=lo.device
    )
    for slot in range(lo.shape[-1]):
        slo = lo[..., slot, None]
        shi = hi[..., slot, None]
        covered |= (slo > 0) & (slo <= v_idx) & (v_idx <= shi)
    return covered


def refresh_gaps_lanes_plain(have_w: torch.Tensor, cfg: SimConfig):
    """Plain version of K6's lane entry: the solo composition on the
    lanes folded into the rows, the overflow counted per lane."""
    lanes, n, w = have_w.shape
    a, k = cfg.n_writers, cfg.gap_slots
    touched = group_grid(have_w.reshape(lanes * n, w), cfg, "any")
    heads = version_heads(touched)
    gaps = extract_gaps(touched, heads, cfg)
    return (heads.reshape(lanes, n, a), gaps.lo.reshape(lanes, n, a, k),
            gaps.hi.reshape(lanes, n, a, k),
            gaps.overflow.reshape(lanes, n * a).sum(dim=1,
                                                    dtype=torch.int32))


def refresh_gaps_lanes(
    have_w: torch.Tensor, cfg: SimConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`refresh_gaps` over the seed ensemble's lanes: have words
    [K, N, W] give heads [K, N, A], gap_lo/gap_hi [K, N, A, K_slots] and
    i32[K] overflow counts (one per lane, for its own overflow_frac).
    K6's lane entry on the card."""
    if have_w.device.type == "cpu":
        return refresh_gaps_lanes_plain(have_w, cfg)
    lanes, n, w = have_w.shape
    a, v = cfg.n_writers, cfg.n_versions
    c, k = cfg.chunks_per_version, cfg.gap_slots
    check("have", have_w, torch.int32, (lanes, n, w))
    dev = have_w.device
    heads = torch.empty((lanes, n, a), dtype=torch.int32, device=dev)
    lo = torch.empty((lanes, n, a, k), dtype=torch.int32, device=dev)
    hi = torch.empty((lanes, n, a, k), dtype=torch.int32, device=dev)
    n_overflow = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    kernels.GAPS_REFRESH_LANES.launch(
        [have_w, heads, lo, hi, n_overflow], [n, w, a, v, c, k, lanes]
    )
    return heads, lo, hi, n_overflow
