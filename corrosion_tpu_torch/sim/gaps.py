"""Fixed-K version-gap interval tensors — the port of the V ≤ 32 word
path of ``corrosion_tpu/sim/gaps.py`` (``_extract_gaps_words``) and of
``gaps_to_mask``.  Plain torch in this slice (ROADMAP B6)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import popcount, shr
from .state import SimConfig


class GapTensors(NamedTuple):
    lo: torch.Tensor  # i32[N, A, K] 1-based range starts, 0 = empty slot
    hi: torch.Tensor  # i32[N, A, K] inclusive ends
    overflow: torch.Tensor  # bool[N, A] had more than K runs (clamped)


def extract_gaps(
    touched: torch.Tensor, heads: torch.Tensor, cfg: SimConfig
) -> GapTensors:
    """Run-length-extract needed version ranges into K interval slots:
    the maximal runs of untouched versions below each head."""
    n, a, v = touched.shape
    if v > 32:
        raise NotImplementedError(
            "the dense gap extraction (V > 32) is not ported yet (B13)"
        )
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
