"""Payload bits on u32 words — the packing helpers and chunk-group folds
of ``corrosion_tpu/sim/packed.py`` (``pack_bits``, ``unpack_bits``,
``_fold_all``, ``_fold_any``, ``_group_low_bits_mask``,
``_smear_groups``, ``group_grid``, ``grid_to_words``,
``all_chunks_words``), shared by the packed round and the gap refresh.

Words ride int32 carriers (`..device`).  Payload index
p = (v * A + a) * C + c, so each (version, actor) group owns C
contiguous bits of one word (C a power of two ≤ 32).
"""

from __future__ import annotations

import torch

from ..device import ONES, i32, shr
from .state import SimConfig


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool/u8[..., P] → int32-carried u32 words [..., P/32], LSB-first."""
    *lead, p = x.shape
    assert p % 32 == 0, p
    # a byte at a time, so each temporary takes a byte a bit: distinct
    # bits, so the u8 sum is exactly the OR; a word's bytes little-endian
    b = (x > 0).reshape(*lead, p // 8, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return (b << shifts).sum(dim=-1, dtype=torch.uint8).view(torch.int32)


def unpack_bits(w: torch.Tensor, p: int) -> torch.Tensor:
    """int32-carried words [..., W] → bool[..., P]."""
    if w.stride(-1) != 1:
        w = w.contiguous()
    shifts = torch.arange(8, dtype=torch.uint8, device=w.device)
    # a byte at a time, little-endian: word bit 8j + i is byte j's bit i
    bits = (w.view(torch.uint8)[..., None] >> shifts) & 1
    return bits.to(torch.bool).reshape(*w.shape[:-1], p)


def fold_all(w: torch.Tensor, c: int) -> torch.Tensor:
    """Each aligned c-bit group's low bit becomes the AND of the group
    (other bits undefined: mask after)."""
    step = 1
    while step < c:
        w = w & shr(w, step)
        step *= 2
    return w


def fold_any(w: torch.Tensor, c: int) -> torch.Tensor:
    """Each aligned c-bit group's low bit becomes the OR of the group."""
    step = 1
    while step < c:
        w = w | shr(w, step)
        step *= 2
    return w


def group_low_bits_mask(c: int) -> int:
    """The u32 mask with a bit at every multiple of c, as an int32 value."""
    return i32(sum(1 << i for i in range(0, 32, c)))


def smear_groups(low: torch.Tensor, c: int) -> torch.Tensor:
    """Broadcast each aligned c-bit group's low bit across the group."""
    w = low
    step = 1
    while step < c:
        w = w | (w << step)
        step *= 2
    return w


def group_grid(w: torch.Tensor, cfg: SimConfig, mode: str) -> torch.Tensor:
    """have-words [..., W] → bool[..., A, V] version grid (all/any chunks)."""
    c = cfg.chunks_per_version
    fold = fold_all if mode == "all" else fold_any
    low = fold(w, c) & group_low_bits_mask(c)
    shifts = torch.arange(0, 32, c, dtype=torch.int32, device=w.device)
    bits = (low[..., None] >> shifts) & 1  # [..., W, 32/c]
    grid = bits.reshape(*w.shape[:-1], cfg.n_versions, cfg.n_writers)
    return grid.transpose(-1, -2).to(torch.bool)  # [..., A, V]


def grid_to_words(x_av: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[..., A, V] → words [..., W] with each (v, a) group's C bits
    set where the grid is True (inverse of group_grid)."""
    c = cfg.chunks_per_version
    va = x_av.transpose(-1, -2).reshape(
        *x_av.shape[:-2], cfg.n_versions * cfg.n_writers
    )
    per_word = 32 // c
    g = va.reshape(*va.shape[:-1], va.shape[-1] // per_word, per_word)
    shifts = torch.arange(0, 32, c, dtype=torch.int64, device=x_av.device)
    low = (g.to(torch.int64) << shifts).sum(dim=-1).to(torch.int32)
    return smear_groups(low, c)


def all_chunks_words(have_w: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Word mask: every bit of version v's group set iff ALL its chunks
    are held."""
    c = cfg.chunks_per_version
    return smear_groups(fold_all(have_w, c) & group_low_bits_mask(c), c)


def and_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise AND of the rows of [R, W] words (torch has no AND reduction:
    a halving fold, log2(R) steps)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.full_like(x[:1], ONES)])
        x = x[0::2] & x[1::2]
    return x[0]
