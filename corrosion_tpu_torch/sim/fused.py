"""The flight recorder's traversal counters — the port of
``corrosion_tpu/sim/fused.py`` in its semantics: per-payload bit counts
over word rows, per-row byte totals of the selected payloads, the
broadcast's per-node send stats (word and dense forms), the sync grant's
fold, and the fold of per-node totals over the live edges.

JAX keeps two forms of each traversal, SWAR nibble accumulators and
byte-table gathers beside per-bit loops, because XLA on the CPU
materializes the one-pass bit-plane expression (``fused.py:14-31``).
Both forms give the same exact integers, and that is what the port
keeps: the plain torch versions here, and the kernels that replace them
on the card (K17 ``trace_counts.cu``, K18 ``trace_wire.cu``, K19's fold
in ``trace_row.cu``; wrappers in `.telemetry`).

**Byte totals are exact.**  Per-row byte totals are int64 here (JAX's
are i32, equal wherever they fit), and the f32 channels are the exact
int64 total rounded once (`grant_fold`, and K19 for the broadcast's
bytes), where JAX sums f32 terms: the two agree within m·2⁻²⁴ of the
total for m terms, and the port's dense and packed rounds agree bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import popcount


def word_bit_counts(words: torch.Tensor, n_payloads: int) -> torch.Tensor:
    """i32[P] per-bit-position set counts over the leading (node or edge)
    axis of int32-carried u32 words [R, W]: the coverage, delivered and
    sync grant counters."""
    cols = [((words >> j) & 1).sum(dim=0, dtype=torch.int32)
            for j in range(32)]
    return torch.stack(cols, dim=-1).reshape(n_payloads)  # [W, 32] → [P]


def word_byte_totals(words: torch.Tensor,
                     nbytes: torch.Tensor) -> torch.Tensor:
    """int64[...] per-row byte totals of the payloads whose bits are set
    in ``words`` [..., W] (the packed twin of ``where(mask, nbytes,
    0).sum(-1)``)."""
    w = words.shape[-1]
    nb = nbytes.to(torch.int64).reshape(w, 32)
    tot = torch.zeros(words.shape[:-1], dtype=torch.int64,
                      device=words.device)
    for j in range(32):
        bit = ((words >> j) & 1).to(torch.int64)
        tot += (bit * nb[:, j]).sum(dim=-1)
    return tot


def word_send_stats(
    sending: torch.Tensor, nbytes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames i32[N], bytes int64[N]): per-node wire totals of a packed
    send set ``sending`` [N, W]."""
    frames = popcount(sending).sum(dim=-1, dtype=torch.int32)
    return frames, word_byte_totals(sending, nbytes)


def dense_send_stats(
    sending: torch.Tensor, nbytes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense twin of `word_send_stats` from a bool send set [N, P]: the
    same integers on identical-valued send sets."""
    frames = sending.sum(dim=-1, dtype=torch.int32)
    byte_tot = torch.where(sending, nbytes.to(torch.int64)[None, :], 0).sum(
        dim=-1)
    return frames, byte_tot


def fold_over_edges(
    frames: torch.Tensor, byte_tot: torch.Tensor, ok: torch.Tensor,
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames, bytes) int64 totals of per-node ``frames`` and
    ``byte_tot`` [N] over the ok edges ``ok`` [N * fanout] (edge e leaves
    node e // fanout): what the wire carried, lost frames included."""
    edges = ok.reshape(-1, fanout).sum(dim=1, dtype=torch.int64)
    return ((frames.to(torch.int64) * edges).sum(),
            (byte_tot.to(torch.int64) * edges).sum())


def grant_fold(
    counts: torch.Tensor, nbytes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames i32, bytes f32) from per-payload sync grant counts [P]:
    the frame total and the exact byte total rounded once to f32."""
    frames = counts.sum(dtype=torch.int32)
    byte_tot = (counts.to(torch.int64) * nbytes.to(torch.int64)).sum()
    return frames, byte_tot.to(torch.float32)
