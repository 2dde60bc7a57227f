"""The analytic floor under a reported wall — the port's copy of the two
functions of ``corrosion_tpu/sim/perf.py:54-86`` that the campaign
engine's defensible wall reads (the rest of that module is ROADMAP A11).

A round rewrites the carry (``have``, the relay budgets, the delay
ring) at least once, so a round cannot take less than those bytes over
a bandwidth ceiling set above any card (4 TB/s a device; an H100's HBM3
moves 3.35 TB/s).  A wall below rounds × lanes × that floor is a broken
measurement, not a fast card.
"""

from __future__ import annotations

from .state import SimConfig

#: single-device write bandwidth ceiling, bytes/s (JAX's constant)
HBM_BYTES_PER_S_CEILING = 4e12


def carry_write_bytes(cfg: SimConfig, packed: bool = False) -> int:
    """Bytes a round must write at least: the delay ring (u8 [D, N, P]
    in both layouts) plus ``have`` and the relay budgets — u8 [N, P]
    each, or with ``packed`` the u32 words and four relay planes."""
    n, p, d = cfg.n_nodes, cfg.n_payloads, cfg.n_delay_slots
    inflight = d * n * p
    if packed:
        have = n * (p // 8)
        relay = n * (p // 2)
    else:
        have = n * p
        relay = n * p
    return have + relay + inflight


def analytic_min_round_s(
    cfg: SimConfig, n_devices: int = 1, packed: bool = False
) -> float:
    """The lower bound on one round's wall: `carry_write_bytes` over the
    ceiling times the device count."""
    return carry_write_bytes(cfg, packed) / (
        HBM_BYTES_PER_S_CEILING * max(1, n_devices)
    )
