"""Run driver: `run_to_convergence` over the packed envelope — the port
of ``corrosion_tpu/sim/round.py``'s entry points.  The dense round
(ROADMAP B13), telemetry (B10) and mesh sharding (B17) are not ported;
asking for them raises instead of silently running something else."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import rng
from .state import PayloadMeta, SimConfig, SimState, init_state
from .topology import Topology


class RunMetrics(NamedTuple):
    """Per-run convergence record; field order is JAX's ``RunMetrics``."""

    coverage_at: torch.Tensor  # i32[P]
    converged_at: torch.Tensor  # i32[N]
    overflow_frac: torch.Tensor  # f32 scalar
    order_violations: torch.Tensor  # i32 scalar


def new_metrics(cfg: SimConfig, device) -> RunMetrics:
    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return RunMetrics(
        coverage_at=full((cfg.n_payloads,), -1),
        converged_at=full((cfg.n_nodes,), -1),
        overflow_frac=full((), 0.0, torch.float32),
        order_violations=full((), 0),
    )


def validate(cfg: SimConfig, topo: Topology) -> None:
    """The delay ring must represent every edge delay (sync uses t+1)."""
    max_delay = max(topo.max_delay, 1)
    if max_delay >= cfg.n_delay_slots:
        raise ValueError(
            f"max edge delay {max_delay} rounds needs n_delay_slots > "
            f"{max_delay}, got {cfg.n_delay_slots}"
        )


def run_to_convergence(
    state: SimState,
    meta: PayloadMeta,
    cfg: SimConfig,
    topo: Topology,
    max_rounds: int = 1000,
    telemetry: bool = False,
    mesh=None,
):
    """Advance rounds until every up node holds every injected version or
    ``max_rounds``; returns (SimState, RunMetrics).  Only the packed
    envelope without telemetry on one device is ported."""
    from .packed import packed_supported, run_packed

    if telemetry:
        raise NotImplementedError("telemetry is not ported yet (ROADMAP B10)")
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (B17)")
    validate(cfg, topo)
    if not packed_supported(cfg, topo):
        raise NotImplementedError(
            "the dense round is not ported yet (ROADMAP B13); this "
            "configuration is outside the packed envelope"
        )
    return run_packed(state, meta, cfg, topo, max_rounds)


def new_sim(cfg: SimConfig, seed: int = 0, device="cuda") -> SimState:
    return init_state(cfg, rng.prng_key(seed, resolve_device(device)))
