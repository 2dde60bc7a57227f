"""Simulator state as torch tensors — the port's copy of
``corrosion_tpu/sim/state.py`` (same names, same field order).

Carrier dtypes (see `..device`): u8 stays u8; u32 ``incarnation`` rides
int32 (values are clamped far below 2^31); the PRNG ``key`` is int64
``[2]`` holding the u32 halves.  One layout differs from JAX on
purpose, and only inside the packed envelope (`packed_supported`):
there ``inflight``, the broadcast delay ring, is u32 words
``[D, N, W]`` (int32 carriers) written by an OR scatter on the card,
where JAX keeps dense u8 ``[D, N, P]`` only because XLA has no OR
scatter.  The bits are the same — the sent values are 0/1 — and
`..convert.state_to_numpy` unpacks the ring back to u8.  Outside the
envelope the dense round runs and ``inflight`` is JAX's u8 ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from . import rng

ALIVE, SUSPECT, DOWN = 0, 1, 2


def max_transmissions_for(n_live: int, base: int) -> int:
    """Per-update transmission budget for ``n_live`` members (the port's
    copy of ``corrosion_tpu/core/swim_tuning.py``)."""
    return max(base, round(base * math.log2(max(2, n_live + 2)) / 5.0))


# the scenario axes (ROADMAP B15) and the one value the port runs
_AXIS_DEFAULTS = {
    "peer_sampler": "uniform",
    "dissemination": "push",
    "fanout_schedule": "flat",
    "sync_cadence": "periodic",
    "ordering": "none",
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration: the fields of the JAX ``SimConfig`` that the
    packed and the dense round read, with the same names and defaults.
    The scenario axes (the PeerSwap sampler and the protocol variants,
    ROADMAP B15) keep their fields so a configuration reads the same in
    both packages, and refuse any value but their default.
    ``trace_every`` is the flight recorder's round stride (`.telemetry`):
    row t is recorded only when t % trace_every == 0."""

    n_nodes: int
    n_payloads: int
    n_writers: int = 1
    chunks_per_version: int = 1
    gap_slots: int = 8
    fanout: int = 3
    max_transmissions: int = 10
    rate_limit_bytes_round: Optional[int] = 5 * 1024 * 1024
    sync_interval_rounds: int = 8
    sync_backoff_max_rounds: int = 0
    sync_peers: int = 3
    sync_budget_bytes: Optional[int] = 4 * 1024 * 1024
    swim_full_view: bool = False
    swim_partial_view: bool = False
    member_slots: int = 64
    gossip_entries: int = 8
    down_gc_rounds: int = 600
    couple_membership: bool = True
    announce_interval_rounds: int = 4
    probe_period_rounds: int = 2
    suspect_timeout_rounds: int = 6
    indirect_probes: int = 3
    ring0_first: bool = True
    n_delay_slots: int = 4
    allow_packed: bool = True
    packed_min_cells: int = 10 * 1024 * 1024
    default_payload_bytes: int = 8 * 1024
    trace_every: int = 1
    peer_sampler: str = "uniform"
    dissemination: str = "push"
    fanout_schedule: str = "flat"
    sync_cadence: str = "periodic"
    ordering: str = "none"

    def __post_init__(self) -> None:
        if self.trace_every < 1:
            raise ValueError(
                f"trace_every must be >= 1, got {self.trace_every}"
            )
        wave = self.n_writers * self.chunks_per_version
        if self.n_payloads % wave != 0:
            raise ValueError(
                f"n_payloads={self.n_payloads} must be a multiple of "
                f"n_writers*chunks_per_version={wave} (version-major grid)"
            )
        if self.swim_full_view and self.swim_partial_view:
            raise ValueError("pick ONE of swim_full_view / swim_partial_view")
        if self.swim_partial_view and self.n_nodes > 262144:
            raise ValueError("partial-view SWIM supports at most 2^18 nodes")
        for name, default in _AXIS_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: the scenario axes "
                    "are not ported yet (ROADMAP B15)"
                )

    @classmethod
    def wan_tuned(cls, n_nodes: int, **kw) -> "SimConfig":
        """Cluster-size-adaptive SWIM timing (JAX ``SimConfig.wan_tuned``)."""
        log = max(3, math.ceil(math.log2(n_nodes + 1)))
        kw.setdefault("probe_period_rounds", 2)
        kw.setdefault("suspect_timeout_rounds", log)
        kw.setdefault("indirect_probes", 3)
        kw.setdefault("announce_interval_rounds", max(4, log // 2))
        base = cls.__dataclass_fields__["max_transmissions"].default
        kw.setdefault(
            "max_transmissions", min(15, max_transmissions_for(n_nodes, base))
        )
        return cls(n_nodes=n_nodes, **kw)

    @property
    def n_versions(self) -> int:
        return self.n_payloads // (self.n_writers * self.chunks_per_version)

    def sync_backoff_cap(self) -> int:
        return self.sync_backoff_max_rounds or 4 * self.sync_interval_rounds


def packed_supported(cfg: SimConfig, topo=None) -> bool:
    """The configurations the bitpacked round takes (JAX
    ``packed.packed_supported``; the topology does not enter)."""
    c = cfg.chunks_per_version
    return (
        cfg.allow_packed
        and cfg.n_nodes * cfg.n_payloads >= cfg.packed_min_cells
        and cfg.n_payloads % 32 == 0
        and c in (1, 2, 4, 8, 16, 32)
        and cfg.max_transmissions < 16
    )


# -- (actor, version, chunk) grid views of the payload axis ------------------
# Payload index p = (v * A + a) * C + c (version-major, uniform_payloads).


def chunk_grid(have: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[N, A, V, C] chunk-occupancy grid from have[N, P]."""
    n = have.shape[0]
    g = (have > 0).reshape(
        n, cfg.n_versions, cfg.n_writers, cfg.chunks_per_version
    )
    return g.permute(0, 2, 1, 3)


def complete_versions(have: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[N, A, V]: every chunk of the version held (the apply gate)."""
    return chunk_grid(have, cfg).all(dim=3)


def touched_versions(have: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[N, A, V]: some chunk of the version held."""
    return chunk_grid(have, cfg).any(dim=3)


def grid_to_payload(x_av: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """A per-(actor, version) array [..., A, V] on the payload axis
    [..., P]."""
    swapped = x_av.transpose(-1, -2)  # [..., V, A]
    tiled = swapped.unsqueeze(-1).expand(
        *swapped.shape, cfg.chunks_per_version
    )
    return tiled.reshape(*x_av.shape[:-2], cfg.n_payloads)


def version_active(injected: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """bool[A, V]: some chunk of the version was injected."""
    g = (injected > 0).reshape(
        cfg.n_versions, cfg.n_writers, cfg.chunks_per_version
    )
    return g.any(dim=2).T


def version_heads(touched: torch.Tensor) -> torch.Tensor:
    """i32[N, A] max 1-based version touched (BookedVersions.last())."""
    v = torch.arange(
        1, touched.shape[2] + 1, dtype=torch.int32, device=touched.device
    )
    return (touched.to(torch.int32) * v).amax(dim=2)


MAX_PAYLOAD_BYTES = 64 * 1024


class PayloadMeta(NamedTuple):
    """Static per-payload metadata (i32[P] each)."""

    actor: torch.Tensor
    version: torch.Tensor
    chunk: torch.Tensor
    nchunks: torch.Tensor
    nbytes: torch.Tensor
    round: torch.Tensor


class SimState(NamedTuple):
    """Dynamic per-round state; field order is JAX's ``SimState``."""

    t: torch.Tensor  # i32 scalar, always on the host
    key: torch.Tensor  # int64[2], u32 halves
    have: torch.Tensor  # u8[N, P]
    injected: torch.Tensor  # u8[P]
    relay_left: torch.Tensor  # u8[N, P]
    # u8[D, N, P], or in the packed envelope int32-carried u32 words
    # [D, N, W] (see the module doc)
    inflight: torch.Tensor
    sync_inflight: torch.Tensor  # u8[D, N, P]
    sync_countdown: torch.Tensor  # i32[N]
    sync_backoff: torch.Tensor  # i32[N]
    alive: torch.Tensor  # u8[N]
    incarnation: torch.Tensor  # i32[N] (u32 in JAX)
    group: torch.Tensor  # i32[N]
    view: torch.Tensor  # i8[N, N] full-view beliefs, or [0, 0]
    vinc: torch.Tensor  # i32[N, N] or [0, 0]
    suspect_since: torch.Tensor  # i32[N, N] or [0, 0]
    converged_at: torch.Tensor  # i32[N]
    heads: torch.Tensor  # i32[N, A]
    gap_lo: torch.Tensor  # i32[N, A, K]
    gap_hi: torch.Tensor  # i32[N, A, K]
    pid: torch.Tensor  # i32[N, M]
    pkey: torch.Tensor  # i32[N, M]
    psince: torch.Tensor  # i32[N, M]
    pview: torch.Tensor  # i32[N, 0]: the PeerSwap sampler is not ported yet


def init_pview(cfg: SimConfig, key: torch.Tensor) -> torch.Tensor:
    """i32[N, M] initial member tables: bucket b of node n holds a random
    id with residue b mod M; -1 where the draw lands on self or past N."""
    n, m = cfg.n_nodes, cfg.member_slots
    per = (n + m - 1) // m
    r = rng.randint(key, (n, m), 0, per)
    dev = key.device
    pid = torch.arange(m, dtype=torch.int32, device=dev)[None, :] + m * r
    me = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    return torch.where((pid < n) & (pid != me), pid, -1)


def init_state(cfg: SimConfig, key: torch.Tensor) -> SimState:
    dev = key.device
    n, p = cfg.n_nodes, cfg.n_payloads
    d = cfg.n_delay_slots
    swim_n = n if cfg.swim_full_view else 0
    pm = cfg.member_slots if cfg.swim_partial_view else 0
    keys = rng.split(key, 3)
    key, sub, kview = keys[0], keys[1], keys[2]
    if cfg.swim_partial_view:
        pid = init_pview(cfg, kview)
        pkey = torch.where(pid >= 0, ALIVE, -1).to(torch.int32)
    else:
        pid = torch.zeros((n, 0), dtype=torch.int32, device=dev)
        pkey = torch.zeros((n, pm), dtype=torch.int32, device=dev)

    def z(*shape, dtype=torch.int32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    u8 = torch.uint8
    return SimState(
        # the round counter lives on the host: the round loop reads it
        # every phase, and a host scalar costs no device sync
        t=torch.zeros((), dtype=torch.int32),
        key=key,
        have=z(n, p, dtype=u8),
        injected=z(p, dtype=u8),
        relay_left=z(n, p, dtype=u8),
        inflight=(z(d, n, p // 32) if packed_supported(cfg)
                  else z(d, n, p, dtype=u8)),
        sync_inflight=z(d, n, p, dtype=u8),
        sync_countdown=rng.randint(sub, (n,), 0, cfg.sync_interval_rounds),
        sync_backoff=z(n, fill=cfg.sync_interval_rounds),
        alive=z(n, dtype=u8),
        incarnation=z(n),
        group=z(n),
        view=z(swim_n, swim_n, dtype=torch.int8),
        vinc=z(swim_n, swim_n),
        suspect_since=z(swim_n, swim_n, fill=-1),
        converged_at=z(n, fill=-1),
        heads=z(n, cfg.n_writers),
        gap_lo=z(n, cfg.n_writers, cfg.gap_slots),
        gap_hi=z(n, cfg.n_writers, cfg.gap_slots),
        pid=pid,
        pkey=pkey,
        psince=z(n, pm, fill=-1),
        pview=z(n, 0),
    )


def _cumsum_last(x: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Exact i32 prefix sum over the last axis, two-level blocked as JAX
    ``state._cumsum_last`` does (the same integers either way)."""
    *lead, p = x.shape
    if p % block or p < 2 * block:
        return torch.cumsum(x, dim=-1, dtype=torch.int32)
    xb = x.reshape(*lead, p // block, block)
    within = torch.cumsum(xb, dim=-1, dtype=torch.int32)
    tot = within[..., -1]
    off = torch.cumsum(tot, dim=-1, dtype=torch.int32) - tot
    return (within + off[..., None]).reshape(*lead, p)


def budget_prefix_mask(
    mask: torch.Tensor, budget_bytes: Optional[int], nbytes: torch.Tensor
) -> torch.Tensor:
    """Oldest-first byte budget (JAX ``state.budget_prefix_mask``): keep
    the prefix of True entries along the last axis whose cumulative size
    fits ``budget_bytes``; None is statically unmetered.  Past 32 767
    payloads the sum rides two exact i32 lanes (KiB and sub-KiB), as in
    JAX."""
    if budget_bytes is None:
        return mask
    p = mask.shape[-1]
    if p >= 1 << 21:
        raise ValueError(
            f"byte budget supports at most 2^21-1 payloads, got {p}"
        )
    sizes = torch.where(mask, nbytes.to(torch.int32), 0)
    if p <= 32767:
        return mask & (_cumsum_last(sizes) <= budget_bytes)
    hi = _cumsum_last(sizes >> 10)
    lo = _cumsum_last(sizes & 1023)
    hi = hi + (lo >> 10)
    lo = lo & 1023
    bhi, blo = budget_bytes >> 10, budget_bytes & 1023
    return mask & ((hi < bhi) | ((hi == bhi) & (lo <= blo)))


def optimize_budgets(cfg: SimConfig, meta: PayloadMeta) -> SimConfig:
    """Drop each byte budget that the payloads' total size provably
    cannot reach (JAX ``state.optimize_budgets``)."""
    total = int(meta.nbytes.sum())
    changes = {}
    if (
        cfg.rate_limit_bytes_round is not None
        and total <= cfg.rate_limit_bytes_round
    ):
        changes["rate_limit_bytes_round"] = None
    if cfg.sync_budget_bytes is not None and total <= cfg.sync_budget_bytes:
        changes["sync_budget_bytes"] = None
    return dataclasses.replace(cfg, **changes) if changes else cfg


def uniform_payloads(
    cfg: SimConfig, device, inject_every: int = 1, payload_bytes=None
) -> PayloadMeta:
    """The version-major write-storm payload layout (JAX
    ``state.uniform_payloads``): index p = (v * A + a) * C + c."""
    p = cfg.n_payloads
    n_writers, chunks = cfg.n_writers, cfg.chunks_per_version
    wave = n_writers * chunks
    idx = torch.arange(p, dtype=torch.int32, device=device)
    version = 1 + idx // wave
    actor = (idx % wave) // chunks
    actor_node = (actor * max(1, cfg.n_nodes // n_writers)) % cfg.n_nodes
    size = cfg.default_payload_bytes if payload_bytes is None else payload_bytes
    sizes = torch.as_tensor(size, dtype=torch.int32, device=device)
    sizes = sizes.expand(p).clone() if sizes.ndim == 0 else sizes.reshape(p)
    hi = int(sizes.max()) if p else 0
    if hi > MAX_PAYLOAD_BYTES:
        raise ValueError(
            f"payload sizes must be ≤ {MAX_PAYLOAD_BYTES} B (got {hi})"
        )
    return PayloadMeta(
        actor=actor_node,
        version=version,
        chunk=idx % chunks,
        nchunks=torch.full((p,), chunks, dtype=torch.int32, device=device),
        nbytes=sizes,
        round=((version - 1) * inject_every).to(torch.int32),
    )
