"""The port's hand-written CUDA kernels (``csrc/*.cu``), one `Kernel`
per C entry point.  Their wrappers live beside the plain torch versions
they are checked against, in the sim module of the JAX function each
replaces:

- K1 `SAMPLE_TARGETS` — `sim.pswim.sample_candidates`;
- K2 `BROADCAST_SCATTER` — `sim.packed.scatter_sending`;
- K3 `SYNC_PULL` — `sim.packed.sync_pull`;
- K4 `MERGE_ENTRIES` — `sim.pswim.merge_entries`;
- K5 `THREEFRY`, `RANDINT` — `sim.rng.split`, `fold_in`, `bits`,
  `randint`;
- K6 `GAPS_REFRESH` — `sim.gaps.refresh_gaps`;
- K7 `CONVERGE_ROWS`, `CONVERGE_FINISH` — `sim.packed.converge_record`;
- K8 `WORD_INJECT`, `WORD_SPEND`, `WORD_DELIVER` —
  `sim.packed.inject_packed`, `spend_relay`, `deliver_packed`.

A wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other.  `PORTED` groups
the entry points by kernel, in K order.
"""

from .build import Kernel, build_all

SAMPLE_TARGETS = Kernel(
    "sample_targets", "sample_targets.cu", "corro_sample_targets", 4
)
BROADCAST_SCATTER = Kernel(
    "broadcast_scatter", "broadcast_scatter.cu", "corro_broadcast_scatter", 4
)
SYNC_PULL = Kernel("sync_pull", "sync_pull.cu", "corro_sync_pull", 3)
MERGE_ENTRIES = Kernel(
    "merge_entries", "merge_entries.cu", "corro_merge_entries", 5
)
THREEFRY = Kernel("threefry", "threefry.cu", "corro_threefry", 3)
RANDINT = Kernel("randint", "threefry.cu", "corro_randint", 5)
GAPS_REFRESH = Kernel(
    "gaps_refresh", "gaps_refresh.cu", "corro_gaps_refresh", 6
)
CONVERGE_ROWS = Kernel(
    "converge_rows", "converge_fold.cu", "corro_converge_rows", 6
)
CONVERGE_FINISH = Kernel(
    "converge_finish", "converge_fold.cu", "corro_converge_finish", 5
)
WORD_INJECT = Kernel("word_inject", "word_phases.cu", "corro_word_inject", 5)
WORD_SPEND = Kernel("word_spend", "word_phases.cu", "corro_word_spend", 3)
WORD_DELIVER = Kernel(
    "word_deliver", "word_phases.cu", "corro_word_deliver", 5
)

PORTED = {
    "sample_targets": (SAMPLE_TARGETS,),
    "broadcast_scatter": (BROADCAST_SCATTER,),
    "sync_pull": (SYNC_PULL,),
    "merge_entries": (MERGE_ENTRIES,),
    "threefry": (THREEFRY, RANDINT),
    "gaps_refresh": (GAPS_REFRESH,),
    "converge_fold": (CONVERGE_ROWS, CONVERGE_FINISH),
    "word_phases": (WORD_INJECT, WORD_SPEND, WORD_DELIVER),
}
KERNELS = tuple(k for entries in PORTED.values() for k in entries)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "BROADCAST_SCATTER", "CONVERGE_FINISH", "CONVERGE_ROWS", "GAPS_REFRESH",
    "KERNELS", "Kernel", "MERGE_ENTRIES", "PORTED", "RANDINT",
    "SAMPLE_TARGETS", "SYNC_PULL", "THREEFRY", "WORD_DELIVER", "WORD_INJECT",
    "WORD_SPEND", "build_all", "reset_launch_counts",
]
