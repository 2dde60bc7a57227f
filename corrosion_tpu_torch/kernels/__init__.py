"""The port's hand-written CUDA kernels (``csrc/*.cu``), one `Kernel`
each.  Their wrappers live beside the plain torch versions they are
checked against, in the sim module of the JAX function each replaces:

- K1 `SAMPLE_TARGETS` — `sim.pswim.sample_candidates`;
- K2 `BROADCAST_SCATTER` — `sim.packed.scatter_sending`;
- K3 `SYNC_PULL` — `sim.packed.sync_pull`;
- K4 `MERGE_ENTRIES` — `sim.pswim.merge_entries`.

A wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other.
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

KERNELS = (SAMPLE_TARGETS, BROADCAST_SCATTER, SYNC_PULL, MERGE_ENTRIES)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "BROADCAST_SCATTER", "KERNELS", "Kernel", "MERGE_ENTRIES",
    "SAMPLE_TARGETS", "SYNC_PULL", "build_all", "reset_launch_counts",
]
