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
- K7 `CONVERGE_ROWS`, `CONVERGE_FINISH` — `sim.packed.converge_record`
  (with the fault loop's exit mode);
- K8 `WORD_INJECT`, `WORD_SPEND`, `WORD_DELIVER` —
  `sim.packed.inject_packed`, `spend_relay`, `deliver_packed`;
- K9 `FAULT_EDGES`, `FAULT_REACH` — `sim.faults.fault_edge_block`,
  `fault_edge_loss`, `fault_session_refused`, `fault_wire_effects`,
  `fault_reach_`;
- K10 `BROADCAST_SCATTER_LOSSY` (in K2's source) —
  `sim.packed.scatter_sending_lossy`;
- K11 `NODE_FAULTS` — `sim.packed.apply_round_faults`;
- K1's second entry `SAMPLE_UNIFORM` (in K1's source) —
  `sim.swim.sample_uniform`;
- K12 `DENSE_INJECT`, `DENSE_BROADCAST`, `DENSE_DELIVER` —
  `sim.broadcast.inject_dense`, `broadcast_send`, `deliver_dense`;
- K13 `DENSE_SYNC` — `sim.sync.sync_pull_dense`;
- K14 `DENSE_GAPS_ROWS`, `DENSE_GAPS_FINISH` — `sim.round.dense_record`;
- K15 `SWIM_TIMEOUT`, `SWIM_MERGE`, `SWIM_APPLY` —
  `sim.swim.swim_timeout_`, `swim_merge`, `swim_apply_`;
- K16 `BUDGET_WORDS` — `sim.packed.budget_prefix_words`;
- K3's metered entry `SYNC_PULL_METERED` (in K3's source, with K16's
  row scan) — `sim.packed.sync_pull` under a sync budget;
- K17 `TRACE_COUNTS`, `TRACE_COVERAGE`, `TRACE_COVERAGE_DENSE` —
  `sim.telemetry.count_words_`, `coverage_delivered_`,
  `coverage_delivered_dense_`;
- K18 `TRACE_WIRE_WORDS`, `TRACE_WIRE_ROWS` — `sim.telemetry.wire_words_`,
  `wire_rows_`;
- K19 `TRACE_ROW` — `sim.telemetry.record_row`.

K17–K19 run only when a run records a trace; so do the telemetry
outputs of K3, K9, K10, K12 and K13 (null pointers otherwise).

A wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other.  `PORTED` groups
the entry points by kernel, in K order (K10 is a second entry point of
K2's source with a row of its own, and so are K1's uniform entry, K3's
metered entry, and the dense round's entries of K17 and K18).
"""

from .build import Kernel, build_all

SAMPLE_TARGETS = Kernel(
    "sample_targets", "sample_targets.cu", "corro_sample_targets", 4
)
BROADCAST_SCATTER = Kernel(
    "broadcast_scatter", "broadcast_scatter.cu", "corro_broadcast_scatter", 4
)
BROADCAST_SCATTER_LOSSY = Kernel(
    "broadcast_scatter_lossy", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy", 7,
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
    "converge_rows", "converge_fold.cu", "corro_converge_rows", 7
)
CONVERGE_FINISH = Kernel(
    "converge_finish", "converge_fold.cu", "corro_converge_finish", 6
)
WORD_INJECT = Kernel("word_inject", "word_phases.cu", "corro_word_inject", 5)
WORD_SPEND = Kernel("word_spend", "word_phases.cu", "corro_word_spend", 4)
WORD_DELIVER = Kernel(
    "word_deliver", "word_phases.cu", "corro_word_deliver", 5
)

FAULT_EDGES = Kernel("fault_edges", "fault_edges.cu", "corro_fault_edges", 7)
FAULT_REACH = Kernel("fault_reach", "fault_edges.cu", "corro_fault_reach", 8)
NODE_FAULTS = Kernel("node_faults", "node_faults.cu", "corro_node_faults", 6)

SAMPLE_UNIFORM = Kernel(
    "sample_uniform", "sample_targets.cu", "corro_sample_uniform", 3
)
DENSE_INJECT = Kernel(
    "dense_inject", "dense_phases.cu", "corro_dense_inject", 4
)
DENSE_BROADCAST = Kernel(
    "dense_broadcast", "dense_phases.cu", "corro_dense_broadcast", 6
)
DENSE_DELIVER = Kernel(
    "dense_deliver", "dense_phases.cu", "corro_dense_deliver", 4
)
DENSE_SYNC = Kernel("dense_sync", "dense_sync.cu", "corro_dense_sync", 7)
DENSE_GAPS_ROWS = Kernel(
    "dense_gaps_rows", "dense_gaps.cu", "corro_dense_gaps_rows", 8
)
DENSE_GAPS_FINISH = Kernel(
    "dense_gaps_finish", "dense_gaps.cu", "corro_dense_gaps_finish", 6
)
SWIM_TIMEOUT = Kernel("swim_timeout", "swim_full.cu", "corro_swim_timeout", 3)
SWIM_MERGE = Kernel("swim_merge", "swim_full.cu", "corro_swim_merge", 2)
SWIM_APPLY = Kernel("swim_apply", "swim_full.cu", "corro_swim_apply", 2)
BUDGET_WORDS = Kernel(
    "budget_words", "budget_words.cu", "corro_budget_words", 3
)
SYNC_PULL_METERED = Kernel(
    "sync_pull_metered", "sync_pull.cu", "corro_sync_pull_metered", 4
)

TRACE_COUNTS = Kernel(
    "trace_counts", "trace_counts.cu", "corro_trace_counts", 2
)
TRACE_COVERAGE = Kernel(
    "trace_coverage", "trace_counts.cu", "corro_trace_coverage", 2
)
TRACE_COVERAGE_DENSE = Kernel(
    "trace_coverage_dense", "trace_counts.cu", "corro_trace_coverage_dense",
    2,
)
TRACE_WIRE_WORDS = Kernel(
    "trace_wire_words", "trace_wire.cu", "corro_trace_wire_words", 3
)
TRACE_WIRE_ROWS = Kernel(
    "trace_wire_rows", "trace_wire.cu", "corro_trace_wire_rows", 2
)
TRACE_ROW = Kernel("trace_row", "trace_row.cu", "corro_trace_row", 6)

PORTED = {
    "sample_targets": (SAMPLE_TARGETS,),
    "broadcast_scatter": (BROADCAST_SCATTER,),
    "sync_pull": (SYNC_PULL,),
    "merge_entries": (MERGE_ENTRIES,),
    "threefry": (THREEFRY, RANDINT),
    "gaps_refresh": (GAPS_REFRESH,),
    "converge_fold": (CONVERGE_ROWS, CONVERGE_FINISH),
    "word_phases": (WORD_INJECT, WORD_SPEND, WORD_DELIVER),
    "fault_edges": (FAULT_EDGES, FAULT_REACH),
    "broadcast_scatter_lossy": (BROADCAST_SCATTER_LOSSY,),
    "node_faults": (NODE_FAULTS,),
    "sample_uniform": (SAMPLE_UNIFORM,),
    "dense_phases": (DENSE_INJECT, DENSE_BROADCAST, DENSE_DELIVER),
    "dense_sync": (DENSE_SYNC,),
    "dense_gaps": (DENSE_GAPS_ROWS, DENSE_GAPS_FINISH),
    "swim_full": (SWIM_TIMEOUT, SWIM_MERGE, SWIM_APPLY),
    "budget_words": (BUDGET_WORDS,),
    "sync_pull_metered": (SYNC_PULL_METERED,),
    "trace_counts": (TRACE_COUNTS, TRACE_COVERAGE),
    "trace_counts_dense": (TRACE_COVERAGE_DENSE,),
    "trace_wire": (TRACE_WIRE_WORDS,),
    "trace_wire_rows": (TRACE_WIRE_ROWS,),
    "trace_row": (TRACE_ROW,),
}
#: the rows of the flight recorder's kernels, which no telemetry-off run
#: launches
TRACE_ROWS = ("trace_counts", "trace_counts_dense", "trace_wire",
              "trace_wire_rows", "trace_row")
KERNELS = tuple(k for entries in PORTED.values() for k in entries)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "BROADCAST_SCATTER", "BROADCAST_SCATTER_LOSSY", "BUDGET_WORDS",
    "CONVERGE_FINISH", "CONVERGE_ROWS", "DENSE_BROADCAST", "DENSE_DELIVER",
    "DENSE_GAPS_FINISH", "DENSE_GAPS_ROWS", "DENSE_INJECT", "DENSE_SYNC",
    "FAULT_EDGES",
    "FAULT_REACH", "GAPS_REFRESH", "KERNELS", "Kernel", "MERGE_ENTRIES",
    "NODE_FAULTS", "PORTED", "RANDINT", "SAMPLE_TARGETS", "SAMPLE_UNIFORM",
    "SWIM_APPLY", "SWIM_MERGE", "SWIM_TIMEOUT", "SYNC_PULL",
    "SYNC_PULL_METERED", "THREEFRY", "TRACE_COUNTS", "TRACE_COVERAGE",
    "TRACE_COVERAGE_DENSE", "TRACE_ROW", "TRACE_ROWS", "TRACE_WIRE_ROWS",
    "TRACE_WIRE_WORDS", "WORD_DELIVER", "WORD_INJECT", "WORD_SPEND",
    "build_all", "reset_launch_counts",
]
