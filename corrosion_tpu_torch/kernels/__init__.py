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
- K19 `TRACE_ROW` — `sim.telemetry.record_row`;
- K9's latency entry `FAULT_EDGES_DELAY` (K9's launcher, counted apart)
  — `sim.faults.fault_edge_delay`, `fault_edge_jitter`,
  `fault_session_delay`, `fault_session_effects` and
  `fault_wire_effects` under a plan with delay or jitter factors;
- K10's jitter stream `BROADCAST_SCATTER_JITTER` (K10's launcher,
  counted apart) — `sim.packed.scatter_sending_lossy` in a round with
  jitter;
- K3's delay entry `SYNC_PULL_DELAY` (K3's launcher, counted apart) —
  `sim.packed.sync_pull` with session delays (the metered entry takes
  them too, and counts as itself);
- the dense round's fault entries, each counted apart: K12's
  `DENSE_BROADCAST_FAULT` (its own C entry, a second instantiation of
  the broadcast kernel) — `sim.broadcast.broadcast_send` with the plan's
  loss or jitter; K13's delay entry `DENSE_SYNC_DELAY` (K13's launcher)
  — `sim.sync.sync_pull_dense` with session delays; K11's dense entry
  `NODE_FAULTS_DENSE` — `sim.faults.apply_node_faults`; K14's exit mode
  `DENSE_GAPS_ROWS_EXIT`, `DENSE_GAPS_FINISH_EXIT` (K14's launchers) —
  `sim.round.dense_record` with a fault plan's horizon;
- K9's matrix entry (K9m) `FAULT_EDGES_MATRIX`, `FAULT_REACH_MATRIX` (in
  K9's source, one row each) — the same `sim.faults` queries on a matrix
  plan's round slice (`RoundFaults`).

- the topology axis (PR 10): K20 `EDGE_SLOTS`, `DEGREE_CAPS`,
  `EDGE_REACH` (``edge_classes.cu``, one row each) —
  `sim.topology.edge_slot`, `apply_degree_caps`, `tiered_reach_`; K10's
  tiered instantiation `BROADCAST_SCATTER_TIERED` (K10's source) —
  `sim.packed.scatter_sending_lossy` under tiered loss; K12's tiered
  instantiation `DENSE_BROADCAST_TIERED` (K12's source) —
  `sim.broadcast.broadcast_send` under tiered loss; K1's view entry
  `SAMPLE_VIEW` (K1's source) — `topo.sampler.sample_view`; K21
  `PEERSWAP_PARTNER`, `PEERSWAP_SWAP`, `PEERSWAP_LAND`
  (``peerswap.cu``) — `topo.sampler.peerswap_partner`,
  `peerswap_apply`.

- the protocol axis: K10's pull instantiation K10p
  `BROADCAST_PULL`, `BROADCAST_PULL_LOSSY`, `BROADCAST_PULL_TIERED` (one
  C entry, counted by its streams) — `sim.packed.scatter_pull`; K12's
  dense pull K12p `DENSE_PULL`, `DENSE_PULL_LOSSY`, `DENSE_PULL_TIERED`
  — `sim.broadcast.pull_send`; the FIFO delivers K8f `WORD_DELIVER_FIFO`
  and K12f-o `DENSE_DELIVER_FIFO` — `sim.packed.deliver_packed`,
  `sim.broadcast.deliver_dense` under ``ordering="fifo"``; K22
  `ORDER_CHECK_WORDS`, `ORDER_CHECK_DENSE` (``order_check.cu``) —
  `sim.invariants.count_order_violations_`; K20's schedule
  instantiation `DEGREE_CAPS_SCHED` — `proto.schedule.capped_schedule`;
  K18's pull entries `TRACE_WIRE_WORDS_PULL`, `TRACE_WIRE_ROWS_PULL` —
  `sim.telemetry.wire_words_pull_`, `wire_rows_pull_`.

- the membership detect predicates: K23 `DETECT_FULL`, `DETECT_PARTIAL`
  (``membership_detect.cu``, one row each) —
  `sim.telemetry.detect_full_`, `detect_partial_`, after every round of
  `sim.telemetry.run_membership_detect`.

- the lane entries of the seed ensembles (B16; ``sim.lanes``), one row
  each, counted apart from the solo entries they extend: K5
  `THREEFRY_LANES`, `RANDINT_LANES` — `sim.rng.split_lanes`,
  `fold_in_lanes`, `bits_lanes`, `randint_lanes`; K1
  `SAMPLE_TARGETS_LANES` — `sim.pswim.sample_candidates_lanes`; K4
  `MERGE_ENTRIES_LANES` (K4's launcher on the lanes folded into its
  rows) — `sim.pswim.merge_entries_lanes`; K2 `BROADCAST_SCATTER_LANES`
  and K10 `BROADCAST_SCATTER_LOSSY_LANES` — `sim.lanes.scatter_lanes`;
  K3 `SYNC_PULL_LANES` — `sim.lanes.sync_pull_lanes`; K6
  `GAPS_REFRESH_LANES` — `sim.gaps.refresh_gaps_lanes`; K7
  `CONVERGE_ROWS_LANES`, `CONVERGE_FINISH_LANES` —
  `sim.lanes.converge_record_lanes`; K8 `WORD_INJECT_LANES`,
  `WORD_SPEND_LANES`, `WORD_DELIVER_LANES` — `sim.lanes.inject_lanes`,
  `spend_lanes`, `deliver_lanes`; K9 `FAULT_REACH_LANES` —
  `sim.faults.fault_reach_lanes_`; K11 `NODE_FAULTS_LANES` —
  `sim.lanes.apply_round_faults_lanes`.  K9's edge queries draw
  nothing and take the lanes folded into their edge axis through
  `FAULT_EDGES`.

- the dense round's lane entries (B16, dense half; ``sim.dense_lanes``),
  one row a kernel, counted apart from the solo entries: K12
  `DENSE_INJECT_LANES`, `DENSE_BROADCAST_LANES`, `DENSE_DELIVER_LANES` —
  `sim.dense_lanes.inject_dense_lanes`, `broadcast_send_lanes`,
  `deliver_dense_lanes`; K13 `DENSE_SYNC_LANES` —
  `sim.dense_lanes.sync_pull_dense_lanes`; K14 `DENSE_GAPS_ROWS_LANES`,
  `DENSE_GAPS_FINISH_LANES` — `sim.dense_lanes.dense_record_lanes`; K15
  `SWIM_TIMEOUT_LANES`, `SWIM_MERGE_LANES`, `SWIM_APPLY_LANES` —
  `sim.swim_lanes.swim_timeout_lanes_`, `swim_merge_lanes`,
  `swim_apply_lanes_`; K1's uniform lane entry `SAMPLE_UNIFORM_LANES` —
  `sim.swim_lanes.sample_uniform_lanes`; K23 `DETECT_FULL_LANES`,
  `DETECT_PARTIAL_LANES` (a row each) — `sim.telemetry.
  detect_full_lanes_`, `detect_partial_lanes_`.

- the dense fault loop's lane entries (B16d, faults; one row a kernel,
  counted apart): K9m's reach `FAULT_REACH_MATRIX_LANES` —
  `sim.faults.fault_reach_lanes_` on a matrix slice; K11d
  `NODE_FAULTS_DENSE_LANES` — `sim.faults.apply_node_faults_lanes`;
  K12f `DENSE_BROADCAST_FAULT_LANES` — `sim.dense_lanes.
  broadcast_send_lanes` with the plan's loss or jitter; K13d
  `DENSE_SYNC_DELAY_LANES` (K13's lane launcher) — `sim.dense_lanes.
  sync_pull_dense_lanes` with session delays; K14x
  `DENSE_GAPS_ROWS_EXIT_LANES`, `DENSE_GAPS_FINISH_EXIT_LANES` (K14's
  lane launchers) — `sim.dense_lanes.dense_record_lanes` with the plan's
  horizon.  K9's and K9m's edge queries and K9's latency entry draw
  nothing and take the lanes folded into their edge axis.

- the flight recorder on the dense round's lanes (B16r, dense half;
  `TRACE_LANE_ROWS`, one row a kernel, counted apart): K17's dense lane
  entry `TRACE_COVERAGE_DENSE_LANES` — `sim.telemetry.
  coverage_delivered_dense_lanes_`; K18's rows lane entry
  `TRACE_WIRE_ROWS_LANES` — `sim.telemetry.wire_rows_lanes_`; K19's lane
  entry `TRACE_ROW_LANES` (a ticket a lane) — `sim.telemetry.
  record_row_lanes`; the recording forms of launchers that take the
  recorder's outputs on lanes: K12's `DENSE_BROADCAST_LANES_TRACE`, K12f's
  `DENSE_BROADCAST_FAULT_LANES_TRACE` (frames and bytes a row, dropped
  frames a lane) — `sim.dense_lanes.broadcast_send_lanes`; K13's
  `DENSE_SYNC_LANES_TRACE`, K13d's `DENSE_SYNC_DELAY_LANES_TRACE` (grant
  counts a lane) — `sim.dense_lanes.sync_pull_dense_lanes`; K9's
  `FAULT_EDGES_LANES_COUNT`, its latency entry's
  `FAULT_EDGES_DELAY_LANES_COUNT` and K9m's
  `FAULT_EDGES_MATRIX_LANES_COUNT` (cut and refused counts a lane, the
  lanes folded) — `sim.faults.fault_wire_effects`,
  `fault_session_effects`, `fault_session_refused` with a ``[K]`` count.

- the topology axis and PeerSwap on the dense round's lanes (B16t,
  B16s; one row a kernel, counted apart from the solo entries): K20's
  `EDGE_SLOTS_LANES`, `DEGREE_CAPS_LANES`, `EDGE_REACH_LANES` —
  `sim.topology.edge_slot_lanes`, `apply_degree_caps_lanes`,
  `tiered_reach_lanes_`; K12t's `DENSE_BROADCAST_TIERED_LANES` and its
  recording form `DENSE_BROADCAST_TIERED_LANES_TRACE` —
  `sim.dense_lanes.broadcast_send_lanes` under tiered loss; K1's view
  lane entry `SAMPLE_VIEW_LANES` — `topo.sampler.sample_view_lanes`; K21
  `PEERSWAP_PARTNER_LANES`, `PEERSWAP_SWAP_LANES`, `PEERSWAP_LAND_LANES`
  — `topo.sampler.peerswap_partner_lanes`, `peerswap_apply_lanes`.

- the protocol variants on the dense round's lanes (B16v; one row a
  kernel, counted apart from the solo entries): K20's schedule lane
  entry `DEGREE_CAPS_SCHED_LANES` — `proto.schedule.capped_schedule_lanes`;
  K12p's lane entry `DENSE_PULL_LANES`, `DENSE_PULL_LOSSY_LANES`,
  `DENSE_PULL_TIERED_LANES` (by its streams) and the recording forms
  `DENSE_PULL_LOSSY_LANES_TRACE`, `DENSE_PULL_TIERED_LANES_TRACE` (dropped
  frames a lane) — `sim.broadcast.pull_send_lanes`; K18's rows-pull lane
  entry `TRACE_WIRE_ROWS_PULL_LANES` — `sim.telemetry.
  wire_rows_pull_lanes_`; K12f-o's lane entry `DENSE_DELIVER_FIFO_LANES`
  — `sim.dense_lanes.deliver_dense_lanes` under ``ordering="fifo"``;
  K22's u8 lane entry `ORDER_CHECK_DENSE_LANES` (a count a lane) —
  `sim.invariants.count_order_violations_lanes_`.

- latency plans and the flight recorder on the packed round's lanes
  (B16l, B16r's packed half; one row a kernel, counted apart from the
  solo entries): K10j's lane entry `BROADCAST_SCATTER_JITTER_LANES` (K10's
  lane launcher with the jitter stream) — `sim.lanes.scatter_lanes` with
  the plan's jitter; K3's delay lane entry `SYNC_PULL_DELAY_LANES` (K3's
  lane launcher with session delays) — `sim.lanes.sync_pull_lanes`; K17's
  word lane entries `TRACE_COUNTS_LANES`, `TRACE_COVERAGE_LANES` —
  `sim.telemetry.count_words_lanes_`, `coverage_delivered_lanes_`; K18's
  words lane entry `TRACE_WIRE_WORDS_LANES` — `sim.telemetry.
  wire_words_lanes_`; the recording forms `BROADCAST_SCATTER_LOSSY_LANES_
  TRACE`, `BROADCAST_SCATTER_JITTER_LANES_TRACE` (dropped frames a lane)
  and `SYNC_PULL_LANES_TRACE`, `SYNC_PULL_DELAY_LANES_TRACE` (granted
  words a lane).

- metered budgets and the topology streams on the packed round's lanes
  (B16m's budgets and topology; one row a kernel, counted apart from the
  solo entries): K16 on the lanes' rows `BUDGET_WORDS_LANES` (K16's
  launcher on the sending words folded to K·N rows) —
  `sim.lanes.budget_prefix_words_lanes`, in `sim.lanes.spend_lanes`
  under the broadcast governor; K3m's lane entry `SYNC_PULL_METERED_LANES`
  (session delays too) and its recording form
  `SYNC_PULL_METERED_LANES_TRACE` — `sim.lanes.sync_pull_lanes` under a
  sync budget; K10's flat topology stream on the lanes (K10's lane entry,
  `BROADCAST_SCATTER_LOSSY_LANES` and its forms) and the tiered lane
  instantiation `BROADCAST_SCATTER_TIERED_LANES` with its recording form
  `BROADCAST_SCATTER_TIERED_LANES_TRACE` — `sim.lanes.scatter_lanes` with
  ``topo_thr`` or ``tiers``.

- the protocol variants on the packed round's lanes (B16m's rest; one row
  a kernel, counted apart from the solo entries): K10p's lane entry
  `BROADCAST_PULL_LANES`, `BROADCAST_PULL_LOSSY_LANES`,
  `BROADCAST_PULL_TIERED_LANES` (by its streams) and the recording forms
  `BROADCAST_PULL_LOSSY_LANES_TRACE`, `BROADCAST_PULL_TIERED_LANES_TRACE`
  (dropped frames a lane) — `sim.lanes.scatter_pull_lanes`; K18's
  words-pull lane entry `TRACE_WIRE_WORDS_PULL_LANES` — `sim.telemetry.
  wire_words_pull_lanes_`; K8f's lane entry `WORD_DELIVER_FIFO_LANES` —
  `sim.lanes.deliver_lanes` under ``ordering="fifo"``; K22's words lane
  entry `ORDER_CHECK_WORDS_LANES` (a count a lane) — `sim.invariants.
  count_order_violations_lanes_` on packed words.  The eager cadence and the
  fan-out schedule need none (the sync's due mask; K20's schedule lane
  entry).

K17–K19 run only when a run records a trace; so do the telemetry
outputs of K3, K9, K10, K12 and K13 (null pointers otherwise).

A wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other.  `PORTED` groups
the entry points by kernel, in K order (K10 is a second entry point of
K2's source with a row of its own, and so are K1's uniform entry, K3's
metered entry, the dense round's entries of K17 and K18, and this
latency and dense fault entries, which extend an entry of their kernel
and keep counts of their own).
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
    "corro_broadcast_scatter_lossy", 10,
)
SYNC_PULL = Kernel("sync_pull", "sync_pull.cu", "corro_sync_pull", 5)
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

FAULT_EDGES = Kernel(
    "fault_edges", "fault_edges.cu", "corro_fault_edges", 13
)
FAULT_REACH = Kernel("fault_reach", "fault_edges.cu", "corro_fault_reach", 8)
NODE_FAULTS = Kernel("node_faults", "node_faults.cu", "corro_node_faults", 8)

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
DENSE_SYNC = Kernel("dense_sync", "dense_sync.cu", "corro_dense_sync", 9)
DENSE_GAPS_ROWS = Kernel(
    "dense_gaps_rows", "dense_gaps.cu", "corro_dense_gaps_rows", 9
)
DENSE_GAPS_FINISH = Kernel(
    "dense_gaps_finish", "dense_gaps.cu", "corro_dense_gaps_finish", 7
)
SWIM_TIMEOUT = Kernel("swim_timeout", "swim_full.cu", "corro_swim_timeout", 3)
SWIM_MERGE = Kernel("swim_merge", "swim_full.cu", "corro_swim_merge", 2)
SWIM_APPLY = Kernel("swim_apply", "swim_full.cu", "corro_swim_apply", 2)
BUDGET_WORDS = Kernel(
    "budget_words", "budget_words.cu", "corro_budget_words", 3
)
SYNC_PULL_METERED = Kernel(
    "sync_pull_metered", "sync_pull.cu", "corro_sync_pull_metered", 6
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

FAULT_EDGES_DELAY = Kernel(
    "fault_edges_delay", "fault_edges.cu", "corro_fault_edges", 13
)
BROADCAST_SCATTER_JITTER = Kernel(
    "broadcast_scatter_jitter", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy", 10,
)
SYNC_PULL_DELAY = Kernel("sync_pull_delay", "sync_pull.cu", "corro_sync_pull",
                         5)

DENSE_BROADCAST_FAULT = Kernel(
    "dense_broadcast_fault", "dense_phases.cu", "corro_dense_broadcast_fault",
    11,
)
DENSE_SYNC_DELAY = Kernel("dense_sync_delay", "dense_sync.cu",
                          "corro_dense_sync", 9)
NODE_FAULTS_DENSE = Kernel(
    "node_faults_dense", "node_faults.cu", "corro_node_faults_dense", 8
)
DENSE_GAPS_ROWS_EXIT = Kernel(
    "dense_gaps_rows_exit", "dense_gaps.cu", "corro_dense_gaps_rows", 9
)
DENSE_GAPS_FINISH_EXIT = Kernel(
    "dense_gaps_finish_exit", "dense_gaps.cu", "corro_dense_gaps_finish", 7
)

FAULT_EDGES_MATRIX = Kernel(
    "fault_edges_matrix", "fault_edges.cu", "corro_fault_edges_matrix", 5
)
FAULT_REACH_MATRIX = Kernel(
    "fault_reach_matrix", "fault_edges.cu", "corro_fault_reach_matrix", 4
)

EDGE_SLOTS = Kernel("edge_slots", "edge_classes.cu", "corro_edge_slots", 3)
DEGREE_CAPS = Kernel("degree_caps", "edge_classes.cu", "corro_degree_caps",
                     2)
EDGE_REACH = Kernel("edge_reach", "edge_classes.cu", "corro_edge_reach", 2)
BROADCAST_SCATTER_TIERED = Kernel(
    "broadcast_scatter_tiered", "broadcast_scatter.cu",
    "corro_broadcast_scatter_tiered", 10,
)
DENSE_BROADCAST_TIERED = Kernel(
    "dense_broadcast_tiered", "dense_phases.cu",
    "corro_dense_broadcast_tiered", 11,
)
SAMPLE_VIEW = Kernel("sample_view", "sample_targets.cu", "corro_sample_view",
                     4)
PEERSWAP_PARTNER = Kernel("peerswap_partner", "peerswap.cu",
                          "corro_peerswap_partner", 2)
PEERSWAP_SWAP = Kernel("peerswap_swap", "peerswap.cu", "corro_peerswap_swap",
                       3)
PEERSWAP_LAND = Kernel("peerswap_land", "peerswap.cu", "corro_peerswap_land",
                       4)

BROADCAST_PULL = Kernel("broadcast_pull", "broadcast_scatter.cu",
                        "corro_broadcast_pull", 7)
BROADCAST_PULL_LOSSY = Kernel("broadcast_pull_lossy", "broadcast_scatter.cu",
                              "corro_broadcast_pull", 7)
BROADCAST_PULL_TIERED = Kernel("broadcast_pull_tiered",
                               "broadcast_scatter.cu", "corro_broadcast_pull",
                               7)
DENSE_PULL = Kernel("dense_pull", "dense_phases.cu", "corro_dense_pull", 8)
DENSE_PULL_LOSSY = Kernel("dense_pull_lossy", "dense_phases.cu",
                          "corro_dense_pull", 8)
DENSE_PULL_TIERED = Kernel("dense_pull_tiered", "dense_phases.cu",
                           "corro_dense_pull", 8)
WORD_DELIVER_FIFO = Kernel("word_deliver_fifo", "word_phases.cu",
                           "corro_word_deliver_fifo", 7)
DENSE_DELIVER_FIFO = Kernel("dense_deliver_fifo", "dense_phases.cu",
                            "corro_dense_deliver_fifo", 6)
ORDER_CHECK_WORDS = Kernel("order_check_words", "order_check.cu",
                           "corro_order_check_words", 4)
ORDER_CHECK_DENSE = Kernel("order_check_dense", "order_check.cu",
                           "corro_order_check_dense", 4)
DEGREE_CAPS_SCHED = Kernel("degree_caps_sched", "edge_classes.cu",
                           "corro_degree_caps_sched", 3)
TRACE_WIRE_WORDS_PULL = Kernel("trace_wire_words_pull", "trace_wire.cu",
                               "corro_trace_wire_words_pull", 2)
TRACE_WIRE_ROWS_PULL = Kernel("trace_wire_rows_pull", "trace_wire.cu",
                              "corro_trace_wire_rows_pull", 1)

DETECT_FULL = Kernel("detect_full", "membership_detect.cu",
                     "corro_detect_full", 2)
DETECT_PARTIAL = Kernel("detect_partial", "membership_detect.cu",
                        "corro_detect_partial", 3)

THREEFRY_LANES = Kernel("threefry_lanes", "threefry.cu",
                        "corro_threefry_lanes", 4)
RANDINT_LANES = Kernel("randint_lanes", "threefry.cu", "corro_randint_lanes",
                       6)
SAMPLE_TARGETS_LANES = Kernel("sample_targets_lanes", "sample_targets.cu",
                              "corro_sample_targets_lanes", 5)
MERGE_ENTRIES_LANES = Kernel("merge_entries_lanes", "merge_entries.cu",
                             "corro_merge_entries", 5)
BROADCAST_SCATTER_LANES = Kernel("broadcast_scatter_lanes",
                                 "broadcast_scatter.cu",
                                 "corro_broadcast_scatter_lanes", 5)
BROADCAST_SCATTER_LOSSY_LANES = Kernel(
    "broadcast_scatter_lossy_lanes", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
SYNC_PULL_LANES = Kernel("sync_pull_lanes", "sync_pull.cu",
                         "corro_sync_pull_lanes", 6)
GAPS_REFRESH_LANES = Kernel("gaps_refresh_lanes", "gaps_refresh.cu",
                            "corro_gaps_refresh_lanes", 7)
CONVERGE_ROWS_LANES = Kernel("converge_rows_lanes", "converge_fold.cu",
                             "corro_converge_rows_lanes", 8)
CONVERGE_FINISH_LANES = Kernel("converge_finish_lanes", "converge_fold.cu",
                               "corro_converge_finish_lanes", 7)
WORD_INJECT_LANES = Kernel("word_inject_lanes", "word_phases.cu",
                           "corro_word_inject_lanes", 6)
WORD_SPEND_LANES = Kernel("word_spend_lanes", "word_phases.cu",
                          "corro_word_spend_lanes", 5)
WORD_DELIVER_LANES = Kernel("word_deliver_lanes", "word_phases.cu",
                            "corro_word_deliver_lanes", 6)
FAULT_REACH_LANES = Kernel("fault_reach_lanes", "fault_edges.cu",
                           "corro_fault_reach_lanes", 8)
NODE_FAULTS_LANES = Kernel("node_faults_lanes", "node_faults.cu",
                           "corro_node_faults_lanes", 9)

DENSE_INJECT_LANES = Kernel("dense_inject_lanes", "dense_phases.cu",
                            "corro_dense_inject_lanes", 5)
DENSE_BROADCAST_LANES = Kernel("dense_broadcast_lanes", "dense_phases.cu",
                               "corro_dense_broadcast_lanes", 8)
DENSE_DELIVER_LANES = Kernel("dense_deliver_lanes", "dense_phases.cu",
                             "corro_dense_deliver_lanes", 6)
DENSE_SYNC_LANES = Kernel("dense_sync_lanes", "dense_sync.cu",
                          "corro_dense_sync_lanes", 11)
DENSE_GAPS_ROWS_LANES = Kernel("dense_gaps_rows_lanes", "dense_gaps.cu",
                               "corro_dense_gaps_rows_lanes", 10)
DENSE_GAPS_FINISH_LANES = Kernel("dense_gaps_finish_lanes", "dense_gaps.cu",
                                 "corro_dense_gaps_finish_lanes", 8)
SWIM_TIMEOUT_LANES = Kernel("swim_timeout_lanes", "swim_full.cu",
                            "corro_swim_timeout_lanes", 4)
SWIM_MERGE_LANES = Kernel("swim_merge_lanes", "swim_full.cu",
                          "corro_swim_merge_lanes", 3)
SWIM_APPLY_LANES = Kernel("swim_apply_lanes", "swim_full.cu",
                          "corro_swim_apply_lanes", 3)
SAMPLE_UNIFORM_LANES = Kernel("sample_uniform_lanes", "sample_targets.cu",
                              "corro_sample_uniform_lanes", 4)
DETECT_FULL_LANES = Kernel("detect_full_lanes", "membership_detect.cu",
                           "corro_detect_full_lanes", 3)
DETECT_PARTIAL_LANES = Kernel("detect_partial_lanes", "membership_detect.cu",
                              "corro_detect_partial_lanes", 4)

FAULT_REACH_MATRIX_LANES = Kernel("fault_reach_matrix_lanes",
                                  "fault_edges.cu",
                                  "corro_fault_reach_matrix_lanes", 4)
NODE_FAULTS_DENSE_LANES = Kernel("node_faults_dense_lanes", "node_faults.cu",
                                 "corro_node_faults_dense_lanes", 9)
DENSE_BROADCAST_FAULT_LANES = Kernel("dense_broadcast_fault_lanes",
                                     "dense_phases.cu",
                                     "corro_dense_broadcast_fault_lanes", 12)
DENSE_SYNC_DELAY_LANES = Kernel("dense_sync_delay_lanes", "dense_sync.cu",
                                "corro_dense_sync_lanes", 11)
DENSE_GAPS_ROWS_EXIT_LANES = Kernel("dense_gaps_rows_exit_lanes",
                                    "dense_gaps.cu",
                                    "corro_dense_gaps_rows_lanes", 10)
DENSE_GAPS_FINISH_EXIT_LANES = Kernel("dense_gaps_finish_exit_lanes",
                                      "dense_gaps.cu",
                                      "corro_dense_gaps_finish_lanes", 8)

TRACE_COVERAGE_DENSE_LANES = Kernel("trace_coverage_dense_lanes",
                                    "trace_counts.cu",
                                    "corro_trace_coverage_dense_lanes", 4)
TRACE_WIRE_ROWS_LANES = Kernel("trace_wire_rows_lanes", "trace_wire.cu",
                               "corro_trace_wire_rows_lanes", 4)
TRACE_ROW_LANES = Kernel("trace_row_lanes", "trace_row.cu",
                         "corro_trace_row_lanes", 8)
DENSE_BROADCAST_LANES_TRACE = Kernel("dense_broadcast_lanes_trace",
                                     "dense_phases.cu",
                                     "corro_dense_broadcast_lanes", 8)
DENSE_BROADCAST_FAULT_LANES_TRACE = Kernel(
    "dense_broadcast_fault_lanes_trace", "dense_phases.cu",
    "corro_dense_broadcast_fault_lanes", 12)
DENSE_SYNC_LANES_TRACE = Kernel("dense_sync_lanes_trace", "dense_sync.cu",
                                "corro_dense_sync_lanes", 11)
DENSE_SYNC_DELAY_LANES_TRACE = Kernel("dense_sync_delay_lanes_trace",
                                      "dense_sync.cu",
                                      "corro_dense_sync_lanes", 11)
FAULT_EDGES_LANES_COUNT = Kernel("fault_edges_lanes_count", "fault_edges.cu",
                                 "corro_fault_edges", 13)
FAULT_EDGES_DELAY_LANES_COUNT = Kernel("fault_edges_delay_lanes_count",
                                       "fault_edges.cu", "corro_fault_edges",
                                       13)
FAULT_EDGES_MATRIX_LANES_COUNT = Kernel("fault_edges_matrix_lanes_count",
                                        "fault_edges.cu",
                                        "corro_fault_edges_matrix", 5)

EDGE_SLOTS_LANES = Kernel("edge_slots_lanes", "edge_classes.cu",
                          "corro_edge_slots_lanes", 4)
DEGREE_CAPS_LANES = Kernel("degree_caps_lanes", "edge_classes.cu",
                           "corro_degree_caps_lanes", 3)
EDGE_REACH_LANES = Kernel("edge_reach_lanes", "edge_classes.cu",
                          "corro_edge_reach_lanes", 3)
DENSE_BROADCAST_TIERED_LANES = Kernel("dense_broadcast_tiered_lanes",
                                      "dense_phases.cu",
                                      "corro_dense_broadcast_tiered_lanes",
                                      12)
DENSE_BROADCAST_TIERED_LANES_TRACE = Kernel(
    "dense_broadcast_tiered_lanes_trace", "dense_phases.cu",
    "corro_dense_broadcast_tiered_lanes", 12)
SAMPLE_VIEW_LANES = Kernel("sample_view_lanes", "sample_targets.cu",
                           "corro_sample_view_lanes", 5)
PEERSWAP_PARTNER_LANES = Kernel("peerswap_partner_lanes", "peerswap.cu",
                                "corro_peerswap_partner_lanes", 3)
PEERSWAP_SWAP_LANES = Kernel("peerswap_swap_lanes", "peerswap.cu",
                             "corro_peerswap_swap_lanes", 4)
PEERSWAP_LAND_LANES = Kernel("peerswap_land_lanes", "peerswap.cu",
                             "corro_peerswap_land_lanes", 5)

DEGREE_CAPS_SCHED_LANES = Kernel("degree_caps_sched_lanes", "edge_classes.cu",
                                 "corro_degree_caps_sched_lanes", 4)
DENSE_PULL_LANES = Kernel("dense_pull_lanes", "dense_phases.cu",
                          "corro_dense_pull_lanes", 9)
DENSE_PULL_LOSSY_LANES = Kernel("dense_pull_lossy_lanes", "dense_phases.cu",
                                "corro_dense_pull_lanes", 9)
DENSE_PULL_TIERED_LANES = Kernel("dense_pull_tiered_lanes", "dense_phases.cu",
                                 "corro_dense_pull_lanes", 9)
DENSE_PULL_LOSSY_LANES_TRACE = Kernel("dense_pull_lossy_lanes_trace",
                                      "dense_phases.cu",
                                      "corro_dense_pull_lanes", 9)
DENSE_PULL_TIERED_LANES_TRACE = Kernel("dense_pull_tiered_lanes_trace",
                                       "dense_phases.cu",
                                       "corro_dense_pull_lanes", 9)
TRACE_WIRE_ROWS_PULL_LANES = Kernel("trace_wire_rows_pull_lanes",
                                    "trace_wire.cu",
                                    "corro_trace_wire_rows_pull_lanes", 4)
DENSE_DELIVER_FIFO_LANES = Kernel("dense_deliver_fifo_lanes",
                                  "dense_phases.cu",
                                  "corro_dense_deliver_fifo_lanes", 8)
ORDER_CHECK_DENSE_LANES = Kernel("order_check_dense_lanes", "order_check.cu",
                                 "corro_order_check_dense_lanes", 5)

BROADCAST_SCATTER_JITTER_LANES = Kernel(
    "broadcast_scatter_jitter_lanes", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
SYNC_PULL_DELAY_LANES = Kernel("sync_pull_delay_lanes", "sync_pull.cu",
                               "corro_sync_pull_lanes", 6)
TRACE_COUNTS_LANES = Kernel("trace_counts_lanes", "trace_counts.cu",
                            "corro_trace_counts_lanes", 4)
TRACE_COVERAGE_LANES = Kernel("trace_coverage_lanes", "trace_counts.cu",
                              "corro_trace_coverage_lanes", 4)
TRACE_WIRE_WORDS_LANES = Kernel("trace_wire_words_lanes", "trace_wire.cu",
                                "corro_trace_wire_words_lanes", 5)
BROADCAST_SCATTER_LOSSY_LANES_TRACE = Kernel(
    "broadcast_scatter_lossy_lanes_trace", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
BROADCAST_SCATTER_JITTER_LANES_TRACE = Kernel(
    "broadcast_scatter_jitter_lanes_trace", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
SYNC_PULL_LANES_TRACE = Kernel("sync_pull_lanes_trace", "sync_pull.cu",
                               "corro_sync_pull_lanes", 6)
SYNC_PULL_DELAY_LANES_TRACE = Kernel("sync_pull_delay_lanes_trace",
                                     "sync_pull.cu", "corro_sync_pull_lanes",
                                     6)

BROADCAST_SCATTER_TIERED_LANES = Kernel(
    "broadcast_scatter_tiered_lanes", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
BROADCAST_SCATTER_TIERED_LANES_TRACE = Kernel(
    "broadcast_scatter_tiered_lanes_trace", "broadcast_scatter.cu",
    "corro_broadcast_scatter_lossy_lanes", 11)
SYNC_PULL_METERED_LANES = Kernel("sync_pull_metered_lanes", "sync_pull.cu",
                                 "corro_sync_pull_metered_lanes", 7)
SYNC_PULL_METERED_LANES_TRACE = Kernel("sync_pull_metered_lanes_trace",
                                       "sync_pull.cu",
                                       "corro_sync_pull_metered_lanes", 7)
BUDGET_WORDS_LANES = Kernel("budget_words_lanes", "budget_words.cu",
                            "corro_budget_words", 3)

BROADCAST_PULL_LANES = Kernel("broadcast_pull_lanes", "broadcast_scatter.cu",
                              "corro_broadcast_pull_lanes", 8)
BROADCAST_PULL_LOSSY_LANES = Kernel("broadcast_pull_lossy_lanes",
                                    "broadcast_scatter.cu",
                                    "corro_broadcast_pull_lanes", 8)
BROADCAST_PULL_TIERED_LANES = Kernel("broadcast_pull_tiered_lanes",
                                     "broadcast_scatter.cu",
                                     "corro_broadcast_pull_lanes", 8)
BROADCAST_PULL_LOSSY_LANES_TRACE = Kernel("broadcast_pull_lossy_lanes_trace",
                                          "broadcast_scatter.cu",
                                          "corro_broadcast_pull_lanes", 8)
BROADCAST_PULL_TIERED_LANES_TRACE = Kernel(
    "broadcast_pull_tiered_lanes_trace", "broadcast_scatter.cu",
    "corro_broadcast_pull_lanes", 8)
TRACE_WIRE_WORDS_PULL_LANES = Kernel("trace_wire_words_pull_lanes",
                                     "trace_wire.cu",
                                     "corro_trace_wire_words_pull_lanes", 5)
WORD_DELIVER_FIFO_LANES = Kernel("word_deliver_fifo_lanes", "word_phases.cu",
                                 "corro_word_deliver_fifo_lanes", 8)
ORDER_CHECK_WORDS_LANES = Kernel("order_check_words_lanes", "order_check.cu",
                                 "corro_order_check_words_lanes", 5)

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
    "fault_edges_delay": (FAULT_EDGES_DELAY,),
    "broadcast_scatter_jitter": (BROADCAST_SCATTER_JITTER,),
    "sync_pull_delay": (SYNC_PULL_DELAY,),
    "dense_broadcast_fault": (DENSE_BROADCAST_FAULT,),
    "dense_sync_delay": (DENSE_SYNC_DELAY,),
    "node_faults_dense": (NODE_FAULTS_DENSE,),
    "dense_gaps_exit": (DENSE_GAPS_ROWS_EXIT, DENSE_GAPS_FINISH_EXIT),
    "fault_edges_matrix": (FAULT_EDGES_MATRIX,),
    "fault_reach_matrix": (FAULT_REACH_MATRIX,),
    "edge_slots": (EDGE_SLOTS,),
    "degree_caps": (DEGREE_CAPS,),
    "edge_reach": (EDGE_REACH,),
    "broadcast_scatter_tiered": (BROADCAST_SCATTER_TIERED,),
    "dense_broadcast_tiered": (DENSE_BROADCAST_TIERED,),
    "sample_view": (SAMPLE_VIEW,),
    "peerswap": (PEERSWAP_PARTNER, PEERSWAP_SWAP, PEERSWAP_LAND),
    "broadcast_pull": (BROADCAST_PULL,),
    "broadcast_pull_lossy": (BROADCAST_PULL_LOSSY,),
    "broadcast_pull_tiered": (BROADCAST_PULL_TIERED,),
    "dense_pull": (DENSE_PULL,),
    "dense_pull_lossy": (DENSE_PULL_LOSSY,),
    "dense_pull_tiered": (DENSE_PULL_TIERED,),
    "word_deliver_fifo": (WORD_DELIVER_FIFO,),
    "dense_deliver_fifo": (DENSE_DELIVER_FIFO,),
    "order_check_words": (ORDER_CHECK_WORDS,),
    "order_check_dense": (ORDER_CHECK_DENSE,),
    "degree_caps_sched": (DEGREE_CAPS_SCHED,),
    "trace_wire_pull": (TRACE_WIRE_WORDS_PULL,),
    "trace_wire_rows_pull": (TRACE_WIRE_ROWS_PULL,),
    "detect_full": (DETECT_FULL,),
    "detect_partial": (DETECT_PARTIAL,),
    "threefry_lanes": (THREEFRY_LANES, RANDINT_LANES),
    "sample_targets_lanes": (SAMPLE_TARGETS_LANES,),
    "merge_entries_lanes": (MERGE_ENTRIES_LANES,),
    "broadcast_scatter_lanes": (BROADCAST_SCATTER_LANES,),
    "broadcast_scatter_lossy_lanes": (BROADCAST_SCATTER_LOSSY_LANES,),
    "sync_pull_lanes": (SYNC_PULL_LANES,),
    "gaps_refresh_lanes": (GAPS_REFRESH_LANES,),
    "converge_fold_lanes": (CONVERGE_ROWS_LANES, CONVERGE_FINISH_LANES),
    "word_phases_lanes": (WORD_INJECT_LANES, WORD_SPEND_LANES,
                          WORD_DELIVER_LANES),
    "fault_reach_lanes": (FAULT_REACH_LANES,),
    "node_faults_lanes": (NODE_FAULTS_LANES,),
    "dense_phases_lanes": (DENSE_INJECT_LANES, DENSE_BROADCAST_LANES,
                           DENSE_DELIVER_LANES),
    "dense_sync_lanes": (DENSE_SYNC_LANES,),
    "dense_gaps_lanes": (DENSE_GAPS_ROWS_LANES, DENSE_GAPS_FINISH_LANES),
    "swim_full_lanes": (SWIM_TIMEOUT_LANES, SWIM_MERGE_LANES,
                        SWIM_APPLY_LANES),
    "sample_uniform_lanes": (SAMPLE_UNIFORM_LANES,),
    "detect_full_lanes": (DETECT_FULL_LANES,),
    "detect_partial_lanes": (DETECT_PARTIAL_LANES,),
    "fault_reach_matrix_lanes": (FAULT_REACH_MATRIX_LANES,),
    "node_faults_dense_lanes": (NODE_FAULTS_DENSE_LANES,),
    "dense_broadcast_fault_lanes": (DENSE_BROADCAST_FAULT_LANES,),
    "dense_sync_delay_lanes": (DENSE_SYNC_DELAY_LANES,),
    "dense_gaps_exit_lanes": (DENSE_GAPS_ROWS_EXIT_LANES,
                              DENSE_GAPS_FINISH_EXIT_LANES),
    "trace_counts_dense_lanes": (TRACE_COVERAGE_DENSE_LANES,),
    "trace_wire_rows_lanes": (TRACE_WIRE_ROWS_LANES,),
    "trace_row_lanes": (TRACE_ROW_LANES,),
    "dense_broadcast_lanes_trace": (DENSE_BROADCAST_LANES_TRACE,),
    "dense_broadcast_fault_lanes_trace": (DENSE_BROADCAST_FAULT_LANES_TRACE,),
    "dense_sync_lanes_trace": (DENSE_SYNC_LANES_TRACE,),
    "dense_sync_delay_lanes_trace": (DENSE_SYNC_DELAY_LANES_TRACE,),
    "fault_edges_lanes_count": (FAULT_EDGES_LANES_COUNT,),
    "fault_edges_delay_lanes_count": (FAULT_EDGES_DELAY_LANES_COUNT,),
    "fault_edges_matrix_lanes_count": (FAULT_EDGES_MATRIX_LANES_COUNT,),
    "edge_slots_lanes": (EDGE_SLOTS_LANES,),
    "degree_caps_lanes": (DEGREE_CAPS_LANES,),
    "edge_reach_lanes": (EDGE_REACH_LANES,),
    "dense_broadcast_tiered_lanes": (DENSE_BROADCAST_TIERED_LANES,),
    "dense_broadcast_tiered_lanes_trace": (
        DENSE_BROADCAST_TIERED_LANES_TRACE,),
    "sample_view_lanes": (SAMPLE_VIEW_LANES,),
    "peerswap_lanes": (PEERSWAP_PARTNER_LANES, PEERSWAP_SWAP_LANES,
                       PEERSWAP_LAND_LANES),
    "degree_caps_sched_lanes": (DEGREE_CAPS_SCHED_LANES,),
    "dense_pull_lanes": (DENSE_PULL_LANES,),
    "dense_pull_lossy_lanes": (DENSE_PULL_LOSSY_LANES,),
    "dense_pull_tiered_lanes": (DENSE_PULL_TIERED_LANES,),
    "dense_pull_lossy_lanes_trace": (DENSE_PULL_LOSSY_LANES_TRACE,),
    "dense_pull_tiered_lanes_trace": (DENSE_PULL_TIERED_LANES_TRACE,),
    "trace_wire_rows_pull_lanes": (TRACE_WIRE_ROWS_PULL_LANES,),
    "dense_deliver_fifo_lanes": (DENSE_DELIVER_FIFO_LANES,),
    "order_check_dense_lanes": (ORDER_CHECK_DENSE_LANES,),
    "broadcast_scatter_jitter_lanes": (BROADCAST_SCATTER_JITTER_LANES,),
    "sync_pull_delay_lanes": (SYNC_PULL_DELAY_LANES,),
    "trace_counts_lanes": (TRACE_COUNTS_LANES, TRACE_COVERAGE_LANES),
    "trace_wire_lanes": (TRACE_WIRE_WORDS_LANES,),
    "broadcast_scatter_lossy_lanes_trace": (
        BROADCAST_SCATTER_LOSSY_LANES_TRACE,),
    "broadcast_scatter_jitter_lanes_trace": (
        BROADCAST_SCATTER_JITTER_LANES_TRACE,),
    "sync_pull_lanes_trace": (SYNC_PULL_LANES_TRACE,),
    "sync_pull_delay_lanes_trace": (SYNC_PULL_DELAY_LANES_TRACE,),
    "broadcast_scatter_tiered_lanes": (BROADCAST_SCATTER_TIERED_LANES,),
    "broadcast_scatter_tiered_lanes_trace": (
        BROADCAST_SCATTER_TIERED_LANES_TRACE,),
    "sync_pull_metered_lanes": (SYNC_PULL_METERED_LANES,),
    "sync_pull_metered_lanes_trace": (SYNC_PULL_METERED_LANES_TRACE,),
    "budget_words_lanes": (BUDGET_WORDS_LANES,),
    "broadcast_pull_lanes": (BROADCAST_PULL_LANES,),
    "broadcast_pull_lossy_lanes": (BROADCAST_PULL_LOSSY_LANES,),
    "broadcast_pull_tiered_lanes": (BROADCAST_PULL_TIERED_LANES,),
    "broadcast_pull_lossy_lanes_trace": (BROADCAST_PULL_LOSSY_LANES_TRACE,),
    "broadcast_pull_tiered_lanes_trace": (
        BROADCAST_PULL_TIERED_LANES_TRACE,),
    "trace_wire_pull_lanes": (TRACE_WIRE_WORDS_PULL_LANES,),
    "word_deliver_fifo_lanes": (WORD_DELIVER_FIFO_LANES,),
    "order_check_words_lanes": (ORDER_CHECK_WORDS_LANES,),
}
#: the flight recorder on the seed ensembles' lanes (B16r): the lane
#: entries of K17-K19 (K17's dense, grant and coverage entries, K18's rows,
#: rows-pull and words entries) and the recording forms of the lane
#: launchers of K12, K12f, K12t, K12p, K13, K13d on the dense round and of
#: K10, K10j, K10p, K3, K3d on the packed round (their recorder outputs,
#: and K18's words-pull lane entry), and of
#: K9's, K9's latency entry's and K9m's edge queries (their lane-strided
#: counts)
TRACE_LANE_ROWS = ("trace_counts_dense_lanes", "trace_wire_rows_lanes",
                   "trace_row_lanes", "dense_broadcast_lanes_trace",
                   "dense_broadcast_fault_lanes_trace",
                   "dense_sync_lanes_trace", "dense_sync_delay_lanes_trace",
                   "fault_edges_lanes_count",
                   "fault_edges_delay_lanes_count",
                   "fault_edges_matrix_lanes_count",
                   "dense_broadcast_tiered_lanes_trace",
                   "dense_pull_lossy_lanes_trace",
                   "dense_pull_tiered_lanes_trace",
                   "trace_wire_rows_pull_lanes", "trace_counts_lanes",
                   "trace_wire_lanes", "broadcast_scatter_lossy_lanes_trace",
                   "broadcast_scatter_jitter_lanes_trace",
                   "sync_pull_lanes_trace", "sync_pull_delay_lanes_trace",
                   "broadcast_scatter_tiered_lanes_trace",
                   "sync_pull_metered_lanes_trace",
                   "broadcast_pull_lossy_lanes_trace",
                   "broadcast_pull_tiered_lanes_trace",
                   "trace_wire_pull_lanes")
#: the rows of the lane entries, which only a seed ensemble launches
LANE_ROWS = ("threefry_lanes", "sample_targets_lanes", "merge_entries_lanes",
             "broadcast_scatter_lanes", "broadcast_scatter_lossy_lanes",
             "sync_pull_lanes", "gaps_refresh_lanes", "converge_fold_lanes",
             "word_phases_lanes", "fault_reach_lanes", "node_faults_lanes",
             "dense_phases_lanes", "dense_sync_lanes", "dense_gaps_lanes",
             "swim_full_lanes", "sample_uniform_lanes", "detect_full_lanes",
             "detect_partial_lanes", "fault_reach_matrix_lanes",
             "node_faults_dense_lanes", "dense_broadcast_fault_lanes",
             "dense_sync_delay_lanes", "dense_gaps_exit_lanes",
             "edge_slots_lanes", "degree_caps_lanes", "edge_reach_lanes",
             "dense_broadcast_tiered_lanes", "sample_view_lanes",
             "peerswap_lanes", "degree_caps_sched_lanes", "dense_pull_lanes",
             "dense_pull_lossy_lanes", "dense_pull_tiered_lanes",
             "dense_deliver_fifo_lanes", "order_check_dense_lanes",
             "broadcast_scatter_jitter_lanes", "sync_pull_delay_lanes",
             "broadcast_scatter_tiered_lanes", "sync_pull_metered_lanes",
             "budget_words_lanes", "broadcast_pull_lanes",
             "broadcast_pull_lossy_lanes", "broadcast_pull_tiered_lanes",
             "word_deliver_fifo_lanes", "order_check_words_lanes",
             *TRACE_LANE_ROWS)
#: the rows of the flight recorder's kernels, which no telemetry-off run
#: launches
TRACE_ROWS = ("trace_counts", "trace_counts_dense", "trace_wire",
              "trace_wire_rows", "trace_row", "trace_wire_pull",
              "trace_wire_rows_pull", *TRACE_LANE_ROWS)
KERNELS = tuple(k for entries in PORTED.values() for k in entries)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "BROADCAST_PULL", "BROADCAST_PULL_LOSSY", "BROADCAST_PULL_TIERED",
    "DEGREE_CAPS_SCHED", "DENSE_DELIVER_FIFO", "DETECT_FULL",
    "DETECT_PARTIAL", "DENSE_PULL", "BROADCAST_SCATTER_LANES",
    "BROADCAST_SCATTER_LOSSY_LANES", "CONVERGE_FINISH_LANES",
    "CONVERGE_ROWS_LANES", "FAULT_REACH_LANES", "GAPS_REFRESH_LANES",
    "LANE_ROWS", "MERGE_ENTRIES_LANES", "NODE_FAULTS_LANES",
    "RANDINT_LANES", "SAMPLE_TARGETS_LANES", "SYNC_PULL_LANES",
    "THREEFRY_LANES", "WORD_DELIVER_LANES", "WORD_INJECT_LANES",
    "WORD_SPEND_LANES", "DENSE_INJECT_LANES", "DENSE_BROADCAST_LANES",
    "DENSE_DELIVER_LANES", "DENSE_SYNC_LANES", "DENSE_GAPS_ROWS_LANES",
    "DENSE_GAPS_FINISH_LANES", "SWIM_TIMEOUT_LANES", "SWIM_MERGE_LANES",
    "SWIM_APPLY_LANES", "SAMPLE_UNIFORM_LANES", "DETECT_FULL_LANES",
    "DETECT_PARTIAL_LANES", "FAULT_REACH_MATRIX_LANES",
    "NODE_FAULTS_DENSE_LANES", "DENSE_BROADCAST_FAULT_LANES",
    "DENSE_SYNC_DELAY_LANES", "DENSE_GAPS_ROWS_EXIT_LANES",
    "DENSE_GAPS_FINISH_EXIT_LANES", "TRACE_COVERAGE_DENSE_LANES",
    "TRACE_WIRE_ROWS_LANES", "TRACE_ROW_LANES", "DENSE_BROADCAST_LANES_TRACE",
    "DENSE_BROADCAST_FAULT_LANES_TRACE", "DENSE_SYNC_LANES_TRACE",
    "DENSE_SYNC_DELAY_LANES_TRACE", "FAULT_EDGES_LANES_COUNT",
    "FAULT_EDGES_DELAY_LANES_COUNT", "FAULT_EDGES_MATRIX_LANES_COUNT",
    "TRACE_LANE_ROWS", "EDGE_SLOTS_LANES", "DEGREE_CAPS_LANES",
    "EDGE_REACH_LANES", "DENSE_BROADCAST_TIERED_LANES",
    "DENSE_BROADCAST_TIERED_LANES_TRACE", "SAMPLE_VIEW_LANES",
    "PEERSWAP_PARTNER_LANES", "PEERSWAP_SWAP_LANES", "PEERSWAP_LAND_LANES",
    "DENSE_PULL_LOSSY", "DENSE_PULL_TIERED", "ORDER_CHECK_DENSE",
    "ORDER_CHECK_WORDS", "TRACE_WIRE_ROWS_PULL", "TRACE_WIRE_WORDS_PULL",
    "WORD_DELIVER_FIFO", "DEGREE_CAPS_SCHED_LANES", "DENSE_PULL_LANES",
    "DENSE_PULL_LOSSY_LANES", "DENSE_PULL_TIERED_LANES",
    "DENSE_PULL_LOSSY_LANES_TRACE", "DENSE_PULL_TIERED_LANES_TRACE",
    "TRACE_WIRE_ROWS_PULL_LANES", "DENSE_DELIVER_FIFO_LANES",
    "ORDER_CHECK_DENSE_LANES", "BROADCAST_SCATTER_JITTER_LANES",
    "SYNC_PULL_DELAY_LANES", "TRACE_COUNTS_LANES", "TRACE_COVERAGE_LANES",
    "TRACE_WIRE_WORDS_LANES", "BROADCAST_SCATTER_LOSSY_LANES_TRACE",
    "BROADCAST_SCATTER_JITTER_LANES_TRACE", "SYNC_PULL_LANES_TRACE",
    "SYNC_PULL_DELAY_LANES_TRACE", "BROADCAST_SCATTER_TIERED_LANES",
    "BROADCAST_SCATTER_TIERED_LANES_TRACE", "SYNC_PULL_METERED_LANES",
    "SYNC_PULL_METERED_LANES_TRACE", "BUDGET_WORDS_LANES",
    "BROADCAST_PULL_LANES", "BROADCAST_PULL_LOSSY_LANES",
    "BROADCAST_PULL_TIERED_LANES", "BROADCAST_PULL_LOSSY_LANES_TRACE",
    "BROADCAST_PULL_TIERED_LANES_TRACE", "TRACE_WIRE_WORDS_PULL_LANES",
    "WORD_DELIVER_FIFO_LANES", "ORDER_CHECK_WORDS_LANES",
    "BROADCAST_SCATTER", "BROADCAST_SCATTER_JITTER",
    "BROADCAST_SCATTER_LOSSY", "BROADCAST_SCATTER_TIERED", "BUDGET_WORDS",
    "CONVERGE_FINISH", "CONVERGE_ROWS", "DEGREE_CAPS", "DENSE_BROADCAST",
    "DENSE_BROADCAST_FAULT", "DENSE_BROADCAST_TIERED", "DENSE_DELIVER",
    "DENSE_GAPS_FINISH", "DENSE_GAPS_FINISH_EXIT", "DENSE_GAPS_ROWS",
    "DENSE_GAPS_ROWS_EXIT", "DENSE_INJECT", "DENSE_SYNC", "DENSE_SYNC_DELAY",
    "EDGE_REACH", "EDGE_SLOTS",
    "FAULT_EDGES", "FAULT_EDGES_DELAY", "FAULT_EDGES_MATRIX",
    "FAULT_REACH", "FAULT_REACH_MATRIX", "GAPS_REFRESH", "KERNELS", "Kernel",
    "MERGE_ENTRIES", "NODE_FAULTS", "NODE_FAULTS_DENSE", "PEERSWAP_LAND",
    "PEERSWAP_PARTNER", "PEERSWAP_SWAP", "PORTED", "RANDINT",
    "SAMPLE_TARGETS", "SAMPLE_UNIFORM", "SAMPLE_VIEW",
    "SWIM_APPLY", "SWIM_MERGE", "SWIM_TIMEOUT", "SYNC_PULL",
    "SYNC_PULL_DELAY", "SYNC_PULL_METERED", "THREEFRY", "TRACE_COUNTS", "TRACE_COVERAGE",
    "TRACE_COVERAGE_DENSE", "TRACE_ROW", "TRACE_ROWS", "TRACE_WIRE_ROWS",
    "TRACE_WIRE_WORDS", "WORD_DELIVER", "WORD_INJECT", "WORD_SPEND",
    "build_all", "reset_launch_counts",
]
