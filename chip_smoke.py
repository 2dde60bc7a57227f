"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the twenty-three CUDA kernels K1–K23 (with the latency entries
   of K3, K9 and K10, the dense fault entries of K11–K14, K9's matrix
   entry K9m, K1's view entry, the tiered instantiations of K10 and
   K12, and the protocol axis's instantiations of K8, K10, K12, K18 and
   K20, and the lane entries of K1–K11 for the seed ensembles on the
   packed round and of K12–K15, K1's uniform entry and K23 for those on
   the dense round and the detect loop, and of K9m's reach, K11d, K12f,
   K13d and K14x for the dense round's fault loop, and of K17's dense
   entry, K18's rows entry and K19 with the recording forms of K12,
   K12f, K13, K13d and K9/K9m's counts for the recorder on the dense
   round's lanes, and of K20's slots, caps and reach entries, K12t (with
   its recording form), K1's view entry and K21 for the topology families
   and PeerSwap on the dense round's lanes, and of K12p (with its
   recording forms), K12f-o, K22's u8 entry, K20's schedule and K18's
   rows-pull entry for the protocol variants there) from the twenty-two
   sources in ``corrosion_tpu_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. at the 100k storm's shapes (N = 100000, M = 64, W = 16, F = 3, S = 3,
   k = 8, A = 16, V = 8, C = 4, K = 8; the fault storm's plan: Kb = 2,
   Kl = 1, threshold 38, E up to 300000), call each kernel's wrappers
   and their plain torch versions on the same card tensors, require
   exact equality, and time both (CUDA events around a CUDA-graph replay
   of 20 calls, after warm-up; kernels that update in place are timed
   with their inputs restored before every call, less the restore's own
   time).  The inputs reach each kernel's traps: words with bit 31 set,
   spans 100000, 64 and 1, a per-element maxval and minval 1, gap rows
   with more than K runs, dead rows, self-edges and both sides of the
   partition, probe draws whose size is not a multiple of 128, a wiped
   row, both values of the fault loop's done flag;
   then K1's uniform entry and K12–K15 the same way at the dense paths'
   shapes — partition-heal-10k's (N = 10000, P = 256, A = 4, V = 64,
   K = 8, F = S = 3, D = 3, two regions) for K12–K14, broadcast-1k's
   (N = 1000, A = 8, V = 32) for K14's word-branch shape, the churn's
   (N = 4096, F = 3) for K15 and K1 — with more than K gap runs, byte
   budgets that bind, a loss threshold of 51, SUSPECT cells past the
   timeout, DOWN receivers and refuting nodes;
   then K16, K3's metered entry, K10's topology stream and K6 past 32
   versions at gapstress-25.6k's shapes (N = 25600, P = 8192, W = 256,
   A = 8, V = 128, C = 8, K = 8, F = S = 3, D = 4) and K14 at the
   distortion control's (N = 1024, K = 64) — budgets that bind, a budget
   of 1, empty rows, P = 65536 (the two-lane branch), needs the grant
   cuts to nothing, both loss streams alone and together, a severed
   channel, runs across version-word edges, heads at 32j, V = 40, more
   than 32 runs in a row;
   then the flight recorder's kernels: K17's grant and coverage entries,
   K18 and K19 at the storm's shapes (E = 300000) and gapstress's (rows
   marked gs), K17's dense entry and K18's rows entry at gapstress-1024's
   (N = 1024, P = 8192), and the telemetry outputs of K3 (granted words;
   its metered entry at gapstress's), K9 (cut and refused counts) and
   K10 (dropped frames) at the fault storm's round 5 and under
   gapstress's topology stream, K12 (per-node frames and bytes, dropped
   frames) and K13 (grant counts) at gapstress-1024's — words with bit
   31 set, byte totals past 2^31, a decimated scratch row, a full-view
   row, drops, cuts and refusals;
   then the latency entries at latency-storm-100k's shapes and round 6
   (N = 100000, W = 16, E = 300000, S = 3, D = 4; its plan: the fault
   storm's, then a one-round delay and a one-round jitter on every link
   out of the first sixth, rounds 2-15): K9's (fault delay, jitter
   bound, session delay, on that plan and on one with overlapping
   delays and jitters), K10's jitter stream (alone, with the fault loss,
   with both losses) and K3's delay entry (and its metered entry with
   the same classes), printing that each of the slice's six traps was
   reached: randint's multiplier wrapping to 0, the i32 draw's element
   index, bits of one word in two slots across the ring's wrap, a slot
   already holding an earlier round's grant, overlapping events and
   self-edges, jitter with both loss streams off;
   then the dense fault entries at the dense storms' shapes (N = 100000,
   P = 512, F = S = 3; D = 2 for the fault storm's round 5, D = 4 for
   the latency storm's round 6): K11's dense entry (a wiped row and an
   override, also on the 4096-node full view), K12's fault entry (the
   fault loss, the fault delay, jitter, the dropped count and per-node
   frames), K13's delay entry (unmetered and metered) and K14's exit
   mode, printing that each of their traps was reached: jitter bounds 0,
   1 and 4 on one ring, randint's multiplier wrapping to 0, both loss
   streams on one cell, a session delay of D - 2 into a slot that holds
   grants, a wipe after convergence;
   then K9m's edge and reach entries at fault-storm-1000's shapes (N =
   1000, E = 3000, its matrix plan's round 5: cut and loss slabs) and
   at the forced-matrix full-view storm's (N = 4096, E = 12288, 704 MiB
   of slabs), printing that each of its six traps was reached: absent
   classes as null slabs, (x, x) legs, a loss that compiled to a cut, a
   one-way cut refusing sessions from both ends, the clamp row past the
   horizon, N not a multiple of 32;
   then the topology axis (phase 3h): K20's edge entry at the tiered
   storms' shapes (E = 300000; wan-3x2's AZ delays into D = 3 and
   wan-fly-6r's measured matrix into D = 6, with and without a fault
   delay), its caps entry on hetero-degree's targets [100000, 3], its
   reach entry at E = 100000 and 300000 and on a topology whose
   cross-region tier is at certainty, K10's tiered instantiation at
   storm-wan-3x2's shapes (W = 16; alone, with the fault stream and its
   dropped count, pinned), K12's at broadcast-1k's (N = 1000, P = 256),
   K1's view entry at storm-peerswap-25.6k's (N = 25600, V = 16; counts
   3 and 1, and with full-view beliefs at N = 4096) and K21 at the same
   shapes, printing that each of the twelve traps was reached: the
   matrix's delays 0–5, the last region's remainder clamping its AZ,
   caps 1–3, a padded reach draw, the certainty pin on probes, on the
   packed wire and on the dense wire, the tiered and fault streams
   composing, empty/self/repeated view candidates, the believed-DOWN
   filter, down nodes with unreachable partners and wiped views, and
   g == t % V with several offers to one partner;
   then the protocol axis (phase 3i): K10p (the push-pull response
   scatter: loss-free, with the flat and fault streams, tiered on
   wan-3x2) at the storm's shapes (E = 300000, W = 16, D = 3) under a
   one-way plan's session mask and reverse thresholds (K9), K12p's three
   forms at broadcast-1k's (N = 1000, P = 256, a binding budget), K8f at
   the storm's and K12f-o at broadcast-1k's and at N = 10000 with C = 4,
   K22's word entry at the storm's and its u8 entry at broadcast-1k's
   and the dense storm's, K20's schedule instantiation on the storm's
   targets and K18's pull entries, printing that each of its traps was
   reached: a pull refused only by the reverse cut, reverse tier loss
   under wan-3x2, the pull jitter-free under a jitter plan, a binding
   responder budget, a FIFO arrival whose predecessor is held but for
   one chunk (packed and dense), the origin-row exemption, a decay step
   crossing R composed after the degree caps;
   then membership churn (phase 3j): K23's full entry at N = 64, 1000
   and 4096 (and 1001) and its partial entry at N = 4096 and 100000 (M
   = 64), each from detect_round -1 and from one already set, and K11's
   PeerSwap view row — its word entry at flash-crowd-peerswap-25.6k's
   shapes (N = 25600, V = 16, the join round) and its dense entry at
   broadcast-1k-wan-3x2-peerswap's (N = 1000, P = 256, D = 4) — printing
   that each of the eight traps was reached: an (up, dead) cell at
   SUSPECT, DOWN on (up, up) and (dead, ·) cells, N not a multiple of
   32, pid = -1 with pkey = -1, a dead watcher whose row names dead
   members unmarked, pkey at INC_CLAMP * 4 + 2, detect_round already
   set, a wiped node with a full view row;
   then the 1M path's kernels (phase 3m, after the lane phases) at
   config_fault_storm_1m's shapes (N = 1000000, W = 16, E = 3000000, D =
   2), each against its plain version at full size: K1's uniform entry
   without a view (a [12, N] draw with self candidates, repeats and rows
   left short), K10's fault stream under the 1M plan's round 5 (its loss
   counter reaching 3.84e8) and K7 in both modes, its exit mode timed;
4. run the 512-node seed-7 write storm and fault storm on the card and
   hold their final state digests, rounds and p99 against the pinned JAX
   goldens;
5. with every launch counter at 0, run ``config_write_storm_100k(seed=0)``
   on the card, hold rounds, p99 and the state digest against the pinned
   JAX goldens, and require every entry point of K1–K8 to have launched;
6. with every launch counter at 0 again, run the 100k fault storm alone
   (``run_fault_plan``), hold its rounds, p99 and digest against the
   goldens and require every entry point of K1's table sampler and
   K3–K11 to have launched; then ``config_packed_fault_storm(seed=0)``
   (the fault storm, then its faultless twin) for
   ``fault_over_faultless``; then the 1M-node tier (path 69):
   ``config_fault_storm_1m(seed=0)`` from launch counters at 0 (the
   packed round with ground-truth membership: K1's uniform entry, K2,
   its edge pass, K3 and its mask pass, K5, K6, K7, K8, K9's edge
   queries, K10, K11; no K4, no member sampler, no reach query), its
   rounds, p99 and digest against ``FAULT_STORM_1M_SEED0`` (live JAX's
   unsharded run), converged with no node left out, its wall and peak
   device memory (its profiles run early, after the storms' launch
   profiles: the launches, device ms and idle share a round over the
   whole run, and rounds 0-2 and 16-18 with each kernel's bound from a
   replay of the same rounds, `bounds_million`);
7. each from launch counters at 0: ``config_partition_heal_10k(seed=0)``
   (K1, K4, K5, K12–K14), ``config_broadcast_1k(seed=0)`` and
   ``config_ground_truth_3node(seed=0)`` (K1's uniform entry, K5,
   K12–K14), the 4096-node full-view churn through the solo
   ``run_membership_detect`` (those, K15 and K23's full entry; the same
   run ``membership_churn(4096, seed=0)`` makes through the engine's
   lanes in the churn paths), each
   held against its goldens (heal round, rounds, p99, digest; the
   churn's detect round, digest and false DOWNs);
8. each from launch counters at 0: ``config_write_storm_gapstress(
   seed=1, n_nodes=25600)`` on the packed round (K1, K3's metered
   entry, K4–K8, K10, K16), held against its golden (rounds, both p99s,
   ``gap_overflow_frac_max``, digest), and ``config_gapstress_distortion(
   seed=0, n_nodes=1024)`` on the dense round (K1, K4, K5, K12–K14; K =
   8 and K = 64), held against its golden;
9. the flight recorder: each from launch counters at 0,
   ``config_write_storm_100k(seed=0, telemetry=True)``, the 100k fault
   storm through ``run_fault_plan(telemetry=True)``,
   ``config_write_storm_gapstress(seed=1, n_nodes=25600,
   telemetry=True)``, the same at 1024 nodes and seed 0 (the dense
   round under loss), ``config_broadcast_1k`` and
   ``config_ground_truth_3node`` with ``telemetry=True``: each gives its
   goldens above and its telemetry golden (every summary key but
   ``wire_bytes`` exactly; each round's f32 byte channels within
   (m + 1)·2⁻²⁴ of the total for the m terms JAX adds), K17–K19 launch
   (and on no telemetry-off path above); then
   ``config_fault_storm_telemetry(seed=0)``'s per-round plain and
   telemetry milliseconds, printed with the card;
10. latency-storm-100k from launch counters at 0, without and with the
   recorder, through ``run_fault_plan``: its golden (rounds, p99,
   digest), with the recorder its telemetry golden, and every entry of
   K1, K2, K4–K8, K9's reach and latency entries, K10 and its jitter
   stream, K11 and K3's delay entry launched;
11. each from launch counters at 0, through ``run_fault_plan`` on the
   dense round (``allow_packed=False``): dense-fault-storm-100k without
   and with the recorder (its golden and telemetry golden; K1, K4, K5,
   K9, K11's dense entry, K12 and its fault entry, K13, K14's exit
   mode), dense-latency-storm-100k (its golden; K9's latency entry and
   K13's delay entry), each also equal to the packed run of the same
   storm on the card in have, heads, alive, relay budgets, injected and
   both stamps; then full-view-fault-storm-4096 (JAX's 4096-node
   acceptance storm on full-view SWIM: K1's uniform entry, K15 with K9's
   reach), held against its golden;
12. the matrix plans, each from launch counters at 0 and each requiring
   K9m's entries and no launch of K9's factored ones: fault-storm-1000
   (the fault storm at 1000 nodes, where JAX's ``compile_plan`` picks
   the matrix form; the dense round, partial-view SWIM), printing the
   matrix lowering's host time, then through its entry point
   ``config_packed_fault_storm(seed=0, n_nodes=1000)``; the 3-node
   fault campaign (``demo_plan(seed=0)``) through ``run_fault_plan``
   and through ``run_fault_plan_checked`` (its per-round digest list and
   coverage markers); full-view-fault-storm-4096 and the packed fault
   storm at 4096 (``packed_min_cells=0``) on forced matrix plans, the
   packed one also equal to its factored twin; each held against its
   golden;
13. the topology axis, each from launch counters at 0 through its entry
   point: ``config_write_storm_100k(seed=0, topo_family=...)`` for
   wan-3x2 (also with ``telemetry=True``: its telemetry golden, the
   dropped frames from the tiered stream), wan-fly-6r and hetero-degree,
   ``config_write_storm_100k(seed=0, n_nodes=25600, sampler="peerswap")``
   and ``config_broadcast_1k(seed=0, topo_family="wan-3x2",
   sampler="peerswap")``, each held against its golden (rounds, p99s,
   digest, and under PeerSwap the view's digest) with K20's entries, the
   tiered K10 or K12, K1's view entry and K21 launched where the path
   runs them (and K2, K10's flat entry, K1's table entry and K4 not
   where it does not);
14. the protocol axis, each from launch counters at 0 through its entry
   point: ``config_write_storm_100k(seed=0, proto_family=...)`` for all
   six families (baseline's launches equal path 5's), the 100k fault
   storm and ``topo_family="wan-3x2"`` with ``telemetry=True`` under
   push-pull, ``config_broadcast_1k(seed=0, proto_family=...)`` for
   push-pull (also over flat-lossy and wan-3x2, and with the recorder),
   lab-ordered and lab-ordered-broken, each held against its golden with
   the run's ``order_violations``, with K10p's, K12p's, K8f's, K12f-o's,
   K22's, K20's schedule's and K18's pull entries launched where the path
   runs them and not where it does not;
   then membership churn, each from launch counters at 0 through its
   entry point: ``config_swim_churn_64(seed=0)`` and
   ``membership_churn(4096, seed=0)`` (through the campaign engine, as
   JAX routes them: one lane of the detect loop, K23's full lane entry;
   the config's record also against JAX's ``spec_hash`` and
   ``result_digest``), the same 64-node run through the solo
   ``run_membership_detect`` (K23's full entry),
   ``config_swim_churn_partial(seed=0)`` (one lane, K23's partial lane
   entry, JAX's engine keys) and the same run with ``telemetry=True``
   through the solo ``run_membership_detect`` (K23's partial entry; its
   telemetry golden, the whole trace by its digest),
   ``config_swim_churn_partial(seed=0, n=100000)`` (600 rounds, no
   detection, as in JAX), each with its K23 entry launched once a round
   (and K23 on no other path), and the flash crowd
   (``flash_crowd_events``: the tail quarter down over rounds 0-7, back
   wiped at round 8) through ``run_fault_plan`` on the 100k storm and on
   storm-peerswap-25.6k (K11 with the view row), each held against its
   golden (detect round, detected fraction, false DOWNs, digest; rounds,
   p99s, digest and the view's digest); the topology phase above also
   runs the 100k fault storm over wan-3x2 against its golden;
15. the seed ensembles (B16p), each from launch counters at 0:
   storm-100k-seeds8 and fault-storm-100k-seeds8 (``campaign.spec.
   storm_seeds_spec``, seeds 0-7) through ``campaign.engine.
   run_campaign``, every lane's rounds, p99 and final-state digest and
   the artifact's ``spec_hash`` and ``result_digest`` against the goldens
   pinned from JAX's ``run_campaign``, every lane entry of the path
   launched and no solo entry of a kernel that has one; each lane also
   equal to the port's solo run of its seed on the card, whose 8 walls
   are printed beside the ensemble's with ``max_memory_allocated``;
   fault-storm-100k-lanes16 (seeds 0-15), lanes 0-7 equal to the
   8-lane golden and lanes 8-15 to their solo runs; one lane of the
   storm, equal to the solo storm with each lane entry launched as often
   as its solo entry (phase 3k before the paths
   compares every lane entry at the 8-lane storm's shapes, each lane
   held to the solo entry on its inputs, K10 also at 16 lanes, past
   2^31 flattened); then the dense ensembles (B16d), each from launch
   counters at 0 through ``run_campaign``: broadcast-1k-seeds8
   (``campaign.spec.broadcast_seeds_spec``: config #3 as a cell, the
   default byte budgets), swim-churn-64-seeds8, swim-churn-full-4096-
   seeds8, swim-churn-partial-4096-seeds8 and swim-churn-partial-100k-
   seeds8 (seeds 0-7), each with its lane entries launched and no solo
   entry, its ``spec_hash`` and ``result_digest`` and every lane's
   rounds, detect round or p99, detected fraction, false DOWNs and
   digest against the goldens pinned from live JAX (at 100k lane 0
   against JAX's solo golden, every lane against the golden pinned from
   the card's run whose lanes equalled the port's solo runs); the
   full-4096 and broadcast ensembles' lanes against their solo runs and
   walls beside their 8 solo walls, with ``max_memory_allocated``
   (phase 3l before the paths compares every dense lane entry at K = 8
   on those paths' shapes — broadcast-1k's with the default and a
   binding budget and a loss threshold, the churn paths' P = 1 at
   100k, K15 at 8 × 4096², K23 with lanes that hold, miss, are already
   set or have only dead watchers — each lane held to the solo entry);
   then the dense round's fault ensembles (B16d, faults), each from
   launch counters at 0 through ``run_campaign``: fault-parity-3node
   (seeds 0-7) and fault-campaign-3node (seed 0), the builtin 3-node
   campaigns on their matrix plans, fault-storm-1000-seeds8 (the fault
   storm below the packed envelope, its matrix plan), dense-fault-storm-
   100k-seeds8 and dense-latency-storm-100k-seeds8 (``campaign.spec.
   dense_storm_seeds_spec``, factored plans), each with round_path
   "dense" and the plan's horizon, its lane entries launched and no solo
   entry, its ``spec_hash``, ``result_digest`` and every lane's rounds,
   p99 and digest against its golden, every lane also against the
   port's solo run of its seed on the card (the solo walls beside the
   ensemble's, with ``max_memory_allocated``); at 100k lane 0 against
   JAX's solo golden, and the dense fault storm's lanes against the
   packed fault storm ensemble's golden (phase 3lf before the paths compares
   K9m's reach lane entry at fault-storm-1000's shapes and K11d's, K12f's,
   K13d's and K14x's lane entries at the 100k dense storms' at K = 8,
   each lane held to the solo entry, printing that each trap was
   reached: lanes whose reach draws differ by plan seed, a wipe of lanes
   holding payloads beside an empty one, a jitter slot and a session
   delay that wrap the ring, a session refused in one direction only,
   done flags that flip at the horizon in some lanes only, a wipe after
   convergence);
   then the flight recorder on the dense round's lanes (B16r), each
   from launch counters at 0 through ``run_campaign``: broadcast-1k-
   seeds8 with ``telemetry`` (path 46: its digest and the eight lane
   summaries pinned from live JAX), broadcast-1k-seeds8-wire (path 47,
   ``measure_wire``: its spec_hash, digest and ``wire_bytes``),
   fault-parity-3node with ``telemetry`` and ``trace_dir`` (path 48:
   its digest, eight summaries and the per-lane JSONL under
   ``flight_recorder_out``, read back), dense-fault-storm-100k-
   seeds8 with ``telemetry`` (path 49: its digest, lane 0's summary
   against the solo golden and lanes 1-7's against live JAX's one-seed
   pins, every key but ``wire_bytes`` exactly, ``wire_bytes`` within the
   f32 bound) and dense-latency-storm-100k-seeds8 with ``telemetry``
   (its digest; the latency entry's lane-strided counts),
   swim-churn-partial-4096-seeds8 with ``telemetry`` (path 50: its
   digest, lane 0's summary and ``trace_digest``, every lane's trace
   digest against the ones pinned from a run whose lanes equalled their
   solo runs), each with its recording lane entries launched and no
   solo entry, every other lane's whole trace equal to its solo
   recording run on the card (phase 3lr
   before the paths compares K17's dense lane entry, K18's rows lane
   entry and K19's lane entry at the 8-lane dense fault storm's shapes
   — K19 also on full-view beliefs at 4096 and at trace_every 2's
   scratch row — the recording forms of K12 at broadcast-1k's and K12f,
   K13, K13d at the dense storms', and K9's, its latency entry's and
   K9m's lane-strided counts at the storms', fault-storm-1000's and the
   3-node plan's shapes, each lane held to the solo entry, printing
   that each trap was reached: lanes counting different totals into
   their own slots, bytes past 2^31, a decimated scratch row, a shared
   fault slice, blocks spanning two lanes, one block holding every lane
   of the 3-node plan, a lane without edges);
   then topology families and PeerSwap on the dense round's lanes (B16t,
   B16s), each from launch counters at 0 through ``run_campaign``:
   peer-sampler-frontier (path 51: both samplers × wan-3x2 and
   hetero-degree, 96 nodes, seeds 0-3, ``measure_wire``; also through
   ``config_peer_sampler_frontier``), broadcast-1k-wan-3x2-peerswap-
   seeds8-wire (path 52, lane 0 against JAX's solo golden with the view's
   digest), broadcast-1k-flat-lossy-uniform-seeds8-wire and broadcast-
   1k-wan-fly-6r-uniform-seeds8 (path 53) and dense-storm-wan-3x2-100k-
   seeds8 (path 54: the 100k storm on the dense round over wan-3x2,
   100 000 × 512 × 8 lanes), each with its lane entries launched and no
   solo entry, its ``spec_hash``, ``result_digest`` and every cell's
   per-seed rounds (and ``wire_bytes``; at 100k each lane's p99,
   convergence and digest) against the goldens pinned from live JAX,
   every lane's final state equal to the port's solo run of its cell
   and seed on the card, the solo walls beside the ensemble's with
   ``max_memory_allocated`` (phase 3lt before the paths compares K20's
   slots, caps and reach lane entries, K12t's lane entry and its
   recording form, K1's view lane entry and K21's lane entries at K = 8
   on those paths' shapes, each lane held to the solo entry, printing
   that each trap was reached: lanes whose draws differ by key alone, a
   tier at certainty beside a tier at 0, matrix delay classes and a
   fault delay that wrap the ring, caps below F in some rows only,
   offers that collide inside one lane with the same slot indices in
   another lane, a dead partner, blocks spanning two lanes, a lane
   without edges);
   then the protocol variants and PeerSwap under a fault plan on the
   dense round's lanes (B16v, B16s-f), each from launch counters at 0
   through ``run_campaign``: protocol-frontier (path 55: four protocol
   families × wan-3x2 and flat-lossy, 96 nodes, seeds 0-3,
   ``measure_wire``; also through ``config_protocol_frontier``, whose
   sampler cell is the solo PeerSwap storm's golden), broadcast-1k-
   fanout-decay-seeds8-wire and broadcast-1k-lab-ordered-broken-seeds8-
   wire (path 56, the latter's lane 0 against JAX's solo golden and its
   38 violations), broadcast-1k-wan-3x2-peerswap-fault-seeds8 (path 57:
   PeerSwap under the fault storm's plan, each lane's view against its
   solo fault run), dense-storm-push-pull-100k-seeds8 (path 58: the
   100k storm on the dense round under push-pull, 100 000 × 512 × 8
   lanes) and protocol-frontier-push-pull (path 59: the frontier's
   push-pull cells without the recorder, K12p's lossy and tiered lane
   forms without a dropped slot), each with its lane entries launched
   and no solo entry, its ``spec_hash``, ``result_digest`` and every
   cell's per-seed rounds (and ``wire_bytes`` and ``order_violations``;
   at 100k each lane's
   p99, convergence and digest) against the goldens pinned from live
   JAX, every lane's final state and order count equal to the port's
   solo run of its cell and seed on the card (at 100k lanes 0 and K - 1),
   the solo walls beside the
   ensemble's with ``max_memory_allocated`` (phase 3lv before the paths
   compares K12p's lane entry and its recording forms, K12f-o's, K22's
   u8, K20's schedule and K18's rows-pull lane entries at K = 8 on those
   paths' shapes, each lane held to the solo entry, printing that each
   trap was reached: lanes whose pull keys, reverse draws and plan seeds
   differ, a pull cut in the reverse direction only, a tier at
   certainty on the pull leg, a relay budget the pull reads before the
   push spends it, a FIFO gate that rejects in one lane what it admits
   in another, violation counts that differ by lane with one of them 0,
   a schedule round where the slot count drops with caps below it,
   blocks spanning two lanes, a lane without edges); then latency-
   storm-100k-seeds8 on the packed round (path 60: its ``spec_hash``,
   the pinned 8-lane digest, every lane against its one-seed JAX pin,
   lanes 0 and 7 against their solo runs on the card, the walls beside
   the dense latency
   ensemble's, ``max_memory_allocated`` beyond what earlier paths hold
   and the replayed peak by call site), fault-storm-100k-seeds8 with the
   recorder (path 61: its digest unmoved, the lanes' summaries pinned)
   and the latency storm with ``measure_wire`` and per-lane JSONL (path
   62), every lane's trace its solo recording run's (phase 3lp before
   them compares K10j's and K3d's lane entries, the recording forms and
   K17's and K18's word lane entries at K = 8 on those paths' shapes);
   then metered budgets, the topology families and PeerSwap on the
   packed round's lanes: gapstress-25.6k-seeds8 through
   ``run_seed_ensemble`` with and without the recorder (path 63: lane 0
   JAX's seed-1 golden and its telemetry golden), storm-wan-3x2-100k-
   seeds8 on the packed round through ``run_campaign`` with and without
   the recorder (path 64: its ``spec_hash``, the packed cell's digest,
   every lane the dense lanes' JAX pin, lane 0's trace JAX's), the
   wan-fly-6r and hetero-degree storms (path 65: lane 0 its golden) and
   the PeerSwap storm at 25 600 nodes (path 66: every lane its one-seed
   JAX pin), every lane and trace equal to its solo run on the card,
   each wall beside the solo walls' sum (phase 3lm before them compares
   K16 on the lanes' rows, K3m's lane entry with its delay classes and
   recording form, and K10's flat and tiered lane streams with and
   without the fault loss and the jitter and as recording forms at K = 8
   on those paths' shapes, lanes 0 and K - 1 held to the solo entries,
   printing that each trap was reached: a budget that binds in one lane
   and not in another, a prefix that stops mid-word, a payload larger
   than the budget, a delay class past D - 2 under metering, a tier at
   certainty, lanes whose k_drop, phase keys and plan seeds differ, K16's
   blocks spanning two lanes, a lane without edges); then the protocol
   variants on the packed round's lanes (paths 67-68); then a matrix plan
   on the packed round's lanes (path 70, B16x): the fault storm at 512
   nodes x 512 payloads (its plan compiled to the matrix form, K9m's edge
   entry with the lanes folded into its edges and its reach lane entry)
   through ``run_campaign`` from launch counters at 0, its ``spec_hash``,
   ``result_digest`` and every lane against
   ``PACKED_FAULT_STORM_512_MATRIX_SEEDS8`` (each lane live JAX's
   one-seed run), lanes 0 and 7 equal to their solo runs on the card;
   and the command line (`corrosion_tpu_torch.cli.main`), each path
   from zeroed counters with its launches by kernel: ``python -m
   corrosion_tpu_torch.cli.main sim write-storm-100k --seed 0`` in a
   process of its own, with no ``--device`` (path 71: exit 0, one JSON
   line equal to path 1's record but the walls, its launches reported
   by a ``sitecustomize`` hook at the child's exit, `LAUNCH_HOOK`, and
   its process wall printed), then through ``cli.main`` in this process
   ``sim storm-ab`` at 25 000 nodes three times (path 72: packed and
   dense identical, rounds ``STORM_AB_25000_SEED0``'s, both walls and the
   speedup printed beside the card), ``sim fault-campaign-3node`` (path 73) and
   ``sim campaign run --spec fault-parity-3node`` (path 74) against
   their goldens, and within path 8 the 100k fault storm's trace through
   ``trace_to_registry`` (path 75: the render line for line
   ``FAULT_STORM_100K_SEED0_REGISTRY``, the wire bytes within the f32
   bound);
16. profile the first 3 rounds of both storms (their telemetry-off
   launches held at exact counts, STORM_OFF_LAUNCHES; run
   right after the build, since the profiler's count depends on what
   the process ran before), the
   fault storm's 12-round loss window, 10 partitioned rounds of
   partition-heal-10k, the first 3 rounds of gapstress-25.6k and rounds
   6-8 of latency-storm-100k and of the same config without its latency
   pair, rounds 5-7 of dense-fault-storm-100k and of fault-storm-1000,
   the first 3 rounds of storm-wan-3x2-100k, storm-peerswap-25.6k and
   the push-pull and lab-ordered storms, and the first 3 rounds of
   swim-churn-partial-100k (host wall, device time by
   kernel from ``torch.profiler``, the device's idle share; the storm
   under the baseline family is held to 1520 launches too), and the
   first 3 rounds of the 8-lane storm and fault storm and of one lane,
   beside a solo storm round profiled in the same call, and the first 3
   rounds of the 8-lane swim-churn-partial-100k, churn-full-4096 and
   broadcast-1k rounds beside their solo rounds, and rounds 5-7 of the
   8-lane dense-fault-storm-100k without and with the recorder (with
   ``max_memory_allocated``) beside its solo rounds, and rounds 5-7 of
   the 8-lane dense-storm-wan-3x2-100k and dense-storm-push-pull-100k
   beside their solo rounds (`profile_dense_lanes`), and rounds 5-7 of
   the 8-lane gapstress-25.6k and packed storm-wan-3x2-100k rounds
   beside their solo rounds (`profile_axis_lanes`);
17. print the card line, the kernels JSON line, then the one-line result
   ``{"ok": true, "device": {...}}``.

Nothing runs on the CPU: without a card the script exits at once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet): the bound of every
# kernel here but K5 and K10 is the bytes it must move
HBM_BYTES_PER_S = 3.35e12
# K5 and K10 are bound by integer instructions: Hopper issues 64 INT32
# lanes per SM per clock (4 partitions × 16), over the card's SMs at its
# max clock
INT32_LANES_PER_SM = 64
# u32 operations the kernels do, counted from the sources: a threefry2x32
# hash is 2 + 5 × (4 × 3 + 2) adds, xors and funnel shifts; a randint
# draw is two hashes and their xors, three modulos, a multiply and an add
OPS_PER_HASH = 72
OPS_PER_RANDINT = 2 * (OPS_PER_HASH + 1) + 5
WARMUP, REPS = 3, 20
# calls timed of a plain version that takes a tenth of a second or more,
# and of any call that takes SLOW_CALL_MS or more (no kernel comes near)
SLOW_PLAIN_REPS = 3
SLOW_CALL_MS = 30.0
# device launches (kernels, copies, fills) of `profile_storm`'s first 3
# rounds with the flight recorder off, setup included: the faultless
# storm's and the fault storm's, counted in a process that has run
# nothing else.  Recording must add nothing to a run that does not
# record.  (The port made 1526 and 1560 before the recorder existed;
# K4's redesign dropped its clone and fill, two launches a round, then
# 1520 and 1554; K1's in-kernel draw on unpacked tables and K3's mask
# pass dropped 117 a round: K5's five bucket draws, the five table packs,
# the mask block's 91 operations but one, the fruitful fill and cast,
# then 1169 and 1203; K2's edge pass took the broadcast's and the sync's
# edge-list glue, and K7's one launch its finish and the overflow fold:
# 56.33 a round on the storm, 41.33 on the fault storm, whose broadcast
# keeps its senders and slot glue.)
STORM_OFF_LAUNCHES = 1000
FAULT_STORM_OFF_LAUNCHES = 1079
#: the round of latency-storm-100k the latency comparisons and profile
#: slice: inside the loss, cut, delay and jitter windows, where a delayed
#: slot (6 + 1) % 4 = 3 wraps to 0 under jitter
LATENCY_T = 6
#: the round of dense-fault-storm-100k its entries are compared at and its
#: profile starts from: inside its loss and half-split windows (rounds
#: 0-11 and 4-15)
DENSE_FAULT_T = 5


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _card_line() -> str:
    return _smi("name,power.limit")


def _int32_ops_per_s() -> float:
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def _time_ms(fn, reps=REPS) -> float:
    """Device milliseconds per call: after WARMUP eager calls, ``reps``
    calls are captured in one CUDA graph, whose replay is timed with CUDA
    events — the host's launch overhead stays out of the number.  A call
    whose last eager run took SLOW_CALL_MS or more (a plain version at a
    path's full shapes) is captured SLOW_PLAIN_REPS times at most."""
    for _ in range(WARMUP - 1):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    if start.elapsed_time(end) >= SLOW_CALL_MS:
        reps = min(reps, SLOW_PLAIN_REPS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_eager_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Device milliseconds per call of a function that syncs with the
    host (and so cannot be captured in a graph): CUDA events around
    ``reps`` eager calls after ``warmup``, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_inplace_ms(fn, restore) -> float:
    """`_time_ms` of a function that updates its inputs in place: each
    call runs on inputs ``restore`` put back, and the restore's own time
    is taken off."""
    def both():
        restore()
        fn()

    return _time_ms(both) - _time_ms(restore)


KERNEL_SYMBOLS = (
    "sample_targets_kernel", "broadcast_scatter_kernel", "sync_pull_kernel",
    "merge_scatter_kernel", "merge_apply_kernel", "threefry_kernel",
    "randint_kernel", "gaps_refresh_kernel", "converge_record_kernel",
    "broadcast_rows_kernel", "edge_list_kernel", "inject_kernel",
    "spend_kernel",
    "deliver_kernel", "fault_edges_kernel", "fault_reach_kernel",
    "node_faults_kernel", "sample_uniform_kernel", "dense_inject_kernel",
    "dense_broadcast_kernel", "dense_deliver_kernel", "dense_sync_kernel",
    "dense_gaps_rows_kernel", "dense_gaps_finish_kernel",
    "swim_timeout_kernel", "swim_merge_kernel", "swim_apply_kernel",
    "budget_words_kernel", "sync_pull_metered_kernel", "sync_masks_kernel",
    "gaps_refresh_wide_kernel", "trace_counts_words_kernel",
    "trace_counts_dense_kernel", "trace_wire_words_kernel",
    "trace_wire_rows_kernel", "trace_row_kernel",
    "fault_edges_matrix_kernel", "fault_reach_matrix_kernel",
    "edge_slots_kernel", "degree_caps_kernel", "edge_reach_kernel",
    "sample_view_kernel", "peerswap_partner_kernel", "peerswap_swap_kernel",
    "peerswap_land_kernel", "broadcast_pull_kernel", "dense_pull_kernel",
    "deliver_fifo_kernel", "dense_deliver_fifo_kernel", "order_words_kernel",
    "order_dense_kernel", "degree_caps_sched_kernel",
    "trace_wire_words_pull_kernel", "trace_wire_rows_pull_kernel",
    "detect_full_kernel", "detect_partial_kernel",
)


def _is_symbol(sym: str, key: str) -> bool:
    """Whether profiler kernel name ``key`` is kernel ``sym`` (not just
    one that ends in it, as dense_deliver_kernel ends in
    deliver_kernel)."""
    return re.search(r"(?<!\w)" + sym + r"\b", key) is not None


def _profile(run, rounds, label, setup=None):
    """Where a run's time goes on the card: ``run()`` (which returns its
    host wall in seconds) once to warm up, once on the host clock, then
    again under torch.profiler for device time by kernel (its own run:
    the profiler slows the host); per round over ``rounds``.  With
    ``setup`` each run is ``run(setup())``, the setup outside the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def args():
        return () if setup is None else (setup(),)

    run(*args())
    wall = run(*args())
    profiled = args()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(*profiled)
    # device-side events only: an aten op's CPU event also reports the
    # device time of the kernels it launched, which would count twice
    device = [
        (ev.key, ev.self_device_time_total, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    device.sort(key=lambda row: -row[1])
    total_us = sum(us for _, us, _ in device)
    ours_us = sum(us for key, us, _ in device
                  if any(_is_symbol(sym, key) for sym in KERNEL_SYMBOLS))
    # int64 elementwise kernels: the threefry's carriers (and index casts)
    long_us = sum(us for key, us, _ in device if "<long" in key)
    return {
        "run": label,
        "device_kernel_names": len(device),
        "rounds": rounds,
        "wall_ms_per_round": wall / rounds * 1e3,
        "device_ms_per_round": total_us / 1e3 / rounds,
        "idle_share": 1.0 - total_us / 1e6 / wall,
        "port_kernels_ms_per_round": ours_us / 1e3 / rounds,
        "port_kernel_ms_per_round": {
            sym: sum(us for key, us, _ in device
                     if _is_symbol(sym, key)) / 1e3 / rounds
            for sym in KERNEL_SYMBOLS
            if any(_is_symbol(sym, key) for key, _, _ in device)
        },
        "port_kernel_launches_per_round": {
            sym: sum(c for key, _, c in device
                     if _is_symbol(sym, key)) / rounds
            for sym in KERNEL_SYMBOLS
            if any(_is_symbol(sym, key) for key, _, _ in device)
        },
        "int64_kernels_ms_per_round": long_us / 1e3 / rounds,
        "device_launches_per_round": sum(c for _, _, c in device) / rounds,
        "top": [
            {"kernel": key[:90], "ms_per_round": us / 1e3 / rounds,
             "launches_per_round": count / rounds}
            for key, us, count in device[:10]
        ],
    }


def profile_storm(dev, rounds=3, faults=False, telemetry=False, n=100_000,
                  topo_family=None, sampler=None, proto_family=None):
    """The first ``rounds`` rounds of the 100k faultless storm, or with
    ``faults`` of the fault storm (inside its loss window); with
    ``telemetry`` the flight recorder on; at ``n`` nodes, over a
    topology family, under a peer sampler and a protocol family when
    asked."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import (
        _resolve_topo, _write_storm, storm_fault_plan)
    from corrosion_tpu_torch.sim.topology import Topology

    topo = _resolve_topo(topo_family)
    cfg, meta = _write_storm(n, 512, dev, topo, sampler, proto_family)
    if faults:
        fplan = compile_plan(storm_fault_plan(100_000, 0), cfg, device=dev)

    def run():
        state = new_sim(cfg, 0, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if faults:
            run_fault_plan(state, meta, cfg, Topology(), fplan, rounds,
                           telemetry)
        else:
            run_to_convergence(state, meta, cfg, topo, rounds, telemetry)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = ("fault storm" if faults else "storm") + (
        f"-{topo_family}" if topo_family else "") + (
        f"-{sampler}" if sampler else "") + (
        f"-{proto_family}" if proto_family else "") + f"-{n / 1000:g}k"
    return _profile(run, rounds, label + (" telemetry" if telemetry else ""))


def profile_heal(dev, rounds=10):
    """``rounds`` partitioned dense rounds of partition-heal-10k through
    `round_step_` on an owned state, as `config_partition_heal_10k`
    runs them, after the state is built (setup is outside the clock)."""
    from corrosion_tpu_torch.sim.round import (
        new_metrics, new_sim, own_state, round_step_)
    from corrosion_tpu_torch.sim.runner import heal_config
    from corrosion_tpu_torch.sim.topology import Topology, regions

    n = 10_000
    cfg, meta = heal_config(n, dev)
    topo = Topology(n_regions=2, inter_delay=2)
    region = regions(n, 2, dev)

    def run():
        state = new_sim(cfg, 0, dev)
        state = own_state(state._replace(
            group=(torch.arange(n, device=dev) >= n // 2).to(torch.int32)))
        metrics = new_metrics(cfg, dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                            region)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, "partition-heal-10k")


def profile_gapstress(dev, rounds=3):
    """The burst's first ``rounds`` rounds of gapstress-25.6k (seed 1):
    every version injected at round 0, both budgets binding, 30 % loss.
    `run_packed`'s loop, with its setup (new_sim, pack_state: ~210 M
    cells) outside the clock and the profiler."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta = _gapstress(GAPSTRESS_N, dev)
    topo = Topology(loss=0.3)
    region = regions(cfg.n_nodes, 1, dev)

    def setup():
        state = new_sim(cfg, 1, dev)
        out = (packed.shrink_state(state), packed.pack_state(state, cfg),
               packed.pack_bits(state.injected), new_metrics(cfg, dev))
        torch.cuda.synchronize()
        return out

    last_round = int(meta.round.max())  # run_packed's one read a run

    def run(loop):
        slim, carry, inj, metrics = loop
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            slim, carry, inj, metrics, done = packed.packed_round_step(
                slim, carry, inj, metrics, meta, cfg, topo, region,
                last_round=last_round)
            bool(done)  # run_packed's one host read a round
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, "gapstress-25.6k", setup)


def profile_latency(dev, start=LATENCY_T, rounds=3, latency=True):
    """``rounds`` rounds of latency-storm-100k from round ``start``
    (inside its loss, cut, delay and jitter windows) through the fault
    loop's body, as `run_fault_plan` runs them (its one host read a
    round included); the first ``start`` rounds are setup, outside the
    clock and the profiler.  Without ``latency`` the same rounds of the
    same config under the fault storm's plan alone, for the latency
    pair's cost."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.runner import storm_fault_plan
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta, fplan = _latency_storm(STORM_N, dev)
    if not latency:
        fplan = faults.compile_plan(storm_fault_plan(STORM_N, 0), cfg,
                                    device=dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    horizon = fplan.horizon
    last_round = int(meta.round.max())  # the loop's one read a run

    def step(loop):
        slim, carry, inj, metrics = loop
        t = int(slim.t)
        rf = faults.round_faults(fplan, t)
        slim, carry = packed.apply_round_faults(slim, carry, rf)
        slim, carry, inj, metrics, done = packed.packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region, rf, horizon,
            None, activity[min(t, horizon)], last_round=last_round)
        bool(done)
        return slim, carry, inj, metrics

    def setup():
        state = new_sim(cfg, 0, dev)
        slim = packed.shrink_state(state)
        slim = slim._replace(**{
            name: getattr(slim, name).clone()
            for name in ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey",
                         "psince")})
        loop = (slim, packed.pack_state(state, cfg),
                packed.pack_bits(state.injected), new_metrics(cfg, dev))
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = "latency storm-100k" if latency else "fault storm-100k (D = 4)"
    return _profile(run, rounds, f"{label} rounds {start}-"
                    f"{start + rounds - 1}", setup)


def profile_dense_fault(dev, start=DENSE_FAULT_T, rounds=3):
    """``rounds`` rounds of dense-fault-storm-100k from round ``start``
    (inside its loss and half-split windows) through the dense fault
    loop's body, as `run_fault_plan` runs them (node faults, the round
    with its slice, the one host read of the flag); the first ``start``
    rounds are setup, outside the clock and the profiler."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.round import (
        new_metrics, new_sim, own_state, round_step_)
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta, fplan = _dense_fault_storm(STORM_N, dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    horizon = fplan.horizon

    def step(loop):
        state, metrics = loop
        t = int(state.t)
        rf = faults.round_faults(fplan, t)
        state = faults.apply_node_faults(state, rf)
        state, metrics, done = round_step_(
            state, metrics, meta, cfg, topo, region, None, rf, horizon,
            activity[min(t, horizon)])
        bool(done)
        return state, metrics

    def setup():
        state = own_state(new_sim(cfg, 0, dev))
        state = state._replace(**{
            name: getattr(state, name).clone()
            for name in ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey",
                         "psince")})
        loop = (state, new_metrics(cfg, dev))
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"dense fault storm-100k rounds {start}-"
                    f"{start + rounds - 1}", setup)


def profile_churn_partial(dev, n=100_000, rounds=3):
    """The first ``rounds`` rounds of swim-churn-partial at ``n`` nodes
    through `run_membership_detect`'s body: the dense round, K23's
    partial entry, the one host read of detect_round a round; the churn
    setup is outside the clock and the profiler."""
    from corrosion_tpu_torch.sim.round import (
        new_metrics, own_state, round_step_)
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.state import ALIVE, SimConfig
    from corrosion_tpu_torch.sim.telemetry import detect_partial_, new_detect
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg = SimConfig.wan_tuned(n, n_payloads=1, swim_partial_view=True,
                              probe_period_rounds=1)
    topo = Topology()
    region = regions(n, 1, dev)

    def setup():
        meta, state = churn_setup(cfg, 0, dev)
        out = (meta, own_state(state), new_metrics(cfg, dev),
               state.alive == ALIVE, new_detect(dev))
        torch.cuda.synchronize()
        return out

    def run(loop):
        meta, state, metrics, up, detect = loop
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            state, metrics, _ = round_step_(state, metrics, meta, cfg, topo,
                                            region)
            detect_partial_(detect, state.pid, state.pkey, up, int(state.t))
            int(detect[0])  # the loop's one host read a round
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"swim-churn-partial-{n / 1000:g}k", setup)


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _random_tables(rng, n, m, t):
    """Member tables shaped like the storm's: residue-mapped ids with -1
    empties, keys across ALIVE/SUSPECT/DOWN with incarnations up to the
    clamp (so packed words carry bit 31), psince stamps up to t."""
    ids = np.arange(m)[None, :] + m * rng.integers(0, (n + m - 1) // m, (n, m))
    pid = np.where((ids < n) & (rng.random((n, m)) > 0.1), ids, -1)
    inc = np.where(rng.random((n, m)) < 0.2, rng.integers(1024, 2047, (n, m)),
                   rng.integers(0, 8, (n, m)))
    pkey = np.where(pid >= 0, inc * 4 + rng.integers(0, 3, (n, m)), -1)
    psince = np.where(rng.random((n, m)) < 0.5, rng.integers(0, t + 1, (n, m)),
                      -1)
    return pid, pkey, psince


def _random_words(g, shape, dev, ands=1):
    """Random u32 words in int32 carriers, each bit set with probability
    2^-ands."""
    w = np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    for _ in range(ands):
        w &= g.integers(0, 1 << 32, shape, dtype=np.uint32)
    return torch.as_tensor(w.view(np.int32), device=dev)


def advertised_rows(g, lead, cfg, dev):
    """What K3's mask pass reads, drawn on ``dev`` from a generator seeded
    by ``g``: heads [*lead, A] with 0 and V among them, gap runs [*lead,
    A, G] with empty slots (lo 0), runs past the head, junk slots (lo >
    hi, past V, not positive) and rows whose last slot overflows to the
    head, and have words [*lead, W] whose version groups are held whole,
    in part or not at all (bit 31 among them)."""
    from corrosion_tpu_torch.sim.words import group_low_bits_mask

    gen = torch.Generator(device=dev).manual_seed(int(g.integers(1 << 62)))
    a, v, c = cfg.n_writers, cfg.n_versions, cfg.chunks_per_version
    w = v * a * c // 32

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    heads = ints(0, v + 1, (*lead, a))
    heads = torch.where(coin(0.1, heads.shape), 0, heads)
    heads = torch.where(coin(0.1, heads.shape), v, heads)
    shape = (*lead, a, cfg.gap_slots)
    lo = ints(1, v + 1, shape)
    hi = lo + ints(0, max(2, v // 4), shape)
    lo = torch.where(coin(0.3, shape), 0, lo)
    junk = coin(0.05, shape)
    lo = torch.where(junk, ints(-3, v + 4, shape), lo)
    hi = torch.where(junk, ints(-3, v + 4, shape), hi)
    last = hi[..., -1]
    hi[..., -1] = torch.where(coin(0.1, last.shape),
                              torch.maximum(last, heads), last)

    def words():
        return ints(0, 1 << 32, (*lead, w), torch.int64)

    low = group_low_bits_mask(c) & 0xFFFFFFFF
    smear = (1 << c) - 1 if c < 32 else 0xFFFFFFFF
    held = ((words() & low) * smear) | (words() & words())
    have = torch.where(held >= 1 << 31, held - (1 << 32), held)
    return heads, lo, hi.contiguous(), have.to(torch.int32)


def _grant_words(masks, miss, peers, ok, budget=None, nbytes=None,
                 sdelay=None, d_slots=1):
    """The sync ring words a pull's grants touch (the words K3 reads and
    writes; the rest of the ring it leaves alone): per node and word, one
    a delay class below D - 1 with a granted bit."""
    from corrosion_tpu_torch.sim import packed

    n, s = peers.shape
    w = miss.shape[1]
    granted = torch.empty((n * s, w), dtype=torch.int32, device=miss.device)
    packed.sync_pull_plain(masks, miss, peers, ok,
                           torch.zeros((n, w), dtype=torch.int32,
                                       device=miss.device), budget, nbytes,
                           granted)
    hit = (granted != 0).view(n, s, w)
    if sdelay is None:
        return int(hit.any(1).sum())
    cls = sdelay.view(n, s, 1)
    return sum(int((hit & (cls == c)).any(1).sum())
               for c in range(d_slots - 1))


def _pull_read_bytes(masks, miss, peers, ok, metered=False):
    """The bytes of ``masks`` and ``miss`` a sync pull reads on this data
    (solo [N, 4, W] and [N, W], or lanes [K, N, 4, W] and [K, N, W]): the
    four planes of each peer a live session gathers, and the puller's
    planes 1-3 and miss row — every node's in K3, whose threads read them
    before the sessions; only a node with a live session's in K3m, which
    reads them under ``live``.  A row that two sessions read counts once;
    a lane without sessions reads nothing of them in K3m."""
    n, w = miss.shape[-2], miss.shape[-1]
    p = peers.reshape(-1, n, peers.shape[-1]).long()
    live = ok.reshape(p.shape) & (p >= 0) & (p < n)
    hits = torch.zeros(p.shape[:2], dtype=torch.int32, device=miss.device)
    hits.scatter_add_(1, torch.where(live, p, 0).flatten(1),
                      live.flatten(1).to(torch.int32))
    gathered = hits > 0
    pullers = live.any(2) if metered else torch.ones_like(gathered)
    rows = (int(gathered.sum()) + 3 * int((gathered | pullers).sum())
            + int(pullers.sum()))
    return rows * w * 4


def compare_kernels(dev, seed=0, n=100_000):
    """Phase 3: every kernel against its plain version at storm shapes."""
    from corrosion_tpu_torch.sim import packed, pswim

    m, w, f, s, k = 64, 16, 3, 3, 8
    t, gc = 40, 12
    rng = np.random.default_rng(seed)

    def cuda(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    def words(shape, ands=1):
        return _random_words(rng, shape, dev, ands)

    pid, pkey, psince = _random_tables(rng, n, m, t)
    pid_t, pkey_t, psince_t = cuda(pid), cuda(pkey), cuda(psince)
    rows = []

    # K1: member sampler, the storm's fanout/sync/relay draw (count 3),
    # its buckets drawn in the kernel
    rows.append(compare_sample_members(dev, rng, pid_t, pkey_t, 3))

    # K2: broadcast ring scatter (one region: every edge lands in slot t%D)
    sending = words((n, w), 4)
    dst = cuda(rng.integers(0, n, n * f))
    slot = cuda(np.full(n * f, t % 2))
    ok = cuda(rng.random(n * f) < 0.95, torch.bool)
    ring0 = words((2, n, w), 6)
    got, ref = ring0.clone(), ring0.clone()
    packed.scatter_sending(got, sending, dst, slot, ok, f)
    packed.scatter_sending_plain(ref, sending, dst, slot, ok, f)
    ring_rows = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    rows.append(dict(
        name="broadcast_scatter",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/packed.py:369",
        equal=bool(torch.equal(got, ref)) and _scatter_widths_equal(dev, rng),
        max_abs_err=_max_abs_err(got, ref),
        ms=_time_ms(lambda: packed.scatter_sending(
            ring_k, sending, dst, slot, ok, f)),
        plain_ms=_time_ms(lambda: packed.scatter_sending_plain(
            ring_p, sending, dst, slot, ok, f)),
        # sending rows, the edge arrays, the touched ring rows in and out
        bound_ms=_bound_ms(sending.numel() * 4 + n * f * 9
                           + ring_rows * w * 4 * 2),
    ))
    # K2's edge pass (the broadcast's and the sync's lists) on a target
    # table
    rows += compare_edge_pass(dev, rng, (), n, w, f, s)

    # K3's mask pass at the storm's layout, then the pull on its masks,
    # whose words carry bit 31 (the unsigned-max trap)
    cfg, _ = _storm_cfg(n, dev)
    mask_row, (masks, miss) = compare_sync_masks(dev, rng, cfg, (n,))
    rows.append(mask_row)
    peers = cuda(rng.integers(0, n, (n, s)))
    pok = cuda(rng.random((n, s)) < 0.7, torch.bool)
    buf0 = torch.zeros((n, w), dtype=torch.int32, device=dev)
    got_buf, ref_buf = buf0.clone(), buf0.clone()
    got = packed.sync_pull(masks, miss, peers, pok, got_buf)
    ref = packed.sync_pull_plain(masks, miss, peers, pok, ref_buf)
    eq = torch.equal(got, ref) and torch.equal(got_buf, ref_buf)
    if not bool((ref_buf < 0).any()):
        raise AssertionError("K3 inputs pulled no word with bit 31 set")
    buf_k, buf_p = buf0.clone(), buf0.clone()
    touched = _grant_words(masks, miss, peers, pok)
    rows.append(dict(
        name="sync_pull",
        source="corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        replaces="corrosion_tpu/sim/packed.py:1138",
        equal=bool(eq), max_abs_err=max(_max_abs_err(got_buf, ref_buf),
                                        _max_abs_err(got, ref)),
        ms=_time_ms(lambda: packed.sync_pull(masks, miss, peers, pok, buf_k)),
        plain_ms=_time_ms(lambda: packed.sync_pull_plain(
            masks, miss, peers, pok, buf_p)),
        # the mask and miss rows the sessions read, peers and ok, the slot
        # words the grants touch in and out, fruitful
        bound_ms=_bound_ms(_pull_read_bytes(masks, miss, peers, pok)
                           + n * s * 5 + touched * 4 * 2 + n),
    ))

    # K4: table merge over the storm's entry count, with colliding ids
    rows.append(compare_merge_entries(dev, rng, pid, (pid_t, pkey_t,
                                                      psince_t), f, k, t, gc))
    rows.append(compare_threefry(dev, rng, n, m))
    rows.append(compare_gaps_refresh(dev, rng, n, w))
    rows.append(compare_converge_fold(dev, rng, n, w))
    rows.append(compare_word_phases(dev, rng, n, w, f))
    rows += compare_fault_seam(dev, rng, n, w, f)
    for row in rows:
        row.setdefault("bound_by", "bytes")
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


def _edge_traps(g, dev, lead, n, f):
    """A target table [*lead, N, F] with the edge pass's traps: -1 and
    self targets, two partition groups, SUSPECT and DOWN rows, senders not
    due; the flat delay over two regions (intra 0, inter 1), so both
    delay classes come."""
    from corrosion_tpu_torch.sim.topology import Topology, regions

    targets = g.integers(-1, n, (*lead, n, f))
    me = np.arange(n)[:, None]
    targets = np.where(g.random((*lead, n, f)) < 0.02, me, targets)
    group = (g.random((*lead, n)) < 0.1).astype(np.int32)
    alive = np.where(g.random((*lead, n)) < 0.05,
                     g.integers(1, 3, (*lead, n)), 0).astype(np.uint8)
    due = g.random((*lead, n)) < 0.7

    def on(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    topo = Topology(n_regions=2, intra_delay=0, inter_delay=1)
    return (on(targets, torch.int32), on(group, torch.int32),
            on(alive, torch.uint8), on(due, torch.bool), topo,
            regions(n, 2, dev))


def _edge_trap_check(got, targets, label):
    """The edge lists must hold both ok values, self targets and -1
    targets never ok, and (given slots) both delay classes."""
    dst, ok, slot = got
    flat = targets.reshape(ok.shape)
    n, f = targets.shape[-2:]
    me = torch.arange(n, device=ok.device).repeat_interleave(f)
    if not (bool(ok.any()) and not bool(ok.all())):
        raise AssertionError(f"{label}: ok takes one value only")
    if bool((ok & ((flat < 0) | (flat == me))).any()):
        raise AssertionError(f"{label}: a -1 or self target is ok")
    if not bool((flat == me).any()) or not bool((flat < 0).any()):
        raise AssertionError(f"{label}: no self or -1 target drawn")
    if slot is not None and torch.unique(slot).numel() != 2:
        raise AssertionError(f"{label}: one delay class only")
    print(f"edge trap {label} reached: ok both ways, -1 and self targets "
          "never ok", flush=True)


def compare_edge_pass(dev, g, lead, n, w, f, s, timed=True):
    """K2's edge pass at the broadcast's shapes (the flat slot) and the
    sync's (the due mask, no slot), solo (``lead`` ()) or on the lanes folded into the rows
    (``lead`` (K,)), each against its plain version; on the lanes each
    lane is also held to the solo entry."""
    from corrosion_tpu_torch.sim import packed

    targets, group, alive, due, topo, region = _edge_traps(g, dev, lead, n,
                                                           f)
    peers, *_ = _edge_traps(g, dev, lead, n, s)
    lanes = lead[0] if lead else 1
    t, d = 40, 2
    sfx = "_lanes" if lead else ""
    rows = []
    for label, tab, due_, topo_ in (("edge_list", targets, None, topo),
                                    ("edge_list_sync", peers, due, None)):
        args = (tab, group, alive, due_, topo_, region, t, d)
        got = packed.edge_list(*args)
        want = packed.edge_list_plain(*args)
        equal = all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(got, want))
        _edge_trap_check(got, tab, label + sfx)
        if lead:
            solo = packed.edge_list(tab[-1], group[-1], alive[-1],
                                    None if due_ is None else due_[-1],
                                    topo_, region, t, d)
            _solo_trap(label + sfx, [x[-1] for x in got if x is not None],
                       [x for x in solo if x is not None])
        e = tab.numel()
        # the targets in; dst, ok (and slot) out; group, alive (and due or
        # region) read once
        nbytes = (e * 4 + e * 4 + e + (e * 4 if topo_ else 0)
                  + lanes * n * 5 + (lanes * n if due_ is not None else 0)
                  + (n * 4 if topo_ else 0))
        rows.append(_row(
            label + sfx, "corrosion_tpu_torch/kernels/csrc/"
            "broadcast_scatter.cu",
            "corrosion_tpu/sim/packed.py:369" if topo_
            else "corrosion_tpu/sim/packed.py:1138",
            equal, max(_max_abs_err(a, b) for a, b in zip(got, want)
                       if a is not None),
            _timed(timed, lambda: packed.edge_list(*args)),
            _timed(timed, lambda: packed.edge_list_plain(*args)), nbytes,
            kernel="edge_list" + sfx))
    if lead:
        for row in rows:
            row.update(lanes=lanes, replaces=row["replaces"] + _VMAP)
    return rows


def _scatter_widths_equal(dev, g):
    """K2 on the edge pass's lists against its plain version at W = 256
    (gapstress's rows, eight warps a row) and at W = 3 (a row inside a
    warp's span), solo and on three lanes."""
    from corrosion_tpu_torch.sim import packed

    equal = True
    for n, w in ((GAPSTRESS_N, 256), (1000, 3)):
        for lead in ((), (3,)):
            f = 3
            targets, group, alive, _, topo, region = _edge_traps(
                g, dev, lead, n, f)
            sending = _random_words(g, (*lead, n, w), dev, 3)
            ring0 = _random_words(g, (*lead, 2, n, w), dev, 5)
            dst, ok, slot = packed.edge_list(targets, group, alive, None,
                                             topo, region, 7, 2)
            got, ref = ring0.clone(), ring0.clone()
            if lead:
                from corrosion_tpu_torch.sim import lanes as ln

                ln.scatter_lanes(got, sending, dst, slot, ok, f)
                ln.scatter_lanes_plain(ref, sending, dst, slot, ok, f)
            else:
                packed.scatter_sending(got, sending, dst, slot, ok, f)
                packed.scatter_sending_plain(ref, sending, dst, slot, ok, f)
            equal &= bool(torch.equal(got, ref))
    print(f"K2 at W = 256 and W = 3, solo and 3 lanes: equal {equal}",
          flush=True)
    return equal


def _member_traps(g, pid, pkey):
    """K1's traps added to member tables [R, M]: 3 % of buckets repeat
    another bucket of their row (distinct candidates then dedup), a few
    ids past 2^19 - 1 (their +1 spills into the packed key field)."""
    r, m = pid.shape
    dup = torch.as_tensor(g.random((r, m)) < 0.03, device=pid.device)
    src = torch.as_tensor(g.integers(0, m, (r, m)), device=pid.device)
    pid = torch.where(dup, torch.gather(pid, 1, src), pid)
    pkey = torch.where(dup, torch.gather(pkey, 1, src), pkey)
    wide = torch.as_tensor(g.random((r, m)) < 0.001, device=pid.device)
    pid = torch.where(wide, (1 << 19) - 1 + src.to(torch.int32) % 3, pid)
    return pid.contiguous(), pkey.contiguous()


def _member_bound(slots, n, m, count, lanes=1):
    """K1's bound on this draw: the larger of its hashes' u32 operations
    (``over`` draws a node, two hashes each where randint's multiplier is
    not 0, and the two subkeys a lane) and its bytes (the distinct (pid,
    pkey) pairs the draws read, the output).  ``slots`` [.., over, N] are
    the draws; also the slots form's bound (its draws in and the words
    they gather: the narrower function the slots form computed)."""
    from corrosion_tpu_torch.sim import rng

    _, mult = rng.scalar_span(0, m)
    srt = slots.reshape(-1, *slots.shape[-2:]).sort(dim=1).values
    distinct = lanes * n + int((srt[:, 1:] != srt[:, :-1]).sum())
    hashes = slots.numel() * (2 if mult else 1) + 2 * lanes
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    nbytes = distinct * 8 + lanes * (n * count * 4 + 16)
    ops_ms, bytes_ms = ops / rate * 1e3, _bound_ms(nbytes)
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, int32_ops_per_s=rate, bytes=nbytes,
                slots_form_bound_ms=_bound_ms(slots.numel() * 8
                                              + lanes * n * count * 4))


def _member_trap_check(pid, pkey, slots, out, label):
    """The draws reached K1's traps: a packed word with bit 31, an empty,
    a DOWN and a duplicated bucket, an id past 2^19 - 1, and a node left
    short (-1 padding)."""
    from corrosion_tpu_torch.sim import pswim
    from corrosion_tpu_torch.sim.swim import _dup_before

    n = pid.shape[0]
    me = torch.arange(n, device=pid.device)[None, :]
    cand = pid[me, slots.long()]
    key = pkey[me, slots.long()]
    valid = (cand >= 0) & (cand != me) & (key % 4 != pswim.DOWN) & (key >= 0)
    reached = {
        "bit 31": bool((key + 1 >= 4096).any()),
        "empty": bool((cand < 0).any()),
        "DOWN": bool(((key % 4 == pswim.DOWN) & (cand >= 0)).any()),
        "duplicate": bool(_dup_before(cand, valid).any()),
        "id past 2^19 - 1": bool((cand >= (1 << 19) - 1).any()),
        "short": bool((out == -1).any()),
    }
    missed = [k for k, v in reached.items() if not v]
    if missed:
        raise AssertionError(f"{label}: traps not reached: {missed}")
    print(f"{label} traps reached: {sorted(reached)}", flush=True)


def compare_sample_members(dev, g, pid, pkey, count):
    """K1 at the storm's tables (N = 100000, M = 64): the bucket draw in
    the kernel, the tables read unpacked, against the plain composition
    (randint, `_pack_tables`, the candidates' dedup and compaction)."""
    from corrosion_tpu_torch.sim import pswim, rng

    n, m = pid.shape
    pid, pkey = _member_traps(g, pid, pkey)
    key = rng.prng_key(int(g.integers(1 << 30)), dev)
    got = pswim.sample_members(pid, pkey, key, count)
    ref = pswim.sample_members_plain(pid, pkey, key, count)
    slots = rng.randint_plain(key, (4 * count, n), 0, m)
    _member_trap_check(pid, pkey, slots, ref, "K1")
    return dict(
        name="sample_targets",
        source="corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        replaces="corrosion_tpu/sim/pswim.py:82",
        equal=bool(torch.equal(got, ref)), max_abs_err=_max_abs_err(got, ref),
        ms=_time_ms(lambda: pswim.sample_members(pid, pkey, key, count)),
        plain_ms=_time_ms(lambda: pswim.sample_members_plain(
            pid, pkey, key, count)),
        **_member_bound(slots, n, m, count))


def compare_sync_masks(dev, g, cfg, lead, name="sync_masks", timed=True,
                       keep=False):
    """K3's mask pass on rows ``lead`` ([N], or the lanes' [K, N]) of
    `advertised_rows` at ``cfg``'s layout: the row and the (masks, miss)
    it produced, for the pull (with ``keep`` the row holds its inputs
    under "inputs")."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.words import (
        fold_all, fold_any, group_low_bits_mask)

    heads, lo, hi, have = advertised_rows(g, lead, cfg, dev)
    got = packed.sync_masks(heads, lo, hi, have, cfg)
    ref = packed.sync_masks_plain(heads, lo, hi, have, cfg)
    c = cfg.chunks_per_version
    groups = fold_any(have, c) & ~fold_all(have, c) & group_low_bits_mask(c)
    reached = {
        "empty slot": bool((lo == 0).any()),
        "head 0": bool((heads == 0).any()),
        "head V": bool((heads == cfg.n_versions).any()),
        "junk slot": bool(((lo > hi) & (lo > 0)).any()),
        "run past V": bool((hi > cfg.n_versions).any()),
        "partly held version": bool((groups != 0).any()),
        "bit 31 in haves": bool((ref[0][..., 0, :] < 0).any()),
    }
    missed = [k for k, v in reached.items() if not v]
    if missed:
        raise AssertionError(f"{name}: traps not reached: {missed}")
    print(f"{name} traps reached: {sorted(reached)}", flush=True)
    nbytes = (heads.numel() + 2 * lo.numel() + have.numel()
              + got[0].numel() + got[1].numel()) * 4
    row = _row(name, "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
               "corrosion_tpu/sim/packed.py:1138 (its masks, :1201-1218)",
               all(torch.equal(a, b) for a, b in zip(got, ref)),
               max(_max_abs_err(a, b) for a, b in zip(got, ref)),
               _timed(timed, lambda: packed.sync_masks(heads, lo, hi, have,
                                                       cfg)),
               _timed(timed, lambda: packed.sync_masks_plain(
                   heads, lo, hi, have, cfg)),
               nbytes, kernel="sync_masks" if len(lead) == 1
               else "sync_masks_lanes")
    if keep:
        row["inputs"] = (heads, lo, hi, have)
    return row, got


def _merge_traps(tabs, entries, t, gc, out, label):
    """K4's branches on these inputs, counted from the pre-merge tables
    and the merge's output (every table [R, M], entries flat): precedence
    raises, replacements, young-DOWN refusals, aged-DOWN claims on
    unstamped buckets, claims the recheck refused (an aged-DOWN bucket a
    matching id revived) and duplicate entries on a cell.  Raises if one
    is never reached."""
    pid, pkey, psince = tabs
    e_dst, e_id, e_key, e_ok = entries
    m = pid.shape[-1]
    cell = e_dst.long() * m + torch.where(e_id >= 0, e_id % m, 0).long()
    cur_id, cur_key, cur_since = (x.reshape(-1)[cell] for x in tabs)
    match = e_ok & (cur_id == e_id)
    claim = e_ok & ~match & (e_key % 4 == 0) & (cur_id >= 0) & (
        cur_key % 4 == 2)
    young = claim & (cur_since >= 0) & (t - cur_since < gc)
    aged = claim & ~young
    new_pid, new_pkey = out[0].reshape(-1), out[1].reshape(-1)
    live = cell[e_ok]
    counts = {
        "precedence": int((match & (e_key > cur_key)).sum()),
        "replaced": int((new_pid != pid.reshape(-1)).sum()),
        "young_down": int(young.sum()),
        "unstamped_down": int((aged & (cur_since < 0)).sum()),
        "recheck_refused": int((aged & (new_pid[cell] == cur_id)
                                & (new_pkey[cell] % 4 != 2)).sum()),
        "duplicates": live.numel() - int(torch.unique(live).numel()),
    }
    missing = [name for name, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"{label}: K4 inputs reach no {missing}")
    print(f"K4 traps {label} reached: " + json.dumps(counts), flush=True)


def compare_merge_entries(dev, rng, pid, tables, f, k, t, gc, timed=True):
    """K4 at the storm's entry count (N * F * (k + 1) + N) on the tables
    ``tables`` (``pid`` their numpy ids): half the ids already in the
    receiver's bucket; with the packed table, as the path calls it,
    equal to the plain version."""
    from corrosion_tpu_torch.sim import pswim

    n, m = pid.shape
    e = n * f * (k + 1) + n

    def cuda(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    e_dst = rng.integers(0, n, e)
    same = rng.random(e) < 0.5
    picked = pid[e_dst, rng.integers(0, m, e)]
    e_id = np.where(same & (picked >= 0), picked, rng.integers(0, n, e))
    e_key = rng.integers(0, 2047, e) * 4 + rng.integers(0, 3, e)
    e_ok = rng.random(e) < 0.8
    entries = (cuda(e_dst), cuda(e_id), cuda(e_key), cuda(e_ok, torch.bool))
    args = (*tables, *entries, t, gc)
    ptbl = pswim._pack_tables(tables[0], tables[1])
    got = pswim.merge_entries(*args, ptbl)
    ref = pswim.merge_entries_plain(*args, ptbl)
    _merge_traps(tables, entries, t, gc, ref, "solo")
    return dict(
        name="merge_entries",
        source="corrosion_tpu_torch/kernels/csrc/merge_entries.cu",
        replaces="corrosion_tpu/sim/pswim.py:103",
        equal=all(torch.equal(a, b) for a, b in zip(got, ref)),
        max_abs_err=max(_max_abs_err(a, b) for a, b in zip(got, ref)),
        ms=_timed(timed, lambda: pswim.merge_entries(*args, ptbl)),
        plain_ms=_timed(timed, lambda: pswim.merge_entries_plain(*args,
                                                                 ptbl)),
        # the entry arrays, the three tables in and out
        bound_ms=_bound_ms(e * 13 + 3 * n * m * 4 * 2),
    )


def _equal_all(got, want):
    eq = all(a.dtype == b.dtype and torch.equal(a, b)
             for a, b in zip(got, want))
    return eq and len(got) == len(want), max(
        _max_abs_err(a, b) for a, b in zip(got, want))


def _round_draws(r, key, backoff, n, m):
    """One storm round's draws (sim/packed.py, sim/pswim.py) through
    ``r``'s split and randint: the splits, then every randint in order."""
    ks = r.split(key, 4)
    kb, ksy, ksw = r.split(ks[1], 3), r.split(ks[2], 3), r.split(ks[3], 11)
    per = (n + m - 1) // m
    return [ks, kb, ksy, ksw] + [
        r.randint(kb[0], (12, n), 0, m),  # broadcast targets
        r.randint(ksy[0], (12, n), 0, m),  # sync peers
        r.randint(ksy[2], (n,), 1, backoff + 1),  # the rearm, per element
        r.randint(ksw[0], (4, n), 0, m),  # probe target
        r.randint(ksw[2], (12, n), 0, m),  # probe relays
        r.randint(ksw[4], (12, n), 0, m),  # gossip targets
        r.randint(ksw[5], (n, 8), 0, m),  # gossip picks
        r.randint(ksw[7], (n,), 0, n),  # announce target: span 100000
        r.randint(ksw[9], (n,), 0, m),  # refill bucket
        r.randint(ksw[10], (n,), 0, per),  # refill id
    ]


def compare_threefry(dev, g, n, m):
    """K5 over a storm round's draws, and randint's span-1 traps."""
    from corrosion_tpu_torch.sim import rng

    plain = SimpleNamespace(split=rng.split_plain, randint=rng.randint_plain)
    key = rng.prng_key(1234, dev)
    # backoffs of 0 make maxval == minval == 1: a per-element span of 1
    backoff = torch.as_tensor(g.integers(0, 33, n), dtype=torch.int32,
                              device=dev)
    got = _round_draws(rng, key, backoff, n, m)
    want = _round_draws(plain, key, backoff, n, m)
    traps = [(key, (n,), 0, 1), (key, (n,), 1, 1), (key, (n,), 5, -3)]
    got += [rng.randint(*a) for a in traps]
    want += [rng.randint_plain(*a) for a in traps]
    equal, err = _equal_all(got, want)
    if not bool((backoff == 0).any()):
        raise AssertionError("K5 inputs reach no per-element span of 1")
    draws = sum(x.numel() for x in got[4:14])
    hashes = sum(x.shape[0] for x in got[:4])
    ops = draws * OPS_PER_RANDINT + hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    return dict(
        name="threefry",
        source="corrosion_tpu_torch/kernels/csrc/threefry.cu",
        replaces="corrosion_tpu/sim/pswim.py:92",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: _round_draws(rng, key, backoff, n, m)),
        plain_ms=_time_ms(lambda: _round_draws(plain, key, backoff, n, m)),
        bound_ms=ops / rate * 1e3, bound_by="operations",
        ops=ops, int32_ops_per_s=rate, draws=draws,
    )


def _storm_cfg(n, dev):
    from corrosion_tpu_torch.sim.runner import _write_storm

    return _write_storm(n, 512, dev)


def compare_gaps_refresh(dev, g, n, w):
    """K6 on mid-storm have words; a second check with K = 2 reaches the
    overflow clamp (at K = 8 a V = 8 row has at most 4 runs)."""
    from corrosion_tpu_torch.sim import gaps

    cfg, _ = _storm_cfg(n, dev)
    bits = (g.random((n, w, 32)) < 0.3).astype(np.uint64)
    have = torch.as_tensor(
        (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        .view(np.int32), device=dev,
    )
    equal, err = _equal_all(gaps.refresh_gaps(have, cfg),
                            gaps.refresh_gaps_plain(have, cfg))
    tight = dataclasses.replace(cfg, gap_slots=2)
    got = gaps.refresh_gaps(have, tight)
    eq2, err2 = _equal_all(got, gaps.refresh_gaps_plain(have, tight))
    if int(got[3]) == 0:
        raise AssertionError("K6 inputs overflow no row at K = 2")
    a, k = cfg.n_writers, cfg.gap_slots
    return dict(
        name="gaps_refresh",
        source="corrosion_tpu_torch/kernels/csrc/gaps_refresh.cu",
        replaces="corrosion_tpu/sim/gaps.py:137",
        equal=equal and eq2, max_abs_err=max(err, err2),
        ms=_time_ms(lambda: gaps.refresh_gaps(have, cfg)),
        plain_ms=_time_ms(lambda: gaps.refresh_gaps_plain(have, cfg)),
        # the have words in; heads, lo, hi and the count out
        bound_ms=_bound_ms(n * w * 4 + n * a * 4 + 2 * n * a * k * 4 + 4),
    )


def _record_cases(g, dev, n, w, cfg):
    """K7's cases at [N, W]: dead rows and all-ones words (bit 31 set),
    once with holes (payload stamps only), once complete past the last
    injection (node stamps and the done flag); then the fault loop's exit
    mode at horizon 21: before it, at it, and at it with an up row wiped
    after its sticky stamp (done must fall back to False).  Each with a
    K6 overflow count and an old overflow fraction, above and below the
    new one."""
    from corrosion_tpu_torch.sim.round import RunMetrics

    p = 32 * w
    dead = g.random(n) < 0.05
    alive = torch.as_tensor(dead * 2, dtype=torch.uint8, device=dev)
    full = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    holes = full.copy()
    rows = g.random(n) < 0.3
    half = max(1, w // 2)
    holes[rows, :half] &= g.integers(0, 1 << 32, (int(rows.sum()), half),
                                     dtype=np.uint32)
    holes[dead] &= g.integers(0, 1 << 32, (int(dead.sum()), w),
                              dtype=np.uint32)
    inj = torch.full((w,), -1, dtype=torch.int32, device=dev)
    cells = cfg.n_nodes * cfg.n_writers

    def metrics(old):
        return RunMetrics(
            coverage_at=torch.full((p,), -1, dtype=torch.int32, device=dev),
            converged_at=torch.as_tensor(
                np.where(g.random(n) < 0.2, 3, -1), dtype=torch.int32,
                device=dev),
            overflow_frac=torch.tensor(old, dtype=torch.float32, device=dev),
            order_violations=torch.zeros((), dtype=torch.int32, device=dev))

    wiped = full.copy()
    victim = int(np.flatnonzero(~dead)[0])
    wiped[victim] = 0
    cases = []
    for i, (words, t, horizon) in enumerate(((holes, 10, None),
                                              (full, 20, None),
                                              (full, 19, 21), (full, 20, 21),
                                              (wiped, 20, 21))):
        m = metrics(0.25 if i % 2 else 0.0)
        if i == 4:
            m.converged_at[victim] = 3
        count = torch.tensor(int(g.integers(1, cells // 3)),
                             dtype=torch.int32, device=dev)
        have = torch.as_tensor(words.view(np.int32), device=dev)
        cases.append((have, inj, alive, m, t, count, horizon))
    return cases


def compare_converge_fold(dev, g, n, w):
    """K7 at the storm's shapes on `_record_cases`, its overflow fold
    included; then the same cases at gapstress's W = 256 (a block a node)
    and at W = 6 (the one-word path)."""
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _storm_cfg(n, dev)
    last = int(meta.round.max())  # a loop's one read a run
    calls = []
    for cfg_, n_, w_ in ((cfg, n, w),
                         (_gapstress(GAPSTRESS_N, dev)[0], GAPSTRESS_N, 256),
                         (dataclasses.replace(cfg, n_payloads=192), n, 6)):
        for have, inj, alive, m, t, count, horizon in _record_cases(
                g, dev, n_, w_, cfg_):
            args = (have, inj, alive, m, meta, t, cfg_, count, last,
                    horizon)
            calls.append((args, packed.converge_record(*args),
                          packed.converge_record_plain(*args)))
    equal, err = True, 0
    for _, got, want in calls:
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
    flags = [bool(c[2][3]) for c in calls]
    if flags != [False, True, False, True, False] * 3:
        raise AssertionError(f"K7 inputs do not reach both done values in "
                             f"both modes: {flags}")
    if len({float(c[2][2]) for c in calls[:5]}) < 2:
        raise AssertionError("K7's overflow fold keeps one value")
    print(f"K7 at W = {w}, 256 and 6: equal {equal}, done {flags[:5]}",
          flush=True)
    args = calls[0][0]
    exit_args = calls[3][0]  # the fault loop's exit mode, done reached
    p = cfg.n_payloads
    return dict(
        name="converge_fold",
        source="corrosion_tpu_torch/kernels/csrc/converge_fold.cu",
        replaces="corrosion_tpu/sim/packed.py:789",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: packed.converge_record(*args)),
        plain_ms=_time_ms(lambda: packed.converge_record_plain(*args)),
        exit_mode_ms=_time_ms(lambda: packed.converge_record(*exit_args)),
        exit_mode_plain_ms=_time_ms(
            lambda: packed.converge_record_plain(*exit_args)),
        # have, injected_p, alive; converged_at and coverage_at in and
        # out; the overflow count and fraction in and out; the done flag
        bound_ms=_bound_ms(n * w * 4 + w * 4 + n + n * 4 * 2 + p * 4 * 2
                           + 4 * 3 + 1),
    )


def _word_phases(ph, c, inj, t, meta, cfg, alive, targets):
    """A round's word phases through ``ph``: inject, spend, deliver."""
    ph.inject(c, inj, t, meta, cfg, alive)
    sending = ph.spend(c, inj, targets, alive)
    ph.deliver(c, t, cfg)
    return sending


def compare_word_phases(dev, g, n, w, f):
    """K8's three entry points on a mid-storm carry, in round order."""
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _storm_cfg(n, dev)
    t = 4

    def words(shape, ands=1):
        return _random_words(g, shape, dev, ands)

    c0 = packed.PackedCarry(
        have=words((n, w)), inflight=words((2, n, w), 5),
        relay=packed.Planes(*(words((n, w), 2) for _ in range(4))),
        sync_buf=words((2, n, w), 6),
    )
    inj0 = words((w,), 2)
    me = np.arange(n)[:, None]
    tg = np.where(g.random((n, f)) < 0.05, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                              dtype=torch.int32, device=dev)
    alive = torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                            device=dev)
    flat0 = [c0.have, c0.inflight, *c0.relay, c0.sync_buf, inj0]
    work = [x.clone() for x in flat0]

    def carry_of(xs):
        return packed.PackedCarry(have=xs[0], inflight=xs[1],
                                  relay=packed.Planes(*xs[2:6]),
                                  sync_buf=xs[6]), xs[7]

    def restore():
        for dst, src in zip(work, flat0):
            dst.copy_(src)

    kern = SimpleNamespace(inject=packed.inject_packed,
                           spend=packed.spend_relay,
                           deliver=packed.deliver_packed)
    plain = SimpleNamespace(inject=packed.inject_packed_plain,
                            spend=packed.spend_relay_plain,
                            deliver=packed.deliver_packed_plain)
    outs = []
    for ph in (kern, plain):
        xs = [x.clone() for x in flat0]
        c, inj = carry_of(xs)
        outs.append([_word_phases(ph, c, inj, t, meta, cfg, alive, targets),
                     *xs])
    equal, err = _equal_all(outs[0], outs[1])

    # bytes: inject's P metadata, W injected words and the cells it arms;
    # spend's have, planes, targets and alive in, sending and the changed
    # plane words out; deliver's two slots in, the cells they touch
    p = cfg.n_payloads
    got = outs[1]
    arms = int(((meta.round == t)
                & (alive[meta.actor.long()] == 0)).sum()) * 5 * 4 * 2
    spent = sum(int((a != b).sum()) for a, b in zip(got[3:7], flat0[2:6]))
    arriving = flat0[1][t % 2]
    pending = flat0[6][t % 2]
    touched = int(((arriving | pending) != 0).sum())
    newly = int(((arriving & ~flat0[0]) != 0).sum())
    nbytes = (p * 9 + w * 4 * 2 + arms
              + n * w * 4 * 6 + n * f * 4 + n + spent * 4
              + 2 * n * w * 4 + touched * 4 * 4 + newly * 4 * 4 * 2)
    c, inj = carry_of(work)
    return dict(
        name="word_phases",
        source="corrosion_tpu_torch/kernels/csrc/word_phases.cu",
        replaces="corrosion_tpu/sim/packed.py:631",
        equal=equal, max_abs_err=err,
        ms=_time_inplace_ms(lambda: _word_phases(
            kern, c, inj, t, meta, cfg, alive, targets), restore),
        plain_ms=_time_inplace_ms(lambda: _word_phases(
            plain, c, inj, t, meta, cfg, alive, targets), restore),
        bound_ms=_bound_ms(nbytes),
    )


def _storm_fault_round(dev, n, t):
    """The 100k fault storm's config, compiled plan and round t's slice."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.runner import storm_fault_plan

    cfg, meta = _storm_cfg(n, dev)
    fplan = faults.compile_plan(storm_fault_plan(n, 0), cfg, device=dev)
    return cfg, meta, fplan, faults.round_faults(fplan, t)


def _fault_edge_calls(fs, rf, key, calls):
    """A fault-storm round's K9 calls through ``fs`` (the wrappers, or the
    plain versions): the five probe reach calls, the sync sessions' cut
    in either direction, and the wire's cuts and thresholds."""
    out = []
    for kind, src, dst, ok in calls:
        if kind == "reach":
            out.append(fs.reach(ok.clone(), rf, key, src, dst))
        elif kind == "session":
            out.append(fs.session(rf, src, dst))
        else:  # a plan without latency factors: (ok, thr)
            out += list(fs.wire(rf, src, dst, ok.clone()))[:2]
    return out


def compare_fault_seam(dev, g, n, w, f):
    """K9, K10 and K11 at the 100k fault storm's shapes and plan, on
    round 5 (loss and partition on) and the wipe round 20."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import rng as trng

    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    key = trng.prng_key(99, dev)

    def edges(e, per_node=None):
        src = (torch.arange(n, dtype=torch.int32, device=dev)
               .repeat_interleave(per_node) if per_node
               else torch.as_tensor(g.integers(0, n, e), dtype=torch.int32,
                                    device=dev))
        dst = g.integers(0, n, e)
        self_edge = g.random(e) < 0.05
        dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
        dst = torch.where(torch.as_tensor(self_edge, device=dev), src, dst)
        ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
        return src, dst.contiguous(), ok

    # the round's calls: probe direct, relay legs, gossip, announce;
    # sessions; the wire (E = N, 3N, 3N, 3N, N; 3N; 3N)
    calls = [("reach", *edges(n, 1)), ("reach", *edges(3 * n, 3)),
             ("reach", *edges(3 * n)), ("reach", *edges(3 * n, 3)),
             ("reach", *edges(n, 1)), ("session", *edges(3 * n, 3)),
             ("wire", *edges(3 * n, 3))]
    if all(c[1].shape[0] % 128 == 0 for c in calls if c[0] == "reach"):
        raise AssertionError("K9 inputs reach no padded probe draw")
    kern = SimpleNamespace(reach=faults.fault_reach_,
                           session=faults.fault_session_refused,
                           wire=faults.fault_wire_effects)
    plain = SimpleNamespace(
        reach=faults.fault_reach_plain,
        session=lambda rf, s, d: (faults._block_plain(rf, s, d)
                                  | faults._block_plain(rf, d, s)),
        wire=lambda rf, s, d, ok: (
            ok.__iand__(~faults._block_plain(rf, s, d)),
            faults._loss_plain(rf, s, d)),
    )
    got = _fault_edge_calls(kern, rf, key, calls)
    want = _fault_edge_calls(plain, rf, key, calls)
    equal, err = _equal_all(got, want)
    # the queries on their own, on the wire's edges
    _, ws, wd, _ = calls[-1]
    for q, ref in ((faults.fault_edge_block, faults._block_plain),
                   (faults.fault_edge_loss, faults._loss_plain)):
        e2, x2 = _equal_all([q(rf, ws, wd)], [ref(rf, ws, wd)])
        equal, err = equal and e2, max(err, x2)
    blk, thr = faults._block_plain(rf, ws, wd), want[-1]
    if not (bool(blk.any()) and bool((~blk & (ws != wd)).any())
            and bool((ws == wd).any()) and int(thr.max()) == 38):
        raise AssertionError("K9 inputs miss a partition side, a "
                             "self-edge or the loss threshold")
    kl = int(rf.loss_src.shape[0])
    kb = int(rf.block_src.shape[0])
    nbytes = sum(c[1].shape[0] * 8 for c in calls)  # the edge ids
    nbytes += sum(c[1].shape[0] * (2 if c[0] == "reach" else 1)
                  for c in calls)  # ok in and out, or the cut out
    nbytes += 3 * n + 1 + n * 2 * (kb + kl) * len(calls)  # wire's thr, masks
    # distinct draw words of the reach calls' edges that need one
    words = 0
    for (kind, src, dst, ok), out in zip(calls, got):
        if kind == "reach":
            need = (ok & ~faults._block_plain(rf, src, dst)
                    & (faults._loss_plain(rf, src, dst) > 0))
            idx = torch.nonzero(need).flatten() // 4
            words += int(torch.unique(idx).numel())
    rate = _int32_ops_per_s()
    ops = words * OPS_PER_HASH
    k9 = dict(
        name="fault_edges",
        source="corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
        replaces="corrosion_tpu/sim/faults.py:182",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: _fault_edge_calls(kern, rf, key, calls)),
        plain_ms=_time_ms(lambda: _fault_edge_calls(plain, rf, key, calls)),
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="bytes" if _bound_ms(nbytes) >= ops / rate * 1e3
        else "operations",
        calls=len(calls),
    )

    # K10: the wire's scatter with the loss drawn in the kernel
    sending = _random_words(g, (n, w), dev, 4)
    _, src, dst, ok0 = calls[-1]
    ok = ok0.clone()
    ok, thr, _, _ = faults.fault_wire_effects(rf, src, dst, ok)
    dst = torch.clamp(dst, min=0)
    slot = torch.full_like(dst, 5 % 2)
    ring0 = _random_words(g, (2, n, w), dev, 6)
    seed = int(rf.seed)
    got_r, want_r = ring0.clone(), ring0.clone()
    packed.scatter_sending_lossy(got_r, sending, dst, slot, ok, thr, key,
                                 seed, f)
    packed.scatter_sending_lossy_plain(want_r, sending, dst, slot, ok, thr,
                                       key, seed, f)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    if torch.equal(lossless, want_r):
        raise AssertionError("K10 inputs drop no payload")
    live = ok & (thr > 0)
    sent_words = (sending.repeat_interleave(f, dim=0) != 0) & live[:, None]
    hashes = int(sent_words.sum()) * 8
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    k10_bytes = (sending.numel() * 4 + src.shape[0] * 10
                 + rows_touched * w * 4 * 2)
    k10_ops = hashes * OPS_PER_HASH
    ring_k, ring_p = ring0.clone(), ring0.clone()
    k10 = dict(
        name="broadcast_scatter_lossy",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/faults.py:260",
        equal=bool(torch.equal(got_r, want_r)),
        max_abs_err=_max_abs_err(got_r, want_r),
        ms=_time_ms(lambda: packed.scatter_sending_lossy(
            ring_k, sending, dst, slot, ok, thr, key, seed, f)),
        # the plain version finds its pairs with a host sync: eager
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, sending, dst, slot, ok, thr, key, seed, f)),
        bound_ms=max(_bound_ms(k10_bytes), k10_ops / rate * 1e3),
        bound_by="operations" if k10_ops / rate * 1e3 > _bound_ms(k10_bytes)
        else "bytes",
        ops=k10_ops, hashes=hashes,
    )
    return [k9, k10, compare_node_faults(dev, g, n, w, cfg, fplan)]


def compare_node_faults(dev, g, n, w, cfg, fplan):
    """K11 on round 20 of the fault storm (node 1's restart: an override
    and a wiped row) and round 8 (its crash: an override only), on a
    mid-storm slim state and carry."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim.state import init_state

    m, t = cfg.member_slots, 20
    slim = packed.shrink_state(init_state(cfg, torch.tensor(
        [0, 5], dtype=torch.int64, device=dev)))
    pid, pkey, psince = _random_tables(g, n, m, t)
    a, k = cfg.n_writers, cfg.gap_slots
    slim = slim._replace(
        pid=torch.as_tensor(pid, dtype=torch.int32, device=dev),
        pkey=torch.as_tensor(pkey, dtype=torch.int32, device=dev),
        psince=torch.as_tensor(psince, dtype=torch.int32, device=dev),
        heads=torch.as_tensor(g.integers(1, 9, (n, a)), dtype=torch.int32,
                              device=dev),
        gap_lo=torch.as_tensor(g.integers(0, 9, (n, a, k)),
                               dtype=torch.int32, device=dev),
        gap_hi=torch.as_tensor(g.integers(0, 9, (n, a, k)),
                               dtype=torch.int32, device=dev),
        alive=torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                              device=dev),
    )
    carry = packed.PackedCarry(
        have=_random_words(g, (n, w), dev),
        inflight=_random_words(g, (2, n, w), dev, 3),
        relay=packed.Planes(*(_random_words(g, (n, w), dev, 2)
                              for _ in range(4))),
        sync_buf=_random_words(g, (2, n, w), dev, 3),
    )
    names = ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey", "psince")

    def flat(sl, c):
        return [getattr(sl, x) for x in names] + [
            c.have, *c.relay, c.inflight, c.sync_buf]

    def unflat(xs):
        sl = slim._replace(**dict(zip(names, xs[:7])))
        return sl, packed.PackedCarry(have=xs[7], relay=packed.Planes(
            *xs[8:12]), inflight=xs[12], sync_buf=xs[13])

    base = flat(slim, carry)
    plain = lambda sl, c, rf: (  # noqa: E731
        faults.apply_node_faults_plain(sl, rf),
        packed.apply_carry_faults(c, rf))
    equal, err = True, 0
    for r in (20, 8):
        rf = faults.round_faults(fplan, r)
        outs = []
        for fn in (packed.apply_round_faults, plain):
            xs = [x.clone() for x in base]
            fn(*unflat(xs), rf)
            outs.append(xs)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        if r == 20 and (int(rf.wipe.sum()) != 1
                        or torch.equal(outs[0][7], base[7])):
            raise AssertionError("K11 inputs wipe no row")
    rf = faults.round_faults(fplan, t)
    work = [x.clone() for x in base]

    def restore():
        for dst, src in zip(work, base):
            dst.copy_(src)

    wiped = int(rf.wipe.sum())
    row = (w * (5 + 2 * 2) + a + 2 * a * k + 3 * m) * 4
    return dict(
        name="node_faults",
        source="corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        replaces="corrosion_tpu/sim/faults.py:703",
        equal=equal, max_abs_err=err,
        ms=_time_inplace_ms(
            lambda: packed.apply_round_faults(*unflat(work), rf), restore),
        plain_ms=_time_inplace_ms(lambda: plain(*unflat(work), rf), restore),
        # the override, the wipe mask and alive in and out; wiped rows out
        bound_ms=_bound_ms(n * 4 + wiped * row),
    )


# -- the dense round's kernels: K1's uniform entry, K12-K15 ------------------


def _u8(g, shape, p_one, dev):
    """u8 0/1 cells, each 1 with probability ``p_one``."""
    return torch.as_tensor((g.random(shape) < p_one).astype(np.uint8),
                           device=dev)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _changed_bytes(before, after) -> int:
    """Bytes of the cells an in-place function changed: what it must
    write at least."""
    return sum(int((a != b).sum()) * a.element_size()
               for a, b in zip(before, after))


def _timed(timed, fn, restore=None):
    if not timed:
        return None
    return _time_inplace_ms(fn, restore) if restore else _time_ms(fn)


def _row(name, source, replaces, equal, err, ms, plain_ms, nbytes, **extra):
    """A kernel row bound by the bytes it must move."""
    return dict(name=name, source=source, replaces=replaces, equal=equal,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=_bound_ms(nbytes), bound_by="bytes", bytes=nbytes,
                **extra)


def compare_sample_uniform(dev, g, n=4096, count=3, timed=True):
    """K1's uniform entry on a churn-shaped draw (N = 4096, the gossip
    fanout 3): self candidates, beliefs with DOWN cells, repeats, rows
    left short; and on the same draw without beliefs (ground truth)."""
    from corrosion_tpu_torch.sim import swim

    over = 4 * count
    me = np.arange(n)[None, :]
    cand = g.integers(0, n, (over, n))
    cand = np.where(g.random((over, n)) < 0.05, me, cand)
    cand[1] = np.where(g.random(n) < 0.3, cand[0], cand[1])  # repeats
    cand_t = torch.as_tensor(cand, dtype=torch.int32, device=dev)
    view = torch.as_tensor(
        np.where(g.random((n, n)) < 0.5, 2, g.integers(0, 2, (n, n))),
        dtype=torch.int8, device=dev)
    got = [swim.sample_uniform(cand_t, v, count) for v in (view, None)]
    want = [swim.sample_uniform_plain(cand_t, v, count) for v in (view, None)]
    equal, err = _equal_all(got, want)
    if not (bool((want[0] == -1).any()) and bool((cand_t == torch.arange(
            n, device=dev)).any())):
        raise AssertionError("K1 uniform inputs leave no row short or draw "
                             "no self candidate")
    return _row(
        "sample_uniform", "corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        "corrosion_tpu/sim/swim.py:59", equal, err,
        _timed(timed, lambda: swim.sample_uniform(cand_t, view, count)),
        _timed(timed, lambda: swim.sample_uniform_plain(cand_t, view, count)),
        # the draws, one belief byte per draw, the output
        cand_t.numel() * 5 + n * count * 4,
    )


def _dense_round_inputs(g, dev, cfg, meta, t):
    """A mid-run dense state at ``cfg``'s shape: half the cells held,
    relay budgets on held cells, the payloads of rounds <= t injected,
    sparse rings, 3% dead nodes, a quarter split."""
    n, p = cfg.n_nodes, cfg.n_payloads
    have = _u8(g, (n, p), 0.5, dev)
    relay = (torch.as_tensor(g.integers(0, cfg.max_transmissions + 1, (n, p)),
                             dtype=torch.uint8, device=dev) * have)
    injected = (meta.round <= t).to(torch.uint8)
    d = cfg.n_delay_slots
    ring = _u8(g, (d, n, p), 0.05, dev)
    sync_ring = _u8(g, (d, n, p), 0.02, dev)
    alive = torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                            device=dev)
    # a split off the region boundary, so both delay classes carry edges
    group = (torch.arange(n, device=dev) >= n // 4).to(torch.int32)
    return have, relay, injected, ring, sync_ring, alive, group


def _dense_round_phases(bc, xs, meta, cfg, targets, dst, slot, ok, key,
                        budget, thr, t, kernel=True):
    """One round's K12 phases on ``xs`` (have, relay, injected, ring,
    sync_ring, alive), in place: the wrappers, or the plain versions."""
    have, relay, injected, ring, sync_ring, alive = xs
    inj = bc.inject_dense if kernel else bc.inject_dense_plain
    send = bc.broadcast_send if kernel else bc.broadcast_send_plain
    dlv = bc.deliver_dense if kernel else bc.deliver_dense_plain
    inj(have, relay, injected, meta, alive, t, cfg.max_transmissions)
    send(have, relay, injected, meta.nbytes, budget, targets, dst, slot, ok,
         alive, key, thr, ring)
    dlv(ring, sync_ring, have, relay, t % ring.shape[0],
        max(cfg.max_transmissions - 1, 1))


def compare_dense_phases(dev, g, n=10_000, timed=True):
    """K12 at partition-heal-10k's shapes (P = 256, F = 3, D = 3, two
    regions, a partition): the path's case (unmetered, lossless) and a
    trap case with a binding byte budget and a loss threshold 0 < 51 <
    256, each a whole round (inject, broadcast, deliver)."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.runner import heal_config
    from corrosion_tpu_torch.sim.topology import (
        Topology, edge_alive, edge_delay, regions)

    cfg, meta = heal_config(n, dev)
    f, t = cfg.fanout, 20
    have, relay, injected, ring, sync_ring, alive, group = \
        _dense_round_inputs(g, dev, cfg, meta, t)
    me = np.arange(n)[:, None]
    tg = np.where(g.random((n, f)) < 0.05, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                              dtype=torch.int32, device=dev)
    topo = Topology(n_regions=2, inter_delay=2)
    region = regions(n, 2, dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(group, alive, src, dst) & (dst != src)
    slot = ((t + edge_delay(topo, region, src, dst)) % cfg.n_delay_slots).to(
        torch.int32)
    key = trng.prng_key(77, dev)
    base = [have, relay, injected, ring, sync_ring, alive]
    budget_trap = 20 * 8192 + 4096
    equal, err, runs = True, 0, {}
    for label, budget, thr in (("path", None, 0), ("trap", budget_trap, 51),
                               ("lossless_trap", budget_trap, 0)):
        outs = []
        for kernel in (True, False):
            xs = [x.clone() for x in base]
            _dense_round_phases(bc, xs, meta, cfg, targets, dst, slot, ok,
                                key, budget, thr, t, kernel)
            outs.append(xs)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        runs[label] = outs[1]
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    if int(eligible.sum(dim=1).max()) * 8192 <= budget_trap:
        raise AssertionError("K12 inputs: the byte budget never binds")
    if _equal_all(runs["trap"], runs["lossless_trap"])[0]:
        raise AssertionError("K12 inputs: the loss drops no payload")
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    def round_(kernel, budget=None, thr=0):
        return lambda: _dense_round_phases(
            bc, work, meta, cfg, targets, dst, slot, ok, key, budget, thr, t,
            kernel)

    e = n * f
    nbytes = (_nbytes(have, relay, injected, meta.nbytes, meta.round,
                      meta.actor, alive, targets, dst, slot, ok)
              + 2 * n * cfg.n_payloads  # the two ring slots deliver reads
              + _changed_bytes(base[:5], runs["path"][:5]))
    # the trap's hashes: one per sending (edge, payload) cell of an ok edge
    sending = eligible.repeat_interleave(f, dim=0) & ok[:, None]
    hashes = int(sending.sum())
    return _row(
        "dense_phases", "corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:32", equal, err,
        _timed(timed, round_(True), restore),
        _timed(timed, round_(False), restore), nbytes,
        trap_ms=_timed(timed, round_(True, budget_trap, 51), restore),
        trap_plain_ms=_timed(timed, round_(False, budget_trap, 51), restore),
        trap_hash_ops=hashes * OPS_PER_HASH, edges=e,
    )


def _advertised(g, dev, cfg, have, t):
    """heads and gap slots as a node advertises them: from a lagging
    copy of its have rows (the bookkeeping of an earlier round)."""
    from corrosion_tpu_torch.sim.round import dense_record_plain, new_metrics

    lag = have & _u8(g, tuple(have.shape), 0.8, have.device)
    meta_round = torch.zeros(cfg.n_payloads, dtype=torch.int32,
                             device=have.device)
    meta = SimpleNamespace(round=meta_round)
    heads, lo, hi, n_over, *_ = dense_record_plain(
        lag, torch.ones(cfg.n_payloads, dtype=torch.uint8, device=dev),
        torch.zeros(cfg.n_nodes, dtype=torch.uint8, device=dev),
        new_metrics(cfg, dev), meta, t, cfg)
    return heads, lo, hi, int(n_over)


def compare_dense_sync(dev, g, n=10_000, timed=True):
    """K13 at partition-heal-10k's shapes (P = 256, A = 4, V = 64, K = 8,
    S = 3): advertised gaps with more than K runs, self and dead peers,
    unmetered (the path) and under a binding sync budget."""
    from corrosion_tpu_torch.sim import sync
    from corrosion_tpu_torch.sim.runner import heal_config

    cfg, meta = heal_config(n, dev)
    s = cfg.sync_peers
    have = _u8(g, (n, cfg.n_payloads), 0.5, dev)
    heads, lo, hi, n_over = _advertised(g, dev, cfg, have, 40)
    if n_over == 0:
        raise AssertionError("K13 inputs: no advertised row has more than "
                             "K gap runs")
    me = np.arange(n)[:, None]
    peers = np.where(g.random((n, s)) < 0.03, me, g.integers(0, n, (n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=dev) & (
        peers != torch.arange(n, device=dev)[:, None])
    slot0 = _u8(g, (n, cfg.n_payloads), 0.01, dev)
    budget_trap = 6 * 8192 + 100
    equal, err, outs = True, 0, {}
    for budget in (None, budget_trap):
        got_slot, want_slot = slot0.clone(), slot0.clone()
        got = sync.sync_pull_dense(have, heads, lo, hi, peers, ok, meta.nbytes,
                                   budget, got_slot, cfg)
        want = sync.sync_pull_dense_plain(have, heads, lo, hi, peers, ok,
                                          meta.nbytes, budget, want_slot, cfg)
        e, x = _equal_all([got, got_slot], [want, want_slot])
        equal, err = equal and e, max(err, x)
        outs[budget] = want_slot
    if torch.equal(outs[None], outs[budget_trap]):
        raise AssertionError("K13 inputs: the sync budget never binds")
    work = slot0.clone()

    def restore():
        work.copy_(slot0)

    nbytes = (_nbytes(have, heads, lo, hi, peers, ok, meta.nbytes)
              + _changed_bytes([slot0], [outs[None]]) + n)
    return _row(
        "dense_sync", "corrosion_tpu_torch/kernels/csrc/dense_sync.cu",
        "corrosion_tpu/sim/sync.py:122", equal, err,
        _timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, ok, meta.nbytes, None, work, cfg),
            restore),
        _timed(timed, lambda: sync.sync_pull_dense_plain(
            have, heads, lo, hi, peers, ok, meta.nbytes, None, work, cfg),
            restore),
        nbytes,
        trap_ms=_timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, ok, meta.nbytes, budget_trap, work,
            cfg), restore),
    )


def _dense_record_cases(g, dev, cfg, meta, p_one=0.5):
    """K14's cases: holes (each chunk held with probability ``p_one``:
    runs past K, dead rows, stamps set and unset) mid-injection, then
    every cell held after the last injection (node stamps and the done
    flag), and the same with one up row short."""
    from corrosion_tpu_torch.sim.round import RunMetrics

    n, p = cfg.n_nodes, cfg.n_payloads
    last = int(meta.round.max())
    alive = torch.as_tensor((g.random(n) < 0.05) * 2, dtype=torch.uint8,
                            device=dev)
    metrics = RunMetrics(
        coverage_at=torch.as_tensor(np.where(g.random(p) < 0.2, 2, -1),
                                    dtype=torch.int32, device=dev),
        converged_at=torch.as_tensor(np.where(g.random(n) < 0.2, 3, -1),
                                     dtype=torch.int32, device=dev),
        overflow_frac=torch.zeros((), device=dev),
        order_violations=torch.zeros((), dtype=torch.int32, device=dev),
    )
    holes = _u8(g, (n, p), p_one, dev)
    full = torch.ones((n, p), dtype=torch.uint8, device=dev)
    short = full.clone()
    short[int(np.flatnonzero(alive.cpu().numpy() == 0)[0]), 0] = 0
    inj_mid = (meta.round <= last // 2).to(torch.uint8)
    inj_all = torch.ones(p, dtype=torch.uint8, device=dev)
    return [(holes, inj_mid, alive, metrics, meta, last // 2, cfg),
            (full, inj_all, alive, metrics, meta, last + 2, cfg),
            (short, inj_all, alive, metrics, meta, last + 2, cfg)]


def compare_dense_gaps(dev, g, n=10_000, n_writers=4, n_payloads=256,
                       timed=True, name="dense_gaps", gap_slots=8,
                       chunks=1, p_one=0.5):
    """K14 at partition-heal-10k's shapes (A = 4, V = 64, K = 8: JAX's
    dense branch), broadcast-1k's (A = 8, V = 32: its word branch) or the
    gapstress distortion control's (A = 8, V = 128, C = 8, K = 64: more
    than 32 runs in a row, past the register cap K14 had)."""
    from corrosion_tpu_torch.sim.round import dense_record, dense_record_plain
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    cfg = SimConfig(n_nodes=n, n_payloads=n_payloads, n_writers=n_writers,
                    chunks_per_version=chunks, gap_slots=gap_slots)
    meta = uniform_payloads(cfg, dev, inject_every=1)
    cases = _dense_record_cases(g, dev, cfg, meta, p_one)
    equal, err, dones = True, 0, []
    for args in cases:
        got, want = dense_record(*args), dense_record_plain(*args)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        dones.append(bool(want[6]))
        if args is not cases[0]:
            continue
        if gap_slots <= 32 and int(want[3]) == 0:
            raise AssertionError("K14 inputs overflow no row")
        if gap_slots > 32 and not bool((want[1][..., 32] > 0).any()):
            raise AssertionError("K14 inputs fill no slot past 32")
    if dones != [False, True, False]:
        raise AssertionError("K14 inputs do not reach both done values")
    args = cases[0]
    a, k = cfg.n_writers, cfg.gap_slots
    p = cfg.n_payloads
    nbytes = (n * p + p + n + p * 4 + n * 4 * 2 + p * 4 * 2
              + n * a * 4 * (1 + 2 * k) + 4 + 1)
    return _row(
        name, "corrosion_tpu_torch/kernels/csrc/dense_gaps.cu",
        "corrosion_tpu/sim/gaps.py:64", equal, err,
        _timed(timed, lambda: dense_record(*args)),
        _timed(timed, lambda: dense_record_plain(*args)), nbytes,
        n_versions=cfg.n_versions,
    )


def _swim_passes(sw, xs, gdst, g_ok, f, ann_target, ann_claim, up,
                 heard_down, fb_inc, t, timeout, kernel=True):
    """K15's three passes on ``xs`` (view, vinc, since, incarnation) in
    place, with the gossip receiver filter between them as swim_step
    has it; returns the belief keys, the merged keys and the new
    incarnations."""
    view, vinc, since, inc = xs
    if kernel:
        timeout_, merge, apply_ = (sw.swim_timeout_, sw.swim_merge,
                                   sw.swim_apply_)
    else:
        timeout_, merge, apply_ = (sw.swim_timeout_plain, sw.swim_merge_plain,
                                   sw.swim_apply_plain)
    key = timeout_(view, vinc, since, t, timeout)
    n = view.shape[0]
    gsrc = torch.arange(n, device=view.device).repeat_interleave(f)
    ok = g_ok & (view[gdst.long(), gsrc] != 2)
    merged = merge(key, gdst, ok, f, ann_target, ann_claim)
    return key, merged, apply_(view, vinc, since, key, merged, inc, up,
                               heard_down, fb_inc, t)


def compare_swim_full(dev, g, n=4096, f=3, timed=True):
    """K15 at churn-full-4096's shapes (N = 4096, F = 3): SUSPECT cells
    past the timeout, DOWN receivers, announce claims, refuting nodes."""
    from corrosion_tpu_torch.sim import swim as sw

    t, timeout = 40, 13
    view = torch.as_tensor(g.choice(3, (n, n), p=[0.8, 0.1, 0.1]),
                           dtype=torch.int8, device=dev)
    vinc = torch.as_tensor(g.integers(0, 6, (n, n)), dtype=torch.int32,
                           device=dev)
    since = torch.as_tensor(np.where(g.random((n, n)) < 0.5,
                                     g.integers(0, t + 1, (n, n)), -1),
                            dtype=torch.int32, device=dev)
    inc = torch.as_tensor(g.integers(0, 6, n), dtype=torch.int32, device=dev)
    gdst = torch.as_tensor(g.integers(0, n, n * f), dtype=torch.int32,
                           device=dev)
    g_ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    ann_target = torch.as_tensor(g.integers(0, n, n), dtype=torch.int32,
                                 device=dev)
    ann_claim = torch.where(torch.as_tensor(g.random(n) < 0.3, device=dev),
                            inc * 4, -1).to(torch.int32)
    up = torch.as_tensor(g.random(n) < 0.95, device=dev)
    heard_down = torch.as_tensor(g.random(n) < 0.05, device=dev)
    fb_inc = torch.as_tensor(np.where(g.random(n) < 0.05,
                                      g.integers(0, 8, n), -1),
                             dtype=torch.int32, device=dev)
    base = [view, vinc, since, inc]
    args = (gdst, g_ok, f, ann_target, ann_claim, up, heard_down, fb_inc, t,
            timeout)
    outs = []
    for kernel in (True, False):
        xs = [x.clone() for x in base]
        res = _swim_passes(sw, xs, *args, kernel=kernel)
        outs.append(list(res) + xs)
    equal, err = _equal_all(outs[0], outs[1])
    key, merged, new_inc, v_after = outs[1][:4]
    expired = (view == 1) & (since >= 0) & (t - since >= timeout)
    if not (bool(expired.any()) and bool((new_inc != inc).any())
            and bool((merged > key).any()) and bool((v_after == 2).any())):
        raise AssertionError("K15 inputs time out, refute or merge nothing")
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    # swim_step's belief update reads view, vinc and since once and
    # writes the cells it changes; the belief keys and the merged
    # buffer are the passes' own and do not count
    cells = n * n
    nbytes = (cells * (1 + 4 + 4)  # view, vinc, since
              + n * f * 5  # gossip edges: gdst, g_ok
              + n * 4 * 4 + n * 2  # ann_target, ann_claim, inc, fb_inc;
              # up, heard_down
              + _changed_bytes(base, outs[1][3:]))
    return _row(
        "swim_full", "corrosion_tpu_torch/kernels/csrc/swim_full.cu",
        "corrosion_tpu/sim/swim.py:185", equal, err,
        _timed(timed, lambda: _swim_passes(sw, work, *args), restore),
        _timed(timed, lambda: _swim_passes(sw, work, *args, kernel=False),
               restore),
        nbytes,
    )


def compare_dense_kernels(dev, seed=1):
    """Phase 3b: K1's uniform entry and K12-K15 against their plain
    versions at the dense paths' shapes."""
    g = np.random.default_rng(seed)
    rows = [
        compare_sample_uniform(dev, g),
        compare_dense_phases(dev, g),
        compare_dense_sync(dev, g),
        compare_dense_gaps(dev, g),
        compare_swim_full(dev, g),
    ]
    # broadcast-1k's shapes: K1 without beliefs is checked above on the
    # churn draw; K14 at V = 32 (JAX's word branch) is checked here
    word = compare_dense_gaps(dev, g, n=1000, n_writers=8, timed=False,
                              name="dense_gaps_v32")
    rows[3]["equal"] = rows[3]["equal"] and word["equal"]
    rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"], word["max_abs_err"])
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the gapstress storm's kernels: K16, K3's metered entry, K10's topology
# stream, K6 past 32 versions, and K14 at K = 64 ----------------------------

GAPSTRESS_N = 25_600


def _gapstress(n, dev, gap_slots=8):
    """The gapstress config and payloads (sizes 1 B - 8 KiB)."""
    from corrosion_tpu_torch.sim.runner import (
        _gapstress_cfg, gapstress_payload_sizes)
    from corrosion_tpu_torch.sim.state import uniform_payloads

    cfg = _gapstress_cfg(n, gap_slots)
    meta = uniform_payloads(cfg, dev, inject_every=0,
                            payload_bytes=gapstress_payload_sizes(
                                cfg.n_payloads))
    return cfg, meta


def compare_budget_words(dev, g, n=GAPSTRESS_N, timed=True):
    """K16 on the broadcast governor's rows (N x W = 256 over the
    gapstress sizes, half the bits set: about 9.5 MB a row) under its
    5 MiB budget and a budget of 1, with empty rows; and on 64 rows of
    P = 65 536 (JAX's two-lane branch) under 9 MB."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.runner import gapstress_payload_sizes

    cfg, meta = _gapstress(n, dev)
    w = cfg.n_payloads // 32
    elig = _random_words(g, (n, w), dev)
    elig[::97] = 0
    big_p = 65_536
    big_sizes = torch.as_tensor(gapstress_payload_sizes(big_p), device=dev)
    cases = [(elig, cfg.rate_limit_bytes_round, meta.nbytes),
             (elig, 1, meta.nbytes),
             (_random_words(g, (64, big_p // 32), dev), 9_000_000,
              big_sizes)]
    equal, err, outs = True, 0, []
    for words, budget, sizes in cases:
        got = packed.budget_prefix_words(words, budget, sizes)
        want = packed.budget_prefix_words_plain(words, budget, sizes)
        e, x = _equal_all([got], [want])
        equal, err = equal and e, max(err, x)
        outs.append(want)
    for (words, _, _), want in zip(cases, outs):
        if torch.equal(words, want) or not bool(want.any()):
            raise AssertionError("K16 inputs: a budget keeps all or nothing")
    budget = cfg.rate_limit_bytes_round
    return _row(
        "budget_words", "corrosion_tpu_torch/kernels/csrc/budget_words.cu",
        "corrosion_tpu/sim/packed.py:102", equal, err,
        _timed(timed, lambda: packed.budget_prefix_words(elig, budget,
                                                         meta.nbytes)),
        _timed(timed, lambda: packed.budget_prefix_words_plain(
            elig, budget, meta.nbytes)),
        # the rows in and out, the sizes
        _nbytes(elig, meta.nbytes) + elig.numel() * 4,
        kernel="budget_words",
    )


def compare_sync_pull_metered(dev, g, n=GAPSTRESS_N, timed=True):
    """K3's metered entry at gapstress's shapes (W = 256, S = 3) under the
    4 MiB grant (it binds: each edge needs megabytes) and a grant of 1
    (edges with a need that pull nothing, so fruitful falls), with self
    and dead peers and words that carry bit 31."""
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _gapstress(n, dev)
    w, s = cfg.n_payloads // 32, cfg.sync_peers
    masks = _random_words(g, (n, 4, w), dev)
    # even rows serve (7 bits in 8 held), odd rows lag (1 in 8), so a
    # lagging puller needs most of a serving peer's megabytes
    serving = ~_random_words(g, (n, w), dev, 3)
    lagging = _random_words(g, (n, w), dev, 3)
    masks[:, 3] = torch.where(torch.arange(n, device=dev)[:, None] % 2 == 0,
                              serving, lagging)
    miss = _random_words(g, (n, w), dev, 2)
    me = np.arange(n)[:, None]
    peers = np.where(g.random((n, s)) < 0.03, me,
                     2 * g.integers(0, n // 2, (n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=dev)
    buf0 = torch.zeros((n, w), dtype=torch.int32, device=dev)
    grant = cfg.sync_budget_bytes
    equal, err, outs = True, 0, {}
    for budget in (None, grant, 1):
        got_buf, want_buf = buf0.clone(), buf0.clone()
        want = packed.sync_pull_plain(masks, miss, peers, ok, want_buf,
                                      budget, meta.nbytes)
        outs[budget] = (want, want_buf)
        if budget is None:
            continue
        got = packed.sync_pull(masks, miss, peers, ok, got_buf, budget,
                               meta.nbytes)
        e, x = _equal_all([got, got_buf], [want, want_buf])
        equal, err = equal and e, max(err, x)
    if torch.equal(outs[None][1], outs[grant][1]):
        raise AssertionError("K3 metered inputs: the grant never binds")
    if not bool((outs[None][0] & ~outs[1][0]).any()):
        raise AssertionError("K3 metered inputs: no need is granted nothing")
    if not bool((outs[grant][1] < 0).any()):
        raise AssertionError("K3 metered inputs pull no word with bit 31")
    work = buf0.clone()

    def restore():
        work.zero_()

    return _row(
        "sync_pull_metered", "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        "corrosion_tpu/sim/packed.py:1238", equal, err,
        _timed(timed, lambda: packed.sync_pull(
            masks, miss, peers, ok, work, grant, meta.nbytes), restore),
        _timed(timed, lambda: packed.sync_pull_plain(
            masks, miss, peers, ok, work, grant, meta.nbytes), restore),
        # the mask and miss rows live sessions read, peers and ok, the
        # slot words the grants touch in and out, fruitful, the sizes
        _pull_read_bytes(masks, miss, peers, ok, True)
        + _nbytes(peers, ok, meta.nbytes)
        + _grant_words(masks, miss, peers, ok, grant, meta.nbytes) * 4 * 2
        + n,
        kernel="sync_pull_metered",
    )


def compare_scatter_topo(dev, g, n=GAPSTRESS_N, timed=True):
    """K10 at gapstress's shapes (E = 3N, W = 256, D = 4): the topology
    stream alone at round(0.3 * 256) = 77 (the path), the fault stream
    alone, both at once, and a severed channel (256) with and without
    fault loss."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import loss_threshold

    cfg, _ = _gapstress(n, dev)
    w, f, d = cfg.n_payloads // 32, cfg.fanout, cfg.n_delay_slots
    e = n * f
    sending = _random_words(g, (n, w), dev, 4)
    dst = torch.as_tensor(g.integers(0, n, e), dtype=torch.int32, device=dev)
    slot = torch.as_tensor(g.integers(0, d, e), dtype=torch.int32,
                           device=dev)
    ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
    thr = torch.as_tensor(np.where(g.random(e) < 0.3, 0,
                                   g.integers(1, 80, e)),
                          dtype=torch.uint8, device=dev)
    key, topo_key = trng.prng_key(5, dev), trng.prng_key(6, dev)
    topo_thr = loss_threshold(0.3)
    ring0 = _random_words(g, (d, n, w), dev, 6)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    cases = {"topology": (None, topo_thr), "fault": (thr, 0),
             "both": (thr, topo_thr), "severed": (None, 256),
             "severed_fault": (thr, 256)}
    equal, err, outs = True, 0, {}
    for name, (t, tt) in cases.items():
        got, want = ring0.clone(), ring0.clone()
        args = (sending, dst, slot, ok, t, key, 11, f, tt, topo_key)
        packed.scatter_sending_lossy(got, *args)
        packed.scatter_sending_lossy_plain(want, *args)
        e_, x = _equal_all([got], [want])
        equal, err = equal and e_, max(err, x)
        outs[name] = want
    if any(torch.equal(outs[k], lossless)
           for k in ("topology", "fault", "both")):
        raise AssertionError("K10 inputs: a lossy stream drops nothing")
    if (torch.equal(outs["both"], outs["topology"])
            or torch.equal(outs["both"], outs["fault"])):
        raise AssertionError("K10 inputs: the two streams do not compose")
    if not (torch.equal(outs["severed"], ring0)
            and torch.equal(outs["severed_fault"], ring0)):
        raise AssertionError("K10: a severed channel let a payload through")
    live = (sending.repeat_interleave(f, dim=0) != 0) & ok[:, None]
    hashes = int(live.sum()) * 8
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    nbytes = sending.numel() * 4 + e * 9 + rows_touched * w * 4 * 2
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    args = (sending, dst, slot, ok, None, key, 11, f, topo_thr, topo_key)
    return dict(
        name="broadcast_scatter_lossy_topo",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/topology.py:267",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: packed.scatter_sending_lossy(ring_k, *args)),
        # the plain version finds its pairs with a host sync: eager, and
        # at ~0.3 s a call, few of them
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, *args), SLOW_PLAIN_REPS) if timed else None,
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes",
        ops=ops, hashes=hashes, bytes=nbytes,
        kernel="broadcast_scatter_lossy",
    )


def compare_gaps_wide(dev, g, n=GAPSTRESS_N, timed=True):
    """K6 past 32 versions at gapstress's shapes (A = 8, V = 128, C = 8,
    K = 8; one chunk bit in 16 set, so 40 % of versions touched: many
    runs, overflow, runs across version-word edges, heads at 32j, empty
    rows) and at V = 40, not a multiple of 32."""
    from corrosion_tpu_torch.sim import gaps

    cfg, _ = _gapstress(n, dev)
    w = cfg.n_payloads // 32
    have = _random_words(g, (n, w), dev, 4)
    have[::101] = 0
    # rows that hold no version past 32, 64 or 96 (a version is 64 bits,
    # two words): their heads land on 32j where that version is touched
    for i, words in enumerate((64, 128, 192)):
        have[i::21, words:] = 0
    narrow = dataclasses.replace(cfg, n_payloads=40 * 64)
    cases = [(have, cfg), (have[:, :narrow.n_payloads // 32].contiguous(),
                           narrow)]
    equal, err = True, 0
    for words, c in cases:
        got = gaps.refresh_gaps(words, c)
        want = gaps.refresh_gaps_plain(words, c)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        heads, lo, hi, n_over = want
        crosses = (lo > 0) & ((lo - 1) // 32 != (hi - 1) // 32)
        if not (int(n_over) > 0 and bool(crosses.any())
                and bool(((heads % 32 == 0) & (heads > 0)).any())
                and bool((heads == 0).any())):
            raise AssertionError(f"K6 inputs at V = {c.n_versions} miss "
                                 "an overflow, a run across a word edge, "
                                 "a head at 32j or an empty row")
    a, k = cfg.n_writers, cfg.gap_slots
    return _row(
        "gaps_refresh_v128",
        "corrosion_tpu_torch/kernels/csrc/gaps_refresh.cu",
        "corrosion_tpu/sim/gaps.py:64", equal, err,
        _timed(timed, lambda: gaps.refresh_gaps(have, cfg)),
        _timed(timed, lambda: gaps.refresh_gaps_plain(have, cfg)),
        # the have words in; heads, lo, hi and the count out
        n * w * 4 + n * a * 4 + 2 * n * a * k * 4 + 4,
        kernel="gaps_refresh",
    )


def compare_gapstress_kernels(dev, seed=2):
    """Phase 3c: K16, K3's mask pass and metered entry, K10's topology
    stream and K6 past 32 versions at gapstress-25.6k's shapes, and K14 at the
    distortion control's (N = 1024, V = 128, C = 8, K = 64)."""
    g = np.random.default_rng(seed)
    cfg, _ = _gapstress(GAPSTRESS_N, dev)
    rows = [
        compare_budget_words(dev, g),
        compare_sync_masks(dev, g, cfg, (GAPSTRESS_N,), "sync_masks_gs")[0],
        compare_sync_pull_metered(dev, g),
        compare_scatter_topo(dev, g),
        compare_gaps_wide(dev, g),
        compare_dense_gaps(dev, g, n=1024, n_writers=8, n_payloads=8192,
                           chunks=8, gap_slots=64, p_one=0.083,
                           name="dense_gaps_k64"),
    ]
    rows[-1]["kernel"] = "dense_gaps"
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the flight recorder: K17-K19 and the telemetry outputs of K3, K9,
# K10, K12 and K13 ---------------------------------------------------------

STORM_N = 100_000
DENSE_GAPSTRESS_N = 1024
_TRACE_SRC = "corrosion_tpu_torch/kernels/csrc/"


def _acc(dev):
    """A zeroed int64 accumulator, as a trace's slots are."""
    return torch.zeros((), dtype=torch.int64, device=dev)


def _alive(g, n, dev):
    return torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                           device=dev)


def compare_trace_counts(dev, g, n, w, e, label="", timed=True):
    """K17's grant and coverage entries as a round runs them: the
    per-payload counts of [E, W] granted words, and the coverage (up
    rows) and delivered (held now, not at round start) counts of [N, W]
    have words, with words that carry bit 31, added to a count row."""
    from corrosion_tpu_torch.sim import fused, telemetry

    p = w * 32
    granted = _random_words(g, (e, w), dev, 2)
    have = _random_words(g, (n, w), dev)
    have0 = have & _random_words(g, (n, w), dev)
    alive = _alive(g, n, dev)
    if not (bool((granted < 0).any()) and bool((have < 0).any())):
        raise AssertionError("K17 inputs carry no word with bit 31")

    def kernel(out):
        telemetry.count_words_(out[2], granted)
        telemetry.coverage_delivered_(out[0:2], have, have0, alive)

    def plain(out):
        out[2] += fused.word_bit_counts(granted, p)
        cov, dlv = telemetry.word_coverage_delivered(have, have0, alive == 0,
                                                     p)
        out[0] += cov
        out[1] += dlv

    got = torch.full((3, p), 7, dtype=torch.int32, device=dev)
    want = got.clone()
    kernel(got)
    plain(want)
    work = torch.zeros_like(got)
    return _row(
        f"trace_counts{label}", _TRACE_SRC + "trace_counts.cu",
        "corrosion_tpu/sim/fused.py:109", bool(torch.equal(got, want)),
        _max_abs_err(got, want), _timed(timed, lambda: kernel(work)),
        _timed(timed, lambda: plain(work)),
        # the words in, the three count rows in and out
        _nbytes(granted, have, have0, alive) + 2 * 3 * p * 4,
        kernel="trace_counts",
    )


def compare_trace_counts_dense(dev, g, n=DENSE_GAPSTRESS_N, p=8192,
                               timed=True):
    """K17's dense entry at gapstress-1024's shape (u8 [N, P])."""
    from corrosion_tpu_torch.sim import telemetry

    have = _u8(g, (n, p), 0.5, dev)
    have0 = have & _u8(g, (n, p), 0.7, dev)
    alive = _alive(g, n, dev)

    def kernel(out):
        telemetry.coverage_delivered_dense_(out, have, have0, alive)

    def plain(out):
        cov, dlv = telemetry.coverage_delivered_dense_plain(have, have0,
                                                            alive)
        out[0] += cov
        out[1] += dlv

    got = torch.full((2, p), 3, dtype=torch.int32, device=dev)
    want = got.clone()
    kernel(got)
    plain(want)
    work = torch.zeros_like(got)
    return _row(
        "trace_counts_dense", _TRACE_SRC + "trace_counts.cu",
        "corrosion_tpu/sim/telemetry.py:290", bool(torch.equal(got, want)),
        _max_abs_err(got, want), _timed(timed, lambda: kernel(work)),
        _timed(timed, lambda: plain(work)),
        _nbytes(have, have0, alive) + 2 * 2 * p * 4,
        kernel="trace_counts_dense",
    )


def compare_trace_wire(dev, g, n, w, f, nbytes, label="", timed=True):
    """K18's words entry: the frames and bytes of [N, W] sending words on
    the ok edges, added to the int64 accumulators; the byte total passes
    2^31."""
    from corrosion_tpu_torch.sim import telemetry

    sending = _random_words(g, (n, w), dev, 3)
    ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    want_f, want_b = telemetry.wire_words_plain(sending, nbytes, ok, f)
    if int(want_b) < 1 << 31:
        raise AssertionError("K18 inputs: the byte total fits 32 bits")
    got = torch.tensor([5, 1 << 40], dtype=torch.int64, device=dev)
    want = got + torch.stack([want_f, want_b])
    telemetry.wire_words_(got, sending, nbytes, ok, f)
    work = torch.zeros(2, dtype=torch.int64, device=dev)

    def plain():
        fr, by = telemetry.wire_words_plain(sending, nbytes, ok, f)
        work[0] += fr
        work[1] += by

    return _row(
        f"trace_wire{label}", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:192", bool(torch.equal(got, want)),
        _max_abs_err(got, want),
        _timed(timed, lambda: telemetry.wire_words_(work, sending, nbytes, ok,
                                                    f)),
        _timed(timed, plain), _nbytes(sending, nbytes, ok) + 2 * 8,
        kernel="trace_wire",
    )


def compare_trace_wire_rows(dev, g, n=DENSE_GAPSTRESS_N, f=3, timed=True):
    """K18's rows entry at gapstress-1024's shape: K12's per-node frames
    and bytes folded over the ok edges."""
    from corrosion_tpu_torch.sim import fused, telemetry

    frames = torch.as_tensor(g.integers(0, 8193, n), dtype=torch.int32,
                             device=dev)
    byte_tot = torch.as_tensor(g.integers(0, 1 << 26, n), dtype=torch.int32,
                               device=dev)
    ok = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    got = torch.zeros(2, dtype=torch.int64, device=dev)
    telemetry.wire_rows_(got, frames, byte_tot, ok, f)
    want = torch.stack(fused.fold_over_edges(frames, byte_tot, ok, f))
    if int(want[1]) < 1 << 31:
        raise AssertionError("K18 rows inputs: the byte total fits 32 bits")
    work = torch.zeros(2, dtype=torch.int64, device=dev)

    def plain():
        fr, by = fused.fold_over_edges(frames, byte_tot, ok, f)
        work[0] += fr
        work[1] += by

    return _row(
        "trace_wire_rows", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:225", bool(torch.equal(got, want)),
        _max_abs_err(got, want),
        _timed(timed, lambda: telemetry.wire_rows_(work, frames, byte_tot, ok,
                                                   f)),
        _timed(timed, plain), _nbytes(frames, byte_tot, ok) + 2 * 8,
        kernel="trace_wire_rows",
    )


def _trace_row_case(g, dev, n, p, nbytes, swim, faults, every=1,
                    rounds=40, m=64):
    """A trace mid-run and the rest of a row's inputs: accumulators that
    pass 2^31 bytes, count rows, a member table (partial view) or beliefs
    (full view), a fault slice, session and overflow totals."""
    from corrosion_tpu_torch.sim import telemetry
    from corrosion_tpu_torch.sim.state import SimConfig

    kw = ({"swim_partial_view": True, "member_slots": m} if swim == "partial"
          else {"swim_full_view": True} if swim == "full" else {})
    cfg = SimConfig(n_nodes=n, n_payloads=p, trace_every=every, **kw)
    trace = telemetry.new_trace(cfg, rounds, dev)
    for name in telemetry.CHANNELS:
        t = getattr(trace, name)
        t.copy_(torch.as_tensor(g.integers(0, 99, tuple(t.shape)),
                                dtype=t.dtype, device=dev))
    trace.acc[:5] = torch.as_tensor(
        [g.integers(0, 1 << 31), (1 << 36) + int(g.integers(0, 1 << 20)),
         g.integers(0, 1 << 30), g.integers(0, 1 << 20),
         g.integers(0, 1 << 20)], dtype=torch.int64, device=dev)
    trace.counts.copy_(torch.as_tensor(g.integers(0, 3 * n, (3, p)),
                                       dtype=torch.int32, device=dev))
    state = SimpleNamespace(pid=None, pkey=None, view=None)
    if swim == "partial":
        pid, pkey, _ = _random_tables(g, n, m, 40)
        state.pid = torch.as_tensor(pid, dtype=torch.int32, device=dev)
        state.pkey = torch.as_tensor(pkey, dtype=torch.int32, device=dev)
    elif swim == "full":
        state.view = torch.as_tensor(g.integers(-1, 3, (n, n)),
                                     dtype=torch.int8, device=dev)
    rf = None
    if faults:
        rf = SimpleNamespace(
            alive=torch.as_tensor(g.integers(-1, 3, n), dtype=torch.int8,
                                  device=dev),
            wipe=torch.as_tensor(g.random(n) < 0.01, device=dev))
    kw = dict(alive=_alive(g, n, dev), state=state, cfg=cfg, rf=rf,
              sync_ok=torch.as_tensor(g.random(3 * n) < 0.3, device=dev),
              n_overflow=torch.tensor(int(g.integers(0, n)),
                                      dtype=torch.int32, device=dev),
              nbytes=nbytes)
    return trace, kw


def _clone_trace(trace):
    return type(trace)(*(t.clone() for t in trace))


def compare_trace_row(dev, g, n, p, nbytes, label="", timed=True):
    """K19 writing a row of a partial-view fault run (row 7), the scratch
    row of a decimated one, and a full-view row, each against the plain
    version on copies of the same trace: every channel, and the
    accumulators zeroed."""
    from corrosion_tpu_torch.sim import telemetry

    cases = [("partial", True, 1, 7), ("partial", True, 3, 8)]
    if not label:
        cases.append(("full", False, 1, 3))
    equal, err, timed_case = True, 0, None
    for swim, faults, every, t in cases:
        nn = 4096 if swim == "full" else n
        base, kw = _trace_row_case(g, dev, nn, p, nbytes, swim, faults,
                                   every)
        row = telemetry.trace_row(base, t, every)
        got, want = _clone_trace(base), _clone_trace(base)
        telemetry.record_row(got, row, **kw)
        telemetry.record_row_plain(want, row, **kw)
        e, x = _equal_all(list(got), list(want))
        equal, err = equal and e, max(err, x)
        if bool(got.acc.any()) or bool(got.counts.any()):
            raise AssertionError("K19 left an accumulator set")
        timed_case = timed_case or (base, kw)  # the first: row 7, faults
    work = _clone_trace(timed_case[0])
    kw = timed_case[1]
    m = kw["state"].pid.shape[1]
    return _row(
        f"trace_row{label}", _TRACE_SRC + "trace_row.cu",
        "corrosion_tpu/sim/telemetry.py:202", equal, err,
        _timed(timed, lambda: telemetry.record_row(work, 7, **kw)),
        _timed(timed, lambda: telemetry.record_row_plain(work, 7, **kw)),
        # alive, the member table, the fault slice, the sessions, the
        # sizes and count rows in; the row, the zeroed rows and totals out
        n * (1 + 8 * m + 2 + 3) + p * 4 * (1 + 3 + 3 + 2) + 12 * 8 * 2 + 64,
        kernel="trace_row",
    )


def compare_trace_outputs(dev, g, timed=True, n=STORM_N,
                          n_gs=GAPSTRESS_N, n_dense=DENSE_GAPSTRESS_N):
    """The telemetry outputs of kernels already ported, each launch with
    its output against the plain version with it: K3's granted words at
    the storm's shapes and its metered entry's at gapstress's, K9's cut
    and refused counts and K10's dropped frames at the fault storm's
    round 5, K10's dropped frames under gapstress's topology stream, and
    K12's per-node frames, bytes and dropped frames and K13's grant
    counts at gapstress-1024's dense shape."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import faults, packed, sync
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import loss_threshold

    rows = []

    # K3 and its metered entry: the granted words
    for label, nn, w, budget, kern in (
            ("sync_pull_granted", n, 16, None, "sync_pull"),
            ("sync_pull_metered_granted", n_gs, 256, 4 * 1024 * 1024,
             "sync_pull_metered")):
        cfg, meta = (_storm_cfg(nn, dev) if budget is None
                     else _gapstress(nn, dev))
        s = 3
        masks = _random_words(g, (nn, 4, w), dev)
        miss = _random_words(g, (nn, w), dev, 2)
        peers = torch.as_tensor(g.integers(0, nn, (nn, s)), dtype=torch.int32,
                                device=dev)
        ok = torch.as_tensor(g.random((nn, s)) < 0.7, device=dev)
        outs = []
        for fn in (packed.sync_pull, packed.sync_pull_plain):
            buf = torch.zeros((nn, w), dtype=torch.int32, device=dev)
            granted = torch.full((nn * s, w), -1, dtype=torch.int32,
                                 device=dev)
            fr = fn(masks, miss, peers, ok, buf, budget, meta.nbytes, granted)
            outs.append([fr, buf, granted])
        e, x = _equal_all(outs[0], outs[1])
        if not bool((outs[1][2] < 0).any()):
            raise AssertionError(f"{label} inputs grant no word with bit 31")
        work = torch.zeros((nn, w), dtype=torch.int32, device=dev)
        granted = torch.empty((nn * s, w), dtype=torch.int32, device=dev)
        rows.append(_row(
            label, _TRACE_SRC + "sync_pull.cu",
            "corrosion_tpu/sim/packed.py:1238", e, x,
            _timed(timed, lambda: packed.sync_pull(
                masks, miss, peers, ok, work, budget, meta.nbytes, granted)),
            # the metered plain version takes ~0.08 s a call: few calls
            _time_ms(lambda: packed.sync_pull_plain(
                masks, miss, peers, ok, work, budget, meta.nbytes, granted),
                REPS if budget is None else SLOW_PLAIN_REPS)
            if timed else None,
            _pull_read_bytes(masks, miss, peers, ok, budget is not None)
            + _nbytes(peers, ok, meta.nbytes, granted)
            + nn * w * 4 * 2 + nn, kernel=kern))

    # K9's counts and K10's dropped frames at the fault storm's round 5
    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    f, w = cfg.fanout, cfg.n_payloads // 32
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.as_tensor(g.integers(0, n, n * f), dtype=torch.int32,
                          device=dev)
    ok0 = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    counts = []
    for kernel in (True, False):
        ok_w, ok_s, cut, refused = (ok0.clone(), ok0.clone(), _acc(dev),
                                    _acc(dev))
        if kernel:
            _, thr, _, _ = faults.fault_wire_effects(rf, src, dst, ok_w,
                                                     cut)
            faults.fault_session_refused(rf, src, dst, ok_s, refused)
        else:
            blk = faults._block_plain(rf, src, dst)
            cut += (ok_w & blk).sum()
            ok_w &= ~blk
            thr = faults._loss_plain(rf, src, dst)
            ref = blk | faults._block_plain(rf, dst, src)
            refused += (ok_s & ref).sum()
            ok_s &= ~ref
        counts.append([ok_w, ok_s, cut, refused, thr])
    e9, x9 = _equal_all(counts[0], counts[1])
    if int(counts[1][2]) == 0 or int(counts[1][3]) == 0:
        raise AssertionError("K9 count inputs cut and refuse nothing")

    def k9(kernel):
        ok_w, ok_s, cut, refused = (ok0.clone(), ok0.clone(), _acc(dev),
                                    _acc(dev))
        if kernel:
            faults.fault_wire_effects(rf, src, dst, ok_w, cut)
            faults.fault_session_refused(rf, src, dst, ok_s, refused)
        else:
            blk = faults._block_plain(rf, src, dst)
            cut += (ok_w & blk).sum()
            ref = blk | faults._block_plain(rf, dst, src)
            refused += (ok_s & ref).sum()

    rows.append(_row(
        "fault_edges_counts", _TRACE_SRC + "fault_edges.cu",
        "corrosion_tpu/sim/faults.py:260", e9, x9,
        _timed(timed, lambda: k9(True)), _timed(timed, lambda: k9(False)),
        # two edge lists, the masks, ok in and out twice, thr, the counts
        n * f * (8 + 4 + 1) + 4 * n * 2 + 16, kernel="fault_edges"))

    ok_w, thr = counts[1][0], counts[1][4]
    key = trng.prng_key(99, dev)
    gs_cfg, _ = _gapstress(n_gs, dev)
    gw, gd = gs_cfg.n_payloads // 32, gs_cfg.n_delay_slots
    g_ok = torch.as_tensor(g.random(n_gs * f) < 0.9, device=dev)
    # (label, ring, sending, dst, slot, ok, the streams, the edges hashed)
    cases = (
        ("broadcast_scatter_lossy_dropped",
         _random_words(g, (2, n, w), dev, 6),
         _random_words(g, (n, w), dev, 4), dst, torch.full_like(dst, 1),
         ok_w, dict(thr=thr, key=key, seed=int(rf.seed)), ok_w & (thr > 0)),
        # an empty ring: the drops, not the ring's old words, are the point
        ("broadcast_scatter_lossy_topo_dropped",
         torch.zeros((gd, n_gs, gw), dtype=torch.int32, device=dev),
         _random_words(g, (n_gs, gw), dev, 4),
         torch.as_tensor(g.integers(0, n_gs, n_gs * f), dtype=torch.int32,
                         device=dev),
         torch.as_tensor(g.integers(0, gd, n_gs * f), dtype=torch.int32,
                         device=dev),
         g_ok, dict(thr=None, key=key, seed=0, topo_thr=loss_threshold(0.3),
                    topo_key=trng.prng_key(6, dev)), g_ok),
    )
    rate = _int32_ops_per_s()
    for label, ring0, snd, dst_, slot_, ok_, streams, hashed in cases:

        def scatter(fn, ring, dropped):
            fn(ring, snd, dst_, slot_, ok_, streams["thr"], streams["key"],
               streams["seed"], f, streams.get("topo_thr", 0),
               streams.get("topo_key"), dropped)

        outs = []
        for fn in (packed.scatter_sending_lossy,
                   packed.scatter_sending_lossy_plain):
            ring, dropped = ring0.clone(), _acc(dev)
            scatter(fn, ring, dropped)
            outs.append([ring, dropped])
        e, x = _equal_all(outs[0], outs[1])
        if int(outs[1][1]) == 0:
            raise AssertionError(f"{label} inputs drop nothing")
        live = (snd.repeat_interleave(f, dim=0) != 0) & hashed[:, None]
        ops = int(live.sum()) * 8 * OPS_PER_HASH
        nb = snd.numel() * 4 + dst_.shape[0] * 10 + ring0.numel() * 4 * 2
        ring_k, ring_p, d_k, d_p = (ring0.clone(), ring0.clone(), _acc(dev),
                                    _acc(dev))
        rows.append(dict(
            name=label, source=_TRACE_SRC + "broadcast_scatter.cu",
            replaces="corrosion_tpu/sim/packed.py:369", equal=e,
            max_abs_err=x,
            ms=_timed(timed, lambda: scatter(packed.scatter_sending_lossy,
                                             ring_k, d_k)),
            # the plain version finds its pairs with a host sync: eager,
            # and few calls of it under the topology stream (~0.3 s each)
            plain_ms=_time_eager_ms(lambda: scatter(
                packed.scatter_sending_lossy_plain, ring_p, d_p),
                REPS if streams["thr"] is not None else SLOW_PLAIN_REPS)
            if timed else None,
            bound_ms=max(_bound_ms(nb), ops / rate * 1e3),
            bound_by="operations" if ops / rate * 1e3 > _bound_ms(nb)
            else "bytes",
            kernel="broadcast_scatter_lossy"))

    # K12 and K13 at gapstress-1024's dense shape
    cfg, meta = _gapstress(n_dense, dev)
    t = 0
    have, relay, injected, ring, sync_ring, alive, group = \
        _dense_round_inputs(g, dev, cfg, meta, t)
    f = cfg.fanout
    targets = torch.as_tensor(g.integers(0, n_dense, (n_dense, f)),
                              dtype=torch.int32, device=dev)
    dst = targets.reshape(-1)
    src = torch.arange(n_dense, dtype=torch.int32,
                       device=dev).repeat_interleave(f)
    ok = (dst != src) & (torch.as_tensor(g.random(n_dense * f) < 0.95,
                                         device=dev))
    slot = torch.full_like(dst, t % cfg.n_delay_slots)
    key = trng.prng_key(71, dev)
    thr = loss_threshold(0.3)
    budget = cfg.rate_limit_bytes_round

    def k12(fn, outs):
        rel, rng_ = relay.clone(), ring.clone()
        rf_, rb_, dr_ = outs
        fn(have, rel, injected, meta.nbytes, budget, targets, dst, slot, ok,
           alive, key, thr, rng_, rf_, rb_, dr_)
        return [rel, rng_, rf_, rb_, dr_]

    def k12_outs():
        return (torch.full((n_dense,), -5, dtype=torch.int32, device=dev),
                torch.full((n_dense,), -5, dtype=torch.int32, device=dev),
                _acc(dev))

    got = k12(bc.broadcast_send, k12_outs())
    want = k12(bc.broadcast_send_plain, k12_outs())
    e, x = _equal_all(got, want)
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    heaviest = int((eligible.to(torch.int64) * meta.nbytes.to(torch.int64))
                   .sum(dim=1).max())
    if int(want[4]) == 0 or heaviest <= budget:
        raise AssertionError("K12 telemetry inputs: nothing lost or the "
                             "budget never binds")
    outs_k, outs_p = k12_outs(), k12_outs()
    rows.append(_row(
        "dense_phases_telemetry", _TRACE_SRC + "dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:32", e, x,
        _timed(timed, lambda: k12(bc.broadcast_send, outs_k)),
        _timed(timed, lambda: k12(bc.broadcast_send_plain, outs_p)),
        _nbytes(have, relay, injected, meta.nbytes, targets, dst, slot, ok,
                alive) + n_dense * 8 + 8, kernel="dense_phases"))

    heads, lo, hi, _ = _advertised(g, dev, cfg, have, 10)
    peers = torch.as_tensor(g.integers(0, n_dense, (n_dense, 3)),
                            dtype=torch.int32, device=dev)
    pok = torch.as_tensor(g.random((n_dense, 3)) < 0.7, device=dev)
    outs = []
    for fn in (sync.sync_pull_dense, sync.sync_pull_dense_plain):
        slot_ring = torch.zeros_like(have)
        cnt = torch.full((cfg.n_payloads,), 9, dtype=torch.int32, device=dev)
        fr = fn(have, heads, lo, hi, peers, pok, meta.nbytes,
                cfg.sync_budget_bytes, slot_ring, cfg, cnt)
        outs.append([fr, slot_ring, cnt])
    e, x = _equal_all(outs[0], outs[1])
    work = torch.zeros_like(have)
    cnt = torch.zeros(cfg.n_payloads, dtype=torch.int32, device=dev)
    rows.append(_row(
        "dense_sync_counts", _TRACE_SRC + "dense_sync.cu",
        "corrosion_tpu/sim/sync.py:122", e, x,
        _timed(timed, lambda: sync.sync_pull_dense(
            have, heads, lo, hi, peers, pok, meta.nbytes,
            cfg.sync_budget_bytes, work, cfg, cnt)),
        _timed(timed, lambda: sync.sync_pull_dense_plain(
            have, heads, lo, hi, peers, pok, meta.nbytes,
            cfg.sync_budget_bytes, work, cfg, cnt)),
        _nbytes(have, heads, lo, hi, peers, pok, meta.nbytes, cnt) * 1
        + n_dense * cfg.n_payloads, kernel="dense_sync"))
    return rows


def compare_trace_kernels(dev, seed=3):
    """Phase 3d: K17-K19 at the storm's shapes (N = 100000, W = 16,
    E = 300000, M = 64) and gapstress's (N = 25600, W = 256, mixed
    sizes; rows marked gs), K17's dense entry and K18's rows entry at
    gapstress-1024's, and the telemetry outputs of K3, K9, K10, K12 and
    K13; every row with a trap (bit 31, byte totals past 2^31, a
    decimated scratch row, a full view, drops and cuts)."""
    from corrosion_tpu_torch.sim.runner import _write_storm

    g = np.random.default_rng(seed)
    _, storm_meta = _write_storm(STORM_N, 512, dev)
    _, gs_meta = _gapstress(GAPSTRESS_N, dev)
    rows = [
        compare_trace_counts(dev, g, STORM_N, 16, 3 * STORM_N),
        compare_trace_counts(dev, g, GAPSTRESS_N, 256, 3 * GAPSTRESS_N,
                             "_gs"),
        compare_trace_counts_dense(dev, g),
        compare_trace_wire(dev, g, STORM_N, 16, 3, storm_meta.nbytes),
        compare_trace_wire(dev, g, GAPSTRESS_N, 256, 3, gs_meta.nbytes,
                           "_gs"),
        compare_trace_wire_rows(dev, g),
        compare_trace_row(dev, g, STORM_N, 512, storm_meta.nbytes),
        compare_trace_row(dev, g, GAPSTRESS_N, 8192, gs_meta.nbytes, "_gs"),
        *compare_trace_outputs(dev, g),
    ]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the latency storm's kernels: K9's latency entry, K10's jitter stream,
# K3's delay entry ------------------------------------------------------------

def latency_storm_plan(n, seed=0):
    """`storm_fault_plan`'s events, then JAX's "storm-mix" latency pair
    (tests/sim/test_packed_equivalence.py) over the first sixth of the
    nodes: one round of delay and up to one of jitter on every link out
    of them, rounds 2-15 (the plan tests/torch_parity.py builds)."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
    from corrosion_tpu_torch.sim.runner import storm_fault_plan

    base = storm_fault_plan(n, seed)
    sel = f"0:{n // 6}"
    return FaultPlan(n_nodes=n, seed=base.seed, events=(
        *base.events,
        FaultEvent("delay", 2, 16, src=sel, dst="*", delay_rounds=1),
        FaultEvent("jitter", 2, 16, src=sel, dst="*", delay_rounds=1),
    ))


def _latency_storm(n, dev):
    """latency-storm-n: the write storm with four delay slots (the one
    change: compile_plan needs 1 + delay 1 + jitter 1 < n_delay_slots),
    its payloads and its compiled plan."""
    from corrosion_tpu_torch.sim import faults

    cfg, meta = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, n_delay_slots=4)
    return cfg, meta, faults.compile_plan(latency_storm_plan(n), cfg,
                                          device=dev)


def _trap(number, what, reached):
    """Print whether trap ``number`` (an int for the latency slice's,
    "dense n" for the dense fault entries') was reached; fail if not."""
    label = number if isinstance(number, str) else f"latency {number}"
    print(f"trap {label} ({what}): "
          f"{'reached' if reached else 'NOT reached'}", flush=True)
    if not reached:
        raise AssertionError(f"trap {label} not reached: {what}")


def _overlap_plan(n):
    """Delays and jitters that overlap: the latency pair, a two-round
    delay into the first half (sums of 3), a two-round jitter out of the
    nodes n/12 to 3n/10 (a max of 2), rounds 2-15."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan

    plan = latency_storm_plan(n)
    return FaultPlan(n_nodes=n, seed=plan.seed, events=(
        *plan.events,
        FaultEvent("delay", 2, 16, src="*", dst=f"0:{n // 2}",
                   delay_rounds=2),
        FaultEvent("jitter", 2, 16, src=f"{n // 12}:{3 * n // 10}",
                   dst="*", delay_rounds=2),
    ))


def compare_fault_latency(dev, g, n=STORM_N, timed=True):
    """K9's latency entry at the latency storm's round 6 (E = 3N): the
    wire's cuts, thresholds, fault delay and jitter bound, the session's
    refusals (counted) and session delay, each in one launch, and the
    three queries alone — on the path's plan and on one whose delays add
    (3 rounds), whose jitters take a max (2) and whose session delay is
    the reversed edge's; self-edges on both sides of every mask."""
    from corrosion_tpu_torch.sim import faults

    cfg, _, fplan = _latency_storm(n, dev)
    f = cfg.fanout
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = np.where(g.random(n * f) < 0.05, np.repeat(np.arange(n), f),
                   g.integers(0, n, n * f))
    dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    ok0 = torch.as_tensor(g.random(n * f) < 0.9, device=dev)
    wide = dataclasses.replace(cfg, n_delay_slots=8)
    overlap = faults.compile_plan(_overlap_plan(n), wide, device=dev)

    def calls(rf, kernel):
        ok_w, ok_s, refused = ok0.clone(), ok0.clone(), _acc(dev)
        if kernel:
            wire = faults.fault_wire_effects(rf, src, dst, ok_w)
            session = faults.fault_session_effects(rf, src, dst, ok_s,
                                                   refused)
            return [*wire, *session, ok_s, refused]
        blk = faults._block_plain(rf, src, dst)
        ok_w &= ~blk
        ref = blk | faults._block_plain(rf, dst, src)
        refused += (ok_s & ref).sum()
        ok_s &= ~ref
        return [ok_w, faults._loss_plain(rf, src, dst),
                faults._delay_plain(rf, src, dst),
                faults._jitter_plain(rf, src, dst), ref,
                faults._session_delay_plain(rf, src, dst), ok_s, refused]

    equal, err = True, 0
    for plan in (fplan, overlap):
        rf = faults.round_faults(plan, LATENCY_T)
        got, want = calls(rf, True), calls(rf, False)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        for q, ref in ((faults.fault_edge_delay, faults._delay_plain),
                       (faults.fault_edge_jitter, faults._jitter_plain),
                       (faults.fault_session_delay,
                        faults._session_delay_plain)):
            e, x = _equal_all([q(rf, src, dst)], [ref(rf, src, dst)])
            equal, err = equal and e, max(err, x)
    delay, jit, sdelay = want[2], want[3], want[5]
    self_edge = src == dst
    _trap(5, "overlapping delays add, jitters take the max, the session "
          "the slower direction, self-edges never fault",
          int(delay.max()) == 3 and int(jit.max()) == 2
          and bool((sdelay > delay).any())
          and not bool(delay[self_edge].any() or jit[self_edge].any()
                       or sdelay[self_edge].any())
          and bool(self_edge.any()))
    rf = faults.round_faults(fplan, LATENCY_T)
    e = n * f
    nbytes = (e * 8  # the edge ids
              + _nbytes(rf.block_src, rf.block_dst, rf.loss_src, rf.loss_dst,
                        rf.delay_src, rf.delay_dst, rf.jitter_src,
                        rf.jitter_dst)
              + e * (2 + 1 + 4 + 4)  # ok in and out, thr, delay, jit
              + e * (2 + 1 + 4) + 8)  # ok, cut, session delay, the count
    return _row(
        "fault_edges_delay", "corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
        "corrosion_tpu/sim/faults.py:226", equal, err,
        _timed(timed, lambda: calls(rf, True)),
        _timed(timed, lambda: calls(rf, False)), nbytes,
        kernel="fault_edges_delay")


def compare_scatter_jitter(dev, g, n=STORM_N, timed=True):
    """K10's jitter stream at the latency storm's round 6 (E = 3N, W =
    16, D = 4): jitter alone (rounds 12-15: both loss streams off), with
    the fault plan's loss (rounds 2-11), and with the flat topology loss
    too; slots from K9's fault delay, so a jittered bit of a delayed
    edge wraps from slot 3 to 0."""
    from corrosion_tpu_torch.device import popcount
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import loss_threshold

    cfg, _, fplan = _latency_storm(n, dev)
    f, w, d = cfg.fanout, cfg.n_payloads // 32, cfg.n_delay_slots
    e = n * f
    rf = faults.round_faults(fplan, LATENCY_T)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.as_tensor(g.integers(0, n, e), dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
    ok, thr, fdelay, jit = faults.fault_wire_effects(rf, src, dst, ok)
    slot = ((LATENCY_T + fdelay) % d).to(torch.int32)
    sending = _random_words(g, (n, w), dev, 1)
    key, topo_key = trng.prng_key(7, dev), trng.prng_key(8, dev)
    seed = int(rf.seed)
    topo_thr = loss_threshold(0.3)
    ring0 = _random_words(g, (d, n, w), dev, 6)
    cases = {"jitter": (None, 0), "jitter_fault_loss": (thr, 0),
             "jitter_both_losses": (thr, topo_thr)}
    equal, err, outs = True, 0, {}
    for name, (t, tt) in cases.items():
        got, want = ring0.clone(), ring0.clone()
        args = (sending, dst, slot, ok, t, key, seed, f, tt, topo_key)
        packed.scatter_sending_lossy(got, *args, jit=jit)
        packed.scatter_sending_lossy_plain(want, *args, jit=jit)
        e_, x = _equal_all([got], [want])
        equal, err = equal and e_, max(err, x)
        outs[name] = want
    unjittered = ring0.clone()
    packed.scatter_sending_plain(unjittered, sending, dst, slot, ok, f)

    # the traps, from the plain version's own pieces
    span, mult = trng.scalar_span(0, packed.JITTER_MAX)
    jkey = faults.fault_key(key, seed, faults.JITTER_TAG)
    live = (jit > 0) & ok
    e_idx = torch.nonzero(live).flatten()[:4096]
    idx = (e_idx[:, None].long() * (32 * w)
           + torch.arange(32 * w, device=dev)).reshape(-1)
    sub = trng.split_plain(jkey, 2)
    zeros = torch.zeros_like(idx)
    h1, h2 = trng.threefry2x32(sub[0][0], sub[0][1], zeros, idx)
    l1, l2 = trng.threefry2x32(sub[1][0], sub[1][1], zeros, idx)
    right = trng.randint_at_plain(jkey, idx, 0, packed.JITTER_MAX).long()
    wrong = ((h1 ^ h2) % span * 2 + (l1 ^ l2) % span) % span
    _trap(1, "randint's multiplier (2^16)^2 wraps to 0 in u32: the higher "
          "draw drops out, where an exact 2 changes the draws",
          mult == 0 and bool((right != wrong).any())
          and torch.equal(right, (l1 ^ l2) % span))
    whole = trng.randint(jkey, (int(e_idx.max()) + 1, 32 * w), 0,
                         packed.JITTER_MAX)
    _trap(2, "the jitter draw's element index is e*P + q of the i32 draw, "
          "whatever the draw's length",
          torch.equal(whole.reshape(-1)[idx].long(), right))
    offsets = (right % 2).reshape(-1, w, 32)
    bits = ((sending.repeat_interleave(f, dim=0)[e_idx].long()[:, :, None]
             >> torch.arange(32, device=dev)) & 1).bool()
    split = ((offsets == 0) & bits).any(2) & ((offsets == 1) & bits).any(2)
    wraps = (slot[e_idx] == d - 1)[:, None] & ((offsets == 1) & bits).any(2)
    _trap(3, "bits of one word land in two slots, and slot 3 + 1 wraps to "
          "0 (three slots written from one destination row)",
          bool(split.any()) and bool(wraps.any()))
    _trap(6, "the jitter stream with both loss streams off (rounds 12-15) "
          "moves bits",
          not torch.equal(outs["jitter"], unjittered))
    if torch.equal(outs["jitter_fault_loss"], outs["jitter"]) or \
            torch.equal(outs["jitter_both_losses"],
                        outs["jitter_fault_loss"]):
        raise AssertionError("K10 jitter inputs: a loss stream drops nothing")

    # the bound of the path's case (jitter and the fault loss): a hash per
    # sent bit of a jittered edge that survives the loss, eight per sent
    # word of an edge under a threshold; the bytes of K10's rows
    words = packed._edge_words(sending, ok, f)
    loss_hashes = int(((words != 0) & (thr > 0)[:, None]).sum()) * 8
    packed._keep_stream_(words, thr, faults.fault_key(
        key, seed, faults.WIRE_LOSS_TAG))  # what the loss lets through
    jitter_hashes = int(popcount(words[jit > 0]).sum())
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    nbytes = (sending.numel() * 4 + e * (4 + 4 + 1 + 1 + 4)
              + 2 * rows_touched * w * 4 * 2)
    ops = (loss_hashes + jitter_hashes) * OPS_PER_HASH
    rate = _int32_ops_per_s()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    args = (sending, dst, slot, ok, thr, key, seed, f)
    return dict(
        name="broadcast_scatter_jitter",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/faults.py:285",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: packed.scatter_sending_lossy(
            ring_k, *args, jit=jit)),
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, *args, jit=jit), SLOW_PLAIN_REPS) if timed else None,
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes",
        ops=ops, hashes=loss_hashes + jitter_hashes, bytes=nbytes,
        kernel="broadcast_scatter_jitter",
    )


def compare_sync_delay(dev, g, n=STORM_N, timed=True):
    """K3's delay entry, and its metered entry with the same classes, at
    the latency storm's shapes (N = 100000, W = 16, S = 3, D = 4) with
    the session delays of its round 6 (K9's): two consecutive rounds on
    a ring whose slots already hold words — round t + 1's class-0 slot is
    round t's class-1 slot — against the plain class loop, with words
    that carry bit 31."""
    from corrosion_tpu_torch.sim import faults, packed

    cfg, meta, fplan = _latency_storm(n, dev)
    w, s, d = cfg.n_payloads // 32, cfg.sync_peers, cfg.n_delay_slots
    rf = faults.round_faults(fplan, LATENCY_T)
    masks = _random_words(g, (n, 4, w), dev)
    miss = _random_words(g, (n, w), dev, 2)
    peers = torch.as_tensor(g.integers(0, n, (n, s)), dtype=torch.int32,
                            device=dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(s)
    ok = torch.as_tensor(g.random(n * s) < 0.7, device=dev)
    _, sdelay = faults.fault_session_effects(rf, src, peers.reshape(-1), ok)
    ok = ok.reshape(n, s)
    ring0 = _random_words(g, (d, n, w), dev, 5)
    budget = 3 * 8 * 1024  # three 8 KiB payloads an edge: it binds
    equal, err = True, 0
    for b in (None, budget):
        got, want = ring0.clone(), ring0.clone()
        for r in range(2):
            slot = (LATENCY_T + 1 + r) % d
            args = (masks, miss, peers, ok)
            kw = dict(budget=b, nbytes=meta.nbytes, sdelay=sdelay, slot=slot)
            fr_k = packed.sync_pull(*args, got, **kw)
            fr_p = packed.sync_pull_plain(*args, want, **kw)
            e_, x = _equal_all([fr_k, got], [fr_p, want])
            equal, err = equal and e_, max(err, x)
        if b is None:
            classes_pulled = want
    if torch.equal(want, classes_pulled):
        raise AssertionError("K3 delay inputs: the sync budget never binds")
    grew = classes_pulled & ~ring0
    _trap(4, "a slot written by round t's class 1 is round t + 1's class 0: "
          "read-OR-write keeps both (and bit 31 words)",
          bool(((ring0 != 0) & (grew != 0))[(LATENCY_T + 2) % d].any())
          and bool((sdelay == 1).any()) and bool((sdelay == 0).any())
          and bool((grew < 0).any()))
    work = ring0.clone()

    def restore():
        work.copy_(ring0)

    slot = (LATENCY_T + 1) % d
    # the ring words the grants touch, class by class, in and out;
    # fruitful
    nbytes = (_pull_read_bytes(masks, miss, peers, ok)
              + _nbytes(peers, ok, sdelay) + 2 * 4 * _grant_words(
                  masks, miss, peers, ok, sdelay=sdelay, d_slots=d) + n)
    rows = [_row(
        "sync_pull_delay", "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        "corrosion_tpu/sim/packed.py:1256", equal, err,
        _timed(timed, lambda: packed.sync_pull(
            masks, miss, peers, ok, work, sdelay=sdelay, slot=slot), restore),
        _timed(timed, lambda: packed.sync_pull_plain(
            masks, miss, peers, ok, work, sdelay=sdelay, slot=slot), restore),
        nbytes, kernel="sync_pull_delay")]
    rows[0]["metered_ms"] = _timed(timed, lambda: packed.sync_pull(
        masks, miss, peers, ok, work, budget, meta.nbytes, sdelay=sdelay,
        slot=slot), restore)
    rows[0]["metered_bound_ms"] = _bound_ms(
        _pull_read_bytes(masks, miss, peers, ok, True)
        + _nbytes(peers, ok, sdelay, meta.nbytes) + 2 * 4
        * _grant_words(masks, miss, peers, ok, budget, meta.nbytes, sdelay,
                       d) + n)
    return rows


def compare_latency_kernels(dev, seed=4):
    """Phase 3e: K9's latency entry, K10's jitter stream and K3's delay
    entry (plain and metered) at the latency storm's shapes, every trap
    of the slice reached."""
    g = np.random.default_rng(seed)
    rows = [compare_fault_latency(dev, g), compare_scatter_jitter(dev, g),
            *compare_sync_delay(dev, g)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- the dense round's fault entries: K11's dense entry, K12's fault entry,
# K13's delay entry, K14's exit mode -------------------------------------------


def _dense_fault_storm(n, dev, plan_seed=0, **changes):
    """The fault storm on the dense round (JAX's ``allow_packed=False``):
    its config, payloads and compiled plan, factored (JAX's form at these
    node counts; path 15 forces the matrix one)."""
    from corrosion_tpu_torch.sim.runner import fault_storm

    return fault_storm(n, 512, plan_seed, dev, factored=True,
                       allow_packed=False, **changes)


def _full_view_storm(dev):
    """full-view-fault-storm-4096: JAX's 4096-node acceptance storm (plan
    seed 3) on full-view SWIM and the dense round."""
    return _dense_fault_storm(4096, dev, 3, swim_partial_view=False,
                              swim_full_view=True)


def _dense_latency_storm(n, dev):
    """latency-storm-n on the dense round."""
    cfg, meta, fplan = _latency_storm(n, dev)
    return dataclasses.replace(cfg, allow_packed=False), meta, fplan


def _dense_state(g, dev, cfg, t):
    """A mid-storm dense state at ``cfg``'s shapes from numpy: half the
    cells held, relay budgets on them, the payloads of rounds <= t
    injected, sparse rings, 3% dead nodes, random member tables or full
    view beliefs, gap rows."""
    from corrosion_tpu_torch.sim.state import init_state

    n, p, d = cfg.n_nodes, cfg.n_payloads, cfg.n_delay_slots
    a, k, m = cfg.n_writers, cfg.gap_slots, cfg.member_slots
    state = init_state(cfg, torch.tensor([0, 9], dtype=torch.int64,
                                         device=dev))
    have = _u8(g, (n, p), 0.5, dev)
    v = cfg.n_versions

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    rep = dict(
        have=have,
        relay_left=torch.as_tensor(g.integers(0, 4, (n, p)),
                                   dtype=torch.uint8, device=dev) * have,
        injected=_u8(g, (p,), 0.9, dev),
        inflight=_u8(g, (d, n, p), 0.05, dev),
        sync_inflight=_u8(g, (d, n, p), 0.02, dev),
        alive=torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                              device=dev),
        heads=i32(g.integers(0, v + 1, (n, a))),
        gap_lo=i32(g.integers(0, v + 1, (n, a, k))),
        gap_hi=i32(g.integers(0, v + 1, (n, a, k))),
    )
    if cfg.swim_partial_view:
        pid, pkey, psince = _random_tables(g, n, m, t)
        rep.update(pid=i32(pid), pkey=i32(pkey), psince=i32(psince))
    if cfg.swim_full_view:
        rep.update(
            view=torch.as_tensor(g.integers(0, 3, (n, n)), dtype=torch.int8,
                                 device=dev),
            vinc=i32(g.integers(0, 5, (n, n))),
            suspect_since=i32(np.where(g.random((n, n)) < 0.3,
                                       g.integers(0, t + 1, (n, n)), -1)))
    return state._replace(t=torch.tensor(t, dtype=torch.int32), **rep)


def _clone_state(state):
    return state._replace(**{f: x.clone() for f, x in zip(state._fields,
                                                          state)})


def compare_node_faults_dense(dev, g, n=STORM_N, timed=True):
    """K11's dense entry on the dense fault storm's state (N = 100000,
    P = 512, D = 2, M = 64) at round 20 (node 1's restart: an override
    and a wiped row, after the storm converged on it) and round 8 (its
    crash: an override only), and on the full-view storm's (N = 4096,
    view [N, N] i8) at its round 20: every field of the state."""
    from corrosion_tpu_torch.sim import faults

    equal, err = True, 0
    cases = []
    for label, (cfg, _, fplan) in (
            ("partial", _dense_fault_storm(n, dev)),
            ("full", _full_view_storm(dev))):
        state = _dense_state(g, dev, cfg, 20)
        for r in (20, 8):
            rf = faults.round_faults(fplan, r)
            got = faults.apply_node_faults(_clone_state(state), rf)
            want = faults.apply_node_faults_plain(_clone_state(state), rf)
            e, x = _equal_all([x for x in got if x.numel()],
                              [x for x in want if x.numel()])
            equal, err = equal and e, max(err, x)
            if r == 20:
                wiped = int(np.flatnonzero(rf.wipe.cpu().numpy())[0])
                if torch.equal(got.have[wiped], state.have[wiped]) or (
                        label == "full" and torch.equal(
                            got.view[wiped], state.view[wiped])):
                    raise AssertionError(f"K11 dense inputs ({label}) wipe "
                                         "no row")
                cases.append((state, rf))
    state, rf = cases[0]
    work = _clone_state(state)
    wiped = torch.nonzero(rf.wipe).flatten()

    def restore():
        # what K11 writes: alive, and the wiped node's rows (its ring rows
        # on dim 1); a copy of the whole state would drown its time
        work.alive.copy_(state.alive)
        for name in ("have", "relay_left", "heads", "gap_lo", "gap_hi",
                     "pid", "pkey", "psince"):
            getattr(work, name)[wiped] = getattr(state, name)[wiped]
        for name in ("inflight", "sync_inflight"):
            getattr(work, name)[:, wiped] = getattr(state, name)[:, wiped]

    cfg = _dense_fault_storm(n, dev)[0]
    p, d, a = cfg.n_payloads, cfg.n_delay_slots, cfg.n_writers
    row = p * (2 + 2 * d) + (a + 2 * a * cfg.gap_slots
                             + 3 * cfg.member_slots) * 4
    return _row(
        "node_faults_dense", "corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        "corrosion_tpu/sim/faults.py:703", equal, err,
        _timed(timed, lambda: faults.apply_node_faults(work, rf), restore),
        _timed(timed, lambda: faults.apply_node_faults_plain(work, rf),
               restore),
        # the override, the wipe mask and alive in and out; the wiped row
        n * 4 + int(rf.wipe.sum()) * row, kernel="node_faults_dense")


def _wire_case(g, dev, cfg, meta, fplan, t, topo_loss=0.0):
    """One round's broadcast inputs on a mid-storm dense state: random
    targets (self and -1 among them), the edges, K9's cuts, fault
    thresholds, fault delay and jitter bounds, the slots."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import edge_alive, loss_threshold

    n, f = cfg.n_nodes, cfg.fanout
    state = _dense_state(g, dev, cfg, t)
    me = np.arange(n)[:, None]
    tg = np.where(g.random((n, f)) < 0.03, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                              dtype=torch.int32, device=dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = targets.reshape(-1)
    ok = dst >= 0
    dst = torch.clamp(dst, min=0)
    ok &= edge_alive(state.group, state.alive, src, dst) & (dst != src)
    rf = faults.round_faults(fplan, t)
    ok, fthr, fdelay, jit = faults.fault_wire_effects(rf, src, dst, ok)
    delay = torch.zeros_like(src) if fdelay is None else fdelay
    slot = ((t + delay) % cfg.n_delay_slots).to(torch.int32)
    key = trng.prng_key(100 + t, dev)
    ks = trng.split(key, 3)
    return SimpleNamespace(
        state=state, targets=targets, src=src, dst=dst, ok=ok, fthr=fthr,
        jit=jit, slot=slot, key=key, k_drop=ks[1], seed=int(rf.seed),
        thr=loss_threshold(topo_loss) if topo_loss > 0 else 0, meta=meta,
        cfg=cfg)


def _wire_send(c, kernel, dropped=None, frames=None, ring=None, relay=None):
    """K12's fault entry (or its plain version) on case ``c``, in place on
    ``ring`` and ``relay`` (the case's own when not given)."""
    from corrosion_tpu_torch.sim import broadcast as bc

    send = bc.broadcast_send if kernel else bc.broadcast_send_plain
    s = c.state
    row_frames = row_bytes = None
    if frames is not None:
        row_frames, row_bytes = frames
    send(s.have, s.relay_left if relay is None else relay, s.injected,
         c.meta.nbytes, c.cfg.rate_limit_bytes_round, c.targets, c.dst,
         c.slot, c.ok, s.alive, c.k_drop, c.thr,
         s.inflight if ring is None else ring, row_frames, row_bytes,
         dropped, c.key, c.fthr, c.jit, c.seed)


def compare_broadcast_fault(dev, g, n=STORM_N, timed=True):
    """K12's fault entry at the dense storms' shapes (N = 100000, P = 512,
    F = 3): the dense fault storm's round 5 (the fault loss on every
    edge, the half split's cuts; D = 2), the dense latency storm's round
    6 (with the fault delay and jitter bounds 0 and 1; D = 4), and a trap
    case at D = 8 with the flat topology loss (both loss streams on one
    cell) and jitter bounds 0, 1 and 4 — each against the plain version
    with the dropped count and the per-node frames and bytes, printing
    the slice's traps as reached."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim.topology import aligned_u8_bits

    cfg, meta, fplan = _dense_fault_storm(n, dev)
    lcfg, lmeta, lplan = _dense_latency_storm(n, dev)
    wide = dataclasses.replace(lcfg, n_delay_slots=8)
    plan = latency_storm_plan(n)
    trap_plan = faults.compile_plan(FaultPlan(
        n_nodes=n, seed=plan.seed, events=(
            *plan.events,
            FaultEvent("jitter", 2, 16, src=f"{n // 2}:{n}", dst="*",
                       delay_rounds=4))), wide, device=dev)
    cases = {
        "path": _wire_case(g, dev, cfg, meta, fplan, DENSE_FAULT_T),
        "latency": _wire_case(g, dev, lcfg, lmeta, lplan, LATENCY_T),
        "trap": _wire_case(g, dev, wide, lmeta, trap_plan, LATENCY_T, 0.3),
    }
    equal, err = True, 0
    for c in cases.values():
        outs = []
        for kernel in (True, False):
            ring, relay = c.state.inflight.clone(), c.state.relay_left.clone()
            dropped = torch.zeros((), dtype=torch.int64, device=dev)
            frames = (torch.empty(n, dtype=torch.int32, device=dev),
                      torch.empty(n, dtype=torch.int32, device=dev))
            _wire_send(c, kernel, dropped, frames, ring, relay)
            outs.append([ring, relay, dropped, *frames])
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)

    # the traps, from the plain version's own pieces
    c = cases["trap"]
    jit_values = set(torch.unique(c.jit[c.ok]).tolist())
    _trap("dense 1", "jitter bounds 0, 1 and 4 on one ring",
          {0, 1, 4} <= jit_values)
    span, mult = trng.scalar_span(0, (1 << 31) - 1)
    jkey = faults.fault_key(c.key, c.seed, faults.JITTER_TAG)
    e_idx = torch.nonzero(c.jit > 0).flatten()[:2048]
    idx = (e_idx[:, None].long() * cfg.n_payloads
           + torch.arange(cfg.n_payloads, device=dev)).reshape(-1)
    sub = trng.split_plain(jkey, 2)
    zeros = torch.zeros_like(idx)
    h1, h2 = trng.threefry2x32(sub[0][0], sub[0][1], zeros, idx)
    l1, l2 = trng.threefry2x32(sub[1][0], sub[1][1], zeros, idx)
    right = trng.randint_at_plain(jkey, idx, 0, (1 << 31) - 1).long()
    wrong = ((h1 ^ h2) % span * 2 + (l1 ^ l2) % span) % span
    _trap("dense 2", "randint's multiplier wraps to 0 (an exact 2 changes "
          "the jitter draws)",
          mult == 0 and bool((right != wrong).any())
          and torch.equal(right, (l1 ^ l2) % span))
    e = n * cfg.fanout
    p = cfg.n_payloads
    sending = ((c.state.have > 0) & (c.state.relay_left > 0)
               & (c.state.injected > 0)[None, :]).repeat_interleave(
                   cfg.fanout, dim=0) & c.ok[:, None]
    topo_drop = aligned_u8_bits(c.k_drop, (e, p)) < c.thr
    fault_drop = aligned_u8_bits(faults.fault_key(
        c.key, c.seed, faults.WIRE_LOSS_TAG), (e, p)) < c.fthr[:, None]
    _trap("dense 3", "both loss streams drop one cell (and each alone)",
          bool((sending & topo_drop & fault_drop).any())
          and bool((sending & topo_drop & ~fault_drop).any())
          and bool((sending & ~topo_drop & fault_drop).any()))
    del sending, topo_drop, fault_drop

    c = cases["path"]
    base = [c.state.inflight, c.state.relay_left]
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    # the bound of the path's case: the hashes of the draw words its ok
    # (edge, sending payload) cells under a fault threshold need, or the
    # bytes it must move, whichever is larger
    sending = ((c.state.have > 0) & (c.state.relay_left > 0)
               & (c.state.injected > 0)[None, :]).repeat_interleave(
                   cfg.fanout, dim=0) & c.ok[:, None] & (c.fthr > 0)[:, None]
    hashes = int(sending.reshape(e, p // 4, 4).any(dim=2).sum())
    del sending
    after = [x.clone() for x in base]
    _wire_send(c, True, ring=after[0], relay=after[1])
    nbytes = (_nbytes(c.state.have, c.state.relay_left, c.state.injected,
                      meta.nbytes, c.targets, c.dst, c.slot, c.ok,
                      c.state.alive, c.fthr)
              + _changed_bytes(base, after))
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    bound = max(_bound_ms(nbytes), ops / rate * 1e3)
    return dict(
        name="dense_broadcast_fault",
        source="corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
        replaces="corrosion_tpu/sim/broadcast.py:124",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: _wire_send(c, True, ring=work[0],
                                            relay=work[1]), restore),
        plain_ms=_timed(timed, lambda: _wire_send(
            c, False, ring=work[0], relay=work[1]), restore),
        bound_ms=bound,
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes",
        ops=ops, hashes=hashes, bytes=nbytes, kernel="dense_broadcast_fault")


def _session_delay_plan(n):
    """A delay of one round on every link out of the first sixth and one
    on every link into the first half, rounds 2-15: a session between the
    two takes 2 = D - 2 rounds at D = 4."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan

    return FaultPlan(n_nodes=n, seed=0, events=(
        FaultEvent("delay", 2, 16, src=f"0:{n // 6}", dst="*",
                   delay_rounds=1),
        FaultEvent("delay", 2, 16, src="*", dst=f"0:{n // 2}",
                   delay_rounds=1)))


def compare_sync_delay_dense(dev, g, n=STORM_N, timed=True):
    """K13's delay entry at the dense latency storm's shapes (N = 100000,
    P = 512, S = 3, D = 4) with session delays 0, 1 and 2 = D - 2 (K9's,
    on a plan whose two delays add), on a ring whose slots already hold
    grants, unmetered (the path) and under a sync budget that binds:
    the ring, the fruitful flags and the grant counts."""
    from corrosion_tpu_torch.sim import faults, sync

    cfg, meta, _ = _dense_latency_storm(n, dev)
    s, d = cfg.sync_peers, cfg.n_delay_slots
    fplan = faults.compile_plan(_session_delay_plan(n), cfg, device=dev)
    state = _dense_state(g, dev, cfg, LATENCY_T)
    heads, lo, hi, _ = _advertised(g, dev, cfg, state.have, LATENCY_T)
    peers = torch.as_tensor(g.integers(0, n, (n, s)), dtype=torch.int32,
                            device=dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(s)
    ok = torch.as_tensor(g.random((n, s)) < 0.7, device=dev)
    rf = faults.round_faults(fplan, LATENCY_T)
    sdelay = faults.fault_session_delay(rf, src, peers.reshape(-1))
    slot = (LATENCY_T + 1) % d
    ring0 = state.sync_inflight
    args = (state.have, heads, lo, hi, peers, ok, meta.nbytes)
    equal, err, rings = True, 0, {}
    for budget in (None, 3 * 8 * 1024):
        outs = []
        for fn in (sync.sync_pull_dense, sync.sync_pull_dense_plain):
            ring = ring0.clone()
            counts = torch.zeros(cfg.n_payloads, dtype=torch.int32,
                                 device=dev)
            fr = fn(*args, budget, ring, cfg, counts, sdelay, slot)
            outs.append([fr, ring, counts])
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        rings[budget] = outs[1][1]
    if torch.equal(rings[None], rings[3 * 8 * 1024]):
        raise AssertionError("K13 delay inputs: the sync budget never binds")
    grew = (rings[None] != 0) & (ring0 == 0)
    far = (slot + d - 2) % d
    _trap("dense 4", "a session delay of D - 2 lands in slot t + 1 + D - 2, "
          "a slot that already holds grants",
          int(sdelay.max()) == d - 2 and bool(grew[far].any())
          and bool((ring0[far] != 0).any()))
    work = ring0.clone()

    def restore():
        work.copy_(ring0)

    nbytes = (_nbytes(state.have, heads, lo, hi, peers, ok, meta.nbytes,
                      sdelay)
              + int(grew.sum()) + n)  # the grants stored, fruitful
    return _row(
        "dense_sync_delay", "corrosion_tpu_torch/kernels/csrc/dense_sync.cu",
        "corrosion_tpu/sim/sync.py:165", equal, err,
        _timed(timed, lambda: sync.sync_pull_dense(
            *args, None, work, cfg, None, sdelay, slot), restore),
        _timed(timed, lambda: sync.sync_pull_dense_plain(
            *args, None, work, cfg, None, sdelay, slot), restore),
        nbytes, kernel="dense_sync_delay")


def compare_dense_gaps_exit(dev, g, n=STORM_N, timed=True):
    """K14's exit mode at the dense storm's shapes (N = 100000, P = 512,
    A = 16, V = 8, C = 4, K = 8) after every payload was injected: every
    up node holding everything but one wiped after its sticky stamp (the
    plain mode would exit; the fault loop must not), before and after
    the plan's horizon, and with the wiped row healed — both values of
    the flag."""
    from corrosion_tpu_torch.sim.round import (
        RunMetrics, dense_record, dense_record_plain)

    cfg, meta, _ = _dense_fault_storm(n, dev)
    p = cfg.n_payloads
    t = int(meta.round.max()) + 2
    alive = torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                            device=dev)
    up = np.flatnonzero(alive.cpu().numpy() == 0)
    have = torch.ones((n, p), dtype=torch.uint8, device=dev)
    have[int(up[1])] = 0  # wiped after it converged
    metrics = RunMetrics(
        coverage_at=torch.full((p,), 2, dtype=torch.int32, device=dev),
        converged_at=torch.full((n,), 4, dtype=torch.int32, device=dev),
        overflow_frac=torch.zeros((), device=dev),
        order_violations=torch.zeros((), dtype=torch.int32, device=dev))
    inj = torch.ones(p, dtype=torch.uint8, device=dev)
    healed = torch.ones_like(have)
    cases = [(have, t - 1), (have, t + 5), (healed, t - 1), (healed, t + 5)]
    equal, err, dones = True, 0, []
    for h, horizon in cases:
        args = (h, inj, alive, metrics, meta, t, cfg)
        got = dense_record(*args, horizon=horizon)
        want = dense_record_plain(*args, horizon=horizon)
        e, x = _equal_all(list(got), list(want))
        equal, err = equal and e, max(err, x)
        dones.append(bool(want[6]))
    sticky = dense_record_plain(have, inj, alive, metrics, meta, t, cfg)
    _trap("dense 5", "a wipe after convergence: the sticky stamps would "
          "exit, the fresh exit mode does not (and does once healed, past "
          "the horizon only)",
          bool(sticky[6]) and dones == [False, False, True, False])
    args = (have, inj, alive, metrics, meta, t, cfg)
    a, k = cfg.n_writers, cfg.gap_slots
    nbytes = (n * p + p + n + p * 4 + n * 4 * 2 + p * 4 * 2
              + n * a * 4 * (1 + 2 * k) + 4 + 1)
    return _row(
        "dense_gaps_exit", "corrosion_tpu_torch/kernels/csrc/dense_gaps.cu",
        "corrosion_tpu/sim/faults.py:748", equal, err,
        _timed(timed, lambda: dense_record(*args, horizon=t - 1)),
        _timed(timed, lambda: dense_record_plain(*args, horizon=t - 1)),
        nbytes, kernel="dense_gaps_exit")


def compare_dense_fault_kernels(dev, seed=5):
    """Phase 3f: K11's dense entry, K12's fault entry, K13's delay entry
    and K14's exit mode at the dense storms' shapes, every trap of the
    slice reached."""
    g = np.random.default_rng(seed)
    rows = [compare_node_faults_dense(dev, g), compare_broadcast_fault(dev, g),
            compare_sync_delay_dense(dev, g), compare_dense_gaps_exit(dev, g)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- K9's matrix entry (K9m): the matrix plans' per-edge queries -----------------

#: fault-storm-1000: JAX's matrix plan at the largest node count its
#: `compile_plan` leaves in the matrix form by default
MATRIX_N = 1000
#: the round the matrix comparisons and profile slice: inside the loss
#: and half-split windows (rounds 0-11 and 4-15)
MATRIX_T = 5


def matrix_trap_plan(n, seed=0):
    """A matrix plan reaching K9m's traps at n nodes: the storm's loss
    burst, losses of 0.99 out of and 0.995 into the first eighth that
    fold with it past 255.5/256 (a cut where they meet: 1 - 0.85 · 0.01
    · 0.005), a one-way cut from the first half to the second (sessions
    refused from both ends), the latency pair out of the first sixth and
    a wiped node (four delay slots)."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan

    half, eighth, sixth = n // 2, f"0:{n // 8}", f"0:{n // 6}"
    return FaultPlan(n_nodes=n, seed=seed, events=(
        FaultEvent("loss", 0, 12, p=0.15),
        FaultEvent("loss", 3, 9, src=eighth, dst="*", p=0.99),
        FaultEvent("loss", 3, 9, src="*", dst=eighth, p=0.995),
        FaultEvent("partition", 4, 16, src=f"0:{half}", dst=f"{half}:{n}"),
        FaultEvent("delay", 2, 10, src=sixth, dst="*", delay_rounds=1),
        FaultEvent("jitter", 2, 10, src=sixth, dst="*", delay_rounds=1),
        FaultEvent("crash", 8, 20, node=1, wipe=True),
    ))


def _matrix_storm(n, dev, **changes):
    """The fault storm at n nodes on its matrix plan (JAX's default below
    1024 nodes, forced above): config, payloads, plan and the host
    seconds of the matrix lowering."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.runner import storm_fault_plan

    plan_seed = changes.pop("plan_seed", 0)
    cfg, meta = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, **changes)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fplan = faults.compile_plan(storm_fault_plan(n, plan_seed), cfg,
                                factored=False, device=dev)
    torch.cuda.synchronize()
    return cfg, meta, fplan, time.monotonic() - t0


def _matrix_edge_lists(g, n, f, dev):
    """E = n·f edges out of every node, one in 20 a self-edge, and an ok
    mask with one in ten cleared."""
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = np.where(g.random(n * f) < 0.05, np.repeat(np.arange(n), f),
                   g.integers(0, n, n * f))
    dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    return src, dst, torch.as_tensor(g.random(n * f) < 0.9, device=dev)


def _matrix_calls(rf, src, dst, ok0, kernel):
    """The wire's call (cuts clearing ok, thresholds, delay, jitter), the
    session's (refusals both ways, counted, and the session delay), and
    the four queries alone: K9m's launches, or their plain gathers."""
    from corrosion_tpu_torch.sim import faults

    dev = src.device
    ok_w, ok_s, cut, refused = ok0.clone(), ok0.clone(), _acc(dev), _acc(dev)
    if kernel:
        wire = faults.fault_wire_effects(rf, src, dst, ok_w, cut)
        session = faults.fault_session_effects(rf, src, dst, ok_s, refused)
        alone = [q(rf, src, dst) for q in (
            faults.fault_edge_block, faults.fault_edge_loss,
            faults.fault_edge_delay, faults.fault_edge_jitter)]
        return [x for x in (*wire, *session, ok_s, cut, refused, *alone)
                if x is not None]
    has = {c: getattr(rf, c) is not None
           for c in ("block", "loss", "delay", "jitter")}
    blk = faults._block_plain(rf, src, dst) if has["block"] else None
    if blk is not None:
        cut += (ok_w & blk).sum()
        ok_w &= ~blk
    ref = None
    if blk is not None:
        ref = blk | faults._block_plain(rf, dst, src)
        refused += (ok_s & ref).sum()
        ok_s &= ~ref
    thr = faults._loss_plain(rf, src, dst) if has["loss"] else None
    delay = faults._delay_plain(rf, src, dst) if has["delay"] else None
    jit = faults._jitter_plain(rf, src, dst) if has["jitter"] else None
    sdelay = (faults._session_delay_plain(rf, src, dst) if has["delay"]
              else None)
    return [x for x in (ok_w, thr, delay, jit, ref, sdelay, ok_s, cut,
                        refused, blk, thr, delay, jit) if x is not None]


def _matrix_reach(rf, src, dst, ok0, key, kernel):
    from corrosion_tpu_torch.sim import faults

    ok = ok0.clone()
    if kernel:
        return faults.fault_reach_(ok, rf, key, src, dst)
    return faults.fault_reach_plain(ok, rf, key, src, dst)


def _matrix_case(dev, g, fplan, t, f, label, timed):
    """K9m's two entries on round t of ``fplan`` at E = N·f, against their
    plain versions on the same card tensors: the equality, the largest
    gap, both rows' times and bytes, and the plain outputs for the
    traps."""
    from corrosion_tpu_torch.sim import faults

    rf = faults.round_faults(fplan, t)
    n = rf.alive.shape[0]
    src, dst, ok0 = _matrix_edge_lists(g, n, f, dev)
    key = torch.as_tensor(g.integers(0, 2**32, 2), dtype=torch.int64,
                          device=dev)
    got = _matrix_calls(rf, src, dst, ok0, True)
    want = _matrix_calls(rf, src, dst, ok0, False)
    equal, err = _equal_all(got, want)
    r_got = _matrix_reach(rf, src, dst, ok0, key, True)
    r_want = _matrix_reach(rf, src, dst, ok0, key, False)
    r_equal, r_err = _equal_all([r_got], [r_want])
    e = n * f
    classes = sum(x is not None for x in (rf.block, rf.loss, rf.delay,
                                          rf.jitter))
    latency = (rf.delay is not None) + (rf.jitter is not None)
    # ids, then one cell of each class the wire reads, two block and two
    # delay cells for the session, the alone queries' cells again; ok in
    # and out twice, the outputs (u8 cut and thr, i32 latency), two counts
    edge_bytes = (e * 8 + e * (2 * classes + 2 + 2 * (rf.delay is not None))
                  + e * 4 + e * (1 + 1) * 2 + e * 4 * (2 * latency) + 16)
    reach_bytes = e * 8 + e * 2 + e * 2 + 16
    extra = dict(shape=label, e=e, n=n, t=t, classes=classes)
    rows = [
        _row("fault_edges_matrix" + label,
             "corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
             "corrosion_tpu/sim/faults.py:195", equal, err,
             _timed(timed, lambda: _matrix_calls(rf, src, dst, ok0, True)),
             _timed(timed, lambda: _matrix_calls(rf, src, dst, ok0, False)),
             edge_bytes, kernel="fault_edges_matrix", **extra),
        _row("fault_reach_matrix" + label,
             "corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
             "corrosion_tpu/sim/swim.py:161", r_equal, r_err,
             _timed(timed, lambda: _matrix_reach(rf, src, dst, ok0, key,
                                                 True)),
             _timed(timed, lambda: _matrix_reach(rf, src, dst, ok0, key,
                                                 False)),
             reach_bytes, kernel="fault_reach_matrix", **extra),
    ]
    return rows, rf, src, dst, want


def compare_matrix_fault_kernels(dev, seed=6, n=MATRIX_N, big=4096,
                                 timed=True):
    """Phase 3g: K9m's edge and reach entries against their plain
    versions at fault-storm-1000's shapes (N = 1000, not a multiple of
    32; its matrix plan, cut and loss, round 5, E = 3N), on the trap
    plan at the same shapes, past the horizon (the clamp row), and at
    the forced-matrix full-view storm's (N = 4096, E = 3N, 740 MB of
    slabs), every trap reached.  Returns the timed rows of the path's
    shapes and of the 4096 shapes."""
    from corrosion_tpu_torch.sim import faults

    g = np.random.default_rng(seed)
    _, _, storm, _ = _matrix_storm(n, dev)
    rows, rf, src, dst, _ = _matrix_case(dev, g, storm, MATRIX_T, 3, "",
                                         timed)
    _trap("matrix 1", "absent classes ride null slabs (no delay, no jitter)",
          rf.delay is None and rf.jitter is None and rf.block is not None
          and rf.loss is not None)
    trap_cfg = dataclasses.replace(_storm_cfg(n, dev)[0], n_delay_slots=4)
    traps = faults.compile_plan(matrix_trap_plan(n), trap_cfg,
                                factored=False, device=dev)
    case, rf, src, dst, want = _matrix_case(dev, g, traps, MATRIX_T, 3,
                                            "_traps", False)
    blk = faults._block_plain(rf, src, dst)
    self_edge = src == dst
    eighth = n // 8
    _trap("matrix 2", "(x, x) legs never fault",
          bool(self_edge.any()) and not bool(blk[self_edge].any())
          and not bool(faults._loss_plain(rf, src, dst)[self_edge].any()))
    folded = (src < eighth) & (dst < eighth) & ~self_edge
    _trap("matrix 3", "a loss that compiled to a cut",
          bool(folded.any()) and bool(blk[folded].all())
          and not bool(faults._loss_plain(rf, src, dst)[folded].any()))
    half = n // 2
    back = (src >= half) & (dst < half)
    refused = blk | faults._block_plain(rf, dst, src)
    _trap("matrix 4", "an asymmetric cut read in both directions",
          bool(back.any()) and not bool(blk[back].any())
          and bool(refused[back].all())
          and bool((faults._session_delay_plain(rf, src, dst)
                    > faults._delay_plain(rf, src, dst)).any()))
    clamp, rf, _, _, want = _matrix_case(dev, g, storm, 99, 3, "_clamp",
                                         False)
    _trap("matrix 5", "a round past the horizon reads the clear row",
          rf.block.data_ptr() == storm.block[storm.horizon].data_ptr()
          and not bool(rf.block.any()) and not bool(rf.loss.any()))
    _trap("matrix 6", f"N = {n} is not a multiple of 32", n % 32 != 0)
    del storm, traps
    _, _, wide, _ = _matrix_storm(big, dev, plan_seed=3,
                                  swim_partial_view=False,
                                  swim_full_view=True, allow_packed=False)
    wide_rows, _, _, _, _ = _matrix_case(dev, g, wide, MATRIX_T, 3, "_4096",
                                         timed)
    del wide
    for row in rows + case + clamp + wide_rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows + wide_rows


def profile_matrix_fault(dev, start=MATRIX_T, rounds=3):
    """Rounds ``start`` to ``start + rounds - 1`` of fault-storm-1000 on
    its matrix plan through the dense fault loop's body (node faults,
    the round with its slice, the one host read of the flag); the rounds
    before are setup."""
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim, round_step_
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta, fplan, _ = _matrix_storm(MATRIX_N, dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    horizon = fplan.horizon

    def step(loop):
        state, metrics = loop
        t = int(state.t)
        rf = faults.round_faults(fplan, t)
        state = faults.apply_node_faults(state, rf)
        state, metrics, done = round_step_(
            state, metrics, meta, cfg, topo, region, None, rf, horizon,
            activity[min(t, horizon)])
        bool(done)
        return state, metrics

    def setup():
        loop = (faults._own_fault_state(new_sim(cfg, 0, dev)),
                new_metrics(cfg, dev))
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"fault-storm-1000 (matrix) rounds {start}-"
                    f"{start + rounds - 1}", setup)


# -- the topology axis: K20, K21, K1's view entry, K10's and K12's tiered ----
# -- instantiations ------------------------------------------------------------

#: the PeerSwap storm's node count (JAX's protocol-frontier sampler cell)
PEERSWAP_N = 25_600


def _topo(family=None, **kw):
    from corrosion_tpu_torch.sim.runner import _resolve_topo

    topo = _resolve_topo(family)
    return dataclasses.replace(topo, **kw) if kw else topo


#: a synthetic topology whose cross-region tier is at certainty (p·256 =
#: 256): the one that reaches JAX's raw >= 256 pin (no family does)
def _pin_topo():
    from corrosion_tpu_torch.sim.topology import Topology

    return Topology(n_regions=2, inter_loss=1.0)


def _boundary_ids(n, topo):
    """The node ids on each side of every region and AZ block edge, and
    the last id (the last region's remainder)."""
    per = max(1, n // topo.n_regions)
    per_az = max(1, per // topo.n_azs)
    ids = {0, n - 1}
    for r in range(topo.n_regions):
        for a in range(topo.n_azs + 1):
            edge = r * per + a * per_az
            ids.update(x for x in (edge - 1, edge) if 0 <= x < n)
    return sorted(ids)


def _edge_list(g, n, e, dev, boundary):
    """E random (src, dst) pairs, every pair of ``boundary`` ids among
    them, one in 20 a self-edge."""
    b = np.asarray(boundary)
    pairs = np.stack(np.meshgrid(b, b), -1).reshape(-1, 2)
    src = g.integers(0, n, e)
    dst = np.where(g.random(e) < 0.05, src, g.integers(0, n, e))
    src[:len(pairs)], dst[:len(pairs)] = pairs[:, 0], pairs[:, 1]
    return (torch.as_tensor(src, dtype=torch.int32, device=dev),
            torch.as_tensor(dst, dtype=torch.int32, device=dev))


def compare_edge_slots(dev, g, n=STORM_N, timed=True):
    """K20's edge entry at the storms' shapes (E = 300000): wan-3x2 (AZ
    delays 0/1/2, D = 3) and wan-fly-6r (the measured matrix, D = 6),
    each at a round and with a fault plan's fixed delay added."""
    from corrosion_tpu_torch.sim import topology as tp

    rows = []
    for family, d in (("wan-3x2", 3), ("wan-fly-6r", 6)):
        topo = _topo(family)
        region = tp.regions(n, topo.n_regions, dev)
        src, dst = _edge_list(g, n, 3 * n, dev, _boundary_ids(n, topo))
        fdelay = torch.as_tensor(g.integers(0, 2, 3 * n), dtype=torch.int32,
                                 device=dev)
        t = 7
        got = [tp.edge_slot(topo, region, src, dst, t, d, fd)
               for fd in (None, fdelay)]
        want = [tp.edge_slot_plain(topo, region, src, dst, t, d, fd)
                for fd in (None, fdelay)]
        equal, err = _equal_all(got, want)
        delays = set(tp.edge_delay(topo, region, src, dst).unique().tolist())
        if family == "wan-fly-6r":
            _trap("topo 1", "wan-fly-6r's matrix delays 0-5 into a ring of "
                  "D = 6", delays == set(range(6)))
        else:
            az = tp.azs(n, topo, dev)
            per = n // 3
            _trap("topo 2", f"the last region's remainder: its local AZ "
                  f"clamps (node {n - 1} in AZ 5)",
                  int(az[n - 1]) == 5 and (n - 1 - 2 * per) // (per // 2) >= 2
                  and delays == {0, 1, 2})
        e = 3 * n
        rows.append(_row(
            f"edge_slots_{family}",
            "corrosion_tpu_torch/kernels/csrc/edge_classes.cu",
            "corrosion_tpu/sim/topology.py:157", equal, err,
            _timed(timed, lambda: tp.edge_slot(topo, region, src, dst, t, d)),
            _timed(timed, lambda: tp.edge_slot_plain(topo, region, src, dst,
                                                     t, d)),
            e * 12, kernel="edge_slots", e=e, d=d))
    return rows


def compare_degree_caps(dev, g, n=STORM_N, timed=True):
    """K20's caps entry at the hetero-degree storm's targets [100000, 3]
    (caps 3, 2, 1 round-robin), -1 slots among them."""
    from corrosion_tpu_torch.sim import topology as tp

    topo = _topo("hetero-degree")
    tg = np.where(g.random((n, 3)) < 0.05, -1, g.integers(0, n, (n, 3)))
    targets = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    got = tp.apply_degree_caps(targets.clone(), topo)
    want = tp.apply_degree_caps_plain(targets, topo)
    equal, err = _equal_all([got], [want])
    masked = (want == -1) & (targets != -1)
    caps = tp.node_degrees(n, topo, dev)
    _trap("topo 3", "caps 1, 2 and 3 each present, 1 and 2 masking slots",
          set(caps.unique().tolist()) == {1, 2, 3}
          and bool(masked[caps == 1].any()) and bool(masked[caps == 2].any())
          and not bool(masked[caps == 3].any()))
    work = targets.clone()
    return _row(
        "degree_caps", "corrosion_tpu_torch/kernels/csrc/edge_classes.cu",
        "corrosion_tpu/sim/topology.py:142", equal, err,
        _timed(timed, lambda: tp.apply_degree_caps(work, topo),
               lambda: work.copy_(targets)),
        _timed(timed, lambda: tp.apply_degree_caps_plain(targets, topo)),
        targets.numel() * 4 + _changed_bytes([targets], [want]),
        kernel="degree_caps")


def compare_edge_reach(dev, g, n=STORM_N, timed=True):
    """K20's reach entry: wan-3x2's tiers at E = N = 100000 (a probe
    leg: 100000 bytes pad to 100096 in JAX's draw) and at E = 300000 (a
    gossip or relay leg), and the pin topology's certainty tier."""
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim import topology as tp

    rows = []
    key = trng.prng_key(21, dev)
    for label, topo, e in (("", _topo("wan-3x2"), n),
                           ("_e300k", _topo("wan-3x2"), 3 * n),
                           ("_pin", _pin_topo(), n)):
        src, dst = _edge_list(g, n, e, dev, _boundary_ids(n, topo))
        ok0 = torch.as_tensor(g.random(e) < 0.9, device=dev)
        got = tp.tiered_reach_(ok0.clone(), topo, n, key, src, dst)
        want = tp.tiered_reach_plain(ok0.clone(), topo, n, key, src, dst)
        equal, err = _equal_all([got], [want])
        region = tp.regions(n, topo.n_regions, dev)
        raw = tp.edge_loss_thresholds_raw(topo, region, src, dst)
        if label == "":
            _trap("topo 4", f"E = {e}: the draw's {e} bytes are not a "
                  "multiple of 128, and every lossy tier drops some edge",
                  e % 128 != 0 and all(
                      bool((ok0 & ~want & (raw == thr)).any())
                      for thr in set(tp.loss_tiers(topo)) - {0}))
        if label == "_pin":
            _trap("topo 5", "the certainty pin: a tier at 256 cuts every "
                  "edge of it", bool((raw >= 256).any())
                  and not bool(want[raw >= 256].any()))
        hashes = int((ok0 & (raw > 0) & (raw < 256)).sum())
        ops = hashes * OPS_PER_HASH
        nbytes = e * 8 + e * 2
        rate = _int32_ops_per_s()
        work = ok0.clone()
        rows.append(dict(
            name="edge_reach" + label,
            source="corrosion_tpu_torch/kernels/csrc/edge_classes.cu",
            replaces="corrosion_tpu/sim/swim.py:125", equal=equal,
            max_abs_err=err,
            ms=_timed(timed, lambda: tp.tiered_reach_(work, topo, n, key,
                                                      src, dst),
                      lambda: work.copy_(ok0)),
            plain_ms=_timed(timed, lambda: tp.tiered_reach_plain(
                ok0.clone(), topo, n, key, src, dst)),
            bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
            bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
            else "bytes", ops=ops, hashes=hashes, bytes=nbytes, e=e,
            kernel="edge_reach"))
    return rows


def compare_scatter_tiered(dev, g, n=STORM_N, timed=True):
    """K10's tiered instantiation at storm-wan-3x2-100k's shapes (E =
    300000, W = 16, D = 3): the tiered stream alone, with the fault
    stream and the dropped count, and on the pin topology."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim import topology as tp

    f, w, d = 3, 16, 3
    e = n * f
    sending = _random_words(g, (n, w), dev, 2)
    dst = torch.as_tensor(g.integers(0, n, e), dtype=torch.int32, device=dev)
    slot = torch.as_tensor(g.integers(0, d, e), dtype=torch.int32,
                           device=dev)
    ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
    thr = torch.as_tensor(np.where(g.random(e) < 0.5, 0,
                                   g.integers(1, 60, e)),
                          dtype=torch.uint8, device=dev)
    key, topo_key = trng.prng_key(8, dev), trng.prng_key(9, dev)
    ring0 = _random_words(g, (d, n, w), dev, 6)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    wan, pin = _topo("wan-3x2"), _pin_topo()
    cases = {"tiered": (None, wan), "both": (thr, wan),
             "fault": (thr, None), "pin": (None, pin)}
    equal, err, outs, drops = True, 0, {}, {}
    for name, (t, tiers) in cases.items():
        got, want = ring0.clone(), ring0.clone()
        dk, dp = _acc(dev), _acc(dev)
        args = (sending, dst, slot, ok, t, key, 11, f, 0, topo_key)
        packed.scatter_sending_lossy(got, *args, dk, None, tiers)
        packed.scatter_sending_lossy_plain(want, *args, dp, None, tiers)
        e_, x = _equal_all([got, dk], [want, dp])
        equal, err = equal and e_, max(err, x)
        outs[name], drops[name] = want, int(dp)
    _trap("topo 6", "the tiered and fault streams compose (each drops, the "
          "OR differs from each)",
          not torch.equal(outs["tiered"], lossless)
          and not torch.equal(outs["both"], outs["tiered"])
          and not torch.equal(outs["both"], outs["fault"])
          and drops["both"] > max(drops["tiered"], drops["fault"]))
    region = tp.regions(n, 2, dev)
    src = torch.arange(n, dtype=torch.int32,
                       device=dev).repeat_interleave(f)
    cross = ok & (region[src] != region[dst])
    sent_cross = int((cross[:, None] & (sending.repeat_interleave(
        f, dim=0) != 0)).sum())
    _trap("topo 7", "the certainty pin on the wire: every frame of a "
          "cross-region edge dropped", sent_cross > 0
          and drops["pin"] == int(torch.where(
              cross[:, None], _popcount_rows(sending, f), 0).sum()))
    tiers = wan
    wan_raw = tp.edge_loss_thresholds_raw(wan, tp.regions(n, 3, dev), src,
                                          dst)
    live = ((sending.repeat_interleave(f, dim=0) != 0) & ok[:, None]
            & ((wan_raw > 0) & (wan_raw < 256))[:, None])
    hashes = int(live.sum()) * 8
    rows_touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    nbytes = sending.numel() * 4 + e * 9 + rows_touched * w * 4 * 2
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    ring_k, ring_p = ring0.clone(), ring0.clone()
    args = (sending, dst, slot, ok, None, key, 11, f, 0, topo_key, None,
            None, tiers)
    return dict(
        name="broadcast_scatter_tiered",
        source="corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        replaces="corrosion_tpu/sim/topology.py:240",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: packed.scatter_sending_lossy(ring_k, *args)),
        plain_ms=_time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, *args), SLOW_PLAIN_REPS) if timed else None,
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes", ops=ops, hashes=hashes, bytes=nbytes,
        kernel="broadcast_scatter_tiered")


def _popcount_rows(sending, f):
    """Each edge's sent frames (the popcount of its sender's words)."""
    from corrosion_tpu_torch.device import popcount

    return popcount(sending).sum(dim=1).repeat_interleave(f)[:, None]


def compare_dense_tiered(dev, g, n=1000, timed=True):
    """K12's tiered instantiation at broadcast-1k-wan-3x2's shapes (N =
    1000, P = 256, F = 3, D = 4): the tiered stream with the per-node
    frames and the dropped count, with a fault plan's loss, and on the
    pin topology."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim import topology as tp
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    cfg = SimConfig(n_nodes=n, n_payloads=256, n_writers=8, fanout=3,
                    n_delay_slots=4, rate_limit_bytes_round=None)
    meta = uniform_payloads(cfg, dev, inject_every=2)
    have, relay, injected, ring, _, alive, _ = _dense_round_inputs(
        g, dev, cfg, meta, 30)
    f, p, e = cfg.fanout, cfg.n_payloads, n * cfg.fanout
    tg = np.where(g.random((n, f)) < 0.03, -1, g.integers(0, n, (n, f)))
    targets = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.clamp(targets.reshape(-1), min=0)
    ok = (targets.reshape(-1) >= 0) & (dst != src) & torch.as_tensor(
        g.random(e) < 0.95, device=dev)
    slot = torch.as_tensor(g.integers(0, 4, e), dtype=torch.int32,
                           device=dev)
    fthr = torch.as_tensor(np.where(g.random(e) < 0.5, 0,
                                    g.integers(1, 80, e)),
                           dtype=torch.uint8, device=dev)
    k_drop, phase_key = trng.prng_key(31, dev), trng.prng_key(32, dev)

    def send(kernel, tiers, fthr_, out):
        r, rl, frames, nbytes_, dropped = out
        fn = bc.broadcast_send if kernel else bc.broadcast_send_plain
        fn(have, rl, injected, meta.nbytes, None, targets, dst, slot, ok,
           alive, k_drop, 0, r, frames, nbytes_, dropped,
           phase_key if fthr_ is not None else None, fthr_, None, 5, tiers)

    def fresh():
        return (ring.clone(), relay.clone(),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev), _acc(dev))

    wan, pin = _topo("wan-3x2"), _pin_topo()
    equal, err, drops = True, 0, {}
    for name, (tiers, fthr_) in {"tiered": (wan, None), "fault": (wan, fthr),
                                 "pin": (pin, None)}.items():
        got, want = fresh(), fresh()
        send(True, tiers, fthr_, got)
        send(False, tiers, fthr_, want)
        e_, x = _equal_all(list(got), list(want))
        equal, err = equal and e_, max(err, x)
        drops[name] = int(want[4])
    region = tp.regions(n, 2, dev)
    cross = ok & (region[src] != region[dst])
    _trap("topo 8", "the dense certainty pin and the fault stream on top of "
          "the tiers", bool(cross.any()) and drops["pin"] > 0
          and drops["fault"] > drops["tiered"] > 0)
    wan_raw = tp.edge_loss_thresholds_raw(wan, tp.regions(n, 3, dev), src,
                                          dst)
    sending = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    per_row = sending.sum(dim=1).repeat_interleave(f)
    hashes = int(per_row[ok & (wan_raw > 0) & (wan_raw < 256)].sum())
    ops = hashes * OPS_PER_HASH
    nbytes = (have.numel() * 2 + p * 8 + e * 13
              + int(per_row[ok].sum()) + int(sending.sum()))
    rate = _int32_ops_per_s()
    kout, pout = fresh(), fresh()
    return dict(
        name="dense_broadcast_tiered",
        source="corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
        replaces="corrosion_tpu/sim/topology.py:240",
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: send(True, wan, None, kout),
                  lambda: kout[1].copy_(relay)),
        plain_ms=_timed(timed, lambda: send(False, wan, None, pout),
                        lambda: pout[1].copy_(relay)),
        bound_ms=max(_bound_ms(nbytes), ops / rate * 1e3),
        bound_by="operations" if ops / rate * 1e3 > _bound_ms(nbytes)
        else "bytes", ops=ops, hashes=hashes, bytes=nbytes,
        kernel="dense_broadcast_tiered")


def _random_views(g, n, v, dev, wiped=0.02):
    """PeerSwap views [N, V]: random ids, one in eight slots empty, some
    self entries and repeats, ``wiped`` of the rows all empty."""
    ids = g.integers(0, n, (n, v))
    ids = np.where(g.random((n, v)) < 0.125, -1, ids)
    me = np.arange(n)[:, None]
    ids = np.where(g.random((n, v)) < 0.03, me, ids)
    ids[:, 1] = np.where(g.random(n) < 0.2, ids[:, 0], ids[:, 1])
    ids[g.random(n) < wiped] = -1
    return torch.as_tensor(ids, dtype=torch.int32, device=dev)


def compare_sample_view(dev, g, n=PEERSWAP_N, v=16, timed=True):
    """K1's view entry at storm-peerswap-25.6k's shapes (N = 25600, V =
    16) for the fan-out (count 3) and one target (count 1), ground-truth
    membership; and with full-view beliefs at N = 4096 (the DOWN
    filter)."""
    from corrosion_tpu_torch.topo import sampler

    rows = []
    for label, nn, count, beliefs in (("", n, 3, False), ("_c1", n, 1, False),
                                      ("_beliefs", 4096, 3, True)):
        pview = _random_views(g, nn, v, dev)
        slots = torch.as_tensor(g.integers(0, v, (4 * count, nn)),
                                dtype=torch.int32, device=dev)
        view = (torch.as_tensor(g.integers(0, 3, (nn, nn)), dtype=torch.int8,
                                device=dev) if beliefs else None)
        got = sampler.sample_view(pview, slots, view, count)
        want = sampler.sample_view_plain(pview, slots, view, count)
        equal, err = _equal_all([got], [want])
        cand = torch.gather(pview, 1, slots.T.long())
        me = torch.arange(nn, device=dev)[:, None]
        if label == "":
            _trap("topo 9", "view candidates that are empty, self and "
                  "repeats; rows left short",
                  bool((cand < 0).any()) and bool((cand == me).any())
                  and bool((cand[:, 0] == cand[:, 1]).any())
                  and bool((want == -1).any()))
        if beliefs:
            safe = torch.clamp(cand, min=0)
            _trap("topo 10", "the believed-DOWN filter under coupled full "
                  "view", bool((view.gather(1, safe.long()) == 2)[
                      cand >= 0].any()))
        rows.append(_row(
            "sample_view" + label,
            "corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
            "corrosion_tpu/topo/sampler.py:57", equal, err,
            _timed(timed, lambda: sampler.sample_view(pview, slots, view,
                                                      count)),
            _timed(timed, lambda: sampler.sample_view_plain(pview, slots,
                                                            view, count)),
            slots.numel() * (8 + (1 if beliefs else 0)) + nn * count * 4,
            kernel="sample_view", count=count, n=nn))
    return rows


def compare_peerswap(dev, g, n=PEERSWAP_N, v=16, timed=True):
    """K21 at storm-peerswap-25.6k's shapes (N = 25600, V = 16, announce
    interval 7): down nodes, unreachable partners, wiped views, partner
    slots c with g = (c + 1) % V == t % V, several offers to one partner,
    a partner's slot t % V both read and overwritten."""
    from corrosion_tpu_torch.topo import sampler

    t, interval = 37, 7
    pview = _random_views(g, n, v, dev)
    # a hub: many views hold node 5, so several nodes offer to it
    pview[:, 0] = torch.where(torch.as_tensor(g.random(n) < 0.01, device=dev),
                              5, pview[:, 0])
    c = torch.as_tensor(np.where(g.random(n) < 0.1, (t % v - 1) % v,
                                 g.integers(0, v, n)), dtype=torch.int32,
                        device=dev)
    c[torch.arange(n, device=dev) % 97 == 0] = 0
    reach = torch.as_tensor(g.random(n) < 0.85, device=dev)
    alive = torch.as_tensor((g.random(n) < 0.03) * 2, dtype=torch.uint8,
                            device=dev)
    rb = torch.as_tensor(g.integers(0, v, n), dtype=torch.int32, device=dev)
    rid = torch.as_tensor(g.integers(0, n, n), dtype=torch.int32, device=dev)

    def run(kernel):
        part = sampler.peerswap_partner if kernel else \
            sampler.peerswap_partner_plain
        app = sampler.peerswap_apply if kernel else \
            sampler.peerswap_apply_plain
        pc, winner = part(pview, c)
        out = app(pview, c, reach, alive, rb, rid, winner, t, interval)
        return [pc, winner, out]

    got, want = run(True), run(False)
    equal, err = _equal_all(got, want)
    pc, winner, out = want
    rows_ = torch.arange(n, device=dev)
    partner = pview[rows_, c.long()]
    ok = (partner >= 0) & (pc != rows_) & (alive == 0) & reach
    offers = torch.bincount(pc[ok].long(), minlength=n)
    _trap("topo 11", "down nodes, unreachable partners and wiped views",
          bool((alive != 0).any()) and bool((~reach & (partner >= 0)).any())
          and bool((pview < 0).all(dim=1).any()))
    _trap("topo 12", "g == t % V with a landed offer, several offers to one "
          "partner, a partner slot read and overwritten in one tick",
          bool((ok & ((c + 1) % v == t % v) & (winner >= 0)).any())
          and int(offers.max()) >= 2
          and bool((winner[pc[ok].long()] >= 0).any()))
    nbytes = pview.numel() * 8 + n * 4 * 7
    return [_row(
        "peerswap", "corrosion_tpu_torch/kernels/csrc/peerswap.cu",
        "corrosion_tpu/topo/sampler.py:81", equal, err,
        _timed(timed, lambda: run(True)), _timed(timed, lambda: run(False)),
        nbytes, kernel="peerswap", n=n, v=v)]


def compare_topology_kernels(dev, seed=7, timed=True):
    """Phase 3h: K20's three entries, K10's and K12's tiered
    instantiations, K1's view entry and K21 against their plain versions
    at the slice's shapes, every trap reached."""
    g = np.random.default_rng(seed)
    rows = (compare_edge_slots(dev, g, timed=timed)
            + [compare_degree_caps(dev, g, timed=timed)]
            + compare_edge_reach(dev, g, timed=timed)
            + [compare_scatter_tiered(dev, g, timed=timed),
               compare_dense_tiered(dev, g, timed=timed)]
            + compare_sample_view(dev, g, timed=timed)
            + compare_peerswap(dev, g, timed=timed))
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- phase 3i: the protocol axis ----------------------------------------------

PROTO_1K = 1000


def _pull_edges(g, dev, n, f, d):
    """A fan-out draw of E = N·F edges: -1 and self slots among the
    targets, the push's ok (neither), a slot per edge in [0, D)."""
    e = n * f
    tg = np.where(g.random(e) < 0.03, -1, g.integers(0, n, e))
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    raw = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    ok = (raw >= 0) & (raw != src)
    dst = torch.clamp(raw, min=0)
    slot = torch.as_tensor(g.integers(0, d, e), dtype=torch.int32, device=dev)
    return src, dst, ok, slot


def one_way_plan(n, seed=3):
    """A one-way cut (the first half to the second) and a loss class out
    of the middle half, rounds 0-7: pulls refused only by the reverse
    cut, and reverse-direction fault loss on the rest."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan

    half = n // 2
    return FaultPlan(n_nodes=n, seed=seed, events=(
        FaultEvent("loss", 0, 8, src=f"{n // 4}:{3 * n // 4}", dst="*",
                   p=0.3),
        FaultEvent("partition", 0, 8, src=f"0:{half}", dst=f"{half}:{n}"),
    ))


def _hash_ops(live, thr_edge):
    """Hashes of one stream over [E, W] sending (edge, word) pairs
    ``live``: eight a pair whose edge threshold is in (0, 256)."""
    on = (thr_edge > 0) & (thr_edge < 256)
    return int((live & on[:, None]).sum()) * 8


def _ops_row(name, source, replaces, equal, err, ms, plain_ms, nbytes, ops,
             **extra):
    """A kernel row bound by the larger of its bytes and its u32
    operations."""
    rate = _int32_ops_per_s()
    ops_ms = ops / rate * 1e3
    return dict(name=name, source=source, replaces=replaces, equal=equal,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(_bound_ms(nbytes), ops_ms),
                bound_by="operations" if ops_ms > _bound_ms(nbytes)
                else "bytes", bytes=nbytes, ops=ops, **extra)


def compare_pull_scatter(dev, g, n=STORM_N, timed=True):
    """K10p at the storm's shapes (E = 300000, W = 16, D = 3): the session
    mask and the reverse thresholds of a one-way plan (K9 with no count,
    on the swapped edges), then the loss-free form, the flat and fault
    streams, and the tiered form on wan-3x2 with the fault stream; and
    one round of latency-storm-100k's plan, where the push jitters."""
    from corrosion_tpu_torch.proto import dissemination as dis
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim import topology as tp

    f, w, d = 3, 16, 3
    cfg, _ = _storm_cfg(n, dev)
    fplan = faults.compile_plan(one_way_plan(n), cfg, device=dev)
    rf = faults.round_faults(fplan, 3)
    seed = int(rf.seed)
    sending = _random_words(g, (n, w), dev, 2)
    src, dst, ok0, slot = _pull_edges(g, dev, n, f, d)
    ok = ok0.clone()
    faults.fault_wire_effects(rf, src, dst, ok)  # the forward cut
    ok_pull = dis.pull_session_ok(ok, rf, src, dst)
    thr_rev = dis.reverse_loss(rf, src, dst)
    q_equal, _ = _equal_all(
        [ok_pull, thr_rev],
        [dis.pull_session_ok_plain(ok, rf, src, dst),
         faults._loss_plain(rf, dst, src)])
    if not q_equal:
        raise AssertionError("pull session mask or reverse thresholds != "
                             "their plain versions")
    _trap("proto 1", "pulls refused only by the reverse cut (a one-way "
          "partition: the push flows, the response does not)",
          bool((ok & ~ok_pull).any()))
    wan = _topo("wan-3x2")
    k_drop = trng.prng_key(12, dev)
    ring0 = _random_words(g, (d, n, w), dev, 6)
    live = ok_pull[:, None] & (sending[dst.long()] != 0)
    rows_touched = torch.unique(
        (slot.long() * n + src.long())[ok_pull]).numel()
    base_bytes = sending.numel() * 4 + src.numel() * 9 + rows_touched * w * 8
    region3 = tp.regions(n, 3, dev)
    cases = (("broadcast_pull", None, 0, None),
             ("broadcast_pull_lossy", thr_rev, 26, None),
             ("broadcast_pull_tiered", thr_rev, 0, wan))
    rows, drops = [], {}
    for name, thr, topo_thr, tiers in cases:
        args = (sending, dst, slot, ok_pull, thr, k_drop, seed, f, topo_thr)
        got, want = ring0.clone(), ring0.clone()
        dk, dp = _acc(dev), _acc(dev)
        packed.scatter_pull(got, *args, dk, tiers)
        packed.scatter_pull_plain(want, *args, dp, tiers)
        equal, err = _equal_all([got, dk], [want, dp])
        drops[name] = int(dp)
        hashes = 0
        if tiers is not None:
            raw = tp.edge_loss_thresholds_raw(tiers, region3, dst, src)
            hashes += _hash_ops(live, raw)
        elif topo_thr:
            hashes += _hash_ops(live, torch.full_like(dst, topo_thr))
        if thr is not None:
            hashes += _hash_ops(live, thr.to(torch.int32))
        work = ring0.clone()
        rows.append(_ops_row(
            name, "corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
            "corrosion_tpu/proto/dissemination.py:58", equal, err,
            _timed(timed, lambda: packed.scatter_pull(work, *args, None,
                                                      tiers),
                   lambda: work.copy_(ring0)),
            _time_eager_ms(lambda: packed.scatter_pull_plain(
                ring0.clone(), *args, None, tiers), SLOW_PLAIN_REPS)
            if timed else None,
            base_bytes + (src.numel() if thr is not None else 0),
            hashes * OPS_PER_HASH, hashes=hashes, kernel=name))
    # the first 3000 edges' pull bits on wan-3x2: every lossy REVERSE tier
    # drops some (the draw's bytes do not depend on its length)
    bits = dis.pull_drop_bits(0, wan, None, 0, k_drop, src[:3000],
                              dst[:3000], 512, region3)
    raw = tp.edge_loss_thresholds_raw(wan, region3, dst[:3000], src[:3000])
    _trap("proto 2", "reverse tier loss under wan-3x2: each lossy tier of the "
          "swapped edges drops pulled payloads on the pull's key",
          drops["broadcast_pull_tiered"] > 0 and all(
              bool(bits[raw == thr].any())
              for thr in set(tp.loss_tiers(wan)) - {0}))
    # one round of the latency storm: the push jitters, the pull lands in
    # its edge's fixed-delay slot
    lcfg, _, lplan = _latency_storm(n, dev)
    lrf = faults.round_faults(lplan, LATENCY_T)
    ok_l = ok0.clone()
    _, lthr, fdelay, jit = faults.fault_wire_effects(lrf, src, dst, ok_l)
    slot_l = tp.edge_slot(tp.Topology(), tp.regions(n, 1, dev), src, dst,
                          LATENCY_T, 4, fdelay)
    okp_l = dis.pull_session_ok(ok_l, lrf, src, dst)
    lrev = dis.reverse_loss(lrf, src, dst)
    got = torch.zeros((4, n, w), dtype=torch.int32, device=dev)
    want = got.clone()
    largs = (sending, dst, slot_l, okp_l, lrev, k_drop, int(lrf.seed), f)
    packed.scatter_pull(got, *largs)
    packed.scatter_pull_plain(want, *largs)
    equal, err = _equal_all([got], [want])
    rows[1]["equal"] &= equal
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], err)
    written = (want != 0).any(dim=2).reshape(-1).nonzero().reshape(-1)
    allowed = (slot_l.long() * n + src.long())[okp_l]
    _trap("proto 3", "the pull jitter-free under a jitter plan: jittered "
          "edges pull, and every pulled bit lands in its edge's fixed-delay "
          "slot", bool(((jit > 0) & okp_l).any()) and written.numel() > 0
          and bool(torch.isin(written, allowed).all()))
    return rows


def compare_dense_pull(dev, g, n=PROTO_1K, timed=True):
    """K12p at broadcast-1k's shapes (N = 1000, P = 256, F = 3, D = 4):
    the loss-free form (the path's), the flat and fault streams with a
    binding byte budget, and the tiered form on wan-3x2 with the fault
    stream, each with its dropped count."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import rng as trng
    from corrosion_tpu_torch.sim import topology as tp
    from corrosion_tpu_torch.sim.state import (
        SimConfig, budget_prefix_mask, uniform_payloads)

    cfg = SimConfig(n_nodes=n, n_payloads=256, n_writers=8, fanout=3,
                    n_delay_slots=4)
    meta = uniform_payloads(cfg, dev, inject_every=2)
    have, relay, injected, ring, _, _, _ = _dense_round_inputs(
        g, dev, cfg, meta, 30)
    f, p, d = 3, cfg.n_payloads, 4
    src, dst, ok, slot = _pull_edges(g, dev, n, f, d)
    fthr = torch.as_tensor(np.where(g.random(n * f) < 0.5, 0,
                                    g.integers(1, 80, n * f)),
                           dtype=torch.uint8, device=dev)
    k_drop = trng.prng_key(33, dev)
    wan = _topo("wan-3x2")
    budget = 40 * 8192
    eligible = (have > 0) & (relay > 0) & (injected > 0)[None, :]
    metered = budget_prefix_mask(eligible, budget, meta.nbytes)
    _trap("proto dense 1", "the responder's byte budget binds its answer",
          bool((eligible & ~metered).any()))
    rows = []
    for name, fth, thr, tiers, bud in (
            ("dense_pull", None, 0, None, None),
            ("dense_pull_lossy", fthr, 26, None, budget),
            ("dense_pull_tiered", fthr, 0, wan, None)):
        args = (have, relay, injected, meta.nbytes, bud, dst, slot, ok,
                k_drop, thr)
        got, want = ring.clone(), ring.clone()
        dk, dp = _acc(dev), _acc(dev)
        bc.pull_send(*args, got, dk, fth, 5, tiers)
        bc.pull_send_plain(*args, want, dp, fth, 5, tiers)
        equal, err = _equal_all([got, dk], [want, dp])
        if name != "dense_pull" and int(dp) == 0:
            raise AssertionError(f"{name}: the streams dropped nothing")
        sending = metered if bud is not None else eligible
        per_edge = sending[dst.long()] & ok[:, None]
        hashes = 0
        if tiers is not None:
            raw = tp.edge_loss_thresholds_raw(tiers, tp.regions(n, 3, dev),
                                              dst, src)
            on = (raw > 0) & (raw < 256)
            hashes += int((per_edge & on[:, None]).sum())
        elif thr:
            hashes += int(per_edge.sum())
        if fth is not None:
            hashes += int((per_edge & (fth > 0)[:, None]).sum())
        nbytes = (have.numel() * 2 + p * 5 + src.numel() * 9
                  + (src.numel() if fth is not None else 0)
                  + int(per_edge.sum()))
        work = ring.clone()
        rows.append(_ops_row(
            name, "corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
            "corrosion_tpu/proto/dissemination.py:58", equal, err,
            _timed(timed, lambda: bc.pull_send(*args, work, None, fth, 5,
                                               tiers),
                   lambda: work.copy_(ring)),
            _timed(timed, lambda: bc.pull_send_plain(*args, work, None, fth,
                                                     5, tiers),
                   lambda: work.copy_(ring)),
            nbytes, hashes * OPS_PER_HASH, hashes=hashes, kernel=name))
    return rows


def _holdings(g, n, a, v, c, dev, full=0.6, some=0.15):
    """u8 have [N, V·A·C] (version-major): whole versions held with
    probability ``full``, single chunks with ``some`` — predecessors held
    but for a chunk, gaps below heads."""
    whole = g.random((n, v, a, 1)) < full
    part = g.random((n, v, a, c)) < some
    return torch.as_tensor((whole | part).reshape(n, v * a * c).astype(
        np.uint8), device=dev)


def _one_chunk_short(have, arrivals, a, v, c):
    """Some arrival of version v > 1 whose predecessor is held but for
    one chunk."""
    n = have.shape[0]
    h = have.reshape(n, v, a, c).sum(dim=3)
    arr = arrivals.reshape(n, v, a, c).any(dim=3)
    return bool((arr[:, 1:] & (h[:, :-1] == c - 1)).any())


def compare_fifo_deliver(dev, g, n=STORM_N, timed=True):
    """K8f at the storm's shapes (N = 100000, W = 16, A = 16, C = 4, D =
    2) and K12f-o at broadcast-1k's (N = 1000, P = 256, A = 8, C = 1, D =
    4) and the storm layout at N = 10000 (C = 4): both rings behind the
    admit gate of the pre-merge have."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.words import pack_bits, unpack_bits

    rows = []
    cfg, _ = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, ordering="fifo")
    a, v, c = cfg.n_writers, cfg.n_versions, cfg.chunks_per_version
    d, w, t = cfg.n_delay_slots, cfg.n_payloads // 32, 9
    have_u8 = _holdings(g, n, a, v, c, dev)
    relay = [_random_words(g, (n, w), dev, 2) & pack_bits(have_u8)
             for _ in range(4)]
    carry0 = packed.PackedCarry(
        have=pack_bits(have_u8), inflight=_random_words(g, (d, n, w), dev, 3),
        relay=packed.Planes(*relay),
        sync_buf=_random_words(g, (d, n, w), dev, 4))
    slot = t % d
    arrivals = unpack_bits(carry0.inflight[slot] | carry0.sync_buf[slot],
                           cfg.n_payloads)
    _trap("proto 4", "a FIFO arrival whose predecessor is held except for "
          "one chunk (refused)", _one_chunk_short(have_u8, arrivals, a, v, c))

    def clone(cr):
        return packed.PackedCarry(cr.have.clone(), cr.inflight.clone(),
                                  packed.Planes(*(x.clone() for x in
                                                  cr.relay)),
                                  cr.sync_buf.clone())

    def restore(dst_, src_=carry0):
        for x, y in zip((dst_.have, dst_.inflight, *dst_.relay,
                         dst_.sync_buf),
                        (src_.have, src_.inflight, *src_.relay,
                         src_.sync_buf)):
            x.copy_(y)

    got, want = clone(carry0), clone(carry0)
    packed.deliver_packed(got, t, cfg)
    packed.deliver_packed_plain(want, t, cfg)
    flat = [got.have, got.inflight, *got.relay, got.sync_buf]
    flat_w = [want.have, want.inflight, *want.relay, want.sync_buf]
    equal, err = _equal_all(flat, flat_w)
    kw_, pw_ = clone(carry0), clone(carry0)
    rows.append(_row(
        "word_deliver_fifo", "corrosion_tpu_torch/kernels/csrc/word_phases.cu",
        "corrosion_tpu/proto/ordering.py:65", equal, err,
        _timed(timed, lambda: packed.deliver_packed(kw_, t, cfg),
               lambda: restore(kw_)),
        _timed(timed, lambda: packed.deliver_packed_plain(pw_, t, cfg),
               lambda: restore(pw_)),
        n * w * 4 * 2 * 2 + _changed_bytes(flat[:1] + flat[2:6],
                                           [carry0.have, *carry0.relay]),
        kernel="word_deliver_fifo"))
    for label, nn, kw in (
            ("", PROTO_1K, dict(n_payloads=256, n_writers=8,
                                n_delay_slots=4)),
            ("_c4", 10_000, dict(n_payloads=512, n_writers=16,
                                 chunks_per_version=4, n_delay_slots=2))):
        from corrosion_tpu_torch.sim.state import SimConfig

        dcfg = SimConfig(n_nodes=nn, fanout=3, ordering="fifo", **kw)
        a, v, c = dcfg.n_writers, dcfg.n_versions, dcfg.chunks_per_version
        p, d = dcfg.n_payloads, dcfg.n_delay_slots
        have = _holdings(g, nn, a, v, c, dev)
        relay_ = torch.as_tensor(g.integers(0, 10, (nn, p)), dtype=torch.uint8,
                                 device=dev) * have
        ring = _u8(g, (d, nn, p), 0.1, dev)
        sync = _u8(g, (d, nn, p), 0.05, dev)
        slot = 3 % d
        if c > 1:
            _trap("proto dense 2", "a dense FIFO arrival whose predecessor "
                  "is held except for one chunk", _one_chunk_short(
                      have, (ring[slot] | sync[slot]) > 0, a, v, c))
        xs0 = (ring, sync, have, relay_)
        outs = []
        for kernel in (True, False):
            xs = [x.clone() for x in xs0]
            if kernel:
                bc.deliver_dense(*xs, slot, 9, dcfg)
            else:
                from corrosion_tpu_torch.proto.ordering import (
                    admit_payload_mask)

                bc.deliver_dense_plain(*xs, slot, 9,
                                       admit_payload_mask(xs[2], dcfg))
            outs.append(xs)
        equal, err = _equal_all(outs[0], outs[1])
        wk = [x.clone() for x in xs0]
        wp = [x.clone() for x in xs0]

        def put_back(xs):
            for x, y in zip(xs, xs0):
                x.copy_(y)

        def plain(xs=wp):
            from corrosion_tpu_torch.proto.ordering import admit_payload_mask

            bc.deliver_dense_plain(*xs, slot, 9,
                                   admit_payload_mask(xs[2], dcfg))

        rows.append(_row(
            "dense_deliver_fifo" + label,
            "corrosion_tpu_torch/kernels/csrc/dense_phases.cu",
            "corrosion_tpu/proto/ordering.py:55", equal, err,
            _timed(timed, lambda: bc.deliver_dense(*wk, slot, 9, dcfg),
                   lambda: put_back(wk)),
            _timed(timed, plain, lambda: put_back(wp)),
            nn * p * 4 + _changed_bytes(outs[1][2:], xs0[2:]),
            kernel="dense_deliver_fifo", n=nn))
    return rows


def compare_order_check(dev, g, n=STORM_N, timed=True):
    """K22's word entry at the storm's shapes (N = 100000, W = 16, A = 16,
    V = 8, C = 4) and its u8 entry at broadcast-1k's (N = 1000, P = 256,
    A = 8, C = 1) and the dense storm's (N = 100000, P = 512, C = 4):
    holdings with gaps, origin rows among them, added to a nonzero
    accumulator."""
    from corrosion_tpu_torch.proto.ordering import prev_complete
    from corrosion_tpu_torch.sim import invariants as inv
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads
    from corrosion_tpu_torch.sim.words import pack_bits

    rows = []
    cfg, meta = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, ordering="fifo-unchecked")
    b1k = SimConfig(n_nodes=PROTO_1K, n_payloads=256, n_writers=8, fanout=3,
                    ordering="fifo-unchecked")
    for label, c_, m_, packed_ in (
            ("order_check_words", cfg, meta, True),
            ("order_check_dense", b1k, uniform_payloads(b1k, dev, 2), False),
            ("order_check_dense_storm", cfg, meta, False)):
        nn = c_.n_nodes
        have_u8 = _holdings(g, nn, c_.n_writers, c_.n_versions,
                            c_.chunks_per_version, dev, 0.5, 0.2)
        have = pack_bits(have_u8) if packed_ else have_u8
        acc0 = torch.full((), 11, dtype=torch.int32, device=dev)
        got = acc0.clone()
        inv.count_order_violations_(got, have, m_, c_)
        grids = inv._grids(have, c_)
        want = acc0 + inv.order_violation_count(*grids, m_, c_)
        equal, err = _equal_all([got], [want])
        if label == "order_check_words":
            everyone = int((grids[0] & ~prev_complete(grids[1])).sum())
            _trap("proto 5", "the origin-row exemption: origin rows hold "
                  "out-of-order versions the count leaves out",
                  everyone > int(want - acc0) > 0)
        work = acc0.clone()
        rows.append(_row(
            label, "corrosion_tpu_torch/kernels/csrc/order_check.cu",
            "corrosion_tpu/sim/invariants.py:51", equal, err,
            _timed(timed, lambda: inv.count_order_violations_(
                work, have, m_, c_), lambda: work.copy_(acc0)),
            _timed(timed, lambda: inv.order_violation_count(
                *inv._grids(have, c_), m_, c_)),
            _nbytes(have) + c_.n_writers * 4 + 4,
            kernel="order_check_dense" if not packed_ else label, n=nn))
    return rows


def compare_caps_schedule(dev, g, n=STORM_N, timed=True):
    """K20's schedule instantiation on the storm's targets [100000, 3]
    (fan-out decay every R = 8 rounds): without degree classes at t = 7
    and t = 8, and composed after hetero-degree's caps 3/2/1."""
    from corrosion_tpu_torch.proto import schedule as sch

    cfg, _ = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, fanout_schedule="decay")
    tg = np.where(g.random((n, 3)) < 0.05, -1, g.integers(0, n, (n, 3)))
    targets = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    flat, het = _topo(), _topo("hetero-degree")
    outs, equal, err = {}, True, 0
    for label, topo, t in (("7", flat, 7), ("8", flat, 8), ("het7", het, 7),
                           ("het8", het, 8)):
        got = sch.capped_schedule(targets.clone(), topo, cfg, t)
        want = sch.capped_schedule_plain(targets, topo, cfg, t)
        e_, x = _equal_all([got], [want])
        equal, err = equal and e_, max(err, x)
        outs[label] = want
    from corrosion_tpu_torch.sim import topology as tp

    caps_only = tp.apply_degree_caps_plain(targets, het)
    _trap("proto 6", "a decay step crossing R = 8 (3 live slots at t = 7, 1 "
          "at t = 8), composed after the degree caps",
          torch.equal(outs["7"], targets)
          and bool((outs["8"][:, 1:] == -1).all())
          and torch.equal(outs["het7"], caps_only)
          and not torch.equal(caps_only, targets)
          and torch.equal(outs["het8"], outs["8"]))
    work = targets.clone()
    return [_row(
        "degree_caps_sched",
        "corrosion_tpu_torch/kernels/csrc/edge_classes.cu",
        "corrosion_tpu/proto/schedule.py:27", equal, err,
        _timed(timed, lambda: sch.capped_schedule(work, het, cfg, 8),
               lambda: work.copy_(targets)),
        _timed(timed, lambda: sch.capped_schedule_plain(targets, het, cfg,
                                                        8)),
        targets.numel() * 4 + _changed_bytes([targets], [outs["het8"]]),
        kernel="degree_caps_sched")]


def compare_trace_wire_pull(dev, g, n=STORM_N, timed=True):
    """K18's pull entries: the words entry at the storm's shapes (E =
    300000, W = 16, 8 KiB payloads) and the rows entry at broadcast-1k's
    (E = 3000), over ok_pull edges with repeated responders."""
    from corrosion_tpu_torch.sim import telemetry as tel
    from corrosion_tpu_torch.sim.fused import word_send_stats

    rows = []
    w, f = 16, 3
    sending = _random_words(g, (n, w), dev, 2)
    nbytes = torch.full((w * 32,), 8192, dtype=torch.int32, device=dev)
    _, dst, ok, _ = _pull_edges(g, dev, n, f, 2)
    got, want = torch.zeros(2, dtype=torch.int64, device=dev), None
    tel.wire_words_pull_(got, sending, nbytes, ok, dst)
    want = torch.stack(tel.pull_fold(*word_send_stats(sending, nbytes), ok,
                                     dst))
    equal, err = _equal_all([got], [want])
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    rows.append(_row(
        "trace_wire_pull", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:192", equal, err,
        _timed(timed, lambda: tel.wire_words_pull_(work, sending, nbytes, ok,
                                                   dst)),
        _timed(timed, lambda: tel.pull_fold(*word_send_stats(sending, nbytes),
                                            ok, dst)),
        sending.numel() * 4 + dst.numel() * 5 + nbytes.numel() * 4,
        kernel="trace_wire_pull"))
    nn = PROTO_1K
    frames = torch.as_tensor(g.integers(0, 256, nn), dtype=torch.int32,
                             device=dev)
    byts = frames * 8192
    _, dst, ok, _ = _pull_edges(g, dev, nn, f, 4)
    got = torch.zeros(2, dtype=torch.int64, device=dev)
    tel.wire_rows_pull_(got, frames, byts, ok, dst)
    want = torch.stack(tel.pull_fold(frames, byts, ok, dst))
    equal, err = _equal_all([got], [want])
    rows.append(_row(
        "trace_wire_rows_pull", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/fused.py:225", equal, err,
        _timed(timed, lambda: tel.wire_rows_pull_(work, frames, byts, ok,
                                                  dst)),
        _timed(timed, lambda: tel.pull_fold(frames, byts, ok, dst)),
        nn * 8 + dst.numel() * 5, kernel="trace_wire_rows_pull"))
    return rows


def compare_protocol_kernels(dev, seed=8, timed=True):
    """Phase 3i: the protocol axis's kernel entries — K10p, K12p, K8f,
    K12f-o, K22, K20's schedule instantiation, K18's pull entries —
    against their plain versions at the storm's and broadcast-1k's
    shapes, every trap reached."""
    g = np.random.default_rng(seed)
    rows = (compare_pull_scatter(dev, g, timed=timed)
            + compare_dense_pull(dev, g, timed=timed)
            + compare_fifo_deliver(dev, g, timed=timed)
            + compare_order_check(dev, g, timed=timed)
            + compare_caps_schedule(dev, g, timed=timed)
            + compare_trace_wire_pull(dev, g, timed=timed))
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- phase 3j: membership churn: K23's two entries and K11's view row --------

CHURN_N = 4096
#: the flash crowd's join round (`flash_crowd_events`' default): the tail
#: quarter restarts wiped here
JOIN_T = 8


def _churn_up(n, dev):
    """up[] of the churn setup (`runner.churn_setup`): every third node
    dead."""
    return torch.arange(n, device=dev) % 3 != 0


def _detect_cases(dev, up, t, want_held, run, plain, label):
    """K23 against its plain version on one input: from detect_round -1
    (the answer must be t iff ``want_held``) and from a detect_round
    already set (it must stay).  Returns (equal, err)."""
    from corrosion_tpu_torch.sim.telemetry import new_detect

    equal, err = True, 0
    for start in (-1, 3):
        outs = []
        for fn in (run, plain):
            det = new_detect(dev)
            det[0] = start
            fn(det)
            outs.append(det)
        e, x = _equal_all([outs[0]], [outs[1]])
        equal, err = equal and e, max(err, x)
        want = (t if want_held else -1) if start < 0 else start
        if int(outs[0][0]) != want or outs[0][1:].any():
            raise AssertionError(f"{label}: detect {outs[0].tolist()}, "
                                 f"want [{want}, 0, 0]")
    return equal, err


def compare_detect_full(dev, g, sizes=(64, 1000, 4096), timed=True):
    """K23's full entry at the churn paths' shapes (N = 64, 1000, 4096;
    and N = 1001, whose rows do not start on words): beliefs where every
    (up, dead) cell is DOWN among random ALIVE/SUSPECT/DOWN cells
    elsewhere, then the same with one (up, dead) cell at SUSPECT, each
    from detect_round -1 and from one already set."""
    from corrosion_tpu_torch.sim import telemetry as tel

    rows = []
    t = 17
    for n in (*sizes, 1001):
        up_np = np.arange(n) % 3 != 0
        view_np = g.integers(0, 3, (n, n)).astype(np.int8)
        view_np[np.ix_(up_np, ~up_np)] = 2
        up = torch.as_tensor(up_np, device=dev)
        view = torch.as_tensor(view_np, device=dev)
        if n % 32:
            _trap("churn 3", f"N = {n}, not a multiple of 32", True)
        noise = int((view_np[np.ix_(up_np, up_np)] == 2).sum()) and int(
            (view_np[~up_np] == 2).sum())
        _trap("churn 2", f"DOWN on (up, up) and (dead, ·) cells at N = {n}",
              noise > 0)
        equal, err = _detect_cases(
            dev, up, t, True, lambda d: tel.detect_full_(d, view, up, t),
            lambda d: tel.detect_full_plain(d, view, up, t),
            f"detect_full {n}")
        bad = view.clone()
        i, j = int(np.flatnonzero(up_np)[-1]), int(np.flatnonzero(~up_np)[-1])
        bad[i, j] = 1
        e, x = _detect_cases(
            dev, up, t, False, lambda d: tel.detect_full_(d, bad, up, t),
            lambda d: tel.detect_full_plain(d, bad, up, t),
            f"detect_full {n} suspect")
        equal, err = equal and e, max(err, x)
        _trap("churn 1", f"an (up, dead) cell at SUSPECT at N = {n}", True)
        _trap("churn 7", f"detect_round already >= 0 stays at N = {n}", True)
        if n not in sizes:
            if not equal:
                raise AssertionError(f"detect_full {n}: kernel != plain")
            continue
        det, det2 = tel.new_detect(dev), tel.new_detect(dev)
        n_up = int(up_np.sum())
        rows.append(_row(
            f"detect_full_{n}",
            "corrosion_tpu_torch/kernels/csrc/membership_detect.cu",
            "corrosion_tpu/sim/telemetry.py:320", equal, err,
            _timed(timed, lambda: tel.detect_full_(det, view, up, t)),
            _timed(timed, lambda: tel.detect_full_plain(det2, view, up, t)),
            # the up watchers' rows of view, and up
            n_up * n + n, kernel="detect_full", n=n))
    return rows


def _partial_tables(g, n, m, dev):
    """Member tables of the churn setup's shape ([N, M], every third node
    dead) where every entry of an up watcher that names a dead member is
    DOWN — some at the incarnation clamp, INC_CLAMP * 4 + 2 — while dead
    watchers' rows name dead members unmarked and empty entries carry
    pid = pkey = -1."""
    from corrosion_tpu_torch.sim.pswim import INC_CLAMP

    up_np = np.arange(n) % 3 != 0
    pid, pkey, _ = _random_tables(g, n, m, 20)
    watched = up_np[:, None] & (pid >= 0) & ~up_np[np.maximum(pid, 0)]
    inc = np.where(g.random((n, m)) < 0.1, INC_CLAMP, pkey >> 2)
    pkey = np.where(watched, inc * 4 + 2, pkey)
    _trap("churn 4", "pid = -1 with pkey = -1",
          bool(((pid < 0) & (pkey == -1)).any()))
    dead_rows = ~up_np[:, None] & (pid >= 0) & ~up_np[np.maximum(pid, 0)]
    _trap("churn 5", "a dead watcher whose row names dead members unmarked",
          bool((dead_rows & ((pkey & 3) != 2)).any()))
    _trap("churn 6", "pkey at INC_CLAMP * 4 + 2",
          bool((watched & (pkey == INC_CLAMP * 4 + 2)).any()))

    def i32(x):
        return torch.as_tensor(x.astype(np.int32), device=dev)

    return (i32(pid), i32(pkey), torch.as_tensor(up_np, device=dev),
            watched)


def compare_detect_partial(dev, g, sizes=(CHURN_N, STORM_N), m=64,
                           timed=True):
    """K23's partial entry at swim-churn-partial's shapes (N = 4096 and
    100000, M = 64): tables where every watched entry is DOWN, then the
    same with one watched entry ALIVE, each from detect_round -1 and
    from one already set."""
    from corrosion_tpu_torch.sim import telemetry as tel

    rows = []
    t = 29
    for n in sizes:
        pid, pkey, up, watched = _partial_tables(g, n, m, dev)
        equal, err = _detect_cases(
            dev, up, t, True,
            lambda d: tel.detect_partial_(d, pid, pkey, up, t),
            lambda d: tel.detect_partial_plain(d, pid, pkey, up, t),
            f"detect_partial {n}")
        bad = pkey.clone()
        i, s = (int(x[-1]) for x in np.nonzero(watched))
        bad[i, s] = bad[i, s] - 2
        e, x = _detect_cases(
            dev, up, t, False,
            lambda d: tel.detect_partial_(d, pid, bad, up, t),
            lambda d: tel.detect_partial_plain(d, pid, bad, up, t),
            f"detect_partial {n} alive")
        equal, err = equal and e, max(err, x)
        det, det2 = tel.new_detect(dev), tel.new_detect(dev)
        n_up = int(up.sum())
        rows.append(_row(
            f"detect_partial_{n}",
            "corrosion_tpu_torch/kernels/csrc/membership_detect.cu",
            "corrosion_tpu/sim/telemetry.py:320", equal, err,
            _timed(timed, lambda: tel.detect_partial_(det, pid, pkey, up, t)),
            _timed(timed, lambda: tel.detect_partial_plain(det2, pid, pkey,
                                                           up, t)),
            # the up watchers' pid and pkey rows, and up
            n_up * m * 8 + n, kernel="detect_partial", n=n, m=m))
    return rows


def _flash_plan(n, cfg, dev):
    from corrosion_tpu_torch.faults import FaultPlan
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.topo import flash_crowd_events

    return faults.compile_plan(
        FaultPlan(n_nodes=n, seed=0, events=flash_crowd_events(n)), cfg,
        device=dev)


def _view_wiped(before, after, rf, label):
    """The wiped rows of a PeerSwap view were full and are empty now."""
    wiped = rf.wipe
    full = bool((before[wiped] >= 0).all(dim=1).any())
    _trap("churn 8", f"a wiped node with a full view row ({label})",
          full and bool((after[wiped] == -1).all()))


def compare_node_faults_view(dev, g, n=PEERSWAP_N, timed=True):
    """K11's word entry at flash-crowd-peerswap-25.6k's shapes (N = 25600,
    W = 16, D = 2, V = 16; the flash crowd's round 8, where the tail
    quarter restarts wiped, and round 0, overrides only), and its dense
    entry at broadcast-1k-wan-3x2-peerswap's (N = 1000, P = 256, D = 4,
    V = 16) under a flash crowd of its own: every field, the PeerSwap
    view row included."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim.runner import _write_storm
    from corrosion_tpu_torch.sim.state import SimConfig, init_state

    rows = []
    cfg, _ = _write_storm(n, 512, dev, sampler="peerswap")
    fplan = _flash_plan(n, cfg, dev)
    w = cfg.n_payloads // 32
    state = init_state(cfg, torch.tensor([0, 7], dtype=torch.int64,
                                         device=dev))
    slim = packed.shrink_state(state)
    carry = packed.PackedCarry(
        have=_random_words(g, (n, w), dev),
        inflight=_random_words(g, (2, n, w), dev, 3),
        relay=packed.Planes(*(_random_words(g, (n, w), dev, 2)
                              for _ in range(4))),
        sync_buf=_random_words(g, (2, n, w), dev, 3))
    names = ("alive", "heads", "gap_lo", "gap_hi", "pview")

    def flat():
        return [getattr(slim, x) for x in names] + [
            carry.have, *carry.relay, carry.inflight, carry.sync_buf]

    def unflat(xs):
        sl = slim._replace(**dict(zip(names, xs[:5])))
        return sl, packed.PackedCarry(have=xs[5], relay=packed.Planes(
            *xs[6:10]), inflight=xs[10], sync_buf=xs[11])

    def plain(sl, c, rf):
        return (faults.apply_node_faults_plain(sl, rf),
                packed.apply_carry_faults(c, rf))

    base = flat()
    equal, err = True, 0
    for r in (JOIN_T, 0):
        rf = faults.round_faults(fplan, r)
        outs = []
        for fn in (packed.apply_round_faults, plain):
            xs = [x.clone() for x in base]
            fn(*unflat(xs), rf)
            outs.append(xs)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        if r == JOIN_T:
            _view_wiped(base[4], outs[0][4], rf, "word entry")
    rf = faults.round_faults(fplan, JOIN_T)
    work = [x.clone() for x in base]

    def restore():
        for dst, src in zip(work, base):
            dst.copy_(src)

    wiped = int(rf.wipe.sum())
    a, k, v = cfg.n_writers, cfg.gap_slots, cfg.view_slots
    row = (w * (5 + 2 * 2) + a + 2 * a * k + v) * 4
    rows.append(_row(
        "node_faults_view", "corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        "corrosion_tpu/sim/faults.py:703", equal, err,
        _timed(timed, lambda: packed.apply_round_faults(*unflat(work), rf),
               restore),
        _timed(timed, lambda: plain(*unflat(work), rf), restore),
        # the override, the wipe mask and alive in and out; wiped rows out
        n * 4 + wiped * row, kernel="node_faults", n=n))

    b1k = SimConfig(n_nodes=PROTO_1K, n_payloads=256, n_writers=8, fanout=3,
                    n_delay_slots=4, peer_sampler="peerswap")
    fplan = _flash_plan(PROTO_1K, b1k, dev)
    dense = _dense_state(g, dev, b1k, JOIN_T)
    equal, err = True, 0
    for r in (JOIN_T, 0):
        rf = faults.round_faults(fplan, r)
        got = faults.apply_node_faults(_clone_state(dense), rf)
        want = faults.apply_node_faults_plain(_clone_state(dense), rf)
        e, x = _equal_all([x for x in got if x.numel()],
                          [x for x in want if x.numel()])
        equal, err = equal and e, max(err, x)
        if r == JOIN_T:
            _view_wiped(dense.pview, got.pview, rf, "dense entry")
    rf = faults.round_faults(fplan, JOIN_T)
    work_d = _clone_state(dense)

    def restore_d():
        for name in ("alive", "have", "relay_left", "inflight",
                     "sync_inflight", "heads", "gap_lo", "gap_hi", "pview"):
            getattr(work_d, name).copy_(getattr(dense, name))

    p, d = b1k.n_payloads, b1k.n_delay_slots
    row = p * (2 + 2 * d) + (b1k.n_writers * (1 + 2 * b1k.gap_slots)
                             + b1k.view_slots) * 4
    rows.append(_row(
        "node_faults_dense_view",
        "corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        "corrosion_tpu/sim/faults.py:703", equal, err,
        _timed(timed, lambda: faults.apply_node_faults(work_d, rf),
               restore_d),
        _timed(timed, lambda: faults.apply_node_faults_plain(work_d, rf),
               restore_d),
        PROTO_1K * 4 + int(rf.wipe.sum()) * row, kernel="node_faults_dense",
        n=PROTO_1K))
    return rows


def compare_churn_kernels(dev, seed=9, timed=True):
    """Phase 3j: K23's full and partial entries and K11's PeerSwap view
    row against their plain versions at the churn paths' shapes, every
    trap reached."""
    g = np.random.default_rng(seed)
    rows = (compare_detect_full(dev, g, timed=timed)
            + compare_detect_partial(dev, g, timed=timed)
            + compare_node_faults_view(dev, g, timed=timed))
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


# -- phase 3k: the lane entries of the seed ensembles (B16) ------------------

#: lanes of the ensemble paths, and of the 2^31 trap
ENSEMBLE_LANES = 8
WIDE_LANES = 16
#: the lane rows a faultless ensemble launches; a fault ensemble adds
#: K10's, K9's reach and K11's lane entries
LANE_STORM_ROWS = ("threefry_lanes", "sample_targets_lanes",
                   "merge_entries_lanes", "broadcast_scatter_lanes",
                   "edge_list_lanes", "sync_masks_lanes", "sync_pull_lanes",
                   "gaps_refresh_lanes", "converge_fold_lanes",
                   "word_phases_lanes")
LANE_FAULT_ROWS = LANE_STORM_ROWS + ("broadcast_scatter_lossy_lanes",
                                     "fault_reach_lanes",
                                     "node_faults_lanes")
#: each lane row's solo row: an ensemble path launches none of these
SOLO_OF_LANE = {"sample_targets_lanes": "sample_targets",
                "merge_entries_lanes": "merge_entries",
                "broadcast_scatter_lanes": "broadcast_scatter",
                "edge_list_lanes": "edge_list",
                "broadcast_scatter_lossy_lanes": "broadcast_scatter_lossy",
                "sync_masks_lanes": "sync_masks",
                "sync_pull_lanes": "sync_pull",
                "gaps_refresh_lanes": "gaps_refresh",
                "converge_fold_lanes": "converge_fold",
                "word_phases_lanes": "word_phases",
                "node_faults_lanes": "node_faults"}
_VMAP = " (vmapped at corrosion_tpu/campaign/ensemble.py:114)"


def _lane_keys(dev, lanes, base=0):
    from corrosion_tpu_torch.sim import rng as trng

    return torch.stack([trng.prng_key(base + k, dev) for k in range(lanes)])


def _lane_row(name, source, replaces, equal, err, ms, plain_ms, nbytes,
              lanes, **extra):
    return _row(name, source, replaces + _VMAP, equal, err, ms, plain_ms,
                nbytes, kernel=name, lanes=lanes, **extra)


def _solo_trap(label, got_lane, want_solo):
    """A lane's output must be the solo entry's on that lane's inputs."""
    if not all(torch.equal(a, b) for a, b in zip(got_lane, want_solo)):
        raise AssertionError(f"lane trap: {label} differs from the solo "
                             "entry on the lane's inputs")
    print(f"lane trap {label} reached: equal to the solo entry", flush=True)


def compare_lane_draws(dev, g, lanes, n, m, timed=True):
    """K5's lane entry over a storm round's draws for K lanes: equal to
    the plain lane versions, each lane equal to K5's solo draw under its
    key (counters lane-local), two lanes apart."""
    from corrosion_tpu_torch.sim import rng

    keys = _lane_keys(dev, lanes, 1000)
    backoff = torch.as_tensor(g.integers(0, 33, (lanes, n)),
                              dtype=torch.int32, device=dev)
    per = (n + m - 1) // m

    def draws(split, randint):
        ks = split(keys, 4)
        kb, ksy, ksw = (split(ks[:, i].contiguous(), c)
                        for i, c in ((1, 3), (2, 3), (3, 11)))
        col = lambda x, i: x[:, i].contiguous()  # noqa: E731
        return [ks, kb, ksy, ksw] + [
            randint(col(kb, 0), (12, n), 0, m),
            randint(col(ksy, 0), (12, n), 0, m),
            randint(col(ksy, 2), (n,), 1, backoff + 1),
            randint(col(ksw, 0), (4, n), 0, m),
            randint(col(ksw, 2), (12, n), 0, m),
            randint(col(ksw, 4), (12, n), 0, m),
            randint(col(ksw, 5), (n, 8), 0, m),
            randint(col(ksw, 7), (n,), 0, n),
            randint(col(ksw, 9), (n,), 0, m),
            randint(col(ksw, 10), (n,), 0, per),
        ]

    got = draws(rng.split_lanes, rng.randint_lanes)
    want = draws(rng.split_lanes_plain, rng.randint_lanes_plain)
    equal, err = _equal_all(got, want)
    last = lanes - 1
    _solo_trap("threefry lanes", [got[4][last], got[6][last],
                                  rng.bits_lanes(keys, (n,))[last]],
               [rng.randint(got[1][last, 0].contiguous(), (12, n), 0, m),
                rng.randint(got[2][last, 2].contiguous(), (n,), 1,
                            backoff[last] + 1),
                rng.bits(keys[last], (n,))])
    if lanes > 1 and torch.equal(got[4][0], got[4][1]):
        raise AssertionError("K5 lanes 0 and 1 drew the same targets")
    n_draws = sum(x.numel() for x in got[4:])
    hashes = sum(x.shape[0] * x.shape[1] for x in got[:4])
    ops = n_draws * OPS_PER_RANDINT + hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    return dict(
        name="threefry_lanes", kernel="threefry_lanes", lanes=lanes,
        source="corrosion_tpu_torch/kernels/csrc/threefry.cu",
        replaces="corrosion_tpu/sim/pswim.py:92" + _VMAP,
        equal=equal, max_abs_err=err,
        ms=_timed(timed, lambda: draws(rng.split_lanes, rng.randint_lanes)),
        plain_ms=_timed(timed, lambda: draws(rng.split_lanes_plain,
                                             rng.randint_lanes_plain)),
        bound_ms=ops / rate * 1e3, bound_by="operations", ops=ops,
        int32_ops_per_s=rate,
    )


def compare_lane_tables(dev, g, lanes, n, m, f, timed=True):
    """K1's and K4's lane entries on K lanes of storm-shaped member
    tables (keys with bit 31 packed; K1's with its traps, drawing under
    each lane's key), each lane equal to the solo entry on its own
    tables."""
    from corrosion_tpu_torch.sim import pswim, rng

    t, gc, k = 40, 12, 8
    tabs = [_random_tables(g, n, m, t) for _ in range(lanes)]

    def cuda(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=dev)

    pid, pkey, psince = (cuda(np.stack([tb[i] for tb in tabs]))
                         for i in range(3))
    table = pswim._pack_tables(pid, pkey).contiguous()
    if not bool((table < 0).any()):
        raise AssertionError("K1 lane tables hold no word with bit 31 set")
    k_pid, k_pkey = (x.reshape(lanes, n, m) for x in _member_traps(
        g, pid.reshape(lanes * n, m), pkey.reshape(lanes * n, m)))
    keys = _lane_keys(dev, lanes, 2000)
    got = pswim.sample_members_lanes(k_pid, k_pkey, keys, 3)
    ref = pswim.sample_members_lanes_plain(k_pid, k_pkey, keys, 3)
    last = lanes - 1
    _solo_trap("sample_targets lanes", [got[last]],
               [pswim.sample_members(k_pid[last], k_pkey[last], keys[last],
                                     3)])
    slots = rng.randint_lanes_plain(keys, (12, n), 0, m)
    _member_trap_check(k_pid[last], k_pkey[last], slots[last], ref[last],
                       "K1 lane")
    rows = [_lane_row(
        "sample_targets_lanes",
        "corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        "corrosion_tpu/sim/pswim.py:82", bool(torch.equal(got, ref)),
        _max_abs_err(got, ref),
        _timed(timed, lambda: pswim.sample_members_lanes(k_pid, k_pkey,
                                                         keys, 3)),
        _timed(timed, lambda: pswim.sample_members_lanes_plain(
            k_pid, k_pkey, keys, 3)), 0, lanes)]
    rows[0].update(_member_bound(slots, n, m, 3, lanes))

    e = n * f * (k + 1) + n
    e_dst = g.integers(0, n, (lanes, e))
    e_id = np.where(g.random((lanes, e)) < 0.5,
                    np.stack([tabs[i][0][e_dst[i], g.integers(0, m, e)]
                              for i in range(lanes)]),
                    g.integers(0, n, (lanes, e)))
    e_id = np.where(e_id >= 0, e_id, g.integers(0, n, (lanes, e)))
    e_key = g.integers(0, 2047, (lanes, e)) * 4 + g.integers(0, 3,
                                                             (lanes, e))
    args = (pid, pkey, psince, cuda(e_dst), cuda(e_id), cuda(e_key),
            torch.as_tensor(g.random((lanes, e)) < 0.8, device=dev), t, gc)
    # as the path calls it, with the packed table
    args = (*args, table)
    got = pswim.merge_entries_lanes(*args)
    ref = pswim.merge_entries_lanes_plain(*args)
    _solo_trap("merge_entries lanes", [x[last] for x in got],
               pswim.merge_entries(*(a[last] if torch.is_tensor(a) else a
                                     for a in args)))
    _merge_traps(*pswim._fold_merge(*args[:7], table)[:2], t, gc,
                 [x.reshape(lanes * n, m) for x in ref], "lanes")
    rows.append(_lane_row(
        "merge_entries_lanes",
        "corrosion_tpu_torch/kernels/csrc/merge_entries.cu",
        "corrosion_tpu/sim/pswim.py:103",
        all(torch.equal(a, b) for a, b in zip(got, ref)),
        max(_max_abs_err(a, b) for a, b in zip(got, ref)),
        _timed(timed, lambda: pswim.merge_entries_lanes(*args)),
        _timed(timed, lambda: pswim.merge_entries_lanes_plain(*args)),
        lanes * (e * 13 + 3 * n * m * 4 * 2), lanes))
    return rows


def _lane_edges(g, dev, lanes, n, f):
    dst = torch.as_tensor(g.integers(0, n, (lanes, n * f)),
                          dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((lanes, n * f)) < 0.95, device=dev)
    return dst, ok


def compare_lane_scatter(dev, g, lanes, n, w, f, timed=True):
    """K2's and K10's lane entries: every lane's ring, edges and (K10)
    fault thresholds, key and plan seed; each lane equal to the solo
    entry under its key and seed — the counters lane-local — and, at
    WIDE_LANES, the last lane of a batch whose flattened edge × payload
    index passes 2^31."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    t = 4
    rows = []
    for lossy in (False, True):
        sending = _random_words(g, (lanes, n, w), dev, 4)
        dst, ok = _lane_edges(g, dev, lanes, n, f)
        slot = torch.full((lanes, n * f), t % 2, dtype=torch.int32,
                          device=dev)
        ring0 = _random_words(g, (lanes, 2, n, w), dev, 6)
        keys = _lane_keys(dev, lanes, 2000)
        seeds = lane_plan_seeds(range(lanes), dev)
        thr = (torch.as_tensor(np.where(g.random((lanes, n * f)) < 0.9, 38,
                                        0), dtype=torch.uint8, device=dev)
               if lossy else None)
        extra = (thr, keys, seeds)
        got, ref = ring0.clone(), ring0.clone()
        ln.scatter_lanes(got, sending, dst, slot, ok, f, *extra)
        ln.scatter_lanes_plain(ref, sending, dst, slot, ok, f, *extra)
        last = lanes - 1
        solo = ring0[last].clone()
        if lossy:
            packed.scatter_sending_lossy(
                solo, sending[last], dst[last], slot[last], ok[last],
                thr[last], keys[last], int(seeds[last]), f)
        else:
            packed.scatter_sending(solo, sending[last], dst[last],
                                   slot[last], ok[last], f)
        name = ("broadcast_scatter_lossy_lanes" if lossy
                else "broadcast_scatter_lanes")
        _solo_trap(name, [got[last]], [solo])
        work_k, work_p = ring0.clone(), ring0.clone()
        touched = int(torch.unique(
            (torch.arange(lanes, device=dev)[:, None] * n
             + dst.long())[ok]).numel())
        nbytes = (sending.numel() * 4 + lanes * n * f * 9
                  + touched * w * 4 * 2)
        row = _lane_row(
            name, "corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
            "corrosion_tpu/sim/faults.py:260" if lossy
            else "corrosion_tpu/sim/packed.py:369",
            bool(torch.equal(got, ref)), _max_abs_err(got, ref),
            _timed(timed, lambda: ln.scatter_lanes(
                work_k, sending, dst, slot, ok, f, *extra)),
            # the lossy plain version finds its draws on the host: eager
            (_time_eager_ms(lambda: ln.scatter_lanes_plain(
                work_p, sending, dst, slot, ok, f, *extra),
                reps=SLOW_PLAIN_REPS) if lossy else _time_ms(
                lambda: ln.scatter_lanes_plain(
                    work_p, sending, dst, slot, ok, f, *extra)))
            if timed else None,
            nbytes, lanes)
        if lossy:
            # one hash per (sending edge word, thr > 0): 8 words of 4 bytes
            live = int(((torch.repeat_interleave(sending, f, dim=1) != 0)
                        & ok[..., None] & (thr > 0)[..., None]).sum())
            ops = live * 8 * OPS_PER_HASH
            rate = _int32_ops_per_s()
            row.update(bound_ms=max(row["bound_ms"], ops / rate * 1e3),
                       bound_by="operations", ops=ops, int32_ops_per_s=rate)
        rows.append(row)
    # K2's edge pass on the lanes folded into their rows
    rows += compare_edge_pass(dev, g, (lanes,), n, w, f, f, timed)
    # the 2^31 trap: WIDE_LANES lanes of E = 3N edges and P = 32W payloads
    wide = WIDE_LANES
    if n == STORM_N and wide * n * f * w * 32 < 1 << 31:
        raise AssertionError("the wide K10 call stays below 2^31")
    sending = _random_words(g, (wide, n, w), dev, 4)
    dst, ok = _lane_edges(g, dev, wide, n, f)
    slot = torch.zeros((wide, n * f), dtype=torch.int32, device=dev)
    ring = torch.zeros((wide, 2, n, w), dtype=torch.int32, device=dev)
    keys = _lane_keys(dev, wide, 3000)
    seeds = lane_plan_seeds(range(wide), dev)
    thr = torch.full((wide, n * f), 38, dtype=torch.uint8, device=dev)
    ln.scatter_lanes(ring, sending, dst, slot, ok, f, thr, keys, seeds)
    solo = torch.zeros_like(ring[-1])
    packed.scatter_sending_lossy(solo, sending[-1], dst[-1], slot[-1],
                                 ok[-1], thr[-1], keys[-1], int(seeds[-1]),
                                 f)
    flat = wide * n * f * w * 32
    _solo_trap(f"{wide} lanes x {n * f} edges x {w * 32} payloads = {flat} "
               f"({'past' if flat >= 1 << 31 else 'below'} 2^31)",
               [ring[-1]], [solo])
    return rows


def compare_lane_sync(dev, g, lanes, n, w, s, timed=True):
    """K3's mask pass on the lanes' folded rows, then K3's lane entry on
    its masks (words with bit 31): lane-local peers into slot 1 of every
    lane's ring; the last lane of each equal to the solo entry."""
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, _ = _storm_cfg(n, dev)
    mask_row, (masks, miss) = compare_sync_masks(
        dev, g, cfg, (lanes, n), "sync_masks_lanes", timed, keep=True)
    mask_row.update(lanes=lanes, replaces=mask_row["replaces"] + _VMAP)
    _solo_trap("sync_masks lanes", [x[-1] for x in (masks, miss)],
               packed.sync_masks(*(x[-1] for x in mask_row.pop("inputs")),
                                 cfg))
    peers = torch.as_tensor(g.integers(0, n, (lanes, n, s)),
                            dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((lanes, n, s)) < 0.7, device=dev)
    ring0 = torch.zeros((lanes, 2, n, w), dtype=torch.int32, device=dev)
    got_r, ref_r = ring0.clone(), ring0.clone()
    got = ln.sync_pull_lanes(masks, miss, peers, ok, got_r, 1)
    ref = ln.sync_pull_lanes_plain(masks, miss, peers, ok, ref_r, 1)
    if not bool((ref_r < 0).any()):
        raise AssertionError("K3 lane inputs pulled no word with bit 31")
    solo = torch.zeros((n, w), dtype=torch.int32, device=dev)
    fr = packed.sync_pull(masks[-1], miss[-1], peers[-1], ok[-1], solo)
    _solo_trap("sync_pull lanes", [got_r[-1, 1], got[-1]], [solo, fr])
    rk, rp = ring0.clone(), ring0.clone()
    touched = sum(_grant_words(masks[k], miss[k], peers[k], ok[k])
                  for k in range(lanes))
    return [mask_row, _lane_row(
        "sync_pull_lanes", "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
        "corrosion_tpu/sim/packed.py:1138",
        bool(torch.equal(got, ref) and torch.equal(got_r, ref_r)),
        max(_max_abs_err(got_r, ref_r), _max_abs_err(got, ref)),
        _timed(timed, lambda: ln.sync_pull_lanes(masks, miss, peers, ok, rk,
                                                 1)),
        _timed(timed, lambda: ln.sync_pull_lanes_plain(masks, miss, peers,
                                                       ok, rp, 1)),
        # the mask and miss rows the sessions read, peers and ok, the slot
        # words the grants touch in and out, fruitful
        _pull_read_bytes(masks, miss, peers, ok) + lanes * (n * s * 5 + n)
        + touched * 4 * 2, lanes)]


def compare_lane_record(dev, g, lanes, n, w, timed=True):
    """K6's and K7's lane entries: per-lane overflow counts that differ
    between lanes, and K7's done flags — both values in one call, in
    both modes (rows with holes after their sticky stamps in some
    lanes)."""
    from corrosion_tpu_torch.sim import gaps
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.round import RunMetrics

    cfg, meta = _storm_cfg(n, dev)
    p = cfg.n_payloads
    rows = []
    # lanes of bit densities 1/2, 1/4, 1/8: their overflow counts differ
    have = torch.stack([_random_words(g, (n, w), dev, 1 + i % 3)
                        for i in range(lanes)])
    tight = dataclasses.replace(cfg, gap_slots=2)
    got = gaps.refresh_gaps_lanes(have, tight)
    ref = gaps.refresh_gaps_lanes_plain(have, tight)
    eq, err = _equal_all(got, ref)
    e2, r2 = _equal_all(gaps.refresh_gaps_lanes(have, cfg),
                        gaps.refresh_gaps_lanes_plain(have, cfg))
    if len(set(got[3].tolist())) < 2:
        raise AssertionError("K6 lane overflow counts do not differ")
    _solo_trap("gaps_refresh lanes", [x[-1] for x in got],
               gaps.refresh_gaps(have[-1], tight))
    a, k = cfg.n_writers, cfg.gap_slots
    rows.append(_lane_row(
        "gaps_refresh_lanes",
        "corrosion_tpu_torch/kernels/csrc/gaps_refresh.cu",
        "corrosion_tpu/sim/gaps.py:137", eq and e2, max(err, r2),
        _timed(timed, lambda: gaps.refresh_gaps_lanes(have, cfg)),
        _timed(timed, lambda: gaps.refresh_gaps_lanes_plain(have, cfg)),
        lanes * (n * w * 4 + n * a * 4 + 2 * n * a * k * 4 + 4), lanes))

    full = np.full((lanes, n, w), 0xFFFFFFFF, dtype=np.uint32)
    holes = g.random(lanes) < 0.5
    holes[0], holes[-1] = True, False
    for i in np.flatnonzero(holes):
        full[i, g.random(n) < 0.1, : w // 2] = 0
    words = torch.as_tensor(full.view(np.int32), device=dev)
    dead = torch.as_tensor((g.random((lanes, n)) < 0.05) * 2,
                           dtype=torch.uint8, device=dev)
    inj = torch.full((lanes, w), -1, dtype=torch.int32, device=dev)
    metrics = RunMetrics(
        coverage_at=torch.full((lanes, p), -1, dtype=torch.int32,
                               device=dev),
        converged_at=torch.as_tensor(
            np.where(g.random((lanes, n)) < 0.2, 3, -1), dtype=torch.int32,
            device=dev),
        overflow_frac=torch.as_tensor(
            np.where(np.arange(lanes) % 2, 0.25, 0.0), dtype=torch.float32,
            device=dev),
        order_violations=torch.zeros(lanes, dtype=torch.int32, device=dev))
    # each lane its own K6 count
    counts = torch.as_tensor(g.integers(1, n * cfg.n_writers // 3, lanes),
                             dtype=torch.int32, device=dev)
    last = int(meta.round.max())  # a loop's one read a run
    cases = []
    for t, horizon in ((20, None), (20, 21), (19, 21)):
        args = (words, inj, dead, metrics, meta, t, cfg, counts, last,
                horizon)
        cases.append((args, ln.converge_record_lanes(*args),
                      ln.converge_record_lanes_plain(*args)))
    eq, err = True, 0
    for _, got, want in cases:
        e, x = _equal_all(got, want)
        eq, err = eq and e, max(err, x)
    done = cases[0][1][3].tolist()
    if len(set(done)) < 2 or len(set(cases[1][1][3].tolist())) < 2 or any(
            cases[2][1][3].tolist()):
        raise AssertionError("K7 lane flags miss a value in a mode")
    if len(set(cases[0][1][2].tolist())) < 2:
        raise AssertionError("K7 lane overflow fractions take one value")
    _solo_trap("converge_fold lanes", [x[-1] for x in cases[1][1]],
               packed.converge_record(
                   words[-1], inj[-1], dead[-1],
                   RunMetrics(*(x[-1] for x in metrics)), meta, 20, cfg,
                   counts[-1], last, 21))
    # gapstress's W = 256 (a block a node) and the one-word path, 3 lanes
    for cfg_, n_, w_ in ((_gapstress(GAPSTRESS_N, dev)[0], GAPSTRESS_N, 256),
                         (dataclasses.replace(cfg, n_payloads=192), 1000, 6)):
        cfg_ = dataclasses.replace(cfg_, n_nodes=n_)
        for have, inj_, alive, m, t, count, horizon in _record_cases(
                g, dev, n_, w_, cfg_)[1:4]:
            args = (torch.stack([have] * 3), torch.stack([inj_] * 3),
                    torch.stack([alive] * 3),
                    RunMetrics(*(torch.stack([x] * 3) for x in m)), meta, t,
                    cfg_, torch.stack([count, count + 1, count * 0]),
                    last, horizon)
            e, x = _equal_all(ln.converge_record_lanes(*args),
                              ln.converge_record_lanes_plain(*args))
            eq, err = eq and e, max(err, x)
    print(f"lane trap converge_fold lanes reached: done {done}", flush=True)
    args = cases[0][0]
    rows.append(_lane_row(
        "converge_fold_lanes",
        "corrosion_tpu_torch/kernels/csrc/converge_fold.cu",
        "corrosion_tpu/sim/packed.py:871", eq, err,
        _timed(timed, lambda: ln.converge_record_lanes(*args)),
        _timed(timed, lambda: ln.converge_record_lanes_plain(*args)),
        lanes * (n * w * 4 + w * 4 + n + n * 4 * 2 + p * 4 * 2 + 4 * 3 + 1),
        lanes))
    return rows


def compare_lane_words(dev, g, lanes, n, w, f, timed=True):
    """K8's three lane entries on K lanes of a mid-storm carry, in round
    order, with dead rows and self targets."""
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _storm_cfg(n, dev)
    t = 4

    def words(shape, ands=1):
        return _random_words(g, shape, dev, ands)

    flat0 = [words((lanes, n, w)), words((lanes, 2, n, w), 5),
             *(words((lanes, n, w), 2) for _ in range(4)),
             words((lanes, 2, n, w), 6), words((lanes, w), 2)]
    me = np.arange(n)[None, :, None]
    tg = np.where(g.random((lanes, n, f)) < 0.05, -1,
                  g.integers(0, n, (lanes, n, f)))
    targets = torch.as_tensor(
        np.where(g.random((lanes, n, f)) < 0.02, me, tg), dtype=torch.int32,
        device=dev)
    alive = torch.as_tensor((g.random((lanes, n)) < 0.05) * 2,
                            dtype=torch.uint8, device=dev)

    def carry_of(xs):
        return packed.PackedCarry(have=xs[0], inflight=xs[1],
                                  relay=packed.Planes(*xs[2:6]),
                                  sync_buf=xs[6]), xs[7]

    def phases(inject, spend, deliver, xs):
        c, inj = carry_of(xs)
        inject(c, inj, t, meta, cfg, alive)
        sending = spend(c, inj, targets, alive)
        deliver(c, t, cfg)
        return sending

    kern = (ln.inject_lanes, ln.spend_lanes, ln.deliver_lanes)
    plain = (ln.inject_lanes_plain, ln.spend_lanes_plain,
             ln.deliver_lanes_plain)
    outs = []
    for ph in (kern, plain):
        xs = [x.clone() for x in flat0]
        outs.append([phases(*ph, xs), *xs])
    equal, err = _equal_all(outs[0], outs[1])
    xs = [x[-1].clone() for x in flat0]
    c, inj = carry_of(xs)
    packed.inject_packed(c, inj, t, meta, cfg, alive[-1])
    sending = packed.spend_relay(c, inj, targets[-1], alive[-1])
    packed.deliver_packed(c, t, cfg)
    _solo_trap("word_phases lanes", [x[-1] for x in outs[0]],
               [sending, *xs])
    work = [x.clone() for x in flat0]

    def restore():
        for dst, src in zip(work, flat0):
            dst.copy_(src)

    p = cfg.n_payloads
    nbytes = lanes * (p * 9 + w * 4 * 2 + n * w * 4 * 6 + n * f * 4 + n
                      + 4 * 2 * n * w * 4 + 2 * n * w * 4)
    return [_lane_row(
        "word_phases_lanes", "corrosion_tpu_torch/kernels/csrc/word_phases.cu",
        "corrosion_tpu/sim/packed.py:631", equal, err,
        _time_inplace_ms(lambda: phases(*kern, work), restore)
        if timed else None,
        _time_inplace_ms(lambda: phases(*plain, work), restore)
        if timed else None,
        nbytes, lanes)]


def compare_lane_faults(dev, g, lanes, n, w, f, timed=True):
    """K9's reach lane entry on the fault storm's round 5 (cuts and loss
    on) with per-lane keys and plan seeds, each lane equal to the solo
    entry under its key and seed; K11's lane entry on the wipe round 20
    over K lanes of tables and carry."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    e = n * f
    src = torch.as_tensor(g.integers(0, n, (lanes, e)), dtype=torch.int32,
                          device=dev)
    dst = torch.as_tensor(g.integers(0, n, (lanes, e)), dtype=torch.int32,
                          device=dev)
    dst = torch.where(torch.as_tensor(g.random((lanes, e)) < 0.05,
                                      device=dev), src, dst).contiguous()
    ok0 = torch.as_tensor(g.random((lanes, e)) < 0.9, device=dev)
    keys = _lane_keys(dev, lanes, 4000)
    seeds = lane_plan_seeds(range(lanes), dev)
    got = faults.fault_reach_lanes_(ok0.clone(), rf, keys, src, dst, seeds)
    ref = faults.fault_reach_lanes_plain(ok0.clone(), rf, keys, src, dst,
                                         seeds)
    solo = faults.fault_reach_(ok0[-1].clone(),
                               rf._replace(seed=int(seeds[-1])), keys[-1],
                               src[-1], dst[-1])
    _solo_trap("fault_reach lanes", [got[-1]], [solo])
    wk, wp = ok0.clone(), ok0.clone()

    def rk():
        wk.copy_(ok0)
        faults.fault_reach_lanes_(wk, rf, keys, src, dst, seeds)

    def rp():
        wp.copy_(ok0)
        faults.fault_reach_lanes_plain(wp, rf, keys, src, dst, seeds)

    rows = [_lane_row(
        "fault_reach_lanes", "corrosion_tpu_torch/kernels/csrc/fault_edges.cu",
        "corrosion_tpu/sim/swim.py:161", bool(torch.equal(got, ref)),
        _max_abs_err(got, ref), _timed(timed, rk), _timed(timed, rp),
        lanes * e * (4 + 4 + 1 + 1), lanes)]

    rf20 = faults.round_faults(fplan, 20)
    if not bool(rf20.wipe.any()):
        raise AssertionError("K11 lane inputs wipe no row")
    m, a, k = 64, cfg.n_writers, cfg.gap_slots
    tabs = [_random_tables(g, n, m, 20) for _ in range(lanes)]
    slim0 = SimpleNamespace(
        alive=torch.zeros((lanes, n), dtype=torch.uint8, device=dev),
        heads=torch.as_tensor(g.integers(0, 9, (lanes, n, a)),
                              dtype=torch.int32, device=dev),
        gap_lo=torch.as_tensor(g.integers(0, 9, (lanes, n, a, k)),
                               dtype=torch.int32, device=dev),
        gap_hi=torch.as_tensor(g.integers(0, 9, (lanes, n, a, k)),
                               dtype=torch.int32, device=dev),
        pid=torch.as_tensor(np.stack([tb[0] for tb in tabs]),
                            dtype=torch.int32, device=dev),
        pkey=torch.as_tensor(np.stack([tb[1] for tb in tabs]),
                             dtype=torch.int32, device=dev),
        psince=torch.as_tensor(np.stack([tb[2] for tb in tabs]),
                               dtype=torch.int32, device=dev),
        pview=torch.zeros((lanes, n, 0), dtype=torch.int32, device=dev))
    names = ("alive", "heads", "gap_lo", "gap_hi", "pid", "pkey", "psince",
             "pview")
    carry0 = [_random_words(g, (lanes, n, w), dev) for _ in range(5)] + [
        _random_words(g, (lanes, 2, n, w), dev) for _ in range(2)]

    # no full view: its tables are empty
    no_view = dict(view=torch.zeros((lanes, 0, 0), dtype=torch.int8,
                                    device=dev),
                   vinc=torch.zeros((lanes, 0, 0), dtype=torch.int32,
                                    device=dev),
                   suspect_since=torch.zeros((lanes, 0, 0),
                                             dtype=torch.int32, device=dev))

    def state_of(xs, ys):
        slim = SimpleNamespace(**dict(zip(names, xs)), **no_view)
        carry = packed.PackedCarry(have=ys[0], inflight=ys[5],
                                   relay=packed.Planes(*ys[1:5]),
                                   sync_buf=ys[6])
        return slim, carry

    outs = []
    for fn in (ln.apply_round_faults_lanes, ln.apply_round_faults_lanes_plain):
        xs = [getattr(slim0, nm).clone() for nm in names]
        ys = [y.clone() for y in carry0]
        fn(*state_of(xs, ys), rf20)
        outs.append(xs[:-1] + ys)  # pview is empty: no PeerSwap
    equal, err = _equal_all(outs[0], outs[1])
    victim = int(rf20.wipe.nonzero()[0])
    if not all(bool((outs[0][i][:, victim] == -1).all()) for i in (4, 5, 6)):
        raise AssertionError("K11 lanes left a wiped table row")
    print("lane trap node_faults lanes reached: the wipe in every lane",
          flush=True)
    xs = [getattr(slim0, nm).clone() for nm in names]
    ys = [y.clone() for y in carry0]
    flat0 = xs + ys
    work = [x.clone() for x in flat0]

    def restore():
        for d, s_ in zip(work, flat0):
            d.copy_(s_)

    wiped = int(rf20.wipe.sum())
    nbytes = lanes * (n * 2 + wiped * (5 * w * 4 + 2 * 2 * w * 4
                                       + (a + 2 * a * k + 3 * m) * 4))
    rows.append(_lane_row(
        "node_faults_lanes", "corrosion_tpu_torch/kernels/csrc/node_faults.cu",
        "corrosion_tpu/sim/faults.py:703", equal, err,
        _time_inplace_ms(lambda: ln.apply_round_faults_lanes(
            *state_of(work[:8], work[8:]), rf20), restore)
        if timed else None,
        _time_inplace_ms(lambda: ln.apply_round_faults_lanes_plain(
            *state_of(work[:8], work[8:]), rf20), restore)
        if timed else None,
        nbytes, lanes))
    return rows


def compare_lane_kernels(dev, seed=10, lanes=ENSEMBLE_LANES, n=STORM_N,
                         timed=True):
    """Phase 3k: every lane entry against its plain version at the
    8-lane storm's shapes (K = 8 lanes of N = 100000, M = 64, W = 16,
    F = S = 3; the fault storm's plan), each lane held to the solo entry
    on its inputs; K10 also at 16 lanes, past 2^31 flattened."""
    g = np.random.default_rng(seed)
    m, w, f, s = 64, 16, 3, 3
    rows = [compare_lane_draws(dev, g, lanes, n, m, timed)]
    rows += compare_lane_tables(dev, g, lanes, n, m, f, timed)
    rows += compare_lane_scatter(dev, g, lanes, n, w, f, timed)
    rows += compare_lane_sync(dev, g, lanes, n, w, s, timed)
    rows += compare_lane_record(dev, g, lanes, n, w, timed)
    rows += compare_lane_words(dev, g, lanes, n, w, f, timed)
    rows += compare_lane_faults(dev, g, lanes, n, w, f, timed)
    for row in rows:
        row.setdefault("bound_by", "bytes")
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


def _keep_finals(ensemble):
    """Wrap `campaign.ensemble.run_seed_ensemble` so the engine's cell
    keeps its lanes' final states: returns (the wrapper's store, a
    restore function)."""
    kept = {}
    orig = ensemble.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["finals"] = out[0]
        return out

    ensemble.run_seed_ensemble = keeping

    def restore():
        ensemble.run_seed_ensemble = orig

    return kept, restore


def _ensemble_lanes_check(finals, artifact, golden, label):
    """Every lane's rounds, p99 and final-state digest, and the
    artifact's spec_hash and result_digest, against the goldens."""
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest

    cell = artifact["cells"][0]
    got = {"spec_hash": artifact["spec_hash"],
           "result_digest": artifact["result_digest"],
           "lanes": [{"seed": s,
                      "rounds": cell["per_seed"]["rounds"][i],
                      "p99_node_convergence_round":
                          cell["per_seed"]["p99_node_convergence_round"][i],
                      "digest": state_digest(lane_state(finals, i))}
                     for i, s in enumerate(cell["seeds"])]}
    print(f"{label}: {json.dumps(got)} wall_clock_s="
          f"{cell['wall_clock_s']} wall_verdict={cell['wall_verdict']}",
          flush=True)
    if got != golden:
        raise AssertionError(f"{label}: differs from its golden")
    if not cell["all_converged"]:
        raise AssertionError(f"{label}: a lane did not converge")


def _solo_walls(cfg, meta, seeds, dev, plan=None):
    """The solo runs of ``seeds`` on the card (`run_to_convergence`, or
    `run_fault_plan` under ``plan`` re-seeded per seed): their final
    states and host walls, each between synchronizations."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.topology import Topology

    out = []
    for s in seeds:
        fplan = (None if plan is None else compile_plan(
            dataclasses.replace(plan, seed=int(s)), cfg, device=dev))
        state = new_sim(cfg, int(s), dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if fplan is None:
            final, _ = run_to_convergence(state, meta, cfg, Topology(), 3000)
        else:
            final, _ = run_fault_plan(state, meta, cfg, Topology(), fplan,
                                      3000)
        torch.cuda.synchronize()
        out.append((final, time.monotonic() - t0))
    return out


def ensemble_paths(dev, goldens):
    """Paths 33-35: storm-100k-seeds8 and fault-storm-100k-seeds8 through
    `campaign.engine.run_campaign` from zeroed counters, each lane and
    the artifact against its golden, every lane row launched and no solo
    entry of a kernel that has one; the ensemble's wall against its 8
    solo walls (each solo run equal to its lane on the card); then
    fault-storm-100k-lanes16, lanes 0-7 equal, tensor for tensor, to
    fault-storm-100k-seeds8's lanes on the card (held to its golden
    above) and lanes 8-15 each to the port's solo run of its seed.
    Returns the lane rows' launches per path and the printed numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign import ensemble
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.spec import storm_seeds_spec
    from corrosion_tpu_torch.sim.state import uniform_payloads

    launches, numbers = {}, {}
    for faults, golden, label in (
            (False, goldens.STORM_100K_SEEDS8, "storm_100k_seeds8"),
            (True, goldens.FAULT_STORM_100K_SEEDS8,
             "fault_storm_100k_seeds8")):
        spec = storm_seeds_spec(range(ENSEMBLE_LANES), faults=faults)
        kept, restore = _keep_finals(ensemble)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        try:
            art = run_campaign(spec, device=dev)
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated()
        rows = LANE_FAULT_ROWS if faults else LANE_STORM_ROWS
        counts = _path_launches(kernels, rows, label)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        _ensemble_lanes_check(kept["finals"], art, golden, label)
        cfg, topo = spec.sim_config({}), spec.topo({})
        meta = uniform_payloads(cfg, dev, inject_every=2)
        plan = spec.fault_plan({}, seed=0)
        solos = _solo_walls(cfg, meta, spec.seeds, dev, plan)
        # each solo run against its lane on the card (the lanes' digests
        # are the golden's, above)
        for k, ((final, _), lane) in enumerate(zip(solos, golden["lanes"])):
            if not _same_state(final, ensemble.lane_state(kept["finals"],
                                                          k)):
                raise AssertionError(f"{label}: solo run of seed "
                                     f"{lane['seed']} differs from its lane")
        if faults:
            fault8 = kept["finals"]  # the 16-lane path's lanes 0-7
        del kept
        wall = art["cells"][0]["wall_clock_s"]
        solo_sum = sum(w for _, w in solos)
        numbers[label] = {"ensemble_wall_s": wall,
                          "solo_walls_s": [w for _, w in solos],
                          "solo_walls_sum_s": solo_sum,
                          "max_memory_allocated_bytes": peak}
        print(f"{label}: ensemble wall {wall} s against the {len(solos)} "
              f"solo walls' sum {solo_sum:.4f} s; max_memory_allocated "
              f"{peak} bytes", flush=True)
        _lap(label)

    # the 2^31 path: 16 lanes of the fault storm, each against its solo run
    spec = storm_seeds_spec(range(WIDE_LANES), faults=True)
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, dev, inject_every=2)
    plan = spec.fault_plan({}, seed=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # the 8-lane run's finals
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    finals, _ = ensemble.run_seed_ensemble(plan, cfg, topo, meta, spec.seeds,
                                           max_rounds=3000, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches["fault_storm_100k_lanes16"] = _path_launches(
        kernels, LANE_FAULT_ROWS, "fault_storm_100k_lanes16")
    # lanes 0-7 against the 8-lane run's lanes on the card, whose digests
    # are the golden's (path 34)
    same8 = all(_same_state(ensemble.lane_state(finals, i),
                            ensemble.lane_state(fault8, i))
                for i in range(ENSEMBLE_LANES))
    del fault8
    rounds = finals.t.tolist()
    solos = _solo_walls(cfg, meta, spec.seeds[ENSEMBLE_LANES:], dev, plan)
    print(f"fault_storm_100k_lanes16: rounds {rounds}, lanes "
          f"0-{ENSEMBLE_LANES - 1} equal to the 8-lane run's: {same8}; wall "
          f"{wall:.4f} s (solo sum of seeds {ENSEMBLE_LANES}-"
          f"{WIDE_LANES - 1} {sum(w for _, w in solos):.4f} s) "
          f"max_memory_allocated {peak} bytes beyond the {held} held",
          flush=True)
    if not same8:
        raise AssertionError("fault_storm_100k_lanes16: lanes 0-7 differ "
                             "from the 8-lane run's")
    for k, (final, _) in enumerate(solos, ENSEMBLE_LANES):
        if not _same_state(final, ensemble.lane_state(finals, k)):
            raise AssertionError(f"fault_storm_100k_lanes16: lane {k} "
                                 "differs from its solo run")
    del finals
    numbers["fault_storm_100k_lanes16"] = {
        "ensemble_wall_s": wall, "max_memory_allocated_bytes": peak,
        "solo_walls_sum_s_seeds_8_15": sum(w for _, w in solos)}
    _lap("fault_storm_100k_lanes16")
    return launches, numbers


def lane_one_check(dev):
    """K = 1 is the solo path: one lane of the storm from zeroed counters
    gives the solo run's digest and launches each lane entry as often as
    the solo run launches its solo entry."""
    from corrosion_tpu_torch import goldens, kernels
    from corrosion_tpu_torch.campaign.ensemble import lane_state, seed_states
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim.lanes import run_lanes
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import _write_storm
    from corrosion_tpu_torch.sim.topology import Topology

    cfg, meta = _write_storm(STORM_N, 512, dev)
    state = new_sim(cfg, 0, dev)
    kernels.reset_launch_counts()
    run_to_convergence(state, meta, cfg, Topology(), 3000)
    solo = {row: sum(k.launches for k in kernels.PORTED[row])
            for row in kernels.PORTED}
    states = seed_states(cfg, [0], dev)
    kernels.reset_launch_counts()
    finals, _ = run_lanes(states, meta, cfg, Topology(), 3000)
    lane = {row: sum(k.launches for k in kernels.PORTED[row])
            for row in kernels.PORTED}
    digest = state_digest(lane_state(finals, 0))
    pairs = {r: (lane[r], solo[SOLO_OF_LANE.get(r, "threefry")])
             for r in LANE_STORM_ROWS}
    print("lane_one: " + json.dumps({"digest": digest, "launches": pairs}),
          flush=True)
    if digest != goldens.STORM_100K_SEED0["digest"]:
        raise AssertionError("one lane differs from the solo storm")
    if any(a != b for a, b in pairs.values()):
        raise AssertionError("one lane launches differ from the solo path's")


def profile_ensemble(dev, lanes=ENSEMBLE_LANES, rounds=3, faults=False):
    """The first ``rounds`` rounds of the K-lane storm (or fault storm)
    through `sim.lanes.run_lanes`: device ms, launches and idle share a
    round, as `profile_storm` gives them for the solo round."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_plan_seeds, seed_states)
    from corrosion_tpu_torch.sim.faults import compile_plan
    from corrosion_tpu_torch.sim.lanes import run_lanes
    from corrosion_tpu_torch.sim.runner import _write_storm, storm_fault_plan
    from corrosion_tpu_torch.sim.topology import Topology

    cfg, meta = _write_storm(STORM_N, 512, dev)
    fplan = (compile_plan(storm_fault_plan(STORM_N, 0), cfg, device=dev)
             if faults else None)
    seeds = lane_plan_seeds(range(lanes), dev) if faults else None

    def setup():
        return seed_states(cfg, range(lanes), dev)

    def run(states):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run_lanes(states, meta, cfg, Topology(), rounds, fplan, seeds)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = f"{'fault storm' if faults else 'storm'}-100k x{lanes} lanes"
    return _profile(run, rounds, label, setup=setup)


#: the kernels redesigned for the card as the profiler names them (K4
#: and K6; K1 with the draws it took from K5's randint, K3 and its mask
#: pass), whose in-path ms the storm profiles print
REDESIGNED_SYMBOLS = ("merge_scatter_kernel", "merge_apply_kernel",
                      "gaps_refresh_kernel", "gaps_refresh_wide_kernel",
                      "sample_targets_kernel", "randint_kernel",
                      "sync_masks_kernel", "sync_pull_kernel",
                      "converge_record_kernel", "broadcast_rows_kernel",
                      "edge_list_kernel")


def in_path_ms(prof):
    """The redesigned kernels' device ms a round in a `_profile` result,
    by kernel symbol (the symbols the run launched)."""
    got = prof["port_kernel_ms_per_round"]
    return {sym: got[sym] for sym in REDESIGNED_SYMBOLS if sym in got}


# -- the dense round's lanes (phase 3l, paths 36-40) ------------------------

#: the dense lane rows each kind of dense ensemble launches
DENSE_LANE_CORE = ("threefry_lanes", "dense_phases_lanes", "dense_sync_lanes",
                   "dense_gaps_lanes")
DENSE_LANE_ROWS = {
    "ground": DENSE_LANE_CORE + ("sample_uniform_lanes",),
    "full": DENSE_LANE_CORE + ("sample_uniform_lanes", "swim_full_lanes",
                               "detect_full_lanes"),
    "partial": DENSE_LANE_CORE + ("sample_targets_lanes",
                                  "merge_entries_lanes",
                                  "detect_partial_lanes"),
}
SOLO_OF_LANE.update({"dense_phases_lanes": "dense_phases",
                     "dense_sync_lanes": "dense_sync",
                     "dense_gaps_lanes": "dense_gaps",
                     "swim_full_lanes": "swim_full",
                     "sample_uniform_lanes": "sample_uniform",
                     "detect_full_lanes": "detect_full",
                     "detect_partial_lanes": "detect_partial"})
_VMAP_DENSE = " (vmapped at corrosion_tpu/campaign/ensemble.py:114, :187)"
_CSRC = "corrosion_tpu_torch/kernels/csrc/"


def _dense_lane_row(name, kernel, source, replaces, equal, err, ms, plain_ms,
                    nbytes, lanes, **extra):
    return _row(name, _CSRC + source, replaces + _VMAP_DENSE, equal, err, ms,
                plain_ms, nbytes, kernel=kernel, lanes=lanes, **extra)


def _stack(xs):
    return torch.stack(list(xs)).contiguous()


def _broadcast_cfg(dev, n=1000, p=256):
    """broadcast-1k-seeds8's config (the default byte budgets) and
    payloads, or the churn paths' (``p`` 1: one writer, one payload)."""
    from corrosion_tpu_torch.campaign.spec import broadcast_seeds_spec
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    if p == 1:
        cfg = SimConfig.wan_tuned(n, n_payloads=1, swim_partial_view=True,
                                  probe_period_rounds=1)
        return cfg, uniform_payloads(cfg, dev, inject_every=1)
    cfg = dataclasses.replace(broadcast_seeds_spec().sim_config({}),
                              n_nodes=n)
    return cfg, uniform_payloads(cfg, dev, inject_every=2)


def _lane_round_inputs(g, dev, cfg, meta, t, lanes):
    """K lanes of `_dense_round_inputs` and of targets with self and -1
    slots, stacked: (xs, targets, dst, slot, ok, keys)."""
    from corrosion_tpu_torch.sim.topology import edge_alive

    n, f, d = cfg.n_nodes, cfg.fanout, cfg.n_delay_slots
    xs, tgts, dsts, oks = [], [], [], []
    for _ in range(lanes):
        have, relay, injected, ring, sync_ring, alive, group = \
            _dense_round_inputs(g, dev, cfg, meta, t)
        xs.append([have, relay, injected, ring, sync_ring, alive])
        me = np.arange(n)[:, None]
        tg = np.where(g.random((n, f)) < 0.05, -1, g.integers(0, n, (n, f)))
        targets = torch.as_tensor(np.where(g.random((n, f)) < 0.02, me, tg),
                                  dtype=torch.int32, device=dev)
        src = torch.arange(n, dtype=torch.int32,
                           device=dev).repeat_interleave(f)
        dst = torch.clamp(targets.reshape(-1), min=0)
        ok = (targets.reshape(-1) >= 0) & edge_alive(group, alive, src, dst)
        tgts.append(targets)
        dsts.append(dst)
        oks.append(ok & (dst != src))
    xs = [_stack(col) for col in zip(*xs)]
    slot = torch.full((lanes, n * f), t % d, dtype=torch.int32, device=dev)
    return (xs, _stack(tgts), _stack(dsts), slot, _stack(oks),
            _lane_keys(dev, lanes, 4000))


def _lane_round(dl, xs, meta, cfg, targets, dst, slot, ok, keys, budget,
                thr, t, kernel=True):
    """One round's K12 lane entries on ``xs`` in place: the wrappers, or
    the plain lane versions."""
    have, relay, injected, ring, sync_ring, alive = xs
    inj = dl.inject_dense_lanes if kernel else dl.inject_dense_lanes_plain
    send = (dl.broadcast_send_lanes if kernel
            else dl.broadcast_send_lanes_plain)
    dlv = dl.deliver_dense_lanes if kernel else dl.deliver_dense_lanes_plain
    inj(have, relay, injected, meta, alive, t, cfg.max_transmissions)
    send(have, relay, injected, meta.nbytes, budget, targets, dst, slot, ok,
         alive, keys, thr, ring)
    dlv(ring, sync_ring, have, relay, t % ring.shape[1],
        max(cfg.max_transmissions - 1, 1))


def compare_lane_dense_phases(dev, g, lanes, n=1000, p=256, timed=True):
    """K12's lane entries (inject, broadcast, deliver) over a round at
    broadcast-1k-seeds8's shapes (N = 1000, P = 256, F = 3, D = 4, the
    default budgets) or the churn paths' (P = 1): the path's case, and
    (at P = 256) a trap with a binding byte budget and a loss threshold
    of 51 under each lane's own key; the last lane held to the solo
    entries on its inputs."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import dense_lanes as dl

    cfg, meta = _broadcast_cfg(dev, n, p)
    t = 20 if p > 1 else 0
    xs, targets, dst, slot, ok, keys = _lane_round_inputs(g, dev, cfg, meta,
                                                          t, lanes)
    cases = [("path", cfg.rate_limit_bytes_round, 0)]
    budget_trap = 20 * 8192 + 4096
    if p > 1:
        cases.append(("trap", budget_trap, 51))
    equal, err, runs = True, 0, {}
    for label, budget, thr in cases:
        outs = []
        for kernel in (True, False):
            ys = [x.clone() for x in xs]
            _lane_round(dl, ys, meta, cfg, targets, dst, slot, ok, keys,
                        budget, thr, t, kernel)
            outs.append(ys)
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        runs[label] = outs[0]
        last = lanes - 1
        solo = [x[last].clone() for x in xs]
        _dense_round_phases(bc, solo, meta, cfg, targets[last], dst[last],
                            slot[last], ok[last], keys[last], budget, thr, t)
        _solo_trap(f"dense_phases lanes {label} N={n} P={p}",
                   [x[last] for x in outs[0]], solo)
    if p > 1:
        have, relay, injected = xs[:3]
        eligible = (have > 0) & (relay > 0) & (injected > 0)[:, None, :]
        if int(eligible.sum(dim=2).max()) * 8192 <= budget_trap:
            raise AssertionError("K12 lane inputs: the budget never binds")
        if int(eligible.sum(dim=2).max()) * 8192 > cfg.rate_limit_bytes_round:
            raise AssertionError("K12 lane inputs: the default budget binds")
    work = [x.clone() for x in xs]

    def restore():
        for dst_, src_ in zip(work, xs):
            dst_.copy_(src_)

    def round_(kernel):
        return lambda: _lane_round(dl, work, meta, cfg, targets, dst, slot,
                                   ok, keys, cfg.rate_limit_bytes_round, 0,
                                   t, kernel)

    nbytes = (_nbytes(*xs[:3], xs[5], targets, dst, slot, ok, meta.nbytes,
                      meta.round, meta.actor)
              + 2 * lanes * n * p  # the two ring slots deliver reads
              + _changed_bytes(xs[:5], runs["path"][:5]))
    tag = "" if p > 1 else f"_{n // 1000}k"
    return _dense_lane_row(
        "dense_phases_lanes" + tag, "dense_phases_lanes", "dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:32", equal, err,
        _timed(timed, round_(True), restore),
        _timed(timed, round_(False), restore), nbytes, lanes, n=n, p=p)


def _lane_advertised(g, dev, cfg, lanes):
    """K lanes of held rows and their advertised heads and gap slots."""
    have = _u8(g, (lanes, cfg.n_nodes, cfg.n_payloads), 0.5, dev)
    adv = [_advertised(g, dev, cfg, have[k], 40) for k in range(lanes)]
    heads, lo, hi = (_stack(a[i] for a in adv) for i in range(3))
    return have, heads, lo, hi, sum(a[3] for a in adv)


def compare_lane_dense_sync(dev, g, lanes, n=1000, p=256, timed=True):
    """K13's lane entry at broadcast-1k-seeds8's shapes (N = 1000, P =
    256, A = 8, V = 32, K = 8, S = 3, D = 4) under the default sync
    budget and under a binding one, or at the churn paths' (P = 1);
    gaps past K, self and dead peers; the last lane held to the solo
    entry."""
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import sync

    cfg, meta = _broadcast_cfg(dev, n, p)
    s, d = cfg.sync_peers, cfg.n_delay_slots
    have, heads, lo, hi, n_over = _lane_advertised(g, dev, cfg, lanes)
    if p > 1 and n_over == 0:
        raise AssertionError("K13 lane inputs: no row past K gap runs")
    me = np.arange(n)[None, :, None]
    peers = np.where(g.random((lanes, n, s)) < 0.03, me,
                     g.integers(0, n, (lanes, n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((lanes, n, s)) < 0.7, device=dev) & (
        peers != torch.arange(n, device=dev)[None, :, None])
    ring0 = _u8(g, (lanes, d, n, p), 0.01, dev)
    slot = 3 % d
    budget_trap = 6 * 8192 + 100
    budgets = [cfg.sync_budget_bytes] + ([budget_trap] if p > 1 else [])
    equal, err, outs = True, 0, {}
    for budget in budgets:
        got_r, want_r = ring0.clone(), ring0.clone()
        args = (have, heads, lo, hi, peers, ok, meta.nbytes, budget)
        got = dl.sync_pull_dense_lanes(*args, got_r, cfg, slot)
        want = dl.sync_pull_dense_lanes_plain(*args, want_r, cfg, slot)
        e, x = _equal_all([got, got_r], [want, want_r])
        equal, err = equal and e, max(err, x)
        outs[budget] = want_r
        last = lanes - 1
        solo_r = ring0[last, slot].clone()
        solo = sync.sync_pull_dense(have[last], heads[last], lo[last],
                                    hi[last], peers[last], ok[last],
                                    meta.nbytes, budget, solo_r, cfg)
        _solo_trap(f"dense_sync lanes budget={budget} N={n} P={p}",
                   [got[last], got_r[last, slot]], [solo, solo_r])
    if p > 1 and torch.equal(outs[cfg.sync_budget_bytes], outs[budget_trap]):
        raise AssertionError("K13 lane inputs: the sync budget never binds")
    work = ring0.clone()

    def restore():
        work.copy_(ring0)

    args = (have, heads, lo, hi, peers, ok, meta.nbytes,
            cfg.sync_budget_bytes)
    nbytes = (_nbytes(have, heads, lo, hi, peers, ok, meta.nbytes)
              + _changed_bytes([ring0], [outs[cfg.sync_budget_bytes]])
              + lanes * n)
    tag = "" if p > 1 else f"_{n // 1000}k"
    return _dense_lane_row(
        "dense_sync_lanes" + tag, "dense_sync_lanes", "dense_sync.cu",
        "corrosion_tpu/sim/sync.py:122", equal, err,
        _timed(timed, lambda: dl.sync_pull_dense_lanes(*args, work, cfg,
                                                       slot), restore),
        _timed(timed, lambda: dl.sync_pull_dense_lanes_plain(
            *args, work, cfg, slot), restore),
        nbytes, lanes, n=n, p=p)


def compare_lane_dense_gaps(dev, g, lanes, n=1000, p=256, timed=True):
    """K14's lane entries at broadcast-1k-seeds8's shapes (A = 8, V = 32,
    K = 8) or the churn paths' (P = 1): lanes in three states at one
    round — holes past K (not done), every cell held (done), one up cell
    short (not done) — so the done flags differ by lane; the last lane
    held to the solo entries."""
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim.round import RunMetrics, dense_record

    cfg, meta = _broadcast_cfg(dev, n, p)
    cases = _dense_record_cases(g, dev, cfg, meta)
    t = cases[1][5]
    picks = [cases[k % 3] for k in range(lanes)]
    have = _stack(c[0] for c in picks)
    injected = _stack(c[1] for c in picks)
    alive = _stack(c[2] for c in picks)
    metrics = RunMetrics(*(_stack(getattr(c[3], f) for c in picks)
                           for f in RunMetrics._fields))
    args = (have, injected, alive, metrics, meta, t, cfg)
    got, want = dl.dense_record_lanes(*args), dl.dense_record_lanes_plain(*args)
    equal, err = _equal_all(got, want)
    dones = want[6].tolist()
    if len(set(dones)) < 2:
        raise AssertionError(f"K14 lane inputs: done flags {dones} all equal")
    if p > 1 and int(want[3][0]) == 0:
        raise AssertionError("K14 lane inputs overflow no row")
    last = lanes - 1
    _solo_trap(f"dense_gaps lanes N={n} P={p} dones={dones}",
               [x[last] for x in got],
               dense_record(have[last], injected[last], alive[last],
                            RunMetrics(*(x[last] for x in metrics)), meta, t,
                            cfg))
    a, k = cfg.n_writers, cfg.gap_slots
    nbytes = lanes * (n * p + p + n + p * 4 + n * 4 * 2 + p * 4 * 2
                      + n * a * 4 * (1 + 2 * k) + 4 + 1)
    tag = "" if p > 1 else f"_{n // 1000}k"
    return _dense_lane_row(
        "dense_gaps_lanes" + tag, "dense_gaps_lanes", "dense_gaps.cu",
        "corrosion_tpu/sim/gaps.py:64", equal, err,
        _timed(timed, lambda: dl.dense_record_lanes(*args)),
        _timed(timed, lambda: dl.dense_record_lanes_plain(*args)),
        nbytes, lanes, n=n, p=p, dones=dones)


def _lane_swim_inputs(g, dev, lanes, n, f, t):
    """K lanes of `compare_swim_full`'s inputs, stacked: (base, args)."""
    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    view = torch.as_tensor(g.choice(3, (lanes, n, n), p=[0.8, 0.1, 0.1]),
                           dtype=torch.int8, device=dev)
    vinc = i32(g.integers(0, 6, (lanes, n, n)))
    since = i32(np.where(g.random((lanes, n, n)) < 0.5,
                         g.integers(0, t + 1, (lanes, n, n)), -1))
    inc = i32(g.integers(0, 6, (lanes, n)))
    gdst = i32(g.integers(0, n, (lanes, n * f)))
    g_ok = torch.as_tensor(g.random((lanes, n * f)) < 0.9, device=dev)
    ann_target = i32(g.integers(0, n, (lanes, n)))
    ann_claim = torch.where(torch.as_tensor(g.random((lanes, n)) < 0.3,
                                            device=dev), inc * 4, -1).to(
        torch.int32)
    up = torch.as_tensor(g.random((lanes, n)) < 0.95, device=dev)
    heard_down = torch.as_tensor(g.random((lanes, n)) < 0.05, device=dev)
    fb_inc = i32(np.where(g.random((lanes, n)) < 0.05,
                          g.integers(0, 8, (lanes, n)), -1))
    return ([view, vinc, since, inc],
            (gdst, g_ok, ann_target, ann_claim, up, heard_down, fb_inc))


def _lane_swim_passes(sl, xs, args, f, t, timeout, kernel=True):
    """K15's three lane passes on ``xs`` in place, with the receiver
    filter between them; returns (keys, merged, incarnations)."""
    view, vinc, since, inc = xs
    gdst, g_ok, ann_target, ann_claim, up, heard_down, fb_inc = args
    if kernel:
        timeout_, merge, apply_ = (sl.swim_timeout_lanes_,
                                   sl.swim_merge_lanes, sl.swim_apply_lanes_)
    else:
        timeout_, merge, apply_ = (sl.swim_timeout_lanes_plain,
                                   sl.swim_merge_lanes_plain,
                                   sl.swim_apply_lanes_plain)
    key = timeout_(view, vinc, since, t, timeout)
    lanes, n = up.shape
    gsrc = torch.arange(n, device=view.device).repeat_interleave(f)
    ok = g_ok & (sl._cells(view, gdst, gsrc[None].expand(lanes, -1)) != 2)
    merged = merge(key, gdst, ok, f, ann_target, ann_claim)
    return key, merged, apply_(view, vinc, since, key, merged, inc, up,
                               heard_down, fb_inc, t)


def compare_lane_swim_full(dev, g, lanes, n=4096, f=3, timed=True):
    """K15's lane entries at swim-churn-full-4096-seeds8's shapes (K = 8
    lanes of N = 4096, F = 3: 134 M belief cells): SUSPECT cells past the
    timeout, DOWN receivers, announce claims, refutes; the last lane
    held to the solo entries."""
    from corrosion_tpu_torch.sim import swim_lanes as sl
    from corrosion_tpu_torch.sim import swim as sw

    t, timeout = 40, 13
    base, args = _lane_swim_inputs(g, dev, lanes, n, f, t)
    outs = []
    for kernel in (True, False):
        xs = [x.clone() for x in base]
        res = _lane_swim_passes(sl, xs, args, f, t, timeout, kernel)
        outs.append(list(res) + xs)
    equal, err = _equal_all(outs[0], outs[1])
    last = lanes - 1
    solo = [x[last].clone() for x in base]
    gdst, g_ok, ann_target, ann_claim, up, heard_down, fb_inc = (
        a[last] for a in args)
    res = _swim_passes(sw, solo, gdst, g_ok, f, ann_target, ann_claim, up,
                       heard_down, fb_inc, t, timeout)
    _solo_trap(f"swim_full lanes N={n}", [x[last] for x in outs[0]],
               list(res) + solo)
    key, merged, new_inc = outs[1][:3]
    if not (bool((new_inc != base[3]).any())
            and bool((merged > key).any())):
        raise AssertionError("K15 lane inputs refute or merge nothing")
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    cells = lanes * n * n
    nbytes = (cells * 9 + lanes * (n * f * 5 + n * 4 * 4 + n * 2)
              + _changed_bytes(base, outs[1][3:]))
    return _dense_lane_row(
        "swim_full_lanes", "swim_full_lanes", "swim_full.cu",
        "corrosion_tpu/sim/swim.py:185", equal, err,
        _timed(timed, lambda: _lane_swim_passes(sl, work, args, f, t,
                                                timeout), restore),
        _timed(timed, lambda: _lane_swim_passes(sl, work, args, f, t,
                                                timeout, False), restore),
        nbytes, lanes, n=n)


def compare_lane_sample_uniform(dev, g, lanes, n=4096, count=3,
                                timed=True):
    """K1's uniform lane entry: K lanes of a churn-full-4096 draw with
    beliefs (DOWN cells, self candidates, repeats, rows left short), and
    of a broadcast-1k draw without (ground truth); the last lane held to
    the solo entry."""
    from corrosion_tpu_torch.sim import swim_lanes as sl
    from corrosion_tpu_torch.sim import swim

    rows = []
    over = 4 * count
    for size, beliefs in ((n, True), (1000, False)):
        me = np.arange(size)[None, None, :]
        cand = g.integers(0, size, (lanes, over, size))
        cand = np.where(g.random((lanes, over, size)) < 0.05, me, cand)
        cand[:, 1] = np.where(g.random((lanes, size)) < 0.3, cand[:, 0],
                              cand[:, 1])
        cand_t = torch.as_tensor(cand, dtype=torch.int32, device=dev)
        view = (torch.as_tensor(
            np.where(g.random((lanes, size, size)) < 0.5, 2,
                     g.integers(0, 2, (lanes, size, size))),
            dtype=torch.int8, device=dev) if beliefs else None)
        got = sl.sample_uniform_lanes(cand_t, view, count)
        want = sl.sample_uniform_lanes_plain(cand_t, view, count)
        equal, err = _equal_all([got], [want])
        if beliefs and not bool((want == -1).any()):
            raise AssertionError("K1 uniform lane inputs leave no row short")
        last = lanes - 1
        _solo_trap(f"sample_uniform lanes N={size} beliefs={beliefs}",
                   [got[last]], [swim.sample_uniform(
                       cand_t[last], None if view is None else view[last],
                       count)])
        rows.append(_dense_lane_row(
            "sample_uniform_lanes" + ("" if beliefs else "_ground"),
            "sample_uniform_lanes", "sample_targets.cu",
            "corrosion_tpu/sim/swim.py:59", equal, err,
            _timed(timed, lambda: sl.sample_uniform_lanes(cand_t, view,
                                                          count)),
            _timed(timed, lambda: sl.sample_uniform_lanes_plain(
                cand_t, view, count)),
            cand_t.numel() * (5 if beliefs else 4) + lanes * size * count * 4,
            lanes, n=size))
    return rows


def compare_lane_detect(dev, g, lanes, timed=True, full_n=CHURN_N,
                        partial_n=STORM_N):
    """K23's lane entries: full view at swim-churn-full-4096's shape and
    partial view at swim-churn-partial-100k's (M = 64), K lanes whose
    inputs differ — lanes that hold (every watched cell DOWN), lanes with
    one watched cell short, a lane whose detect_round was already set,
    and a lane of all-dead watchers — each lane's word equal to the solo
    entry's on its inputs, scratch words back at 0."""
    from corrosion_tpu_torch.sim import telemetry as tel

    rows = []
    t = 23
    for kind, n in (("full", full_n), ("partial", partial_n)):
        tables, ups = [], []
        for k in range(lanes):
            if kind == "full":
                up_np = np.arange(n) % 3 != 0
                view_np = g.integers(0, 3, (n, n)).astype(np.int8)
                view_np[np.ix_(up_np, ~up_np)] = 2
                if k % 2:
                    i = int(np.flatnonzero(up_np)[k])
                    view_np[i, int(np.flatnonzero(~up_np)[k])] = 1
                x = (torch.as_tensor(view_np, device=dev),)
                up = torch.as_tensor(up_np, device=dev)
            else:
                pid, pkey, up, watched = _partial_tables(g, n, 64, dev)
                if k % 2:
                    i, s = (int(v[k]) for v in np.nonzero(watched))
                    pkey[i, s] -= 2
                x = (pid, pkey)
            if k == (2 if lanes > 3 else 0):
                up = torch.zeros_like(up)  # every watcher dead
            tables.append(x)
            ups.append(up)
        xs = [_stack(col) for col in zip(*tables)]
        up = _stack(ups)
        start = tel.new_detect_lanes(lanes, dev)
        start[lanes - 1, 0] = 5  # already detected: stays
        entry = tel.detect_full_lanes_ if kind == "full" \
            else tel.detect_partial_lanes_
        plain = tel.detect_full_lanes_plain if kind == "full" \
            else tel.detect_partial_lanes_plain
        got, want = start.clone(), start.clone()
        entry(got, *xs, up, t)
        plain(want, *xs, up, t)
        equal, err = _equal_all([got], [want])
        rounds = got[:, 0].tolist()
        if not (t in rounds and -1 in rounds and 5 in rounds) or bool(
                got[:, 1:].any()):
            raise AssertionError(f"detect_{kind} lanes: words "
                                 f"{got.tolist()}")
        solo = tel.new_detect(dev)
        solo_entry = tel.detect_full_ if kind == "full" \
            else tel.detect_partial_
        solo_entry(solo, *(x[0] for x in xs), up[0], t)
        _solo_trap(f"detect_{kind} lanes N={n} rounds={rounds}", [got[0]],
                   [solo])
        det, det2 = start.clone(), start.clone()
        n_up = int(up.sum())
        per_cell = n if kind == "full" else 64 * 8
        rows.append(_dense_lane_row(
            f"detect_{kind}_lanes", f"detect_{kind}_lanes",
            "membership_detect.cu", "corrosion_tpu/sim/telemetry.py:318",
            equal, err,
            _timed(timed, lambda: entry(det, *xs, up, t)),
            _timed(timed, lambda: plain(det2, *xs, up, t)),
            n_up * per_cell + lanes * n, lanes, n=n))
    return rows


def compare_dense_lane_kernels(dev, seed=11, lanes=ENSEMBLE_LANES,
                               timed=True, big=True):
    """Phase 3l: every lane entry of the dense round and the detect loop
    against its plain version at K = 8 on its paths' shapes, each lane
    held to the solo entry on its inputs, binding budgets included;
    ``big`` False shrinks the 100k and 4096 shapes to 3000 and 300 nodes
    (a CPU rehearsal)."""
    g = np.random.default_rng(seed)
    wide, full = (STORM_N, CHURN_N) if big else (3000, 300)
    rows = [compare_lane_dense_phases(dev, g, lanes, timed=timed),
            compare_lane_dense_sync(dev, g, lanes, timed=timed),
            compare_lane_dense_gaps(dev, g, lanes, timed=timed),
            compare_lane_dense_phases(dev, g, lanes, wide, 1, timed),
            compare_lane_dense_sync(dev, g, lanes, wide, 1, timed),
            compare_lane_dense_gaps(dev, g, lanes, wide, 1, timed),
            compare_lane_swim_full(dev, g, lanes, n=full, timed=timed)]
    rows += compare_lane_sample_uniform(dev, g, lanes, n=full, timed=timed)
    rows += compare_lane_detect(dev, g, lanes, timed, full, wide)
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: paths 36-40: (label, spec builder, membership kind, golden name, solo
#: walls and profile?)
DENSE_ENSEMBLE_PATHS = (
    ("broadcast_1k_seeds8", "broadcast", "ground", "BROADCAST_1K_SEEDS8"),
    ("swim_churn_64_seeds8", "churn64", "full", "SWIM_CHURN_64_SEEDS8"),
    ("swim_churn_full_4096_seeds8", "churn4096", "full",
     "SWIM_CHURN_FULL_4096_SEEDS8"),
    ("swim_churn_partial_4096_seeds8", "partial4096", "partial",
     "SWIM_CHURN_PARTIAL_4096_SEEDS8"),
    ("swim_churn_partial_100k_seeds8", "partial100k", "partial",
     "SWIM_CHURN_PARTIAL_100K_SEEDS8"),
)


def dense_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "broadcast": lambda: sp.broadcast_seeds_spec(seeds),
        "churn64": lambda: sp.swim_churn_64_spec(seeds=seeds),
        "churn4096": lambda: sp.swim_churn_64_spec(seeds=seeds, n=CHURN_N),
        "partial4096": lambda: sp.swim_churn_partial_spec(seeds=seeds),
        "partial100k": lambda: sp.swim_churn_partial_spec(seeds=seeds,
                                                          n=STORM_N),
    }[which]()


def _dense_solo_runs(spec, dev):
    """The port's solo runs of a dense path's seeds on the card: the
    detect loop (`run_membership_detect` on `churn_setup`) or the dense
    convergence loop (`run_to_convergence`); their finals, detect rounds
    (-1, or None for a convergence run) and host walls."""
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.telemetry import run_membership_detect

    cfg, topo = spec.sim_config({}), spec.topo({})
    out = []
    for s in spec.seeds:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if spec.detect_membership({}):
            meta, state = churn_setup(cfg, int(s), dev)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            final, _, det = run_membership_detect(
                state, meta, cfg, topo, spec.max_rounds, device=dev)
            det = int(det)
        else:
            meta = uniform_payloads(cfg, dev, inject_every=2)
            final, _ = run_to_convergence(new_sim(cfg, int(s), dev), meta,
                                          cfg, topo, spec.max_rounds)
            det = None
        torch.cuda.synchronize()
        out.append((final, det, time.monotonic() - t0))
    return out


def dense_ensemble_paths(dev, goldens):
    """Paths 36-40: the five dense ensembles through `campaign.engine.
    run_campaign` (seeds 0-7), each from zeroed counters: every lane
    entry of the path launched, no solo entry of a kernel that has one;
    the artifact's spec_hash and result_digest and each lane's rounds,
    detect round or p99, digest, detected fraction and false DOWNs
    against the golden pinned from live JAX; swim-churn-partial-100k's
    lanes (JAX's CPU run does not fit) against the golden pinned from
    the card's run where each lane equalled the port's solo run of its
    seed, lane 0 also against JAX's solo golden.  The full-4096 and
    broadcast ensembles' lanes against their solo runs on this card, and
    their walls beside their 8 solo walls, with max_memory_allocated.  Returns the launches per path
    and the printed numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest

    launches, numbers = {}, {}
    for label, which, kind, golden_name in DENSE_ENSEMBLE_PATHS:
        spec = dense_path_spec(which)
        kept = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated()
        counts = _path_launches(kernels, DENSE_LANE_ROWS[kind], label)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        cell = art["cells"][0]
        ps = cell["per_seed"]
        finals = kept[0]["finals"]
        detect = spec.detect_membership({})
        lanes = []
        for i, s in enumerate(cell["seeds"]):
            lane = {"seed": s, "rounds": ps["rounds"][i],
                    "digest": state_digest(lane_state(finals, i))}
            if detect:
                lane["detect_round"] = ps["detect_round"][i]
                lane["detected_fraction"] = ps["detected_fraction"][i]
                if "false_positive_downs" in ps:
                    lane["false_positive_downs"] = \
                        ps["false_positive_downs"][i]
            else:
                lane["p99_node_convergence_round"] = \
                    ps["p99_node_convergence_round"][i]
            lanes.append(lane)
        got = {"spec_hash": art["spec_hash"],
               "result_digest": art["result_digest"], "lanes": lanes}
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{cell['wall_clock_s']} wall_verdict={cell['wall_verdict']} "
              f"round_path={cell['round_path']}", flush=True)
        if cell["round_path"] != "dense":
            raise AssertionError(f"{label}: round_path {cell['round_path']}")
        golden = getattr(goldens, golden_name)
        want = {key: golden[key] for key in got if key in golden}
        if {key: got[key] for key in want} != want or (
                "lane0" in golden and lanes[0] != golden["lane0"]):
            raise AssertionError(f"{label}: differs from its golden")
        del kept
        entry = {"ensemble_wall_s": cell["wall_clock_s"],
                 "max_memory_allocated_bytes": peak}
        if which in ("churn4096", "broadcast"):
            solos = _dense_solo_runs(spec, dev)
            if not all(_same_state(f, lane_state(finals, i))
                       for i, (f, _, _) in enumerate(solos)):
                raise AssertionError(f"{label}: a lane differs from its solo "
                                     "run")
            if detect and [d for _, d, _ in solos] != [
                    -1 if lane["detect_round"] is None
                    else lane["detect_round"] for lane in lanes]:
                raise AssertionError(f"{label}: detect rounds differ from "
                                     "the solo runs'")
            entry["solo_walls_s"] = [w for _, _, w in solos]
            entry["solo_walls_sum_s"] = sum(entry["solo_walls_s"])
            del solos
            print(f"{label}: every lane equal to its solo run; ensemble wall "
                  f"{cell['wall_clock_s']} s against the solo walls' sum "
                  f"{entry['solo_walls_sum_s']:.4f} s; max_memory_allocated "
                  f"{peak} bytes", flush=True)
        del finals
        numbers[label] = entry
        _lap(label)
    return launches, numbers


def _dense_path_setup(which, lanes, dev):
    """A dense path's config, payloads and round-0 state: K stacked lanes
    (seeds 0..K-1, the kill applied on detect paths) or, with ``lanes``
    None, the solo state of seed 0."""
    from corrosion_tpu_torch.campaign.ensemble import seed_states
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.state import ALIVE, DOWN, uniform_payloads

    spec = dense_path_spec(which)
    cfg = spec.sim_config({})
    detect = spec.detect_membership({})
    if lanes is None:
        if detect:
            return (cfg,) + churn_setup(cfg, 0, dev)
        return (cfg, uniform_payloads(cfg, dev, inject_every=2),
                new_sim(cfg, 0, dev))
    meta = uniform_payloads(cfg, dev, inject_every=1 if detect else 2)
    states = seed_states(cfg, range(lanes), dev)
    if detect:
        kill = torch.arange(cfg.n_nodes, device=dev) % 3 == 0
        alive = torch.where(kill, DOWN, ALIVE).to(torch.uint8)
        states = states._replace(
            alive=alive.expand(states.alive.shape).contiguous())
    return cfg, meta, states


def profile_dense_path(dev, which, lanes=ENSEMBLE_LANES, rounds=3):
    """The first ``rounds`` rounds of a dense path: with ``lanes`` the
    lane round (`dense_lanes.dense_round_step_lanes`, K23's lane entry on
    detect paths, the one host read of the [K] flags a round), with
    ``lanes`` None the solo round (`round.round_step_`, K23's solo entry,
    the solo read); device ms, launches and idle share a round."""
    from corrosion_tpu_torch.sim import telemetry as tel
    from corrosion_tpu_torch.sim.dense_lanes import (
        dense_round_step_lanes, lane_batch)
    from corrosion_tpu_torch.sim.round import (
        new_metrics, own_state, round_step_)
    from corrosion_tpu_torch.sim.state import ALIVE
    from corrosion_tpu_torch.sim.topology import Topology, regions

    topo = Topology()
    spec = dense_path_spec(which)
    cfg = spec.sim_config({})
    detect = spec.detect_membership({})
    region = regions(cfg.n_nodes, 1, dev)

    def setup():
        _, meta, state = _dense_path_setup(which, lanes, dev)
        if lanes is None:
            out = (meta, own_state(state), new_metrics(cfg, dev),
                   state.alive == ALIVE, tel.new_detect(dev))
        else:
            batch = lane_batch(state, cfg)
            out = (meta, batch.slim, batch.metrics, state.alive == ALIVE,
                   tel.new_detect_lanes(lanes, dev))
        torch.cuda.synchronize()
        return out

    def run(loop):
        meta, state, metrics, up, det = loop
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            if lanes is None:
                state, metrics, done = round_step_(state, metrics, meta, cfg,
                                                   topo, region)
            else:
                state, metrics, done = dense_round_step_lanes(
                    state, metrics, meta, cfg, topo, region)
            t = int(state.t)
            if detect:
                if lanes is None:
                    fn = (tel.detect_full_ if cfg.swim_full_view
                          else tel.detect_partial_)
                else:
                    fn = (tel.detect_full_lanes_ if cfg.swim_full_view
                          else tel.detect_partial_lanes_)
                args = ((state.view,) if cfg.swim_full_view
                        else (state.pid, state.pkey))
                fn(det, *args, up, t)
                done = det[..., 0] >= 0
            done.tolist()  # the loop's one host read a round
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = f"{which} x{lanes} lanes" if lanes else f"{which} solo"
    return _profile(run, rounds, label, setup)


# -- the dense fault loop's lanes (phase 3lf, paths 41-45) -------------------

SOLO_OF_LANE.update({"fault_reach_matrix_lanes": "fault_reach_matrix",
                     "node_faults_dense_lanes": "node_faults_dense",
                     "dense_broadcast_fault_lanes": "dense_broadcast_fault",
                     "dense_sync_delay_lanes": "dense_sync_delay",
                     "dense_gaps_exit_lanes": "dense_gaps_exit"})


def _tu8(gen, shape, p_one, dev):
    """u8 0/1 cells on the card, each 1 with probability ``p_one``, from
    a seeded torch generator (the lanes' inputs are too wide to draw on
    the host)."""
    return (torch.rand(shape, generator=gen, device=dev) < p_one).to(
        torch.uint8)


def _lane_dense_states(gen, dev, cfg, lanes, t):
    """K mid-storm dense states at ``cfg``'s shapes, stacked (``t`` one
    host scalar): half the cells held with relay budgets on them, most
    payloads injected, sparse rings, 3 % dead nodes, random member tables
    or full-view beliefs, heads and gap rows."""
    from corrosion_tpu_torch.sim.state import init_state

    n, p, d = cfg.n_nodes, cfg.n_payloads, cfg.n_delay_slots
    a, k, m, v = cfg.n_writers, cfg.gap_slots, cfg.member_slots, \
        cfg.n_versions
    base = init_state(cfg, torch.tensor([0, 9], dtype=torch.int64,
                                        device=dev))

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    have = _tu8(gen, (lanes, n, p), 0.5, dev)
    rep = dict(
        have=have,
        relay_left=ints(0, 4, (lanes, n, p), torch.uint8) * have,
        injected=_tu8(gen, (lanes, p), 0.9, dev),
        inflight=_tu8(gen, (lanes, d, n, p), 0.05, dev),
        sync_inflight=_tu8(gen, (lanes, d, n, p), 0.02, dev),
        alive=(_tu8(gen, (lanes, n), 0.03, dev) * 2),
        heads=ints(0, v + 1, (lanes, n, a)),
        gap_lo=ints(0, v + 1, (lanes, n, a, k)),
        gap_hi=ints(0, v + 1, (lanes, n, a, k)),
    )
    if cfg.swim_partial_view:
        rep.update(pid=ints(-1, n, (lanes, n, m)),
                   pkey=ints(-1, 40, (lanes, n, m)),
                   psince=ints(-1, t + 1, (lanes, n, m)))
    if cfg.swim_full_view:
        rep.update(view=ints(0, 3, (lanes, n, n), torch.int8),
                   vinc=ints(0, 5, (lanes, n, n)),
                   suspect_since=ints(-1, t + 1, (lanes, n, n)))
    rest = {f: x.expand(lanes, *x.shape).contiguous()
            for f, x in zip(base._fields, base)
            if f not in rep and f != "t"}
    return base._replace(t=torch.tensor(t, dtype=torch.int32), **rest,
                         **rep)


def _lane_edges_of(gen, dev, state, f):
    """Each lane's targets [K, N, F] (self and -1 among them) and its
    edges: src [1, E], dst and ok [K, E] as the dense lanes build them."""
    from corrosion_tpu_torch.sim.lanes import _edges

    lanes, n = state.alive.shape
    tg = torch.randint(0, n, (lanes, n, f), generator=gen, device=dev,
                       dtype=torch.int32)
    me = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    roll = torch.rand((lanes, n, f), generator=gen, device=dev)
    tg = torch.where(roll < 0.03, -1, torch.where(roll < 0.05, me, tg))
    tg = tg.to(torch.int32).contiguous()
    src, dst, ok = _edges(state, tg)
    return tg, src, dst.contiguous(), ok


def compare_lane_reach_matrix(dev, g, lanes, n=MATRIX_N, f=3, timed=True):
    """K9m's reach lane entry at fault-storm-1000's shapes (K lanes of
    E = N·F edges on its matrix plan's round 5: the half split's cuts and
    the 0.15 loss) with per-lane keys and plan seeds: equal to the plain
    version, lanes 0 and K - 1 each equal to the solo entry under its key
    and seed, and on one edge list shared by every lane the lanes' draws
    disagreeing (each lane folds its own seed)."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import faults

    _, _, fplan, _ = _matrix_storm(n, dev)
    rf = faults.round_faults(fplan, MATRIX_T)
    e = n * f
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        f)[None].expand(lanes, -1).contiguous()
    dst = torch.as_tensor(np.where(g.random((lanes, e)) < 0.05,
                                   src.cpu().numpy(),
                                   g.integers(0, n, (lanes, e))),
                          dtype=torch.int32, device=dev)
    ok0 = torch.as_tensor(g.random((lanes, e)) < 0.9, device=dev)
    keys = _lane_keys(dev, lanes, 5000)
    seeds = lane_plan_seeds(range(lanes), dev)
    got = faults.fault_reach_lanes_(ok0.clone(), rf, keys, src, dst, seeds)
    ref = faults.fault_reach_lanes_plain(ok0.clone(), rf, keys, src, dst,
                                         seeds)
    for k in (0, lanes - 1):
        solo = faults.fault_reach_(ok0[k].clone(),
                                   rf._replace(seed=int(seeds[k])), keys[k],
                                   src[k], dst[k])
        _solo_trap(f"fault_reach_matrix lanes lane {k}", [got[k]], [solo])
    same = dst[:1].expand(lanes, -1).contiguous()
    ok1 = ok0[:1].expand(lanes, -1).contiguous()
    shared = faults.fault_reach_lanes_(ok1.clone(), rf,
                                       keys[:1].expand(lanes, -1).contiguous(),
                                       src, same, seeds)
    cut = faults._block_plain(rf, src[0], same[0])
    _trap("lane fault 1", "K9m's reach on lanes: a cut edge cleared in "
          "every lane, and lanes of one key and one edge list that differ "
          "by their plan seeds' loss draws",
          bool((ok1[0] & cut).any()) and not bool(shared[:, cut].any())
          and bool((shared != shared[0]).any()))
    wk, wp = ok0.clone(), ok0.clone()

    def rk():
        wk.copy_(ok0)
        faults.fault_reach_lanes_(wk, rf, keys, src, dst, seeds)

    def rp():
        wp.copy_(ok0)
        faults.fault_reach_lanes_plain(wp, rf, keys, src, dst, seeds)

    # ids, ok in and out, the block and loss cells
    return _lane_row(
        "fault_reach_matrix_lanes", _CSRC + "fault_edges.cu",
        "corrosion_tpu/sim/swim.py:161",
        bool(torch.equal(got, ref)), _max_abs_err(got, ref),
        _timed(timed, rk), _timed(timed, rp), lanes * e * (4 + 4 + 2 + 2),
        lanes, n=n, e=e)


def compare_lane_node_faults_dense(dev, gen, lanes, n=STORM_N,
                                   full_n=MATRIX_N, timed=True):
    """K11d's lane entry on K lanes of the dense fault storm's state
    (N = 100000, P = 512, D = 2, M = 64) at round 20 (node 1's restart:
    an override and a wiped row) and of the full-view storm's at N =
    1000 (its [K, N, N] beliefs): equal to the plain version, the last
    lane to the solo entry; lane 0's wiped rows hold nothing before the
    wipe while the other lanes' hold payloads."""
    from corrosion_tpu_torch.sim import faults

    cases = []
    for label, (cfg, _, fplan) in (
            ("partial", _dense_fault_storm(n, dev)),
            ("full", _dense_fault_storm(full_n, dev, swim_partial_view=False,
                                        swim_full_view=True))):
        rf = faults.round_faults(fplan, 20)
        node = int(torch.nonzero(rf.wipe).flatten()[0])
        states = _lane_dense_states(gen, dev, cfg, lanes, 20)
        for name, fill in (("have", 0), ("relay_left", 0), ("heads", 0),
                           ("gap_lo", 0), ("gap_hi", 0), ("pid", -1),
                           ("pkey", -1), ("psince", -1)):
            getattr(states, name)[0, node] = fill
        for name in ("inflight", "sync_inflight"):
            getattr(states, name)[0, :, node] = 0
        got = faults.apply_node_faults_lanes(_clone_state(states), rf)
        want = faults.apply_node_faults_lanes_plain(_clone_state(states), rf)
        e, x = _equal_all([y for y in got if y.numel()],
                          [y for y in want if y.numel()])
        last = lanes - 1
        solo = faults.apply_node_faults(
            faults._lane_states(_clone_state(states))[last], rf)
        _solo_trap(f"node_faults_dense lanes {label}",
                   [y[last] for f_, y in zip(got._fields, got) if f_ != "t"],
                   [y for f_, y in zip(solo._fields, solo) if f_ != "t"])
        held = [bool(states.have[k, node].any()) for k in range(lanes)]
        kept = [all(torch.equal(getattr(got, nm)[k, node + 1],
                                getattr(states, nm)[k, node + 1])
                    for nm in ("have", "relay_left", "heads"))
                for k in range(lanes)]
        _trap(f"lane fault 2 {label}",
              "a wipe of lanes that hold payloads in the wiped row beside a "
              "lane whose row is already empty: every lane's row emptied, "
              "the next row untouched",
              not held[0] and all(held[1:])
              and not bool(got.have[:, node].any()) and all(kept))
        cases.append((e, x, states, rf, cfg))
    equal = all(c[0] for c in cases)
    err = max(c[1] for c in cases)
    _, _, states, rf, cfg = cases[0]
    work = _clone_state(states)
    wiped = torch.nonzero(rf.wipe).flatten()

    def restore():
        work.alive.copy_(states.alive)
        for name in ("have", "relay_left", "heads", "gap_lo", "gap_hi",
                     "pid", "pkey", "psince"):
            getattr(work, name)[:, wiped] = getattr(states, name)[:, wiped]
        for name in ("inflight", "sync_inflight"):
            getattr(work, name)[:, :, wiped] = getattr(states, name)[
                :, :, wiped]

    p, d, a = cfg.n_payloads, cfg.n_delay_slots, cfg.n_writers
    row = p * (2 + 2 * d) + (a + 2 * a * cfg.gap_slots
                             + 3 * cfg.member_slots) * 4
    return _lane_row(
        "node_faults_dense_lanes", _CSRC + "node_faults.cu",
        "corrosion_tpu/sim/faults.py:703", equal, err,
        _timed(timed, lambda: faults.apply_node_faults_lanes(work, rf),
               restore),
        _timed(timed, lambda: faults.apply_node_faults_lanes_plain(work, rf),
               restore),
        lanes * (n * 2 + int(rf.wipe.sum()) * row) + n * 2, lanes,
        n=n)


def _lane_wire_case(gen, dev, cfg, meta, fplan, t, lanes, zero_rings=False):
    """One round's broadcast inputs on K lanes of a mid-storm state: the
    lanes' targets and edges, K9's cuts, fault thresholds, delays and
    jitter bounds on the lanes folded into the edge axis, the slots, the
    lanes' phase keys and k_drop, their plan seeds."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import rng as trng

    state = _lane_dense_states(gen, dev, cfg, lanes, t)
    if zero_rings:
        state.inflight.zero_()
    targets, src, dst, ok = _lane_edges_of(gen, dev, state, cfg.fanout)
    rf = faults.round_faults(fplan, t)
    _, fthr, fdelay, jit = faults.fault_wire_effects(
        rf, src.expand(lanes, -1).reshape(-1), dst.reshape(-1), ok.view(-1))
    fthr, fdelay, jit = (None if x is None else x.view(lanes, -1)
                         for x in (fthr, fdelay, jit))
    delay = torch.zeros_like(dst) if fdelay is None else fdelay
    slot = ((t + delay) % cfg.n_delay_slots).to(torch.int32)
    keys = _lane_keys(dev, lanes, 6000 + t)
    return SimpleNamespace(
        state=state, targets=targets, dst=dst, ok=ok, fthr=fthr, jit=jit,
        slot=slot, keys=keys,
        k_drop=trng.split_lanes(keys, 3)[:, 1].contiguous(),
        seeds=lane_plan_seeds(range(lanes), dev),
        host_seeds=lane_plan_seeds(range(lanes), "cpu"), meta=meta, cfg=cfg)


def _lane_wire_send(c, kernel, ring, relay):
    """K12's fault lane entry (or its plain version) on case ``c``, in
    place on ``ring`` and ``relay``; the plain version takes the seeds
    from the host (a plain version timed in a graph must not read the
    card)."""
    from corrosion_tpu_torch.sim import dense_lanes as dl

    s = c.state
    send = dl.broadcast_send_lanes if kernel else \
        dl.broadcast_send_lanes_plain
    send(s.have, relay, s.injected, c.meta.nbytes,
         c.cfg.rate_limit_bytes_round, c.targets, c.dst, c.slot, c.ok,
         s.alive, c.k_drop, 0, ring, c.keys, c.fthr, c.jit,
         c.seeds if kernel else c.host_seeds)


def compare_lane_broadcast_fault(dev, gen, lanes, n=STORM_N, timed=True):
    """K12's fault lane entry on K lanes at the dense storms' shapes (N =
    100000, P = 512, F = 3): the dense fault storm's round 5 (the fault
    loss, the half split's cuts; D = 2) and the dense latency storm's
    round 6 on empty rings (delay and jitter of one round out of the
    first sixth; D = 4): equal to the plain version, the last lane to the
    solo fault entry under its phase key and plan seed, and a jittered
    payload that wraps the ring (slot D - 1 plus one lands in slot 0)."""
    from corrosion_tpu_torch.sim import broadcast as bc

    cfg, meta, fplan = _dense_fault_storm(n, dev)
    lcfg, lmeta, lplan = _dense_latency_storm(n, dev)
    cases = {"path": _lane_wire_case(gen, dev, cfg, meta, fplan,
                                     DENSE_FAULT_T, lanes),
             "latency": _lane_wire_case(gen, dev, lcfg, lmeta, lplan,
                                        LATENCY_T, lanes, zero_rings=True)}
    equal, err, after = True, 0, {}
    last = lanes - 1
    for label, c in cases.items():
        outs = []
        for kernel in (True, False):
            ring, relay = c.state.inflight.clone(), c.state.relay_left.clone()
            _lane_wire_send(c, kernel, ring, relay)
            outs.append([ring, relay])
        e, x = _equal_all(outs[0], outs[1])
        equal, err = equal and e, max(err, x)
        after[label] = outs[0]
        s = c.state
        ring, relay = s.inflight[last].clone(), s.relay_left[last].clone()
        bc.broadcast_send(
            s.have[last], relay, s.injected[last], meta.nbytes,
            c.cfg.rate_limit_bytes_round, c.targets[last], c.dst[last],
            c.slot[last], c.ok[last], s.alive[last], c.k_drop[last], 0, ring,
            phase_key=c.keys[last],
            fthr=None if c.fthr is None else c.fthr[last],
            jit=None if c.jit is None else c.jit[last],
            seed=int(c.seeds[last]))
        _solo_trap(f"dense_broadcast_fault lanes {label}",
                   [x[last] for x in outs[0]], [ring, relay])
        del outs
    c = cases["latency"]
    d = c.cfg.n_delay_slots
    base_slots = set(torch.unique(c.slot[c.ok]).tolist())
    _trap("lane fault 3", "a jittered payload wraps the ring: every edge's "
          "slot is D - 2 or D - 1, yet slot 0 receives",
          base_slots <= {d - 2, d - 1} and d - 1 in base_slots
          and bool(after["latency"][0][:, 0].any()))
    del cases["latency"], after
    c = cases["path"]
    base = [c.state.inflight, c.state.relay_left]
    work = [x.clone() for x in base]

    def restore():
        for dst_, src_ in zip(work, base):
            dst_.copy_(src_)

    hashes = 0
    for k in range(lanes):
        s = c.state
        sending = ((s.have[k] > 0) & (s.relay_left[k] > 0)
                   & (s.injected[k] > 0)[None, :]).repeat_interleave(
                       c.cfg.fanout, dim=0) & (c.ok[k] & (c.fthr[k] > 0))[
                           :, None]
        hashes += int(sending.reshape(sending.shape[0], -1, 4).any(
            dim=2).sum())
        del sending
    ring, relay = base[0].clone(), base[1].clone()
    _lane_wire_send(c, True, ring, relay)
    changed = _changed_bytes(base, [ring, relay])
    del ring, relay
    nbytes = (_nbytes(c.state.have, c.state.relay_left, c.state.injected,
                      meta.nbytes, c.targets, c.dst, c.slot, c.ok,
                      c.state.alive, c.fthr) + changed)
    ops = hashes * OPS_PER_HASH
    rate = _int32_ops_per_s()
    ops_ms = ops / rate * 1e3
    row = _lane_row(
        "dense_broadcast_fault_lanes", _CSRC + "dense_phases.cu",
        "corrosion_tpu/sim/broadcast.py:124", equal, err,
        _timed(timed, lambda: _lane_wire_send(c, True, work[0], work[1]),
               restore),
        _timed(timed, lambda: _lane_wire_send(c, False, work[0], work[1]),
               restore),
        nbytes, lanes, ops=ops, hashes=hashes, n=n)
    row["bound_ms"] = max(row["bound_ms"], ops_ms)
    row["bound_by"] = "operations" if ops_ms > _bound_ms(nbytes) else "bytes"
    return row


def compare_lane_sync_delay(dev, g, gen, lanes, n=STORM_N, timed=True):
    """K13's delay lane entry on K lanes at the dense latency storm's
    shapes (N = 100000, P = 512, S = 3, D = 4) at round 6 (pull slot
    t + 1 = 3: a session delay of one wraps to slot 0, empty before) with
    the sessions K9 refuses on the lanes folded under the latency storm's
    plan and, for the refusal trap, under a one-way cut (a session dies
    on the reverse edge too); equal to the plain version, the last lane
    to the solo delay entry."""
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import faults, sync

    cfg, meta, fplan = _dense_latency_storm(n, dev)
    s, d = cfg.sync_peers, cfg.n_delay_slots
    t = LATENCY_T
    state = _lane_dense_states(gen, dev, cfg, lanes, t)
    adv = [_advertised(g, dev, cfg, state.have[k], 40) for k in range(lanes)]
    heads, lo, hi = (_stack(a[i] for a in adv) for i in range(3))
    _, src, dst, ok = _lane_edges_of(gen, dev, state, s)
    src_flat = src.expand(lanes, -1).reshape(-1)
    ok_pre = ok.clone()  # before the storm's half split refuses sessions
    rf = faults.round_faults(fplan, t)
    _, sdelay = faults.fault_session_effects(rf, src_flat, dst.reshape(-1),
                                             ok.view(-1))
    sdelay = sdelay.view(lanes, -1)
    # the refusal trap: a one-way cut of the first half from the second
    oplan = faults.compile_plan(one_way_plan(n), cfg, device=dev)
    orf = faults.round_faults(oplan, 2)
    ok_k = ok_pre.clone()
    ref_k = faults.fault_session_refused(orf, src_flat, dst.reshape(-1),
                                         ok_k.view(-1))
    fwd = faults._block_plain(orf, src_flat, dst.reshape(-1))
    ref_p = fwd | faults._block_plain(orf, dst.reshape(-1), src_flat)
    ok_p = ok_pre & ~ref_p.view(lanes, -1)
    _trap("lane fault 4", "a session refused in one direction only: a "
          "puller in the second half whose server sits in the first (the "
          "cut runs the other way) is refused, on the lanes folded",
          torch.equal(ref_k, ref_p) and torch.equal(ok_k, ok_p)
          and bool((ok_pre.view(-1) & ref_k & ~fwd).any()))
    ring0 = state.sync_inflight
    ring0[:, 0] = 0
    slot = (t + 1) % d
    peers, ok = dst.view(lanes, -1, s), ok.view(lanes, -1, s)
    args = (state.have, heads, lo, hi, peers, ok, meta.nbytes, None)
    got_r, want_r = ring0.clone(), ring0.clone()
    got = dl.sync_pull_dense_lanes(*args, got_r, cfg, slot, sdelay)
    want = dl.sync_pull_dense_lanes_plain(*args, want_r, cfg, slot, sdelay)
    equal, err = _equal_all([got, got_r], [want, want_r])
    last = lanes - 1
    solo_r = ring0[last].clone()
    solo = sync.sync_pull_dense(
        state.have[last], heads[last], lo[last], hi[last], peers[last],
        ok[last], meta.nbytes, None, solo_r, cfg, None, sdelay[last], slot)
    _solo_trap("dense_sync_delay lanes", [got[last], got_r[last]],
               [solo, solo_r])
    _trap("lane fault 5", "a session delay wraps the ring: pull slot D - 1 "
          "plus one lands in slot 0, empty before",
          slot == d - 1 and int(sdelay.max()) == 1
          and bool(got_r[:, 0].any()))
    work = ring0.clone()

    def restore():
        work.copy_(ring0)

    nbytes = (_nbytes(state.have, heads, lo, hi, peers, ok, meta.nbytes,
                      sdelay)
              + _changed_bytes([ring0], [got_r]) + lanes * state.have.shape[1])
    return _lane_row(
        "dense_sync_delay_lanes", _CSRC + "dense_sync.cu",
        "corrosion_tpu/sim/sync.py:165", equal, err,
        _timed(timed, lambda: dl.sync_pull_dense_lanes(
            *args, work, cfg, slot, sdelay), restore),
        _timed(timed, lambda: dl.sync_pull_dense_lanes_plain(
            *args, work, cfg, slot, sdelay), restore),
        nbytes, lanes, n=n)


def compare_lane_gaps_exit(dev, gen, lanes, n=STORM_N, timed=True):
    """K14's lane entries in their exit mode at the dense storm's shapes
    (N = 100000, P = 512, A = 16, V = 8, C = 4, K = 8) after every
    payload was injected, over lanes of three kinds — settled (every up
    node holds everything), wiped after convergence (one up row empty
    under set stamps), holes — at the plan's horizon (t + 1 = horizon:
    the flags flip in the settled lanes only) and before it (none):
    equal to the plain version, the last lane to the solo exit mode."""
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim.round import RunMetrics, dense_record

    cfg, meta, _ = _dense_fault_storm(n, dev)
    p = cfg.n_payloads
    t = int(meta.round.max()) + 2
    alive = (_tu8(gen, (lanes, n), 0.03, dev) * 2)
    have = torch.ones((lanes, n, p), dtype=torch.uint8, device=dev)
    kinds = [k % 3 for k in range(lanes)]
    for k, kind in enumerate(kinds):
        up = torch.nonzero(alive[k] == 0).flatten()
        if kind == 1:
            have[k, int(up[1])] = 0  # wiped after it converged
        elif kind == 2:
            have[k] = _tu8(gen, (n, p), 0.5, dev)
    metrics = RunMetrics(
        coverage_at=torch.full((lanes, p), 2, dtype=torch.int32, device=dev),
        converged_at=torch.full((lanes, n), 4, dtype=torch.int32,
                                device=dev),
        overflow_frac=torch.zeros((lanes,), device=dev),
        order_violations=torch.zeros((lanes,), dtype=torch.int32,
                                     device=dev))
    inj = torch.ones((lanes, p), dtype=torch.uint8, device=dev)
    args = (have, inj, alive, metrics, meta, t, cfg)
    equal, err, dones = True, 0, {}
    for horizon in (t + 1, t + 2):
        got = dl.dense_record_lanes(*args, horizon)
        want = dl.dense_record_lanes_plain(*args, horizon)
        e, x = _equal_all(got, want)
        equal, err = equal and e, max(err, x)
        dones[horizon] = want[6].tolist()
        last = lanes - 1
        _solo_trap(f"dense_gaps_exit lanes horizon t+{horizon - t}",
                   [y[last] for y in got],
                   dense_record(have[last], inj[last], alive[last],
                                RunMetrics(*(y[last] for y in metrics)),
                                meta, t, cfg, horizon))
    sticky = dl.dense_record_lanes_plain(*args)[6].tolist()
    _trap("lane fault 6", "done flags flip at the horizon in the settled "
          "lanes only, none before it",
          dones[t + 1] == [kind == 0 for kind in kinds]
          and not any(dones[t + 2]))
    _trap("lane fault 7", "a wipe after convergence un-converges its lane: "
          "the sticky stamps would exit it, the exit mode does not",
          all(sticky[k] and not dones[t + 1][k]
              for k, kind in enumerate(kinds) if kind == 1))
    a, kg = cfg.n_writers, cfg.gap_slots
    nbytes = lanes * (n * p + p + n + p * 4 + n * 4 * 2 + p * 4 * 2
                      + n * a * 4 * (1 + 2 * kg) + 4 + 1)
    return _lane_row(
        "dense_gaps_exit_lanes", _CSRC + "dense_gaps.cu",
        "corrosion_tpu/sim/faults.py:748", equal, err,
        _timed(timed, lambda: dl.dense_record_lanes(*args, t + 1)),
        _timed(timed, lambda: dl.dense_record_lanes_plain(*args, t + 1)),
        nbytes, lanes, n=n, dones=dones[t + 1])


def compare_dense_fault_lane_kernels(dev, seed=12, lanes=ENSEMBLE_LANES,
                                     timed=True, big=True):
    """Phase 3lf: every lane entry of the dense fault loop against its
    plain version at K = 8 on its paths' shapes (K9m's reach at
    fault-storm-1000's, the rest at the 100k dense storms'), each lane
    held to the solo entry on its inputs, every trap reached; ``big``
    False shrinks 100 000 and 1000 nodes to 1200 and 333 (a CPU
    rehearsal)."""
    g = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wide, mid = (STORM_N, MATRIX_N) if big else (1200, 333)
    rows = [compare_lane_reach_matrix(dev, g, lanes, mid, timed=timed),
            compare_lane_node_faults_dense(dev, gen, lanes, wide, mid,
                                           timed),
            compare_lane_broadcast_fault(dev, gen, lanes, wide, timed),
            compare_lane_sync_delay(dev, g, gen, lanes, wide, timed),
            compare_lane_gaps_exit(dev, gen, lanes, wide, timed)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: the rows every dense fault ensemble launches; each path adds its own
DENSE_FAULT_LANE_CORE = ("threefry_lanes", "dense_phases_lanes",
                         "dense_gaps_exit_lanes", "node_faults_dense_lanes",
                         "dense_broadcast_fault_lanes")
#: paths 41-45: (label, spec builder, the rows the path adds, golden name)
DENSE_FAULT_ENSEMBLE_PATHS = (
    ("fault_parity_3node", "parity",
     ("sample_uniform_lanes", "dense_sync_delay_lanes",
      "fault_edges_matrix"), "FAULT_PARITY_3NODE_SEEDS8"),
    ("fault_campaign_3node", "campaign",
     ("sample_uniform_lanes", "dense_sync_delay_lanes",
      "fault_edges_matrix"), "FAULT_CAMPAIGN_3NODE_ENGINE"),
    ("fault_storm_1000_seeds8", "storm1000",
     ("sample_targets_lanes", "merge_entries_lanes", "dense_sync_lanes",
      "fault_edges_matrix", "fault_reach_matrix_lanes"),
     "FAULT_STORM_1000_SEEDS8"),
    ("dense_fault_storm_100k_seeds8", "dense100k",
     ("sample_targets_lanes", "merge_entries_lanes", "dense_sync_lanes",
      "fault_reach_lanes"), "DENSE_FAULT_STORM_100K_SEEDS8"),
    ("dense_latency_storm_100k_seeds8", "latency100k",
     ("sample_targets_lanes", "merge_entries_lanes",
      "dense_sync_delay_lanes", "fault_edges_delay", "fault_reach_lanes"),
     "DENSE_LATENCY_STORM_100K_SEEDS8"),
)


def dense_fault_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "parity": lambda: sp.fault_parity_3node_spec(seeds),
        "campaign": lambda: sp.fault_campaign_3node_spec(0),
        "storm1000": lambda: sp.storm_seeds_spec(seeds, n_nodes=1000,
                                                 faults=True),
        "dense100k": lambda: sp.dense_storm_seeds_spec(seeds),
        "latency100k": lambda: sp.dense_storm_seeds_spec(seeds,
                                                         latency=True),
    }[which]()


def _same_state(a, b) -> bool:
    """Two solo states equal in every field (``t`` included), on the
    device: the check a state digest makes, without the host copy."""
    return all(torch.equal(x, y.to(x.device)) for x, y in zip(a, b))


def _fault_solo_runs(spec, dev):
    """The port's solo runs of a fault path's seeds on the card: the
    spec's plan re-seeded per seed through `run_fault_plan`; each run's
    rounds and p99 node-convergence round (the engine's lower
    percentile), its final state and host wall."""
    from corrosion_tpu_torch.campaign.engine import _percentile_lower
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.state import uniform_payloads

    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every({}))
    out = []
    for s in spec.seeds:
        fplan = compile_plan(spec.fault_plan({}, seed=int(s)), cfg, topo,
                             device=dev)
        state = new_sim(cfg, int(s), dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        final, metrics = run_fault_plan(state, meta, cfg, topo, fplan,
                                        spec.max_rounds)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        out.append(({"rounds": int(final.t),
                     "p99_node_convergence_round": _percentile_lower(
                         metrics.converged_at.cpu().numpy(), 99)},
                    final, wall))
    return out


def dense_fault_ensemble_paths(dev, goldens):
    """Paths 41-45: the dense round's fault ensembles through `campaign.
    engine.run_campaign` (seeds 0-7; fault-campaign-3node its one seed),
    each from zeroed counters: every lane entry of the path launched, no
    solo entry of a kernel that has one; round_path "dense" and the
    plan's horizon; the artifact's spec_hash and result_digest and each
    lane's rounds, p99 and state digest against the golden pinned from
    live JAX.  Every path's lanes each against the port's solo run of
    its seed on this card (the walls beside, with max_memory_allocated);
    at 100k lane 0 also against JAX's solo golden, and the dense fault
    storm's lanes against the packed fault storm ensemble's golden (JAX's
    dense == packed contract).  Returns the launches per path and the
    printed numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest

    launches, numbers = {}, {}
    for label, which, extra, golden_name in DENSE_FAULT_ENSEMBLE_PATHS:
        spec = dense_fault_path_spec(which)
        kept = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated()
        counts = _path_launches(kernels, DENSE_FAULT_LANE_CORE + extra, label)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        cell = art["cells"][0]
        ps = cell["per_seed"]
        finals = kept[0]["finals"]
        lanes = [{"seed": s, "rounds": ps["rounds"][i],
                  "p99_node_convergence_round":
                      ps["p99_node_convergence_round"][i],
                  "digest": state_digest(lane_state(finals, i))}
                 for i, s in enumerate(cell["seeds"])]
        del kept
        got = {"spec_hash": art["spec_hash"],
               "result_digest": art["result_digest"], "lanes": lanes}
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{cell['wall_clock_s']} wall_verdict={cell['wall_verdict']} "
              f"round_path={cell['round_path']} plan_horizon="
              f"{cell['plan_horizon']} all_converged="
              f"{cell['all_converged']}", flush=True)
        if cell["round_path"] != "dense" or cell["plan_horizon"] <= 0:
            raise AssertionError(f"{label}: round_path {cell['round_path']}, "
                                 f"plan_horizon {cell['plan_horizon']}")
        if getattr(goldens, golden_name) != got:
            raise AssertionError(f"{label}: differs from its golden")
        solos = _fault_solo_runs(spec, dev)
        if [rec for rec, _, _ in solos] != [
                {k: v for k, v in lane.items() if k not in ("seed", "digest")}
                for lane in lanes] or not all(
                    _same_state(final, lane_state(finals, i))
                    for i, (_, final, _) in enumerate(solos)):
            raise AssertionError(f"{label}: a lane differs from its solo run")
        del finals
        walls = [wall for _, _, wall in solos]
        entry = {"ensemble_wall_s": cell["wall_clock_s"],
                 "max_memory_allocated_bytes": peak, "solo_walls_s": walls,
                 "solo_walls_sum_s": sum(walls)}
        print(f"{label}: every lane equal to its solo run; ensemble wall "
              f"{cell['wall_clock_s']} s against the solo walls' sum "
              f"{sum(walls):.4f} s ({walls}); max_memory_allocated {peak} "
              "bytes", flush=True)
        if which in ("dense100k", "latency100k"):
            jax_solo = (goldens.DENSE_FAULT_STORM_100K_SEED0
                        if which == "dense100k"
                        else goldens.DENSE_LATENCY_STORM_100K_SEED0)
            if {k: lanes[0][k] for k in jax_solo} != jax_solo:
                raise AssertionError(f"{label}: lane 0 differs from JAX's "
                                     "solo golden")
            if which == "dense100k" and (
                    goldens.FAULT_STORM_100K_SEEDS8["lanes"] != lanes):
                raise AssertionError(f"{label}: lanes differ from the packed "
                                     "fault storm ensemble's golden")
        numbers[label] = entry
        _lap(label)
    return launches, numbers


def profile_dense_fault_lanes(dev, lanes=ENSEMBLE_LANES, start=DENSE_FAULT_T,
                              rounds=3, telemetry=False):
    """``rounds`` rounds of the 8-lane dense-fault-storm-100k from round
    ``start`` through the lane fault loop's body, as `run_dense_lanes`
    runs them (K11d's lane entry, the lane round with its slice, the one
    host read of the [K] flags); the first ``start`` rounds are setup.
    With ``telemetry`` every round records each lane's row in a lane
    trace, as a recording ensemble does.  `profile_dense_fault` gives
    the solo round."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_plan_seeds, seed_states)
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.dense_lanes import (
        dense_round_step_lanes, lane_batch, trace_of)
    from corrosion_tpu_torch.sim.telemetry import new_trace_lanes
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta, fplan = _dense_fault_storm(STORM_N, dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    horizon = fplan.horizon
    seeds = lane_plan_seeds(range(lanes), dev)

    def step(batch):
        t = int(batch.slim.t)
        rf = faults.round_faults(fplan, t)
        faults.apply_node_faults_lanes(batch.slim, rf)
        state, metrics, done = dense_round_step_lanes(
            batch.slim, batch.metrics, meta, cfg, topo, region, rf, horizon,
            batch.seeds, activity[min(t, horizon)],
            trace_of(batch.extra) if telemetry else None)
        done.tolist()  # the loop's one host read a round
        return batch._replace(slim=state, metrics=metrics)

    def setup():
        trace = (new_trace_lanes(cfg, start + 2 * rounds, lanes, dev)
                 if telemetry else None)
        batch = lane_batch(seed_states(cfg, range(lanes), dev), cfg, seeds,
                           trace)
        for _ in range(start):
            batch = step(batch)
        torch.cuda.synchronize()
        return batch

    def run(batch):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            batch = step(batch)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"dense fault storm-100k x{lanes} lanes "
                    f"rounds {start}-{start + rounds - 1}"
                    + (" with the recorder" if telemetry else ""), setup)


# -- the flight recorder on the dense round's lanes (phase 3lr, paths 46-50) --

SOLO_OF_LANE.update({"trace_counts_dense_lanes": "trace_counts_dense",
                     "trace_wire_rows_lanes": "trace_wire_rows",
                     "trace_row_lanes": "trace_row"})
_TEL = "corrosion_tpu/sim/telemetry.py"


def compare_lane_coverage_dense(dev, gen, lanes, n=STORM_N, p=512,
                                timed=True):
    """K17's dense lane entry at the 8-lane dense fault storm's shapes (N
    = 100000, P = 512): ``have0`` a mid-storm holding that grows with the
    lane, ``have`` it plus the round's arrivals, 3 % dead rows, into
    [K, 3, P] count rows that already hold counts (the entry adds);
    equal to the plain version, the last lane to the solo dense entry."""
    from corrosion_tpu_torch.sim import telemetry as tel

    have0 = torch.stack([_tu8(gen, (n, p), 0.2 + 0.05 * k, dev)
                         for k in range(lanes)])
    have = have0 | _tu8(gen, (lanes, n, p), 0.1, dev)
    alive = _tu8(gen, (lanes, n), 0.03, dev) * 2
    base = torch.randint(0, 1000, (lanes, 3, p), generator=gen, device=dev,
                         dtype=torch.int32)
    got, want = base.clone(), base.clone()
    tel.coverage_delivered_dense_lanes_(got[:, 0:2], have, have0, alive)
    tel.coverage_delivered_dense_lanes_plain(want[:, 0:2], have, have0,
                                             alive)
    equal, err = _equal_all([got], [want])
    last = lanes - 1
    solo = base[last].clone()
    tel.coverage_delivered_dense_(solo[0:2], have[last], have0[last],
                                  alive[last])
    _solo_trap("trace_counts_dense lanes", [got[last]], [solo])
    cov = (got - base)[:, 0].sum(dim=1).tolist()
    _trap("lane trace 1", "each lane's coverage lands in its own rows, "
          "lanes differing, the grant rows untouched",
          len(set(cov)) == lanes and torch.equal(got[:, 2], base[:, 2]))
    work = base.clone()

    def restore():
        work.copy_(base)

    return _lane_row(
        "trace_counts_dense_lanes", _CSRC + "trace_counts.cu",
        "corrosion_tpu/sim/round.py:218", equal, err,
        _timed(timed, lambda: tel.coverage_delivered_dense_lanes_(
            work[:, 0:2], have, have0, alive), restore),
        _timed(timed, lambda: tel.coverage_delivered_dense_lanes_plain(
            work[:, 0:2], have, have0, alive), restore),
        _nbytes(have, have0, alive) + lanes * 2 * p * 4, lanes, n=n)


def compare_lane_wire_rows(dev, gen, lanes, n=STORM_N, f=3, timed=True):
    """K18's rows lane entry at the 8-lane dense storm's shapes (N =
    100000, F = 3): each lane's per-node frames and bytes (up to 512
    payloads of 8 KiB a row) over its ok edges (more of them in later
    lanes) into its slots of [K, 12] accumulators that already hold
    totals; equal to the plain version, the last lane to the solo rows
    entry, every lane's byte total past 2^31 (int64 exact)."""
    from corrosion_tpu_torch.sim import telemetry as tel

    frames = torch.randint(0, 513, (lanes, n), generator=gen, device=dev,
                           dtype=torch.int32)
    nbytes_ = frames * 8192
    share = torch.tensor([0.5 + 0.05 * k for k in range(lanes)], device=dev)
    ok = torch.rand((lanes, n * f), generator=gen, device=dev) < share[:, None]
    base = torch.randint(0, 1 << 40, (lanes, len(tel.ACC)), generator=gen,
                         device=dev, dtype=torch.int64)
    got, want = base.clone(), base.clone()
    tel.wire_rows_lanes_(got[:, tel.WIRE], frames, nbytes_, ok, f)
    tel.wire_rows_lanes_plain(want[:, tel.WIRE], frames, nbytes_, ok, f)
    equal, err = _equal_all([got], [want])
    last = lanes - 1
    solo = base[last].clone()
    tel.wire_rows_(solo[tel.WIRE], frames[last], nbytes_[last], ok[last], f)
    _solo_trap("trace_wire_rows lanes", [got[last]], [solo])
    added = (got - base)[:, 1].tolist()
    _trap("lane trace 2", "each lane's byte total, past 2^31, in its own "
          "slot, lanes differing, the other slots untouched",
          min(added) > 1 << 31 and len(set(added)) == lanes
          and torch.equal(got[:, 2:], base[:, 2:]))
    work = base.clone()

    def restore():
        work.copy_(base)

    return _lane_row(
        "trace_wire_rows_lanes", _CSRC + "trace_wire.cu",
        "corrosion_tpu/sim/broadcast.py:254", equal, err,
        _timed(timed, lambda: tel.wire_rows_lanes_(
            work[:, tel.WIRE], frames, nbytes_, ok, f), restore),
        _timed(timed, lambda: tel.wire_rows_lanes_plain(
            work[:, tel.WIRE], frames, nbytes_, ok, f), restore),
        _nbytes(frames, nbytes_, ok) + lanes * 2 * 8, lanes, n=n)


def _lane_trace_row_case(gen, dev, lanes, n, p, swim, every, rounds=40,
                         m=64):
    """A lane trace mid-run and the rest of a row's inputs: per-lane
    accumulators (bytes past 2^31, each lane its own) and count rows,
    member tables (partial view) or beliefs (full view), a shared fault
    slice with crashes and wipes, per-lane sessions and overflow."""
    from corrosion_tpu_torch.sim import telemetry as tel
    from corrosion_tpu_torch.sim.state import SimConfig

    kw = ({"swim_partial_view": True, "member_slots": m} if swim == "partial"
          else {"swim_full_view": True})
    cfg = SimConfig(n_nodes=n, n_payloads=p, trace_every=every, **kw)
    trace = tel.new_trace_lanes(cfg, rounds, lanes, dev)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    for name in tel.CHANNELS:
        x = getattr(trace, name)
        x.copy_(ints(0, 99, tuple(x.shape)).to(x.dtype))
    trace.acc[:, :5] = ints(0, 1 << 20, (lanes, 5), torch.int64)
    trace.acc[:, 1] += 1 << 36
    trace.counts.copy_(ints(0, 3 * n, (lanes, 3, p)))
    state = SimpleNamespace(pid=None, pkey=None, view=None)
    if swim == "partial":
        state.pid = ints(-1, n, (lanes, n, m))
        state.pkey = ints(-1, 40, (lanes, n, m))
    else:
        state.view = ints(-1, 3, (lanes, n, n), torch.int8)
    rf = SimpleNamespace(alive=ints(-1, 3, (n,), torch.int8),
                         wipe=_tu8(gen, (n,), 0.01, dev).bool())
    args = dict(alive=_tu8(gen, (lanes, n), 0.03, dev) * 2, state=state,
                cfg=cfg, rf=rf, sync_ok=_tu8(gen, (lanes, 3 * n), 0.3,
                                             dev).bool(),
                n_overflow=ints(0, n, (lanes,)), nbytes=torch.full(
                    (p,), 8192, dtype=torch.int32, device=dev))
    return trace, args


def compare_lane_trace_row(dev, gen, lanes, n=STORM_N, p=512, full_n=CHURN_N,
                           timed=True):
    """K19's lane entry at the 8-lane dense fault storm's shapes (N =
    100000, P = 512, partial view M = 64) and on full-view beliefs (N =
    4096), each at a sample row and at trace_every 2's scratch row, under
    a shared fault slice: every channel of every lane equal to the plain
    version, the last lane to the solo entry, each lane's accumulators
    zeroed by its own last block."""
    from corrosion_tpu_torch.sim import telemetry as tel

    equal, err = True, 0
    timed_case = None
    for swim, nn in (("partial", n), ("full", full_n)):
        for every, t in ((1, 7), (2, 7)):
            trace, args = _lane_trace_row_case(gen, dev, lanes, nn, p, swim,
                                               every)
            row = tel.trace_row(trace, t, every)
            got, want = _clone_trace(trace), _clone_trace(trace)
            tel.record_row_lanes(got, row, **args)
            tel.record_row_lanes_plain(want, row, **args)
            e, x = _equal_all(list(got), list(want))
            equal, err = equal and e, max(err, x)
            last = lanes - 1
            solo = _clone_trace(tel.lane_trace(trace, last))
            st = args["state"]
            tel.record_row(solo, row, alive=args["alive"][last],
                           state=SimpleNamespace(
                               pid=None if st.pid is None else st.pid[last],
                               pkey=None if st.pkey is None
                               else st.pkey[last],
                               view=None if st.view is None
                               else st.view[last]),
                           cfg=args["cfg"], rf=args["rf"],
                           sync_ok=args["sync_ok"][last],
                           n_overflow=args["n_overflow"][last],
                           nbytes=args["nbytes"])
            _solo_trap(f"trace_row lanes {swim} every {every}",
                       list(tel.lane_trace(got, last)), list(solo))
            rows_of = set(zip(*(getattr(got, name)[:, row].tolist()
                                for name in ("up_nodes", "swim_suspect",
                                             "sync_sessions"))))
            _trap(f"lane trace 3{swim[0]}{every}", f"{swim} view, "
                  f"trace_every {every} (row {row} of "
                  f"{trace.up_nodes.shape[1]}): every lane's row written "
                  "from its own inputs and its accumulators zeroed, the "
                  "shared slice's crashes in every lane",
                  len(rows_of) == lanes and not bool(got.acc.any())
                  and not bool(got.counts.any())
                  and bool((got.crashes[:, row] > 0).all())
                  and (every == 1 or row == trace.up_nodes.shape[1] - 1))
            if timed_case is None:
                timed_case = (trace, args, row)
            del got, want, solo
    trace, args, row = timed_case
    work = _clone_trace(trace)

    def restore():
        work.acc.copy_(trace.acc)
        work.counts.copy_(trace.counts)

    st = args["state"]
    nbytes = (_nbytes(args["alive"], st.pid, st.pkey, args["rf"].alive,
                      args["rf"].wipe, args["sync_ok"], args["n_overflow"],
                      args["nbytes"], trace.acc, trace.counts)
              + _nbytes(trace.acc, trace.counts)
              + lanes * (2 * p * 4 + 14 * 4))
    return _lane_row(
        "trace_row_lanes", _CSRC + "trace_row.cu", _TEL + ":202", equal, err,
        _timed(timed, lambda: tel.record_row_lanes(work, row, **args),
               restore),
        _timed(timed, lambda: tel.record_row_lanes_plain(work, row, **args),
               restore),
        nbytes, lanes, n=n)


def _lane_hashes(c, lanes, edge_draws):
    """u32 hashes the loss draws of case ``c`` need at least: the words
    (four bytes) holding an (edge, payload) cell that sends on an edge
    ``edge_draws`` marks [K, E]."""
    hashes = 0
    s = c.state
    for k in range(lanes):
        sending = ((s.have[k] > 0) & (s.relay_left[k] > 0)
                   & (s.injected[k] > 0)[None, :]).repeat_interleave(
                       c.cfg.fanout, dim=0) & edge_draws[k][:, None]
        hashes += int(sending.reshape(sending.shape[0], -1, 4).any(
            dim=2).sum())
        del sending
    return hashes


def compare_lane_broadcast_trace(dev, g, gen, lanes, n=STORM_N, n1k=PROTO_1K,
                                 timed=True):
    """K12's and K12f's lane entries with the recorder's outputs: the
    faultless entry at broadcast-1k-seeds8's shapes (N = 1000, P = 256,
    F = 3, D = 4, the default budget; path 46's case and a trap under a
    flat loss threshold of 51), the fault entry at the 8-lane dense fault
    storm's round 5 (N = 100000, P = 512, D = 2) under the storm's fault
    loss; ring, relay, each lane's frames and bytes a row and its
    dropped slot equal to the plain version, the last lane to the solo
    entry, every lane's drops in its own slot of [K, 12] accumulators."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import telemetry as tel

    cfg1, meta1 = _broadcast_cfg(dev, n1k, 256)
    xs, targets, dst, slot, ok, keys = _lane_round_inputs(g, dev, cfg1,
                                                          meta1, 20, lanes)
    flat = dict(have=xs[0], relay=xs[1], injected=xs[2], ring=xs[3],
                alive=xs[5], nbytes=meta1.nbytes,
                budget=cfg1.rate_limit_bytes_round, targets=targets,
                dst=dst, slot=slot, ok=ok, k_drop=keys, c=None, n=n1k)
    cfg, meta, fplan = _dense_fault_storm(n, dev)
    c = _lane_wire_case(gen, dev, cfg, meta, fplan, DENSE_FAULT_T, lanes)
    s = c.state
    fault = dict(have=s.have, relay=s.relay_left, injected=s.injected,
                 ring=s.inflight, alive=s.alive, nbytes=meta.nbytes,
                 budget=cfg.rate_limit_bytes_round, targets=c.targets,
                 dst=c.dst, slot=c.slot, ok=c.ok, k_drop=c.k_drop, c=c, n=n)
    slot_d = tel.ACC.index("bcast_dropped")
    acc0 = torch.randint(0, 1 << 20, (lanes, len(tel.ACC)), generator=gen,
                         device=dev, dtype=torch.int64)
    last = lanes - 1
    rows = []
    for name, x, cases in (("dense_broadcast_lanes_trace", flat,
                            ((51, True), (0, False))),
                           ("dense_broadcast_fault_lanes_trace", fault,
                            ((0, True),))):
        fc = x["c"]

        def outs(x=x):
            zero = torch.zeros_like(x["alive"], dtype=torch.int32)
            return [x["ring"].clone(), x["relay"].clone(), zero,
                    zero.clone(), acc0.clone()]

        def send(kernel, o, thr, drops, x=x, fc=fc, outputs=True):
            fn = (dl.broadcast_send_lanes if kernel
                  else dl.broadcast_send_lanes_plain)
            fn(x["have"], o[1], x["injected"], x["nbytes"], x["budget"],
               x["targets"], x["dst"], x["slot"], x["ok"], x["alive"],
               x["k_drop"], thr, o[0], None if fc is None else fc.keys,
               None if fc is None else fc.fthr, None,
               None if fc is None else (fc.seeds if kernel
                                        else fc.host_seeds),
               *((o[2], o[3], o[4][:, slot_d] if drops else None)
                 if outputs else (None, None, None)))

        equal, err = True, 0
        for thr, drops in cases:
            got, want = outs(), outs()
            send(True, got, thr, drops)
            send(False, want, thr, drops)
            e, m = _equal_all(got, want)
            equal, err = equal and e, max(err, m)
            solo = [y[last].clone() for y in outs()]
            bc.broadcast_send(
                x["have"][last], solo[1], x["injected"][last], x["nbytes"],
                x["budget"], x["targets"][last], x["dst"][last],
                x["slot"][last], x["ok"][last], x["alive"][last],
                x["k_drop"][last], thr, solo[0], solo[2], solo[3],
                solo[4][slot_d] if drops else None,
                phase_key=None if fc is None else fc.keys[last],
                fthr=None if fc is None else fc.fthr[last],
                seed=0 if fc is None else int(fc.seeds[last]))
            _solo_trap(f"{name} thr={thr}", [y[last] for y in got], solo)
            rest = [i for i in range(len(tel.ACC)) if i != slot_d]
            lost = (got[4] - acc0)[:, slot_d].tolist()
            if drops:
                _trap(f"lane trace 4 {name}", "each lane's lost frames in "
                      "its own dropped slot, lanes differing, the other "
                      "slots untouched, frames counted on rows that send",
                      min(lost) > 0 and len(set(lost)) == lanes
                      and torch.equal(got[4][:, rest], acc0[:, rest])
                      and bool((got[2] > 0).any(dim=1).all()))
        base = outs()
        work = [y.clone() for y in base]

        def restore(work=work, base=base):
            for dst_, src_ in zip(work, base):
                dst_.copy_(src_)

        thr, drops = cases[-1]
        draws = (fc.ok & (fc.fthr > 0)) if fc is not None else None
        hashes = 0 if draws is None else _lane_hashes(fc, lanes, draws)
        ops = hashes * OPS_PER_HASH
        nbytes = (_nbytes(x["have"], x["relay"], x["injected"], x["nbytes"],
                          x["targets"], x["dst"], x["slot"], x["ok"],
                          x["alive"])
                  + (_nbytes(fc.fthr) if fc is not None else 0)
                  + _changed_bytes(base[:2], got[:2]) + _nbytes(*got[2:4])
                  + (lanes * 8 if drops else 0))
        row = _lane_row(
            name, _CSRC + "dense_phases.cu",
            "corrosion_tpu/sim/broadcast.py:254", equal, err,
            _timed(timed, lambda send=send, work=work, thr=thr,
                   drops=drops: send(True, work, thr, drops), restore),
            _timed(timed, lambda send=send, work=work, thr=thr,
                   drops=drops: send(False, work, thr, drops), restore),
            nbytes, lanes, ops=ops, hashes=hashes, n=x["n"],
            ms_without_recorder=_timed(
                timed, lambda send=send, work=work, thr=thr: send(
                    True, work, thr, False, outputs=False), restore))
        ops_ms = ops / _int32_ops_per_s() * 1e3
        row["bound_ms"] = max(row["bound_ms"], ops_ms)
        row["bound_by"] = ("operations" if ops_ms > _bound_ms(nbytes)
                           else "bytes")
        rows.append(row)
        del got, want, base, work
    return rows


def compare_lane_sync_trace(dev, g, gen, lanes, n=STORM_N, timed=True):
    """K13's and K13d's lane entries with the grant counts: the dense
    fault storm's sync (N = 100000, P = 512, S = 3, D = 2) at round 5
    and the dense latency storm's with its session delays (D = 4) at
    round 6, each lane's grants added to its own row of [K, 3, P] counts
    that already hold counts (rows 3·P apart); fruitful, the ring and
    the counts equal to the plain version, the last lane to the solo
    entry."""
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import faults, sync
    from corrosion_tpu_torch.sim import telemetry as tel

    rows = []
    for name, (cfg, meta, fplan), t in (
            ("dense_sync_lanes_trace", _dense_fault_storm(n, dev),
             DENSE_FAULT_T),
            ("dense_sync_delay_lanes_trace", _dense_latency_storm(n, dev),
             LATENCY_T)):
        s, d = cfg.sync_peers, cfg.n_delay_slots
        state = _lane_dense_states(gen, dev, cfg, lanes, t)
        adv = [_advertised(g, dev, cfg, state.have[k], 40)
               for k in range(lanes)]
        heads, lo, hi = (_stack(a[i] for a in adv) for i in range(3))
        _, src, dst, ok = _lane_edges_of(gen, dev, state, s)
        rf = faults.round_faults(fplan, t)
        _, sdelay = faults.fault_session_effects(
            rf, src.expand(lanes, -1).reshape(-1), dst.reshape(-1),
            ok.view(-1))
        delayed = name.startswith("dense_sync_delay")
        sdelay = sdelay.view(lanes, -1) if delayed else None
        slot = (t + 1) % d
        peers, ok = dst.view(lanes, -1, s), ok.view(lanes, -1, s)
        counts0 = torch.randint(0, 1000, (lanes, 3, cfg.n_payloads),
                                generator=gen, device=dev, dtype=torch.int32)
        args = (state.have, heads, lo, hi, peers, ok, meta.nbytes, None)
        ring0 = state.sync_inflight

        def pull(fn, ring, counts, sdelay=sdelay, args=args, slot=slot,
                 cfg=cfg):
            return fn(*args, ring, cfg, slot, sdelay,
                      None if counts is None else counts[:, tel.GRANTS])

        got = [ring0.clone(), counts0.clone()]
        want = [ring0.clone(), counts0.clone()]
        fk = pull(dl.sync_pull_dense_lanes, *got)
        fp = pull(dl.sync_pull_dense_lanes_plain, *want)
        equal, err = _equal_all([fk] + got, [fp] + want)
        last = lanes - 1
        solo_r, solo_c = ring0[last].clone(), counts0[last].clone()
        fs = sync.sync_pull_dense(
            state.have[last], heads[last], lo[last], hi[last], peers[last],
            ok[last], meta.nbytes, None,
            solo_r if delayed else solo_r[slot], cfg, solo_c[tel.GRANTS],
            None if sdelay is None else sdelay[last], slot)
        _solo_trap(name, [fk[last], got[0][last], got[1][last]],
                   [fs, solo_r, solo_c])
        grants = (got[1] - counts0)[:, tel.GRANTS].sum(dim=1).tolist()
        _trap(f"lane trace 5{'d' if delayed else ''}", f"{name}: each "
              "lane's grants in its own row, lanes differing, the coverage "
              "rows untouched",
              min(grants) > 0 and len(set(grants)) == lanes
              and torch.equal(got[1][:, :tel.GRANTS],
                              counts0[:, :tel.GRANTS]))
        work = [ring0.clone(), counts0.clone()]

        def restore(work=work, ring0=ring0, counts0=counts0):
            work[0].copy_(ring0)
            work[1].copy_(counts0)

        nbytes = (_nbytes(state.have, heads, lo, hi, peers, ok, meta.nbytes)
                  + (_nbytes(sdelay) if delayed else 0)
                  + _changed_bytes([ring0, counts0], got)
                  + lanes * state.have.shape[1])
        rows.append(_lane_row(
            name, _CSRC + "dense_sync.cu", "corrosion_tpu/sim/sync.py:286",
            equal, err,
            _timed(timed, lambda pull=pull, work=work: pull(
                dl.sync_pull_dense_lanes, *work), restore),
            _timed(timed, lambda pull=pull, work=work: pull(
                dl.sync_pull_dense_lanes_plain, *work), restore),
            nbytes, lanes, n=n,
            ms_without_recorder=_timed(
                timed, lambda pull=pull, work=work: pull(
                    dl.sync_pull_dense_lanes, work[0], None), restore)))
        del state, got, want, work
    return rows


def _lane_counts_plain(rf, src, dst, ok, count, sym):
    """Plain version of K9's and K9m's lane-strided counts: the cut (with
    ``sym`` either direction's) clears ``ok`` in place and adds each
    lane's cleared edges to its slot of ``count`` [K]."""
    from corrosion_tpu_torch.sim import faults

    hit = faults._block_plain(rf, src, dst)
    if sym:
        hit = hit | faults._block_plain(rf, dst, src)
    faults._count_into(count, ok & hit)
    ok &= ~hit


def compare_lane_fault_counts(dev, gen, lanes, n=STORM_N, mid=MATRIX_N,
                              timed=True):
    """K9's, K9's latency entry's and K9m's edge queries with the lanes
    folded into their edge axis and a lane-strided count: the dense
    fault storm's wire cuts at round 5 (factored; 300 000 edges a lane,
    blocks spanning two lanes), the dense latency storm's refused
    sessions at round 6 (the latency entry, with session delays), and
    fault-storm-1000's wire cuts at round 5 (matrix) and the 3-node
    parity plan's at round 6 (nine edges a lane: one block holds every
    lane); ok and every lane's count equal to the plain version, the
    last lane to the solo query, lanes with different cut counts whose
    sum is the folded scalar's."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import telemetry as tel

    counted = (kernels.FAULT_EDGES_LANES_COUNT,
               kernels.FAULT_EDGES_DELAY_LANES_COUNT,
               kernels.FAULT_EDGES_MATRIX_LANES_COUNT)
    pcfg_spec = sp.builtin_spec("fault-parity-3node")
    pcfg = pcfg_spec.sim_config({})
    pplan = faults.compile_plan(pcfg_spec.fault_plan({}, seed=0), pcfg,
                                pcfg_spec.topo({}), device=dev)
    mcfg, _, mplan, _ = _matrix_storm(mid, dev)
    cases = (
        ("fault_edges_lanes_count", _dense_fault_storm(n, dev), DENSE_FAULT_T,
         "bcast_cut", False),
        ("fault_edges_delay_lanes_count", _dense_latency_storm(n, dev),
         LATENCY_T, "sync_refused", True),
        ("fault_edges_matrix_lanes_count", (mcfg, None, mplan), 5,
         "bcast_cut", False),
        ("fault_edges_matrix_lanes_count", (pcfg, None, pplan), 6,
         "bcast_cut", False))
    rows, seen = [], set()
    for name, (cfg, _, fplan), t, slot_name, sym in cases:
        state = _lane_dense_states(gen, dev, cfg, lanes, t)
        f = cfg.sync_peers if sym else cfg.fanout
        _, src, dst, ok0 = _lane_edges_of(gen, dev, state, f)
        rf = faults.round_faults(fplan, t)
        ok0[0] = False  # a lane with nothing to cut
        src = src.expand(lanes, -1).reshape(-1).contiguous()
        dst = dst.reshape(-1)
        ok0 = ok0.reshape(-1)
        slot = tel.ACC.index(slot_name)
        acc0 = torch.randint(0, 1 << 20, (lanes, len(tel.ACC)),
                             generator=gen, device=dev, dtype=torch.int64)

        def query(kernel, ok, acc, rf=rf, src=src, dst=dst, sym=sym,
                  slot=slot):
            count = None if acc is None else acc[:, slot]
            if not kernel:
                _lane_counts_plain(rf, src, dst, ok, count, sym)
            elif sym:
                faults.fault_session_effects(rf, src, dst, ok, count)
            else:
                faults.fault_wire_effects(rf, src, dst, ok, count)

        got, want = [ok0.clone(), acc0.clone()], [ok0.clone(), acc0.clone()]
        before = [k.launches for k in counted]
        query(True, *got)
        launched = [k.name for k, b in zip(counted, before)
                    if k.launches > b]
        if dev.type == "cuda" and launched != [name]:
            raise AssertionError(f"{name}: launched {launched}")
        query(False, *want)
        equal, err = _equal_all(got, want)
        e = ok0.numel() // lanes
        last = lanes - 1
        ok_s = ok0[last * e:].clone()
        cnt = acc0[last, slot].clone()
        if sym:
            faults.fault_session_effects(rf, src[last * e:], dst[last * e:],
                                         ok_s, cnt)
        else:
            faults.fault_wire_effects(rf, src[last * e:], dst[last * e:],
                                      ok_s, cnt)
        _solo_trap(f"{name} e={e}", [got[0][last * e:], got[1][last, slot]],
                   [ok_s, cnt])
        folded = acc0[0, slot].clone()
        ok_f = ok0.clone()
        if sym:
            faults.fault_session_effects(rf, src, dst, ok_f, folded)
        else:
            faults.fault_wire_effects(rf, src, dst, ok_f, folded)
        per_lane = (got[1] - acc0)[:, slot]
        print(f"{name} e={e}: per-lane counts {per_lane.tolist()}",
              flush=True)
        _trap(f"lane trace 6 {name} e={e}", "each lane's cleared edges in "
              "its own slot, a lane without ok edges at 0 beside lanes that "
              "cut, their sum the folded scalar's"
              + (", one block across every lane" if e < 256
                 else ", blocks spanning two lanes"),
              len(set(per_lane.tolist())) > 1
              and int(per_lane.sum()) == int(folded - acc0[0, slot])
              and (e < 256 or e % 256 != 0))
        if name in seen:
            continue
        seen.add(name)
        work = [ok0.clone(), acc0.clone()]

        def restore(work=work, ok0=ok0, acc0=acc0):
            work[0].copy_(ok0)
            work[1].copy_(acc0)

        nbytes = (_nbytes(src, dst, ok0) + _changed_bytes([ok0], [got[0]])
                  + lanes * 8)
        rows.append(_lane_row(
            name, _CSRC + "fault_edges.cu",
            "corrosion_tpu/sim/faults.py:" + ("303" if sym else "195"),
            equal, err,
            _timed(timed, lambda query=query, work=work: query(True, *work),
                   restore),
            _timed(timed, lambda query=query, work=work: query(False, *work),
                   restore),
            nbytes, lanes, n=cfg.n_nodes, e=e,
            ms_without_recorder=_timed(
                timed, lambda query=query, work=work: query(
                    True, work[0], None), restore)))
        del state
    return rows


def compare_dense_lane_trace_kernels(dev, seed=13, lanes=ENSEMBLE_LANES,
                                     timed=True, big=True):
    """Phase 3lr: every lane entry the flight recorder adds to the dense
    round's lanes against its plain version at K = 8 on its paths'
    shapes (the 8-lane dense fault storm's, the full view's at 4096,
    K9m's at fault-storm-1000's and the 3-node plan's), each lane held
    to the solo entry on its inputs, every trap reached; ``big`` False
    shrinks 100 000, 4096 and 1000 nodes to 1200, 96 and 333 (a CPU
    rehearsal)."""
    g = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wide, full, mid = (STORM_N, CHURN_N, MATRIX_N) if big else (1200, 96, 333)
    rows = [compare_lane_coverage_dense(dev, gen, lanes, wide, timed=timed),
            compare_lane_wire_rows(dev, gen, lanes, wide, timed=timed),
            compare_lane_trace_row(dev, gen, lanes, wide, full_n=full,
                                   timed=timed),
            *compare_lane_broadcast_trace(dev, g, gen, lanes, wide,
                                          timed=timed),
            *compare_lane_sync_trace(dev, g, gen, lanes, wide, timed),
            *compare_lane_fault_counts(dev, gen, lanes, wide, mid, timed)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: the rows every recording dense ensemble launches (besides K12's inject
#: and deliver lane entries, `TRACE_LANE_ENTRIES`)
TRACE_LANE_CORE = ("threefry_lanes", "trace_counts_dense_lanes",
                   "trace_wire_rows_lanes", "trace_row_lanes")
TRACE_LANE_ENTRIES = ("dense_inject_lanes", "dense_deliver_lanes")
#: paths 46-50: (label, spec builder, the rows the path adds, golden name)
TRACE_ENSEMBLE_PATHS = (
    ("broadcast_1k_seeds8_telemetry", "broadcast",
     ("dense_gaps_lanes", "sample_uniform_lanes",
      "dense_broadcast_lanes_trace", "dense_sync_lanes_trace"),
     "BROADCAST_1K_SEEDS8"),
    ("broadcast_1k_seeds8_wire", "wire",
     ("dense_gaps_lanes", "sample_uniform_lanes",
      "dense_broadcast_lanes_trace", "dense_sync_lanes_trace"),
     "BROADCAST_1K_SEEDS8_WIRE"),
    ("fault_parity_3node_telemetry", "parity",
     ("dense_gaps_exit_lanes", "node_faults_dense_lanes",
      "sample_uniform_lanes", "dense_broadcast_fault_lanes_trace",
      "dense_sync_delay_lanes_trace", "fault_edges_matrix_lanes_count"),
     "FAULT_PARITY_3NODE_SEEDS8"),
    ("dense_fault_storm_100k_seeds8_telemetry", "dense100k",
     ("dense_gaps_exit_lanes", "node_faults_dense_lanes",
      "sample_targets_lanes", "merge_entries_lanes", "fault_reach_lanes",
      "dense_broadcast_fault_lanes_trace", "dense_sync_lanes_trace",
      "fault_edges_lanes_count"),
     "DENSE_FAULT_STORM_100K_SEEDS8"),
    ("dense_latency_storm_100k_seeds8_telemetry", "latency100k",
     ("dense_gaps_exit_lanes", "node_faults_dense_lanes",
      "sample_targets_lanes", "merge_entries_lanes", "fault_reach_lanes",
      "dense_broadcast_fault_lanes_trace", "dense_sync_delay_lanes_trace",
      "fault_edges_delay_lanes_count"),
     "DENSE_LATENCY_STORM_100K_SEEDS8"),
    ("swim_churn_partial_4096_seeds8_telemetry", "partial4096",
     ("dense_gaps_lanes", "sample_targets_lanes", "merge_entries_lanes",
      "detect_partial_lanes", "dense_broadcast_lanes_trace",
      "dense_sync_lanes_trace"),
     "SWIM_CHURN_PARTIAL_4096_SEEDS8"),
)


def trace_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "broadcast": lambda: sp.broadcast_seeds_spec(seeds),
        "wire": lambda: sp.broadcast_wire_seeds_spec(seeds),
        "parity": lambda: sp.fault_parity_3node_spec(seeds),
        "dense100k": lambda: sp.dense_storm_seeds_spec(seeds),
        "latency100k": lambda: sp.dense_storm_seeds_spec(seeds,
                                                         latency=True),
        "partial4096": lambda: sp.swim_churn_partial_spec(seeds=seeds),
    }[which]()


def _solo_traces(spec, dev):
    """The port's solo telemetry runs of a path's seeds on the card (the
    detect loop, the fault loop under the spec's plan re-seeded per
    seed, or the convergence loop): each run's rounds, trace and wall."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.runner import churn_setup
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.telemetry import run_membership_detect

    cfg, topo = spec.sim_config({}), spec.topo({})
    out = []
    for s in spec.seeds:
        s = int(s)
        if spec.detect_membership({}):
            meta, state = churn_setup(cfg, s, dev)
        else:
            meta = uniform_payloads(cfg, dev,
                                    inject_every=spec.inject_every({}))
            state = new_sim(cfg, s, dev)
        plan = (None if spec.detect_membership({})
                else spec.fault_plan({}, seed=s))
        fplan = None if plan is None else compile_plan(plan, cfg, topo,
                                                       device=dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if spec.detect_membership({}):
            final, _, _, trace = run_membership_detect(
                state, meta, cfg, topo, spec.max_rounds, telemetry=True,
                device=dev)
        elif fplan is not None:
            final, _, trace = run_fault_plan(state, meta, cfg, topo, fplan,
                                             spec.max_rounds, telemetry=True)
        else:
            final, _, trace = run_to_convergence(
                state, meta, cfg, topo, spec.max_rounds, telemetry=True)
        torch.cuda.synchronize()
        out.append((int(final.t), trace, time.monotonic() - t0))
    return out


def _lanes_equal_solo_traces(traces, solos, label):
    """Every field of each lane's trace (its sixteen channels over all
    ``max_rounds`` rows, zero past its exit, and its emptied
    accumulators) equal to its solo telemetry run's."""
    from corrosion_tpu_torch.sim.telemetry import lane_trace

    for k, (_, solo, _) in enumerate(solos):
        lane = lane_trace(traces, k)
        bad = [name for name, a, b in zip(lane._fields, lane, solo)
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label}: lane {k}'s trace differs from "
                                 f"its solo telemetry run in {bad}")


def _wire_within(got, want, rounds, label, m_bcast, m_sync):
    """``wire_bytes`` of a summary (the port's exact totals rounded once a
    round) within the f32 bound of JAX's (its sums of m f32 terms a
    round): (m + 1)·2⁻²⁴ of each round, over the rounds, plus both
    sums' rounding; the rest of the summary exactly."""
    g, w = dict(got), dict(want)
    gw, ww = g.pop("wire_bytes"), w.pop("wire_bytes")
    if g != w:
        raise AssertionError(f"{label}: telemetry summary {g} != golden {w}")
    for key, m in (("broadcast", m_bcast), ("sync", m_sync)):
        total = abs(ww[key]) * (1 + F32_ULP)
        limit = (m + 1 + 2 * rounds) * F32_ULP * total + 0.1
        if abs(gw[key] - ww[key]) > limit:
            raise AssertionError(f"{label}: wire_bytes.{key} {gw[key]} vs "
                                 f"golden {ww[key]} (limit {limit})")
    return max(abs(gw[k] - ww[k]) / max(ww[k], 1.0)
               for k in ("broadcast", "sync"))


def trace_ensemble_paths(dev, goldens, trace_dir):
    """Paths 46-50: the flight recorder on the dense round's lanes through
    `campaign.engine.run_campaign` (seeds 0-7), each from zeroed
    counters: every recording lane entry of the path launched, no solo
    entry of a kernel that has a lane entry; the artifact's spec_hash and
    result_digest against the golden pinned from live JAX (a recording
    run's digest is the plain run's; the wire cell's carries its
    wire_bytes), each lane's summary against the pinned ones (at 100k
    every key but wire_bytes exactly, wire_bytes within the f32 bound),
    and every lane's whole trace against its solo telemetry run on this
    card (the wire cell's lanes against the broadcast path's solos; the
    partial-4096 lanes against their trace digests, pinned from a run
    whose lanes equalled their solo runs).
    fault-parity-3node writes its per-lane JSONL under ``trace_dir``,
    which is read back.  Returns the launches per path and the printed
    numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import _lane_trace_path
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.sim.telemetry import (
        lane_trace, trace_digest, trace_rows)

    launches, numbers, solos_of = {}, {}, {}
    for label, which, extra, golden_name in TRACE_ENSEMBLE_PATHS:
        spec = trace_path_spec(which)
        kept = {}
        tdir = trace_dir if which == "parity" else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, telemetry=which != "wire", trace_dir=tdir,
                           device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated()
        counts = _path_launches(kernels, TRACE_LANE_CORE + extra, label,
                                telemetry=True, entries=TRACE_LANE_ENTRIES)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        cell = art["cells"][0]
        traces = kept[0]["traces"]
        rounds = cell["per_seed"]["rounds"]
        golden = getattr(goldens, golden_name)
        got = {"spec_hash": art["spec_hash"],
               "result_digest": art["result_digest"]}
        summaries = (cell["telemetry"]["per_seed"] if "telemetry" in cell
                     else None)
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{cell['wall_clock_s']} round_path={cell['round_path']} "
              f"rounds={rounds} summaries={json.dumps(summaries)}",
              flush=True)
        if cell["round_path"] != "dense" or any(
                got[k] != golden[k] for k in got):
            raise AssertionError(f"{label}: differs from its golden")
        entry = {"ensemble_wall_s": cell["wall_clock_s"],
                 "max_memory_allocated_bytes": peak}
        if which == "broadcast":
            tel = goldens.BROADCAST_1K_SEEDS8_TELEMETRY
            lane0 = dict(goldens.BROADCAST_1K_SEED0_TELEMETRY["summary"],
                         wire_bytes=goldens.BROADCAST_1K_SEED0_TELEMETRY[
                             "wire_bytes"])
            if summaries != tel["summaries"] or summaries[0] != lane0:
                raise AssertionError(f"{label}: lane summaries differ")
        elif which == "wire":
            if cell["per_seed"]["wire_bytes"] != golden["wire_bytes"] or (
                    "telemetry" in cell):
                raise AssertionError(f"{label}: wire_bytes differ")
        elif which == "parity":
            if summaries != goldens.FAULT_PARITY_3NODE_SEEDS8_TELEMETRY[
                    "summaries"]:
                raise AssertionError(f"{label}: lane summaries differ")
            for k, seed in enumerate(spec.seeds):
                path = _lane_trace_path(trace_dir, spec, 0, seed)
                with open(path) as f:
                    lines = [json.loads(line) for line in f]
                head = lines[0]
                want_rows = trace_rows(lane_trace(traces, k), rounds[k],
                                       spec.sim_config({}))
                if (head["summary"] != summaries[k] or head["seed"] != seed
                        or head["spec_hash"] != art["spec_hash"]
                        or lines[1:] != want_rows):
                    raise AssertionError(f"{label}: {path} differs")
            print(f"{label}: {len(spec.seeds)} flight-recorder files under "
                  f"{trace_dir} equal to the lanes' rows", flush=True)
        elif which == "dense100k":
            solo0 = goldens.DENSE_FAULT_STORM_100K_SEED0_TELEMETRY
            wants = [dict(solo0["summary"],
                          wire_bytes=solo0["wire_bytes"])] + list(
                goldens.DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY[
                    "summaries"])
            entry["wire_bytes_worst_relative_gap"] = max(
                _wire_within(g, w, r, f"{label} lane {k}", 300_000, 512)
                for k, (g, w, r) in enumerate(zip(summaries, wants, rounds)))
        elif which == "partial4096":
            want = goldens.SWIM_CHURN_PARTIAL_4096_SEED0_TELEMETRY
            lane0 = {"summary": summaries[0],
                     "trace_digest": trace_digest(lane_trace(traces, 0),
                                                  rounds[0])}
            if lane0 != want:
                raise AssertionError(f"{label}: lane 0 {lane0} != {want}")
        if which == "partial4096":
            # each lane's trace against the digests pinned from a run
            # whose lanes equalled their solo recording runs
            want = goldens.SWIM_CHURN_PARTIAL_4096_SEEDS8_TRACES
            digests = [trace_digest(lane_trace(traces, k), r)
                       for k, r in enumerate(rounds)]
            if rounds != want["rounds"] or digests != want["trace_digests"]:
                raise AssertionError(f"{label}: lane traces {digests} differ "
                                     "from the pinned ones")
            print(f"{label}: every lane's trace digest pinned; max_memory_"
                  f"allocated {peak} bytes", flush=True)
        else:
            solos = solos_of.get("broadcast") if which == "wire" else None
            if solos is None:
                solos = _solo_traces(spec, dev)
            if [r for r, _, _ in solos] != rounds:
                raise AssertionError(f"{label}: rounds differ from the "
                                     "solos'")
            _lanes_equal_solo_traces(traces, solos, label)
            if which == "broadcast":
                solos_of[which] = solos
            walls = [w for _, _, w in solos]
            entry.update(solo_walls_s=walls, solo_walls_sum_s=sum(walls))
            print(f"{label}: every lane's trace equal to its solo telemetry "
                  f"run; ensemble wall {cell['wall_clock_s']} s against the "
                  f"solo walls' sum {sum(walls):.4f} s; max_memory_allocated "
                  f"{peak} bytes", flush=True)
        if which != "wire":
            _trap(f"lane trace 7 {which}", "lanes that finish in different "
                  "rounds leave with their traces (rows past each exit "
                  "zero, equal to the solo run's)", len(set(rounds)) > 1)
        del kept, traces
        numbers[label] = entry
        _lap(label)
    return launches, numbers


# -- topology families and PeerSwap on the dense round's lanes (phase 3lt,
# paths 51-54) -----------------------------------------------------------------

SOLO_OF_LANE.update({"edge_slots_lanes": "edge_slots",
                     "degree_caps_lanes": "degree_caps",
                     "edge_reach_lanes": "edge_reach",
                     "dense_broadcast_tiered_lanes": "dense_broadcast_tiered",
                     "dense_broadcast_tiered_lanes_trace":
                         "dense_broadcast_tiered",
                     "sample_view_lanes": "sample_view",
                     "peerswap_lanes": "peerswap"})
#: the ring slots of the 100k dense WAN storm (path 54)
WAN_D = 3


def _lane_split_trap(label, got):
    """Lanes of one input that differ only by their keys must draw
    differently: some lane's output differs from lane 0's."""
    _trap(f"lane topo {label}", "lanes of one input whose draws differ "
          "(each lane draws under its own key)",
          any(not torch.equal(got[k], got[0]) for k in range(1, len(got))))


def _flat_block_trap(label, per_lane):
    _trap(f"lane topo {label}", f"blocks spanning two lanes: {per_lane} "
          "elements a lane is not a multiple of the 256-thread block, so "
          "lane k's slice starts inside a block of the flat [K, ...] layout "
          "(each lane's grid row offsets it in 64 bits)", per_lane % 256 != 0)


def compare_lane_edge_slots(dev, g, lanes, n=STORM_N, n1k=PROTO_1K,
                            timed=True):
    """K20's edge lane entry: wan-3x2's AZ delays at the 100k WAN storm's
    shapes (K lanes of E = 300000, D = 3) with and without a fault plan's
    fixed delay, and wan-fly-6r's measured matrix at path 53's (N = 1000,
    D = 6) with fixed delays that wrap the ring; the last lane held to
    the solo entry."""
    from corrosion_tpu_torch.sim import topology as tp

    rows = []
    for family, nn, d in (("wan-3x2", n, WAN_D), ("wan-fly-6r", n1k, 6)):
        topo = _topo(family)
        region = tp.regions(nn, topo.n_regions, dev)
        e = 3 * nn
        src = torch.arange(nn, dtype=torch.int32,
                           device=dev).repeat_interleave(3)
        dst = torch.as_tensor(g.integers(0, nn, (lanes, e)),
                              dtype=torch.int32, device=dev)
        fdelay = torch.as_tensor(g.integers(0, 3, (lanes, e)),
                                 dtype=torch.int32, device=dev)
        t = 7
        got = [tp.edge_slot_lanes(topo, region, src, dst, t, d, fd)
               for fd in (None, fdelay)]
        want = [tp.edge_slot_lanes_plain(topo, region, src, dst, t, d, fd)
                for fd in (None, fdelay)]
        equal, err = _equal_all(got, want)
        last = lanes - 1
        _solo_trap(f"edge_slots lanes {family} lane {last}",
                   [x[last] for x in got],
                   [tp.edge_slot(topo, region, src, dst[last], t, d, fd)
                    for fd in (None, fdelay[last])])
        if family == "wan-fly-6r":
            delay = tp.edge_delay(topo, region, src[None], dst)
            _trap("lane topo 1", "matrix delay classes 0-5 and a fault "
                  "delay that wrap the ring of D = 6",
                  set(delay.unique().tolist()) == set(range(6))
                  and bool(((t + delay + fdelay) >= 2 * d).any()))
        else:
            _flat_block_trap("2", e)
        rows.append(_dense_lane_row(
            f"edge_slots_lanes_{family}", "edge_slots_lanes",
            "edge_classes.cu", "corrosion_tpu/sim/topology.py:157", equal,
            err,
            _timed(timed, lambda: tp.edge_slot_lanes(topo, region, src, dst,
                                                     t, d, fdelay)),
            _timed(timed, lambda: tp.edge_slot_lanes_plain(
                topo, region, src, dst, t, d, fdelay)),
            e * 4 + lanes * e * 12, lanes, n=nn, e=e, d=d))
    return rows


def compare_lane_degree_caps(dev, g, lanes, n=96, timed=True):
    """K20's caps lane entry on K lanes of hetero-degree's targets at the
    frontier's shapes (N = 96, F = 3; caps 3, 2, 1 round-robin), -1 slots
    among them; the last lane held to the solo entry."""
    from corrosion_tpu_torch.sim import topology as tp

    topo = _topo("hetero-degree")
    tg = np.where(g.random((lanes, n, 3)) < 0.05, -1,
                  g.integers(0, n, (lanes, n, 3)))
    targets = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    got = tp.apply_degree_caps_lanes(targets.clone(), topo)
    want = tp.apply_degree_caps_lanes_plain(targets, topo)
    equal, err = _equal_all([got], [want])
    last = lanes - 1
    _solo_trap(f"degree_caps lanes lane {last}", [got[last]],
               [tp.apply_degree_caps(targets[last].clone(), topo)])
    caps = tp.node_degrees(n, topo, dev)
    masked = (want == -1) & (targets != -1)
    _trap("lane topo 3", "caps below F in some rows only (caps 1 and 2 mask "
          "slots in every lane, rows of cap 3 keep theirs)",
          all(bool(masked[k][caps < 3].any()) for k in range(lanes))
          and not bool(masked[:, caps == 3].any()))
    _flat_block_trap("4", n * 3)
    work = targets.clone()
    return _dense_lane_row(
        "degree_caps_lanes", "degree_caps_lanes", "edge_classes.cu",
        "corrosion_tpu/sim/topology.py:142", equal, err,
        _timed(timed, lambda: tp.apply_degree_caps_lanes(work, topo),
               lambda: work.copy_(targets)),
        _timed(timed, lambda: tp.apply_degree_caps_lanes_plain(targets,
                                                               topo)),
        targets.numel() * 4 + _changed_bytes([targets], [want]), lanes,
        n=n)


def compare_lane_edge_reach(dev, g, lanes, n=STORM_N, timed=True):
    """K20's reach lane entry: wan-3x2's tiers on K lanes of the 100k WAN
    storm's probe (E = N = 100000) and gossip legs (E = 300000), each
    lane under its own key, and the pin topology (a tier at certainty
    beside a tier at 0); the last lane held to the solo entry, and lanes
    of one edge list under their own keys drawing differently."""
    from corrosion_tpu_torch.sim import topology as tp

    rows = []
    keys = _lane_keys(dev, lanes, 7000)
    for label, topo, e in (("", _topo("wan-3x2"), n),
                           ("_e300k", _topo("wan-3x2"), 3 * n),
                           ("_pin", _pin_topo(), n)):
        bound = _boundary_ids(n, topo)
        pairs = [_edge_list(g, n, e, dev, bound) for _ in range(lanes)]
        src = _stack(p[0] for p in pairs)
        dst = _stack(p[1] for p in pairs)
        ok0 = torch.as_tensor(g.random((lanes, e)) < 0.9, device=dev)
        got = tp.tiered_reach_lanes_(ok0.clone(), topo, n, keys, src, dst)
        want = tp.tiered_reach_lanes_plain(ok0.clone(), topo, n, keys, src,
                                           dst)
        equal, err = _equal_all([got], [want])
        last = lanes - 1
        _solo_trap(f"edge_reach lanes{label} lane {last}", [got[last]],
                   [tp.tiered_reach_(ok0[last].clone(), topo, n, keys[last],
                                     src[last], dst[last])])
        region = tp.regions(n, topo.n_regions, dev)
        raw = tp.edge_loss_thresholds_raw(topo, region, src, dst)
        if label == "":
            one = [x[:1].expand(lanes, -1).contiguous()
                   for x in (ok0, src, dst)]
            _lane_split_trap("5", tp.tiered_reach_lanes_(
                one[0].clone(), topo, n, keys, one[1], one[2]))
            _flat_block_trap("6", e)
        if label == "_pin":
            _trap("lane topo 7", "a tier at certainty cuts every edge of it "
                  "in every lane, a tier at 0 cuts none",
                  bool((raw >= 256).any()) and not bool(got[raw >= 256].any())
                  and torch.equal(got[raw == 0], ok0[raw == 0]))
        hashes = int((ok0 & (raw > 0) & (raw < 256)).sum())
        ops = hashes * OPS_PER_HASH
        nbytes = lanes * e * (8 + 2) + lanes * 16
        rate = _int32_ops_per_s()
        work = ok0.clone()
        row = _dense_lane_row(
            "edge_reach_lanes" + label, "edge_reach_lanes", "edge_classes.cu",
            "corrosion_tpu/sim/swim.py:125", equal, err,
            _timed(timed, lambda: tp.tiered_reach_lanes_(work, topo, n, keys,
                                                         src, dst),
                   lambda: work.copy_(ok0)),
            _timed(timed, lambda: tp.tiered_reach_lanes_plain(
                ok0.clone(), topo, n, keys, src, dst)),
            nbytes, lanes, ops=ops, hashes=hashes, e=e)
        ops_ms = ops / rate * 1e3
        row["bound_ms"] = max(row["bound_ms"], ops_ms)
        row["bound_by"] = "operations" if ops_ms > _bound_ms(nbytes) \
            else "bytes"
        rows.append(row)
    return rows


def compare_lane_broadcast_tiered(dev, g, gen, lanes, n=STORM_N,
                                  n1k=PROTO_1K, timed=True):
    """K12t's lane entry and its recording form at the 100k WAN storm's
    shapes (K lanes of N = 100000, P = 512, F = 3, D = 3; the dense fault
    storm's state at round 2, inside its loss window and before its
    split): wan-3x2's tiers alone (path 54's case), with a fault plan's
    loss stream under each lane's phase key and seed, on the pin
    topology, and with one lane without edges; the recording form with
    each lane's frames, bytes and dropped slot; lanes of one input at
    path 52's shapes (N = 1000, P = 256, D = 4) drawing under their own
    keys.  The last lane held to the solo tiered entry."""
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import telemetry as tel

    cfg, meta, fplan = _dense_fault_storm(n, dev, n_delay_slots=WAN_D)
    c = _lane_wire_case(gen, dev, cfg, meta, fplan, 2, lanes)
    s = c.state
    wan, pin = _topo("wan-3x2"), _pin_topo()
    slot_d = tel.ACC.index("bcast_dropped")
    acc0 = torch.randint(0, 1 << 20, (lanes, len(tel.ACC)), generator=gen,
                         device=dev, dtype=torch.int64)
    no_edges = c.ok.clone()
    no_edges[1] = False
    last = lanes - 1

    def outs():
        zero = torch.zeros_like(s.alive, dtype=torch.int32)
        return [s.inflight.clone(), s.relay_left.clone(), zero, zero.clone(),
                acc0.clone()]

    def send(kernel, o, tiers, fault=False, ok=None, record=False):
        fn = (dl.broadcast_send_lanes if kernel
              else dl.broadcast_send_lanes_plain)
        fn(s.have, o[1], s.injected, meta.nbytes, cfg.rate_limit_bytes_round,
           c.targets, c.dst, c.slot, c.ok if ok is None else ok, s.alive,
           c.k_drop, 0, o[0], c.keys if fault else None,
           c.fthr if fault else None, None,
           (c.seeds if kernel else c.host_seeds) if fault else None,
           *((o[2], o[3], o[4][:, slot_d]) if record else (None,) * 3),
           tiers=tiers)

    def solo(o, tiers, fault=False, ok=None, record=False):
        x = [y[last].clone() for y in o]
        okl = (c.ok if ok is None else ok)[last]
        bc.broadcast_send(
            s.have[last], x[1], s.injected[last], meta.nbytes,
            cfg.rate_limit_bytes_round, c.targets[last], c.dst[last],
            c.slot[last], okl, s.alive[last], c.k_drop[last], 0, x[0],
            *((x[2], x[3], x[4][slot_d]) if record else (None,) * 3),
            phase_key=c.keys[last] if fault else None,
            fthr=c.fthr[last] if fault else None,
            seed=int(c.seeds[last]) if fault else 0, tiers=tiers)
        return x

    rows, drops = [], {}
    for name, cases in (
            ("dense_broadcast_tiered_lanes",
             (("tiered", wan, False, None), ("fault", wan, True, None),
              ("pin", pin, False, None), ("no_edges", wan, False, no_edges))),
            ("dense_broadcast_tiered_lanes_trace",
             (("record", wan, False, None),))):
        record = name.endswith("_trace")
        equal, err = True, 0
        for label, tiers, fault, ok in cases:
            got, want = outs(), outs()
            send(True, got, tiers, fault, ok, record)
            send(False, want, tiers, fault, ok, record)
            e_, m = _equal_all(got, want)
            equal, err = equal and e_, max(err, m)
            ref = solo(outs(), tiers, fault, ok, record)
            _solo_trap(f"{name} {label} lane {last}",
                       [y[last] for y in got], ref)
            drops[label] = got[0].sum(dim=(1, 2, 3)) - s.inflight.sum(
                dim=(1, 2, 3))
            if label == "no_edges":
                _trap("lane topo 8", "a lane without edges writes nothing "
                      "to its ring but still spends its relay budget",
                      int(drops[label][1]) == 0
                      and bool((got[1][1] != s.relay_left[1]).any()))
            if label == "pin":
                _trap("lane topo 9", "the certainty pin and a tier at 0 on "
                      "the wire of every lane (the pin's lanes write less "
                      "than the tiers')",
                      bool((drops["pin"] < drops["tiered"]).all()))
            if record:
                lost = (got[4] - acc0)[:, slot_d].tolist()
                rest = [i for i in range(len(tel.ACC)) if i != slot_d]
                _trap("lane topo 10", "each lane's tiered drops in its own "
                      "dropped slot, lanes differing, the other slots "
                      "untouched", min(lost) > 0 and len(set(lost)) == lanes
                      and torch.equal(got[4][:, rest], acc0[:, rest]))
            del got, want, ref
        base = outs()
        work = [y.clone() for y in base]

        def restore(work=work, base=base):
            for d_, s_ in zip(work, base):
                d_.copy_(s_)

        raw = torch.stack([
            _topo_raw(wan, n, dev, c.dst[k]) for k in range(lanes)])
        draws = c.ok & (raw > 0) & (raw < 256)
        hashes = _lane_hashes(c, lanes, draws)
        ops = hashes * OPS_PER_HASH
        ref = outs()
        send(False, ref, wan, record=record)
        nbytes = (_nbytes(s.have, s.relay_left, s.injected, meta.nbytes,
                          c.targets, c.dst, c.slot, c.ok, s.alive)
                  + _changed_bytes(base[:2], ref[:2])
                  + (_nbytes(*ref[2:4]) + lanes * 8 if record else 0))
        del ref
        row = _dense_lane_row(
            name, name, "dense_phases.cu", "corrosion_tpu/sim/topology.py:240",
            equal, err,
            _timed(timed, lambda work=work, record=record: send(
                True, work, wan, record=record), restore),
            _timed(timed, lambda work=work, record=record: send(
                False, work, wan, record=record), restore),
            nbytes, lanes, ops=ops, hashes=hashes, n=n)
        ops_ms = ops / _int32_ops_per_s() * 1e3
        row["bound_ms"] = max(row["bound_ms"], ops_ms)
        row["bound_by"] = "operations" if ops_ms > _bound_ms(nbytes) \
            else "bytes"
        rows.append(row)
        del base, work
    del c, s
    # lanes of one input (path 52's shapes), each under its own k_drop
    cfg1, meta1 = _broadcast_cfg(dev, n1k, 256)
    xs, targets, dst, slot, ok, keys = _lane_round_inputs(g, dev, cfg1,
                                                          meta1, 20, lanes)
    one = [x[:1].expand(lanes, *x.shape[1:]).contiguous()
           for x in (*xs, targets, dst, slot, ok)]
    ring = one[3].clone()
    dl.broadcast_send_lanes(one[0], one[1].clone(), one[2], meta1.nbytes,
                            cfg1.rate_limit_bytes_round, one[6], one[7],
                            one[8], one[9], one[5], keys, 0, ring,
                            tiers=wan)
    _lane_split_trap("11", list(ring))
    return rows


def _topo_raw(topo, n, dev, dst):
    """The raw tier threshold of each edge e → dst[e], the sender e / 3."""
    from corrosion_tpu_torch.sim import topology as tp

    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(3)
    return tp.edge_loss_thresholds_raw(topo, tp.regions(n, topo.n_regions,
                                                        dev), src, dst)


def compare_lane_sample_view(dev, g, lanes, n=PROTO_1K, v=16, timed=True,
                             suffix="", cases=(("", False),
                                               ("_beliefs", True))):
    """K1's view lane entry at path 52's shapes (K lanes of N = 1000, V =
    16; count 3, the fan-out and the sync peers) on views with empty,
    self and repeated slots, and with full-view beliefs (the DOWN
    filter); the last lane held to the solo entry, and lanes of one view
    under their own slot draws sampling differently.  ``cases`` (label,
    beliefs) picks the forms, ``suffix`` tags the rows' names."""
    from corrosion_tpu_torch.topo import sampler

    rows = []
    for label, beliefs in cases:
        pview = _stack(_random_views(g, n, v, dev) for _ in range(lanes))
        slots = torch.as_tensor(g.integers(0, v, (lanes, 12, n)),
                                dtype=torch.int32, device=dev)
        view = (torch.as_tensor(g.integers(0, 3, (lanes, n, n)),
                                dtype=torch.int8, device=dev)
                if beliefs else None)
        got = sampler.sample_view_lanes(pview, slots, view, 3)
        want = sampler.sample_view_lanes_plain(pview, slots, view, 3)
        equal, err = _equal_all([got], [want])
        last = lanes - 1
        _solo_trap(f"sample_view lanes{label} lane {last}", [got[last]],
                   [sampler.sample_view(pview[last], slots[last],
                                        None if view is None else view[last],
                                        3)])
        if not beliefs:
            one = pview[:1].expand(lanes, -1, -1).contiguous()
            _lane_split_trap("12", sampler.sample_view_lanes(one, slots, None,
                                                             3))
        rows.append(_dense_lane_row(
            "sample_view_lanes" + suffix + label, "sample_view_lanes",
            "sample_targets.cu", "corrosion_tpu/topo/sampler.py:57", equal,
            err,
            _timed(timed, lambda: sampler.sample_view_lanes(pview, slots,
                                                            view, 3)),
            _timed(timed, lambda: sampler.sample_view_lanes_plain(
                pview, slots, view, 3)),
            slots.numel() * (8 + (1 if beliefs else 0)) + lanes * n * 12,
            lanes, n=n, count=3))
    return rows


def compare_lane_peerswap(dev, g, lanes, n=PROTO_1K, v=16, timed=True,
                          suffix="", block_trap=True):
    """K21's three lane entries at path 52's shapes (K lanes of N = 1000,
    V = 16, announce interval 7): offers that collide on one partner
    inside a lane, the same partner slots c in two lanes of different
    views (each lane's offers land in its own view), a dead partner (its
    message unreachable), down nodes, wiped views; the last lane held to
    the solo entry.  ``suffix`` tags the row's name; ``block_trap`` False
    leaves out the trap of blocks spanning two lanes, for an N whose
    lanes start on block boundaries."""
    from corrosion_tpu_torch.topo import sampler

    t, interval = 37, 7
    pview = _stack(_random_views(g, n, v, dev) for _ in range(lanes))
    hub = torch.as_tensor(g.random((lanes, n)) < 0.02, device=dev)
    pview[:, :, 0] = torch.where(hub, 5, pview[:, :, 0])
    c = torch.as_tensor(np.where(g.random((lanes, n)) < 0.1,
                                 (t % v - 1) % v,
                                 g.integers(0, v, (lanes, n))),
                        dtype=torch.int32, device=dev)
    c[1] = c[0]
    alive = torch.as_tensor((g.random((lanes, n)) < 0.03) * 2,
                            dtype=torch.uint8, device=dev)
    partner = torch.clamp(torch.gather(pview, 2, c.long()[..., None])[..., 0],
                          min=0)
    reach = (torch.gather(alive, 1, partner.long()) == 0) & torch.as_tensor(
        g.random((lanes, n)) < 0.9, device=dev)
    rb = torch.as_tensor(g.integers(0, v, (lanes, n)), dtype=torch.int32,
                         device=dev)
    rid = torch.as_tensor(g.integers(0, n, (lanes, n)), dtype=torch.int32,
                          device=dev)

    def run(kernel):
        part = (sampler.peerswap_partner_lanes if kernel
                else sampler.peerswap_partner_lanes_plain)
        app = (sampler.peerswap_apply_lanes if kernel
               else sampler.peerswap_apply_lanes_plain)
        pc, winner = part(pview, c)
        out = app(pview, c, reach, alive, rb, rid, winner, t, interval)
        return [pc, winner, out]

    got, want = run(True), run(False)
    equal, err = _equal_all(got, want)
    last = lanes - 1
    pc1, w1 = sampler.peerswap_partner(pview[last], c[last])
    out1 = sampler.peerswap_apply(pview[last], c[last], reach[last],
                                  alive[last], rb[last], rid[last], w1, t,
                                  interval)
    _solo_trap(f"peerswap lanes lane {last}", [x[last] for x in got],
               [pc1, w1, out1])
    pc, winner, out = want
    rows_ = torch.arange(n, device=dev)
    ok = ((torch.gather(pview, 2, c.long()[..., None])[..., 0] >= 0)
          & (pc != rows_) & (alive == 0) & reach)
    offers = [torch.bincount(pc[k][ok[k]].long(), minlength=n)
              for k in range(lanes)]
    dead = torch.gather(alive, 1, pc.long()) != 0
    _trap("lane topo 13", "offers that collide on one partner inside a lane, "
          "and the same partner slots in lanes 0 and 1 landing in each "
          "lane's own view",
          all(int(o.max()) >= 2 for o in offers) and torch.equal(c[0], c[1])
          and not torch.equal(out[0], out[1]))
    real = torch.gather(pview, 2, c.long()[..., None])[..., 0] >= 0
    _trap("lane topo 14", "a dead partner: an up node's swap message to it "
          "unreachable, so it takes and offers nothing",
          bool((dead & real & (alive == 0) & ~reach).any()))
    if block_trap:
        _flat_block_trap("15", n)
    nbytes = pview.numel() * 8 + lanes * n * 4 * 7
    return [_dense_lane_row(
        "peerswap_lanes" + suffix, "peerswap_lanes", "peerswap.cu",
        "corrosion_tpu/topo/sampler.py:81", equal, err,
        _timed(timed, lambda: run(True)), _timed(timed, lambda: run(False)),
        nbytes, lanes, n=n, v=v)]


def compare_topology_lane_kernels(dev, seed=14, lanes=ENSEMBLE_LANES,
                                  timed=True, big=True):
    """Phase 3lt: every lane entry of the topology axis and PeerSwap on
    the dense round's lanes against its plain version at K = 8 on its
    paths' shapes (the 100k WAN storm's, broadcast-1k's, the frontier's),
    each lane held to the solo entry on its inputs, every trap reached;
    ``big`` False shrinks 100 000 and 1000 nodes to 1200 and 333 (a CPU
    rehearsal)."""
    g = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wide, mid = (STORM_N, PROTO_1K) if big else (1200, 333)
    rows = [*compare_lane_edge_slots(dev, g, lanes, wide, mid, timed),
            compare_lane_degree_caps(dev, g, lanes, timed=timed),
            *compare_lane_edge_reach(dev, g, lanes, wide, timed),
            *compare_lane_broadcast_tiered(dev, g, gen, lanes, wide, mid,
                                           timed),
            *compare_lane_sample_view(dev, g, lanes, mid, timed=timed),
            *compare_lane_peerswap(dev, g, lanes, mid, timed=timed)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: paths 51-54: (label, spec builder, the rows the path adds, golden name,
#: whether it records); every path also launches K12's inject and deliver
#: lane entries (`TRACE_LANE_ENTRIES`)
TOPO_LANE_CORE = ("threefry_lanes", "dense_gaps_lanes")
_RECORDING = ("trace_counts_dense_lanes", "trace_wire_rows_lanes",
              "trace_row_lanes", "dense_sync_lanes_trace")
TOPO_ENSEMBLE_PATHS = (
    ("peer_sampler_frontier", "frontier",
     _RECORDING + ("sample_uniform_lanes", "dense_broadcast_lanes_trace",
                   "dense_broadcast_tiered_lanes_trace", "edge_slots_lanes",
                   "degree_caps_lanes", "sample_view_lanes", "peerswap_lanes",
                   "edge_reach_lanes"),
     "PEER_SAMPLER_FRONTIER", True),
    ("broadcast_1k_wan_3x2_peerswap_seeds8_wire", "wan_peerswap_1k",
     _RECORDING + ("dense_broadcast_tiered_lanes_trace", "edge_slots_lanes",
                   "sample_view_lanes", "peerswap_lanes", "edge_reach_lanes"),
     "BROADCAST_1K_WAN_3X2_PEERSWAP_SEEDS8_WIRE", True),
    ("broadcast_1k_flat_lossy_uniform_seeds8_wire", "flat_lossy_1k",
     _RECORDING + ("sample_uniform_lanes", "dense_broadcast_lanes_trace"),
     "BROADCAST_1K_FLAT_LOSSY_UNIFORM_SEEDS8_WIRE", True),
    ("broadcast_1k_wan_fly_6r_uniform_seeds8", "fly_1k",
     ("dense_sync_lanes", "sample_uniform_lanes",
      "dense_broadcast_tiered_lanes", "edge_slots_lanes"),
     "BROADCAST_1K_WAN_FLY_6R_UNIFORM_SEEDS8", False),
    ("dense_storm_wan_3x2_100k_seeds8", "wan100k",
     ("dense_sync_lanes", "sample_targets_lanes", "merge_entries_lanes",
      "dense_broadcast_tiered_lanes", "edge_slots_lanes",
      "edge_reach_lanes"),
     "DENSE_STORM_WAN_3X2_100K_SEEDS8", False),
)


def wan_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "frontier": lambda: sp.peer_sampler_frontier_spec(
            seeds=tuple(seeds)[:4]),
        "wan_peerswap_1k": lambda: sp.broadcast_topology_seeds_spec(
            "wan-3x2", "peerswap", seeds, measure_wire=True),
        "flat_lossy_1k": lambda: sp.broadcast_topology_seeds_spec(
            "flat-lossy", "uniform", seeds, measure_wire=True),
        "fly_1k": lambda: sp.broadcast_topology_seeds_spec(
            "wan-fly-6r", "uniform", seeds, n_delay_slots=6),
        "wan100k": lambda: sp.dense_storm_wan_seeds_spec(seeds),
    }[which]()


def _cell_solo_runs(spec, dev):
    """The port's solo runs of every cell and seed of a path on the card:
    `run_to_convergence`, or under the spec's events `run_fault_plan` of
    the plan re-seeded per seed; for each cell its config, payloads and
    each seed's (final state, metrics, host wall)."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence
    from corrosion_tpu_torch.sim.state import uniform_payloads

    out = []
    for cell in spec.cells():
        cfg, topo = spec.sim_config(cell), spec.topo(cell)
        meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every(cell))
        runs = []
        for s in spec.seeds:
            state = new_sim(cfg, int(s), dev)
            plan = spec.fault_plan(cell, seed=int(s))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if plan is None:
                final, metrics = run_to_convergence(state, meta, cfg, topo,
                                                    spec.max_rounds)
            else:
                final, metrics = run_fault_plan(
                    state, meta, cfg, topo,
                    compile_plan(plan, cfg, topo, device=dev),
                    spec.max_rounds)
            torch.cuda.synchronize()
            runs.append((final, metrics, time.monotonic() - t0))
        out.append((cfg, meta, runs))
    return out


def _lane_record(ps, i, seed, final):
    from corrosion_tpu_torch.convert import state_digest

    return {"seed": seed, "rounds": ps["rounds"][i],
            "p99_node_convergence_round": ps["p99_node_convergence_round"][i],
            "converged": ps["converged"][i],
            "unconverged_nodes": ps["unconverged_nodes"][i],
            "digest": state_digest(final)}


def _solo_record(final, metrics, meta):
    """A solo run's record in the goldens' terms (the runner's p99s, the
    state's and the view's digests)."""
    from corrosion_tpu_torch.convert import pview_digest, state_digest
    from corrosion_tpu_torch.sim.runner import _node_convergence, _percentile

    cov = metrics.coverage_at.cpu().numpy()
    lat = np.where(cov >= 0, cov - meta.round.cpu().numpy(), -1)
    conv = _node_convergence(metrics, final)
    return {"rounds": int(final.t),
            "p99_node_convergence_round":
                conv["p99_node_convergence_round"],
            "p99_payload_latency_rounds": _percentile(lat, 99),
            "digest": state_digest(final), "pview_digest": pview_digest(final)}


def topology_ensemble_paths(dev, goldens):
    """Paths 51-54: topology families and PeerSwap on the dense round's
    lanes through `campaign.engine.run_campaign`, each from zeroed
    counters: every lane entry of the path launched (the recording forms
    on measure_wire cells), no solo entry of a kernel that has a lane
    entry; the artifact's spec_hash, result_digest and every cell's
    per-seed record (rounds, wire_bytes; at 100k the p99, convergence
    and each lane's state digest) against the golden pinned from live
    JAX; every lane's final state equal to the port's solo run of its
    cell and seed on this card (the walls beside, with
    max_memory_allocated).  Path 51 also through
    `runner.config_peer_sampler_frontier`; path 52's lane 0 against JAX's
    solo golden (the view's digest too); path 54's lane 0 solo run
    against 38 rounds and p99 34.0, and its one-seed campaign against
    JAX's result_digest.  Returns the launches per path and
    the printed numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.sim.round import RunMetrics
    from corrosion_tpu_torch.sim.runner import config_peer_sampler_frontier

    launches, numbers = {}, {}
    for label, which, extra, golden_name, recording in TOPO_ENSEMBLE_PATHS:
        spec = wan_path_spec(which)
        kept = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated()
        counts = _path_launches(kernels, TOPO_LANE_CORE + extra, label,
                                telemetry=recording,
                                entries=TRACE_LANE_ENTRIES)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        golden = getattr(goldens, golden_name)
        cells = art["cells"]
        got = {"spec_hash": art["spec_hash"],
               "result_digest": art["result_digest"],
               "rounds": [c["per_seed"]["rounds"] for c in cells]}
        if recording:
            got["wire_bytes"] = [c["per_seed"]["wire_bytes"] for c in cells]
        if which == "wan100k":
            got["lanes"] = [
                _lane_record(cells[0]["per_seed"], i, s,
                             lane_state(kept[0]["finals"], i))
                for i, s in enumerate(cells[0]["seeds"])]
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{[c['wall_clock_s'] for c in cells]} round_path="
              f"{[c['round_path'] for c in cells]}", flush=True)
        if any(c["round_path"] != "dense" for c in cells) or any(
                got[k] != golden[k] for k in got):
            raise AssertionError(f"{label}: differs from its golden")
        solos = _cell_solo_runs(spec, dev)
        for i, (cfg, meta, runs) in enumerate(solos):
            finals = kept[i]["finals"]
            if [int(f.t) for f, _, _ in runs] != cells[i]["per_seed"][
                    "rounds"] or not all(
                        _same_state(f, lane_state(finals, k))
                        for k, (f, _, _) in enumerate(runs)):
                raise AssertionError(f"{label}: a lane of cell {i} differs "
                                     "from its solo run")
        if which == "wan_peerswap_1k":
            cfg, meta, runs = solos[0]
            metrics = RunMetrics(*(x[0] for x in kept[0]["metrics"]))
            rec = _solo_record(lane_state(kept[0]["finals"], 0), metrics,
                               meta)
            if rec != goldens.BROADCAST_1K_WAN_3X2_PEERSWAP_SEED0:
                raise AssertionError(f"{label}: lane 0 {rec} differs from "
                                     "JAX's solo golden")
        if which == "wan100k":
            cfg, meta, runs = solos[0]
            rec = _solo_record(runs[0][0], runs[0][1], meta)
            want = goldens.STORM_WAN_3X2_100K_SEED0
            if {k: rec[k] for k in want} != want:
                raise AssertionError(f"{label}: the solo dense run of seed 0 "
                                     f"{rec} differs from {want}")
            one = run_campaign(wan_path_spec(which, seeds=(0,)), device=dev)
            print(f"{label}: the one-seed campaign of seed 0 gives "
                  f"result_digest {one['result_digest']}", flush=True)
            if one["result_digest"] != golden["seed0_result_digest"]:
                raise AssertionError(f"{label}: the one-seed campaign "
                                     "differs from JAX's")
        del kept
        walls = [w for _, _, runs in solos for _, _, w in runs]
        entry = {"ensemble_wall_s": [c["wall_clock_s"] for c in cells],
                 "max_memory_allocated_bytes": peak, "solo_walls_s": walls,
                 "solo_walls_sum_s": sum(walls)}
        if which == "frontier":
            rec = config_peer_sampler_frontier(seed=0, device=dev)
            if rec["result_digest"] != golden["result_digest"]:
                raise AssertionError(f"{label}: config_peer_sampler_frontier "
                                     f"gives {rec['result_digest']}")
            print(f"{label}: config_peer_sampler_frontier {json.dumps(rec)}",
                  flush=True)
        print(f"{label}: every lane equal to its solo run; ensemble walls "
              f"{entry['ensemble_wall_s']} s against the solo walls' sum "
              f"{sum(walls):.4f} s ({walls}); max_memory_allocated {peak} "
              "bytes", flush=True)
        numbers[label] = entry
        del solos
        _lap(label)
    return launches, numbers


def profile_dense_lanes(dev, spec, name, lanes=ENSEMBLE_LANES, start=5,
                        rounds=3):
    """``rounds`` rounds of a faultless dense cell (``spec``, called
    ``name``) from round ``start``: with ``lanes`` the lane round
    (`dense_lanes.dense_round_step_lanes`, the one host read of the [K]
    flags a round), with ``lanes`` None the solo dense round
    (`round.round_step_`) of seed 0; the first ``start`` rounds are
    setup."""
    from corrosion_tpu_torch.campaign.ensemble import seed_states
    from corrosion_tpu_torch.sim.dense_lanes import (
        dense_round_step_lanes, lane_batch)
    from corrosion_tpu_torch.sim.round import (
        new_metrics, new_sim, own_state, round_step_)
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.topology import regions

    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every({}))
    region = regions(cfg.n_nodes, topo.n_regions, dev)

    def step(loop):
        state, metrics = loop
        if lanes is None:
            state, metrics, done = round_step_(state, metrics, meta, cfg,
                                               topo, region)
        else:
            state, metrics, done = dense_round_step_lanes(
                state, metrics, meta, cfg, topo, region)
        done.tolist()  # the loop's one host read a round
        return state, metrics

    def setup():
        if lanes is None:
            loop = (own_state(new_sim(cfg, 0, dev)), new_metrics(cfg, dev))
        else:
            batch = lane_batch(seed_states(cfg, range(lanes), dev), cfg)
            loop = (batch.slim, batch.metrics)
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = f"{name} x{lanes} lanes" if lanes else f"{name} solo"
    return _profile(run, rounds, f"{label} rounds {start}-"
                    f"{start + rounds - 1}", setup)


# -- the protocol variants and PeerSwap under a plan on the dense round's
# lanes (phase 3lv, paths 55-59) ---------------------------------------------

SOLO_OF_LANE.update({"degree_caps_sched_lanes": "degree_caps_sched",
                     "dense_pull_lanes": "dense_pull",
                     "dense_pull_lossy_lanes": "dense_pull_lossy",
                     "dense_pull_tiered_lanes": "dense_pull_tiered",
                     "dense_pull_lossy_lanes_trace": "dense_pull_lossy",
                     "dense_pull_tiered_lanes_trace": "dense_pull_tiered",
                     "trace_wire_rows_pull_lanes": "trace_wire_rows_pull",
                     "dense_deliver_fifo_lanes": "dense_deliver_fifo",
                     "order_check_dense_lanes": "order_check_dense"})
#: the protocol frontier's width (path 55)
FRONTIER_N = 96


def _pull_lane_case(gen, dev, lanes, n, p, f, d, t=20):
    """K mid-run dense lanes at (N, P, F, D): have, relay, injected,
    ring, each lane's edges (-1 and self targets cleared, 3 % dead
    nodes), slots in [0, D), k_drop and plan seeds a lane."""
    from types import SimpleNamespace

    def u8(shape, p_one):
        return (torch.rand(shape, generator=gen, device=dev)
                < p_one).to(torch.uint8)

    have = u8((lanes, n, p), 0.5)
    relay = torch.randint(0, 4, (lanes, n, p), generator=gen, device=dev,
                          dtype=torch.uint8) * have
    injected = (torch.arange(p, device=dev) // 8 <= t).to(
        torch.uint8).expand(lanes, p).contiguous()
    ring = u8((lanes, d, n, p), 0.02)
    raw = torch.randint(-1, n, (lanes, n * f), generator=gen, device=dev,
                        dtype=torch.int32)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    alive = u8((lanes, n), 0.03) * 2
    dst = torch.clamp(raw, min=0)
    ok = ((raw >= 0) & (dst != src[None])
          & (torch.gather(alive, 1, dst.long()) == 0)
          & (alive[:, src.long()] == 0))
    slot = torch.randint(0, d, (lanes, n * f), generator=gen, device=dev,
                         dtype=torch.int32)
    return SimpleNamespace(
        have=have, relay=relay, injected=injected, ring=ring, src=src,
        dst=dst.contiguous(), ok=ok.contiguous(), slot=slot, alive=alive,
        k_drop=_lane_keys(dev, lanes, 5100),
        seeds=torch.arange(11, 11 + lanes, dtype=torch.int32, device=dev),
        nbytes=torch.full((p,), 8192, dtype=torch.int32, device=dev))


def _frontier_pull_rows(dev, gen, lanes, timed):
    """K12p's lane entry's tiered and lossy forms at the frontier's
    shapes (K lanes of N = 96, P = 64, F = 3, D = 4), each push-pull
    cell's own: its byte budget and payload sizes, wan-3x2's tiers or
    flat-lossy's threshold, no plan; with each lane's dropped slot (the
    ``_trace`` forms, as path 55 records) and without (as path 59 runs
    them).  The last lane held to the solo entry."""
    from corrosion_tpu_torch.campaign.spec import (
        protocol_frontier_push_pull_spec)
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.topology import loss_threshold, wire_tiers

    spec = protocol_frontier_push_pull_spec()
    rows, last = [], lanes - 1
    for cell in spec.cells():
        cfg, topo = spec.sim_config(cell), spec.topo(cell)
        nbytes = uniform_payloads(cfg, dev, inject_every=spec.inject_every(
            cell)).nbytes
        budget = cfg.rate_limit_bytes_round
        tiers = wire_tiers(topo)
        thr = (loss_threshold(topo.loss)
               if topo.loss > 0 and tiers is None else 0)
        c = _pull_lane_case(gen, dev, lanes, cfg.n_nodes, cfg.n_payloads,
                            cfg.fanout, cfg.n_delay_slots)
        acc0 = torch.randint(0, 1 << 20, (lanes, 3), generator=gen,
                             device=dev, dtype=torch.int64)

        def pull(kernel, ring, acc, c=c, thr=thr, tiers=tiers,
                 nbytes=nbytes, budget=budget):
            fn = bc.pull_send_lanes if kernel else bc.pull_send_lanes_plain
            fn(c.have, c.relay, c.injected, nbytes, budget, c.dst, c.slot,
               c.ok, c.k_drop, thr, ring, None if acc is None else acc[:, 0],
               None, None, tiers)

        sending = ((c.have > 0) & (c.relay > 0)
                   & (c.injected > 0)[:, None, :])
        answered = sum(int((sending[k][c.dst[k].long()]
                            & c.ok[k][:, None]).sum()) for k in range(lanes))
        hashes = answered // 4
        ops = hashes * OPS_PER_HASH
        nb = _nbytes(c.dst, c.slot, c.ok, c.injected, nbytes) + answered * 3
        kind = "lossy" if tiers is None else "tiered"
        for trace in (True, False):
            name = f"dense_pull_{kind}_lanes" + ("_trace" if trace else "")
            base = [c.ring, acc0 if trace else None]
            got = [None if x is None else x.clone() for x in base]
            want = [None if x is None else x.clone() for x in base]
            pull(True, *got)
            pull(False, *want)
            kept = [x for x in got if x is not None]
            equal, err = _equal_all(kept, [x for x in want if x is not None])
            x = [c.ring[last].clone(), acc0[last].clone()]
            bc.pull_send(c.have[last], c.relay[last], c.injected[last],
                         nbytes, budget, c.dst[last], c.slot[last],
                         c.ok[last], c.k_drop[last], thr, x[0],
                         x[1][0] if trace else None, None, 0, tiers)
            _solo_trap(f"{name} frontier lane {last}",
                       [y[last] for y in kept], x[:len(kept)])
            work = [None if y is None else y.clone() for y in base]

            def restore(work=work, base=base):
                for w_, b_ in zip(work, base):
                    if w_ is not None:
                        w_.copy_(b_)

            row = _dense_lane_row(
                name, name, "dense_phases.cu",
                "corrosion_tpu/proto/dissemination.py:58", equal, err,
                _timed(timed, lambda work=work, pull=pull: pull(True, *work),
                       restore),
                _timed(timed, lambda work=work, pull=pull: pull(False, *work),
                       restore),
                nb, lanes, ops=ops, hashes=hashes, n=cfg.n_nodes)
            ops_ms = ops / _int32_ops_per_s() * 1e3
            row["bound_ms"] = max(row["bound_ms"], ops_ms)
            row["bound_by"] = ("operations" if ops_ms > _bound_ms(nb)
                               else "bytes")
            rows.append(row)
            del got, want, kept, x
    return rows


def compare_lane_dense_pull(dev, g, gen, lanes, n=STORM_N, n1k=PROTO_1K,
                            timed=True):
    """K12p's lane entry at path 58's shapes (K lanes of N = 100000, P =
    512, F = 3, D = 2, no stream) and at the frontier's (`_frontier_pull_
    rows`: paths 55 and 59), the rows of the kernels line; and, a check
    at broadcast-1k's shapes (N = 1000, P = 256, D = 4) under a plan: the
    flat and fault streams under each lane's k_drop and plan seed with a
    binding byte budget and each lane's dropped slot, wan-3x2's tiers and
    the certainty pin on the pull leg, a lane without edges; the pull's
    session under a one-way cut (refused by the reverse cut alone) and
    its reads of the relay budget before the push spends it.  The last
    lane held to the solo entry on its inputs."""
    from corrosion_tpu_torch.proto.dissemination import (
        pull_session_ok_lanes, reverse_loss_lanes)
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.state import SimConfig

    last = lanes - 1
    rows = []
    # path 58: the storm's width, no stream
    c = _pull_lane_case(gen, dev, lanes, n, 512, 3, 2)
    got, want = c.ring.clone(), c.ring.clone()
    args = (c.have, c.relay, c.injected, c.nbytes, None, c.dst, c.slot, c.ok,
            c.k_drop, 0)
    bc.pull_send_lanes(*args, got)
    bc.pull_send_lanes_plain(*args, want)
    equal, err = _equal_all([got], [want])
    solo = c.ring[last].clone()
    bc.pull_send(c.have[last], c.relay[last], c.injected[last], c.nbytes,
                 None, c.dst[last], c.slot[last], c.ok[last], c.k_drop[last],
                 0, solo)
    _solo_trap(f"dense_pull_lanes lane {last}", [got[last]], [solo])
    sending = (c.have > 0) & (c.relay > 0) & (c.injected > 0)[:, None, :]
    answered = sum(int((sending[k][c.dst[k].long()] & c.ok[k][:, None]).sum())
                   for k in range(lanes))
    nbytes = (_nbytes(c.dst, c.slot, c.ok, c.injected, c.nbytes)
              + answered * 3 + _changed_bytes([c.ring], [want]))
    del got, want, solo, sending
    work = c.ring.clone()
    rows.append(_dense_lane_row(
        "dense_pull_lanes", "dense_pull_lanes", "dense_phases.cu",
        "corrosion_tpu/proto/dissemination.py:58", equal, err,
        _timed(timed, lambda: bc.pull_send_lanes(*args, work),
               lambda: work.copy_(c.ring)),
        _timed(timed, lambda: bc.pull_send_lanes_plain(*args, work),
               lambda: work.copy_(c.ring)),
        nbytes, lanes, n=n, answered_cells=answered))
    del c, work, args
    rows += _frontier_pull_rows(dev, gen, lanes, timed)
    # broadcast-1k's shapes under a plan: the streams, the tiers, the pin
    cfg = SimConfig(n_nodes=n1k, n_payloads=256, n_writers=8, fanout=3,
                    n_delay_slots=4)
    c = _pull_lane_case(gen, dev, lanes, n1k, 256, 3, 4)
    plan = faults.compile_plan(one_way_plan(n1k), cfg, device=dev)
    rf = faults.round_faults(plan, 2)
    ok_fwd = c.ok.clone()
    faults.fault_wire_effects(rf, c.src.expand(lanes, -1).reshape(-1),
                              c.dst.reshape(-1), ok_fwd.view(-1))
    ok_pull = pull_session_ok_lanes(ok_fwd, rf, c.src[None], c.dst)
    _trap("lane proto 1", "a pull whose session is cut in the reverse "
          "direction only (a one-way cut: the push's edge flows, its "
          "response does not)", bool((ok_fwd & ~ok_pull).any()))
    fthr = reverse_loss_lanes(rf, c.src[None], c.dst).contiguous()
    budget = 40 * 8192
    wan, pin = _topo("wan-3x2"), _pin_topo()
    no_edges = ok_pull.clone()
    no_edges[1] = False
    host_seeds = c.seeds.cpu()
    slot_d = 0
    acc0 = torch.randint(0, 1 << 20, (lanes, 3), generator=gen, device=dev,
                         dtype=torch.int64)

    def pull(kernel, ring, acc, thr, tiers, fault, ok, bud=budget,
             relay=None):
        fn = bc.pull_send_lanes if kernel else bc.pull_send_lanes_plain
        fn(c.have, c.relay if relay is None else relay, c.injected, c.nbytes,
           bud, c.dst, c.slot, ok, c.k_drop, thr, ring,
           None if acc is None else acc[:, slot_d],
           fthr if fault else None,
           (c.seeds if kernel else host_seeds) if fault else None, tiers)

    for name, cases in (
            ("dense_pull_lossy_lanes_trace",
             (("lossy", 26, None, True, ok_pull),
              ("no_edges", 26, None, True, no_edges))),
            ("dense_pull_tiered_lanes_trace",
             (("tiered", 0, wan, True, ok_pull),
              ("pin", 0, pin, False, c.ok)))):
        for label, thr, tiers, fault, ok in cases:
            got = [c.ring.clone(), acc0.clone()]
            want = [c.ring.clone(), acc0.clone()]
            pull(True, *got, thr, tiers, fault, ok)
            pull(False, *want, thr, tiers, fault, ok)
            if not _equal_all(got, want)[0]:
                raise AssertionError(f"{name} {label} at {n1k} nodes: "
                                     "kernel != plain version")
            x = [c.ring[last].clone(), acc0[last].clone()]
            bc.pull_send(c.have[last], c.relay[last], c.injected[last],
                         c.nbytes, budget, c.dst[last], c.slot[last],
                         ok[last], c.k_drop[last], thr, x[0], x[1][slot_d],
                         fthr[last] if fault else None,
                         int(host_seeds[last]) if fault else 0, tiers)
            _solo_trap(f"{name} {label} lane {last}",
                       [got[0][last], got[1][last]], x)
            lost = (got[1] - acc0)[:, slot_d].tolist()
            if label == "lossy":
                _trap("lane proto 2", "lanes whose pull keys, reverse draws "
                      "and plan seeds differ: every lane's streams drop "
                      "frames, each its own count in its own dropped slot, "
                      "the other slots untouched",
                      min(lost) > 0 and len(set(lost)) == lanes
                      and torch.equal(got[1][:, 1:], acc0[:, 1:]))
            if label == "no_edges":
                _trap("lane proto 3", "a lane without edges writes and "
                      "drops nothing", lost[1] == 0 and torch.equal(
                          got[0][1], c.ring[1]))
            if label == "pin":
                raw = torch.stack([_topo_raw(pin, n1k, dev, c.dst[k])
                                   for k in range(lanes)])
                _trap("lane proto 4", "a tier at certainty on the pull leg "
                      "(the pin topology's cross-region responses all lost, "
                      "with no draw; no plan, so the split's edges pull)",
                      bool((ok & (raw >= 256)).any())
                      and min(lost) > 0)
            del got, want, x
    # the budget the pull reads is the one before the push spends it
    spent = c.relay.clone()
    targets = torch.where(c.ok, c.dst, -1).view(lanes, n1k, 3).contiguous()
    dl.broadcast_send_lanes(c.have, spent, c.injected, c.nbytes, None,
                            targets, c.dst, c.slot, c.ok, c.alive, c.k_drop,
                            0, c.ring.clone())
    before, after = c.ring.clone(), c.ring.clone()
    pull(True, before, None, 0, None, False, ok_pull, bud=None)
    pull(True, after, None, 0, None, False, ok_pull, bud=None, relay=spent)
    _trap("lane proto 5", "a relay budget the pull reads before the push "
          "spends it (the pull launched after the spend would answer less "
          "in every lane)", all(int(before[k].sum()) > int(after[k].sum())
                                for k in range(lanes)))
    return rows


def compare_lane_fifo_deliver(dev, g, lanes, n=FRONTIER_N, n1k=PROTO_1K,
                              timed=True):
    """K12f-o's lane entry at the frontier's shapes (K lanes of N = 96, P
    = 64, A = 4, C = 1, D = 4; path 55's lab-ordered cells; the row)
    and, a check, at broadcast-1k's (N = 1000, P = 256, A = 8): both
    rings behind each lane's admit gate of its own pre-merge have; one
    set of arrivals in every lane, so the gate rejects in one lane what
    it admits in another.  The last lane held to the solo entry."""
    from corrosion_tpu_torch.proto.ordering import admit_payload_mask
    from corrosion_tpu_torch.sim import broadcast as bc
    from corrosion_tpu_torch.sim import dense_lanes as dl
    from corrosion_tpu_torch.sim.state import SimConfig

    rows, last = [], lanes - 1
    for nn, p, a, label in ((n, 64, 4, "frontier"), (n1k, 256, 8, "1k")):
        cfg = SimConfig(n_nodes=nn, n_payloads=p, n_writers=a, fanout=3,
                        n_delay_slots=4, ordering="fifo")
        v, d = cfg.n_versions, 4
        have = _stack(_holdings(g, nn, a, v, 1, dev, 0.5, 0.1)
                      for _ in range(lanes))
        relay = have * 2
        ring = _u8(g, (d, nn, p), 0.3, dev)[None].expand(
            lanes, d, nn, p).contiguous()
        sync_ring = _u8(g, (d, nn, p), 0.2, dev)[None].expand(
            lanes, d, nn, p).contiguous()
        slot = 3

        def run(fn, xs):
            fn(xs[0], xs[1], xs[2], xs[3], slot, 3, cfg)

        got = [x.clone() for x in (ring, sync_ring, have, relay)]
        want = [x.clone() for x in (ring, sync_ring, have, relay)]
        run(dl.deliver_dense_lanes, got)
        run(dl.deliver_dense_lanes_plain, want)
        equal, err = _equal_all(got, want)
        x = [y[last].clone() for y in (ring, sync_ring, have, relay)]
        bc.deliver_dense(*x, slot, 3, cfg)
        _solo_trap(f"dense_deliver_fifo_lanes {label} lane {last}",
                   [y[last] for y in got], x)
        admit = torch.stack([admit_payload_mask(have[k], cfg)
                             for k in range(lanes)])
        arriving = (ring[:, slot] | sync_ring[:, slot]) > 0
        _trap(f"lane proto 6 {label}", "a FIFO gate that rejects in one "
              "lane what it admits in another (the same arrivals in every "
              "lane)", bool((arriving & admit).any(dim=0).logical_and(
                  (arriving & ~admit).any(dim=0)).any()))
        if label == "1k":
            # a check: no path runs the gate at this width
            if not equal:
                raise AssertionError(f"dense_deliver_fifo_lanes at {nn} "
                                     "nodes: kernel != plain version")
            continue
        work = [y.clone() for y in (ring, sync_ring, have, relay)]
        base = [ring, sync_ring, have, relay]

        def restore(work=work, base=base):
            for d_, s_ in zip(work, base):
                d_.copy_(s_)

        rows.append(_dense_lane_row(
            "dense_deliver_fifo_lanes", "dense_deliver_fifo_lanes",
            "dense_phases.cu",
            "corrosion_tpu/proto/ordering.py:55", equal, err,
            _timed(timed, lambda work=work: run(dl.deliver_dense_lanes,
                                                work), restore),
            _timed(timed, lambda work=work: run(
                dl.deliver_dense_lanes_plain, work), restore),
            # two slots and have read, have, relay and both slots written
            _nbytes(ring[:, slot], sync_ring[:, slot], have)
            + _changed_bytes(got, [ring, sync_ring, have, relay]),
            lanes, n=nn))
    return rows


def compare_lane_order_check(dev, g, lanes, n=FRONTIER_N, n1k=PROTO_1K,
                             timed=True):
    """K22's u8 lane entry at broadcast-1k's shapes (K lanes of N = 1000,
    P = 256, A = 8, C = 1; path 56's lab-ordered-broken cell) and the
    frontier's (N = 96, P = 64, A = 4): each lane's holdings with gaps,
    added to its own nonzero count; one lane holds its versions in order,
    so the counts differ by lane and one of them is 0.  The last lane
    held to the solo entry."""
    from corrosion_tpu_torch.sim import invariants as inv
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    rows, last = [], lanes - 1
    for nn, p, a, label in ((n1k, 256, 8, "1k"), (n, 64, 4, "frontier")):
        cfg = SimConfig(n_nodes=nn, n_payloads=p, n_writers=a, fanout=3,
                        ordering="fifo-unchecked")
        meta = uniform_payloads(cfg, dev, inject_every=2)
        v = cfg.n_versions
        have = _stack(_holdings(g, nn, a, v, 1, dev, 0.5, 0.2)
                      for _ in range(lanes))
        # lane 0 holds a gapless prefix of versions: no violation
        heads = torch.as_tensor(g.integers(0, v + 1, (nn, 1, a)), device=dev)
        vv = torch.arange(v, device=dev)[None, :, None]
        have[0] = (vv < heads).to(torch.uint8).reshape(nn, v * a)
        acc0 = torch.arange(7, 7 + lanes, dtype=torch.int32, device=dev)
        got = acc0.clone()
        inv.count_order_violations_lanes_(got, have, meta, cfg)
        want = acc0.clone()
        inv.count_order_violations_lanes_plain(want, have, meta, cfg)
        equal, err = _equal_all([got], [want])
        x = acc0[last].clone()
        inv.count_order_violations_(x, have[last], meta, cfg)
        _solo_trap(f"order_check_dense_lanes {label} lane {last}",
                   [got[last]], [x])
        counts = (want - acc0).tolist()
        _trap(f"lane proto 7 {label}", "violation counts that differ by "
              "lane, one of them 0", counts[0] == 0 and min(counts[1:]) > 0
              and len(set(counts)) > 2)
        work = acc0.clone()
        rows.append(_dense_lane_row(
            "order_check_dense_lanes" + ("" if label == "1k"
                                         else "_frontier"),
            "order_check_dense_lanes", "order_check.cu",
            "corrosion_tpu/sim/invariants.py:51", equal, err,
            _timed(timed, lambda work=work, have=have, meta=meta, cfg=cfg:
                   inv.count_order_violations_lanes_(work, have, meta, cfg),
                   lambda work=work: work.copy_(acc0)),
            _timed(timed, lambda work=work, have=have, meta=meta, cfg=cfg:
                   inv.count_order_violations_lanes_plain(work, have, meta,
                                                          cfg),
                   lambda work=work: work.copy_(acc0)),
            _nbytes(have) + a * 4 + lanes * 8, lanes, n=nn))
    return rows


def compare_lane_caps_schedule(dev, g, lanes, n=PROTO_1K, timed=True):
    """K20's schedule lane entry on K lanes of targets at path 56's
    fan-out decay cell's shapes (N = 1000, F = 3, R = 8): without degree
    classes at t = 7 and t = 8, where the live count drops from 3 to 1,
    and after hetero-degree's caps 3/2/1 (caps below the live count in
    some rows).  The last lane held to the solo entry."""
    from corrosion_tpu_torch.proto import schedule as sch
    from corrosion_tpu_torch.sim import topology as tp
    from corrosion_tpu_torch.sim.state import SimConfig

    cfg = SimConfig(n_nodes=n, n_payloads=256, n_writers=8, fanout=3,
                    fanout_schedule="decay")
    tg = np.where(g.random((lanes, n, 3)) < 0.05, -1,
                  g.integers(0, n, (lanes, n, 3)))
    targets = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    flat, het = _topo(), _topo("hetero-degree")
    outs, equal, err = {}, True, 0
    last = lanes - 1
    for label, topo, t in (("7", flat, 7), ("8", flat, 8), ("het7", het, 7),
                           ("het8", het, 8)):
        got = sch.capped_schedule_lanes(targets.clone(), topo, cfg, t)
        want = sch.capped_schedule_lanes_plain(targets, topo, cfg, t)
        e_, x = _equal_all([got], [want])
        equal, err = equal and e_, max(err, x)
        _solo_trap(f"degree_caps_sched_lanes {label} lane {last}",
                   [got[last]], [sch.capped_schedule(targets[last].clone(),
                                                     topo, cfg, t)])
        outs[label] = want
    caps = tp.node_degrees(n, het, dev)
    _trap("lane proto 8", "a schedule round where the slot count drops (3 "
          "live slots at t = 7, 1 at t = 8) with caps below it in some rows "
          "of every lane",
          torch.equal(outs["7"], targets)
          and bool((outs["8"][:, :, 1:] == -1).all())
          and all(bool(((outs["het7"][k] == -1) & (targets[k] != -1))[
              caps < 3].any()) for k in range(lanes))
          and torch.equal(outs["het8"], outs["8"]))
    _flat_block_trap("proto 9", n * 3)
    work = targets.clone()
    return [_dense_lane_row(
        "degree_caps_sched_lanes", "degree_caps_sched_lanes",
        "edge_classes.cu", "corrosion_tpu/proto/schedule.py:27", equal, err,
        _timed(timed, lambda: sch.capped_schedule_lanes(work, het, cfg, 7),
               lambda: work.copy_(targets)),
        _timed(timed, lambda: sch.capped_schedule_lanes_plain(targets, het,
                                                              cfg, 7)),
        targets.numel() * 4 + _changed_bytes([targets], [outs["het7"]]),
        lanes, n=n)]


def compare_lane_wire_rows_pull(dev, g, lanes, n=FRONTIER_N, timed=True):
    """K18's rows-pull lane entry at the frontier's shapes (K lanes of E
    = 288 pulls over N = 96 rows): each lane's answered pulls into its
    own accumulator slots of a lane trace's [K, 12] acc, one lane without
    edges; the last lane held to the solo entry."""
    from corrosion_tpu_torch.sim import telemetry as tel

    f, last = 3, lanes - 1
    frames = torch.as_tensor(g.integers(0, 64, (lanes, n)), dtype=torch.int32,
                             device=dev)
    byts = frames * 8192
    dst = torch.as_tensor(g.integers(0, n, (lanes, n * f)), dtype=torch.int32,
                          device=dev)
    ok = torch.as_tensor(g.random((lanes, n * f)) < 0.8, device=dev)
    ok[1] = False
    acc0 = torch.as_tensor(g.integers(0, 1 << 20, (lanes, len(tel.ACC))),
                           dtype=torch.int64, device=dev)
    w = tel.ACC.index("bcast_frames")
    got, want = acc0.clone(), acc0.clone()
    tel.wire_rows_pull_lanes_(got[:, w:w + 2], frames, byts, ok, dst)
    tel.wire_rows_pull_lanes_plain(want[:, w:w + 2], frames, byts, ok, dst)
    equal, err = _equal_all([got], [want])
    x = acc0[last, w:w + 2].clone()
    tel.wire_rows_pull_(x, frames[last], byts[last], ok[last], dst[last])
    _solo_trap(f"trace_wire_rows_pull_lanes lane {last}",
               [got[last, w:w + 2]], [x])
    added = (want - acc0)[:, w].tolist()
    rest = [i for i in range(len(tel.ACC)) if i not in (w, w + 1)]
    _trap("lane proto 10", "each lane's answered pulls in its own frames "
          "and bytes slots, lanes differing, a lane without edges adding "
          "nothing, the other slots untouched",
          added[1] == 0 and min(added[:1] + added[2:]) > 0
          and torch.equal(want[:, rest], acc0[:, rest]))
    work = acc0.clone()
    return [_dense_lane_row(
        "trace_wire_rows_pull_lanes", "trace_wire_rows_pull_lanes",
        "trace_wire.cu", "corrosion_tpu/sim/broadcast.py:285", equal, err,
        _timed(timed, lambda: tel.wire_rows_pull_lanes_(
            work[:, w:w + 2], frames, byts, ok, dst),
            lambda: work.copy_(acc0)),
        _timed(timed, lambda: tel.wire_rows_pull_lanes_plain(
            work[:, w:w + 2], frames, byts, ok, dst),
            lambda: work.copy_(acc0)),
        _nbytes(frames, byts, ok, dst) + lanes * 16, lanes, n=n)]


def compare_protocol_lane_kernels(dev, seed=15, lanes=ENSEMBLE_LANES,
                                  timed=True, big=True):
    """Phase 3lv: every lane entry of the protocol variants on the dense
    round's lanes against its plain version at K = 8 on its paths'
    shapes (the 100k push-pull storm's, broadcast-1k's, the frontier's),
    each lane held to the solo entry on its inputs, every trap reached;
    ``big`` False shrinks 100 000 and 1000 nodes to 1200 and 333 (a CPU
    rehearsal)."""
    g = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wide, mid = (STORM_N, PROTO_1K) if big else (1200, 333)
    rows = [*compare_lane_dense_pull(dev, g, gen, lanes, wide, mid, timed),
            *compare_lane_fifo_deliver(dev, g, lanes, n1k=mid, timed=timed),
            *compare_lane_order_check(dev, g, lanes, n1k=mid, timed=timed),
            *compare_lane_caps_schedule(dev, g, lanes, mid, timed),
            *compare_lane_wire_rows_pull(dev, g, lanes, timed=timed)]
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: paths 55-59: (label, spec builder, the rows the path adds to
#: `PROTO_LANE_CORE`, golden name, whether it records); every path also
#: launches K12's inject and deliver lane entries (`TRACE_LANE_ENTRIES`),
#: the faultless ones K14's lane entry (`dense_gaps_lanes`) and the fault
#: path K14x's (`dense_gaps_exit_lanes`)
PROTO_LANE_CORE = ("threefry_lanes",)
PROTO_ENSEMBLE_PATHS = (
    ("protocol_frontier", "frontier",
     _RECORDING + ("dense_gaps_lanes", "sample_uniform_lanes",
                   "dense_broadcast_lanes_trace",
                   "dense_broadcast_tiered_lanes_trace", "edge_slots_lanes",
                   "dense_pull_lossy_lanes_trace",
                   "dense_pull_tiered_lanes_trace",
                   "trace_wire_rows_pull_lanes", "dense_deliver_fifo_lanes",
                   "order_check_dense_lanes"),
     "PROTOCOL_FRONTIER", True),
    ("broadcast_1k_fanout_decay_seeds8_wire", "decay_1k",
     _RECORDING + ("dense_gaps_lanes", "sample_uniform_lanes",
                   "dense_broadcast_lanes_trace", "degree_caps_sched_lanes"),
     "BROADCAST_1K_FANOUT_DECAY_SEEDS8_WIRE", True),
    ("broadcast_1k_lab_ordered_broken_seeds8_wire", "broken_1k",
     _RECORDING + ("dense_gaps_lanes", "sample_uniform_lanes",
                   "dense_broadcast_lanes_trace", "order_check_dense_lanes"),
     "BROADCAST_1K_LAB_ORDERED_BROKEN_SEEDS8_WIRE", True),
    ("broadcast_1k_wan_3x2_peerswap_fault_seeds8", "psfault_1k",
     ("dense_sync_lanes", "dense_broadcast_tiered_lanes", "edge_slots_lanes",
      "sample_view_lanes", "peerswap_lanes", "edge_reach_lanes",
      "fault_reach_matrix_lanes", "node_faults_dense_lanes",
      "dense_gaps_exit_lanes"),
     "BROADCAST_1K_WAN_3X2_PEERSWAP_FAULT_SEEDS8", False),
    ("dense_storm_push_pull_100k_seeds8", "pp100k",
     ("dense_gaps_lanes", "dense_sync_lanes", "sample_targets_lanes",
      "merge_entries_lanes", "dense_phases_lanes", "dense_pull_lanes"),
     "DENSE_STORM_PUSH_PULL_100K_SEEDS8", False),
    ("protocol_frontier_push_pull", "frontier_pp",
     ("dense_gaps_lanes", "sample_uniform_lanes", "dense_sync_lanes",
      "dense_phases_lanes", "dense_broadcast_tiered_lanes", "edge_slots_lanes",
      "dense_pull_lossy_lanes", "dense_pull_tiered_lanes"),
     "PROTOCOL_FRONTIER_PUSH_PULL", False),
)


def proto_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "frontier": lambda: sp.protocol_frontier_spec(seeds=tuple(seeds)[:4]),
        "decay_1k": lambda: sp.broadcast_proto_seeds_spec("fanout-decay",
                                                          seeds),
        "broken_1k": lambda: sp.broadcast_proto_seeds_spec(
            "lab-ordered-broken", seeds),
        "psfault_1k": lambda: sp.broadcast_peerswap_fault_seeds_spec(seeds),
        "pp100k": lambda: sp.dense_storm_push_pull_seeds_spec(seeds),
        "frontier_pp": lambda: sp.protocol_frontier_push_pull_spec(
            seeds=tuple(seeds)[:4]),
    }[which]()


def protocol_ensemble_paths(dev, goldens):
    """Paths 55-59: the protocol variants and PeerSwap under a fault plan
    on the dense round's lanes through `campaign.engine.run_campaign`,
    each from zeroed counters: every new lane entry of the path launched
    (the recording forms on measure_wire cells), no solo entry of a
    kernel that has a lane entry; the artifact's spec_hash, result_digest
    and every cell's per-seed rounds (and wire_bytes, order_violations;
    at 100k each lane's p99, convergence and state digest) against the
    golden pinned from live JAX; every lane's final state (the PeerSwap
    view included) equal to the port's solo run of its cell and seed on
    this card, at 100k (path 58, every lane a JAX pin) lanes 0 and K - 1
    (the walls beside, with max_memory_allocated).  Path 55
    also through `runner.config_protocol_frontier` (its sampler cell
    against the solo PeerSwap storm's golden); path 56's broken-ordering
    lane 0 against JAX's solo golden (its 38 violations); path 58's lane
    0 solo run against 22 rounds and p99 21.0, and its one-seed campaign
    against JAX's result_digest.  Returns the launches per path and the
    printed numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.sim.round import RunMetrics
    from corrosion_tpu_torch.sim.runner import config_protocol_frontier

    launches, numbers = {}, {}
    for label, which, extra, golden_name, recording in PROTO_ENSEMBLE_PATHS:
        spec = proto_path_spec(which)
        kept = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated()
        counts = _path_launches(kernels, PROTO_LANE_CORE + extra, label,
                                telemetry=recording,
                                entries=TRACE_LANE_ENTRIES)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        golden = getattr(goldens, golden_name)
        cells = art["cells"]
        got = {"spec_hash": art["spec_hash"],
               "result_digest": art["result_digest"],
               "rounds": [c["per_seed"]["rounds"] for c in cells]}
        for key in ("wire_bytes", "order_violations"):
            if key in golden:
                got[key] = [c["per_seed"].get(key) for c in cells]
        if which == "pp100k":
            got["lanes"] = [
                _lane_record(cells[0]["per_seed"], i, s,
                             lane_state(kept[0]["finals"], i))
                for i, s in enumerate(cells[0]["seeds"])]
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{[c['wall_clock_s'] for c in cells]} round_path="
              f"{[c['round_path'] for c in cells]}", flush=True)
        if any(c["round_path"] != "dense" for c in cells) or any(
                got[k] != golden[k] for k in got):
            raise AssertionError(f"{label}: differs from its golden")
        # every lane of the 100k cell is a live-JAX pin, so its solo runs
        # are lanes 0 and K - 1 only (the script's time, ROADMAP)
        lanes_ = (list(range(len(spec.seeds))) if which != "pp100k"
                  else [0, len(spec.seeds) - 1])
        solos = _cell_solo_runs(dataclasses.replace(
            spec, seeds=tuple(spec.seeds[k] for k in lanes_)), dev)
        for i, (cfg, meta, runs) in enumerate(solos):
            finals = kept[i]["finals"]
            order = kept[i]["metrics"].order_violations
            if [int(f.t) for f, _, _ in runs] != [
                    cells[i]["per_seed"]["rounds"][k] for k in lanes_] or \
                    not all(_same_state(f, lane_state(finals, k))
                            and int(m.order_violations) == int(order[k])
                            for k, (f, m, _) in zip(lanes_, runs)):
                raise AssertionError(f"{label}: a lane of cell {i} differs "
                                     "from its solo run")
        if which == "broken_1k":
            cfg, meta, runs = solos[0]
            metrics = RunMetrics(*(x[0] for x in kept[0]["metrics"]))
            rec = _solo_record(lane_state(kept[0]["finals"], 0), metrics,
                               meta)
            rec["order_violations"] = int(metrics.order_violations)
            want = goldens.BROADCAST_1K_LAB_ORDERED_BROKEN_SEED0
            if {k: rec[k] for k in want} != want:
                raise AssertionError(f"{label}: lane 0 {rec} differs from "
                                     "JAX's solo golden")
        if which == "pp100k":
            cfg, meta, runs = solos[0]
            rec = _solo_record(runs[0][0], runs[0][1], meta)
            if (rec["rounds"], rec["p99_node_convergence_round"]) != (22,
                                                                      21.0):
                raise AssertionError(f"{label}: the solo dense run of seed 0 "
                                     f"{rec} is not 22 rounds, p99 21.0")
            one = run_campaign(proto_path_spec(which, seeds=(0,)), device=dev)
            print(f"{label}: the one-seed campaign of seed 0 gives "
                  f"result_digest {one['result_digest']}", flush=True)
            if one["result_digest"] != golden["seed0_result_digest"]:
                raise AssertionError(f"{label}: the one-seed campaign "
                                     "differs from JAX's")
        del kept
        # K times the mean where only lanes 0 and K - 1 ran solo
        walls = [w for _, _, runs in solos for _, _, w in runs]
        entry = {"ensemble_wall_s": [c["wall_clock_s"] for c in cells],
                 "max_memory_allocated_bytes": peak, "solo_walls_s": walls,
                 "solo_walls_sum_s": sum(walls) * len(spec.seeds)
                 / len(lanes_)}
        if which == "frontier":
            rec = config_protocol_frontier(seed=0, device=dev)
            storm = rec["sampler_storm"]
            want = goldens.STORM_PEERSWAP_25600_SEED0
            if rec["result_digest"] != golden["result_digest"] or (
                    storm["rounds"], storm["p99_node_convergence_round"]) != (
                    want["rounds"], want["p99_node_convergence_round"]):
                raise AssertionError(f"{label}: config_protocol_frontier "
                                     f"gives {json.dumps(rec)}")
            print(f"{label}: config_protocol_frontier {json.dumps(rec)}",
                  flush=True)
        print(f"{label}: lanes {lanes_} equal to their solo runs; ensemble "
              f"walls {entry['ensemble_wall_s']} s against the solo walls' "
              f"sum {entry['solo_walls_sum_s']:.4f} s ({walls}); "
              f"max_memory_allocated {peak} bytes", flush=True)
        numbers[label] = entry
        del solos
        _lap(label)
    return launches, numbers


# -- latency plans and the flight recorder on the packed round's lanes
# (phase 3lp, paths 60-62) -------------------------------------------------

SOLO_OF_LANE.update({
    "broadcast_scatter_jitter_lanes": "broadcast_scatter_jitter",
    "broadcast_scatter_jitter_lanes_trace": "broadcast_scatter_jitter",
    "broadcast_scatter_lossy_lanes_trace": "broadcast_scatter_lossy",
    "sync_pull_delay_lanes": "sync_pull_delay",
    "sync_pull_lanes_trace": "sync_pull",
    "sync_pull_delay_lanes_trace": "sync_pull_delay",
    "trace_counts_lanes": "trace_counts",
    "trace_wire_lanes": "trace_wire"})


def _one_way_latency_plan(n):
    """The latency pair with a one-way cut from the first half to the
    second (a session refused in one direction only) and the fault
    storm's loss, rounds 0-15: the session queries' plan of phase 3lp."""
    from corrosion_tpu_torch.faults import FaultEvent, FaultPlan

    half = n // 2
    plan = latency_storm_plan(n)
    return FaultPlan(n_nodes=n, seed=plan.seed, events=(
        FaultEvent("loss", 0, 12, p=0.15),
        FaultEvent("partition", 0, 16, src=f"0:{half}", dst=f"{half}:{n}"),
        *plan.events[-2:]))


def _packed_lane_round(dev, g, lanes, n, t=LATENCY_T):
    """K lanes of latency-storm-n's round ``t`` (loss, half split, delay
    and jitter all on): per-lane edges and sending words, the round's
    wire effects through K9's latency entry on the lanes folded (each
    lane's cut edges counted into its own [K] slot), per-lane keys and
    plan seeds.  Lane 1 repeats lane 0's edges, words and ring (only its
    key and seed differ); the last lane attempts no edge."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import faults

    cfg, meta, fplan = _latency_storm(n, dev)
    f, w, d = cfg.fanout, cfg.n_payloads // 32, cfg.n_delay_slots
    e = n * f
    rf = faults.round_faults(fplan, t)
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.as_tensor(g.integers(0, n, (lanes, e)), dtype=torch.int32,
                          device=dev)
    ok = torch.as_tensor(g.random((lanes, e)) < 0.9, device=dev)
    # the block holding the jitter's edge boundary (the sender n // 6)
    # carries jittered and unjittered edges, none of them cut
    per_block = 256 // w
    b0 = (n // 6) * f // per_block * per_block
    block = slice(b0, b0 + per_block)
    dst[:, block] = dst[:, block] % (n // 2)
    ok[:, block] = True
    sending = _random_words(g, (lanes, n, w), dev, 1)
    ring0 = _random_words(g, (lanes, d, n, w), dev, 6)
    for x in (dst, ok, sending, ring0):
        x[1] = x[0]
    ok[-1] = False
    ok0 = ok.clone()
    acc = torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
    _, thr, fdelay, jit = faults.fault_wire_effects(
        rf, src.repeat(lanes), dst.reshape(-1), ok.view(-1), cut=acc[:, 3])
    thr, fdelay, jit = (x.view(lanes, e) for x in (thr, fdelay, jit))
    slot = ((t + fdelay) % d).to(torch.int32)
    return dict(cfg=cfg, meta=meta, rf=rf, f=f, w=w, d=d, e=e, src=src,
                dst=dst, ok=ok, ok0=ok0, cut=acc[:, 3], thr=thr, jit=jit,
                slot=slot, sending=sending, ring0=ring0,
                keys=_lane_keys(dev, lanes, 6000),
                seeds=lane_plan_seeds(range(lanes), dev))


def compare_packed_lane_scatter_jitter(dev, g, lanes, n=STORM_N, timed=True):
    """K10j's lane entry and the recording forms of K10's and K10j's lane
    entries at latency-storm-100k's round 6 on K lanes, each against its
    plain version (the solo plain version looped over the lanes), lane 0
    and the last lane held to the solo entry on their inputs; the traps
    of lanes whose draws differ, blocks of jittered and unjittered edges,
    loss and jitter on one edge, counts that differ by lane, and a lane
    without edges."""
    from corrosion_tpu_torch.device import popcount
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import lanes as ln

    c = _packed_lane_round(dev, g, lanes, n)
    f, w, e, d = c["f"], c["w"], c["e"], c["d"]
    args = (c["sending"], c["dst"], c["slot"], c["ok"], f, c["thr"],
            c["keys"], c["seeds"])
    cases = (("broadcast_scatter_jitter_lanes", c["jit"], False),
             ("broadcast_scatter_jitter_lanes_trace", c["jit"], True),
             ("broadcast_scatter_lossy_lanes_trace", None, True))
    rows, rings = [], {}
    for name, jit, rec in cases:
        got, want = c["ring0"].clone(), c["ring0"].clone()
        dk = torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
        dp = torch.zeros_like(dk)
        ln.scatter_lanes(got, *args, jit, dk[:, 2] if rec else None)
        ln.scatter_lanes_plain(want, *args, jit, dp[:, 2] if rec else None)
        equal, err = _equal_all([got, dk], [want, dp])
        for k in (0, lanes - 1):
            solo, sd = c["ring0"][k].clone(), _acc(dev)
            packed.scatter_sending_lossy(
                solo, c["sending"][k], c["dst"][k], c["slot"][k], c["ok"][k],
                c["thr"][k], c["keys"][k], int(c["seeds"][k]), f,
                dropped=sd if rec else None, jit=None if jit is None
                else jit[k])
            _solo_trap(f"{name} lane {k}", [got[k], dk[k, 2]],
                       [solo, sd if rec else dk[k, 2]])
        rings[name] = (want, dp[:, 2].clone())
        # the bound: eight hashes a sending (edge, word) under a loss
        # threshold, one a sent bit of a jittered edge that survives it
        loss_h = jit_h = 0
        for k in range(lanes):
            words = packed._edge_words(c["sending"][k], c["ok"][k], f)
            loss_h += int(((words != 0) & (c["thr"][k] > 0)[:, None]).sum())
            packed._keep_stream_(words, c["thr"][k], faults.fault_key(
                c["keys"][k], int(c["seeds"][k]), faults.WIRE_LOSS_TAG))
            if jit is not None:
                jit_h += int(popcount(words[jit[k] > 0]).sum())
        ops = (8 * loss_h + jit_h) * OPS_PER_HASH
        rows_touched = int(torch.unique(
            (torch.arange(lanes, device=dev)[:, None] * (d * n)
             + c["slot"].long() * n + c["dst"].long())[c["ok"]]).numel())
        nbytes = (c["sending"].numel() * 4 + lanes * e * (4 + 4 + 1 + 1 + 4)
                  + 2 * rows_touched * w * 4 * 2 + (lanes * 8 if rec else 0))
        work_k, work_p = c["ring0"].clone(), c["ring0"].clone()
        acc_k, acc_p = (torch.zeros((lanes, 12), dtype=torch.int64,
                                    device=dev) for _ in range(2))

        def restore_k():
            work_k.copy_(c["ring0"])
            acc_k.zero_()

        def restore_p():
            work_p.copy_(c["ring0"])
            acc_p.zero_()

        row = _ops_row(
            name, "corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
            ("corrosion_tpu/sim/faults.py:285" if jit is not None
             else "corrosion_tpu/sim/packed.py:573") + _VMAP, equal, err,
            _timed(timed, lambda jit=jit, rec=rec: ln.scatter_lanes(
                work_k, *args, jit, acc_k[:, 2] if rec else None),
                restore_k),
            # the plain versions find their draws on the host: eager
            _time_eager_ms(lambda jit=jit, rec=rec: (
                restore_p(), ln.scatter_lanes_plain(
                    work_p, *args, jit, acc_p[:, 2] if rec else None)),
                SLOW_PLAIN_REPS) if timed else None,
            nbytes, ops, kernel=name, lanes=lanes, hashes=8 * loss_h + jit_h)
        rows.append(row)

    want, dropped = rings["broadcast_scatter_jitter_lanes_trace"]
    unjittered, _ = rings["broadcast_scatter_lossy_lanes_trace"]
    _trap("lane packed 1", "lanes whose keys and plan seeds differ draw "
          "their own loss and jitter (lanes 0 and 1 share every input but "
          "the key and seed)",
          not torch.equal(want[0], want[1])
          and int(dropped[0]) != int(dropped[1]))
    jittered = (c["jit"][0] > 0) & c["ok"][0]
    per_block = 256 // w
    blocks = e // per_block * per_block
    jb = jittered[:blocks].view(-1, per_block)
    plain_edges = ((c["jit"][0] == 0) & c["ok"][0])[:blocks].view(
        -1, per_block)
    _trap("lane packed 2", "a block with jittered and unjittered edges "
          "together, and a jitter bound of 0 on some edges",
          bool((jb.any(1) & plain_edges.any(1)).any())
          and bool((c["jit"] == 0).any()))
    both = (c["thr"][0] > 0) & jittered & (
        packed._edge_words(c["sending"][0], c["ok"][0], f) != 0).any(1)
    _trap("lane packed 3", "loss and jitter bite the same edges in one "
          "round (the loss drops frames, the jitter moves survivors)",
          bool(both.any()) and int(dropped[0]) > 0
          and not torch.equal(want[0], unjittered[0]))
    cut = [int(x) for x in c["cut"]]
    want_cut = [int((c["ok0"][k] & faults._block_plain(
        c["rf"], c["src"], c["dst"][k])).sum()) for k in range(lanes)]
    drops = [int(x) for x in dropped]
    _trap("lane packed 4", "dropped and cut counts differ by lane, the "
          "lane without edges 0 (K9's lane-strided count over blocks that "
          f"span two lanes: E = {e} is not a multiple of 256)",
          cut == want_cut and len(set(cut)) > 1 and cut[-1] == 0
          and len(set(drops)) > 1 and drops[-1] == 0 and e % 256 != 0)
    _trap("lane packed 5", "the lane without edges keeps its ring",
          torch.equal(want[-1], c["ring0"][-1]))
    return rows


def compare_packed_lane_sync_delay(dev, g, lanes, n=STORM_N, timed=True):
    """K3's delay lane entry and the recording forms of K3's lane entries
    (with and without session delays) at latency-storm-100k's shapes on K
    lanes: two consecutive rounds on rings whose slots already hold words,
    session delays from K9's latency entry on the lanes folded (a one-way
    cut: each lane's refused sessions into its own slot) with some
    classes past D - 2; lane 0 and the last lane against the solo entry.
    Returns the rows and the granted words (K17's grant lane entry's
    input)."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim import lanes as ln

    cfg, _, _ = _latency_storm(n, dev)
    w, s, d = cfg.n_payloads // 32, cfg.sync_peers, cfg.n_delay_slots
    fplan = faults.compile_plan(_one_way_latency_plan(n), cfg, device=dev)
    rf = faults.round_faults(fplan, LATENCY_T)
    masks = _random_words(g, (lanes, n, 4, w), dev)
    miss = _random_words(g, (lanes, n, w), dev, 2)
    peers = torch.as_tensor(g.integers(0, n, (lanes, n, s)),
                            dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((lanes, n * s)) < 0.7, device=dev)
    ok[-1] = False
    ok0 = ok.clone()
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(s)
    acc = torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
    refused, sdelay = faults.fault_session_effects(
        rf, src.repeat(lanes), peers.reshape(-1), ok.view(-1), acc[:, 4])
    refused, sdelay = refused.view(lanes, -1), sdelay.view(lanes, -1)
    # a class past D - 2 on every 97th edge: granted, landing nowhere
    sdelay = sdelay.clone()
    sdelay[:, ::97] = d - 1
    ok = ok.view(lanes, n, s)
    ring0 = _random_words(g, (lanes, d, n, w), dev, 5)
    args = (masks, miss, peers, ok)
    cases = (("sync_pull_delay_lanes", sdelay, False),
             ("sync_pull_delay_lanes_trace", sdelay, True),
             ("sync_pull_lanes_trace", None, True))
    rows, out = [], {}
    e_s = n * s
    # the ring words this data's grants touch, class by class: the kernel
    # reads and writes those words of the ring and no others
    touched = torch.empty((lanes, e_s, w), dtype=torch.int32, device=dev)
    ln.sync_pull_lanes_plain(*args, ring0.clone(), (LATENCY_T + 1) % d,
                             sdelay, touched)
    touched = (touched != 0).view(lanes, n, s, w)

    def ring_words(sd):
        if sd is None:
            return int(touched.any(2).sum())
        cls = sd.view(lanes, n, s, 1)
        return sum(int((touched & (cls == c)).any(2).sum())
                   for c in range(d - 1))

    for name, sd, rec in cases:
        # without session delays the fault storm's two-slot ring (path 61)
        ring_c = ring0 if sd is not None else ring0[:, :2].contiguous()
        dc = ring_c.shape[1]
        got, want = ring_c.clone(), ring_c.clone()
        gk = (torch.empty((lanes, e_s, w), dtype=torch.int32, device=dev)
              if rec else None)
        gp = torch.empty_like(gk) if rec else None
        outs_k, outs_p = [], []
        for r in range(2):
            slot = (LATENCY_T + 1 + r) % dc
            outs_k.append(ln.sync_pull_lanes(*args, got, slot, sd, gk))
            outs_p.append(ln.sync_pull_lanes_plain(*args, want, slot, sd, gp))
        equal, err = _equal_all(outs_k + [got] + ([gk] if rec else []),
                                outs_p + [want] + ([gp] if rec else []))
        for k in (0, lanes - 1):
            solo = ring_c[k].clone()
            sg = gk[k].clone() if rec else None
            for r in range(2):
                slot = (LATENCY_T + 1 + r) % dc
                fr = packed.sync_pull(
                    masks[k], miss[k], peers[k], ok[k],
                    solo[slot] if sd is None else solo, granted=sg,
                    sdelay=None if sd is None else sd[k], slot=slot)
            _solo_trap(f"{name} lane {k}",
                       [got[k], outs_k[1][k]] + ([gk[k]] if rec else []),
                       [solo, fr] + ([sg] if rec else []))
        out[name] = (want, outs_p[1], gp)
        work_k, work_p = ring_c.clone(), ring_c.clone()
        slot = (LATENCY_T + 1) % dc
        nbytes = (_pull_read_bytes(masks, miss, peers, ok)
                  + lanes * (e_s * 5 + (e_s * 4 if sd is not None else 0)
                             + n + (e_s * w * 4 if rec else 0))
                  + 2 * ring_words(sd) * 4)  # touched words in and out
        rows.append(_lane_row(
            name, "corrosion_tpu_torch/kernels/csrc/sync_pull.cu",
            ("corrosion_tpu/sim/packed.py:1256" if sd is not None
             else "corrosion_tpu/sim/packed.py:1238"), equal, err,
            _timed(timed, lambda sd=sd, gk=gk, wk=work_k, sl=slot:
                   ln.sync_pull_lanes(*args, wk, sl, sd, gk),
                   lambda wk=work_k, rc=ring_c: wk.copy_(rc)),
            _timed(timed, lambda sd=sd, gp=gp, wp=work_p, sl=slot:
                   ln.sync_pull_lanes_plain(*args, wp, sl, sd, gp),
                   lambda wp=work_p, rc=ring_c: wp.copy_(rc)),
            nbytes, lanes))

    want, fruitful, granted = out["sync_pull_delay_lanes_trace"]
    base, later = (LATENCY_T + 1) % d, (LATENCY_T + 2) % d
    grew = want & ~ring0
    _trap("lane packed 6", "a sync slot already holding an earlier round's "
          "slower grant: round t's class 1 is round t + 1's class 0, and "
          "read-OR-write keeps both (words with bit 31)",
          bool(((ring0[:, later] != 0) & (grew[:, later] != 0)).any())
          and bool((grew < 0).any()))
    g_any = (granted != 0).any(2).view(lanes, n, s)
    cls = sdelay.view(lanes, n, s)
    past = (cls == d - 1) & g_any
    # a class past D - 2: granted, yet the same pull without those edges
    # leaves the ring as it is
    cut_ring = ring0.clone()
    ln.sync_pull_lanes_plain(masks, miss, peers, ok & (cls != d - 1),
                             cut_ring, base, sdelay)
    one_round = ring0.clone()
    ln.sync_pull_lanes_plain(*args, one_round, base, sdelay)
    _trap("lane packed 7", "a grant of a class past D - 2 lands nowhere",
          bool(past.any()) and torch.equal(one_round, cut_ring))
    delayed_only = fruitful & ~(g_any & (cls == 0)).any(2)
    _trap("lane packed 8", "fruitful from grants in delayed classes only "
          "(class 1, or past D - 2)", bool(delayed_only.any()))
    blocked = faults._block_plain(rf, src.repeat(lanes), peers.reshape(-1))
    one_way = (refused.reshape(-1) & ~blocked).view(lanes, -1)
    ref = [int(x) for x in acc[:, 4]]
    want_ref = [int((ok0[k] & refused[k]).sum()) for k in range(lanes)]
    _trap("lane packed 9", "sessions refused in one direction only, each "
          "lane's refusals in its own slot, the lane without sessions 0",
          bool(one_way[:-1].any()) and ref == want_ref
          and len(set(ref)) > 1 and ref[-1] == 0)
    return rows, granted


def compare_packed_lane_trace_words(dev, g, lanes, granted, n=STORM_N, f=3,
                             timed=True):
    """K17's grant and coverage lane entries and K18's words lane entry
    on K lanes of the storm's words, each into its lane's own count rows
    or accumulators of a lane trace (rows 3·P apart, slots 12 apart) and
    against its plain version; the last lane held to the solo entry."""
    from corrosion_tpu_torch.sim import telemetry as tel

    cfg, meta = _storm_cfg(n, dev)
    w, p = cfg.n_payloads // 32, cfg.n_payloads
    e_s = granted.shape[1]
    have0 = _random_words(g, (lanes, n, w), dev, 2)
    have = have0 | _random_words(g, (lanes, n, w), dev, 3)
    alive = torch.as_tensor((g.random((lanes, n)) < 0.03) * 2,
                            dtype=torch.uint8, device=dev)
    sending = _random_words(g, (lanes, n, w), dev, 2)
    ok = torch.as_tensor(g.random((lanes, n * f)) < 0.9, device=dev)
    counts = [torch.zeros((lanes, 3, p), dtype=torch.int32, device=dev)
              for _ in range(2)]
    accs = [torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
            for _ in range(2)]
    tel.count_words_lanes_(counts[0][:, 2], granted)
    tel.count_words_lanes_plain(counts[1][:, 2], granted)
    tel.coverage_delivered_lanes_(counts[0][:, 0:2], have, have0, alive)
    tel.coverage_delivered_lanes_plain(counts[1][:, 0:2], have, have0, alive)
    tel.wire_words_lanes_(accs[0][:, 0:2], sending, meta.nbytes, ok, f)
    tel.wire_words_lanes_plain(accs[1][:, 0:2], sending, meta.nbytes, ok, f)
    solo_c = torch.zeros((3, p), dtype=torch.int32, device=dev)
    solo_a = torch.zeros(12, dtype=torch.int64, device=dev)
    tel.count_words_(solo_c[2], granted[-1])
    tel.coverage_delivered_(solo_c[0:2], have[-1], have0[-1], alive[-1])
    tel.wire_words_(solo_a[0:2], sending[-1], meta.nbytes, ok[-1], f)
    _solo_trap("trace words lanes", [counts[0][-1], accs[0][-1]],
               [solo_c, solo_a])
    rows = []
    specs = (
        ("trace_counts_lanes", "trace_counts_lanes",
         "corrosion_tpu/sim/fused.py:109", 2, 3,
         lambda cn, a: tel.count_words_lanes_(cn[:, 2], granted),
         lambda cn, a: tel.count_words_lanes_plain(cn[:, 2], granted),
         lanes * (e_s * w * 4 + p * 4 * 2)),
        ("trace_coverage_lanes", "trace_counts_lanes",
         "corrosion_tpu/sim/telemetry.py:290", 0, 2,
         lambda cn, a: tel.coverage_delivered_lanes_(cn[:, 0:2], have,
                                                     have0, alive),
         lambda cn, a: tel.coverage_delivered_lanes_plain(cn[:, 0:2], have,
                                                          have0, alive),
         lanes * (2 * n * w * 4 + n + 2 * p * 4 * 2)),
        ("trace_wire_lanes", "trace_wire_lanes",
         "corrosion_tpu/sim/fused.py:192", None, None,
         lambda cn, a: tel.wire_words_lanes_(a[:, 0:2], sending, meta.nbytes,
                                             ok, f),
         lambda cn, a: tel.wire_words_lanes_plain(a[:, 0:2], sending,
                                                  meta.nbytes, ok, f),
         lanes * (n * w * 4 + n * f + 2 * 8) + p * 4))
    for name, kernel, replaces, lo, hi, run_k, run_p, nbytes in specs:
        if lo is None:
            got, want = accs[0][:, 0:2], accs[1][:, 0:2]
        else:
            got, want = counts[0][:, lo:hi], counts[1][:, lo:hi]
        equal, err = _equal_all([got], [want])
        wk = [torch.zeros_like(counts[0]), torch.zeros_like(accs[0])]
        wp = [torch.zeros_like(counts[0]), torch.zeros_like(accs[0])]

        def zero(ws):
            for x in ws:
                x.zero_()

        rows.append(dict(_lane_row(
            name, "corrosion_tpu_torch/kernels/csrc/" + (
                "trace_wire.cu" if lo is None else "trace_counts.cu"),
            replaces, equal, err,
            _timed(timed, lambda run_k=run_k: run_k(*wk),
                   lambda: zero(wk)),
            _timed(timed, lambda run_p=run_p: run_p(*wp),
                   lambda: zero(wp)),
            nbytes, lanes), kernel=kernel))
    _trap("lane packed 10", "each lane's counts and wire totals land in its "
          "own rows and slots (the lanes' totals differ)",
          len({int(x) for x in counts[0][:, 2].sum(1)}) > 1
          and len({int(x) for x in accs[0][:, 0]}) > 1)
    return rows


def compare_packed_lane_latency_kernels(dev, seed=16, lanes=ENSEMBLE_LANES,
                                        timed=True, big=True):
    """Phase 3lp: every lane entry and recording form the latency plans
    and the flight recorder add to the packed round's lanes against its
    plain version at K = 8 on the 100k paths' shapes (W = 16, D = 4, F =
    S = 3), lane 0 and the last lane held to the solo entry on their
    inputs, every trap reached; ``big`` False shrinks 100 000 nodes to
    1200 (a CPU rehearsal)."""
    g = np.random.default_rng(seed)
    n = STORM_N if big else 1200
    rows = compare_packed_lane_scatter_jitter(dev, g, lanes, n, timed)
    sync_rows, granted = compare_packed_lane_sync_delay(dev, g, lanes, n,
                                                        timed)
    rows += sync_rows
    rows += compare_packed_lane_trace_words(dev, g, lanes, granted, n,
                                            timed=timed)
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: the lane rows each path 60-62 launches, besides `LANE_PACKED_CORE`
LANE_PACKED_CORE = ("threefry_lanes", "sample_targets_lanes",
                    "merge_entries_lanes", "broadcast_scatter_lanes",
                    "gaps_refresh_lanes", "converge_fold_lanes",
                    "word_phases_lanes", "fault_reach_lanes",
                    "node_faults_lanes")
_PACKED_RECORDING = ("trace_counts_lanes", "trace_wire_lanes",
                     "trace_row_lanes")
PACKED_LANE_PATHS = (
    ("latency_storm_100k_seeds8", "latency",
     ("broadcast_scatter_lossy_lanes", "broadcast_scatter_jitter_lanes",
      "sync_pull_delay_lanes", "fault_edges_delay")),
    ("fault_storm_100k_seeds8_telemetry", "fault_telemetry",
     ("broadcast_scatter_lossy_lanes_trace", "sync_pull_lanes_trace",
      "fault_edges_lanes_count", *_PACKED_RECORDING)),
    ("latency_storm_100k_seeds8_wire", "latency_wire",
     ("broadcast_scatter_lossy_lanes_trace",
      "broadcast_scatter_jitter_lanes_trace", "sync_pull_delay_lanes_trace",
      "fault_edges_delay_lanes_count", *_PACKED_RECORDING)),
)


def packed_lane_path_spec(which, seeds=range(ENSEMBLE_LANES)):
    from corrosion_tpu_torch.campaign import spec as sp

    return {
        "latency": lambda: sp.latency_storm_seeds_spec(seeds),
        "fault_telemetry": lambda: sp.storm_seeds_spec(seeds, faults=True),
        "latency_wire": lambda: sp.latency_storm_seeds_spec(
            seeds, measure_wire=True),
    }[which]()


def _peak_sites(run, top=8):
    """Run ``run()`` with the caching allocator's history on and replay
    the allocations it made to the moment their live bytes peaked
    (tensors held before the call do not count).  Returns that peak and
    the ``top`` call sites of the port (up to three frames of
    `corrosion_tpu_torch`, innermost first) by the bytes they held at
    the peak."""
    mem = torch.cuda.memory
    torch.cuda.synchronize()
    mem._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        run()
        torch.cuda.synchronize()
        events = mem._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        mem._record_memory_history(enabled=None)

    def replay(stop):
        live, now, peak, at = {}, 0, 0, -1
        for i, ev in enumerate(events[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                now += ev["size"]
                if now > peak:
                    peak, at = now, i
            elif ev["action"].startswith("free") and ev["addr"] in live:
                now -= live.pop(ev["addr"])["size"]
        return live, peak, at

    _, peak, at = replay(len(events))
    live, _, _ = replay(at + 1)
    sites = {}
    for ev in live.values():
        frames = [f"{f['filename'].split('corrosion_tpu_torch/')[-1]}:"
                  f"{f['line']} {f['name']}" for f in ev.get("frames", ())
                  if "corrosion_tpu_torch" in f["filename"]][:3]
        key = " < ".join(frames) or "outside the port"
        sites[key] = sites.get(key, 0) + ev["size"]
    ranked = sorted(sites.items(), key=lambda kv: -kv[1])[:top]
    return peak, [{"site": k, "bytes": v} for k, v in ranked]


def packed_latency_ensemble_paths(dev, goldens, trace_dir,
                                  dense_latency_wall=None):
    """Paths 60-62: latency plans and the flight recorder on the packed
    round's lanes through `campaign.engine.run_campaign` (seeds 0-7), each
    from zeroed counters, every lane entry of the path launched and no
    solo entry of a kernel that has one, round_path "packed".  Path 60,
    latency-storm-100k-seeds8: the spec_hash, the pinned 8-lane digest and
    each lane's one-seed JAX pin; lanes 0 and 7 equal to the port's solo
    latency runs of their seeds on this card, lane 0 to JAX's solo
    golden; its wall beside 8 times the two solo walls' mean and the
    dense latency ensemble's (path 45).  Path 61, fault-storm-100k-seeds8 with the
    recorder: the packed golden's spec_hash and result_digest unmoved,
    lane 0's summary JAX's solo recording golden's and lanes 1-7 the
    pinned ones (wire_bytes within the f32 bound), every lane's trace its
    solo recording run's.  Path 62, the latency storm with measure_wire
    and a trace_dir: lane 0's summary and wire_bytes JAX's (within the
    bound), every lane's trace its solo recording run's, every per-lane
    JSONL the lane's rows.  Returns the launches per path and the printed
    numbers."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import (
        _lane_trace_path, run_campaign)
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim.telemetry import lane_trace, trace_rows

    launches, numbers = {}, {}
    for label, which, extra in PACKED_LANE_PATHS:
        spec = packed_lane_path_spec(which)
        recording = which != "latency"
        kept = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # earlier paths' tensors
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        art = run_campaign(spec, telemetry=recording,
                           trace_dir=trace_dir if which == "latency_wire"
                           else None, device=dev, lanes_out=kept)
        peak = torch.cuda.max_memory_allocated() - held
        counts = _path_launches(kernels, LANE_PACKED_CORE + extra, label,
                                telemetry=recording)
        solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
        if solo_on:
            raise AssertionError(f"{label}: solo entries {solo_on} launched "
                                 "on a lane path")
        launches[label] = counts
        cell = art["cells"][0]
        ps = cell["per_seed"]
        rounds = ps["rounds"]
        finals = kept[0]["finals"]
        summaries = (cell["telemetry"]["per_seed"] if recording else None)
        print(f"{label}: spec_hash={art['spec_hash']} result_digest="
              f"{art['result_digest']} wall_clock_s={cell['wall_clock_s']} "
              f"round_path={cell['round_path']} rounds={rounds} "
              f"p99={json.dumps(ps['p99_node_convergence_round'])} "
              f"wire_bytes={json.dumps(ps.get('wire_bytes'))} "
              f"summaries={json.dumps(summaries)}", flush=True)
        if cell["round_path"] != "packed" or not cell["all_converged"]:
            raise AssertionError(f"{label}: round_path {cell['round_path']}"
                                 f", all_converged {cell['all_converged']}")
        entry = {"ensemble_wall_s": cell["wall_clock_s"],
                 "max_memory_allocated_bytes": peak,
                 "held_at_entry_bytes": held}
        print(f"{label}: max_memory_allocated {peak} bytes beyond the "
              f"{held} held at entry", flush=True)
        if which == "latency":
            golden = goldens.LATENCY_STORM_100K_SEEDS8
            lanes = [{"seed": s, "rounds": rounds[i],
                      "p99_node_convergence_round":
                          ps["p99_node_convergence_round"][i],
                      "converged": ps["converged"][i],
                      "unconverged_nodes": ps["unconverged_nodes"][i],
                      "digest": state_digest(lane_state(finals, i))}
                     for i, s in enumerate(cell["seeds"])]
            got = {"spec_hash": art["spec_hash"],
                   "result_digest": art["result_digest"], "lanes": lanes}
            print(f"{label}: lanes {json.dumps(lanes)}", flush=True)
            if got != {k: golden[k] for k in got}:
                raise AssertionError(f"{label}: differs from its golden")
            solo0 = goldens.LATENCY_STORM_100K_SEED0
            if {k: lanes[0][k] for k in solo0} != solo0:
                raise AssertionError(f"{label}: lane 0 differs from JAX's "
                                     "solo golden")
            # every lane is a live-JAX pin: lanes 0 and K - 1 run solo
            # (the script's time, ROADMAP)
            k_last = len(spec.seeds) - 1
            solos = _fault_solo_runs(dataclasses.replace(
                spec, seeds=(spec.seeds[0], spec.seeds[k_last])), dev)
            if not all(_same_state(final, lane_state(finals, k))
                       for k, (_, final, _) in zip((0, k_last), solos)):
                raise AssertionError(f"{label}: lane 0 or {k_last} differs "
                                     "from its solo run")
            walls = [wall for _, _, wall in solos]
            solo_sum = sum(walls) * len(spec.seeds) / len(walls)
            entry.update(solo_walls_s=walls, solo_walls_sum_s=solo_sum,
                         dense_latency_ensemble_wall_s=dense_latency_wall)
            print(f"{label}: lanes 0 and {k_last} equal to their solo runs; "
                  f"ensemble wall {cell['wall_clock_s']} s against the solo "
                  f"walls' sum {solo_sum:.4f} s (K x the mean of {walls}) "
                  f"and the dense latency ensemble's {dense_latency_wall} s",
                  flush=True)
            # where that peak lies: the same cell once more, its
            # allocations replayed (after the timed run, which it would
            # slow)
            replayed, sites = _peak_sites(
                lambda: run_campaign(spec, device=dev))
            entry.update(replayed_peak_bytes=replayed, peak_sites=sites)
            print(f"{label}: replayed peak {replayed} bytes, by site "
                  f"{json.dumps(sites)}", flush=True)
        else:
            traces = kept[0]["traces"]
            if which == "fault_telemetry":
                golden = goldens.FAULT_STORM_100K_SEEDS8
                if (art["spec_hash"], art["result_digest"]) != (
                        golden["spec_hash"], golden["result_digest"]):
                    raise AssertionError(f"{label}: the recorder moved the "
                                         "artifact")
                solo0 = goldens.FAULT_STORM_100K_SEED0_TELEMETRY
                wants = [dict(solo0["summary"],
                              wire_bytes=solo0["wire_bytes"])] + list(
                    goldens.DENSE_FAULT_STORM_100K_SEEDS8_TELEMETRY[
                        "summaries"])
            else:
                golden = goldens.LATENCY_STORM_100K_SEEDS1_WIRE
                solo0 = goldens.LATENCY_STORM_100K_SEED0_TELEMETRY
                wants = [dict(solo0["summary"],
                              wire_bytes=solo0["wire_bytes"])]
                if rounds[:1] != golden["rounds"] or rounds != [
                        x["rounds"] for x in
                        goldens.LATENCY_STORM_100K_SEEDS8["lanes"]]:
                    raise AssertionError(f"{label}: rounds differ from the "
                                         "latency storm's")
                total = abs(golden["wire_bytes"][0]) * (1 + F32_ULP)
                # both channels' f32 bounds (`_wire_within`) and the sum's
                limit = ((300_000 + 512 + 3 + 4 * rounds[0]) * F32_ULP
                         * total + 0.2)
                gap = abs(ps["wire_bytes"][0] - golden["wire_bytes"][0])
                if gap > limit:
                    raise AssertionError(f"{label}: lane 0's wire_bytes "
                                         f"{ps['wire_bytes'][0]} vs JAX's "
                                         f"{golden['wire_bytes'][0]}")
                entry["wire_bytes_lane0_relative_gap"] = gap / total
            entry["wire_bytes_worst_relative_gap"] = max(
                _wire_within(g_, w_, r_, f"{label} lane {k}", 300_000, 512)
                for k, (g_, w_, r_) in enumerate(zip(summaries, wants,
                                                     rounds)))
            solos = _solo_traces(spec, dev)
            if [r for r, _, _ in solos] != rounds:
                raise AssertionError(f"{label}: rounds differ from the "
                                     "solos'")
            _lanes_equal_solo_traces(traces, solos, label)
            walls = [w for _, _, w in solos]
            entry.update(solo_walls_s=walls, solo_walls_sum_s=sum(walls))
            print(f"{label}: every lane's trace equal to its solo recording "
                  f"run; ensemble wall {cell['wall_clock_s']} s against the "
                  f"solo walls' sum {sum(walls):.4f} s", flush=True)
            if which == "latency_wire":
                for k, seed in enumerate(spec.seeds):
                    path = _lane_trace_path(trace_dir, spec, 0, seed)
                    with open(path) as f:
                        lines = [json.loads(line) for line in f]
                    head = lines[0]
                    want_rows = trace_rows(lane_trace(traces, k), rounds[k],
                                           spec.sim_config({}))
                    if (head["summary"] != summaries[k]
                            or head["seed"] != seed
                            or head["spec_hash"] != art["spec_hash"]
                            or lines[1:] != want_rows):
                        raise AssertionError(f"{label}: {path} differs")
                print(f"{label}: {len(spec.seeds)} flight-recorder files "
                      f"under {trace_dir} equal to the lanes' rows",
                      flush=True)
            del traces
        _trap(f"lane packed path {which}", "lanes that finish in different "
              "rounds leave the batch (with their traces) as their solo "
              "runs end", len(set(rounds)) > 1)
        del kept, finals
        numbers[label] = entry
        _lap(label)
    return launches, numbers


def profile_packed_lanes(dev, lanes=ENSEMBLE_LANES, start=5, rounds=3,
                         latency=True, telemetry=False):
    """``rounds`` rounds of the K-lane latency storm (or, without
    ``latency``, the fault storm) from round ``start`` (loss, the half
    split and, in the latency storm, the delay and jitter all on) through
    `sim.lanes.packed_lane_step`, the packed lane fault loop's body that
    `sim.lanes.run_lanes` runs, and the loop's one host read of the [K]
    flags; the first ``start`` rounds are setup.  With ``telemetry``
    every round records each lane's row."""
    from corrosion_tpu_torch.campaign.ensemble import (
        lane_plan_seeds, seed_states)
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim.runner import storm_fault_plan
    from corrosion_tpu_torch.sim.telemetry import new_trace_lanes
    from corrosion_tpu_torch.sim.topology import Topology, regions

    if latency:
        cfg, meta, fplan = _latency_storm(STORM_N, dev)
    else:
        cfg, meta = _storm_cfg(STORM_N, dev)
        fplan = faults.compile_plan(storm_fault_plan(STORM_N, 0), cfg,
                                    device=dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    seeds = lane_plan_seeds(range(lanes), dev)
    last_round = int(meta.round.max())  # run_lanes' one read a run

    def step(batch):
        batch, done = ln.packed_lane_step(batch, meta, cfg, topo, region,
                                          fplan, activity, telemetry,
                                          last_round=last_round)
        done.tolist()  # the loop's one host read a round
        return batch

    def setup():
        trace = (new_trace_lanes(cfg, start + 2 * rounds, lanes, dev)
                 if telemetry else None)
        batch = ln.packed_lane_batch(seed_states(cfg, range(lanes), dev), cfg,
                                     seeds, trace)
        for _ in range(start):
            batch = step(batch)
        torch.cuda.synchronize()
        return batch

    def run(batch):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            batch = step(batch)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"{'latency' if latency else 'fault'} "
                    f"storm-100k x{lanes} lanes rounds {start}-"
                    f"{start + rounds - 1}"
                    + (" with the recorder" if telemetry else ""), setup)


# -- metered budgets, topology families and every membership mode on the
# packed round's lanes (phase 3lm, paths 63-66) -----------------------------

SOLO_OF_LANE.update({
    "budget_words_lanes": "budget_words",
    "sync_pull_metered_lanes": "sync_pull_metered",
    "sync_pull_metered_lanes_trace": "sync_pull_metered",
    "broadcast_scatter_tiered_lanes": "broadcast_scatter_tiered",
    "broadcast_scatter_tiered_lanes_trace": "broadcast_scatter_tiered"})


def _device_words(g, shape, dev, ands=1):
    """`_random_words` drawn on ``dev`` from a generator seeded by ``g``:
    phase 3lm's inputs run to gigabytes, and drawing them on the host
    would take longer than the comparisons."""
    gen = torch.Generator(device=dev).manual_seed(int(g.integers(1 << 62)))

    def draw():
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    w = draw()
    for _ in range(ands - 1):
        w &= draw()
    return w


def _metered_trap(number, what, reached):
    _trap(f"lane metered {number}", what, reached)


def compare_packed_lane_budget(dev, g, lanes, n=GAPSTRESS_N, timed=True):
    """K16 on the lanes' rows at gapstress-25.6k's governor shapes (K
    lanes of N rows of W = 256 words, the gapstress sizes, its 5 MiB
    budget), each lane against its plain version and lanes 0 and K - 1
    against the solo entry: lane 0's rows bind (half their bits set,
    about 9.5 MB a row), lane 1's fit (one bit in 64), empty rows; a
    budget below the largest payload (a row whose first payload is
    larger keeps nothing); the rows folded at N' = 8m - 3 nodes, so
    K16's blocks of 8 rows span two lanes."""
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _gapstress(n, dev)
    w = cfg.n_payloads // 32
    budget = cfg.rate_limit_bytes_round
    elig = _device_words(g, (lanes, n, w), dev)
    elig[1] = _device_words(g, (n, w), dev, 6)
    elig[:, ::97] = 0
    got = ln.budget_prefix_words_lanes(elig, budget, meta.nbytes)
    want = ln.budget_prefix_words_lanes_plain(elig, budget, meta.nbytes)
    equal, err = _equal_all([got], [want])
    for k in (0, lanes - 1):
        _solo_trap(f"budget_words_lanes lane {k}", [got[k]],
                   [packed.budget_prefix_words(elig[k], budget,
                                               meta.nbytes)])
    binds = [bool((want[k] != elig[k]).any()) for k in range(lanes)]
    _metered_trap(1, "the governor binds in one lane (0) and not in another "
                  "(1)", binds[0] and not binds[1])
    _metered_trap(2, "a prefix that stops mid-word (a kept word that is "
                  "neither 0 nor its eligible word)",
                  bool(((want != 0) & (want != elig)).any()))
    # payload 5 (8 KiB) first, then payload 6 (1 B): under 6000 bytes the
    # larger payload stops the prefix, so the row keeps nothing
    small = elig.clone()
    small[:, 0, 0] = (1 << 5) | (1 << 6)
    got_s = ln.budget_prefix_words_lanes(small, 6000, meta.nbytes)
    want_s = ln.budget_prefix_words_lanes_plain(small, 6000, meta.nbytes)
    e_s, x_s = _equal_all([got_s], [want_s])
    _metered_trap(3, "a payload larger than the budget first in its row: "
                  "the row keeps nothing, not even the 1 B after it",
                  bool((want_s[:, 0] == 0).all()) and int(meta.nbytes[5])
                  > 6000 and int(meta.nbytes[6]) <= 6000)
    n_odd = n // 8 * 8 - 3
    odd = elig[:, :n_odd].contiguous()
    got_o = ln.budget_prefix_words_lanes(odd, budget, meta.nbytes)
    want_o = ln.budget_prefix_words_lanes_plain(odd, budget, meta.nbytes)
    e_o, x_o = _equal_all([got_o], [want_o])
    _metered_trap(4, f"K16's blocks of 8 folded rows span two lanes (N' = "
                  f"{n_odd}, not a multiple of 8), each row metered alone",
                  n_odd % 8 != 0 and e_o)
    row = _lane_row(
        "budget_words_lanes", _CSRC + "budget_words.cu",
        "corrosion_tpu/sim/packed.py:102", equal and e_s and e_o,
        max(err, x_s, x_o),
        _timed(timed, lambda: ln.budget_prefix_words_lanes(
            elig, budget, meta.nbytes)),
        _timed(timed, lambda: ln.budget_prefix_words_lanes_plain(
            elig, budget, meta.nbytes)),
        # the rows in and out, the sizes
        _nbytes(elig, meta.nbytes) + elig.numel() * 4, lanes)
    del got, want, small, got_s, want_s, odd, got_o, want_o
    return [row]


def compare_packed_lane_sync_metered(dev, g, lanes, n=GAPSTRESS_N,
                                     timed=True):
    """K3m's lane entry, with session delays and as its recording form,
    at gapstress-25.6k's shapes (K lanes of N = 25 600, W = 256, S = 3, D
    = 4) under its 4 MiB grant: lane 0's pullers lag serving peers by
    megabytes (the grant binds), lane 1's miss one bit in 64 (it does
    not); self and dead peers, words with bit 31, delay classes up to D -
    1 (past D - 2: granted, landing nowhere) on a ring whose slots hold
    words; the last lane without sessions.  Lanes 0 and K - 1 against the
    solo metered entry.  Returns the rows."""
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, meta = _gapstress(n, dev)
    w, s, d = cfg.n_payloads // 32, cfg.sync_peers, cfg.n_delay_slots
    masks = _device_words(g, (lanes, n, 4, w), dev)
    serving = ~_device_words(g, (lanes, n, w), dev, 3)
    lagging = _device_words(g, (lanes, n, w), dev, 3)
    even = torch.arange(n, device=dev)[None, :, None] % 2 == 0
    masks[:, :, 3] = torch.where(even, serving, lagging)
    # lane 1 holds nearly everything: its needs fit the grant
    masks[1, :, 3] = ~_device_words(g, (n, w), dev, 6)
    miss = _device_words(g, (lanes, n, w), dev, 2)
    me = np.arange(n)[None, :, None]
    peers = np.where(g.random((lanes, n, s)) < 0.03, me,
                     2 * g.integers(0, n // 2, (lanes, n, s)))
    peers = torch.as_tensor(peers, dtype=torch.int32, device=dev)
    ok = torch.as_tensor(g.random((lanes, n, s)) < 0.7, device=dev)
    ok[-1] = False
    sdelay = torch.as_tensor(g.integers(0, d, (lanes, n * s)),
                             dtype=torch.int32, device=dev)
    ring0 = _device_words(g, (lanes, d, n, w), dev, 5)
    grant = cfg.sync_budget_bytes
    slot = 1
    args = (masks, miss, peers, ok)
    e_s = n * s

    def pull(kernel, ring, sd, granted, budget=grant):
        fn = ln.sync_pull_lanes if kernel else ln.sync_pull_lanes_plain
        return fn(*args, ring, slot, sd, granted, budget, meta.nbytes)

    cases = (("sync_pull_metered_lanes", None, False),
             ("sync_pull_metered_lanes delays", sdelay, False),
             ("sync_pull_metered_lanes_trace", None, True),
             ("sync_pull_metered_lanes_trace delays", sdelay, True))
    checks, outs = {}, {}
    for label, sd, rec in cases:
        got, want = ring0.clone(), ring0.clone()
        gk = (torch.empty((lanes, e_s, w), dtype=torch.int32, device=dev)
              if rec else None)
        gp = torch.empty_like(gk) if rec else None
        fk = pull(True, got, sd, gk)
        fp = pull(False, want, sd, gp)
        checks[label] = _equal_all([fk, got] + ([gk] if rec else []),
                                   [fp, want] + ([gp] if rec else []))
        for k in (0, lanes - 1):
            solo = ring0[k].clone()
            sg = (torch.empty((e_s, w), dtype=torch.int32, device=dev)
                  if rec else None)
            fr = packed.sync_pull(masks[k], miss[k], peers[k], ok[k],
                                  solo[slot] if sd is None else solo, grant,
                                  meta.nbytes, sg,
                                  None if sd is None else sd[k], slot)
            _solo_trap(f"{label} lane {k}",
                       [got[k], fk[k]] + ([gk[k]] if rec else []),
                       [solo, fr] + ([sg] if rec else []))
        outs[label] = (want, fp, gp)
        del got, gk
    # the grant binds in lane 0 and not in lane 1: the unmetered pull
    # differs from the metered one in lane 0 only
    free = ring0[:2].clone()
    ln.sync_pull_lanes_plain(masks[:2], miss[:2], peers[:2], ok[:2], free,
                             slot)
    metered = outs["sync_pull_metered_lanes"][0][:2]
    _metered_trap(5, "the sync grant binds in one lane (0) and not in "
                  "another (1)", not torch.equal(free[0], metered[0])
                  and torch.equal(free[1], metered[1]))
    want, fruitful, granted = outs["sync_pull_metered_lanes_trace delays"]
    g_any = (granted != 0).any(2).view(lanes, n, s)
    cls = sdelay.view(lanes, n, s)
    cut_ring = ring0.clone()
    ln.sync_pull_lanes_plain(masks, miss, peers, ok & (cls != d - 1),
                             cut_ring, slot, sdelay, None, grant,
                             meta.nbytes)
    _metered_trap(6, "a delay class past D - 2 under metering: granted, "
                  "landing nowhere", bool(((cls == d - 1) & g_any).any())
                  and torch.equal(want, cut_ring))
    _metered_trap(7, "the lane without sessions pulls nothing and keeps its "
                  "ring", not bool(fruitful[-1].any())
                  and torch.equal(want[-1], ring0[-1])
                  and not bool(granted[-1].any()))
    _metered_trap(8, "grant words with bit 31", bool((granted < 0).any()))
    # the ring words the grants touch (the kernel reads and writes those
    # and no others), by class with the delays
    touched = (granted != 0).view(lanes, n, s, w)

    def ring_words(sd):
        if sd is None:
            return int(touched.any(2).sum())
        return sum(int((touched & (cls[..., None] == c)).any(2).sum())
                   for c in range(d - 1))

    rows = []
    for name, rec in (("sync_pull_metered_lanes", False),
                      ("sync_pull_metered_lanes_trace", True)):
        work_k, work_p = ring0.clone(), ring0.clone()
        gk = (torch.empty((lanes, e_s, w), dtype=torch.int32, device=dev)
              if rec else None)
        gp = torch.empty_like(gk) if rec else None
        equal = checks[name][0] and checks[name + " delays"][0]
        err = max(checks[name][1], checks[name + " delays"][1])
        # the mask and miss rows live sessions read (none in the last
        # lane), peers and ok, the sizes, fruitful, the grants, the ring
        # words they touch in and out
        nbytes = (_pull_read_bytes(masks, miss, peers, ok, True)
                  + _nbytes(peers, ok, meta.nbytes)
                  + lanes * n + (gk.numel() * 4 if rec else 0)
                  + 2 * ring_words(None) * 4)
        row = _lane_row(
            name, _CSRC + "sync_pull.cu", "corrosion_tpu/sim/packed.py:1238",
            equal, err,
            _timed(timed, lambda wk=work_k, gk=gk: pull(True, wk, None, gk),
                   lambda wk=work_k: wk.copy_(ring0)),
            # the plain version takes most of a second: one eager call
            _time_eager_ms(lambda wp=work_p, gp=gp: (
                wp.copy_(ring0), pull(False, wp, None, gp)), 1, warmup=0)
            if timed else None,
            nbytes, lanes)
        row["delays_ms"] = _timed(
            timed, lambda wk=work_k, gk=gk: pull(True, wk, sdelay, gk),
            lambda wk=work_k: wk.copy_(ring0))
        row["delays_bound_ms"] = _bound_ms(
            nbytes - 2 * ring_words(None) * 4 + sdelay.numel() * 4
            + 2 * ring_words(sdelay) * 4)
        rows.append(row)
        del work_k, work_p, gk, gp
    return rows


def _scatter_topo_case(dev, g, lanes, n, w, d, f, ands):
    """K lanes of one broadcast round's wire at (N, W, D, F): sending
    words, edges, slots, fault thresholds and jitter bounds; lane 1
    repeats lane 0's (only its keys and seed differ), the last lane
    attempts no edge."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds

    e = n * f
    c = SimpleNamespace(n=n, w=w, d=d, f=f, e=e)
    c.sending = _device_words(g, (lanes, n, w), dev, ands)
    c.dst = torch.as_tensor(g.integers(0, n, (lanes, e)), dtype=torch.int32,
                            device=dev)
    c.slot = torch.as_tensor(g.integers(0, d, (lanes, e)), dtype=torch.int32,
                             device=dev)
    c.ok = torch.as_tensor(g.random((lanes, e)) < 0.9, device=dev)
    c.thr = torch.as_tensor(np.where(g.random((lanes, e)) < 0.3, 0,
                                     g.integers(1, 80, (lanes, e))),
                            dtype=torch.uint8, device=dev)
    c.jit = torch.as_tensor(np.where(g.random((lanes, e)) < 0.9, 0,
                                     g.integers(1, 3, (lanes, e))),
                            dtype=torch.int32, device=dev)
    for x in (c.sending, c.dst, c.slot, c.ok, c.thr, c.jit):
        x[1] = x[0]
    c.ok[-1] = False
    c.ring0 = _device_words(g, (lanes, d, n, w), dev, 6)
    c.keys = _lane_keys(dev, lanes, 7000)
    c.topo_keys = _lane_keys(dev, lanes, 7100)
    c.seeds = lane_plan_seeds(range(lanes), dev)
    return c


def compare_packed_lane_scatter_topo(dev, g, lanes, n=GAPSTRESS_N,
                                     n_wan=STORM_N, timed=True):
    """K10's flat topology stream on the lanes at gapstress-25.6k's wire
    (K lanes of E = 76 800 edges, W = 256, D = 4, loss 0.3) and the tiered
    lane instantiation at the 100k WAN storm's (E = 300 000, W = 16, D =
    3, wan-3x2's tiers): each alone (the paths' cases), with the fault
    loss, with the fault loss and the jitter, as recording forms, and the
    tiered form over the certainty pin; each against its plain version,
    lanes 0 and K - 1 against the solo K10 on their inputs.  Returns the
    rows."""
    from corrosion_tpu_torch.device import popcount
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.topology import loss_threshold

    cfg, _ = _gapstress(n, dev)
    flat = _scatter_topo_case(dev, g, lanes, n, cfg.n_payloads // 32,
                              cfg.n_delay_slots, cfg.fanout, 4)
    wan_cfg, _ = _storm_cfg(n_wan, dev)
    tiered = _scatter_topo_case(dev, g, lanes, n_wan,
                                wan_cfg.n_payloads // 32, WAN_D,
                                wan_cfg.fanout, 2)
    wan, pin = _topo("wan-3x2"), _pin_topo()
    thr77 = loss_threshold(0.3)
    # (label, case, topo_thr, tiers, fault, jitter, recording, row name)
    cases = (
        ("flat", flat, thr77, None, False, False, False,
         "broadcast_scatter_lossy_lanes_topo"),
        ("flat fault", flat, thr77, None, True, False, False, None),
        ("flat fault jitter", flat, thr77, None, True, True, False, None),
        ("flat recording", flat, thr77, None, False, False, True,
         "broadcast_scatter_lossy_lanes_trace_topo"),
        ("flat fault jitter recording", flat, thr77, None, True, True, True,
         None),
        ("tiered", tiered, 0, wan, False, False, False,
         "broadcast_scatter_tiered_lanes"),
        ("tiered fault", tiered, 0, wan, True, False, False, None),
        ("tiered fault jitter", tiered, 0, wan, True, True, False, None),
        ("tiered recording", tiered, 0, wan, False, False, True,
         "broadcast_scatter_tiered_lanes_trace"),
        ("tiered fault jitter recording", tiered, 0, wan, True, True, True,
         None),
        ("tiered pin recording", tiered, 0, pin, False, False, True, None),
    )

    def run(kernel, c, ring, tt, tiers, fault, jitter, dropped):
        fn = ln.scatter_lanes if kernel else ln.scatter_lanes_plain
        fn(ring, c.sending, c.dst, c.slot, c.ok, c.f,
           c.thr if fault else None, c.keys if fault else None,
           c.seeds if fault else None, c.jit if jitter else None, dropped,
           tt, c.topo_keys, tiers)

    checks, outs, rows = {}, {}, []
    for label, c, tt, tiers, fault, jitter, rec, name in cases:
        got, want = c.ring0.clone(), c.ring0.clone()
        dk = torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
        dp = torch.zeros_like(dk)
        run(True, c, got, tt, tiers, fault, jitter, dk[:, 2] if rec else None)
        run(False, c, want, tt, tiers, fault, jitter,
            dp[:, 2] if rec else None)
        checks[label] = _equal_all([got, dk], [want, dp])
        for k in (0, lanes - 1):
            solo, sd = c.ring0[k].clone(), _acc(dev)
            packed.scatter_sending_lossy(
                solo, c.sending[k], c.dst[k], c.slot[k], c.ok[k],
                c.thr[k] if fault else None, c.keys[k], int(c.seeds[k]),
                c.f, tt, c.topo_keys[k], sd if rec else None,
                c.jit[k] if jitter else None,
                **({} if tiers is None else {"tiers": tiers}))
            _solo_trap(f"{label} lane {k}", [got[k], dk[k, 2]],
                       [solo, sd if rec else dk[k, 2]])
        outs[label] = (want, dp[:, 2].clone())
        del got
        if name is None:
            continue
        # the bound: eight hashes a sending (edge, word) on an ok edge
        # whose topology threshold draws (flat 77; a tier between 1 and
        # 255)
        hashes = 0
        for k in range(lanes):
            words = packed._edge_words(c.sending[k], c.ok[k], c.f)
            if tiers is None:
                draws = torch.ones(c.e, dtype=torch.bool, device=dev)
            else:
                raw = _topo_raw(tiers, c.n, dev, c.dst[k])
                draws = (raw > 0) & (raw < 256)
            hashes += 8 * int(((words != 0) & draws[:, None]).sum())
            del words
        rows_touched = int(torch.unique(
            (torch.arange(lanes, device=dev)[:, None] * (c.d * c.n)
             + c.slot.long() * c.n + c.dst.long())[c.ok]).numel())
        nbytes = (c.sending.numel() * 4 + lanes * c.e * (4 + 4 + 1)
                  + 2 * rows_touched * c.w * 4 + (lanes * 8 if rec else 0))
        work_k, work_p = c.ring0.clone(), c.ring0.clone()
        acc_k, acc_p = (torch.zeros((lanes, 12), dtype=torch.int64,
                                    device=dev) for _ in range(2))

        def restore(work, acc, c=c):
            work.copy_(c.ring0)
            acc.zero_()

        row = _ops_row(
            name, _CSRC + "broadcast_scatter.cu",
            ("corrosion_tpu/sim/topology.py:267" if tiers is None
             else "corrosion_tpu/sim/topology.py:240") + _VMAP,
            None, None,
            _timed(timed, lambda c=c, tt=tt, tiers=tiers, rec=rec: run(
                True, c, work_k, tt, tiers, False, False,
                acc_k[:, 2] if rec else None),
                lambda: restore(work_k, acc_k)),
            # the plain versions find their draws on the host and take
            # seconds a call: one eager call
            _time_eager_ms(lambda c=c, tt=tt, tiers=tiers, rec=rec: (
                restore(work_p, acc_p), run(
                    False, c, work_p, tt, tiers, False, False,
                    acc_p[:, 2] if rec else None)),
                1, warmup=0) if timed else None,
            nbytes, hashes * OPS_PER_HASH, lanes=lanes, hashes=hashes,
            kernel=name.replace("_topo", ""))
        rows.append(row)
        del work_k, work_p
    # each row holds every case of its form
    for row in rows:
        prefix = row["name"].split("_lanes")[0]
        mine = [k for k in checks if k.split()[0] == (
            "tiered" if "tiered" in prefix else "flat")
            and ("recording" in k) == row["kernel"].endswith("_trace")]
        row["equal"] = all(checks[k][0] for k in mine)
        row["max_abs_err"] = max(checks[k][1] for k in mine)
        row["cases"] = mine
    _metered_trap(9, "lanes whose k_drop, phase keys and plan seeds differ "
                  "drop their own payloads in every drawing case (lanes 0 "
                  "and 1 share every other input)",
                  all(not torch.equal(want[0], want[1])
                      for label, (want, _) in outs.items()
                      if "pin" not in label))
    flat_drop = outs["flat recording"][1]
    tier_drop = outs["tiered recording"][1]
    _metered_trap(10, "the lane without edges writes nothing and counts no "
                  "drop; the others' drops differ",
                  all(torch.equal(outs[k][0][-1], (flat if k.startswith(
                      "flat") else tiered).ring0[-1]) for k in outs)
                  and int(flat_drop[-1]) == 0 and int(tier_drop[-1]) == 0
                  and len({int(x) for x in flat_drop[:-1]}) > 1)
    pin_drop = outs["tiered pin recording"][1]
    severed = (_topo_raw(pin, n_wan, dev, tiered.dst[0]) >= 256) & \
        tiered.ok[0]
    sent = packed._edge_words(tiered.sending[0], tiered.ok[0], tiered.f)
    _metered_trap(11, "a tier at certainty (threshold 256) drops every "
                  "payload of its edges without a draw, on every lane",
                  bool(severed.any()) and int(pin_drop[0]) == int(
                      popcount(sent[severed]).sum()))
    _metered_trap(12, "the jitter and the fault stream compose with the "
                  "topology stream (each case's ring differs from the "
                  "topology stream's alone)",
                  not torch.equal(outs["flat"][0], outs["flat fault"][0])
                  and not torch.equal(outs["flat fault"][0],
                                      outs["flat fault jitter"][0])
                  and not torch.equal(outs["tiered"][0],
                                      outs["tiered fault jitter"][0]))
    del flat, tiered, outs
    return rows


def compare_packed_lane_node_faults_view(dev, g, lanes, n=CHURN_N):
    """K11's lane entry with the full view's tables (the packed lanes'
    full view, B16s's packed half) at churn-full-4096's width: the fault
    storm's wipe round 20 over K lanes of random beliefs, tables and
    carry, against its plain version and, on lanes 0 and K - 1, the solo
    word entry; every lane's wiped row back to 0, 0, -1, the others
    untouched.  A check: no path of this script runs full view on the
    packed lanes, so it has no kernels-line row."""
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, _, _, rf = _storm_fault_round(dev, n, 20)
    w, m, a, k = cfg.n_payloads // 32, 64, cfg.n_writers, cfg.gap_slots
    gen = torch.Generator(device=dev).manual_seed(int(g.integers(1 << 62)))

    def ints(hi, shape, lo=0, dtype=torch.int32):
        return torch.randint(lo, hi, shape, dtype=dtype, device=dev,
                             generator=gen)

    slim0 = SimpleNamespace(
        alive=torch.zeros((lanes, n), dtype=torch.uint8, device=dev),
        heads=ints(9, (lanes, n, a)), gap_lo=ints(9, (lanes, n, a, k)),
        gap_hi=ints(9, (lanes, n, a, k)), pid=ints(n, (lanes, n, m), -1),
        pkey=ints(4096, (lanes, n, m), -1), psince=ints(30, (lanes, n, m), -1),
        view=ints(3, (lanes, n, n), dtype=torch.int8),
        vinc=ints(8, (lanes, n, n)), suspect_since=ints(30, (lanes, n, n), -1),
        pview=ints(n, (lanes, n, 16), -1))
    names = tuple(vars(slim0))
    # the packed loop's slim state: zero-width payload tensors
    u8 = torch.uint8
    slim0.have = torch.zeros((lanes, n, 0), dtype=u8, device=dev)
    slim0.relay_left = torch.zeros((lanes, n, 0), dtype=u8, device=dev)
    slim0.inflight = torch.zeros((lanes, 2, n, 0), dtype=torch.int32,
                                 device=dev)
    slim0.sync_inflight = torch.zeros((lanes, 2, n, 0), dtype=u8,
                                      device=dev)
    carry0 = [_device_words(g, (lanes, n, w), dev) for _ in range(5)] + [
        _device_words(g, (lanes, 2, n, w), dev) for _ in range(2)]

    def run(fn, k=None):
        pick = (lambda x: x.clone()) if k is None else (
            lambda x: x[k].clone())
        slim = SimpleNamespace(**{nm: pick(x)
                                  for nm, x in vars(slim0).items()})
        ys = [pick(y) for y in carry0]
        carry = packed.PackedCarry(have=ys[0], inflight=ys[5],
                                   relay=packed.Planes(*ys[1:5]),
                                   sync_buf=ys[6])
        if k is None:
            fn(slim, carry, rf)
        else:
            fn(SimpleNamespace(**vars(slim)), carry, rf)
        return [getattr(slim, nm) for nm in names] + ys

    got = run(ln.apply_round_faults_lanes)
    want = run(ln.apply_round_faults_lanes_plain)
    equal, err = _equal_all(got, want)
    if not equal:
        raise AssertionError("K11's lane entry with the full view != its "
                             "plain version")
    for k in (0, lanes - 1):
        solo = run(packed.apply_round_faults, k)
        _solo_trap(f"node_faults_lanes full view lane {k}",
                   [x[k] for x in got], solo)
    victim = int(rf.wipe.nonzero()[0])
    view, vinc, since = (got[names.index(x)] for x in (
        "view", "vinc", "suspect_since"))
    others = torch.arange(n, device=dev) != victim
    pview = got[names.index("pview")]
    _metered_trap(13, "K11's lane entry puts every lane's wiped full-view "
                  "row back to 0, 0, -1, empties its PeerSwap view and "
                  "leaves the other rows",
                  bool((view[:, victim] == 0).all())
                  and bool((vinc[:, victim] == 0).all())
                  and bool((since[:, victim] == -1).all())
                  and bool((pview[:, victim] == -1).all())
                  and torch.equal(view[:, others], slim0.view[:, others])
                  and bool((slim0.view[:, victim] != 0).any()))


def compare_packed_lane_metered_kernels(dev, seed=17, lanes=ENSEMBLE_LANES,
                                        timed=True, big=True):
    """Phase 3lm: K16 on the lanes' rows, K3m's lane entry (its delay
    classes and its recording form), K10's flat topology stream on the
    lanes and the tiered lane instantiation (each with and without the
    fault loss and the jitter, and as recording forms) against their plain
    versions at K = 8 on the paths' shapes (gapstress-25.6k's, the 100k
    WAN storm's), lanes 0 and K - 1 held to the solo entries, every trap
    reached; K1's view lane entry (ground truth) and K21's lane entries
    at storm-peerswap-25.6k's (path 66: V = 16), the last lane held to
    the solo entry; ``big`` False shrinks the nodes to 163, 300 and 333
    (a CPU rehearsal)."""
    g = np.random.default_rng(seed)
    n = GAPSTRESS_N if big else 163
    n_wan = STORM_N if big else 300
    n_swap = PEERSWAP_N if big else 333
    rows = compare_packed_lane_budget(dev, g, lanes, n, timed)
    rows += compare_packed_lane_sync_metered(dev, g, lanes, n, timed)
    rows += compare_packed_lane_scatter_topo(dev, g, lanes, n, n_wan, timed)
    # at N = 25 600 (100 blocks a lane) no block spans two lanes: phase
    # 3lt reaches that trap at N = 1000
    rows += compare_lane_sample_view(dev, g, lanes, n_swap, timed=timed,
                                     suffix="_25600", cases=(("", False),))
    rows += compare_lane_peerswap(dev, g, lanes, n_swap, timed=timed,
                                  suffix="_25600", block_trap=not big)
    compare_packed_lane_node_faults_view(dev, g, lanes,
                                         CHURN_N if big else 1031)
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: the lane rows every path 63-66 launches
AXIS_CORE = ("threefry_lanes", "gaps_refresh_lanes", "converge_fold_lanes",
             "word_phases_lanes")
_PARTIAL_VIEW = ("sample_targets_lanes", "merge_entries_lanes")
_TIERED = ("edge_slots_lanes", "edge_reach_lanes")
#: paths 63-66: (label, which, the lane rows besides `AXIS_CORE`, those of
#: the recording run, or None where the path has none)
PACKED_AXIS_PATHS = (
    ("gapstress_25600_seeds8", "gapstress",
     (*_PARTIAL_VIEW, "budget_words_lanes", "broadcast_scatter_lossy_lanes",
      "sync_pull_metered_lanes"),
     (*_PARTIAL_VIEW, "budget_words_lanes",
      "broadcast_scatter_lossy_lanes_trace", "sync_pull_metered_lanes_trace",
      *_PACKED_RECORDING)),
    ("storm_wan_3x2_100k_seeds8", "wan-3x2",
     (*_PARTIAL_VIEW, *_TIERED, "broadcast_scatter_tiered_lanes",
      "sync_pull_lanes"),
     (*_PARTIAL_VIEW, *_TIERED, "broadcast_scatter_tiered_lanes_trace",
      "sync_pull_lanes_trace", *_PACKED_RECORDING)),
    ("storm_wan_fly_6r_100k_seeds8", "wan-fly-6r",
     (*_PARTIAL_VIEW, *_TIERED, "broadcast_scatter_tiered_lanes",
      "sync_pull_lanes"), None),
    ("storm_hetero_degree_100k_seeds8", "hetero-degree",
     (*_PARTIAL_VIEW, "degree_caps_lanes", "broadcast_scatter_lanes",
      "sync_pull_lanes"), None),
    ("storm_peerswap_25600_seeds8", "peerswap",
     ("sample_view_lanes", "peerswap_lanes", "broadcast_scatter_lanes",
      "sync_pull_lanes"), None),
)


def axis_path_case(which, dev, seeds=None):
    """The cell of path ``which``: (cfg, topo, meta, seeds, spec) — a
    campaign spec for the topology storms (run through the engine), None
    for the two cells a user runs as a seed ensemble: gapstress-25.6k
    (config #5b: 8192 payloads in a burst, `gapstress_payload_sizes`, 30 %
    flat loss, both byte budgets binding; seeds 1-8, lane 0 the
    config's own seed 1) and the PeerSwap storm at 25 600 × 512 (ground
    truth membership; seeds 0-7)."""
    from corrosion_tpu_torch.campaign import spec as sp
    from corrosion_tpu_torch.sim.runner import _write_storm
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.topology import Topology

    if which == "gapstress":
        cfg, meta = _gapstress(GAPSTRESS_N, dev)
        return (cfg, Topology(loss=0.3), meta,
                tuple(seeds or range(1, ENSEMBLE_LANES + 1)), None)
    if which == "peerswap":
        cfg, meta = _write_storm(PEERSWAP_N, 512, dev, sampler="peerswap")
        return (cfg, Topology(), meta, tuple(seeds or range(ENSEMBLE_LANES)),
                None)
    spec = sp.storm_topology_seeds_spec(
        which, tuple(seeds or range(ENSEMBLE_LANES)))
    cfg = spec.sim_config({})
    return (cfg, spec.topo({}),
            uniform_payloads(cfg, dev, inject_every=spec.inject_every({})),
            spec.seeds, spec)


def _axis_solo_run(cfg, topo, meta, seed, dev, telemetry):
    """The port's solo run of one seed of a path on the card
    (`run_to_convergence`, the packed round): its final state, trace
    (None without ``telemetry``) and host wall."""
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    state = new_sim(cfg, int(seed), dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_to_convergence(state, meta, cfg, topo, 3000, telemetry)
    torch.cuda.synchronize()
    return res[0], res[2] if telemetry else None, time.monotonic() - t0


def _axis_run(dev, cfg, topo, meta, seeds, spec, telemetry):
    """One run of a path's cell from zeroed counters: through the engine
    (a spec) or `run_seed_ensemble`; returns (finals, metrics, traces,
    wall, the artifact or None)."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import run_seed_ensemble

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    if spec is not None:
        kept = {}
        art = run_campaign(spec, telemetry=telemetry, device=dev,
                           lanes_out=kept)
        cell = art["cells"][0]
        return (kept[0]["finals"], kept[0]["metrics"],
                kept[0].get("traces"), cell["wall_clock_s"], art)
    t0 = time.monotonic()
    out = run_seed_ensemble(None, cfg, topo, meta, seeds, max_rounds=3000,
                            telemetry=telemetry, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return out[0], out[1], out[2] if telemetry else None, wall, None


def packed_axis_ensemble_paths(dev, goldens):
    """Paths 63-66: metered budgets, the topology families and PeerSwap
    under ground-truth membership on the packed round's lanes, each from
    zeroed counters, every lane entry of the path launched and no solo
    entry of a kernel that has one.  Path 63, gapstress-25.6k-seeds8
    (seeds 1-8 through `run_seed_ensemble`, with and without the
    recorder): lane 0 JAX's `GAPSTRESS_25600_SEED1` (overflow share too)
    and its telemetry golden.  Path 64, storm-wan-3x2-100k-seeds8 on the
    packed round through `run_campaign`, with and without the recorder:
    the spec_hash, the packed cell's result_digest, every lane JAX's
    dense lane pin (the dense == packed contract) and lane 0's trace
    `STORM_WAN_3X2_100K_SEED0_TELEMETRY`.  Path 65, the wan-fly-6r and
    hetero-degree storms: lane 0 their solo goldens.  Path 66, the
    PeerSwap storm at 25 600 nodes: every lane its one-seed JAX pin
    (digest and pview_digest).  Every lane (and trace) equal to its solo
    run on this card (the solo runs one at a time, after the ensemble),
    but on path 64, whose every lane a JAX pin holds: there lanes 0 and
    K - 1; only a pinned lane's state is hashed on the host.  Each wall
    beside the solo walls' sum (path 64: K times the mean of its two).
    Returns the launches per path and the printed numbers."""
    import gc

    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.sim.round import RunMetrics

    gc.collect()  # what earlier phases left in reference cycles
    launches, numbers = {}, {}
    for label, which, rows, rec_rows in PACKED_AXIS_PATHS:
        cfg, topo, meta, seeds, spec = axis_path_case(which, dev)
        # the lanes whose digests a golden pins
        pinned = (range(len(seeds)) if which in ("wan-3x2", "peerswap")
                  else (0,))
        entry = {}
        for telemetry in ((False, True) if rec_rows is not None
                          else (False,)):
            run_label = label + ("_telemetry" if telemetry else "")
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            finals, metrics, traces, wall, art = _axis_run(
                dev, cfg, topo, meta, seeds, spec, telemetry)
            peak = torch.cuda.max_memory_allocated() - held
            counts = _path_launches(
                kernels, AXIS_CORE + (rec_rows if telemetry else rows),
                run_label, telemetry=telemetry)
            solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
            if solo_on:
                raise AssertionError(f"{run_label}: solo entries {solo_on} "
                                     "launched on a lane path")
            launches[run_label] = counts
            rounds = [int(x) for x in finals.t]
            lanes = None
            if not telemetry:
                lanes = [dict(_solo_record(lane_state(finals, k), RunMetrics(
                    *(x[k] for x in metrics)), meta), seed=int(seeds[k]),
                    gap_overflow_frac_max=float(metrics.overflow_frac[k]))
                    for k in pinned]
                print(f"{run_label}: rounds={rounds} pinned lanes "
                      f"{json.dumps(lanes)}", flush=True)
            # each seed's solo run, one at a time (a gapstress state is
            # 2 GB), against its lane; the WAN storm's lanes are every one
            # held to JAX's pins, so two of its lanes run solo
            solo_lanes = ((0, len(seeds) - 1) if which == "wan-3x2"
                          else range(len(seeds)))
            walls = []
            for k in solo_lanes:
                seed = seeds[k]
                final, trace, solo_wall = _axis_solo_run(
                    cfg, topo, meta, seed, dev, telemetry)
                walls.append(solo_wall)
                if not _same_state(final, lane_state(finals, k)):
                    raise AssertionError(f"{run_label}: lane {k} differs "
                                         "from its solo run")
                if telemetry:
                    _lanes_equal_solo_traces(
                        type(traces)(*(x[k:k + 1] for x in traces)),
                        [(rounds[k], trace, solo_wall)], f"{run_label} "
                        f"lane {k}")
                del final, trace
            # with two solo lanes the sum is K times their mean
            solo_sum = sum(walls) * len(seeds) / len(walls)
            print(f"{run_label}: lanes {list(solo_lanes)}"
                  f"{' and their traces' if telemetry else ''} equal to their "
                  f"solo runs; ensemble wall {wall} s against the solo walls' "
                  f"sum {solo_sum} s ({walls}); max_memory_allocated {peak} "
                  f"bytes beyond the {held} held at entry", flush=True)
            tag = "recording_" if telemetry else ""
            entry.update({tag + "ensemble_wall_s": wall,
                          tag + "solo_walls_s": walls,
                          tag + "solo_lanes": list(solo_lanes),
                          tag + "solo_walls_sum_s": solo_sum,
                          tag + "max_memory_allocated_bytes": peak,
                          tag + "held_at_entry_bytes": held})
            _axis_goldens(which, label, lanes, rounds, art, goldens,
                          telemetry, traces, cfg)
            _trap(f"lane axis path {which}", "lanes that finish in different "
                  "rounds leave the batch as their solo runs end",
                  len(set(rounds)) > 1)
            del finals, metrics, traces
        numbers[label] = entry
        _lap(label)
    return launches, numbers


def _axis_goldens(which, label, lanes, rounds, art, goldens, telemetry,
                  traces, cfg):
    """Hold a path 63-66 run to its pins (`packed_axis_ensemble_paths`):
    ``lanes`` the records of its pinned lanes (None on a recording run,
    whose lanes the caller held to their solo recording runs)."""
    from corrosion_tpu_torch.sim.telemetry import (
        lane_trace, trace_host, trace_summary)

    keys = ("rounds", "p99_node_convergence_round", "digest")
    if which == "gapstress":
        golden = goldens.GAPSTRESS_25600_SEED1
        if lanes is not None and {k: lanes[0][k] for k in golden} != golden:
            raise AssertionError(f"{label}: lane 0 differs from "
                                 "GAPSTRESS_25600_SEED1")
        tel_golden = goldens.GAPSTRESS_25600_SEED1_TELEMETRY
        m = (3 * GAPSTRESS_N, 8192)
    elif which == "peerswap":
        want = goldens.STORM_PEERSWAP_25600_SEEDS8["lanes"]
        if [{k: x[k] for k in w} for x, w in zip(lanes, want)] != want:
            raise AssertionError(f"{label}: lanes differ from their one-seed "
                                 "JAX pins")
        return
    else:
        golden = {"wan-3x2": goldens.STORM_WAN_3X2_100K_SEEDS8,
                  "wan-fly-6r": None, "hetero-degree": None}[which]
        solo0 = {"wan-3x2": goldens.STORM_WAN_3X2_100K_SEED0,
                 "wan-fly-6r": goldens.STORM_WAN_FLY_6R_100K_SEED0,
                 "hetero-degree": goldens.STORM_HETERO_DEGREE_100K_SEED0}[
            which]
        if lanes is not None and {k: lanes[0][k] for k in solo0} != solo0:
            raise AssertionError(f"{label}: lane 0 differs from its solo "
                                 "golden")
        cell = art["cells"][0]
        if cell["round_path"] != "packed" or not cell["all_converged"]:
            raise AssertionError(f"{label}: round_path {cell['round_path']}, "
                                 f"all_converged {cell['all_converged']}")
        print(f"{label}: spec_hash={art['spec_hash']} result_digest="
              f"{art['result_digest']}", flush=True)
        if golden is None:
            return
        want = [{k: x[k] for k in ("seed", *keys)} for x in golden["lanes"]]
        # the cell's pins carry the engine's (lower) p99
        ps = art["cells"][0]["per_seed"]
        got = None if lanes is None else [
            dict({k: x[k] for k in ("seed", *keys)},
                 p99_node_convergence_round=ps["p99_node_convergence_round"][i])
            for i, x in enumerate(lanes)]
        if ((got is not None and got != want)
                or art["spec_hash"] != golden["spec_hash"]
                or art["result_digest"] != golden["result_digest"]):
            raise AssertionError(f"{label}: differs from its golden")
        tel_golden = goldens.STORM_WAN_3X2_100K_SEED0_TELEMETRY
        m = (300_000, 512)
    if telemetry:
        lane0 = lane_trace(traces, 0)
        result = {"telemetry": trace_summary(trace_host(lane0, rounds[0]),
                                             rounds[0], cfg),
                  "rounds": rounds[0], "trace": lane0}
        _telemetry_check(result, tel_golden, *m, f"{label}_telemetry lane 0")


def profile_axis_lanes(dev, which, lanes=ENSEMBLE_LANES, start=5, rounds=3):
    """``rounds`` rounds of path ``which``'s cell (gapstress or the WAN
    storm) from round ``start``: with ``lanes`` the packed lane round
    (`sim.lanes.packed_lane_step`, the one host read of the [K] flags a
    round), with ``lanes`` None the solo packed round of the path's first
    seed; the first ``start`` rounds are setup."""
    from corrosion_tpu_torch.campaign.ensemble import seed_states
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim.packed import (
        pack_state, packed_round_step, shrink_state)
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.topology import regions
    from corrosion_tpu_torch.sim.words import pack_bits

    cfg, topo, meta, seeds, _ = axis_path_case(which, dev)
    region = regions(cfg.n_nodes, topo.n_regions, dev)

    last_round = int(meta.round.max())  # the loops' one read a run

    def step(loop):
        if lanes is None:
            slim, carry, inj, metrics = loop
            slim, carry, inj, metrics, done = packed_round_step(
                slim, carry, inj, metrics, meta, cfg, topo, region,
                last_round=last_round)
            loop = (slim, carry, inj, metrics)
        else:
            loop, done = ln.packed_lane_step(loop, meta, cfg, topo, region,
                                             last_round=last_round)
        done.tolist()  # the loop's one host read a round
        return loop

    def setup():
        if lanes is None:
            state = new_sim(cfg, seeds[0], dev)
            loop = (shrink_state(state), pack_state(state, cfg),
                    pack_bits(state.injected), new_metrics(cfg, dev))
        else:
            loop = ln.packed_lane_batch(
                seed_states(cfg, seeds[:lanes], dev), cfg)
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = f"{which} x{lanes} lanes" if lanes else f"{which} solo"
    return _profile(run, rounds, f"packed {label} rounds {start}-"
                    f"{start + rounds - 1}", setup)


# -- the protocol variants on the packed round's lanes (phase 3lq, paths
# 67-68) ---------------------------------------------------------------------

SOLO_OF_LANE.update({
    "broadcast_pull_lanes": "broadcast_pull",
    "broadcast_pull_lossy_lanes": "broadcast_pull_lossy",
    "broadcast_pull_tiered_lanes": "broadcast_pull_tiered",
    "broadcast_pull_lossy_lanes_trace": "broadcast_pull_lossy",
    "broadcast_pull_tiered_lanes_trace": "broadcast_pull_tiered",
    "trace_wire_pull_lanes": "trace_wire_pull",
    "word_deliver_fifo_lanes": "word_deliver_fifo",
    "order_check_words_lanes": "order_check_words"})
#: the width of phase 3lq's odd check: 1001 nodes leave every new entry's
#: per-lane threads off its blocks, so each lane's last block is partial
ODD_N = 1001


def _proto_trap(number, what, reached):
    _trap(f"lane packed proto {number}", what, reached)


def _device_holdings(g, n, a, v, c, dev, full=0.6, some=0.15):
    """`_holdings` drawn on ``dev`` from a generator seeded by ``g`` (phase
    3lq holds K lanes of 100 000 rows)."""
    gen = torch.Generator(device=dev).manual_seed(int(g.integers(1 << 62)))
    whole = torch.rand((n, v, a, 1), generator=gen, device=dev) < full
    part = torch.rand((n, v, a, c), generator=gen, device=dev) < some
    return (whole | part).reshape(n, v * a * c).to(torch.uint8)


def _pull_words_case(dev, g, lanes, n, w=16, d=3, f=3):
    """K lanes of a push-pull round's response leg at (N, W, D, F): each
    lane's sending words, its edges (-1 and self targets among them, the
    first lane's first edge reversed into a one-way cut), slots in [0, D),
    the push's ok after one_way_plan's forward cut (K9 on the lanes
    folded), the ok_pull and the reverse thresholds (K9's session and wire
    queries on the swapped edges), the forward thresholds, per-lane k_drop
    and plan seeds.  Lane 1 repeats lane 0's inputs (only its k_drop and
    seed differ); the last lane has no edges."""
    from corrosion_tpu_torch.campaign.ensemble import lane_plan_seeds
    from corrosion_tpu_torch.proto import dissemination as dis
    from corrosion_tpu_torch.sim import faults

    cfg, _ = _storm_cfg(n, dev)
    fplan = faults.compile_plan(one_way_plan(n), cfg, device=dev)
    rf = faults.round_faults(fplan, 3)
    e = n * f
    c = SimpleNamespace(n=n, w=w, d=d, f=f, e=e, rf=rf)
    c.sending = _device_words(g, (lanes, n, w), dev, 2)
    tg = np.where(g.random((lanes, e)) < 0.03, -1,
                  g.integers(0, n, (lanes, e)))
    c.src = torch.arange(n, dtype=torch.int32,
                         device=dev).repeat_interleave(f)[None]
    raw = torch.as_tensor(tg, dtype=torch.int32, device=dev)
    ok = (raw >= 0) & (raw != c.src)
    c.dst = torch.clamp(raw, min=0).contiguous()
    c.slot = torch.as_tensor(g.integers(0, d, (lanes, e)), dtype=torch.int32,
                             device=dev)
    for x in (c.sending, c.dst, ok, c.slot):
        x[1] = x[0]
    ok[-1] = False
    ok = ok.contiguous()
    _, thr, _, _ = faults.fault_wire_effects(
        rf, c.src.expand(lanes, -1).reshape(-1), c.dst.reshape(-1),
        ok.view(-1))
    c.ok, c.thr = ok, thr.view(lanes, e)
    c.ok_pull = dis.pull_session_ok_lanes(ok, rf, c.src, c.dst).contiguous()
    c.thr_rev = dis.reverse_loss_lanes(rf, c.src, c.dst)
    c.ring0 = _device_words(g, (lanes, d, n, w), dev, 6)
    c.k_drop = _lane_keys(dev, lanes, 7200)
    c.seeds = lane_plan_seeds(range(lanes), dev)
    return c


def _pull_response_bytes(dst, ok_pull, w) -> int:
    """The least bytes a pull over K lanes reads: every edge's ok_pull,
    the responder id of each answered edge, and each lane's responder rows
    of ``w`` words once.  Refused edges read nothing more, and the lane
    without edges only its flags."""
    total = ok_pull.numel()
    for k in range(ok_pull.shape[0]):
        answered = dst[k][ok_pull[k]]
        total += (answered.numel() * 4
                  + int(torch.unique(answered).numel()) * w * 4)
    return int(total)


def _pull_cases(wan, pin):
    """K10p's lane cases: (label, fault stream, topo_thr, tiers, recording,
    row name or None for a check).  The rows run as their paths run them:
    no stream (storm-push-pull), the fault stream alone (fault-storm-push-
    pull, with and without the recorder), wan-3x2's tiers alone (storm-wan-
    3x2-push-pull, with and without it)."""
    return (
        ("plain", False, 0, None, False, "broadcast_pull_lanes"),
        ("lossy", True, 0, None, False, "broadcast_pull_lossy_lanes"),
        ("lossy recording", True, 0, None, True,
         "broadcast_pull_lossy_lanes_trace"),
        ("tiered", False, 0, wan, False, "broadcast_pull_tiered_lanes"),
        ("tiered recording", False, 0, wan, True,
         "broadcast_pull_tiered_lanes_trace"),
        ("flat fault recording", True, 26, None, True, None),
        ("severed recording", False, 256, None, True, None),
        ("tiered fault recording", True, 0, wan, True, None),
        ("pin recording", False, 0, pin, True, None),
    )


def _run_pull(kernel, c, ring, fault, tt, tiers, dropped):
    from corrosion_tpu_torch.sim import lanes as ln

    fn = ln.scatter_pull_lanes if kernel else ln.scatter_pull_lanes_plain
    fn(ring, c.sending, c.dst, c.slot, c.ok_pull,
       c.thr_rev if fault else None, c.k_drop, c.seeds, c.f, tt, dropped,
       tiers)


def compare_packed_lane_pull(dev, g, lanes, n=STORM_N, timed=True,
                             rows_out=True, w=16):
    """K10p's lane entry at the 100k push-pull storms' wire (K lanes of E
    = 300 000 edges, W = 16, D = 3): its three streams and their recording
    forms, and as checks the flat stream with the fault stream, a severed
    flat channel (topo_thr 256), the tiers with the fault stream and a tier
    at certainty; each against its plain version, lanes 0 and K - 1
    against the solo K10p on their inputs.  Returns the rows (none with
    ``rows_out`` False: a check at another width; ``w`` below 16 only in
    a CPU rehearsal)."""
    from corrosion_tpu_torch.device import popcount
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim import topology as tp

    c = _pull_words_case(dev, g, lanes, n, w)
    # four regions: the one-way cut refuses every pull across the halves,
    # so only the cross-region edges inside a half reach the pin
    wan, pin = _topo("wan-3x2"), dataclasses.replace(_pin_topo(),
                                                     n_regions=4)
    outs, rows = {}, []
    for label, fault, tt, tiers, rec, name in _pull_cases(wan, pin):
        got, want = c.ring0.clone(), c.ring0.clone()
        dk = torch.zeros((lanes, 12), dtype=torch.int64, device=dev)
        dp = torch.zeros_like(dk)
        _run_pull(True, c, got, fault, tt, tiers, dk[:, 2] if rec else None)
        _run_pull(False, c, want, fault, tt, tiers,
                  dp[:, 2] if rec else None)
        equal, err = _equal_all([got, dk], [want, dp])
        if not equal:
            raise AssertionError(f"K10p's lanes, {label} at {n} nodes: "
                                 "kernel != plain version")
        for k in (0, lanes - 1):
            solo, sd = c.ring0[k].clone(), _acc(dev)
            packed.scatter_pull(
                solo, c.sending[k], c.dst[k], c.slot[k], c.ok_pull[k],
                c.thr_rev[k] if fault else None, c.k_drop[k],
                int(c.seeds[k]), c.f, tt, sd if rec else None, tiers)
            _solo_trap(f"{label} lane {k} at {n}", [got[k], dk[k, 2]],
                       [solo, sd if rec else dk[k, 2]])
        outs[label] = (want, dp[:, 2].clone())
        del got
        if name is None or not rows_out:
            continue
        # the bound: eight hashes a sending (edge, word) on an ok_pull edge
        # whose stream draws (the fault stream under thr_rev; a reverse
        # tier between 1 and 255)
        hashes = 0
        region = tp.regions(n, wan.n_regions, dev)
        for k in range(lanes):
            live = c.ok_pull[k][:, None] & (c.sending[k][c.dst[k].long()] != 0)
            if tiers is not None:
                hashes += _hash_ops(live, tp.edge_loss_thresholds_raw(
                    tiers, region, c.dst[k], c.src[0]))
            if fault:
                hashes += _hash_ops(live, c.thr_rev[k].to(torch.int32))
            del live
        # the bytes: what the pull reads (`_pull_response_bytes`), the slot and
        # under the fault stream the reverse threshold of each answered
        # edge, and the ring rows it touches read and written
        rows_touched = int(torch.unique(
            (torch.arange(lanes, device=dev)[:, None] * (c.d * c.n)
             + c.slot.long() * c.n + c.src.long())[c.ok_pull]).numel())
        answered = int(c.ok_pull.sum())
        nbytes = (_pull_response_bytes(c.dst, c.ok_pull, c.w)
                  + answered * (4 + (1 if fault else 0))
                  + 2 * rows_touched * c.w * 4 + (lanes * 8 if rec else 0))
        work_k, work_p = c.ring0.clone(), c.ring0.clone()
        acc_k, acc_p = (torch.zeros((lanes, 12), dtype=torch.int64,
                                    device=dev) for _ in range(2))

        def restore(work, acc, c=c):
            work.copy_(c.ring0)
            acc.zero_()

        rows.append(_ops_row(
            name, _CSRC + "broadcast_scatter.cu",
            "corrosion_tpu/proto/dissemination.py:58" + _VMAP, equal, err,
            _timed(timed, lambda fault=fault, tt=tt, tiers=tiers, rec=rec:
                   _run_pull(True, c, work_k, fault, tt, tiers,
                             acc_k[:, 2] if rec else None),
                   lambda: restore(work_k, acc_k)),
            # the plain versions draw their bits on the host's schedule and
            # take seconds a call under a stream: one eager call
            _time_eager_ms(lambda fault=fault, tt=tt, tiers=tiers, rec=rec: (
                restore(work_p, acc_p), _run_pull(
                    False, c, work_p, fault, tt, tiers,
                    acc_p[:, 2] if rec else None)),
                1, warmup=0) if timed else None,
            nbytes, hashes * OPS_PER_HASH, lanes=lanes, hashes=hashes,
            kernel=name))
        del work_k, work_p
    ok_fwd = c.ok
    _proto_trap(1, "lanes whose k_drop and plan seeds differ pull their own "
                "payloads through every drawing case (lanes 0 and 1 share "
                "every other input)",
                all(not torch.equal(want[0], want[1])
                    for label, (want, _) in outs.items()
                    if label not in ("plain", "severed recording",
                                     "pin recording")))
    sent = packed._edge_words(c.sending[0][c.dst[0].long()], c.ok_pull[0], 1)
    severed = (tp.edge_loss_thresholds_raw(
        pin, tp.regions(n, pin.n_regions, dev), c.dst[0], c.src[0]) >= 256)
    _proto_trap(2, "a reverse tier at certainty (threshold 256) drops every "
                "pulled payload of its edges without a draw",
                bool((severed & c.ok_pull[0]).any()) and int(
                    outs["pin recording"][1][0]) == int(
                        popcount(sent[severed]).sum()))
    _proto_trap(3, "a flat topo_thr of 256 or more severs every pull: the "
                "rings stay as they were and every answered frame counts as "
                "dropped",
                torch.equal(outs["severed recording"][0], c.ring0)
                and int(outs["severed recording"][1][0]) == int(
                    popcount(sent).sum()) > 0)
    _proto_trap(4, "a reverse edge whose fault loss is live where the "
                "forward edge's is not",
                bool(((c.thr_rev > 0) & (c.thr == 0) & c.ok_pull).any()))
    _proto_trap(5, "an ok_pull false where the push's ok is true (the "
                "one-way cut refuses the response only)",
                bool((ok_fwd & ~c.ok_pull).any()))
    _proto_trap(6, "the lane without edges writes nothing and counts no "
                "drop; the other lanes' drops differ",
                all(torch.equal(want[-1], c.ring0[-1])
                    for want, _ in outs.values())
                and int(outs["lossy recording"][1][-1]) == 0
                and len({int(x) for x in outs["lossy recording"][1][:-1]})
                > 1)
    del c, outs
    return rows


def compare_packed_lane_wire_pull(dev, g, lanes, n=STORM_N, timed=True,
                                  rows_out=True, w=16):
    """K18's words-pull lane entry at the 100k push-pull storms' shapes (K
    lanes of E = 300 000 ok_pull edges over N rows of W = 16 words, the
    storm's 8 KiB sizes): each lane's answered pulls into its own frames
    and bytes slots of a lane trace's [K, 12] accumulators, lanes 0 and K
    - 1 held to the solo entry."""
    from corrosion_tpu_torch.sim import telemetry as tel

    c = _pull_words_case(dev, g, lanes, n, w)
    # lane 1 answers half of lane 0's pulls: its totals differ
    c.ok_pull[1, ::2] = False
    _, meta = _storm_cfg(n, dev)
    nbytes = meta.nbytes[:w * 32].contiguous()
    acc0 = torch.as_tensor(g.integers(0, 1 << 40, (lanes, len(tel.ACC))),
                           dtype=torch.int64, device=dev)
    w = tel.ACC.index("bcast_frames")
    got, want = acc0.clone(), acc0.clone()
    tel.wire_words_pull_lanes_(got[:, w:w + 2], c.sending, nbytes, c.ok_pull,
                               c.dst)
    tel.wire_words_pull_lanes_plain(want[:, w:w + 2], c.sending, nbytes,
                                    c.ok_pull, c.dst)
    equal, err = _equal_all([got], [want])
    if not equal:
        raise AssertionError(f"K18's words-pull lanes at {n} nodes: kernel "
                             "!= plain version")
    for k in (0, lanes - 1):
        x = acc0[k, w:w + 2].clone()
        tel.wire_words_pull_(x, c.sending[k], nbytes, c.ok_pull[k], c.dst[k])
        _solo_trap(f"trace_wire_pull_lanes lane {k} at {n}",
                   [got[k, w:w + 2]], [x])
    added = (want - acc0)[:, w:w + 2]
    rest = [i for i in range(len(tel.ACC)) if i not in (w, w + 1)]
    _proto_trap(7, "each lane's answered pulls in its own frames and bytes "
                "slots (exact int64 sums), lanes differing, the lane without "
                "edges adding nothing, the other slots untouched",
                int(added[-1].abs().sum()) == 0
                and int(added[:-1, 1].min()) > 0
                and len({int(x) for x in added[:-1, 0]}) > 1
                and torch.equal(want[:, rest], acc0[:, rest]))
    if not rows_out:
        return []
    work = acc0.clone()
    return [_lane_row(
        "trace_wire_pull_lanes", _TRACE_SRC + "trace_wire.cu",
        "corrosion_tpu/sim/packed.py:584", equal, err,
        _timed(timed, lambda: tel.wire_words_pull_lanes_(
            work[:, w:w + 2], c.sending, nbytes, c.ok_pull, c.dst),
            lambda: work.copy_(acc0)),
        _timed(timed, lambda: tel.wire_words_pull_lanes_plain(
            work[:, w:w + 2], c.sending, nbytes, c.ok_pull, c.dst),
            lambda: work.copy_(acc0)),
        _pull_response_bytes(c.dst, c.ok_pull, c.w) + _nbytes(nbytes)
        + lanes * 16, lanes)]


def _fifo_lane_carry(dev, g, lanes, cfg):
    """K lanes of a lab-ordered storm's carry at ``cfg``'s shapes: each
    lane's holdings with gaps (`_holdings`), relay planes inside them, and
    one set of ring and sync-ring words in every lane, so the gate admits
    in one lane what it drops in another."""
    from corrosion_tpu_torch.sim import packed
    from corrosion_tpu_torch.sim.words import pack_bits

    n = cfg.n_nodes
    a, v, c = cfg.n_writers, cfg.n_versions, cfg.chunks_per_version
    d, w = cfg.n_delay_slots, cfg.n_payloads // 32
    have = _stack(pack_bits(_device_holdings(g, n, a, v, c, dev))
                  for _ in range(lanes))
    relay = [_device_words(g, (lanes, n, w), dev, 2) & have
             for _ in range(4)]
    inflight = _device_words(g, (d, n, w), dev, 3)[None].expand(
        lanes, d, n, w).contiguous()
    sync_buf = _device_words(g, (d, n, w), dev, 4)[None].expand(
        lanes, d, n, w).contiguous()
    return packed.PackedCarry(have=have, inflight=inflight,
                              relay=packed.Planes(*relay), sync_buf=sync_buf)


def _clone_carry(cr):
    from corrosion_tpu_torch.sim import packed

    return packed.PackedCarry(cr.have.clone(), cr.inflight.clone(),
                              packed.Planes(*(x.clone() for x in cr.relay)),
                              cr.sync_buf.clone())


def _carry_tensors(cr):
    return [cr.have, cr.inflight, *cr.relay, cr.sync_buf]


def compare_packed_lane_fifo(dev, g, lanes, n=STORM_N, timed=True,
                             rows_out=True):
    """K8f's lane entry at the lab-ordered storm's shapes (K lanes of N =
    100 000, W = 16, A = 16, C = 4, D = 2): both rings behind each lane's
    admit gate of its own pre-merge have, one set of arrivals in every
    lane; lanes 0 and K - 1 held to the solo K8f on their carry."""
    from corrosion_tpu_torch.proto.ordering import admit_words
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim import packed

    cfg, _ = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, ordering="fifo")
    t = 9
    carry0 = _fifo_lane_carry(dev, g, lanes, cfg)
    got, want = _clone_carry(carry0), _clone_carry(carry0)
    ln.deliver_lanes(got, t, cfg)
    ln.deliver_lanes_plain(want, t, cfg)
    equal, err = _equal_all(_carry_tensors(got), _carry_tensors(want))
    if not equal:
        raise AssertionError(f"K8f's lanes at {n} nodes: kernel != plain "
                             "version")
    for k in (0, lanes - 1):
        solo = packed.PackedCarry(*(
            x[k].clone() if not isinstance(x, tuple)
            else packed.Planes(*(p[k].clone() for p in x)) for x in carry0))
        packed.deliver_packed(solo, t, cfg)
        _solo_trap(f"word_deliver_fifo_lanes lane {k} at {n}",
                   [x[k] for x in _carry_tensors(got)], _carry_tensors(solo))
    slot = t % cfg.n_delay_slots
    arriving = carry0.inflight[:, slot] | carry0.sync_buf[:, slot]
    dropped = torch.stack([arriving[k] & ~admit_words(carry0.have[k], cfg)
                           for k in range(lanes)])
    _proto_trap(8, "a FIFO gate that drops a slot's words in one lane and "
                "admits them in another (the same arrivals in every lane)",
                bool(((dropped != 0).any(dim=0)
                      & ((dropped == 0) & (arriving != 0)).any(dim=0)).any()))
    del dropped
    if not rows_out:
        return []
    kw_, pw_ = _clone_carry(carry0), _clone_carry(carry0)

    def restore(dst_):
        for x, y in zip(_carry_tensors(dst_), _carry_tensors(carry0)):
            x.copy_(y)

    w = cfg.n_payloads // 32
    return [_lane_row(
        "word_deliver_fifo_lanes", _CSRC + "word_phases.cu",
        "corrosion_tpu/proto/ordering.py:65", equal, err,
        _timed(timed, lambda: ln.deliver_lanes(kw_, t, cfg),
               lambda: restore(kw_)),
        _timed(timed, lambda: ln.deliver_lanes_plain(pw_, t, cfg),
               lambda: restore(pw_)),
        # both slots and have read; have, the planes and both slots
        # written where they change
        lanes * n * w * 4 * 3 + _changed_bytes(
            _carry_tensors(want), _carry_tensors(carry0)), lanes)]


def compare_packed_lane_order_words(dev, g, lanes, n=STORM_N, timed=True,
                                    rows_out=True):
    """K22's words lane entry at the lab-ordered-broken storm's shapes (K
    lanes of N = 100 000, W = 16, A = 16, V = 8, C = 4): each lane's
    holdings with gaps added to its own nonzero count; lane 0 holds
    gapless prefixes of versions (a count of 0), so the counts differ by
    lane; lanes 0 and K - 1 held to the solo entry."""
    from corrosion_tpu_torch.sim import invariants as inv
    from corrosion_tpu_torch.sim.words import pack_bits

    cfg, meta = _storm_cfg(n, dev)
    cfg = dataclasses.replace(cfg, ordering="fifo-unchecked")
    a, v, c = cfg.n_writers, cfg.n_versions, cfg.chunks_per_version
    have = _stack(pack_bits(_device_holdings(g, n, a, v, c, dev, 0.5,
                                                   0.2))
                  for _ in range(lanes))
    heads = torch.as_tensor(g.integers(0, v + 1, (n, 1, a, 1)), device=dev)
    vv = torch.arange(v, device=dev)[None, :, None, None]
    have[0] = pack_bits((vv < heads).expand(n, v, a, c).reshape(
        n, v * a * c).to(torch.uint8))
    acc0 = torch.arange(7, 7 + lanes, dtype=torch.int32, device=dev)
    got, want = acc0.clone(), acc0.clone()
    inv.count_order_violations_lanes_(got, have, meta, cfg)
    inv.count_order_violations_lanes_plain(want, have, meta, cfg)
    equal, err = _equal_all([got], [want])
    if not equal:
        raise AssertionError(f"K22's words lanes at {n} nodes: kernel != "
                             "plain version")
    for k in (0, lanes - 1):
        x = acc0[k].clone()
        inv.count_order_violations_(x, have[k], meta, cfg)
        _solo_trap(f"order_check_words_lanes lane {k} at {n}", [got[k]], [x])
    counts = (want - acc0).tolist()
    _proto_trap(9, "order counts that differ by lane", len(set(counts)) > 2)
    _proto_trap(10, "a lane whose count is 0 (gapless prefixes)",
                counts[0] == 0 and min(counts[1:]) > 0)
    if not rows_out:
        return []
    work = acc0.clone()
    return [_lane_row(
        "order_check_words_lanes", _CSRC + "order_check.cu",
        "corrosion_tpu/sim/invariants.py:51", equal, err,
        _timed(timed, lambda: inv.count_order_violations_lanes_(
            work, have, meta, cfg), lambda: work.copy_(acc0)),
        _timed(timed, lambda: inv.count_order_violations_lanes_plain(
            work, have, meta, cfg), lambda: work.copy_(acc0)),
        _nbytes(have) + a * 4 + lanes * 8, lanes)]


def compare_packed_lane_protocol_kernels(dev, seed=18, lanes=ENSEMBLE_LANES,
                                         timed=True, big=True):
    """Phase 3lq: K10p's lane entry (its three streams and their recording
    forms), K18's words-pull, K8f's and K22's words lane entries against
    their plain versions at K = 8 on paths 67-68's shapes (100 000 x 512,
    F = 3), lanes 0 and K - 1 held to the solo entries, every trap reached;
    then each again as a check at ODD_N nodes, where every lane's grid
    row ends in a partial block.  ``big``
    False shrinks 100 000 and ODD_N nodes to 301 and 203, and the
    pulls' words to 4 a row (a CPU rehearsal)."""
    g = np.random.default_rng(seed)
    # the rehearsal's pulls carry 4 words (128 payloads) a row
    n, odd, w = (STORM_N, ODD_N, 16) if big else (301, 203, 4)
    rows = compare_packed_lane_pull(dev, g, lanes, n, timed, w=w)
    rows += compare_packed_lane_wire_pull(dev, g, lanes, n, timed, w=w)
    rows += compare_packed_lane_fifo(dev, g, lanes, n, timed)
    rows += compare_packed_lane_order_words(dev, g, lanes, n, timed)
    compare_packed_lane_pull(dev, g, lanes, odd, False, False, w)
    compare_packed_lane_wire_pull(dev, g, lanes, odd, False, False, w)
    compare_packed_lane_fifo(dev, g, lanes, odd, False, False)
    compare_packed_lane_order_words(dev, g, lanes, odd, False, False)
    # each lane entry's threads a lane at ODD_N and its threads a block, as
    # its launcher sets them: every lane is a grid row of its own
    # (blockIdx.y), so no block spans two lanes; what the odd check holds is
    # each lane's partial last block
    geometry = {"K10p": (odd * 3 * w, 256), "K18wp": (odd * 3 * 32, 256),
                "K8f": (odd * 32, 256), "K22w": (odd * 16, 256)}
    _proto_trap(11, f"a partial last block in every lane at {odd} nodes ("
                + ", ".join(f"{k} {t} threads a lane in blocks of {b}"
                            for k, (t, b) in geometry.items())
                + "), held to the plain versions above",
                all(t % b != 0 for t, b in geometry.values()))
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    return rows


#: paths 67-68: (label, which, the lane rows the run launches, those of
#: its recording run or None, the K8 lane entries it launches by name);
#: every run also launches `PROTO_PACKED_CORE`
PROTO_PACKED_CORE = ("threefry_lanes", "sample_targets_lanes",
                     "merge_entries_lanes", "gaps_refresh_lanes",
                     "converge_fold_lanes")
_WORDS = ("word_phases_lanes",)
PACKED_PROTO_PATHS = (
    ("storm_push_pull_100k_seeds8", "push-pull",
     (*_WORDS, "broadcast_scatter_lanes", "sync_pull_lanes",
      "broadcast_pull_lanes"), None, ()),
    ("storm_wan_3x2_push_pull_100k_seeds8", "wan-push-pull",
     (*_WORDS, *_TIERED, "broadcast_scatter_tiered_lanes", "sync_pull_lanes",
      "broadcast_pull_tiered_lanes"),
     (*_WORDS, *_TIERED, "broadcast_scatter_tiered_lanes_trace",
      "sync_pull_lanes_trace", "broadcast_pull_tiered_lanes_trace",
      "trace_wire_pull_lanes", *_PACKED_RECORDING), ()),
    ("fault_storm_push_pull_100k_seeds8", "fault-push-pull",
     (*_WORDS, "broadcast_scatter_lossy_lanes", "fault_reach_lanes",
      "node_faults_lanes", "sync_pull_lanes", "broadcast_pull_lossy_lanes",
      "broadcast_pull_lanes"),
     (*_WORDS, "broadcast_scatter_lossy_lanes_trace", "fault_reach_lanes",
      "node_faults_lanes", "sync_pull_lanes_trace",
      "broadcast_pull_lossy_lanes_trace", "broadcast_pull_lanes",
      "trace_wire_pull_lanes", "fault_edges_lanes_count",
      *_PACKED_RECORDING), ()),
    # K8's deliver lane entry gives way to K8f's under FIFO
    ("storm_lab_ordered_100k_seeds8", "lab-ordered",
     ("broadcast_scatter_lanes", "sync_pull_lanes", "word_deliver_fifo_lanes",
      "order_check_words_lanes"), None,
     ("word_inject_lanes", "word_spend_lanes")),
    ("storm_lab_ordered_broken_100k_seeds8", "lab-ordered-broken",
     (*_WORDS, "broadcast_scatter_lanes", "sync_pull_lanes",
      "order_check_words_lanes"), None, ()),
    ("storm_swarm_aggressive_100k_seeds8", "swarm-aggressive",
     (*_WORDS, "broadcast_scatter_lanes", "sync_pull_lanes"), None, ()),
    ("storm_fanout_decay_100k_seeds8", "fanout-decay",
     (*_WORDS, "broadcast_scatter_lanes", "sync_pull_lanes",
      "degree_caps_sched_lanes"), None, ()),
)
#: the protocol rows a path launches only where its knob is on
_PROTO_LANE_ROWS = {"broadcast_pull_lanes", "broadcast_pull_lossy_lanes",
                    "broadcast_pull_tiered_lanes",
                    "broadcast_pull_lossy_lanes_trace",
                    "broadcast_pull_tiered_lanes_trace",
                    "trace_wire_pull_lanes", "word_deliver_fifo_lanes",
                    "order_check_words_lanes", "degree_caps_sched_lanes"}


def packed_proto_spec(which, seeds=range(ENSEMBLE_LANES)):
    """The campaign cell of path ``which`` (`campaign.spec.
    storm_proto_seeds_spec`): the 100k storm on the packed round under a
    protocol family, over wan-3x2 or under the fault storm's plan for the
    push-pull variants."""
    from corrosion_tpu_torch.campaign import spec as sp

    seeds = tuple(seeds)
    if which == "wan-push-pull":
        return sp.storm_proto_seeds_spec("push-pull", seeds,
                                         topo_family="wan-3x2")
    if which == "fault-push-pull":
        return sp.storm_proto_seeds_spec("push-pull", seeds, faults=True)
    return sp.storm_proto_seeds_spec(which, seeds)


#: each path's golden of its eight lanes and its lane 0's solo golden
_PROTO_GOLDENS = {
    "push-pull": ("STORM_PUSH_PULL_100K_SEEDS8",
                  "STORM_PUSH_PULL_100K_SEED0"),
    "wan-push-pull": ("STORM_WAN_3X2_PUSH_PULL_100K_SEEDS8",
                      "STORM_WAN_3X2_PUSH_PULL_100K_SEED0"),
    "fault-push-pull": ("FAULT_STORM_PUSH_PULL_100K_SEEDS8",
                        "FAULT_STORM_PUSH_PULL_100K_SEED0"),
    "lab-ordered": ("STORM_LAB_ORDERED_100K_SEEDS8",
                    "STORM_LAB_ORDERED_100K_SEED0"),
    "lab-ordered-broken": ("STORM_LAB_ORDERED_BROKEN_100K_SEEDS8",
                           "STORM_LAB_ORDERED_BROKEN_100K_SEED0"),
    "swarm-aggressive": ("STORM_SWARM_AGGRESSIVE_100K_SEEDS8",
                         "STORM_SWARM_AGGRESSIVE_100K_SEED0"),
    "fanout-decay": ("STORM_FANOUT_DECAY_100K_SEEDS8",
                     "STORM_FANOUT_DECAY_100K_SEED0"),
}


def _proto_solo_run(spec, cfg, topo, meta, seed, dev, telemetry):
    """The port's solo run of one seed of a path's cell on the card (the
    packed round; under the spec's plan re-seeded by the seed, as the
    engine's lane): its final state, metrics, trace (None without
    ``telemetry``) and host wall."""
    from corrosion_tpu_torch.sim.faults import compile_plan, run_fault_plan
    from corrosion_tpu_torch.sim.round import new_sim, run_to_convergence

    state = new_sim(cfg, int(seed), dev)
    fplan = None
    if spec.events:
        fplan = compile_plan(spec.fault_plan({}, seed=int(seed)), cfg, topo,
                             device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if fplan is None:
        res = run_to_convergence(state, meta, cfg, topo, spec.max_rounds,
                                 telemetry)
    else:
        res = run_fault_plan(state, meta, cfg, topo, fplan, spec.max_rounds,
                             telemetry)
    torch.cuda.synchronize()
    return (res[0], res[1], res[2] if telemetry else None,
            time.monotonic() - t0)


def _proto_goldens(which, label, art, finals, metrics, meta, goldens):
    """Hold a path 67-68 cell to its pins: the spec_hash, the packed
    cell's result_digest and every lane's record (rounds, the engine's
    p99, convergence, state digest, order count) against the eight
    one-seed live-JAX lanes, and lane 0 against its solo golden."""
    from concurrent.futures import ThreadPoolExecutor

    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim.round import RunMetrics
    from corrosion_tpu_torch.sim.runner import _node_convergence, _percentile

    cell = art["cells"][0]
    ps = cell["per_seed"]
    golden_name, solo_name = _PROTO_GOLDENS[which]
    golden, solo = getattr(goldens, golden_name), getattr(goldens, solo_name)
    # a lane's state is ~700 MB on the host: hash the lanes side by side
    # (blake2b and the copies leave the GIL)
    with ThreadPoolExecutor(max_workers=len(cell["seeds"])) as pool:
        digests = list(pool.map(lambda i: state_digest(lane_state(finals, i)),
                                range(len(cell["seeds"]))))
    lanes = []
    for i, seed in enumerate(cell["seeds"]):
        rec = {"seed": seed, "rounds": ps["rounds"][i],
               "p99_node_convergence_round":
                   ps["p99_node_convergence_round"][i],
               "converged": ps["converged"][i],
               "unconverged_nodes": ps["unconverged_nodes"][i],
               "digest": digests[i]}
        if "order_violations" in ps:
            rec["order_violations"] = ps["order_violations"][i]
        lanes.append(rec)
    # lane 0 in the solo golden's terms (the runner's p99s)
    final0, m0 = lane_state(finals, 0), RunMetrics(*(x[0] for x in metrics))
    cov = m0.coverage_at.cpu().numpy()
    lat = np.where(cov >= 0, cov - meta.round.cpu().numpy(), -1)
    rec0 = {"rounds": int(final0.t),
            "p99_node_convergence_round": _node_convergence(
                m0, final0)["p99_node_convergence_round"],
            "p99_payload_latency_rounds": _percentile(lat, 99),
            "digest": digests[0],
            "order_violations": int(m0.order_violations)}
    got = {"spec_hash": art["spec_hash"],
           "result_digest": art["result_digest"], "lanes": lanes}
    print(f"{label}: {json.dumps(got)} lane 0 {json.dumps(rec0)} "
          f"round_path {cell['round_path']}", flush=True)
    if cell["round_path"] != "packed" or got != {
            k: golden[k] for k in got}:
        raise AssertionError(f"{label}: differs from {golden_name}")
    if {k: rec0[k] for k in solo} != solo:
        raise AssertionError(f"{label}: lane 0 differs from {solo_name}")
    if which == "lab-ordered" and any(ps["order_violations"]):
        raise AssertionError(f"{label}: a FIFO lane counts violations")


def packed_proto_ensemble_paths(dev, goldens):
    """Paths 67-68: the protocol variants on the packed round's lanes
    through `campaign.engine.run_campaign`, each from zeroed counters,
    every lane entry of the path launched and no solo entry of a kernel
    that has one, no protocol row of a knob the cell leaves off.  Path
    67: the 100k push-pull storm (seeds 0-7; its lanes the dense
    push-pull lanes' pins, the dense == packed contract), over wan-3x2
    and under the fault storm's plan, the last two with and without the
    recorder (lane 0's trace JAX's solo telemetry golden over wan-3x2).
    Path 68: the lab-ordered, lab-ordered-broken, swarm-aggressive and
    fanout-decay storms.  Every cell against its golden (spec_hash, the
    packed cell's result_digest, every lane one-seed live JAX's, lane 0
    its solo golden); lanes 0 and K - 1 equal to their solo runs on this
    card, state, metrics and trace (the solo runs one at a time, after
    the ensemble), a recording run's finals equal to the run's without
    the recorder.  Each wall beside the solo walls' sum (K times the mean
    of the two).  Returns the launches per run and the printed numbers."""
    import gc

    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.sim.round import RunMetrics
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.telemetry import (
        lane_trace, trace_host, trace_summary)

    gc.collect()
    launches, numbers = {}, {}
    for label, which, rows, rec_rows, entries in PACKED_PROTO_PATHS:
        spec = packed_proto_spec(which)
        cfg, topo = spec.sim_config({}), spec.topo({})
        meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every({}))
        k_last = len(spec.seeds) - 1
        entry, plain_finals = {}, None
        for telemetry in ((False, True) if rec_rows is not None
                          else (False,)):
            run_label = label + ("_telemetry" if telemetry else "")
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            kept = {}
            t_run = time.monotonic()
            art = run_campaign(spec, telemetry=telemetry, device=dev,
                               lanes_out=kept)
            t_run = time.monotonic() - t_run
            peak = torch.cuda.max_memory_allocated() - held
            path_rows = PROTO_PACKED_CORE + (rec_rows if telemetry else rows)
            counts = _path_launches(kernels, path_rows, run_label,
                                    telemetry=telemetry, entries=entries)
            solo_on = [r for r in SOLO_OF_LANE.values() if counts[r]]
            off = [r for r in _PROTO_LANE_ROWS - set(path_rows) if counts[r]]
            if solo_on or off:
                raise AssertionError(f"{run_label}: solo entries {solo_on}, "
                                     f"protocol rows {off} off the path")
            if which == "lab-ordered" and kernels.WORD_DELIVER_LANES.launches:
                raise AssertionError(f"{run_label}: K8's deliver lane entry "
                                     "ran under FIFO")
            launches[run_label] = counts
            finals, metrics = kept[0]["finals"], kept[0]["metrics"]
            traces = kept[0].get("traces")
            wall = art["cells"][0]["wall_clock_s"]
            rounds = [int(x) for x in finals.t]
            t_check = time.monotonic()
            if telemetry:
                # the recorder changes no state
                if not all(torch.equal(a, b) for a, b in zip(finals,
                                                             plain_finals)):
                    raise AssertionError(f"{run_label}: the recording run's "
                                         "finals differ from the plain run's")
                if which == "wan-push-pull":
                    lane0 = lane_trace(traces, 0)
                    _telemetry_check(
                        {"telemetry": trace_summary(
                            trace_host(lane0, rounds[0]), rounds[0], cfg),
                         "rounds": rounds[0], "trace": lane0},
                        goldens.STORM_WAN_3X2_PUSH_PULL_100K_SEED0_TELEMETRY,
                        300_000, 512, f"{run_label} lane 0")
            else:
                _proto_goldens(which, run_label, art, finals, metrics, meta,
                               goldens)
                plain_finals = finals
            t_check = time.monotonic() - t_check
            t_solo = time.monotonic()
            walls = []
            for k in (0, k_last):
                final, m, trace, solo_wall = _proto_solo_run(
                    spec, cfg, topo, meta, spec.seeds[k], dev, telemetry)
                walls.append(solo_wall)
                lane_m = RunMetrics(*(x[k] for x in metrics))
                if not (_same_state(final, lane_state(finals, k)) and all(
                        torch.equal(a, b) for a, b in zip(m, lane_m))):
                    raise AssertionError(f"{run_label}: lane {k} differs "
                                         "from its solo run")
                if telemetry:
                    _lanes_equal_solo_traces(
                        type(traces)(*(x[k:k + 1] for x in traces)),
                        [(rounds[k], trace, solo_wall)],
                        f"{run_label} lane {k}")
                del final, m, trace
            solo_sum = sum(walls) * len(spec.seeds) / len(walls)
            t_solo = time.monotonic() - t_solo
            print(f"{run_label}: rounds={rounds}; lanes 0 and {k_last}"
                  f"{' and their traces' if telemetry else ''} equal to their "
                  f"solo runs; ensemble wall {wall} s against the solo walls' "
                  f"sum {solo_sum} s (K x the mean of {walls}); "
                  f"max_memory_allocated {peak} bytes beyond the {held} held "
                  f"at entry; host seconds: the campaign call {t_run:.1f}, "
                  f"the pin checks {t_check:.1f}, the solo runs "
                  f"{t_solo:.1f}", flush=True)
            tag = "recording_" if telemetry else ""
            entry.update({tag + "ensemble_wall_s": wall,
                          tag + "solo_walls_s": walls,
                          tag + "solo_walls_sum_s": solo_sum,
                          tag + "max_memory_allocated_bytes": peak,
                          tag + "held_at_entry_bytes": held,
                          tag + "rounds": rounds})
            del kept, metrics, traces, art
        del finals, plain_finals
        numbers[label] = entry
        _lap(label)
    return launches, numbers


def profile_proto_lanes(dev, which, lanes=ENSEMBLE_LANES, start=5, rounds=3):
    """``rounds`` rounds of path ``which``'s cell (the push-pull or the
    lab-ordered storm) from round ``start``: with ``lanes`` the packed lane
    round (`sim.lanes.packed_lane_step`), with ``lanes`` None the solo
    packed round of seed 0; the first ``start`` rounds are setup."""
    from corrosion_tpu_torch.campaign.ensemble import seed_states
    from corrosion_tpu_torch.sim import lanes as ln
    from corrosion_tpu_torch.sim.packed import (
        pack_state, packed_round_step, shrink_state)
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.state import uniform_payloads
    from corrosion_tpu_torch.sim.topology import regions
    from corrosion_tpu_torch.sim.words import pack_bits

    spec = packed_proto_spec(which)
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every({}))
    region = regions(cfg.n_nodes, topo.n_regions, dev)

    last_round = int(meta.round.max())  # the loops' one read a run

    def step(loop):
        if lanes is None:
            slim, carry, inj, metrics = loop
            slim, carry, inj, metrics, done = packed_round_step(
                slim, carry, inj, metrics, meta, cfg, topo, region,
                last_round=last_round)
            loop = (slim, carry, inj, metrics)
        else:
            loop, done = ln.packed_lane_step(loop, meta, cfg, topo, region,
                                             last_round=last_round)
        done.tolist()  # the loop's one host read a round
        return loop

    def setup():
        if lanes is None:
            state = new_sim(cfg, spec.seeds[0], dev)
            loop = (shrink_state(state), pack_state(state, cfg),
                    pack_bits(state.injected), new_metrics(cfg, dev))
        else:
            loop = ln.packed_lane_batch(
                seed_states(cfg, spec.seeds[:lanes], dev), cfg)
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    label = f"{which} x{lanes} lanes" if lanes else f"{which} solo"
    return _profile(run, rounds, f"packed {label} rounds {start}-"
                    f"{start + rounds - 1}", setup)


# -- the 1M-node tier (phase 3m, path 69) and matrix plans on the packed
# round's lanes (path 70) -----------------------------------------------------

#: config_fault_storm_1m's nodes (JAX runner.py:753)
MILLION = 1_000_000
#: the first rounds of the 1M fault storm's profiled windows: rounds 0-2,
#: inside the loss window (K10's fault stream), and 16-18, past the loss
#: and the split (K2)
MILLION_WINDOWS = (0, 16)
#: the rows path 69 launches: the packed round with ground-truth
#: membership (K1's uniform entry, no SWIM step) under the factored plan
MILLION_ROWS = ("sample_uniform", "threefry", "edge_list",
                "broadcast_scatter", "broadcast_scatter_lossy", "word_phases",
                "sync_masks", "sync_pull", "gaps_refresh", "converge_fold",
                "node_faults")
#: partial-view SWIM's rows, off under ground truth
MILLION_OFF = ("sample_targets", "merge_entries")
#: the nodes of path 70's cell: the fault storm below 1024 nodes, where
#: the plan compiles to the matrix form
MATRIX_LANE_N = 512


def compare_million_kernels(dev, seed=19, n=MILLION, timed=True):
    """Phase 3m: the 1M path's kernels whose indices grow the most past
    the 100k storm's, at config_fault_storm_1m's shapes (N = 1000000, W =
    16, F = S = 3, E = 3000000, D = 2), each against its plain version on
    the same card tensors: K1's uniform entry without a view (the [12, N]
    candidate draw, with self candidates, repeats and rows left short);
    K10's fault stream at E = 3000000 under the 1M plan's round 5 (the
    threshold 38 on every edge, the split's cuts; its loss counter e*8W +
    8k + j reaches 3.84e8 in u32, its byte index e*P + q 1.54e9); K7's
    exit mode at [N, W] (264 blocks of 256 rows, 15 passes each before the
    ticket; the overflow fold's f32 reciprocal of N * A = 1.6e7)."""
    from corrosion_tpu_torch.sim import faults, packed, swim
    from corrosion_tpu_torch.sim import rng as trng

    g = np.random.default_rng(seed)
    w, f, count = 16, 3, 3
    rows = []

    # K1's uniform entry, no view (ground truth)
    over = 4 * count
    me = np.arange(n)[None, :]
    cand = g.integers(0, n, (over, n))
    cand = np.where(g.random((over, n)) < 0.05, me, cand)
    cand[1] = np.where(g.random(n) < 0.3, cand[0], cand[1])  # repeats
    short = g.random(n) < 0.001
    cand[:, short] = me[:, short]  # rows left short
    cand_t = torch.as_tensor(cand, dtype=torch.int32, device=dev)
    del cand
    got = swim.sample_uniform(cand_t, None, count)
    want = swim.sample_uniform_plain(cand_t, None, count)
    equal, err = _equal_all([got], [want])
    if not bool((want == -1).any()):
        raise AssertionError("K1 uniform inputs at 1M leave no row short")
    rows.append(_row(
        "sample_uniform_1m",
        "corrosion_tpu_torch/kernels/csrc/sample_targets.cu",
        "corrosion_tpu/sim/swim.py:59", equal, err,
        _timed(timed, lambda: swim.sample_uniform(cand_t, None, count)),
        _timed(timed, lambda: swim.sample_uniform_plain(cand_t, None,
                                                        count)),
        # the draws, the output
        cand_t.numel() * 4 + n * count * 4, kernel="sample_uniform"))
    del cand_t, got, want

    # K10's fault stream on the wire's edges of round 5
    cfg, meta, fplan, rf = _storm_fault_round(dev, n, 5)
    key = trng.prng_key(99, dev)
    e = n * f
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(f)
    dst = torch.as_tensor(g.integers(0, n, e), dtype=torch.int32, device=dev)
    dst = torch.where(torch.as_tensor(g.random(e) < 0.05, device=dev), src,
                      dst).contiguous()
    ok = torch.as_tensor(g.random(e) < 0.9, device=dev)
    ok, thr, _, _ = faults.fault_wire_effects(rf, src, dst, ok)
    if int(thr.max()) != 38 or bool(ok.all()):
        raise AssertionError("K10 inputs at 1M miss the threshold or a cut")
    sending = _random_words(g, (n, w), dev, 4)
    slot = torch.full_like(dst, 5 % 2)
    ring0 = _random_words(g, (2, n, w), dev, 6)
    s = int(rf.seed)
    got_r, want_r = ring0.clone(), ring0.clone()
    packed.scatter_sending_lossy(got_r, sending, dst, slot, ok, thr, key, s,
                                 f)
    packed.scatter_sending_lossy_plain(want_r, sending, dst, slot, ok, thr,
                                       key, s, f)
    lossless = ring0.clone()
    packed.scatter_sending_plain(lossless, sending, dst, slot, ok, f)
    if torch.equal(lossless, want_r):
        raise AssertionError("K10 inputs at 1M drop no payload")
    del lossless
    live = ok & (thr > 0)
    hashes = int(((sending.repeat_interleave(f, dim=0) != 0)
                  & live[:, None]).sum()) * 8
    touched = torch.unique((slot.long() * n + dst.long())[ok]).numel()
    k10_bytes = sending.numel() * 4 + e * 10 + touched * w * 4 * 2
    k10_ops = hashes * OPS_PER_HASH
    ring_k, ring_p = ring0.clone(), ring0.clone()
    rows.append(_ops_row(
        "broadcast_scatter_lossy_1m",
        "corrosion_tpu_torch/kernels/csrc/broadcast_scatter.cu",
        "corrosion_tpu/sim/faults.py:260",
        bool(torch.equal(got_r, want_r)), _max_abs_err(got_r, want_r),
        _timed(timed, lambda: packed.scatter_sending_lossy(
            ring_k, sending, dst, slot, ok, thr, key, s, f)),
        # the plain version finds its pairs with a host sync: eager
        _time_eager_ms(lambda: packed.scatter_sending_lossy_plain(
            ring_p, sending, dst, slot, ok, thr, key, s, f), reps=2,
            warmup=1) if timed else None,
        k10_bytes, k10_ops, kernel="broadcast_scatter_lossy",
        hashes=hashes))
    del got_r, want_r, ring_k, ring_p, ring0, sending, src, dst, ok, thr

    # K7's exit mode on `_record_cases` at [N, W]
    last = int(meta.round.max())
    calls = []
    for have, inj, alive, m, t, cnt, horizon in _record_cases(g, dev, n, w,
                                                             cfg):
        args = (have, inj, alive, m, meta, t, cfg, cnt, last, horizon)
        calls.append((args, packed.converge_record(*args),
                      packed.converge_record_plain(*args)))
    equal, err = True, 0
    for _, got, want in calls:
        e2, x2 = _equal_all(got, want)
        equal, err = equal and e2, max(err, x2)
    flags = [bool(c[2][3]) for c in calls]
    if flags != [False, True, False, True, False]:
        raise AssertionError(f"K7 inputs at 1M do not reach both done "
                             f"values in both modes: {flags}")
    exit_args = calls[3][0]  # the fault loop's exit mode, done reached
    p = cfg.n_payloads
    rows.append(_row(
        "converge_fold_exit_1m",
        "corrosion_tpu_torch/kernels/csrc/converge_fold.cu",
        "corrosion_tpu/sim/packed.py:1027", equal, err,
        _timed(timed, lambda: packed.converge_record(*exit_args)),
        _timed(timed, lambda: packed.converge_record_plain(*exit_args)),
        # have, injected_p, alive; converged_at and coverage_at in and
        # out; the overflow count and fraction in and out; the done flag
        n * w * 4 + w * 4 + n + n * 4 * 2 + p * 4 * 2 + 4 * 3 + 1,
        kernel="converge_fold"))
    del calls
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if not row["equal"]:
            raise AssertionError(f"{row['name']}: kernel != plain version")
    print("phase 3m: " + json.dumps(
        {r["name"]: [r["ms"], r["plain_ms"], r["bound_ms"]] for r in rows}),
        flush=True)
    return rows


def _million_loop(dev, start, n=MILLION):
    """config_fault_storm_1m's run (at ``n`` nodes) as the packed fault
    loop's body (`packed.run_packed_faults`: the round's node faults, the
    round with its slice and activity, the loop's one host read): (setup,
    step), the setup the run's packed state after its first ``start``
    rounds."""
    from corrosion_tpu_torch.sim import faults, packed
    from corrosion_tpu_torch.sim.round import new_metrics, new_sim
    from corrosion_tpu_torch.sim.runner import fault_storm
    from corrosion_tpu_torch.sim.topology import Topology, regions

    cfg, meta, fplan = fault_storm(n, 512, 0, dev)
    topo = Topology()
    region = regions(cfg.n_nodes, 1, dev)
    activity = faults.host_activity(fplan)
    horizon = fplan.horizon
    last_round = int(meta.round.max())  # the loop's one read a run

    def step(loop):
        slim, carry, inj, metrics = loop
        t = int(slim.t)
        rf = faults.round_faults(fplan, t)
        slim, carry = packed.apply_round_faults(slim, carry, rf)
        slim, carry, inj, metrics, done = packed.packed_round_step(
            slim, carry, inj, metrics, meta, cfg, topo, region, rf, horizon,
            None, activity[min(t, horizon)], last_round=last_round)
        bool(done)
        return slim, carry, inj, metrics

    def setup():
        state = new_sim(cfg, 0, dev)
        loop = (packed.shrink_state(state), packed.pack_state(state, cfg),
                packed.pack_bits(state.injected), new_metrics(cfg, dev))
        del state
        for _ in range(start):
            loop = step(loop)
        torch.cuda.synchronize()
        return loop

    return setup, step


def profile_million(dev, start, rounds=3):
    """Rounds ``start`` to ``start + rounds - 1`` of the 1M fault storm
    (`_million_loop`); the rounds before, and the run's setup, are
    outside the profile."""
    setup, step = _million_loop(dev, start)

    def run(loop):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(rounds):
            loop = step(loop)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, f"fault-storm-1m rounds {start}-"
                    f"{start + rounds - 1}", setup)


def profile_million_run(dev, rounds):
    """`config_fault_storm_1m`'s whole call of ``rounds`` rounds, its
    setup (the config, the plan's compile, `new_sim`, the pack) and the
    final unpack included."""
    from corrosion_tpu_torch.sim.runner import config_fault_storm_1m

    def run():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        config_fault_storm_1m(seed=0, device=dev)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    return _profile(run, rounds, "fault-storm-1m whole run")


#: pointers of the 1M path's entries whose cells a launch updates in
#: place, by entry, from the launch's pointer count: "ring" ones are read
#: and written only where a cell changes (a scatter's, a wipe's or a set
#: bit's target), "inout" ones are read whole and written where they
#: change, "slot" ones are rings whose slot ints[3] is read whole and
#: cleared.  K8's pointers hold the relay planes between fixed ones.
_INPLACE = {
    "fault_edges": lambda n: {n - 5: "inout"},
    "broadcast_scatter": lambda n: {0: "ring"},
    "broadcast_scatter_lossy": lambda n: {0: "ring"},
    "word_inject": lambda n: {i: "ring" for i in range(3, n)},
    "word_spend": lambda n: {i: "inout" for i in range(1, n - 4)},
    "word_deliver": lambda n: {0: "slot", 1: "slot",
                               **{i: "ring" for i in range(2, n)}},
    "sync_pull": lambda n: {4: "ring"},
    "node_faults": lambda n: {i: "ring" for i in range(2, n)},
}
#: pointers a bound leaves out: K7's self-clearing scratch
_SCRATCH = {"converge_record": (11,)}


def _launch_ops(name, ptrs, ints):
    """The u32 operations of one launch's hashes: K5's draws (a hash an
    element; a randint element two and its modulos) and K10's fault
    stream (eight hashes a sending (edge, word) pair whose u8 threshold is
    not 0)."""
    if name == "threefry":
        return ints[0] * OPS_PER_HASH
    if name == "randint":
        return ints[0] * OPS_PER_RANDINT
    if name == "broadcast_scatter_lossy" and ptrs[5] is not None:
        sending, ok, thr = ptrs[1], ptrs[4], ptrs[5]
        live = ok & (thr > 0)
        pairs = (sending.repeat_interleave(ints[3], dim=0) != 0) & live[:, None]
        return int(pairs.sum()) * 8 * OPS_PER_HASH
    return 0


def bounds_million(dev, start, rounds=3, n=MILLION):
    """The least time the card could take for each 1M-path entry's work
    in rounds ``start`` to ``start + rounds - 1`` of the 1M fault storm:
    the rounds (deterministic) replayed from `_million_loop`'s setup with
    every entry's launch wrapped to count the bytes it must move (each
    input read once, each output written once; an in-place pointer as
    `_INPLACE` says, its changed cells from a copy taken before the
    launch) and its hashes' u32 operations (`_launch_ops`).  Per round,
    by entry: launches, bytes, operations, bound ms and what bounds it."""
    from corrosion_tpu_torch import kernels

    setup, step = _million_loop(dev, start, n)
    loop = setup()
    acc = {}

    def wrapped(kern):
        orig = kern.launch

        def launch(ptrs, ints):
            rule = _INPLACE.get(kern.name)
            inplace = {} if rule is None else rule(len(ptrs))
            before = {i: ptrs[i].clone() for i in inplace
                      if ptrs[i] is not None}
            ops = _launch_ops(kern.name, ptrs, ints)
            orig(ptrs, ints)
            torch.cuda.synchronize()
            nbytes = 0
            for i, p in enumerate(ptrs):
                if p is None or i in _SCRATCH.get(kern.name, ()):
                    continue
                how = inplace.get(i)
                if how is None:
                    nbytes += _nbytes(p)
                    continue
                changed = _changed_bytes([before[i]], [p])
                if how == "inout":
                    nbytes += _nbytes(p) + changed
                elif how == "slot":
                    nbytes += _nbytes(p[ints[3]]) + changed
                else:
                    nbytes += 2 * changed
            a = acc.setdefault(kern.name, [0, 0, 0])
            a[0] += 1
            a[1] += nbytes
            a[2] += ops
        return launch

    for kern in kernels.KERNELS:
        kern.launch = wrapped(kern)
    try:
        for _ in range(rounds):
            loop = step(loop)
    finally:
        for kern in kernels.KERNELS:
            del kern.launch
    rate = _int32_ops_per_s()
    out = {}
    for name, (n_launch, nbytes, ops) in sorted(acc.items()):
        b_ms, o_ms = _bound_ms(nbytes / rounds), ops / rounds / rate * 1e3
        out[name] = {"launches_per_round": n_launch / rounds,
                     "bytes_per_round": nbytes / rounds,
                     "ops_per_round": ops / rounds,
                     "bound_ms_per_round": max(b_ms, o_ms),
                     "bound_by": "operations" if o_ms > b_ms else "bytes"}
    return {"rounds": f"{start}-{start + rounds - 1}", "entries": out}


def million_path(dev, goldens, card):
    """Path 69: `config_fault_storm_1m(seed=0)` from zeroed counters, every
    row of `MILLION_ROWS` launched, K9's edge queries (not its reach,
    which ground truth never calls) and no row of partial-view SWIM;
    rounds, p99 and digest against `goldens.FAULT_STORM_1M_SEED0`,
    converged with no node left out.  Prints the record and the peak
    device memory beside the card; returns the path's launches."""
    import gc

    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.sim.runner import config_fault_storm_1m

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rec = config_fault_storm_1m(seed=0, device=dev, return_state=True)
    peak = torch.cuda.max_memory_allocated()
    counts = _path_launches(kernels, MILLION_ROWS, "fault_storm_1m",
                            entries=("fault_edges",))
    off = [row for row in MILLION_OFF if counts[row]]
    if off or kernels.FAULT_REACH.launches:
        raise AssertionError(f"fault_storm_1m: partial-view rows {off} or "
                             "K9's reach launched under ground truth")
    if (rec["round_path"], rec["membership"]) != ("packed", "ground-truth"):
        raise AssertionError("fault_storm_1m: not the packed round with "
                             "ground-truth membership")
    _storm_check(rec, goldens.FAULT_STORM_1M_SEED0, "fault_storm_1m")
    if rec["unconverged_nodes"] != 0:
        raise AssertionError("fault_storm_1m: unconverged nodes")
    print("config_fault_storm_1m: " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("state", "metrics")})
        + f" max_memory_allocated {peak} bytes ({held} held at entry); "
        f"card: {card}", flush=True)
    return counts


def million_profiles(dev, rounds, card):
    """Where the 1M fault storm's time goes: its whole run profiled (the
    launches, device ms and idle share a round, printed beside the card),
    then the windows of `MILLION_WINDOWS` profiled and their bounds
    replayed (`bounds_million`).  Run early in the process: the profiler
    has dropped device events in a process that ran many phases before
    (fractional launch counts a round)."""
    prof = profile_million_run(dev, rounds)
    print(f"fault_storm_1m: {prof['device_launches_per_round']} launches "
          f"and {prof['device_ms_per_round']} device ms a round, idle "
          f"{prof['idle_share']}, wall {prof['wall_ms_per_round'] * rounds} "
          f"ms ({rounds} rounds, setup and unpack included); card: {card}",
          flush=True)
    print("profile_fault_storm_1m: " + json.dumps(prof), flush=True)
    for start in MILLION_WINDOWS:
        print("profile_fault_storm_1m: " + json.dumps(
            profile_million(dev, start)), flush=True)
        print("bounds_fault_storm_1m: " + json.dumps(
            bounds_million(dev, start)), flush=True)


def packed_matrix_spec(seeds=range(ENSEMBLE_LANES), n=MATRIX_LANE_N):
    """Path 70's cell: the fault storm at ``n`` nodes on the packed round
    (``packed_min_cells`` 0), its plan compiled to the matrix form below
    1024 nodes (`campaign.spec.storm_seeds_spec` with ``faults``)."""
    from corrosion_tpu_torch.campaign import spec as sp

    seeds = tuple(seeds)
    spec = sp.storm_seeds_spec(seeds, n_nodes=n, faults=True)
    return dataclasses.replace(
        spec, name=f"packed-fault-storm-{n}-matrix-seeds{len(seeds)}",
        scenario=dict(spec.scenario, packed_min_cells=0))


#: the lane rows path 70 launches: the packed lane round under a matrix
#: plan (K9m's edge entry with the lanes folded into its edges, its reach
#: lane entry)
MATRIX_LANE_ROWS = LANE_STORM_ROWS + ("broadcast_scatter_lossy_lanes",
                                      "node_faults_lanes",
                                      "fault_reach_matrix_lanes",
                                      "fault_edges_matrix")


def packed_matrix_path(dev, goldens):
    """Path 70: the packed round's lanes under a matrix plan (B16x),
    `packed_matrix_spec` through `campaign.engine.run_campaign` from
    zeroed counters: every row of `MATRIX_LANE_ROWS` launched, no solo
    entry of a kernel that has a lane entry nor a factored plan's K9
    entry; spec_hash, result_digest and every lane (rounds, p99,
    convergence, digest) against
    `goldens.PACKED_FAULT_STORM_512_MATRIX_SEEDS8` (each lane live JAX's
    one-seed run); lanes 0 and K - 1 equal to their solo runs on this
    card.  Returns the path's launches."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.campaign.engine import run_campaign
    from corrosion_tpu_torch.campaign.ensemble import lane_state
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim.round import RunMetrics
    from corrosion_tpu_torch.sim.state import uniform_payloads

    label = "packed_fault_storm_512_matrix_seeds8"
    spec = packed_matrix_spec()
    cfg, topo = spec.sim_config({}), spec.topo({})
    meta = uniform_payloads(cfg, dev, inject_every=spec.inject_every({}))
    kernels.reset_launch_counts()
    kept = {}
    art = run_campaign(spec, device=dev, lanes_out=kept)
    counts = _path_launches(kernels, MATRIX_LANE_ROWS, label)
    stray = [r for r in (*SOLO_OF_LANE.values(), "fault_edges",
                         "fault_reach_lanes") if counts[r]]
    if stray:
        raise AssertionError(f"{label}: {stray} launched on the lanes")
    finals, metrics = kept[0]["finals"], kept[0]["metrics"]
    cell = art["cells"][0]
    ps = cell["per_seed"]
    got = {"spec_hash": art["spec_hash"],
           "result_digest": art["result_digest"],
           "lanes": [{"seed": s, "rounds": ps["rounds"][i],
                      "p99_node_convergence_round":
                          ps["p99_node_convergence_round"][i],
                      "converged": ps["converged"][i],
                      "unconverged_nodes": ps["unconverged_nodes"][i],
                      "digest": state_digest(lane_state(finals, i))}
                     for i, s in enumerate(cell["seeds"])]}
    print(f"{label}: {json.dumps(got)} round_path {cell['round_path']} "
          f"wall_clock_s {cell['wall_clock_s']}", flush=True)
    if (cell["round_path"] != "packed"
            or got != goldens.PACKED_FAULT_STORM_512_MATRIX_SEEDS8):
        raise AssertionError(f"{label}: differs from its golden")
    k_last = len(spec.seeds) - 1
    for k in (0, k_last):
        final, m, _, _ = _proto_solo_run(spec, cfg, topo, meta, spec.seeds[k],
                                         dev, False)
        lane_m = RunMetrics(*(x[k] for x in metrics))
        if not (_same_state(final, lane_state(finals, k)) and all(
                torch.equal(a, b) for a, b in zip(m, lane_m))):
            raise AssertionError(f"{label}: lane {k} differs from its solo "
                                 "run")
    print(f"{label}: lanes 0 and {k_last} equal to their solo runs",
          flush=True)
    return counts


_START = time.monotonic()


def _lap(label: str) -> None:
    """Print the seconds the script has run, after ``label``."""
    print(f"elapsed_s={time.monotonic() - _START:.1f} after {label}",
          flush=True)


def _storm_check(result, golden, label):
    """Hold a run's record against its golden: every golden key (the
    digest from the record's final state), then convergence — or, for
    the membership churn, detection."""
    from corrosion_tpu_torch.convert import pview_digest, state_digest

    digests = {"digest": state_digest, "pview_digest": pview_digest}
    got = {key: digests[key](result["state"]) if key in digests
           else result[key] for key in golden}
    print(f"{label}: {json.dumps(got)} wall_clock_s="
          f"{result['wall_clock_s']:.3f}", flush=True)
    for key, want in golden.items():
        if got[key] != want:
            raise AssertionError(f"{label}: {key} {got[key]!r} != golden "
                                 f"{want!r}")
    if not result.get("converged", result.get("detect_round", -1) >= 0):
        raise AssertionError(f"{label}: did not converge")


def _fault_record(final, metrics, wall):
    """A fault run's record in `_storm_check`'s terms."""
    from corrosion_tpu_torch.sim.runner import _node_convergence

    conv = _node_convergence(metrics, final)
    return {"state": final, "rounds": int(final.t), "wall_clock_s": wall,
            "converged": conv["unconverged_nodes"] == 0, **conv}


#: K23's rows, which launch only on a path that runs a detect loop
DETECT_ROWS = ("detect_full", "detect_partial", "detect_full_lanes",
               "detect_partial_lanes")


def _path_launches(kernels, rows, label, telemetry=False, entries=(),
                   counts=None):
    """Read every entry point's launch count after a path ran from 0 (or
    take them from ``counts``, entry name to launches, for a path another
    process ran), require each entry of ``rows``' kernels, and each
    kernel named in ``entries``, to have launched — and no entry of K23
    unless ``rows`` names it, nor, without ``telemetry``, of the flight
    recorder's kernels — and return the counts of every kernel row."""
    if counts is None:
        counts = {kern.name: kern.launches for kern in kernels.KERNELS}
    for name in entries:
        if counts[name] <= 0:
            raise AssertionError(f"kernel entry {name} never launched on "
                                 f"the {label} path")
    off = [row for row in kernels.PORTED if row not in rows]
    print(f"{label} launches={json.dumps(counts)} off_path={off}",
          flush=True)
    for row in rows:
        for kern in kernels.PORTED[row]:
            if counts[kern.name] <= 0:
                raise AssertionError(f"kernel entry {kern.name} never "
                                     f"launched on the {label} path")
    stray = [row for row in DETECT_ROWS if row not in rows
             and any(counts[k.name] for k in kernels.PORTED[row])]
    if stray:
        raise AssertionError(f"{stray} launched on the {label} path, which "
                             "runs no detect loop")
    if not telemetry:
        on = [kern.name for row in kernels.TRACE_ROWS
              for kern in kernels.PORTED[row] if counts[kern.name]]
        if on:
            raise AssertionError(f"flight recorder kernels {on} launched "
                                 f"on the telemetry-off {label} path")
    return {row: sum(counts[k.name] for k in entries_)
            for row, entries_ in kernels.PORTED.items()}


# -- the command line: paths 71-75 ---------------------------------------------

#: the command line's module, as ``python -m`` runs it
CLI_MODULE = "corrosion_tpu_torch.cli.main"
#: the ``sitecustomize`` a command-line subprocess starts with, from a
#: directory put first on its PYTHONPATH: at exit it writes every kernel
#: entry point's launch count to $CHIP_SMOKE_LAUNCHES, and it runs the
#: ``sitecustomize`` the interpreter would have found otherwise
LAUNCH_HOOK = """\
import atexit, importlib.util, json, os, sys


def _write_launches():
    kernels = sys.modules.get("corrosion_tpu_torch.kernels")
    if kernels is not None:
        with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
            json.dump({k.name: k.launches for k in kernels.KERNELS}, f)


atexit.register(_write_launches)
_here = os.path.dirname(os.path.abspath(__file__))
for _d in sys.path:
    _next = os.path.join(os.path.abspath(_d or "."), "sitecustomize.py")
    if os.path.dirname(_next) != _here and os.path.isfile(_next):
        _spec = importlib.util.spec_from_file_location("_site_next", _next)
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
"""
#: a record's keys made of the wall clock
WALL_KEYS = ("wall_clock_s", "rounds_per_sec", "node_rounds_per_sec")
#: `sim storm-ab` runs in path 72, for the spread of its walls
AB_RUNS = 3


def cli_subprocess_path(storm, rows, card, argv=("sim", "write-storm-100k",
                                                  "--seed", "0")):
    """Path 71, the entry point as a user starts it: ``python -m
    corrosion_tpu_torch.cli.main sim write-storm-100k --seed 0`` (no
    ``--device``: the card) in a process of its own, which starts from
    zeroed counters and reports them at exit (`LAUNCH_HOOK`).  It must
    exit 0 and print one JSON line: path 1's record (``storm``, the same
    config in this process) in every key but the wall's, every entry of
    ``rows``' kernels launched.  Returns the launches by kernel row and
    the walls: the record's (the run, synchronized) and the process's,
    from its start to its exit."""
    import os
    import tempfile

    from corrosion_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as harness:
        with open(os.path.join(harness, "sitecustomize.py"), "w") as f:
            f.write(LAUNCH_HOOK)
        counts_path = os.path.join(harness, "launches.json")
        env = dict(os.environ, CHIP_SMOKE_LAUNCHES=counts_path,
                   PYTHONPATH=os.pathsep.join(
                       d for d in (harness, os.environ.get("PYTHONPATH"))
                       if d))
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", CLI_MODULE, *argv], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=900)
        process_wall = time.monotonic() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli {' '.join(argv)}: exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        if len(lines) != 1:
            raise AssertionError(f"cli {' '.join(argv)}: {len(lines)} lines "
                                 "of output, not one JSON line")
        record = json.loads(lines[0])
        with open(counts_path) as f:
            counts = json.load(f)
    label = "cli_" + argv[1].replace("-", "_")
    launches = _path_launches(kernels, rows, label, counts=counts)
    want = {k: v for k, v in storm.items()
            if k not in ("state", "metrics", "trace", *WALL_KEYS)}
    got = {k: v for k, v in record.items() if k not in WALL_KEYS}
    if set(record) != set(want) | set(WALL_KEYS) or json.loads(
            json.dumps(want, default=float)) != got:
        raise AssertionError(f"{label}: record {record} is not path 1's "
                             f"{want}")
    walls = {"wall_clock_s": record["wall_clock_s"],
             "process_wall_s": process_wall}
    print(f"{label}: {lines[0]} process_wall_s={process_wall:.3f} "
          f"card={card}", flush=True)
    return launches, walls


def _cli_main(argv):
    """``cli.main(argv)`` in this process: its exit code and stdout."""
    import contextlib
    import io

    from corrosion_tpu_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}")
    return out.getvalue()


def cli_paths(goldens, card, storm_rows, dense_rows, device_argv=(),
              ab_nodes=None):
    """Paths 72-74, the command line in this process (``cli.main``), each
    from zeroed counters with its launches by kernel printed:

    - 72, ``sim storm-ab`` at JAX's default 25 000 nodes (``ab_nodes``
      for a rehearsal), `AB_RUNS` times: each ``results_identical``, the
      two round paths (the config asserts them; the launches show both
      rounds' kernels), rounds equal to ``STORM_AB_25000_SEED0``'s packed
      and dense runs, the two walls and ``packed_speedup`` printed beside
      the card, then the speedups' median;
    - 73, ``sim fault-campaign-3node``: ``FAULT_CAMPAIGN_3NODE_ENGINE``'s
      ``spec_hash``, ``result_digest`` and p99 and
      ``FAULT_CAMPAIGN_3NODE_SEED0``'s rounds;
    - 74, ``sim campaign run --spec fault-parity-3node --out <tmp>``:
      ``FAULT_PARITY_3NODE_SEEDS8``'s ``spec_hash`` and ``result_digest``,
      and the artifact's per-seed rounds and p99s its lanes'.

    ``device_argv`` is ``--device cpu`` in a rehearsal on the CPU.
    Returns (launches by path, the storm A/B's record)."""
    import os
    import tempfile

    from corrosion_tpu_torch import kernels

    launches = {}
    label = "cli_storm_ab"
    argv = ["sim", "storm-ab", "--seed", "0", *device_argv]
    if ab_nodes:
        argv += ["--nodes", str(ab_nodes)]
    pin = goldens.STORM_AB_25000_SEED0
    kernels.reset_launch_counts()
    runs = []
    for _ in range(AB_RUNS):
        ab = json.loads(_cli_main(argv))
        if (not ab["results_identical"] or ab["mismatched_keys"]
                or not ab["converged"]
                or ab["rounds"] != pin["packed"]["rounds"]
                or ab["rounds"] != pin["dense"]["rounds"]):
            raise AssertionError(f"{label}: {ab} against {pin}")
        print(f"{label}: {json.dumps(ab)} card={card}", flush=True)
        runs.append(ab)
    launches[label] = _path_launches(
        kernels, [*storm_rows, *dense_rows], label)
    speedups = sorted(r["packed_speedup"] for r in runs)
    print(f"{label}: packed_speedup median {speedups[len(runs) // 2]!r} "
          f"of {AB_RUNS} runs {speedups} card={card}", flush=True)

    label = "cli_fault_campaign_3node"
    kernels.reset_launch_counts()
    rec = json.loads(_cli_main(["sim", "fault-campaign-3node", "--seed", "0",
                                *device_argv]))
    extra = dict((p[0], p[2]) for p in DENSE_FAULT_ENSEMBLE_PATHS)
    launches[label] = _path_launches(
        kernels, DENSE_FAULT_LANE_CORE + extra["fault_campaign_3node"], label)
    engine = goldens.FAULT_CAMPAIGN_3NODE_ENGINE
    got = {k: rec[k] for k in ("spec_hash", "result_digest", "rounds",
                               "p99_node_convergence_round")}
    want = {"spec_hash": engine["spec_hash"],
            "result_digest": engine["result_digest"],
            "rounds": goldens.FAULT_CAMPAIGN_3NODE_SEED0["rounds"],
            "p99_node_convergence_round":
                engine["lanes"][0]["p99_node_convergence_round"]}
    print(f"{label}: {json.dumps(rec)}", flush=True)
    if got != want or not rec["converged"] or rec["round_path"] != "dense":
        raise AssertionError(f"{label}: {got} != {want}")

    label = "cli_campaign_fault_parity_3node"
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "fault-parity-3node.json")
        kernels.reset_launch_counts()
        summary = json.loads(_cli_main(
            ["sim", "campaign", "run", "--spec", "fault-parity-3node",
             "--out", out_path, *device_argv]))
        launches[label] = _path_launches(
            kernels, DENSE_FAULT_LANE_CORE + extra["fault_parity_3node"],
            label)
        with open(out_path) as f:
            art = json.load(f)
    parity = goldens.FAULT_PARITY_3NODE_SEEDS8
    per_seed = art["cells"][0]["per_seed"]
    lanes = [{k: lane[k] for k in ("rounds", "p99_node_convergence_round")}
             for lane in parity["lanes"]]
    print(f"{label}: {json.dumps(summary)}", flush=True)
    if ((summary["spec_hash"], summary["result_digest"])
            != (parity["spec_hash"], parity["result_digest"])
            or summary["artifact"] != out_path
            or list(summary["kernel_paths"].values()) != ["dense"]
            or [{"rounds": r, "p99_node_convergence_round": p}
                for r, p in zip(per_seed["rounds"],
                                per_seed["p99_node_convergence_round"])]
            != lanes):
        raise AssertionError(f"{label}: differs from its golden")
    return launches, ab


def registry_path(trace, rounds, cfg, goldens, m_bcast=300_000, m_sync=512,
                  golden="FAULT_STORM_100K_SEED0_REGISTRY"):
    """Path 75: `trace_to_registry` of the 100k fault storm's recorded
    trace (path 8's, held to ``FAULT_STORM_100K_SEED0_TELEMETRY``) onto a
    fresh `Registry`, from zeroed counters (it runs on the host and
    launches nothing): its ``render()`` equal to the golden line for
    line, but the two ``sim_wire_bytes_total`` samples within
    (m + 1 + 2R)·2⁻²⁴·S of JAX's (R rounds, m f32 terms a round, S the
    total), as `_telemetry_check` bounds ``wire_bytes``."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.metrics import Registry
    from corrosion_tpu_torch.sim.telemetry import trace_to_registry

    label = "fault_storm_100k_registry"
    kernels.reset_launch_counts()
    reg = Registry()
    trace_to_registry(trace, rounds, cfg, registry=reg,
                      run="fault_storm_100k")
    got = reg.render()
    counts = {kern.name: kern.launches for kern in kernels.KERNELS}
    print(f"{label} launches={json.dumps(counts)}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"{label}: the export launched kernels")
    want = getattr(goldens, golden)
    gl, wl = got.splitlines(), want.splitlines()
    gaps = {}
    if len(gl) != len(wl):
        raise AssertionError(f"{label}: {len(gl)} lines, golden {len(wl)}")
    for g, w in zip(gl, wl):
        if not w.startswith("sim_wire_bytes_total{"):
            if g != w:
                raise AssertionError(f"{label}: {g!r} != golden {w!r}")
            continue
        (gk, gv), (wk, wv) = g.rsplit(" ", 1), w.rsplit(" ", 1)
        m = m_bcast if 'path="broadcast"' in wk else m_sync
        limit = (m + 1 + 2 * rounds) * F32_ULP * abs(float(wv)) * (
            1 + F32_ULP) + 0.1
        gap = abs(float(gv) - float(wv))
        if gk != wk or gap > limit:
            raise AssertionError(f"{label}: {g!r} against golden {w!r} "
                                 f"(limit {limit})")
        gaps[wk] = gap
    print(f"{label}: render equal to the golden ({len(gl)} lines; "
          f"sim_wire_bytes_total gaps {json.dumps(gaps)})", flush=True)
    return got


def _timed_fault_run(cfg, meta, fplan, seed, dev, telemetry=False,
                     topo=None):
    """A fault run from zeroed launch counters through `run_fault_plan`
    (over ``topo``, the flat topology by default): its output and its
    record in `_storm_check`'s terms, with the p99 payload latency."""
    from corrosion_tpu_torch import kernels
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import _percentile
    from corrosion_tpu_torch.sim.topology import Topology

    state = new_sim(cfg, seed, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = faults.run_fault_plan(state, meta, cfg, topo or Topology(), fplan,
                                max_rounds=3000, telemetry=telemetry)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    run = _fault_record(out[0], out[1], wall)
    cov = out[1].coverage_at.cpu().numpy()
    lat = np.where(cov >= 0, cov - meta.round.cpu().numpy(), -1)
    run["p99_payload_latency_rounds"] = _percentile(lat, 99)
    return {"out": out, "run": run}


def _same_as_packed(dense, packed_run, label):
    """JAX's dense == packed contract (tests/sim/test_packed_equivalence.py
    test_fault_storm_4096_packed_vs_dense): the same have, heads, alive,
    relay budgets and injected flags, and the same convergence and
    coverage stamps, as the packed run of the same storm on this card."""
    for name in ("have", "heads", "alive", "relay_left", "injected"):
        if not torch.equal(getattr(dense[0], name),
                           getattr(packed_run[0], name)):
            raise AssertionError(f"{label}: {name} differs from the packed "
                                 "run's")
    for name in ("converged_at", "coverage_at"):
        if not torch.equal(getattr(dense[1], name),
                           getattr(packed_run[1], name)):
            raise AssertionError(f"{label}: {name} differs from the packed "
                                 "run's")
    print(f"{label}: have, heads, alive, relay_left, injected, converged_at "
          "and coverage_at equal to the packed run's", flush=True)


def _per_round(launches, rows, rounds, label):
    print(f"{label} launches per round: " + json.dumps(
        {row: launches[row] / rounds for row in rows}), flush=True)


F32_ULP = 2.0 ** -24


def _telemetry_check(result, golden, m_bcast, m_sync, label):
    """Hold a telemetry run against its golden: every key of the summary
    block but ``wire_bytes`` exactly (the coverage-curve digest, latency
    percentiles, frames, drops, cuts, refusals, crashes, wipes, sessions,
    SWIM peaks, overflow rounds), and each round's f32 byte channels
    within (m + 1)·2⁻²⁴·S of JAX's for the m f32 terms JAX adds (the
    port's row is the exact total S rounded once); ``wire_bytes`` within
    the rows' bounds plus both sums' rounding.  Returns the largest
    relative gap of a row."""
    from corrosion_tpu_torch.sim.telemetry import trace_host

    got = dict(result["telemetry"])
    wire = got.pop("wire_bytes")
    if got != golden["summary"]:
        raise AssertionError(f"{label}: telemetry summary {got} != golden "
                             f"{golden['summary']}")
    rounds = result["rounds"]
    host = trace_host(result["trace"], rounds)
    worst, bounds = 0.0, {}
    for channel, key, m in (("bcast_bytes", "broadcast", m_bcast),
                            ("sync_bytes", "sync", m_sync)):
        port = host[channel].astype(np.float64)
        want = np.asarray(golden[channel], np.float64)
        exact_hi = np.abs(port) * (1 + F32_ULP)
        bound = (m + 1) * F32_ULP * exact_hi
        gap = np.abs(want - port)
        if want.shape != port.shape or bool((gap > bound).any()):
            raise AssertionError(f"{label}: {channel} outside the f32 bound")
        worst = max(worst, float((gap / np.maximum(port, 1)).max()))
        total = float(exact_hi.sum())
        limit = float(bound.sum()) + 2 * rounds * F32_ULP * total + 0.1
        if abs(wire[key] - golden["wire_bytes"][key]) > limit:
            raise AssertionError(f"{label}: wire_bytes.{key} {wire[key]} vs "
                                 f"golden {golden['wire_bytes'][key]}")
        bounds[key] = limit
    print(f"{label}: telemetry {json.dumps(got)} wire_bytes={json.dumps(wire)}"
          f" f32_worst_relative_gap={worst!r}", flush=True)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from corrosion_tpu_torch import goldens, kernels
    from corrosion_tpu_torch.convert import state_digest
    from corrosion_tpu_torch.sim import faults
    from corrosion_tpu_torch.sim.round import new_sim
    from corrosion_tpu_torch.sim.runner import (
        _write_storm,
        config_broadcast_1k,
        config_fault_storm_telemetry,
        config_gapstress_distortion,
        config_ground_truth_3node,
        config_packed_fault_storm,
        config_partition_heal_10k,
        config_write_storm_100k,
        config_write_storm_gapstress,
        config_swim_churn_64,
        config_swim_churn_partial,
        churn_setup,
        _resolve_topo,
        membership_churn,
        membership_lane_stats,
        run_scenario,
        storm_fault_plan,
    )
    from corrosion_tpu_torch.sim.state import SimConfig
    from corrosion_tpu_torch.sim.telemetry import (
        run_membership_detect, trace_digest, trace_host, trace_summary)
    from corrosion_tpu_torch.sim.topology import Topology

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}", flush=True)

    t0 = time.monotonic()
    kernels.build_all(verbose=True)
    print(f"build_s={time.monotonic() - t0:.2f}", flush=True)

    # the storms' telemetry-off launches, first: the count the profiler
    # gives depends on what the process ran before (a few launches fewer
    # after the comparison phases), so it is held in a fresh process;
    # then the recorder's share of the same rounds
    storm_profiles = [profile_storm(dev),
                      profile_storm(dev, proto_family="baseline"),
                      profile_storm(dev, faults=True)]
    for prof, want in zip(storm_profiles, (STORM_OFF_LAUNCHES,
                                           STORM_OFF_LAUNCHES,
                                           FAULT_STORM_OFF_LAUNCHES)):
        got = round(prof["device_launches_per_round"] * prof["rounds"])
        if got != want:
            raise AssertionError(f"{prof['run']}: {got} launches in "
                                 f"{prof['rounds']} telemetry-off rounds, "
                                 f"not {want}")
    storm_profiles.append(profile_storm(dev, telemetry=True))
    # the 1M fault storm's profiles and bounds, early for the same reason
    million_profiles(dev, goldens.FAULT_STORM_1M_SEED0["rounds"], card)
    print("in-path redesigned kernels' ms per round, "
          + storm_profiles[0]["run"] + ": "
          + json.dumps(in_path_ms(storm_profiles[0])), flush=True)
    _lap("the storms' launch profiles")

    rows = compare_kernels(dev)
    print("kernel comparisons equal at storm shapes", flush=True)
    _lap("storm kernel comparisons")
    dense_kernel_rows = compare_dense_kernels(dev)
    print("kernel comparisons equal at the dense paths' shapes", flush=True)
    _lap("dense kernel comparisons")
    gap_kernel_rows = compare_gapstress_kernels(dev)
    print("kernel comparisons equal at gapstress's shapes", flush=True)
    _lap("gapstress kernel comparisons")
    trace_kernel_rows = compare_trace_kernels(dev)
    print("kernel comparisons equal for the flight recorder", flush=True)
    _lap("flight recorder kernel comparisons")
    latency_kernel_rows = compare_latency_kernels(dev)
    print("kernel comparisons equal at the latency storm's shapes",
          flush=True)
    _lap("latency kernel comparisons")
    dense_fault_kernel_rows = compare_dense_fault_kernels(dev)
    print("kernel comparisons equal at the dense fault storms' shapes",
          flush=True)
    _lap("dense fault kernel comparisons")
    matrix_kernel_rows = compare_matrix_fault_kernels(dev)
    print("kernel comparisons equal at the matrix plans' shapes", flush=True)
    _lap("matrix fault kernel comparisons")
    topo_kernel_rows = compare_topology_kernels(dev)
    print("kernel comparisons equal at the topology axis' shapes", flush=True)
    _lap("topology kernel comparisons")
    proto_kernel_rows = compare_protocol_kernels(dev)
    print("kernel comparisons equal at the protocol axis' shapes", flush=True)
    _lap("protocol kernel comparisons")
    churn_kernel_rows = compare_churn_kernels(dev)
    print("kernel comparisons equal at the churn paths' shapes", flush=True)
    _lap("churn kernel comparisons")
    lane_kernel_rows = compare_lane_kernels(dev)
    print("kernel comparisons equal at the 8-lane storm's shapes",
          flush=True)
    _lap("lane kernel comparisons")
    dense_lane_rows = compare_dense_lane_kernels(dev)
    print("kernel comparisons equal at the 8-lane dense paths' shapes",
          flush=True)
    _lap("dense lane kernel comparisons")
    dense_fault_lane_rows = compare_dense_fault_lane_kernels(dev)
    print("kernel comparisons equal at the 8-lane dense fault paths' shapes",
          flush=True)
    _lap("dense fault lane kernel comparisons")
    trace_lane_rows = compare_dense_lane_trace_kernels(dev)
    print("kernel comparisons equal for the recorder on the dense lanes",
          flush=True)
    _lap("recorder lane kernel comparisons")
    topo_lane_rows = compare_topology_lane_kernels(dev)
    print("kernel comparisons equal for the topology axis and PeerSwap on "
          "the dense lanes", flush=True)
    _lap("topology lane kernel comparisons")
    proto_lane_rows = compare_protocol_lane_kernels(dev)
    print("kernel comparisons equal for the protocol variants on the dense "
          "lanes", flush=True)
    _lap("protocol lane kernel comparisons")
    packed_lane_rows = compare_packed_lane_latency_kernels(dev)
    print("kernel comparisons equal for latency plans and the recorder on "
          "the packed lanes", flush=True)
    _lap("packed lane latency and recorder kernel comparisons")
    axis_lane_rows = compare_packed_lane_metered_kernels(dev)
    print("kernel comparisons equal for metered budgets and the topology "
          "streams on the packed lanes", flush=True)
    _lap("packed lane metered and topology kernel comparisons")
    proto_packed_rows = compare_packed_lane_protocol_kernels(dev)
    print("kernel comparisons equal for the protocol variants on the packed "
          "lanes", flush=True)
    _lap("phase 3lq, packed lane protocol kernel comparisons")
    million_rows = compare_million_kernels(dev)
    print("kernel comparisons equal at the 1M fault storm's shapes",
          flush=True)
    _lap("phase 3m, the 1M path's kernel comparisons")

    cfg, meta = _write_storm(512, 256, dev)
    cfg = dataclasses.replace(cfg, packed_min_cells=0)
    small = run_scenario(cfg, meta, seed=7, max_rounds=600, device=dev,
                         return_state=True)
    _storm_check(small, goldens.STORM_512_SEED7, "storm_512_seed7")
    fplan = faults.compile_plan(storm_fault_plan(512, 7), cfg,
                                factored=True, device=dev)
    t0 = time.monotonic()
    final, metrics = faults.run_fault_plan(
        new_sim(cfg, 7, dev), meta, cfg, Topology(), fplan, max_rounds=600)
    torch.cuda.synchronize()
    _storm_check(_fault_record(final, metrics, time.monotonic() - t0),
                 goldens.FAULT_STORM_512_SEED7, "fault_storm_512_seed7")

    # path 1, the faultless storm: K1-K8 (K3 with its mask pass)
    faultless_rows = ["sample_targets", "broadcast_scatter", "edge_list",
                      "sync_masks", "sync_pull", "merge_entries", "threefry",
                      "gaps_refresh", "converge_fold", "word_phases"]
    kernels.reset_launch_counts()
    big = config_write_storm_100k(seed=0, device=dev, return_state=True)
    launches = _path_launches(kernels, faultless_rows, "storm_100k")
    _storm_check(big, goldens.STORM_100K_SEED0, "storm_100k_seed0")

    # paths 71-74, the command line: path 1's entry point in a process of
    # its own, as a user starts it, then storm-ab and the two 3-node
    # campaigns through cli.main in this one
    cli_subprocess_path(big, faultless_rows, card)
    cli_paths(goldens, card, faultless_rows,
              ["sample_targets", "merge_entries", "threefry", "dense_phases",
               "dense_sync", "dense_gaps"])
    _lap("paths 71-74, the command line")

    # path 2, the 100k fault storm alone: K1's table entry and K3-K11.
    # Every fault round scatters through K10, so K2 is off this path.
    cfg, meta = _write_storm(100_000, 512, dev)
    fplan = faults.compile_plan(storm_fault_plan(100_000, 0), cfg,
                                device=dev)
    state = new_sim(cfg, 0, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, metrics = faults.run_fault_plan(
        state, meta, cfg, Topology(), fplan, max_rounds=3000)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    packed_fault = (final, metrics)
    fault_launches = _path_launches(
        kernels, [row for row in faultless_rows if row != "broadcast_scatter"]
        + ["fault_edges", "broadcast_scatter_lossy", "node_faults"],
        "fault_storm_100k")
    _storm_check(_fault_record(final, metrics, wall),
                 goldens.FAULT_STORM_100K_SEED0, "fault_storm_100k")

    # the fault storm's entry point, with its faultless twin
    fault = config_packed_fault_storm(seed=0, device=dev, return_state=True)
    _storm_check(fault, goldens.FAULT_STORM_100K_SEED0,
                 "config_packed_fault_storm")
    print("config_packed_fault_storm: " + json.dumps({
        k: v for k, v in fault.items() if k not in ("state", "metrics")}),
        flush=True)

    # path 69, the 1M-node tier: the packed round with ground-truth
    # membership under the factored storm plan, with its profiles
    million_launches = million_path(dev, goldens, card)
    _lap("path 69, the 1M fault storm")

    # path 3, partition-heal-10k: the dense round with partial-view
    # SWIM, two regions (ring0 tiering): K1, K4, K5 and K12-K14
    dense_rows = ["dense_phases", "dense_sync", "dense_gaps"]
    kernels.reset_launch_counts()
    heal = config_partition_heal_10k(seed=0, device=dev, return_state=True)
    heal_launches = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows],
        "partition_heal_10k")
    _storm_check(heal, goldens.PARTITION_HEAL_10K_SEED0, "partition_heal_10k")

    # path 4, broadcast-1k and the 3-node ground truth (metered budgets):
    # ground-truth membership, so the uniform sampler (K1's second
    # entry), K5 and K12-K14
    uniform_rows = ["sample_uniform", "threefry", *dense_rows]
    for label, entry, golden in (
            ("broadcast_1k", config_broadcast_1k, goldens.BROADCAST_1K_SEED0),
            ("ground_truth_3node", config_ground_truth_3node,
             goldens.GROUND_TRUTH_3NODE_SEED0)):
        kernels.reset_launch_counts()
        result = entry(seed=0, device=dev, return_state=True)
        _path_launches(kernels, uniform_rows, label)
        _storm_check(result, golden, label)

    # path 5, churn-full-4096: full-view SWIM on [4096, 4096] beliefs,
    # K1's uniform entry filtering by them, K15, and K23's full entry
    # after every round: the solo detect loop (run_membership_detect) on
    # membership_churn's setup (membership_churn itself now runs through
    # the campaign engine's lanes, path 28b)
    cfg5 = SimConfig.wan_tuned(CHURN_N, n_payloads=1, swim_full_view=True)
    meta5, state5 = churn_setup(cfg5, 0, dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final5, _, det5 = run_membership_detect(state5, meta5, cfg5, Topology(),
                                            400, device=dev)
    torch.cuda.synchronize()
    churn_launches_5 = _path_launches(
        kernels, [*uniform_rows, "swim_full", "detect_full"],
        "churn_full_4096")
    _storm_check({"state": final5, "detect_round": int(det5),
                  "false_downs": membership_lane_stats(final5, cfg5)[
                      "false_positive_downs"],
                  "wall_clock_s": time.monotonic() - t0},
                 goldens.CHURN_FULL_4096_SEED0, "churn_full_4096")

    # path 6, gapstress-25.6k: the packed round under both byte budgets
    # (K16, K3's metered entry, K8's metered spend), the flat 30 % loss
    # on every round's scatter (K10's topology stream, so K2 is off the
    # path) and V = 128 gaps (K6's walk)
    gap_rows = ["sample_targets", "merge_entries", "threefry", "gaps_refresh",
                "converge_fold", "word_phases", "sync_masks",
                "sync_pull_metered", "budget_words", "broadcast_scatter_lossy"]
    kernels.reset_launch_counts()
    gapstress = config_write_storm_gapstress(seed=1, n_nodes=GAPSTRESS_N,
                                             device=dev, return_state=True)
    gap_launches = _path_launches(kernels, gap_rows, "gapstress_25600")
    if gapstress["round_path"] != "packed":
        raise AssertionError("gapstress_25600 did not take the packed round")
    _storm_check(gapstress, goldens.GAPSTRESS_25600_SEED1, "gapstress_25600")

    # path 7, the K-clamp distortion at 1024 nodes: the dense round at
    # K = 8 and at the K = 64 control (K14 past 32 slots)
    kernels.reset_launch_counts()
    dist = config_gapstress_distortion(seed=0, n_nodes=1024, device=dev,
                                       return_state=True)
    dist_launches = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows],
        "gapstress_distortion_1024")
    golden = goldens.GAPSTRESS_DISTORTION_1024_SEED0
    for run in ("stressed", "control"):
        _storm_check(dist[run], golden[run], f"gapstress_distortion_{run}")
    if dist["distortion_rounds"] != golden["distortion_rounds"]:
        raise AssertionError("gapstress_distortion: distortion_rounds "
                             f"{dist['distortion_rounds']} != golden")

    _lap("paths 1-7")
    # path 8, the flight recorder: every path the JAX runner lets record
    # a trace, with telemetry on, each from zeroed counters — its goldens
    # (rounds, p99s, overflow, digest) do not move, its telemetry golden
    # holds, and K17-K19 launch
    packed_trace = ["trace_counts", "trace_wire", "trace_row"]
    dense_trace = ["trace_counts_dense", "trace_wire_rows", "trace_row"]
    tel_launches, f32_gaps = {}, {}
    kernels.reset_launch_counts()
    run = config_write_storm_100k(seed=0, telemetry=True, device=dev,
                                  return_state=True)
    tel_launches["storm"] = _path_launches(
        kernels, faultless_rows + packed_trace, "storm_100k_telemetry", True)
    _storm_check(run, goldens.STORM_100K_SEED0, "storm_100k_telemetry")
    f32_gaps["storm_100k"] = _telemetry_check(
        run, goldens.STORM_100K_SEED0_TELEMETRY, 300_000, 512,
        "storm_100k_telemetry")

    cfg, meta = _write_storm(100_000, 512, dev)
    fplan = faults.compile_plan(storm_fault_plan(100_000, 0), cfg,
                                device=dev)
    state = new_sim(cfg, 0, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, metrics, trace = faults.run_fault_plan(
        state, meta, cfg, Topology(), fplan, max_rounds=3000,
        telemetry=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel_launches["fault"] = _path_launches(
        kernels, [row for row in faultless_rows if row != "broadcast_scatter"]
        + ["fault_edges", "broadcast_scatter_lossy", "node_faults",
           *packed_trace], "fault_storm_100k_telemetry", True)
    run = _fault_record(final, metrics, wall)
    run["trace"] = trace
    run["telemetry"] = trace_summary(trace_host(trace, run["rounds"]),
                                     run["rounds"], cfg)
    _storm_check(run, goldens.FAULT_STORM_100K_SEED0,
                 "fault_storm_100k_telemetry")
    f32_gaps["fault_storm_100k"] = _telemetry_check(
        run, goldens.FAULT_STORM_100K_SEED0_TELEMETRY, 300_000, 512,
        "fault_storm_100k_telemetry")
    # path 75, the same trace exported on a fresh metrics registry
    registry_path(trace, run["rounds"], cfg, goldens)

    kernels.reset_launch_counts()
    run = config_write_storm_gapstress(seed=1, n_nodes=GAPSTRESS_N,
                                       telemetry=True, device=dev,
                                       return_state=True)
    tel_launches["gapstress"] = _path_launches(
        kernels, gap_rows + packed_trace, "gapstress_25600_telemetry", True)
    _storm_check(run, goldens.GAPSTRESS_25600_SEED1,
                 "gapstress_25600_telemetry")
    f32_gaps["gapstress_25600"] = _telemetry_check(
        run, goldens.GAPSTRESS_25600_SEED1_TELEMETRY, 3 * GAPSTRESS_N, 8192,
        "gapstress_25600_telemetry")

    kernels.reset_launch_counts()
    run = config_write_storm_gapstress(seed=0, n_nodes=DENSE_GAPSTRESS_N,
                                       telemetry=True, device=dev,
                                       return_state=True)
    tel_launches["gapstress_1024"] = _path_launches(
        kernels, ["sample_targets", "merge_entries", "threefry", *dense_rows,
                  *dense_trace], "gapstress_1024_telemetry", True)
    if run["round_path"] != "dense":
        raise AssertionError("gapstress_1024 did not take the dense round")
    _storm_check(run, goldens.GAPSTRESS_DISTORTION_1024_SEED0["stressed"],
                 "gapstress_1024_telemetry")
    f32_gaps["gapstress_1024"] = _telemetry_check(
        run, goldens.GAPSTRESS_1024_SEED0_TELEMETRY, 3 * DENSE_GAPSTRESS_N,
        8192, "gapstress_1024_telemetry")

    for label, entry, golden, tel_golden, m in (
            ("broadcast_1k", config_broadcast_1k, goldens.BROADCAST_1K_SEED0,
             goldens.BROADCAST_1K_SEED0_TELEMETRY, (3000, 256)),
            ("ground_truth_3node", config_ground_truth_3node,
             goldens.GROUND_TRUTH_3NODE_SEED0,
             goldens.GROUND_TRUTH_3NODE_SEED0_TELEMETRY, (6, 64))):
        kernels.reset_launch_counts()
        run = entry(seed=0, telemetry=True, device=dev, return_state=True)
        tel_launches[label] = _path_launches(
            kernels, uniform_rows + dense_trace, f"{label}_telemetry", True)
        _storm_check(run, golden, f"{label}_telemetry")
        f32_gaps[label] = _telemetry_check(run, tel_golden, *m,
                                           f"{label}_telemetry")

    # the bench's telemetry rung: the per-round cost of the recorder
    rung = config_fault_storm_telemetry(seed=0, device=dev)
    summary = {k: v for k, v in rung["telemetry"].items()
               if k != "wire_bytes"}
    if (summary != goldens.FAULT_STORM_100K_SEED0_TELEMETRY["summary"]
            or rung["rounds"] != goldens.FAULT_STORM_100K_SEED0["rounds"]
            or not rung["converged"]):
        raise AssertionError("config_fault_storm_telemetry: its run is not "
                             "the golden fault storm")
    print(f"config_fault_storm_telemetry: {json.dumps(rung)} card={card}",
          flush=True)

    _lap("path 8, the flight recorder")
    # path 9, latency-storm-100k: the fault storm with a delay and a
    # jitter over the first sixth, from zeroed counters, without and
    # with the recorder.  K9's wire and session calls take its latency
    # entry, K10 its jitter stream in rounds 2-15 (its loss streams
    # alone in rounds 0-1, K2 from round 16), K3 its delay entry.
    latency_rows = ["sample_targets", "broadcast_scatter", "merge_entries",
                    "threefry", "gaps_refresh", "converge_fold",
                    "word_phases", "broadcast_scatter_lossy", "node_faults",
                    "fault_edges_delay", "broadcast_scatter_jitter",
                    "sync_masks", "sync_pull_delay"]
    cfg, meta, fplan = _latency_storm(STORM_N, dev)
    latency_launches = {}
    for tel in (False, True):
        label = "latency_storm_100k" + ("_telemetry" if tel else "")
        state = new_sim(cfg, 0, dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = faults.run_fault_plan(state, meta, cfg, Topology(), fplan,
                                    max_rounds=3000, telemetry=tel)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        latency_launches[tel] = _path_launches(
            kernels, latency_rows + (packed_trace if tel else []), label, tel)
        if kernels.FAULT_REACH.launches <= 0:
            raise AssertionError(f"fault_reach never launched on {label}")
        run = _fault_record(out[0], out[1], wall)
        _storm_check(run, goldens.LATENCY_STORM_100K_SEED0, label)
        if not tel:
            packed_latency = out
        if tel:
            run["trace"] = out[2]
            run["telemetry"] = trace_summary(
                trace_host(out[2], run["rounds"]), run["rounds"], cfg)
            f32_gaps["latency_storm_100k"] = _telemetry_check(
                run, goldens.LATENCY_STORM_100K_SEED0_TELEMETRY, 300_000,
                512, label)
    print("latency_storm_100k launches per round: " + json.dumps({
        row: latency_launches[False][row] / goldens.LATENCY_STORM_100K_SEED0[
            "rounds"] for row in latency_rows}), flush=True)
    _lap("path 9, the latency storm")

    # path 10, dense-fault-storm-100k: the fault storm on the dense round
    # (JAX's allow_packed=False) from zeroed counters, without and with
    # the recorder: partial-view SWIM (K1, K4), K5, K9, K11's dense
    # entry, K12 and its fault entry (the loss window), K13, K14's exit
    # mode; its golden, and JAX's dense == packed contract against path
    # 2's packed run on this card
    dense_fault_rows = ["sample_targets", "merge_entries", "threefry",
                        "fault_edges", "dense_phases", "dense_sync",
                        "node_faults_dense", "dense_broadcast_fault",
                        "dense_gaps_exit"]
    cfg, meta, fplan = _dense_fault_storm(STORM_N, dev)
    dense_fault_launches = {}
    for tel in (False, True):
        label = "dense_fault_storm_100k" + ("_telemetry" if tel else "")
        out = _timed_fault_run(cfg, meta, fplan, 0, dev, tel)
        dense_fault_launches[tel] = _path_launches(
            kernels, dense_fault_rows + (dense_trace if tel else []), label,
            tel)
        _storm_check(out["run"], goldens.DENSE_FAULT_STORM_100K_SEED0, label)
        _same_as_packed(out["out"], packed_fault, label)
        if tel:
            run = out["run"]
            run["trace"] = out["out"][2]
            run["telemetry"] = trace_summary(
                trace_host(run["trace"], run["rounds"]), run["rounds"], cfg)
            f32_gaps["dense_fault_storm_100k"] = _telemetry_check(
                run, goldens.DENSE_FAULT_STORM_100K_SEED0_TELEMETRY, 300_000,
                512, label)
    _per_round(dense_fault_launches[False], dense_fault_rows,
               goldens.DENSE_FAULT_STORM_100K_SEED0["rounds"],
               "dense_fault_storm_100k")
    print("f32_worst_relative_gap: " + json.dumps(f32_gaps), flush=True)
    _lap("path 10, the dense fault storm")

    # path 11, dense-latency-storm-100k: the latency storm on the dense
    # round — K9's latency entry, K12's fault entry with the jitter draw,
    # K13's delay entry every round — against the packed run of path 9
    dense_latency_rows = ["sample_targets", "merge_entries", "threefry",
                          "fault_edges_delay", "dense_phases",
                          "dense_sync_delay", "node_faults_dense",
                          "dense_broadcast_fault", "dense_gaps_exit"]
    cfg, meta, fplan = _dense_latency_storm(STORM_N, dev)
    out = _timed_fault_run(cfg, meta, fplan, 0, dev)
    dense_latency_launches = _path_launches(
        kernels, dense_latency_rows, "dense_latency_storm_100k")
    if kernels.FAULT_REACH.launches <= 0:
        raise AssertionError("fault_reach never launched on "
                             "dense_latency_storm_100k")
    _storm_check(out["run"], goldens.DENSE_LATENCY_STORM_100K_SEED0,
                 "dense_latency_storm_100k")
    _same_as_packed(out["out"], packed_latency, "dense_latency_storm_100k")
    _per_round(dense_latency_launches, dense_latency_rows,
               goldens.DENSE_LATENCY_STORM_100K_SEED0["rounds"],
               "dense_latency_storm_100k")

    # path 12, full-view-fault-storm-4096: JAX's 4096-node acceptance
    # storm on full-view SWIM (K1's uniform entry, K15 with K9's reach on
    # every probe leg, K11's view wipe) and the dense round
    fv_rows = ["sample_uniform", "threefry", "fault_edges", "dense_phases",
               "dense_sync", "swim_full", "node_faults_dense",
               "dense_broadcast_fault", "dense_gaps_exit"]
    cfg, meta, fplan = _full_view_storm(dev)
    out = _timed_fault_run(cfg, meta, fplan, 7, dev)
    fv_launches = _path_launches(kernels, fv_rows,
                                 "full_view_fault_storm_4096")
    _storm_check(out["run"], goldens.FULL_VIEW_FAULT_STORM_4096_SEED7,
                 "full_view_fault_storm_4096")
    _lap("paths 11-12, the dense latency storm and the full view")

    # path 13, fault-storm-1000: the fault storm where JAX's compile_plan
    # picks the matrix form, alone through run_fault_plan from zeroed
    # counters — the dense round with partial-view SWIM, K9m for every
    # edge query (K9's factored entries never launch) — then through its
    # entry point, config_packed_fault_storm(n_nodes=1000)
    matrix_rows = ["fault_edges_matrix", "fault_reach_matrix"]
    factored_k9 = ["fault_edges", "fault_edges_delay"]
    fs1000_rows = ["sample_targets", "merge_entries", "threefry",
                   "dense_phases", "dense_sync", "node_faults_dense",
                   "dense_broadcast_fault", "dense_gaps_exit", *matrix_rows]

    def no_factored_k9(label):
        on = [k.name for row in factored_k9 for k in kernels.PORTED[row]
              if k.launches]
        if on:
            raise AssertionError(f"{label}: factored K9 entries {on} "
                                 "launched on a matrix plan")

    cfg, meta, fplan, compile_s = _matrix_storm(MATRIX_N, dev)
    print(f"fault_storm_1000: matrix plan {tuple(fplan.block.shape)} cut and "
          f"loss (delay {fplan.delay}, jitter {fplan.jitter}), host compile "
          f"{compile_s * 1e3:.1f} ms card={card}", flush=True)
    out = _timed_fault_run(cfg, meta, fplan, 0, dev)
    fs1000_launches = _path_launches(kernels, fs1000_rows, "fault_storm_1000")
    no_factored_k9("fault_storm_1000")
    _storm_check(out["run"], goldens.FAULT_STORM_1000_SEED0,
                 "fault_storm_1000")
    _per_round(fs1000_launches, fs1000_rows,
               goldens.FAULT_STORM_1000_SEED0["rounds"], "fault_storm_1000")
    entry = config_packed_fault_storm(seed=0, n_nodes=MATRIX_N, device=dev,
                                      return_state=True)
    _storm_check(entry, goldens.FAULT_STORM_1000_SEED0,
                 "config_packed_fault_storm_1000")
    print("config_packed_fault_storm_1000: " + json.dumps({
        k: v for k, v in entry.items() if k not in ("state", "metrics")}),
        flush=True)

    # path 14, the 3-node fault campaign (demo_plan(seed=0), the matrix
    # plan) on the card: run_fault_plan, then the checked driver with the
    # sim invariants, each from zeroed counters, against JAX's goldens
    from corrosion_tpu_torch.faults import demo_plan
    from corrosion_tpu_torch.invariants import Catalog
    from corrosion_tpu_torch.sim.state import SimConfig, uniform_payloads

    camp_cfg = SimConfig(n_nodes=3, n_payloads=16, fanout=2,
                         sync_interval_rounds=4, n_delay_slots=4)
    camp_meta = uniform_payloads(camp_cfg, dev, inject_every=1)
    camp_plan = faults.compile_plan(demo_plan(seed=0), camp_cfg, device=dev)
    if not isinstance(camp_plan, faults.SimFaultPlan):
        raise AssertionError("the 3-node campaign did not compile the matrix "
                             "plan")
    campaign_rows = ["sample_uniform", "threefry", "node_faults_dense",
                     "dense_broadcast_fault", "dense_sync_delay",
                     "fault_edges_matrix"]
    out = _timed_fault_run(camp_cfg, camp_meta, camp_plan, 0, dev)
    campaign_launches = _path_launches(
        kernels, campaign_rows + ["dense_gaps_exit"], "fault_campaign_3node")
    no_factored_k9("fault_campaign_3node")
    _storm_check(out["run"], goldens.FAULT_CAMPAIGN_3NODE_SEED0,
                 "fault_campaign_3node")
    catalog = Catalog()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, _, digests = faults.run_fault_plan_checked(
        demo_plan(seed=0), new_sim(camp_cfg, 0, dev), camp_meta, camp_cfg,
        max_rounds=400, catalog=catalog)
    checked_wall = time.monotonic() - t0
    checked_launches = _path_launches(
        kernels, campaign_rows + ["dense_gaps"], "fault_campaign_3node_checked")
    no_factored_k9("fault_campaign_3node_checked")
    listed = hashlib.blake2b(digest_size=8)
    for d in digests:
        listed.update(d.encode())
    got = {"n_digests": len(digests), "last_digest": digests[-1],
           "digest_list": listed.hexdigest()}
    print(f"fault_campaign_3node_checked: {json.dumps(got)} markers="
          f"{json.dumps(catalog.report())} wall_clock_s={checked_wall:.3f}",
          flush=True)
    if got != goldens.FAULT_CAMPAIGN_3NODE_SEED0_CHECKED:
        raise AssertionError("fault_campaign_3node_checked: digests != golden")
    if state_digest(final) != goldens.FAULT_CAMPAIGN_3NODE_SEED0["digest"]:
        raise AssertionError("fault_campaign_3node_checked: final state")
    if catalog.unfired_sometimes() or sorted(catalog.report()) != \
            demo_plan().coverage_markers():
        raise AssertionError("fault_campaign_3node_checked: markers")

    # path 15, full-view-fault-storm-4096 on the forced matrix form
    # (factored=False: 22 × 4096² cut and loss slabs on the card): path
    # 12's storm and golden, K9m in place of K9
    fvm_rows = [row for row in fv_rows if row != "fault_edges"] + matrix_rows
    cfg, meta, fplan, compile_s = _matrix_storm(
        4096, dev, plan_seed=3, swim_partial_view=False, swim_full_view=True,
        allow_packed=False)
    print(f"full_view_fault_storm_4096_matrix: plan "
          f"{tuple(fplan.block.shape)}, "
          f"{(fplan.block.numel() + fplan.loss.numel()) / 2**20:.0f} MiB, "
          f"host compile {compile_s * 1e3:.1f} ms", flush=True)
    out = _timed_fault_run(cfg, meta, fplan, 7, dev)
    fvm_launches = _path_launches(kernels, fvm_rows,
                                  "full_view_fault_storm_4096_matrix")
    no_factored_k9("full_view_fault_storm_4096_matrix")
    _storm_check(out["run"], goldens.FULL_VIEW_FAULT_STORM_4096_SEED7,
                 "full_view_fault_storm_4096_matrix")
    del fplan, out

    # path 16, a packed run on a matrix plan: the 4096-node fault storm
    # inside the packed envelope (packed_min_cells=0), forced matrix, then
    # the same run on the factored plan; equal to each other and to the
    # golden (live JAX)
    packed_rows = ["sample_targets", "sync_masks", "sync_pull",
                   "merge_entries", "threefry", "gaps_refresh",
                   "converge_fold", "word_phases",
                   "broadcast_scatter_lossy", "node_faults", *matrix_rows]
    cfg, meta, fplan, _ = _matrix_storm(4096, dev, packed_min_cells=0)
    out = _timed_fault_run(cfg, meta, fplan, 0, dev)
    pm_launches = _path_launches(kernels, packed_rows,
                                 "packed_fault_storm_4096_matrix")
    no_factored_k9("packed_fault_storm_4096_matrix")
    _storm_check(out["run"], goldens.PACKED_FAULT_STORM_4096_SEED0,
                 "packed_fault_storm_4096_matrix")
    del fplan
    fac = faults.compile_plan(storm_fault_plan(4096, 0), cfg, factored=True,
                              device=dev)
    twin = _timed_fault_run(cfg, meta, fac, 0, dev)
    _storm_check(twin["run"], goldens.PACKED_FAULT_STORM_4096_SEED0,
                 "packed_fault_storm_4096_factored")
    if state_digest(twin["out"][0]) != state_digest(out["out"][0]) or any(
            not torch.equal(a, b) for a, b in zip(twin["out"][1],
                                                   out["out"][1])):
        raise AssertionError("packed_fault_storm_4096: matrix != factored")
    print("packed_fault_storm_4096: the matrix run's state and metrics "
          "equal the factored run's", flush=True)
    _lap("paths 13-16, the matrix plans")

    # paths 17-21, the topology axis, each from zeroed counters through
    # its entry point.  The geo-tiered storms draw every round's wire loss
    # through K10's tiered instantiation (K2 and K10's flat entry stay off
    # the path), their slots through K20's edge entry and their probes'
    # loss through K20's reach entry; hetero-degree caps its targets
    # through K20's caps entry; under PeerSwap every target comes from K1's
    # view entry and the view swaps through K21 (ground-truth membership:
    # no member table, K1's table entry and K4 stay off)
    storm_core = ["sync_masks", "sync_pull", "threefry", "gaps_refresh",
                  "converge_fold", "word_phases"]
    tiered_rows = ["sample_targets", "merge_entries", *storm_core,
                   "broadcast_scatter_tiered", "edge_slots", "edge_reach"]
    topo_paths = (
        ("storm_wan_3x2_100k", dict(topo_family="wan-3x2"), tiered_rows,
         goldens.STORM_WAN_3X2_100K_SEED0),
        ("storm_wan_fly_6r_100k", dict(topo_family="wan-fly-6r"),
         tiered_rows, goldens.STORM_WAN_FLY_6R_100K_SEED0),
        ("storm_hetero_degree_100k", dict(topo_family="hetero-degree"),
         ["sample_targets", "merge_entries", "broadcast_scatter", *storm_core,
          "degree_caps"], goldens.STORM_HETERO_DEGREE_100K_SEED0),
        ("storm_peerswap_25600", dict(n_nodes=PEERSWAP_N, sampler="peerswap"),
         ["sample_view", "peerswap", "broadcast_scatter", *storm_core],
         goldens.STORM_PEERSWAP_25600_SEED0),
    )
    topo_launches = {}
    for label, kw, path_rows, golden in topo_paths:
        kernels.reset_launch_counts()
        run = config_write_storm_100k(seed=0, device=dev, return_state=True,
                                      **kw)
        topo_launches[label] = _path_launches(kernels, path_rows, label)
        if run["round_path"] != "packed":
            raise AssertionError(f"{label} did not take the packed round")
        _storm_check(run, golden, label)
        _per_round(topo_launches[label], path_rows, run["rounds"], label)
    off = {"storm_wan_3x2_100k": ["broadcast_scatter",
                                  "broadcast_scatter_lossy"],
           "storm_peerswap_25600": ["sample_targets", "merge_entries"]}
    for label, rows_off in off.items():
        on = [row for row in rows_off if topo_launches[label][row]]
        if on:
            raise AssertionError(f"{label}: {on} launched off its path")

    # the 100k fault storm over wan-3x2: K10's tiered instantiation with
    # the fault stream, K9's edges and reach beside K20's, K11
    topo = _resolve_topo("wan-3x2")
    cfg, meta = _write_storm(STORM_N, 512, dev, topo)
    fplan = faults.compile_plan(storm_fault_plan(STORM_N, 0), cfg, topo,
                                device=dev)
    out = _timed_fault_run(cfg, meta, fplan, 0, dev, topo=topo)
    label = "fault_storm_wan_3x2_100k"
    topo_launches[label] = _path_launches(
        kernels, tiered_rows + ["fault_edges", "node_faults"], label)
    _storm_check(out["run"], goldens.FAULT_STORM_WAN_3X2_100K_SEED0, label)
    _per_round(topo_launches[label], tiered_rows, out["run"]["rounds"],
               label)

    # the headline tiered storm with the flight recorder: the dropped
    # frames come from the tiered stream (K10's tiered instantiation's
    # count)
    packed_trace_rows = ["trace_counts", "trace_wire", "trace_row"]
    kernels.reset_launch_counts()
    run = config_write_storm_100k(seed=0, topo_family="wan-3x2",
                                  telemetry=True, device=dev,
                                  return_state=True)
    topo_launches["storm_wan_3x2_100k_telemetry"] = _path_launches(
        kernels, tiered_rows + packed_trace_rows,
        "storm_wan_3x2_100k_telemetry", True)
    _storm_check(run, goldens.STORM_WAN_3X2_100K_SEED0,
                 "storm_wan_3x2_100k_telemetry")
    f32_gaps["storm_wan_3x2_100k"] = _telemetry_check(
        run, goldens.STORM_WAN_3X2_100K_SEED0_TELEMETRY, 300_000, 512,
        "storm_wan_3x2_100k_telemetry")

    # path 21, broadcast-1k on wan-3x2 under PeerSwap: the dense round
    # (K12's tiered instantiation with its inject and deliver, K13, K14),
    # K20's slots and the swap tick's reach, K1's view entry and K21
    b1k_rows = ["sample_view", "peerswap", "threefry", "dense_sync",
                "dense_gaps", "dense_broadcast_tiered", "edge_slots",
                "edge_reach"]
    kernels.reset_launch_counts()
    run = config_broadcast_1k(seed=0, topo_family="wan-3x2",
                              sampler="peerswap", device=dev,
                              return_state=True)
    topo_launches["broadcast_1k_wan_3x2_peerswap"] = _path_launches(
        kernels, b1k_rows, "broadcast_1k_wan_3x2_peerswap")
    for kern in (kernels.DENSE_INJECT, kernels.DENSE_DELIVER):
        if kern.launches <= 0:
            raise AssertionError(f"{kern.name} never launched on "
                                 "broadcast_1k_wan_3x2_peerswap")
    if run["round_path"] != "dense":
        raise AssertionError("broadcast_1k_wan_3x2_peerswap did not take the "
                             "dense round")
    _storm_check(run, goldens.BROADCAST_1K_WAN_3X2_PEERSWAP_SEED0,
                 "broadcast_1k_wan_3x2_peerswap")
    print("f32_worst_relative_gap: " + json.dumps(f32_gaps), flush=True)
    _lap("paths 17-21, the topology axis")

    # paths 22-27, the protocol axis, each from zeroed counters through
    # its entry point, held against live JAX's goldens with the run's
    # RunMetrics order_violations
    proto_launches = {}

    def proto_check(result, golden, label, meta=None):
        """`_storm_check` with the run's order_violations (and, for a run
        without a record, its p99 payload latency from ``meta``)."""
        from corrosion_tpu_torch.sim.runner import _percentile

        result = dict(result)
        m = result["metrics"]
        result["order_violations"] = int(m.order_violations)
        if meta is not None:
            cov = m.coverage_at.cpu().numpy()
            lat = np.where(cov >= 0, cov - meta.round.cpu().numpy(), -1)
            result["p99_payload_latency_rounds"] = _percentile(lat, 99)
        _storm_check(result, golden, label)

    no_deliver = [row for row in faultless_rows if row != "word_phases"]
    storm_protos = (
        ("storm_baseline_100k", "baseline", faultless_rows,
         goldens.STORM_BASELINE_100K_SEED0),
        ("storm_swarm_aggressive_100k", "swarm-aggressive", faultless_rows,
         goldens.STORM_SWARM_AGGRESSIVE_100K_SEED0),
        ("storm_push_pull_100k", "push-pull",
         faultless_rows + ["broadcast_pull"],
         goldens.STORM_PUSH_PULL_100K_SEED0),
        ("storm_fanout_decay_100k", "fanout-decay",
         faultless_rows + ["degree_caps_sched"],
         goldens.STORM_FANOUT_DECAY_100K_SEED0),
        ("storm_lab_ordered_100k", "lab-ordered",
         no_deliver + ["word_deliver_fifo", "order_check_words"],
         goldens.STORM_LAB_ORDERED_100K_SEED0),
        ("storm_lab_ordered_broken_100k", "lab-ordered-broken",
         faultless_rows + ["order_check_words"],
         goldens.STORM_LAB_ORDERED_BROKEN_100K_SEED0),
    )
    proto_rows = {"broadcast_pull", "broadcast_pull_lossy",
                  "broadcast_pull_tiered", "degree_caps_sched",
                  "word_deliver_fifo", "order_check_words"}
    for label, family, path_rows, golden in storm_protos:
        kernels.reset_launch_counts()
        run = config_write_storm_100k(seed=0, proto_family=family, device=dev,
                                      return_state=True)
        proto_launches[label] = _path_launches(kernels, path_rows, label)
        if family == "lab-ordered":
            # K8's inject and spend run; its deliver gives way to K8f
            if not (kernels.WORD_INJECT.launches
                    and kernels.WORD_SPEND.launches
                    and kernels.WORD_DELIVER.launches == 0):
                raise AssertionError(f"{label}: K8's entries off their path")
        proto_check(run, golden, label)
        _per_round(proto_launches[label], path_rows, run["rounds"], label)
        on = [row for row in proto_rows - set(path_rows)
              if proto_launches[label][row]]
        if on:
            raise AssertionError(f"{label}: {on} launched off its path")
    if proto_launches["storm_baseline_100k"] != launches:
        raise AssertionError("storm_baseline_100k: launches differ from the "
                             "storm's")

    # the fault storm under push-pull: the pull's loss streams in the loss
    # window (K10p lossy), its loss-free form after, the refusals across
    # the half split (K9's session entry)
    cfg, meta = _write_storm(100_000, 512, dev, proto_family="push-pull")
    fplan = faults.compile_plan(storm_fault_plan(100_000, 0), cfg,
                                device=dev)
    out = _timed_fault_run(cfg, meta, fplan, 0, dev)
    label = "fault_storm_push_pull_100k"
    proto_launches[label] = _path_launches(
        kernels, [row for row in faultless_rows if row != "broadcast_scatter"]
        + ["fault_edges", "broadcast_scatter_lossy", "node_faults",
           "broadcast_pull", "broadcast_pull_lossy"], label)
    out["run"]["metrics"] = out["out"][1]
    proto_check(out["run"], goldens.FAULT_STORM_PUSH_PULL_100K_SEED0, label,
                meta)

    # the headline tiered storm under push-pull with the recorder: K10p's
    # tiered form, the pull's frames and bytes (K18's pull entry), the
    # dropped frames of both legs
    label = "storm_wan_3x2_push_pull_100k_telemetry"
    kernels.reset_launch_counts()
    run = config_write_storm_100k(seed=0, topo_family="wan-3x2",
                                  proto_family="push-pull", telemetry=True,
                                  device=dev, return_state=True)
    proto_launches[label] = _path_launches(
        kernels, tiered_rows + packed_trace_rows
        + ["broadcast_pull_tiered", "trace_wire_pull"], label, True)
    proto_check(run, goldens.STORM_WAN_3X2_PUSH_PULL_100K_SEED0, label)
    # (N·F + 1)·2⁻²⁴·S: JAX adds the push's and the pull's f32 sums of
    # N·F terms each, then the two
    f32_gaps["storm_wan_3x2_push_pull_100k"] = _telemetry_check(
        run, goldens.STORM_WAN_3X2_PUSH_PULL_100K_SEED0_TELEMETRY, 300_000,
        512, label)

    # broadcast-1k on the dense round: K12p's three forms, K12f-o, K22's
    # u8 entry, K18's rows pull entry
    dense_core = ["sample_uniform", "threefry", "dense_sync", "dense_gaps"]
    b1k_protos = (
        ("broadcast_1k_push_pull", dict(proto_family="push-pull"),
         uniform_rows + ["dense_pull"], goldens.BROADCAST_1K_PUSH_PULL_SEED0),
        ("broadcast_1k_push_pull_flat_lossy",
         dict(proto_family="push-pull", topo_family="flat-lossy"),
         uniform_rows + ["dense_pull_lossy"],
         goldens.BROADCAST_1K_PUSH_PULL_FLAT_LOSSY_SEED0),
        ("broadcast_1k_push_pull_wan_3x2",
         dict(proto_family="push-pull", topo_family="wan-3x2"),
         dense_core + ["dense_broadcast_tiered", "edge_slots",
                       "dense_pull_tiered"],
         goldens.BROADCAST_1K_PUSH_PULL_WAN_3X2_SEED0),
        ("broadcast_1k_lab_ordered", dict(proto_family="lab-ordered"),
         dense_core + ["dense_deliver_fifo", "order_check_dense"],
         goldens.BROADCAST_1K_LAB_ORDERED_SEED0),
        ("broadcast_1k_lab_ordered_broken",
         dict(proto_family="lab-ordered-broken"),
         uniform_rows + ["order_check_dense"],
         goldens.BROADCAST_1K_LAB_ORDERED_BROKEN_SEED0),
    )
    for label, kw, path_rows, golden in b1k_protos:
        kernels.reset_launch_counts()
        run = config_broadcast_1k(seed=0, device=dev, return_state=True, **kw)
        proto_launches[label] = _path_launches(kernels, path_rows, label)
        if run["round_path"] != "dense":
            raise AssertionError(f"{label} did not take the dense round")
        # the dense phases' entries the rows above leave out: under FIFO
        # K12f-o delivers, under tiers K12's tiered instantiation sends
        fifo = kw["proto_family"] == "lab-ordered"
        for kern in (kernels.DENSE_INJECT,
                     kernels.DENSE_BROADCAST if fifo
                     else kernels.DENSE_DELIVER):
            if kern.launches <= 0:
                raise AssertionError(f"{kern.name} never launched on {label}")
        if fifo and kernels.DENSE_DELIVER.launches:
            raise AssertionError(f"{label}: K12's deliver ran under FIFO")
        proto_check(run, golden, label)
    label = "broadcast_1k_push_pull_telemetry"
    kernels.reset_launch_counts()
    run = config_broadcast_1k(seed=0, proto_family="push-pull",
                              telemetry=True, device=dev, return_state=True)
    proto_launches[label] = _path_launches(
        kernels, uniform_rows + dense_trace
        + ["dense_pull", "trace_wire_rows_pull"], label, True)
    proto_check(run, goldens.BROADCAST_1K_PUSH_PULL_SEED0, label)
    f32_gaps["broadcast_1k_push_pull"] = _telemetry_check(
        run, goldens.BROADCAST_1K_PUSH_PULL_SEED0_TELEMETRY, 3000, 256, label)
    print("f32_worst_relative_gap: " + json.dumps(f32_gaps), flush=True)
    _lap("paths 22-27, the protocol axis")

    # paths 28-32, membership churn, each from zeroed counters through its
    # entry point: the detect loops (K23 once a round, its full entry on
    # full view, its partial entry on partial view) and the flash-crowd
    # cold joins through run_fault_plan (K11, with the PeerSwap view row
    # under the sampler)
    churn_launches = {}
    full_churn_rows = [*uniform_rows, "swim_full", "detect_full"]
    partial_churn_rows = ["sample_targets", "merge_entries", "threefry",
                          *dense_rows, "detect_partial"]

    def churn_path(label, run, path_rows, golden, telemetry=False):
        """A detect run's launches (its K23 entry once a round; the other
        entry never, `_path_launches`) and record against its golden; a
        config's record also against JAX's engine keys."""
        churn_launches[label] = _path_launches(kernels, path_rows, label,
                                               telemetry)
        golden = dict(golden,
                      **goldens.CHURN_CONFIG_ENGINE_KEYS.get(label, {}))
        rounds = int(run["state"].t)
        entry = next(row for row in DETECT_ROWS if row in path_rows)
        if churn_launches[label][entry] != rounds:
            raise AssertionError(f"{label}: {entry} launched "
                                 f"{churn_launches[label][entry]} times in "
                                 f"{rounds} rounds")
        detect_check(run, golden, label)
        _per_round(churn_launches[label], path_rows, rounds, label)

    def detect_check(run, golden, label):
        """Every golden key, the digest from the final state; a run that
        must not detect (``converged`` False in the golden) is held to
        that instead of `_storm_check`'s convergence."""
        got = {key: state_digest(run["state"]) if key == "digest"
               else run[key] for key in golden}
        print(f"{label}: {json.dumps(got)} wall_clock_s="
              f"{run['wall_clock_s']:.3f}", flush=True)
        for key, want in golden.items():
            if got[key] != want:
                raise AssertionError(f"{label}: {key} {got[key]!r} != "
                                     f"golden {want!r}")

    # configs #2/#2b run through the campaign engine as JAX's do: one
    # lane of the detect loop (K23's lane entries), with the engine's
    # spec_hash and result_digest; the solo detect loop of the same run
    # keeps K23's solo entries on a path
    lane_full_rows = list(DENSE_LANE_ROWS["full"])
    lane_partial_rows = list(DENSE_LANE_ROWS["partial"])
    kernels.reset_launch_counts()
    run = config_swim_churn_64(seed=0, device=dev, return_state=True)
    churn_path("swim_churn_64", run, lane_full_rows,
               goldens.SWIM_CHURN_64_SEED0)
    kernels.reset_launch_counts()
    run = membership_churn(CHURN_N, seed=0, device=dev, return_state=True)
    churn_path("membership_churn_4096", run, lane_full_rows,
               goldens.CHURN_FULL_4096_SEED0)
    cfg64 = SimConfig.wan_tuned(64, n_payloads=1, swim_full_view=True)
    meta64, state64 = churn_setup(cfg64, 0, dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final64, _, det64 = run_membership_detect(state64, meta64, cfg64,
                                              Topology(), 400, device=dev)
    torch.cuda.synchronize()
    churn_path("swim_churn_64_solo",
               {"state": final64, "detect_round": int(det64),
                "wall_clock_s": time.monotonic() - t0}, full_churn_rows,
               {key: goldens.SWIM_CHURN_64_SEED0[key]
                for key in ("detect_round", "digest")})
    kernels.reset_launch_counts()
    run = config_swim_churn_partial(seed=0, device=dev, return_state=True)
    churn_path("swim_churn_partial_4096", run, lane_partial_rows,
               goldens.SWIM_CHURN_PARTIAL_4096_SEED0)
    # the same run with the recorder, through run_membership_detect: its
    # telemetry golden, the whole trace held by its digest
    cfg = SimConfig.wan_tuned(CHURN_N, n_payloads=1, swim_partial_view=True,
                              probe_period_rounds=1)
    meta, state = churn_setup(cfg, 0, dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, _, detect, trace = run_membership_detect(
        state, meta, cfg, Topology(), 600, telemetry=True, device=dev)
    torch.cuda.synchronize()
    label = "swim_churn_partial_4096_telemetry"
    rounds = int(final.t)
    churn_path(label, {"state": final, "detect_round": int(detect),
                       "wall_clock_s": time.monotonic() - t0},
               partial_churn_rows + dense_trace,
               {key: goldens.SWIM_CHURN_PARTIAL_4096_SEED0[key]
                for key in ("detect_round", "digest")},
               telemetry=True)
    golden = goldens.SWIM_CHURN_PARTIAL_4096_SEED0_TELEMETRY
    got = {"summary": trace_summary(trace, rounds, cfg),
           "trace_digest": trace_digest(trace, rounds)}
    if got != golden:
        raise AssertionError(f"{label}: {got} != golden {golden}")
    print(f"{label}: telemetry {json.dumps(got)}", flush=True)
    kernels.reset_launch_counts()
    run = config_swim_churn_partial(seed=0, n=STORM_N, device=dev,
                                    return_state=True)
    churn_path("swim_churn_partial_100k", run, lane_partial_rows,
               goldens.SWIM_CHURN_PARTIAL_100K_SEED0)
    cfg = SimConfig.wan_tuned(STORM_N, n_payloads=1, swim_partial_view=True,
                              probe_period_rounds=1)
    meta, state = churn_setup(cfg, 0, dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    final, _, detect = run_membership_detect(state, meta, cfg, Topology(),
                                             600, device=dev)
    torch.cuda.synchronize()
    churn_path("swim_churn_partial_100k_solo",
               {"state": final, "detect_round": int(detect),
                "wall_clock_s": time.monotonic() - t0}, partial_churn_rows,
               {key: goldens.SWIM_CHURN_PARTIAL_100K_SEED0[key]
                for key in ("detect_round", "digest")})

    # the flash crowd on the 100k write storm: the tail quarter down over
    # rounds 0-7, back wiped at round 8 (K11's word entry); no link
    # faults, so every round scatters through K2
    cfg, meta = _write_storm(STORM_N, 512, dev)
    out = _timed_fault_run(cfg, meta, _flash_plan(STORM_N, cfg, dev), 0, dev)
    label = "flash_crowd_storm_100k"
    churn_launches[label] = _path_launches(
        kernels, faultless_rows + ["node_faults"], label)
    _storm_check(out["run"], goldens.FLASH_CROWD_STORM_100K_SEED0, label)
    # storm-peerswap-25.6k under a flash crowd: the joiners' views are
    # emptied (K11's view row) and refilled through the swaps (K21)
    cfg, meta = _write_storm(PEERSWAP_N, 512, dev, sampler="peerswap")
    out = _timed_fault_run(cfg, meta, _flash_plan(PEERSWAP_N, cfg, dev), 0,
                           dev)
    label = "flash_crowd_peerswap_25600"
    churn_launches[label] = _path_launches(
        kernels, ["sample_view", "peerswap", "broadcast_scatter", *storm_core,
                  "node_faults"], label)
    _storm_check(out["run"], goldens.FLASH_CROWD_PEERSWAP_25600_SEED0, label)
    _lap("paths 28-32, membership churn")

    # paths 33-35: the seed ensembles through the campaign engine, and
    # one lane against the solo storm
    lane_launches, lane_numbers = ensemble_paths(dev, goldens)
    lane_one_check(dev)
    print("ensemble numbers: " + json.dumps(lane_numbers), flush=True)
    _lap("paths 33-35, the seed ensembles")
    # paths 36-40: the dense round's and the detect loop's ensembles
    dense_lane_launches, dense_lane_numbers = dense_ensemble_paths(dev,
                                                                   goldens)
    print("dense ensemble numbers: " + json.dumps(dense_lane_numbers),
          flush=True)
    _lap("paths 36-40, the dense ensembles")
    # paths 41-45: the dense round's fault ensembles
    dense_fault_lane_launches, dense_fault_lane_numbers = \
        dense_fault_ensemble_paths(dev, goldens)
    print("dense fault ensemble numbers: " + json.dumps(
        dense_fault_lane_numbers), flush=True)
    _lap("paths 41-45, the dense fault ensembles")
    # paths 46-50: the flight recorder on the dense round's lanes; the
    # per-lane flight-recorder JSONL goes under flight_recorder_out/
    # (gitignored)
    trace_lane_launches, trace_lane_numbers = trace_ensemble_paths(
        dev, goldens, "flight_recorder_out")
    print("recording ensemble numbers: " + json.dumps(trace_lane_numbers),
          flush=True)
    _lap("paths 46-50, the recorder on the dense lanes")
    # paths 51-54: topology families and PeerSwap on the dense lanes
    topo_lane_launches, topo_lane_numbers = topology_ensemble_paths(dev,
                                                                    goldens)
    print("topology ensemble numbers: " + json.dumps(topo_lane_numbers),
          flush=True)
    _lap("paths 51-54, topology families and PeerSwap on the dense lanes")
    # paths 55-59: the protocol variants and PeerSwap under a fault plan on
    # the dense lanes
    proto_lane_launches, proto_lane_numbers = protocol_ensemble_paths(
        dev, goldens)
    print("protocol ensemble numbers: " + json.dumps(proto_lane_numbers),
          flush=True)
    _lap("paths 55-59, the protocol variants on the dense lanes")
    # paths 60-62: latency plans and the flight recorder on the packed
    # round's lanes; path 62's per-lane JSONL goes under
    # flight_recorder_out/ (gitignored)
    packed_lane_launches, packed_lane_numbers = \
        packed_latency_ensemble_paths(
            dev, goldens, "flight_recorder_out", dense_fault_lane_numbers[
                "dense_latency_storm_100k_seeds8"]["ensemble_wall_s"])
    print("packed lane ensemble numbers: " + json.dumps(packed_lane_numbers),
          flush=True)
    _lap("paths 60-62, latency plans and the recorder on the packed lanes")
    # paths 63-66: metered budgets, the topology families and PeerSwap on
    # the packed round's lanes
    axis_lane_launches, axis_lane_numbers = packed_axis_ensemble_paths(
        dev, goldens)
    print("packed axis ensemble numbers: " + json.dumps(axis_lane_numbers),
          flush=True)
    _lap("paths 63-66, budgets, topology and PeerSwap on the packed lanes")
    # paths 67-68: the protocol variants on the packed round's lanes
    proto_packed_launches, proto_packed_numbers = \
        packed_proto_ensemble_paths(dev, goldens)
    print("packed protocol ensemble numbers: "
          + json.dumps(proto_packed_numbers), flush=True)
    _lap("paths 67-68, the protocol variants on the packed lanes")
    # path 70: a matrix plan on the packed round's lanes
    matrix_lane_launches = packed_matrix_path(dev, goldens)
    _lap("path 70, a matrix plan on the packed lanes")

    for prof in storm_profiles:
        print("profile: " + json.dumps(prof), flush=True)
    # the whole loss window, where most nodes send and K10 draws most
    print("profile: " + json.dumps(profile_storm(dev, 12, faults=True)),
          flush=True)
    print("profile: " + json.dumps(profile_heal(dev)), flush=True)
    print("profile_gapstress: " + json.dumps(profile_gapstress(dev)),
          flush=True)
    # a latency-window round, then the same rounds without the latency
    # pair: what the delay, jitter and session delays cost
    for latency in (True, False):
        print("profile_latency: " + json.dumps(
            profile_latency(dev, latency=latency)), flush=True)
    print("profile_dense_fault: " + json.dumps(profile_dense_fault(dev)),
          flush=True)
    print("profile_matrix_fault: " + json.dumps(profile_matrix_fault(dev)),
          flush=True)
    for kw in (dict(topo_family="wan-3x2"),
               dict(n=PEERSWAP_N, sampler="peerswap")):
        print("profile_topology: " + json.dumps(profile_storm(dev, **kw)),
              flush=True)
    for family in ("push-pull", "lab-ordered"):
        print("profile_protocol: " + json.dumps(profile_storm(
            dev, proto_family=family)), flush=True)
    print("profile_churn: " + json.dumps(profile_churn_partial(dev)),
          flush=True)
    # the 8-lane storm and fault storm rounds beside the solo rounds
    # measured in this call, and one lane
    for lanes_, faults_ in ((ENSEMBLE_LANES, False), (ENSEMBLE_LANES, True),
                            (1, False)):
        prof = profile_ensemble(dev, lanes_, faults=faults_)
        print("profile_ensemble: " + json.dumps(prof), flush=True)
        print(f"in-path redesigned kernels' ms per round, {prof['run']}: "
              + json.dumps(in_path_ms(prof)), flush=True)
    print("profile_solo: " + json.dumps(profile_storm(dev)), flush=True)
    # the 8-lane dense rounds beside their solo rounds, in one process
    for which in ("partial100k", "churn4096", "broadcast"):
        for lanes_ in (ENSEMBLE_LANES, None):
            print("profile_dense_ensemble: " + json.dumps(
                profile_dense_path(dev, which, lanes_)), flush=True)
    # the 8-lane dense fault round without and with the recorder beside
    # its solo round, in one process
    for tel_ in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_dense_fault_lanes(dev, telemetry=tel_)
        prof["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        print("profile_dense_fault_ensemble: " + json.dumps(prof),
              flush=True)
    print("profile_dense_fault_ensemble: " + json.dumps(
        profile_dense_fault(dev)), flush=True)
    # the 8-lane dense WAN storm round beside its solo round, in one
    # process
    for lanes_ in (ENSEMBLE_LANES, None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_dense_lanes(dev, wan_path_spec("wan100k"),
                                   "dense storm-wan-3x2-100k", lanes_)
        prof["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        print("profile_wan_ensemble: " + json.dumps(prof), flush=True)
    # the 8-lane dense push-pull storm round beside its solo round, in one
    # process
    for lanes_ in (ENSEMBLE_LANES, None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_dense_lanes(dev, proto_path_spec("pp100k"),
                                   "dense storm-push-pull-100k", lanes_)
        prof["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        print("profile_push_pull_ensemble: " + json.dumps(prof), flush=True)
    # the 8-lane packed latency round (rounds 5-7), and the 8-lane packed
    # fault round without and with the recorder, in one process
    for latency_, tel_ in ((True, False), (False, False), (False, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_packed_lanes(dev, latency=latency_, telemetry=tel_)
        prof["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        print("profile_packed_ensemble: " + json.dumps(prof), flush=True)
    # the 8-lane gapstress and packed WAN storm rounds beside their solo
    # rounds, in one process
    for which in ("gapstress", "wan-3x2"):
        for lanes_ in (ENSEMBLE_LANES, None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prof = profile_axis_lanes(dev, which, lanes_)
            prof["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
            print("profile_axis_ensemble: " + json.dumps(prof), flush=True)
    # the 8-lane packed push-pull and lab-ordered rounds beside their solo
    # rounds, in one process
    for which in ("push-pull", "lab-ordered"):
        for lanes_ in (ENSEMBLE_LANES, None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prof = profile_proto_lanes(dev, which, lanes_)
            prof["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
            print("profile_proto_ensemble: " + json.dumps(prof), flush=True)

    for row in rows:
        kern = row.get("kernel", row["name"])
        row["launches"] = (launches if kern in faultless_rows
                           else fault_launches)[kern]
        row["fault_path_launches"] = fault_launches[kern]
    for row in dense_kernel_rows:
        path = churn_launches_5 if row["name"] in (
            "sample_uniform", "swim_full") else heal_launches
        row["launches"] = path[row["name"]]
    rows += dense_kernel_rows
    for row in gap_kernel_rows:
        path = dist_launches if row["kernel"] == "dense_gaps" else gap_launches
        row["launches"] = path[row["kernel"]]
    rows += gap_kernel_rows
    # each flight-recorder row reads its kernel's launches on the
    # telemetry path whose shapes it was compared at
    trace_path = {"trace_counts": "storm", "trace_wire": "storm",
                  "trace_row": "storm", "sync_pull_granted": "storm",
                  "fault_edges_counts": "fault",
                  "broadcast_scatter_lossy_dropped": "fault",
                  "sync_pull_metered_granted": "gapstress",
                  "broadcast_scatter_lossy_topo_dropped": "gapstress"}
    for row in trace_kernel_rows:
        path = trace_path.get(row["name"], "gapstress" if row["name"].endswith(
            "_gs") else "gapstress_1024")
        row["launches"] = tel_launches[path][row["kernel"]]
        row["path"] = path
    rows += trace_kernel_rows
    for row in latency_kernel_rows:
        row["launches"] = latency_launches[False][row["kernel"]]
        row["path"] = "latency_storm_100k"
    rows += latency_kernel_rows
    for row in dense_fault_kernel_rows:
        path, counts = (
            ("dense_latency_storm_100k", dense_latency_launches)
            if row["kernel"] == "dense_sync_delay"
            else ("dense_fault_storm_100k", dense_fault_launches[False]))
        row["launches"] = counts[row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            "dense_latency_storm_100k": dense_latency_launches[row["kernel"]],
            "full_view_fault_storm_4096": fv_launches[row["kernel"]]}
    rows += dense_fault_kernel_rows
    other = {"fault_campaign_3node": campaign_launches,
             "fault_campaign_3node_checked": checked_launches,
             "full_view_fault_storm_4096_matrix": fvm_launches,
             "packed_fault_storm_4096_matrix": pm_launches}
    for row in matrix_kernel_rows:
        path, counts = (
            ("full_view_fault_storm_4096_matrix", fvm_launches)
            if row["name"].endswith("_4096")
            else ("fault_storm_1000", fs1000_launches))
        row["launches"] = counts[row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]] for label, c in other.items()}
    rows += matrix_kernel_rows
    # each topology row reads its kernel's launches on the path whose
    # shapes it was compared at
    topo_path = {"edge_slots_wan-fly-6r": "storm_wan_fly_6r_100k",
                 "degree_caps": "storm_hetero_degree_100k",
                 "dense_broadcast_tiered": "broadcast_1k_wan_3x2_peerswap",
                 "sample_view_beliefs": "broadcast_1k_wan_3x2_peerswap",
                 "sample_view": "storm_peerswap_25600",
                 "sample_view_c1": "storm_peerswap_25600",
                 "peerswap": "storm_peerswap_25600"}
    for row in topo_kernel_rows:
        path = topo_path.get(row["name"], "storm_wan_3x2_100k")
        row["launches"] = topo_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]] for label, c in topo_launches.items()}
    rows += topo_kernel_rows
    # each protocol row reads its kernel's launches on the path that runs
    # it
    proto_path = {
        "broadcast_pull": "storm_push_pull_100k",
        "broadcast_pull_lossy": "fault_storm_push_pull_100k",
        "broadcast_pull_tiered": "storm_wan_3x2_push_pull_100k_telemetry",
        "dense_pull": "broadcast_1k_push_pull",
        "dense_pull_lossy": "broadcast_1k_push_pull_flat_lossy",
        "dense_pull_tiered": "broadcast_1k_push_pull_wan_3x2",
        "word_deliver_fifo": "storm_lab_ordered_100k",
        "dense_deliver_fifo": "broadcast_1k_lab_ordered",
        "order_check_words": "storm_lab_ordered_broken_100k",
        "order_check_dense": "broadcast_1k_lab_ordered_broken",
        "degree_caps_sched": "storm_fanout_decay_100k",
        "trace_wire_pull": "storm_wan_3x2_push_pull_100k_telemetry",
        "trace_wire_rows_pull": "broadcast_1k_push_pull_telemetry",
    }
    for row in proto_kernel_rows:
        path = proto_path[row["kernel"]]
        row["launches"] = proto_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]] for label, c in proto_launches.items()}
    rows += proto_kernel_rows
    # each churn row reads its kernel's launches on the path whose shapes
    # it was compared at; the dense view row's kernel runs on no churn
    # path (its launches are the dense fault storm's)
    churn_path = {"detect_full_64": "swim_churn_64_solo",
                  "detect_full_1000": "swim_churn_64_solo",
                  "detect_full_4096": "churn_full_4096",
                  "detect_partial_4096": "swim_churn_partial_4096_telemetry",
                  "detect_partial_100000": "swim_churn_partial_100k_solo",
                  "node_faults_view": "flash_crowd_peerswap_25600"}
    churn_launches["churn_full_4096"] = churn_launches_5
    for row in churn_kernel_rows:
        path = churn_path.get(row["name"], "dense_fault_storm_100k")
        counts = (dense_fault_launches[False]
                  if path == "dense_fault_storm_100k"
                  else churn_launches[path])
        row["launches"] = counts[row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]] for label, c in churn_launches.items()}
    rows += churn_kernel_rows
    # each lane row reads its launches on the 8-lane fault storm's path,
    # which runs every lane entry
    for row in lane_kernel_rows:
        row["launches"] = lane_launches["fault_storm_100k_seeds8"][
            row["kernel"]]
        row["path"] = "fault_storm_100k_seeds8"
        row["other_paths_launches"] = {
            label: c[row["kernel"]] for label, c in lane_launches.items()}
    rows += lane_kernel_rows
    # each dense lane row reads its launches on the path whose shapes it
    # was compared at
    dense_lane_path = {"dense_phases_lanes": "broadcast_1k_seeds8",
                       "dense_sync_lanes": "broadcast_1k_seeds8",
                       "dense_gaps_lanes": "broadcast_1k_seeds8",
                       "sample_uniform_lanes_ground": "broadcast_1k_seeds8",
                       "detect_partial_lanes":
                           "swim_churn_partial_100k_seeds8"}
    for row in dense_lane_rows:
        path = dense_lane_path.get(
            row["name"], "swim_churn_partial_100k_seeds8"
            if row["name"].endswith("_100k")
            else "swim_churn_full_4096_seeds8")
        row["launches"] = dense_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in dense_lane_launches.items()}
    rows += dense_lane_rows
    # each dense fault lane row reads its launches on the path whose
    # shapes it was compared at
    fault_lane_path = {
        "fault_reach_matrix_lanes": "fault_storm_1000_seeds8",
        "dense_sync_delay_lanes": "dense_latency_storm_100k_seeds8"}
    for row in dense_fault_lane_rows:
        path = fault_lane_path.get(row["kernel"],
                                   "dense_fault_storm_100k_seeds8")
        row["launches"] = dense_fault_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in dense_fault_lane_launches.items()}
    rows += dense_fault_lane_rows
    # each recorder lane row reads its launches on the path whose shapes
    # it was compared at
    trace_lane_path = {
        "dense_broadcast_lanes_trace": "broadcast_1k_seeds8_telemetry",
        "dense_sync_delay_lanes_trace":
            "dense_latency_storm_100k_seeds8_telemetry",
        "fault_edges_delay_lanes_count":
            "dense_latency_storm_100k_seeds8_telemetry",
        "fault_edges_matrix_lanes_count": "fault_parity_3node_telemetry"}
    for row in trace_lane_rows:
        path = trace_lane_path.get(row["kernel"],
                                   "dense_fault_storm_100k_seeds8_telemetry")
        row["launches"] = trace_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in trace_lane_launches.items()}
    rows += trace_lane_rows
    # each topology lane row reads its launches on the path whose shapes
    # it was compared at
    wan100k, peerswap1k = ("dense_storm_wan_3x2_100k_seeds8",
                           "broadcast_1k_wan_3x2_peerswap_seeds8_wire")
    topo_lane_path = {
        "edge_slots_lanes_wan-fly-6r":
            "broadcast_1k_wan_fly_6r_uniform_seeds8",
        "degree_caps_lanes": "peer_sampler_frontier",
        "dense_broadcast_tiered_lanes_trace": peerswap1k,
        "sample_view_lanes": peerswap1k,
        "sample_view_lanes_beliefs": peerswap1k,
        "peerswap_lanes": peerswap1k}
    for row in topo_lane_rows:
        path = topo_lane_path.get(row["name"], wan100k)
        row["launches"] = topo_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in topo_lane_launches.items()}
    rows += topo_lane_rows
    # each protocol lane row reads its launches on the path that runs its
    # kernel at the row's shapes
    proto_lane_path = {
        "dense_pull_lanes": "dense_storm_push_pull_100k_seeds8",
        "dense_pull_lossy_lanes": "protocol_frontier_push_pull",
        "dense_pull_tiered_lanes": "protocol_frontier_push_pull",
        "degree_caps_sched_lanes": "broadcast_1k_fanout_decay_seeds8_wire",
        "order_check_dense_lanes":
            "broadcast_1k_lab_ordered_broken_seeds8_wire"}
    for row in proto_lane_rows:
        path = ("protocol_frontier" if row["name"].endswith("_frontier")
                else proto_lane_path.get(row["kernel"], "protocol_frontier"))
        row["launches"] = proto_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in proto_lane_launches.items()}
    rows += proto_lane_rows
    # each packed lane row reads its launches on the path that runs its
    # kernel at the row's shapes
    packed_lane_path = {
        "broadcast_scatter_jitter_lanes": "latency_storm_100k_seeds8",
        "sync_pull_delay_lanes": "latency_storm_100k_seeds8",
        "broadcast_scatter_jitter_lanes_trace":
            "latency_storm_100k_seeds8_wire",
        "broadcast_scatter_lossy_lanes_trace":
            "latency_storm_100k_seeds8_wire",
        "sync_pull_delay_lanes_trace": "latency_storm_100k_seeds8_wire"}
    for row in packed_lane_rows:
        path = packed_lane_path.get(row["kernel"],
                                    "fault_storm_100k_seeds8_telemetry")
        row["launches"] = packed_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in packed_lane_launches.items()}
    rows += packed_lane_rows
    # each metered or topology lane row reads its launches on the path
    # whose shapes it was compared at
    axis_lane_path = {
        "budget_words_lanes": "gapstress_25600_seeds8",
        "sync_pull_metered_lanes": "gapstress_25600_seeds8",
        "broadcast_scatter_lossy_lanes": "gapstress_25600_seeds8",
        "sync_pull_metered_lanes_trace": "gapstress_25600_seeds8_telemetry",
        "broadcast_scatter_lossy_lanes_trace":
            "gapstress_25600_seeds8_telemetry",
        "broadcast_scatter_tiered_lanes": "storm_wan_3x2_100k_seeds8",
        "broadcast_scatter_tiered_lanes_trace":
            "storm_wan_3x2_100k_seeds8_telemetry",
        "sample_view_lanes_25600": "storm_peerswap_25600_seeds8",
        "peerswap_lanes_25600": "storm_peerswap_25600_seeds8"}
    for row in axis_lane_rows:
        path = axis_lane_path.get(row["name"],
                                  axis_lane_path.get(row["kernel"]))
        row["launches"] = axis_lane_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in axis_lane_launches.items()}
    rows += axis_lane_rows
    # each packed protocol lane row reads its launches on the run that
    # launches its kernel at the row's shapes
    proto_packed_path = {
        "broadcast_pull_lanes": "storm_push_pull_100k_seeds8",
        "broadcast_pull_lossy_lanes": "fault_storm_push_pull_100k_seeds8",
        "broadcast_pull_lossy_lanes_trace":
            "fault_storm_push_pull_100k_seeds8_telemetry",
        "broadcast_pull_tiered_lanes": "storm_wan_3x2_push_pull_100k_seeds8",
        "broadcast_pull_tiered_lanes_trace":
            "storm_wan_3x2_push_pull_100k_seeds8_telemetry",
        "trace_wire_pull_lanes":
            "storm_wan_3x2_push_pull_100k_seeds8_telemetry",
        "word_deliver_fifo_lanes": "storm_lab_ordered_100k_seeds8",
        "order_check_words_lanes": "storm_lab_ordered_broken_100k_seeds8"}
    for row in proto_packed_rows:
        path = proto_packed_path[row["kernel"]]
        row["launches"] = proto_packed_launches[path][row["kernel"]]
        row["path"] = path
        row["other_paths_launches"] = {
            label: c[row["kernel"]]
            for label, c in proto_packed_launches.items()}
    rows += proto_packed_rows
    # each 1M row reads its kernel's launches on path 69
    for row in million_rows:
        row["launches"] = million_launches[row["kernel"]]
        row["path"] = "fault_storm_1m"
        row["other_paths_launches"] = {
            "packed_fault_storm_512_matrix_seeds8":
                matrix_lane_launches[row["kernel"]]}
    rows += million_rows
    for row in rows:
        row["kernel_ms"] = row["ms"]
    _lap("profiles")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
