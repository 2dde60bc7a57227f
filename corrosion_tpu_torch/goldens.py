"""Results of the JAX reference pinned for runs without JAX.

Each entry is what the JAX package (``corrosion_tpu``, jax 0.9.0 on the
CPU) produces for one scenario and seed: rounds to convergence, the p99
node-convergence round (the gapstress entries also the p99 payload
latency and the largest gap-overflow share), and the blake2b digest of
the final state (`convert.state_digest`, equal to the JAX suite's
``_digest``); the comment above each names the JAX call.
``chip_smoke.py`` holds the port's runs on the card against them;
``tests/test_torch_storm.py``, ``tests/test_torch_fault_storm.py``,
``tests/test_torch_dense.py``, ``tests/test_torch_swim_full.py``,
``tests/test_torch_gapstress.py``, ``tests/test_torch_latency.py``,
``tests/test_torch_dense_faults.py`` and
``tests/test_torch_matrix_faults.py`` hold them against live JAX (the
largest under ``-m slow``).  The ``*_TELEMETRY`` entries at the end are
the same runs' flight-recorder summaries and per-round byte channels;
``tests/test_torch_telemetry.py`` holds the 3-node and broadcast-1k ones
against live JAX.  The protocol axis's entries at the end carry the
run's ``order_violations`` too; ``tests/test_torch_proto_runs.py`` holds
them against live JAX under ``-m slow``.
"""

# _write_storm(512, 256) with packed_min_cells=0, seed 7
STORM_512_SEED7 = {
    "rounds": 14,
    "p99_node_convergence_round": 12.0,
    "digest": "c8c0c977843b660d",
}

# config_write_storm_100k(seed=0): 100000 nodes, 512 payloads
STORM_100K_SEED0 = {
    "rounds": 28,
    "p99_node_convergence_round": 24.0,
    "digest": "9318cde1da5511ba",
}

# run_fault_plan on _write_storm(512, 256) with packed_min_cells=0, seed 7,
# under compile_plan(storm_fault_plan(512, 7), factored=True)
FAULT_STORM_512_SEED7 = {
    "rounds": 24,
    "p99_node_convergence_round": 18.0,
    "digest": "60ba44e303d6d7b9",
}

# config_packed_fault_storm(seed=0): 100000 nodes, 512 payloads
FAULT_STORM_100K_SEED0 = {
    "rounds": 29,
    "p99_node_convergence_round": 25.0,
    "digest": "1cd8919e20ad0df8",
}

# the latency storm: cfg, meta = _write_storm(100000, 512) with
# n_delay_slots=4 (the one change to the storm: compile_plan needs the
# topology's 1 + delay 1 + jitter 1 < n_delay_slots), and
# run_fault_plan(new_sim(cfg, 0), meta, cfg, Topology(),
# compile_plan(plan, cfg, Topology()), max_rounds=3000), where plan is
# storm_fault_plan(100000, 0)'s events followed by
# FaultEvent("delay", 2, 16, src="0:16666", dst="*", delay_rounds=1) and
# FaultEvent("jitter", 2, 16, src="0:16666", dst="*", delay_rounds=1)
LATENCY_STORM_100K_SEED0 = {
    "rounds": 29,
    "p99_node_convergence_round": 26.0,
    "digest": "652c9355f037a8c9",
}

# the same fault storm on the dense round: _write_storm(100000, 512) with
# allow_packed=False (JAX's dense == packed contract), run_fault_plan(
# new_sim(cfg, 0), meta, cfg, Topology(), compile_plan(storm_fault_plan(
# 100000, 0), cfg, Topology()), max_rounds=3000) — pinned from live JAX's
# dense run on the CPU, which gives the packed run's results bit for bit
DENSE_FAULT_STORM_100K_SEED0 = {
    "rounds": 29,
    "p99_node_convergence_round": 25.0,
    "digest": "1cd8919e20ad0df8",
}

# the latency storm on the dense round: LATENCY_STORM_100K_SEED0's run
# with allow_packed=False, pinned from live JAX's dense run on the CPU
# (the packed run's results again)
DENSE_LATENCY_STORM_100K_SEED0 = {
    "rounds": 29,
    "p99_node_convergence_round": 26.0,
    "digest": "652c9355f037a8c9",
}

# JAX's 4096-node acceptance storm (tests/sim/test_packed_equivalence.py
# test_fault_storm_4096_packed_vs_dense) on full-view membership:
# _write_storm(4096, 512) with swim_partial_view=False,
# swim_full_view=True, allow_packed=False, run_fault_plan(new_sim(cfg, 7),
# meta, cfg, Topology(), compile_plan(storm_fault_plan(4096, seed=3), cfg,
# Topology()), 1000)
FULL_VIEW_FAULT_STORM_4096_SEED7 = {
    "rounds": 26,
    "p99_node_convergence_round": 24.0,
    "digest": "3e833122b5aaa8ee",
}

# config_packed_fault_storm(seed=0, n_nodes=1000)'s fault run: _write_storm(
# 1000, 512) (the dense round, partial-view SWIM), run_fault_plan(new_sim(
# cfg, 0), meta, cfg, Topology(), compile_plan(storm_fault_plan(1000, 0),
# cfg, Topology()), 3000) — the matrix plan [22, 1000, 1000], cut and loss
FAULT_STORM_1000_SEED0 = {
    "rounds": 24,
    "p99_node_convergence_round": 22.0,
    "digest": "660add80364fb2f9",
}

# the 3-node fault campaign (fault_campaign_3node_spec(0)'s scenario:
# SimConfig(n_nodes=3, n_payloads=16, fanout=2, sync_interval_rounds=4,
# n_delay_slots=4), uniform_payloads(cfg, inject_every=1), new_sim(cfg, 0),
# demo_plan(seed=0), the matrix plan): run_fault_plan(..., 1000) gives
# rounds, p99 and digest; run_fault_plan_checked(..., max_rounds=400) the
# per-round digests, whose count, last entry and blake2b-8 over the
# entries' ASCII in order are pinned (the final state is the same)
FAULT_CAMPAIGN_3NODE_SEED0 = {
    "rounds": 41,
    "p99_node_convergence_round": 17.96,
    "digest": "1e2f75d5f2b1a911",
}
FAULT_CAMPAIGN_3NODE_SEED0_CHECKED = {
    "n_digests": 41,
    "last_digest": "9b3d6d3e274298e9",
    "digest_list": "12db1511c2db23c8",
}

# _write_storm(4096, 512) with packed_min_cells=0 (the packed round),
# run_fault_plan(new_sim(cfg, 0), meta, cfg, Topology(), compile_plan(
# storm_fault_plan(4096, 0), cfg, Topology(), factored=True), 3000); the
# port runs it on the matrix form too, which JAX pins as equal
PACKED_FAULT_STORM_4096_SEED0 = {
    "rounds": 33,
    "p99_node_convergence_round": 23.0,
    "digest": "f3ad275debd555bd",
}

# runner.config_ground_truth_3node(seed=0), its final state from
# run_to_convergence(new_sim(cfg, 0), meta, cfg, Topology(), 2000)
GROUND_TRUTH_3NODE_SEED0 = {
    "rounds": 64,
    "p99_node_convergence_round": 63.0,
    "digest": "d6d63ed7637675ce",
}

# runner.config_broadcast_1k(seed=0): 1000 nodes, 8 writers x 32
# versions, budgets dropped by optimize_budgets, the dense round
BROADCAST_1K_SEED0 = {
    "rounds": 73,
    "p99_node_convergence_round": 69.0,
    "digest": "c0523861b0f30759",
}

# runner.config_partition_heal_10k(seed=0): round_step over 60
# partitioned rounds, then run_to_convergence after the heal
PARTITION_HEAL_10K_SEED0 = {
    "heal_round": 60,
    "rounds": 96,
    "rounds_after_heal": 36,
    "p99_node_convergence_round": 87.0,
    "digest": "5878edbabd4f1678",
}

# SimConfig.wan_tuned(4096, n_payloads=1, swim_full_view=True), every
# third node killed at t = 0, round_step until every survivor believes
# every dead node DOWN (telemetry.run_membership_detect's predicate),
# seed 0: the round counter then, the state's digest, (up, up) DOWNs
CHURN_FULL_4096_SEED0 = {
    "detect_round": 46,
    "digest": "ba94e70d5efbab4c",
    "false_downs": 0,
}

# runner.config_write_storm_gapstress(seed=1, n_nodes=25600): the bench's
# own rung (config #5b), 8192 payloads (V = 128, K = 8), 30 % flat loss,
# both byte budgets binding, the packed round
GAPSTRESS_25600_SEED1 = {
    "rounds": 42,
    "p99_node_convergence_round": 34.0,
    "p99_payload_latency_rounds": 40.0,
    "gap_overflow_frac_max": 0.3996679484844208,
    "digest": "c00323c9ab9cd35b",
}

# runner.config_write_storm_gapstress(seed=1, n_nodes=4096): the bench's
# CPU rung, the packed round
GAPSTRESS_4096_SEED1 = {
    "rounds": 50,
    "p99_node_convergence_round": 32.0,
    "p99_payload_latency_rounds": 38.0,
    "gap_overflow_frac_max": 0.28094482421875,
    "digest": "b6e643f01aa5357e",
}

# runner.config_gapstress_distortion(seed=0, n_nodes=1024): the gapstress
# scenario at K = 8 and at the K = 64 control, each on the dense round
# (1024 x 8192 cells is under packed_min_cells)
GAPSTRESS_DISTORTION_1024_SEED0 = {
    "stressed": {
        "rounds": 35,
        "p99_node_convergence_round": 29.0,
        "p99_payload_latency_rounds": 34.0,
        "gap_overflow_frac_max": 0.1939697265625,
        "digest": "752f9209dd4f17cb",
    },
    "control": {
        "rounds": 35,
        "p99_node_convergence_round": 29.0,
        "p99_payload_latency_rounds": 34.0,
        "gap_overflow_frac_max": 0.0,
        "digest": "6f58fc855b9ca158",
    },
    "distortion_rounds": 0,
}


# -- the flight recorder ------------------------------------------------------
#
# Each *_TELEMETRY entry is JAX's run of the scenario with telemetry on
# (jax 0.9.0 on the CPU, the batching shim of tests/torch_parity.py):
# ``summary`` is its trace_summary but ``wire_bytes``, integers and
# percentiles to hold exactly (coverage_curve_digest included);
# ``wire_bytes`` is that block, and ``bcast_bytes``/``sync_bytes`` are
# the per-round f32 channels, which the port holds within
# m * 2**-24 of the exact total for m f32 terms JAX adds (telemetry.py).
# The run's rounds, p99 and state digest are the entries above.

# config_write_storm_100k(seed=0, telemetry=True)
STORM_100K_SEED0_TELEMETRY = {'summary': {'rounds': 28,
             'coverage_curve_digest': '2441d1b2fddbc04d',
             'coverage_latency_rounds': {'p50': 19.0,
                                         'p95': 26.0,
                                         'p99': 27.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 1668948132, 'sync': 12994264},
             'fault': {'dropped_frames': 0,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 1273377,
             'swim': {'peak_suspect': 0, 'peak_down': 0},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 13672022802432.0,
                'sync': 106449010688.0,
                'per_round_mean': 492088279040.0},
 'bcast_bytes': [1572864.0, 6291456.0, 26640384.0, 105381888.0, 419168256.0,
                 1650229248.0, 6410502144.0, 23713972224.0, 73977593856.0,
                 153851756544.0, 224852115456.0, 306889457664.0,
                 378878263296.0, 461192331264.0, 533394456576.0,
                 615350992896.0, 686881767424.0, 768318504960.0,
                 839237500928.0, 919415816192.0, 985750831104.0,
                 1048557649920.0, 1064783970304.0, 1048967512064.0,
                 999169261568.0, 918772776960.0, 846878212096.0,
                 764568600576.0],
 'sync_bytes': [0.0, 786432.0, 2785280.0, 14778368.0, 63569920.0,
                263061504.0, 1072693248.0, 3852763136.0, 3271884800.0,
                3846307840.0, 4905205760.0, 4824137728.0, 6167134208.0,
                6014926848.0, 7528087552.0, 7011827712.0, 8110374912.0,
                7132413952.0, 8313339904.0, 7452327936.0, 8285782016.0,
                7135657984.0, 7261388800.0, 3559882752.0, 333807616.0,
                22511616.0, 1572864.0, 0.0]}

# run_fault_plan(new_sim(cfg, 0), meta, cfg, Topology(),
# compile_plan(storm_fault_plan(100000, 0), cfg, Topology()), max_rounds=3000,
# telemetry=True) on _write_storm(100000, 512), then trace_summary
FAULT_STORM_100K_SEED0_TELEMETRY = {'summary': {'rounds': 29,
             'coverage_curve_digest': '4f13acb4e02b421b',
             'coverage_latency_rounds': {'p50': 23.0,
                                         'p95': 27.0,
                                         'p99': 28.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 1439584365, 'sync': 12464393},
             'fault': {'dropped_frames': 1022178,
                       'cut_edges': 1800283,
                       'refused_sessions': 218108,
                       'crash_node_rounds': 12,
                       'wipes': 1},
             'sync_sessions': 990170,
             'swim': {'peak_suspect': 296781, 'peak_down': 203417},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 11793075273728.0,
                'sync': 102108307456.0,
                'per_round_mean': 410178744178.8},
 'bcast_bytes': [1572864.0, 5578752.0, 21282816.0, 75202560.0, 133521408.0,
                 301596672.0, 669892608.0, 1496842240.0, 3289587712.0,
                 7119421440.0, 14741135360.0, 28472893440.0, 48705159168.0,
                 75180228608.0, 101430951936.0, 129086111744.0,
                 311786995712.0, 409783566336.0, 536659165184.0,
                 672618119168.0, 806573965312.0, 932563582976.0,
                 1039734079488.0, 1124774838272.0, 1172280967168.0,
                 1162642063360.0, 1123776856064.0, 1070931574784.0,
                 1018218283008.0],
 'sync_bytes': [0.0, 704512.0, 2211840.0, 10739712.0, 20226048.0,
                49905664.0, 121192448.0, 283074560.0, 209928192.0,
                555442176.0, 1100775424.0, 1900027904.0, 2635587584.0,
                2870534144.0, 3272712192.0, 3604045824.0, 7867719680.0,
                10241728512.0, 12119359488.0, 12567347200.0, 12091138048.0,
                10922401792.0, 9341108224.0, 7246790656.0, 2740420608.0,
                307429376.0, 24281088.0, 1474560.0, 0.0]}

# config_write_storm_gapstress(seed=1, n_nodes=25600, telemetry=True)
GAPSTRESS_25600_SEED1_TELEMETRY = {'summary': {'rounds': 42,
             'coverage_curve_digest': '639abf6f4f8845c8',
             'coverage_latency_rounds': {'p50': 27.0,
                                         'p95': 39.0,
                                         'p99': 39.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 5594131140, 'sync': 138925168},
             'fault': {'dropped_frames': 1682654327,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 438132,
             'swim': {'peak_suspect': 8153, 'peak_down': 14284},
             'gap_overflow_rounds': 29},
 'wire_bytes': {'broadcast': 12949398749184.0,
                'sync': 320883523584.0,
                'per_round_mean': 315959101732.6},
 'bcast_bytes': [56875648.0, 177407968.0, 542237312.0, 1658792576.0,
                 5073758208.0, 15459468288.0, 46550441984.0, 135459733504.0,
                 312801951744.0, 394467672064.0, 401850335232.0,
                 402377506816.0, 402445959168.0, 402472796160.0,
                 402481381376.0, 402483642368.0, 402484068352.0,
                 402482987008.0, 402478956544.0, 402465652736.0,
                 402439208960.0, 402412077056.0, 402393202688.0,
                 402349195264.0, 401574821888.0, 399459483648.0,
                 398580645888.0, 398376370176.0, 398280982528.0,
                 398160166912.0, 397944127488.0, 397496745984.0,
                 396668076032.0, 394905288704.0, 391304577024.0,
                 382559846400.0, 360900263936.0, 316848308224.0,
                 262636568576.0, 240059809792.0, 234731978752.0,
                 233044459520.0],
 'sync_bytes': [0.0, 15859751.0, 66960892.0, 266356464.0, 734418240.0,
                2627813120.0, 7397061632.0, 18436548608.0, 13145274368.0,
                26452189184.0, 26019491840.0, 23140169728.0, 23521128448.0,
                25858551808.0, 26175174656.0, 25145131008.0, 21861306368.0,
                17969831936.0, 15303885824.0, 11594786816.0, 9394036736.0,
                6945627648.0, 4681944576.0, 3384017664.0, 2558115072.0,
                2103154048.0, 1443881984.0, 1166268416.0, 935394944.0,
                569305664.0, 398329664.0, 351673696.0, 302370880.0,
                331810304.0, 234947376.0, 158410016.0, 130845904.0,
                48463560.0, 12711567.0, 230037.0, 24582.0, 0.0]}

# config_write_storm_gapstress(seed=0, n_nodes=1024, telemetry=True):
# the dense round (under packed_min_cells), 30 % loss
GAPSTRESS_1024_SEED0_TELEMETRY = {'summary': {'rounds': 35,
             'coverage_curve_digest': 'a400aa4b6cf897dc',
             'coverage_latency_rounds': {'p50': 21.0,
                                         'p95': 33.0,
                                         'p99': 34.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 206012463, 'sync': 6106570},
             'fault': {'dropped_frames': 61965190,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 15762,
             'swim': {'peak_suspect': 319, 'peak_down': 678},
             'gap_overflow_rounds': 20},
 'wire_bytes': {'broadcast': 476712632320.0,
                'sync': 14151321600.0,
                'per_round_mean': 14024684397.7},
 'bcast_bytes': [56875648.0, 175385568.0, 542854528.0, 1659585792.0,
                 4870772736.0, 11658641408.0, 15663099904.0, 16057790464.0,
                 16092371968.0, 16094889984.0, 16096168960.0, 16096399360.0,
                 16096912384.0, 16096955392.0, 16096978944.0, 16096939008.0,
                 16096940032.0, 16096390144.0, 16095794176.0, 16073872384.0,
                 16062430208.0, 16026230784.0, 15926460416.0, 15893092352.0,
                 15886270464.0, 15883974656.0, 15880682496.0, 15874040832.0,
                 15857089536.0, 15830512640.0, 15761794048.0, 15605986304.0,
                 15291123712.0, 14461146112.0, 12656174080.0],
 'sync_bytes': [0.0, 23514874.0, 67995208.0, 217641248.0, 717745984.0,
                1373217536.0, 1869258240.0, 1995266432.0, 666755264.0,
                843615616.0, 776353408.0, 875797248.0, 919466176.0,
                849527552.0, 674961088.0, 589795776.0, 395692704.0,
                385966112.0, 254095392.0, 296054656.0, 105204032.0,
                59585172.0, 56229568.0, 42407400.0, 22212820.0, 15808366.0,
                37710104.0, 591451.0, 4772298.0, 8714157.0, 0.0, 0.0,
                24576.0, 5341026.0, 0.0]}

# config_ground_truth_3node(seed=0, telemetry=True)
GROUND_TRUTH_3NODE_SEED0_TELEMETRY = {'summary': {'rounds': 64,
             'coverage_curve_digest': 'f1fc9816eabdcd73',
             'coverage_latency_rounds': {'p50': 31.0,
                                         'p95': 59.0,
                                         'p99': 62.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 3139, 'sync': 2},
             'fault': {'dropped_frames': 0,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 44,
             'swim': {'peak_suspect': 0, 'peak_down': 0},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 25714688.0,
                'sync': 16384.0,
                'per_round_mean': 402048.0},
 'bcast_bytes': [16384.0, 49152.0, 98304.0, 163840.0, 180224.0, 262144.0,
                 311296.0, 360448.0, 409600.0, 458752.0, 376832.0, 458752.0,
                 385024.0, 458752.0, 376832.0, 442368.0, 376832.0, 360448.0,
                 442368.0, 458752.0, 475136.0, 458752.0, 376832.0, 442368.0,
                 475136.0, 458752.0, 475136.0, 393216.0, 442368.0, 458752.0,
                 458752.0, 385024.0, 475136.0, 458752.0, 385024.0, 458752.0,
                 458752.0, 475136.0, 376832.0, 442368.0, 385024.0, 458752.0,
                 385024.0, 458752.0, 376832.0, 376832.0, 385024.0, 458752.0,
                 475136.0, 458752.0, 385024.0, 458752.0, 458752.0, 458752.0,
                 475136.0, 458752.0, 385024.0, 458752.0, 458752.0, 458752.0,
                 458752.0, 458752.0, 385024.0, 458752.0],
 'sync_bytes': [0.0, 0.0, 16384.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                0.0, 0.0, 0.0, 0.0, 0.0]}

# config_broadcast_1k(seed=0, telemetry=True)
BROADCAST_1K_SEED0_TELEMETRY = {'summary': {'rounds': 73,
             'coverage_curve_digest': 'fec8534fa9d5bc23',
             'coverage_latency_rounds': {'p50': 38.0,
                                         'p95': 67.0,
                                         'p99': 69.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 6609069, 'sync': 75005},
             'fault': {'dropped_frames': 0,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 37644,
             'swim': {'peak_suspect': 0, 'peak_down': 0},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 54141493248.0,
                'sync': 614440960.0,
                'per_round_mean': 750081290.5},
 'bcast_bytes': [196608.0, 786432.0, 3342336.0, 12976128.0, 46989312.0,
                 130056192.0, 227696640.0, 321773568.0, 419659776.0,
                 513540096.0, 609755136.0, 702013440.0, 789577728.0,
                 849076224.0, 862642176.0, 860405760.0, 865320960.0,
                 860872704.0, 862027776.0, 858390528.0, 861044736.0,
                 857579520.0, 862052352.0, 858660864.0, 859987968.0,
                 855834624.0, 860110848.0, 858390528.0, 862420992.0,
                 858144768.0, 861536256.0, 855662592.0, 859594752.0,
                 857038848.0, 860184576.0, 856203264.0, 860356608.0,
                 856006656.0, 859226112.0, 854654976.0, 859299840.0,
                 856326144.0, 859004928.0, 854949888.0, 859570176.0,
                 854556672.0, 859496448.0, 857382912.0, 859865088.0,
                 855121920.0, 858980352.0, 856104960.0, 860332032.0,
                 854605824.0, 859029504.0, 854163456.0, 857309184.0,
                 855760896.0, 861708288.0, 857948160.0, 861978624.0,
                 857948160.0, 861265920.0, 857088000.0, 860798976.0,
                 858046464.0, 858292224.0, 844922880.0, 814817280.0,
                 727203840.0, 633372672.0, 537673728.0, 444776448.0],
 'sync_bytes': [0.0, 131072.0, 491520.0, 1646592.0, 6160384.0, 8970240.0,
                8273920.0, 13131776.0, 5251072.0, 8175616.0, 6971392.0,
                9297920.0, 7725056.0, 11681792.0, 9617408.0, 12566528.0,
                7086080.0, 10969088.0, 8241152.0, 10559488.0, 8110080.0,
                11091968.0, 8175616.0, 11919360.0, 7389184.0, 11591680.0,
                8577024.0, 11616256.0, 9216000.0, 10338304.0, 8077312.0,
                10698752.0, 9347072.0, 11264000.0, 8740864.0, 11419648.0,
                8167424.0, 11911168.0, 7823360.0, 11337728.0, 8085504.0,
                10813440.0, 9330688.0, 10567680.0, 10616832.0, 11395072.0,
                9248768.0, 10559488.0, 9093120.0, 10706944.0, 9363456.0,
                9682944.0, 9617408.0, 10174464.0, 8470528.0, 9322496.0,
                9756672.0, 9428992.0, 8953856.0, 10354688.0, 8912896.0,
                9199616.0, 7954432.0, 10919936.0, 9781248.0, 10428416.0,
                7446528.0, 8593408.0, 1679360.0, 122880.0, 49152.0, 49152.0,
                0.0]}

# the latency storm's run above with telemetry=True, then trace_summary
# (tests/test_torch_latency.py re-derives both latency entries under -m slow)
LATENCY_STORM_100K_SEED0_TELEMETRY = {'summary': {'rounds': 29,
             'coverage_curve_digest': '38c877501a4dd467',
             'coverage_latency_rounds': {'p50': 23.0,
                                         'p95': 27.0,
                                         'p99': 28.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 1398233452, 'sync': 12604442},
             'fault': {'dropped_frames': 629767,
                       'cut_edges': 1800283,
                       'refused_sessions': 212426,
                       'crash_node_rounds': 12,
                       'wipes': 1},
             'sync_sessions': 976668,
             'swim': {'peak_suspect': 296781, 'peak_down': 203417},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 11454329651200.0,
                'sync': 103255588864.0,
                'per_round_mean': 398537422071.2},
 'bcast_bytes': [1572864.0, 5578752.0, 21282816.0, 64610304.0, 101621760.0,
                 219021312.0, 461365248.0, 988495872.0, 2082742272.0,
                 4368924672.0, 8925650944.0, 17416830976.0, 31116156928.0,
                 51798245376.0, 75383021568.0, 100426252288.0, 250371915776.0,
                 361044738048.0, 476414312448.0, 604279865344.0,
                 744786558976.0, 885490450432.0, 1009682022400.0,
                 1112550146048.0, 1177866862592.0, 1185302970368.0,
                 1160944418816.0, 1119693176832.0, 1072519708672.0],
 'sync_bytes': [0.0, 704512.0, 2211840.0, 9461760.0, 15507456.0, 35233792.0,
                82526208.0, 185925632.0, 128851968.0, 339812352.0, 687546368.0,
                1257177088.0, 2001903616.0, 2608177152.0, 3083149312.0,
                3336871936.0, 8711536640.0, 9300484096.0, 10752499712.0,
                12484943872.0, 12928385024.0, 12227780608.0, 10626080768.0,
                8344870912.0, 3515695104.0, 538894336.0, 46555136.0, 2801664.0,
                0.0]}

# the dense fault storm's run (DENSE_FAULT_STORM_100K_SEED0) with
# telemetry=True, from live JAX's dense run on the CPU: every key and row
# equal to the packed run's entry above
DENSE_FAULT_STORM_100K_SEED0_TELEMETRY = FAULT_STORM_100K_SEED0_TELEMETRY

# -- the topology axis: geo-tiered families and the PeerSwap sampler --------
# rounds, p99 node-convergence round, p99 payload latency (rounds) and the
# state digest of each run (jax 0.9.0 on the CPU, run_to_convergence of
# the config's own state, meta and topology)

# config_write_storm_100k(seed=0, topo_family="wan-3x2"): 3 regions × 2 AZs,
# delays 0/1/2 (3 ring slots), loss 0 / 2 % / 10 % by tier
STORM_WAN_3X2_100K_SEED0 = {
    "rounds": 38,
    "p99_node_convergence_round": 34.0,
    "p99_payload_latency_rounds": 24.0,
    "digest": "72bb7596220d68d6",
}

# config_write_storm_100k(seed=0, topo_family="wan-fly-6r"): six regions,
# the measured-RTT delay matrix 0-5 (6 ring slots), 5 % cross-region loss
STORM_WAN_FLY_6R_100K_SEED0 = {
    "rounds": 38,
    "p99_node_convergence_round": 34.0,
    "p99_payload_latency_rounds": 24.0,
    "digest": "30148051f1f32cc9",
}

# config_write_storm_100k(seed=0, topo_family="hetero-degree"): fan-out
# caps 3/2/1 round-robin on the flat topology
STORM_HETERO_DEGREE_100K_SEED0 = {
    "rounds": 33,
    "p99_node_convergence_round": 28.0,
    "p99_payload_latency_rounds": 19.0,
    "digest": "6636b2bbf0a6ae07",
}

# config_write_storm_100k(seed=0, n_nodes=25600, n_payloads=512,
# sampler="peerswap"): the packed round, ground-truth membership, V = 16;
# ``pview_digest`` is `convert.pview_digest` of the final view
STORM_PEERSWAP_25600_SEED0 = {
    "rounds": 39,
    "p99_node_convergence_round": 25.0,
    "p99_payload_latency_rounds": 24.0,
    "digest": "88f6fafd442852d1",
    "pview_digest": "84599380bf2cec63",
}

# config_broadcast_1k(seed=0, topo_family="wan-3x2", sampler="peerswap"):
# the dense round
BROADCAST_1K_WAN_3X2_PEERSWAP_SEED0 = {
    "rounds": 78,
    "p99_node_convergence_round": 75.0,
    "p99_payload_latency_rounds": 16.0,
    "digest": "b82531302e9d0fa9",
    "pview_digest": "a54c20a560f2a181",
}

# config_write_storm_100k(seed=0, topo_family="wan-3x2", telemetry=True):
# the dropped-frames channel comes from the tiered stream
STORM_WAN_3X2_100K_SEED0_TELEMETRY = {'summary': {'rounds': 38,
             'coverage_curve_digest': 'eb1b28ae3890fcd5',
             'coverage_latency_rounds': {'p50': 28.0,
                                         'p95': 36.0,
                                         'p99': 36.0,
                                         'uncovered_payloads': 0},
             'wire_frames': {'broadcast': 1682614020, 'sync': 23526292},
             'fault': {'dropped_frames': 119431448,
                       'cut_edges': 0,
                       'refused_sessions': 0,
                       'crash_node_rounds': 0,
                       'wipes': 0},
             'sync_sessions': 1577835,
             'swim': {'peak_suspect': 178, 'peak_down': 216},
             'gap_overflow_rounds': 0},
 'wire_bytes': {'broadcast': 13783972970496.0,
                'sync': 192727367680.0,
                'per_round_mean': 367807903636.2},
 'bcast_bytes': [1572864.0, 2162688.0, 5603328.0, 12484608.0, 25534464.0,
                 54607872.0, 115777536.0, 244383744.0, 508968960.0,
                 1063845888.0, 2239070208.0, 4658036736.0, 9606905856.0,
                 19536740352.0, 38520938496.0, 71969218560.0, 123545296896.0,
                 189669605376.0, 262029279232.0, 334446231552.0,
                 404627587072.0, 473417482240.0, 541382213632.0,
                 608986791936.0, 676075405312.0, 741954420736.0,
                 805258723328.0, 861490511872.0, 904930197504.0,
                 927614435328.0, 922143948800.0, 888188043264.0,
                 832201555968.0, 765062283264.0, 695836475392.0,
                 627046285312.0, 558830387200.0, 490671243264.0],
 'sync_bytes': [0.0, 196608.0, 491520.0, 2187264.0, 3932160.0, 9945088.0,
                23994368.0, 51986432.0, 35250176.0, 92536832.0, 181706752.0,
                389611520.0, 840531968.0, 1754939392.0, 3426918400.0,
                6004768768.0, 8884576256.0, 10979475456.0, 11582914560.0,
                12012347392.0, 12156878848.0, 12554010624.0, 12758122496.0,
                12950888448.0, 13069967360.0, 13079601152.0, 13170663424.0,
                12774137856.0, 11570167808.0, 9860399104.0, 7151861760.0,
                3799810048.0, 1264467968.0, 252338176.0, 32907264.0,
                2433024.0, 368640.0, 49152.0]}

# -- the protocol axis ------------------------------------------------------
# config_write_storm_100k(seed=0, proto_family=...): the storm under each
# protocol family (`proto.families`), with the run's RunMetrics
# order_violations (the standing delivery-order count summed over the
# rounds; nonzero only under the unchecked negative control).  Baseline
# is STORM_100K_SEED0 with its payload latency and order count.
STORM_BASELINE_100K_SEED0 = {
    "rounds": 28,
    "p99_node_convergence_round": 24.0,
    "p99_payload_latency_rounds": 13.0,
    "digest": "9318cde1da5511ba",
    "order_violations": 0
}

STORM_SWARM_AGGRESSIVE_100K_SEED0 = {
    "rounds": 25,
    "p99_node_convergence_round": 24.0,
    "p99_payload_latency_rounds": 10.0,
    "digest": "3485976e691a30c1",
    "order_violations": 0
}

STORM_PUSH_PULL_100K_SEED0 = {
    "rounds": 22,
    "p99_node_convergence_round": 21.0,
    "p99_payload_latency_rounds": 7.0,
    "digest": "294cd4e8cf59c03e",
    "order_violations": 0
}

STORM_FANOUT_DECAY_100K_SEED0 = {
    "rounds": 42,
    "p99_node_convergence_round": 36.0,
    "p99_payload_latency_rounds": 29.0,
    "digest": "57eef25b9a43c471",
    "order_violations": 0
}

STORM_LAB_ORDERED_100K_SEED0 = {
    "rounds": 240,
    "p99_node_convergence_round": 216.0,
    "p99_payload_latency_rounds": 222.0,
    "digest": "ae68f79e4fbd6a79",
    "order_violations": 0
}

STORM_LAB_ORDERED_BROKEN_100K_SEED0 = {
    "rounds": 28,
    "p99_node_convergence_round": 24.0,
    "p99_payload_latency_rounds": 13.0,
    "digest": "9318cde1da5511ba",
    "order_violations": 2154
}

# config_broadcast_1k(seed=0, proto_family=...) on the dense round
BROADCAST_1K_PUSH_PULL_SEED0 = {
    "rounds": 67,
    "p99_node_convergence_round": 66.0,
    "p99_payload_latency_rounds": 5.0,
    "digest": "27cb76c41c2e06f8",
    "order_violations": 0
}

BROADCAST_1K_LAB_ORDERED_SEED0 = {
    "rounds": 807,
    "p99_node_convergence_round": 799.0,
    "p99_payload_latency_rounds": 695.25,
    "digest": "e5b1b59620a1bf72",
    "order_violations": 0
}

BROADCAST_1K_LAB_ORDERED_BROKEN_SEED0 = {
    "rounds": 73,
    "p99_node_convergence_round": 69.0,
    "p99_payload_latency_rounds": 8.0,
    "digest": "c0523861b0f30759",
    "order_violations": 38
}

# config_write_storm_100k(seed=0, topo_family="wan-3x2",
# proto_family="push-pull"), with telemetry=True for the second entry: the
# frames and bytes channels carry both directions, the dropped frames both
# legs' tiered streams
STORM_WAN_3X2_PUSH_PULL_100K_SEED0 = {
    "rounds": 31,
    "p99_node_convergence_round": 29.0,
    "p99_payload_latency_rounds": 16.0,
    "digest": "80ffab6c56e21c7d",
    "order_violations": 0
}

STORM_WAN_3X2_PUSH_PULL_100K_SEED0_TELEMETRY = {'bcast_bytes': [3244032.0,
                 6914048.0,
                 18915328.0,
                 56999936.0,
                 165453824.0,
                 431177728.0,
                 1200734208.0,
                 3369574400.0,
                 9206710272.0,
                 24671698944.0,
                 63586156544.0,
                 147120947200.0,
                 281276743680.0,
                 428530761728.0,
                 579126231040.0,
                 731598946304.0,
                 883601899520.0,
                 1034394664960.0,
                 1186001453056.0,
                 1339943813120.0,
                 1490887376896.0,
                 1635533717504.0,
                 1770832527360.0,
                 1892463149056.0,
                 1993123168256.0,
                 2044699607040.0,
                 2018547073024.0,
                 1936046424064.0,
                 1804479102976.0,
                 1654017228800.0,
                 1502431150080.0],
 'summary': {'coverage_curve_digest': 'dd260f9317ffffbb',
             'coverage_latency_rounds': {'p50': 21.0,
                                         'p95': 29.0,
                                         'p99': 29.0,
                                         'uncovered_payloads': 0},
             'fault': {'crash_node_rounds': 0,
                       'cut_edges': 0,
                       'dropped_frames': 229123401,
                       'refused_sessions': 0,
                       'wipes': 0},
             'gap_overflow_rounds': 0,
             'rounds': 31,
             'swim': {'peak_down': 133, 'peak_suspect': 178},
             'sync_sessions': 1345734,
             'wire_frames': {'broadcast': 3229659814, 'sync': 16442778}},
 'sync_bytes': [0.0,
                360448.0,
                1015808.0,
                4923392.0,
                12705792.0,
                37224448.0,
                111312896.0,
                315891712.0,
                294420480.0,
                933175296.0,
                2251309056.0,
                4338401280.0,
                5594701824.0,
                6231670784.0,
                7226474496.0,
                7835140096.0,
                8631967744.0,
                9144786944.0,
                9798959104.0,
                9880264704.0,
                9830096896.0,
                9456320512.0,
                9300123648.0,
                9289998336.0,
                9381404672.0,
                7680376832.0,
                5186879488.0,
                1718329344.0,
                203325440.0,
                7651328.0,
                24576.0],
 'wire_bytes': {'broadcast': 26457373933568.0,
                'per_round_mean': 857808811965.9,
                'sync': 134699237376.0}}

# run_fault_plan on _write_storm(100000, 512, proto_family="push-pull")
# under compile_plan(storm_fault_plan(100000, 0)) (factored), packed: the
# pull's loss streams in the loss window, refusals across the half split
FAULT_STORM_PUSH_PULL_100K_SEED0 = {
    "rounds": 24,
    "p99_node_convergence_round": 22.0,
    "p99_payload_latency_rounds": 13.0,
    "digest": "7a89d180aff7a703",
    "order_violations": 0
}

# config_broadcast_1k(seed=0, proto_family="push-pull", topo_family=...):
# the dense pull's flat loss stream (flat-lossy) and its tiers (wan-3x2)
BROADCAST_1K_PUSH_PULL_FLAT_LOSSY_SEED0 = {
    "rounds": 68,
    "p99_node_convergence_round": 66.0,
    "p99_payload_latency_rounds": 5.0,
    "digest": "e47956bea3a42609",
    "order_violations": 0
}

BROADCAST_1K_PUSH_PULL_WAN_3X2_SEED0 = {
    "rounds": 72,
    "p99_node_convergence_round": 70.0,
    "p99_payload_latency_rounds": 9.0,
    "digest": "ba016c3b855a16b7",
    "order_violations": 0
}

# config_broadcast_1k(seed=0, proto_family="push-pull", telemetry=True)
BROADCAST_1K_PUSH_PULL_SEED0_TELEMETRY = {'bcast_bytes': [385024.0,
                 2703360.0,
                 18767872.0,
                 113893376.0,
                 367312896.0,
                 512466944.0,
                 755810304.0,
                 902578176.0,
                 1149984768.0,
                 1302437888.0,
                 1544912896.0,
                 1655422976.0,
                 1810612224.0,
                 1705140224.0,
                 1805271040.0,
                 1704148992.0,
                 1808187392.0,
                 1703575552.0,
                 1800273920.0,
                 1720066048.0,
                 1837875200.0,
                 1694064640.0,
                 1790623744.0,
                 1693958144.0,
                 1793892352.0,
                 1704353792.0,
                 1811144704.0,
                 1703157760.0,
                 1788149760.0,
                 1691107328.0,
                 1833598976.0,
                 1741570048.0,
                 1839915008.0,
                 1737072640.0,
                 1823637504.0,
                 1724940288.0,
                 1828954112.0,
                 1720786944.0,
                 1819082752.0,
                 1697882112.0,
                 1787813888.0,
                 1688412160.0,
                 1793015808.0,
                 1698758656.0,
                 1800814592.0,
                 1698922496.0,
                 1801805824.0,
                 1701527552.0,
                 1821138944.0,
                 1725980672.0,
                 1822384128.0,
                 1722425344.0,
                 1822138368.0,
                 1698324480.0,
                 1799708672.0,
                 1708630016.0,
                 1814970368.0,
                 1712275456.0,
                 1810948096.0,
                 1708072960.0,
                 1810956288.0,
                 1705066496.0,
                 1824555008.0,
                 1717370880.0,
                 1813430272.0,
                 1707655168.0,
                 1789435904.0],
 'summary': {'coverage_curve_digest': '59c03ae72af854c9',
             'coverage_latency_rounds': {'p50': 35.0,
                                         'p95': 64.0,
                                         'p99': 66.0,
                                         'uncovered_payloads': 0},
             'fault': {'crash_node_rounds': 0,
                       'cut_edges': 0,
                       'dropped_frames': 0,
                       'refused_sessions': 0,
                       'wipes': 0},
             'gap_overflow_rounds': 0,
             'rounds': 67,
             'swim': {'peak_down': 0, 'peak_suspect': 0},
             'sync_sessions': 33732,
             'wire_frames': {'broadcast': 12837678, 'sync': 46859}},
 'sync_bytes': [0.0,
                221184.0,
                1196032.0,
                5398528.0,
                5005312.0,
                6823936.0,
                5349376.0,
                9084928.0,
                3432448.0,
                5980160.0,
                4071424.0,
                7135232.0,
                5488640.0,
                7258112.0,
                5611520.0,
                8568832.0,
                4243456.0,
                7544832.0,
                5324800.0,
                7143424.0,
                2990080.0,
                6094848.0,
                5955584.0,
                6651904.0,
                5480448.0,
                6701056.0,
                5292032.0,
                6414336.0,
                5750784.0,
                7061504.0,
                4857856.0,
                7692288.0,
                4530176.0,
                8077312.0,
                4177920.0,
                7962624.0,
                4784128.0,
                8052736.0,
                3489792.0,
                7446528.0,
                4710400.0,
                7225344.0,
                5505024.0,
                6840320.0,
                6021120.0,
                7249920.0,
                4579328.0,
                7430144.0,
                4947968.0,
                7110656.0,
                4759552.0,
                6807552.0,
                4628480.0,
                6168576.0,
                5750784.0,
                6602752.0,
                5595136.0,
                6594560.0,
                5095424.0,
                6651904.0,
                5177344.0,
                6725632.0,
                5169152.0,
                6955008.0,
                5849088.0,
                6602752.0,
                2768896.0],
 'wire_bytes': {'broadcast': 105166258176.0,
                'per_round_mean': 1575375031.4,
                'sync': 383868928.0}}

# -- membership churn and churn schedules ------------------------------------
#
# Pinned from live JAX on the CPU (jax 0.9.0; the detect runs inside the
# batching shim of tests/torch_parity.py, since corrosion_tpu/sim/
# telemetry.py only imports under it).  The detect runs are JAX
# telemetry.run_membership_detect on the churn setup: new_sim(cfg, seed)
# with every third node DOWN at t = 0 (run_detect_ensemble's
# kill_every=3), uniform_payloads(cfg, inject_every=1), the flat
# topology; detected_fraction and false_positive_downs are
# campaign/engine.py _membership_lane_stats of the final state.

# config_swim_churn_64(seed=0): SimConfig.wan_tuned(64, n_payloads=1,
# swim_full_view=True), max_rounds 400
SWIM_CHURN_64_SEED0 = {
    "detect_round": 18,
    "detect_sim_s": 9.0,
    "detected_fraction": 1.0,
    "false_positive_downs": 0,
    "converged": True,
    "digest": "320febe04f83217e",
}

# config_swim_churn_partial(seed=0): SimConfig.wan_tuned(4096,
# n_payloads=1, swim_partial_view=True, probe_period_rounds=1), M = 64,
# max_rounds 600
SWIM_CHURN_PARTIAL_4096_SEED0 = {
    "detect_round": 489,
    "detect_sim_s": 244.5,
    "detected_fraction": 1.0,
    "member_slots": 64,
    "converged": True,
    "digest": "30464f44f42a1a0a",
}

# the same run with telemetry=True: JAX's trace_summary, and
# telemetry.trace_digest over every channel's 489 rows (exact on both
# sides: the one payload is never sent — its writer, node 0, is dead — so
# every byte channel is 0)
SWIM_CHURN_PARTIAL_4096_SEED0_TELEMETRY = {
    "summary": {
        "rounds": 489,
        "coverage_curve_digest": "3b8f46883559f707",
        "coverage_latency_rounds": {"p50": None, "p95": None, "p99": None,
                                    "uncovered_payloads": 1},
        "wire_bytes": {"broadcast": 0.0, "sync": 0.0,
                       "per_round_mean": 0.0},
        "wire_frames": {"broadcast": 0, "sync": 0},
        "fault": {"dropped_frames": 0, "cut_edges": 0,
                  "refused_sessions": 0, "crash_node_rounds": 0,
                  "wipes": 0},
        "sync_sessions": 222103,
        "swim": {"peak_suspect": 10891, "peak_down": 58053},
        "gap_overflow_rounds": 0,
    },
    "trace_digest": "96edc1918a8a4fbe",
}

# config_swim_churn_partial(seed=0, n=100000): the partial-view tier at
# the storm's width, 600 rounds; JAX has not detected by then
SWIM_CHURN_PARTIAL_100K_SEED0 = {
    "detect_round": -1,
    "detect_sim_s": -1,
    "detected_fraction": 0.9999936655984989,
    "member_slots": 64,
    "converged": False,
    "digest": "4b11df2095ef0fda",
}

# _write_storm(100000, 512) (the write storm's config, the packed round),
# run_fault_plan(new_sim(cfg, 0), meta, cfg, Topology(), compile_plan(
# FaultPlan(n_nodes=100000, seed=0, events=flash_crowd_events(100000)),
# cfg, Topology()), max_rounds=3000): nodes 75000-99999 down over rounds
# 0-7, back wiped at round 8 (the factored plan)
FLASH_CROWD_STORM_100K_SEED0 = {
    "rounds": 28,
    "p99_node_convergence_round": 24.0,
    "p99_payload_latency_rounds": 15.0,
    "digest": "0ae5b76327eddb47",
}

# storm-peerswap-25.6k's config (_write_storm(25600, 512,
# sampler="peerswap")) under FaultPlan(n_nodes=25600, seed=0,
# events=flash_crowd_events(25600)) through run_fault_plan, as above;
# the joiners come back with empty PeerSwap views
FLASH_CROWD_PEERSWAP_25600_SEED0 = {
    "rounds": 33,
    "p99_node_convergence_round": 25.0,
    "p99_payload_latency_rounds": 19.0,
    "digest": "7c544c6af95b7662",
    "pview_digest": "3b2041f979b1ad9e",
}

# the 100k fault storm over wan-3x2: _write_storm(100000, 512,
# topo=family wan-3x2) (n_delay_slots 3), run_fault_plan(new_sim(cfg, 0),
# meta, cfg, topo, compile_plan(storm_fault_plan(100000, 0), cfg, topo),
# max_rounds=3000)
FAULT_STORM_WAN_3X2_100K_SEED0 = {
    "rounds": 39,
    "p99_node_convergence_round": 35.0,
    "p99_payload_latency_rounds": 27.0,
    "digest": "52f8246745aa8558",
}

# The seed ensembles (B16): the engine's sim cell over seeds 0-7 of the
# 100k storm, `campaign.spec.storm_seeds_spec()` (storm-100k-seeds8) —
# pinned from JAX's run_campaign(CampaignSpec(name="storm-100k-seeds8",
# scenario=storm_scenario(100000), seeds=range(8), max_rounds=3000),
# out_path=None) on the CPU: the artifact's spec_hash and result_digest,
# and each lane's rounds, p99 node-convergence round and final-state
# digest (the lanes of JAX's run_seed_ensemble, kept from inside the
# call).  JAX's solo runs of seeds 1-7 (run_to_convergence(new_sim(cfg,
# s), ...)) give the same digests; lane 0 is STORM_100K_SEED0.
STORM_100K_SEEDS8 = {
    "spec_hash": "70c01a5924989c83",
    "result_digest": "4b2f83f25aaf5b4cea9b2f071ccd96bf",
    "lanes": [
        {"seed": 0, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "9318cde1da5511ba"},
        {"seed": 1, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "7a4e9a64ea49fa86"},
        {"seed": 2, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "0751071be1be8719"},
        {"seed": 3, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "1893e4c4d0cb9c00"},
        {"seed": 4, "rounds": 27,
         "p99_node_convergence_round": 24.0,
         "digest": "c5d7cf5c8c3b1005"},
        {"seed": 5, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "4fbdbaad19de62bc"},
        {"seed": 6, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "9e1d7ea908dfb28a"},
        {"seed": 7, "rounds": 28,
         "p99_node_convergence_round": 24.0,
         "digest": "52d8c3781bee838c"},
    ],
}

# fault-storm-100k-seeds8: the same cell under storm_fault_plan's events
# (`storm_seeds_spec(faults=True)`; the plan compiled factored, each lane
# re-seeded by derive_seed(s, "sim") & 0x7FFFFFFF), pinned the same way.
# JAX's solo runs of seeds 1-7 (run_fault_plan under compile_plan of the
# plan at seed s) give the same digests; lane 0 is
# FAULT_STORM_100K_SEED0.
FAULT_STORM_100K_SEEDS8 = {
    "spec_hash": "48993bac83614018",
    "result_digest": "5b010cfeb8a58001c594c62f5891fea5",
    "lanes": [
        {"seed": 0, "rounds": 29,
         "p99_node_convergence_round": 25.0,
         "digest": "1cd8919e20ad0df8"},
        {"seed": 1, "rounds": 29,
         "p99_node_convergence_round": 25.0,
         "digest": "d43c6558ccd8f2cf"},
        {"seed": 2, "rounds": 29,
         "p99_node_convergence_round": 26.0,
         "digest": "79043e29e10440ae"},
        {"seed": 3, "rounds": 30,
         "p99_node_convergence_round": 26.0,
         "digest": "c6faaeee24d42429"},
        {"seed": 4, "rounds": 28,
         "p99_node_convergence_round": 25.0,
         "digest": "ca918aac46268ef7"},
        {"seed": 5, "rounds": 29,
         "p99_node_convergence_round": 25.0,
         "digest": "64d5a0dc5e156874"},
        {"seed": 6, "rounds": 30,
         "p99_node_convergence_round": 25.0,
         "digest": "c6989b311b5be8de"},
        {"seed": 7, "rounds": 32,
         "p99_node_convergence_round": 26.0,
         "digest": "85b0610603ec24f1"},
    ],
}


# -- the dense round's seed ensembles (B16, dense half) ----------------------
#
# Each through JAX's `campaign.engine.run_campaign` on the CPU (the
# detect cells inside tests.torch_parity.jax_telemetry()): the artifact's
# spec_hash and result_digest, and per lane (seeds 0-7) the rounds, the
# detect round (None: never detected) or the p99 node-convergence round,
# the detected fraction, the false DOWNs (full view) and the blake2b
# digest of the lane's final state.  JAX's vmapped lanes equal JAX's
# solo runs of each seed at all four shapes (64 and 4096 nodes
# included), so the goldens are both.

# campaign.spec.broadcast_seeds_spec(): config_broadcast_1k as a cell
BROADCAST_1K_SEEDS8 = {
    "spec_hash": "d75dccc16a4f9bd0",
    "result_digest": "fdcbf1321e0b597f373a131baa024b04",
    "lanes": [
        {"seed": 0, "rounds": 73, "p99_node_convergence_round": 69.0,
         "digest": "c0523861b0f30759"},
        {"seed": 1, "rounds": 71, "p99_node_convergence_round": 69.0,
         "digest": "84d2ea853e29fb71"},
        {"seed": 2, "rounds": 70, "p99_node_convergence_round": 69.0,
         "digest": "4433db24225ae57e"},
        {"seed": 3, "rounds": 70, "p99_node_convergence_round": 69.0,
         "digest": "acf63a1d0a51a38f"},
        {"seed": 4, "rounds": 70, "p99_node_convergence_round": 69.0,
         "digest": "b27e8decd82ecbfd"},
        {"seed": 5, "rounds": 70, "p99_node_convergence_round": 69.0,
         "digest": "9d36e56b40b7b343"},
        {"seed": 6, "rounds": 70, "p99_node_convergence_round": 68.0,
         "digest": "0f7ea210475fabe1"},
        {"seed": 7, "rounds": 71, "p99_node_convergence_round": 69.0,
         "digest": "3e8eb1ca9362e93d"},
    ],
}

# swim_churn_64_spec(seeds=range(8))
SWIM_CHURN_64_SEEDS8 = {
    "spec_hash": "985184187fdc4c18",
    "result_digest": "aac5ed4f3578bc804b286689b2004018",
    "lanes": [
        {"seed": 0, "rounds": 18, "detect_round": 18,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "320febe04f83217e"},
        {"seed": 1, "rounds": 19, "detect_round": 19,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "f8ae1acedf401573"},
        {"seed": 2, "rounds": 20, "detect_round": 20,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "0d817472e1211aa0"},
        {"seed": 3, "rounds": 20, "detect_round": 20,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "cf99034573f72d8c"},
        {"seed": 4, "rounds": 19, "detect_round": 19,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "3a0a0f73e31610c2"},
        {"seed": 5, "rounds": 18, "detect_round": 18,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "d3c3fe528b8be475"},
        {"seed": 6, "rounds": 17, "detect_round": 17,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "a1fdbc65dabe1c04"},
        {"seed": 7, "rounds": 16, "detect_round": 16,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "63a5dab1001aed71"},
    ],
}

# swim_churn_64_spec(seeds=range(8), n=4096): membership_churn(4096)'s
# shape
SWIM_CHURN_FULL_4096_SEEDS8 = {
    "spec_hash": "f40da8383a3d7b2c",
    "result_digest": "24785e7ee03ddd766ba3dbfeecee864f",
    "lanes": [
        {"seed": 0, "rounds": 46, "detect_round": 46,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "ba94e70d5efbab4c"},
        {"seed": 1, "rounds": 46, "detect_round": 46,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "aef8f978e61bd38b"},
        {"seed": 2, "rounds": 40, "detect_round": 40,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "ec8508bd82b383ed"},
        {"seed": 3, "rounds": 44, "detect_round": 44,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "22d619b38ef9a913"},
        {"seed": 4, "rounds": 44, "detect_round": 44,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "0f0a1b11b8fc8d29"},
        {"seed": 5, "rounds": 42, "detect_round": 42,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "a88d823e0c5ec456"},
        {"seed": 6, "rounds": 44, "detect_round": 44,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "d71dbe1112feda3c"},
        {"seed": 7, "rounds": 38, "detect_round": 38,
         "detected_fraction": 1.0, "false_positive_downs": 0,
         "digest": "22c0b7e339fb83ba"},
    ],
}

# swim_churn_partial_spec(seeds=range(8))
SWIM_CHURN_PARTIAL_4096_SEEDS8 = {
    "spec_hash": "c03e2e97bb1cbbe1",
    "result_digest": "56a0ef1ae7f9fcfa19ffd226af9e43b6",
    "lanes": [
        {"seed": 0, "rounds": 489, "detect_round": 489,
         "detected_fraction": 1.0, "digest": "30464f44f42a1a0a"},
        {"seed": 1, "rounds": 568, "detect_round": 568,
         "detected_fraction": 1.0, "digest": "e9df362d68cc6dff"},
        {"seed": 2, "rounds": 523, "detect_round": 523,
         "detected_fraction": 1.0, "digest": "af5391bcd593fea3"},
        {"seed": 3, "rounds": 488, "detect_round": 488,
         "detected_fraction": 1.0, "digest": "97e66789f8e32f2f"},
        {"seed": 4, "rounds": 526, "detect_round": 526,
         "detected_fraction": 1.0, "digest": "4ca2318b45864920"},
        {"seed": 5, "rounds": 569, "detect_round": 569,
         "detected_fraction": 1.0, "digest": "026df605ad028c8b"},
        {"seed": 6, "rounds": 421, "detect_round": 421,
         "detected_fraction": 1.0, "digest": "f738067e4dc85478"},
        {"seed": 7, "rounds": 600, "detect_round": None,
         "detected_fraction": 0.9999828526355499,
         "digest": "2e35a4bf6c365f5e"},
    ],
}

# swim_churn_partial_spec(seeds=range(8), n=100000): the spec hash from
# JAX; JAX's 8-lane CPU run does not fit a session, so lane 0 is
# SWIM_CHURN_PARTIAL_100K_SEED0 (JAX's solo run) and lanes 1-7 are held
# to the port's solo runs on the card
SWIM_CHURN_PARTIAL_100K_SEEDS8 = {
    "spec_hash": "00fa857b724422ca",
    "lane0": {
        "seed": 0,
        "rounds": 600,
        "detect_round": None,
        "detected_fraction": 0.9999936655984989,
        "digest": "4b11df2095ef0fda",
    },
}

# configs #2/#2b through JAX's engine (config_swim_churn_64(seed=0),
# config_swim_churn_partial(seed=0)): the one-seed cells' artifact keys;
# at 100k (config_swim_churn_partial(seed=0, n=100000)) the spec hash
# alone
CHURN_CONFIG_ENGINE_KEYS = {
    "swim_churn_64": {
        "spec_hash": "9d9d65cd293398f1",
        "result_digest": "b22370c7956e4ff53b3d2fee8f80954d",
    },
    "swim_churn_partial_4096": {
        "spec_hash": "ce7b33791aa01fce",
        "result_digest": "09b03138035aa25796e601737184f90b",
    },
    "swim_churn_partial_100k": {"spec_hash": "83c262822b4dd231"},
}
