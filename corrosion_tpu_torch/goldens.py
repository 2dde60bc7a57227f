"""Results of the JAX reference pinned for runs without JAX.

Each entry is what the JAX package (``corrosion_tpu``, jax 0.9.0 on the
CPU) produces for one scenario and seed: rounds to convergence, the p99
node-convergence round (the gapstress entries also the p99 payload
latency and the largest gap-overflow share), and the blake2b digest of
the final state (`convert.state_digest`, equal to the JAX suite's
``_digest``); the comment above each names the JAX call.
``chip_smoke.py`` holds the port's runs on the card against them;
``tests/test_torch_storm.py``, ``tests/test_torch_fault_storm.py``,
``tests/test_torch_dense.py``, ``tests/test_torch_swim_full.py`` and
``tests/test_torch_gapstress.py`` hold them against live JAX (the
largest under ``-m slow``).  The ``*_TELEMETRY`` entries at the end are
the same runs' flight-recorder summaries and per-round byte channels;
``tests/test_torch_telemetry.py`` holds the 3-node and broadcast-1k ones
against live JAX.
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
