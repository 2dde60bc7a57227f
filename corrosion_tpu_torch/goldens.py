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
largest under ``-m slow``).
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
