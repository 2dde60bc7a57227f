"""Results of the JAX reference pinned for runs without JAX.

Each entry is what the JAX package (``corrosion_tpu``, jax 0.9.0 on the
CPU) produces for the write storm at the given size and seed, faultless
or under ``storm_fault_plan`` (factored): rounds to convergence, the
p99 node-convergence round, and the blake2b digest of the final state
(`convert.state_digest`, equal to the JAX suite's ``_digest``).
``chip_smoke.py`` holds the port's runs on the card against them;
``tests/test_torch_storm.py`` and ``tests/test_torch_fault_storm.py``
hold them against live JAX (the 100k entries under ``-m slow``).
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
