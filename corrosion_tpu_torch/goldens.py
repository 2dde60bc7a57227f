"""Results of the JAX reference pinned for runs without JAX.

Each entry is what the JAX package (``corrosion_tpu``, jax 0.9.0 on the
CPU) produces for the write storm at the given size and seed: rounds to
convergence, the p99 node-convergence round, and the blake2b digest of
the final state (`convert.state_digest`, equal to the JAX suite's
``_digest``).  ``chip_smoke.py`` holds the port's runs on the card
against them; ``tests/test_torch_storm.py`` holds them against live JAX
(the 100k entry under ``-m slow``).
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
