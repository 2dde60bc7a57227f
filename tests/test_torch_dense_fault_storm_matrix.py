"""The fault storm at 600 nodes, four seeds, on the dense round under its
matrix plan (JAX's form below 1024 nodes: the half split's cuts and the
loss as [R+1, N, N] slabs) through both packages' ``run_campaign`` on
the CPU: the artifact and every lane of the port's lane-batched fault
loop (K9m's folded edge queries and reach lane entry, K11d, K12f, K14x
lanes) against JAX's vmapped one.  Alone in its file: JAX's compile of
the vmapped loop takes most of a minute."""

import jax
import pytest

from corrosion_tpu.campaign import ensemble as jens
from corrosion_tpu.campaign.engine import run_campaign as jrun_campaign
from corrosion_tpu.campaign.spec import CampaignSpec as JaxSpec
from corrosion_tpu_torch.campaign.engine import run_campaign
from corrosion_tpu_torch.campaign.spec import storm_seeds_spec
from tests.torch_parity import assert_lanes_equal_jax


@pytest.mark.campaign
def test_matrix_fault_storm_600_equals_live_jax():
    """Lanes that finish at different rounds (the golden cell's shape at
    600 nodes): spec_hash, result_digest, per-seed records and bands
    equal JAX's, and every lane's state and stamps."""
    spec = storm_seeds_spec((0, 1, 2, 3), n_nodes=600, faults=True)
    kept = {}
    orig = jens.run_seed_ensemble

    def keeping(*args, **kw):
        out = orig(*args, **kw)
        kept["out"] = out
        return out

    jens.run_seed_ensemble = keeping
    try:
        want = jrun_campaign(JaxSpec.from_dict(spec.to_dict()),
                             out_path=None)
    finally:
        jens.run_seed_ensemble = orig
    lanes_out = {}
    got = run_campaign(spec, device="cpu", lanes_out=lanes_out)
    assert got["spec_hash"] == want["spec_hash"]
    assert got["result_digest"] == want["result_digest"]
    cell, jcell = got["cells"][0], want["cells"][0]
    for key in ("per_seed", "bands", "round_path", "plan_horizon"):
        assert cell[key] == jcell[key], key
    assert cell["round_path"] == "dense"
    assert len(set(cell["per_seed"]["rounds"])) > 1
    jf, jm = kept["out"][:2]
    assert_lanes_equal_jax(jf, jm, lanes_out[0]["finals"],
                           lanes_out[0]["metrics"], "matrix-600")
    assert jax.tree.leaves(jf)
