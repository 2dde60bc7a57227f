"""K4's function, the partial-view SWIM table merge, branch by branch
(the cases of tests/torch_merge_cases.py, one per branch of JAX
``_merge_entries``): the port's plain version (`pswim.merge_entries_plain`,
what the card's kernel is held to) must equal live JAX with and without
the packed pre-merge table ``ptbl``, and each case asserts that its branch
fired.  Integer state, so every comparison is exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.sim import pswim as jpswim
from corrosion_tpu.sim.state import SimConfig as JaxSimConfig
from corrosion_tpu_torch.sim import pswim
from tests import torch_merge_cases as mc

JCFG = JaxSimConfig(n_nodes=mc.N, n_payloads=32, swim_partial_view=True,
                    member_slots=mc.M, down_gc_rounds=mc.GC)
_merge = jax.jit(jpswim._merge_entries, static_argnums=(8,))


@pytest.mark.parametrize("with_ptbl", (False, True), ids=("tables", "ptbl"))
@pytest.mark.parametrize("case", sorted(mc.CASES))
def test_merge_branch(case, with_ptbl):
    inputs, fired = mc.build(case)
    want = _merge(*(jnp.asarray(x) for x in inputs), jnp.int32(mc.T), JCFG)
    args = [torch.from_numpy(x) for x in inputs]
    ptbl = pswim._pack_tables(args[0], args[1]) if with_ptbl else None
    got = pswim.merge_entries_plain(*args, mc.T, mc.GC, ptbl)
    for name, w, p in zip(("pid", "pkey", "psince"), want, got):
        np.testing.assert_array_equal(np.asarray(w), p.numpy(),
                                      err_msg=name)
    assert fired(inputs[:3], [p.numpy() for p in got]), \
        f"{case} did not fire"
