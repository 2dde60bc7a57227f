"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
inputs made from a seed with numpy, handed to the JAX reference and to
the port (device="cpu", plain torch versions), and compared exactly."""

import contextlib
import dataclasses
import hashlib
import importlib
import sys

import numpy as np
import torch

from corrosion_tpu.sim.runner import _write_storm as jax_write_storm
from corrosion_tpu_torch.convert import state_from_numpy, state_to_numpy
from corrosion_tpu_torch.sim.runner import _write_storm as port_write_storm

# the suite runs under xdist beside wall-clock-sensitive tests (the host
# ground-truth calibration skips when its event loop starves): one
# intra-op thread keeps the port's CPU tensors from taking every core
torch.set_num_threads(1)


def fields(named_tuple) -> dict:
    """A JAX or port NamedTuple as {field: numpy array}."""
    out = {}
    for name, value in zip(type(named_tuple)._fields, named_tuple):
        if isinstance(value, torch.Tensor):
            value = value.cpu()
        out[name] = np.asarray(value)
    return out


def assert_fields_equal(want: dict, got: dict, label: str) -> None:
    assert want.keys() == got.keys(), label
    for name in want:
        np.testing.assert_array_equal(
            want[name], got[name], err_msg=f"{label}: field {name}"
        )
        assert want[name].dtype == got[name].dtype, f"{label}: {name} dtype"


def storm_configs(n_nodes: int, n_payloads: int):
    """(jax cfg, jax meta, port cfg, port meta) of the write storm with
    the packed envelope forced open at test scale."""
    jcfg, jmeta = jax_write_storm(n_nodes, n_payloads)
    pcfg, pmeta = port_write_storm(n_nodes, n_payloads, "cpu")
    return (
        dataclasses.replace(jcfg, packed_min_cells=0), jmeta,
        dataclasses.replace(pcfg, packed_min_cells=0), pmeta,
    )


def to_port(jax_state, cfg):
    return state_from_numpy(fields(jax_state), cfg, "cpu")


def port_fields(state) -> dict:
    return state_to_numpy(state)


def random_tables(rng, n, m, t):
    """Member tables as a long run leaves them: residue-mapped ids with
    -1 empties, keys across ALIVE/SUSPECT/DOWN with incarnations up to
    the clamp (packed words then carry bit 31), psince stamps up to t."""
    ids = np.arange(m)[None, :] + m * rng.integers(0, (n + m - 1) // m, (n, m))
    pid = np.where((ids < n) & (rng.random((n, m)) > 0.15), ids, -1)
    inc = np.where(
        rng.random((n, m)) < 0.2,
        rng.integers(1024, 2047, (n, m)),
        rng.integers(0, 4, (n, m)),
    )
    pkey = np.where(pid >= 0, inc * 4 + rng.integers(0, 3, (n, m)), -1)
    psince = np.where(
        rng.random((n, m)) < 0.5, rng.integers(0, t + 1, (n, m)), -1
    )
    return (pid.astype(np.int32), pkey.astype(np.int32),
            psince.astype(np.int32))


def jax_digest(state, skip=("pview",)) -> str:
    """tests/sim/test_topo.py's _digest of a JAX state (blake2b over its
    fields), live — the port's `convert.state_digest` must equal it."""
    h = hashlib.blake2b(digest_size=8)
    for f, v in zip(type(state)._fields, state):
        if f in skip:
            continue
        h.update(f.encode())
        h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()


def assert_states_equal(jax_state, port_state, label: str) -> None:
    assert_fields_equal(fields(jax_state), port_fields(port_state), label)


def assert_metrics_equal(jax_metrics, port_metrics, label: str) -> None:
    """RunMetrics field for field, exactly: overflow_frac is one f32 mean
    (an exact integer sum over an f32 cell count) on both sides."""
    assert_fields_equal(fields(jax_metrics), fields(port_metrics), label)


_JAX_TELEMETRY = "corrosion_tpu.sim.telemetry"


@contextlib.contextmanager
def jax_telemetry():
    """The JAX flight recorder, importable for the length of a ``with``.

    ``corrosion_tpu/sim/telemetry.py:77`` tests ``_ob_p not in
    batching.primitive_batchers``; under jax 0.9.0 that object is a
    ``PrimitiveBatchersProxy`` without ``__contains__``, so the import
    raises TypeError.  Inside the block the proxy answers ``in`` from
    the batcher table it writes to (jax already registers the
    optimization barrier there, so the module registers nothing) and
    the module is yielded.  On exit the patch is removed, the module is
    dropped from ``sys.modules`` and from its package, and jax's
    in-memory compile caches are cleared, so nothing traced under the
    shim serves a later caller: every other test in the same worker
    sees the JAX package exactly as it would without this block."""
    import jax
    from jax._src.interpreters import batching

    proxy = batching.PrimitiveBatchersProxy
    had = "__contains__" in proxy.__dict__
    old = proxy.__dict__.get("__contains__")
    proxy.__contains__ = lambda self, prim: (
        prim in batching.fancy_primitive_batchers)
    try:
        yield importlib.import_module(_JAX_TELEMETRY)
    finally:
        if had:
            proxy.__contains__ = old
        else:
            del proxy.__contains__
        sys.modules.pop(_JAX_TELEMETRY, None)
        package = sys.modules.get("corrosion_tpu.sim")
        if package is not None and hasattr(package, "telemetry"):
            delattr(package, "telemetry")
        jax.clear_caches()
