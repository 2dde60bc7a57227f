"""State carried across between the JAX package and the port.

The JAX side hands over plain numpy arrays under its own field names;
this module maps them onto the port's tensors and back, in JAX's dtypes:
u8 for ``have``, the rings and ``relay_left``; u32 for ``key`` and
``incarnation``; i8 for ``view``; i32 for the rest.  The port's word
ring ``inflight [D, N, W]`` goes back to JAX's dense u8 ``[D, N, P]``.
`state_digest` is the blake2b fingerprint the JAX suite pins final
states with, taken over `state_to_numpy` (it skips the PeerSwap view
``pview`` by default, as the JAX suite's does; `pview_digest` is the
same fingerprint over ``pview`` alone).  `fault_plan_from_numpy` maps
a compiled fault plan across, factored or matrix (its absent classes
None), so both packages can run the very same plan.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable

import numpy as np
import torch

from .device import resolve_device
from .sim.faults import FactoredFaultPlan, SimFaultPlan
from .sim.words import pack_bits, unpack_bits
from .sim.state import PayloadMeta, SimConfig, SimState, packed_supported

_JAX_DTYPES = {
    "t": np.int32,
    "key": np.uint32,
    "have": np.uint8,
    "injected": np.uint8,
    "relay_left": np.uint8,
    "inflight": np.uint8,
    "sync_inflight": np.uint8,
    "alive": np.uint8,
    "incarnation": np.uint32,
    "view": np.int8,
}


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The port's state as numpy arrays in JAX's field names and dtypes."""
    out = {}
    for name, value in zip(SimState._fields, state):
        if name == "inflight" and value.dtype == torch.int32:
            value = unpack_bits(value, value.shape[-1] * 32)
        arr = value.detach().cpu().numpy()
        out[name] = arr.astype(_JAX_DTYPES.get(name, np.int32))
    return out


def state_from_numpy(
    d: Dict[str, np.ndarray], cfg: SimConfig, device="cuda"
) -> SimState:
    """The port's state from JAX's (numpy arrays under JAX field names)."""
    dev = resolve_device(device)
    fields = {}
    for name in SimState._fields:
        arr = np.array(d[name])  # a writable copy
        if name == "t":
            fields[name] = torch.tensor(int(arr), dtype=torch.int32)
        elif name == "key":
            fields[name] = torch.from_numpy(arr.astype(np.int64)).to(dev)
        elif name == "inflight" and packed_supported(cfg):
            fields[name] = pack_bits(torch.from_numpy(arr).to(dev))
        elif arr.dtype in (np.uint8, np.int8):
            fields[name] = torch.from_numpy(arr).to(dev)
        else:
            fields[name] = torch.from_numpy(arr.astype(np.int32)).to(dev)
    ring = fields["inflight"]
    width = ring.shape[-1] * (32 if ring.dtype == torch.int32 else 1)
    if width != cfg.n_payloads:
        raise ValueError("inflight ring does not match cfg.n_payloads")
    return SimState(**fields)


def meta_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> PayloadMeta:
    dev = resolve_device(device)
    return PayloadMeta(**{
        name: torch.from_numpy(np.asarray(d[name]).astype(np.int32)).to(dev)
        for name in PayloadMeta._fields
    })


def fault_plan_from_numpy(d: Dict[str, np.ndarray], device="cuda"):
    """The port's compiled plan from JAX's (numpy arrays under its field
    names, in its dtypes): a `SimFaultPlan` when ``d`` has the matrix
    fields, whose absent classes (None, or an object array holding None)
    stay None, else a `FactoredFaultPlan`; ``seed`` stays on the host."""
    dev = resolve_device(device)
    form = SimFaultPlan if "block" in d else FactoredFaultPlan
    fields = {}
    for name in form._fields:
        value = d[name]
        if value is None or (isinstance(value, np.ndarray)
                             and value.dtype == object):
            fields[name] = None
            continue
        arr = np.array(value)  # a writable copy
        if name == "seed":
            fields[name] = torch.tensor(int(arr), dtype=torch.int32)
        else:
            fields[name] = torch.from_numpy(arr).to(dev)
    return form(**fields)


def state_digest(state: SimState, skip: Iterable[str] = ("pview",)) -> str:
    """blake2b over the state fields in JAX's layout and order (the JAX
    suite's ``_digest``, with the same default skip of ``pview``)."""
    h = hashlib.blake2b(digest_size=8)
    skip = set(skip)
    for name, arr in state_to_numpy(state).items():
        if name in skip:
            continue
        h.update(name.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def pview_digest(state: SimState) -> str:
    """blake2b over the PeerSwap view alone (``pview``, the field
    `state_digest` skips by default), in the same layout."""
    return state_digest(state, skip=[f for f in SimState._fields
                                     if f != "pview"])
