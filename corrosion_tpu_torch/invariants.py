"""Runtime invariant catalog: always / sometimes assertions — the port's
copy of the parts of ``corrosion_tpu/invariants.py`` the checked fault
driver (`sim.faults.run_fault_plan_checked`) uses: `Catalog` with
``always``, ``sometimes``, ``unfired_sometimes`` and ``report``, and the
process-wide `CATALOG`.

Every assertion registers itself by name on first use.  An ``always``
must hold each time it is reached: a violation is counted, logged, and
raised in ``strict`` mode.  A ``sometimes`` is a coverage marker: it
must hold at least once over a run, and ``unfired_sometimes`` lists the
ones that never did.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class AssertionState:
    kind: str  # 'always' | 'sometimes'
    passes: int = 0
    violations: int = 0
    last_details: Optional[dict] = None


class InvariantViolation(AssertionError):
    def __init__(self, name: str, kind: str, details: Optional[dict]):
        super().__init__(f"invariant {kind} {name!r} violated: {details!r}")
        self.name = name
        self.kind = kind
        self.details = details


class Catalog:
    def __init__(self):
        self._lock = threading.Lock()
        self._asserts: Dict[str, AssertionState] = {}
        self.strict = False  # raise on violation

    def _state(self, name: str, kind: str) -> AssertionState:
        st = self._asserts.get(name)
        if st is None:
            st = self._asserts[name] = AssertionState(kind=kind)
        return st

    def always(self, cond: bool, name: str, details: Optional[dict] = None):
        """Must hold every time execution reaches it."""
        with self._lock:
            st = self._state(name, "always")
            if cond:
                st.passes += 1
                return
            st.violations += 1
            st.last_details = details
        logging.getLogger("corrosion_tpu_torch.invariants").warning(
            "invariant always %r violated: %r", name, details
        )
        if self.strict:
            raise InvariantViolation(name, "always", details)

    def sometimes(self, cond: bool, name: str, details: Optional[dict] = None):
        """Coverage marker: must hold at least once over a run."""
        with self._lock:
            st = self._state(name, "sometimes")
            if cond:
                st.passes += 1
            else:
                st.last_details = details

    def unfired_sometimes(self) -> List[str]:
        """`sometimes` markers that never held."""
        with self._lock:
            return sorted(
                n
                for n, st in self._asserts.items()
                if st.kind == "sometimes" and st.passes == 0
            )

    def report(self) -> dict:
        with self._lock:
            return {
                n: {
                    "kind": st.kind,
                    "passes": st.passes,
                    "violations": st.violations,
                }
                for n, st in sorted(self._asserts.items())
            }


#: process-wide catalog
CATALOG = Catalog()
