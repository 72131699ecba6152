# forge3d_tpu_torch/mem.py
# The resource ledger of forge3d_tpu/mem.py, copied: render paths register
# their logical device resources, and the policy decides whether an
# over-budget registration raises (enforce), records a degradation (warn)
# or passes (off). The JAX package's `metrics()` also asks the JAX runtime
# for live device memory; this copy reports the ledger alone.

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List

from .errors import MemoryBudgetExceeded

#: Default tracked-resource budget (the JAX package's 512 MiB).
MEMORY_BUDGET_CAP: int = 512 * 1024 * 1024

_VALID_POLICIES = ("enforce", "warn", "off")


@dataclass
class _Resource:
    name: str
    kind: str  # "buffer" | "texture" | "pyramid" | ...
    nbytes: int


_DEGRADATIONS: List[dict] = []


def record_degradation(category: str, message: str) -> None:
    """forge3d_tpu.degradation.record_degradation's record, kept here."""
    _DEGRADATIONS.append({"category": category, "message": message,
                          "timestamp": time.time()})


class MemoryTracker:
    def __init__(self, budget_bytes: int = MEMORY_BUDGET_CAP) -> None:
        self._lock = threading.Lock()
        self._budget = int(budget_bytes)
        self._policy = "enforce"
        self._resources: Dict[int, _Resource] = {}
        self._next_id = 1
        self._peak = 0
        self._total_allocs = 0

    # -- policy ------------------------------------------------------------
    def set_policy(self, policy: str) -> None:
        if policy not in _VALID_POLICIES:
            raise ValueError(f"policy must be one of {_VALID_POLICIES}, got {policy!r}")
        with self._lock:
            self._policy = policy

    def get_policy(self) -> str:
        with self._lock:
            return self._policy

    def set_budget(self, nbytes: int) -> None:
        with self._lock:
            self._budget = int(nbytes)

    @property
    def budget_bytes(self) -> int:
        with self._lock:
            return self._budget

    # -- ledger ------------------------------------------------------------
    def track(self, name: str, nbytes: int, kind: str = "buffer") -> int:
        """Register a logical device resource; returns a handle id.

        Raises MemoryBudgetExceeded under the 'enforce' policy when the
        tracked total would exceed the budget.
        """
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        with self._lock:
            in_use = sum(r.nbytes for r in self._resources.values())
            if self._policy == "enforce" and in_use + nbytes > self._budget:
                raise MemoryBudgetExceeded(
                    f"allocation '{name}' of {nbytes} B would exceed the "
                    f"{self._budget} B budget ({in_use} B in use)",
                    requested_bytes=nbytes,
                    budget_bytes=self._budget,
                )
            if self._policy == "warn" and in_use + nbytes > self._budget:
                record_degradation(
                    "memory_budget",
                    f"tracked use {in_use + nbytes} B exceeds budget {self._budget} B",
                )
            rid = self._next_id
            self._next_id += 1
            self._resources[rid] = _Resource(name, kind, nbytes)
            self._total_allocs += 1
            self._peak = max(self._peak, in_use + nbytes)
            return rid

    def free(self, rid: int) -> None:
        with self._lock:
            self._resources.pop(rid, None)

    def reset(self) -> None:
        with self._lock:
            self._resources.clear()
            self._peak = 0
            self._total_allocs = 0

    # -- reporting ----------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            in_use = sum(r.nbytes for r in self._resources.values())
            by_kind: Dict[str, int] = {}
            for r in self._resources.values():
                by_kind[r.kind] = by_kind.get(r.kind, 0) + r.nbytes
            return {
                "tracked_bytes": in_use,
                "peak_tracked_bytes": self._peak,
                "budget_bytes": self._budget,
                "policy": self._policy,
                "resource_count": len(self._resources),
                "total_allocations": self._total_allocs,
                "by_kind": by_kind,
                "within_budget": in_use <= self._budget,
            }


_GLOBAL = MemoryTracker()


def global_tracker() -> MemoryTracker:
    return _GLOBAL

