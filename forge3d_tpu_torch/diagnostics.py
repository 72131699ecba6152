# forge3d_tpu_torch/diagnostics.py
# A host copy of forge3d_tpu/diagnostics.py for the PyTorch port (Severity,
# Diagnostic and ValidationReport; the memory telemetry reports are not
# copied): the port imports no module of the JAX package, so it keeps its own
# copy, held against the original by tests/test_torch_host_copies.py. The
# original's notes follow.
#
# Structured diagnostics with severity + render-blocking policies.
#
# Parity notes (reference behavior, not code):
#   forge3d:python/forge3d/diagnostics.py (1.1k) — Diagnostic
#   objects with severity, category codes, render policies that decide
#   whether a recipe may render (block on error, warn-through), and stats
#   endpoints aggregation.

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional


class Severity(IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    FATAL = 3


@dataclass(frozen=True)
class Diagnostic:
    severity: Severity
    code: str               # stable machine code, e.g. "terrain.missing_dem"
    message: str
    subject: Optional[str] = None   # which recipe element

    def as_dict(self) -> dict:
        return {
            "severity": self.severity.name.lower(),
            "code": self.code,
            "message": self.message,
            "subject": self.subject,
        }


@dataclass
class ValidationReport:
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, severity: Severity, code: str, message: str,
            subject: Optional[str] = None) -> None:
        self.diagnostics.append(Diagnostic(severity, code, message, subject))

    def info(self, code, message, subject=None):
        self.add(Severity.INFO, code, message, subject)

    def warning(self, code, message, subject=None):
        self.add(Severity.WARNING, code, message, subject)

    def error(self, code, message, subject=None):
        self.add(Severity.ERROR, code, message, subject)

    def fatal(self, code, message, subject=None):
        self.add(Severity.FATAL, code, message, subject)

    @property
    def max_severity(self) -> Severity:
        if not self.diagnostics:
            return Severity.INFO
        return max(d.severity for d in self.diagnostics)

    def blocking(self, policy: str = "block_on_error") -> List[Diagnostic]:
        """Diagnostics that block rendering under the given policy
        (reference: diagnostics.py:60-94 render policies)."""
        if policy == "block_on_error":
            thr = Severity.ERROR
        elif policy == "block_on_warning":
            thr = Severity.WARNING
        elif policy == "never_block":
            thr = Severity.FATAL + 1
        else:
            raise ValueError(f"unknown render policy {policy!r}")
        return [d for d in self.diagnostics if d.severity >= thr]

    def raise_if_blocking(self, policy: str = "block_on_error") -> None:
        from .errors import RenderError

        blocking = self.blocking(policy)
        if blocking:
            lines = "; ".join(f"[{d.code}] {d.message}" for d in blocking)
            raise RenderError(f"render blocked by diagnostics: {lines}")

    def as_dict(self) -> dict:
        return {
            "max_severity": self.max_severity.name.lower(),
            "diagnostics": [d.as_dict() for d in self.diagnostics],
        }

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)
