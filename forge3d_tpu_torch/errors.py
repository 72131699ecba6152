# forge3d_tpu_torch/errors.py
# The exception hierarchy of forge3d_tpu/errors.py, copied with its class
# names and bases so that the port raises what the JAX package raises
# without importing it.

from __future__ import annotations


class RenderError(RuntimeError):
    """Base class for all render-path failures."""


class UploadError(RenderError):
    """Invalid input data handed to a device upload (bad shape/dtype/NaN)."""


class DeviceError(RenderError):
    """Device acquisition or execution failure (poisoned context, no TPU)."""


class MemoryBudgetExceeded(RenderError):
    """An allocation would exceed the enforced HBM budget.

    Mirrors the reference's 512 MiB host-visible budget policy
    (src/util/memory_budget.rs:11-12) re-targeted at TPU HBM accounting.
    """

    def __init__(self, message: str, requested_bytes: int = 0, budget_bytes: int = 0):
        super().__init__(message)
        self.requested_bytes = int(requested_bytes)
        self.budget_bytes = int(budget_bytes)


class DegradedCapability(RenderError):
    """A requested capability is unavailable and was degraded or refused."""


class TransformFailed(RenderError):
    """A CRS / geometry transform could not be applied."""


class ExperimentalSyntheticOutput(RenderError):
    """Raised when a deterministic synthetic (non-hardware) output would be
    produced without the caller explicitly opting in (``synthetic_ok=True``)."""


class ConvergenceError(RenderError):
    """A converged reference render failed to meet its variance gate.

    The reference refuses to return a non-converged image
    (src/path_tracing/hybrid_compute/render_terrain.rs:1181-1189); we keep
    that fail-closed contract.
    """

    def __init__(self, message: str, frames: int = 0, variance: float = float("inf")):
        super().__init__(message)
        self.frames = int(frames)
        self.variance = float(variance)


class ContractViolation(RenderError):
    """A runtime value-safety contract on kernel outputs was violated.

    TPU-native stand-in for the reference's shader-contract runtime asserts
    (src/terrain/renderer/runtime_contract.rs, src/verify/mod.rs).
    """
