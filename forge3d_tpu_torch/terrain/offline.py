# forge3d_tpu_torch/terrain/offline.py
# The offline progressive-accumulation driver of
# forge3d_tpu/terrain/offline.py (the TV12 print pipeline):
# render_offline(renderer, ...) accumulates batches of jittered samples
# (kernel R1 step) until the tile-luminance deltas converge with an upward
# trend, resolves the HDR mean, optionally denoises it with the guided
# a-trous filter (kernel E3) and tonemaps it.

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..errors import RenderError
from ..frame import AovFrame, Frame, HdrFrame

_CONVERGENCE_TREND_WINDOW = 3


@dataclass
class OfflineQualitySettings:
    """Offline accumulation quality policy."""

    enabled: bool = False
    max_samples: int = 256
    min_samples: int = 8
    batch_size: int = 8
    convergence_threshold: float = 1e-3
    converged_ratio_target: float = 0.98
    denoiser: str = "off"  # off|atrous|svgf
    denoise_iterations: int = 5

    def validate(self) -> None:
        if self.max_samples < 1 or self.batch_size < 1:
            raise ValueError("max_samples and batch_size must be >= 1")
        if self.min_samples > self.max_samples:
            raise ValueError("min_samples must be <= max_samples")
        if self.denoiser not in ("off", "atrous", "svgf"):
            raise ValueError(f"unknown denoiser {self.denoiser!r}")


@dataclass
class OfflineProgress:
    samples_so_far: int
    max_samples: int
    mean_delta: float
    p95_delta: float
    converged_ratio: float
    elapsed_ms: float


@dataclass
class OfflineResult:
    frame: Frame
    hdr_frame: HdrFrame
    aov_frame: AovFrame
    metadata: dict


def _upward_trend(history) -> bool:
    if len(history) < _CONVERGENCE_TREND_WINDOW:
        return False
    window = history[-_CONVERGENCE_TREND_WINDOW:]
    ratios = [h["converged_tile_ratio"] for h in window]
    return ratios[-1] >= ratios[0] - 1e-3 and sum(
        c - p for p, c in zip(ratios, ratios[1:])
    ) >= -1e-3


def render_offline(
    renderer: Any,
    material_set: Any = None,
    env_maps: Any = None,
    params: Any = None,
    heightmap: Optional[np.ndarray] = None,
    *,
    settings: OfflineQualitySettings,
    progress_callback: Optional[Callable[[OfflineProgress], None]] = None,
    water_mask: Optional[np.ndarray] = None,
    certificate=None,
    cache=None,
) -> OfflineResult:
    """Render terrain through the offline accumulation pipeline of
    `renderer` (a TerrainRenderer); the denoiser runs on the renderer's
    device."""
    _ = cache
    settings.validate()
    if not settings.enabled:
        raise RenderError(
            "offline rendering requires settings.enabled=True (explicit opt-in)"
        )
    t0 = time.perf_counter()
    renderer.begin_offline_accumulation(
        material_set, env_maps, params, heightmap, water_mask=water_mask
    )
    history = []
    try:
        samples = 0
        while samples < settings.max_samples:
            batch = min(settings.batch_size, settings.max_samples - samples)
            renderer.accumulate_batch(batch)
            samples += batch
            metrics = renderer.read_accumulation_metrics(
                settings.convergence_threshold
            )
            history.append(metrics)
            if progress_callback is not None:
                progress_callback(
                    OfflineProgress(
                        samples_so_far=samples,
                        max_samples=settings.max_samples,
                        mean_delta=metrics["mean_delta"],
                        p95_delta=metrics["p95_delta"],
                        converged_ratio=metrics["converged_tile_ratio"],
                        elapsed_ms=(time.perf_counter() - t0) * 1e3,
                    )
                )
            if (
                samples >= settings.min_samples
                and metrics["converged_tile_ratio"] >= settings.converged_ratio_target
                and _upward_trend(history)
            ):
                break

        hdr_frame, aov_frame = renderer.resolve_offline_hdr()

        if settings.denoiser in ("atrous", "svgf"):
            import torch

            from ..ops.denoise import atrous_denoise

            def plane(name):
                a = aov_frame.get(name)
                return None if a is None else torch.as_tensor(a, device=renderer.device)

            rgb = atrous_denoise(
                torch.as_tensor(hdr_frame.rgb, device=renderer.device),
                albedo=plane("albedo"),
                normal=plane("normal"),
                depth=plane("depth"),
                iterations=settings.denoise_iterations,
            )
            hdr_frame = HdrFrame(rgb=rgb.cpu().numpy().astype(np.float32),
                                 metadata=dict(hdr_frame.metadata))

        frame = renderer.tonemap_offline_hdr(hdr_frame)
        metadata = {
            "samples": samples,
            "batches": len(history),
            "final_metrics": history[-1] if history else None,
            "elapsed_ms": (time.perf_counter() - t0) * 1e3,
            "denoiser": settings.denoiser,
        }
        if certificate is not None and certificate is not False:
            from ..assurance.certificate import emit_certificate

            target = certificate if not isinstance(certificate, bool) else {}
            emit_certificate(target, "render_offline",
                             {"frames": samples, "rgba": frame.rgba})
            if isinstance(target, dict):
                metadata["certificate_payload_sha256"] = target.get("digest")
        return OfflineResult(frame=frame, hdr_frame=hdr_frame,
                             aov_frame=aov_frame, metadata=metadata)
    finally:
        renderer.end_offline_accumulation()
