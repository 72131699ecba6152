# forge3d_tpu_torch/colormaps.py
# The colormap registry of forge3d_tpu/colormaps.py: 256-entry float rgb
# LUTs baked into the port's own copy of the asset (assets/colormaps.npz),
# runtime registration, the optional provider packages, the host-side
# `apply`, and `sample_lut`, the torch counterpart of `sample_lut_jnp`.

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "colormaps.npz")

_BUILTIN: Dict[str, np.ndarray] = {}
_RUNTIME: Dict[str, np.ndarray] = {}
_PROVIDERS: Dict[str, Callable[[str], np.ndarray]] = {}


def _load_builtin() -> None:
    if _BUILTIN:
        return
    with np.load(_ASSET) as z:
        for k in z.files:
            _BUILTIN[k] = np.asarray(z[k], np.float32)


def available() -> list[str]:
    _load_builtin()
    return sorted(set(_BUILTIN) | set(_RUNTIME))


def register(name: str, lut: np.ndarray) -> None:
    """Register a (N, 3) float LUT. Values are normally in [0, 1];
    display-space calibration LUTs may exceed 1, capped at 4."""
    lut = np.asarray(lut, np.float32)
    if lut.ndim != 2 or lut.shape[1] != 3 or lut.shape[0] < 2:
        raise ValueError(f"LUT must be (N>=2, 3), got {lut.shape}")
    if lut.min() < 0.0 or lut.max() > 4.0:
        raise ValueError("LUT values must be in [0, 4]")
    _RUNTIME[name] = lut


def register_provider(prefix: str, fn: Callable[[str], np.ndarray]) -> None:
    """Register a provider resolving names like '<prefix>:<map>'."""
    _PROVIDERS[prefix] = fn


def _mpl_lut(mpl_cmap, n: int = 256) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return np.asarray(mpl_cmap(xs), np.float32)[:, :3]


def install_default_providers() -> None:
    """Install the external colormap providers (matplotlib, cmocean,
    cmcrameri, colorcet, palettable). Each imports its package lazily and
    fails with a clear error when it is absent."""

    def _matplotlib(name: str) -> np.ndarray:
        import matplotlib

        return _mpl_lut(matplotlib.colormaps[name])

    def _lazy(module: str, resolver):
        def fn(name: str) -> np.ndarray:
            import importlib

            try:
                mod = importlib.import_module(module)
            except ImportError as exc:
                raise KeyError(
                    f"colormap provider needs the optional package "
                    f"{module!r}: {exc}") from exc
            return resolver(mod, name)
        return fn

    register_provider("matplotlib", _matplotlib)
    register_provider("mpl", _matplotlib)
    register_provider("cmocean", _lazy(
        "cmocean.cm", lambda m, n: _mpl_lut(getattr(m, n))))
    register_provider("cmcrameri", _lazy(
        "cmcrameri.cm", lambda m, n: _mpl_lut(getattr(m, n))))
    register_provider("colorcet", _lazy(
        "colorcet", lambda m, n: _mpl_lut(m.cm[n])))

    def _palettable(mod, name):
        import importlib

        sub = importlib.import_module(
            "palettable." + ".".join(name.split(".")[:-1]))
        return _mpl_lut(getattr(sub, name.split(".")[-1]).mpl_colormap)

    register_provider("palettable", _lazy("palettable", _palettable))


def get_lut(name: str) -> np.ndarray:
    """Resolve a colormap name to its (N, 3) float32 LUT."""
    _load_builtin()
    if name in _RUNTIME:
        return _RUNTIME[name]
    if name in _BUILTIN:
        return _BUILTIN[name]
    if ":" in name:
        if not _PROVIDERS:
            install_default_providers()
        prefix, rest = name.split(":", 1)
        if prefix in _PROVIDERS:
            lut = np.asarray(_PROVIDERS[prefix](rest), np.float32)
            return lut
    raise KeyError(f"unknown colormap {name!r}; available: {available()}")


def apply(name: str, values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Map scalar values to rgb via LUT with linear interpolation
    (host-side). Device-side mapping uses `sample_lut`."""
    lut = get_lut(name)
    v = np.asarray(values, np.float64)
    lo = float(np.min(v) if vmin is None else vmin)
    hi = float(np.max(v) if vmax is None else vmax)
    span = hi - lo if hi > lo else 1.0
    t = np.clip((v - lo) / span, 0.0, 1.0) * (lut.shape[0] - 1)
    i0 = np.floor(t).astype(np.int64)
    i1 = np.minimum(i0 + 1, lut.shape[0] - 1)
    f = (t - i0)[..., None]
    return (lut[i0] * (1 - f) + lut[i1] * f).astype(np.float32)


def sample_lut(lut: torch.Tensor, t: torch.Tensor):
    """LUT sample on tensors: t in [0, 1] (any shape), lut (N, 3) float32.
    Returns (r, g, b). Linear interpolation, clamped."""
    n = lut.shape[0]
    tt = torch.clamp(t, 0.0, 1.0) * (n - 1)
    i0 = torch.floor(tt).to(torch.int32)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = tt - i0.to(tt.dtype)
    i0 = i0.to(torch.int64)
    i1 = i1.to(torch.int64)
    return tuple(lut[:, c][i0] * (1 - f) + lut[:, c][i1] * f for c in range(3))
