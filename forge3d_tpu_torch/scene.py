# forge3d_tpu_torch/scene.py
# Scene: the simple grid-terrain render-to-texture class of
# forge3d_tpu/scene.py on PyTorch, with its setters, errors and outputs.
#
# A render resamples the heights to the grid and builds the min-max pyramid
# on the host, forms the camera rays in float64 on the host and narrows them
# to float32 (the MENSURA anchor), then runs on `device`: the primary trace
# and the four AO traces through K5 (ops/traversal.trace) and the normals
# through normal_at; the colormap, the sun term, the AO, the ground plane,
# the water and the background as PyTorch elementwise glue in the JAX
# package's float32 operation order; the rect-area lights (one launch for
# the whole list), SSR and the post chain through E2 (ops/post.py); and the
# u8 encode before the readback. `device="cuda"` (the default) raises
# DeviceError without CUDA; "cpu" runs the plain versions.

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import colormaps
from .camera import camera_basis
from .errors import UploadError
from .frame import Frame
from .io.image import numpy_to_png
from .ops import post
from .ops.pyramid import build_pyramid
from .ops.rng import seed_state, xorshift32
from .ops.shading import cosine_dir, fdiv
from .ops.tonemap import to_u8
from .ops.traversal import normal_at, scene_from_pyramid, trace

_F32 = torch.float32


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Scene:
    """Grid-terrain scene with colormap shading."""

    def __init__(self, width: int, height: int, grid: Optional[int] = 128,
                 colormap: Optional[str] = "viridis", *, device="cuda"):
        from .pt.terrain_ref import resolve_device

        if width <= 0 or height <= 0:
            raise ValueError("width/height must be positive")
        self.width = int(width)
        self.height = int(height)
        self.grid = int(grid or 128)
        if self.grid < 2:
            raise ValueError("grid must be >= 2")
        self.colormap = colormap or "viridis"
        colormaps.get_lut(self.colormap)  # validate early
        self.device = resolve_device(device)
        self._heights: Optional[np.ndarray] = None
        self._eye = np.array([3.0, 2.0, 3.0], np.float64)
        self._target = np.array([0.0, 0.0, 0.0], np.float64)
        self._up = np.array([0.0, 1.0, 0.0], np.float64)
        self._fovy_deg = 45.0
        self._znear = 0.1
        self._zfar = 100.0
        self._ssao_enabled = False
        self._ssao = (1.0, 1.0, 0.025)  # radius, intensity, bias
        # terrain footprint: a centred unit-ish quad like the reference spike
        self._span = 2.0
        self._h_scale = 1.0
        # post-fx state (the reference Scene's py_api surface)
        self._bloom = {"enabled": False, "threshold": 1.0, "intensity": 0.5}
        self._dof = {"enabled": False, "focus": 4.0, "range": 2.0, "max_coc": 6.0}
        self._vignette = {"enabled": False, "strength": 0.35}
        self._ssr = {"enabled": False, "intensity": 0.5}
        self._ssgi = {"enabled": False, "intensity": 0.5}
        self._oit = {"enabled": False, "mode": "weighted"}
        self._ground_plane = {"enabled": False, "height": 0.0, "color": (0.35, 0.35, 0.38)}
        self._water_surface = {"enabled": False, "height": 0.0,
                               "color": (0.08, 0.22, 0.35), "opacity": 0.75}
        self._clouds = {"enabled": False, "coverage": 0.4, "density": 0.5}
        self._reflections = {"enabled": False, "intensity": 0.4}
        self._rect_area_lights: list = []
        #: wall ms of the last render by stage (synchronised on the card)
        self.last_timings: Dict[str, float] = {}

    # -- camera ------------------------------------------------------------
    def set_camera_look_at(self, eye, target, up, fovy_deg: float,
                           znear: float, zfar: float) -> None:
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        if not (np.isfinite(eye).all() and np.isfinite(target).all() and np.isfinite(up).all()):
            raise ValueError("camera parameters must be finite")
        if znear <= 0 or zfar <= znear:
            raise ValueError("require 0 < znear < zfar")
        if np.allclose(eye, target):
            raise ValueError("eye and target must differ")
        if not (0.0 < fovy_deg < 180.0):
            raise ValueError("fovy_deg out of range")
        self._eye, self._target, self._up = eye, target, up
        self._fovy_deg = float(fovy_deg)
        self._znear, self._zfar = float(znear), float(zfar)

    # -- terrain data ------------------------------------------------------
    def set_height_from_r32f(self, height_r32f: np.ndarray) -> None:
        hm = np.asarray(height_r32f)
        if hm.dtype != np.float32:
            hm = hm.astype(np.float32)
        if hm.ndim != 2 or hm.shape[0] < 2 or hm.shape[1] < 2:
            raise UploadError("height data must be a 2D float32 array >= 2x2")
        if not np.isfinite(hm).all():
            raise UploadError("height data contains non-finite values")
        self._heights = np.ascontiguousarray(hm)

    def set_terrain_span(self, span: float, height_scale: float = 1.0) -> None:
        if span <= 0 or height_scale <= 0:
            raise ValueError("span and height_scale must be > 0")
        self._span = float(span)
        self._h_scale = float(height_scale)

    # -- ssao (applied as hemispheric AO in the ray engine) ---------------
    def ssao_enabled(self) -> bool:
        return self._ssao_enabled

    def set_ssao_enabled(self, enabled: bool) -> bool:
        self._ssao_enabled = bool(enabled)
        return self._ssao_enabled

    def set_ssao_parameters(self, radius: float, intensity: float, bias: float) -> None:
        if radius <= 0:
            raise ValueError("radius must be > 0")
        self._ssao = (float(radius), float(intensity), float(bias))

    def get_ssao_parameters(self) -> Tuple[float, float, float]:
        return self._ssao

    # -- post-fx setters ---------------------------------------------------
    def set_bloom_enabled(self, enabled: bool) -> None:
        self._bloom["enabled"] = bool(enabled)

    def set_bloom_parameters(self, threshold: float, intensity: float) -> None:
        if threshold < 0 or intensity < 0:
            raise ValueError("bloom parameters must be >= 0")
        self._bloom.update(threshold=float(threshold), intensity=float(intensity))

    def set_dof_enabled(self, enabled: bool) -> None:
        self._dof["enabled"] = bool(enabled)

    def set_dof_parameters(self, focus_distance: float, focus_range: float,
                           max_coc: float = 6.0) -> None:
        if focus_distance <= 0 or focus_range <= 0:
            raise ValueError("dof parameters must be > 0")
        self._dof.update(focus=float(focus_distance), range=float(focus_range),
                         max_coc=float(max_coc))

    def set_vignette_enabled(self, enabled: bool, strength: float = 0.35) -> None:
        self._vignette.update(enabled=bool(enabled), strength=float(strength))

    def set_ssr_enabled(self, enabled: bool, intensity: float = 0.5) -> None:
        self._ssr.update(enabled=bool(enabled), intensity=float(intensity))

    def set_ssgi_enabled(self, enabled: bool, intensity: float = 0.5) -> None:
        self._ssgi.update(enabled=bool(enabled), intensity=float(intensity))

    def set_oit_enabled(self, enabled: bool, mode: str = "weighted") -> None:
        if mode not in ("weighted", "dual_source"):
            raise ValueError("oit mode must be weighted|dual_source")
        self._oit.update(enabled=bool(enabled), mode=mode)

    def set_ground_plane(self, enabled: bool, height: float = 0.0,
                         color=(0.35, 0.35, 0.38)) -> None:
        self._ground_plane.update(enabled=bool(enabled), height=float(height),
                                  color=tuple(color))

    def set_water_surface(self, enabled: bool, height: float = 0.0,
                          color=(0.08, 0.22, 0.35), opacity: float = 0.75) -> None:
        self._water_surface.update(enabled=bool(enabled), height=float(height),
                                   color=tuple(color), opacity=float(opacity))

    def set_clouds_enabled(self, enabled: bool, coverage: float = 0.4,
                           density: float = 0.5) -> None:
        self._clouds.update(enabled=bool(enabled), coverage=float(coverage),
                            density=float(density))

    def set_reflections_enabled(self, enabled: bool, intensity: float = 0.4) -> None:
        self._reflections.update(enabled=bool(enabled), intensity=float(intensity))

    def add_rect_area_light(self, center, right, up, half_extent,
                            color=(1.0, 1.0, 1.0), intensity: float = 1.0) -> int:
        self._rect_area_lights.append(
            dict(center=tuple(center), right=tuple(right), up=tuple(up),
                 half_extent=tuple(half_extent), color=tuple(color),
                 intensity=float(intensity)))
        return len(self._rect_area_lights) - 1

    def clear_rect_area_lights(self) -> None:
        self._rect_area_lights.clear()

    # -- rendering ---------------------------------------------------------
    def _default_heights(self) -> np.ndarray:
        g = self.grid
        y, x = np.mgrid[0:g, 0:g].astype(np.float32)
        return (0.15 * np.sin(x * 6.0 / g) * np.cos(y * 6.0 / g)).astype(np.float32)

    def _grid_heights(self) -> np.ndarray:
        """The heights resampled bilinearly to the grid (scene.py:208-222)."""
        hm = self._heights if self._heights is not None else self._default_heights()
        g = self.grid
        if hm.shape != (g, g):
            yi = np.linspace(0, hm.shape[0] - 1, g)
            xi = np.linspace(0, hm.shape[1] - 1, g)
            y0 = np.floor(yi).astype(int)
            x0 = np.floor(xi).astype(int)
            y1 = np.minimum(y0 + 1, hm.shape[0] - 1)
            x1 = np.minimum(x0 + 1, hm.shape[1] - 1)
            fy = (yi - y0)[:, None]
            fx = (xi - x0)[None, :]
            hm = (
                hm[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
                + hm[np.ix_(y0, x1)] * (1 - fy) * fx
                + hm[np.ix_(y1, x0)] * fy * (1 - fx)
                + hm[np.ix_(y1, x1)] * fy * fx
            ).astype(np.float32)
        return hm

    def _camera_dirs(self) -> np.ndarray:
        """(H, W, 3) float32 unit ray directions, formed in float64 relative
        to the eye and narrowed once (scene.py:235-246)."""
        right, up, fwd = camera_basis(self._eye, self._target, self._up)
        W, H = self.width, self.height
        half_h = math.tan(math.radians(self._fovy_deg) * 0.5)
        half_w = (W / H) * half_h
        xs = (np.arange(W, dtype=np.float64) + 0.5) / W * 2.0 - 1.0
        ys = 1.0 - (np.arange(H, dtype=np.float64) + 0.5) / H * 2.0
        gx, gy = np.meshgrid(xs * half_w, ys * half_h)
        d = (gx[..., None] * right + gy[..., None] * up + fwd).astype(np.float64)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return d.astype(np.float32)

    def _buffers(self, mark=lambda name: None) -> Dict[str, torch.Tensor]:
        """The render up to the post passes: the shaded (H, W, 3) `ldr`, the
        `depth` buffer (zfar off the terrain), the terrain `normal` and, for
        the rect lights, the hit `points` and `view` vectors, on the device.
        `mark(stage)` is called after each stage."""
        dev = self.device

        hm = self._grid_heights()
        g = self.grid
        span = self._span
        spacing = span / (g - 1)
        scene = scene_from_pyramid(build_pyramid(hm), origin_xz=(-span / 2.0, -span / 2.0),
                                   spacing_xz=(spacing, spacing),
                                   exaggeration=self._h_scale, device=dev)
        mark("pyramid")

        W, H = self.width, self.height
        d = self._camera_dirs()
        ro = tuple(torch.full((H, W), float(np.float32(c)), dtype=_F32, device=dev)
                   for c in self._eye)
        rd = tuple(torch.as_tensor(np.ascontiguousarray(d[..., k]), device=dev)
                   for k in range(3))
        mark("rays")

        hit = trace(scene, ro, rd, tmin=self._znear, tmax=self._zfar)
        t = hit.t
        px = ro[0] + t * rd[0]
        py = ro[1] + t * rd[1]
        pz = ro[2] + t * rd[2]
        nx, ny, nz = normal_at(scene, (px, py, pz), hit.cell_x, hit.cell_z)
        mark("trace")

        hmin = float(hm.min()) * self._h_scale
        hmax = float(hm.max()) * self._h_scale
        hn = torch.clamp(fdiv(py - hmin, max(hmax - hmin, 1e-6)), 0.0, 1.0)
        lut = torch.as_tensor(np.ascontiguousarray(colormaps.get_lut(self.colormap), np.float32),
                              device=dev)
        ar, ag, ab = colormaps.sample_lut(lut, hn)

        sun = np.array([0.5, 0.8, 0.3])
        sun /= np.linalg.norm(sun)
        ndl = torch.clamp(nx * float(sun[0]) + ny * float(sun[1]) + nz * float(sun[2]), min=0.0)
        shade = 0.25 + 0.75 * ndl

        if self._ssao_enabled:
            radius, intensity, _bias = self._ssao
            xs = torch.arange(W, device=dev).expand(H, W)
            ys = torch.arange(H, device=dev)[:, None].expand(H, W)
            st = seed_state(12345, 0x9E3779B9, xs, ys, 0)
            occ = torch.zeros((H, W), dtype=_F32, device=dev)
            for _ in range(4):
                st, u1 = xorshift32(st)
                st, u2 = xorshift32(st)
                adir = cosine_dir(nx, ny, nz, u1, u2)
                o = trace(scene, (px + nx * 1e-3, py + ny * 1e-3, pz + nz * 1e-3), adir,
                          tmax=radius).hit
                occ = occ + torch.where(o, 1.0, 0.0)
            shade = shade * (1.0 - fdiv(intensity * 0.5 * occ, 4.0))
        mark("ao")

        r = ar * shade
        g_ = ag * shade
        b = ab * shade

        out = {"normal": torch.stack([nx, ny, nz], -1), "points": torch.stack([px, py, pz], -1),
               "view": -torch.stack(rd, -1)}
        # rect area lights add on top of sun shading (one E2 launch)
        if self._rect_area_lights:
            add = post.rect_area_light_sum(out["points"], out["normal"], out["view"], [dict(
                light_center=L["center"], light_right=L["right"], light_up=L["up"],
                half_extent=L["half_extent"], color=L["color"], intensity=L["intensity"])
                for L in self._rect_area_lights])
            r = r + add[..., 0] * ar
            g_ = g_ + add[..., 1] * ag
            b = b + add[..., 2] * ab

        bg = (0.12, 0.14, 0.18)
        # the ground plane catches rays that miss the terrain
        gp = self._ground_plane
        den = torch.where(rd[1].abs() < 1e-6, -1e-6, rd[1])
        if gp["enabled"]:
            tg = fdiv(gp["height"] - ro[1], den)
            ground_hit = (~hit.hit) & (tg > self._znear) & (tg < self._zfar)
            gndl = max(float(np.dot([0, 1, 0], sun)), 0.0)
            gshade = 0.25 + 0.75 * gndl
            gc = gp["color"]
            r = torch.where(ground_hit, gc[0] * gshade, r)
            g_ = torch.where(ground_hit, gc[1] * gshade, g_)
            b = torch.where(ground_hit, gc[2] * gshade, b)
            vis_any = hit.hit | ground_hit
        else:
            vis_any = hit.hit
        # water surface: a semi-transparent plane over low terrain
        ws = self._water_surface
        if ws["enabled"]:
            tw = fdiv(ws["height"] - ro[1], den)
            water_hit = (tw > self._znear) & (tw < torch.where(hit.hit, t, self._zfar)) \
                & (rd[1] < 0)
            wop = ws["opacity"]
            wc = ws["color"]
            r = torch.where(water_hit, (1 - wop) * r + wop * wc[0], r)
            g_ = torch.where(water_hit, (1 - wop) * g_ + wop * wc[1], g_)
            b = torch.where(water_hit, (1 - wop) * b + wop * wc[2], b)
        r = torch.where(vis_any, r, bg[0])
        g_ = torch.where(vis_any, g_, bg[1])
        b = torch.where(vis_any, b, bg[2])
        out["ldr"] = torch.stack([r, g_, b], -1)
        out["depth"] = torch.where(hit.hit, t, self._zfar)
        mark("shade")
        return out

    def render_rgba(self) -> np.ndarray:
        dev = self.device
        marks = [("start", time.perf_counter())]

        def mark(name):
            _sync(dev)
            marks.append((name, time.perf_counter()))

        buf = self._buffers(mark)
        ldr, depth_buf = buf["ldr"], buf["depth"]
        W, H = self.width, self.height
        if self._ssr["enabled"] or self._reflections["enabled"]:
            inten = (self._ssr["intensity"] if self._ssr["enabled"]
                     else self._reflections["intensity"])
            ldr = post.ssr(ldr, depth_buf, buf["normal"], intensity=inten)
        if self._bloom["enabled"] or self._dof["enabled"] or self._vignette["enabled"]:
            ldr = post.apply_post_chain(
                ldr, depth_buf,
                post.PostConfig(
                    bloom_enabled=self._bloom["enabled"],
                    bloom_threshold=self._bloom["threshold"],
                    bloom_intensity=self._bloom["intensity"],
                    dof_enabled=self._dof["enabled"],
                    dof_focus=self._dof["focus"],
                    dof_range=self._dof["range"],
                    dof_max_coc=self._dof["max_coc"],
                    vignette_enabled=self._vignette["enabled"],
                    vignette_strength=self._vignette["strength"],
                ))
        mark("post")

        rgba = torch.full((H, W, 4), 255, dtype=torch.uint8, device=dev)
        rgba[..., :3] = to_u8(ldr).to(torch.uint8)
        out = rgba.cpu().numpy()
        mark("readback")
        self.last_timings = {f"{name}_ms": (t1 - t0) * 1e3
                             for (_, t0), (name, t1) in zip(marks, marks[1:])}
        self.last_timings["total_ms"] = (marks[-1][1] - marks[0][1]) * 1e3
        return out

    def render_png(self, path) -> None:
        numpy_to_png(path, self.render_rgba())

    def render_frame(self) -> Frame:
        return Frame(rgba=self.render_rgba(),
                     metadata={"colormap": self.colormap, "grid": self.grid})
