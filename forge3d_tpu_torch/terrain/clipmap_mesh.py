# forge3d_tpu_torch/terrain/clipmap_mesh.py — reference-layout clipmap mesh,
# a host copy (numpy) of forge3d_tpu/terrain/clipmap_mesh.py, word for word
# below this header, so that the G-buffer equals the JAX package's.
#
# Parity notes (reference behavior, not code): the reference's clipmap
# camera mode rasterizes a CPU-generated center-block + nested-ring mesh
# (src/terrain/clipmap/{level.rs,ring.rs,vertex.rs}) through the terrain
# PBR pipeline (src/shaders/terrain_pbr_pom.wgsl vs_clipmap_main). The
# recipe goldens bake several layout quirks of that generator which are
# part of the pixel contract and are reproduced here deliberately:
#   - base_cell = extent / (center_resolution * 8); the center block
#     spans ±(base_cell * center_resolution / 2).
#   - each ring r covers [inner, inner + cell_r * ring_resolution] with
#     cell_r = base_cell * 2^r, built from 4 two-row strips whose columns
#     step 2*cell_r from the NEGATIVE outer corner — so strips cover only
#     [-outer, outer - 2*inner] along their run (clamped), leaving
#     L-shaped corner holes on the positive side ("corner patches are
#     currently handled by strip overlap" — ring.rs:204-218).
#   - heightmap UVs map [-extent/2, extent/2] -> [0, 1] and CLAMP, so
#     outer rings repeat the DEM edge rows.
#   - morph weight ramps to 1 over the outer `morph_range` fraction of
#     each strip; geomorphing blends the fine bilinear height with a
#     bilinear sample on a 2^(ring+1)-texel coarse grid
#     (vs_clipmap_main, terrain_pbr_pom.wgsl:4765-4800).
#   - every ring vertex gets a skirt twin flagged morph=-1, dropped by
#     ring_resolution * 0.001 in height units before exaggeration;
#     curtain quads connect only row-adjacent vertices (ring.rs:238-268).

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ClipmapConfig", "build_clipmap_mesh", "clipmap_vertex_heights",
           "rasterize_clipmap_gbuffer"]


@dataclass(frozen=True)
class ClipmapConfig:
    ring_count: int = 4
    ring_resolution: int = 32
    center_resolution: int = 32
    skirt_depth: float = 10.0
    morph_range: float = 0.3

    @classmethod
    def from_camera_mode(cls, camera_mode: str) -> "ClipmapConfig":
        """Parse the reference's "clipmap:rings:res:center:skirt:morph"
        camera-mode spelling (map_scene.py _mapscene_clipmap_camera_mode)."""
        parts = camera_mode.split(":")
        vals = parts[1:]
        get = lambda i, d: float(vals[i]) if i < len(vals) else d  # noqa: E731
        return cls(ring_count=int(get(0, 4)), ring_resolution=int(get(1, 64)),
                   center_resolution=int(get(2, 64)),
                   skirt_depth=get(3, 10.0), morph_range=get(4, 0.3))


def _strip_indices(base: int, width: int) -> np.ndarray:
    i = np.arange(width - 1)
    i0 = base + i
    i1 = i0 + 1
    i2 = i0 + width
    i3 = i2 + 1
    return np.stack([np.stack([i0, i2, i1], -1),
                     np.stack([i1, i2, i3], -1)], 1).reshape(-1, 3)


def build_clipmap_mesh(config: ClipmapConfig, center=(0.0, 0.0),
                       extent: float = 1.0):
    """Build the combined clipmap mesh.

    Returns (pos(N,2), uv(N,2), morph(N,2), tris(M,3)) where morph[:,0]
    is the geomorph weight (-1 flags skirt vertices) and morph[:,1] the
    ring index (0 for the center block).
    """
    cx, cy = float(center[0]), float(center[1])
    base_cell = extent / (config.center_resolution * 8.0)

    verts, uvs, morphs, tris = [], [], [], []

    def to_uv(wx, wz):
        u = (wx + extent * 0.5) / extent
        v = (wz + extent * 0.5) / extent
        return np.clip(u, 0.0, 1.0), np.clip(v, 0.0, 1.0)

    def emit(wx, wz, morph_w, ring):
        u, v = to_uv(wx, wz)
        verts.append(np.stack([wx, wz], -1))
        uvs.append(np.stack([u, v], -1))
        morphs.append(np.stack([np.asarray(morph_w, np.float64),
                                np.full_like(np.asarray(morph_w, np.float64),
                                             float(ring))], -1))

    n_total = 0

    # -- center block ------------------------------------------------------
    n = config.center_resolution
    half = base_cell * n * 0.5
    cell = (half * 2.0) / n
    xs = cx - half + np.arange(n + 1) * cell
    zs = cy - half + np.arange(n + 1) * cell
    wz, wx = np.meshgrid(zs, xs, indexing="ij")
    emit(wx.ravel(), wz.ravel(), np.zeros(wx.size), 0)
    stride = n + 1
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i0 = (jj * stride + ii).ravel()
    tris.append(np.stack([np.stack([i0, i0 + 1, i0 + stride], -1),
                          np.stack([i0 + 1, i0 + stride + 1, i0 + stride],
                                   -1)], 1).reshape(-1, 3))
    n_total = wx.size

    # -- rings -------------------------------------------------------------
    res = config.ring_resolution
    inner = half
    for r in range(config.ring_count):
        cell_r = base_cell * (1 << r)
        strip = cell_r * res
        outer = inner + strip

        ring_start = n_total
        ring_verts = 0
        morph_start = 1.0 - config.morph_range

        def calc_morph(dist):
            t = dist / strip
            return np.where(t > morph_start,
                            (t - morph_start) / config.morph_range, 0.0)

        cols = np.arange(res + 1)
        # strips: (axis along run, fixed rows, dist per row, clamps)
        run_x = cx - outer + cols * cell_r * 2.0
        run_x = np.minimum(run_x, cx + outer)
        run_z = cy - inner + cols * cell_r * 2.0
        run_z = np.minimum(run_z, cy + inner)
        strips = [
            # top (positive Z): rows z=+inner, z=+outer
            (run_x, (cy + inner, cy + outer), (0.0, strip), "x"),
            # bottom (negative Z): rows z=-outer, z=-inner
            (run_x, (cy - outer, cy - inner), (strip, 0.0), "x"),
            # left (negative X): rows x=-outer, x=-inner
            (run_z, (cx - outer, cx - inner), (strip, 0.0), "z"),
            # right (positive X): rows x=+inner, x=+outer
            (run_z, (cx + inner, cx + outer), (0.0, strip), "z"),
        ]
        for run, rows, dists, axis in strips:
            base = n_total + ring_verts
            for fixed, dist in zip(rows, dists):
                m = calc_morph(np.full(run.shape, dist))
                if axis == "x":
                    emit(run, np.full(run.shape, fixed), m, r)
                else:
                    emit(np.full(run.shape, fixed), run, m, r)
                ring_verts += run.size
            tris.append(_strip_indices(base, res + 1))
        n_total += ring_verts

        # skirts: one twin per ring vertex (morph=-1), curtains between
        # row-adjacent pairs only
        ring_pos = np.concatenate(verts[-8:], axis=0)  # 4 strips x 2 rows
        ring_uv = np.concatenate(uvs[-8:], axis=0)
        skirt_base = n_total
        verts.append(ring_pos.copy())
        uvs.append(ring_uv.copy())
        morphs.append(np.stack([np.full(len(ring_pos), -1.0),
                                np.full(len(ring_pos), float(r))], -1))
        row_w = res + 1
        idx = np.arange(len(ring_pos))
        sel = idx[(idx > 0) & ((idx % row_w) != 0)]
        prev = sel - 1
        t1 = np.stack([ring_start + prev, ring_start + sel,
                       skirt_base + prev], -1)
        t2 = np.stack([ring_start + sel, skirt_base + sel,
                       skirt_base + prev], -1)
        tris.append(np.concatenate([t1, t2], axis=0))
        n_total += len(ring_pos)

        inner = outer

    pos = np.concatenate(verts, axis=0).astype(np.float32)
    uv = np.concatenate(uvs, axis=0).astype(np.float32)
    morph = np.concatenate(morphs, axis=0).astype(np.float32)
    tri = np.concatenate(tris, axis=0).astype(np.int32)
    return pos, uv, morph, tri


def clipmap_vertex_heights(dem: np.ndarray, uv: np.ndarray,
                           morph: np.ndarray,
                           ring_resolution: int,
                           sampling: str = "bilinear") -> np.ndarray:
    """Geomorphed height per vertex (raw DEM units, before centering /
    exaggeration; skirt drop NOT applied). Mirrors vs_clipmap_main:
    fine sample at uv blended with a sample snapped to a 2^(ring+1)-texel
    coarse grid by the morph weight. `sampling` selects the height-texture
    filter: the recipe goldens bake the renderer's default NEAREST sampler
    (wgpu convention: texel floor(u * size)), while "bilinear" matches the
    shader's explicit filtered path."""
    h, w = dem.shape

    def nearest(u, v):
        xi = np.clip(np.floor(np.clip(u, 0.0, 1.0) * w).astype(int), 0, w - 1)
        yi = np.clip(np.floor(np.clip(v, 0.0, 1.0) * h).astype(int), 0, h - 1)
        return dem[yi, xi]

    def bilin(u, v):
        x = np.clip(u, 0.0, 1.0) * (w - 1)
        y = np.clip(v, 0.0, 1.0) * (h - 1)
        x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
        y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        fx = x - x0
        fy = y - y0
        return (dem[y0, x0] * (1 - fx) * (1 - fy) + dem[y0, x1] * fx * (1 - fy)
                + dem[y1, x0] * (1 - fx) * fy + dem[y1, x1] * fx * fy)

    if sampling == "nearest":
        bilin = nearest  # noqa: F811 — same call contract, snapped texels

    u, v = uv[:, 0].astype(np.float64), uv[:, 1].astype(np.float64)
    h_fine = bilin(u, v)
    ring = np.maximum(morph[:, 1], 0.0)
    coarse_texels = np.exp2(np.minimum(ring + 1.0, 16.0))
    step_u = coarse_texels / max(w - 1, 1)
    step_v = coarse_texels / max(h - 1, 1)
    cu = u / step_u
    cv = v / step_v
    bu = np.floor(cu) * step_u
    bv = np.floor(cv) * step_v
    tu = cu - np.floor(cu)
    tv = cv - np.floor(cv)
    h00 = bilin(bu, bv)
    h10 = bilin(bu + step_u, bv)
    h01 = bilin(bu, bv + step_v)
    h11 = bilin(bu + step_u, bv + step_v)
    h_coarse = (h00 * (1 - tu) * (1 - tv) + h10 * tu * (1 - tv)
                + h01 * (1 - tu) * tv + h11 * tu * tv)
    wgt = np.clip(morph[:, 0], 0.0, 1.0)
    return h_fine * (1 - wgt) + h_coarse * wgt


def _look_at_rh(eye, target, up):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -float(s @ eye)
    m[1, 3] = -float(u @ eye)
    m[2, 3] = float(f @ eye)
    return m


def _perspective_wgpu(fov_y_deg, aspect, near, far):
    fov = np.deg2rad(fov_y_deg)
    f = 1.0 / np.tan(fov * 0.5)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = far / (near - far)
    proj[2, 3] = near * far / (near - far)
    proj[3, 2] = -1.0
    return proj


def rasterize_clipmap_gbuffer(heightmap, *, size_px, camera_mode,
                              terrain_span, z_scale, domain,
                              cam_radius, cam_phi_deg, cam_theta_deg,
                              fov_y_deg, clip, cam_target=(0.0, 0.0, 0.0)):
    """Rasterize the clipmap ring mesh into a per-pixel G-buffer.

    Mirrors the reference's clipmap vertex path + rasterizer
    (terrain_pbr_pom.wgsl:4766-4830 ``vs_clipmap_main``): geomorphed
    NEAREST height samples, domain clamp (identity height curve), skirt
    drop ring_resolution*0.001 in raw height units, world_position =
    (mesh xy, ORIGINAL height * exaggeration) while the clip position
    uses the height CENTERED on the domain midpoint.  The camera is the
    legacy Y-up orbit (upload.rs:344-371 non-zup branch) with the wgpu
    [0,1]-depth perspective projection.

    The recipe goldens draw this mesh through the GPU LOD indirect path,
    but at the recipe parameters every region selects LOD 0
    (clipmap_lod_select.wgsl:118-127: pixel_error_budget 2.0, tile_size
    terrain_span/ring_resolution, identity instance transforms), so the
    full-resolution combined mesh IS the drawn geometry.

    Returns dict(uv (H,W,2), world_pos (H,W,3), valid (H,W) bool,
    eye (3,), view (4,4), proj (4,4)).
    """
    W, H = int(size_px[0]), int(size_px[1])
    hm = np.asarray(heightmap, np.float32)
    dom_lo, dom_hi = float(domain[0]), float(domain[1])
    config = ClipmapConfig.from_camera_mode(camera_mode)
    pos, uv, morph, tri = build_clipmap_mesh(config, (0.0, 0.0),
                                             float(terrain_span))
    hv = clipmap_vertex_heights(hm, uv, morph, config.ring_resolution,
                                sampling="nearest")
    # h_disp = apply_height_curve01(get_height_geom_t(h)) * range + lo
    # == clamp to the domain with the identity curve (wgsl:1483-1508)
    h_disp = np.clip(hv, dom_lo, dom_hi)
    skirt = np.where(morph[:, 0] < 0.0,
                     config.ring_resolution * 0.001, 0.0)
    h_center = (dom_lo + dom_hi) * 0.5
    z_centered = (h_disp - h_center - skirt) * z_scale
    z_original = (h_disp - skirt) * z_scale

    phi = np.deg2rad(cam_phi_deg)
    theta = np.deg2rad(cam_theta_deg)
    target = np.asarray(cam_target, np.float64)
    eye = target + cam_radius * np.array([
        np.sin(theta) * np.cos(phi), np.cos(theta),
        np.sin(theta) * np.sin(phi)])
    view = _look_at_rh(eye, target, (0.0, 1.0, 0.0))
    proj = _perspective_wgpu(fov_y_deg, W / H, clip[0], clip[1])

    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    half_h = np.tan(np.deg2rad(fov_y_deg) * 0.5)
    half_w = (W / H) * half_h

    wpos = np.stack([pos[:, 0], pos[:, 1], z_centered], -1)
    rel = wpos - eye
    ca = rel @ right
    cb = rel @ up
    cz = rel @ fwd          # == clip-space w for the RH projection

    # perspective-correct attributes: u, v, world x, world y, world z
    attrs = np.stack([uv[:, 0], uv[:, 1], pos[:, 0], pos[:, 1],
                      z_original], -1)

    gb_attr = np.zeros((H, W, attrs.shape[1]), np.float64)
    zbuf = np.full((H, W), np.inf)
    valid = np.zeros((H, W), bool)
    ys2, xs2 = np.mgrid[0:H, 0:W]
    near = float(clip[0])

    def project(a, b, c):
        return np.array([(a / (c * half_w) + 1.0) * 0.5 * W - 0.5,
                         (1.0 - b / (c * half_h)) * 0.5 * H - 0.5])

    def raster_tri(tp, tz, tattr):
        xmin = max(int(np.floor(tp[:, 0].min())), 0)
        xmax = min(int(np.ceil(tp[:, 0].max())) + 1, W)
        ymin = max(int(np.floor(tp[:, 1].min())), 0)
        ymax = min(int(np.ceil(tp[:, 1].max())) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            return
        e1 = tp[1] - tp[0]
        e2 = tp[2] - tp[0]
        den = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(den) < 1e-12:
            return
        px = xs2[ymin:ymax, xmin:xmax] - tp[0][0]
        py = ys2[ymin:ymax, xmin:xmax] - tp[0][1]
        b1 = (px * e2[1] - py * e2[0]) / den
        b2 = (py * e1[0] - px * e1[1]) / den
        inside = (b1 >= -1e-9) & (b2 >= -1e-9) & (b1 + b2 <= 1 + 1e-9)
        if not inside.any():
            return
        iw = 1.0 / tz
        wint = iw[0] + b1 * (iw[1] - iw[0]) + b2 * (iw[2] - iw[0])
        zi = 1.0 / wint
        sub = (slice(ymin, ymax), slice(xmin, xmax))
        nearer = inside & (zi < zbuf[sub])
        if not nearer.any():
            return
        aw = tattr * iw[:, None]
        interp = (aw[0][None, None, :]
                  + b1[..., None] * (aw[1] - aw[0])[None, None, :]
                  + b2[..., None] * (aw[2] - aw[0])[None, None, :]) \
            / wint[..., None]
        gb_attr[sub] = np.where(nearer[..., None], interp, gb_attr[sub])
        zbuf[sub] = np.where(nearer, zi, zbuf[sub])
        valid[sub] |= nearer

    vis = (cz[tri] > near).any(axis=1)
    for t in tri[vis]:
        if (cz[t] <= near).any():
            # Sutherland-Hodgman near clip in camera space
            poly = [(ca[i], cb[i], cz[i], attrs[i]) for i in t]
            clipped = []
            for i3 in range(3):
                cur, nxt = poly[i3], poly[(i3 + 1) % 3]
                cin, nin = cur[2] > near, nxt[2] > near
                if cin:
                    clipped.append(cur)
                if cin != nin:
                    f = (near - cur[2]) / (nxt[2] - cur[2])
                    clipped.append((cur[0] + f * (nxt[0] - cur[0]),
                                    cur[1] + f * (nxt[1] - cur[1]),
                                    cur[2] + f * (nxt[2] - cur[2]),
                                    cur[3] + f * (nxt[3] - cur[3])))
            if len(clipped) < 3:
                continue
            for k in range(1, len(clipped) - 1):
                p0, p1, p2 = clipped[0], clipped[k], clipped[k + 1]
                tp = np.stack([project(q[0], q[1], q[2])
                               for q in (p0, p1, p2)])
                tz = np.array([q[2] for q in (p0, p1, p2)])
                ta = np.stack([q[3] for q in (p0, p1, p2)])
                raster_tri(tp, tz, ta)
            continue
        tp = np.stack([project(ca[i], cb[i], cz[i]) for i in t])
        raster_tri(tp, cz[t], attrs[t])

    return {
        "uv": gb_attr[..., 0:2].astype(np.float32),
        "world_pos": gb_attr[..., 2:5].astype(np.float32),
        "valid": valid,
        "eye": np.asarray(eye, np.float32),
        "view": view, "proj": proj,
    }
