# The port's virtual texturing against the JAX package's: the host copies
# (Morton codes, the BC7/BC5 codec, the packed store and its residency set,
# forge3d_tpu_torch/terrain/vt.py and codec/) and R1's VT branch
# (forge3d_tpu_torch/terrain/renderer.py, its plain version on the CPU) on
# the fixture of tests/test_vt_render.py: 8x8, 4x4 and 2x2 pages of 128^2
# checker texels over a 65^2 DEM at 96x64.
#
# Gates: Morton codes, BC bytes, decoded texels, store files and manifests
# equal exactly; a corrupt page fails closed in both. Renders: rgba within
# one u8 step on >= 99.5% of pixels (the ROADMAP's rule; the CPU shows them
# equal), the albedo AOV within 1e-5 * (1 + |ref|) on >= 99.5% of elements,
# fallback_texels_frame equal exactly every frame, and last_vt_stats equal
# apart from the upload time.
import numpy as np
import pytest
import torch

from forge3d_tpu.codec import bc as Jbc
from forge3d_tpu.terrain import vt as Jvt
from forge3d_tpu.terrain.params import make_terrain_params
from forge3d_tpu.terrain.renderer import MaterialSet as JMaterialSet
from forge3d_tpu.terrain.renderer import TerrainRenderer as JRenderer

from forge3d_tpu_torch.codec import bc as Tbc
from forge3d_tpu_torch.convert import terrain_params_from_dict
from forge3d_tpu_torch.terrain import renderer as rr
from forge3d_tpu_torch.terrain import vt as Tvt

torch.set_num_threads(1)

PAGE = Tvt.PAGE_SIZE
LEVELS = ((0, 8), (1, 4), (2, 2))


def checker_page(level, x, y):
    """tests/test_vt_render.py:_checker_page."""
    i = np.arange(PAGE)
    xx, yy = np.meshgrid(i, i)
    r = ((xx // 16 + yy // 16) % 2) * 120 + 60 + 25 * level
    g = np.full_like(r, 40 + 37 * ((x * 5 + y * 3) % 5))
    b = np.full_like(r, 200 - 30 * level)
    a = np.full_like(r, 255)
    return np.stack([r, g, b, a], -1).astype(np.uint8)


def pages():
    return {("albedo", lv, x, y): checker_page(lv, x, y)
            for lv, n in LEVELS for y in range(n) for x in range(n)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("vt")
    pg = pages()
    return {"jax": (d / "j.f3dvt", Jvt.vt_pack(d / "j.f3dvt", pg)),
            "port": (d / "t.f3dvt", Tvt.vt_pack(d / "t.f3dvt", pg))}


def test_morton_codes():
    rng = np.random.default_rng(3)
    for x, y in [(0, 0), (1, 0), (0, 1), (2**16 - 1, 2**16 - 1), (2**32 - 1, 5),
                 *rng.integers(0, 2**32, (50, 2)).tolist()]:
        code = Tvt.morton_encode(int(x), int(y))
        assert code == Jvt.morton_encode(int(x), int(y))
        assert Tvt.morton_decode(code) == Jvt.morton_decode(code) == (x, y)


def test_bc_codec_bytes():
    rng = np.random.default_rng(9)
    noisy = rng.integers(0, 256, (36, 52, 4), dtype=np.uint8)   # ragged edge blocks
    for img in (noisy, checker_page(1, 2, 3)):
        blob = Tbc.encode_bc7_rgba8(img)
        assert blob == Jbc.encode_bc7_rgba8(img)
        h, w = img.shape[:2]
        assert np.array_equal(Tbc.decode_bc7(blob, w, h), Jbc.decode_bc7(blob, w, h))
    rg = rng.integers(0, 256, (40, 20, 2), dtype=np.uint8)
    blob = Tbc.encode_bc5_rg8(rg)
    assert blob == Jbc.encode_bc5_rg8(rg)
    assert np.array_equal(Tbc.decode_bc5(blob, 20, 40), Jbc.decode_bc5(blob, 20, 40))
    for mod in (Tbc, Jbc):
        with pytest.raises(ValueError, match="expected"):
            mod.encode_bc7_rgba8(rg)
        with pytest.raises(ValueError, match="size mismatch"):
            mod.decode_bc7(blob[:-1], 20, 40)


def test_stores_are_the_same_file_and_read_across(stores, tmp_path):
    (jp, jman), (tp, tman) = stores["jax"], stores["port"]
    assert jp.read_bytes() == tp.read_bytes() and jman == tman
    kinds = {("normal", 0, 0, 0): np.full((PAGE, PAGE, 2), 77, np.uint8),
             ("height", 0, 0, 0): np.linspace(0, 1, PAGE * PAGE, dtype=np.float32
                                              ).reshape(PAGE, PAGE)}
    assert Tvt.vt_pack(tmp_path / "t.vt", kinds) == Jvt.vt_pack(tmp_path / "j.vt", kinds)
    assert (tmp_path / "t.vt").read_bytes() == (tmp_path / "j.vt").read_bytes()
    for path_read, path_other in ((jp, tp), (tp, jp)):
        ts, js = Tvt.VTStore(path_read), Jvt.VTStore(path_other)
        for key in (("albedo", 0, 3, 5), ("albedo", 2, 1, 1)):
            assert np.array_equal(ts.request(*key), js.request(*key))
        for key in kinds:
            t = Tvt.VTStore(tmp_path / "j.vt").request(*key)
            assert np.array_equal(t, Jvt.VTStore(tmp_path / "t.vt").request(*key))
        assert ts.logical_texels == js.logical_texels
        ts.close()
        js.close()


def test_lru_eviction_and_fail_closed(stores, tmp_path):
    path, _ = stores["port"]
    budget = 2 * PAGE * PAGE * 4
    ts, js = Tvt.VTStore(path, budget_bytes=budget), Jvt.VTStore(path, budget_bytes=budget)
    for key in (("albedo", 0, 0, 0), ("albedo", 0, 1, 0), ("albedo", 0, 0, 0),
                ("albedo", 0, 2, 0), ("albedo", 0, 1, 0)):
        assert np.array_equal(ts.request(*key), js.request(*key))
    st, sj = ts.stats(), js.stats()
    st.pop("avg_upload_ms")
    sj.pop("avg_upload_ms")
    assert st == sj and st["evictions"] == 2 and st["resident_bytes"] <= budget
    for store, err in ((ts, Tvt.VtError), (js, Jvt.VtError)):
        with pytest.raises(err, match="not in store"):
            store.request("albedo", 5, 0, 0)
        assert store.fallback_texels == PAGE * PAGE
    raw = bytearray(path.read_bytes())
    raw[-5] ^= 0xFF   # inside the last page's blob
    bad = tmp_path / "bad.f3dvt"
    bad.write_bytes(bytes(raw))
    last = max(Tvt.VTStore(path).index.values(), key=lambda e: e["offset"])
    key = (last["kind"], last["level"], last["x"], last["y"])
    with pytest.raises(Tvt.VtError, match="digest mismatch"):
        Tvt.VTStore(bad).request(*key)
    with pytest.raises(Jvt.VtError, match="digest mismatch"):
        Jvt.VTStore(bad).request(*key)
    bad.write_bytes(b"not a store")
    with pytest.raises(Tvt.VtError, match="not a forge3d VT store"):
        Tvt.VTStore(bad)


def dem65():
    n = 65
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    return 3.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)


def jax_params():
    p = make_terrain_params(size_px=(96, 64))
    p.light.intensity = 1.2  # keep the tonemap out of saturation
    return p


def vt_stats(stats):
    return {k: v for k, v in stats.items() if k != "avg_upload_ms"}


def render_pair(stores, budget_pages, frames):
    path, _ = stores["port"]
    budget = budget_pages * PAGE * PAGE * 3 * 4
    jm = JMaterialSet(vt_store=Jvt.VTStore(path, budget_bytes=budget), vt_budget_bytes=budget)
    tm = rr.MaterialSet(vt_store=str(path), vt_budget_bytes=budget)
    assert isinstance(tm.vt_store, Tvt.VTStore)
    p = jax_params()
    pp = terrain_params_from_dict(p.to_dict())
    jr, tr = JRenderer(), rr.TerrainRenderer(device="cpu")
    out = []
    for _ in range(frames):
        fj, aj = jr.render_with_aov(material_set=jm, params=p, heightmap=dem65())
        ft, at = tr.render_with_aov(material_set=tm, params=pp, heightmap=dem65())
        out.append((fj, aj, dict(jr.last_vt_stats), ft, at, dict(tr.last_vt_stats)))
    assert tr.last_consumed_settings == jr.last_consumed_settings
    assert "vt" in tr.last_consumed_settings and "vt_residency_ms" in tr.last_gpu_timings
    return out


def test_vt_render_matches_jax(stores):
    frames = render_pair(stores, 24, 3)
    for fj, aj, sj, ft, at, st in frames:
        du = np.abs(fj.rgba.astype(np.int32) - ft.rgba.astype(np.int32)).max(-1)
        assert (du <= 1).mean() >= 0.995
        a, b = np.asarray(aj["albedo"], np.float64), at["albedo"].astype(np.float64)
        assert (np.abs(b - a) <= 1e-5 * (1.0 + np.abs(a))).mean() >= 0.995
        assert st["fallback_texels_frame"] == sj["fallback_texels_frame"]
        assert vt_stats(st) == vt_stats(sj)
    assert frames[-1][5]["fallback_texels_frame"] == 0.0
    assert np.array_equal(frames[1][3].rgba, frames[2][3].rgba)
    # the VT albedo drives the pixels: more than one checker value on the terrain
    alb = frames[-1][4]["albedo"][..., 0]
    assert np.unique(np.round(alb[alb > 0], 2)).size >= 2


def test_vt_budget_of_two_pages_counts_fallback(stores):
    (fj, aj, sj, ft, at, st), = render_pair(stores, 2, 1)
    assert st["fallback_texels_frame"] == sj["fallback_texels_frame"] > 0
    assert vt_stats(st) == vt_stats(sj) and st["resident_pages"] <= st["pages_in_store"]
    du = np.abs(fj.rgba.astype(np.int32) - ft.rgba.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995


def test_vt_render_with_aa_counts_sample_zero(stores):
    path, _ = stores["port"]
    budget = 6 * PAGE * PAGE * 3 * 4
    p = jax_params()
    p.sampling.aa_samples = 2
    jr, tr = JRenderer(), rr.TerrainRenderer(device="cpu")
    fj = jr.render_terrain_pbr_pom(
        material_set=JMaterialSet(vt_store=str(path), vt_budget_bytes=budget), params=p,
        heightmap=dem65())
    ft = tr.render_terrain_pbr_pom(
        material_set=rr.MaterialSet(vt_store=str(path), vt_budget_bytes=budget),
        params=terrain_params_from_dict(p.to_dict()), heightmap=dem65())
    assert tr.last_vt_stats["fallback_texels_frame"] == jr.last_vt_stats["fallback_texels_frame"]
    du = np.abs(fj.rgba.astype(np.int32) - ft.rgba.astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995


def test_terrain_stats_host_copy():
    from forge3d_tpu.terrain import stats as Js

    from forge3d_tpu_torch.terrain import stats as Ts

    rng = np.random.default_rng(6)
    tiles = {(tx, tz): rng.uniform(0, 5, (9, 9)).astype(np.float32)
             for tx in range(2) for tz in range(2)}
    tiles[(1, 0)][:, 0] = tiles[(0, 0)][:, -1]   # one watertight seam
    for mod in (Js, Ts):
        rng = np.random.default_rng(6)   # the same draws for both packages
        mod.reset_stats()
        for k in range(3):
            hit = rng.uniform(0, 1, (8, 12)) > 0.3 + 0.1 * k
            mod.record_frame_stats(hit, np.full(hit.shape, 10.0 + k), blocks_total=64,
                                   blocks_tested=20 + k)
        mod.record_vt_event(hit=False, bytes_streamed=4096, resident_pages=1)
        mod.record_vt_event(hit=True, resident_pages=1)
    for name in ("terrain_culling_stats", "terrain_visibility_stats", "terrain_vt_stats"):
        assert getattr(Ts, name)() == getattr(Js, name)(), name
    assert Ts.terrain_seam_stats(tiles) == Js.terrain_seam_stats(tiles)
    assert Ts.terrain_seam_stats(tiles)["cracks"] > 0
