# The port's sharded renders (forge3d_tpu_torch.parallel, M1) on the CPU:
# worlds of 1, 2 and 4 gloo ranks, spawned with torch.multiprocessing and a
# FileStore, against each other, against the port's unsharded renders and
# against forge3d_tpu.parallel on 1, 2, 4 and 8 virtual devices.
#
# Cases: render_frames_sharded for 2 frames on
# tests/test_sharded_equivalence.py's _desc(64, 64) and on
# __graft_entry__._small_desc(64, 8, 33), whose bands are 8, 4 and 2 rows;
# render_sweep_sharded for 8 frames on that file's 64x48 sweep scene.
#
# Gates:
# - per-ray, N = 2 and 4 against N = 1: accum, welford and every reservoir
#   field bit-identical, on every rank (each pixel's seeds and rays follow
#   its place in the frame, not its band);
# - per-ray, N = 1 against JAX on 1 and 8 devices: the per-ray frame rule
#   of tests/test_torch_terrain_ref.py (floats within 1e-5 * (1 + |ref|) and
#   integer reservoir fields equal, each on >= 99.9% of elements);
# - sweep, world N against JAX on N devices: tests/test_torch_sweep.py's
#   render rule (rgba within one u8 step on >= 99.5% of pixels, depth NaN
#   masks equal on >= 99.9%, frames and method equal);
# - sweep, N = 1: bit-identical to the port's render_terrain_sweep with the
#   same 8 frames; N = 2 and 4: rgba within 1 LSB and hdr within rtol 1e-5,
#   atol 1e-6 (tests/test_sharded_equivalence.py:76-79: the sum's order
#   changes);
# - `devices` and `frames_per_device` as JAX gives them; a height that the
#   rank count does not divide raises ValueError.
#
# The spawned ranks import this module, so it imports jax and the JAX
# package only inside the tests.
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

FRAC = 0.999
WORLDS = (1, 2, 4)
FIELDS = ("dir_x", "dir_y", "dir_z", "intensity", "light_type", "light_index", "w_sum", "m",
          "weight", "target_pdf")


def equivalence_desc_kw(w, h):
    """tests/test_sharded_equivalence.py:_desc's fields."""
    n = 65
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (6.0 * np.sin(xx * 0.15) * np.cos(yy * 0.12)).astype(np.float32)
    return dict(heights=dem, cam_origin=(32.0, 25.0, 88.0), cam_look_at=(32.0, 0.0, 32.0),
                fov_y_deg=42.0, width=w, height=h, spp=1, seed=1234)


def sweep_desc_kw():
    """test_sharded_equivalence.py:test_sweep_frame_sharding_smoke's scene."""
    n = 33
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (4.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)).astype(np.float32)
    return dict(heights=dem, cam_origin=(16.0, 14.0, 48.0), cam_look_at=(16.0, 0.0, 16.0),
                fov_y_deg=42.0, width=64, height=48, spp=1)


def _rank(rank, world, store_path, out_dir, cases):
    """One rank of a gloo world: every case, its results saved by rank."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        from forge3d_tpu_torch.parallel import frame_mesh, render_frames_sharded
        from forge3d_tpu_torch.parallel import render_sweep_sharded
        from forge3d_tpu_torch.pt.terrain_ref import TerrainRefDesc

        mesh = frame_mesh(device="cpu")
        out = {}
        for name, kw in cases["per_ray"].items():
            acc, wf, res = render_frames_sharded(TerrainRefDesc(**kw), 2, mesh=mesh)
            out[f"{name}/accum"], out[f"{name}/welford"] = acc.numpy(), wf.numpy()
            for f in FIELDS:
                out[f"{name}/{f}"] = getattr(res, f).clone().numpy()
        sw = render_sweep_sharded(TerrainRefDesc(**cases["sweep"]), 8, mesh=mesh)
        for k in ("rgba", "hdr", "depth"):
            out[f"sweep/{k}"] = sw[k]
        for k in ("devices", "frames_per_device", "frames"):
            out[f"sweep/{k}"] = np.asarray(sw[k])
        out["sweep/method"] = np.asarray(sw["method"])
        bad = dict(cases["sweep"], height=world + 1 if world > 1 else 7)
        try:
            render_frames_sharded(TerrainRefDesc(**bad), 1, mesh=mesh)
            out["raised"] = np.asarray("")
        except ValueError as e:
            out["raised"] = np.asarray(str(e))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cases():
    import __graft_entry__ as graft

    small = graft._small_desc(64, 8, 33)
    return {"per_ray": {"equivalence_64x64": equivalence_desc_kw(64, 64),
                        "graft_64x8": {k: getattr(small, k)
                                       for k in small.__dataclass_fields__}},
            "sweep": sweep_desc_kw()}


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    """{N: [rank 0's results, rank 1's, ...]} for each world."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        mp.spawn(_rank, args=(world, str(d / "store"), str(d), cases), nprocs=world)
        out[world] = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return out


def close_frac(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    ok = np.abs(got - ref) <= 1e-5 * (1.0 + np.abs(ref))
    return float((ok | (np.isnan(ref) & np.isnan(got))).mean())


def keys_of(results, prefix):
    return [k for k in results if k.startswith(prefix + "/")]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["equivalence_64x64", "graft_64x8"])
def test_per_ray_bands_bit_identical_to_one_rank(worlds, case, world):
    one = worlds[1][0]
    keys = keys_of(one, case)
    assert len(keys) == 12
    for rank_out in worlds[world]:
        for k in keys:
            np.testing.assert_array_equal(rank_out[k], one[k], err_msg=k)
    assert (one[f"{case}/accum"][..., 3] == 2.0).all()


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("case", ["equivalence_64x64", "graft_64x8"])
def test_per_ray_one_rank_matches_jax(worlds, cases, case, n_dev):
    import jax

    from forge3d_tpu.parallel.mesh import frame_mesh as jax_mesh
    from forge3d_tpu.parallel.tiles import render_frames_sharded as jax_render
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc as JDesc

    acc, wf, res = jax_render(JDesc(**cases["per_ray"][case]), 2,
                              mesh=jax_mesh(jax.devices()[:n_dev]))
    got = worlds[1][0]
    assert close_frac(acc, got[f"{case}/accum"]) >= FRAC
    assert close_frac(wf, got[f"{case}/welford"]) >= FRAC
    for f in FIELDS:
        a, b = np.asarray(getattr(res, f)), got[f"{case}/{f}"]
        if f in ("light_type", "light_index", "m"):
            assert (a.astype(np.int64) == b.astype(np.int64)).mean() >= FRAC, f
        else:
            assert close_frac(a, b) >= FRAC, f


@pytest.mark.parametrize("world", WORLDS)
def test_sweep_matches_jax(worlds, cases, world):
    import jax

    from forge3d_tpu.parallel.mesh import frame_mesh as jax_mesh
    from forge3d_tpu.parallel.sweep import render_sweep_sharded as jax_sweep
    from forge3d_tpu.pt.terrain_ref import TerrainRefDesc as JDesc

    a = jax_sweep(JDesc(**cases["sweep"]), 8, mesh=jax_mesh(jax.devices()[:world]))
    b = worlds[world][0]
    du = np.abs(a["rgba"].astype(np.int32) - b["sweep/rgba"].astype(np.int32)).max(-1)
    assert (du <= 1).mean() >= 0.995
    assert (np.isnan(a["depth"]) == np.isnan(b["sweep/depth"])).mean() >= 0.999
    assert a["frames"] == int(b["sweep/frames"]) == 8
    assert a["method"] == str(b["sweep/method"]) == "sweep"
    assert a["devices"] == int(b["sweep/devices"]) == world
    assert a["frames_per_device"] == int(b["sweep/frames_per_device"]) == 8 // world


def test_sweep_one_rank_equals_render_terrain_sweep(worlds, cases):
    from forge3d_tpu_torch.pt.terrain_ref import TerrainRefDesc
    from forge3d_tpu_torch.pt.terrain_sweep import render_terrain_sweep

    ref = render_terrain_sweep(TerrainRefDesc(**cases["sweep"]), frames=8, device="cpu")
    got = worlds[1][0]
    for k in ("rgba", "hdr", "depth"):
        np.testing.assert_array_equal(got[f"sweep/{k}"], ref[k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_sweep_ranks_within_one_lsb(worlds, world):
    one = worlds[1][0]
    for b in worlds[world]:
        diff = np.abs(one["sweep/rgba"].astype(np.int16) - b["sweep/rgba"].astype(np.int16))
        assert int(diff.max()) <= 1
        np.testing.assert_allclose(b["sweep/hdr"], one["sweep/hdr"], rtol=1e-5, atol=1e-6)
    for b in worlds[world][1:]:    # every rank resolves the same sum
        np.testing.assert_array_equal(b["sweep/rgba"], worlds[world][0]["sweep/rgba"])


@pytest.mark.parametrize("world", [2, 4])
def test_height_not_divisible_raises(worlds, world):
    for b in worlds[world]:
        assert f"must divide across {world} devices" in str(b["raised"])
    assert str(worlds[1][0]["raised"]) == ""


def test_mesh_of_one_process():
    """Without a process group: one rank whose collectives are identities;
    the sharding helpers give it every row."""
    from forge3d_tpu_torch.parallel import frame_mesh, replicated_sharding, shard_frame
    from forge3d_tpu_torch.parallel import tile_sharding
    from forge3d_tpu_torch.parallel.mesh import TILE_AXIS

    assert not dist.is_initialized() and TILE_AXIS == "tiles"
    m = frame_mesh(device="cpu")
    assert (m.rank, m.size, m.device, m.group) == (0, 1, torch.device("cpu"), None)
    t = torch.arange(12.0).reshape(6, 2)
    assert m.all_reduce_(t.clone()).equal(t) and m.all_gather(t).equal(t)
    assert tile_sharding(m, ndim=2).band(6) == slice(0, 6)
    rows, flat, rep = shard_frame(m, row_arrays=(np.zeros((6, 4, 3)),),
                                  flat_arrays=(np.ones(24),), replicated=(np.ones(5),))
    assert rows[0].shape == (6, 4, 3) and flat[0].shape == (24,) and rep[0].shape == (5,)
    assert replicated_sharding(m).shard(t).equal(t)
    assert frame_mesh([0], device="cpu").size == 1
    with pytest.raises(ValueError, match="process group's ranks"):
        frame_mesh([0, 1], device="cpu")


def test_tile_sharding_bands_of_ranks():
    from forge3d_tpu_torch.parallel.mesh import FrameMesh, tile_sharding

    bands = [tile_sharding(FrameMesh(None, r, 4, torch.device("cpu")), ndim=3).band(8)
             for r in range(4)]
    assert bands == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    sh = tile_sharding(FrameMesh(None, 1, 2, torch.device("cpu")), ndim=2, axis=1)
    assert sh.shard(np.arange(12).reshape(2, 6)).tolist() == [[3, 4, 5], [9, 10, 11]]
    with pytest.raises(ValueError, match="must divide across 4 devices"):
        bands = tile_sharding(FrameMesh(None, 0, 4, torch.device("cpu"))).band(6)


def test_default_device_is_cuda():
    from forge3d_tpu_torch.errors import DeviceError
    from forge3d_tpu_torch.parallel import frame_mesh

    if torch.cuda.is_available():
        assert frame_mesh().device.type == "cuda"
    else:
        with pytest.raises(DeviceError):
            frame_mesh()
