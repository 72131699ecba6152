# forge3d_tpu_torch/parallel/sweep.py
# Frame-sharded rendering of the sweep estimator
# (forge3d_tpu/parallel/sweep.py), M1's sweep half: the converged render's
# jittered frames are independent, so each rank integrates its share of
# them (K2 sweeps and K3 polar frames into one (E, A, 9) accumulator), one
# all_reduce sums the accumulators (JAX's psum), and every rank runs the
# one K4 resolve of the mean.

from __future__ import annotations

from .mesh import frame_mesh


def render_sweep_sharded(desc, n_frames: int, mesh=None):
    """Render the converged sweep frame with frames sharded across `mesh`
    (default: the default process group's ranks, or this process alone).

    Rank r integrates frames r * per_dev .. (r + 1) * per_dev - 1 of the
    render's frame keys (fold_in(PRNGKey(seed), i)); the only collective is
    one sum of the (E, A, 9) polar accumulator. Returns the same dict as
    render_terrain_sweep, with `devices` and `frames_per_device`. n_frames
    rounds up to a multiple of the rank count. With one rank the render is
    render_terrain_sweep's with the same frames, bit for bit; with more,
    the sum's order changes."""
    from ..ops import sweep as sw
    from ..pt import terrain_sweep as ts
    from ..pt.terrain_ref import _validate

    _validate(desc)
    mesh = mesh if mesh is not None else frame_mesh()
    n_dev = mesh.size
    per_dev = max(1, -(-int(n_frames) // n_dev))
    n_frames = per_dev * n_dev

    plan = ts.plan_for(desc, 32, 12, -0.55)
    scene = ts.make_scene(desc, mesh.device)
    rot = sw.rotate_heights(scene.heights, plan.rot)
    mine = ts.frame_jitters(int(desc.seed) & 0xFFFFFFFF, n_frames)[
        mesh.rank * per_dev:(mesh.rank + 1) * per_dev]
    acc = mesh.all_reduce_(ts.accumulate(plan, scene, rot, mine))
    packed = ts.resolve(plan, acc, n_frames)
    return ts._unpack_render(desc, packed.cpu().numpy(), n_frames,
                             extra={"devices": int(n_dev), "frames_per_device": int(per_dev)})
