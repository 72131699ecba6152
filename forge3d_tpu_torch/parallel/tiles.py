# forge3d_tpu_torch/parallel/tiles.py
# Row-sharded rendering of the per-ray terrain path tracer
# (forge3d_tpu/parallel/tiles.py), M1's per-ray half: every rank owns a
# contiguous band of the frame's pixel rows; the pyramid, the scene and the
# center G-buffer (K5 + K8) are built whole on every rank, as JAX replicates
# them. Per frame a rank runs K6 on its band (frame_step_band), the ranks
# all-gather the merged reservoirs, and K7 runs on the band while reading
# the whole gathered frame (spatial_reuse_band): ReSTIR's neighbours lie up
# to 3 rows away, and a band may be thinner than that (8 rows a device in
# the JAX package's dry run, 2 in the tests), so halos from the adjacent
# ranks alone would not do in general. The collectives are NCCL's on the
# card (the TPU's cross-chip copies, hopper-kernels guide §4), gloo's on the
# CPU. The frames' pixels are those of the unsharded render, bit for bit:
# each pixel's seeds and rays depend on its place in the frame, not on the
# band.

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import frame_mesh, replicated_sharding, tile_sharding


def shard_frame(mesh, *, row_arrays=(), flat_arrays=(), replicated=()):
    """Put frame state on this rank: arrays whose dim 0 is pixel rows
    (H, ...) and arrays of shape (H*W, ...) as this rank's band, read-only
    tables whole. Returns the three groups in the same order."""
    out_rows = tuple(tile_sharding(mesh, ndim=a.ndim).shard(a) for a in row_arrays)
    out_flat = tuple(tile_sharding(mesh, ndim=a.ndim).shard(a) for a in flat_arrays)
    rep = replicated_sharding(mesh)
    return out_rows, out_flat, tuple(rep.shard(a) for a in replicated)


def _gather_reservoirs(mesh, res):
    """The ranks' band reservoirs as the whole frame's: the ten fields
    packed into one int32 tensor, so one all_gather a frame carries them."""
    from ..ops.restir import Reservoirs

    packed = torch.stack([f.view(torch.int32) for f in res.fields()])
    whole = mesh.all_gather(packed, dim=1)
    return Reservoirs(*(whole[k].view(f.dtype) for k, f in enumerate(res.fields())))


def render_frames_sharded(desc, n_frames: int, mesh=None):
    """Run `n_frames` accumulation frames of the terrain PT reference with
    the frame's rows sharded across `mesh` (default: the default process
    group's ranks, or this process alone).

    Returns (accum (H, W, 4), welford (H, W, 2), reservoirs over H*W) for
    the whole frame on every rank, on its device: JAX's gather at writeout.
    A scene's mesh is not traced, as in the JAX package; its typed lights
    are."""
    from ..ops import restir as rst
    from ..ops.pyramid import build_pyramid
    from ..ops.shading import env_map
    from ..ops.traversal import scene_from_pyramid
    from ..pt import terrain_ref as tr

    mesh = mesh if mesh is not None else frame_mesh()
    H, W = desc.height, desc.width
    band = tile_sharding(mesh, ndim=3).band(H)
    row0, rows = band.start, band.stop - band.start
    dev = mesh.device

    pyr = build_pyramid(np.asarray(desc.heights, np.float32))
    scene = scene_from_pyramid(pyr, origin_xz=(0.0, 0.0), spacing_xz=desc.spacing,
                               exaggeration=desc.exaggeration, device=dev)
    ctx = tr.make_context(dataclasses.replace(desc, mesh=None), scene,
                          env_map(desc.env_map, desc.env_intensity, dev))
    gb_n = tr.center_gbuffer(ctx)["gb_n"]

    accum = torch.zeros((rows, W, 4), dtype=torch.float32, device=dev)
    welford = torch.zeros((rows, W, 2), dtype=torch.float32, device=dev)
    res = rst.Reservoirs.zeros(rows * W, dev)
    for f in range(int(n_frames)):
        accum, welford, merged = tr.frame_step_band(ctx, accum, welford, res, f, row0)
        res = rst.spatial_reuse_band(_gather_reservoirs(mesh, merged), *gb_n, W, H, f,
                                     ctx.seed_hi, row0, rows)
    return mesh.all_gather(accum), mesh.all_gather(welford), _gather_reservoirs(mesh, res)
