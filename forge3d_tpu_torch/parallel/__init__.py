# forge3d_tpu_torch/parallel: the sharded renders of forge3d_tpu/parallel
# (M1) over torch.distributed. The per-ray path shards each frame's pixel
# rows across the ranks (K6 and K7 on a rank's band, the reservoirs
# all-gathered between them, the frame gathered at writeout); the sweep
# shards the converged render's frames and sums the polar accumulator with
# one all_reduce. NCCL on the card, gloo on the CPU; without a process group
# the mesh is this process alone.
from .mesh import frame_mesh, tile_sharding, replicated_sharding  # noqa: F401
from .tiles import shard_frame, render_frames_sharded  # noqa: F401
from .sweep import render_sweep_sharded  # noqa: F401
