#!/usr/bin/env python
# examples/multichip_sweep_torch.py -- the converged sweep render with its
# jittered frames split across ranks, on the PyTorch port (the counterpart
# of examples/multichip_sweep.py): each rank renders its share of the 8
# frames, one all_reduce sums the polar accumulators, and every rank
# resolves the same image. Under torchrun every rank takes a card of its
# own and the ranks meet over NCCL; alone, it runs one rank (a one-rank
# process group), on the card or with --device cpu over gloo.
#
#   torchrun --nproc-per-node 4 examples/multichip_sweep_torch.py [out.png]
#   python examples/multichip_sweep_torch.py [out.png] [--device cpu]

import argparse
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(out_path="examples/out/multichip_sweep_torch.png", device="cuda"):
    import torch.distributed as dist

    from forge3d_tpu_torch.io.image import numpy_to_png
    from forge3d_tpu_torch.parallel import frame_mesh
    from forge3d_tpu_torch.parallel.sweep import render_sweep_sharded
    from forge3d_tpu_torch.pt.terrain_ref import TerrainRefDesc

    backend = "nccl" if device == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:       # torchrun names the rendezvous
        if device == "cuda":
            import torch

            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        n = 129
        yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
        dem = (12.0 * np.sin(xx * 0.08) * np.cos(yy * 0.06)).astype(np.float32)
        desc = TerrainRefDesc(heights=dem, cam_origin=(64.0, 42.0, 170.0),
                              cam_look_at=(64.0, 0.0, 64.0), fov_y_deg=45.0,
                              width=320, height=240, spp=1)
        mesh = frame_mesh(device=device)
        out = render_sweep_sharded(desc, n_frames=8, mesh=mesh)
        if mesh.rank == 0:
            print(f"rendered on {out['devices']} ranks ({mesh.device}), "
                  f"{out['frames_per_device']} frames each")
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            numpy_to_png(out_path, out["rgba"])
            print(f"wrote {out_path}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="examples/out/multichip_sweep_torch.png")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    main(a.out, a.device)
