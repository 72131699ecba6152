#!/usr/bin/env python
# examples/wildfire_smoke_frames_torch.py -- terrain + animated smoke overlay
# frame sequence on the PyTorch port (the counterpart of
# examples/wildfire_smoke_frames.py, step for step): a Terrarium round trip
# of a named DEM, a TerrainRenderer base, then per frame an emitter, a fluid
# step and a volume march alpha-composited over the base.
#
#   python examples/wildfire_smoke_frames_torch.py            # on the GPU
#   python examples/wildfire_smoke_frames_torch.py --device cpu

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(n_frames=8, out_dir="wildfire_frames_torch", device="cuda"):
    import forge3d_tpu_torch as f3t
    from forge3d_tpu_torch.gis.osm import build_terrarium_dem, decode_terrarium_dem
    from forge3d_tpu_torch.io.image import numpy_to_png
    from forge3d_tpu_torch.smoke import SmokeDomain, SmokeEmitter, SmokeStepSettings
    from forge3d_tpu_torch.terrain.params import make_terrain_params
    from forge3d_tpu_torch.terrain.renderer import TerrainRenderer

    Path(out_dir).mkdir(exist_ok=True)

    # DEM shipped as a Terrarium tile round-trip (the video pipeline's
    # ingest format)
    dem, _ = f3t.fetch_dem("rainier", size=256)
    dem = decode_terrarium_dem(build_terrarium_dem(dem))

    dom = SmokeDomain(24, 16, 24, voxel_size=(8.0, 8.0, 8.0), device=device)
    emitter = SmokeEmitter(center=(96.0, 8.0, 96.0), radius=18.0,
                           density_rate=4.0, temperature_rate=3.0)
    settings = SmokeStepSettings(dt=0.6, buoyancy=1.2, dissipation=0.02)

    p = make_terrain_params()
    p.size_px = (480, 300)
    p.cam_radius = 420.0
    p.cam_theta_deg = 35.0
    p.cam_target = (128.0, 0.0, 128.0)
    p.z_scale = 0.08
    renderer = TerrainRenderer(device=device)
    base = renderer.render_terrain_pbr_pom(params=p, heightmap=dem).rgba

    for f_i in range(n_frames):
        dom.add_emitter(emitter, settings.dt)
        dom.step(settings)
        overlay = dom.render_rgba(480, 300,
                                  cam_origin=(128, 260, 540),
                                  cam_look_at=(128, 0, 128))
        a = overlay[..., 3:4].astype(np.float32) / 255.0
        frame = base.copy()
        frame[..., :3] = (base[..., :3] * (1 - a)
                          + overlay[..., :3] * a).astype(np.uint8)
        numpy_to_png(f"{out_dir}/frame_{f_i:04d}.png", frame)
    print(f"wrote {n_frames} frames to {out_dir}/")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out-dir", default="wildfire_frames_torch")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.frames, args.out_dir, args.device)
