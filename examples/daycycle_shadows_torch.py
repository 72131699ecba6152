#!/usr/bin/env python
# examples/daycycle_shadows_torch.py -- a day of sun positions from the solar
# ephemeris driving terrain shadow renders, on the PyTorch port (the
# counterpart of examples/daycycle_shadows.py, hour for hour): the sun's
# azimuth and elevation from sky.sun_position_at (the port's copy of the
# Meeus series in astro.py), then a sweep render of the terrain per hour.
#
#   python examples/daycycle_shadows_torch.py            # on the GPU
#   python examples/daycycle_shadows_torch.py --device cpu

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

LAT, LON = 46.85, -121.76          # Mount Rainier
JD0 = 2460855.5                    # 2025-06-29 00:00 UTC
HOURS = (16.0, 20.0, 24.0)         # morning / noon / evening local-ish


def dem() -> np.ndarray:
    n = 65
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    return (10.0 * np.sin(x * 0.09) * np.cos(y * 0.07)).astype(np.float32)


CAM = dict(origin=(32.0, 26.0, 88.0), look_at=(32.0, 0.0, 32.0), fov_y=45.0)


def render_hours(device="cuda", hours=HOURS):
    """{hour: (azimuth, elevation, rgba)} for each hour with the sun above
    2 degrees, rendered on `device`."""
    import forge3d_tpu_torch as f3t
    from forge3d_tpu_torch.sky import sun_position_at

    out = {}
    for h in hours:
        az, el = sun_position_at(JD0 + h / 24.0, LAT, LON)
        if el <= 2.0:
            out[h] = (az, el, None)
            continue
        r = f3t.hybrid_render_terrain_reference(
            dem(), 96, 72, CAM, spp=1, seed=5, traversal="sweep",
            sun_azimuth_deg=float(az), sun_elevation_deg=float(el), device=device)
        out[h] = (az, el, r["rgba"])
    return out


def main(out_dir="daycycle_torch", device="cuda") -> None:
    from forge3d_tpu_torch.io.image import numpy_to_png

    out = pathlib.Path(out_dir)
    out.mkdir(exist_ok=True)
    for h, (az, el, rgba) in render_hours(device).items():
        if rgba is None:
            print(f"hour {h}: sun below horizon (el {el:.1f}), skipping")
            continue
        p = out / f"daycycle_h{int(h):02d}.png"
        numpy_to_png(p, rgba)
        print(f"hour {h}: sun az {az:.1f} el {el:.1f} -> {p.name}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="daycycle_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out, args.device)
