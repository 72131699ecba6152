#!/usr/bin/env python
# examples/dem_compression_f3dz_torch.py -- error-bounded DEM compression
# with the F3DZ codec on the PyTorch port (the counterpart of
# examples/dem_compression_f3dz.py, bound for bound): the host C++ codec
# compresses and decodes, verify_dem reports, and the device lane decodes
# the same stream on the card (kernel C1: the 512^2 page is four full
# tiles), byte-identical to the C++ lane; a corrupt byte is refused.
#
#   python examples/dem_compression_f3dz_torch.py            # on the GPU
#   python examples/dem_compression_f3dz_torch.py --device cpu

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def page(n: int = 512) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    rng = np.random.default_rng(11)
    return (900.0 + 220.0 * np.sin(x * 0.015) * np.cos(y * 0.012)
            + 6.0 * rng.standard_normal((n, n))).astype(np.float32)


def main(device: str = "cuda") -> None:
    import forge3d_tpu_torch as f3t
    from forge3d_tpu_torch.codec import decompress_dem_device

    dem = page()
    for max_err in (1.0, 0.1, 0.01):
        blob = f3t.compress_dem(dem, max_error=max_err)
        back = f3t.decompress_dem(blob)
        err = float(np.abs(back - dem).max())
        ratio = dem.nbytes / len(blob)
        ok = f3t.verify_dem(blob, dem)
        on_device = decompress_dem_device(blob, device=device)
        same = bool(np.array_equal(on_device.view(np.uint32), back.view(np.uint32)))
        print(f"max_error={max_err:>5}: {len(blob) / 1024:8.1f} KiB "
              f"({ratio:5.2f}x), worst error {err:.4g}, "
              f"verify ok={ok['ok']}, device lane ({device}) byte-identical={same}")
        assert err <= max_err and same

    # corrupt one byte: decode fails closed
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    try:
        f3t.decompress_dem(bytes(bad))
        print("ERROR: corrupt bundle decoded")
    except Exception as e:
        print(f"corrupt page refused as expected: {type(e).__name__}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
