# forge3d_tpu_torch/codec: the codecs of forge3d_tpu/codec. F3DZ, the
# error-bounded DEM compression (f3dz.py: the host C++ encoder and decoder,
# native/f3dz.cpp; f3dz_pylane.py: the pure-Python decode lane;
# f3dz_device.py: the decode lane on the card, kernel C1 in csrc/codec.cu),
# and the host BC7 (mode 6) / BC5 texture codec of codec/bc.py, which the
# virtual-texture store packs its pages with (native/bc.cpp). The host C++
# is built with g++ at first use.

from .f3dz import F3dzError, compress_dem, decompress_dem, f3dz_info, verify_dem
from .f3dz_device import decompress_dem_device

__all__ = ["compress_dem", "decompress_dem", "decompress_dem_device",
           "verify_dem", "f3dz_info", "F3dzError"]
