# forge3d_tpu_torch/codec: the host BC7 (mode 6) / BC5 texture codec of
# forge3d_tpu/codec/bc.py (codec/bc.py), which the virtual-texture store
# packs its pages with. Host C++ (native/bc.cpp), built with g++ at first
# use.
