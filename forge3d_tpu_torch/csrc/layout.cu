// forge3d_tpu_torch/csrc/layout.cu
// The sizes of the kernels' argument structs, which _kernels.py mirrors by
// hand in ctypes: _kernels.bind compares them with the mirrors when the
// library loads (a field out of place shifts every uniform after it
// without a word).

#include "adjudication.cuh"
#include "leaf.cuh"
#include "pt.cuh"
#include "screen.cuh"
#include "smoke.cuh"
#include "terrain_shade.cuh"

extern "C" {

// in _kernels.STRUCTS' order; returns the number of structs
int f3d_struct_sizes(long long* out, int n) {
    const long long sizes[] = {(long long)sizeof(ScreenArgs), (long long)sizeof(ScreenOut),
                               (long long)sizeof(ClipArgs),   (long long)sizeof(SkyArgs),
                               (long long)sizeof(SdfArgs),    (long long)sizeof(MeshArgs),
                               (long long)sizeof(TlasArgs),   (long long)sizeof(HybridArgs),
                               (long long)sizeof(HybridOut),  (long long)sizeof(AdjArgs),
                               (long long)sizeof(TerrainArgs), (long long)sizeof(TerrainOut),
                               (long long)sizeof(SmokeMarchArgs), (long long)sizeof(PreethamArgs),
                               (long long)sizeof(GuideArgs),  (long long)sizeof(TlasInst),
                               (long long)sizeof(LightArgs)};
    const int count = (int)(sizeof(sizes) / sizeof(sizes[0]));
    for (int i = 0; i < n && i < count; ++i) out[i] = sizes[i];
    return count;
}

}  // extern "C"
