# forge3d_tpu_torch/terrain: the perspective TerrainRenderer (kernel R1),
# its parameters and the offline accumulation driver; screen.py holds the
# screen and clipmap camera modes (kernels S1-S9).
from .params import TerrainRenderParams, make_terrain_params  # noqa: F401
from .renderer import IBL, MaterialSet, TerrainRenderer  # noqa: F401
from .offline import (  # noqa: F401
    OfflineProgress,
    OfflineQualitySettings,
    OfflineResult,
    render_offline,
)
