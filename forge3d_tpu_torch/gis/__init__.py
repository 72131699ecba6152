# forge3d_tpu_torch/gis
# A host copy of the part of forge3d_tpu/gis that MapScene reads: the
# GeoTIFF reader and writer (geotiff.py, struct and zlib) and
# read_raster_info. TerrainSource(path=...) and RasterOverlayLayer paths
# other than PNG go through it.

from __future__ import annotations

from .geotiff import RasterInfo, raster_info, read_raster, write_raster  # noqa: F401


def read_raster_info(path) -> dict:
    info = raster_info(path)
    return {
        "width": info.width, "height": info.height, "count": info.count,
        "dtype": info.dtype, "nodata": info.nodata,
        "transform": info.transform, "crs": info.crs,
        "bounds": info.bounds, "resolution": info.resolution,
        "tiled": info.tiled, "block_size": info.block_size,
    }
