from .common import PreprocessedGaussians, RenderSettings, preprocess, tile_grid
from .composite import (CompositeSorted, composite_bwd, composite_bwd_plain, composite_fwd,
                        composite_fwd_plain, pack_fields)
from .tiled import bin_and_sort, render_tiled

__all__ = [
    "PreprocessedGaussians", "RenderSettings", "preprocess", "tile_grid",
    "CompositeSorted", "composite_bwd", "composite_bwd_plain", "composite_fwd",
    "composite_fwd_plain", "pack_fields", "bin_and_sort", "render_tiled",
]
