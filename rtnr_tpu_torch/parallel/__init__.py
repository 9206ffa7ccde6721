"""Multi-rank rendering and training on ``torch.distributed`` (the port's
``rtnr_tpu/parallel``): the mesh of ranks, point-sharded and batched
rendering, row-strip tiles and the sharded differentiable raster."""

from rtnr_tpu_torch.parallel.mesh import init_distributed, make_mesh
from rtnr_tpu_torch.parallel.render import (
    rasterize_point_sharded,
    render_filtered_sharded,
    render_full_batch,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "rasterize_point_sharded",
    "render_filtered_sharded",
    "render_full_batch",
]
