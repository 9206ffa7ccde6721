"""Point-sharded differentiable raster: scene and pose gradients over ranks.

Counterpart of ``rtnr_tpu/parallel/diff.py`` (its ``custom_vjp`` is one
``torch.autograd.Function`` here, the same one that serves a single card:
``ops/raster_diff._DiffCore``, which over a mesh of one rank is the serial
raster). Every rank calls the same function with its block of points and
colours on the ``"points"`` axis and, in the batched form, all F camera
matrices (it renders its F / n_batch frames on the ``"batch"`` axis).

The forward merges each frame in two passes: the local z-buffer, ``pmin``
over points, then the in-band sums against the merged z-buffer
(``band_ref``) and a ``psum`` over points; the lowest rank among
exact-depth ties owns a pixel's depth cotangent (``diff.py:111-115``). On
the card both passes are ``rtnr_resolve_diff`` (``ops/raster_resolve4.py``);
over a points axis of size 1 one launch does both. The backward is JAX's
``bwd_sm``; ``ops/raster_diff._fwd_frame`` and ``_DiffCore`` say how each
gradient merges over the axes.
"""

from __future__ import annotations

from typing import Optional

import torch

from rtnr_tpu_torch.ops.raster_diff import DiffRaster, rasterize_diff_frames
from rtnr_tpu_torch.parallel.mesh import Mesh


def rasterize_diff_point_sharded(points, colors, cam_proj, mesh: Mesh, *, width: int,
                                 height: int, valid: Optional[torch.Tensor] = None,
                                 depth_band: float = 0.02,
                                 points_axis: str = "points") -> DiffRaster:
    """Differentiable single-frame raster with the scene split over
    ``points_axis``: ``rasterize_diff_sorted``'s contract, the images
    replicated; the gradients of this rank's points and colours, and of
    ``cam_proj`` (4, 4) (merged over points) on every rank."""
    out = rasterize_diff_frames(points, colors, cam_proj[None], width=width, height=height,
                                valid=valid, depth_band=depth_band, mesh=mesh,
                                points_axis=points_axis)
    return DiffRaster(*(t[0] for t in out))


def rasterize_diff_sharded_batch(points, colors, cam_projs, mesh: Mesh, *, width: int,
                                 height: int, valid: Optional[torch.Tensor] = None,
                                 depth_band: float = 0.02, points_axis: str = "points",
                                 batch_axis: str = "batch") -> DiffRaster:
    """Batched frames: ``cam_projs`` (F, 4, 4), every frame on every rank;
    the DiffRaster fields hold the rank's (F / n_batch) frames with a leading
    frame axis. The point and colour gradients sum over all F frames."""
    return rasterize_diff_frames(points, colors, cam_projs, width=width, height=height,
                                 valid=valid, depth_band=depth_band, mesh=mesh,
                                 points_axis=points_axis, batch_axis=batch_axis)
