"""Output-tile sharding: image row strips over a ``"tiles"`` mesh axis.

Counterpart of ``rtnr_tpu/parallel/tiles.py``. Each rank owns the row strip
[t * strip_h, (t + 1) * strip_h) of the image (t: its place on the tiles
axis) and rasters only the points that land in it; with a points axis too,
each (tile, point block) rank merges as ``parallel/render.py`` does. The
strips are all-gathered over the tiles axis into full, replicated frames.

The strip's pixel rows are the full image's minus an integer offset
(``project_and_sort(..., row_offset=)``), so they are bit-identical to the
one-card raster; ``strip_projection`` (the shift baked into the matrix) is
kept for the per-strip block culling, whose test needs a pinhole matrix at
(width x strip_h). Without a points axis the strip raster is the main
path's one launch of ``rtnr_resolve4``; with one, the two passes of
``render.merged_sums``.

``render_full_tile_sharded`` runs the whole pipeline on strips: each rank
exchanges ``halo`` boundary rows with its ring neighbours
(``collectives.ppermute_ring``), runs the strip-mode prefilter on its
halo-extended strip (core rows bit-identical to the full image's), and the
U-Net on its core plus ``unet_halo`` rows (rows beyond the image zeroed);
seams differ from the one-card frame only by the receptive field beyond
``unet_halo``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rtnr_tpu_torch.config import DEPTH_EMPTY
from rtnr_tpu_torch.ops.culling import compact_points, cull_points
from rtnr_tpu_torch.ops.prefilter import filter_frame
from rtnr_tpu_torch.ops.raster import depth_min_max, project_and_sort, resolve_uint8
from rtnr_tpu_torch.parallel.collectives import (
    all_gather,
    pmax,
    pmin,
    ppermute_ring,
    psum,
)
from rtnr_tpu_torch.parallel.mesh import Mesh
from rtnr_tpu_torch.parallel.render import merged_sums, unet_rgb


def strip_projection(cam_proj: torch.Tensor, t: int, strip_h: int) -> torch.Tensor:
    """The projection whose rows [0, strip_h) are strip t's: row 1 minus
    (t * strip_h) times row 2, in f32 (``tiles.py:36-39``)."""
    M = cam_proj.to(torch.float32).clone()
    shift = torch.tensor(float(t), dtype=torch.float32) * torch.tensor(float(strip_h),
                                                                        dtype=torch.float32)
    M[1] = M[1] + (-shift.to(M.device)) * M[2]
    return M


def _strip_raster(points, colors, valid, cam_proj, mesh, t, *, width, strip_h, depth_band,
                  points_axis):
    """This rank's strip: (rgb (strip_h, W, 3) uint8, depth (strip_h, W))."""
    hw = width * strip_h
    sp = project_and_sort(points, colors, cam_proj, width=width, height=strip_h, valid=valid,
                          row_offset=t * strip_h)
    sums4, depth = merged_sums(sp, mesh, points_axis, hw, depth_band)
    rgb = resolve_uint8(sums4[:, :3], sums4[:, 3])
    return rgb.reshape(strip_h, width, 3), depth.reshape(strip_h, width)


def rasterize_tile_sharded(points, colors, valid, cam_proj, mesh: Mesh, *, width: int,
                           height: int, depth_band: float = 0.02, tiles_axis: str = "tiles",
                           points_axis: Optional[str] = None, block_index=None,
                           tile_budget: Optional[int] = None):
    """One frame with the image split into row strips (and the points into
    blocks on ``points_axis``, if given). With ``block_index``
    (``ops.culling.BlockIndex`` whose ``point_block`` is per point of this
    rank's ``points``) each strip first keeps only the points whose block
    meets its frustum, compacted into ``tile_budget`` rows (default: all).

    Returns full (rgb (H,W,3) uint8, depth (H,W) f32, candidates (n_tiles,)
    int32), replicated; ``candidates[t]`` counts the points that entered
    strip t's raster (summed over the point blocks)."""
    n_tiles = mesh.size(tiles_axis)
    assert height % n_tiles == 0, f"height {height} must divide into {n_tiles} strips"
    strip_h = height // n_tiles
    t = mesh.axis_index(tiles_axis)
    n_cand = valid.sum().to(torch.int32)
    if block_index is not None:
        budget = points.shape[0] if tile_budget is None else tile_budget
        keep = cull_points(block_index, strip_projection(cam_proj, t, strip_h), valid,
                           width=width, height=strip_h)
        n_cand = keep.sum().to(torch.int32)
        points, colors, valid = compact_points(points, colors, keep, budget)
    rgb, depth = _strip_raster(points, colors, valid, cam_proj, mesh, t, width=width,
                               strip_h=strip_h, depth_band=depth_band, points_axis=points_axis)
    cand = all_gather(psum(n_cand, mesh, points_axis)[None], mesh, tiles_axis).reshape(-1)
    return (all_gather(rgb, mesh, tiles_axis).reshape(height, width, 3),
            all_gather(depth, mesh, tiles_axis).reshape(height, width), cand)


def render_full_tile_sharded(points, colors, valid, cam_proj, mesh: Mesh, unet, *,
                             width: int, height: int, depth_band: float = 0.02,
                             levels: int = 4, filter_strength: float = 1.025,
                             gradient_filter: float = 0.03, halo: int = 96,
                             unet_halo: int = 32, tiles_axis: str = "tiles",
                             points_axis: Optional[str] = None,
                             act_scales=None) -> Dict[str, torch.Tensor]:
    """Raster -> prefilter -> U-Net with the image split into row strips
    (module doc); ``height`` is already pyramid-padded and divides into
    pyramid-aligned strips. Returns replicated ``raw_rgb``, ``raw_depth``,
    ``unet_input``, ``rgb_f`` and ``rgb_unet`` at (height, width).

    Constraints (``tiles.py:193-212``): height % (n_tiles * 2^levels) == 0,
    halo and unet_halo multiples of 2^levels, halo >= the border pollution
    bound sum(2^(l+1), l = 1..levels) + unet_halo, and halo <= strip_h (the
    one-hop ring reaches only the next strip)."""
    n_tiles = mesh.size(tiles_axis)
    lv = 1 << levels
    pad_w = -(-width // lv) * lv
    assert height % (n_tiles * lv) == 0, (
        f"height {height} must divide into {n_tiles} pyramid-aligned strips")
    strip_h = height // n_tiles
    assert halo % lv == 0 and unet_halo % lv == 0
    pollution = sum(2 ** (l + 1) for l in range(1, levels + 1))
    assert halo >= pollution + unet_halo, (
        f"halo {halo} < pollution bound {pollution} + unet_halo {unet_halo}")
    assert (strip_h + 2 * halo) % lv == 0
    assert halo <= strip_h, (
        f"halo {halo} > strip height {strip_h}: the one-hop ring exchange cannot reach "
        "rows two strips away")
    t = mesh.axis_index(tiles_axis)
    rgb, depth = _strip_raster(points, colors, valid, cam_proj, mesh, t, width=width,
                               strip_h=strip_h, depth_band=depth_band, points_axis=points_axis)
    if pad_w > width:
        # pyramid column padding with empty pixels (pad_to_pyramid): the raster
        # ran at the true width, so padded columns never hold a splat
        depth = torch.cat([depth, torch.full((strip_h, pad_w - width), DEPTH_EMPTY,
                                             dtype=depth.dtype, device=depth.device)], 1)
        rgb = torch.cat([rgb, rgb.new_zeros((strip_h, pad_w - width, 3))], 1)

    # the halo exchange: the strip above sends its last rows, the one below
    # its first; the ring's wrapped outer halos of the first and last strips
    # get filler (depth empty, rgb 0), which strip-mode border masks never read
    # for a global row inside the image
    def rows(sl):
        return torch.cat([depth[sl][None], rgb[sl].to(torch.float32).permute(2, 0, 1)])

    top = ppermute_ring(rows(slice(strip_h - halo, strip_h)), mesh, tiles_axis, 1)
    bot = ppermute_ring(rows(slice(0, halo)), mesh, tiles_axis, -1)
    filler = torch.cat([torch.full_like(top[:1], DEPTH_EMPTY), torch.zeros_like(top[1:])])
    if t == 0:
        top = filler
    if t == n_tiles - 1:
        bot = filler
    ext_depth = torch.cat([top[0], depth, bot[0]])
    ext_rgb = torch.cat([top[1:].permute(1, 2, 0).to(torch.uint8), rgb,
                         bot[1:].permute(1, 2, 0).to(torch.uint8)])

    # the depth range of the whole frame for the normalised depth channel
    dmin_l, dmax_l = depth_min_max(depth.reshape(-1))
    dmin = pmin(dmin_l, mesh, tiles_axis)
    dmax = pmax(dmax_l, mesh, tiles_axis)
    pf = filter_frame(ext_depth, ext_rgb, levels=levels, filter_strength=filter_strength,
                      gradient_filter=gradient_filter, row_offset=t * strip_h - halo,
                      total_h=height, minmax=(dmin, dmax))
    x_core = pf["unet_input"][halo:halo + strip_h]
    uh = unet_halo
    x_ext = pf["unet_input"][halo - uh:halo + strip_h + uh]
    # the overlap rows beyond the image (first and last strips) are zeros
    grow = torch.arange(x_ext.shape[0], device=x_ext.device)[:, None, None] + (t * strip_h - uh)
    x_ext = torch.where((grow >= 0) & (grow < height), x_ext, 0.0)
    y = unet(x_ext[None].contiguous(), act_scales=act_scales, levels=levels)[0]
    y_core = y[uh:uh + strip_h].to(torch.float32)

    gather = lambda a: all_gather(a, mesh, tiles_axis).reshape((height,) + tuple(a.shape[1:]))
    y_full = gather(y_core)[:, :width]
    return {
        "raw_rgb": gather(rgb)[:, :width],
        "raw_depth": gather(depth)[:, :width],
        "unet_input": gather(x_core)[:, :width],
        "rgb_f": y_full,
        "rgb_unet": unet_rgb(y_full),
    }
