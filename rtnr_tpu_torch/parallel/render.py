"""Multi-rank rendering: point sharding and frame batching.

Counterpart of ``rtnr_tpu/parallel/render.py``. The scene is split over the
``"points"`` axis: each rank rasters its contiguous block of points into a
full-resolution partial z-buffer, the partial depth images merge with
``pmin``, the 2 cm band is then tested against the merged (global) minimum,
which keeps the reference's two-pass order (render.cu:53-130), and the
integer colour sums merge with ``psum``. Frames split over the ``"batch"``
axis (pure data parallelism). Every rank calls the same function:

- ``points`` / ``colors`` / ``valid``: this rank's block on the points axis
  (``collectives.shard_rows`` of the padded host arrays);
- ``cam_projs`` (F, 4, 4): all F frames on every rank; F must divide by the
  batch axis, and the rank renders its contiguous F / n_batch of them;
- outputs: a single frame replicated on every rank; batched frames as the
  rank's own (F_local, ...) frames (``collectives.gather_frames`` assembles
  the full batch).

On the card the raster's two passes are two launches of the v4 resolve,
``rtnr_resolve4`` (``ops/raster_resolve4.py``): the first's depth output is
the local z-buffer, the second is the sums form with ``band_ref`` = the
merged z-buffer. Over a points axis of size 1 a frame is ``rasterize``'s,
the serial raster (one launch). The prefilter runs on each local frame, and
the U-Net on each local frame with the port's ``UNet`` (its weights
replicated), in every mode it has (bf16, static or dyn int8 where ``UNet``
would quantise).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rtnr_tpu_torch.ops.prefilter import filter_frame
from rtnr_tpu_torch.ops.raster import project_and_sort, rasterize, resolve_uint8
from rtnr_tpu_torch.ops.raster_resolve4 import raster_images_v4
from rtnr_tpu_torch.parallel.collectives import pmin, psum
from rtnr_tpu_torch.parallel.mesh import Mesh


def merged_sums(sp, mesh: Mesh, points_axis: Optional[str], hw: int,
                depth_band: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sorted stream of this rank's points -> (sums4 (HW, 4) int32, depth
    (HW,) f32), both merged over ``points_axis``: pass 1's depth is the local
    z-buffer, ``pmin`` merges it, pass 2 sums each pixel's band against the
    merged minimum (``band_ref``), ``psum`` merges the sums."""
    if mesh.size(points_axis) == 1:
        sums, cnt, depth = raster_images_v4(sp, hw, depth_band)
        return torch.cat([sums, cnt[:, None]], 1), depth
    _, _, local_min = raster_images_v4(sp, hw, depth_band)
    gmin = pmin(local_min, mesh, points_axis)
    sums, cnt, _ = raster_images_v4(sp, hw, depth_band, band_ref=gmin)
    return psum(torch.cat([sums, cnt[:, None]], 1), mesh, points_axis), gmin


def _raster_frame(points, colors, valid, cam_proj, mesh, *, width, height, depth_band,
                  points_axis):
    """(rgb (H,W,3) uint8, depth (H,W) f32) merged over ``points_axis``;
    over one rank, ``rasterize`` (the serial raster)."""
    if mesh.size(points_axis) == 1:
        return rasterize(points, colors, cam_proj, width=width, height=height, valid=valid,
                         depth_band=depth_band)
    sp = project_and_sort(points, colors, cam_proj, width=width, height=height, valid=valid)
    sums4, depth = merged_sums(sp, mesh, points_axis, width * height, depth_band)
    rgb = resolve_uint8(sums4[:, :3], sums4[:, 3])
    return rgb.reshape(height, width, 3), depth.reshape(height, width)


def rasterize_point_sharded(points, colors, valid, cam_proj, mesh: Mesh, *, width: int,
                            height: int, depth_band: float = 0.02,
                            points_axis: str = "points"):
    """One frame with the scene split over ``points_axis``: (rgb (H,W,3)
    uint8, depth (H,W) f32), replicated; equal bit for bit to ``rasterize``
    of the whole cloud."""
    return _raster_frame(points, colors, valid, cam_proj, mesh, width=width, height=height,
                         depth_band=depth_band, points_axis=points_axis)


def local_frames(cam_projs: torch.Tensor, mesh: Mesh, batch_axis: Optional[str]):
    """This rank's contiguous block of the (F, 4, 4) frames."""
    f, n = cam_projs.shape[0], mesh.size(batch_axis)
    if f % n:
        raise ValueError(f"{f} frames do not split over {n} ranks of {batch_axis!r}")
    b = f // n
    i = mesh.axis_index(batch_axis)
    return cam_projs[i * b:(i + 1) * b]


def render_filtered_sharded(points, colors, valid, cam_projs, mesh: Mesh, *, width: int,
                            height: int, depth_band: float = 0.02, levels: int = 4,
                            filter_strength: float = 1.025, gradient_filter: float = 0.03,
                            points_axis: str = "points",
                            batch_axis: str = "batch") -> Dict[str, torch.Tensor]:
    """The rank's frames of ``cam_projs`` (F, 4, 4): raster (points merged)
    and prefilter. Returns (F_local, ...) ``raw_rgb``, ``raw_depth``,
    ``rgb``, ``depth``, ``mask`` (cropped) and ``unet_input`` (padded)."""
    outs = []
    for M in local_frames(cam_projs, mesh, batch_axis):
        rgb, depth = _raster_frame(points, colors, valid, M, mesh, width=width, height=height,
                                   depth_band=depth_band, points_axis=points_axis)
        pf = filter_frame(depth, rgb, levels=levels, filter_strength=filter_strength,
                          gradient_filter=gradient_filter)
        outs.append({
            "raw_rgb": rgb, "raw_depth": depth,
            "rgb": pf["filtered_rgb"][:height, :width],
            "depth": pf["filtered_depth"][:height, :width],
            "mask": pf["mask"][:height, :width],
            "unet_input": pf["unet_input"],
        })
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def unet_rgb(y: torch.Tensor) -> torch.Tensor:
    """``clip(rint(y * 255), 0, 255)`` as uint8 (``render.py:224-228``)."""
    return torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8)


def render_full_batch(points, colors, valid, cam_projs, mesh: Mesh, unet, *, width: int,
                      height: int, depth_band: float = 0.02, levels: int = 4,
                      filter_strength: float = 1.025, gradient_filter: float = 0.03,
                      points_axis: str = "points", batch_axis: str = "batch",
                      act_scales=None) -> Dict[str, torch.Tensor]:
    """``render_filtered_sharded``, then the U-Net (the port's ``UNet``,
    ``act_scales`` for a static-int8 net) on each local frame: adds
    ``rgb_f`` (F_local, H, W, 3) f32 and ``rgb_unet`` uint8."""
    mid = render_filtered_sharded(points, colors, valid, cam_projs, mesh, width=width,
                                  height=height, depth_band=depth_band, levels=levels,
                                  filter_strength=filter_strength,
                                  gradient_filter=gradient_filter, points_axis=points_axis,
                                  batch_axis=batch_axis)
    x = mid["unet_input"]
    y = torch.cat([unet(x[i:i + 1], act_scales=act_scales, levels=levels)
                   for i in range(x.shape[0])])
    y = y.to(torch.float32)[:, :height, :width]
    return {**mid, "rgb_f": y, "rgb_unet": unet_rgb(y)}
