"""Differentiable splat raster: pixel gradients to colours, positions, pose.

Counterpart of ``rtnr_tpu/ops/raster_diff.py``. Forward and backward follow
its scalable custom-VJP form (``rasterize_diff_sorted``, ``:388-449``):

- forward: ``project_and_sort_diff`` (one ``torch.sort``), then
  ``raster_images_diff`` (K5 + K2 ``float_sums`` as one tile kernel,
  ``rtnr_resolve_diff``: each pixel's in-band colour sums and count as f32
  totals and its head depth, written straight into dense images);
- backward: ``bwd_from_images``, one row gather of the cotangent images and
  the depth image at each point's own pixel (no sort), then the chain
  through ``z = p . M[2, :3] + M[2, 3]`` to the points and ``cam_proj`` row 2.

Everything differentiable is linear once the piecewise-constant decisions
(pixel assignment, band membership, head identity) are frozen; those are
straight-through, as in the JAX package. The backward is plain torch, as it
is plain XLA there (it has no Pallas kernel).

Unlike the JAX package's prefix-sum forward, whose f32 prefixes over the
whole stream lose exactness past 2^24 (at 5M points they reach ~6e8, f32
steps of 64), the port sums each pixel on its own in f64: it equals the JAX
package wherever that is exact, and stays exact where it is not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtnr_tpu_torch.ops.raster import project_and_sort_diff
from rtnr_tpu_torch.ops.raster_resolve4 import raster_images_diff


class DiffRaster(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3) float32, 0..255, 0 where empty
    depth: torch.Tensor  # (H, W) float32, FLT_MAX where empty
    count: torch.Tensor  # (H, W) int32 contributing points per pixel
    mask: torch.Tensor  # (H, W) bool occupancy


def camera_pose_gradients(dM: torch.Tensor, K4: torch.Tensor) -> torch.Tensor:
    """Chain a cam_proj cotangent dM (4x4) back to extrinsics E: M = K4 @ E."""
    return K4.T @ dM


def bwd_from_images(
    g_sums: torch.Tensor,
    g_depth: torch.Tensor,
    depth_img: torch.Tensor,
    pix: torch.Tensor,
    z: torch.Tensor,
    hw: int,
    depth_band: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free backward (``raster_diff.py:338-385``, one device, so no
    ``own`` ownership lane): per point j, at its own pixel,

      in_band_j = ok_j & !(z_j > depth[pix_j] + band)   -> g_colors[j] = g_sums[pix_j]
      head_j    = ok_j & z_j == depth[pix_j]            -> gz[j] = g_depth[pix_j]

    ``depth_img`` is the forward's head depth, so the head test picks the
    point the forward's sort chose (on an exact depth tie every tied point
    gets the full depth cotangent, as in the JAX package)."""
    table = torch.stack([g_sums[:, 0], g_sums[:, 1], g_sums[:, 2], g_depth, depth_img], 1)
    ok = pix < hw
    rows = table[torch.where(ok, pix, torch.zeros_like(pix)).to(torch.int64)]
    zh = rows[:, 4]
    in_band = ok & ~(z > zh + depth_band)
    head = ok & (z == zh)
    g_colors = rows[:, 0:3] * in_band[:, None].to(torch.float32)
    gz = rows[:, 3] * head.to(torch.float32)
    return g_colors, gz


class _DiffCore(torch.autograd.Function):
    """(points, colors, cam_proj) -> (sums (HW,3) f32, count (HW,) f32,
    depth (HW,) f32); the count is not differentiable."""

    @staticmethod
    def forward(ctx, points, colors, cam_proj, valid, width, height, depth_band):
        hw = width * height
        M = cam_proj.to(torch.float32)
        sd, (pix, zs) = project_and_sort_diff(points, colors, M, width=width, height=height,
                                              valid=valid)
        sums, cnt, depth = raster_images_diff(sd, hw, depth_band)
        ctx.save_for_backward(pix, zs, depth, points, M)
        ctx.hw, ctx.depth_band = hw, depth_band
        ctx.mark_non_differentiable(cnt)
        return sums, cnt, depth

    @staticmethod
    def backward(ctx, g_sums, _g_cnt, g_depth):
        pix, zs, depth, pts, M = ctx.saved_tensors
        g_colors, gz = bwd_from_images(g_sums, g_depth, depth, pix, zs, ctx.hw,
                                       ctx.depth_band)
        g_points = gz[:, None] * M[2, :3][None, :]
        g_M = torch.zeros((4, 4), dtype=torch.float32, device=gz.device)
        g_M[2, :3] = gz @ pts
        g_M[2, 3] = gz.sum()
        return g_points, g_colors, g_M, None, None, None, None


def rasterize_diff_sorted(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    depth_band: float = 0.02,
) -> DiffRaster:
    """Differentiable raster. colors: (N,3) float32 (0..255 scale). Float
    rgb is sum/count (true division), 0 with FLT_MAX depth where empty.
    Gradients reach ``points``, ``colors`` and ``cam_proj`` (row 2)."""
    sums, cnt, depth = _DiffCore.apply(points, colors, cam_proj, valid, width, height,
                                       depth_band)
    occupied = cnt > 0
    rgb = torch.where(occupied[:, None], sums / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    return DiffRaster(
        rgb=rgb.reshape(height, width, 3),
        depth=depth.reshape(height, width),
        count=cnt.to(torch.int32).reshape(height, width),
        mask=occupied.reshape(height, width),
    )


# The JAX package's other name. It keeps a scatter formulation for small
# inputs because scatters serialise on a TPU (pipeline_diff.py:51-58); on the
# card one implementation serves every size, with the same outputs and
# gradients.
rasterize_diff = rasterize_diff_sorted
