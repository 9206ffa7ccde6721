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

One ``autograd.Function`` (``_DiffCore``) serves one card and several
ranks: over a mesh (``parallel/diff.py``) the forward merges each frame's
images over the points axis and the backward merges the gradients over the
mesh's axes; without one (or over one rank) it is the serial raster, with
one resolve launch a frame.

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
    own: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free backward (``raster_diff.py:338-385``): per point j, at its
    own pixel,

      in_band_j = ok_j & !(z_j > depth[pix_j] + band)   -> g_colors[j] = g_sums[pix_j]
      head_j    = ok_j & z_j == depth[pix_j]            -> gz[j] = g_depth[pix_j]

    ``depth_img`` is the forward's head depth, so the head test picks the
    point the forward's sort chose (on an exact depth tie every tied point
    gets the full depth cotangent, as in the JAX package).

    ``own`` ((hw,) int or bool, the point-sharded path): this shard's pixel
    ownership, which gates the depth cotangent so that exactly one shard's
    head point receives it (``parallel/diff.py``)."""
    lanes = [g_sums[:, 0], g_sums[:, 1], g_sums[:, 2], g_depth, depth_img]
    if own is not None:
        lanes.append(own.to(torch.float32))
    table = torch.stack(lanes, 1)
    ok = pix < hw
    rows = table[torch.where(ok, pix, torch.zeros_like(pix)).to(torch.int64)]
    zh = rows[:, 4]
    in_band = ok & ~(z > zh + depth_band)
    head = ok & (z == zh)
    if own is not None:
        head = head & (rows[:, 5] > 0)
    g_colors = rows[:, 0:3] * in_band[:, None].to(torch.float32)
    gz = rows[:, 3] * head.to(torch.float32)
    return g_colors, gz


_I32_MAX = 2**31 - 1


def _size(mesh, axis: Optional[str]) -> int:
    return 1 if mesh is None else mesh.size(axis)


def _fwd_frame(points, colors, valid, M, hw: int, width: int, height: int, depth_band: float,
               mesh, axis: Optional[str]):
    """One frame -> (sums (HW,3), cnt (HW,), depth (HW,)), merged over
    ``axis`` of ``mesh``, and the backward's residuals (pix, zs, own).

    Over one rank, one resolve gives all three. Over a points axis, in two
    passes (the reference's order, render.cu:101-106): pass 1's depth output
    is the local z-buffer, ``pmin`` merges it; the owner of a pixel's depth
    cotangent is the lowest rank among exact-depth ties (a second ``pmin``,
    ``rtnr_tpu/parallel/diff.py:111-115``); pass 2 sums each pixel's band
    against the merged z-buffer (``band_ref``), and ``psum`` adds the
    shards' f32 sums in rank order."""
    sd, (pix, zs) = project_and_sort_diff(points, colors, M, width=width, height=height,
                                          valid=valid)
    if _size(mesh, axis) == 1:
        sums, cnt, depth = raster_images_diff(sd, hw, depth_band)
        return (sums, cnt, depth), (pix, zs, None)
    from rtnr_tpu_torch.parallel.collectives import pmin, psum

    _, _, local_min = raster_images_diff(sd, hw, depth_band)
    gmin = pmin(local_min, mesh, axis)
    rank = mesh.axis_index(axis)
    tie = torch.full((hw,), _I32_MAX, dtype=torch.int32, device=gmin.device)
    tie.masked_fill_(local_min == gmin, rank)
    own = pmin(tie, mesh, axis) == rank
    sums, cnt, _ = raster_images_diff(sd, hw, depth_band, band_ref=gmin)
    return (psum(sums, mesh, axis), psum(cnt, mesh, axis), gmin), (pix, zs, own)


class _DiffCore(torch.autograd.Function):
    """(points, colors, cam_projs (F,4,4)) -> this rank's frames' (sums
    (F_l,HW,3) f32, count (F_l,HW) f32, depth (F_l,HW) f32); the count is
    not differentiable. Without a mesh (or over one rank) F_l = F. With one
    (``parallel/diff.py``) the points and colours are this rank's block on
    ``points_axis``, the frames its F / n_batch on ``batch_axis``, and the
    images are merged over points.

    Backward (the JAX package's ``bwd_sm``): ``bwd_from_images`` at each
    point's own pixel, the chain through ``z = p . M[2, :3] + M[2, 3]``, the
    camera partials ``psum``med over points; the point and colour gradients
    sum over the local frames and then ``psum`` over batch, and so does the
    (F, 4, 4) camera gradient, so every rank holds that of all F matrices."""

    @staticmethod
    def forward(ctx, points, colors, cam_projs, valid, width, height, depth_band, mesh,
                points_axis, batch_axis):
        hw = width * height
        Ms = cam_projs.to(torch.float32)
        if _size(mesh, batch_axis) > 1:
            from rtnr_tpu_torch.parallel.render import local_frames

            Ms = local_frames(Ms, mesh, batch_axis)
        outs, ctx.res = [], []
        for M in Ms:
            o, r = _fwd_frame(points, colors, valid, M, hw, width, height, depth_band, mesh,
                              points_axis)
            outs.append(o)
            ctx.res.append(r)
        sums, cnt, depth = (torch.stack([o[k] for o in outs]) for k in range(3))
        ctx.save_for_backward(points, Ms, depth)
        ctx.meta = (mesh, hw, depth_band, points_axis, batch_axis, cam_projs.shape[0])
        ctx.mark_non_differentiable(cnt)
        return sums, cnt, depth

    @staticmethod
    def backward(ctx, g_sums, _g_cnt, g_depth):
        points, Ms, depth = ctx.saved_tensors
        mesh, hw, depth_band, points_axis, batch_axis, n_frames = ctx.meta
        g_points = g_colors = None
        g_Ms = []
        for f, (pix, zs, own) in enumerate(ctx.res):
            gc, gz = bwd_from_images(g_sums[f], g_depth[f], depth[f], pix, zs, hw, depth_band,
                                     own=own)
            gp = gz[:, None] * Ms[f, 2, :3][None, :]
            g_points = gp if g_points is None else g_points + gp
            g_colors = gc if g_colors is None else g_colors + gc
            gM = torch.zeros((4, 4), dtype=torch.float32, device=gz.device)
            gM[2, :3] = gz @ points.to(torch.float32)
            gM[2, 3] = gz.sum()
            g_Ms.append(gM)
        g_cams = torch.stack(g_Ms)
        if _size(mesh, points_axis) > 1 or _size(mesh, batch_axis) > 1:
            from rtnr_tpu_torch.parallel.collectives import psum

            g_Ms = psum(g_cams, mesh, points_axis)
            # this rank's frames' rows; the other frames arrive by the psum over batch
            fl = n_frames // mesh.size(batch_axis)
            i = mesh.axis_index(batch_axis)
            g_cams = torch.zeros((n_frames, 4, 4), dtype=torch.float32, device=points.device)
            g_cams[i * fl:(i + 1) * fl] = g_Ms
            g_points = psum(g_points, mesh, batch_axis)
            g_colors = psum(g_colors, mesh, batch_axis)
            g_cams = psum(g_cams, mesh, batch_axis)
        return g_points, g_colors, g_cams, None, None, None, None, None, None, None


def rasterize_diff_frames(points, colors, cam_projs, *, width: int, height: int,
                          valid: Optional[torch.Tensor] = None, depth_band: float = 0.02,
                          mesh=None, points_axis: Optional[str] = None,
                          batch_axis: Optional[str] = None) -> DiffRaster:
    """``rasterize_diff_sorted`` of the frames ``cam_projs`` (F, 4, 4): the
    DiffRaster fields with a leading axis of this rank's frames (all F
    without a mesh; ``_DiffCore`` for the mesh's contract). Gradients reach
    ``points``, ``colors`` (summed over the frames) and ``cam_projs``."""
    sums, cnt, depth = _DiffCore.apply(points, colors, cam_projs, valid, width, height,
                                       depth_band, mesh, points_axis, batch_axis)
    occupied = cnt > 0
    rgb = torch.where(occupied[..., None], sums / torch.clamp(cnt, min=1.0)[..., None], 0.0)
    lead = (cnt.shape[0],)
    return DiffRaster(
        rgb=rgb.reshape(*lead, height, width, 3),
        depth=depth.reshape(*lead, height, width),
        count=cnt.to(torch.int32).reshape(*lead, height, width),
        mask=occupied.reshape(*lead, height, width),
    )


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
    out = rasterize_diff_frames(points, colors, cam_proj[None], width=width, height=height,
                                valid=valid, depth_band=depth_band)
    return DiffRaster(*(t[0] for t in out))


# The JAX package's other name. It keeps a scatter formulation for small
# inputs because scatters serialise on a TPU (pipeline_diff.py:51-58); on the
# card one implementation serves every size, with the same outputs and
# gradients.
rasterize_diff = rasterize_diff_sorted
