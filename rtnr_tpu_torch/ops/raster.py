"""Point-splat rasterization: projection, (pixel, depth) sort, resolve.

Counterpart of ``rtnr_tpu/ops/raster.py`` (carrier-free path). Semantics of
the reference CUDA raster (src/RTRenderer/src/render.cu:53-163): project
with ``M = K4 @ E``, cull ``z <= 0`` and out-of-frame points, round pixel
coordinates half to even (``rintf``), keep the per-pixel min depth, and
average (integer division) the colours of every point within 2 cm of it.

The sort stays a library call (``torch.sort``), as the JAX package leaves
it to XLA; the resolve after it runs the hand-written kernels of
``ops/raster_resolve4.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtnr_tpu_torch.config import DEPTH_EMPTY

# float bounds for the pixel-coordinate cast: |coordinate| <= 2^31 - 128 keeps
# the int32 conversion defined; every in-frame coordinate is far inside
_COORD_LIMIT = 2147483520.0


def project_points(
    points: torch.Tensor, cam_proj: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points (N, 3) f32 -> (u, v) int32 pixel coords and z f32 depth.

    Each row is ``((x*m[i,0] + y*m[i,1]) + z*m[i,2]) + m[i,3]`` in f32,
    evaluated op by op in exactly that order. A matmul sums in another
    order and moves points across .5 pixel boundaries; this order matches
    the JAX package bit for bit. ``torch.round`` is round-half-even, like
    ``rintf`` (reference render.cu:65-66).
    """
    m = cam_proj.to(device=points.device, dtype=torch.float32)
    x, y, zc = points[:, 0], points[:, 1], points[:, 2]

    def row(i: int) -> torch.Tensor:
        return ((x * m[i, 0] + y * m[i, 1]) + zc * m[i, 2]) + m[i, 3]

    r0, r1, z = row(0), row(1), row(2)
    safe_z = torch.where(z > 0.0, z, torch.ones_like(z))

    def to_pixel(r: torch.Tensor) -> torch.Tensor:
        q = torch.round(r / safe_z)
        return q.clamp(-_COORD_LIMIT, _COORD_LIMIT).to(torch.int32)

    return to_pixel(r0), to_pixel(r1), z


def _pixel_ids(u, v, z, valid: Optional[torch.Tensor], width: int, height: int):
    """Linear pixel id per point; culled points get the sentinel H*W."""
    ok = (z > 0.0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    if valid is not None:
        ok = ok & valid
    pix = torch.where(ok, v * width + u, torch.full_like(u, width * height))
    return pix, ok


class SortedPoints(NamedTuple):
    """Carrier-free point stream sorted by (pixel id, depth bits)."""

    pix: torch.Tensor  # (N,) int32; sentinel H*W for culled points
    zbits: torch.Tensor  # (N,) int32 f32 bit patterns (+inf when culled)
    packed: torch.Tensor  # (N,) int32 colour r|g<<8|b<<16


def project_and_sort(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
) -> SortedPoints:
    """Project, then ONE ``torch.sort`` on the int64 key ``pix << 32 | zbits``.

    That orders like the JAX package's 2-key ``lax.sort`` on (pix, zbits)
    (``raster.py:170``, ``carriers=False``), because every sorted depth is
    positive or +inf, so its bit pattern is non-negative. Equal keys are
    interchangeable downstream (sums and counts commute), so the sort need
    not be stable."""
    u, v, z = project_points(points, cam_proj)
    pix, ok = _pixel_ids(u, v, z, valid, width, height)
    zs = torch.where(ok, z, torch.full_like(z, float("inf")))
    zbits = zs.view(torch.int32)
    cols = colors.to(torch.int32)
    packed = cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)
    key = (pix.to(torch.int64) << 32) | zbits.to(torch.int64)
    key_s, order = torch.sort(key)
    return SortedPoints(
        pix=(key_s >> 32).to(torch.int32),
        zbits=(key_s & 0xFFFFFFFF).to(torch.int32),
        packed=packed[order],
    )


class SortedDiff(NamedTuple):
    """The differentiable forward's stream, sorted by (pixel id, depth bits)."""

    pix: torch.Tensor  # (N,) int32; sentinel H*W for culled points
    zbits: torch.Tensor  # (N,) int32 f32 bit patterns (+inf when culled)
    rgb: torch.Tensor  # (N, 3) float32 colours in sorted order


def project_and_sort_diff(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[SortedDiff, Tuple[torch.Tensor, torch.Tensor]]:
    """The differentiable forward's projection and sort
    (``rtnr_tpu/ops/raster_diff.py:204-245``): the same projection and one
    ``torch.sort`` on ``pix << 32 | zbits``, then one gather of the f32
    colours by the sort order (JAX sorts them as payload lanes).

    Depth is ``where((pix < hw) & (z < DEPTH_EMPTY), z, +inf)``
    (``raster_diff.py:212-213``), one clause more than ``project_and_sort``:
    a point at or beyond FLT_MAX depth stays on its pixel but sorts last.
    Also returns the ORIGINAL-order ``(pix, zs)``, the backward's residuals.
    """
    hw = width * height
    u, v, z = project_points(points, cam_proj)
    pix, _ = _pixel_ids(u, v, z, valid, width, height)
    zs = torch.where((pix < hw) & (z < DEPTH_EMPTY), z, torch.full_like(z, float("inf")))
    key = (pix.to(torch.int64) << 32) | zs.view(torch.int32).to(torch.int64)
    key_s, order = torch.sort(key)
    sd = SortedDiff(
        pix=(key_s >> 32).to(torch.int32),
        zbits=(key_s & 0xFFFFFFFF).to(torch.int32),
        rgb=colors.to(torch.float32)[order].contiguous(),
    )
    return sd, (pix, zs)


def resolve_uint8(sum_img: torch.Tensor, cnt_img: torch.Tensor) -> torch.Tensor:
    """Integer-average resolve (reference render.cu:145-162): (HW,3) uint8."""
    cnt = torch.clamp(cnt_img, min=1)[:, None]
    rgb = torch.div(sum_img, cnt, rounding_mode="floor").to(torch.uint8)
    return torch.where(cnt_img[:, None] > 0, rgb, torch.zeros_like(rgb))


def rasterize(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    depth_band: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full splat raster: (rgb (H,W,3) uint8, depth (H,W) f32). Empty pixels
    are black with depth FLT_MAX (reference project_cloud.cu:316)."""
    from rtnr_tpu_torch.ops.raster_resolve4 import raster_images_v4

    sp = project_and_sort(points, colors, cam_proj, width=width, height=height, valid=valid)
    sums, cnt, depth = raster_images_v4(sp, width * height, depth_band)
    rgb = resolve_uint8(sums, cnt)
    return rgb.reshape(height, width, 3), depth.reshape(height, width)


def rasterize_packed(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    depth_band: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``rasterize`` with rgb packed r|g<<8|b<<16 as (H, W) int32: the
    integer-average resolve runs inside the expansion kernel (K2)."""
    from rtnr_tpu_torch.ops.raster_resolve4 import raster_images_v4

    sp = project_and_sort(points, colors, cam_proj, width=width, height=height, valid=valid)
    packed, depth = raster_images_v4(sp, width * height, depth_band, packed_out=True)
    return packed.reshape(height, width), depth.reshape(height, width)


def unpack_rgb8(packed: torch.Tensor) -> torch.Tensor:
    """(...,) int32 r|g<<8|b<<16 -> (..., 3) uint8."""
    return torch.stack([((packed >> s) & 255).to(torch.uint8) for s in (0, 8, 16)], dim=-1)


def depth_min_max(depth_img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (min, max) over non-empty pixels, skipping the exact FLT_MAX
    seed (reference render.cu:166-240); (inf, -inf) when all are empty."""
    occupied = depth_img != DEPTH_EMPTY
    inf = torch.full_like(depth_img, float("inf"))
    dmin = torch.where(occupied, depth_img, inf).amin()
    dmax = torch.where(occupied, depth_img, -inf).amax()
    return dmin, dmax
