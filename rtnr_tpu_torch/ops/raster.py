"""Point-splat rasterization: projection, (pixel, depth) sort, resolve.

Counterpart of ``rtnr_tpu/ops/raster.py``. Semantics of the reference CUDA
raster (src/RTRenderer/src/render.cu:53-163): project with ``M = K4 @ E``,
cull ``z <= 0`` and out-of-frame points, round pixel coordinates half to
even (``rintf``), keep the per-pixel min depth, and average (integer
division) the colours of every point within 2 cm of it.

The sort stays a library call (``torch.sort``), as the JAX package leaves
it to XLA. ``rasterize`` / ``rasterize_packed`` pick the resolve after it
from ``RTNR_RESOLVE``, read at each call, with the JAX package's values:
``v4`` (default) the carrier-free (pixel, depth) stream into the v4
resolve, K1 and K2 as one kernel (``ops/raster_resolve4.py``); ``v5`` the
pixel-only stream into the v5 resolve, K6 and K2 as one kernel
(``ops/raster_resolve5.py``); ``v3`` and any
other value the carrier stream into the carrier kernel
(``ops/raster_resolve_carriers.py``, JAX's v3 and v2). Every branch gives
the same bits, so the port applies the choice at every size (JAX only on a
TPU above 2^17 elements); CPU tensors run the kernels' plain twins.

The carrier-stream helpers (``segment_broadcast_head``,
``place_rows_by_pixel``, ``band_winners``, ``raster_images``,
``min_depth_image``, ``gather_images_sorted``, ``accumulate_sums``) are XLA
in the JAX package and stay plain torch here; the placement sort and the
sort-merge gather become a scatter and a gather. ``rasterize_scatter`` is
the atomics form of the reference (scatter-min, then scatter-add): the
on-device cross-check of the sort-based raster.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from rtnr_tpu_torch.config import DEPTH_EMPTY
from rtnr_tpu_torch.utils import trace

# float bounds for the pixel-coordinate cast: |coordinate| <= 2^31 - 128 keeps
# the int32 conversion defined; every in-frame coordinate is far inside
_COORD_LIMIT = 2147483520.0
_FLT_MAX_BITS = 0x7F7FFFFF
# realness flag above the three colour bytes, on carrier streams only
# (rtnr_tpu/ops/raster.py:56)
REAL_BIT = 1 << 24


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
    """Point stream sorted by pixel id (and by default depth bits).

    Carrier-free (``carriers=False``): every element is a point and
    ``packed`` is its colour r|g<<8|b<<16. A carrier stream adds one element
    per pixel (pixel id, FLT_MAX depth bits, packed 0) and sets ``REAL_BIT``
    in every real point's ``packed``: the flag alone tells a carrier from a
    black point at FLT_MAX depth."""

    pix: torch.Tensor  # (N,) int32; sentinel H*W for culled points
    zbits: torch.Tensor  # (N,) int32 f32 bit patterns (+inf when culled)
    packed: torch.Tensor  # (N,) int32 colour r|g<<8|b<<16 (| REAL_BIT with carriers)


def project_and_sort(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    carriers: bool = False,
    depth_key: bool = True,
    row_offset: Optional[int] = None,
) -> SortedPoints:
    """Project, then ONE ``torch.sort`` on the int64 key ``pix << 32 | zbits``.

    That orders like the JAX package's 2-key ``lax.sort`` on (pix, zbits)
    (``raster.py:170``), because every sorted depth is positive or +inf, so
    its bit pattern is non-negative. Equal keys are interchangeable
    downstream (sums and counts commute), so the sort need not be stable.

    ``carriers`` and ``depth_key`` mean what they mean in JAX
    (``raster.py:117-193``), but the port's default is the carrier-free
    stream that K1 reads: ``carriers=True`` appends the H*W carriers and
    flags real points with ``REAL_BIT``; ``depth_key=False`` sorts the int32
    pixel id alone (one 32-bit key: depth order inside a pixel segment is
    then arbitrary) and gathers ``zbits`` and ``packed`` by the order.

    ``row_offset`` (``raster.py:127-148``) renders the row band
    [row_offset, row_offset + height) of the full image: v is rounded with
    the full-image matrix, then the offset is subtracted as an integer, so
    each point's pixel row is bit-identical to the full-image render (a
    shift baked into the matrix rounds differently near .5; the row strips
    of ``parallel/tiles.py``)."""
    hw = width * height
    u, v, z = project_points(points, cam_proj)
    if row_offset is not None:
        v = v - int(row_offset)
    pix, ok = _pixel_ids(u, v, z, valid, width, height)
    zs = torch.where(ok, z, torch.full_like(z, float("inf")))
    zbits = zs.view(torch.int32)
    cols = colors.to(torch.int32)
    packed = cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)
    if carriers:
        dev = pix.device
        pix = torch.cat([pix, torch.arange(hw, dtype=torch.int32, device=dev)])
        zbits = torch.cat([zbits, torch.full((hw,), _FLT_MAX_BITS, dtype=torch.int32,
                                             device=dev)])
        packed = torch.cat([packed | REAL_BIT, torch.zeros(hw, dtype=torch.int32, device=dev)])
    if not depth_key:
        with trace.span("projection.sort", fresh=True):
            pix_s, order = torch.sort(pix)
        return SortedPoints(pix=pix_s, zbits=zbits[order], packed=packed[order])
    key = (pix.to(torch.int64) << 32) | zbits.to(torch.int64)
    with trace.span("projection.sort", fresh=True):
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


def _band_limit(z_ref: torch.Tensor, depth_band: float) -> torch.Tensor:
    """``z_ref + band`` in f32 (reference render.cu:106)."""
    return z_ref + torch.tensor(depth_band, dtype=torch.float32, device=z_ref.device)


def _segments(pix: torch.Tensor):
    """(is_head, is_last, head_pos) of a pixel-sorted stream: a head is an
    element whose predecessor has another pixel id (the sentinel segment
    included), ``head_pos`` the index of each element's head."""
    fill = lambda v: torch.full((1,), v, dtype=pix.dtype, device=pix.device)
    is_head = pix != torch.cat([fill(-1), pix[:-1]])
    is_last = pix != torch.cat([pix[1:], fill(-2)])
    # element 0 is always a head, so every element has one
    head_pos = torch.nonzero(is_head).squeeze(1)[torch.cumsum(is_head, 0) - 1]
    return is_head, is_last, head_pos


def _lanes4(sp: SortedPoints, weight: torch.Tensor) -> torch.Tensor:
    """(4, N) int64 lanes (r, g, b, 1) times ``weight`` (bool or 0/1). Lanes
    lead: a CUDA cumsum along a (N, 4) tensor's first dim scans each column
    in one thread."""
    w = weight.to(torch.int64)
    pk = sp.packed.to(torch.int64)
    return torch.stack([(pk & 255) * w, ((pk >> 8) & 255) * w, ((pk >> 16) & 255) * w, w])


def is_real(sp: SortedPoints) -> torch.Tensor:
    """The real-point flag of a carrier stream (``REAL_BIT``)."""
    return (sp.packed & REAL_BIT) != 0


def segment_broadcast_head(values: torch.Tensor, is_head: torch.Tensor,
                           head_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each segment head's value (1-D, or rows of a 2-D tensor) at every
    element of its segment: one gather by ``head_pos`` (JAX's Hillis-Steele
    doubling avoids the gather a TPU lacks). Elements before the first head
    take element 0's value, as in JAX."""
    if head_pos is None:
        idx = torch.arange(is_head.numel(), device=is_head.device)
        head_pos = torch.cummax(torch.where(is_head, idx, torch.zeros_like(idx)), 0).values
    return values[head_pos]


def place_rows_by_pixel(key: torch.Tensor, rows: Sequence[torch.Tensor],
                        hw: int) -> Tuple[torch.Tensor, ...]:
    """Dense (HW, ...) images from the rows whose ``key`` < hw, each written
    at row ``key``: a scatter (JAX sorts by key and slices H*W rows, which
    needs exactly one such row per pixel, as carriers guarantee). Pixels
    with no row stay 0."""
    sel = key < hw
    at = key[sel].to(torch.int64)
    out = []
    for r in rows:
        img = torch.zeros((hw,) + tuple(r.shape[1:]), dtype=r.dtype, device=r.device)
        img[at] = r[sel]
        out.append(img)
    return tuple(out)


def band_winners(sp: SortedPoints, hw: int, depth_band: float):
    """Per-element band logic of a (pixel, depth)-sorted carrier stream
    (``rtnr_tpu/ops/raster.py:240-263``): (band_end mask, sums4 (N, 4) int32,
    head depth bits (N,) int32). At a band end, sums4 holds the real
    in-band totals of its pixel. The port's stream has no ``ok`` lane, so
    ``hw`` is an argument."""
    is_head, is_last, head_pos = _segments(sp.pix)
    z = sp.zbits.view(torch.float32)
    # carriers carry FLT_MAX and are only in band when they head an empty
    # pixel (FLT_MAX + 0.02f == FLT_MAX in f32)
    in_band = (sp.pix < hw) & ~(z > _band_limit(z[head_pos], depth_band))
    next_in = torch.cat([in_band[1:], torch.zeros(1, dtype=torch.bool, device=z.device)])
    band_end = in_band & (is_last | ~next_in)
    contrib = _lanes4(sp, is_real(sp))
    csum = torch.cumsum(contrib, 1)  # int64: no wrap
    sums4 = (csum - (csum - contrib)[:, head_pos]).t().to(torch.int32).contiguous()
    return band_end, sums4, sp.zbits[head_pos]


def raster_images(sp: SortedPoints, hw: int, depth_band: float):
    """Dense (sums (HW,3) int32, count (HW,) int32, depth (HW,) f32) of a
    (pixel, depth)-sorted carrier stream: the band end of every pixel
    placed at its pixel. The plain twin of the carrier kernel
    (``ops/raster_resolve_carriers.py``)."""
    band_end, sums4, zhead = band_winners(sp, hw, depth_band)
    key = torch.where(band_end, sp.pix, torch.full_like(sp.pix, hw))
    sums, cnt, zb = place_rows_by_pixel(key, (sums4[:, :3], sums4[:, 3], zhead), hw)
    return sums, cnt, zb.view(torch.float32)


def min_depth_image(sp: SortedPoints, hw: int) -> torch.Tensor:
    """(HW,) min-depth image (FLT_MAX empty) of a (pixel, depth)-sorted
    carrier stream: each segment head's depth at its pixel (the reference's
    atomicMin z-buffer, render.cu:81)."""
    is_head = _segments(sp.pix)[0]
    key = torch.where(is_head & (sp.pix < hw), sp.pix, torch.full_like(sp.pix, hw))
    (zb,) = place_rows_by_pixel(key, (sp.zbits,), hw)
    return zb.view(torch.float32)


def gather_images_sorted(imgs: Sequence[torch.Tensor], pix_s: torch.Tensor,
                         hw: int) -> Tuple[torch.Tensor, ...]:
    """``img[pix_s]`` for each (HW,) image, 0 where ``pix_s`` is the
    sentinel H*W: one gather (JAX merges carriers in with two sorts)."""
    ok = pix_s < hw
    at = torch.where(ok, pix_s, torch.zeros_like(pix_s)).to(torch.int64)
    return tuple(torch.where(ok, img[at], torch.zeros((), dtype=img.dtype, device=img.device))
                 for img in imgs)


def gather_image_sorted(img: torch.Tensor, pix_s: torch.Tensor, hw: int) -> torch.Tensor:
    """Single-image ``gather_images_sorted``."""
    return gather_images_sorted((img,), pix_s, hw)[0]


def accumulate_sums(sp: SortedPoints, min_depth: Optional[torch.Tensor], hw: int,
                    depth_band: float) -> torch.Tensor:
    """Band-filtered per-pixel colour sums and counts of a carrier stream ->
    (HW, 4) int32.

    ``min_depth=None`` tests the band against each segment head;
    otherwise against the supplied (e.g. all-reduced) min-depth image, as
    the reference's accumulate pass reads the final z-buffer
    (render.cu:101-106). That form is one scatter-add of the real in-band
    points: the same sums as JAX's prefix differences and carrier-wins
    placement (``raster.py:362-386``), which give a pixel whose band is
    empty here a zero row."""
    if min_depth is None:
        sums, cnt, _ = raster_images(sp, hw, depth_band)
        return torch.cat([sums, cnt[:, None]], 1)
    z = sp.zbits.view(torch.float32)
    lim = _band_limit(gather_image_sorted(min_depth, sp.pix, hw), depth_band)
    w = (sp.pix < hw) & ~(z > lim) & is_real(sp)
    out = torch.zeros((4, hw), dtype=torch.int64, device=z.device)
    out.index_add_(1, sp.pix[w].to(torch.int64), _lanes4(sp, w)[:, w])
    return out.t().to(torch.int32).contiguous()


def resolve_uint8(sum_img: torch.Tensor, cnt_img: torch.Tensor) -> torch.Tensor:
    """Integer-average resolve (reference render.cu:145-162): (HW,3) uint8."""
    cnt = torch.clamp(cnt_img, min=1)[:, None]
    rgb = torch.div(sum_img, cnt, rounding_mode="floor").to(torch.uint8)
    return torch.where(cnt_img[:, None] > 0, rgb, torch.zeros_like(rgb))


def _raster_sums(points, colors, cam_proj, *, width: int, height: int,
                 valid: Optional[torch.Tensor], depth_band: float, packed_out: bool = False):
    """Project, sort and resolve by ``RTNR_RESOLVE`` (module doc): (sums,
    count, depth) images, or with ``packed_out`` (packed rgb, depth)."""
    from rtnr_tpu_torch.ops.raster_resolve4 import raster_images_v4
    from rtnr_tpu_torch.ops.raster_resolve5 import raster_images_v5
    from rtnr_tpu_torch.ops.raster_resolve_carriers import resolve_carriers

    hw = width * height
    resolve = os.environ.get("RTNR_RESOLVE", "v4")
    if resolve in ("v4", "v5"):
        sp = project_and_sort(points, colors, cam_proj, width=width, height=height,
                              valid=valid, depth_key=resolve == "v4")
        images = raster_images_v4 if resolve == "v4" else raster_images_v5
        return images(sp, hw, depth_band, packed_out=packed_out)
    # v3 and any other value (JAX's v2): the carrier stream, one kernel
    sp = project_and_sort(points, colors, cam_proj, width=width, height=height,
                          valid=valid, carriers=True)
    sums, cnt, depth = resolve_carriers(sp, hw, depth_band)
    if not packed_out:
        return sums, cnt, depth
    rgb = resolve_uint8(sums, cnt).to(torch.int32)
    return rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16), depth


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
    sums, cnt, depth = _raster_sums(points, colors, cam_proj, width=width, height=height,
                                    valid=valid, depth_band=depth_band)
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
    integer-average resolve runs inside the resolve kernel on v4 and v5."""
    packed, depth = _raster_sums(points, colors, cam_proj, width=width, height=height,
                                 valid=valid, depth_band=depth_band, packed_out=True)
    return packed.reshape(height, width), depth.reshape(height, width)


def rasterize_scatter(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    depth_band: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The atomics form of the reference raster, with ``rasterize``'s
    semantics: ``scatter_reduce_("amin")`` builds the z-buffer, then one
    ``index_add_`` of the int32 sums of every point within the band of its
    pixel's minimum (``rtnr_tpu/ops/raster.py:522-558``). No sort: on the
    card, an independent cross-check of the sort-based raster."""
    hw = width * height
    u, v, z = project_points(points, cam_proj)
    pix, ok = _pixel_ids(u, v, z, valid, width, height)
    dev = z.device
    # one spare slot at H*W takes the culled points (JAX's mode="drop")
    depth = torch.full((hw + 1,), DEPTH_EMPTY, dtype=torch.float32, device=dev)
    at = pix.to(torch.int64)
    depth.scatter_reduce_(0, at, torch.where(ok, z, torch.full_like(z, float("inf"))), "amin")
    depth = depth[:hw]
    min_d = depth[torch.clamp(at, max=hw - 1)]
    w = (ok & ~(z > _band_limit(min_d, depth_band))).to(torch.int32)
    contrib = torch.cat([colors.to(torch.int32) * w[:, None], w[:, None]], 1)
    sums4 = torch.zeros((hw + 1, 4), dtype=torch.int32, device=dev)
    sums4.index_add_(0, at, contrib)
    rgb = resolve_uint8(sums4[:hw, :3], sums4[:hw, 3])
    return rgb.reshape(height, width, 3), depth.reshape(height, width)


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
