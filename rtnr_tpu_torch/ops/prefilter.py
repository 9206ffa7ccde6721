"""Depth-based background-leak prefilter + 5-channel U-Net input packing.

Counterpart of ``rtnr_tpu/ops/prefilter.py``, full-image and strip mode.
The JAX package runs this in plain XLA, so
the port runs it in plain torch. It is bit-exact with the JAX package, so
every step keeps the reference's f32 order (reference
src/RTRenderer/src/project_cloud.cu:28-187):

1. a 2x2 min-depth pyramid of ``levels`` levels;
2. a 3x3 Laplacian edge mask per coarse level, accumulated tap by tap over
   all nine taps (zero taps included) as separate multiply and add ops, so
   FLT_MAX-saturated neighbourhoods overflow exactly as in the reference;
3. the coarse-vs-fine keep test;
4. on non-final levels, the bilinear refill of rejected fine pixels with
   weights against the CLAMPED lower index, mutating the next-finer level
   before it is compared (the coarse-to-fine order is load-bearing);
5. packing of (rgb/255, mask, normalised depth) with rejected pixels zeroed.

``F.conv2d``, ``F.interpolate``, ``torch.lerp`` and ``addcmul`` round
differently (fused or reordered products) and are deliberately not used.
Constants enter as Python scalars, which torch applies in f32 (as
``jnp.float32`` does), so no small host-to-device copy stalls the stream.

Strip mode (``row_offset`` / ``total_h`` / ``minmax``, the row strips of
``parallel/tiles.py``): the input is a halo-extended row strip of a
``total_h``-row image whose local row 0 is global row ``row_offset``; every
border decision (the Laplacian's border rows, out-of-image coarse reads,
the bilinear clamps and weights) follows global rows, so the strip's rows
away from its extension borders are bit-identical to the full image's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rtnr_tpu_torch.config import DEPTH_EMPTY_THRESHOLD
from rtnr_tpu_torch.ops.raster import depth_min_max

_LAPLACE_TAPS: Tuple[Tuple[int, int, float], ...] = (
    (-1, -1, 0.0),
    (-1, 0, 1.0),
    (-1, 1, 0.0),
    (0, -1, 1.0),
    (0, 0, -4.0),
    (0, 1, 1.0),
    (1, -1, 0.0),
    (1, 0, 1.0),
    (1, 1, 0.0),
)


def min_pool2(x: torch.Tensor) -> torch.Tensor:
    """One 2x2-min pyramid level (reference ``reduce``, project_cloud.cu:28-53)."""
    h, w = x.shape
    return x[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def laplacian_edge_mask(x: torch.Tensor, gradient_filter: float, g0: Optional[int] = None,
                        h_tot: int = 0) -> torch.Tensor:
    """Binary edge mask: ordered 9-term Laplacian > threshold; borders False
    (project_cloud.cu:55-79). Strip mode: ``x``'s row 0 is global row ``g0``
    (possibly negative) of an ``h_tot``-row image, and the border rows are
    the global ones."""
    h, w = x.shape
    s = torch.zeros_like(x)
    for dy, dx, tap in _LAPLACE_TAPS:
        nb = torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))
        s = s + nb * tap
    mask = s > gradient_filter
    row = torch.arange(h, device=x.device)[:, None]
    col = torch.arange(w, device=x.device)[None, :]
    row_int = (row > 0) & (row < h - 1) if g0 is None else \
        (row + g0 > 0) & (row + g0 < h_tot - 1)
    interior = row_int & (col > 0) & (col < w - 1)
    return mask & interior


def _up2(a: torch.Tensor) -> torch.Tensor:
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def compare_levels(
    low: torch.Tensor, high: torch.Tensor, grad_mask: torch.Tensor,
    filter_strength: float, g0: Optional[int] = None, h_tot: int = 0,
) -> torch.Tensor:
    """Keep-mask for the fine level (reference compareImgsKernel,
    project_cloud.cu:88-126). A fine pixel survives iff its depth is <= fs x
    the co-located coarse depth, or, on a gradient edge, <= fs x the max of
    the 3x3 coarse neighbourhood (out-of-bounds reads are -1.0). With fs > 0
    the OR of nine tests ``cv <= nb*fs`` is exactly ``cv <= fs*max(nb)``.
    Strip mode (``g0`` / ``h_tot`` as in ``laplacian_edge_mask``): coarse
    reads beyond the global image rows are -1.0 even where the strip holds
    halo rows."""
    empty = high >= DEPTH_EMPTY_THRESHOLD
    lh, lw = low.shape
    low_pad = torch.nn.functional.pad(low[None], (1, 1, 1, 1), value=-1.0)[0]
    nbmax = torch.full_like(low, -1.0)
    if g0 is not None:
        row = torch.arange(lh, device=low.device)[:, None]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = low_pad[1 + dy: 1 + dy + lh, 1 + dx: 1 + dx + lw]
            if g0 is not None and dy != 0:
                gnb = row + (g0 + dy)
                nb = torch.where((gnb >= 0) & (gnb < h_tot), nb, -1.0)
            nbmax = torch.maximum(nbmax, nb)
    threshold = torch.where(grad_mask, nbmax, low) * filter_strength
    keep = high <= _up2(threshold)
    return ~empty & keep


def _axis_weights(o: int, device: torch.device) -> torch.Tensor:
    """Weights ``inx - clamp(floor(inx), 0, l-1)`` with ``inx = (x+0.5)/2 - 0.5``
    for o == 2l: 0.75 at even x, 0.25 at odd x, and -0.25 at x = 0 (the
    clamped border extrapolates). All three are exact in f32; built on the
    device, so no host copy."""
    w = torch.full((o,), 0.25, dtype=torch.float32, device=device)
    w[2::2] = 0.75
    w[0] = -0.25
    return w


def bilinear_up2(low: torch.Tensor, out_shape: Tuple[int, int], g0: Optional[int] = None,
                 h_tot: int = 0) -> torch.Tensor:
    """The reference resizeKernel interpolation (project_cloud.cu:136-160):
    half-pixel centres, clamped indices, weights against the clamped lower
    index (so borders extrapolate). With out == 2*low the four clamped taps
    are edge-clamped +-1 shifts of the 2x-repeated image. Strip mode
    (``g0`` / ``h_tot`` of the coarse level, as in ``laplacian_edge_mask``):
    the row weights and clamps follow global fine rows (only global row 0
    extrapolates; strip offsets are even, so the 0.75 / 0.25 parity holds)."""
    oh, ow = out_shape
    lh, lw = low.shape
    assert (oh, ow) == (2 * lh, 2 * lw), "bilinear_up2 requires exact 2x upsampling"
    wy = _axis_weights(oh, low.device)
    if g0 is not None:
        gy = torch.arange(oh, device=low.device) + 2 * g0
        wy[0] = 0.75  # the local row 0 is global row 2*g0, an even row
        wy = torch.where(gy == 0, -0.25, wy)
    wy = wy[:, None]
    wx = _axis_weights(ow, low.device)[None, :]

    A = _up2(low)
    dn = lambda M: torch.cat([M[:1], M[:-1]], dim=0)
    up = lambda M: torch.cat([M[1:], M[-1:]], dim=0)
    if g0 is not None:
        # the row clamps happen at the global borders; inner strips read the
        # true neighbour rows from their halo
        gyc = (torch.arange(oh, device=low.device) + 2 * g0)[:, None]
        dn_l, up_l = dn, up
        dn = lambda M: torch.where(gyc == 0, M, dn_l(M))
        up = lambda M: torch.where(gyc == 2 * h_tot - 1, M, up_l(M))
    lf = lambda M: torch.cat([M[:, :1], M[:, :-1]], dim=1)
    rt = lambda M: torch.cat([M[:, 1:], M[:, -1:]], dim=1)
    l00 = dn(lf(A))
    l01 = dn(rt(A))
    l10 = up(lf(A))
    l11 = up(rt(A))
    v0 = (1.0 - wx) * l00 + wx * l01
    v1 = (1.0 - wx) * l10 + wx * l11
    return (1.0 - wy) * v0 + wy * v1


def depth_prefilter(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    *,
    levels: int = 4,
    filter_strength: float = 1.025,
    gradient_filter: float = 0.03,
    row_offset: Optional[int] = None,
    total_h: int = 0,
    minmax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Coarse-to-fine prefilter + packing. depth (H, W) f32 (FLT_MAX empty),
    rgb (H, W, 3) uint8; H and W divisible by 2**levels.

    Returns unet_input (H, W, 5) f32 NHWC, filtered_depth (-1 at rejected
    pixels), filtered_rgb (0 there), mask (bool keep), depth_min/max.

    Strip mode (module doc): ``row_offset`` is the global row of local row 0
    (a multiple of 2**levels, negative for the first strip's outer halo) of
    a ``total_h``-row image; ``minmax`` supplies the global (dmin, dmax)."""
    h, w = depth.shape
    assert h % (1 << levels) == 0 and w % (1 << levels) == 0, (
        f"prefilter needs H, W divisible by {1 << levels}; got {h}x{w} "
        "(use rtnr_tpu_torch.pipeline.pad_to_pyramid)"
    )
    depth = depth.to(torch.float32)
    pyr = [depth]
    for _ in range(levels):
        pyr.append(min_pool2(pyr[-1]))

    if row_offset is not None:
        assert row_offset % (1 << levels) == 0, "strip offsets must align with the pyramid"
    mask_fine = None
    for i in range(levels, 0, -1):
        # the arithmetic shift is exact for offsets divisible by 2**i
        g0 = None if row_offset is None else int(row_offset) >> i
        h_l = total_h >> i
        grad = laplacian_edge_mask(pyr[i], gradient_filter, g0, h_l)
        mask_fine = compare_levels(pyr[i], pyr[i - 1], grad, filter_strength, g0, h_l)
        if i > 1:
            filled = bilinear_up2(pyr[i], tuple(pyr[i - 1].shape), g0, h_l)
            pyr[i - 1] = torch.where(mask_fine, pyr[i - 1], filled)

    dmin, dmax = depth_min_max(depth) if minmax is None else minmax
    keep = mask_fine
    rgb_f = rgb.to(torch.float32)
    # XLA folds the JAX package's ``rgb / 255.0`` into a multiply by the f32
    # reciprocal; the port multiplies too, to stay bit-exact with it (the
    # two differ from the true quotient by at most 1 ulp)
    ch_rgb = torch.where(keep[:, :, None], rgb_f * (1.0 / 255.0), 0.0)
    ch_mask = keep.to(torch.float32)
    ch_depth = torch.where(keep, (depth - dmin) / (dmax - dmin), -1.0)
    unet_input = torch.cat([ch_rgb, ch_mask[:, :, None], ch_depth[:, :, None]], dim=-1)
    filtered_depth = torch.where(keep, depth, -1.0)
    filtered_rgb = torch.where(keep[:, :, None], rgb, torch.zeros_like(rgb))
    return {
        "unet_input": unet_input,
        "filtered_depth": filtered_depth,
        "filtered_rgb": filtered_rgb,
        "mask": keep,
        "depth_min": dmin,
        "depth_max": dmax,
    }

