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

``filter_frame`` is the callers' entry: ``pad_to_pyramid``, then
``depth_prefilter``. On a CUDA frame in full-image mode with no gradient
(uint8 rgb, f32 depth) it runs the kernels of ``csrc/prefilter.cu``
instead: one C call, a memset and ``levels + 1`` launches in place of ~350
small torch ops, equal bit for bit (the source's header gives the design).
CPU tensors, strip mode (``row_offset`` / ``minmax``) and inputs that
require a gradient (the differentiable scene step) take the plain path;
any other CUDA call raises. Each call on the kernels adds 1 to
``filter_frame.launches`` and to the open record's counter
``prefilter.fused`` (``utils.trace.count``).

The kernels' plain twins, vectorised over the pixels with the kernels'
index arithmetic: ``pyramid_plain`` (the padded frame's levels and its
depth range through the kernels' order keys), ``level_pass_plain`` (one
coarse-to-fine pass) and ``pack_plain`` (the last pass's outputs);
``prefilter_plain`` composes them as the C entry launches them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from rtnr_tpu_torch import _build
from rtnr_tpu_torch.config import DEPTH_EMPTY, DEPTH_EMPTY_THRESHOLD
from rtnr_tpu_torch.ops.raster import depth_min_max
from rtnr_tpu_torch.utils import trace

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


def pyramid_pad_shape(height: int, width: int, levels: int) -> Tuple[int, int]:
    """Smallest (H', W') >= (H, W) divisible by 2**levels. There is no
    polyphase layout in the port, so no further row padding (1440x1440 keeps
    full prefilter parity)."""
    m = 1 << levels
    return (-(-height // m) * m, -(-width // m) * m)


def pad_to_pyramid(depth: torch.Tensor, rgb: torch.Tensor, levels: int):
    """Pad depth with FLT_MAX (empty) and rgb with black to the pyramid
    shape; padded pixels are always rejected and cropped by the caller."""
    h, w = depth.shape
    ph, pw = pyramid_pad_shape(h, w, levels)
    if (ph, pw) == (h, w):
        return depth, rgb
    dp = torch.full((ph, pw), DEPTH_EMPTY, dtype=depth.dtype, device=depth.device)
    dp[:h, :w] = depth
    cp = torch.zeros((ph, pw, rgb.shape[2]), dtype=rgb.dtype, device=rgb.device)
    cp[:h, :w] = rgb
    return dp, cp


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



# ---- the kernels' plain twins (csrc/prefilter.cu) ----

def _order_keys(v: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving 32-bit keys of f32 values, as int64."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= 1 << 31, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def pyramid_plain(depth: torch.Tensor, levels: int):
    """``prefilter_pyramid``'s twin: levels 1..``levels`` of the 2x2-min
    pyramid of the frame ``depth`` (H, W) read as empty beyond itself up to
    the pyramid shape, and (dmin, dmax) over its occupied pixels from the
    largest order key and complemented key (a key left at 0: the all-empty
    frame's inf, -inf). Returns (levels, dmin, dmax)."""
    h, w = depth.shape
    x = torch.full(pyramid_pad_shape(h, w, levels), DEPTH_EMPTY, dtype=torch.float32,
                   device=depth.device)
    x[:h, :w] = depth
    pyr = []
    for _ in range(levels):
        x = torch.minimum(torch.minimum(x[0::2, 0::2], x[0::2, 1::2]),
                          torch.minimum(x[1::2, 0::2], x[1::2, 1::2]))
        pyr.append(x)
    k = _order_keys(depth[depth != DEPTH_EMPTY])
    zero = k.new_zeros(1)
    kmin, kmax = torch.cat([zero, k ^ 0xFFFFFFFF]).max(), torch.cat([zero, k]).max()
    dmin = torch.where(kmin == 0, float("inf"), _from_key(kmin ^ 0xFFFFFFFF))
    dmax = torch.where(kmax == 0, float("-inf"), _from_key(kmax))
    return pyr, dmin, dmax


def level_pass_plain(low: torch.Tensor, fine: torch.Tensor, filter_strength: float,
                     gradient_filter: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``prefilter_level``'s twin: every pixel (y, x) of the fine level
    (2hc, 2wc) against the 3x3 neighbourhood of its coarse pixel
    (y >> 1, x >> 1) in ``low`` (hc, wc), -1 outside it. Returns the keep
    mask and the fine level refilled where rejected (the kernel's in-place
    write)."""
    hc, wc = low.shape
    y = torch.arange(2 * hc, device=low.device)[:, None]
    x = torch.arange(2 * wc, device=low.device)[None, :]
    cy, cx = y >> 1, x >> 1

    def at(r, c):
        return low[r.clamp(0, hc - 1), c.clamp(0, wc - 1)]

    s = torch.zeros_like(fine)
    nbmax = torch.full_like(fine, -1.0)
    for dy, dx, tap in _LAPLACE_TAPS:
        r, c = cy + dy, cx + dx
        nb = torch.where((r >= 0) & (r < hc) & (c >= 0) & (c < wc), at(r, c), -1.0)
        s = s + nb * tap
        nbmax = torch.maximum(nbmax, nb)
    grad = (cy > 0) & (cy < hc - 1) & (cx > 0) & (cx < wc - 1) & (s > gradient_filter)
    thr = torch.where(grad, nbmax, at(cy, cx)) * filter_strength
    keep = ~(fine >= DEPTH_EMPTY_THRESHOLD) & (fine <= thr)

    def weight(i):
        return torch.where(i == 0, -0.25, torch.where(i % 2 == 1, 0.25, 0.75))

    wx, wy = weight(x), weight(y)
    ym, yp = (y - 1).clamp(min=0) >> 1, (y + 1).clamp(max=2 * hc - 1) >> 1
    xm, xp = (x - 1).clamp(min=0) >> 1, (x + 1).clamp(max=2 * wc - 1) >> 1
    v0 = (1.0 - wx) * at(ym, xm) + wx * at(ym, xp)
    v1 = (1.0 - wx) * at(yp, xm) + wx * at(yp, xp)
    return keep, torch.where(keep, fine, (1.0 - wy) * v0 + wy * v1)


def pack_plain(depth: torch.Tensor, rgb: torch.Tensor, keep: torch.Tensor, dmin: torch.Tensor,
               dmax: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The last level pass's outputs from the padded frame and its keep
    mask, in ``depth_prefilter``'s keys."""
    k = keep[:, :, None]
    unet_input = torch.cat([torch.where(k, rgb.to(torch.float32) * (1.0 / 255.0), 0.0),
                            k.to(torch.float32),
                            torch.where(k, ((depth - dmin) / (dmax - dmin))[:, :, None], -1.0)],
                           dim=-1)
    return {"unet_input": unet_input, "filtered_depth": torch.where(keep, depth, -1.0),
            "filtered_rgb": torch.where(k, rgb, 0), "mask": keep, "depth_min": dmin,
            "depth_max": dmax}


def prefilter_plain(depth: torch.Tensor, rgb: torch.Tensor, *, levels: int = 4,
                    filter_strength: float = 1.025,
                    gradient_filter: float = 0.03) -> Dict[str, torch.Tensor]:
    """The twins composed as ``rtnr_prefilter`` launches the kernels; equal
    bit for bit to ``pad_to_pyramid`` then ``depth_prefilter``."""
    depth = depth.to(torch.float32)
    pyr, dmin, dmax = pyramid_plain(depth, levels)
    dp, cp = pad_to_pyramid(depth, rgb, levels)
    pyr = [dp] + pyr
    for i in range(levels, 1, -1):
        _, pyr[i - 1] = level_pass_plain(pyr[i], pyr[i - 1], filter_strength, gradient_filter)
    keep, _ = level_pass_plain(pyr[1], dp, filter_strength, gradient_filter)
    return pack_plain(dp, cp, keep, dmin, dmax)


# ---- the kernels ----

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MAX_LEVELS = 6  # levels a pyramid block's 64-pixel tile holds


def _bind(lib: ctypes.CDLL) -> None:
    lib.rtnr_prefilter.argtypes = [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P,
                                   _P, _P]
    lib.rtnr_prefilter.restype = _I


def _prefilter_kernels(depth: torch.Tensor, rgb: torch.Tensor, levels: int,
                       filter_strength: float, gradient_filter: float) -> Dict[str, torch.Tensor]:
    h, w = depth.shape
    ph, pw = pyramid_pad_shape(h, w, levels)
    dev = depth.device
    depth, rgb = depth.contiguous(), rgb.contiguous()
    # levels 1..L one after another, then the two 32-bit min / max keys
    pyr = torch.empty(sum((ph >> k) * (pw >> k) for k in range(1, levels + 1)) + 2,
                      dtype=torch.float32, device=dev)
    out = {"unet_input": torch.empty((ph, pw, 5), dtype=torch.float32, device=dev),
           "filtered_depth": torch.empty((ph, pw), dtype=torch.float32, device=dev),
           "filtered_rgb": torch.empty((ph, pw, 3), dtype=torch.uint8, device=dev),
           "mask": torch.empty((ph, pw), dtype=torch.bool, device=dev)}
    minmax = torch.empty(2, dtype=torch.float32, device=dev)
    lib = _build.load("prefilter", _bind)
    _build.check(lib.rtnr_prefilter(
        depth.data_ptr(), rgb.data_ptr(), h, w, ph, pw, levels, filter_strength,
        gradient_filter, DEPTH_EMPTY_THRESHOLD, pyr.data_ptr(),
        *(t.data_ptr() for t in out.values()), minmax.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rtnr_prefilter")
    out["depth_min"], out["depth_max"] = minmax[0], minmax[1]
    return out


def filter_frame(depth: torch.Tensor, rgb: torch.Tensor, *, levels: int = 4,
                 filter_strength: float = 1.025, gradient_filter: float = 0.03,
                 row_offset: Optional[int] = None, total_h: int = 0,
                 minmax: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """``pad_to_pyramid`` then ``depth_prefilter`` of the frame depth (H, W)
    and rgb (H, W, 3): ``depth_prefilter``'s outputs at the pyramid shape,
    on the kernels or the plain path as the module doc says."""
    if depth.device.type == "cpu" or row_offset is not None or minmax is not None \
            or depth.requires_grad or rgb.requires_grad:
        dp, cp = pad_to_pyramid(depth, rgb, levels)
        return depth_prefilter(dp, cp, levels=levels, filter_strength=filter_strength,
                               gradient_filter=gradient_filter, row_offset=row_offset,
                               total_h=total_h, minmax=minmax)
    if depth.device.type != "cuda" or rgb.device != depth.device \
            or depth.dtype != torch.float32 or rgb.dtype != torch.uint8 \
            or depth.dim() != 2 or tuple(rgb.shape) != (*depth.shape, 3) \
            or not 1 <= levels <= _MAX_LEVELS:
        raise ValueError(
            "filter_frame: the kernels take f32 depth (H, W) and uint8 rgb (H, W, 3) on one "
            f"CUDA device and 1-{_MAX_LEVELS} levels; got depth {depth.dtype} "
            f"{tuple(depth.shape)} on {depth.device}, rgb {rgb.dtype} {tuple(rgb.shape)} on "
            f"{rgb.device}, {levels} levels")
    out = _prefilter_kernels(depth, rgb, levels, filter_strength, gradient_filter)
    filter_frame.launches += 1
    trace.count("prefilter.fused")
    return out


filter_frame.launches = 0
