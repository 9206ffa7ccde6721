"""Plain reference of the render stages: splat raster and depth prefilter.

Written from the reference renderer's semantics (EDM-Research
project_cloud.cu / render.cu), independent of the program:

- projection ``M = K4 @ E`` in float64, used in f32; each row evaluated
  as ``((x*m0 + y*m1) + z*m2) + m3``, pixel coordinates rounded half to
  even; a point is drawn where z > 0 and its pixel is inside the frame;
- z-buffer: each pixel's least depth (``scatter_reduce`` amin; FLT_MAX
  where empty);
- resolve: the integer mean (floor) of the colours of the points within
  2 cm of that depth;
- prefilter: a 2x2 min-depth pyramid, a 3x3 Laplacian edge mask per coarse
  level (nine taps in order, borders off), the coarse-vs-fine keep test,
  the bilinear refill of rejected fine pixels coarse to fine, then the
  5-channel U-Net input (rgb/255, mask, normalised depth).

Every step keeps the reference's f32 operation order, so its frames are
bit-exact where the reference's are. It renders the whole cloud: a culled
frame has to equal it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

DEPTH_EMPTY = 3.4028234663852886e38
DEPTH_EMPTY_THRESHOLD = 3.4028e38
_COORD_LIMIT = 2147483520.0


def cam_proj(K, extrinsics: np.ndarray) -> np.ndarray:
    """4x4 ``K4 @ E`` in float64 (K: 3x3 intrinsics)."""
    K4 = np.eye(4, dtype=np.float64)
    K4[:3, :3] = np.asarray(K, np.float64)
    return (K4 @ np.asarray(extrinsics, dtype=np.float64)).astype(np.float64)


def project(points: torch.Tensor, M: np.ndarray):
    m = torch.from_numpy(np.asarray(M, np.float32)).to(points.device)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r0, r1, d = (((x * m[i, 0] + y * m[i, 1]) + z * m[i, 2]) + m[i, 3] for i in range(3))
    safe = torch.where(d > 0.0, d, torch.ones_like(d))
    u, v = (torch.round(r / safe).clamp(-_COORD_LIMIT, _COORD_LIMIT).to(torch.int32)
            for r in (r0, r1))
    return u, v, d


def raster(points: torch.Tensor, colors: torch.Tensor, M: np.ndarray, width: int, height: int,
           depth_band: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3) uint8, depth (H, W) f32) of every point."""
    hw = width * height
    u, v, z = project(points, M)
    ok = (z > 0.0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    pix = torch.where(ok, v.to(torch.int64) * width + u, torch.full_like(u, hw, dtype=torch.int64))
    del u, v
    depth = torch.full((hw + 1,), DEPTH_EMPTY, dtype=torch.float32, device=z.device)
    depth.scatter_reduce_(0, pix, torch.where(ok, z, torch.full_like(z, float("inf"))), "amin")
    lim = depth[pix] + torch.tensor(depth_band, dtype=torch.float32, device=z.device)
    w = ok & ~(z > lim)
    del lim, z
    sums = torch.zeros((hw + 1, 4), dtype=torch.int64, device=points.device)
    sums.index_add_(0, pix[w], torch.cat([colors[w].to(torch.int64),
                                          torch.ones_like(pix[w])[:, None]], 1))
    cnt = sums[:hw, 3:]
    rgb = torch.div(sums[:hw, :3], cnt.clamp(min=1), rounding_mode="floor").to(torch.uint8)
    rgb = torch.where(cnt > 0, rgb, torch.zeros_like(rgb))
    return rgb.reshape(height, width, 3), depth[:hw].reshape(height, width)


def pad_to(depth: torch.Tensor, rgb: torch.Tensor, levels: int):
    h, w = depth.shape
    m = 1 << levels
    ph, pw = -(-h // m) * m, -(-w // m) * m
    dp = torch.full((ph, pw), DEPTH_EMPTY, dtype=depth.dtype, device=depth.device)
    dp[:h, :w] = depth
    cp = torch.zeros((ph, pw, 3), dtype=rgb.dtype, device=rgb.device)
    cp[:h, :w] = rgb
    return dp, cp


_TAPS = ((-1, -1, 0.0), (-1, 0, 1.0), (-1, 1, 0.0), (0, -1, 1.0), (0, 0, -4.0), (0, 1, 1.0),
         (1, -1, 0.0), (1, 0, 1.0), (1, 1, 0.0))


def _min_pool(x):
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def _edges(x, gradient_filter):
    h, w = x.shape
    s = torch.zeros_like(x)
    for dy, dx, tap in _TAPS:
        s = s + torch.roll(x, shifts=(-dy, -dx), dims=(0, 1)) * tap
    row = torch.arange(h, device=x.device)[:, None]
    col = torch.arange(w, device=x.device)[None, :]
    return (s > gradient_filter) & (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)


def _up2(a):
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _keep(low, high, grad, fs):
    lh, lw = low.shape
    lp = torch.nn.functional.pad(low[None], (1, 1, 1, 1), value=-1.0)[0]
    nbmax = torch.full_like(low, -1.0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nbmax = torch.maximum(nbmax, lp[1 + dy:1 + dy + lh, 1 + dx:1 + dx + lw])
    thr = torch.where(grad, nbmax, low) * fs
    return ~(high >= DEPTH_EMPTY_THRESHOLD) & (high <= _up2(thr))


def _weights(o, device):
    w = torch.full((o,), 0.25, dtype=torch.float32, device=device)
    w[2::2] = 0.75
    w[0] = -0.25
    return w


def _bilinear_up2(low):
    lh, lw = low.shape
    wy = _weights(2 * lh, low.device)[:, None]
    wx = _weights(2 * lw, low.device)[None, :]
    A = _up2(low)
    dn = lambda M: torch.cat([M[:1], M[:-1]], dim=0)
    up = lambda M: torch.cat([M[1:], M[-1:]], dim=0)
    lf = lambda M: torch.cat([M[:, :1], M[:, :-1]], dim=1)
    rt = lambda M: torch.cat([M[:, 1:], M[:, -1:]], dim=1)
    v0 = (1.0 - wx) * dn(lf(A)) + wx * dn(rt(A))
    v1 = (1.0 - wx) * up(lf(A)) + wx * up(rt(A))
    return (1.0 - wy) * v0 + wy * v1


def prefilter(depth: torch.Tensor, rgb: torch.Tensor, levels: int, filter_strength: float,
              gradient_filter: float) -> Dict[str, torch.Tensor]:
    """Padded depth (FLT_MAX empty) and rgb -> unet_input (H, W, 5) f32,
    filtered depth (-1 where rejected) and the keep mask."""
    pyr = [depth.to(torch.float32)]
    for _ in range(levels):
        pyr.append(_min_pool(pyr[-1]))
    keep = None
    for i in range(levels, 0, -1):
        keep = _keep(pyr[i], pyr[i - 1], _edges(pyr[i], gradient_filter), filter_strength)
        if i > 1:
            pyr[i - 1] = torch.where(keep, pyr[i - 1], _bilinear_up2(pyr[i]))
    d = pyr[0]  # the refill writes the coarser levels only
    occ = d != DEPTH_EMPTY
    dmin = torch.where(occ, d, torch.full_like(d, float("inf"))).amin()
    dmax = torch.where(occ, d, torch.full_like(d, -float("inf"))).amax()
    ch_rgb = torch.where(keep[:, :, None], rgb.to(torch.float32) * (1.0 / 255.0), 0.0)
    ch_depth = torch.where(keep, (d - dmin) / (dmax - dmin), -1.0)
    x = torch.cat([ch_rgb, keep.to(torch.float32)[:, :, None], ch_depth[:, :, None]], dim=-1)
    return {"unet_input": x, "depth": torch.where(keep, d, -1.0), "mask": keep}


def render_input(points, colors, M, width, height, rc: Dict) -> Dict[str, torch.Tensor]:
    """Raster and prefilter of one view: raw_rgb, raw_depth, the padded
    unet_input, and depth and mask cropped to the frame."""
    raw_rgb, raw_depth = raster(points, colors, M, width, height, rc["depth_band"])
    dp, cp = pad_to(raw_depth, raw_rgb, rc["pyramid_levels"])
    pf = prefilter(dp, cp, rc["pyramid_levels"], rc["filter_strength"], rc["gradient_filter"])
    return {"raw_rgb": raw_rgb, "raw_depth": raw_depth, "unet_input": pf["unet_input"],
            "depth": pf["depth"][:height, :width], "mask": pf["mask"][:height, :width]}
