"""Differentiable end-to-end path: raster -> prefilter -> (U-Net).

Counterpart of ``rtnr_tpu/ops/pipeline_diff.py``: gradients flow from a
pixel loss back through the packed 5-channel tensor to point colours, point
positions and the camera matrix, and on to the U-Net's parameters when the
net is applied on top. The prefilter's masks are piecewise constant
(straight-through); the kept pixels' normalised depth is smooth in the
surviving depths, and the colour channels are linear in the in-band colours.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rtnr_tpu_torch.ops.prefilter import depth_prefilter
from rtnr_tpu_torch.ops.raster_diff import rasterize_diff
from rtnr_tpu_torch.pipeline import pad_to_pyramid


def render_filtered_diff(
    points: torch.Tensor,
    colors: torch.Tensor,
    cam_proj: torch.Tensor,
    *,
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,
    depth_band: float = 0.02,
    levels: int = 4,
    filter_strength: float = 1.025,
    gradient_filter: float = 0.03,
) -> Dict[str, torch.Tensor]:
    """Differentiable raster + prefilter. colors: (N,3) float32 (0..255).
    Returns the padded ``unet_input`` (H',W',5) plus the float rgb/depth,
    differentiable in points / colors / cam_proj along the smooth paths."""
    out = rasterize_diff(points, colors, cam_proj, width=width, height=height, valid=valid,
                         depth_band=depth_band)
    dpad, cpad = pad_to_pyramid(out.depth, out.rgb, levels)
    pf = depth_prefilter(dpad, cpad, levels=levels, filter_strength=filter_strength,
                         gradient_filter=gradient_filter)
    return {
        "unet_input": pf["unet_input"],
        "rgb_f": out.rgb,
        "depth": out.depth,
        "mask": pf["mask"][:height, :width],
        "depth_min": pf["depth_min"],
        "depth_max": pf["depth_max"],
    }


def render_full_diff(points, colors, cam_proj, unet: torch.nn.Module, *, width: int,
                     height: int, valid=None, depth_band: float = 0.02,
                     levels: int = 4) -> torch.Tensor:
    """Differentiable full pipeline -> float RGB (H,W,3) in ~[0,1].

    ``unet`` is a ``models.unet.UNetTrain``, which holds its own weights (the
    JAX function takes the module and its variables apart); it runs in the
    mode it is in (``.eval()`` matches the JAX package's ``unet.apply``).
    Gradients reach point colours and positions, the camera matrix and the
    U-Net's parameters in one backward pass."""
    mid = render_filtered_diff(points, colors, cam_proj, width=width, height=height,
                               valid=valid, depth_band=depth_band, levels=levels)
    y = unet(mid["unet_input"][None])[0]
    return y.to(torch.float32)[:height, :width]
