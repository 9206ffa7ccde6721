"""Render configuration (copy of ``rtnr_tpu.config``).

Defaults reproduce the reference constants (reference project_cloud.cu:20-26,
render.cu:106). The port keeps its own copy so it never imports the JAX
package. The fields, their order and ``to_json`` are the JAX package's, so
both packages write the same JSON for the same configuration.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the render pipeline.

    - ``depth_band``: accumulation band above the per-pixel min depth
      (reference render.cu:106, ``min_depth + 0.02f``).
    - ``pyramid_levels``: min-pyramid halvings in the depth prefilter
      (reference project_cloud.cu:23).
    - ``filter_strength`` / ``gradient_filter``: prefilter thresholds
      (reference project_cloud.cu:24-25).
    - ``block_size_m``: voxel block edge of the scene grid
      (reference cloudreader.cpp:10).
    - ``unet_dtype``: "bf16" runs the hand-written CUDA kernels; "f32" is
      the f32 net on plain ``F.conv2d`` (on the card too, TF32 off).
    - ``unet_int8`` (bf16 net only): "off" exact bf16; "dyn" int8 with
      activations quantised in the kernel on the levels with >= 256
      features; "static" int8 activations with per-layer scales from a
      one-time calibration on the first view (``rtnr_tpu/config.py:43-50``).
    - ``stage_timing``: the JAX package's per-stage timing switch
      (``rtnr_tpu/config.py:52-56``). The port's ``Renderer`` always marks
      its stages with CUDA events (``Renderer.last_timings``), so the switch
      changes no output and no timing.
    - ``unet_in_channels`` / ``unet_out_channels``: the U-Net's 5 inputs
      (RGB, mask, depth) and 3 outputs.
    """

    depth_band: float = 0.02
    pyramid_levels: int = 4
    filter_strength: float = 1.025
    gradient_filter: float = 0.03
    block_size_m: float = 0.25
    unet_dtype: str = "bf16"
    unet_int8: str = "off"
    stage_timing: bool = False
    unet_features: Tuple[int, ...] = (64, 128, 256, 512)
    unet_in_channels: int = 5
    unet_out_channels: int = 3

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        d = json.loads(s)
        d["unet_features"] = tuple(d.get("unet_features", (64, 128, 256, 512)))
        return cls(**d)


# 0x7F7FFFFF == FLT_MAX seeds the z-buffer (reference project_cloud.cu:316);
# a pixel still holding it after projection is empty.
DEPTH_EMPTY = 3.4028234663852886e38

# The prefilter treats any depth >= this as empty (reference
# project_cloud.cu:21, ``MAX_FLOAT 3.4028e38``, slightly below FLT_MAX).
DEPTH_EMPTY_THRESHOLD = 3.4028e38
