"""End-to-end render pipeline: raster -> prefilter -> U-Net.

Counterpart of ``rtnr_tpu/pipeline.py`` (the phase branch of
``render_full``, ``pipeline.py:167-199``): the three reference entry points
(computeRGBD / computeFilteredRGBD / computeFull, reference
project_cloud.h:11-18) as functions on tensors, and ``Renderer``, which pins
the scene and the folded U-Net weights on the device once.

Functions on tensors follow their inputs' device. ``Renderer`` runs on the
card unless the caller asks for ``device="cpu"``; without CUDA the default
raises. It takes every option of the JAX ``Renderer``: the bf16, int8
("dyn", "static" with lazy calibration) and f32 U-Nets, and frustum culling
(``cull_budget``, ``ops/culling.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, ContextManager, Dict, List, Optional

import numpy as np
import torch

from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import from_flax_variables
from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales
from rtnr_tpu_torch.ops.culling import build_block_index, compact_points, cull_points
# pad_to_pyramid is also imported from here
from rtnr_tpu_torch.ops.prefilter import (filter_frame, pad_to_pyramid,  # noqa: F401
                                          pyramid_pad_shape)
from rtnr_tpu_torch.ops.raster import rasterize, rasterize_packed, unpack_rgb8
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.utils import trace


def render_rgbd(points, colors, valid, cam_proj, *, width: int, height: int,
                depth_band: float = 0.02) -> Dict[str, torch.Tensor]:
    """Stage 1: raw projection (reference computeRGBD)."""
    rgb, depth = rasterize(points, colors, cam_proj, width=width, height=height,
                           valid=valid, depth_band=depth_band)
    return {"rgb": rgb, "depth": depth}


def _no_stage(name: str) -> ContextManager:
    return contextlib.nullcontext()


def _render(points, colors, valid, cam_proj, unet: Optional[Callable], *, width: int,
            height: int, depth_band: float, levels: int, filter_strength: float,
            gradient_filter: float, stage: Callable[[str], ContextManager] = _no_stage):
    """Raster -> prefilter (-> U-Net when ``unet`` is given); ``stage(name)``
    wraps each stage (the Renderer's stage spans)."""
    with stage("frame.projection"):
        if unet is None:
            raw_rgb, raw_depth = rasterize(points, colors, cam_proj, width=width,
                                           height=height, valid=valid, depth_band=depth_band)
        else:  # the integer-average resolve runs inside the resolve kernel
            packed, raw_depth = rasterize_packed(points, colors, cam_proj, width=width,
                                                 height=height, valid=valid,
                                                 depth_band=depth_band)
            raw_rgb = unpack_rgb8(packed)
    with stage("frame.filter"):
        pf = filter_frame(raw_depth, raw_rgb, levels=levels, filter_strength=filter_strength,
                          gradient_filter=gradient_filter)
    crop = lambda x: x[:height, :width]
    if unet is None:
        return {
            "rgb": crop(pf["filtered_rgb"]),
            "depth": crop(pf["filtered_depth"]),
            "mask": crop(pf["mask"]),
            "unet_input": pf["unet_input"],  # padded (H', W', 5)
            "depth_min": pf["depth_min"],
            "depth_max": pf["depth_max"],
            "raw_rgb": raw_rgb,
            "raw_depth": raw_depth,
        }
    with stage("frame.unet"):
        y = crop(unet(pf["unet_input"][None])[0]).to(torch.float32)
    return {
        # the saturating x255 uint8 frame (reference project_cloud.cu:480)
        "rgb": torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8),
        "rgb_f": y,
        "depth": crop(pf["filtered_depth"]),
        "raw_rgb": raw_rgb,
        "raw_depth": raw_depth,
        "mask": crop(pf["mask"]),
    }


def render_filtered(points, colors, valid, cam_proj, *, width: int, height: int,
                    depth_band: float = 0.02, levels: int = 4,
                    filter_strength: float = 1.025,
                    gradient_filter: float = 0.03) -> Dict[str, torch.Tensor]:
    """Stage 2: projection + depth prefilter (reference computeFilteredRGBD):
    rgb zeroed and depth -1 at rejected pixels, plus the padded U-Net input."""
    return _render(points, colors, valid, cam_proj, None, width=width, height=height,
                   depth_band=depth_band, levels=levels, filter_strength=filter_strength,
                   gradient_filter=gradient_filter)


def render_full(points, colors, valid, cam_proj, unet: UNet, *, width: int, height: int,
                depth_band: float = 0.02, levels: int = 4, filter_strength: float = 1.025,
                gradient_filter: float = 0.03, act_scales=None) -> Dict[str, torch.Tensor]:
    """Stage 3: raster + prefilter + U-Net (reference computeFull).
    ``rgb_f`` is the float output, ``rgb`` its saturating x255 uint8 frame.
    ``act_scales`` feeds a static-int8 net (``UNet(quant_int8=True)``); an
    int8 net runs exact bf16 unless ``levels == len(unet.features)`` and
    ``unet.int8_applies`` the padded shape (``rtnr_tpu/pipeline.py:167``)."""
    net = functools.partial(unet, act_scales=act_scales, levels=levels)
    return _render(points, colors, valid, cam_proj, net, width=width, height=height,
                   depth_band=depth_band, levels=levels, filter_strength=filter_strength,
                   gradient_filter=gradient_filter)


@dataclasses.dataclass
class FrameTimings:
    """Per-stage times in ms (the reference's RENDER_TIME print,
    project_cloud.cu:490): the frame's stage spans ``frame.projection``,
    ``frame.filter``, ``frame.unet`` (``utils.trace``): CUDA events on the
    card, the host clock around the CPU path."""

    projection_ms: float = 0.0
    filter_ms: float = 0.0
    unet_ms: float = 0.0
    total_ms: float = 0.0

    def __str__(self) -> str:
        return (
            f"RENDER_TIME: projection[{self.projection_ms:.2f}], "
            f"filter[{self.filter_ms:.2f}], unet[{self.unet_ms:.2f}], "
            f"Total[{self.total_ms:.2f}]"
        )


def _numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The outputs in host numpy: the frame's ``frame.copy_out`` span."""
    with trace.span("frame.copy_out"):
        trace.count("copy_out.bytes", sum(v.numel() * v.element_size() for v in out.values()))
        return {k: v.detach().cpu().numpy() for k, v in out.items()}


class Renderer:
    """Scene-pinned render front end (the reference's ``ProjectCloud``).

    ``unet_variables``: the JAX package's U-Net variables as nested numpy
    dicts (raw with ``batch_stats``, or folded); None disables
    ``compute_full``. ``device`` defaults to "cuda" and raises without it.

    ``config.unet_dtype``: "bf16" runs the CUDA kernels; "f32" runs the f32
    net on plain ``F.conv2d`` (TF32 off), as the JAX package's f32 net runs
    XLA's own convs; ``unet_int8`` has no effect on it. ``config.unet_int8``
    (bf16 only): "off" exact, "dyn" dynamic int8, "static" static int8,
    calibrated lazily on the first ``compute_full`` view's own U-Net input
    (``calibrate``); the scales stay on the device (``act_scales``). As in
    JAX, int8 applies only where ``pyramid_levels == len(unet_features)``
    and the padded frame passes ``UNet.int8_applies``; elsewhere the frame
    is the exact bf16 one.

    ``cull_budget`` enables frustum culling on the 0.25 m block grid
    (``rtnr_tpu/pipeline.py:257-384``): per view, the points of out-of-
    frustum blocks are compacted away into a ``cull_budget``-point buffer,
    which shrinks the per-frame sort. The compaction is cached and reused
    while the camera stays within ``cull_inflate_m`` meters and a rotation
    bounded by ``cull_margin_px`` pixels of the compaction's pose (block boxes
    are inflated by the same amount, so reuse is conservative). If a view
    keeps more points than the budget, the full cloud is rendered for that
    pose region instead: culling never drops a visible point.
    ``cull_budget`` is an int, "auto" (1.5x the first view's kept count,
    rounded up to ``pad_points_to``, grown on overflow) or None/0 (off).
    """

    def __init__(self, scene: Scene, config: RenderConfig = RenderConfig(),
                 unet_variables: Any = None, pad_points_to: int = 1024,
                 cull_budget: Any = None, cull_margin_px: float = 96.0,
                 cull_inflate_m: float = 0.5, device: str = "cuda"):
        if config.unet_int8 not in ("off", "dyn", "static"):
            raise ValueError(f"unet_int8 must be 'off', 'dyn' or 'static', not "
                             f"{config.unet_int8!r}")
        if config.unet_dtype not in ("bf16", "f32"):
            raise ValueError(f"unet_dtype must be 'bf16' or 'f32', not {config.unet_dtype!r}")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self.device = dev
        self.config = config
        pts, cols, valid = scene.sorted_by_block().device_arrays(pad_points_to)
        self.points = torch.from_numpy(pts).to(dev)
        self.colors = torch.from_numpy(cols).to(dev)
        self.valid = torch.from_numpy(valid).to(dev)
        self._cull_auto = cull_budget == "auto"
        self.cull_budget = None if self._cull_auto else cull_budget
        self._cull_enabled = bool(cull_budget)
        self._pad_points_to = int(pad_points_to)
        self.cull_margin_px = float(cull_margin_px)
        self.cull_inflate_m = float(cull_inflate_m)
        self._cull_cache: Optional[dict] = None
        if self._cull_enabled:
            self._block_index = build_block_index(scene, pad_points_to, device=dev)
        self.unet: Optional[UNet] = None
        self.act_scales: Optional[Dict[str, torch.Tensor]] = None
        if unet_variables is not None:
            bf16 = config.unet_dtype == "bf16"
            state = from_flax_variables(unet_variables)
            self.unet = UNet(state, features=config.unet_features,
                             out_channels=config.unet_out_channels,
                             quant_int8=bf16 and config.unet_int8 != "off").to(dev)
            # weights laid out on the device once (static int8: after calibration)
            if bf16 and config.unet_int8 == "dyn":
                self.unet.prepare_int8()
            elif bf16:
                self.unet.prepare()
        self.last_timings = FrameTimings()

    def _cam_proj(self, camera: Camera, extrinsics: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(camera.cam_proj(extrinsics).astype(np.float32)).to(self.device)

    def _view_points(self, camera: Camera, extrinsics: np.ndarray):
        """Scene tensors for this view: the full cloud, or the cached culled
        compaction (recomputed only when the pose leaves the cached
        compaction's conservative validity region). If the view keeps more
        points than the budget, the full cloud is returned (and cached for
        the region)."""
        if not self._cull_enabled:
            return self.points, self.colors, self.valid
        E = np.asarray(extrinsics, np.float64)
        R, t = E[:3, :3], E[:3, 3]
        C = -R.T @ t  # camera center in world space
        f = min(camera.fx, camera.fy)
        # rotation budget: pixel shift at the image edge <= margin/2
        # (shift <= f * dtheta * sec^2(alpha_max), alpha_max at the corner)
        sec2 = 1.0 + (max(camera.width, camera.height) / (2.0 * f)) ** 2
        rot_budget_rad = self.cull_margin_px / (2.0 * f * sec2)
        cache = self._cull_cache
        if cache is not None and cache["wh"] == (camera.width, camera.height):
            cosang = (np.trace(cache["R"].T @ R) - 1.0) / 2.0
            ang = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
            if float(np.linalg.norm(C - cache["C"])) <= self.cull_inflate_m and ang <= rot_budget_rad:
                return cache["arrays"]

        keep = cull_points(self._block_index, self._cam_proj(camera, extrinsics), self.valid,
                           width=camera.width, height=camera.height,
                           margin=self.cull_margin_px, inflate_m=self.cull_inflate_m)
        n_kept = int(keep.sum())
        pad = self._pad_points_to
        if self._cull_auto and (self.cull_budget is None or n_kept > self.cull_budget):
            # size (or grow, on overflow) the budget to 1.5x the kept count
            self.cull_budget = min(-(-int(1.5 * max(n_kept, 1)) // pad) * pad,
                                   int(self.points.shape[0]))
        overflowed = n_kept > (self.cull_budget or 0)
        if overflowed:  # the compaction would drop visible points: render the full cloud
            arrays = (self.points, self.colors, self.valid)
        else:
            arrays = compact_points(self.points, self.colors, keep, self.cull_budget)
        self._cull_cache = {"arrays": arrays, "C": C, "R": R, "wh": (camera.width, camera.height),
                            "n_kept": n_kept, "overflowed": overflowed}
        return arrays

    def _unet(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.unet_dtype == "bf16":
            return self.unet(x, act_scales=self.act_scales, levels=self.config.pyramid_levels)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return self.unet.forward_plain(x, torch.float32)

    def calibrate(self, camera: Camera, extrinsics: np.ndarray):
        """Static-int8 calibration on this view's own U-Net input, once
        (``rtnr_tpu/pipeline.py:444-472``); a no-op unless
        ``unet_int8="static"`` runs the bf16 net, and at a view where the net
        runs exact bf16 (``pyramid_levels != len(features)`` or a padded
        shape outside ``UNet.int8_applies``), so a later view at a shape that
        quantises still calibrates. Returns ``act_scales``."""
        if self.act_scales is None and self.unet is not None and self.unet.quant_int8 \
                and self.config.unet_int8 == "static":
            cfg = self.config
            ph, pw = pyramid_pad_shape(camera.height, camera.width, cfg.pyramid_levels)
            if cfg.pyramid_levels != len(self.unet.features) or not self.unet.int8_applies(ph, pw):
                return None
            pts, cols, valid = self._view_points(camera, extrinsics)
            mid = render_filtered(pts, cols, valid, self._cam_proj(camera, extrinsics),
                                  width=camera.width, height=camera.height,
                                  depth_band=cfg.depth_band, levels=cfg.pyramid_levels,
                                  filter_strength=cfg.filter_strength,
                                  gradient_filter=cfg.gradient_filter)
            self.act_scales = calibrate_act_scales(self.unet, mid["unet_input"][None])
            self.unet.prepare_int8(self.act_scales)
        return self.act_scales

    def _frame(self):
        """The frame's root span (``utils.trace``)."""
        return trace.span("frame", root=True, device=self.device)

    @contextlib.contextmanager
    def _staged(self, camera: Camera, extrinsics: np.ndarray, full: bool):
        """The frame, holding its stages' outputs on the device (``full``:
        through the U-Net)."""
        if full and self.unet is None:
            raise RuntimeError("No U-Net variables given; compute_full unavailable.")
        with self._frame():
            yield self._stages(camera, extrinsics, full)

    def _stage(self, stages: List, name: str):
        """A stage span, timed whether or not the record is on."""
        sp = trace.span(name, timed=True)
        stages.append(sp)
        return sp

    def _cull(self, camera: Camera, extrinsics: np.ndarray, prev: Optional[dict]):
        """``_view_points`` and the pose upload in the frame's culling span,
        with its counters (``prev``: the compaction cached when the frame
        began): (points, colours, valid, the camera matrix on the device).
        The upload's copy waits for the stream, so after a recompute the span
        ends once the compaction has run. The calibration may precede it in
        the frame: its device time starts at an event of its own."""
        with trace.span("frame.cull", fresh=True):
            arrays = self._view_points(camera, extrinsics)
            M = self._cam_proj(camera, extrinsics)
        cache = self._cull_cache
        if cache is not None:
            trace.count("cull.recomputed", int(cache is not prev))
            trace.count("cull.kept_points", cache["n_kept"])
            trace.count("cull.overflowed", int(cache["overflowed"]))
        return (*arrays, M)

    def _wait(self, stages: List) -> None:
        """Wait for the last stage's end; ``last_timings`` from the stages."""
        with trace.span("frame.wait"):
            stages[-1].wait()
        ms = [sp.ms for sp in stages] + [0.0] * (3 - len(stages))
        self.last_timings = FrameTimings(projection_ms=ms[0], filter_ms=ms[1], unet_ms=ms[2],
                                         total_ms=sum(ms))

    def compute_rgbd(self, camera: Camera, extrinsics: np.ndarray) -> Dict[str, np.ndarray]:
        with self._frame():
            pts, cols, valid, M = self._cull(camera, extrinsics, self._cull_cache)
            stages = []
            with self._stage(stages, "frame.projection"):
                out = render_rgbd(pts, cols, valid, M, width=camera.width,
                                  height=camera.height, depth_band=self.config.depth_band)
            self._wait(stages)
            return _numpy(out)

    def _stages(self, camera: Camera, extrinsics: np.ndarray, full: bool):
        """The frame's stages; call inside ``_frame()`` (``_staged``)."""
        cfg = self.config
        prev = self._cull_cache
        if full:
            self.calibrate(camera, extrinsics)
        pts, cols, valid, M = self._cull(camera, extrinsics, prev)
        stages = []
        out = _render(pts, cols, valid, M, self._unet if full else None,
                      width=camera.width, height=camera.height, depth_band=cfg.depth_band,
                      levels=cfg.pyramid_levels, filter_strength=cfg.filter_strength,
                      gradient_filter=cfg.gradient_filter,
                      stage=functools.partial(self._stage, stages))
        self._wait(stages)
        return out

    def compute_filtered_rgbd(self, camera: Camera, extrinsics: np.ndarray,
                              timings: bool = False) -> Dict[str, np.ndarray]:
        """Projection + prefilter; ``timings`` as in ``compute_full``."""
        with self._staged(camera, extrinsics, full=False) as out:
            return _numpy(out)

    def compute_full_tensors(self, camera: Camera, extrinsics: np.ndarray,
                             timings: bool = False) -> Dict[str, torch.Tensor]:
        """``compute_full`` without the copy to host numpy (outputs stay on
        the device)."""
        with self._staged(camera, extrinsics, full=True) as out:
            return out

    def compute_full(self, camera: Camera, extrinsics: np.ndarray,
                     timings: bool = False) -> Dict[str, np.ndarray]:
        """Full neural render; ``last_timings`` holds the staged times.

        Each call is one frame of the record (``utils.trace``): the root span
        ``frame`` holds ``frame.cull``, the three stage spans, ``frame.wait``
        and ``frame.copy_out`` (``frame.projection`` holds
        ``projection.sort``), with the counters ``cull.recomputed``,
        ``cull.kept_points``, ``cull.overflowed`` and ``copy_out.bytes``; the
        view that calibrates static int8 calibrates inside its frame.

        ``timings`` (and ``config.stage_timing``) is the JAX package's switch
        to run the stages as separate synchronised programs
        (``rtnr_tpu/pipeline.py:474-488``). The port always marks the same
        stages with CUDA events on one stream, so the switch changes neither
        the outputs nor the timings."""
        with self._staged(camera, extrinsics, full=True) as out:
            return _numpy(out)
