"""Closed-loop serving: one client asks ``Renderer.compute_full`` for frame
after frame along the traffic's camera path.

Set-up makes the scene and the U-Net weights from the seed on the device,
builds the ``Renderer`` as the render CLI does (``setup.scene_s`` is the
host clock around that), and renders the path's first ``warmup_frames``
frames: the first calibrates the static int8 scales on its view, the
others build every kernel and take the culled compaction through a reuse
and a recompute. The window then continues the path, one frame at a time:
a frame's latency runs from the call to its return with the outputs in host
memory. Per frame the record keeps the latency, ``last_timings``' three
stage spans and the culling cache's kept count and whether it was
recomputed. A uniform sample of the recomputing and the reusing frames
(``sample``, drawn from the seed as the window goes) keeps its outputs.

After the window (and the traced frames, with ``--trace 1``) the
``Renderer`` is freed and the reference renders every sampled view from
the whole cloud; the compared numbers are

- ``scale_gap``: the largest relative gap between the program's and the
  reference's static activation scales;
- ``raw_px_diff``: pixels whose ``raw_rgb`` or ``raw_depth`` differ;
- ``filter_px_diff``: pixels whose ``depth`` or ``mask`` differ;
- ``rgb_f_gap``: the largest gap of ``rgb_f``;
- ``rgb_gap``: the largest gap of the uint8 frame ``rgb``, in levels.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rtnr_bench import scenes, tracing, weights
from rtnr_bench.harness import Run, find, load_module
from rtnr_bench.reference import render as ref_render
from rtnr_bench.reference.unet import RefUNet

CONTROL_QMAX = 7  # int4, the precision below the configuration's int8
STAND_INS = ("control",)  # for calibrate.py: the int4 reference


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def build(rec: Run):
    """(renderer, camera, the scene's arrays, the U-Net variables)."""
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    cfg = rec.config
    t0 = time.time()
    pts, cols = scenes.make_scene(cfg["scene"], rec.seed, rec.device)
    pts_np, cols_np = pts.cpu().numpy(), cols.cpu().numpy()
    del pts, cols
    rc = dict(cfg["render"])
    rc["unet_features"] = tuple(rc["unet_features"])
    variables = weights.unet_variables(rec.seed, rc["unet_features"], rec.device)
    renderer = Renderer(Scene.from_arrays(pts_np, cols_np), RenderConfig(**rc), variables,
                        device=rec.device, **cfg["renderer"])
    _sync(rec.device)
    rec.scene_s = time.time() - t0
    return renderer, Camera.from_params(**cfg["camera"]), (pts_np, cols_np), variables


def reference_checks(rec: Run, cam, arrays, variables, first_pose, scales: Dict[str, float],
                     samples: List) -> Dict[str, float]:
    """The compared numbers of the sampled frames against the reference:
    pixel counts summed over the frames, gaps the widest (NaN stays NaN)."""
    cfg, dev = rec.config, rec.device
    rc = cfg["render"]
    w, h = cfg["camera"]["width"], cfg["camera"]["height"]
    points, colors = (torch.from_numpy(a).to(dev) for a in arrays)
    view = lambda E: ref_render.render_input(points, colors, ref_render.cam_proj(cam.K, E), w, h,
                                             rc)
    net = RefUNet(variables, rc["unet_features"], dev)
    s_ref = net.calibrate(view(first_pose)["unet_input"])
    out = {"scale_gap": max(abs(scales[k] / float(v) - 1.0) for k, v in s_ref.items())
           if set(scales) == set(s_ref) else float("inf"),
           "raw_px_diff": 0.0, "filter_px_diff": 0.0, "rgb_f_gap": 0.0, "rgb_gap": 0.0}
    bad = 0
    for E, got in samples:
        ref = view(E)
        g = {k: torch.from_numpy(np.ascontiguousarray(got[k])).to(dev) for k in
             ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb")}
        y = net.forward(ref["unet_input"], s_ref)[:h, :w]
        frame = {
            "raw_px_diff": int(((g["raw_rgb"] != ref["raw_rgb"]).any(-1)
                                | (g["raw_depth"] != ref["raw_depth"])).sum()),
            "filter_px_diff": int(((g["depth"] != ref["depth"]) | (g["mask"] != ref["mask"])).sum()),
            "rgb_f_gap": float((g["rgb_f"].to(torch.float32) - y).abs().max()),
            "rgb_gap": float((g["rgb"].to(torch.float32)
                              - torch.clamp(torch.round(y * 255.0), 0, 255)).abs().max()),
        }
        bad += not all(v <= cfg["limits"][k] for k, v in frame.items())
        for k, v in frame.items():
            out[k] = out[k] + v if k.endswith("_diff") else max(out[k], v, key=_nan_first)
    rec.extra["failed"] = bad
    return out


def _nan_first(v: float) -> float:
    return float("inf") if v != v else v


def window(rec: Run, renderer, cam, poses: np.ndarray):
    """Warm-up, then the measured window; returns the sampled frames."""
    tr = rec.traffic
    n = len(poses)
    for i in range(tr["warmup_frames"]):
        renderer.compute_full(cam, poses[i % n])
    rng = np.random.default_rng([int(rec.seed) & 0xFFFF_FFFF_FFFF_FFFF, 1])
    res = {k: Reservoir(v, rng) for k, v in tr["sample"].items()}
    n_points = int(renderer.points.shape[0])
    i = tr["warmup_frames"]
    t_w0 = time.time()
    rec.setup_s = t_w0 - rec.t_start
    t_b = t_w0
    while t_b - t_w0 < rec.seconds:
        E = poses[i % n]
        prev = renderer._cull_cache
        t_a = time.perf_counter()
        out = renderer.compute_full(cam, E)
        t_b_pc = time.perf_counter()
        t_b = time.time()
        lt, cache = renderer.last_timings, renderer._cull_cache
        recomputed = cache is not prev
        kept = 1.0 if cache is None or cache["overflowed"] else cache["n_kept"] / n_points
        rec.frames.append({"latency_ms": (t_b_pc - t_a) * 1e3, "projection_ms": lt.projection_ms,
                           "filter_ms": lt.filter_ms, "unet_ms": lt.unet_ms, "kept_share": kept,
                           "recomputed": recomputed})
        res["recomputed" if recomputed else "reused"].offer((E, out))
        i += 1
    rec.window_s = t_b - t_w0
    rec.extra["attempted"] = len(rec.frames)
    rec.extra["next_pose"] = i
    return [s for r in res.values() for s in r.items]


def measure(rec: Run) -> Dict:
    """Set-up, window and traced frames; the program freed, what the
    reference needs."""
    tr = rec.traffic
    renderer, cam, arrays, variables = build(rec)
    gen = load_module(find(rec.root, "traffic", tr["generator"], ".py"))
    poses = gen.poses(rec.config, tr, rec.seed)
    samples = window(rec, renderer, cam, poses)
    if rec.device == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if rec.trace:
        i0 = rec.extra["next_pose"]
        rec.traced = tracing.traced(
            lambda: [renderer.compute_full(cam, poses[(i0 + k) % len(poses)])
                     for k in range(tr["trace_frames"])], rec.device)
    scales = {k: float(v) for k, v in (renderer.act_scales or {}).items()}
    del renderer
    gc.collect()
    if rec.device == "cuda":
        torch.cuda.empty_cache()
    return {"cam": cam, "arrays": arrays, "variables": variables, "first_pose": poses[0],
            "scales": scales, "samples": samples}


def control_answers(rec: Run, ctx: Dict, qmax: int):
    """The reference computed in the control's precision in the program's
    place: its scales and the sampled frames' outputs."""
    cfg, dev = rec.config, rec.device
    rc = cfg["render"]
    w, h = cfg["camera"]["width"], cfg["camera"]["height"]
    points, colors = (torch.from_numpy(a).to(dev) for a in ctx["arrays"])
    view = lambda E: ref_render.render_input(points, colors, ref_render.cam_proj(ctx["cam"].K, E),
                                             w, h, rc)
    net = RefUNet(ctx["variables"], rc["unet_features"], dev, qmax)
    s = net.calibrate(view(ctx["first_pose"])["unet_input"])
    samples = []
    for E, _ in ctx["samples"]:
        ref = view(E)
        y = net.forward(ref["unet_input"], s)[:h, :w]
        out = {k: ref[k].cpu().numpy() for k in ("raw_rgb", "raw_depth", "depth", "mask")}
        out["rgb_f"] = y.cpu().numpy()
        out["rgb"] = torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
        samples.append((E, out))
    return {k: float(v) for k, v in s.items()}, samples


def checks(rec: Run, ctx: Dict, stand_in: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers: of the program, or of what ``stand_in`` names
    in its place."""
    scales, samples = ctx["scales"], ctx["samples"]
    if stand_in == "control":
        scales, samples = control_answers(rec, ctx, CONTROL_QMAX)
    return reference_checks(rec, ctx["cam"], ctx["arrays"], ctx["variables"], ctx["first_pose"],
                            scales, samples)


def run(rec: Run) -> None:
    ctx = measure(rec)
    t0 = time.time()
    for k, v in checks(rec, ctx).items():
        rec.check(k, v)
    rec.extra["reference_s"] = time.time() - t0
