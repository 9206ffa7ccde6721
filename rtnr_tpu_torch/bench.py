"""Benchmark line of the port: the full neural render (raster + prefilter +
U-Net) on the card, as the JAX package's ``bench.py`` measures it on a TPU.

    python -m rtnr_tpu_torch.bench          # one CUDA card; prints ONE JSON line

The same work as ``bench.py:52-184``: ``Scene.synthetic(BENCH_POINTS,
seed=0, extent=10)`` (5M points), ``Camera.from_params(1100, 1100, w/2, h/2,
w, h)`` at ``E[2,3] = 12``, the full-width U-Net [64,128,256,512] with the
port's seeded random weights (``init_unet_numpy(0)``), and a trajectory of
``BENCH_FRAMES`` frames (default 20), frame k at ``M0`` with ``M[0,3]``
shifted by ``dx * k``. Each frame is consumed into an accumulator on the
card (``rgb[0,0,0] + raw_depth[0,0] + rgb_f[h/2, w/2, 1]``); a trial ends
with one synchronise, and the result is the median fps of ``BENCH_TRIALS``
trials (default 3) after one warm-up trajectory.

The headline is static int8 (``BENCH_UNET_INT8``, default ``static``;
``dyn`` and ``off`` are the other modes), calibrated on frame 0; exact bf16
is timed beside it (``BENCH_BOTH``, default 1). Where the padded frame fails
the int8 shape terms (``models.unet.int8_shape_ok``; the reference's export
shapes 960x720 and 1440x1440), the headline falls back to bf16 with
``bench.py``'s note on stderr. ``BENCH_WIDTH`` / ``BENCH_HEIGHT`` set the
frame. In ``bench.py`` ``BENCH_BATCH`` only unrolls frames inside the timed
loop; here the frames always run one by one, ``batch`` is reported as read,
and the trajectory holds ``ceil(frames / batch) * batch`` frames as there.

The JSON line has ``bench.py``'s fields (``metric``, ``value``, ``unit``,
``vs_baseline`` against 30 fps, ``trials``, ``unet_int8``, ``batch``,
``points_per_s``, ``pixels_per_s``, ``ms_per_frame``, ``fps_bf16_exact``,
``ms_per_frame_bf16``) plus ``device``, the card's name. ``run(...,
device="cpu")`` runs the same on the CPU's plain twins, for tests.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Sequence

import numpy as np

FEATURES = (64, 128, 256, 512)
BASELINE_FPS = 30.0


def headline_mode(mode: str, width: int, height: int,
                  features: Sequence[int] = FEATURES) -> str:
    """The U-Net mode the bench times: ``mode``, or "off" (with bench.py's
    note on stderr) where the padded frame fails the int8 shape terms."""
    from rtnr_tpu_torch.models.unet import int8_shape_ok
    from rtnr_tpu_torch.pipeline import pyramid_pad_shape

    if mode not in ("off", "dyn", "static"):
        raise ValueError(f"BENCH_UNET_INT8 must be 'off', 'dyn' or 'static', not {mode!r}")
    if mode != "off" and not int8_shape_ok(features, *pyramid_pad_shape(height, width,
                                                                         len(features))):
        print(f"# phase layout unsupported at {width}x{height}: falling back to bf16",
              file=sys.stderr, flush=True)
        return "off"
    return mode


def run(n_points: int = 5_000_000, width: int = 1920, height: int = 1080, frames: int = 20,
        batch: int = 1, trials: int = 3, int8_mode: str = "static", both: bool = True,
        features: Sequence[int] = FEATURES, device: str = "cuda") -> Dict:
    """Time the trajectory and return the JSON record (module doc)."""
    import torch

    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
    from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales
    from rtnr_tpu_torch.pipeline import Renderer, render_filtered, render_full
    from rtnr_tpu_torch.scene import Scene

    features = tuple(features)
    int8_mode = headline_mode(int8_mode, width, height, features)
    both = both and int8_mode == "static"
    scene = Scene.synthetic(n_points, seed=0, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, width / 2, height / 2, width, height)
    variables = init_unet_numpy(0, features)
    # the scene on the device and the exact bf16 net, laid out once
    r = Renderer(scene, RenderConfig(unet_features=features), variables, device=device)
    dev = r.device
    E = np.eye(4)
    E[2, 3] = 12.0
    M0 = torch.from_numpy(cam.cam_proj(E).astype(np.float32)).to(dev)

    nets = {"off": (r.unet, None)}
    if int8_mode != "off":
        net = UNet(from_flax_variables(variables), features=features, quant_int8=True).to(dev)
        scales = None
        if int8_mode == "static":
            print("# calibrating int8 scales on frame 0...", file=sys.stderr, flush=True)
            mid = render_filtered(r.points, r.colors, r.valid, M0, width=width, height=height,
                                  levels=len(features))
            scales = calibrate_act_scales(net, mid["unet_input"][None])
            del mid
        net.prepare_int8(scales)
        nets[int8_mode] = (net, scales)

    n_frames = -(-frames // batch) * batch

    def trajectory(unet, scales, dx: float) -> torch.Tensor:
        shift = torch.zeros((n_frames, 4, 4), dtype=torch.float32, device=dev)
        shift[:, 0, 3] = dx * torch.arange(n_frames, dtype=torch.float32, device=dev)
        Ms = M0 + shift
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for k in range(n_frames):
                out = render_full(r.points, r.colors, r.valid, Ms[k], unet, width=width,
                                  height=height, levels=len(features), act_scales=scales)
                # consume the frame, as bench.py does
                acc += (out["rgb"][0, 0, 0].float() + out["raw_depth"][0, 0]
                        + out["rgb_f"][height // 2, width // 2, 1])
        return acc

    def measure(mode: str):
        unet, scales = nets[mode]
        tag = "bf16" if mode == "off" else "int8"
        print(f"# warming up {tag} ({n_points} pts, {width}x{height}, batch {batch})...",
              file=sys.stderr, flush=True)
        float(trajectory(unet, scales, 0.01))
        print(f"# timing {tag}...", file=sys.stderr, flush=True)
        fps = []
        for t in range(trials):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(trajectory(unet, scales, 0.02 + 0.001 * t))  # the trial's one synchronise
            fps.append(round(n_frames / (time.perf_counter() - t0), 3))
        return sorted(fps)[len(fps) // 2], fps  # bench.py's median

    fps, fps_trials = measure(int8_mode)
    fps_bf16 = measure("off")[0] if both else None
    rec = {
        "metric": f"fps_{width}x{height}_full_pipeline_{n_points // 1_000_000}Mpts",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "trials": fps_trials,
        "unet_int8": int8_mode,
        "batch": batch,
        "points_per_s": round(fps * n_points, 0),
        "pixels_per_s": round(fps * width * height, 0),
        "ms_per_frame": round(1e3 / fps, 2),
    }
    if fps_bf16 is not None:
        rec["fps_bf16_exact"] = fps_bf16
        rec["ms_per_frame_bf16"] = round(1e3 / fps_bf16, 2)
    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return rec


def main() -> int:
    rec = run(
        n_points=int(os.environ.get("BENCH_POINTS", 5_000_000)),
        width=int(os.environ.get("BENCH_WIDTH", 1920)),
        height=int(os.environ.get("BENCH_HEIGHT", 1080)),
        frames=int(os.environ.get("BENCH_FRAMES", 20)),
        batch=int(os.environ.get("BENCH_BATCH", 1)),
        trials=int(os.environ.get("BENCH_TRIALS", 3)),
        int8_mode=os.environ.get("BENCH_UNET_INT8", "static"),
        both=os.environ.get("BENCH_BOTH", "1") == "1",
    )
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
