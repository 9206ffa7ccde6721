"""CLI: render a camera trajectory through a point cloud on the card.

    python -m rtnr_tpu_torch.apps.render_trajectory <cloud.ply|.e57> <traj.txt> <calib.txt> \
        -o renders --stage full --ckpt model.pth.tar --depth --timings

The port's counterpart of ``rtnr_tpu/apps/render_trajectory.py`` (the
reference example executable, example/render_trajectory/main.cpp:67-102),
with the same parser: it loads the cloud (``.ply``, ``.e57``, or a directory
holding a ``pcd.npz`` cache; ``--cache-dir`` load-or-rebuilds the cache), the
calibration (COLMAP ``cameras.txt`` or the matrix file) and the trajectory
(TUM or COLMAP order), renders every frame with ``Renderer`` on the card and
writes one PNG per frame (``--depth``: a normalised 8-bit depth PNG beside
it), printing each frame's ``RENDER_TIME`` stages and a closing JSON line.

Stages: ``project`` (the reference example's default, main.cpp:96),
``filtered``, ``full`` (the neural pipeline; needs ``--ckpt``, a ``.msgpack``
or ``.pth``/``.pth.tar`` file).

Not yet ported: ``--batch > 0`` and ``--tiles > 1`` render over several
devices (ROADMAP A4) and exit with code 1. ``--no-compile-cache`` is
accepted and does nothing: the port has no compilation cache.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="render_trajectory",
        description="Real-time neural rendering of LiDAR point clouds on an NVIDIA GPU",
    )
    p.add_argument("cloud", help=".ply/.e57 point cloud (or a dir holding a pcd.npz cache)")
    p.add_argument("trajectory", help="trajectory file (TUM or COLMAP images.txt)")
    p.add_argument("calibration", help="COLMAP cameras.txt or matrix-format calibration file")
    p.add_argument("-o", "--output", default="renders", help="output directory for PNGs")
    p.add_argument("--stage", choices=("project", "filtered", "full"), default="project")
    p.add_argument("--ckpt", default=None, help="U-Net checkpoint (.pth/.pth.tar or .msgpack)")
    p.add_argument("--traj-format", choices=("tum", "colmap"), default="tum")
    p.add_argument("--cache-dir", default=None, help="scene cache dir (like ~/.pcl_cache)")
    p.add_argument("--batch", type=int, default=0,
                   help="frames per device batch (0 = serial; > 0 needs the multi-device "
                        "module, not yet ported)")
    p.add_argument("--depth", action="store_true", help="also write 8-bit depth PNGs")
    p.add_argument("--downsample", type=float, default=1.0, help="per-block keep fraction")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for compatibility; the port has no compilation cache")
    p.add_argument("--tiles", type=int, default=0,
                   help="row strips over N devices (> 1 needs the multi-device module, "
                        "not yet ported)")
    p.add_argument("--cull-budget", default="auto",
                   help="block-grid frustum culling point-slot budget: an "
                        "int, 'auto' (default: sized from the first view, "
                        "grown on overflow), or '0'/'off'. Safe at any "
                        "value: a view exceeding the budget falls back to "
                        "the exact full-cloud render; compaction is cached "
                        "across nearby frames")
    p.add_argument("--levels", type=int, default=4,
                   help="depth-prefilter pyramid levels (reference "
                        "depthRescaleDepth)")
    p.add_argument("--features", type=int, nargs="+", default=[64, 128, 256, 512],
                   help="U-Net feature widths (must match the checkpoint)")
    p.add_argument("--timings", action="store_true",
                   help="per-stage RENDER_TIME (projection/filter/unet) per frame")
    return p


def main(argv=None, device: str = "cuda") -> int:
    """Run the CLI; ``device`` is for tests (the command line always renders
    on the card, and raises without one)."""
    args = build_parser().parse_args(argv)
    if args.batch > 0 or args.tiles > 1:
        print("--batch and --tiles need the multi-device module, which the port does not "
              "have yet (ROADMAP A4)", file=sys.stderr)
        return 1

    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables
    from rtnr_tpu_torch.utils.image import write_png

    camera = Camera.load_calibration(args.calibration)
    trajectory = Trajectory.load(args.trajectory, fmt=args.traj_format)
    print(f"Loaded trajectory: {len(trajectory)} frames at {camera.width}x{camera.height}")

    cloud_path = Path(args.cloud)
    if cloud_path.is_dir():
        scene = Scene.load_cache(cloud_path)
        if scene is None:
            print(f"No pcd.npz cache in {cloud_path}", file=sys.stderr)
            return 1
    else:
        scene = Scene.from_file(cloud_path, cache_dir=args.cache_dir)
    if args.downsample < 1.0:
        scene = scene.downsample(args.downsample)
    print(f"Loaded {scene.n_points} points "
          f"({scene.num_blocks[0]}x{scene.num_blocks[1]}x{scene.num_blocks[2]} blocks)")

    variables = None
    if args.stage == "full":
        if args.ckpt is None:
            print("--stage=full requires --ckpt", file=sys.stderr)
            return 1
        variables = load_unet_variables(args.ckpt, args.features)

    config = RenderConfig(stage_timing=args.timings, unet_features=tuple(args.features),
                          pyramid_levels=args.levels)
    cull = args.cull_budget
    if isinstance(cull, str):
        cull = None if cull.lower() in ("0", "off", "none") else (
            "auto" if cull.lower() == "auto" else int(cull))
    renderer = Renderer(scene, config=config, unet_variables=variables,
                        cull_budget=cull or None, device=device)

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)

    def frame_name(i: int) -> str:
        name = trajectory[i].filename
        return name if name.endswith(".png") else name + ".png"

    def write_depth(name: str, d: np.ndarray) -> None:
        occ = (d > 0) & (d < 3e38)
        dn = np.zeros_like(d)
        if occ.any():
            lo, hi = d[occ].min(), d[occ].max()
            dn[occ] = (d[occ] - lo) / max(hi - lo, 1e-9) * 255.0
        write_png(outdir / name.replace(".png", "_depth.png"), dn.astype(np.uint8))

    stage_fn = {
        "project": renderer.compute_rgbd,
        "filtered": renderer.compute_filtered_rgbd,
        "full": renderer.compute_full,
    }[args.stage]
    t_start = time.perf_counter()
    for i in range(len(trajectory)):
        out = stage_fn(camera, trajectory.world_to_cam(i))
        write_png(outdir / frame_name(i), out["rgb"])
        if args.depth:
            write_depth(frame_name(i), np.asarray(out["depth"]))
        print(f"[{i + 1}/{len(trajectory)}] {frame_name(i)}  {renderer.last_timings}")
    total = time.perf_counter() - t_start
    fps = len(trajectory) / total if total > 0 else 0.0
    print(json.dumps({"frames": len(trajectory), "seconds": round(total, 3),
                      "fps": round(fps, 2), "stage": args.stage}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
