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
``--timings`` adds the frame's record (``utils.trace``) to its line: the
host ms of the culling, of the wait for the last stage and of the copy to
the host, ``recomputed[0|1]`` for the culled compaction, the points it
kept and ``overflowed[0|1]`` (more than the culling budget: the frame
rendered the whole cloud) (serial rendering only).

Stages: ``project`` (the reference example's default, main.cpp:96),
``filtered``, ``full`` (the neural pipeline; needs ``--ckpt``, a ``.msgpack``
or ``.pth``/``.pth.tar`` file).

Several ranks (``torchrun --nproc-per-node N -m
rtnr_tpu_torch.apps.render_trajectory ...``; ``parallel.init_distributed``
picks the backend):

- ``--batch B``: frames data-parallel over the N ranks
  (``parallel.render_full_batch`` / ``render_filtered_sharded`` on a (N, 1)
  mesh), B rounded to a multiple of N (at least N), the last batch padded
  with its last frame; the PNGs are the serial CLI's.
- ``--tiles T`` (needs N == T): the image in T row strips, ``--stage
  project`` with the per-strip block culling (``parallel.tiles.
  rasterize_tile_sharded``, the serial PNGs) or ``full`` (``render_full_
  tile_sharded`` at the strip-aligned pyramid height, with the JAX CLI's
  halo arithmetic; the U-Net's seams differ from the serial frame).

Rank 0 writes the PNGs and prints the frame lines and the closing JSON line.
``--no-compile-cache`` is accepted and does nothing: the port has no
compilation cache.
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
                   help="frames per batch over the launcher's ranks (0 = serial)")
    p.add_argument("--depth", action="store_true", help="also write 8-bit depth PNGs")
    p.add_argument("--downsample", type=float, default=1.0, help="per-block keep fraction")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for compatibility; the port has no compilation cache")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard the image into N row strips over N ranks with per-strip "
                        "block-grid candidate gather (projection or full stage)")
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
                   help="add the frame's record to each frame's line: culling, wait and "
                        "copy ms, whether the culled compaction was recomputed, points kept, "
                        "whether they overflowed the budget")
    return p


def record_line(rec) -> str:
    """A frame's record (``utils.trace.records()``) as the ``--timings`` part
    of its line: the host ms of the culling, the wait for the last stage and
    the copy to the host, whether the culled compaction was recomputed, the
    points it kept ("-" without culling) and whether they overflowed the
    culling budget, so that the frame rendered the whole cloud."""
    root = rec["spans"][0]["id"]
    ms = {sp["name"]: sp["host_ms"] for sp in rec["spans"] if sp["parent"] == root}
    c = rec["counters"]
    kept = c.get("cull.kept_points")
    return (f"cull[{ms.get('frame.cull', 0.0):.2f}], wait[{ms.get('frame.wait', 0.0):.2f}], "
            f"copy[{ms.get('frame.copy_out', 0.0):.2f}], "
            f"recomputed[{int(c.get('cull.recomputed', 0))}], "
            f"kept[{'-' if kept is None else int(kept)}], "
            f"overflowed[{int(c.get('cull.overflowed', 0))}]")


def main(argv=None, device: str = "cuda") -> int:
    """Run the CLI; ``device`` is for tests (the command line always renders
    on the card, and raises without one)."""
    args = build_parser().parse_args(argv)
    multi = args.batch > 0 or args.tiles > 1
    rank, world = 0, 1
    if multi:
        import torch.distributed as dist

        from rtnr_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(device)
        if dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        if args.tiles > 1 and world != args.tiles:
            print(f"--tiles {args.tiles} needs {args.tiles} ranks (torchrun --nproc-per-node "
                  f"{args.tiles}); this run has {world}", file=sys.stderr)
            return 1
    say = print if rank == 0 else (lambda *a, **k: None)

    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils import trace
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables
    from rtnr_tpu_torch.utils.image import write_png

    camera = Camera.load_calibration(args.calibration)
    trajectory = Trajectory.load(args.trajectory, fmt=args.traj_format)
    say(f"Loaded trajectory: {len(trajectory)} frames at {camera.width}x{camera.height}")

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
    say(f"Loaded {scene.n_points} points "
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

    t_start = time.perf_counter()
    if multi:
        extra = _render_ranks(args, scene, camera, trajectory, renderer, config, frame_name,
                              write_depth, outdir, say, rank)
        if extra is None:
            return 1
    else:
        extra = {}
        stage_fn = {
            "project": renderer.compute_rgbd,
            "filtered": renderer.compute_filtered_rgbd,
            "full": renderer.compute_full,
        }[args.stage]
        for i in range(len(trajectory)):
            out = stage_fn(camera, trajectory.world_to_cam(i))
            write_png(outdir / frame_name(i), out["rgb"])
            if args.depth:
                write_depth(frame_name(i), np.asarray(out["depth"]))
            line = f"[{i + 1}/{len(trajectory)}] {frame_name(i)}  {renderer.last_timings}"
            if args.timings:
                line += f"  {record_line(trace.records(1)[0])}"
            print(line)
    total = time.perf_counter() - t_start
    fps = len(trajectory) / total if total > 0 else 0.0
    say(json.dumps({"frames": len(trajectory), "seconds": round(total, 3),
                    "fps": round(fps, 2), "stage": args.stage, **extra}))
    return 0


def _render_ranks(args, scene, camera, trajectory, renderer, config, frame_name, write_depth,
                  outdir, say, rank):
    """The ``--tiles`` / ``--batch`` loops over the launcher's ranks (module
    doc); returns the closing line's extra fields, or None on a usage error."""
    import torch

    from rtnr_tpu_torch.parallel.collectives import gather_frames
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.utils.image import write_png

    dev = renderer.device
    pts, cols, validm = renderer.points, renderer.colors, renderer.valid
    n_frames = len(trajectory)
    cam_proj = lambda i: torch.from_numpy(
        camera.cam_proj(trajectory.world_to_cam(i)).astype(np.float32)).to(dev)
    host = lambda t: t.detach().cpu().numpy()
    if args.tiles > 1:
        mesh = make_mesh((args.tiles,), ("tiles",))
        if args.stage == "project":
            from rtnr_tpu_torch.ops.culling import build_block_index
            from rtnr_tpu_torch.parallel.tiles import rasterize_tile_sharded

            index = build_block_index(scene, pad_to_multiple=1024, device=dev)
            for i in range(n_frames):
                rgb, depth, cand = rasterize_tile_sharded(
                    pts, cols, validm, cam_proj(i), mesh, width=camera.width,
                    height=camera.height, depth_band=config.depth_band, block_index=index)
                if rank == 0:
                    write_png(outdir / frame_name(i), host(rgb))
                    if args.depth:
                        write_depth(frame_name(i), host(depth))
                say(f"[{i + 1}/{n_frames}] {frame_name(i)}  strip candidates: "
                    f"{host(cand).tolist()}")
        elif args.stage == "full":
            # the whole pipeline on strips: per-strip raster, halo-exchange
            # prefilter (core rows bit-exact), overlap-and-discard U-Net strips
            from rtnr_tpu_torch.parallel.tiles import render_full_tile_sharded
            from rtnr_tpu_torch.pipeline import pyramid_pad_shape

            levels = config.pyramid_levels
            hp, _ = pyramid_pad_shape(camera.height, camera.width, levels)
            lv = 1 << levels
            strip_lv = args.tiles * lv
            hp = -(-hp // strip_lv) * strip_lv  # strip-aligned pyramid pad
            strip_h = hp // args.tiles
            pollution = sum(2 ** (l + 1) for l in range(1, levels + 1))
            uh = min(32 - 32 % lv if lv <= 32 else 0, strip_h)
            halo = min(-(-(pollution + uh) // lv) * lv, strip_h)
            uh = max(min(uh, halo - pollution), 0)
            for i in range(n_frames):
                out = render_full_tile_sharded(
                    pts, cols, validm, cam_proj(i), mesh, renderer.unet, width=camera.width,
                    height=hp, depth_band=config.depth_band, levels=levels,
                    filter_strength=config.filter_strength,
                    gradient_filter=config.gradient_filter, halo=halo, unet_halo=uh,
                    act_scales=renderer.act_scales)
                if rank == 0:
                    write_png(outdir / frame_name(i),
                              host(out["rgb_unet"])[: camera.height, : camera.width])
                    if args.depth:
                        write_depth(frame_name(i),
                                    host(out["raw_depth"])[: camera.height, : camera.width])
                say(f"[{i + 1}/{n_frames}] {frame_name(i)} (tiles={args.tiles})")
        else:
            say("--tiles supports --stage project or full", file=sys.stderr)
            return None
        return {"tiles": args.tiles}

    # frames data-parallel over the ranks (the reference renders one frame at
    # a time, main.cpp:92-100)
    from rtnr_tpu_torch.parallel.render import render_filtered_sharded, render_full_batch

    dist = torch.distributed
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((n_dev, 1))
    bs = max(args.batch, n_dev)
    bs -= bs % n_dev  # divisible by the batch axis
    kw = dict(width=camera.width, height=camera.height, depth_band=config.depth_band,
              levels=config.pyramid_levels, filter_strength=config.filter_strength,
              gradient_filter=config.gradient_filter)
    for s0 in range(0, n_frames, bs):
        idxs = list(range(s0, min(s0 + bs, n_frames)))
        Ms = torch.stack([cam_proj(i) for i in idxs] + [cam_proj(idxs[-1])] * (bs - len(idxs)))
        if args.stage == "full":
            out = render_full_batch(pts, cols, validm, Ms, mesh, renderer.unet,
                                    act_scales=renderer.act_scales, **kw)
            rgb_key, depth_key = "rgb_unet", "depth"
        else:
            out = render_filtered_sharded(pts, cols, validm, Ms, mesh, **kw)
            rgb_key, depth_key = ("raw_rgb", "raw_depth") if args.stage == "project" else \
                ("rgb", "depth")
        rgbs = host(gather_frames(out[rgb_key], mesh))
        depths = host(gather_frames(out[depth_key], mesh)) if args.depth else None
        if rank == 0:
            for j, i in enumerate(idxs):
                write_png(outdir / frame_name(i), rgbs[j])
                if args.depth:
                    write_depth(frame_name(i), depths[j])
        say(f"[{idxs[-1] + 1}/{n_frames}] batch of {len(idxs)} frames over {n_dev} rank(s)")
    return {"batch": bs, "ranks": n_dev}


if __name__ == "__main__":
    sys.exit(main())
