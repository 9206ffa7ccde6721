"""CLI: fine-tune the refinement U-Net with the rasterizer in the loop.

    python -m rtnr_tpu_torch.apps.train_unet <cloud.ply|.e57> <traj.txt> <calib.txt> \
        --self-supervised --steps 150 --lr 2e-4 -o unet.msgpack

The port's counterpart of ``rtnr_tpu/apps/train_unet.py``, with the same
parser, JSON log lines (``step``, ``loss``, ``grad_norm``, ``sec``) and
checkpoint: pairs of (posed target image, live raster + prefilter render)
drive an L1 loss on the bf16 U-Net's output, one Adam step a batch of
frames, frames drawn with ``np.random.default_rng(0).choice``. Targets are
PNGs (``--targets DIR``: the trajectory entry's file name, else
``frame_<i>.png``) or the scene's own projections (``--self-supervised``).
``-o`` writes ``{"params", "batch_stats"}`` as a flax msgpack file, which
both packages' ``load_unet_variables`` read.

It trains on the card (``main``'s ``device``, for tests; from the shell
always the card, and it raises without one). Under a launcher
(``torchrun --nproc-per-node N -m rtnr_tpu_torch.apps.train_unet ...``) it
trains on N ranks, as the JAX CLI on N devices: the batch is
``--batch`` (0: N) rounded down to a multiple of N (at least N), every rank
draws the same frames and trains on its N-th of them
(``train.trainer.make_train_step(mesh=...)`` on a (N, 1) mesh: global-batch
BatchNorm, gradients summed over the ranks, parameters equal on every
rank), and rank 0 logs and writes the checkpoint. On one rank ``--batch N``
stacks N frames into one step.
Without ``--init-ckpt`` the net starts from ``init_unet_numpy(0)`` (seeded
He-normal weights), not from JAX's ``init_unet``: the two initializers give
different weights.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train_unet")
    p.add_argument("cloud", help=".ply/.e57 cloud or cache dir")
    p.add_argument("trajectory")
    p.add_argument("calibration")
    p.add_argument("--targets", default=None, help="directory of target PNGs (frame_<i>.png)")
    p.add_argument("--self-supervised", action="store_true",
                   help="use the scene's own projections as targets (smoke training)")
    p.add_argument("--init-ckpt", default=None, help="initial U-Net weights (.pth/.msgpack)")
    p.add_argument("-o", "--output", default="unet_ckpt.msgpack")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=0, help="frames per step (0 = one per device)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--features", type=int, nargs="+", default=[64, 128, 256, 512])
    p.add_argument("--log-every", type=int, default=10)
    return p


def main(argv=None, device: str = "cuda") -> int:
    """Run the CLI; ``device`` is for tests (the command line always trains
    on the card, and raises without one)."""
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.models.convert import init_unet_numpy, to_flax_variables
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train.trainer import create_train_state, make_train_step
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables, save_msgpack
    from rtnr_tpu_torch.utils.image import read_png

    camera = Camera.load_calibration(args.calibration)
    trajectory = Trajectory.load(args.trajectory)
    cloud_path = Path(args.cloud)
    scene = (
        Scene.load_cache(cloud_path) if cloud_path.is_dir() else Scene.from_file(cloud_path)
    )
    if scene is None:
        print("No scene found", file=sys.stderr)
        return 1

    mesh, rank = None, 0
    if "WORLD_SIZE" in os.environ:
        from rtnr_tpu_torch.parallel.mesh import init_distributed, make_mesh

        device = init_distributed(device)
        rank = dist.get_rank()
        if dist.get_world_size() > 1:
            mesh = make_mesh((dist.get_world_size(), 1))
    n_dev = 1 if mesh is None else mesh.world
    batch = args.batch or n_dev
    batch -= batch % n_dev or 0
    batch = max(batch, n_dev)

    features = tuple(args.features)
    if args.init_ckpt:
        variables = load_unet_variables(args.init_ckpt, features)
    else:
        variables = init_unet_numpy(0, features)
    state = create_train_state(variables, features=features, dtype=torch.bfloat16,
                               learning_rate=args.lr, device=device)
    step_fn = make_train_step(width=camera.width, height=camera.height, mesh=mesh)
    dev = next(state.model.parameters()).device

    pts, cols, valid = scene.sorted_by_block().device_arrays(8 * n_dev)
    points, colors, validd = (torch.from_numpy(a).to(dev) for a in (pts, cols, valid))

    # assemble the (cam_proj, target) pools
    projs, targets = [], []
    for i in range(len(trajectory)):
        projs.append(camera.cam_proj(trajectory.world_to_cam(i)).astype(np.float32))
        if args.targets:
            f = Path(args.targets) / trajectory[i].filename
            if not f.exists():
                f = Path(args.targets) / f"frame_{i + 1}.png"
            targets.append(read_png(f).astype(np.float32) / 255.0)
    if args.self_supervised:
        from rtnr_tpu_torch.pipeline import Renderer

        r = Renderer(scene, device=device)
        targets = [
            r.compute_rgbd(camera, trajectory.world_to_cam(i))["rgb"].astype(np.float32) / 255.0
            for i in range(len(trajectory))
        ]
    if not targets:
        print("No targets: pass --targets DIR or --self-supervised", file=sys.stderr)
        return 1

    projs = np.stack(projs)
    targets = np.stack(targets)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    for step in range(args.steps):
        sel = rng.choice(len(projs), size=batch, replace=len(projs) < batch)
        state, metrics = step_fn(state, points, colors, validd,
                                 torch.from_numpy(projs[sel]).to(dev),
                                 torch.from_numpy(targets[sel]).to(dev))
        if (step % args.log_every == 0 or step == args.steps - 1) and rank == 0:
            print(json.dumps({"step": step, "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"]),
                              "sec": round(time.perf_counter() - t0, 1)}), flush=True)

    if rank == 0:
        save_msgpack(args.output, to_flax_variables(state.model))
        print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
