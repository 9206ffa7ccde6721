"""CLI: extract training pairs from a scanner .e57 file.

    python -m rtnr_tpu_torch.apps.generate_pairs <scan.e57> -o pairs --cache-dir cache

The port's counterpart of the JAX package's ``apps/generate_pairs.py``,
with the same parser, files and exit codes. The reference's training data
comes from ``CloudReader::loadCubemaps`` (reference cloudreader.cpp:219-254):
each photo embedded in the scanner file, its pose/intrinsics (``getImage``,
PointCloudReader.cpp:18-51), and a depth/projection render of the cloud
from that pose (``Renderer.compute_rgbd`` on the card). The CLI writes what
``apps/train_unet.py`` consumes:

    out/
      frame_1.png ... frame_N.png    ground-truth photos
      depth_1.npz ...                rendered depth + projected RGB
      traj.txt                       TUM-format poses (cam-to-world)
      calib.txt                      calibration (first image's intrinsics)

so ``train_unet cloud.e57 out/traj.txt out/calib.txt --targets out/`` runs
end to end from a single scanner file. It renders on the card (``main``'s
``device`` is for tests; from the shell it raises without one).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> tuple:
    """3x3 rotation -> (qw, qx, qy, qz), w >= 0 (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw, qx, qy, qz = 0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw, qx, qy, qz = (R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw, qx, qy, qz = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw, qx, qy, qz = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s
    if qw < 0:
        qw, qx, qy, qz = -qw, -qx, -qy, -qz
    return qw, qx, qy, qz


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="generate_pairs")
    p.add_argument("cloud", help=".e57 file with embedded posed images")
    p.add_argument("-o", "--output", default="pairs", help="output directory")
    p.add_argument("--cache-dir", default=None, help="scene cache directory")
    p.add_argument("--limit", type=int, default=None, help="max images to extract")
    p.add_argument("--no-depth", action="store_true", help="skip depth/projection renders")
    return p


def main(argv=None, device: str = "cuda") -> int:
    """Run the CLI; ``device`` is for tests (the command line always renders
    on the card, and raises without one)."""
    args = build_parser().parse_args(argv)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)

    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.data.e57 import E57Reader
    from rtnr_tpu_torch.data.pairs import TrainingPair, generate_pairs_from_e57
    from rtnr_tpu_torch.utils.image import write_png

    path = Path(args.cloud)
    if path.suffix.lower() != ".e57":
        print("generate-pairs requires an .e57 file with embedded images", file=sys.stderr)
        return 1

    if args.no_depth:
        pairs = []
        with E57Reader(path) as r:
            n = r.image_count if args.limit is None else min(args.limit, r.image_count)
            for i in range(n):
                img, w2c, K = r.get_image(i)
                cam = Camera(K=K, width=img.shape[1], height=img.shape[0], dists=(0.0,) * 5)
                pairs.append(TrainingPair(image=img, depth=None, proj_rgb=None,
                                          world_to_cam=w2c, camera=cam))
    else:
        pairs = generate_pairs_from_e57(path, cache_dir=args.cache_dir, limit=args.limit,
                                        device=device)

    if not pairs:
        print("No embedded images found in the file", file=sys.stderr)
        return 1

    traj_lines = []
    for i, pr in enumerate(pairs):
        write_png(out / f"frame_{i + 1}.png", pr.image)
        if pr.depth is not None:
            np.savez_compressed(
                out / f"depth_{i + 1}.npz", depth=pr.depth, proj_rgb=pr.proj_rgb,
                world_to_cam=pr.world_to_cam, K=pr.camera.K,
            )
        cam_to_world = np.linalg.inv(pr.world_to_cam)
        qw, qx, qy, qz = (float(v) for v in rotmat_to_quat(cam_to_world[:3, :3]))
        tx, ty, tz = (float(v) for v in cam_to_world[:3, 3])
        # TUM order (timestamp tx ty tz qx qy qz qw) -- what train_unet loads
        traj_lines.append(f"{i}.0 {tx!r} {ty!r} {tz!r} {qx!r} {qy!r} {qz!r} {qw!r}")
    (out / "traj.txt").write_text("\n".join(traj_lines) + "\n")
    pairs[0].camera.save_calibration(out / "calib.txt")
    print(json.dumps({"pairs": len(pairs), "output": str(out),
                      "resolution": [pairs[0].camera.width, pairs[0].camera.height]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
