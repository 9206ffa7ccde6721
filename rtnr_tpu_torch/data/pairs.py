"""Training-pair generation: ground-truth photos aligned with renders.

Counterpart of the JAX package's ``data/pairs.py`` (the reference's
``CloudReader::loadCubemaps``, cloudreader.cpp:219-254): for every (photo,
pose, intrinsics) triple, render the point cloud's depth and projected RGB
from the same pose with the port's ``Renderer`` on ``device`` (the card by
default; ``device="cpu"`` runs the kernels' plain twins), so the U-Net can
be trained against imperfectly aligned ground truth.

``generate_pairs_from_e57`` takes the photos embedded in a scanner ``.e57``
(container decoded by the port's host library, JPEG by its own decoder).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.scene import Scene


@dataclasses.dataclass
class TrainingPair:
    image: np.ndarray  # (H, W, 3) uint8 ground-truth photo
    depth: np.ndarray  # (H, W) float32 rendered depth (FLT_MAX empty)
    proj_rgb: np.ndarray  # (H, W, 3) uint8 projected point colors
    world_to_cam: np.ndarray  # (4, 4)
    camera: Camera


def generate_pairs(
    scene: Scene,
    images: Sequence[np.ndarray],
    world_to_cam: Sequence[np.ndarray],
    cameras: Sequence[Camera],
    device: str = "cuda",
) -> List[TrainingPair]:
    """Render aligned depth + projection for each posed ground-truth image
    (the loadCubemaps loop, cloudreader.cpp:235-252)."""
    from rtnr_tpu_torch.pipeline import Renderer

    renderer = Renderer(scene, device=device)
    pairs: List[TrainingPair] = []
    for img, w2c, cam in zip(images, world_to_cam, cameras):
        out = renderer.compute_rgbd(cam, w2c)
        pairs.append(TrainingPair(image=np.asarray(img), depth=out["depth"],
                                  proj_rgb=out["rgb"], world_to_cam=np.asarray(w2c),
                                  camera=cam))
    return pairs


def generate_pairs_from_e57(path, cache_dir=None, limit: Optional[int] = None,
                            device: str = "cuda") -> List[TrainingPair]:
    """Training pairs straight from a scanner ``.e57``: embedded posed
    photos + depth/projection renders from the same poses -- the full
    ``loadCubemaps`` pipeline (reference cloudreader.cpp:219-254) with the
    container decoded natively (``csrc/host/rtnr_e57.cpp``) and ``getImage``'s
    intrinsics/pose conventions (reference PointCloudReader.cpp:18-51)."""
    from rtnr_tpu_torch.data.e57 import E57Reader

    scene = Scene.from_file(path, cache_dir=cache_dir)
    images: List[np.ndarray] = []
    w2cs: List[np.ndarray] = []
    cameras: List[Camera] = []
    with E57Reader(path) as r:
        n = r.image_count if limit is None else min(limit, r.image_count)
        for i in range(n):
            img, w2c, K = r.get_image(i)
            h, w = img.shape[:2]
            images.append(img)
            w2cs.append(w2c)
            # E57 pinhole images carry no distortion model; 5 explicit zeros
            # keep the calibration-file round trip valid (camera.py parser)
            cameras.append(Camera(K=K, width=w, height=h, dists=(0.0,) * 5))
    return generate_pairs(scene, images, w2cs, cameras, device=device)


def batches_for_training(
    pairs: Sequence[TrainingPair],
    batch_size: int,
    shuffle_seed: Optional[int] = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (cam_projs (B,4,4) f32, targets (B,H,W,3) f32 in [0,1]) batches
    for ``train.trainer.make_train_step``; drops the ragged tail, as the JAX
    package does."""
    n = len(pairs)
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    for s in range(0, n - batch_size + 1, batch_size):
        sel = order[s: s + batch_size]
        projs = np.stack([pairs[i].camera.cam_proj(pairs[i].world_to_cam)
                          for i in sel]).astype(np.float32)
        targets = np.stack([pairs[i].image for i in sel]).astype(np.float32) / 255.0
        yield projs, targets


def synthetic_pairs(
    scene: Scene,
    camera: Camera,
    n: int = 8,
    seed: int = 0,
    base_distance: float = 10.0,
    device: str = "cuda",
) -> List[TrainingPair]:
    """Self-supervised pairs for tests and smoke training: the 'ground
    truth' image is the scene's own projection from a jittered pose."""
    from rtnr_tpu_torch.pipeline import Renderer

    rng = np.random.default_rng(seed)
    renderer = Renderer(scene, device=device)
    pairs = []
    for _ in range(n):
        E = np.eye(4)
        E[0, 3] = rng.uniform(-0.5, 0.5)
        E[1, 3] = rng.uniform(-0.5, 0.5)
        E[2, 3] = base_distance + rng.uniform(-1.0, 1.0)
        out = renderer.compute_rgbd(camera, E)
        pairs.append(TrainingPair(image=out["rgb"], depth=out["depth"], proj_rgb=out["rgb"],
                                  world_to_cam=E, camera=camera))
    return pairs
