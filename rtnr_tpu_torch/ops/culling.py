"""Frustum culling on the voxel block grid (plain torch).

Counterpart of ``rtnr_tpu/ops/culling.py:34-155``; no TPU kernel lies here.
The reference builds its 0.25 m block grid but never culls with it. Here,
per view, each block's box is tested against the view frustum and the
points of invisible blocks are masked out or compacted into a fixed-size
budget buffer, which shrinks the per-frame sort.

``compact_points`` is a stable compaction (a cumsum rank and one scatter),
not the TPU's placement sort: kept points keep their order and every slot
past the kept count is zero and invalid. Each kept point's slot is its rank
in both, so the kept rows equal the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rtnr_tpu_torch.scene import Scene


class BlockIndex(NamedTuple):
    """Per-scene block table for culling on the device."""

    corners: torch.Tensor  # (B, 8, 3) f32 block box corners
    corner_signs: torch.Tensor  # (B, 8, 3) f32 +-1 outward direction per corner
    point_block: torch.Tensor  # (N',) int64 block of each point (padding: block 0)


def build_block_index(scene: Scene, pad_to_multiple: int = 8, device=None) -> BlockIndex:
    """Block corner table and each point's block, in the point order of
    ``scene.sorted_by_block().device_arrays(pad_to_multiple)``."""
    s = scene.sorted_by_block()
    uniq, inv = np.unique(s.block_keys, return_inverse=True)
    lo, hi = s.block_bounds(uniq)
    B = uniq.shape[0]
    corners = np.empty((B, 8, 3), np.float32)
    signs = np.empty((B, 8, 3), np.float32)
    for c in range(8):
        for a in range(3):
            sel = (c >> a) & 1
            corners[:, c, a] = hi[:, a] if sel else lo[:, a]
            signs[:, c, a] = 1.0 if sel else -1.0
    n_pad = (-s.n_points) % pad_to_multiple
    point_block = np.concatenate([inv.reshape(-1), np.zeros(n_pad, np.int64)])
    return BlockIndex(
        corners=torch.from_numpy(corners).to(device),
        corner_signs=torch.from_numpy(signs).to(device),
        point_block=torch.from_numpy(point_block.astype(np.int64)).to(device),
    )


def visible_blocks(corners: torch.Tensor, cam_proj: torch.Tensor, width: int, height: int,
                   margin: float = 1.0) -> torch.Tensor:
    """(B,) bool: the block may intersect the view frustum.

    A block is visible unless all 8 corners are behind the camera, or all
    lie in front and beyond one image border (a conservative separating-
    plane test in projective space; ``margin`` in pixels absorbs splat
    rounding). The border constants are f32, as in the JAX package."""
    M = cam_proj.to(torch.float32)
    r = corners @ M[:3, :3].T + M[:3, 3]  # (B, 8, 3)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    eps = 1e-9
    m = np.float32(margin)
    lo_b = float(np.float32(0.0) - m)
    hi_x = float(np.float32(width - 1) + m)
    hi_y = float(np.float32(height - 1) + m)
    front = z > 0.0
    all_behind = torch.all(z <= 0.0, dim=1)

    def sep(cond):
        return torch.all(cond & front, dim=1)

    separated = (sep(x < lo_b * z - eps) | sep(x > hi_x * z + eps)
                 | sep(y < lo_b * z - eps) | sep(y > hi_y * z + eps))
    return ~(all_behind | separated)


def cull_points(index: BlockIndex, cam_proj: torch.Tensor, valid: torch.Tensor, *,
                width: int, height: int, margin: float = 1.0,
                inflate_m: float = 0.0) -> torch.Tensor:
    """Per-point visibility mask for this frame (AND the scene's validity).

    ``inflate_m`` grows every block box outward by that many meters before
    the test, so a camera whose center stays within ``inflate_m`` of this
    pose sees only blocks of the inflated visible set: the Renderer reuses a
    compaction across nearby frames on that ground."""
    corners = index.corners + float(np.float32(inflate_m)) * index.corner_signs
    vis = visible_blocks(corners, cam_proj, width, height, margin=margin)
    return valid & vis[index.point_block]


def compact_points(points: torch.Tensor, colors: torch.Tensor, keep: torch.Tensor,
                   budget: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kept points, in order, in a ``budget``-row buffer: (points, colors,
    valid). Kept points past the budget are dropped (callers size the
    budget, and the Renderer falls back to the full cloud rather than drop
    any); unused rows are zero and invalid. No host synchronisation."""
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < budget), rank, torch.full_like(rank, budget))
    out_pts = torch.zeros((budget + 1, points.shape[1]), dtype=points.dtype, device=points.device)
    out_cols = torch.zeros((budget + 1, colors.shape[1]), dtype=colors.dtype, device=colors.device)
    # every dropped point lands on the spill row ``budget``, cut off below
    out_pts.index_copy_(0, slot, points)
    out_cols.index_copy_(0, slot, colors)
    n_kept = torch.clamp_max(keep.sum(), budget)
    valid = torch.arange(budget, device=keep.device) < n_kept
    return out_pts[:budget], out_cols[:budget], valid
