"""Pixel-only-sorted raster resolve: segmented-min winners (K6), then K2.

Counterpart of ``rtnr_tpu/ops/raster_pallas5.py`` (``RTNR_RESOLVE=v5``):
``raster_images_pallas5`` becomes ``raster_images_v5``. The input is the
carrier-free stream sorted by pixel id alone (``project_and_sort(...,
depth_key=False)``), so depth order inside a pixel segment is arbitrary;
the per-pixel minimum and the 2 cm band against it are order-free. The
CUDA kernel is ``rtnr_winners5`` in ``csrc/raster_resolve.cu``.

``winners5`` writes the intermediate contract that K1 writes (see
``raster_resolve4``): a (6, cap) winner image of per-pixel totals, the
minimum depth bits and the pixel id at column = winner rank, and the
winner total on the device; the TPU kernel writes inclusive prefix sums
instead. So K2 (``expand_winners``) runs unchanged after it.

The TPU kernel's one-part lookback, its overflow flag and the re-sort
fallback (``raster_pallas5.py:547-572``) have no counterpart: one thread
walks a whole segment, whatever its length.

``winners5`` launches the kernel for CUDA tensors and runs the plain twin
``winners5_plain`` only for CPU tensors; ``winners5.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops.raster import SortedPoints


def winners5_plain(sp: SortedPoints, hw: int, depth_band: float):
    """Plain torch twin of K6: same (wimg, total) contract."""
    return rr.winners_plain(sp, hw, depth_band, seg_min=True)


def winners5(sp: SortedPoints, hw: int, depth_band: float):
    """K6: winner rows of the pixel-sorted carrier-free stream -> (wimg,
    total), each pixel's band taken against its segment minimum."""
    rr._check_stream(sp)
    if sp.pix.device.type == "cpu":
        return winners5_plain(sp, hw, depth_band)
    if sp.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sp.pix.device}")
    out = rr._launch_winners("rtnr_winners5", sp.pix, sp.zbits, sp.packed, hw, depth_band)
    winners5.launches += 1
    return out


winners5.launches = 0


def raster_images_v5(sp: SortedPoints, hw: int, depth_band: float, packed_out: bool = False):
    """Dense images from a carrier-free, pixel-only-sorted stream, with the
    contract of ``raster_images_v4``: (sums (HW,3) i32, count (HW,) i32,
    depth (HW,) f32), or with ``packed_out`` (packed rgb (HW,) i32, depth)."""
    wimg, total = winners5(sp, hw, depth_band)
    return rr.expand_winners(wimg, total, hw, packed_out=packed_out)
