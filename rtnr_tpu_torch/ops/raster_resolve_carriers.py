"""Carrier-stream raster resolve: one kernel for the TPU's v1, v2 and v3.

Counterpart of ``rtnr_tpu/ops/raster_pallas.py`` (``_resolve_kernel``, K9),
``raster_pallas2.py`` (``_resolve_kernel2``, K8) and ``raster_pallas3.py``
(``_resolve_kernel3``, K7). The three TPU kernels compute one function, the
contract of ``raster.raster_images``, and differ only in how they tile,
scan and place on the TPU (``tests/test_foils.py`` holds all three bit for
bit against that one function). On the card they are one kernel,
``rtnr_resolve_carriers`` in ``csrc/raster_resolve.cu``, and
``raster_images_v1`` / ``_v2`` / ``_v3`` are names for it.

Input: the carrier stream sorted by (pixel id, depth bits)
(``project_and_sort(..., carriers=True)``), in which every pixel owns a
segment. Output: dense (sums (HW,3) i32, count (HW,) i32, depth (HW,) f32);
the winner of pixel k is written at column k, so no rank and no expansion
pass run. An empty pixel's head is its carrier: depth FLT_MAX, count 0.

``resolve_carriers`` launches the kernel for CUDA tensors and runs the
plain twin ``resolve_carriers_plain`` (``raster.raster_images``) only for
CPU tensors; ``resolve_carriers.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from rtnr_tpu_torch import _build
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops.raster import SortedPoints, raster_images


def resolve_carriers_plain(sp: SortedPoints, hw: int, depth_band: float):
    """Plain torch twin of the carrier kernel: ``raster.raster_images``."""
    return raster_images(sp, hw, depth_band)


def resolve_carriers(sp: SortedPoints, hw: int, depth_band: float):
    """K7-K9: dense (sums, count, depth) images of a (pixel, depth)-sorted
    carrier stream."""
    rr._check_stream(sp)
    dev = sp.pix.device
    if dev.type == "cpu":
        return resolve_carriers_plain(sp, hw, depth_band)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    sums = torch.empty((hw, 3), dtype=torch.int32, device=dev)
    count = torch.empty((hw,), dtype=torch.int32, device=dev)
    depth = torch.empty((hw,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = rr._lib().rtnr_resolve_carriers(
        sp.pix.data_ptr(), sp.zbits.data_ptr(), sp.packed.data_ptr(), sp.pix.numel(), hw,
        float(depth_band), sums.data_ptr(), count.data_ptr(), depth.data_ptr(), stream,
    )
    _build.check(rc, "rtnr_resolve_carriers")
    resolve_carriers.launches += 1
    return sums, count, depth


resolve_carriers.launches = 0

# the TPU's three carrier resolvers (K9, K8, K7) are one function here
raster_images_v1 = raster_images_v2 = raster_images_v3 = resolve_carriers
