"""Counterpart of ``rtnr_tpu/ops/raster_partitioned.py``.

``raster_images_partitioned`` has the contract of ``raster.raster_images``
(dense sums, count and depth of a (pixel, depth)-sorted carrier stream) and
is that function. The JAX package's two-level partitioning (per-part scans
stitched by tiny carry scans, per-part placement sorts, a sequential
``fori_loop`` of slice updates) works around XLA's full-array scans and
global placement sort on a TPU; the port's ``raster_images`` is one gather,
one cumulative sum and one scatter, so the workaround is not carried over.
"""

from __future__ import annotations

from rtnr_tpu_torch.ops.raster import SortedPoints, raster_images


def raster_images_partitioned(sp: SortedPoints, hw: int, depth_band: float):
    """Dense (sums (HW,3) int32, count (HW,) int32, depth (HW,) f32) of a
    carrier stream: ``raster.raster_images``."""
    return raster_images(sp, hw, depth_band)
