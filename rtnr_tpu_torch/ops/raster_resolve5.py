"""Pixel-only-sorted raster resolve (``RTNR_RESOLVE=v5``): K6 and K2 as one
tile kernel, and K6 alone.

Counterpart of ``rtnr_tpu/ops/raster_pallas5.py``: ``raster_images_pallas5``
(segment-min winners ``_winners_kernel5``, then ``expand_winners``) becomes
``raster_images_v5``. The input is the carrier-free stream sorted by pixel
id alone (``project_and_sort(..., depth_key=False)``), so depth order inside
a pixel segment is arbitrary; the per-pixel minimum and the 2 cm band
against it are order-free. On the card ``raster_images_v5`` is ONE kernel,
``rtnr_resolve5`` in ``csrc/raster_resolve.cu``: the tile skeleton of
``rtnr_resolve4`` (512-pixel tiles find their window of the sorted stream
with a warp's search), whose two passes over the window take each pixel's
minimum depth with shared-memory ``atomicMin`` and then add its in-band
elements. No winner image, no rank and no scan; a segment of any length is
exact. Its twin is K6's twin, then K2's; its images equal
``raster_images_v4``'s on the same points.

``winners5`` (``rtnr_winners5``) is K6 alone, off every path since the tile
kernel: it writes the intermediate contract that K1 writes (see
``raster_resolve4``), a (6, cap) winner image of per-pixel totals, the
minimum depth bits and the pixel id at column = winner rank, and the winner
total on the device (the TPU kernel writes inclusive prefix sums instead),
so K2 (``expand_winners``) expands it unchanged. The TPU kernel's one-part
lookback, its overflow flag and the re-sort fallback
(``raster_pallas5.py:547-572``) have no counterpart in either kernel.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
only for CPU tensors; ``raster_images_v5.launches`` and
``winners5.launches`` count kernel launches.
"""

from __future__ import annotations

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


def raster_images_v5_plain(sp: SortedPoints, hw: int, depth_band: float,
                           packed_out: bool = False):
    """Plain torch twin of ``rtnr_resolve5``: K6's twin, then K2's."""
    wimg, total = winners5_plain(sp, hw, depth_band)
    return rr.expand_plain(wimg, total, hw, packed_out)


def raster_images_v5(sp: SortedPoints, hw: int, depth_band: float, packed_out: bool = False):
    """Dense images from a carrier-free, pixel-only-sorted stream, with the
    contract of ``raster_images_v4``: (sums (HW,3) i32, count (HW,) i32,
    depth (HW,) f32), or with ``packed_out`` (packed rgb (HW,) i32, depth).
    On the card: one launch of ``rtnr_resolve5``; for CPU tensors the plain
    twin."""
    rr._check_stream(sp)
    if sp.pix.device.type == "cpu":
        return raster_images_v5_plain(sp, hw, depth_band, packed_out)
    if sp.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sp.pix.device}")
    out = rr._launch_tile_resolve("rtnr_resolve5", sp, hw, depth_band, packed_out)
    raster_images_v5.launches += 1
    return out


raster_images_v5.launches = 0
