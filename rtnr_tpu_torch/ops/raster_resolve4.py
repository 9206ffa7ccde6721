"""Carrier-free raster resolve: the v4 resolve (K1 + K2 in one kernel), the
differentiable forward's resolve (K5 + K2 ``float_sums`` in one kernel),
winners (K1), float winners (K5) and expansion (K2).

Counterpart of ``rtnr_tpu/ops/raster_pallas4.py``: ``raster_images_pallas4``
becomes ``raster_images_v4``, which on the card is ONE kernel
(``rtnr_resolve4``: each block owns a tile of output pixels, finds its
window of the sorted stream with two searches and resolves it in shared
memory; no winner image, no ranks); the differentiable forward's
``compact_rows_by_rank`` (K5), the prefix sums and ranks before it and the
``float_sums`` expansion after it become ``raster_images_diff``, also ONE
kernel on the card (``rtnr_resolve_diff``: the same tiles, each pixel's
segment head walking its band in f64 into the tile, bit for bit what K5 +
K2 give); ``expand_winners`` keeps its name; ``winners_f32`` is K5 alone.
The CUDA kernels are in ``csrc/raster_resolve.cu`` (its header notes what
each replaces, its bound and its design); ``_lib`` loads and binds that
library for this module, ``raster_resolve5`` and ``raster_resolve_carriers``.

Intermediate contract of the standalone kernels (``winners``, ``winners_f32``
and ``raster_resolve5.winners5``, kept for their tests and the per-kernel
table of ``chip_smoke.py``): a winner image ``wimg`` (6, cap)
int32, rows (r sum, g sum, b sum, count, head depth bits, pixel id), one
column per winner (= pixel with at least one point) in pixel order, and the
winner total as a (1,) int32 tensor that stays on the device. ``winners``
writes integer sums; ``winners_f32`` writes f32 bit patterns, which
``expand_winners(..., float_sums=True)`` returns as f32 images.
``expand_winners`` runs the tile kernel.

Each wrapper launches its kernel for CUDA tensors and runs its plain torch
twin only for CPU tensors. ``raster_images_v4.launches`` /
``raster_images_diff.launches`` (and both wrappers' ``band_ref_launches``,
their band-reference form) / ``winners.launches`` /
``winners_f32.launches`` / ``expand_winners.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from rtnr_tpu_torch import _build
from rtnr_tpu_torch.ops.raster import SortedDiff, SortedPoints

_FLT_MAX_BITS = 0x7F7FFFFF
_WIN_BLOCK = 1024  # elements per block of the winners kernels (csrc)
# the tile skeleton of rtnr_resolve4 / rtnr_expand (csrc TILE_P, TILE_ELEMS,
# TILE_CHUNK, TILES_PER_BLOCK): output pixels a tile owns, stream elements a
# thread holds, stream elements a block works per step, tiles a block resolves
TILE_P = 512
TILE_ELEMS = 4
TILE_CHUNK = 512
TILES_PER_BLOCK = 3

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of every entry of ``csrc/raster_resolve.cu`` (the v4
    and v5 resolves, K6 and the carrier kernel included: ``_build.load``
    binds a library once)."""
    for fn in (lib.rtnr_winners, lib.rtnr_winners_f32, lib.rtnr_winners5):
        fn.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _P, _P, _I, _P, _P]
        fn.restype = _I
    lib.rtnr_expand.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _P]
    lib.rtnr_resolve_carriers.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _P, _P, _P, _P]
    lib.rtnr_resolve5.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P, _P]
    # rtnr_resolve4 and rtnr_resolve_diff take a band reference image (or NULL)
    # before the stream
    lib.rtnr_resolve4.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P, _P,
                                  _P]
    lib.rtnr_resolve_diff.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P,
                                      _P]
    for fn in (lib.rtnr_expand, lib.rtnr_resolve_carriers, lib.rtnr_resolve4, lib.rtnr_resolve5,
               lib.rtnr_resolve_diff):
        fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load("raster_resolve", _bind)


def _check_stream(sp: SortedPoints) -> None:
    for t in sp:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("sorted stream must be contiguous 1-D int32 tensors")
    if not (sp.pix.device == sp.zbits.device == sp.packed.device):
        raise ValueError("sorted stream tensors must share a device")


def _winner_rows(pix, zbits, hw, depth_band, lanes: torch.Tensor, acc_dtype, out_bits,
                 seg_min: bool = False, band_ref=None):
    """Shared twin body: heads, band membership (``!(z > z_ref + band)``)
    and per-segment in-band sums of the four ``lanes`` (4, n) in
    ``acc_dtype``, turned to int32 rows by ``out_bits``. ``z_ref`` is the
    head's depth, or with ``seg_min`` (K6, any order inside a segment) the
    segment's minimum, or with ``band_ref`` (a (hw,) f32 image) that image at
    the element's pixel; row 4 holds the head's depth (the minimum with
    ``seg_min``)."""
    n = pix.numel()
    dev = pix.device
    cap = max(min(n, hw), 1)
    ok = pix < hw
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), pix[:-1]])
    head = ok & (pix != prev)
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    total = int(head.sum())
    if seg_min:
        # positive depths (and +inf) order as their int32 bit patterns
        zmin = torch.full((cap,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
        zmin.scatter_reduce_(0, seg[ok], zbits[ok], "amin")
        zref, zhead = zmin[seg.clamp(min=0)], zmin[:total]
    else:
        idx = torch.arange(n, device=dev)
        head_pos = torch.cummax(torch.where(head, idx, torch.zeros_like(idx)), dim=0).values
        zref, zhead = zbits[head_pos], zbits[head]
    zref = zref.view(torch.float32)
    if band_ref is not None:
        zref = band_ref[torch.clamp(pix, max=max(hw - 1, 0)).to(torch.int64)]
    lim = zref + torch.tensor(depth_band, dtype=torch.float32, device=dev)
    in_band = ok & ~(zbits.view(torch.float32) > lim)
    wimg = torch.zeros((6, cap), dtype=torch.int32, device=dev)
    acc = torch.zeros((4, cap), dtype=acc_dtype, device=dev)
    acc.index_add_(1, seg[in_band], lanes[:, in_band].to(acc_dtype))
    wimg[:4] = out_bits(acc)
    wimg[4, :total] = zhead
    wimg[5, :total] = pix[head]
    return wimg, torch.tensor([total], dtype=torch.int32, device=dev)


def _launch_winners(fn: str, pix, zbits, payload, hw: int, depth_band: float):
    """Run the C entry ``fn`` (rtnr_winners or rtnr_winners_f32) on CUDA
    tensors; returns (wimg, total)."""
    n = pix.numel()
    dev = pix.device
    cap = max(min(n, hw), 1)
    nb = -(-n // _WIN_BLOCK)
    scratch = torch.empty((2 * max(nb, 1),), dtype=torch.int32, device=dev)
    wimg = torch.empty((6, cap), dtype=torch.int32, device=dev)
    total = torch.empty((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), fn)(
        pix.data_ptr(), zbits.data_ptr(), payload.data_ptr(), n, hw, float(depth_band),
        scratch.data_ptr(), wimg.data_ptr(), cap, total.data_ptr(), stream,
    )
    _build.check(rc, fn)
    return wimg, total


def winners_plain(sp: SortedPoints, hw: int, depth_band: float, seg_min: bool = False,
                  band_ref=None):
    """Plain torch twin of K1 (with ``seg_min``, of K6; with ``band_ref``, of
    the band-reference form): same (wimg, total) contract."""
    pix, zbits, packed = sp
    lanes = torch.stack([packed & 255, (packed >> 8) & 255, (packed >> 16) & 255,
                         torch.ones_like(packed)], 0)
    return _winner_rows(pix, zbits, hw, depth_band, lanes, torch.int64,
                        lambda acc: acc.to(torch.int32), seg_min, band_ref)


def winners(sp: SortedPoints, hw: int, depth_band: float):
    """K1: winner rows of the (pixel, depth)-sorted stream -> (wimg, total).
    Launches the CUDA kernel for CUDA tensors; the plain twin for CPU."""
    _check_stream(sp)
    if sp.pix.device.type == "cpu":
        return winners_plain(sp, hw, depth_band)
    if sp.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sp.pix.device}")
    out = _launch_winners("rtnr_winners", sp.pix, sp.zbits, sp.packed, hw, depth_band)
    winners.launches += 1
    return out


winners.launches = 0


def _check_diff_stream(sd: SortedDiff) -> None:
    for t in (sd.pix, sd.zbits):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("pix and zbits must be contiguous 1-D int32 tensors")
    n = sd.pix.numel()
    if sd.rgb.dtype != torch.float32 or tuple(sd.rgb.shape) != (n, 3) or \
            not sd.rgb.is_contiguous():
        raise ValueError("rgb must be a contiguous (N, 3) float32 tensor")
    if not (sd.pix.device == sd.zbits.device == sd.rgb.device):
        raise ValueError("sorted stream tensors must share a device")


def winners_f32_plain(sd: SortedDiff, hw: int, depth_band: float, band_ref=None):
    """Plain torch twin of K5: per-pixel in-band sums of the f32 colours and
    the count, accumulated in f64 (``index_add_``) and rounded once to f32,
    stored as bit patterns. On the CPU ``index_add_`` adds in stream order,
    as the kernel does; on the card it adds with atomics, in any order, which
    can only move an f64 sum's last bits (integer colours stay exact).
    ``band_ref``: the band ends at that (hw,) f32 image's value + band."""
    lanes = torch.cat([sd.rgb.t(), torch.ones_like(sd.rgb[:, :1]).t()], 0)
    return _winner_rows(sd.pix, sd.zbits, hw, depth_band, lanes, torch.float64,
                        lambda acc: acc.to(torch.float32).view(torch.int32),
                        band_ref=band_ref)


def winners_f32(sd: SortedDiff, hw: int, depth_band: float):
    """K5: float winner rows of the differentiable forward's sorted stream ->
    (wimg, total), rows 0-3 f32 bit patterns of per-pixel totals (no prefix
    sums, nothing to subtract). Launches the CUDA kernel for CUDA tensors;
    the plain twin for CPU."""
    _check_diff_stream(sd)
    if sd.pix.device.type == "cpu":
        return winners_f32_plain(sd, hw, depth_band)
    if sd.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sd.pix.device}")
    out = _launch_winners("rtnr_winners_f32", sd.pix, sd.zbits, sd.rgb, hw, depth_band)
    winners_f32.launches += 1
    return out


winners_f32.launches = 0


def raster_images_diff_plain(sd: SortedDiff, hw: int, depth_band: float, band_ref=None):
    """Plain torch twin of ``rtnr_resolve_diff`` (and of its band-reference
    form): K5's twin, then K2's ``float_sums`` twin."""
    wimg, total = winners_f32_plain(sd, hw, depth_band, band_ref)
    return expand_plain(wimg, total, hw, False, float_sums=True)


def raster_images_diff(sd: SortedDiff, hw: int, depth_band: float, band_ref=None):
    """The differentiable forward's dense images from its (pixel,
    depth)-sorted stream: (sums (HW,3) f32, count (HW,) f32, depth (HW,)
    f32), what ``expand_winners(*winners_f32(sd, hw, band), hw,
    float_sums=True)`` returns. On the card: one launch of
    ``rtnr_resolve_diff`` (no winner image); for CPU tensors the plain
    twin.

    ``band_ref`` (a (hw,) f32 image, e.g. the z-buffer merged over point
    shards): each pixel's band ends at ``band_ref + band`` instead of its
    head's depth + band; the depth output is still the head's depth.
    ``raster_images_diff.band_ref_launches`` counts that form's launches
    (``launches`` counts both)."""
    _check_diff_stream(sd)
    _check_band_ref(band_ref, hw, sd.pix.device)
    if sd.pix.device.type == "cpu":
        return raster_images_diff_plain(sd, hw, depth_band, band_ref)
    if sd.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sd.pix.device}")
    dev = sd.pix.device
    out0, count, depth = _dense_outputs(dev, hw, False)
    vec = int(sd.pix.data_ptr() % 16 == 0)  # 16-byte loads of the pixel ids where aligned
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().rtnr_resolve_diff(
        sd.pix.data_ptr(), sd.zbits.data_ptr(), sd.rgb.data_ptr(), sd.pix.numel(), hw,
        float(depth_band), vec, out0.data_ptr(), count.data_ptr(), depth.data_ptr(),
        None if band_ref is None else band_ref.data_ptr(), stream,
    )
    _build.check(rc, "rtnr_resolve_diff")
    raster_images_diff.launches += 1
    if band_ref is not None:
        raster_images_diff.band_ref_launches += 1
    return _expand_images(out0, count, depth, False, True)


raster_images_diff.launches = 0
raster_images_diff.band_ref_launches = 0


def _check_band_ref(band_ref, hw: int, dev) -> None:
    if band_ref is None:
        return
    if band_ref.dtype != torch.float32 or tuple(band_ref.shape) != (hw,) or \
            not band_ref.is_contiguous() or band_ref.device != dev:
        raise ValueError(f"band_ref must be a contiguous ({hw},) float32 tensor on {dev}")


def expand_plain(wimg: torch.Tensor, total: torch.Tensor, hw: int, packed_out: bool,
                 float_sums: bool = False):
    """Plain torch twin of K2."""
    dev = wimg.device
    t = int(total[0])
    r, g, b, cnt, zb, wpix = (wimg[k, :t] for k in range(6))
    p = wpix.to(torch.int64)
    depth_bits = torch.full((hw,), _FLT_MAX_BITS, dtype=torch.int32, device=dev)
    depth_bits[p] = zb
    depth = depth_bits.view(torch.float32)
    if packed_out:
        c = torch.clamp(cnt, min=1)
        avg = lambda s: torch.div(s, c, rounding_mode="floor")
        pk = avg(r) | (avg(g) << 8) | (avg(b) << 16)
        out = torch.zeros((hw,), dtype=torch.int32, device=dev)
        out[p] = torch.where(cnt > 0, pk, torch.zeros_like(pk))
        return out, depth
    sums = torch.zeros((hw, 3), dtype=torch.int32, device=dev)
    sums[p] = torch.stack([r, g, b], 1)
    count = torch.zeros((hw,), dtype=torch.int32, device=dev)
    count[p] = cnt
    return _as_float_sums(sums, count, depth) if float_sums else (sums, count, depth)


def _as_float_sums(sums: torch.Tensor, count: torch.Tensor, depth: torch.Tensor):
    """float_sums: the 32-bit sum and count rows are f32 bit patterns (0 bits
    = 0.0 at empty pixels)."""
    return sums.view(torch.float32), count.view(torch.float32), depth


def _dense_outputs(dev, hw: int, packed_out: bool):
    """Uninitialised output images of a tile kernel: (out0, count or None,
    depth); every element is written once by the kernel."""
    depth = torch.empty((hw,), dtype=torch.float32, device=dev)
    if packed_out:
        return torch.empty((hw,), dtype=torch.int32, device=dev), None, depth
    return (torch.empty((hw, 3), dtype=torch.int32, device=dev),
            torch.empty((hw,), dtype=torch.int32, device=dev), depth)


def _expand_images(out0, count, depth, packed_out: bool, float_sums: bool):
    if packed_out:
        return out0, depth
    return _as_float_sums(out0, count, depth) if float_sums else (out0, count, depth)


def _check_wimg(wimg: torch.Tensor, packed_out: bool, float_sums: bool) -> None:
    if wimg.dtype != torch.int32 or wimg.dim() != 2 or wimg.shape[0] != 6:
        raise ValueError("wimg must be a (6, cap) int32 tensor")
    if packed_out and float_sums:
        raise ValueError("packed_out resolves integer sums; float_sums has none")


def _launch_expand(wimg: torch.Tensor, total: torch.Tensor, hw: int, packed_out: bool,
                   float_sums: bool):
    """Run the C entry rtnr_expand on CUDA tensors."""
    _check_wimg(wimg, packed_out, float_sums)
    if wimg.device.type != "cuda" or total.device != wimg.device:
        raise ValueError(f"rtnr_expand takes CUDA tensors on one device, not {wimg.device}")
    wimg = wimg.contiguous()
    dev = wimg.device
    out0, count, depth = _dense_outputs(dev, hw, packed_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().rtnr_expand(
        wimg.data_ptr(), wimg.shape[1], total.data_ptr(), hw, int(packed_out),
        out0.data_ptr(), None if count is None else count.data_ptr(), depth.data_ptr(), stream,
    )
    _build.check(rc, "rtnr_expand")
    return _expand_images(out0, count, depth, packed_out, float_sums)


def expand_winners(wimg: torch.Tensor, total: torch.Tensor, hw: int, *,
                   packed_out: bool = False, float_sums: bool = False):
    """K2: winner rows -> dense images. Returns (sums (HW,3) i32, count (HW,)
    i32, depth (HW,) f32); with ``float_sums`` (rows of ``winners_f32``) the
    sums and count are f32; with ``packed_out`` (packed rgb (HW,) i32, depth
    (HW,) f32). On the card: the tile kernel ``rtnr_expand``."""
    _check_wimg(wimg, packed_out, float_sums)
    if wimg.device.type == "cpu":
        return expand_plain(wimg, total, hw, packed_out, float_sums)
    if wimg.device.type != "cuda":
        raise ValueError(f"unsupported device {wimg.device}")
    out = _launch_expand(wimg, total, hw, packed_out, float_sums)
    expand_winners.launches += 1
    return out


expand_winners.launches = 0


def raster_images_v4_plain(sp: SortedPoints, hw: int, depth_band: float,
                           packed_out: bool = False, band_ref=None):
    """Plain torch twin of ``rtnr_resolve4`` (and of its band-reference
    form): K1's twin, then K2's."""
    wimg, total = winners_plain(sp, hw, depth_band, band_ref=band_ref)
    return expand_plain(wimg, total, hw, packed_out)


def raster_images_v4(sp: SortedPoints, hw: int, depth_band: float,
                     packed_out: bool = False, band_ref=None):
    """Dense images from a carrier-free (pixel, depth)-sorted stream:
    (sums (HW,3) i32, count (HW,) i32, depth (HW,) f32), or with
    ``packed_out`` (packed rgb (HW,) i32, depth (HW,) f32) — the contract of
    ``raster_images_pallas4``. On the card: one launch of ``rtnr_resolve4``
    (no winner image); for CPU tensors the plain twin.

    ``band_ref`` (sums form only; a (hw,) f32 image, e.g. the z-buffer
    merged over point shards): each pixel's band ends at ``band_ref +
    band`` instead of its head's depth + band, the semantics of the JAX
    package's ``accumulate_sums(sp, min_depth, ...)``; the depth output is
    still the head's depth. ``raster_images_v4.band_ref_launches`` counts
    that form's launches (``launches`` counts both)."""
    _check_stream(sp)
    _check_band_ref(band_ref, hw, sp.pix.device)
    if band_ref is not None and packed_out:
        raise ValueError("band_ref needs the sums form (packed_out=False)")
    if sp.pix.device.type == "cpu":
        return raster_images_v4_plain(sp, hw, depth_band, packed_out, band_ref)
    if sp.pix.device.type != "cuda":
        raise ValueError(f"unsupported device {sp.pix.device}")
    out = _launch_tile_resolve("rtnr_resolve4", sp, hw, depth_band, packed_out, band_ref)
    raster_images_v4.launches += 1
    if band_ref is not None:
        raster_images_v4.band_ref_launches += 1
    return out


def _launch_tile_resolve(fn: str, sp: SortedPoints, hw: int, depth_band: float,
                         packed_out: bool, band_ref=None):
    """Run a tile resolve's C entry ``fn`` (``rtnr_resolve4``, which also
    takes ``band_ref``, or ``rtnr_resolve5``) on a CUDA stream -> the dense
    images."""
    dev = sp.pix.device
    out0, count, depth = _dense_outputs(dev, hw, packed_out)
    # 16-byte stream loads where every pointer allows them
    vec = int(all(t.data_ptr() % 16 == 0 for t in sp))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ref = () if fn != "rtnr_resolve4" else (
        None if band_ref is None else band_ref.data_ptr(),)
    rc = getattr(_lib(), fn)(
        sp.pix.data_ptr(), sp.zbits.data_ptr(), sp.packed.data_ptr(), sp.pix.numel(), hw,
        float(depth_band), vec, int(packed_out), out0.data_ptr(),
        None if count is None else count.data_ptr(), depth.data_ptr(), *ref, stream,
    )
    _build.check(rc, fn)
    return _expand_images(out0, count, depth, packed_out, False)


raster_images_v4.launches = 0
raster_images_v4.band_ref_launches = 0
