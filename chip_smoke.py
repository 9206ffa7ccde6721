#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``rtnr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero, and the result line is not printed):
1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``rtnr_tpu_torch/csrc`` (one nvcc per source,
   in parallel), with the build seconds;
3. each kernel against its plain torch twin on the card at the main paths'
   shapes (5M-point synthetic scene, 1920x1080, full-width U-Net
   [64,128,256,512] with seeded random weights): the v4 resolve
   (``rtnr_resolve4``, K1 and K2 in one kernel) in both forms bit-exact
   against its twin, against the old pair (K1 + the search K2) and between
   two runs, also on a 20,000-point one-pixel stream, an all-culled stream, a
   1919x1079 frame (a ragged last tile) and a one-point stream; K1 alone, the
   tile K2 and the search K2 bit-exact against their twins; each redesigned
   kernel timed in turns against the kernels it replaced (and required to be
   faster); the v4 projection stage timed in its parts (projection and key
   ops, sort, split and gather, resolve); K3 at
   all 18 conv shapes (pool, head and two-input variants included) and K4 at
   its 4 shapes within 2 bf16 ulp of the output's magnitude against the f32
   ``F.conv2d`` / ``F.conv_transpose2d`` twin (TF32 off); at each K3 shape,
   the routed kernel (``conv_sm90.cu`` at the 17 shapes whose channels are
   multiples of 64; ``conv_in_sm90.cu`` at the 5-channel input conv, also
   within 2 bf16 ulp of its walk twin, two runs equal, one ``conv3x3_in``
   launch, timed in turns by its C entry), ``conv.cu``'s gemm<0,0> launched directly, and
   ``F.conv2d``; each K4 call on ``conv_sm90.cu``'s ``convt2x2_wgmma``
   (one launch of its counter, two runs equal), timed in turns against
   ``conv.cu``'s gemm<1,0> and ``F.conv_transpose2d``; the depth prefilter
   on ``csrc/prefilter.cu`` (``check_prefilter``) bit for bit against the
   plain path on the frame, an all-empty and a FLT_MAX-saturated frame and
   small frames at levels 1-4, one launch a call, timed against the plain
   path and its byte bound; every serving frame, the training CLI's steps
   and ``make_train_step`` run it once a frame or step, the scene step never;
4. the differentiable raster at the same shape: K5 (``winners_f32``) and
   the K2 ``float_sums`` expansion bit-exact against their twins; the
   differentiable forward's resolve as one kernel (``rtnr_resolve_diff``, K5
   and K2 ``float_sums`` in one tile kernel, one launch a call and no K5 or
   K2) bit-exact against that old pair on the scene's integer colours and
   on colours with seeded f32 noise (logging how many sums are not
   integers), against its twin on integer colours, between two launches,
   and on a 20,000-point one-pixel stream and an all-culled stream; its
   count, depth and sums equal to the serving raster's v4 integer images;
   its time through its C entry in turns against the pair's C entries (and
   required to be faster), K5 and K2 ``float_sums`` each through its C
   entry, beside ``torch.segment_reduce`` (+ ``index_copy_``) over the same
   segments; forward and backward ms;
5. the alternative resolvers at the same shape: the v5 resolve as one
   kernel (``rtnr_resolve5``, K6 and K2 in one tile kernel) in both forms
   bit-exact against its twin and the v4 resolve's images, two runs equal,
   one launch a call, also on a 20,000-point one-pixel stream, the same with
   its minimum last, an all-culled stream, a 1919x1079 frame, one point and
   an empty stream, and timed through its C entry in turns against the
   K6 + K2 pair it replaced (and required to be faster), beside the library
   yardstick (``segment_reduce`` min, the band, ``segment_reduce`` sum,
   ``index_copy_``); K6 alone (``winners5``) on the
   pixel-only stream and the carrier kernel (``resolve_carriers``, K7-K9) on
   the carrier stream bit-exact against their twins and their images against
   the v4 resolve's, K6 on a 20,000-point one-pixel segment, ``rasterize_scatter``
   (the atomics form) equal to ``rasterize``, and the 32-bit (pixel) against
   the 64-bit (pixel, depth) sort; then K10 (``conv_direct.conv3x3_pallas``
   on ``conv_sm90.cu``) at 1088x1920, inputs (64, 64) -> 64, driven once
   with the counts reset, within 2 bf16 ulp of its f32 twin, beside gemm<0,0>;
   then K3's fused-ConvTranspose kernel at the fused levels updc2 and updc3
   on the net's own activations, within 2 bf16 ulp of its f32 twin and
   bit-equal to the card's unfused K4 -> ``conv_sm90.cu`` pair, timed in
   turns against that pair and against ``F.conv_transpose2d`` +
   ``F.conv2d``, with its share of the bound; and the int8 gate: at 960x720
   (outside JAX's phase shapes) the static and dyn Renderers equal the bf16
   frame bit for bit, with no int8 launch and no calibration;
6. the int8 modes: the static net's lazy calibration (timed), then every
   int8-mode call of the static and the dyn net at the frame's shapes
   against its twin -- K3 static (int8 pool included), K3 dyn and K4 static
   bit for bit, the bf16 input conv with int8 output (``conv_in_sm90.cu``)
   within 1 code on <= 0.1% of elements against its twin and its walk twin,
   two runs equal, its share of codes differing from gemm<0,0>'s, timed in
   turns against gemm<0,0> and ``F.conv2d`` -- with ms, bound (int8 at
   1,979 TOP/s), twin and ``torch._int_mm`` (GEMM only) times; K4 static and K3 dyn on
   ``conv_i8_sm90.cu`` and K3 static on its ``conv3x3_static_wgmma`` (one
   launch of its counter a call), each also equal to ``conv.cu``'s kernel
   and two runs equal, timed in turns against that kernel and ``_int_mm``
   (the K3 modes also against the bf16 ``conv_sm90.cu`` conv of the same
   shape);
   the static and dyn U-Net outputs
   within max 0.10 / mean 0.02 of max|bf16| of the bf16 kernel net's;
7. the serving path: ``Renderer(...).compute_full`` for one warm-up frame,
   10 timed frames with the outputs left on the card and 3 with them copied
   to host numpy, with ms/frame, the staged projection / filter / U-Net ms
   (CUDA events), finiteness, the launch count of every kernel in that run
   (each must be > 0; ``conv_sm90.cu``'s conv exactly 17 a bf16 frame and 7
   a dyn frame, its K4 4 a bf16 and a dyn frame; ``conv_i8_sm90.cu`` 10 a
   dyn frame, and 4 (K4) and 17 (K3 static) a static frame;
   ``conv_in_sm90.cu`` once a frame in every mode), a ``torch.profiler``
   trace of a few frames of each mode, none of which may show a kernel of
   ``conv.cu``
   (device busy/idle share, top kernels; one ``resolve4_tile`` and no K1 or
   K2 kernel a frame), the U-Net output against the
   plain f32 twin net at the full shape, and a small render on the card
   against the same render on the CPU; then the same frames (without the
   host copies) for ``unet_int8="static"`` and ``"dyn"``, the static frame
   against the bf16 one at a second pose (same budget), and a culled render
   (``cull_budget="auto"``, camera inside the cloud) equal bit for bit to
   the unculled one, with its kept share and both frame times; and 1 warm-up
   + 5 bf16 frames under each of ``RTNR_RESOLVE=v4``, ``v5``, ``v3`` and
   ``v2`` (counts reset before each), every one equal to the v4 frame bit for
   bit, each through its own resolver kernel (v5: ``rtnr_resolve5`` once a
   frame and no K6 or K2 launch), with the v5 and v4 projection stages of
   the same call side by side; 1 warm-up + 5 bf16 frames
   under ``RTNR_FUSE_UP=1`` (``conv3x3_up`` 2, K4 2, ``conv_sm90.cu``'s
   plain conv 15 and ``conv_in_sm90.cu`` 1 a frame) with a trace, the fused net against the f32 twin
   net, its frame against the unfused one, and one dyn frame fused at
   levels 2 and 3; the environment is restored;
8. UNetTrain's BatchNorm + ReLU on ``csrc/bn_train.cu`` (``check_bn_train``)
   at the step's five layer shapes in bf16: forward and backward against the
   plain layer, two calls equal bit for bit, device time against the plain
   layer and ``F.batch_norm`` + ``relu``; then the training paths at full
   width (bf16 U-Net, batch 1, targets the scene's own ``render_rgbd``
   frames): 1 warm-up + 3 timed steps of ``make_train_step``
   (``rtnr_resolve4`` must launch, K1 and K2 must not) and of
   ``make_scene_train_step`` (``rtnr_resolve_diff`` must launch, K5 and K2
   must not), each with 18 BatchNorm layers a step on the fused kernels, with
   ms/step, peak device memory per step, finite losses, moved batch
   statistics, colours and camera matrices, non-zero pose and colour
   gradients, and a profiler trace of one scene step; then a small scene
   step on the card against the CPU;
9. the host layer, the render CLI and the bench line: the 5M-point scene
   written with ``data.ply.write_ply``, a 3-pose TUM trajectory around the
   bench pose, a COLMAP ``cameras.txt`` and a ``.msgpack`` checkpoint of the
   weights under a temporary directory; ``Scene.from_file`` timed cold,
   building the ``pcd.npz`` cache and from it (each equal to the scene);
   ``apps.render_trajectory.main`` in process at ``--stage full --depth
   --timings`` with every launch count set to 0 just before and read just
   after (exit 0, 3 PNGs and 3 depth PNGs, ``rtnr_resolve4`` 1,
   ``conv_sm90.cu``'s conv 17 and ``conv_in_sm90.cu``'s 1 a frame, no int8
   kernel; each PNG the same bytes as ``write_png`` of an in-process
   ``Renderer.compute_full`` at the pose) and its fps; then
   ``bench.run`` at 1920x1080 (5 frames, 1 trial, static int8 with bf16
   beside it; every ``bench.py`` field) and at 960x720 (falls back to bf16);
   then the training CLI, the JAX package's ``scripts/train_demo_r5.py``: its
   400,000-point four-wall scene (seed 7) as PLY, a 16-pose TUM trajectory
   and a 640x352 calibration; ``python -m rtnr_tpu_torch.apps.train_unet
   --self-supervised --steps 150 --lr 2e-4`` in a subprocess (the loss must
   fall), the checkpoint reloaded and pose 8 rendered trained and untrained
   (the trained L1 to the target must be the lower), ms/step and steps/s;
10. the E57 chain on the port's host library (``csrc/host``, built with g++):
   the 5M-point scene written as one scanner file by ``data.e57_write``
   (ScaledInteger coordinates at 0.1 mm, colours with their limits, the
   scan pose at identity) with six 1920x1080 photos embedded (the port's
   ``encode_jpeg``, quality 95, 4:2:0, of ``compute_rgbd`` at poses along
   bench.py's trajectory); ``Scene.from_file`` timed cold, building the
   cache and from it (5,000,000 points, colours equal, points on the 0.1 mm
   grid); the port's JPEG decoder timed per photo and within the JPEG's loss
   of its source (8x8 block means); ``python -m
   rtnr_tpu_torch.apps.generate_pairs`` in a subprocess (6 frames, 6 depth
   files, traj.txt, calib.txt), then ``generate_pairs.main`` in process
   (the same files); each pair's depth and projection equal bit for bit to
   a direct ``compute_rgbd`` of the scene read back at its pose, the pose
   within 1e-9 of the written one and K equal, the PNG equal to the decoded
   photo; a ``utils.trace.capture`` of one render holding the
   ``e57.pairs.render`` span and a ``resolve4_tile`` kernel event;
   ``train_unet.main([scan.e57, ..., "--targets", pairs, "--steps", "20"])``
   in process (full-width bf16 at 1920x1080, finite losses, each step timed
   by the host clock between its log lines); the checkpoint reloaded and
   rendered by ``compute_full``; the launch counts set to 0 just before the
   pairs CLI in process, the training CLI and the trained frame, and read
   just after each (``rtnr_resolve4`` 6, 20 and 1; the training CLI's fused
   BatchNorm 360; the frame's
   ``conv_sm90.cu`` conv 17, K4 4 and input conv 1; nothing else); the
   ``StageTimer`` line of the phase;
11. the multi-rank slice (``rtnr_tpu_torch/parallel``; ranks are fresh
   processes from ``parallel.launch``, sharing the one card): the
   band-reference forms of ``rtnr_resolve4`` (sums) and
   ``rtnr_resolve_diff`` at the bench shape (the cloud in four blocks)
   bit for bit against their twins, the blocks' sums adding up to the whole
   cloud's, timed in turns against the entries without the reference (with
   the kernel checks of phase 4); four gloo ranks at the bench cell
   (``parallel_rank_cases``): ``rasterize_point_sharded`` on (1, 4),
   ``render_filtered_sharded`` on (2, 2), ``render_full_batch`` on (4, 1)
   over 8 poses in bf16 and static int8, ``rasterize_tile_sharded`` on (4,)
   with the per-strip block culling, ``render_full_tile_sharded`` on (4,) at
   1088 rows and the sharded differentiable forward on (1, 4), each with
   the launch counts set to 0 just before and read just after, each bit for
   bit against the one-device frames of the same poses (the strip U-Net's
   ``rgb_f`` within JAX's seam bounds, mean 2e-3 and max 0.15, away from the
   image's outer 64 rows, and its uint8 frame within 1 level on average);
   two ranks run two
   scene-train steps on (2, 1) at 1080p against one rank stepping both
   frames (parameters equal on both ranks, the loss within 1e-2, 18 fused
   BatchNorm layers a step on each rank); one rank
   runs the cases on NCCL plus NCCL's collectives; the render CLI through
   ``torch.distributed.run`` on four ranks (``--batch 4 --stage full`` and
   ``--tiles 4 --stage project`` byte-equal to the serial CLI's PNGs,
   ``--tiles 4 --stage full`` against them; with the host phase) and the
   training CLI on two (the loss falls, the checkpoint renders; with the
   training-CLI phase);
12. one JSON ``kernels`` line: every kernel and int8 mode with its launches
   on its path, time, bound, plain twin and library times (the input conv
   in two rows, ``conv3x3_in`` and ``conv3x3_in_i8out``, with the
   previous gemm<0,0> time; ``resolve4`` with the old pair's time,
   ``resolve5`` with K6 + K2's, ``resolve_diff`` with K5 + K2 ``float_sums``'s,
   ``bn_train`` summed over a training step's 18 layers,
   ``expand`` also with its ``float_sums`` time on K5's rows, ``expand`` with the search kernel's,
   ``conv3x3_up`` with the pair's; the band-reference forms, ``resolve4_ref``
   and ``resolve_diff_ref``, with their launches on the point-sharded paths
   of rank 0 and the entries' times without the reference);
13. the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``rtnr_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import re
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 FLOP/s and int8 OP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

WIDTH, HEIGHT = 1920, 1080
POINTS = 5_000_000  # bench.py:52-55 of the JAX package
FRAMES = 10  # timed frames after one warm-up
INT8_FRAMES = 10  # timed frames of each int8 serving path
CULL_FRAMES = 5  # timed frames of the culled and unculled render
HOST_FRAMES = 3  # timed frames of compute_full, outputs copied to host numpy
RESOLVER_FRAMES = 5  # timed frames under each RTNR_RESOLVE value
ONE_PIXEL_POINTS = 20_000  # long-segment checks of K6 and the v4 resolve (TPU K6 looks back ~16k)
TRAIN_STEPS = 3  # timed steps of each train step after one warm-up
SEED = 0
FLT_MAX = 3.4028234663852886e38  # the raster's empty depth


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ulp_bf16(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 2.0 ** -133


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5) -> float:
    """Mean device time of one call of ``fn``: its kernels, copies and
    sets summed from a ``torch.profiler`` trace of ``reps`` calls, so a call
    whose host side outlasts its device work is timed by the device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def turns_ms(fns: dict):
    """Mean ms of each function, timed in turns (forward, then backward
    over the dict's order), in that order."""
    order = list(fns) + list(reversed(list(fns)))
    turns = {k: [] for k in fns}
    for k in order:
        turns[k].append(time_ms(fns[k]))
    return tuple(statistics.mean(turns[k]) for k in fns)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def segment_reduce_ms(sp, cnt, depth, hw, band, what, real_only=False):
    """Time of ``torch.segment_reduce`` summing the f32 lanes (r, g, b, 1) of
    the in-band elements of the pixel-sorted stream ``sp`` (against the
    minimum-depth image ``depth``; ``real_only``: the carrier stream's real
    points), one run per pixel with ``cnt`` > 0: the reduction alone, without
    the head search, the band test or the ranks."""
    import torch
    from rtnr_tpu_torch.ops.raster import REAL_BIT

    z = sp.zbits.view(torch.float32)
    keep = (sp.pix < hw) & ~(z > depth[sp.pix.clamp(max=hw - 1).long()] + band)
    if real_only:
        keep &= (sp.packed & REAL_BIT) != 0
    pk = sp.packed[keep]
    data = torch.stack([pk & 255, (pk >> 8) & 255, (pk >> 16) & 255, torch.ones_like(pk)],
                       1).float()
    lengths = cnt[cnt > 0].to(torch.int64)
    if int(lengths.sum()) != data.shape[0]:
        fail(f"segment_reduce yardstick: in-band runs do not match {what}'s counts")
    return time_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=0))


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(got, want) -> bool:
    import torch

    return len(got) == len(want) and all(torch.equal(_bits(g), _bits(w))
                                         for g, w in zip(got, want))


def one_pixel_cloud(dev):
    """ONE_PIXEL_POINTS points on the centre pixel in unsorted depth, a
    partial band: (points, colours, camera matrix) on ``dev``."""
    import numpy as np
    import torch
    from rtnr_tpu_torch.camera import Camera

    g = torch.Generator(device=dev).manual_seed(SEED)
    zc = 2.0 + 0.3 * torch.rand(ONE_PIXEL_POINTS, generator=g, device=dev)
    pts = torch.stack([torch.zeros_like(zc), torch.zeros_like(zc), zc], 1)
    cols = torch.randint(0, 256, (ONE_PIXEL_POINTS, 3), generator=g, device=dev).float()
    M = torch.from_numpy(Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH,
                                            HEIGHT).cam_proj(np.eye(4)).astype(np.float32))
    return pts, cols, M.to(dev)


def check_resolvers(renderer, M, band, rows):
    """K6 and the carrier kernel (K7-K9) at the frame's shape, bit for bit
    against their twins and against the v4 resolve's images; K6 on a
    20,000-point one-pixel segment; rasterize_scatter against rasterize; the sorts of
    the three stream forms. Returns the sort and projection times."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops import raster_resolve5 as r5
    from rtnr_tpu_torch.ops import raster_resolve_carriers as rc

    hw = WIDTH * HEIGHT
    args = (renderer.points, renderer.colors, M)
    kw = dict(width=WIDTH, height=HEIGHT, valid=renderer.valid)
    sp4 = tr.project_and_sort(*args, **kw)
    ref = rr.raster_images_v4(sp4, hw, band)
    ref_packed = rr.raster_images_v4(sp4, hw, band, packed_out=True)

    sp5 = tr.project_and_sort(*args, depth_key=False, **kw)
    if not torch.equal(sp5.pix, sp4.pix):
        fail("the pixel-only stream's pixel ids differ from the (pixel, depth) stream's")
    check_resolve5(renderer, M, band, sp5, ref, ref_packed, rows)
    wimg, total = r5.winners5(sp5, hw, band)
    wimg_p, total_p = r5.winners5_plain(sp5, hw, band)
    t = int(total[0])
    if t != int(total_p[0]) or not torch.equal(wimg[:, :t], wimg_p[:, :t]):
        fail("K6 winners5 differs from its twin")
    for packed_out, want in ((False, ref), (True, ref_packed)):
        if not same_bits(rr.expand_winners(wimg, total, hw, packed_out=packed_out), want):
            fail(f"K6+K2 images (packed_out={packed_out}) differ from the v4 resolve's")
    n5 = sp5.pix.numel()
    log(f"K6 winners5 bit-exact vs twin, K6+K2 images equal the v4 resolve's: {n5} points, "
        f"{t} winners")

    spc = tr.project_and_sort(*args, carriers=True, **kw)
    nc = spc.pix.numel()
    if nc != n5 + hw:
        fail(f"carrier stream holds {nc} elements, not {n5} + {hw}")
    got = rc.resolve_carriers(spc, hw, band)
    if not same_bits(got, rc.resolve_carriers_plain(spc, hw, band)):
        fail("carrier kernel differs from its twin")
    if not same_bits(got, ref):
        fail("carrier kernel images differ from the v4 resolve's")
    log(f"carrier kernel bit-exact vs twin and equal to the v4 resolve's images: {nc} elements")

    rgb_s, d_s = tr.rasterize_scatter(*args, **kw)
    rgb, d = tr.rasterize(*args, **kw)
    if not same_bits((rgb_s, d_s), (rgb, d)):
        fail("rasterize_scatter differs from rasterize")
    log("rasterize_scatter (scatter_reduce amin + index_add_) equals rasterize bit for bit")
    del rgb_s, d_s, rgb, d

    n1 = ONE_PIXEL_POINTS
    pts1, cols1, M1 = one_pixel_cloud(M.device)
    sp1 = tr.project_and_sort(pts1, cols1, M1, width=WIDTH, height=HEIGHT, depth_key=False)
    w1, t1 = r5.winners5(sp1, hw, band)
    w1_p, t1_p = r5.winners5_plain(sp1, hw, band)
    if not (torch.equal(t1, t1_p) and torch.equal(w1[:, :1], w1_p[:, :1])):
        fail("K6 on the one-pixel segment differs from its twin")
    ref1 = rr.raster_images_v4(tr.project_and_sort(pts1, cols1, M1, width=WIDTH, height=HEIGHT),
                               hw, band)
    if int(t1[0]) != 1 or not same_bits(rr.expand_winners(w1, t1, hw), ref1):
        fail("K6+K2 on the one-pixel segment differ from the v4 resolve")
    log(f"K6 on one pixel of {n1} points (beyond the TPU kernel's one-part lookback): "
        f"bit-exact vs twin and the v4 resolve, {int(ref1[1].max())} in band")

    k6_ms = time_ms(lambda: r5.winners5(sp5, hw, band))
    k6_plain = time_ms(lambda: r5.winners5_plain(sp5, hw, band), reps=2)
    kc_ms = time_ms(lambda: rc.resolve_carriers(spc, hw, band))
    kc_plain = time_ms(lambda: rc.resolve_carriers_plain(spc, hw, band), reps=2)
    # K6 reads the stream and writes a winner row (K1's traffic); the carrier
    # kernel reads its stream and writes sums, count and depth per pixel
    b6, by6 = bound_ms(12.0 * n5 + 24.0 * t, 0.0)
    bc, byc = bound_ms(12.0 * nc + 20.0 * hw, 0.0)
    lib6 = segment_reduce_ms(sp5, ref[1], ref[2], hw, band, "K6")
    libc = segment_reduce_ms(spc, got[1], got[2], hw, band, "the carrier kernel", real_only=True)
    rows["winners5"] = dict(ms=k6_ms, plain_ms=k6_plain, bound_ms=b6, bound_by=by6,
                            library_ms=lib6, max_abs_err=0.0)
    rows["resolve_carriers"] = dict(ms=kc_ms, plain_ms=kc_plain, bound_ms=bc, bound_by=byc,
                                    library_ms=libc, max_abs_err=0.0)
    log(f"K6 winners5: {k6_ms:.4f} ms (plain {k6_plain:.4f}, bound {b6:.4f} {by6}, "
        f"segment_reduce {lib6:.4f})")
    log(f"K7-K9 resolve_carriers: {kc_ms:.4f} ms (plain {kc_plain:.4f}, bound {bc:.4f} {byc}, "
        f"segment_reduce {libc:.4f})")

    # the sort: v4's 64-bit (pixel, depth) key against v5's 32-bit pixel key
    u, v, z = tr.project_points(renderer.points, M)
    pix, ok = tr._pixel_ids(u, v, z, renderer.valid, WIDTH, HEIGHT)
    zb = torch.where(ok, z, torch.full_like(z, float("inf"))).view(torch.int32)
    key64 = (pix.to(torch.int64) << 32) | zb.to(torch.int64)
    sorts = {"sort_key64_ms": time_ms(lambda: torch.sort(key64)),
             "sort_key32_ms": time_ms(lambda: torch.sort(pix))}
    for name, extra in (("v4", {}), ("v5", {"depth_key": False}), ("carriers", {"carriers": True})):
        sorts[f"project_and_sort_{name}_ms"] = time_ms(
            lambda: tr.project_and_sort(*args, **kw, **extra))
    log("sorts at 5M points: " + ", ".join(f"{k} {v:.4f}" for k, v in sorts.items()))
    del sp4, sp5, spc, wimg, wimg_p, got, ref, ref_packed, key64
    return sorts


def resolve5_streams(renderer, M, sp5):
    """The edge streams rtnr_resolve5 is held on besides the frame's, each a
    pixel-only-sorted stream: name -> (stream, hw)."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr

    hw = WIDTH * HEIGHT
    pts1, cols1, M1 = one_pixel_cloud(M.device)
    one = tr.project_and_sort(pts1, cols1, M1, width=WIDTH, height=HEIGHT, depth_key=False)
    out = {"one_pixel": (one, hw)}
    # the same segment with its minimum last: depth descending
    order = torch.argsort(one.zbits, descending=True, stable=True)
    out["min_last"] = (tr.SortedPoints(*(t[order].contiguous() for t in one)), hw)
    inf_bits = torch.full_like(sp5.zbits, 0x7F800000)
    out["all_culled"] = (tr.SortedPoints(torch.full_like(sp5.pix, hw), inf_bits, sp5.packed), hw)
    w, h = WIDTH - 1, HEIGHT - 1  # a ragged last tile
    out["ragged_frame"] = (tr.project_and_sort(renderer.points, renderer.colors, M, width=w,
                                               height=h, valid=renderer.valid, depth_key=False),
                           w * h)
    out["one_point"] = (tr.SortedPoints(*(t[:1].clone() for t in sp5)), hw)
    out["empty_frame"] = (tr.SortedPoints(*(t[:0].clone() for t in sp5)), hw)
    return out


def v4_order(sp):
    """The same elements sorted by (pixel, depth bits), the v4 resolve's input."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr

    key = (sp.pix.to(torch.int64) << 32) | sp.zbits.to(torch.int64)
    order = torch.argsort(key, stable=True)
    return tr.SortedPoints(*(t[order].contiguous() for t in sp))


def resolve5_entries(sp5, hw, band):
    """rtnr_resolve5 (packed) and the K6 + K2 pair it replaced (rtnr_winners5's
    three launches into its own rows, then rtnr_expand) through their C
    entries, arguments and outputs bound once."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    lib = rr._lib()
    dev = sp5.pix.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    packed, depth = i32(hw), i32(hw)
    n = sp5.pix.numel()
    stream_args = (sp5.pix.data_ptr(), sp5.zbits.data_ptr(), sp5.packed.data_ptr(), n, hw, band)
    scratch, wimg, total = i32(2 * max(-(-n // 1024), 1)), i32(6, max(min(n, hw), 1)), i32(1)
    calls = {
        "resolve5": (lib.rtnr_resolve5, stream_args + (1, 1, packed.data_ptr(), None,
                                                       depth.data_ptr(), stream)),
        "winners5": (lib.rtnr_winners5, stream_args + (scratch.data_ptr(), wimg.data_ptr(),
                                                       wimg.shape[1], total.data_ptr(), stream)),
        "expand": (lib.rtnr_expand, (wimg.data_ptr(), wimg.shape[1], total.data_ptr(), hw, 1,
                                     packed.data_ptr(), None, depth.data_ptr(), stream)),
    }
    if not all(t.data_ptr() % 16 == 0 for t in sp5):
        fail("the frame's pixel-only stream is not 16-byte aligned")
    for name, (fn, args) in calls.items():
        _build.check(fn(*args), name)
    k = {name: (lambda fn=fn, args=args: fn(*args)) for name, (fn, args) in calls.items()}
    return k["resolve5"], lambda: (k["winners5"](), k["expand"]())


def check_resolve5(renderer, M, band, sp5, ref, ref_packed, rows):
    """The v5 resolve as one kernel: rtnr_resolve5 in both forms bit for bit
    against its twin and the v4 resolve's images, two runs equal, one
    launch a call; the same on the edge streams; then its time through its C
    entry in turns against the K6 + K2 pair it replaced, beside the library
    yardstick and its bound."""
    import torch
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops import raster_resolve5 as r5

    hw = WIDTH * HEIGHT
    for packed_out, want in ((False, ref), (True, ref_packed)):
        n0 = (r5.raster_images_v5.launches, r5.winners5.launches, rr.expand_winners.launches)
        got = r5.raster_images_v5(sp5, hw, band, packed_out=packed_out)
        torch.cuda.synchronize()
        if (r5.raster_images_v5.launches, r5.winners5.launches,
                rr.expand_winners.launches) != (n0[0] + 1, n0[1], n0[2]):
            fail("raster_images_v5 did not launch rtnr_resolve5 alone, once")
        if not same_bits(got, r5.raster_images_v5_plain(sp5, hw, band, packed_out)):
            fail(f"rtnr_resolve5 (packed_out={packed_out}) differs from its twin")
        if not same_bits(got, want):
            fail(f"rtnr_resolve5 (packed_out={packed_out}) differs from the v4 resolve's images")
        if not same_bits(got, r5.raster_images_v5(sp5, hw, band, packed_out=packed_out)):
            fail(f"rtnr_resolve5 (packed_out={packed_out}) differs between two runs")
    n = sp5.pix.numel()
    n_in = int((sp5.pix < hw).sum())
    log(f"rtnr_resolve5 (both forms) bit-exact vs its twin and the v4 resolve's images, two runs "
        f"equal, one launch a call: {n} points ({n_in} in frame), hw {hw}")
    for name, (s2, hw2) in resolve5_streams(renderer, M, sp5).items():
        for packed_out in (True, False):
            got = r5.raster_images_v5(s2, hw2, band, packed_out=packed_out)
            if not (same_bits(got, r5.raster_images_v5_plain(s2, hw2, band, packed_out))
                    and same_bits(got, rr.raster_images_v4(v4_order(s2), hw2, band,
                                                           packed_out=packed_out))):
                fail(f"rtnr_resolve5 on the {name} stream (packed_out={packed_out}) differs "
                     "from its twin or from the v4 resolve")
        log(f"rtnr_resolve5 on the {name} stream ({s2.pix.numel()} elements, hw {hw2}, max "
            f"count {int(got[1].max()) if hw2 else 0}): both forms bit-exact vs its twin and "
            "the v4 resolve")
        del s2, got

    r5_entry, pair = resolve5_entries(sp5, hw, band)
    ms, prev = turns_ms({"resolve5": r5_entry, "pair": pair})
    sums_ms = time_ms(lambda: r5.raster_images_v5(sp5, hw, band))
    wrapper_ms = time_ms(lambda: r5.raster_images_v5(sp5, hw, band, packed_out=True))
    plain = time_ms(lambda: r5.raster_images_v5_plain(sp5, hw, band, True), reps=2)
    # bytes: each in-frame element read once (3 x int32), packed rgb + depth a pixel
    bnd, by = bound_ms(12.0 * n_in + 8.0 * hw, 0.0)
    # the library yardstick: segment_reduce "min" over the pixel segments, the
    # band mask against it, segment_reduce "sum" of the in-band f32 lanes and
    # index_copy_ of the per-pixel rows into a dense image (no average, no
    # packing)
    inb = sp5.pix < hw
    pix_in = sp5.pix[inb]
    zf = sp5.zbits[inb].view(torch.float32)
    pk = sp5.packed[inb]
    lanes = torch.stack([pk & 255, (pk >> 8) & 255, (pk >> 16) & 255, torch.ones_like(pk)],
                        1).float()
    pixels, lengths = torch.unique_consecutive(pix_in, return_counts=True)
    dense = torch.zeros((hw, 5), dtype=torch.float32, device=sp5.pix.device)
    bandt = torch.tensor(band, dtype=torch.float32, device=sp5.pix.device)

    def library():
        zmin = torch.segment_reduce(zf, "min", lengths=lengths)
        keep = ~(zf > torch.repeat_interleave(zmin, lengths, output_size=zf.numel()) + bandt)
        sums = torch.segment_reduce(lanes * keep[:, None], "sum", lengths=lengths, axis=0)
        dense.index_copy_(0, pixels.long(), torch.cat([sums, zmin[:, None]], 1))

    lib_ms = time_ms(library)
    rows["resolve5"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                            max_abs_err=0.0, previous_ms=prev, sums_ms=sums_ms,
                            wrapper_ms=wrapper_ms)
    log(f"rtnr_resolve5 (packed, C entry): {ms:.4f} ms against K6 + K2 (rtnr_winners5's three "
        f"launches + rtnr_expand) {prev:.4f} in turns ({prev / ms:.2f}x); bound {bnd:.4f} {by} "
        f"({bnd / ms:.3f} of it); plain {plain:.4f}; segment_reduce min + band + sum + "
        f"index_copy_ {lib_ms:.4f}; sums form through its wrapper {sums_ms:.4f}, packed "
        f"{wrapper_ms:.4f}")
    if not ms < prev:
        fail("rtnr_resolve5 is not faster than the K6 + K2 pair it replaced")


def check_conv_direct(rows, counted):
    """K10's counterpart at the decoder's finest two-input shape: driven once
    through ``conv_direct.conv3x3_pallas`` with every count reset just
    before and read just after (its path), then against the f32 twin within
    2 bf16 ulp of its magnitude, with ms, bound, twin and ``F.conv2d``."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import conv as cv
    from rtnr_tpu_torch.ops.conv_direct import conv3x3_pallas

    h, w, cs, F = 1088, 1920, (64, 64), 64
    g = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16) for c in cs]
    k = 0.05 * torch.randn((3, 3, sum(cs), F), generator=g, device="cuda")
    b = torch.randn((F,), generator=g, device="cuda")
    for fn in counted.values():
        fn.launches = 0
    y = conv3x3_pallas(xs, k, b, relu=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    log(f"conv_direct path (one conv3x3_pallas call): launches {launches}")
    if launches["conv3x3_direct"] <= 0 or launches["conv3x3_wgmma"] <= 0:
        fail("conv3x3_pallas did not launch conv_sm90.cu")
    kb, bb = cv._bf16_values(k), cv._bf16_values(b)
    (ref,) = cv.conv3x3_plain(xs, kb, bb, relu=True, dtype=torch.float32)
    err = float((y.float() - ref).abs().max())
    tol = 2 * ulp_bf16(float(ref.abs().max()))
    if not err <= tol:
        fail(f"K10 conv3x3_pallas: max abs err {err} > {tol}")
    ms = time_ms(lambda: conv3x3_pallas(xs, k, b, relu=True))
    wp = cv.prepare_conv3x3(k, b, xs[0].device)
    prev = time_ms(lambda: cv._conv3x3_gemm(xs, wp, relu=True, pool=False, head=None))
    plain = time_ms(lambda: cv.conv3x3_plain(xs, kb, bb, relu=True), reps=2)
    xcat = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)  # channels-last NCHW view
    wl = kb.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    lib = time_ms(lambda: Fn.conv2d(xcat, wl, bb.to(torch.bfloat16), padding=1))
    m, ct = h * w, sum(cs)
    flops = 2.0 * m * F * 9 * ct
    bnd, by = bound_ms(2.0 * m * ct + 2.0 * 9 * ct * F + 4.0 * F + 2.0 * m * F, flops)
    rows["conv3x3_direct"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                  library_ms=lib, max_abs_err=err, previous_ms=prev)
    log(f"K10 conv3x3_pallas {h}x{w}x(64+64)->64 err {err:.3g} (tol {tol:.3g}) | {ms:.4f} ms, "
        f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bnd:.4f} {by}, plain {plain:.4f}, "
        f"F.conv2d {lib:.4f}, gemm<0,0> {prev:.4f}")
    return {"launches": launches}


def check_conv_up(unet, x, rows):
    """K3's fused-ConvTranspose mode at the full-width net's fused levels
    (updc2, updc3) on the bf16 net's own activations at the frame's shape:
    within 2 bf16 ulp of its f32 twin (the up values rounded to bf16 once, as
    the contract has it), two runs equal, and bit-equal to the card's unfused
    K4 -> ``conv_sm90.cu`` pair (its summation order is the pair's); timed in
    turns against that pair and against ``F.conv_transpose2d`` + ``F.conv2d``
    on the concat (two library calls, a yardstick only), with its share of
    the operations bound."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import conv as cv

    p = unet.prepare()
    calls = record_unet_calls(unet, x)
    deeps = {name: xin for kind, name, xin, _, _ in calls if kind == "convt2x2"}
    skips = {name: xin[0] for kind, name, xin, _, _ in calls if kind == "conv3x3"}
    levels = sorted(unet.fuse_levels(int(x.shape[1])))
    if levels != [2, 3]:
        fail(f"fuse_up_ok picks decoder levels {levels} at {tuple(x.shape)}, not [2, 3]")
    acc = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, pair_ms=0.0, err=0.0,
               flops=0.0, nbytes=0.0)
    per_shape = {}
    for i in levels:
        deep, skip = deeps[f"up{i}"], skips[f"updc{i}/conv0"]
        w, up = p[f"updc{i}/conv0"], p[f"up{i}"]
        _, h, wd, cs = skip.shape
        cd, F = up.cin, int(w.wmat.shape[1])
        if not cv.takes_up(cs, cd, up.f, F):
            fail(f"updc{i}: the fused kernel does not take ({cs}, {cd}, {up.f}, {F})")
        n0 = cv.conv3x3_up.launches
        (y,) = cv.conv3x3_prepared([skip, deep], w, relu=True, up=up)
        torch.cuda.synchronize()
        if cv.conv3x3_up.launches != n0 + 1:
            fail(f"updc{i}: the fused call did not launch conv3x3_up_wgmma")
        kern = cv._bf16_values(unet.param(f"updc{i}/conv0/kernel"))
        (ref,) = cv.conv3x3_plain([skip, cv.convt2x2_prepared_plain(deep, up)], kern, w.bias,
                                  relu=True, dtype=torch.float32)
        err = float((y.float() - ref).abs().max())
        tol = 2 * ulp_bf16(float(ref.abs().max()))
        if not err <= tol:
            fail(f"K3-up updc{i} {tuple(skip.shape)}: max abs err {err} > {tol}")
        (y2,) = cv.conv3x3_prepared([skip, deep], w, relu=True, up=up)
        if not torch.equal(y2, y):
            fail(f"K3-up updc{i}: two runs differ")
        (yp,) = cv.conv3x3_prepared([skip, cv.convt2x2_prepared(deep, up)], w, relu=True)
        d = (y.float() - yp.float()).abs()
        share, dmax = float((d > 0).float().mean()), float(d.max())
        if not torch.equal(y, yp):
            fail(f"K3-up updc{i}: differs from the card's K4 -> conv_sm90 pair on {share:.4g} "
                 f"of elements (max {dmax:.3g}); it must equal it bit for bit")
        del y2, yp, d, ref

        kt = cv._bf16_values(unet.param(f"up{i}/kernel"))
        wt = torch.flip(kt, dims=(0, 1)).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
        wl = kern.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bt, bl = up.bias.to(torch.bfloat16), w.bias.to(torch.bfloat16)
        dl, sl = deep.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2)  # channels-last views
        fns = {
            "fused": lambda: cv.conv3x3_prepared([skip, deep], w, relu=True, up=up),
            "pair": lambda: cv.conv3x3_prepared([skip, cv.convt2x2_prepared(deep, up)], w,
                                                relu=True),
            "library": lambda: Fn.conv2d(
                torch.cat([sl, Fn.conv_transpose2d(dl, wt, bt, stride=2)], dim=1), wl, bl,
                padding=1),
        }
        t = {k: [] for k in fns}
        for k in ("fused", "pair", "library", "library", "pair", "fused"):
            t[k].append(time_ms(fns[k]))
        ms, pair_ms, lib = (statistics.mean(t[k]) for k in ("fused", "pair", "library"))
        plain = time_ms(lambda: cv.conv3x3_prepared_plain([skip, deep], w, relu=True, up=up),
                        reps=2)
        M = h * wd
        flops = 2.0 * M * F * 9 * (cs + F) + 2.0 * (M // 4) * 4 * F * cd  # conv + ConvTranspose
        nbytes = (2.0 * M * cs + 2.0 * (M // 4) * cd + 2.0 * 4 * cd * F
                  + 2.0 * 9 * (cs + F) * F + 8.0 * F + 2.0 * M * F)
        b, by = bound_ms(nbytes, flops)
        for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", b), ("library_ms", lib),
                     ("pair_ms", pair_ms), ("flops", flops), ("nbytes", nbytes)):
            acc[k] += v
        acc["err"] = max(acc["err"], err)
        per_shape[f"updc{i}"] = {"ms": ms, "pair_ms": pair_ms, "library_ms": lib,
                                 "plain_ms": plain, "bound_ms": b, "share_of_bound": b / ms,
                                 "err": err, "tol": tol, "differs_from_pair": share,
                                 "max_diff_from_pair": dmax, "all_ms": t}
        log(f"K3-up updc{i} {h}x{wd}x({cs}+up {cd}->{F})->{F} err {err:.3g} (tol {tol:.3g}); "
            f"bit-equal to the card's K4 -> conv_sm90 pair (differs on {share:.4g} of "
            f"elements) | fused {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b / ms:.3f} of "
            f"its bound {b:.4f} {by}), pair {pair_ms:.4f}, F.conv_transpose2d + F.conv2d "
            f"{lib:.4f}, plain {plain:.4f}; turns {t}")
    _, by = bound_ms(acc["nbytes"], acc["flops"])
    rows["conv3x3_up"] = dict(ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
                              bound_by=by, library_ms=acc["library_ms"], max_abs_err=acc["err"],
                              pair_ms=acc["pair_ms"])
    log(f"K3-up per frame (2 shapes): fused {acc['ms']:.4f} ms against the card's pair "
        f"{acc['pair_ms']:.4f} ({acc['pair_ms'] / acc['ms']:.2f}x) and the library pair "
        f"{acc['library_ms']:.4f}; bound {acc['bound_ms']:.4f} "
        f"({acc['bound_ms'] / acc['ms']:.3f} of it), plain {acc['plain_ms']:.4f}")
    return per_shape


def fuse_up_frames(renderer, dyn_r, cam, E, x, counted):
    """``RTNR_FUSE_UP=1``: 1 warm-up + RESOLVER_FRAMES bf16 frames
    (``conv3x3_up`` 2, K4 2 and ``conv3x3_in`` 1 a frame) and a trace of 3, the U-Net
    against the f32 twin net within the bf16 budget, the largest difference from the unfused frame;
    then one dyn frame with its launch counts. The environment is restored."""
    import os

    import torch

    ref = renderer.compute_full_tensors(cam, E)["rgb_f"]  # unfused: the variable is unset
    saved = os.environ.get("RTNR_FUSE_UP")
    os.environ["RTNR_FUSE_UP"] = "1"
    try:
        res = serve_frames(renderer, cam, E, RESOLVER_FRAMES, counted,
                           ("resolve4", "conv3x3", "convt2x2", "conv3x3_wgmma",
                            "conv3x3_up"), "bf16 RTNR_FUSE_UP=1",
                           per_frame={"resolve4": 1, "winners": 0, "expand": 0,
                                      "conv3x3_up": 2, "convt2x2": 2, "convt2x2_wgmma": 2,
                                      "conv3x3_wgmma": 15, "conv3x3_in": 1})
        trace_frames(renderer, cam, E, res["ms_per_frame"], label="bf16 RTNR_FUSE_UP=1")
        dframe = float((renderer.compute_full_tensors(cam, E)["rgb_f"] - ref).abs().max())
        with torch.no_grad():
            yk = renderer.unet(x).float()
            yr = renderer.unet.forward_plain(x, torch.float32)
        d = (yk - yr).abs()
        scale = max(1.0, float(yr.abs().max()))
        dmax, dmean = float(d.max()), float(d.mean())
        log(f"U-Net under RTNR_FUSE_UP=1 vs f32 twin: max {dmax:.4g}, mean {dmean:.4g} (budget "
            f"max 5e-2, mean 5e-3 x {scale:.4g}); rgb_f max difference from the unfused frame "
            f"{dframe:.4g}")
        if not (dmax <= 5e-2 * scale and dmean <= 5e-3 * scale):
            fail("U-Net under RTNR_FUSE_UP=1 outside the budget against the f32 twin")
        del yk, yr, d
        for fn in counted.values():
            fn.launches = 0
        out = dyn_r.compute_full_tensors(cam, E)
        torch.cuda.synchronize()
        dyn = {k: fn.launches for k, fn in counted.items()}
        log(f"dyn int8 frame under RTNR_FUSE_UP=1: launches {dyn}, unet "
            f"{dyn_r.last_timings.unet_ms:.3f} ms")
        if (dyn["conv3x3_up"] != 2 or dyn["conv3x3_dyn"] != 10 or dyn["convt2x2"] != 2
                or dyn["convt2x2_wgmma"] != 2 or dyn["conv3x3_dyn_wgmma"] != 10
                or dyn["conv3x3_in"] != 1):
            fail("the dyn frame under RTNR_FUSE_UP=1 did not fuse levels 2 and 3")
        if not bool(torch.isfinite(out["rgb_f"]).all()):
            fail("the dyn frame under RTNR_FUSE_UP=1 is not finite")
    finally:
        if saved is None:
            os.environ.pop("RTNR_FUSE_UP", None)
        else:
            os.environ["RTNR_FUSE_UP"] = saved
    return {"serve": res, "unet_err": {"max": dmax, "mean": dmean, "scale": scale},
            "max_diff_from_unfused_frame": dframe, "dyn_launches": dyn}


def check_int8_gate(renderer, static_r, dyn_r, counted):
    """At 960x720 (padded 720 rows: 720 % 64 != 0, outside the shape terms
    of JAX's phase path) the static and the dyn Renderer give the bf16
    Renderer's frame bit for bit, launch no int8 kernel, and the static one
    keeps ``act_scales`` None. Run before the static Renderer calibrates."""
    import numpy as np
    import torch
    from rtnr_tpu_torch.camera import Camera

    cam = Camera.from_params(600.0, 600.0, 480.0, 360.0, 960, 720)
    E = np.eye(4)
    E[2, 3] = 12.0
    ref = renderer.compute_full_tensors(cam, E)
    keys = ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb")
    int8 = ("conv3x3_i8out", "conv3x3_static", "conv3x3_dyn", "convt2x2_static",
            "conv3x3_dyn_wgmma", "convt2x2_static_wgmma", "conv3x3_static_wgmma")
    for label, r in (("static", static_r), ("dyn", dyn_r)):
        for fn in counted.values():
            fn.launches = 0
        out = r.compute_full_tensors(cam, E)
        torch.cuda.synchronize()
        if any(counted[k].launches for k in int8):
            fail(f"the {label} Renderer launched int8 kernels at 960x720")
        if not same_bits([out[k] for k in keys], [ref[k] for k in keys]):
            fail(f"the {label} Renderer's 960x720 frame differs from the bf16 frame")
    if static_r.act_scales is not None:
        fail("the static Renderer calibrated at 960x720")
    log("int8 gate: at 960x720 the static and dyn Renderers equal the bf16 frame bit for bit "
        "(no int8 launch; act_scales None)")
    return {"equal": True, "shape": [720, 960]}


def resolver_frames(renderer, cam, E, counted):
    """1 warm-up + RESOLVER_FRAMES bf16 frames under RTNR_RESOLVE = v4, v5,
    v3 and v2 in turn (counts reset before each); each later frame equal to
    the v4 frame bit for bit, each path through its own resolver (v4 only
    rtnr_resolve4; v5 K6 and K2; v3 and v2 the carrier kernel). The
    environment is restored."""
    import os

    import torch

    need = {"v4": ("resolve4",), "v5": ("resolve5",),
            "v3": ("resolve_carriers",), "v2": ("resolve_carriers",)}
    others = ("resolve4", "resolve5", "winners", "winners5", "resolve_carriers", "expand")
    saved = os.environ.get("RTNR_RESOLVE")
    out, ref = {}, None
    try:
        for mode, own in need.items():
            os.environ["RTNR_RESOLVE"] = mode
            res = serve_frames(renderer, cam, E, RESOLVER_FRAMES, counted,
                               own + ("conv3x3", "convt2x2"), f"bf16 RTNR_RESOLVE={mode}",
                               per_frame={own[0]: 1})
            stray = [k for k in others if k not in own and res["launches"][k]]
            if stray:
                fail(f"RTNR_RESOLVE={mode} launched {stray}")
            frame = renderer.compute_full_tensors(cam, E)
            keys = ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f")
            if ref is None:
                ref = frame
            elif not same_bits([frame[k] for k in keys], [ref[k] for k in keys]):
                fail(f"RTNR_RESOLVE={mode} frame differs from the v4 frame")
            out[mode] = res
    finally:
        if saved is None:
            os.environ.pop("RTNR_RESOLVE", None)
        else:
            os.environ["RTNR_RESOLVE"] = saved
    log("resolver frames equal the v4 frame bit for bit (raw_rgb, raw_depth, depth, mask, "
        "rgb_f): " + ", ".join(f"{m} {r['ms_per_frame']:.3f} ms/frame (projection "
                               f"{r['stage_ms']['projection']:.3f})" for m, r in out.items()))
    p4, p5 = out["v4"]["stage_ms"]["projection"], out["v5"]["stage_ms"]["projection"]
    log(f"projection stage, same call: v5 (32-bit sort, rtnr_resolve5) {p5:.3f} ms against v4 "
        f"(64-bit sort, rtnr_resolve4) {p4:.3f} ms ({p4 - p5:+.3f})")
    return out


def resolve4_streams(renderer, M, sp):
    """The adversarial streams rtnr_resolve4 is held on besides the frame's:
    name -> (stream, hw)."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr

    hw = WIDTH * HEIGHT
    out = {"one_pixel": (tr.project_and_sort(*one_pixel_cloud(M.device), width=WIDTH,
                                             height=HEIGHT), hw)}
    inf_bits = torch.full_like(sp.zbits, 0x7F800000)
    out["all_culled"] = (tr.SortedPoints(torch.full_like(sp.pix, hw), inf_bits, sp.packed), hw)
    # 1919 x 1079 = 2,070,601 pixels: the last tile is ragged
    w, h = WIDTH - 1, HEIGHT - 1
    out["ragged_frame"] = (tr.project_and_sort(renderer.points, renderer.colors, M, width=w,
                                               height=h, valid=renderer.valid), w * h)
    out["one_point"] = (tr.SortedPoints(*(t[:1].clone() for t in sp)), hw)
    return out


def resolve_entries(sp, hw, band, wimg, total):
    """Launches of ``raster_resolve.cu``'s C entries on the frame's stream and
    K1's winner rows, their arguments and outputs bound once: the kernels'
    times without the Python wrappers' checks and allocation, which at ~40 us
    a kernel would leave the card waiting for the host. Keys: the v4 resolve
    in both forms, K1 alone, the tile K2, the search K2, and the old pair (K1
    into its own rows, then the search K2)."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    lib = rr._lib()
    dev = sp.pix.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    packed, sums, cnt, depth = i32(hw), i32(hw, 3), i32(hw), i32(hw)
    n, cap = sp.pix.numel(), wimg.shape[1]
    stream_args = (sp.pix.data_ptr(), sp.zbits.data_ptr(), sp.packed.data_ptr(), n, hw, band)
    scratch = i32(2 * max(-(-n // 1024), 1))
    wimg2, total2 = i32(6, max(min(n, hw), 1)), i32(1)
    winners_args = stream_args + (scratch.data_ptr(), wimg2.data_ptr(), wimg2.shape[1],
                                  total2.data_ptr(), stream)
    calls = {
        "resolve4": (lib.rtnr_resolve4, stream_args + (1, 1, packed.data_ptr(), None,
                                                       depth.data_ptr(), None, stream)),
        "resolve4_sums": (lib.rtnr_resolve4, stream_args + (1, 0, sums.data_ptr(),
                                                            cnt.data_ptr(), depth.data_ptr(),
                                                            None, stream)),
        "winners": (lib.rtnr_winners, winners_args),
        "expand": (lib.rtnr_expand, (wimg.data_ptr(), cap, total.data_ptr(), hw, 1,
                                     packed.data_ptr(), None, depth.data_ptr(), stream)),
        "expand_search": (lib.rtnr_expand_search, (wimg.data_ptr(), cap, total.data_ptr(), hw,
                                                   1, packed.data_ptr(), None, depth.data_ptr(),
                                                   stream)),
        "pair_expand": (lib.rtnr_expand_search, (wimg2.data_ptr(), wimg2.shape[1],
                                                 total2.data_ptr(), hw, 1, packed.data_ptr(),
                                                 None, depth.data_ptr(), stream)),
    }
    if not all(sp_t.data_ptr() % 16 == 0 for sp_t in sp):
        fail("the frame's stream is not 16-byte aligned")
    for name, (fn, args) in calls.items():
        _build.check(fn(*args), name)
    out = {name: (lambda fn=fn, args=args: fn(*args)) for name, (fn, args) in calls.items()}
    pair_k1, pair_k2 = out.pop("winners"), out.pop("pair_expand")
    out["winners"] = pair_k1
    out["pair"] = lambda: (pair_k1(), pair_k2())
    return out


def check_resolve(renderer, M, sp, hw, band, rows):
    """On the frame's stream: rtnr_resolve4 in both forms bit for bit against
    its twin and against the old pair (K1 + the search K2), and on the
    adversarial streams; K1 alone, the tile K2 and the search K2 against
    their twins; then the times, each new kernel in turns against the one it
    replaced."""
    import torch
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    wimg, total = rr.winners(sp, hw, band)
    wimg_p, total_p = rr.winners_plain(sp, hw, band)
    t = int(total[0])
    if t != int(total_p[0]):
        fail(f"K1 winner total {t} != twin {int(total_p[0])}")
    if not torch.equal(wimg[:, :t], wimg_p[:, :t]):
        bad = (wimg[:, :t] != wimg_p[:, :t]).nonzero()[:5].tolist()
        fail(f"K1 winner rows differ from the twin, first at {bad}")
    for packed_out in (True, False):
        ref = rr.expand_plain(wimg, total, hw, packed_out)
        if not same_bits(rr.expand_winners(wimg, total, hw, packed_out=packed_out), ref):
            fail(f"K2 tile kernel (packed_out={packed_out}) differs from the twin")
        if not same_bits(rr.expand_search(wimg, total, hw, packed_out=packed_out), ref):
            fail(f"K2 search kernel (packed_out={packed_out}) differs from the twin")
        got = rr.raster_images_v4(sp, hw, band, packed_out=packed_out)
        if not same_bits(got, ref):
            fail(f"rtnr_resolve4 (packed_out={packed_out}) differs from K1 + K2")
        if not same_bits(got, rr.raster_images_v4_plain(sp, hw, band, packed_out)):
            fail(f"rtnr_resolve4 (packed_out={packed_out}) differs from its twin")
        if not same_bits(got, rr.raster_images_v4(sp, hw, band, packed_out=packed_out)):
            fail(f"rtnr_resolve4 (packed_out={packed_out}) differs between two runs")
    n = sp.pix.numel()
    n_in = int((sp.pix < hw).sum())
    log(f"rtnr_resolve4 (both forms) bit-exact vs its twin and K1 + K2, two runs equal; K1, "
        f"tile K2 and search K2 bit-exact vs twins: {n} points ({n_in} in frame), {t} winners, "
        f"hw {hw}")
    for name, (s2, hw2) in resolve4_streams(renderer, M, sp).items():
        w2, t2 = rr.winners(s2, hw2, band)
        for packed_out in (True, False):
            got = rr.raster_images_v4(s2, hw2, band, packed_out=packed_out)
            if not (same_bits(got, rr.raster_images_v4_plain(s2, hw2, band, packed_out))
                    and same_bits(got, rr.expand_search(w2, t2, hw2, packed_out=packed_out))):
                fail(f"rtnr_resolve4 on the {name} stream (packed_out={packed_out}) differs "
                     "from its twin or from K1 + K2")
        log(f"rtnr_resolve4 on the {name} stream ({s2.pix.numel()} elements, hw {hw2}, "
            f"{int(t2[0])} winners, max count {int(got[1].max()) if hw2 else 0}): both forms "
            "bit-exact vs its twin and K1 + K2")
        del s2, w2, t2, got

    # kernel times through the C entries, each new kernel in turns against the
    # kernels it replaced; the wrappers' times beside them
    k = resolve_entries(sp, hw, band, wimg, total)
    r4_ms, pair_ms = turns_ms({"resolve4": k["resolve4"], "pair": k["pair"]})
    k2_ms, k2_search = turns_ms({"tile": k["expand"], "search": k["expand_search"]})
    r4_sums_ms = time_ms(k["resolve4_sums"])
    k1_ms = time_ms(k["winners"])
    wrapped = {
        "resolve4": time_ms(lambda: rr.raster_images_v4(sp, hw, band, packed_out=True)),
        "expand": time_ms(lambda: rr.expand_winners(wimg, total, hw, packed_out=True)),
        "winners": time_ms(lambda: rr.winners(sp, hw, band))}
    r4_plain = time_ms(lambda: rr.raster_images_v4_plain(sp, hw, band, True), reps=2)
    k1_plain = time_ms(lambda: rr.winners_plain(sp, hw, band), reps=2)
    k2_plain = time_ms(lambda: rr.expand_plain(wimg, total, hw, True), reps=2)
    # rtnr_resolve4 reads each in-frame element once (3 x int32) and writes
    # packed rgb + depth (8 B) or sums, count and depth (20 B) a pixel; K1
    # reads the stream and writes 6 x int32 a winner; K2 reads the winner rows
    # and writes packed rgb + depth a pixel
    b4, by4 = bound_ms(12.0 * n_in + 8.0 * hw, 0.0)
    b4s, _ = bound_ms(12.0 * n_in + 20.0 * hw, 0.0)
    b1, by1 = bound_ms(12.0 * n + 24.0 * t, 0.0)
    b2, by2 = bound_ms(24.0 * t + 8.0 * hw, 0.0)
    # yardsticks: K1's reduction as torch.segment_reduce over the same in-band
    # runs (f32 lanes r, g, b, 1; without the head search, the band test and
    # the ranks), K2 as one index_copy_ of the winner rows into a dense
    # (H*W, 6) image (without the integer average and the packing); the v4
    # resolve as the two together
    _, cnt_i, depth_i = rr.expand_winners(wimg, total, hw, packed_out=False)
    lib1 = segment_reduce_ms(sp, cnt_i, depth_i, hw, band, "K1")
    rows_t = wimg[:, :t].t().contiguous()
    dense = torch.zeros((hw, 6), dtype=torch.int32, device=wimg.device)
    lib2 = time_ms(lambda: dense.index_copy_(0, wimg[5, :t].long(), rows_t))
    del rows_t, dense
    rows["resolve4"] = dict(ms=r4_ms, plain_ms=r4_plain, bound_ms=b4, bound_by=by4,
                            library_ms=lib1 + lib2, max_abs_err=0.0, previous_ms=pair_ms,
                            sums_ms=r4_sums_ms, sums_bound_ms=b4s,
                            wrapper_ms=wrapped["resolve4"])
    rows["winners"] = dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=b1, bound_by=by1,
                           library_ms=lib1, max_abs_err=0.0, wrapper_ms=wrapped["winners"])
    rows["expand"] = dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=b2, bound_by=by2,
                          library_ms=lib2, max_abs_err=0.0, previous_ms=k2_search,
                          wrapper_ms=wrapped["expand"])
    log(f"rtnr_resolve4 (packed, C entry): {r4_ms:.4f} ms against K1 + search K2 {pair_ms:.4f} "
        f"in turns ({pair_ms / r4_ms:.2f}x); bound {b4:.4f} {by4} ({b4 / r4_ms:.3f} of it"
        f"{', half its bound met' if r4_ms <= 2 * b4 else ', half its bound missed'}); plain "
        f"{r4_plain:.4f}; segment_reduce + index_copy_ {lib1 + lib2:.4f}; sums form "
        f"{r4_sums_ms:.4f} (bound {b4s:.4f}); through its wrapper {wrapped['resolve4']:.4f}")
    log(f"K1 winners (C entry): {k1_ms:.4f} ms (plain {k1_plain:.4f}, bound {b1:.4f} {by1}, "
        f"segment_reduce {lib1:.4f}); through its wrapper {wrapped['winners']:.4f}")
    log(f"K2 expand (tile, C entry): {k2_ms:.4f} ms against the search kernel {k2_search:.4f} "
        f"in turns ({k2_search / k2_ms:.2f}x); bound {b2:.4f} {by2}"
        f"{', half its bound met' if k2_ms <= 2 * b2 else ', half its bound missed'}; plain "
        f"{k2_plain:.4f}, index_copy_ {lib2:.4f}; through its wrapper {wrapped['expand']:.4f}")
    if not (r4_ms < pair_ms and k2_ms < k2_search):
        fail("a redesigned resolve kernel is not faster than the kernels it replaced")


def projection_split(renderer, M, band):
    """The v4 projection stage at the frame's shape in its parts, each timed
    alone with CUDA events: the projection and key ops, the 64-bit sort, the
    split of the sorted key and the colour gather, and the resolve."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    hw = WIDTH * HEIGHT
    st = {}

    def key():
        u, v, z = tr.project_points(renderer.points, M)
        pix, ok = tr._pixel_ids(u, v, z, renderer.valid, WIDTH, HEIGHT)
        zb = torch.where(ok, z, torch.full_like(z, float("inf"))).view(torch.int32)
        cols = renderer.colors.to(torch.int32)
        st["packed"] = cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)
        st["key"] = (pix.to(torch.int64) << 32) | zb.to(torch.int64)

    def sort():
        st["key_s"], st["order"] = torch.sort(st["key"])

    def gather():
        ks = st["key_s"]
        st["sp"] = tr.SortedPoints((ks >> 32).to(torch.int32), (ks & 0xFFFFFFFF).to(torch.int32),
                                   st["packed"][st["order"]])

    out = {"project_key_ms": time_ms(key), "sort_ms": time_ms(sort),
           "unpack_gather_ms": time_ms(gather),
           "resolve_ms": time_ms(lambda: rr.raster_images_v4(st["sp"], hw, band,
                                                             packed_out=True))}
    out["sum_ms"] = sum(out.values())
    log("v4 projection stage in parts (CUDA events, each alone): " +
        ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def diff_entries(sd, hw, band):
    """rtnr_resolve_diff and the pair it replaced (rtnr_winners_f32's three
    launches into its own rows, then rtnr_expand in the sums form, the
    float_sums expansion) through their C entries, arguments and outputs
    bound once: name -> a call (``resolve_diff``, ``winners_f32``,
    ``expand_f32``, ``pair``)."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    lib = rr._lib()
    dev = sd.pix.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    sums, cnt, depth = i32(hw, 3), i32(hw), i32(hw)
    n = sd.pix.numel()
    stream_args = (sd.pix.data_ptr(), sd.zbits.data_ptr(), sd.rgb.data_ptr(), n, hw, band)
    scratch, wimg, total = i32(2 * max(-(-n // 1024), 1)), i32(6, max(min(n, hw), 1)), i32(1)
    outs = (sums.data_ptr(), cnt.data_ptr(), depth.data_ptr(), stream)
    calls = {
        "resolve_diff": (lib.rtnr_resolve_diff,
                         stream_args + (1,) + outs[:3] + (None, stream)),
        "winners_f32": (lib.rtnr_winners_f32, stream_args + (scratch.data_ptr(), wimg.data_ptr(),
                                                             wimg.shape[1], total.data_ptr(),
                                                             stream)),
        "expand_f32": (lib.rtnr_expand, (wimg.data_ptr(), wimg.shape[1], total.data_ptr(), hw, 0)
                       + outs),
    }
    if sd.pix.data_ptr() % 16:
        fail("the diff stream's pixel ids are not 16-byte aligned")
    for name, (fn, args) in calls.items():
        _build.check(fn(*args), name)
    k = {name: (lambda fn=fn, args=args: fn(*args)) for name, (fn, args) in calls.items()}
    k["pair"] = lambda: (k["winners_f32"](), k["expand_f32"]())
    return k


def check_diff_raster(points, colors, valid, M, band, rows):
    """The differentiable forward at the frame's shape: K5 + K2 float_sums
    against their twins bit for bit; rtnr_resolve_diff (one launch, no K5 or
    K2) bit for bit against that old pair on the scene's integer colours and
    on colours with seeded f32 noise, against its twin on integer colours,
    between two launches, and on a 20,000-point one-pixel stream and an
    all-culled stream against its twin; its count, depth and sums against
    the serving raster's v4 integer images exactly (the colours are
    integers, so every sum is exact in f32); its time through its C entry in
    turns against the pair's C entries (it must be faster); forward and
    backward ms."""
    import torch
    from rtnr_tpu_torch.ops import raster_diff as rd
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops.raster import project_and_sort, project_and_sort_diff

    hw = WIDTH * HEIGHT
    sd, _ = project_and_sort_diff(points, colors, M, width=WIDTH, height=HEIGHT, valid=valid)
    wimg, total = rr.winners_f32(sd, hw, band)
    wimg_p, total_p = rr.winners_f32_plain(sd, hw, band)
    t = int(total[0])
    if t != int(total_p[0]) or not torch.equal(wimg[:, :t], wimg_p[:, :t]):
        fail("K5 winners_f32 differs from its twin")
    pair = rr.expand_winners(wimg, total, hw, float_sums=True)
    if not same_bits(pair, rr.expand_plain(wimg, total, hw, False, float_sums=True)):
        fail("K2 float_sums differs from its twin")
    del wimg_p, total_p

    counts = lambda: (rr.raster_images_diff.launches, rr.winners_f32.launches,
                      rr.expand_winners.launches)
    before = counts()
    got = rr.raster_images_diff(sd, hw, band)
    torch.cuda.synchronize()
    if counts() != (before[0] + 1,) + before[1:]:
        fail("raster_images_diff did not launch rtnr_resolve_diff alone, once")
    if not same_bits(got, pair):
        fail("rtnr_resolve_diff differs from K5 + K2 float_sums (integer colours)")
    if not same_bits(got, rr.raster_images_diff_plain(sd, hw, band)):
        fail("rtnr_resolve_diff differs from its twin (integer colours)")
    if not same_bits(got, rr.raster_images_diff(sd, hw, band)):
        fail("rtnr_resolve_diff differs between two launches")
    sums_f, cnt_f, depth_f = got
    sp = project_and_sort(points, colors, M, width=WIDTH, height=HEIGHT, valid=valid)
    sums_i, cnt_i, depth_i = rr.raster_images_v4(sp, hw, band)
    if not (torch.equal(cnt_f, cnt_i.float()) and torch.equal(sums_f, sums_i.float())
            and torch.equal(depth_f.view(torch.int32), depth_i.view(torch.int32))):
        fail("diff raster count/depth/sums differ from the serving raster's")
    n = sd.pix.numel()
    n_in = int((sd.pix < hw).sum())
    log(f"K5 + K2 float_sums bit-exact vs twins; rtnr_resolve_diff (one launch, no K5 or K2) "
        f"bit-exact vs K5 + K2, vs its twin and between two launches; its count, depth and sums "
        f"equal the serving v4 images exactly: {n} points ({n_in} in frame), {t} winners, max "
        f"count {int(cnt_i.max())}, max sum {int(sums_i.max())}")
    del sp, sums_i, cnt_i, depth_i

    # colours off the integers, as Adam leaves them: seeded noise added in f32
    g = torch.Generator(device=M.device).manual_seed(SEED)
    sdf = sd._replace(rgb=(sd.rgb + (torch.rand(sd.rgb.shape, generator=g, device=M.device)
                                     - 0.5)).contiguous())
    pair_f = rr.expand_winners(*rr.winners_f32(sdf, hw, band), hw, float_sums=True)
    got_f = rr.raster_images_diff(sdf, hw, band)
    non_int = int((pair_f[0] != torch.round(pair_f[0])).sum())
    if not same_bits(got_f, pair_f) or not same_bits(got_f, rr.raster_images_diff(sdf, hw, band)):
        fail("rtnr_resolve_diff differs from K5 + K2 float_sums or between two launches "
             "(non-integer colours)")
    if non_int == 0:
        fail("the noisy colours gave no non-integer sum")
    log(f"rtnr_resolve_diff bit-exact vs K5 + K2 float_sums on noisy f32 colours, two launches "
        f"equal: {non_int} of {3 * hw} sums are not integers")
    del pair_f, got_f, sdf

    pts1, cols1, M1 = one_pixel_cloud(M.device)
    one, _ = project_and_sort_diff(pts1, cols1, M1, width=WIDTH, height=HEIGHT)
    inf_bits = torch.full_like(sd.zbits, 0x7F800000)
    edge = {"one_pixel": one, "all_culled": sd._replace(pix=torch.full_like(sd.pix, hw),
                                                        zbits=inf_bits)}
    for name, s2 in edge.items():
        got2 = rr.raster_images_diff(s2, hw, band)
        if not (same_bits(got2, rr.raster_images_diff_plain(s2, hw, band)) and same_bits(
                got2, rr.expand_winners(*rr.winners_f32(s2, hw, band), hw, float_sums=True))):
            fail(f"rtnr_resolve_diff on the {name} stream differs from its twin or K5 + K2")
        log(f"rtnr_resolve_diff on the {name} stream ({s2.pix.numel()} elements, max count "
            f"{int(got2[1].max())}): bit-exact vs its twin and K5 + K2")
    del edge, one, got2

    # times through the C entries, the new kernel in turns against the pair
    k = diff_entries(sd, hw, band)
    diff_ms, pair_ms = turns_ms({"resolve_diff": k["resolve_diff"], "pair": k["pair"]})
    k5_ms, k2f_ms = time_ms(k["winners_f32"]), time_ms(k["expand_f32"])
    wrapped = {"resolve_diff": time_ms(lambda: rr.raster_images_diff(sd, hw, band)),
               "winners_f32": time_ms(lambda: rr.winners_f32(sd, hw, band))}
    diff_plain = time_ms(lambda: rr.raster_images_diff_plain(sd, hw, band), reps=2)
    k5_plain = time_ms(lambda: rr.winners_f32_plain(sd, hw, band), reps=2)
    # yardsticks: segment_reduce over the in-band runs (the reduction only,
    # without the head search, the band test and the ranks), and with
    # index_copy_ of the per-pixel rows into a dense (H*W, 5) image
    z = sd.zbits.view(torch.float32)
    head_z = depth_f[sd.pix.clamp(max=hw - 1).long()]
    in_band = (sd.pix < hw) & ~(z > head_z + band)
    data = sd.rgb[in_band]
    lengths = cnt_f[cnt_f > 0].to(torch.int64)
    if int(lengths.sum()) != data.shape[0]:
        fail("segment_reduce yardstick: in-band runs do not match the counts")
    lib = time_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=0))
    occupied = (cnt_f > 0).nonzero()[:, 0]
    dense = torch.zeros((hw, 5), dtype=torch.float32, device=M.device)

    def library():
        red = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
        dense.index_copy_(0, occupied, torch.cat([red, cnt_f[occupied, None],
                                                  depth_f[occupied, None]], 1))

    lib_diff = time_ms(library)
    # bytes: rtnr_resolve_diff reads each in-frame element once (pix, z bits,
    # 12 B of colour) and writes sums, count and depth (20 B) a pixel; K5
    # reads 20 B a point and writes 6 x int32 a winner
    bd, byd = bound_ms(20.0 * n_in + 20.0 * hw, 0.0)
    b5, by5 = bound_ms(20.0 * n + 24.0 * t, 0.0)
    rows["resolve_diff"] = dict(ms=diff_ms, plain_ms=diff_plain, bound_ms=bd, bound_by=byd,
                                library_ms=lib_diff, max_abs_err=0.0, previous_ms=pair_ms,
                                wrapper_ms=wrapped["resolve_diff"])
    rows["winners_f32"] = dict(ms=k5_ms, plain_ms=k5_plain, bound_ms=b5, bound_by=by5,
                               library_ms=lib, max_abs_err=0.0,
                               wrapper_ms=wrapped["winners_f32"])
    rows["expand"]["float_sums_ms"] = k2f_ms
    log(f"rtnr_resolve_diff (C entry): {diff_ms:.4f} ms against K5 + K2 float_sums "
        f"(rtnr_winners_f32's three launches + rtnr_expand) {pair_ms:.4f} in turns "
        f"({pair_ms / diff_ms:.2f}x); bound {bd:.4f} {byd} ({bd / diff_ms:.3f} of it); plain "
        f"{diff_plain:.4f}; segment_reduce + index_copy_ {lib_diff:.4f}; through its wrapper "
        f"{wrapped['resolve_diff']:.4f}")
    log(f"K5 winners_f32 (C entry): {k5_ms:.4f} ms (plain {k5_plain:.4f}, bound {b5:.4f} {by5}, "
        f"segment_reduce {lib:.4f}, through its wrapper {wrapped['winners_f32']:.4f}); K2 "
        f"float_sums (C entry, on K5's rows) {k2f_ms:.4f} ms")
    if not diff_ms < pair_ms:
        fail("rtnr_resolve_diff is not faster than the K5 + K2 pair it replaced")
    del data, lengths, in_band, head_z, sd, wimg, k, dense, occupied, pair, got

    # the differentiable raster's forward and backward, as the scene step runs them
    cols = colors.detach().clone().requires_grad_(True)
    Mg = M.detach().clone().requires_grad_(True)
    g = torch.randn((HEIGHT, WIDTH, 3), device=M.device, generator=torch.Generator(
        device=M.device).manual_seed(SEED))
    out = {}

    def fwd():
        out["o"] = rd.rasterize_diff_sorted(points, cols, Mg, width=WIDTH, height=HEIGHT,
                                            valid=valid, depth_band=band)

    def bwd():
        o = out["o"]
        loss = torch.sum(o.rgb * g) + 1e-6 * torch.sum(torch.where(o.mask, o.depth, 0.0))
        loss.backward()

    fwd_ms = time_ms(fwd)
    bwd_ms = time_ms(lambda: (fwd(), bwd()), reps=3) - fwd_ms
    if not (bool(torch.isfinite(cols.grad).all()) and float(Mg.grad.abs().sum()) > 0):
        fail("diff raster gradients are not finite or the pose gradient is zero")
    log(f"diff raster at {WIDTH}x{HEIGHT}, {n} points: forward {fwd_ms:.4f} ms, "
        f"backward {bwd_ms:.4f} ms")
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def train_phase(renderer, cam, E, variables, counted):
    """Both train steps at full width on the scene: targets are the scene's
    own render_rgbd frames (the CLI's --self-supervised); 1 warm-up + TRAIN_STEPS
    timed steps each, bf16 U-Net, batch 1. Launch counts are reset just
    before each step kind and read just after."""
    import torch
    from rtnr_tpu_torch.pipeline import render_rgbd
    from rtnr_tpu_torch.train import trainer as tt

    M = renderer._cam_proj(cam, E)
    cams = M[None]
    targets = render_rgbd(renderer.points, renderer.colors, renderer.valid, M, width=WIDTH,
                          height=HEIGHT)["rgb"][None].float() / 255.0
    result = {}

    def run(name, state, step, args, need, absent=()):
        for fn in counted.values():
            fn.launches = 0
        stats0 = state.model.param("down0/bn0/mean").clone()
        ms, enq, mem, losses = [], [], [], []
        for i in range(1 + TRAIN_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, *args)
            t1 = time.perf_counter()  # the host has enqueued the whole step
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
                enq.append((t1 - t0) * 1e3)
            mem.append(torch.cuda.max_memory_allocated() / 2**30)
            losses.append(float(m["loss"]))
        launches = {k: fn.launches for k, fn in counted.items()}
        log(f"{name}: launches over {1 + TRAIN_STEPS} steps {launches}")
        for k in need:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the {name} path")
        if launches["bn_train"] != 18 * (1 + TRAIN_STEPS):  # every BatchNorm of every step
            fail(f"{name}: {launches['bn_train']} BatchNorm layers on the fused kernels in "
                 f"{1 + TRAIN_STEPS} steps, not 18 a step")
        for k in absent:
            if launches[k]:
                fail(f"kernel {k} was launched on the {name} path")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: non-finite loss {losses}")
        if torch.equal(stats0, state.model.param("down0/bn0/mean")):
            fail(f"{name}: batch_stats did not move")
        med, enq_med = statistics.median(ms), statistics.median(enq)
        log(f"{name}: ms/step median {med:.3f} (all {[round(v, 3) for v in ms]}), host "
            f"enqueue median {enq_med:.3f} ms, peak device memory per step "
            f"{[round(v, 3) for v in mem]} GiB, losses {[round(v, 5) for v in losses]}")
        result[name] = {"ms_per_step": med, "enqueue_ms": enq_med, "steps": len(ms),
                        "peak_mem_gib": max(mem), "losses": losses, "launches": launches}
        return state, m

    state = tt.create_train_state(variables, dtype=torch.bfloat16, device="cuda")
    step = tt.make_train_step(width=WIDTH, height=HEIGHT)
    run("train_step", state, step,
        (renderer.points, renderer.colors, renderer.valid, cams, targets),
        ("resolve4", "bn_train", "prefilter"), absent=("winners", "expand"))
    del state
    torch.cuda.empty_cache()

    sstate = tt.create_scene_train_state(variables, renderer.colors, cams,
                                         dtype=torch.bfloat16, device="cuda")
    cols0, cams0 = sstate.colors.detach().clone(), sstate.cam_projs.detach().clone()
    sstep = tt.make_scene_train_step(width=WIDTH, height=HEIGHT)
    sargs = (renderer.points, renderer.valid, targets)
    sstate, m = run("scene_step", sstate, sstep, sargs, ("resolve_diff", "bn_train"),
                    absent=("winners_f32", "expand", "prefilter"))
    if not (float(m["pose_grad_norm"]) > 0 and float(m["color_grad_norm"]) > 0):
        fail(f"scene_step: zero pose or colour gradient {m}")
    if torch.equal(cols0, sstate.colors.detach()) or torch.equal(cams0, sstate.cam_projs.detach()):
        fail("scene_step: colours or camera matrices did not move")
    log(f"scene_step metrics: " + ", ".join(f"{k} {float(v):.6g}" for k, v in m.items()))
    result["scene_step"]["trace"] = trace_step(lambda: sstep(sstate, *sargs),
                                               result["scene_step"]["ms_per_step"])
    return result


# (H, W, C, layers a step) of the [64,128,256,512] UNetTrain's 18 BatchNorm
# layers at 1088x1920: four at each encoder / decoder level, two in the bottleneck
BN_LAYERS = ((1088, 1920, 64, 4), (544, 960, 128, 4), (272, 480, 256, 4), (136, 240, 512, 4),
             (68, 120, 1024, 2))


def check_bn_train(rows):
    """UNetTrain's BatchNorm + ReLU on ``csrc/bn_train.cu`` at the training
    step's five layer shapes, bf16 (``ops.bn_train.bn_relu_train``): forward
    and backward against the plain layer (``bn_relu_train_plain`` under
    autograd), the output and dx within 2 bf16 ulp of relative norm (one
    rounding each, apart where the f32 sums' order moves a value across a
    rounding boundary), dscale and dbias within 1e-3 (f32 sums over up to
    2.1M elements in two orders); two calls equal bit for bit; then forward +
    backward timed by their device time (``device_ms``: at the deep levels a
    call's host side outlasts its kernels) against the plain layer and
    ``F.batch_norm`` + ``relu`` (the library yardstick; the port never calls
    it), summed over a step's 18 layers, beside the byte bound (6 bytes an
    element forward, 10 backward, at 3.35 TB/s), and the kernels' call also
    by CUDA events around 5 calls (``wall``, host included)."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import bn_train as bt

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "fwd_ms": 0.0,
           "wall_ms": 0.0}
    worst = 0.0
    for h, w, c, layers in BN_LAYERS:
        g = torch.Generator(device="cuda").manual_seed(SEED + c)
        off = torch.randn(c, generator=g, device="cuda") * 0.5
        x = (torch.randn((1, h, w, c), generator=g, device="cuda") * (1 + off.abs()) + off) \
            .to(torch.bfloat16).permute(0, 3, 1, 2).requires_grad_(True)
        dy = torch.randn((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        scale = (torch.rand(c, generator=g, device="cuda") + 0.5).requires_grad_(True)
        bias = (torch.randn(c, generator=g, device="cuda") * 0.3).requires_grad_(True)
        m0, v0 = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")

        def run(layer, m=None, v=None):
            m = m0.clone() if m is None else m
            v = v0.clone() if v is None else v
            y = layer(x, scale, bias, m, v)
            return (y, *torch.autograd.grad(y, (x, scale, bias), dy), m, v)

        def library(x, scale, bias, m, v):
            return torch.relu(Fn.batch_norm(x, m, v, scale, bias, training=True, momentum=0.1,
                                            eps=bt.EPS))

        got, again = run(bt.bn_relu_train), run(bt.bn_relu_train)
        want = run(bt.bn_relu_train_plain)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"bn_relu_train at {h}x{w}x{c}: two calls differ")
        gaps = {k: float((a.detach().float() - b.float()).norm() / b.float().norm())
                for k, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"), got, want)}
        limit = {"y": 2 * 2.0 ** -8, "dx": 2 * 2.0 ** -8, "dscale": 1e-3, "dbias": 1e-3,
                 "mean": 1e-3, "var": 1e-3}
        for k, v in gaps.items():
            if not v <= limit[k]:
                fail(f"bn_relu_train at {h}x{w}x{c}: {k} off the plain layer by {v:.3e} "
                     f"(> {limit[k]:.3e})")
        worst = max(worst, float((got[0].detach().float() - want[0].detach().float())
                                 .abs().max()))
        mk, vk = m0.clone(), v0.clone()
        fwd = device_ms(lambda: bt.bn_relu_train(x, scale, bias, mk, vk))
        ms, plain, lib = (device_ms(lambda: run(layer, mk, vk))
                          for layer in (bt.bn_relu_train, bt.bn_relu_train_plain, library))
        wall = time_ms(lambda: run(bt.bn_relu_train, mk, vk))
        bnd, by = bound_ms(16.0 * h * w * c, 0.0)
        log(f"bn_relu_train {h}x{w}x{c} (x{layers} a step) bf16: forward + backward "
            f"{ms:.4f} ms of device time (forward {fwd:.4f}; wall {wall:.4f}), bound {bnd:.4f} "
            f"{by} ({100 * bnd / ms:.1f}%), plain {plain:.4f}, F.batch_norm + relu {lib:.4f}; "
            "gaps to the plain layer " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bnd),
                     ("fwd_ms", fwd), ("wall_ms", wall)):
            tot[k] += layers * v
        del x, dy, got, again, want
        torch.cuda.empty_cache()
    rows["bn_train"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                            bound_by="bytes", library_ms=tot["library_ms"], max_abs_err=worst,
                            forward_ms=tot["fwd_ms"], wall_ms=tot["wall_ms"])
    log(f"bn_relu_train over a step's 18 layers: {tot['ms']:.4f} ms of device time (forward "
        f"{tot['fwd_ms']:.4f}; wall {tot['wall_ms']:.4f}), bound {tot['bound_ms']:.4f} "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f}%), plain {tot['plain_ms']:.4f}, "
        f"F.batch_norm + relu {tot['library_ms']:.4f}")


def check_prefilter(raw_depth, raw_rgb, rows):
    """The depth prefilter on ``csrc/prefilter.cu`` (``ops.prefilter.filter_frame``)
    against ``pad_to_pyramid`` + ``depth_prefilter`` on the card, bit for bit:
    on the serving raster's frame, an all-empty and a FLT_MAX-saturated frame
    of its shape and 48x80 frames at levels 1-4; two calls equal; one launch
    a call. Then timed at the frame's shape: ``ms`` its device time (profiler),
    ``wall_ms`` by CUDA events around 20 calls (host included: what a frame
    pays), both against the plain path and the byte bound (inputs read once,
    outputs written once, the pyramid written and read once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rtnr_tpu_torch.ops import prefilter as tp

    def plain(d, c, levels=4):
        return tp.depth_prefilter(*tp.pad_to_pyramid(d, c, levels), levels=levels)

    def same(got, want):
        for k in want:
            a, b = got[k], want[k]
            if a.dtype == torch.float32:
                a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
            if a.shape != b.shape or not torch.equal(a, b):
                return False
        return True

    h, w = raw_depth.shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    empty = torch.full_like(raw_depth, FLT_MAX)
    sat = torch.where(torch.rand((h, w), generator=g, device="cuda") < 0.85, empty,
                      torch.rand((h, w), generator=g, device="cuda") * 19 + 1)
    small = torch.where(torch.rand((48, 80), generator=g, device="cuda") < 0.3,
                        torch.full((48, 80), FLT_MAX, device="cuda"),
                        torch.rand((48, 80), generator=g, device="cuda") * 19 + 1)
    small_rgb = torch.randint(0, 256, (48, 80, 3), generator=g, device="cuda",
                              dtype=torch.uint8)
    cases = [("frame", raw_depth, raw_rgb, 4), ("all-empty", empty, raw_rgb, 4),
             ("saturated", sat, raw_rgb, 4),
             *[(f"48x80 at {lv} levels", small, small_rgb, lv) for lv in (1, 2, 3, 4)]]
    n0 = tp.filter_frame.launches
    for name, d, c, lv in cases:
        got, again = tp.filter_frame(d, c, levels=lv), tp.filter_frame(d, c, levels=lv)
        if not same(got, plain(d, c, lv)) or not same(again, got):
            fail(f"prefilter kernels on the {name} frame differ from the plain path")
    if tp.filter_frame.launches != n0 + 2 * len(cases):
        fail(f"filter_frame counted {tp.filter_frame.launches - n0} kernel calls in "
             f"{2 * len(cases)}")
    kept = float(tp.filter_frame(raw_depth, raw_rgb)["mask"].float().mean())

    call = lambda: tp.filter_frame(raw_depth, raw_rgb)  # noqa: E731
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    ops = [e.name.split("(")[0].strip().split(" ")[-1] for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    ms, plain_ms = device_ms(call, reps=20), device_ms(lambda: plain(raw_depth, raw_rgb))
    wall, plain_wall = turns_ms({"kernels": call, "plain": lambda: plain(raw_depth, raw_rgb)})
    hp, wp = tp.pyramid_pad_shape(h, w, 4)
    n_pyr = sum((hp >> k) * (wp >> k) for k in range(1, 5))
    nbytes = 7.0 * h * w + 28.0 * hp * wp + 8.0 * n_pyr
    bnd, by = bound_ms(nbytes, 0.0)
    rows["prefilter"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                             library_ms=None, max_abs_err=0.0, wall_ms=wall)
    log(f"prefilter kernels {h}x{w} (padded {hp}x{wp}, 4 levels): bit-exact on "
        f"{len(cases)} frames, kept {100 * kept:.1f}% of the frame; {len(ops)} device ops a call "
        f"({', '.join(ops)}); device {ms:.4f} ms, bound {bnd:.4f} {by} "
        f"({100 * bnd / ms:.1f}%), wall {wall:.4f} ms a call; plain path device {plain_ms:.4f} "
        f"ms, wall {plain_wall:.4f} ms")


CLI_POSES = ("0 0 0 -12 0 0 0 1", "1 0.3 0 -12 0 0 0 1",
             "2 -0.2 0.1 -11.5 0.0087 0.0175 0 0.9998")  # TUM lines around the bench pose


def host_cli_bench_phase(scene, variables, counted, card, static_ms):
    """The host layer, the render CLI and the bench line on the card: the
    scene written as PLY, a 3-pose TUM trajectory, a COLMAP ``cameras.txt``
    and a ``.msgpack`` checkpoint under a temporary directory; ``Scene.from_file``
    timed cold and through the cache; ``apps.render_trajectory.main`` run in
    process at ``--stage full`` with every launch count set to 0 just before
    and read just after (``rtnr_resolve4`` 1, ``conv_sm90.cu``'s conv 17 and
    ``conv_in_sm90.cu``'s 1 a frame, no int8 kernel), its PNGs equal to
    ``write_png`` of an in-process ``Renderer.compute_full`` at the same poses;
    then ``bench.run`` at 1920x1080 (static int8 with bf16 beside it) and at
    960x720 (falls back to bf16)."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from rtnr_tpu_torch import bench
    from rtnr_tpu_torch.apps import render_trajectory as cli
    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import save_msgpack
    from rtnr_tpu_torch.utils.image import read_png, write_png

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cloud, traj_f = os.path.join(tmp, "cloud.ply"), os.path.join(tmp, "traj.txt")
        calib, ckpt = os.path.join(tmp, "cameras.txt"), os.path.join(tmp, "unet.msgpack")
        cache, outdir = os.path.join(tmp, "cache"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        write_ply(cloud, scene.points, scene.colors)
        with open(traj_f, "w") as f:
            f.write("\n".join(CLI_POSES) + "\n")
        with open(calib, "w") as f:
            f.write(f"1 OPENCV {WIDTH} {HEIGHT} 1100 1100 {WIDTH / 2} {HEIGHT / 2} 0 0 0 0 0\n")
        save_msgpack(ckpt, variables)
        res["write_s"] = time.perf_counter() - t0
        times = {}
        for label, kw in (("cold", {}), ("cache_build", {"cache_dir": cache}),
                          ("cache_hit", {"cache_dir": cache})):
            t0 = time.perf_counter()
            loaded = Scene.from_file(cloud, **kw)
            times[label] = time.perf_counter() - t0
            for k in ("points", "colors", "block_keys"):
                if not np.array_equal(getattr(loaded, k), getattr(scene, k)):
                    fail(f"Scene.from_file ({label}): {k} differs from the written scene")
        res["from_file_s"] = times
        log(f"host layer: PLY + TUM + cameras.txt + msgpack written in {res['write_s']:.3f} s; "
            f"Scene.from_file cold {times['cold']:.3f} s, building the cache "
            f"{times['cache_build']:.3f} s, from the cache {times['cache_hit']:.3f} s")

        for fn in counted.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([cloud, traj_f, calib, "-o", outdir, "--stage", "full", "--ckpt",
                           ckpt, "--depth", "--timings", "--cache-dir", cache])
        launches = {k: fn.launches for k, fn in counted.items()}
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            log(f"  cli| {line}")
        if rc != 0:
            fail(f"render CLI exited {rc}")
        n = len(CLI_POSES)
        names = sorted(os.listdir(outdir))
        want = sorted([f"frame_{i + 1}.png" for i in range(n)]
                      + [f"frame_{i + 1}_depth.png" for i in range(n)])
        if names != want:
            fail(f"render CLI wrote {names}, not {want}")
        log(f"render CLI launches over {n} frames: {launches}")
        per_frame = {"resolve4": 1, "conv3x3_wgmma": 17, "conv3x3_in": 1, "convt2x2_wgmma": 4,
                     "winners": 0, "expand": 0, "conv3x3_static_wgmma": 0,
                     "conv3x3_dyn_wgmma": 0, "convt2x2_static_wgmma": 0, "conv3x3_up": 0}
        for k, m in per_frame.items():
            if launches[k] != m * n:
                fail(f"render CLI: {k} launched {launches[k]} times in {n} frames, not {m} a frame")
        rec = json.loads(lines[-1])
        res.update(cli=rec, launches=launches)
        # the same frames in process: the PNGs must be the same bytes
        cam = Camera.load_calibration(calib)
        traj = Trajectory.load(traj_f)
        r = Renderer(Scene.from_file(cloud, cache_dir=cache), RenderConfig(), variables,
                     cull_budget="auto", device="cuda")
        split = {"compute_full_ms": [], "write_png_ms": []}
        for i in range(n):
            t0 = time.perf_counter()
            frame = r.compute_full(cam, traj.world_to_cam(i))
            t1 = time.perf_counter()
            ref = os.path.join(tmp, "want.png")
            write_png(ref, frame["rgb"])
            split["compute_full_ms"].append((t1 - t0) * 1e3)
            split["write_png_ms"].append((time.perf_counter() - t1) * 1e3)
            with open(ref, "rb") as a, open(os.path.join(outdir, f"frame_{i + 1}.png"), "rb") as b:
                if a.read() != b.read():
                    fail(f"render CLI frame {i + 1} differs from compute_full's PNG")
            if read_png(os.path.join(outdir, f"frame_{i + 1}_depth.png")).shape != (HEIGHT, WIDTH):
                fail("render CLI depth PNG has the wrong shape")
        del r, frame
        res["split"] = split
        torch.cuda.empty_cache()
        res["parallel_cli"] = parallel_cli_runs([cloud, traj_f, calib], ckpt, cache, outdir, tmp,
                                                card)
        log(f"render CLI --stage full at {WIDTH}x{HEIGHT}, {POINTS} points: {n} PNGs equal to "
            f"compute_full's, {n} depth PNGs; {rec['fps']} fps over {rec['frames']} frames "
            f"({rec['seconds']} s, PNG writes included) on {card}; in process, compute_full "
            f"{[round(v, 3) for v in split['compute_full_ms']]} ms and write_png of the RGB "
            f"frame {[round(v, 3) for v in split['write_png_ms']]} ms a frame")
    torch.cuda.empty_cache()

    rec = bench.run(n_points=POINTS, width=WIDTH, height=HEIGHT, frames=5, trials=1)
    log(json.dumps(rec))
    fields = {"metric", "value", "unit", "vs_baseline", "trials", "unet_int8", "batch",
              "points_per_s", "pixels_per_s", "ms_per_frame", "fps_bf16_exact",
              "ms_per_frame_bf16", "device"}
    if set(rec) != fields or rec["unet_int8"] != "static" or not rec["value"] > 0:
        fail(f"bench line at {WIDTH}x{HEIGHT}: fields {sorted(rec)}, mode {rec['unet_int8']}")
    log(f"bench line at {WIDTH}x{HEIGHT} ({card}): static int8 {rec['ms_per_frame']} ms/frame "
        f"({rec['value']} fps), bf16 {rec['ms_per_frame_bf16']} ms/frame; phase 7's "
        f"compute_full_tensors static median {static_ms:.3f} ms/frame (a different loop)")
    res["bench"] = rec
    torch.cuda.empty_cache()
    rec = bench.run(n_points=POINTS, width=960, height=720, frames=2, trials=1)
    log(json.dumps(rec))
    if rec["unet_int8"] != "off" or "fps_bf16_exact" in rec:
        fail(f"bench line at 960x720 did not fall back to bf16: {rec}")
    res["bench_960x720"] = rec
    return res


TRAIN_CLI_STEPS = 150  # scripts/train_demo_r5.py of the JAX package
TRAIN_CLI_W, TRAIN_CLI_H = 640, 352


def train_demo_scene():
    """scripts/train_demo_r5.py's scene: 400,000 points on a back wall, a
    floor and two side walls, coloured per wall with seeded noise (seed 7):
    (points f32, colours u8)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n = 400_000
    walls, cols = [], []
    for k in range(4):
        m = n // 4
        p = rng.uniform(-4, 4, (m, 3))
        if k == 0:
            p[:, 2] = 6.0 + 0.05 * rng.standard_normal(m)  # back wall
            c = np.stack([200 + 0 * p[:, 0], 60 + 20 * p[:, 0], 60 + 10 * p[:, 1]], 1)
        elif k == 1:
            p[:, 1] = 3.0 + 0.05 * rng.standard_normal(m)  # floor
            c = np.stack([60 + 10 * p[:, 0], 180 + 0 * p[:, 0], 60 + 10 * p[:, 2]], 1)
        elif k == 2:
            p[:, 0] = -4.0 + 0.05 * rng.standard_normal(m)
            p[:, 2] = rng.uniform(0, 6, m)
            c = np.stack([60 + 0 * p[:, 1], 60 + 10 * p[:, 1], 200 + 5 * p[:, 2]], 1)
        else:
            p[:, 0] = 4.0 + 0.05 * rng.standard_normal(m)
            p[:, 2] = rng.uniform(0, 6, m)
            c = np.stack([200 + 0 * p[:, 1], 180 + 5 * p[:, 1], 60 + 0 * p[:, 2]], 1)
        walls.append(p)
        cols.append(np.clip(c + 10 * rng.standard_normal(c.shape), 0, 255))
    return np.concatenate(walls).astype(np.float32), np.concatenate(cols).astype(np.uint8)


def train_cli_phase(card):
    """The port's counterpart of the JAX package's scripts/train_demo_r5.py:
    the demo scene as PLY, a 16-pose TUM trajectory and a 640x352
    calibration (fx 420) under a temporary directory; ``python -m
    rtnr_tpu_torch.apps.train_unet ... --self-supervised --steps 150 --lr
    2e-4`` in a subprocess (full-width bf16 U-Net from ``init_unet_numpy(0)``,
    one frame a step); the last logged loss must be below the first; then
    the checkpoint reloaded with the port's ``load_unet_variables`` and pose 8
    rendered by ``compute_full`` (exact bf16) with the trained and the
    untrained net: the trained net's L1 to the self-supervised target must
    be the lower."""
    import os
    import tempfile

    import numpy as np
    import torch
    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        ply, traj, calib = (os.path.join(d, f) for f in ("scene.ply", "traj.txt", "calib.txt"))
        ckpt = os.path.join(d, "unet.msgpack")
        write_ply(ply, *train_demo_scene())
        with open(traj, "w") as f:
            for i in range(16):
                t = i / 15.0
                f.write(f"{i:.1f} {-1.0 + 2.0 * t:.4f} {0.2:.4f} {-2.0 - 1.0 * t:.4f} 0 0 0 1\n")
        fx = 420.0
        with open(calib, "w") as f:
            f.write(f"{TRAIN_CLI_W} {TRAIN_CLI_H}\n{fx} 0 {TRAIN_CLI_W / 2}\n0 {fx} "
                    f"{TRAIN_CLI_H / 2}\n0 0 1\n0 0 0 0 0\n0\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        cmd = [sys.executable, "-m", "rtnr_tpu_torch.apps.train_unet", ply, traj, calib,
               "--self-supervised", "--steps", str(TRAIN_CLI_STEPS), "--lr", "2e-4", "-o", ckpt,
               "--log-every", "10"]
        log("train CLI: " + " ".join(os.path.basename(c) if c.startswith(d) else c
                                     for c in cmd[1:]))
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        for line in r.stdout.strip().splitlines():
            log(f"  train| {line}")
        if r.returncode != 0:
            fail(f"train CLI exited {r.returncode}: {r.stderr[-4000:]}")
        logs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
        if not logs or logs[-1]["step"] != TRAIN_CLI_STEPS - 1:
            fail(f"train CLI logged {len(logs)} lines, not through step {TRAIN_CLI_STEPS - 1}")
        if not logs[-1]["loss"] < logs[0]["loss"]:
            fail(f"train CLI: the loss did not fall ({logs[0]['loss']} -> {logs[-1]['loss']})")
        # steps after the first logged one, over the CLI's own clock (0.1 s resolution)
        span = logs[-1]["sec"] - logs[0]["sec"]
        ms_step = span / (logs[-1]["step"] - logs[0]["step"]) * 1e3

        cam = Camera.load_calibration(calib)
        E = Trajectory.load(traj).world_to_cam(8)
        scene = Scene.from_file(ply)
        target, outs = None, {}
        for tag, variables in (("untrained", init_unet_numpy(0, (64, 128, 256, 512))),
                               ("trained", load_unet_variables(ckpt))):
            rdr = Renderer(scene, RenderConfig(unet_int8="off"), variables, device="cuda")
            if target is None:
                target = rdr.compute_rgbd(cam, E)["rgb"].astype(np.float32) / 255.0
            outs[tag] = rdr.compute_full(cam, E)["rgb_f"]
            del rdr
        torch.cuda.empty_cache()
        par_cli = parallel_train_cli(ply, traj, calib, d, card)
    l1 = {k: float(np.abs(v - target).mean()) for k, v in outs.items()}
    if not l1["trained"] < l1["untrained"]:
        fail(f"train CLI: the trained net's L1 {l1['trained']} is not below the untrained "
             f"net's {l1['untrained']}")
    res = {"steps": TRAIN_CLI_STEPS, "resolution": f"{TRAIN_CLI_W}x{TRAIN_CLI_H}",
           "loss_first": logs[0]["loss"], "loss_last": logs[-1]["loss"], "wall_s": wall_s,
           "steps_per_s_incl_startup": TRAIN_CLI_STEPS / wall_s, "ms_per_step": ms_step,
           "steps_per_s": 1e3 / ms_step, "render_l1_untrained": l1["untrained"],
           "render_l1_trained": l1["trained"], "card": card, "two_ranks": par_cli}
    log(f"train CLI at {TRAIN_CLI_W}x{TRAIN_CLI_H}, 400,000 points, {TRAIN_CLI_STEPS} steps on "
        f"{card}: loss {logs[0]['loss']:.5f} -> {logs[-1]['loss']:.5f}; {ms_step:.2f} ms/step "
        f"({1e3 / ms_step:.2f} steps/s, CLI clock, steps {logs[0]['step']}-{logs[-1]['step']}); "
        f"{wall_s:.2f} s wall with start-up ({TRAIN_CLI_STEPS / wall_s:.2f} steps/s); pose 8 "
        f"compute_full L1 to the target: untrained {l1['untrained']:.5f}, trained "
        f"{l1['trained']:.5f} ({l1['untrained'] / l1['trained']:.2f}x lower)")
    return res


E57_PHOTOS = 6  # embedded 1920x1080 photos, poses along bench.py's trajectory
E57_TRAIN_STEPS = 20  # steps of the training CLI on the pairs (cut these first for time)
E57_JPEG_QUALITY = 95


class StampedLines:
    """A stand-in for stdout that keeps each complete line with the host
    clock (``time.perf_counter``) at which its end arrived."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text):
        now = time.perf_counter()
        *done, self._part = (self._part + text).split("\n")
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        pass


def e57_poses():
    """bench.py's trajectory: the camera 12 m from the cloud, moved sideways
    (its ``M0[0, 3] += dx * k``), one pose a photo."""
    import numpy as np

    poses = []
    for k in range(E57_PHOTOS):
        E = np.eye(4)
        E[0, 3], E[2, 3] = -0.5 + 0.2 * k, 12.0
        poses.append(E)
    return poses


def e57_phase(card, counted):
    """The E57 chain on the card: the 5M-point scene as one scanner file
    (ScaledInteger coordinates at 0.1 mm, colours with their limits, the scan
    pose at identity) with six embedded 1920x1080 photos (``encode_jpeg``,
    quality 95, 4:2:0, of ``compute_rgbd`` at poses along bench.py's
    trajectory); ``Scene.from_file`` timed cold, building the cache and from
    it; the JPEG decode timed per photo; ``python -m
    rtnr_tpu_torch.apps.generate_pairs`` in a subprocess (exit 0, 6 frames, 6
    depth files, traj.txt, calib.txt); each pair's depth and projection equal
    bit for bit to a direct ``compute_rgbd`` at the written pose of the scene
    read back, its pose within 1e-9 and its K equal, its photo within the
    JPEG's loss of the rendered source (8x8 block means); a
    ``trace.capture`` of one render holding the ``e57.pairs.render`` span and
    the ``resolve4_tile`` kernel. The launch counts are set to 0 just before
    each of three paths and read just after: the pairs CLI run again in
    process (``generate_pairs.main``; its files must equal the subprocess's),
    the training CLI in process (``train_unet.main scan.e57 traj.txt
    calib.txt --targets pairs``, full-width bf16 at 1920x1080, finite losses,
    each step timed by the host clock between its log lines; its ``python
    -m`` entry runs in ``train_cli_phase``) and the trained checkpoint
    reloaded and rendered by ``compute_full``. The direct reference renders
    are not counted."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch
    from rtnr_tpu_torch.apps import generate_pairs, train_unet
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.data.e57_write import E57Image, scan_from_arrays, write_e57
    from rtnr_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from rtnr_tpu_torch.data.native import NativeE57
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils import trace
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables
    from rtnr_tpu_torch.utils.image import read_png

    res = {"card": card}
    timer = trace.StageTimer()
    scene = Scene.synthetic(POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    poses = e57_poses()
    src = Renderer(scene, device="cuda")
    photos = [src.compute_rgbd(cam, E)["rgb"] for E in poses]
    del src
    t0 = time.perf_counter()
    blobs = [encode_jpeg(p, E57_JPEG_QUALITY, "4:2:0") for p in photos]
    res["encode_ms_per_photo"] = (time.perf_counter() - t0) * 1e3 / len(blobs)

    D = np.diag([1.0, -1.0, -1.0, 1.0])
    flen = 0.0055  # m; pixel pitch flen / 1100 gives fx = fy = 1100

    def image_pose(E):  # the E57 pose whose getImage gives world_to_cam == E
        from rtnr_tpu_torch.apps.generate_pairs import rotmat_to_quat

        P = np.linalg.inv(E) @ D
        return (*rotmat_to_quat(P[:3, :3]), P[0, 3], P[1, 3], P[2, 3])

    images = [E57Image(jpeg_bytes=b, name=f"photo{k}", pose=image_pose(E), image_width=WIDTH,
                       image_height=HEIGHT, focal_length=flen, pixel_width=flen / 1100.0,
                       pixel_height=flen / 1100.0, principal_point_x=WIDTH / 2,
                       principal_point_y=HEIGHT / 2)
              for k, (b, E) in enumerate(zip(blobs, poses))]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scan.e57")
        with timer.stage("write"):
            write_e57(path, [scan_from_arrays(scene.points, scene.colors,
                                              pose=(1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0))], images)
        res["write_s"] = timer.stages["write"] / 1e3
        res["file_mb"] = os.path.getsize(path) / 1e6
        log(f"e57: wrote {POINTS} points (ScaledInteger 0.1 mm) + {len(images)} photos "
            f"({WIDTH}x{HEIGHT}, JPEG q{E57_JPEG_QUALITY} 4:2:0, encode "
            f"{res['encode_ms_per_photo']:.1f} ms a photo): {res['write_s']:.3f} s, "
            f"{res['file_mb']:.3f} MB ({card})")

        cache = os.path.join(d, "cache")
        with timer.stage("read_cold"):
            cold = Scene.from_file(path)
        with timer.stage("read_cache_build"):
            Scene.from_file(path, cache_dir=cache)
        with timer.stage("read_cached"):
            read = Scene.from_file(path, cache_dir=cache)
        res["from_file_s"] = {k: timer.stages[k] / 1e3
                              for k in ("read_cold", "read_cache_build", "read_cached")}
        if read.n_points != POINTS or cold.n_points != POINTS:
            fail(f"e57: Scene.from_file read {read.n_points} points, not {POINTS}")
        for k in ("points", "colors", "block_keys"):
            if not np.array_equal(getattr(cold, k), getattr(read, k)):
                fail(f"e57: the cached scene's {k} differs from the cold read")
        if not np.array_equal(read.colors, scene.colors):
            fail("e57: colours read back differ from the written ones")
        dq = float(np.abs(read.points.astype(np.float64) - scene.points).max())
        if dq > 6e-5:
            fail(f"e57: points read back {dq} m from the written ones (0.1 mm grid)")
        del cold
        log(f"e57: Scene.from_file {POINTS} points: cold {res['from_file_s']['read_cold']:.3f} s, "
            f"building the cache {res['from_file_s']['read_cache_build']:.3f} s, cached "
            f"{res['from_file_s']['read_cached']:.3f} s; max |read - written| {dq:.3g} m ({card})")

        dec_ms, block_err = [], []
        with NativeE57(path) as r:
            if r.image_count != E57_PHOTOS:
                fail(f"e57: {r.image_count} embedded photos, not {E57_PHOTOS}")
            for k in range(r.image_count):
                blob = r.read_blob(k)
                t0 = time.perf_counter()
                img = decode_jpeg(blob)
                dec_ms.append((time.perf_counter() - t0) * 1e3)
                got = img.astype(np.float64).reshape(HEIGHT // 8, 8, WIDTH // 8, 8, 3)
                want = photos[k].astype(np.float64).reshape(HEIGHT // 8, 8, WIDTH // 8, 8, 3)
                block_err.append(float(np.abs(got.mean(axis=(1, 3))
                                              - want.mean(axis=(1, 3))).mean()))
        res["decode_ms_per_photo"] = dec_ms
        res["photo_block_mean_err"] = block_err
        log(f"e57: JPEG decode {[round(v, 3) for v in dec_ms]} ms a {WIDTH}x{HEIGHT} photo "
            f"(host); 8x8 block-mean error to the rendered source {[round(v, 4) for v in block_err]} "
            f"({card})")
        if max(block_err) >= 10.0:  # tests/test_pairs.py:94-99 of the JAX package
            fail(f"e57: a decoded photo is {max(block_err)} from its source in 8x8 block means")

        out = os.path.join(d, "pairs")
        cmd = [sys.executable, "-m", "rtnr_tpu_torch.apps.generate_pairs", path, "-o", out,
               "--cache-dir", os.path.join(d, "cli_cache")]
        with timer.stage("pairs"):
            r = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True,
                               timeout=600)
        for line in r.stdout.strip().splitlines():
            log(f"  pairs| {line}")
        if r.returncode != 0:
            fail(f"generate_pairs CLI exited {r.returncode}: {r.stderr[-4000:]}")
        res["pairs_cli_s"] = timer.stages["pairs"] / 1e3
        names = sorted(os.listdir(out))
        want = sorted([f"frame_{i + 1}.png" for i in range(E57_PHOTOS)]
                      + [f"depth_{i + 1}.npz" for i in range(E57_PHOTOS)]
                      + ["traj.txt", "calib.txt"])
        if names != want:
            fail(f"generate_pairs CLI wrote {names}, not {want}")
        log(f"e57: generate_pairs CLI {res['pairs_cli_s']:.3f} s for {E57_PHOTOS} pairs "
            f"(a subprocess: start-up, decode, cache, renders, PNG and npz writes; {card})")

        # the same CLI in process, every count set to 0 just before it and read just after
        out_in = os.path.join(d, "pairs_in_process")
        for fn in counted.values():
            fn.launches = 0
        buf = io.StringIO()
        with timer.stage("pairs_in_process"), contextlib.redirect_stdout(buf):
            rc = generate_pairs.main([path, "-o", out_in, "--cache-dir",
                                      os.path.join(d, "cli_cache_in_process")], device="cuda")
        launches = {"pairs_cli": {k: fn.launches for k, fn in counted.items()}}
        for line in buf.getvalue().strip().splitlines():
            log(f"  pairs (in process)| {line}")
        if rc != 0:
            fail(f"generate_pairs CLI in process exited {rc}")
        if sorted(os.listdir(out_in)) != want:
            fail(f"generate_pairs CLI in process wrote {sorted(os.listdir(out_in))}, not {want}")
        for name in want:
            a, b = os.path.join(out, name), os.path.join(out_in, name)
            if name.endswith(".npz"):
                za, zb = np.load(a), np.load(b)
                same = sorted(za.files) == sorted(zb.files) and all(
                    np.array_equal(za[k], zb[k]) for k in za.files)
            else:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    same = fa.read() == fb.read()
            if not same:
                fail(f"e57: {name} of the CLI in process differs from the subprocess's")
        log(f"e57: generate_pairs CLI in process {timer.stages['pairs_in_process'] / 1e3:.3f} s, "
            f"its files equal to the subprocess's; launches {launches['pairs_cli']}")

        # each pair against a direct render of the scene read back, at the written pose
        # (these renders are the reference side: their launches are not counted)
        rr = Renderer(read, device="cuda")
        npz = [np.load(os.path.join(out, f"depth_{i + 1}.npz")) for i in range(E57_PHOTOS)]
        direct = [rr.compute_rgbd(Camera(K=z["K"], width=WIDTH, height=HEIGHT,
                                         dists=(0.0,) * 5), z["world_to_cam"]) for z in npz]
        torch.cuda.synchronize()
        for i, (z, ref, E) in enumerate(zip(npz, direct, poses)):
            if not np.allclose(z["world_to_cam"], E, rtol=0, atol=1e-9):
                fail(f"e57 pair {i + 1}: world_to_cam {z['world_to_cam']} is not the written pose")
            if not np.allclose(z["K"], cam.K, rtol=1e-12, atol=0):
                fail(f"e57 pair {i + 1}: K {z['K']} differs from the written intrinsics")
            if not (same_bits([torch.from_numpy(z["depth"])], [torch.from_numpy(ref["depth"])])
                    and np.array_equal(z["proj_rgb"], ref["rgb"])):
                fail(f"e57 pair {i + 1}: depth / projection differ from a direct compute_rgbd")
            if not np.array_equal(read_png(os.path.join(out, f"frame_{i + 1}.png")),
                                  decode_jpeg(blobs[i])):
                fail(f"e57 pair {i + 1}: the photo PNG is not the decoded JPEG")
        occ = [float((z["depth"] < 3e38).mean()) for z in npz]
        log(f"e57: {E57_PHOTOS} pairs equal to direct compute_rgbd renders at their poses (depth "
            f"bits, projection), poses within 1e-9, K equal; occupancy "
            f"{[round(v, 4) for v in occ]}")
        if min(occ) < 0.05:
            fail(f"e57: a pair sees too little of the cloud (occupancy {min(occ)})")

        trace_dir = os.path.join(d, "trace")
        with trace.capture(trace_dir):
            with trace.span("e57.pairs.render"):
                rr.compute_rgbd(cam, poses[0])
            torch.cuda.synchronize()
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        span = [e for e in events if e.get("name") == "e57.pairs.render"]
        kern = [e for e in events if "resolve4_tile" in str(e.get("name", ""))
                and e.get("cat") == "kernel"]
        log(f"e57 trace: {len(span)} e57.pairs.render span(s), {len(kern)} resolve4_tile kernel "
            f"event(s), {len(events)} events")
        if not span or not kern:
            fail("e57 trace lacks the e57.pairs.render span or the resolve4_tile kernel")
        res["trace"] = {"spans": len(span), "resolve4_tile": len(kern),
                        "resolve4_tile_us": [e.get("dur") for e in kern]}
        del rr, direct
        torch.cuda.empty_cache()

        # the training CLI in process on the pairs, counted as the pairs CLI is; each step
        # logs after reading its loss back (a device sync), and every log line is stamped
        # with the host clock as it arrives, so a step is the interval between two lines
        ckpt = os.path.join(d, "unet.msgpack")
        for fn in counted.values():
            fn.launches = 0
        stamped = StampedLines()
        with timer.stage("train"), contextlib.redirect_stdout(stamped):
            rc = train_unet.main([path, os.path.join(out, "traj.txt"),
                                  os.path.join(out, "calib.txt"), "--targets", out, "--steps",
                                  str(E57_TRAIN_STEPS), "-o", ckpt, "--log-every", "1"],
                                 device="cuda")
        launches["train_cli"] = {k: fn.launches for k, fn in counted.items()}
        for _, line in stamped.lines[-4:]:
            log(f"  train| {line}")
        if rc != 0:
            fail(f"train CLI on the E57 pairs exited {rc}")
        steps = [(t, json.loads(line)) for t, line in stamped.lines if line.startswith("{")]
        logs = [v for _, v in steps]
        if len(logs) != E57_TRAIN_STEPS or not all(math.isfinite(v["loss"]) for v in logs):
            fail(f"train CLI on the E57 pairs: {len(logs)} log lines, losses "
                 f"{[v['loss'] for v in logs]}")
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(steps, steps[1:])]
        res["train"] = {"steps": E57_TRAIN_STEPS, "cli_s": timer.stages["train"] / 1e3,
                        "loss_first": logs[0]["loss"], "loss_last": logs[-1]["loss"],
                        "ms_per_step": statistics.fmean(step_ms),
                        "ms_per_step_median": statistics.median(step_ms),
                        "ms_per_step_min": min(step_ms), "ms_per_step_max": max(step_ms)}
        log(f"e57: train CLI on the pairs at {WIDTH}x{HEIGHT}, {E57_TRAIN_STEPS} steps, bf16 "
            f"(64, 128, 256, 512): loss {logs[0]['loss']:.5f} -> {logs[-1]['loss']:.5f}; "
            f"{res['train']['ms_per_step']:.3f} ms a step (mean of steps 1-"
            f"{E57_TRAIN_STEPS - 1}, median {res['train']['ms_per_step_median']:.3f}, min "
            f"{min(step_ms):.3f}, max {max(step_ms):.3f}; host perf_counter between the "
            f"steps' log lines), {res['train']['cli_s']:.3f} s with start-up; launches "
            f"{launches['train_cli']} ({card})")

        rt = Renderer(read, RenderConfig(unet_int8="off"), load_unet_variables(ckpt),
                      device="cuda")
        for fn in counted.values():
            fn.launches = 0
        with timer.stage("render"):
            frame = rt.compute_full(cam, poses[0])
        launches["render"] = {k: fn.launches for k, fn in counted.items()}
        if frame["rgb"].shape != (HEIGHT, WIDTH, 3) or not np.isfinite(frame["rgb_f"]).all():
            fail("e57: the trained checkpoint's compute_full is not a finite 1080p frame")
        del rt, read
    torch.cuda.empty_cache()
    # the pairs CLI runs the v4 resolve and nothing else of the port's kernels; the
    # training CLI that and the 18 fused BatchNorm layers a step (its convs are plain
    # torch); the trained frame runs the bf16 U-Net
    need = {"pairs_cli": {"resolve4": E57_PHOTOS},
            "train_cli": {"resolve4": E57_TRAIN_STEPS, "bn_train": 18 * E57_TRAIN_STEPS,
                          "prefilter": E57_TRAIN_STEPS},
            "render": {"resolve4": 1, "prefilter": 1, "conv3x3": 18, "conv3x3_wgmma": 17, "convt2x2": 4,
                       "convt2x2_wgmma": 4, "conv3x3_in": 1, "conv3x3_in_i8out": 1}}
    for part, counts in need.items():
        for k in counted:
            if launches[part][k] != counts.get(k, 0):
                fail(f"e57 path, {part}: {k} launched {launches[part][k]} times, not "
                     f"{counts.get(k, 0)}")
    res["launches"] = launches
    res["stage_line"] = timer.line()
    log(f"e57: {timer.line()} (ms; {card})")
    return res


def trace_step(run, step_ms: float):
    """torch.profiler over one step: device busy time (device-side events)
    against the unprofiled step, and the top device kernels."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += e.device_time_total / 1e3
            per_name[e.name][1] += 1
    busy = sum(v[0] for v in per_name.values())
    if busy <= 0:
        log("trace: device time not measured (the profiler saw no device events)")
        return None
    log(f"trace of one scene step: device busy {busy:.3f} ms; unprofiled step {step_ms:.3f} ms "
        f"-> idle share {max(0.0, 1 - busy / step_ms):.4f}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        log(f"  {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    # the kernels above are mostly generic elementwise templates: attribute
    # device time to the torch ops (forward and backward) that launched them
    ops = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:15]
    log("trace of one scene step by torch op (self device time):")
    for e in ops:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    return {"busy_ms": busy, "top": [[name[:60], ms, n] for name, (ms, n) in top[:8]],
            "top_ops": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in ops[:8]]}


def check_small_train_vs_cpu():
    """One scene step at 32x32, features (8, 16), f32 (TF32 off), on the card
    against the same step on the CPU (whose plain twins the tests hold
    against the JAX package): loss and gradient norms within rtol 1e-3."""
    import numpy as np
    import torch
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt

    pts, cols, valid = Scene.synthetic(8192, seed=0, extent=6.0).sorted_by_block().device_arrays(64)
    cam = Camera.from_params(30, 30, 16, 16, 32, 32)
    Es = [np.eye(4), np.eye(4)]
    Es[0][2, 3], Es[1][2, 3] = 8.0, 8.2
    cams = np.stack([cam.cam_proj(e) for e in Es]).astype(np.float32)
    targets = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = init_unet_numpy(0, (8, 16))
    out = {}
    for dev in ("cuda", "cpu"):
        st = tt.create_scene_train_state(variables, cols, cams, learning_rate=1e-3, device=dev)
        step = tt.make_scene_train_step(width=32, height=32, levels=3)
        t = lambda a: torch.from_numpy(a).to(dev)
        _, m = step(st, t(pts), t(valid), t(targets))
        out[dev] = {k: float(v) for k, v in m.items()}
    for k, v in out["cpu"].items():
        if not abs(out["cuda"][k] - v) <= 1e-3 * abs(v):
            fail(f"small scene step: {k} on the card {out['cuda'][k]} vs CPU {v}")
    log(f"small scene step (32x32, f32), card vs CPU within rtol 1e-3: {out['cuda']}")


def in_conv_kernel(x, w):
    """One launch of ``conv_in_sm90.cu``'s entry on ``x`` and the prepared
    weights ``w`` (ReLU), its arguments bound once: the kernel's time without
    the Python wrapper's checks and allocation (the yardsticks it is timed
    against are C++ calls)."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import conv as cv

    lib = _build.load("conv_in_sm90", cv._bind_in)
    _, h, wd, c = x.shape
    out = torch.empty((1, h, wd, int(w.wmat.shape[1])),
                      dtype=torch.int8 if w.out_i8 else torch.bfloat16, device=x.device)
    args = (x.data_ptr(), int(c), int(h), int(wd), w.wmat.data_ptr(), int(w.wmat.shape[0]),
            w.bias.data_ptr(), out.data_ptr(), int(w.out_i8), 1,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib.rtnr_conv3x3_in(*args), "rtnr_conv3x3_in")
    return lambda: lib.rtnr_conv3x3_in(*args)


def record_unet_calls(unet, x, p=None):
    """Run the net once on prepared weights ``p`` (default: the bf16 ones),
    recording every conv3x3 / convt2x2 call's inputs (the main path's shapes
    and activations)."""
    import torch
    from rtnr_tpu_torch.ops.conv import conv3x3_prepared, convt2x2_prepared

    p = unet.prepare() if p is None else p
    calls = []

    def conv(xs, name, pool=False, head=False):
        calls.append(("conv3x3", name, list(xs), pool, head))
        return conv3x3_prepared(xs, p[name], relu=True, pool=pool,
                                head=p["final_conv"] if head else None)

    def convt(h, name):
        calls.append(("convt2x2", name, h, False, False))
        return convt2x2_prepared(h, p[name])

    unet._run(x.to(torch.bfloat16).contiguous(), conv, convt)
    return calls


def check_convs(unet, x, rows):
    """K3 at its 18 shapes and K4 at its 4 against the f32 twins. At each K3
    shape: the kernel the route picks, conv.cu's gemm<0,0> (with its pool /
    head kernels, launched directly) and ``F.conv2d``; the 17 routed shapes
    (conv_sm90.cu) are also summed on their own. The input conv
    (conv_in_sm90.cu) is also held within 2 bf16 ulp of its walk twin
    ``conv3x3_in_plain``, launches ``conv3x3_in`` once a call, gives equal
    runs, and is timed in turns against gemm<0,0> and ``F.conv2d`` at its
    own shape (5 -> 64, channels-last bf16)."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import conv as cv

    p = unet.prepare()
    head_w = p["final_conv"]
    acc = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, flops=0.0,
                   nbytes=0.0, previous_ms=0.0, calls=0)
           for k in ("conv3x3", "conv3x3_wgmma", "conv3x3_in", "convt2x2")}
    slower, slower_k4 = [], []
    calls = record_unet_calls(unet, x)
    if len([c for c in calls if c[0] == "conv3x3"]) != 18 or \
            len([c for c in calls if c[0] == "convt2x2"]) != 4:
        fail(f"expected 18 conv3x3 + 4 convt2x2 calls, got {len(calls)}")
    for kind, name, xin, pool, head in calls:
        kern = cv._bf16_values(unet.param(f"{name}/kernel"))
        w = p[name]
        a = acc[kind]
        if kind == "conv3x3":
            xs = xin
            _, h, wd, _ = xs[0].shape
            ct, F = w.cin, int(w.wmat.shape[1])
            inconv = cv.k3_route([int(t.shape[3]) for t in xs], w, head=head,
                                 pool=pool) == "conv_in_sm90"
            n_in = cv.conv3x3_in.launches
            (y,) = cv.conv3x3_prepared(xs, w, relu=True)
            torch.cuda.synchronize()
            if cv.conv3x3_in.launches != n_in + int(inconv):
                fail(f"K3 {name}: conv3x3_in launched {cv.conv3x3_in.launches - n_in} times, "
                     f"not {int(inconv)}")
            (ref,) = cv.conv3x3_plain(xs, kern, w.bias, relu=True, dtype=torch.float32)
            err = float((y.float() - ref).abs().max())
            tol = 2 * ulp_bf16(float(ref.abs().max()))
            extra = ""
            if pool:
                y2, pooled = cv.conv3x3_prepared(xs, w, relu=True, pool=True)
                if not (torch.equal(y2, y) and torch.equal(pooled, cv._pool2(y))):
                    fail(f"K3 {name}: fused pool output differs from max-pool of the conv")
                extra = " +pool exact"
            if head:
                (hout,) = cv.conv3x3_prepared(xs, w, relu=True, head=head_w)
                href = torch.matmul(y.float(), head_w.hk.float()) + head_w.hb
                herr = float((hout.float() - href).abs().max())
                htol = 2 * ulp_bf16(float(href.abs().max()))
                if not herr <= htol:
                    fail(f"K3 {name} head: max abs err {herr} > {htol}")
                extra = f" +head err {herr:.3g} (tol {htol:.3g})"
            if not err <= tol:
                fail(f"K3 {name} {tuple(xs[0].shape)}: max abs err {err} > {tol}")
            if inconv:
                (twin,) = cv.conv3x3_in_plain(xs, w, relu=True)
                terr = float((y.float() - twin.float()).abs().max())
                ttol = 2 * ulp_bf16(float(twin.float().abs().max()))
                if not terr <= ttol:
                    fail(f"K3 input conv {name}: max abs err {terr} > {ttol} against its twin")
                if not torch.equal(cv.conv3x3_prepared(xs, w, relu=True)[0], y):
                    fail(f"K3 input conv {name}: two runs differ")
                extra += f" twin err {terr:.3g} (tol {ttol:.3g}), two runs equal"
                del twin
            mean = float((y.float() - ref).abs().mean())
            M = h * wd
            oc = int(head_w.hk.shape[1]) if head else 0
            flops = 2.0 * M * F * 9 * ct + 2.0 * M * F * oc
            out_bytes = 2.0 * M * (oc if head else F) + (2.0 * M * F / 4 if pool else 0.0)
            nbytes = 2.0 * M * ct + 2.0 * 9 * ct * F + 4.0 * F + out_bytes
            hd = head_w if head else None
            routed = cv.takes_wgmma([int(t.shape[3]) for t in xs], F, head=head)
            xcat = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)  # channels-last NCHW view
            wl = kern.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            bl = w.bias.to(torch.bfloat16)
            if inconv:  # in turns: conv_in_sm90.cu, gemm<0,0>, F.conv2d at 5 -> 64
                wrapper_ms = time_ms(lambda: cv.conv3x3_prepared(xs, w, relu=True))
                extra += f", through its wrapper {wrapper_ms:.4f} ms"
                ms, prev, lib = turns_ms({
                    "new": in_conv_kernel(xs[0], w),
                    "old": lambda: cv._conv3x3_gemm(xs, w, relu=True, pool=False, head=None),
                    "library": lambda: Fn.conv2d(xcat, wl, bl, padding=1)})
                plain = time_ms(lambda: cv.conv3x3_in_plain(xs, w, relu=True), reps=2)
            else:
                ms = time_ms(lambda: cv.conv3x3_prepared(xs, w, relu=True, pool=pool, head=hd))
                prev = time_ms(lambda: cv._conv3x3_gemm(xs, w, relu=True, pool=pool, head=hd))
                hk = unet.param("final_conv/kernel") if head else None
                hb = unet.param("final_conv/bias") if head else None
                plain = time_ms(lambda: cv.conv3x3_plain(xs, kern, w.bias, relu=True, pool=pool,
                                                         head_kernel=hk, head_bias=hb), reps=2)
                lib = time_ms(lambda: Fn.conv2d(xcat, wl, bl, padding=1))
            shape = f"{h}x{wd}x({'+'.join(str(int(t.shape[3])) for t in xs)})->{F}"
            kname = "wgmma" if routed else ("conv_in_sm90" if inconv else "gemm<0,0>")
            extra += (f" | {kname} {ms:.4f} ms, gemm<0,0> {prev:.4f} ms, F.conv2d {lib:.4f} ms")
            if (routed or inconv) and not ms < prev:
                slower.append(name)
        else:
            hx = xin
            _, h, wd, c = hx.shape
            F = w.f
            if cv.k4_route(c, w) != "conv_sm90":
                fail(f"K4 {name}: {c} -> {F} does not take conv_sm90.cu")
            n0 = cv.convt2x2_wgmma.launches
            y = cv.convt2x2_prepared(hx, w)
            torch.cuda.synchronize()
            if cv.convt2x2_wgmma.launches != n0 + 1:
                fail(f"K4 {name}: the call did not launch convt2x2_wgmma")
            if not torch.equal(cv.convt2x2_prepared(hx, w), y):
                fail(f"K4 {name}: two runs differ")
            ref = cv.convt2x2_plain(hx, kern, w.bias, dtype=torch.float32)
            err = float((y.float() - ref).abs().max())
            tol = 2 * ulp_bf16(float(ref.abs().max()))
            if not err <= tol:
                fail(f"K4 {name} {tuple(hx.shape)}: max abs err {err} > {tol}")
            mean = float((y.float() - ref).abs().mean())
            M = h * wd
            flops = 2.0 * M * 4 * F * c
            nbytes = 2.0 * M * c + 2.0 * 4 * c * F + 4.0 * F + 2.0 * 4 * M * F
            routed = inconv = False
            plain = time_ms(lambda: cv.convt2x2_plain(hx, kern, w.bias), reps=2)
            xl = hx.permute(0, 3, 1, 2)
            wt = torch.flip(kern, dims=(0, 1)).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
            bl = w.bias.to(torch.bfloat16)
            # in turns: the routed kernel, conv.cu's gemm<1,0>, the library call
            ms, prev, lib = turns_ms({"new": lambda: cv.convt2x2_prepared(hx, w),
                                      "old": lambda: cv._convt2x2_gemm(hx, w),
                                      "library": lambda: Fn.conv_transpose2d(xl, wt, bl,
                                                                             stride=2)})
            if not ms < prev:
                slower_k4.append(name)
            shape = f"{h}x{wd}x{c}->{2 * h}x{2 * wd}x{F}"
            extra = (f" | convt2x2_wgmma {ms:.4f} ms, gemm<1,0> {prev:.4f} ms, "
                     f"F.conv_transpose2d {lib:.4f} ms")
        b, by = bound_ms(nbytes, flops)
        sub = ("conv3x3_wgmma",) if routed else (("conv3x3_in",) if inconv else ())
        for t in (a,) + tuple(acc[k] for k in sub):
            t["ms"] += ms
            t["previous_ms"] += prev
            t["plain_ms"] += plain
            t["bound_ms"] += b
            t["library_ms"] += lib
            t["err"] = max(t["err"], err)
            t["flops"] += flops
            t["nbytes"] += nbytes
            t["calls"] += 1
        log(f"{kind} {name:16s} {shape:24s} err {err:.3g} (tol {tol:.3g}, mean {mean:.3g})"
            f"{extra} | {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound {b:.4f} {by}, "
            f"plain {plain:.4f}, library {lib:.4f}")
    if acc["conv3x3_wgmma"]["calls"] != 17 or acc["conv3x3_in"]["calls"] != 1:
        fail(f"{acc['conv3x3_wgmma']['calls']} of the 18 conv3x3 shapes take conv_sm90.cu and "
             f"{acc['conv3x3_in']['calls']} conv_in_sm90.cu, not 17 and 1")
    for kind, a in acc.items():
        _, by = bound_ms(a["nbytes"], a["flops"])
        rows[kind] = dict(ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                          bound_by=by, library_ms=a["library_ms"], max_abs_err=a["err"])
        rows[kind]["previous_ms"] = a["previous_ms"]
        log(f"{kind} per frame: {a['calls']} calls, {a['ms']:.4f} ms ({a['flops'] / 1e12:.4f} "
            f"TFLOP, {a['flops'] / a['ms'] / 1e9:.1f} TFLOP/s), bound {a['bound_ms']:.4f}, "
            f"plain {a['plain_ms']:.4f}, library {a['library_ms']:.4f}, "
            f"{'gemm<1,0>' if kind == 'convt2x2' else 'gemm<0,0>'} {a['previous_ms']:.4f}")
    a = acc["conv3x3_wgmma"]
    log(f"conv_sm90.cu on its 17 shapes: {a['ms']:.4f} ms against gemm<0,0> "
        f"{a['previous_ms']:.4f} ({a['previous_ms'] / a['ms']:.2f}x) and F.conv2d "
        f"{a['library_ms']:.4f} ({a['library_ms'] / a['ms']:.2f}x); half its bound "
        f"{2 * a['bound_ms']:.4f} ms {'met' if a['ms'] <= 2 * a['bound_ms'] else 'missed'}; "
        f"slower than gemm<0,0> at {slower or 'no shape'}")
    a = acc["conv3x3_in"]
    log(f"conv_in_sm90.cu, the input conv (bf16 out): {a['ms']:.4f} ms against gemm<0,0> "
        f"{a['previous_ms']:.4f} ({a['previous_ms'] / a['ms']:.2f}x) and F.conv2d at 5 -> 64 "
        f"{a['library_ms']:.4f} ({a['library_ms'] / a['ms']:.2f}x); bound {a['bound_ms']:.4f} "
        f"({a['nbytes'] / a['ms'] / 1e9:.3f} TB/s); half its bound "
        f"{'met' if a['ms'] <= 2 * a['bound_ms'] else 'missed'}")
    a = acc["convt2x2"]
    log(f"convt2x2_wgmma on the 4 K4 shapes: {a['ms']:.4f} ms against gemm<1,0> "
        f"{a['previous_ms']:.4f} ({a['previous_ms'] / a['ms']:.2f}x) and F.conv_transpose2d "
        f"{a['library_ms']:.4f} ({a['library_ms'] / a['ms']:.2f}x), bound {a['bound_ms']:.4f}; "
        f"slower than gemm<1,0> at {slower_k4 or 'no shape'}")


def _im2col_i8(xs):
    """(H*W, 9*C) int8 im2col of (1,H,W,C) inputs, tap-major like the kernels'
    K (bf16 inputs are cast: only the GEMM's time is wanted)."""
    import torch

    x = torch.cat([t.to(torch.int8) for t in xs], dim=-1)[0]
    h, w, c = x.shape
    xp = torch.zeros((h + 2, w + 2, c), dtype=torch.int8, device=x.device)
    xp[1:-1, 1:-1] = x
    return torch.stack([xp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                       dim=2).reshape(h * w, 9 * c)


def int_mm_fn(a, b):
    """A call of ``torch._int_mm(a, b)`` (the int8 GEMM yardstick), or None
    where it refuses the operands in either layout of ``b``."""
    import torch

    err = None
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, bb)
            torch.cuda.synchronize()
        except RuntimeError as e:
            err = e
            continue
        return lambda: torch._int_mm(a, bb)
    log(f"  torch._int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {str(err)[:120]}")
    return None


# the conv.cu kernel each conv_i8_sm90.cu mode replaced
OLD_KERNEL = {"convt2x2_static": "gemm<1,1>", "conv3x3_dyn": "gemm<0,2>",
              "conv3x3_static": "gemm<0,1>", "conv3x3_i8out": "gemm<0,0>"}


def check_int8_convs(static_unet, act_scales, dyn_unet, x, rows):
    """Every int8-mode call of the static and the dyn net at the frame's
    shapes against its plain twin on the card, on the same inputs: K3 static
    (int8 pool included) and K4 static bit for bit, K3 dyn bit for bit, the
    bf16 input conv with int8 output (``conv_in_sm90.cu``) within 1 code on
    <= 0.1% of elements against its mode twin and its walk twin (f32 sums in
    another order), two runs equal, with the share of codes that differ from
    gemm<0,0>'s printed; ms, bound, twin and library per mode. K4
    static, K3 dyn and K3 static run ``conv_i8_sm90.cu``: each call is also
    held equal to ``conv.cu``'s kernel and to a second run. Every call is
    timed in turns against the ``conv.cu`` kernel it replaced and a library
    call (``torch._int_mm``; ``F.conv2d`` for the input conv), the K3 int8
    modes also against the bf16 ``conv_sm90.cu`` conv of the same shape, a
    yardstick their routes never call."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import conv as cv

    modes = ("conv3x3_i8out", "conv3x3_static", "convt2x2_static", "conv3x3_dyn")
    acc = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, ops=0.0,
                   nbytes=0.0, calls=0, previous_ms=0.0, bf16_ms=0.0) for k in modes}
    slower, per_shape = [], {}
    nets = ((static_unet, static_unet.prepare_int8(act_scales)),
            (dyn_unet, dyn_unet.prepare_int8(None)))
    bf16_w = dyn_unet.prepare()
    for unet, p in nets:
        head_w = p["final_conv"]
        for kind, name, xin, pool, head in record_unet_calls(unet, x, p):
            w = p[name]
            prev = bf16 = None
            if kind == "convt2x2":
                if w.quant != "static":
                    continue  # the bf16 K4 is checked with the bf16 net
                mode = "convt2x2_static"
                _, h, wd, c = xin.shape
                if cv.k4_route(c, w) != "conv_i8_sm90":
                    fail(f"K4 static {name}: {c} -> {w.f} does not take conv_i8_sm90.cu")
                n0 = cv.convt2x2_static_wgmma.launches
                y = cv.convt2x2_prepared(xin, w)
                torch.cuda.synchronize()
                if cv.convt2x2_static_wgmma.launches != n0 + 1:
                    fail(f"K4 static {name}: the call did not launch convt2x2_i8_wgmma")
                if not torch.equal(y, cv.convt2x2_prepared_plain(xin, w)):
                    fail(f"K4 static {name}: kernel differs from its twin")
                if not torch.equal(y, cv._convt2x2_gemm(xin, w)):
                    fail(f"K4 static {name}: kernel differs from conv.cu's gemm<1,1>")
                if not torch.equal(cv.convt2x2_prepared(xin, w), y):
                    fail(f"K4 static {name}: two runs differ")
                err, extra = 0.0, " = gemm<1,1>"
                M, F = h * wd, w.f
                ops = 2.0 * M * 4 * F * c
                nbytes = 1.0 * M * c + 4.0 * c * F + 8.0 * F + 4.0 * M * F
                fns = {"new": lambda: cv.convt2x2_prepared(xin, w),
                       "old": lambda: cv._convt2x2_gemm(xin, w)}
                lib_fn = int_mm_fn(xin[0].reshape(M, c), w.wmat[:c])
                plain = time_ms(lambda: cv.convt2x2_prepared_plain(xin, w), reps=2)
                shape = f"{h}x{wd}x{c}->{2 * h}x{2 * wd}x{F}"
                rate = INT8_OPS_PER_S
            else:
                mode = {"static": "conv3x3_static", "dyn": "conv3x3_dyn"}.get(w.quant)
                if mode is None:
                    if not w.out_i8:
                        continue  # exact bf16 convs are checked with the bf16 net
                    mode = "conv3x3_i8out"
                xs = xin
                _, h, wd, _ = xs[0].shape
                cs = [int(t.shape[3]) for t in xs]
                ct, F = w.cin, int(w.wmat.shape[1])
                hd = head_w if head else None
                dyn = mode == "conv3x3_dyn"
                static = mode == "conv3x3_static"
                i8out = mode == "conv3x3_i8out"
                if (dyn or static) and cv.k3_route(cs, w, head=head) != "conv_i8_sm90":
                    fail(f"K3 {w.quant} {name}: {cs} -> {F} does not take conv_i8_sm90.cu")
                if i8out and cv.k3_route(cs, w, head=head, pool=pool) != "conv_in_sm90":
                    fail(f"K3 int8-out {name}: {cs} -> {F} does not take conv_in_sm90.cu")
                counters = (cv.conv3x3_dyn_wgmma, cv.conv3x3_static_wgmma, cv.conv3x3_in)
                n0 = [c.launches for c in counters]
                got = cv.conv3x3_prepared(xs, w, relu=True, pool=pool)
                torch.cuda.synchronize()
                moved = tuple(c.launches - n for c, n in zip(counters, n0))
                if moved != (int(dyn), int(static), int(i8out)):
                    fail(f"K3 {name}: conv3x3_dyn_wgmma / conv3x3_static_wgmma / conv3x3_in "
                         f"launched {moved} times, not {(int(dyn), int(static), int(i8out))}")
                ref = cv.conv3x3_prepared_plain(xs, w, relu=True, pool=pool)
                if i8out:
                    err, extra = 0.0, ""
                    (walk,) = cv.conv3x3_in_plain(xs, w, relu=True)
                    for label, want in (("twin", ref[0]), ("walk twin", walk)):
                        d = (got[0].int() - want.int()).abs()
                        err = max(err, float(d.max()))
                        share = float((d > 0).float().mean())
                        if not (float(d.max()) <= 1 and share <= 1e-3):
                            fail(f"K3 int8-out {name}: max code diff {float(d.max())}, share "
                                 f"{share} against its {label}")
                        extra += f" codes differ from the {label} on {share:.3g} (<= 1e-3);"
                    if not torch.equal(cv.conv3x3_prepared(xs, w, relu=True)[0], got[0]):
                        fail(f"K3 int8-out {name}: two runs differ")
                    (old,) = cv._conv3x3_gemm(xs, w, relu=True, pool=False, head=None)
                    d = (got[0].int() - old.int()).abs()
                    extra += (f" two runs equal; differ from gemm<0,0>'s codes on "
                              f"{float((d > 0).float().mean()):.3g} (max {int(d.max())})")
                    del walk, old, d
                else:
                    for g, r in zip(got, ref):
                        if not torch.equal(g, r):
                            fail(f"K3 {w.quant} {name}: kernel differs from its twin")
                    err = 0.0
                    extra = " +int8 pool exact" if pool else ""
                if dyn or static:
                    gname = "gemm<0,2>" if dyn else "gemm<0,1>"
                    old = cv._conv3x3_gemm(xs, w, relu=True, pool=pool, head=None)
                    if not all(torch.equal(g, o) for g, o in zip(got, old)):
                        fail(f"K3 {w.quant} {name}: kernel differs from conv.cu's {gname}")
                    again = cv.conv3x3_prepared(xs, w, relu=True, pool=pool)
                    if not all(torch.equal(g, o) for g, o in zip(got, again)):
                        fail(f"K3 {w.quant} {name}: two runs differ")
                    extra += f" = {gname}"
                if pool and not torch.equal(got[1], cv._pool2(got[0])):
                    fail(f"K3 {name}: pooled output differs from the 2x2 max of the conv")
                if head:
                    (hout,) = cv.conv3x3_prepared(xs, w, relu=True, head=hd)
                    href = torch.matmul(got[0].float(), hd.hk.float()) + hd.hb
                    herr = float((hout.float() - href).abs().max())
                    if not herr <= 2 * ulp_bf16(float(href.abs().max())):
                        fail(f"K3 {name} head: max abs err {herr}")
                    (htwin,) = cv.conv3x3_prepared_plain(xs, w, relu=True, head=hd)
                    hshare = float((hout != htwin).float().mean())
                    extra += f" +head err {herr:.3g} (differs from the twin on {hshare:.3g})"
                M = h * wd
                oc = int(hd.hk.shape[1]) if head else 0
                ops = 2.0 * M * F * 9 * ct + 2.0 * M * F * oc
                in_b = 1.0 if w.quant == "static" else 2.0
                out_b = 1.0 if w.out_i8 else 2.0
                out_bytes = (2.0 * M * oc if head else out_b * M * F) + (
                    out_b * M * F / 4 if pool else 0.0)
                nbytes = in_b * M * ct + (1.0 if w.quant else 2.0) * 9 * ct * F + 8.0 * F + out_bytes
                fns = {"new": lambda: cv.conv3x3_prepared(xs, w, relu=True, pool=pool, head=hd)}
                if i8out:
                    extra += f"; through its wrapper {time_ms(fns['new']):.4f} ms"
                    fns["new"] = in_conv_kernel(xs[0], w)
                    fns["old"] = lambda: cv._conv3x3_gemm(xs, w, relu=True, pool=False, head=None)
                if dyn or static:
                    wb = bf16_w[name]
                    hb16 = bf16_w["final_conv"] if head else None
                    xb = [t.to(torch.bfloat16) for t in xs]  # the bf16 conv's own operands
                    fns["old"] = lambda: cv._conv3x3_gemm(xs, w, relu=True, pool=pool, head=hd)
                    fns["bf16"] = lambda: cv._conv3x3_wgmma(xb, wb, relu=True, pool=pool,
                                                            head=hb16)
                if i8out:
                    plain = time_ms(lambda: cv.conv3x3_in_plain(xs, w, relu=True), reps=2)
                else:
                    plain = time_ms(lambda: cv.conv3x3_prepared_plain(xs, w, relu=True,
                                                                      pool=pool, head=hd), reps=2)
                if mode == "conv3x3_i8out":  # the bf16 GEMM: F.conv2d in bf16
                    xl = xs[0].permute(0, 3, 1, 2)
                    wl = w.wmat[:9 * ct].reshape(3, 3, ct, F).permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    lib_fn = lambda: Fn.conv2d(xl, wl, padding=1)
                    rate = BF16_FLOP_PER_S
                else:  # GEMM only, over an explicit int8 im2col
                    lib_fn = int_mm_fn(_im2col_i8(xs), w.wmat[:9 * ct])
                    rate = INT8_OPS_PER_S
                shape = f"{h}x{wd}x({'+'.join(str(c) for c in cs)})->{F}"
            # in turns: the routed kernel, conv.cu's where replaced, the bf16 conv, the
            # library
            if lib_fn is not None:
                fns["library"] = lib_fn
            order = list(fns) + list(reversed(list(fns)))
            turns = {k: [] for k in fns}
            for k in order:
                turns[k].append(time_ms(fns[k]))
            ms = statistics.mean(turns["new"])
            lib = statistics.mean(turns["library"]) if "library" in turns else None
            if "old" in turns:
                prev = statistics.mean(turns["old"])
                if not ms < prev:
                    slower.append(name)
            if "bf16" in turns:
                bf16 = statistics.mean(turns["bf16"])
            del fns, lib_fn
            b, by = bound_ms(nbytes, ops, rate)
            a = acc[mode]
            a["ms"] += ms
            a["plain_ms"] += plain
            a["bound_ms"] += b
            a["library_ms"] = None if (lib is None or a["library_ms"] is None) else a["library_ms"] + lib
            a["err"] = max(a["err"], err)
            a["ops"] += ops
            a["nbytes"] += nbytes
            a["calls"] += 1
            a["rate"] = rate
            a["previous_ms"] += prev or 0.0
            a["bf16_ms"] += bf16 or 0.0
            libs = "refused" if lib is None else f"{lib:.4f}"
            cmp = ""
            if prev is not None:
                cmp = f", {OLD_KERNEL[mode]} {prev:.4f}"
                per_shape[f"{mode} {name}"] = {"ms": ms, "previous_ms": prev, "library_ms": lib,
                                               "bound_ms": b, "bf16_ms": bf16, "turns": turns}
            if bf16 is not None:
                cmp += f", bf16 conv_sm90 {bf16:.4f}"
            log(f"{mode} {name:16s} {shape:24s} err {err:.3g}{extra} | {ms:.4f} ms, "
                f"{ops / ms / 1e9:.1f} TOP/s, bound {b:.4f} {by}, plain {plain:.4f}, "
                f"library {libs}{cmp}")
    for mode, a in acc.items():
        if not a["calls"]:
            fail(f"no {mode} call in the int8 nets")
        _, by = bound_ms(a["nbytes"], a["ops"], a["rate"])
        rows[mode] = dict(ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                          bound_by=by, library_ms=a["library_ms"], max_abs_err=a["err"])
        libs = "null" if a["library_ms"] is None else f"{a['library_ms']:.4f}"
        more = ""
        if mode in OLD_KERNEL:
            rows[mode]["previous_ms"] = a["previous_ms"]
            more = (f", {OLD_KERNEL[mode]} {a['previous_ms']:.4f} "
                    f"({a['previous_ms'] / a['ms']:.2f}x)")
        if mode in ("conv3x3_dyn", "conv3x3_static"):
            rows[mode]["bf16_ms"] = a["bf16_ms"]
            more += f", bf16 conv_sm90.cu on the same shapes {a['bf16_ms']:.4f}"
        log(f"{mode} per frame: {a['calls']} calls, {a['ms']:.4f} ms ({a['ops'] / 1e12:.4f} "
            f"TOP, {a['ops'] / a['ms'] / 1e9:.1f} TOP/s), bound {a['bound_ms']:.4f}, plain "
            f"{a['plain_ms']:.4f}, library {libs}{more}")
    # the int8-output mode's one call is the input conv on conv_in_sm90.cu
    rows["conv3x3_in_i8out"] = dict(rows["conv3x3_i8out"])
    a = acc["conv3x3_i8out"]
    log(f"conv_in_sm90.cu, the input conv (int8 out): {a['ms']:.4f} ms against gemm<0,0> "
        f"{a['previous_ms']:.4f} ({a['previous_ms'] / a['ms']:.2f}x) and F.conv2d at 5 -> 64 "
        f"{a['library_ms']:.4f}; bound {a['bound_ms']:.4f} "
        f"({a['nbytes'] / a['ms'] / 1e9:.3f} TB/s); half its bound "
        f"{'met' if a['ms'] <= 2 * a['bound_ms'] else 'missed'}")
    if (acc["convt2x2_static"]["calls"] != 4 or acc["conv3x3_dyn"]["calls"] != 10
            or acc["conv3x3_static"]["calls"] != 17):
        fail("expected 4 K4 static, 10 K3 dyn and 17 K3 static calls in the int8 nets")
    a = acc["conv3x3_static"]
    log(f"conv3x3_static_wgmma on its 17 shapes: {a['ms']:.4f} ms, bf16 conv_sm90.cu "
        f"{a['bf16_ms']:.4f} ({'below' if a['ms'] < a['bf16_ms'] else 'not below'}), twice "
        f"the bound {2 * a['bound_ms']:.4f} ({'met' if a['ms'] <= 2 * a['bound_ms'] else 'missed'})")
    log(f"conv_i8_sm90.cu / conv_in_sm90.cu slower than the conv.cu kernel they replace at "
        f"{slower or 'no shape'}")
    return {"per_shape": per_shape, "slower_than_conv_cu": slower}


def check_int8_nets(bf16_unet, static_unet, act_scales, dyn_unet, x):
    """The static and dyn U-Net outputs against the bf16 kernel net's at the
    calibration input: max <= 0.10 and mean <= 0.02 of max|bf16|
    (PARITY.md's int8 budgets)."""
    import torch

    with torch.no_grad():
        yb = bf16_unet(x).float()
        scale = float(yb.abs().max())
        out = {}
        for label, y in (("static", static_unet(x, act_scales=act_scales)), ("dyn", dyn_unet(x))):
            d = (y.float() - yb).abs()
            dmax, dmean = float(d.max()), float(d.mean())
            log(f"U-Net {label} int8 vs bf16 kernel net at {tuple(x.shape)}: max {dmax:.4g}, "
                f"mean {dmean:.4g}, max|bf16| {scale:.4g} (budget max 0.10, mean 0.02 x it)")
            if not (dmax <= 0.10 * scale and dmean <= 0.02 * scale):
                fail(f"U-Net {label} int8 output outside the budget against bf16")
            out[label] = {"max": dmax, "mean": dmean, "scale": scale}
    return out


def trace_frames(renderer, cam, E, frame_ms: float, frames: int = 3, label: str = "bf16"):
    """torch.profiler over a few frames: device busy time per frame (sum of
    the device-side events: kernels and copies, one stream) against the
    unprofiled ``frame_ms``, and the top device kernels; returns each
    kernel's (ms, launches) per frame. Prints "not measured" where the
    profiler sees no device events (no CUPTI)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            renderer.compute_full_tensors(cam, E)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames

    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += e.device_time_total / 1e3
            per_name[e.name][1] += 1
    busy = sum(v[0] for v in per_name.values()) / frames
    if busy <= 0:
        log("trace: device time not measured (the profiler saw no device events)")
        return {}
    log(f"trace ({label}): {frames} frames; device busy {busy:.3f} ms/frame; unprofiled frame "
        f"{frame_ms:.3f} ms -> idle share {max(0.0, 1 - busy / frame_ms):.4f} "
        f"(profiled wall {wall_ms:.3f} ms/frame)")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms / frames:8.3f} ms/frame  x{n // frames:<4d} {name[:90]}")
    return {name: (ms / frames, n // frames) for name, (ms, n) in per_name.items()}


def check_small_vs_cpu(features):
    """A small render on the card against the same render on the CPU (whose
    plain twins the tests hold against the JAX package)."""
    import numpy as np
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=3, extent=6.0)
    cam = Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48)
    E = np.eye(4)
    E[2, 3] = 8.0
    cfg = RenderConfig(unet_features=features)
    vars_ = init_unet_numpy(1, features)
    gpu = Renderer(scene, cfg, vars_, device="cuda").compute_full(cam, E)
    cpu = Renderer(scene, cfg, vars_, device="cpu").compute_full(cam, E)
    for k in ("raw_rgb", "raw_depth", "mask", "depth"):
        if not np.array_equal(gpu[k], cpu[k]):
            fail(f"small render: {k} differs between the card and the CPU")
    d = np.abs(gpu["rgb_f"] - cpu["rgb_f"])
    scale = max(1.0, float(np.abs(cpu["rgb_f"]).max()))
    if not (d.max() <= 5e-2 * scale and d.mean() <= 5e-3 * scale):
        fail(f"small render: rgb_f max {d.max()} / mean {d.mean()} vs scale {scale}")
    log(f"small 64x48 render, card vs CPU: raw/mask/depth bit-exact, rgb_f max "
        f"{d.max():.3g} mean {d.mean():.3g}")


def serve_frames(r, cam, E, n, counted, need, label, host_frames=0, per_frame=None):
    """One warm-up frame through ``compute_full`` (numpy out), ``n`` timed
    frames of ``compute_full_tensors`` and ``host_frames`` of ``compute_full``;
    every launch count is set to 0 just before and read just after, and each
    kernel in ``need`` must have launched (each in ``per_frame`` exactly that
    many times a frame)."""
    import numpy as np
    import torch

    for fn in counted.values():
        fn.launches = 0
    warm = r.compute_full(cam, E)
    if warm["rgb"].shape != (HEIGHT, WIDTH, 3) or not np.isfinite(warm["rgb_f"]).all():
        fail(f"{label}: compute_full gave an unexpected or non-finite output")
    del warm

    def timed(frame, k):
        ms, st, res = [], [], None
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = frame(cam, E)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            st.append(r.last_timings)
        return res, ms, st

    # compute_full_tensors is compute_full without the copy to host numpy
    out, frame_ms, stages = timed(r.compute_full_tensors, n)
    _, host_ms, _ = timed(r.compute_full, host_frames)
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"{label} launches over {1 + n + host_frames} frames: {launches}")
    for k in need:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {label} path")
    for k, m in (per_frame or {}).items():
        if launches[k] != m * (1 + n + host_frames):
            fail(f"{label}: {k} launched {launches[k]} times in {1 + n + host_frames} frames, "
                 f"not {m} a frame")
    res = {"ms_per_frame": statistics.median(frame_ms), "frames": len(frame_ms),
           "all_ms": frame_ms, "launches": launches,
           "stage_ms": {k: statistics.median(getattr(s, f"{k}_ms") for s in stages)
                        for k in ("projection", "filter", "unet")}}
    st = res["stage_ms"]
    log(f"{label} frames: {len(frame_ms)} timed, ms/frame median {res['ms_per_frame']:.3f} "
        f"(all {[round(v, 3) for v in frame_ms]}); stages (CUDA events, median): projection "
        f"{st['projection']:.3f} ms, filter {st['filter']:.3f} ms, unet {st['unet']:.3f} ms")
    if host_frames:
        res["host_out_ms_per_frame"] = statistics.median(host_ms)
        log(f"{label} compute_full with the copy to host numpy: {len(host_ms)} frames, ms/frame "
            f"median {res['host_out_ms_per_frame']:.3f} (all {[round(v, 3) for v in host_ms]})")
    if tuple(out["rgb_f"].shape) != (HEIGHT, WIDTH, 3) or out["rgb"].dtype != torch.uint8:
        fail(f"{label}: unexpected output shape {tuple(out['rgb_f'].shape)}")
    for k in ("rgb_f", "raw_depth", "depth"):
        if not bool(torch.isfinite(out[k]).all()):
            fail(f"{label}: output {k} is not finite")
    log(f"{label} outputs finite: rgb_f range [{float(out['rgb_f'].min()):.4f}, "
        f"{float(out['rgb_f'].max()):.4f}], mask kept {float(out['mask'].float().mean()):.4f}, "
        f"occupied {float((out['raw_depth'] < 3e38).float().mean()):.4f}")
    return res


def check_culled(renderer, culled, cam, Ec):
    """The culled render against the unculled one at a pose inside the cloud:
    raw_rgb, raw_depth, depth, mask and rgb_f equal bit for bit; the kept
    share; both timed (compute_full_tensors, median of CULL_FRAMES)."""
    import numpy as np
    import torch

    a, b = renderer.compute_full(cam, Ec), culled.compute_full(cam, Ec)
    for k in ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb"):
        if not np.array_equal(a[k], b[k]):
            fail(f"culled render: {k} differs from the unculled render")
    cache = culled._cull_cache
    kept = cache["n_kept"] / POINTS
    if cache["overflowed"] or not kept < 1.0:
        fail(f"culled render: nothing culled or overflowed ({cache['n_kept']} kept)")
    res = {"kept_share": kept, "n_kept": cache["n_kept"], "budget": culled.cull_budget}
    for label, r in (("unculled", renderer), ("culled", culled)):
        ms = []
        for _ in range(CULL_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.compute_full_tensors(cam, Ec)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[f"{label}_ms"] = statistics.median(ms)
        res[f"{label}_projection_ms"] = r.last_timings.projection_ms
        log(f"{label} render at the inside pose: ms/frame median {statistics.median(ms):.3f} "
            f"(all {[round(v, 3) for v in ms]}), last projection stage "
            f"{r.last_timings.projection_ms:.3f} ms")
    log(f"culled render (cull_budget='auto', budget {culled.cull_budget}): kept {cache['n_kept']} "
        f"of {POINTS} points ({kept:.4f}); raw_rgb, raw_depth, depth, mask and rgb_f equal the "
        f"unculled render bit for bit")
    return res


# ---- the multi-rank slice (rtnr_tpu_torch/parallel), ranks sharing the card ----

PAR_RANKS = 4  # gloo ranks on the one card
PAR_POSES = 8  # frames of render_full_batch (two a rank)
PAR_TRAIN_STEPS = 2  # scene-train steps on (2, 1) against one rank
# step 0's gradient norms on (2, 1) against one rank, relative, each four to
# eight times its reading on an NVIDIA H100 80GB HBM3 at 700 W (at most the
# CPU test's 1e-4, tests/test_torch_parallel_diff.py). One rank convolves
# both frames at once, each of the two ranks one; the pose norm is a sum
# over 5M points that cancels to 1e-3 of its terms. f32 (TF32 off) read
# 3.9e-6, 1.4e-6, 2.1e-4; bf16 2.3e-3, 6.0e-5, 9.3e-3. A merge that drops
# or doubles a rank's part moves a norm by tens of percent.
PAR_GRAD_RTOL = {"float32": {"grad_norm": 1e-4, "color_grad_norm": 1e-4,
                             "pose_grad_norm": 1e-3},
                 "bfloat16": {"grad_norm": 1e-2, "color_grad_norm": 5e-4,
                              "pose_grad_norm": 5e-2}}
TILE_HALO, TILE_UNET_HALO = 96, 32  # the render CLI's arithmetic at 1088 rows, 4 strips
STRIP_EDGE = 64  # the image's outer rows left out of the strip U-Net's seam bounds


def par_counters():
    """The launch counters of the parallel paths: name -> (wrapper, attribute)."""
    from rtnr_tpu_torch.ops import bn_train
    from rtnr_tpu_torch.ops import conv as cv
    from rtnr_tpu_torch.ops import raster_resolve4 as rr

    return {"resolve4": (rr.raster_images_v4, "launches"),
            "bn_train": (bn_train.bn_relu_train, "launches"),
            "resolve4_ref": (rr.raster_images_v4, "band_ref_launches"),
            "resolve_diff": (rr.raster_images_diff, "launches"),
            "resolve_diff_ref": (rr.raster_images_diff, "band_ref_launches"),
            "winners": (rr.winners, "launches"), "expand": (rr.expand_winners, "launches"),
            "conv3x3_wgmma": (cv.conv3x3_wgmma, "launches"),
            "convt2x2_wgmma": (cv.convt2x2_wgmma, "launches"),
            "conv3x3_in": (cv.conv3x3_in, "launches"),
            "conv3x3_static_wgmma": (cv.conv3x3_static_wgmma, "launches"),
            "convt2x2_static_wgmma": (cv.convt2x2_static_wgmma, "launches")}


def par_reset():
    for fn, attr in par_counters().values():
        setattr(fn, attr, 0)


def par_read():
    return {k: getattr(fn, attr) for k, (fn, attr) in par_counters().items()}


def par_poses():
    """PAR_POSES camera poses around the bench pose (12 m out, moved sideways)."""
    import numpy as np

    out = []
    for k in range(PAR_POSES):
        E = np.eye(4)
        E[0, 3], E[1, 3], E[2, 3] = 0.25 * k - 1.0, 0.1 * (k % 3), 12.0 - 0.2 * k
        out.append(E)
    return out


def par_timed(fn):
    """(fn(), ms on the card's clock, ms on the host clock)."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def _par_eq(got, want) -> bool:
    import torch

    g = got.view(torch.int32) if got.dtype == torch.float32 else got
    w = want.view(torch.int32) if want.dtype == torch.float32 else want
    return g.shape == w.shape and bool(torch.equal(g, w))


def parallel_rank_cases(nccl: bool = False):
    """One rank of the parallel phase (every rank runs it; ``nccl``: the
    world is one rank on NCCL and every mesh has axes of size 1). Each case:
    the single-device reference, then the launch counts set to 0, the
    sharded call (timed), the counts read, its outputs held against the
    reference bit for bit (``rgb_f`` of the strips within the stated
    tolerance). Returns the rank's results; raises on a mismatch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops.culling import build_block_index
    from rtnr_tpu_torch.ops.raster import rasterize
    from rtnr_tpu_torch.ops.raster_diff import rasterize_diff_sorted
    from rtnr_tpu_torch.parallel import collectives as C
    from rtnr_tpu_torch.parallel.diff import rasterize_diff_point_sharded
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.parallel.render import (
        rasterize_point_sharded,
        render_filtered_sharded,
        render_full_batch,
    )
    from rtnr_tpu_torch.parallel.tiles import rasterize_tile_sharded, render_full_tile_sharded
    from rtnr_tpu_torch.pipeline import Renderer, render_filtered, render_full
    from rtnr_tpu_torch.scene import Scene

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world  # every mesh below spans the world
    res = {"rank": rank, "world": world, "backend": dist.get_backend(), "cases": {}}
    scene = Scene.synthetic(POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    variables = init_unet_numpy(SEED, (64, 128, 256, 512))
    bf16 = Renderer(scene, RenderConfig(), variables, device="cuda")
    static = Renderer(scene, RenderConfig(unet_int8="static"), variables, device="cuda")
    poses = par_poses()
    Ms = torch.stack([bf16._cam_proj(cam, E) for E in poses])
    static.calibrate(cam, poses[0])
    pts, cols, valid = bf16.points, bf16.colors, bf16.valid
    hw = WIDTH * HEIGHT

    def case(name, run, check, frames=1):
        """One untimed warm-up run (first calls load kernels), then: reset the
        counts, run (timed), read the counts, check."""
        run()
        torch.cuda.synchronize()
        dist.barrier()
        par_reset()
        out, dev_ms, host_ms = par_timed(run)
        launches = par_read()
        detail = check(out, launches)
        res["cases"][name] = {"ms_per_frame": dev_ms / frames, "host_ms_per_frame":
                              host_ms / frames, "frames": frames, "launches": launches,
                              **(detail or {})}

    def need(launches, **want):
        for k, v in want.items():
            if launches[k] != v:
                raise AssertionError(f"{k} launched {launches[k]} times, not {v}")

    # 1. one frame, the scene over the points axis: (1, n)
    mesh = make_mesh((1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")
    ref_rgb, ref_depth = rasterize(pts, cols, Ms[0], width=WIDTH, height=HEIGHT, valid=valid)

    def check_point(out, launches):
        if not (_par_eq(out[0], ref_rgb) and _par_eq(out[1], ref_depth)):
            raise AssertionError("rasterize_point_sharded differs from rasterize")
        two = n > 1  # pass 1, then the band-reference pass
        need(launches, resolve4=1 + two, resolve4_ref=int(two), winners=0, expand=0)

    case("point_sharded", lambda: rasterize_point_sharded(
        blk(pts), blk(cols), blk(valid), Ms[0], mesh, width=WIDTH, height=HEIGHT), check_point)

    # 2. render_filtered_sharded on (2, 2) (n == 1: (1, 1)), two frames
    mesh = make_mesh((2, 2) if n == 4 else (1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")
    nb = mesh.shape["batch"]
    mine = list(range(2))[mesh.axis_index("batch") * (2 // nb):][:2 // nb]
    refs = [render_filtered(pts, cols, valid, Ms[f], width=WIDTH, height=HEIGHT) for f in mine]

    def check_filtered(out, launches):
        for j, r in enumerate(refs):
            for k in ("raw_rgb", "raw_depth", "rgb", "depth", "mask", "unet_input"):
                if not _par_eq(out[k][j], r[k]):
                    raise AssertionError(f"render_filtered_sharded {k} differs (frame {mine[j]})")
        two = mesh.shape["points"] > 1
        need(launches, resolve4=len(mine) * (1 + two), resolve4_ref=len(mine) * two)

    case("filtered_sharded", lambda: render_filtered_sharded(
        blk(pts), blk(cols), blk(valid), Ms[:2], mesh, width=WIDTH, height=HEIGHT),
        check_filtered, frames=len(mine))
    del refs

    # 3. render_full_batch on (n, 1): PAR_POSES frames, bf16 and static int8
    mesh = make_mesh((n, 1))
    fl = PAR_POSES // n
    mine = list(range(mesh.axis_index("batch") * fl, (mesh.axis_index("batch") + 1) * fl))
    for label, r in (("bf16", bf16), ("static", static)):
        refs = [render_full(pts, cols, valid, Ms[f], r.unet, width=WIDTH, height=HEIGHT,
                            act_scales=r.act_scales)["rgb_f"] for f in mine]

        def check_full(out, launches, refs=refs, label=label):
            for j, y in enumerate(refs):
                if not _par_eq(out["rgb_f"][j], y):
                    raise AssertionError(f"render_full_batch ({label}) rgb_f differs "
                                         f"(frame {mine[j]})")
            if label == "bf16":
                need(launches, resolve4=fl, resolve4_ref=0, conv3x3_wgmma=17 * fl,
                     convt2x2_wgmma=4 * fl, conv3x3_in=fl, conv3x3_static_wgmma=0)
            else:
                need(launches, resolve4=fl, conv3x3_static_wgmma=17 * fl,
                     convt2x2_static_wgmma=4 * fl, conv3x3_in=fl, conv3x3_wgmma=0)
            g = C.gather_frames(out["rgb_unet"], mesh)
            if tuple(g.shape) != (PAR_POSES, HEIGHT, WIDTH, 3):
                raise AssertionError(f"gather_frames gave {tuple(g.shape)}")

        case(f"full_batch_{label}", lambda r=r: render_full_batch(
            pts, cols, valid, Ms, mesh, r.unet, width=WIDTH, height=HEIGHT,
            act_scales=r.act_scales), check_full, frames=fl)
        del refs
    torch.cuda.empty_cache()

    # 4. row strips with the per-strip block culling: (n,) tiles
    mesh = make_mesh((n,), ("tiles",))
    index = build_block_index(scene, pad_to_multiple=1024, device=pts.device)

    def check_tiles(out, launches):
        if not (_par_eq(out[0], ref_rgb) and _par_eq(out[1], ref_depth)):
            raise AssertionError("rasterize_tile_sharded differs from rasterize")
        need(launches, resolve4=1, resolve4_ref=0)
        return {"candidates": out[2].tolist()}

    case("tiles_culled", lambda: rasterize_tile_sharded(
        pts, cols, valid, Ms[0], mesh, width=WIDTH, height=HEIGHT, block_index=index),
        check_tiles)
    del index

    # 5. the whole pipeline on strips at the pyramid height (1088 rows)
    hp = 1088
    one = render_full(pts, cols, valid, Ms[0], bf16.unet, width=WIDTH, height=hp)
    mid = render_filtered(pts, cols, valid, Ms[0], width=WIDTH, height=hp)["unet_input"]

    def check_strips(out, launches):
        for k in ("raw_rgb", "raw_depth"):
            if not _par_eq(out[k], one[k]):
                raise AssertionError(f"render_full_tile_sharded {k} differs")
        if not _par_eq(out["unet_input"], mid):
            raise AssertionError("render_full_tile_sharded core unet_input differs")
        d = (out["rgb_f"] - one["rgb_f"]).abs()
        rows = d.amax(dim=(1, 2))
        need(launches, resolve4=1, conv3x3_in=1, conv3x3_wgmma=17, convt2x2_wgmma=4)
        # away from the image's outer rows, JAX's seam bounds
        # (tests/test_tiles.py: mean 2e-3, max 0.15). At those rows the zeroed
        # overlap rows of the first and last strips are not the one-card
        # net's padding: JAX's strips leave the bounds there too, and the
        # port's equal JAX's on the border strips
        # (tests/test_torch_tiles.py, random-BatchNorm weights)
        inner = d[STRIP_EDGE:hp - STRIP_EDGE]
        rgb8 = (out["rgb_unet"].float() - one["rgb"].float()).abs()
        res = {"rgb_f_max": float(d.max()), "rgb_f_mean": float(d.mean()),
               "rgb_f_inner_max": float(inner.max()), "rgb_f_inner_mean": float(inner.mean()),
               "rgb_f_scale": float(one["rgb_f"].abs().max()), "rgb8_max": int(rgb8.max()),
               "rgb8_mean": float(rgb8.mean()), "worst_rows": rows.topk(4).indices.tolist()}
        if not (res["rgb_f_inner_mean"] < 2e-3 and res["rgb_f_inner_max"] < 0.15
                and res["rgb8_mean"] <= 1.0):
            raise AssertionError(f"the strip U-Net's frame is outside the tolerance: {res}")
        return res

    case("strips_full", lambda: render_full_tile_sharded(
        pts, cols, valid, Ms[0], mesh, bf16.unet, width=WIDTH, height=hp, halo=TILE_HALO,
        unet_halo=TILE_UNET_HALO), check_strips)
    del one, mid
    torch.cuda.empty_cache()

    # 6. the differentiable forward on (1, n), integer colours: bit for bit
    mesh = make_mesh((1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")
    colsf = cols.float()
    ref = rasterize_diff_sorted(pts, colsf, Ms[0], width=WIDTH, height=HEIGHT, valid=valid)
    c_blk = blk(colsf).clone().requires_grad_(True)

    def check_diff(out, launches):
        for k in ("rgb", "depth", "count", "mask"):
            if not _par_eq(getattr(out, k).detach(), getattr(ref, k).detach()):
                raise AssertionError(f"rasterize_diff_point_sharded {k} differs")
        two = n > 1
        need(launches, resolve_diff=1 + two, resolve_diff_ref=int(two))
        loss = torch.sum(out.rgb * 1e-3) + 1e-6 * torch.sum(torch.where(out.mask, out.depth,
                                                                          0.0))
        loss.backward()
        if not bool(torch.isfinite(c_blk.grad).all()) or float(c_blk.grad.abs().sum()) == 0:
            raise AssertionError("rasterize_diff_point_sharded colour gradients")

    case("diff_point_sharded", lambda: rasterize_diff_point_sharded(
        blk(pts), c_blk, Ms[0], mesh, width=WIDTH, height=HEIGHT, valid=blk(valid)),
        check_diff)

    if nccl:  # NCCL's collectives on CUDA tensors at world size 1
        x = torch.arange(8, device=pts.device, dtype=torch.float32)
        y = x.clone()
        for op in (dist.ReduceOp.MIN, dist.ReduceOp.MAX, dist.ReduceOp.SUM):
            dist.all_reduce(y, op=op)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        dist.broadcast(y, 0)
        torch.cuda.synchronize()
        if not (torch.equal(y, x) and torch.equal(parts[0], x)):
            raise AssertionError("NCCL collectives at world size 1")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def parallel_train_ranks(steps: int):
    """Scene-train steps on a (2, 1) mesh, one 1080p frame a rank: ``steps``
    with the bf16 U-Net, then one with the f32 U-Net (TF32 off); rank 0
    first runs the same steps on one rank with both frames. Returns the
    metrics and a digest of the parameters after each step."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops.raster import rasterize
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt

    rank = dist.get_rank()
    scene = Scene.synthetic(POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    dev = torch.device("cuda", torch.cuda.current_device())
    pts, cols, valid = (torch.from_numpy(a).to(dev)
                        for a in scene.sorted_by_block().device_arrays(1024))
    Ms = torch.stack([torch.from_numpy(cam.cam_proj(E).astype(np.float32)).to(dev)
                      for E in par_poses()[:2]])
    targets = torch.stack([rasterize(pts, cols, M, width=WIDTH, height=HEIGHT,
                                     valid=valid)[0].float() / 255.0 for M in Ms])
    variables = init_unet_numpy(SEED, (64, 128, 256, 512))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(mesh, dtype=torch.bfloat16, n_steps=steps):
        state = tt.create_scene_train_state(variables, cols.float().cpu().numpy(),
                                            Ms.cpu().numpy(), dtype=dtype, learning_rate=1e-4)
        step = tt.make_scene_train_step(width=WIDTH, height=HEIGHT, mesh=mesh)
        out = []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, pts, valid, targets)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for p in state.model.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
            out.append({"ms": (time.perf_counter() - t0) * 1e3, "params": h.hexdigest(),
                        **{k: float(v) for k, v in m.items()}})
        del state
        torch.cuda.empty_cache()
        return out

    res = {"rank": rank}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        res["one_rank"] = run(None)
        res["one_rank_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    par_reset()
    res["two_ranks"] = run(make_mesh((2, 1)))
    res["launches"] = par_read()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        res["one_rank_f32"] = run(None, torch.float32, 1)
    dist.barrier()
    res["two_ranks_f32"] = run(make_mesh((2, 1)), torch.float32, 1)
    return res


def parallel_phase(card, rows):
    """The multi-rank slice on the one card: PAR_RANKS gloo ranks (the
    backend rule's choice when ranks share a card) run ``parallel_rank_cases``
    at the bench cell (1920x1080, 5M points, U-Net [64,128,256,512]); two
    ranks run ``parallel_train_ranks`` (scene-train steps on (2, 1) against
    one rank); one rank on NCCL runs ``parallel_rank_cases`` on meshes of
    size 1 plus NCCL's collectives. Every rank's checks must pass; the
    ranks' launch counts fill the band-reference rows' launches."""
    import os

    import torch
    from rtnr_tpu_torch.parallel.launch import run_ranks

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for label, world, target, kw in (
            ("gloo4", PAR_RANKS, "chip_smoke:parallel_rank_cases", {}),
            ("train2", 2, "chip_smoke:parallel_train_ranks", {"steps": PAR_TRAIN_STEPS}),
            ("nccl1", 1, "chip_smoke:parallel_rank_cases", {"nccl": True})):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            res = run_ranks(target, world, kw, device="cuda", threads=2, extra_path=[root],
                            timeout=600)
        except (RuntimeError, TimeoutError) as e:
            fail(f"parallel phase {label}: {str(e)[-6000:]}")
        wall = time.perf_counter() - t0
        out[label] = {"wall_s": wall, "ranks": res}
        if label == "train2":
            one, two = res[0]["one_rank"], [r["two_ranks"] for r in res]
            # step 0 is where the merge of the U-Net's, the colours' and the
            # poses' gradients shows before any update moves the two runs apart
            for dt, a, b in (("bfloat16", two[0][0], one[0]),
                             ("float32", res[0]["two_ranks_f32"][0], res[0]["one_rank_f32"][0])):
                grad_rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in PAR_GRAD_RTOL[dt]}
                log(f"parallel train2 {dt} step 0 gradient norms on (2, 1) vs one rank: "
                    + ", ".join(f"{k} {a[k]!r} vs {b[k]!r} (rel {v:.3e})"
                                for k, v in grad_rel.items()))
                for k, v in grad_rel.items():
                    if not v <= PAR_GRAD_RTOL[dt][k]:
                        fail(f"scene-train step 0 ({dt}): {k} {a[k]} on (2, 1) vs {b[k]} on "
                             f"one rank (rel {v:.3e} > {PAR_GRAD_RTOL[dt][k]})")
            for r in res:  # the multi-rank step's BatchNorm on the fused kernels
                if r["launches"]["bn_train"] != 18 * PAR_TRAIN_STEPS:
                    fail(f"scene-train on (2, 1), rank {r['rank']}: "
                         f"{r['launches']['bn_train']} fused BatchNorm layers in "
                         f"{PAR_TRAIN_STEPS} steps, not 18 a step")
            if res[0]["two_ranks_f32"][0]["params"] != res[1]["two_ranks_f32"][0]["params"]:
                fail("scene-train f32 step: the two ranks' parameters differ")
            for s in range(PAR_TRAIN_STEPS):
                if two[0][s]["params"] != two[1][s]["params"]:
                    fail(f"scene-train step {s}: the two ranks' parameters differ")
                rel = abs(two[0][s]["loss"] - one[s]["loss"]) / abs(one[s]["loss"])
                if not rel <= 1e-2:
                    fail(f"scene-train step {s}: loss {two[0][s]['loss']} on (2, 1) vs "
                         f"{one[s]['loss']} on one rank")
            log(f"parallel train2 ({wall:.1f} s): scene-train steps on (2, 1) at "
                f"{WIDTH}x{HEIGHT}, one frame a rank: losses {[t['loss'] for t in two[0]]} vs one "
                f"rank with both frames {[t['loss'] for t in one]}; parameters equal on both "
                f"ranks after every step; ms/step {[round(t['ms'], 1) for t in two[0]]} (one rank "
                f"{[round(t['ms'], 1) for t in one]}); peak {res[0]['peak_gib']:.2f} / "
                f"{res[1]['peak_gib']:.2f} GiB a rank (one rank, two frames "
                f"{res[0]['one_rank_peak_gib']:.2f}); launches {res[0]['launches']} ({card})")
            continue
        for r in res:
            for name, c in r["cases"].items():
                log(f"parallel {label} rank {r['rank']}/{r['world']} ({r['backend']}) {name}: "
                    f"{c['ms_per_frame']:.3f} ms/frame (card), {c['host_ms_per_frame']:.3f} "
                    f"(host), launches {c['launches']}"
                    + "".join(f", {k} {v}" for k, v in c.items()
                              if k not in ("ms_per_frame", "host_ms_per_frame", "launches")))
        log(f"parallel {label}: {world} rank(s), every case bit for bit against one device "
            f"({wall:.1f} s wall, peak {max(r['peak_gib'] for r in res):.2f} GiB a rank)")
    strips = out["gloo4"]["ranks"][0]["cases"]["strips_full"]
    log(f"strip U-Net (4 strips of 272 rows + 2 x {TILE_UNET_HALO} overlap, bf16) vs one "
        f"device at 1088 rows: rgb_f max {strips['rgb_f_max']:.4f}, mean "
        f"{strips['rgb_f_mean']:.5f}; rows {STRIP_EDGE}-{1088 - STRIP_EDGE - 1} max "
        f"{strips['rgb_f_inner_max']:.4f}, mean {strips['rgb_f_inner_mean']:.5f} (bounds 0.15, "
        f"2e-3; |rgb_f| max {strips['rgb_f_scale']:.3f}); uint8 frame max {strips['rgb8_max']}, "
        f"mean {strips['rgb8_mean']:.4f} levels (bound 1); worst rows {strips['worst_rows']}")
    return out


def check_band_ref(points, colors, valid, M, band, rows):
    """The band-reference forms at the bench shape: the cloud in PAR_RANKS
    contiguous blocks (the point shards of the parallel paths), each block's
    local z-buffer from ``rtnr_resolve4``, their minimum as the reference;
    for each block ``rtnr_resolve4``'s sums form with ``band_ref`` bit for
    bit against its twin, the blocks' sums adding up to the whole cloud's
    and the depth output equal to the local z-buffer; ``rtnr_resolve_diff``
    with ``band_ref`` the same on the integer colours (twin on the card),
    and on noisy f32 colours against the CPU twin (first block); each form
    timed through its C entry in turns against the same entry without the
    reference, beside its twin, its bound and ``segment_reduce`` +
    ``index_copy_`` over the same in-band runs."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops.raster import SortedDiff, project_and_sort, project_and_sort_diff

    hw = WIDTH * HEIGHT
    n = points.shape[0]
    b = n // PAR_RANKS
    blocks = [slice(i * b, (i + 1) * b) for i in range(PAR_RANKS)]
    sps = [project_and_sort(points[s], colors[s], M, width=WIDTH, height=HEIGHT,
                            valid=valid[s]) for s in blocks]
    mins = [rr.raster_images_v4(sp, hw, band)[2] for sp in sps]
    gmin = torch.stack(mins).amin(0)
    whole = rr.raster_images_v4(project_and_sort(points, colors, M, width=WIDTH, height=HEIGHT,
                                                 valid=valid), hw, band)
    tot = [torch.zeros_like(whole[0]), torch.zeros_like(whole[1])]
    for sp, lm in zip(sps, mins):
        got = rr.raster_images_v4(sp, hw, band, band_ref=gmin)
        if not same_bits(got, rr.raster_images_v4_plain(sp, hw, band, band_ref=gmin)):
            fail("rtnr_resolve4 (band_ref) differs from its twin")
        if not same_bits(got[2:], (lm,)):
            fail("rtnr_resolve4 (band_ref): the depth output is not the local z-buffer")
        tot[0] += got[0]
        tot[1] += got[1]
    if not (same_bits(tot, whole[:2]) and same_bits((gmin,), whole[2:])):
        fail("the blocks' band_ref sums do not add up to the whole cloud's raster")

    sds = [project_and_sort_diff(points[s], colors[s].float(), M, width=WIDTH, height=HEIGHT,
                                 valid=valid[s])[0] for s in blocks]
    dmins = [rr.raster_images_diff(sd, hw, band)[2] for sd in sds]
    dref = torch.stack(dmins).amin(0)
    tsum = torch.zeros((hw, 3), device=M.device)
    for sd in sds:
        got = rr.raster_images_diff(sd, hw, band, band_ref=dref)
        if not same_bits(got, rr.raster_images_diff_plain(sd, hw, band, band_ref=dref)):
            fail("rtnr_resolve_diff (band_ref) differs from its twin (integer colours)")
        tsum += got[0]
    if not torch.equal(tsum, whole[0].float()):
        fail("the blocks' band_ref diff sums do not add up to the whole cloud's")
    g = torch.Generator(device=M.device).manual_seed(SEED)
    sd0 = sds[0]._replace(rgb=(sds[0].rgb + torch.rand(sds[0].rgb.shape, generator=g,
                                                       device=M.device)).contiguous())
    got = rr.raster_images_diff(sd0, hw, band, band_ref=dref)
    cpu = rr.raster_images_diff_plain(SortedDiff(*(t.cpu() for t in sd0)), hw, band,
                                      band_ref=dref.cpu())
    if not same_bits([t.cpu() for t in got], cpu):
        fail("rtnr_resolve_diff (band_ref) differs from its CPU twin on noisy colours")
    log(f"band_ref forms at {WIDTH}x{HEIGHT}, {n} points in {PAR_RANKS} blocks: rtnr_resolve4 "
        "(sums) and rtnr_resolve_diff bit for bit against their twins (noisy f32 colours: the "
        "CPU twin), depth output = the local z-buffer, the blocks' sums = the whole cloud's")

    # times through the C entries, with and without the reference, in turns
    lib = rr._lib()
    sp, sd = sps[0], sds[0]
    stream = torch.cuda.current_stream(M.device).cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=M.device)
    sums, cnt, depth = i32(hw, 3), i32(hw), i32(hw)
    outs = (sums.data_ptr(), cnt.data_ptr(), depth.data_ptr())
    a4 = (sp.pix.data_ptr(), sp.zbits.data_ptr(), sp.packed.data_ptr(), sp.pix.numel(), hw,
          band, 1, 0) + outs
    ad = (sd.pix.data_ptr(), sd.zbits.data_ptr(), sd.rgb.data_ptr(), sd.pix.numel(), hw,
          band, 1) + outs
    calls = {"r4": (lib.rtnr_resolve4, a4 + (None, stream)),
             "r4_ref": (lib.rtnr_resolve4, a4 + (gmin.data_ptr(), stream)),
             "diff": (lib.rtnr_resolve_diff, ad + (None, stream)),
             "diff_ref": (lib.rtnr_resolve_diff, ad + (dref.data_ptr(), stream))}
    for name, (fn, args) in calls.items():
        _build.check(fn(*args), name)
    k = {name: (lambda fn=fn, args=args: fn(*args)) for name, (fn, args) in calls.items()}
    r4_ms, r4_ref_ms = turns_ms({"r4": k["r4"], "r4_ref": k["r4_ref"]})
    d_ms, d_ref_ms = turns_ms({"diff": k["diff"], "diff_ref": k["diff_ref"]})
    p4 = time_ms(lambda: rr.raster_images_v4_plain(sp, hw, band, band_ref=gmin), reps=2)
    pd = time_ms(lambda: rr.raster_images_diff_plain(sd, hw, band, band_ref=dref), reps=2)
    n_in = int((sp.pix < hw).sum())
    # bytes: the block's in-frame elements once (12 B; 20 B with f32 colour),
    # the reference at the pixels with points (4 B), 20 B written a pixel
    n_px = int((mins[0] < 3e38).sum())
    b4, by4 = bound_ms(12.0 * n_in + 4.0 * n_px + 20.0 * hw, 0.0)
    bd, byd = bound_ms(20.0 * n_in + 4.0 * n_px + 20.0 * hw, 0.0)
    # yardsticks, as the resolves' rows: segment_reduce over the same in-band
    # runs (the band against the reference; f32 lanes r, g, b, 1), then
    # index_copy_ of the per-pixel rows into a dense (H*W, 4) image
    z = sp.zbits.view(torch.float32)
    w = (sp.pix < hw) & ~(z > gmin[sp.pix.clamp(max=hw - 1).long()] + band)
    pk = sp.packed[w]
    lanes = torch.stack([pk & 255, (pk >> 8) & 255, (pk >> 16) & 255,
                         torch.ones_like(pk)], 1).float()
    cnt4 = rr.raster_images_v4(sp, hw, band, band_ref=gmin)[1]
    lanes_f = torch.cat([sd.rgb[w], torch.ones_like(sd.rgb[w, :1])], 1)

    def library(data):
        lengths = cnt4[cnt4 > 0].to(torch.int64)
        if int(lengths.sum()) != data.shape[0]:
            fail("band_ref yardstick: the in-band runs do not match the counts")
        occupied = (cnt4 > 0).nonzero()[:, 0]
        dense = torch.zeros((hw, 4), dtype=torch.float32, device=M.device)
        return lambda: dense.index_copy_(0, occupied, torch.segment_reduce(
            data, "sum", lengths=lengths, axis=0))

    lib4, libd = time_ms(library(lanes)), time_ms(library(lanes_f))
    rows["resolve4_ref"] = dict(ms=r4_ref_ms, plain_ms=p4, bound_ms=b4, bound_by=by4,
                                library_ms=lib4, max_abs_err=0.0, without_ref_ms=r4_ms)
    rows["resolve_diff_ref"] = dict(ms=d_ref_ms, plain_ms=pd, bound_ms=bd, bound_by=byd,
                                    library_ms=libd, max_abs_err=0.0, without_ref_ms=d_ms)
    log(f"band_ref (C entries, one block of {sp.pix.numel()} points, {n_in} in frame): "
        f"rtnr_resolve4 sums {r4_ref_ms:.4f} ms with the reference, {r4_ms:.4f} without, in "
        f"turns (bound {b4:.4f} {by4}, twin {p4:.4f}, segment_reduce + index_copy_ "
        f"{lib4:.4f}); rtnr_resolve_diff {d_ref_ms:.4f} ms with, {d_ms:.4f} without (bound "
        f"{bd:.4f} {byd}, twin {pd:.4f}, segment_reduce + index_copy_ {libd:.4f})")


PAR_CLI_TRAIN_STEPS = 30  # steps of the training CLI on 2 ranks


def torchrun(nproc: int, module: str, args, timeout: float = 400):
    """``python -m torch.distributed.run --standalone --nproc-per-node N -m
    module args``: (exit code, stdout, stderr, seconds)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), "-m", module] + list(args)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def parallel_cli_runs(files, ckpt, cache, serial_full, tmp, card):
    """The render CLI through ``torch.distributed.run`` on PAR_RANKS ranks
    sharing the card, on the host phase's files: ``--batch 4 --stage full``
    (PNGs the serial CLI's bytes), ``--tiles 4 --stage project`` (the serial
    project PNGs' bytes) and ``--tiles 4 --stage full`` (the U-Net strips:
    its PNGs against the serial ones, max and mean in levels)."""
    import os

    import numpy as np
    from rtnr_tpu_torch.apps import render_trajectory as cli
    from rtnr_tpu_torch.utils.image import read_png

    serial_proj = os.path.join(tmp, "serial_project")
    if cli.main(files + ["-o", serial_proj, "--stage", "project", "--cache-dir", cache]) != 0:
        fail("serial render CLI (project) failed")
    n = len(CLI_POSES)
    frames = [f"frame_{i + 1}.png" for i in range(n)]
    res = {}
    for label, argv, want in (
            ("batch_full", ["--batch", "4", "--stage", "full", "--ckpt", ckpt], serial_full),
            ("tiles_project", ["--tiles", "4", "--stage", "project"], serial_proj),
            ("tiles_full", ["--tiles", "4", "--stage", "full", "--ckpt", ckpt], serial_full)):
        out = os.path.join(tmp, label)
        rc, so, se, secs = torchrun(PAR_RANKS, "rtnr_tpu_torch.apps.render_trajectory",
                                    files + ["-o", out, "--cache-dir", cache] + argv)
        for line in so.strip().splitlines():
            log(f"  {label}| {line}")
        if rc != 0:
            fail(f"render CLI {label} on {PAR_RANKS} ranks exited {rc}: {se[-4000:]}")
        rec = json.loads(so.strip().splitlines()[-1])
        if sum(1 for line in so.splitlines() if line.startswith("{")) != 1:
            fail(f"render CLI {label}: the closing line came from more than rank 0")
        diff = []
        for f in frames:
            a, b = read_png(os.path.join(out, f)), read_png(os.path.join(want, f))
            if label != "tiles_full":
                with open(os.path.join(out, f), "rb") as x, open(os.path.join(want, f), "rb") as y:
                    if x.read() != y.read():
                        fail(f"render CLI {label}: {f} differs from the serial CLI's")
            diff.append(np.abs(a.astype(np.int32) - b.astype(np.int32)))
        d = np.stack(diff)
        if not d.mean() <= 1.0:
            fail(f"render CLI {label}: mean {d.mean():.4f} levels from the serial frames")
        res[label] = {"rc": rc, "seconds": secs, "record": rec, "max_levels": int(d.max()),
                      "mean_levels": float(d.mean())}
        log(f"render CLI {label} on {PAR_RANKS} ranks sharing the card: exit 0, {n} PNGs "
            + ("byte-equal to the serial CLI's" if label != "tiles_full" else
               f"against the serial frames max {int(d.max())}, mean {d.mean():.4f} levels")
            + f"; {rec['fps']} fps, {secs:.1f} s with start-up ({card})")
    return res


def parallel_train_cli(ply, traj, calib, d, card):
    """The training CLI through ``torch.distributed.run`` on 2 ranks sharing
    the card (one frame a rank): the loss falls, rank 0 alone logs and
    writes the checkpoint, which loads and renders a finite frame."""
    import os

    import numpy as np
    from rtnr_tpu_torch.camera import Camera, Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables

    ckpt = os.path.join(d, "unet2.msgpack")
    rc, so, se, secs = torchrun(2, "rtnr_tpu_torch.apps.train_unet",
                                [ply, traj, calib, "--self-supervised", "--steps",
                                 str(PAR_CLI_TRAIN_STEPS), "--lr", "2e-4", "-o", ckpt,
                                 "--log-every", "5"])
    for line in so.strip().splitlines():
        log(f"  train2| {line}")
    if rc != 0:
        fail(f"training CLI on 2 ranks exited {rc}: {se[-4000:]}")
    logs = [json.loads(line) for line in so.splitlines() if line.startswith("{")]
    if not logs or logs[-1]["step"] != PAR_CLI_TRAIN_STEPS - 1 or len(
            {e["step"] for e in logs}) != len(logs):
        fail(f"training CLI on 2 ranks: {len(logs)} log lines (rank 0 alone logs)")
    if not logs[-1]["loss"] < logs[0]["loss"]:
        fail(f"training CLI on 2 ranks: the loss did not fall ({logs[0]['loss']} -> "
             f"{logs[-1]['loss']})")
    r = Renderer(Scene.from_file(ply), RenderConfig(), load_unet_variables(ckpt), device="cuda")
    y = r.compute_full(Camera.load_calibration(calib), Trajectory.load(traj).world_to_cam(8))
    if not np.isfinite(y["rgb_f"]).all():
        fail("training CLI on 2 ranks: the checkpoint renders a non-finite frame")
    del r
    log(f"training CLI on 2 ranks sharing the card ({card}): {PAR_CLI_TRAIN_STEPS} steps, batch "
        f"2 (one frame a rank), loss {logs[0]['loss']:.5f} -> {logs[-1]['loss']:.5f}, "
        f"{secs:.1f} s with start-up; the checkpoint loads and renders")
    return {"steps": PAR_CLI_TRAIN_STEPS, "loss_first": logs[0]["loss"],
            "loss_last": logs[-1]["loss"], "seconds": secs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import numpy as np

        from rtnr_tpu_torch import _build
        from rtnr_tpu_torch.camera import Camera
        from rtnr_tpu_torch.config import RenderConfig
        from rtnr_tpu_torch.models.convert import init_unet_numpy
        from rtnr_tpu_torch.ops import bn_train
        from rtnr_tpu_torch.ops import conv as cv
        from rtnr_tpu_torch.ops import conv_direct, prefilter
        from rtnr_tpu_torch.ops import raster_resolve4 as rr
        from rtnr_tpu_torch.ops import raster_resolve5 as r5
        from rtnr_tpu_torch.ops import raster_resolve_carriers as rc
        from rtnr_tpu_torch.ops.raster import project_and_sort
        from rtnr_tpu_torch.pipeline import Renderer, render_filtered
        from rtnr_tpu_torch.scene import Scene
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if "jax" in sys.modules or "rtnr_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # the host library (g++: PLY, .oct, E57, JPEG) builds beside the nvcc builds
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(_build.build_host)
        built = _build.build_all()
        built["host (g++)"] = host.result()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {secs:.2f} s' for k, (secs, _) in built.items())})")
    for k, (_, nvcc_out) in built.items():
        for line in _build.ptxas_report(nvcc_out):
            log(f"  ptxas {k}: {line}")

    # ---- the slice's configuration ----
    t0 = time.perf_counter()
    scene = Scene.synthetic(POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    E = np.eye(4)
    E[2, 3] = 12.0
    cfg = RenderConfig()  # bf16 exact, features (64, 128, 256, 512)
    variables = init_unet_numpy(SEED, cfg.unet_features)
    renderer = Renderer(scene, cfg, variables, device="cuda")
    static_r = Renderer(scene, RenderConfig(unet_int8="static"), variables, device="cuda")
    dyn_r = Renderer(scene, RenderConfig(unet_int8="dyn"), variables, device="cuda")
    torch.cuda.synchronize()
    log(f"setup: {POINTS} points, {WIDTH}x{HEIGHT}, U-Net {cfg.unet_features} bf16, "
        f"static int8, dyn int8, {time.perf_counter() - t0:.2f} s")

    # ---- kernel checks at the main path's shapes ----
    rows = {}
    hw = WIDTH * HEIGHT
    M = renderer._cam_proj(cam, E)
    sp = project_and_sort(renderer.points, renderer.colors, M, width=WIDTH, height=HEIGHT,
                          valid=renderer.valid)
    check_resolve(renderer, M, sp, hw, cfg.depth_band, rows)
    del sp
    split = projection_split(renderer, M, cfg.depth_band)
    mid = render_filtered(renderer.points, renderer.colors, renderer.valid, M,
                          width=WIDTH, height=HEIGHT)
    x = mid["unet_input"][None]
    check_prefilter(mid["raw_depth"], mid["raw_rgb"], rows)
    del mid
    check_convs(renderer.unet, x, rows)
    diff_ms = check_diff_raster(renderer.points, renderer.colors, renderer.valid, M,
                                cfg.depth_band, rows)
    check_band_ref(renderer.points, renderer.colors, renderer.valid, M, cfg.depth_band, rows)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counted = {"resolve4": rr.raster_images_v4, "resolve5": r5.raster_images_v5,
               "resolve_diff": rr.raster_images_diff,
               "winners": rr.winners,
               "expand": rr.expand_winners,
               "conv3x3": cv.conv3x3, "convt2x2": cv.convt2x2, "winners_f32": rr.winners_f32,
               "conv3x3_i8out": cv.conv3x3_i8out, "conv3x3_static": cv.conv3x3_static,
               "conv3x3_dyn": cv.conv3x3_dyn, "convt2x2_static": cv.convt2x2_static,
               "winners5": r5.winners5, "resolve_carriers": rc.resolve_carriers,
               "conv3x3_direct": conv_direct.conv3x3_pallas, "conv3x3_wgmma": cv.conv3x3_wgmma,
               "conv3x3_up": cv.conv3x3_up, "conv3x3_dyn_wgmma": cv.conv3x3_dyn_wgmma,
               "convt2x2_static_wgmma": cv.convt2x2_static_wgmma,
               "conv3x3_static_wgmma": cv.conv3x3_static_wgmma,
               "convt2x2_wgmma": cv.convt2x2_wgmma,
               # one counter, two rows: the input conv's bf16 and int8-out forms
               "conv3x3_in": cv.conv3x3_in, "conv3x3_in_i8out": cv.conv3x3_in,
               "bn_train": bn_train.bn_relu_train, "prefilter": prefilter.filter_frame}
    sorts = check_resolvers(renderer, M, cfg.depth_band, rows)
    conv_direct_path = check_conv_direct(rows, counted)
    conv_up = check_conv_up(renderer.unet, x, rows)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- int8 only where JAX quantises: 960x720 is outside its phase path ----
    int8_gate = check_int8_gate(renderer, static_r, dyn_r, counted)

    # ---- the int8 modes: calibration, kernels and nets at the frame's shapes ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = static_r.calibrate(cam, E)  # the lazy calibration, on this view's U-Net input
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    log(f"static-int8 calibration (render_filtered + one bf16 forward + weight "
        f"quantisation): {calib_ms:.3f} ms, {len(scales)} scales, range "
        f"[{min(float(v) for v in scales.values()):.4g}, "
        f"{max(float(v) for v in scales.values()):.4g}]")
    if len(scales) != 21:
        fail(f"calibration recorded {len(scales)} scales, not 21")
    int8_kernels = check_int8_convs(static_r.unet, scales, dyn_r.unet, x, rows)
    int8_err = check_int8_nets(renderer.unet, static_r.unet, scales, dyn_r.unet, x)
    torch.cuda.empty_cache()

    # ---- the main path: bf16 ----
    torch.cuda.reset_peak_memory_stats()
    serve = serve_frames(renderer, cam, E, FRAMES, counted,
                         ("resolve4", "conv3x3", "convt2x2", "conv3x3_wgmma",
                          "convt2x2_wgmma", "conv3x3_in"), "bf16",
                         host_frames=HOST_FRAMES,
                         per_frame={"resolve4": 1, "winners": 0, "expand": 0, "prefilter": 1,
                                    "conv3x3_wgmma": 17, "convt2x2_wgmma": 4, "conv3x3_up": 0,
                                    "conv3x3_dyn_wgmma": 0, "convt2x2_static_wgmma": 0,
                                    "conv3x3_static_wgmma": 0, "conv3x3_in": 1,
                                    "conv3x3": 18, "conv3x3_i8out": 0})
    peak = torch.cuda.max_memory_allocated() / 2**30
    bf16_trace = trace_frames(renderer, cam, E, serve["ms_per_frame"])
    resolvers = resolver_frames(renderer, cam, E, counted)
    fuse_up = fuse_up_frames(renderer, dyn_r, cam, E, x, counted)

    # ---- the bf16 U-Net against the plain f32 twin net at the full shape ----
    with torch.no_grad():
        yk = renderer.unet(x).float()
        yr = renderer.unet.forward_plain(x, torch.float32)
    d = (yk - yr).abs()
    scale = max(1.0, float(yr.abs().max()))
    dmax, dmean = float(d.max()), float(d.mean())
    log(f"U-Net bf16 vs f32 twin at {tuple(x.shape)}: max {dmax:.4g}, mean {dmean:.4g}, "
        f"|ref| max {float(yr.abs().max()):.4g} (budget max 5e-2, mean 5e-3 x {scale:.4g})")
    if not (dmax <= 5e-2 * scale and dmean <= 5e-3 * scale):
        fail("U-Net bf16 output outside the budget against the f32 twin")
    # the strip U-Net's shape (render_full_tile_sharded at 1080p in 4 strips:
    # 272 + 2 x 32 rows): the kernels take it (same budget), and a static
    # int8 net runs exact bf16 there (336 % 64 != 0: the int8 gate)
    xs = x[:, :1088 // PAR_RANKS + 2 * TILE_UNET_HALO].contiguous()
    for fn in counted.values():
        fn.launches = 0
    with torch.no_grad():
        ys = renderer.unet(xs).float()
        yq = static_r.unet(xs, act_scales=static_r.act_scales).float()
        yr = renderer.unet.forward_plain(xs, torch.float32)
    strip_launches = {k: fn.launches for k, fn in counted.items()}
    d = (ys - yr).abs()
    scale = max(1.0, float(yr.abs().max()))
    log(f"U-Net at the strip shape {tuple(xs.shape)}: bf16 kernels vs f32 twin max "
        f"{float(d.max()):.4g}, mean {float(d.mean()):.4g} (budget as above x {scale:.4g}); the "
        f"static net {'equals' if torch.equal(yq, ys) else 'differs from'} the bf16 frame; "
        f"launches {dict((k, v) for k, v in strip_launches.items() if v)}")
    if not (float(d.max()) <= 5e-2 * scale and float(d.mean()) <= 5e-3 * scale):
        fail("U-Net at the strip shape outside the budget against the f32 twin")
    if not torch.equal(yq, ys) or strip_launches["conv3x3_static_wgmma"] != 0 \
            or strip_launches["conv3x3_wgmma"] != 34:
        fail("the strip shape did not run exact bf16 on the sm90 kernels in both nets")
    del yk, yr, x, xs, ys, yq

    check_small_vs_cpu((16, 32))

    # ---- the int8 serving paths ----
    serve_static = serve_frames(static_r, cam, E, INT8_FRAMES, counted,
                                ("resolve4", "conv3x3_i8out", "conv3x3_static",
                                 "convt2x2_static", "convt2x2_static_wgmma",
                                 "conv3x3_static_wgmma", "conv3x3_in"), "static int8",
                                per_frame={"resolve4": 1, "winners": 0, "expand": 0,
                                           "prefilter": 1, "conv3x3_static": 17, "conv3x3_static_wgmma": 17,
                                           "convt2x2_static": 4, "convt2x2_static_wgmma": 4,
                                           "convt2x2_wgmma": 0, "conv3x3_in": 1,
                                           "conv3x3_i8out": 1, "conv3x3": 0})
    serve_dyn = serve_frames(dyn_r, cam, E, INT8_FRAMES, counted,
                             ("resolve4", "conv3x3", "conv3x3_dyn", "convt2x2",
                              "conv3x3_wgmma", "conv3x3_dyn_wgmma", "convt2x2_wgmma",
                              "conv3x3_in"),
                             "dyn int8",
                             per_frame={"resolve4": 1, "winners": 0, "expand": 0,
                                        "prefilter": 1, "conv3x3_wgmma": 7, "conv3x3_dyn": 10,
                                        "conv3x3_dyn_wgmma": 10, "convt2x2_wgmma": 4,
                                        "conv3x3_static_wgmma": 0, "conv3x3_in": 1,
                                        "conv3x3": 8})
    static_trace = trace_frames(static_r, cam, E, serve_static["ms_per_frame"],
                                label="static int8")
    dyn_trace = trace_frames(dyn_r, cam, E, serve_dyn["ms_per_frame"], label="dyn int8")
    # no kernel of conv.cu in any mode's frame: its GEMM, pool, head and dyn pre-pass
    for label, tr in (("bf16", bf16_trace), ("static int8", static_trace),
                      ("dyn int8", dyn_trace)):
        if not tr:
            log(f"{label} trace: conv.cu kernels not measured (no device events)")
            continue
        left = [n for n in tr if re.search(r"\bgemm<\d, \d>|maxpool2<|head1x1_bf16|dyn_scales", n)]
        log(f"{label} trace: conv.cu's gemm / maxpool2 / head1x1_bf16 / dyn_scales "
            f"{'absent' if not left else 'present: ' + ', '.join(left)}")
        if left:
            fail(f"the {label} frame still runs conv.cu kernels")
        # the v4 resolve: one rtnr_resolve4 kernel a frame, no K1 or K2 kernel
        old_k12 = [n for n in tr
                   if re.search(r"winners_(count|scan|write)|expand_(tile|search)", n)]
        r4 = [v[1] for n, v in tr.items() if "resolve4_tile" in n]
        log(f"{label} trace: resolve4_tile x{sum(r4)} a frame; K1's and K2's kernels "
            f"{'absent' if not old_k12 else 'present: ' + ', '.join(old_k12)}")
        if old_k12 or sum(r4) != 1:
            fail(f"the {label} frame does not resolve through one rtnr_resolve4 kernel")
    # end to end at a second pose, away from the calibration view
    E2 = np.eye(4)
    E2[0, 3], E2[1, 3], E2[2, 3] = 1.5, -0.5, 9.0
    ya = renderer.compute_full_tensors(cam, E2)["rgb_f"]
    yq = static_r.compute_full_tensors(cam, E2)["rgb_f"]
    dd = (ya - yq).abs()
    sc = float(ya.abs().max())
    e2e = {"max": float(dd.max()), "mean": float(dd.mean()), "scale": sc}
    log(f"static int8 vs bf16 rgb_f at a second pose (not the calibration view): max "
        f"{e2e['max']:.4g}, mean {e2e['mean']:.4g}, max|bf16| {sc:.4g} (budget 0.10 / 0.02 x it)")
    if not (e2e["max"] <= 0.10 * sc and e2e["mean"] <= 0.02 * sc):
        fail("static int8 end to end outside the budget at the second pose")
    del ya, yq, dd

    # ---- the culled render, camera inside the cloud ----
    Ec = np.eye(4)
    Ec[2, 3] = 2.0
    culled_r = Renderer(scene, cfg, variables, cull_budget="auto", device="cuda")
    culled = check_culled(renderer, culled_r, cam, Ec)
    del culled_r, static_r, dyn_r

    # ---- the training paths ----
    torch.cuda.empty_cache()
    check_bn_train(rows)
    train = train_phase(renderer, cam, E, variables, counted)
    check_small_train_vs_cpu()

    # ---- the host layer, the render CLI and the bench line ----
    del renderer
    torch.cuda.empty_cache()
    host = host_cli_bench_phase(scene, variables, counted, card, serve_static["ms_per_frame"])
    del scene
    torch.cuda.empty_cache()

    # ---- the training CLI, the JAX package's scripts/train_demo_r5.py ----
    train_cli = train_cli_phase(card)

    # ---- the E57 chain: pairs from a 5M-point scanner file, training on them ----
    e57 = e57_phase(card, counted)

    # ---- the multi-rank slice: ranks sharing the card, gloo and NCCL ----
    torch.cuda.empty_cache()
    par = parallel_phase(card, rows)

    sm90_src = "rtnr_tpu_torch/csrc/conv_sm90.cu"
    i8_src = "rtnr_tpu_torch/csrc/conv_i8_sm90.cu"
    in_src = "rtnr_tpu_torch/csrc/conv_in_sm90.cu"
    sources = {
        # K1 and K2 of the v4 path in one kernel
        "resolve4": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                     "rtnr_tpu/ops/raster_pallas4.py:663, rtnr_tpu/ops/raster_pallas4.py:920"),
        # K6 and K2 of the v5 path in one kernel
        "resolve5": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                     "rtnr_tpu/ops/raster_pallas5.py:516, rtnr_tpu/ops/raster_pallas4.py:920"),
        # K1 alone: no path launches it since rtnr_resolve4 (its tests, the previous pair)
        "winners": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                    "rtnr_tpu/ops/raster_pallas4.py:663"),
        "expand": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                   "rtnr_tpu/ops/raster_pallas4.py:920"),
        # every K3 bf16 call of a frame: 17 on conv_sm90.cu, the input conv on conv_in_sm90.cu
        "conv3x3": ("cuda", f"{sm90_src}, {in_src}", "rtnr_tpu/ops/conv_phase.py:1018"),
        "conv3x3_wgmma": ("cuda", sm90_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        "convt2x2": ("cuda", sm90_src, "rtnr_tpu/ops/conv_phase.py:1310"),
        # K5 and K2's float_sums mode of the differentiable forward in one kernel
        "resolve_diff": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                         "rtnr_tpu/ops/raster_pallas4.py:872, rtnr_tpu/ops/raster_pallas4.py:920"),
        # K5 alone: no path launches it since rtnr_resolve_diff (its tests, the previous pair)
        "winners_f32": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                        "rtnr_tpu/ops/raster_pallas4.py:872"),
        # every int8-output K3 call of a frame: the input conv
        "conv3x3_i8out": ("cuda", in_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        "conv3x3_static": ("cuda", i8_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        "conv3x3_dyn": ("cuda", i8_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        "convt2x2_static": ("cuda", i8_src, "rtnr_tpu/ops/conv_phase.py:1310"),
        "winners5": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                     "rtnr_tpu/ops/raster_pallas5.py:516"),
        "resolve_carriers": ("cuda", "rtnr_tpu_torch/csrc/raster_resolve.cu",
                             "rtnr_tpu/ops/raster_pallas3.py:448, "
                             "rtnr_tpu/ops/raster_pallas2.py:334, "
                             "rtnr_tpu/ops/raster_pallas.py:303"),
        "conv3x3_direct": ("cuda", sm90_src, "rtnr_tpu/ops/conv_pallas.py:272"),
        # K3's up_kernel= mode (conv_phase.py:720-780), the same pallas_call site
        "conv3x3_up": ("cuda", sm90_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        # the input conv, down0/conv0 (to_phase's padded channels, conv_phase.py:46-57,
        # :842-856), in its two output forms
        "conv3x3_in": ("cuda", in_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        "conv3x3_in_i8out": ("cuda", in_src, "rtnr_tpu/ops/conv_phase.py:1018"),
        # no TPU kernel: flax's nn.BatchNorm + ReLU, which XLA fuses on its own
        "bn_train": ("cuda", "rtnr_tpu_torch/csrc/bn_train.cu",
                     "none (flax nn.BatchNorm + relu under XLA, rtnr_tpu/models/unet.py:366-374)"),
        # no TPU kernel: the JAX package's jnp prefilter, which XLA fuses on its own
        "prefilter": ("cuda", "rtnr_tpu_torch/csrc/prefilter.cu",
                      "none (jnp depth_prefilter under XLA, rtnr_tpu/ops/prefilter.py)"),
    }
    labels = {"resolve4": "K1 + K2, the v4 resolve (packed form)",
              "resolve5": "K6 + K2, the v5 resolve (packed form)",
              "resolve_diff": "K5 + K2 float_sums, the differentiable forward's resolve",
              "conv3x3_in": "K3 input conv, bf16 out",
              "conv3x3_in_i8out": "K3 input conv, int8 out",
              "bn_train": "UNetTrain BatchNorm + ReLU, forward and backward, a step's 18 layers",
              "prefilter": "the depth prefilter of a 1080p frame (pad, pyramid, 4 level passes)"}
    # each kernel's launches on the path that runs it (all paths in launches_by_path)
    paths = {"serve": serve, "serve_static": serve_static, "serve_dyn": serve_dyn,
             "render_cli": host,
             **{f"e57_{part}": {"launches": n} for part, n in e57["launches"].items()},
             "train_step": train["train_step"], "scene_step": train["scene_step"],
             "conv_direct": conv_direct_path, "serve_fuse_up": fuse_up["serve"],
             "serve_fuse_up_dyn": {"launches": fuse_up["dyn_launches"]},
             **{f"resolve_{m}": r for m, r in resolvers.items()}}
    own = {"resolve5": "resolve_v5", "resolve_diff": "scene_step", "expand": "scene_step",
           "winners_f32": "scene_step",
           "conv3x3_i8out": "serve_static",
           "conv3x3_static": "serve_static", "convt2x2_static": "serve_static",
           "conv3x3_dyn": "serve_dyn", "winners5": "resolve_v5",
           "resolve_carriers": "resolve_v3", "conv3x3_direct": "conv_direct",
           "conv3x3_up": "serve_fuse_up", "conv3x3_in_i8out": "serve_static",
           "bn_train": "train_step"}
    kernels = []
    for name, (route, src, repl) in sources.items():
        r = rows[name]
        by_path = {p: v["launches"][name] for p, v in paths.items()}
        kernels.append({
            "name": name, **({"label": labels[name]} if name in labels else {}),
            "route": route, "source": src, "replaces": repl,
            "launches": by_path[own.get(name, "serve")], "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"previous_ms": r["previous_ms"]} if "previous_ms" in r else {}),
            **({"pair_ms": r["pair_ms"]} if "pair_ms" in r else {}),
            **({"bf16_ms": r["bf16_ms"]} if "bf16_ms" in r else {}),
            **({k: r[k] for k in ("sums_ms", "sums_bound_ms", "wrapper_ms", "float_sums_ms",
                                  "forward_ms", "wall_ms") if k in r}),
        })
    # the band-reference forms: launched on the point-sharded paths of the
    # parallel phase (rank 0 of the four gloo ranks; every rank the same)
    cases = par["gloo4"]["ranks"][0]["cases"]
    for name, kernel, case, repl in (
            ("resolve4_ref", "rtnr_resolve4 (sums form, band_ref)", "point_sharded",
             "rtnr_tpu/ops/raster_pallas4.py:663, rtnr_tpu/ops/raster_pallas4.py:920"),
            ("resolve_diff_ref", "rtnr_resolve_diff (band_ref)", "diff_point_sharded",
             "rtnr_tpu/ops/raster_pallas4.py:872, rtnr_tpu/ops/raster_pallas4.py:920")):
        r = rows[name]
        kernels.append({
            "name": name, "label": kernel, "route": "cuda",
            "source": "rtnr_tpu_torch/csrc/raster_resolve.cu", "replaces": repl,
            "launches": cases[case]["launches"][name],
            "launches_by_path": {f"parallel_{c}": v["launches"][name]
                                 for c, v in cases.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "without_ref_ms": r["without_ref_ms"]})
    summary = {"ms_per_frame": serve["ms_per_frame"], "frames": serve["frames"],
               "host_out_ms_per_frame": serve["host_out_ms_per_frame"],
               "stage_ms": serve["stage_ms"], "points": POINTS, "width": WIDTH,
               "height": HEIGHT, "peak_mem_gib": peak, "card": card,
               "static_int8": {**serve_static, "calibration_ms": calib_ms,
                               "unet_err": int8_err["static"], "e2e_second_pose": e2e},
               "dyn_int8": {**serve_dyn, "unet_err": int8_err["dyn"]},
               "culled": culled,
               "resolvers": {m: {k: r[k] for k in ("ms_per_frame", "all_ms", "stage_ms",
                                                   "launches")}
                             for m, r in resolvers.items()},
               "sorts": sorts, "projection_split": split,
               "fuse_up": {"kernel": conv_up, "unet_err": fuse_up["unet_err"],
                           "max_diff_from_unfused_frame": fuse_up["max_diff_from_unfused_frame"],
                           **{k: fuse_up["serve"][k] for k in ("ms_per_frame", "all_ms",
                                                               "stage_ms", "launches")},
                           "dyn_launches": fuse_up["dyn_launches"]},
               "int8_gate": int8_gate, "int8_kernels": int8_kernels,
               "host": {k: host[k] for k in ("write_s", "from_file_s", "cli", "split", "bench",
                                             "bench_960x720")},
               "e57": {k: v for k, v in e57.items() if k != "launches"},
               "parallel": par}
    log(json.dumps({"summary": summary}))
    log(json.dumps({"train": {"diff_raster_ms": diff_ms, **train, "train_cli": train_cli,
                              "card": card}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
