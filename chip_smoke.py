#!/usr/bin/env python3
"""The per-kernel table of the PyTorch/CUDA port (``rtnr_tpu_torch``) on one
NVIDIA GPU: one row per CUDA kernel that a serving or training path launches,
and per standalone entry that stands for a TPU kernel, at the benchmark's
shapes (a 1920x1080 frame padded to 1088x1920, the full-width U-Net
[64,128,256,512] with seeded weights, a 5M-point scene: the steps cell's
size; the walk's 50M-point building keeps ~15M points after culling).

    python3 chip_smoke.py            # from the repository root, one CUDA card

It prints the card's name and power limit (``nvidia-smi``), builds every
library of ``rtnr_tpu_torch/csrc`` with nvcc in parallel (ptxas's registers,
shared memory and spills a kernel), times each row, holds each row's kernel
against its plain twin on the timed inputs, counts its launches, prints one
JSON ``kernels`` line and ends with ``{"ok": true, ...}``.

A row (``ROWS``) is a C entry, or a second form of one (``form``). Its
columns:
- ``ms``: device time of the unit in its ``label``, the median of REPEATS
  timings, each CUDA events around TIMED_CALLS calls after a warm-up
  (through the C entry where the Python wrapper's host work would outlast
  the kernel), or the profiler's device time (the prefilter and the
  BatchNorm, whose calls are host-bound); ``spread``, the timings' range
  over their median;
- ``bound_ms``: the larger of its bytes over 3.35 TB/s and its operations
  over its precision's peak (``rtnr_bench/flops.py``, whose ``unet_calls``
  give the U-Net rows' operations and bytes; the other rows count each
  stream element and each output once, ``STREAM_BYTES``);
- ``plain_ms``: its plain torch twin on the card; ``library_ms``: PyTorch's
  own call for the same work (a yardstick the port never calls; None where
  there is none);
- ``launches``: its launches on each path, counted over one call of each
  entry that a user runs: a frame of each serving mode, a step of each
  train step, the render, pairs and training CLIs in process (the E57 and
  JPEG chain under the pairs CLI), and on two gloo ranks sharing the card
  and on one NCCL rank the multi-rank entries (``sharded_launches``).
  Frames and steps are not timed here: ``rtnr_bench`` measures the
  deployed paths end to end.

Each row's kernel is called through its Python wrapper on the timed
inputs and held against its plain twin at the limits that
``tests/test_torch_cuda.py`` holds it to at edge shapes (``same_bits``,
``within_ulp2``, ``codes_within_one``, ``conv_ok``, ``bn_ok``, defined here
and imported there). The script fails (exit 1) where a kernel is outside
its limit, a C entry returns an error, a CLI does not exit 0, a rank fails,
or a row's launches are not where ``ROWS`` puts them; it exits 2 without
CUDA and 3 without the package beside it. It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from rtnr_bench import flops

WIDTH, HEIGHT = 1920, 1080
HP = 1088  # the frame's rows padded to the U-Net's pyramid
POINTS = 5_000_000
FEATURES = (64, 128, 256, 512)
SEED = 0
REPEATS = 5  # timings of each row; ms is their median
TIMED_CALLS = 10  # calls between the CUDA events of one timing
RANK_POINTS = 200_000  # the scene of the CLIs' and the ranks' launch counts
BLOCKS = 4  # point shards of the band-reference rows: one rank's quarter of the scene

RR, SM90 = "rtnr_tpu_torch/csrc/raster_resolve.cu", "rtnr_tpu_torch/csrc/conv_sm90.cu"
I8, IN = "rtnr_tpu_torch/csrc/conv_i8_sm90.cu", "rtnr_tpu_torch/csrc/conv_in_sm90.cu"
V4 = "raster_pallas4.py:663 _winners_kernel4 + :920 _expand_kernel4"
DIFF = "raster_pallas4.py:872 _compact_kernel + :920 _expand_kernel4 (float_sums)"
K3, K4 = "conv_phase.py:1018 _conv_phase_kernel", "conv_phase.py:1310 _convt_phase_kernel"


class Row(NamedTuple):
    name: str
    source: str  # the CUDA file that defines its entries
    entries: Tuple[str, ...]  # the C entries one timed call reaches
    tpu: str  # the TPU kernel it stands for (rtnr_tpu/ops/...), or none
    label: str  # the unit that ms times
    form: str = ""  # set on a second row of an entry: what this form differs in


ROWS = (
    Row("resolve4", RR, ("rtnr_resolve4",), V4, "a frame's v4 resolve, packed form"),
    Row("resolve4_ref", RR, ("rtnr_resolve4",), V4 + ", as parallel/render.py's accumulate",
        "one rank's quarter of the scene, sums form", "band reference"),
    Row("resolve5", RR, ("rtnr_resolve5",),
        "raster_pallas5.py:516 _winners_kernel5 + raster_pallas4.py:920 _expand_kernel4",
        "a frame's v5 resolve (RTNR_RESOLVE=v5), packed form"),
    Row("resolve_diff", RR, ("rtnr_resolve_diff",), DIFF,
        "a frame of the differentiable forward (the scene step)"),
    Row("resolve_diff_ref", RR, ("rtnr_resolve_diff",), DIFF + ", as parallel/diff.py's",
        "one rank's quarter of the scene", "band reference"),
    Row("winners", RR, ("rtnr_winners",), "raster_pallas4.py:663 _winners_kernel4",
        "K1 alone on a frame's stream"),
    Row("expand", RR, ("rtnr_expand",), "raster_pallas4.py:920 _expand_kernel4",
        "K2 alone on a frame's winner rows, packed form"),
    Row("winners_f32", RR, ("rtnr_winners_f32",), "raster_pallas4.py:872 _compact_kernel",
        "K5 alone on a frame's differentiable stream"),
    Row("winners5", RR, ("rtnr_winners5",), "raster_pallas5.py:516 _winners_kernel5",
        "K6 alone on a frame's pixel-sorted stream"),
    Row("resolve_carriers", RR, ("rtnr_resolve_carriers",),
        "raster_pallas3.py:448, raster_pallas2.py:334, raster_pallas.py:303 (K7-K9)",
        "a frame's carrier stream (RTNR_RESOLVE=v3 or v2)"),
    Row("conv3x3_wgmma", SM90, ("rtnr_conv3x3_wgmma",), K3 + ", bf16",
        "a bf16 frame's 17 convs whose channels are multiples of 64"),
    Row("conv3x3_in", IN, ("rtnr_conv3x3_in",), K3 + ", the input conv",
        "down0/conv0 of a bf16 or dyn frame, bf16 out"),
    Row("conv3x3_in_i8out", IN, ("rtnr_conv3x3_in",), K3 + ", the input conv",
        "down0/conv0 of a static frame", "int8 out"),
    Row("conv3x3_up", SM90, ("rtnr_conv3x3_up_wgmma",), "conv_phase.py:720-780, :1018 up_kernel=",
        "updc2/conv0 and updc3/conv0 with up2 and up3 fused (RTNR_FUSE_UP=1)"),
    Row("conv3x3_static", I8, ("rtnr_conv3x3_static_wgmma",), K3 + ", static int8",
        "a static frame's 17 int8 convs"),
    Row("conv3x3_dyn", I8, ("rtnr_conv3x3_dyn_wgmma",), K3 + ", dyn int8",
        "a dyn frame's 10 int8 convs"),
    Row("convt2x2", SM90, ("rtnr_convt2x2_wgmma",), K4 + ", bf16",
        "a bf16 or dyn frame's 4 ConvTranspose"),
    Row("convt2x2_static", I8, ("rtnr_convt2x2_i8_wgmma",), K4 + ", static int8",
        "a static frame's 4 ConvTranspose"),
    Row("conv3x3_direct", SM90, ("rtnr_conv3x3_wgmma",), "conv_pallas.py:272 _conv_kernel (K10)",
        "one call at updc3/conv0's shape", "K10 through conv_direct.conv3x3_pallas"),
    Row("prefilter", "rtnr_tpu_torch/csrc/prefilter.cu", ("rtnr_prefilter",),
        "none: the jnp depth_prefilter under XLA (prefilter.py)",
        "a frame's prefilter (pad, pyramid, 4 level passes)"),
    Row("bn_train", "rtnr_tpu_torch/csrc/bn_train.cu",
        ("rtnr_bn_blocks", "rtnr_bn_stats", "rtnr_bn_apply", "rtnr_bn_grad_sums",
         "rtnr_bn_grad_x"),
        "none: flax nn.BatchNorm + relu under XLA (models/unet.py:366-374)",
        "forward + backward of a train step's 18 BatchNorm + ReLU layers"),
)
# entries no path of the benchmark's shapes launches: conv.cu serves channel
# counts that are not multiples of 64 (toy nets); the full-width net runs none
NO_PATH = {e: "rtnr_tpu_torch/csrc/conv.cu" for e in (
    "rtnr_conv3x3", "rtnr_convt2x2", "rtnr_dyn_scales", "rtnr_maxpool2", "rtnr_head1x1")}
# rows that stand for a TPU kernel but run on no path: each lives inside a tile resolve
# (K1, K2, K5, K6) or is JAX's conv_impl="pallas" path (K10)
STANDALONE = {"winners", "expand", "winners_f32", "winners5", "conv3x3_direct"}

# bytes a call moves: each stream element read once (pixel id, depth bits and
# 4 B packed or 12 B f32 colour), each output written once (packed rgb + depth
# 8 B, or sums, count and depth 20 B a pixel; a winner row 24 B), and the band
# reference read at the pixels with points. Keys: n stream elements, n_in of
# them in the frame, hw pixels, winners (pixels with points), carriers
# (elements of the carrier stream), ref_in and ref_px (the block's in-frame
# elements and pixels with points)
STREAM_BYTES = {
    "resolve4": lambda s: 12.0 * s["n_in"] + 8.0 * s["hw"],
    "resolve5": lambda s: 12.0 * s["n_in"] + 8.0 * s["hw"],
    "resolve_diff": lambda s: 20.0 * s["n_in"] + 20.0 * s["hw"],
    "resolve4_ref": lambda s: 12.0 * s["ref_in"] + 4.0 * s["ref_px"] + 20.0 * s["hw"],
    "resolve_diff_ref": lambda s: 20.0 * s["ref_in"] + 4.0 * s["ref_px"] + 20.0 * s["hw"],
    "winners": lambda s: 12.0 * s["n"] + 24.0 * s["winners"],
    "winners5": lambda s: 12.0 * s["n"] + 24.0 * s["winners"],
    "winners_f32": lambda s: 20.0 * s["n"] + 24.0 * s["winners"],
    "expand": lambda s: 24.0 * s["winners"] + 8.0 * s["hw"],
    "resolve_carriers": lambda s: 12.0 * s["carriers"] + 20.0 * s["hw"],
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- the limits a kernel is held to against its plain twin ----
# tests/test_torch_cuda.py holds the kernels to these same limits at edge shapes

def same_bits(got, want) -> bool:
    """Two sequences of tensors alike in number and shape and equal bit for
    bit, f32 by its bits."""
    import torch

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    got, want = list(got), list(want)
    return len(got) == len(want) and all(
        a.shape == b.shape and torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


def ulp2(t) -> float:
    """2 bf16 ulp of the tensor's magnitude."""
    import numpy as np

    return 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 6)


def within_ulp2(got, want) -> bool:
    return bool(float((got.float() - want.float()).abs().max()) <= ulp2(want))


def codes_within_one(got, want) -> bool:
    """int8 codes at most one apart, on at most 0.1% of the elements."""
    d = (got.int() - want.int()).abs()
    return int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


def winners_ok(got, want) -> bool:
    """(winner rows, total) of a winners kernel: the same total and rows."""
    import torch

    k = int(want[1][0])
    return int(got[1][0]) == k and torch.equal(got[0][:, :k], want[0][:, :k])


def conv_ok(xs, w, pool: bool = False, head=None, up=None) -> bool:
    """One ``conv3x3_prepared`` call against ``conv3x3_prepared_plain`` on
    the same prepared weights: int8 codes bit for bit (the fused pool too),
    the int8-out input conv within ``codes_within_one``, bf16 within 2 bf16
    ulp of the twin (the fused pool exactly the max of the conv); with
    ``head``, the head within 2 bf16 ulp of the head of the kernel's own
    conv output."""
    import torch
    from rtnr_tpu_torch.ops import conv as cv

    got = cv.conv3x3_prepared(xs, w, relu=True, pool=pool, up=up)
    want = cv.conv3x3_prepared_plain(xs, w, relu=True, pool=pool, up=up)
    if w.quant:
        ok = same_bits(got, want)
    elif w.out_i8:
        ok = codes_within_one(got[0], want[0])
    else:
        ok = within_ulp2(got[0], want[0]) and (not pool or torch.equal(got[1], cv._pool2(got[0])))
    if head is not None:
        (hout,) = cv.conv3x3_prepared(xs, w, relu=True, head=head)
        ok = ok and within_ulp2(hout, torch.matmul(got[0].float(), head.hk.float()) + head.hb)
    return ok


def convt_ok(x, w) -> bool:
    """One ``convt2x2_prepared`` call against its twin: int8 bit for bit,
    bf16 within 2 bf16 ulp."""
    from rtnr_tpu_torch.ops import conv as cv

    got, want = cv.convt2x2_prepared(x, w), cv.convt2x2_prepared_plain(x, w)
    return same_bits((got,), (want,)) if w.quant else within_ulp2(got, want)


def bn_ok(x, dy, scale, bias, mean, var) -> bool:
    """One forward and backward of ``bn_relu_train`` against its twins,
    given the kernels' own sums (kept by a ``reduce``): the output, the
    running statistics, dscale, dbias and dx bit for bit; the sums
    themselves, f32 in the kernels' order, within 2e-5 of the f64 sums of
    magnitudes (a term passes through at most ~135 f32 additions)."""
    import torch
    from rtnr_tpu_torch.ops import bn_train as bt

    seen = []

    def keep(v):
        seen.append(v.clone())
        return v

    xr = x.detach().requires_grad_(True)
    s, b = scale.detach().clone().requires_grad_(True), bias.detach().clone().requires_grad_(True)
    m, v = mean.clone(), var.clone()
    y = bt.bn_relu_train(xr, s, b, m, v, keep)
    y.backward(dy)
    y = y.detach()
    tot, sums = seen
    c, xd = x.shape[1], x.double()
    ref = bt.batch_sums_plain(xd)
    absx = torch.cat([xd.abs().sum(dim=(0, 2, 3)), ref[c:2 * c]])
    m_t, v_t = mean.clone(), var.clone()
    y_t = bt.bn_relu_apply_plain(x, tot, scale, bias, m_t, v_t)
    mean_k, _, rstd, _ = bt.channel_terms(tot, scale)
    gd = torch.where(y > 0, dy, 0).double()
    gx = gd * (xd - mean_k.double()[:, None, None])
    want = torch.cat([gd.sum(dim=(0, 2, 3)), gx.sum(dim=(0, 2, 3))])
    mag = torch.cat([gd.abs().sum(dim=(0, 2, 3)), gx.abs().sum(dim=(0, 2, 3))])
    return (float(tot[-1]) == x.numel() // c
            and bool(((tot[:2 * c].double() - ref[:2 * c]).abs() <= 2e-5 * absx).all())
            and torch.equal(y, y_t) and torch.equal(m, m_t) and torch.equal(v, v_t)
            and bool(((sums.double() - want).abs() <= 2e-5 * mag).all())
            and torch.equal(s.grad, sums[c:] * rstd) and torch.equal(b.grad, sums[:c])
            and torch.equal(xr.grad, bt.bn_relu_grad_x_plain(dy, x, tot, scale, bias, sums)))


def hold(what: str, ok: bool) -> None:
    if not ok:
        fail(f"{what}: the kernel's output is outside its limit against its plain twin")


def bound_ms(nbytes: float, ops: Optional[Dict[str, float]] = None) -> Tuple[float, str]:
    """The least time (ms) at the published peaks, ``flops.least_s`` of the
    work, and which of bytes or operations sets it."""
    work = {"ops": dict(ops or {}), "bytes": float(nbytes)}
    by = "operations" if flops.math_s([work]) > nbytes / flops.HBM_BYTES_PER_S else "bytes"
    return flops.least_s(work) * 1e3, by


def bn_layers(h: int = HP, w: int = WIDTH, features=FEATURES):
    """(H, W, C, layers) of UNetTrain's BatchNorm layers at (h, w): four at
    each encoder / decoder level, two in the bottleneck."""
    n = len(features)
    return tuple((h >> i, w >> i, f, 4) for i, f in enumerate(features)) + (
        (h >> n, w >> n, 2 * features[-1], 2),)


def unet_work(unet, h: int = HP, w: int = WIDTH) -> Dict[str, Dict]:
    """The U-Net rows' work at the padded (h, w), from ``flops.unet_calls``:
    row -> {"ops": {precision: ops}, "bytes", "calls"}. The dyn row is the
    bf16 calls that ``unet``'s dyn plan quantises, their operations at the
    int8 rate (its bytes count the int8 weights at 2 B: an upper count);
    the fused-ConvTranspose row is the pairs it fuses (its bytes count the
    up values it keeps on chip: an upper count); K10 is updc{n-1}/conv0."""
    features = tuple(unet.features)
    bf16 = {c["name"]: c for c in flops.unet_calls(features, h, w, "bf16")}
    static = {c["name"]: c for c in flops.unet_calls(features, h, w, "static")}
    convs = [k for k in bf16 if "/" in k and k != "down0/conv0"]
    ups = [k for k in bf16 if "/" not in k]
    dyn = [k for k, v in unet.int8_plan(None).items() if v.get("quant") == "dyn"]
    groups = {
        "conv3x3_wgmma": [bf16[k] for k in convs],
        "conv3x3_in": [bf16["down0/conv0"]],
        "convt2x2": [bf16[k] for k in ups],
        "conv3x3_in_i8out": [static["down0/conv0"]],
        "conv3x3_static": [static[k] for k in convs],
        "convt2x2_static": [static[k] for k in ups],
        "conv3x3_dyn": [dict(bf16[k], ops={"int8": bf16[k]["ops"]["bf16"]}) for k in dyn],
        "conv3x3_up": [bf16[k] for i in sorted(unet.fuse_levels(h))
                       for k in (f"up{i}", f"updc{i}/conv0")],
        "conv3x3_direct": [bf16[f"updc{len(features) - 1}/conv0"]],
    }
    out = {}
    for row, calls in groups.items():
        ops: Dict[str, float] = {}
        for c in calls:
            for p, v in c["ops"].items():
                ops[p] = ops.get(p, 0.0) + v
        out[row] = {"ops": ops, "bytes": sum(c["bytes"] for c in calls), "calls": len(calls)}
    out["conv3x3_up"]["calls"] //= 2  # one kernel call a fused pair
    return out


def row_work(unet, stats: Dict[str, float]) -> Dict[str, Tuple[float, Dict[str, float]]]:
    """Every row's (bytes, operations by precision): the U-Net rows from
    ``unet_work``, the stream rows from ``STREAM_BYTES`` over the streams'
    sizes ``stats``, the prefilter (the 1080p frame read once, the padded
    outputs written once, the pyramid written and read once) and the
    BatchNorm (6 B an element forward, 10 backward, bf16)."""
    from rtnr_tpu_torch.ops.prefilter import pyramid_pad_shape

    out = {k: (v["bytes"], v["ops"]) for k, v in unet_work(unet).items()}
    out.update({k: (f(stats), {}) for k, f in STREAM_BYTES.items()})
    hp, wp = pyramid_pad_shape(HEIGHT, WIDTH, 4)
    pyramid = sum((hp >> k) * (wp >> k) for k in range(1, 5))
    out["prefilter"] = (7.0 * HEIGHT * WIDTH + 28.0 * hp * wp + 8.0 * pyramid, {})
    out["bn_train"] = (sum(16.0 * h * w * c * k for h, w, c, k in bn_layers()), {})
    return out


def launch_counts() -> Dict[str, int]:
    """Each row's launch counter now (the wrappers' ``.launches``): the
    band-reference forms apart from their entries' other calls, the input
    conv's two output forms apart."""
    from rtnr_tpu_torch.ops import bn_train, conv_direct, prefilter
    from rtnr_tpu_torch.ops import conv as cv
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops import raster_resolve5 as r5
    from rtnr_tpu_torch.ops import raster_resolve_carriers as rc

    v4, diff = rr.raster_images_v4, rr.raster_images_diff
    return {
        "resolve4": v4.launches - v4.band_ref_launches, "resolve4_ref": v4.band_ref_launches,
        "resolve5": r5.raster_images_v5.launches,
        "resolve_diff": diff.launches - diff.band_ref_launches,
        "resolve_diff_ref": diff.band_ref_launches,
        "winners": rr.winners.launches, "expand": rr.expand_winners.launches,
        "winners_f32": rr.winners_f32.launches, "winners5": r5.winners5.launches,
        "resolve_carriers": rc.resolve_carriers.launches,
        "conv3x3_wgmma": cv.conv3x3_wgmma.launches,
        "conv3x3_in": cv.conv3x3_in.launches - cv.conv3x3_i8out.launches,
        "conv3x3_in_i8out": cv.conv3x3_i8out.launches,
        "conv3x3_up": cv.conv3x3_up.launches,
        "conv3x3_static": cv.conv3x3_static_wgmma.launches,
        "conv3x3_dyn": cv.conv3x3_dyn_wgmma.launches,
        "convt2x2": cv.convt2x2_wgmma.launches,
        "convt2x2_static": cv.convt2x2_static_wgmma.launches,
        "conv3x3_direct": conv_direct.conv3x3_pallas.launches,
        "prefilter": prefilter.filter_frame.launches,
        "bn_train": bn_train.bn_relu_train.launches,
    }


def counted(fn) -> Dict[str, int]:
    """The launches of one call of ``fn``, after one uncounted call (first
    calls load kernels and calibrate)."""
    import torch

    fn()
    torch.cuda.synchronize()
    before = launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launch_counts().items()}


# ---- timing ----

def time_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Mean ms of one call: CUDA events around ``calls`` calls after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int = 5) -> float:
    """Mean device time of one call: its kernels, copies and sets summed
    from a ``torch.profiler`` trace of ``calls`` calls, so a call whose host
    side outlasts its device work is timed by the device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("the profiler saw no device time")
    return us / 1e3 / calls


def repeats(fn, device: bool = False) -> List[float]:
    """REPEATS timings of one call of ``fn`` (``device_ms`` or ``time_ms``)."""
    return [(device_ms if device else time_ms)(fn) for _ in range(REPEATS)]


def plain_ms(fn) -> float:
    return time_ms(fn, calls=2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def c_entry(fn, args, name: str, keep=()):
    """A call of the C entry ``fn`` on ``args`` (bound once), checked once;
    ``keep``: tensors whose pointers ``args`` holds, alive as long as the call."""
    from rtnr_tpu_torch import _build

    _build.check(fn(*args), name)

    def call():
        return fn(*args)

    call.keep = keep
    return call


def segment_library(pix, zf, lanes, depth, hw: int, band: float, keep=None):
    """The library yardstick of a resolve: ``torch.segment_reduce`` summing
    the f32 ``lanes`` of the in-band elements (against the head-depth image
    ``depth``; ``keep`` narrows them further) over each pixel's run, then
    ``index_copy_`` of the per-pixel rows into a dense image. The band test
    is made once, outside the call."""
    import torch

    inb = (pix < hw) & ~(zf > depth[pix.clamp(max=hw - 1).long()] + band)
    if keep is not None:
        inb &= keep
    data = lanes[inb].contiguous()
    pixels, lengths = torch.unique_consecutive(pix[inb], return_counts=True)
    dense = torch.zeros((hw, data.shape[1]), dtype=torch.float32, device=pix.device)
    return lambda: dense.index_copy_(0, pixels.long(), torch.segment_reduce(
        data, "sum", lengths=lengths, axis=0))


def packed_lanes(packed):
    import torch

    return torch.stack([packed & 255, (packed >> 8) & 255, (packed >> 16) & 255,
                        torch.ones_like(packed)], 1).float()


def time_resolves(renderer, M, band: float, out: Dict) -> Dict[str, float]:
    """The v4, v5 and differentiable resolves, K1, K2, K5, K6 alone and the
    carrier kernel on the frame's streams, each then held bit for bit
    against its twin (both forms where it has two); returns the streams'
    sizes (``STREAM_BYTES``' keys but the band reference's)."""
    import torch
    from rtnr_tpu_torch.ops import raster as tr
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops import raster_resolve5 as r5
    from rtnr_tpu_torch.ops import raster_resolve_carriers as rc

    hw = WIDTH * HEIGHT
    args = (renderer.points, renderer.colors, M)
    kw = dict(width=WIDTH, height=HEIGHT, valid=renderer.valid)
    sp = tr.project_and_sort(*args, **kw)
    sp5 = tr.project_and_sort(*args, depth_key=False, **kw)
    spc = tr.project_and_sort(*args, carriers=True, **kw)
    sd, _ = tr.project_and_sort_diff(*args, **kw)
    if any(t.data_ptr() % 16 for s in (sp, sp5) for t in s) or sd.pix.data_ptr() % 16:
        fail("a frame stream is not 16-byte aligned")
    wimg, total = rr.winners(sp, hw, band)
    depth = rr.raster_images_v4(sp, hw, band)[2]
    n, t = sp.pix.numel(), int(total[0])
    stats = {"n": n, "n_in": int((sp.pix < hw).sum()), "hw": hw, "winners": t,
             "carriers": spc.pix.numel()}

    lib = rr._lib()
    stream = torch.cuda.current_stream().cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=M.device)  # noqa: E731
    packed, sums, count, dout = i32(hw), i32(hw, 3), i32(hw), i32(hw)
    scratch, rows, rtotal = i32(2 * max(-(-n // 1024), 1)), i32(6, max(min(n, hw), 1)), i32(1)
    winner_out = (scratch.data_ptr(), rows.data_ptr(), rows.shape[1], rtotal.data_ptr(), stream)

    def stream_args(s, colours):
        return (s.pix.data_ptr(), s.zbits.data_ptr(), colours.data_ptr(), s.pix.numel(), hw, band)

    calls = {
        "resolve4": (lib.rtnr_resolve4, stream_args(sp, sp.packed)
                     + (1, 1, packed.data_ptr(), None, dout.data_ptr(), None, stream)),
        "resolve5": (lib.rtnr_resolve5, stream_args(sp5, sp5.packed)
                     + (1, 1, packed.data_ptr(), None, dout.data_ptr(), stream)),
        "resolve_diff": (lib.rtnr_resolve_diff, stream_args(sd, sd.rgb)
                         + (1, sums.data_ptr(), count.data_ptr(), dout.data_ptr(), None, stream)),
        "winners": (lib.rtnr_winners, stream_args(sp, sp.packed) + winner_out),
        "winners_f32": (lib.rtnr_winners_f32, stream_args(sd, sd.rgb) + winner_out),
        "expand": (lib.rtnr_expand, (wimg.data_ptr(), wimg.shape[1], total.data_ptr(), hw, 1,
                                     packed.data_ptr(), None, dout.data_ptr(), stream)),
    }
    timed = {k: c_entry(fn, a, k) for k, (fn, a) in calls.items()}
    # the wrappers of K6 and the carrier kernel (their host work is small against them)
    timed["winners5"] = lambda: r5.winners5(sp5, hw, band)
    timed["resolve_carriers"] = lambda: rc.resolve_carriers(spc, hw, band)
    plain = {
        "resolve4": lambda: rr.raster_images_v4_plain(sp, hw, band, True),
        "resolve5": lambda: r5.raster_images_v5_plain(sp5, hw, band, True),
        "resolve_diff": lambda: rr.raster_images_diff_plain(sd, hw, band),
        "winners": lambda: rr.winners_plain(sp, hw, band),
        "winners_f32": lambda: rr.winners_f32_plain(sd, hw, band),
        "expand": lambda: rr.expand_plain(wimg, total, hw, True),
        "winners5": lambda: r5.winners5_plain(sp5, hw, band),
        "resolve_carriers": lambda: rc.resolve_carriers_plain(spc, hw, band),
    }
    zf = lambda s: s.zbits.view(torch.float32)  # noqa: E731
    diff_lanes = torch.cat([sd.rgb, torch.ones_like(sd.rgb[:, :1])], 1)
    segments = segment_library(sp.pix, zf(sp), packed_lanes(sp.packed), depth, hw, band)
    segments5 = segment_library(sp5.pix, zf(sp5), packed_lanes(sp5.packed), depth, hw, band)
    segments_diff = segment_library(sd.pix, zf(sd), diff_lanes, depth, hw, band)
    win_rows = wimg[:, :t].t().contiguous()
    dense = torch.zeros((hw, 6), dtype=torch.int32, device=M.device)
    library = {
        "resolve4": segments,
        "winners": segments,
        "resolve5": segments5,
        "winners5": segments5,
        "resolve_diff": segments_diff,
        "winners_f32": segments_diff,
        "resolve_carriers": segment_library(spc.pix, zf(spc), packed_lanes(spc.packed), depth,
                                            hw, band, keep=(spc.packed & tr.REAL_BIT) != 0),
        "expand": lambda: dense.index_copy_(0, wimg[5, :t].long(), win_rows),
    }
    for k in timed:
        out[k] = {"ms": repeats(timed[k]), "plain_ms": plain_ms(plain[k]),
                  "library_ms": time_ms(library[k])}
    forms = (False, True)  # sums, packed
    held = {
        "resolve4": lambda: all(same_bits(rr.raster_images_v4(sp, hw, band, packed_out=f),
                                          rr.raster_images_v4_plain(sp, hw, band, f))
                                for f in forms),
        "resolve5": lambda: all(same_bits(r5.raster_images_v5(sp5, hw, band, packed_out=f),
                                          r5.raster_images_v5_plain(sp5, hw, band, f))
                                for f in forms),
        # integer colours: the card twin's f64 atomics add them exactly
        "resolve_diff": lambda: same_bits(rr.raster_images_diff(sd, hw, band),
                                          rr.raster_images_diff_plain(sd, hw, band)),
        "winners": lambda: winners_ok(rr.winners(sp, hw, band), rr.winners_plain(sp, hw, band)),
        "winners_f32": lambda: winners_ok(rr.winners_f32(sd, hw, band),
                                          rr.winners_f32_plain(sd, hw, band)),
        "winners5": lambda: winners_ok(r5.winners5(sp5, hw, band),
                                       r5.winners5_plain(sp5, hw, band)),
        "expand": lambda: all(same_bits(rr.expand_winners(wimg, total, hw, packed_out=f),
                                        rr.expand_plain(wimg, total, hw, f)) for f in forms),
        "resolve_carriers": lambda: same_bits(rc.resolve_carriers(spc, hw, band),
                                              rc.resolve_carriers_plain(spc, hw, band)),
    }
    for k, ok in held.items():
        hold(f"{k} on the frame's stream", ok())
    return stats


def time_band_ref(renderer, M, band: float, out: Dict, stats: Dict) -> None:
    """The band-reference forms on one of BLOCKS contiguous point shards,
    against the shards' merged z-buffer (what the point-sharded paths pass),
    through their C entries, each then held bit for bit against its twin;
    adds the block's sizes to ``stats``."""
    import torch
    from rtnr_tpu_torch.ops import raster_resolve4 as rr
    from rtnr_tpu_torch.ops.raster import project_and_sort, project_and_sort_diff

    hw = WIDTH * HEIGHT
    pts, cols, valid = renderer.points, renderer.colors, renderer.valid
    b = pts.shape[0] // BLOCKS
    blocks = [slice(i * b, (i + 1) * b) for i in range(BLOCKS)]
    kw = dict(width=WIDTH, height=HEIGHT)
    sps = [project_and_sort(pts[s], cols[s], M, valid=valid[s], **kw) for s in blocks]
    sds = [project_and_sort_diff(pts[s], cols[s].float(), M, valid=valid[s], **kw)[0]
           for s in blocks]
    local = rr.raster_images_v4(sps[0], hw, band)[2]
    ref = torch.stack([local] + [rr.raster_images_v4(s, hw, band)[2] for s in sps[1:]]).amin(0)
    dref = torch.stack([rr.raster_images_diff(s, hw, band)[2] for s in sds]).amin(0)
    sp, sd = sps[0], sds[0]
    stats.update(ref_in=int((sp.pix < hw).sum()), ref_px=int((local < 3e38).sum()))

    lib = rr._lib()
    stream = torch.cuda.current_stream().cuda_stream
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=M.device)  # noqa: E731
    bufs = (i32(hw, 3), i32(hw), i32(hw))
    outs = tuple(t.data_ptr() for t in bufs)
    timed = {
        "resolve4_ref": c_entry(lib.rtnr_resolve4, (
            sp.pix.data_ptr(), sp.zbits.data_ptr(), sp.packed.data_ptr(), sp.pix.numel(), hw,
            band, 1, 0) + outs + (ref.data_ptr(), stream), "resolve4_ref"),
        "resolve_diff_ref": c_entry(lib.rtnr_resolve_diff, (
            sd.pix.data_ptr(), sd.zbits.data_ptr(), sd.rgb.data_ptr(), sd.pix.numel(), hw,
            band, 1) + outs + (dref.data_ptr(), stream), "resolve_diff_ref"),
    }
    plain = {"resolve4_ref": lambda: rr.raster_images_v4_plain(sp, hw, band, band_ref=ref),
             "resolve_diff_ref": lambda: rr.raster_images_diff_plain(sd, hw, band,
                                                                     band_ref=dref)}
    zf = sp.zbits.view(torch.float32)
    library = {"resolve4_ref": segment_library(sp.pix, zf, packed_lanes(sp.packed), ref, hw,
                                               band),
               "resolve_diff_ref": segment_library(
                   sd.pix, sd.zbits.view(torch.float32),
                   torch.cat([sd.rgb, torch.ones_like(sd.rgb[:, :1])], 1), dref, hw, band)}
    for k in timed:
        out[k] = {"ms": repeats(timed[k]), "plain_ms": plain_ms(plain[k]),
                  "library_ms": time_ms(library[k])}
    hold("resolve4_ref on a block", same_bits(rr.raster_images_v4(sp, hw, band, band_ref=ref),
                                              plain["resolve4_ref"]()))
    hold("resolve_diff_ref on a block", same_bits(
        rr.raster_images_diff(sd, hw, band, band_ref=dref), plain["resolve_diff_ref"]()))


def record_unet_calls(unet, x, p):
    """Run the net once on prepared weights ``p``, recording every conv3x3 /
    convt2x2 call: (kind, name, inputs, pool, head)."""
    import torch
    from rtnr_tpu_torch.ops.conv import conv3x3_prepared, convt2x2_prepared

    calls = []

    def conv(xs, name, pool=False, head=False):
        calls.append(("conv3x3", name, list(xs), pool, head))
        return conv3x3_prepared(xs, p[name], relu=True, pool=pool,
                                head=p["final_conv"] if head else None)

    def convt(h, name):
        calls.append(("convt2x2", name, h, False, False))
        return convt2x2_prepared(h, p[name])

    with torch.no_grad():
        unet._run(x.to(torch.bfloat16).contiguous(), conv, convt)
    return calls


def in_conv_entry(x, w):
    """One launch of ``conv_in_sm90.cu``'s entry on ``x`` and the prepared
    weights ``w`` (ReLU), its arguments bound once."""
    import torch
    from rtnr_tpu_torch import _build
    from rtnr_tpu_torch.ops import conv as cv

    lib = _build.load("conv_in_sm90", cv._bind_in)
    _, h, wd, c = x.shape
    y = torch.empty((1, h, wd, int(w.wmat.shape[1])),
                    dtype=torch.int8 if w.out_i8 else torch.bfloat16, device=x.device)
    return c_entry(lib.rtnr_conv3x3_in, (
        x.data_ptr(), int(c), int(h), int(wd), w.wmat.data_ptr(), int(w.wmat.shape[0]),
        w.bias.data_ptr(), y.data_ptr(), int(w.out_i8), 1,
        torch.cuda.current_stream(x.device).cuda_stream), "rtnr_conv3x3_in", keep=(y,))


def int_mm(a, b):
    """``torch._int_mm(a, b)`` (the int8 GEMM yardstick), or None where it
    refuses the operands in either layout of ``b``."""
    import torch

    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, bb)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return lambda bb=bb: torch._int_mm(a, bb)
    return None


def im2col_i8(xs):
    """(H*W, 9*C) int8 im2col of (1, H, W, C) inputs, tap-major like the
    kernels' K (only the GEMM's time is wanted)."""
    import torch

    x = torch.cat([t.to(torch.int8) for t in xs], dim=-1)[0]
    h, w, c = x.shape
    xp = torch.zeros((h + 2, w + 2, c), dtype=torch.int8, device=x.device)
    xp[1:-1, 1:-1] = x
    return torch.stack([xp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                       dim=2).reshape(h * w, 9 * c)


def conv_library(xs, w):
    """F.conv2d (bf16, channels-last) on the call's concatenated inputs, or
    for int8 weights ``torch._int_mm`` over an explicit im2col."""
    import torch
    import torch.nn.functional as Fn

    ct, f = w.cin, int(w.wmat.shape[1])
    if w.wmat.dtype == torch.int8 and w.quant:
        return int_mm(im2col_i8(xs), w.wmat[:9 * ct])
    x = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
    wl = w.wmat[:9 * ct].to(torch.bfloat16).reshape(3, 3, ct, f).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b = w.bias.to(torch.bfloat16)
    return lambda: Fn.conv2d(x, wl, b, padding=1)


def convt_library(x, w):
    """F.conv_transpose2d (bf16) of the call, or ``torch._int_mm`` for int8
    weights."""
    import torch
    import torch.nn.functional as Fn

    _, h, wd, c = x.shape
    if w.quant:
        return int_mm(x[0].reshape(h * wd, c), w.wmat[:c])
    wt = w.wmat[:c].reshape(c, 2, 2, w.f).permute(0, 3, 1, 2).contiguous()
    xl, b = x.permute(0, 3, 1, 2), w.bias.to(torch.bfloat16)
    return lambda: Fn.conv_transpose2d(xl, wt, b, stride=2)


def time_convs(bf16_net, static_net, scales, dyn_net, x, out: Dict, work: Dict) -> None:
    """Every conv call of the bf16, static and dyn nets at the frame's
    shapes, summed into its row (``unet_work``'s calls); the
    fused-ConvTranspose mode at the fused levels; K10 at updc3/conv0's
    shape. Each call is held against its twin (``conv_ok``, ``convt_ok``;
    K10 within 2 bf16 ulp of the f32 twin)."""
    import torch
    from rtnr_tpu_torch.ops import conv as cv
    from rtnr_tpu_torch.ops.conv_direct import conv3x3_pallas

    acc: Dict[str, Dict] = {}

    def add(row, what, fn, plain, library, ok):
        a = acc.setdefault(row, {"ms": [0.0] * REPEATS, "plain_ms": 0.0, "library_ms": 0.0,
                                 "calls": 0})
        a["ms"] = [s + v for s, v in zip(a["ms"], repeats(fn))]
        hold(f"{row} {what}", ok())
        a["plain_ms"] += plain_ms(plain)
        a["library_ms"] = (None if library is None or a["library_ms"] is None
                           else a["library_ms"] + time_ms(library))
        a["calls"] += 1

    first = "down0/conv0"
    nets = (("bf16", bf16_net, bf16_net.prepare()),
            ("static", static_net, static_net.prepare_int8(scales)),
            ("dyn", dyn_net, dyn_net.prepare_int8(None)))
    for mode, net, p in nets:
        hd = p["final_conv"]
        calls = record_unet_calls(net, x, p)
        for kind, name, xin, pool, head in calls:
            w = p[name]
            if kind == "convt2x2":
                row = {"bf16": "convt2x2", "static": "convt2x2_static"}.get(mode)
                if row:
                    add(row, name, lambda: cv.convt2x2_prepared(xin, w),
                        lambda: cv.convt2x2_prepared_plain(xin, w), convt_library(xin, w),
                        lambda: convt_ok(xin, w))
                continue
            if name == first:
                row = {"bf16": "conv3x3_in", "static": "conv3x3_in_i8out"}.get(mode)
                fn = in_conv_entry(xin[0], w) if row else None
            else:
                row = {"bf16": "conv3x3_wgmma", "static": "conv3x3_static",
                       "dyn": "conv3x3_dyn" if w.quant == "dyn" else None}[mode]
                fn = lambda: cv.conv3x3_prepared(xin, w, relu=True, pool=pool,  # noqa: E731
                                                 head=hd if head else None)
            if row:
                add(row, name, fn, lambda: cv.conv3x3_prepared_plain(
                    xin, w, relu=True, pool=pool, head=hd if head else None),
                    conv_library(xin, w), lambda: conv_ok(xin, w, pool, hd if head else None))
        if mode == "bf16":
            p_bf16, deeps = p, {n: xin for k, n, xin, _, _ in calls if k == "convt2x2"}
            skips = {n: xin[0] for k, n, xin, _, _ in calls if k == "conv3x3"}
        torch.cuda.empty_cache()

    for i in sorted(bf16_net.fuse_levels(HP)):
        deep, skip = deeps[f"up{i}"], skips[f"updc{i}/conv0"]
        w, up = p_bf16[f"updc{i}/conv0"], p_bf16[f"up{i}"]
        if not cv.takes_up(int(skip.shape[3]), int(deep.shape[3]), up.f, int(w.wmat.shape[1])):
            fail(f"updc{i}: the fused-ConvTranspose kernel does not take its shape")
        convt = convt_library(deep, up)
        # the concat of skip and up has skip's shape twice: C_up == F == skip's channels
        conv = conv_library([skip, skip], w)
        add("conv3x3_up", f"updc{i}/conv0",
            lambda: cv.conv3x3_prepared([skip, deep], w, relu=True, up=up),
            lambda: cv.conv3x3_prepared_plain([skip, deep], w, relu=True, up=up),
            lambda: (convt(), conv()), lambda: conv_ok([skip, deep], w, up=up))

    g = torch.Generator(device="cuda").manual_seed(SEED)
    f = FEATURES[0]
    xs = [torch.randn((1, HP, WIDTH, f), generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    k = 0.05 * torch.randn((3, 3, 2 * f, f), generator=g, device="cuda")
    b = torch.randn((f,), generator=g, device="cuda")
    wk = cv.prepare_conv3x3(k, b, xs[0].device)
    kb, bb = cv._bf16_values(k), cv._bf16_values(b)
    add("conv3x3_direct", "at updc3/conv0's shape", lambda: conv3x3_pallas(xs, k, b, relu=True),
        lambda: cv.conv3x3_plain(xs, kb, bb, relu=True), conv_library(xs, wk),
        lambda: within_ulp2(conv3x3_pallas(xs, k, b, relu=True),
                            cv.conv3x3_plain(xs, kb, bb, relu=True, dtype=torch.float32)[0]))
    for row, a in acc.items():
        if a["calls"] != work[row]["calls"]:
            fail(f"{row}: {a['calls']} calls timed, not {work[row]['calls']}")
        out[row] = {key: v for key, v in a.items() if key != "calls"}


def time_prefilter(raw_depth, raw_rgb, out: Dict) -> None:
    """``filter_frame`` on the frame by its device time, beside the plain
    path (``pad_to_pyramid`` + ``depth_prefilter``, ~390 small ops; no
    PyTorch call does the prefilter), then held bit for bit against it."""
    from rtnr_tpu_torch.ops import prefilter as tp

    def plain():
        return tp.depth_prefilter(*tp.pad_to_pyramid(raw_depth, raw_rgb, 4), levels=4)

    out["prefilter"] = {
        "ms": repeats(lambda: tp.filter_frame(raw_depth, raw_rgb), device=True),
        "plain_ms": device_ms(plain), "library_ms": None}
    got, want = tp.filter_frame(raw_depth, raw_rgb), plain()
    hold("prefilter on the frame", set(got) == set(want) and same_bits(
        [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]))


def time_bn_train(out: Dict) -> None:
    """UNetTrain's BatchNorm + ReLU (``ops.bn_train.bn_relu_train``), bf16,
    forward and backward at each layer shape of a step by device time
    (at the deep levels a call's host side outlasts its kernels), summed
    over the step's 18 layers, beside the plain layer and ``F.batch_norm`` +
    ``relu``; each layer shape held against the twins (``bn_ok``)."""
    import torch
    import torch.nn.functional as Fn
    from rtnr_tpu_torch.ops import bn_train as bt

    def library(x, scale, bias, m, v):
        return torch.relu(Fn.batch_norm(x, m, v, scale, bias, training=True, momentum=0.1,
                                        eps=bt.EPS))

    tot = {"ms": [0.0] * REPEATS, "plain_ms": 0.0, "library_ms": 0.0}
    for h, w, c, layers in bn_layers():
        g = torch.Generator(device="cuda").manual_seed(SEED + c)
        off = torch.randn(c, generator=g, device="cuda") * 0.5
        x = (torch.randn((1, h, w, c), generator=g, device="cuda") * (1 + off.abs()) + off) \
            .to(torch.bfloat16).permute(0, 3, 1, 2).requires_grad_(True)
        dy = torch.randn((1, h, w, c), generator=g, device="cuda").to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        scale = (torch.rand(c, generator=g, device="cuda") + 0.5).requires_grad_(True)
        bias = (torch.randn(c, generator=g, device="cuda") * 0.3).requires_grad_(True)
        m, v = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")

        def run(layer):
            y = layer(x, scale, bias, m, v)
            return torch.autograd.grad(y, (x, scale, bias), dy)

        ms = repeats(lambda: run(bt.bn_relu_train), device=True)
        tot["ms"] = [s + layers * t for s, t in zip(tot["ms"], ms)]
        tot["plain_ms"] += layers * device_ms(lambda: run(bt.bn_relu_train_plain))
        tot["library_ms"] += layers * device_ms(lambda: run(library))
        hold(f"bn_train at {(h, w, c)}", bn_ok(x.detach(), dy, scale, bias, m, v))
        del x, dy
        torch.cuda.empty_cache()
    out["bn_train"] = tot


# ---- launches on the paths ----

@contextlib.contextmanager
def environ(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def path_launches(renderer, static_r, dyn_r, cam, E, variables) -> Dict[str, Dict[str, int]]:
    """Every row's launches over one frame of each serving mode (bf16,
    static and dyn int8; RTNR_RESOLVE=v5, v3, v2; RTNR_FUSE_UP=1 in bf16 and
    dyn) and one step of each train step at the frame's shape."""
    import torch
    from rtnr_tpu_torch.pipeline import render_rgbd
    from rtnr_tpu_torch.train import trainer as tt

    frame = lambda r: lambda: r.compute_full(cam, E)  # noqa: E731
    paths = {"serve_bf16": counted(frame(renderer)), "serve_static": counted(frame(static_r)),
             "serve_dyn": counted(frame(dyn_r))}
    for mode in ("v5", "v3", "v2"):
        with environ("RTNR_RESOLVE", mode):
            paths[f"serve_{mode}"] = counted(frame(renderer))
    with environ("RTNR_FUSE_UP", "1"):
        paths["serve_fuse_up"] = counted(frame(renderer))
        paths["serve_fuse_up_dyn"] = counted(frame(dyn_r))

    M = renderer._cam_proj(cam, E)
    pts, cols, valid = renderer.points, renderer.colors, renderer.valid
    targets = render_rgbd(pts, cols, valid, M, width=WIDTH, height=HEIGHT)["rgb"][None] \
        .float() / 255.0
    cams = M[None]
    for name, state, step, args in (
            ("train_step", tt.create_train_state(variables, dtype=torch.bfloat16, device="cuda"),
             tt.make_train_step(width=WIDTH, height=HEIGHT), (pts, cols, valid, cams, targets)),
            ("scene_step", tt.create_scene_train_state(variables, cols, cams,
                                                       dtype=torch.bfloat16, device="cuda"),
             tt.make_scene_train_step(width=WIDTH, height=HEIGHT), (pts, valid, targets))):
        held = [state]

        def one(step=step, args=args, held=held):
            held[0], m = step(held[0], *args)
            float(m["loss"])

        paths[name] = counted(one)
        del held
        torch.cuda.empty_cache()
    return paths


def pose():
    """The frames' camera pose: 12 m back from the scene's centre."""
    import numpy as np

    E = np.eye(4)
    E[2, 3] = 12.0
    return E


def cli_launches(variables) -> Dict[str, Dict[str, int]]:
    """Every row's launches over one run of each CLI in process (its
    ``main``), on a RANK_POINTS-point scene at the frame's shape with the
    full-width net: the render CLI (``--stage full``, one pose), the pairs
    CLI on an E57 file holding the scene and one JPEG photo of it (the E57
    and JPEG chain), and the training CLI on those pairs (``--targets``, one
    step). Each run must exit 0."""
    import io
    import tempfile

    import numpy as np
    from rtnr_tpu_torch.apps import generate_pairs, render_trajectory, train_unet
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.data.e57_write import E57Image, scan_from_arrays, write_e57
    from rtnr_tpu_torch.data.jpeg import encode_jpeg
    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import save_msgpack

    scene = Scene.synthetic(RANK_POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT,
                             (0, 0, 0, 0, 0))  # the calibration file's pinhole form
    E = pose()
    photo = Renderer(scene, device="cuda").compute_rgbd(cam, E)["rgb"]
    P = np.linalg.inv(E) @ np.diag([1.0, -1.0, -1.0, 1.0])  # the E57 image pose of E
    flen = 0.0055  # m; a pixel pitch of flen / 1100 gives fx = fy = 1100
    photo57 = E57Image(
        jpeg_bytes=encode_jpeg(photo, 95), image_width=WIDTH, image_height=HEIGHT,
        focal_length=flen, pixel_width=flen / 1100.0, pixel_height=flen / 1100.0,
        principal_point_x=WIDTH / 2, principal_point_y=HEIGHT / 2,
        pose=(*generate_pairs.rotmat_to_quat(P[:3, :3]), *P[:3, 3]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        f = lambda name: os.path.join(d, name)  # noqa: E731
        write_ply(f("scene.ply"), scene.points, scene.colors)
        with open(f("traj.txt"), "w") as fh:
            fh.write(f"0 0 0 {-E[2, 3]} 0 0 0 1\n")
        cam.save_calibration(f("calib.txt"))
        save_msgpack(f("unet.msgpack"), variables)
        write_e57(f("scan.e57"), [scan_from_arrays(scene.points, scene.colors)], [photo57])
        runs = {
            "render_cli": lambda: render_trajectory.main(
                [f("scene.ply"), f("traj.txt"), f("calib.txt"), "-o", f("frames"), "--stage",
                 "full", "--ckpt", f("unet.msgpack")], device="cuda"),
            "pairs_cli": lambda: generate_pairs.main([f("scan.e57"), "-o", f("pairs")],
                                                     device="cuda"),
            "train_cli": lambda: train_unet.main(
                [f("scan.e57"), f("pairs/traj.txt"), f("pairs/calib.txt"), "--targets",
                 f("pairs"), "--steps", "1", "-o", f("trained.msgpack")], device="cuda"),
        }
        out = {}
        for name, run in runs.items():
            rcs: List[int] = []
            with contextlib.redirect_stdout(io.StringIO()):
                out[name] = counted(lambda run=run: rcs.append(run()))
            if rcs != [0, 0]:
                fail(f"{name} exited {rcs}")
    return out


def sharded_launches() -> Dict[str, Dict[str, int]]:
    """One rank's launches (every rank runs it; the meshes span the world
    of n ranks): one counted call of each multi-rank entry on a
    RANK_POINTS-point scene (launches do not depend on its size) at the
    frame's shape with the full-width net. On (1, n): the point-sharded
    frame, ``render_filtered_sharded`` of two frames and the point-sharded
    differentiable forward; on (n, 1): ``render_full_batch`` of two frames
    in bf16 and in static int8 and one scene-train step of two frames; on
    (n,) row strips: ``rasterize_tile_sharded`` with per-strip culling and
    ``render_full_tile_sharded`` (the strip U-Net, at 1088 rows). Keys are
    prefixed with the backend and the world size."""
    import torch
    import torch.distributed as dist
    from rtnr_tpu_torch.camera import Camera
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops.culling import build_block_index
    from rtnr_tpu_torch.ops.raster import rasterize
    from rtnr_tpu_torch.parallel import collectives as C
    from rtnr_tpu_torch.parallel.diff import rasterize_diff_point_sharded
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.parallel.render import (
        rasterize_point_sharded,
        render_filtered_sharded,
        render_full_batch,
    )
    from rtnr_tpu_torch.parallel.tiles import rasterize_tile_sharded, render_full_tile_sharded
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt

    n = dist.get_world_size()
    scene = Scene.synthetic(RANK_POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    variables = init_unet_numpy(SEED, FEATURES)
    bf16 = Renderer(scene, RenderConfig(), variables, device="cuda")
    static = Renderer(scene, RenderConfig(unet_int8="static"), variables, device="cuda")
    E2 = pose()
    E2[0, 3] = 0.5
    static.calibrate(cam, pose())
    pts, cols, valid = bf16.points, bf16.colors, bf16.valid
    Ms = torch.stack([bf16._cam_proj(cam, E) for E in (pose(), E2)])
    kw = dict(width=WIDTH, height=HEIGHT)
    points = make_mesh((1, n))
    blk = lambda a: C.shard_rows(a, points, "points")  # noqa: E731
    p, c, v = blk(pts), blk(cols), blk(valid)
    cf = blk(cols.float()).clone().requires_grad_(True)
    batch, strips = make_mesh((n, 1)), make_mesh((n,), ("tiles",))
    index = build_block_index(scene, pad_to_multiple=1024, device=pts.device)
    targets = torch.stack([rasterize(pts, cols, M, valid=valid, **kw)[0].float() / 255.0
                           for M in Ms])
    held = [tt.create_scene_train_state(variables, cols.float().cpu().numpy(), Ms.cpu().numpy(),
                                        dtype=torch.bfloat16, learning_rate=1e-4,
                                        device="cuda")]
    scene_step = tt.make_scene_train_step(mesh=batch, **kw)

    def step():
        held[0], m = scene_step(held[0], pts, valid, targets)
        float(m["loss"])

    runs = {
        "point_sharded_frame": lambda: rasterize_point_sharded(p, c, v, Ms[0], points, **kw),
        "filtered_sharded": lambda: render_filtered_sharded(p, c, v, Ms, points, **kw),
        "point_sharded_diff": lambda: rasterize_diff_point_sharded(p, cf, Ms[0], points,
                                                                   valid=v, **kw),
        "full_batch_bf16": lambda: render_full_batch(pts, cols, valid, Ms, batch, bf16.unet,
                                                     **kw),
        "full_batch_static": lambda: render_full_batch(pts, cols, valid, Ms, batch, static.unet,
                                                       act_scales=static.act_scales, **kw),
        "scene_step": step,
        "tiles_culled": lambda: rasterize_tile_sharded(pts, cols, valid, Ms[0], strips,
                                                       block_index=index, **kw),
        "strips_full": lambda: render_full_tile_sharded(pts, cols, valid, Ms[0], strips,
                                                        bf16.unet, width=WIDTH, height=HP),
    }
    tag = f"{dist.get_backend()}{n}_"
    return {tag + k: counted(run) for k, run in runs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from rtnr_tpu_torch import _build
        from rtnr_tpu_torch.camera import Camera
        from rtnr_tpu_torch.config import RenderConfig
        from rtnr_tpu_torch.models.convert import init_unet_numpy
        from rtnr_tpu_torch.parallel.launch import run_ranks
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
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {secs:.2f} s' for k, (secs, _) in built.items())})")
    for k, (_, nvcc_out) in built.items():
        for line in _build.ptxas_report(nvcc_out):
            log(f"  ptxas {k}: {line}")

    t0 = time.perf_counter()
    scene = Scene.synthetic(POINTS, seed=SEED, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    E = pose()
    cfg = RenderConfig()  # bf16 exact, features (64, 128, 256, 512)
    variables = init_unet_numpy(SEED, cfg.unet_features)
    renderer = Renderer(scene, cfg, variables, device="cuda")
    static_r = Renderer(scene, RenderConfig(unet_int8="static"), variables, device="cuda")
    dyn_r = Renderer(scene, RenderConfig(unet_int8="dyn"), variables, device="cuda")
    M = renderer._cam_proj(cam, E)
    mid = render_filtered(renderer.points, renderer.colors, renderer.valid, M, width=WIDTH,
                          height=HEIGHT)
    x = mid["unet_input"][None]
    scales = static_r.calibrate(cam, E)
    torch.cuda.synchronize()
    log(f"setup: {POINTS} points, {WIDTH}x{HEIGHT}, U-Net {cfg.unet_features} bf16, static and "
        f"dyn int8, {time.perf_counter() - t0:.2f} s")

    times: Dict[str, Dict] = {}
    work_u = unet_work(dyn_r.unet)
    stats = time_resolves(renderer, M, cfg.depth_band, times)
    time_band_ref(renderer, M, cfg.depth_band, times, stats)
    torch.cuda.empty_cache()
    time_convs(renderer.unet, static_r.unet, scales, dyn_r.unet, x, times, work_u)
    time_prefilter(mid["raw_depth"], mid["raw_rgb"], times)
    del mid, x
    torch.cuda.empty_cache()
    time_bn_train(times)
    work = row_work(dyn_r.unet, stats)

    paths = path_launches(renderer, static_r, dyn_r, cam, E, variables)
    del renderer, static_r, dyn_r, scene
    torch.cuda.empty_cache()
    paths.update(cli_launches(variables))
    root = os.path.dirname(os.path.abspath(__file__))
    for world in (2, 1):  # gloo between ranks sharing the card; NCCL for one rank
        try:
            ranks = run_ranks("chip_smoke:sharded_launches", world, {}, device="cuda",
                              threads=2, extra_path=[root], timeout=600)
        except (RuntimeError, TimeoutError) as e:
            fail(f"the sharded paths on {world} rank(s): {str(e)[-4000:]}")
        paths.update(ranks[0])

    kernels = []
    for r in ROWS:
        t = times[r.name]
        launches = {p: c[r.name] for p, c in paths.items() if c[r.name]}
        if bool(launches) == (r.name in STANDALONE):
            fail(f"{r.name}: launches {launches or 'on no path'}, but ROWS puts it "
                 + ("on no path" if r.name in STANDALONE else "on a path"))
        nbytes, ops = work[r.name]
        bnd, by = bound_ms(nbytes, ops)
        ms = statistics.median(t["ms"])
        row = {"name": r.name, "label": r.label, "tpu": r.tpu, "source": r.source,
               "entries": list(r.entries), **({"form": r.form} if r.form else {}),
               "ms": ms, "spread": (max(t["ms"]) - min(t["ms"])) / ms, "ms_all": t["ms"],
               "bound_ms": bnd, "bound_by": by, "plain_ms": t["plain_ms"],
               "library_ms": t["library_ms"], "launches": launches}
        kernels.append(row)
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"{r.name:17s} {ms:9.4f} ms (spread {row['spread']:.3f}) bound {bnd:.4f} {by} "
            f"({bnd / ms:.3f} of it), plain {t['plain_ms']:.4f}, library {lib}; "
            f"launches {launches}")
    log(json.dumps({"kernels": kernels, "card": card, "streams": stats}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
