"""K4's bf16 mode and K3's static int8 mode on Hopper (``convt2x2_wgmma`` in
``csrc/conv_sm90.cu``, ``conv3x3_static_wgmma`` in ``csrc/conv_i8_sm90.cu``),
the parts the CPU reaches: the routes (``conv.k3_route`` / ``conv.k4_route``)
over the full-width U-Net's bf16 and static int8 plans, the K-major weight
copies the kernels read, the plain twins that contract as the kernels walk N
and K (``conv3x3_static_wgmma_plain`` bit for bit against the static twin,
``convt2x2_wgmma_plain`` within 1 bf16 ulp of the bf16 twin: f32 sums in
another order), the int8 halo box's 64B-swizzle addressing, and CPU calls
counting nothing. Torch only: the mode twins are held against the JAX
package in tests/test_torch_int8_conv.py (K3 static) and
tests/test_torch_conv.py (K4 bf16)."""

import collections
import types

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.models.convert import unet_layer_names
from rtnr_tpu_torch.models.unet import UNet
from rtnr_tpu_torch.ops import conv as cv

FEATURES = (64, 128, 256, 512)


def mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def codes(shape, seed, lo=-127):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, 128, size=shape)
                            .astype(np.int8))


def unet_shapes(features=FEATURES, in_ch=5):
    """(input channel counts, F, head) of every conv3x3 and (C, F) of every
    ConvTranspose of the U-Net, by layer name."""
    n = len(features)
    convs, c = {}, in_ch
    for i, f in enumerate(features):
        convs[f"down{i}/conv0"] = ((c,), f, False)
        convs[f"down{i}/conv1"] = ((f,), f, False)
        c = f
    fb = 2 * features[-1]
    convs["bottleneck/conv0"] = ((features[-1],), fb, False)
    convs["bottleneck/conv1"] = ((fb,), fb, False)
    ups, prev = {}, fb
    for i, f in enumerate(reversed(features)):
        ups[f"up{i}"] = (prev, f)
        convs[f"updc{i}/conv0"] = ((f, f), f, False)  # [skip, up]
        convs[f"updc{i}/conv1"] = ((f,), f, i == n - 1)
        prev = f
    names, up_names = unet_layer_names(n)
    assert set(names) == set(convs) and set(up_names) == set(ups)
    return convs, ups


def routes(quant: str, features=FEATURES):
    """Each layer's (mode, route, has a K-major copy) under the plan of
    ``UNet.int8_plan`` ("static" with every scale 0.05; "" the bf16 net)."""
    convs, ups = unet_shapes(features)
    net = types.SimpleNamespace(features=features, quant_min_f=256)
    p = UNet.int8_plan(net, collections.defaultdict(lambda: 0.05)) if quant else {}
    out = {}
    for name, (cs, f, head) in convs.items():
        w = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), 1, 0.1), mk((f,), 2), c0=cs[0],
                               **p.get(name, {}))
        out[name] = (w.quant, cv.k3_route(cs, w, head=head), w.wmat_t is not None)
    for name, (c, f) in ups.items():
        w = cv.prepare_convt2x2(mk((2, 2, c, f), 3, 0.1), mk((f,), 4), **p.get(name, {}))
        out[name] = (w.quant, cv.k4_route(c, w), w.wmat_t is not None)
    return out


def test_static_plan_routes_all_seventeen_convs():
    r = routes("static")
    static = [k for k, (mode, _, _) in r.items() if mode == "static" and "/" in k]
    assert len(static) == 17
    assert all(r[k][1:] == ("conv_i8_sm90", True) for k in static)
    # the int8-output input conv is exact bf16 and runs conv_in_sm90.cu on wmat
    assert r["down0/conv0"][:2] == ("", "conv_in_sm90") and not r["down0/conv0"][2]


def test_bf16_plan_routes_its_four_convtransposes():
    r = routes("")
    ups = [k for k in r if "/" not in k]
    assert len(ups) == 4 and all(r[k] == ("", "conv_sm90", True) for k in ups)


@pytest.mark.parametrize("cs,f,head,want", [
    ((64,), 64, False, True), ((64, 64), 64, False, True), ((64,), 64, True, True),
    ((128,), 128, False, True), ((512, 512), 512, False, True), ((1024,), 1024, False, True),
    ((16,), 32, False, False), ((32, 32), 32, False, False),  # toy widths
    ((5,), 64, False, False), ((24,), 64, False, False),  # channels off the 64-byte stage
    ((64, 32), 64, False, False), ((64,), 96, False, False),
    ((128,), 128, True, False),  # the head needs one consumer to hold every channel
    ((256,), 256, True, False),
])
def test_static_route_cases(cs, f, head, want):
    assert cv.takes_static_wgmma(cs, f, head=head) == want
    w = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), 5, 0.1), None, quant="static",
                           in_scales=(0.02, 0.03)[:len(cs)], c0=cs[0])
    assert (cv.k3_route(cs, w, head=head) == "conv_i8_sm90") == want


@pytest.mark.parametrize("c,f,want", [(1024, 512, True), (128, 64, True), (64, 64, True),
                                      (32, 16, False), (16, 32, False), (24, 64, False),
                                      (64, 96, False)])
def test_convt_route_cases(c, f, want):
    assert cv.takes_convt_wgmma(c, f) == want
    w = cv.prepare_convt2x2(mk((2, 2, c, f), 6, 0.1), mk((f,), 7))
    assert (cv.k4_route(c, w) == "conv_sm90") == want
    assert (w.wmat_t is not None) == want


def test_static_k_major_copy_follows_the_kernel_row_map():
    """Row ``t*(C0+C1) + (C0 if input 1) + c`` of ``wmat_t`` holds the
    quantised kernel[t // 3, t % 3, channel, :] (the second input's slice
    already scaled by its scale ratio), as ``wmat`` does."""
    c0, c1, f = 64, 128, 64
    w = cv.prepare_conv3x3(mk((3, 3, c0 + c1, f), 10, 0.1), mk((f,), 11), quant="static",
                           in_scales=(0.02, 0.05), c0=c0, out_scale=0.1)
    k = 9 * (c0 + c1)
    assert w.wmat_t.shape == (f, k) and w.wmat_t.dtype == torch.int8
    assert w.wmat_t.is_contiguous() and torch.equal(w.wmat_t, w.wmat[:k].t())
    wq = w.wmat[:k].reshape(3, 3, c0 + c1, f)
    rng = np.random.default_rng(12)
    for _ in range(64):
        t, i, n = int(rng.integers(9)), int(rng.integers(2)), int(rng.integers(f))
        c = int(rng.integers(c1 if i else c0))
        row = t * (c0 + c1) + (c0 if i else 0) + c
        assert w.wmat_t[n, row] == wq[t // 3, t % 3, (c0 if i else 0) + c, n]


@pytest.mark.parametrize("c,f,c0", [(32, 64, None), (64, 96, None), (96, 64, 32),
                                    (24, 64, None)])
def test_no_static_copy_where_the_kernel_is_not_routed(c, f, c0):
    scales = (0.1,) if c0 is None else (0.1, 0.2)
    w = cv.prepare_conv3x3(mk((3, 3, c, f), 30, 0.1), mk((f,), 31), quant="static",
                           in_scales=scales, c0=c0)
    assert w.wmat_t is None


def _static_case(hw, cs, f, seed, *, out_i8=True, head=False):
    h, w = hw
    xs = [codes((1, h, w, c), seed + i, 0) for i, c in enumerate(cs)]
    wq = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), seed + 5, 0.1), mk((f,), seed + 6, 0.5),
                            quant="static", in_scales=(0.031, 0.047)[:len(cs)], c0=cs[0],
                            out_scale=0.09 if out_i8 else None)
    hd = cv.prepare_head(mk((f, 3), seed + 7, 0.2), mk((3,), seed + 8)) if head else None
    return xs, wq, hd


@pytest.mark.parametrize("hw,cs,f,pool,out_i8,head", [
    ((20, 36), (64,), 64, True, True, False),
    ((17, 30), (64,), 128, False, True, False),
    ((20, 36), (64, 64), 128, True, True, False),
    ((17, 30), (128, 64), 256, False, True, False),
    ((20, 36), (64,), 256, True, False, False),  # bf16 output, pooled
    ((17, 30), (64,), 64, False, False, True),  # the head conv: bf16, head fused
    ((20, 36), (64, 64), 64, False, False, True),
])
def test_static_walk_twin_equals_the_static_twin(hw, cs, f, pool, out_i8, head):
    """At ragged 20x36 and 17x30 (neither divisible by the 16 x 16 tile), one
    and two inputs, with the pool, with the head, int8 and bf16 output: the
    kernel-walk twin equals ``conv3x3_prepared_plain`` bit for bit."""
    xs, wq, hd = _static_case(hw, cs, f, 40, out_i8=out_i8, head=head)
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=pool, head=hd)
    got = cv.conv3x3_static_wgmma_plain(xs, wq, relu=True, pool=pool, head=hd)
    assert len(got) == len(want) == (2 if pool else 1)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("c,f,hw", [(64, 64, (17, 30)), (128, 128, (20, 36)),
                                    (256, 64, (5, 7)), (64, 192, (3, 50))])
def test_convt_walk_twin_within_one_ulp(c, f, hw):
    """H*W not a multiple of the 128-pixel tile; F = 64 (one N tile), 128
    and 192 (two and three 64-channel chunks). f32 sums in another order
    than ``F.conv_transpose2d``'s: within 1 bf16 ulp of the output's
    magnitude (the repository's form of an ulp gate: an element whose sums
    cancel keeps the absolute error of the large ones) of the bf16 twin."""
    x = torch.from_numpy(mk((1,) + hw + (c,), 50)).to(torch.bfloat16)
    w = cv.prepare_convt2x2(mk((2, 2, c, f), 51, 0.1), mk((f,), 52))
    got = cv.convt2x2_wgmma_plain(x, w)
    want = cv.convt2x2_prepared_plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (1, 2 * hw[0],
                                                                       2 * hw[1], f)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


@pytest.mark.parametrize("dy", [0, 1, 2])
def test_static_box_addressing(dy):
    """The static kernel's pixel operand at tap dy under TMA's 64B swizzle.
    The box (64 channels, 16 x, 18 y) lands as 1-KB pixel rows of 64-byte
    pixels, 16-byte chunk c of the byte at smem address a stored at chunk c ^
    ((a >> 7) & 3). The operand starts at box row dy: a 1-KB multiple, so on
    a 512-byte swizzle atom, and wgmma's layout-2 descriptor (rows of 64
    bytes, 8-row groups 512 bytes apart, a k32 step 32 bytes on) applies the
    same XOR: its row n, k byte kb of step s is box pixel (dy + n // 16,
    n % 16), channel 32s + kb, the tap's input pixel of the tile's output
    pixel (n // 16, n % 16); its 256 rows cover the 16 x 16 tile once."""
    base = 4096  # any 1-KB aligned stage buffer
    swz = lambda a: a ^ (((a >> 7) & 3) << 4)
    # TMA: logical byte (box row yr, column xc, channel ch) -> smem address
    smem = {}
    for yr in range(18):
        for xc in range(16):
            for ch in range(64):
                smem[swz(base + (yr * 16 + xc) * 64 + ch)] = (yr, xc, ch)
    assert len(smem) == 18 * 16 * 64
    start = base + dy * 1024
    assert start % 512 == 0
    covered = set()
    for s in range(2):
        for n in range(256):
            for kb in range(0, 32, 4):
                yr, xc, ch = smem[swz(start + 32 * s + n * 64 + kb)]
                assert (yr, xc, ch) == (dy + n // 16, n % 16, 32 * s + kb)
                covered.add((n // 16, n % 16))
    assert covered == {(y, x) for y in range(16) for x in range(16)}


def test_static_staging_is_a_bijection():
    """The staged block of codes: 64 rows x 4 chunks of 16 bytes, chunk ch of
    row r at ``r*64 + ((ch ^ ((r >> 1) & 3)) << 4)``; the 8 rows a warp's
    fragment writes for one column group fall on 8 distinct 4-bank groups."""
    offs = {r * 64 + ((ch ^ ((r >> 1) & 3)) << 4) for r in range(64) for ch in range(4)}
    assert offs == set(range(0, 64 * 64, 16))
    for ch in range(4):
        banks = {((r * 64 + ((ch ^ ((r >> 1) & 3)) << 4)) // 16) % 8 for r in range(8)}
        assert len(banks) == 8


def test_cpu_calls_run_the_twins_and_count_nothing():
    xs, wq, _ = _static_case((8, 16), (64,), 64, 60)
    xh, wh, hd = _static_case((8, 16), (64,), 64, 62, out_i8=False, head=True)
    x = torch.from_numpy(mk((1, 4, 6, 64), 61)).to(torch.bfloat16)
    wt = cv.prepare_convt2x2(mk((2, 2, 64, 64), 62, 0.2), mk((64,), 63))
    counters = (cv.conv3x3_static_wgmma, cv.conv3x3_static, cv.convt2x2_wgmma, cv.convt2x2)
    before = [c.launches for c in counters]
    y, pooled = cv.conv3x3_prepared(xs, wq, relu=True, pool=True)
    (hout,) = cv.conv3x3_prepared(xh, wh, relu=True, head=hd)
    up = cv.convt2x2_prepared(x, wt)
    assert [c.launches for c in counters] == before
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=True)
    assert torch.equal(y, want[0]) and torch.equal(pooled, want[1])
    assert torch.equal(hout, cv.conv3x3_prepared_plain(xh, wh, relu=True, head=hd)[0])
    assert torch.equal(up, cv.convt2x2_prepared_plain(x, wt))
