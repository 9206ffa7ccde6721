"""The int8 modes on Hopper (``csrc/conv_i8_sm90.cu``), the parts the CPU
reaches: the routes (``conv.k3_route`` / ``conv.k4_route``) over the
full-width U-Net's static and dyn int8 plans, the K-major int8 weight copies
the kernels read, the plain twins that contract as the kernels walk N and K
(``conv3x3_dyn_wgmma_plain``, ``convt2x2_i8_wgmma_plain``) against the
mode twins bit for bit, the dyn kernel's A-fragment addressing, and CPU
calls counting nothing. Torch only: the mode twins are held against the JAX
package in tests/test_torch_int8_conv.py."""

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


def plan(static: bool, features=FEATURES):
    """The int8 plan of ``UNet.int8_plan`` (static with every scale 0.05)."""
    net = types.SimpleNamespace(features=features, quant_min_f=256)
    scales = collections.defaultdict(lambda: 0.05) if static else None
    return UNet.int8_plan(net, scales)


def routes(static: bool, features=FEATURES):
    """Each layer's route under the plan, on small random weights."""
    convs, ups = unet_shapes(features)
    p, out = plan(static, features), {}
    for name, (cs, f, head) in convs.items():
        w = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), 1, 0.1), mk((f,), 2), c0=cs[0],
                               **p.get(name, {}))
        out[name] = (w.quant, cv.k3_route(cs, w, head=head))
    for name, (c, f) in ups.items():
        w = cv.prepare_convt2x2(mk((2, 2, c, f), 3, 0.1), mk((f,), 4), **p.get(name, {}))
        out[name] = (w.quant, cv.k4_route(c, w))
    return out


def test_dyn_plan_routes_its_ten_convs():
    r = routes(static=False)
    dyn = {k for k, (mode, _) in r.items() if mode == "dyn"}
    assert len(dyn) == 10
    assert all(r[k][1] == "conv_i8_sm90" for k in dyn)
    # the rest of the dyn net is exact bf16: 7 convs and the 4 ConvTransposes on
    # conv_sm90.cu, the input conv on conv_in_sm90.cu
    rest = collections.Counter(route for k, (mode, route) in r.items() if k not in dyn)
    assert rest == {"conv_sm90": 11, "conv_in_sm90": 1}


def test_static_plan_routes_its_four_convtransposes_only():
    """The static plan's 4 ConvTransposes and its 17 static convs run
    conv_i8_sm90.cu; the int8-output input conv runs conv_in_sm90.cu."""
    r = routes(static=True)
    ups = [k for k in r if "/" not in k]  # up0 .. up3
    assert len(ups) == 4 and all(r[k] == ("static", "conv_i8_sm90") for k in ups)
    static = [k for k, (mode, _) in r.items() if mode == "static" and k not in ups]
    assert len(static) == 17 and all(r[k][1] == "conv_i8_sm90" for k in static)
    rest = {k: v for k, v in r.items() if k not in ups and k not in static}
    assert rest == {"down0/conv0": ("", "conv_in_sm90")}


@pytest.mark.parametrize("cs,f,head,want", [
    ((128,), 256, False, True), ((512, 512), 512, False, True), ((1024,), 1024, False, True),
    ((64,), 128, False, False),  # F below the 256-channel tile
    ((16,), 32, False, False), ((16, 16), 16, False, False),  # toy widths
    ((5,), 256, False, False), ((24,), 256, False, False),  # channels off the 64-channel stage
    ((64, 32), 256, False, False),
    ((64,), 256, True, False),  # the head stays on conv.cu
])
def test_dyn_route_cases(cs, f, head, want):
    assert cv.takes_dyn_wgmma(cs, f, head=head) == want


@pytest.mark.parametrize("c,f,out_i8,want", [
    (1024, 512, True, True), (128, 64, True, True), (64, 64, True, True),
    (32, 16, True, False), (16, 32, True, False), (24, 64, True, False), (64, 96, True, False),
    (128, 64, False, False),  # bf16 output stays on conv.cu
])
def test_convt_route_cases(c, f, out_i8, want):
    assert cv.takes_convt_i8_wgmma(c, f, out_i8=out_i8) == want


def test_dyn_k_major_copy_follows_the_kernel_row_map():
    """Row ``t*(C0+C1) + (C0 if input 1) + c`` of ``wmat_t`` holds the
    quantised kernel[t // 3, t % 3, channel, :], as ``wmat`` does."""
    c0, c1, f = 64, 128, 256
    w = cv.prepare_conv3x3(mk((3, 3, c0 + c1, f), 10, 0.1), mk((f,), 11), quant="dyn")
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


def test_static_convt_k_major_copy_is_in_column_order():
    """Row ``(dy*2 + dx)*F + f`` of the (4F, C) copy holds the quantised
    flipped kernel[1-dy, 1-dx, :, f], so a 256-row N tile is one output
    sub-row (or all four subpixels at F = 64)."""
    c, f = 128, 128
    kt = mk((2, 2, c, f), 20, 0.1)
    w = cv.prepare_convt2x2(kt, mk((f,), 21), quant="static", in_scale=0.02, out_scale=0.05)
    assert w.wmat_t.shape == (4 * f, c) and w.wmat_t.dtype == torch.int8
    assert w.wmat_t.is_contiguous()
    swv, wq = cv._quant_weights(torch.flip(torch.from_numpy(kt), dims=(0, 1)), (0, 1, 2))
    for dy in range(2):
        for dx in range(2):
            rows = w.wmat_t[(dy * 2 + dx) * f:(dy * 2 + dx + 1) * f]
            assert torch.equal(rows, wq[dy, dx].t().to(torch.int8))
    # wq[dy, dx] is the flip: kernel[1-dy, 1-dx]
    assert torch.equal(wq[0, 1], cv._quant_weights(torch.from_numpy(kt), (0, 1, 2))[1][1, 0])


@pytest.mark.parametrize("c,f,kw", [(64, 64, {"quant": "dyn"}), (64, 128, {"quant": "dyn"}),
                                    (32, 256, {"quant": "dyn"}),
                                    (32, 256, {"quant": "static", "in_scales": (0.1,)})])
def test_no_dyn_copy_where_the_kernel_is_not_routed(c, f, kw):
    assert cv.prepare_conv3x3(mk((3, 3, c, f), 30, 0.1), mk((f,), 31), **kw).wmat_t is None


def test_no_static_convt_copy_at_toy_widths():
    assert cv.prepare_convt2x2(mk((2, 2, 32, 16), 32), quant="static", in_scale=0.1).wmat_t is None


def _dyn_inputs(hw, cs, f, seed, zero_patch=False):
    h, w = hw
    xs = [torch.from_numpy(mk((1, h, w, c), seed + i)).to(torch.bfloat16)
          for i, c in enumerate(cs)]
    if zero_patch:
        for x in xs:
            x[:, 2:9, 3:12] = 0
    wq = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), seed + 5, 0.1), mk((f,), seed + 6),
                            quant="dyn")
    return xs, wq


@pytest.mark.parametrize("hw,cs,f,pool,zero", [((20, 36), (64,), 256, True, False),
                                               ((17, 30), (64,), 256, False, False),
                                               ((20, 36), (64, 64), 512, True, False),
                                               ((17, 30), (128, 64), 256, False, False),
                                               ((20, 36), (64, 64), 256, False, True)])
def test_dyn_walk_twin_equals_the_dyn_twin(hw, cs, f, pool, zero):
    """At ragged 20x36 and 17x30, one and two inputs, with the pool and
    with an all-zero patch (rinv = 0): the kernel-walk twin equals
    ``conv3x3_prepared_plain`` bit for bit."""
    xs, wq = _dyn_inputs(hw, cs, f, 40, zero)
    got = cv.conv3x3_dyn_wgmma_plain(xs, wq, relu=True, pool=pool)
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=pool)
    assert len(got) == len(want) == (2 if pool else 1)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r)


@pytest.mark.parametrize("c,f,hw", [(64, 64, (17, 30)), (128, 128, (20, 36)),
                                    (64, 256, (5, 7)), (192, 64, (3, 50))])
def test_convt_walk_twin_equals_the_static_twin(c, f, hw):
    """H*W not a multiple of the 128-pixel tile; F = 64 (a tile holds all
    four subpixels), 128 (one dy) and 256 (one subpixel)."""
    x = codes((1,) + hw + (c,), 50)
    w = cv.prepare_convt2x2(mk((2, 2, c, f), 51, 0.2), mk((f,), 52), quant="static",
                            in_scale=0.013, out_scale=0.037)
    got = cv.convt2x2_i8_wgmma_plain(x, w)
    assert got.dtype == torch.int8 and torch.equal(got, cv.convt2x2_prepared_plain(x, w))


def test_dyn_a_fragment_addressing():
    """The dyn kernel's quantiser reads, for lane l, k32 step s and half u,
    8 bytes at ``(((4s + 2u + q/2) ^ g) << 4) + 8(q % 2)`` of box row p (g =
    l/4, q = l%4, p % 8 == g) under TMA's 128B swizzle (16-byte chunk c of
    row p stored at chunk c ^ (p % 8)). Undone, that is channels 32s + 16u +
    4q .. +3 of pixel row g (+8): register 2u + h of wgmma's s8 A fragment,
    whose 16 rows x 32 k bytes the 32 lanes cover once."""
    seen = collections.Counter()
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for s in range(2):
            for u in range(2):
                off = (((4 * s + 2 * u + (q >> 1)) ^ g) << 4) + 8 * (q & 1)
                for h in range(2):
                    p = 16 * 3 + g + 8 * h  # any box row of fragment row g + 8h
                    chunk = (off >> 4) ^ (p & 7)  # the logical chunk TMA stored there
                    channel = (16 * chunk + (off & 15)) // 2
                    assert channel == 32 * s + 16 * u + 4 * q
                    # register 2u + h: row g + 8h, k bytes 4q + 16u .. +3 of step s
                    for e in range(4):
                        seen[(s, g + 8 * h, 4 * q + 16 * u + e)] += 1
    assert len(seen) == 2 * 16 * 32 and set(seen.values()) == {1}


def test_cpu_calls_run_the_twins_and_count_nothing():
    xs, wq = _dyn_inputs((8, 16), (64,), 256, 60)
    x = codes((1, 4, 6, 64), 61)
    wt = cv.prepare_convt2x2(mk((2, 2, 64, 64), 62, 0.2), None, quant="static", in_scale=0.02,
                             out_scale=0.05)
    counters = (cv.conv3x3_dyn_wgmma, cv.conv3x3_dyn, cv.convt2x2_static_wgmma,
                cv.convt2x2_static)
    before = [c.launches for c in counters]
    y, pooled = cv.conv3x3_prepared(xs, wq, relu=True, pool=True)
    up = cv.convt2x2_prepared(x, wt)
    assert [c.launches for c in counters] == before
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=True)
    assert torch.equal(y, want[0]) and torch.equal(pooled, want[1])
    assert torch.equal(up, cv.convt2x2_prepared_plain(x, wt))
