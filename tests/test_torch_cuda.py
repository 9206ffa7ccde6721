"""The port's CUDA kernels (the v4, v5 and differentiable resolves and their
band-reference forms, K1-K6,
the carrier kernel for K7-K9, K10 on K3, K3's fused-ConvTranspose mode, the
input conv on conv_in_sm90.cu, the int8 modes of K3/K4 on conv.cu and on
the s8 wgmma kernels of conv_i8_sm90.cu, UNetTrain's BatchNorm + ReLU on
bn_train.cu, and the depth prefilter on prefilter.cu) against their plain torch twins on
the card, the differentiable raster and the int8 Renderer on the card
against the CPU, and Renderer frames under every RTNR_RESOLVE value; then
the benchmark's shapes (a 1080p frame of the full-width net in every
serving mode, its routes, conv calls and output budgets, both train steps,
the training CLI) and the multi-rank paths on ranks sharing the card.
Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so on a machine with the card and no JAX it
runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import bn_ok, conv_ok, convt_ok, same_bits, ulp2
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.ops import conv as cv
from rtnr_tpu_torch.ops import raster as tr
from rtnr_tpu_torch.ops import raster_diff as td
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops import raster_resolve5 as r5
from rtnr_tpu_torch.ops import raster_resolve_carriers as rc
from rtnr_tpu_torch.ops.conv_direct import conv3x3_pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50_000])
def test_resolve_kernels_match_twins(cuda, n):
    """K1 + K2, bit for bit, incl. a dense stream with long segments."""
    w, h = 96, 64
    rng = np.random.default_rng(11)
    px, py = rng.integers(0, w, n), rng.integers(0, h // 4, n)
    z = rng.uniform(2.0, 8.0, n)
    pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    M = Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    sp = tr.project_and_sort(t(pts), t(cols), t(M), width=w, height=h)
    wimg, total = rr.winners(sp, w * h, 0.02)
    wimg_p, total_p = rr.winners_plain(sp, w * h, 0.02)
    k = int(total_p[0])
    assert int(total[0]) == k and torch.equal(wimg[:, :k], wimg_p[:, :k])
    for packed_out in (False, True):
        got = rr.expand_winners(wimg, total, w * h, packed_out=packed_out)
        want = rr.expand_plain(wimg_p, total_p, w * h, packed_out)
        for g, x in zip(got, want):
            assert torch.equal(g.view(torch.int32), x.view(torch.int32))


def _dense_stream(cuda, n, w, h, seed=11):
    rng = np.random.default_rng(seed)
    px, py = rng.integers(0, w, n), rng.integers(0, h // 4, n)
    z = rng.uniform(2.0, 8.0, n)
    pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    M = Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    return tr.project_and_sort(t(pts), t(cols), t(M), width=w, height=h)


def _resolve4_stream(cuda, case):
    """(stream, hw) of the rtnr_resolve4 cases: 96 x 64 = 6,144 = 3 tiles of
    2,048 pixels; 97 x 61 = 5,917 is not a multiple of the tile."""
    if case in ("n1", "n50000"):
        return _dense_stream(cuda, 1 if case == "n1" else 50_000, 96, 64), 96 * 64
    w, h = 97, 61
    if case == "one_pixel_20000":
        pts, cols, M = _resolver_cloud(cuda, 3_000, w, h, 22, one_pixel=20_000)
    elif case == "all_culled":
        pts, cols, M = _resolver_cloud(cuda, 4_000, w, h, 23)
        pts = pts * torch.tensor([1.0, 1.0, -1.0], device=cuda)  # behind the camera
    else:
        pts, cols, M = _resolver_cloud(cuda, 30_000, w, h, 24)
    sp = tr.project_and_sort(pts, cols, M, width=w, height=h)
    if case == "unaligned":  # 4-byte offsets: the kernel's element-by-element loads
        sp = tr.SortedPoints(*(t[1:] for t in sp))
    return sp, w * h


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n1", "n50000", "one_pixel_20000", "all_culled",
                                  "hw_not_multiple_of_p", "unaligned"])
def test_resolve4_matches_twin_and_old_pair(cuda, case):
    """rtnr_resolve4 in both forms against its twin, bit for bit; one
    launch of its own counter a call, none of K1's or K2's; two runs
    equal."""
    sp, hw = _resolve4_stream(cuda, case)
    if case == "all_culled":
        assert int((sp.pix < hw).sum()) == 0
    for packed_out in (False, True):
        before = (rr.raster_images_v4.launches, rr.winners.launches, rr.expand_winners.launches)
        got = rr.raster_images_v4(sp, hw, 0.02, packed_out=packed_out)
        assert (rr.raster_images_v4.launches, rr.winners.launches,
                rr.expand_winners.launches) == (before[0] + 1, before[1], before[2])
        assert same_bits(got, rr.raster_images_v4_plain(sp, hw, 0.02, packed_out))
        assert same_bits(got, rr.raster_images_v4(sp, hw, 0.02, packed_out=packed_out))
        if case == "one_pixel_20000" and not packed_out:
            assert int(got[1].max()) >= 1000


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50_000])
@pytest.mark.parametrize("form", ["packed", "sums", "float_sums"])
def test_expand_tile_matches_twin_and_search(cuda, n, form):
    """The tile K2 (rtnr_expand) in its three forms against expand_plain,
    bit for bit; one launch of its counter a call."""
    w, h = 97, 61
    hw = w * h
    sp = _dense_stream(cuda, n, w, h, seed=13)
    packed_out, float_sums = form == "packed", form == "float_sums"
    if float_sums:
        frac = torch.rand((sp.pix.numel(), 3), generator=torch.Generator(device=cuda)
                          .manual_seed(5), device=cuda)
        rgb = torch.stack([(sp.packed >> s) & 255 for s in (0, 8, 16)], 1).float() + frac
        wimg, total = rr.winners_f32(tr.SortedDiff(sp.pix, sp.zbits, rgb.contiguous()), hw, 0.02)
    else:
        wimg, total = rr.winners(sp, hw, 0.02)
    before = rr.expand_winners.launches
    got = rr.expand_winners(wimg, total, hw, packed_out=packed_out, float_sums=float_sums)
    assert rr.expand_winners.launches == before + 1
    assert same_bits(got, rr.expand_plain(wimg, total, hw, packed_out, float_sums))


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [(5,), (64,), (64, 64)])
def test_conv3x3_kernel_matches_f32_twin(cuda, cs):
    """K3 with one and two inputs and the 5-channel input, plus the pool
    (exact) and the head (2 ulp of its own reference)."""
    xs = [torch.from_numpy(_mk((1, 32, 48, c), i)).to(cuda, torch.bfloat16)
          for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), 64), 3, 0.05)).to(cuda)
    b = torch.from_numpy(_mk((64,), 4)).to(cuda)
    y, pooled = cv.conv3x3(xs, k, b, relu=True, pool=True)
    (ref,) = cv.conv3x3_plain(xs, cv._bf16_values(k), cv._bf16_values(b), relu=True,
                              dtype=torch.float32)
    assert float((y.float() - ref).abs().max()) <= ulp2(ref)
    assert torch.equal(pooled, cv._pool2(y))
    hk = torch.from_numpy(_mk((64, 3), 5, 0.2)).to(cuda)
    hb = torch.from_numpy(_mk((3,), 6)).to(cuda)
    (hout,) = cv.conv3x3(xs, k, b, relu=True, head_kernel=hk, head_bias=hb)
    href = torch.matmul(y.float(), cv._bf16_values(hk)) + cv._bf16_values(hb)
    assert float((hout.float() - href).abs().max()) <= ulp2(href)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(8, 16), (128, 64)])
def test_convt2x2_kernel_matches_f32_twin(cuda, c, f):
    x = torch.from_numpy(_mk((1, 16, 24, c), 7)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_mk((2, 2, c, f), 8, 0.1)).to(cuda)
    b = torch.from_numpy(_mk((f,), 9)).to(cuda)
    y = cv.convt2x2(x, k, b)
    ref = cv.convt2x2_plain(x, cv._bf16_values(k), cv._bf16_values(b), dtype=torch.float32)
    assert y.shape == (1, 32, 48, f)
    assert float((y.float() - ref).abs().max()) <= ulp2(ref)


@pytest.mark.cuda
def test_wrappers_count_launches(cuda):
    x = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16, device=cuda)
    before = (cv.conv3x3.launches, cv.convt2x2.launches)
    cv.conv3x3([x], _mk((3, 3, 8, 8), 1), relu=True)
    cv.convt2x2(x, _mk((2, 2, 8, 8), 2))
    assert (cv.conv3x3.launches, cv.convt2x2.launches) == (before[0] + 1, before[1] + 1)


def _codes(shape, seed, lo=-127):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, 128, size=shape)
                            .astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("cs,w,pool,out", [
    ((16,), 48, True, True),  # int8 pool
    ((32, 16), 37, False, True),  # two inputs, odd W
    ((8,), 24, False, True),  # channels off the 16-byte loads
    ((64,), 40, False, False),  # bf16 out (the head conv)
])
def test_conv3x3_static_kernel_matches_twin(cuda, cs, w, pool, out):
    """K3 static, bit for bit: i32 sums and the same f32 epilogue."""
    xs = [_codes((1, 20, w, c), i, 0).to(cuda) for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), 64), 3, 0.1)).to(cuda)
    b = torch.from_numpy(_mk((64,), 4, 0.5)).to(cuda)
    scales = [torch.tensor(v, device=cuda) for v in (0.031, 0.047)][: len(cs)]
    wq = cv.prepare_conv3x3(k, b, quant="static", in_scales=scales, c0=cs[0],
                            out_scale=torch.tensor(0.09, device=cuda) if out else None)
    before = cv.conv3x3_static.launches
    got = cv.conv3x3_prepared(xs, wq, relu=True, pool=pool)
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=pool)
    assert cv.conv3x3_static.launches == before + 1
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("cs,w,head", [((16,), 48, False), ((32, 16), 37, False),
                                       ((8,), 24, False), ((64,), 32, True)])
def test_conv3x3_dyn_kernel_matches_twin(cuda, cs, w, head):
    """K3 dyn with its per-pixel scale pre-pass, bit for bit (the head on
    its bf16 output within 2 ulp)."""
    xs = [torch.from_numpy(_mk((1, 20, w, c), i)).to(cuda, torch.bfloat16)
          for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), 64), 3, 0.1)).to(cuda)
    wq = cv.prepare_conv3x3(k, torch.from_numpy(_mk((64,), 4)).to(cuda), quant="dyn")
    (got,) = cv.conv3x3_prepared(xs, wq, relu=True)
    (want,) = cv.conv3x3_prepared_plain(xs, wq, relu=True)
    assert torch.equal(got, want)
    if head:
        hw = cv.prepare_head(torch.from_numpy(_mk((64, 3), 5, 0.2)).to(cuda))
        (hout,) = cv.conv3x3_prepared(xs, wq, relu=True, head=hw)
        href = torch.matmul(got.float(), hw.hk.float()) + hw.hb
        assert float((hout.float() - href).abs().max()) <= ulp2(href)


@pytest.mark.cuda
def test_conv3x3_exact_int8_out_kernel_matches_twin(cuda):
    """The 5-channel bf16 input conv writing int8 (on conv_in_sm90.cu): f32
    sums in another order than the twin's, so at most 1 code on at most 0.1%
    of the elements."""
    x = torch.from_numpy(_mk((1, 32, 48, 5), 1)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_mk((3, 3, 5, 64), 2, 0.3)).to(cuda)
    wq = cv.prepare_conv3x3(k, None, out_scale=torch.tensor(0.02, device=cuda))
    before = (cv.conv3x3_i8out.launches, cv.conv3x3_in.launches)
    (got,) = cv.conv3x3_prepared([x], wq, relu=True)
    (want,) = cv.conv3x3_prepared_plain([x], wq, relu=True)
    assert (cv.conv3x3_i8out.launches, cv.conv3x3_in.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    assert got.dtype == torch.int8
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,w", [(32, 16, 24), (8, 8, 13)])
def test_convt2x2_static_kernel_matches_twin(cuda, c, f, w):
    x = _codes((1, 10, w, c), 7).to(cuda)
    k = torch.from_numpy(_mk((2, 2, c, f), 8, 0.2)).to(cuda)
    wq = cv.prepare_convt2x2(k, torch.from_numpy(_mk((f,), 9)).to(cuda), quant="static",
                             in_scale=torch.tensor(0.013, device=cuda),
                             out_scale=torch.tensor(0.037, device=cuda))
    before = cv.convt2x2_static.launches
    got = cv.convt2x2_prepared(x, wq)
    assert cv.convt2x2_static.launches == before + 1
    assert torch.equal(got, cv.convt2x2_prepared_plain(x, wq))


@pytest.mark.cuda
def test_int8_renderer_on_card_matches_cpu(cuda):
    """Static and dyn Renderers on the card against the same on the CPU:
    raster, mask and depth bit for bit, rgb_f within max 0.10 / mean 0.02 of
    the range (the bf16 input conv's f32 sums may flip a code, and the
    calibration reads the bf16 net), through the int8 kernels."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=3, extent=6.0)
    cam = Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48)
    E = np.eye(4)
    E[2, 3] = 8.0
    v = init_unet_numpy(1, (16, 32))
    for mode, counter in (("static", cv.conv3x3_static), ("dyn", cv.conv3x3_dyn)):
        cfg = RenderConfig(unet_features=(16, 32), pyramid_levels=2, unet_int8=mode)
        out = {}
        for dev in ("cuda", "cpu"):
            r = Renderer(scene, cfg, v, cull_budget="auto", device=dev)
            r.unet.quant_min_f = 1
            before = counter.launches
            out[dev] = r.compute_full(cam, E)
            if dev == "cuda":
                assert counter.launches > before
        for k in ("raw_rgb", "raw_depth", "mask", "depth"):
            np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k])
        d = np.abs(out["cuda"]["rgb_f"] - out["cpu"]["rgb_f"])
        scale = max(1e-6, float(np.abs(out["cpu"]["rgb_f"]).max()))
        assert d.max() <= 0.10 * scale and d.mean() <= 0.02 * scale


def _dense_cloud(n, w, h, seed, integer):
    rng = np.random.default_rng(seed)
    px, py = rng.integers(0, w, n), rng.integers(0, h // 4, n)
    z = np.where(rng.random(n) < 0.5, rng.uniform(4.0, 4.04, n), rng.uniform(2.0, 8.0, n))
    pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)) if integer else rng.uniform(0, 255, (n, 3))
    M = Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4)).astype(np.float32)
    return pts, cols.astype(np.float32), M


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
def test_winners_f32_and_float_expand_match_twins(cuda, integer):
    """K5 + K2 float_sums, bit for bit: against the twin on the card
    (integer colours; its f64 atomics cannot round), and against the twin
    on the CPU, which adds in the kernel's stream order (float colours)."""
    w, h, n = 96, 64, 50_000
    pts, cols, M = _dense_cloud(n, w, h, 12, integer)
    t = lambda a: torch.from_numpy(a).to(cuda)
    sd, _ = tr.project_and_sort_diff(t(pts), t(cols), t(M), width=w, height=h)
    wimg, total = rr.winners_f32(sd, w * h, 0.02)
    twin_dev = "cuda" if integer else "cpu"
    sd_twin = tr.SortedDiff(*(x.to(twin_dev) for x in sd))
    wimg_p, total_p = rr.winners_f32_plain(sd_twin, w * h, 0.02)
    k = int(total_p[0])
    assert int(total[0]) == k and torch.equal(wimg[:, :k].cpu(), wimg_p[:, :k].cpu())
    got = rr.expand_winners(wimg, total, w * h, float_sums=True)
    want = rr.expand_plain(wimg, total, w * h, False, float_sums=True)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), x.view(torch.int32))


@pytest.mark.cuda
def test_diff_raster_on_card_matches_cpu(cuda):
    """Forward bit for bit, colour and point gradients exactly, cam_proj
    within rtol 1e-5 (``gz @ pts`` sums in another order)."""
    w, h = 96, 64
    pts, cols, M = _dense_cloud(30_000, w, h, 13, integer=False)
    g = np.random.default_rng(14).normal(size=(h, w, 3)).astype(np.float32)

    def run(dev):
        P, C, MM = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in (pts, cols, M))
        o = td.rasterize_diff(P, C, MM, width=w, height=h)
        loss = (torch.sum(o.rgb * torch.from_numpy(g).to(dev))
                + 1e-6 * torch.sum(torch.where(o.mask, o.depth, 0.0)))
        loss.backward()
        return [x.detach().cpu() for x in o] + [P.grad.cpu(), C.grad.cpu(), MM.grad.cpu()]

    counts = lambda: (rr.raster_images_diff.launches, rr.winners_f32.launches,
                      rr.expand_winners.launches)
    before = counts()
    card, cpu = run(cuda), run("cpu")
    assert counts() == (before[0] + 1,) + before[1:]
    for a, b in zip(card[:6], cpu[:6]):
        assert torch.equal(a, b)
    torch.testing.assert_close(card[6], cpu[6], rtol=1e-5, atol=1e-5 * float(cpu[6].abs().max()))


def _diff_stream(pix, z, cols, hw):
    """The differentiable forward's stream (culled points: sentinel hw, +inf
    depth), sorted by (pixel, depth bits), on the CPU."""
    pix = np.asarray(pix, np.int64)
    ok = pix < hw
    pix = np.where(ok, pix, hw).astype(np.int32)
    zb = np.where(ok, np.asarray(z, np.float32), np.float32(np.inf)).view(np.int32)
    order = np.lexsort((zb, pix))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[order]))
    return tr.SortedDiff(t(pix), t(zb), t(np.asarray(cols, np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "one_pixel_20000", "inf_depths", "all_culled",
                                  "empty", "ragged"])
@pytest.mark.parametrize("integer", [True, False])
def test_resolve_diff_matches_twin_and_old_pair(cuda, case, integer):
    """rtnr_resolve_diff bit for bit against the old pair (K5 + K2
    float_sums) on the card, against its twin on the CPU (stream order, any
    colours) and on the card (integer colours, where the twin's atomics are
    exact), two launches equal, one launch a call and no K5 or K2; also from
    a stream offset by one element (no 16-byte loads)."""
    rng = np.random.default_rng(90)
    hw, n = 96 * 64, 50_000
    z = np.where(rng.random(n) < 0.5, rng.uniform(4.0, 4.04, n), rng.uniform(2.0, 8.0, n))
    pix = rng.integers(0, hw + 500, n)
    if case == "one_pixel_20000":
        pix, z = np.r_[np.full(20_000, 1000), pix[:3000]], np.r_[rng.uniform(2.0, 2.3, 20_000),
                                                                 z[:3000]]
    elif case == "inf_depths":
        z[rng.random(n) < 0.3] = np.inf
    elif case == "all_culled":
        pix = np.full(n, hw)
    elif case == "empty":
        pix, z = pix[:0], z[:0]
    elif case == "ragged":
        hw = 3 * 512 + 517
        pix = rng.integers(0, hw + 40, n)
    m = len(pix)
    cols = rng.integers(0, 256, (m, 3)) if integer else rng.uniform(-40.0, 300.0, (m, 3))
    sd_cpu = _diff_stream(pix, z, cols, hw)
    sd = tr.SortedDiff(*(x.to(cuda) for x in sd_cpu))
    counts = lambda: (rr.raster_images_diff.launches, rr.winners_f32.launches,
                      rr.expand_winners.launches)
    before = counts()
    got = rr.raster_images_diff(sd, hw, 0.02)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1,) + before[1:]
    assert all(g.dtype == torch.float32 for g in got)
    assert same_bits(got, rr.expand_winners(*rr.winners_f32(sd, hw, 0.02), hw, float_sums=True))
    assert same_bits([g.cpu() for g in got], rr.raster_images_diff_plain(sd_cpu, hw, 0.02))
    if integer:
        assert same_bits(got, rr.raster_images_diff_plain(sd, hw, 0.02))
    assert same_bits(rr.raster_images_diff(sd, hw, 0.02), got)
    if m > 1:
        off = tr.SortedDiff(*(torch.cat([x[:1], x])[1:] for x in sd))
        assert same_bits(rr.raster_images_diff(off, hw, 0.02), got)
    if case == "one_pixel_20000":
        assert float(got[1][1000]) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "one_pixel_20000", "all_culled", "ragged"])
@pytest.mark.parametrize("integer", [True, False])
def test_band_ref_forms_match_twins(cuda, case, integer):
    """The band-reference forms (``band_ref=``: rtnr_resolve4's sums form,
    rtnr_resolve_diff) on one of two point shards against their twins on
    the CPU and, for integer colours, on the card. The reference is the
    shards' merged z-buffer, moved below the local head at a tenth of the
    pixels (those get zero rows) and to FLT_MAX at another tenth; the depth
    output stays the local head's; each call counts one launch of each
    counter; the packed form refuses a reference."""
    rng = np.random.default_rng(91)
    hw, n = 96 * 64, 50_000
    z = np.where(rng.random(n) < 0.5, rng.uniform(4.0, 4.04, n), rng.uniform(2.0, 8.0, n))
    pix = rng.integers(0, hw + 500, n)
    if case == "one_pixel_20000":
        pix, z = np.r_[np.full(20_000, 1000), pix[:3000]], np.r_[rng.uniform(2.0, 2.3, 20_000),
                                                                 z[:3000]]
    elif case == "all_culled":
        pix = np.full(n, hw)
    elif case == "ragged":
        hw = 3 * 512 + 517
        pix = rng.integers(0, hw + 40, n)
    m = len(pix)
    cols = rng.integers(0, 256, (m, 3)) if integer else rng.uniform(-40.0, 300.0, (m, 3))
    shard = rng.random(m) < 0.5
    mine = _diff_stream(pix[shard], z[shard], cols[shard], hw)
    other = _diff_stream(pix[~shard], z[~shard], cols[~shard], hw)
    heads = [rr.raster_images_diff_plain(s, hw, 0.02)[2] for s in (mine, other)]
    ref = torch.minimum(*heads)
    move = rng.random(hw)
    ref = torch.where(torch.from_numpy(move < 0.1), ref - 0.5, ref)
    ref = torch.where(torch.from_numpy(move > 0.9), torch.full_like(ref, 3.4028234663852886e38),
                      ref).contiguous()
    ref_c = ref.to(cuda)
    sd = tr.SortedDiff(*(x.to(cuda) for x in mine))
    before = (rr.raster_images_diff.launches, rr.raster_images_diff.band_ref_launches)
    got = rr.raster_images_diff(sd, hw, 0.02, band_ref=ref_c)
    assert (rr.raster_images_diff.launches, rr.raster_images_diff.band_ref_launches) == (
        before[0] + 1, before[1] + 1)
    assert same_bits([g.cpu() for g in got],
                      rr.raster_images_diff_plain(mine, hw, 0.02, band_ref=ref))
    if integer:
        assert same_bits(got, rr.raster_images_diff_plain(sd, hw, 0.02, band_ref=ref_c))
    assert torch.equal(got[2].cpu().view(torch.int32), heads[0].view(torch.int32))
    # the serving stream's sums form: 8-bit colours packed in one int32, in
    # _diff_stream's order
    c8 = rng.integers(0, 256, (int(shard.sum()), 3))
    packed = (c8[:, 0] | (c8[:, 1] << 8) | (c8[:, 2] << 16)).astype(np.int32)
    ps = np.asarray(pix[shard], np.int64)
    ps = np.where(ps < hw, ps, hw)
    zb = np.where(ps < hw, np.asarray(z[shard], np.float32), np.float32(np.inf)).view(np.int32)
    sp_cpu = tr.SortedPoints(mine.pix, mine.zbits,
                             torch.from_numpy(packed[np.lexsort((zb, ps))]))
    sp = tr.SortedPoints(*(x.to(cuda) for x in sp_cpu))
    before = (rr.raster_images_v4.launches, rr.raster_images_v4.band_ref_launches)
    got4 = rr.raster_images_v4(sp, hw, 0.02, band_ref=ref_c)
    assert (rr.raster_images_v4.launches, rr.raster_images_v4.band_ref_launches) == (
        before[0] + 1, before[1] + 1)
    assert same_bits([g.cpu() for g in got4],
                      rr.raster_images_v4_plain(sp_cpu, hw, 0.02, band_ref=ref))
    assert same_bits(got4, rr.raster_images_v4_plain(sp, hw, 0.02, band_ref=ref_c))
    with pytest.raises(ValueError, match="sums form"):
        rr.raster_images_v4(sp, hw, 0.02, packed_out=True, band_ref=ref_c)


def _resolver_cloud(cuda, n, w, h, seed, one_pixel=0):
    """A dense cloud of ``n`` points at odd sizes, plus ``one_pixel`` points
    on the centre pixel in unsorted depth (a partial band)."""
    rng = np.random.default_rng(seed)
    px, py = rng.integers(0, w, n), rng.integers(0, h // 4, n)
    z = rng.uniform(2.0, 8.0, n)
    pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1)
    zc = rng.uniform(2.0, 2.3, one_pixel)
    pts = np.concatenate([pts, np.stack([np.zeros(one_pixel), np.zeros(one_pixel), zc], 1)])
    cols = rng.integers(0, 256, (n + one_pixel, 3))
    cols[: n // 50] = 0  # black points
    M = Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    return t(pts), t(cols), t(M)


@pytest.mark.cuda
@pytest.mark.parametrize("n,one_pixel", [(1, 0), (50_000, 0), (3_000, 20_000)])
def test_winners5_and_carrier_kernels_match_twins(cuda, n, one_pixel):
    """K6 and the carrier kernel against their twins bit for bit at odd
    image sizes, and their dense images against K1+K2's; the 20,000-point
    one-pixel segment is far beyond the TPU kernel's lookback."""
    w, h = 97, 61
    hw = w * h
    pts, cols, M = _resolver_cloud(cuda, n, w, h, 21, one_pixel)
    kw = dict(width=w, height=h)
    ref = rr.raster_images_v4(tr.project_and_sort(pts, cols, M, **kw), hw, 0.02)
    sp5 = tr.project_and_sort(pts, cols, M, depth_key=False, **kw)
    before = (rr.winners.launches, r5.winners5.launches)
    wimg, total = r5.winners5(sp5, hw, 0.02)
    assert (rr.winners.launches, r5.winners5.launches) == (before[0], before[1] + 1)
    wimg_p, total_p = r5.winners5_plain(sp5, hw, 0.02)
    k = int(total_p[0])
    assert int(total[0]) == k and torch.equal(wimg[:, :k], wimg_p[:, :k])
    assert same_bits(rr.expand_winners(wimg, total, hw), ref)
    counts = lambda: (r5.raster_images_v5.launches, r5.winners5.launches,
                      rr.expand_winners.launches, rr.raster_images_v4.launches)
    before = counts()
    assert same_bits(r5.raster_images_v5(sp5, hw, 0.02), ref)
    assert counts() == (before[0] + 1,) + before[1:]
    if one_pixel:
        assert int(ref[1].max()) >= 1000
    spc = tr.project_and_sort(pts, cols, M, carriers=True, **kw)
    before = rc.resolve_carriers.launches
    got = rc.resolve_carriers(spc, hw, 0.02)
    assert rc.resolve_carriers.launches == before + 1
    assert same_bits(got, rc.resolve_carriers_plain(spc, hw, 0.02))
    assert same_bits(got, ref)
    rgb_s, d_s = tr.rasterize_scatter(pts, cols, M, **kw)
    rgb, d = tr.rasterize(pts, cols, M, **kw)
    assert torch.equal(rgb_s, rgb) and same_bits((d_s,), (d,))


def _stream5(cuda, pix, z, cols, hw):
    """A pixel-only-sorted stream on the card (culled points: sentinel hw,
    +inf depth), the given order kept inside a pixel."""
    pix = np.asarray(pix, np.int64)
    ok = pix < hw
    zb = np.where(ok, np.asarray(z, np.float32), np.float32(np.inf)).astype(np.float32)
    cols = np.asarray(cols, np.int64)
    packed = cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)
    order = np.argsort(np.where(ok, pix, hw), kind="stable")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[order]).astype(np.int32)).to(cuda)
    return tr.SortedPoints(pix=t(np.where(ok, pix, hw)), zbits=t(zb.view(np.int32)),
                           packed=t(packed))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_pixel_5000", "min_last", "empty", "all_culled",
                                  "ragged"])
def test_resolve5_matches_twin_and_v4_on_edge_streams(cuda, case):
    """rtnr_resolve5 bit for bit against its twin and against rtnr_resolve4
    on the same points in (pixel, depth) order, both forms: a 5,000-point
    pixel crossing many chunks, a 5,000-point segment whose minimum is its
    last element, an empty frame, every point culled, a ragged last tile;
    also from a stream offset by one element (no 16-byte loads)."""
    rng = np.random.default_rng(7)
    hw, n = 1200, 5000
    if case == "one_pixel_5000":
        pix, z = np.r_[np.full(n, 513), rng.integers(0, hw, 700)], rng.uniform(2.0, 2.3, n + 700)
    elif case == "min_last":
        pix, z = np.full(n, 100), np.r_[rng.uniform(2.015, 2.3, n - 1), 2.0]
    elif case == "empty":
        pix, z = np.zeros(0), np.zeros(0)
    elif case == "all_culled":
        pix, z = np.full(700, hw), rng.uniform(2.0, 3.0, 700)
    else:
        hw = 3 * 512 + 517
        pix, z = rng.integers(0, hw + 40, 9000), rng.uniform(2.0, 2.05, 9000)
    sp = _stream5(cuda, pix, z, rng.integers(0, 256, (len(pix), 3)), hw)
    zb = sp.zbits.cpu().numpy()
    order = torch.from_numpy(np.lexsort((zb, sp.pix.cpu().numpy()))).to(cuda)
    sp4 = tr.SortedPoints(*(t[order].contiguous() for t in sp))
    for packed_out in (False, True):
        before = r5.raster_images_v5.launches
        got = r5.raster_images_v5(sp, hw, 0.02, packed_out=packed_out)
        assert r5.raster_images_v5.launches == before + 1
        assert same_bits(got, r5.raster_images_v5_plain(sp, hw, 0.02, packed_out))
        assert same_bits(got, rr.raster_images_v4(sp4, hw, 0.02, packed_out=packed_out))
        if len(pix) > 1:
            off = tr.SortedPoints(*(torch.cat([t[:1], t])[1:] for t in sp))
            assert same_bits(r5.raster_images_v5(off, hw, 0.02, packed_out=packed_out), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cs,bias", [(1, (64, 64), True), (2, (24,), False)])
def test_conv3x3_direct_matches_twin(cuda, n, cs, bias):
    """K10 on K3's kernel: within 2 bf16 ulp of the f32 twin's magnitude,
    one K3 launch per image."""
    xs = [torch.from_numpy(_mk((n, 24, 40, c), i)).to(cuda, torch.bfloat16)
          for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), 32), 3, 0.05)).to(cuda)
    b = torch.from_numpy(_mk((32,), 4)).to(cuda) if bias else None
    before = (conv3x3_pallas.launches, cv.conv3x3.launches)
    y = conv3x3_pallas(xs, k, b, relu=True)
    assert (conv3x3_pallas.launches, cv.conv3x3.launches) == (before[0] + n, before[1] + n)
    bb = torch.zeros(32, device=cuda) if b is None else cv._bf16_values(b)
    for i in range(n):
        (ref,) = cv.conv3x3_plain([x[i:i + 1] for x in xs], cv._bf16_values(k), bb, relu=True,
                                  dtype=torch.float32)
        assert float((y[i:i + 1].float() - ref).abs().max()) <= ulp2(ref)


@pytest.mark.cuda
def test_renderer_frames_equal_under_each_resolve(cuda, monkeypatch):
    """A Renderer frame under RTNR_RESOLVE = v5, v3 and v2 equals the v4
    frame bit for bit, through each resolver's own kernel (v4 launches
    rtnr_resolve4 once and neither K1 nor K2; v5 launches rtnr_resolve5
    once and no K1, K6, K2 or rtnr_resolve4)."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=3, extent=6.0)
    cam = Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48)
    E = np.eye(4)
    E[2, 3] = 8.0
    r = Renderer(scene, RenderConfig(unet_features=(16, 32)), init_unet_numpy(1, (16, 32)),
                 device="cuda")
    monkeypatch.setenv("RTNR_RESOLVE", "v4")
    pair = lambda: (rr.winners.launches, rr.expand_winners.launches)
    k12, v4 = pair(), rr.raster_images_v4.launches
    ref = r.compute_full(cam, E)
    assert pair() == k12 and rr.raster_images_v4.launches == v4 + 1
    for mode, own in (("v5", r5.raster_images_v5), ("v3", rc.resolve_carriers),
                      ("v2", rc.resolve_carriers)):
        monkeypatch.setenv("RTNR_RESOLVE", mode)
        k1, v4, mine = rr.winners.launches, rr.raster_images_v4.launches, own.launches
        k6, k2 = r5.winners5.launches, rr.expand_winners.launches
        out = r.compute_full(cam, E)
        assert rr.winners.launches == k1 and own.launches == mine + 1
        assert rr.raster_images_v4.launches == v4
        assert (r5.winners5.launches, rr.expand_winners.launches) == (k6, k2)
        for key in ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb"):
            assert np.array_equal(out[key], ref[key]), (mode, key)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cs,f", [((20, 36), (64,), 64), ((20, 36), (64, 64), 128),
                                     ((68, 120), (128,), 256), ((68, 120), (64, 64), 64),
                                     ((20, 36), (128, 64), 256)])
def test_conv3x3_wgmma_matches_f32_twin(cuda, hw, cs, f):
    """conv_sm90.cu at ragged shapes, one input and two: within 2 bf16 ulp
    of the f32 twin, the pool equal to the max-pool of the output bit for
    bit, the head within 2 ulp of hk/hb on the kernel's own output, two runs
    equal bit for bit, one launch counted per call."""
    h, w = hw
    xs = [torch.from_numpy(_mk((1, h, w, c), 20 + i)).to(cuda, torch.bfloat16)
          for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), f), 23, 0.05)).to(cuda)
    b = torch.from_numpy(_mk((f,), 24)).to(cuda)
    wts = cv.prepare_conv3x3(k, b, cuda)
    before = (cv.conv3x3_wgmma.launches, cv.conv3x3.launches)
    (y,) = cv.conv3x3_prepared(xs, wts, relu=True)
    assert (cv.conv3x3_wgmma.launches, cv.conv3x3.launches) == (before[0] + 1, before[1] + 1)
    (ref,) = cv.conv3x3_plain(xs, cv._bf16_values(k), cv._bf16_values(b), relu=True,
                              dtype=torch.float32)
    assert float((y.float() - ref).abs().max()) <= ulp2(ref)
    y2, pooled = cv.conv3x3_prepared(xs, wts, relu=True, pool=True)
    assert torch.equal(y2, y) and torch.equal(pooled, cv._pool2(y))
    (y3,) = cv.conv3x3_prepared(xs, wts, relu=True)
    assert torch.equal(y3, y)
    if f <= 128:
        head = cv.prepare_head(_mk((f, 3), 25, 0.2), _mk((3,), 26), cuda)
        (hout,) = cv.conv3x3_prepared(xs, wts, relu=True, head=head)
        href = torch.matmul(y.float(), head.hk.float()) + head.hb
        assert hout.shape == (1, h, w, 3)
        assert float((hout.float() - href).abs().max()) <= ulp2(href)


@pytest.mark.cuda
def test_conv3x3_wgmma_counts_only_routed_calls(cuda):
    """The 5-channel conv takes conv_in_sm90.cu, not conv_sm90.cu; a
    64-channel one takes conv_sm90.cu; conv3x3.launches counts both."""
    x5 = torch.from_numpy(_mk((1, 16, 32, 5), 30)).to(cuda, torch.bfloat16)
    x64 = torch.from_numpy(_mk((1, 16, 32, 64), 31)).to(cuda, torch.bfloat16)
    n, m = cv.conv3x3_wgmma.launches, cv.conv3x3.launches
    cv.conv3x3([x5], _mk((3, 3, 5, 64), 32, 0.1), relu=True)
    assert (cv.conv3x3_wgmma.launches, cv.conv3x3.launches) == (n, m + 1)
    cv.conv3x3([x64], _mk((3, 3, 64, 64), 33, 0.05), relu=True)
    assert (cv.conv3x3_wgmma.launches, cv.conv3x3.launches) == (n + 1, m + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1, 1), (3, 37), (17, 130), (4, 1921), (64, 1920)])
@pytest.mark.parametrize("c", [1, 3, 5, 8])
@pytest.mark.parametrize("out_i8", [False, True])
def test_conv3x3_in_matches_its_twin(cuda, hw, c, out_i8):
    """The input conv on conv_in_sm90.cu (tiles of 128 pixels; W = 1921
    leaves a one-pixel tile) against its walk twin: bf16 out within 2 bf16
    ulp of the output's magnitude, int8 out within 1 code on at most 0.1%
    of the elements (at least one): f32 sums in the tensor cores' order.
    Two runs equal; conv3x3_in and the mode's counter move by one."""
    h, w = hw
    x = torch.from_numpy(_mk((1, h, w, c), 60 + c)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_mk((3, 3, c, 64), 70 + c, 0.3)).to(cuda)
    b = torch.from_numpy(_mk((64,), 80 + c, 0.5)).to(cuda)
    wq = cv.prepare_conv3x3(k, b, out_scale=torch.tensor(0.02, device=cuda) if out_i8 else None)
    assert cv.k3_route([c], wq) == "conv_in_sm90"
    mode = cv.conv3x3_i8out if out_i8 else cv.conv3x3
    before = (cv.conv3x3_in.launches, mode.launches)
    (got,) = cv.conv3x3_prepared([x], wq, relu=True)
    torch.cuda.synchronize()
    assert (cv.conv3x3_in.launches, mode.launches) == (before[0] + 1, before[1] + 1)
    (want,) = cv.conv3x3_in_plain([x], wq, relu=True)
    assert got.dtype == want.dtype and got.shape == (1, h, w, 64)
    if out_i8:
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= max(1, d.numel() // 1000)
    else:
        assert float((got.float() - want.float()).abs().max()) <= ulp2(want.float())
    assert torch.equal(cv.conv3x3_prepared([x], wq, relu=True)[0], got)


@pytest.mark.cuda
def test_conv3x3_in_refuses_a_misaligned_input(cuda):
    flat = torch.zeros(1 + 4 * 40 * 5, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(1, 4, 40, 5)  # contiguous, 2 bytes past a 16-byte boundary
    wq = cv.prepare_conv3x3(_mk((3, 3, 5, 64), 90, 0.1), None, cuda)
    with pytest.raises(ValueError, match="aligned"):
        cv.conv3x3_prepared([x], wq, relu=True)


def _up_inputs(cuda, h, w, cs, cd, f, seed=40):
    skip = torch.from_numpy(_mk((1, h, w, cs), seed)).to(cuda, torch.bfloat16)
    deep = torch.from_numpy(_mk((1, h // 2, w // 2, cd), seed + 1)).to(cuda, torch.bfloat16)
    wts = cv.prepare_conv3x3(_mk((3, 3, cs + f, f), seed + 2, 0.05), _mk((f,), seed + 3), cuda)
    up = cv.prepare_convt2x2(_mk((2, 2, cd, f), seed + 4, 0.1), _mk((f,), seed + 5), cuda)
    return skip, deep, wts, up


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cs,cd,f", [((14, 18), 64, 128, 64), ((14, 18), 128, 256, 128),
                                        ((34, 50), 64, 128, 64), ((34, 50), 128, 256, 128),
                                        ((16, 32), 192, 64, 64)])
def test_conv3x3_up_matches_f32_twin(cuda, hw, cs, cd, f):
    """The fused-ConvTranspose kernel at ragged H and W (2*7 x 2*9, 2*17 x
    2*25): within 2 bf16 ulp of the f32 twin (the up values rounded to bf16
    once, as the contract has it), bit-equal to the card's K4 + K3 pair (its
    summation order is the pair's), two runs equal bit for bit, one launch
    counted on its own counter and none on K3's or K4's."""
    h, w = hw
    skip, deep, wts, up = _up_inputs(cuda, h, w, cs, cd, f)
    assert cv.takes_up(cs, cd, f, f)
    before = (cv.conv3x3_up.launches, cv.conv3x3.launches, cv.convt2x2.launches)
    (y,) = cv.conv3x3_prepared([skip, deep], wts, relu=True, up=up)
    torch.cuda.synchronize()
    assert (cv.conv3x3_up.launches, cv.conv3x3.launches, cv.convt2x2.launches) == (
        before[0] + 1, before[1], before[2])
    up_ref = cv.convt2x2_prepared_plain(deep, up)
    kern = wts.wmat[:9 * (cs + f)].float().reshape(3, 3, cs + f, f)
    (ref,) = cv.conv3x3_plain([skip, up_ref], kern, wts.bias, relu=True, dtype=torch.float32)
    assert y.shape == (1, h, w, f)
    assert float((y.float() - ref).abs().max()) <= ulp2(ref)
    (y2,) = cv.conv3x3_prepared([skip, deep], wts, relu=True, up=up)
    assert torch.equal(y2, y)
    (pair,) = cv.conv3x3_prepared([skip, cv.convt2x2_prepared(deep, up)], wts, relu=True)
    assert torch.equal(y, pair)


@pytest.mark.cuda
def test_conv3x3_up_unfused_route_runs_the_card_pair(cuda):
    """A shape the fused kernel does not take (F = 32) runs K4 then K3 on
    the card, each counted as itself, bit-equal to calling them in turn."""
    skip, deep, wts, up = _up_inputs(cuda, 12, 20, 32, 64, 32)
    before = (cv.conv3x3_up.launches, cv.conv3x3.launches, cv.convt2x2.launches)
    (y,) = cv.conv3x3_prepared([skip, deep], wts, relu=True, up=up)
    assert (cv.conv3x3_up.launches, cv.conv3x3.launches, cv.convt2x2.launches) == (
        before[0], before[1] + 1, before[2] + 1)
    (want,) = cv.conv3x3_prepared([skip, cv.convt2x2_prepared(deep, up)], wts, relu=True)
    assert torch.equal(y, want)


def _dyn_case(cuda, hw, cs, f, seed=60, zero_patch=False):
    h, w = hw
    xs = [torch.from_numpy(_mk((1, h, w, c), seed + i)).to(cuda, torch.bfloat16)
          for i, c in enumerate(cs)]
    if zero_patch:  # pixels whose 3x3 field is all zero: amax 0, rinv 0
        for x in xs:
            x[:, 2:9, 3:12] = 0
    k = torch.from_numpy(_mk((3, 3, sum(cs), f), seed + 5, 0.1)).to(cuda)
    b = torch.from_numpy(_mk((f,), seed + 6)).to(cuda)
    return xs, cv.prepare_conv3x3(k, b, quant="dyn")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cs,f,pool", [((20, 36), (64,), 256, True),
                                          ((17, 30), (64, 64), 256, False),
                                          ((20, 40), (128,), 512, True),
                                          ((68, 120), (64, 128), 256, True),
                                          ((12, 24), (256,), 1024, False)])
def test_conv3x3_dyn_wgmma_matches_twin_and_conv_cu(cuda, hw, cs, f, pool):
    """conv_i8_sm90.cu's dyn kernel at ragged shapes (H % 8, W % 16 not 0),
    one input and two, with the pool: equal bit for bit to its twin and to
    conv.cu's gemm<0,2>; two runs equal; its counter and conv3x3_dyn move,
    and the conv.cu call moves only conv3x3_dyn."""
    xs, wq = _dyn_case(cuda, hw, cs, f)
    assert cv.takes_dyn_wgmma(cs, f) and wq.wmat_t is not None
    before = (cv.conv3x3_dyn_wgmma.launches, cv.conv3x3_dyn.launches)
    got = cv.conv3x3_prepared(xs, wq, relu=True, pool=pool)
    torch.cuda.synchronize()
    assert (cv.conv3x3_dyn_wgmma.launches, cv.conv3x3_dyn.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=pool)
    old = cv._conv3x3_gemm(xs, wq, relu=True, pool=pool, head=None)
    assert (cv.conv3x3_dyn_wgmma.launches, cv.conv3x3_dyn.launches) == (before[0] + 1,
                                                                         before[1] + 2)
    assert len(got) == len(want) == (2 if pool else 1)
    for g, r, o in zip(got, want, old):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r) and torch.equal(g, o)
    again = cv.conv3x3_prepared(xs, wq, relu=True, pool=pool)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
def test_conv3x3_dyn_wgmma_zero_patch(cuda):
    """Output pixels whose receptive field is all zero (rinv = 0) quantise
    to zero codes and give the bias, as the twin and conv.cu do."""
    xs, wq = _dyn_case(cuda, (20, 36), (64, 64), 256, seed=70, zero_patch=True)
    (got,) = cv.conv3x3_prepared(xs, wq, relu=False)
    (want,) = cv.conv3x3_prepared_plain(xs, wq, relu=False)
    (old,) = cv._conv3x3_gemm(xs, wq, relu=False, pool=False, head=None)
    assert torch.equal(got, want) and torch.equal(got, old)
    assert torch.equal(got[0, 4, 6], wq.bias.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,hw", [(64, 64, (17, 30)), (128, 64, (20, 36)),
                                    (256, 128, (9, 13)), (512, 256, (7, 11)),
                                    (1024, 512, (5, 9))])
def test_convt2x2_i8_wgmma_matches_twin_and_conv_cu(cuda, c, f, hw):
    """conv_i8_sm90.cu's static K4 at H*W not a multiple of the 128-pixel
    tile: equal bit for bit to its twin and to conv.cu's gemm<1,1>; two runs
    equal; its counter and convt2x2_static move, the conv.cu call only the
    latter."""
    h, w = hw
    x = _codes((1, h, w, c), 80).to(cuda)
    wq = cv.prepare_convt2x2(torch.from_numpy(_mk((2, 2, c, f), 81, 0.2)).to(cuda),
                             torch.from_numpy(_mk((f,), 82)).to(cuda), quant="static",
                             in_scale=torch.tensor(0.013, device=cuda),
                             out_scale=torch.tensor(0.037, device=cuda))
    assert cv.takes_convt_i8_wgmma(c, f) and wq.wmat_t is not None
    before = (cv.convt2x2_static_wgmma.launches, cv.convt2x2_static.launches)
    got = cv.convt2x2_prepared(x, wq)
    torch.cuda.synchronize()
    assert (cv.convt2x2_static_wgmma.launches, cv.convt2x2_static.launches) == (
        before[0] + 1, before[1] + 1)
    old = cv._convt2x2_gemm(x, wq)
    assert (cv.convt2x2_static_wgmma.launches, cv.convt2x2_static.launches) == (
        before[0] + 1, before[1] + 2)
    assert got.dtype == torch.int8 and got.shape == (1, 2 * h, 2 * w, f)
    assert torch.equal(got, cv.convt2x2_prepared_plain(x, wq)) and torch.equal(got, old)
    assert torch.equal(cv.convt2x2_prepared(x, wq), got)


@pytest.mark.cuda
def test_int8_wgmma_counters_only_move_on_routed_calls(cuda):
    """A dyn conv with F = 64 and a static K4 with F = 16 stay on conv.cu."""
    xs, wq = _dyn_case(cuda, (8, 16), (64,), 64)
    n = (cv.conv3x3_dyn_wgmma.launches, cv.conv3x3_dyn.launches)
    cv.conv3x3_prepared(xs, wq, relu=True)
    assert (cv.conv3x3_dyn_wgmma.launches, cv.conv3x3_dyn.launches) == (n[0], n[1] + 1)
    x = _codes((1, 4, 6, 32), 90).to(cuda)
    wt = cv.prepare_convt2x2(torch.from_numpy(_mk((2, 2, 32, 16), 91, 0.2)).to(cuda), None,
                             quant="static", in_scale=torch.tensor(0.02, device=cuda),
                             out_scale=torch.tensor(0.05, device=cuda))
    m = (cv.convt2x2_static_wgmma.launches, cv.convt2x2_static.launches)
    cv.convt2x2_prepared(x, wt)
    assert (cv.convt2x2_static_wgmma.launches, cv.convt2x2_static.launches) == (m[0], m[1] + 1)


def _static_case(cuda, hw, cs, f, *, out_i8=True, head=False, seed=100):
    h, w = hw
    xs = [_codes((1, h, w, c), seed + i, 0).to(cuda) for i, c in enumerate(cs)]
    k = torch.from_numpy(_mk((3, 3, sum(cs), f), seed + 5, 0.1)).to(cuda)
    b = torch.from_numpy(_mk((f,), seed + 6, 0.5)).to(cuda)
    scales = [torch.tensor(v, device=cuda) for v in (0.031, 0.047)][: len(cs)]
    wq = cv.prepare_conv3x3(k, b, quant="static", in_scales=scales, c0=cs[0],
                            out_scale=torch.tensor(0.09, device=cuda) if out_i8 else None)
    hd = (cv.prepare_head(_mk((f, 3), seed + 7, 0.2), _mk((3,), seed + 8), cuda)
          if head else None)
    return xs, wq, hd


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cs,f,pool,out_i8", [
    ((20, 36), (64,), 64, True, True),
    ((17, 30), (64, 64), 64, False, True),
    ((20, 36), (64,), 64, True, False),  # bf16 output, pooled
    ((20, 36), (64,), 128, True, True),
    ((17, 30), (128, 64), 128, False, True),
    ((68, 120), (128,), 256, True, True),
    ((68, 120), (256, 256), 256, False, True),
    ((20, 36), (64,), 256, True, False),
    ((12, 24), (512,), 512, True, True),
    ((12, 24), (512,), 1024, False, True),
    ((18, 30), (64,), 192, True, True),
    ((8, 16), (64,), 64, True, True),  # one tile: the second consumer has none
])
def test_conv3x3_static_wgmma_matches_twin_and_conv_cu(cuda, hw, cs, f, pool, out_i8):
    """conv_i8_sm90.cu's static kernel at ragged shapes (H, W % 16 not 0),
    one input and two, with the pool, int8 and bf16 output, odd and even
    tile counts a block: equal bit for bit to its twin and to conv.cu's
    gemm<0,1>; two runs equal; its counter and conv3x3_static move, the
    conv.cu call only the latter."""
    xs, wq, _ = _static_case(cuda, hw, cs, f, out_i8=out_i8)
    assert cv.takes_static_wgmma(cs, f) and wq.wmat_t is not None
    before = (cv.conv3x3_static_wgmma.launches, cv.conv3x3_static.launches)
    got = cv.conv3x3_prepared(xs, wq, relu=True, pool=pool)
    torch.cuda.synchronize()
    assert (cv.conv3x3_static_wgmma.launches, cv.conv3x3_static.launches) == (
        before[0] + 1, before[1] + 1)
    want = cv.conv3x3_prepared_plain(xs, wq, relu=True, pool=pool)
    old = cv._conv3x3_gemm(xs, wq, relu=True, pool=pool, head=None)
    assert (cv.conv3x3_static_wgmma.launches, cv.conv3x3_static.launches) == (
        before[0] + 1, before[1] + 2)
    assert len(got) == len(want) == (2 if pool else 1)
    for g, r, o in zip(got, want, old):
        assert g.dtype == (torch.int8 if out_i8 else torch.bfloat16)
        assert torch.equal(g, r) and torch.equal(g, o)
    again = cv.conv3x3_prepared(xs, wq, relu=True, pool=pool)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cs", [((20, 36), (64,)), ((17, 30), (64, 64)),
                                   ((68, 120), (64,))])
def test_conv3x3_static_wgmma_head(cuda, hw, cs):
    """The head conv (bf16 output, F = 64, the 1x1 head fused): the head
    within 2 bf16 ulp of hk/hb on the kernel's bf16 conv output, which
    equals the twin's bit for bit; two runs equal."""
    xs, wq, hd = _static_case(cuda, hw, cs, 64, out_i8=False, head=True, seed=110)
    n = cv.conv3x3_static_wgmma.launches
    (y,) = cv.conv3x3_prepared(xs, wq, relu=True)
    (hout,) = cv.conv3x3_prepared(xs, wq, relu=True, head=hd)
    assert cv.conv3x3_static_wgmma.launches == n + 2
    assert torch.equal(y, cv.conv3x3_prepared_plain(xs, wq, relu=True)[0])
    href = torch.matmul(y.float(), hd.hk.float()) + hd.hb
    assert hout.shape == (1,) + hw + (3,)
    assert float((hout.float() - href).abs().max()) <= ulp2(href)
    assert torch.equal(cv.conv3x3_prepared(xs, wq, relu=True, head=hd)[0], hout)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,hw", [(1024, 512, (5, 9)), (512, 256, (7, 11)),
                                    (256, 128, (9, 13)), (128, 64, (17, 30)),
                                    (64, 192, (3, 50))])
def test_convt2x2_wgmma_matches_f32_twin(cuda, c, f, hw):
    """conv_sm90.cu's bf16 K4 at every (C, F) of the full-width net, H*W not
    a multiple of the 128-pixel tile: within 2 bf16 ulp of the f32 twin; two
    runs equal; its counter and convt2x2 move, the conv.cu call only the
    latter."""
    h, w = hw
    x = torch.from_numpy(_mk((1, h, w, c), 120)).to(cuda, torch.bfloat16)
    k = torch.from_numpy(_mk((2, 2, c, f), 121, 0.05)).to(cuda)
    b = torch.from_numpy(_mk((f,), 122)).to(cuda)
    wts = cv.prepare_convt2x2(k, b)
    assert cv.k4_route(c, wts) == "conv_sm90"
    before = (cv.convt2x2_wgmma.launches, cv.convt2x2.launches)
    y = cv.convt2x2_prepared(x, wts)
    torch.cuda.synchronize()
    assert (cv.convt2x2_wgmma.launches, cv.convt2x2.launches) == (before[0] + 1, before[1] + 1)
    ref = cv.convt2x2_plain(x, cv._bf16_values(k), cv._bf16_values(b), dtype=torch.float32)
    assert y.shape == (1, 2 * h, 2 * w, f) and y.dtype == torch.bfloat16
    assert float((y.float() - ref).abs().max()) <= ulp2(ref)
    old = cv._convt2x2_gemm(x, wts)
    assert (cv.convt2x2_wgmma.launches, cv.convt2x2.launches) == (before[0] + 1, before[1] + 2)
    assert float((old.float() - ref).abs().max()) <= ulp2(ref)
    assert torch.equal(cv.convt2x2_prepared(x, wts), y)


@pytest.mark.cuda
def test_new_wgmma_counters_only_move_on_routed_calls(cuda):
    """A static conv with 32 channels, a static head conv at F = 128 and a
    bf16 K4 with F = 16 stay on conv.cu: conv3x3_static / convt2x2 move,
    the new counters do not."""
    xs, wq, _ = _static_case(cuda, (8, 16), (32,), 64, seed=130)
    xh, wh, hd = _static_case(cuda, (8, 16), (64,), 128, out_i8=False, head=True, seed=133)
    n = (cv.conv3x3_static_wgmma.launches, cv.conv3x3_static.launches)
    cv.conv3x3_prepared(xs, wq, relu=True)
    (hout,) = cv.conv3x3_prepared(xh, wh, relu=True, head=hd)
    assert (cv.conv3x3_static_wgmma.launches, cv.conv3x3_static.launches) == (n[0], n[1] + 2)
    (y,) = cv.conv3x3_prepared_plain(xh, wh, relu=True)
    href = torch.matmul(y.float(), hd.hk.float()) + hd.hb
    assert float((hout.float() - href).abs().max()) <= ulp2(href)
    x = torch.from_numpy(_mk((1, 4, 6, 32), 131)).to(cuda, torch.bfloat16)
    wt = cv.prepare_convt2x2(torch.from_numpy(_mk((2, 2, 32, 16), 132, 0.2)).to(cuda), None)
    m = (cv.convt2x2_wgmma.launches, cv.convt2x2.launches)
    cv.convt2x2_prepared(x, wt)
    assert (cv.convt2x2_wgmma.launches, cv.convt2x2.launches) == (m[0], m[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "static", "dyn"])
def test_unet_batch_on_card_equals_single_frames(cuda, mode):
    """A batch of 2 through ``UNet.forward`` on the Hopper kernels (features
    (64, 128): the wgmma routes and the input conv) gives the two
    single-frame outputs bit for bit, in each mode."""
    from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
    from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales

    feats = (64, 128)
    state = from_flax_variables(init_unet_numpy(3, feats))
    x = torch.from_numpy(_mk((2, 64, 128, 5), 5)).to(cuda)
    net = UNet(state, features=feats, quant_int8=mode != "bf16").to(cuda)
    scales = None
    if mode == "static":
        scales = calibrate_act_scales(UNet(state, features=feats).to(cuda), x)
    if mode == "dyn":
        net.quant_min_f = 64
    before = cv.conv3x3_in.launches
    got = net(x, act_scales=scales)
    assert cv.conv3x3_in.launches == before + 2
    assert got.shape == (2, 64, 128, 3)
    for i in range(2):
        assert torch.equal(got[i:i + 1], net(x[i:i + 1], act_scales=scales)), i


@pytest.mark.cuda
def test_render_cli_full_stage_on_card(cuda, tmp_path, capsys):
    """``apps.render_trajectory`` on the card: the full stage's PNGs are
    ``write_png`` of the card Renderer's ``compute_full`` frames."""
    from rtnr_tpu_torch.apps.render_trajectory import main
    from rtnr_tpu_torch.camera import Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import save_msgpack
    from rtnr_tpu_torch.utils.image import write_png

    scene = Scene.synthetic(20_000, seed=3, extent=6.0)
    write_ply(tmp_path / "c.ply", scene.points, scene.colors)
    Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48, (0, 0, 0, 0, 0)).save_calibration(
        tmp_path / "calib.txt")
    (tmp_path / "t.txt").write_text("0 0 0 -8 0 0 0 1\n1 0.2 0 -8 0 0 0 1\n")
    raw = init_unet_numpy(1, (16, 32))
    save_msgpack(tmp_path / "u.msgpack", raw)
    argv = [str(tmp_path / f) for f in ("c.ply", "t.txt", "calib.txt")] + [
        "-o", str(tmp_path / "out"), "--stage", "full", "--ckpt", str(tmp_path / "u.msgpack"),
        "--features", "16", "32", "--levels", "2", "--timings"]
    assert main(argv) == 0
    assert '"stage": "full"' in capsys.readouterr().out
    cam = Camera.load_calibration(tmp_path / "calib.txt")
    traj = Trajectory.load(tmp_path / "t.txt")
    r = Renderer(Scene.from_file(tmp_path / "c.ply"),
                 RenderConfig(unet_features=(16, 32), pyramid_levels=2), raw,
                 cull_budget="auto")
    for i in range(2):
        write_png(tmp_path / "want.png", r.compute_full(cam, traj.world_to_cam(i))["rgb"])
        assert (tmp_path / "out" / f"frame_{i + 1}.png").read_bytes() == \
            (tmp_path / "want.png").read_bytes()


# ---------------------------------------------------------------------------
# the host library on the card's machine: E57 chain and JPEG decoder
# ---------------------------------------------------------------------------

# a 38x22 4:2:0 quality-90 JPEG with restart markers, made by Pillow 12.1 on
# libjpeg-turbo 3.1.3, and the SHA-256 of Pillow's decoded RGB pixels
_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoMDAsKCwsNDhIQ"
    "DQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQU"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAARCAAWACYDASIAAhEBAxEB/8QAHwAAAQUBAQEB"
    "AQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKB"
    "kaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1"
    "dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcF"
    "BAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5"
    "OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0"
    "tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/90ABAAC/9oADAMBAAIRAxEAPwDs"
    "Lf4pwi0dPtTol0rKswuPKL/L+83MRksTGP3eVHA4yoA4bx78Q7m9guUDNLM7M4DFdhiypXPzfxB9pPfZjjhT"
    "574J0nWLuGa2nDyMs/zbAP3Q2blPlDOCRngrtHQYyAe7h+E93e203lwttlAfz1wgBIAGB2OMnB9DnPAr864e"
    "yPAYCvGVW1v6/T0P3+jl2XZNk96ju0vLWy3+X+fy+ftXTUNbuLuSWSSVTMqrG7AZjbIXkAlmCr0Bxgg/w5rs"
    "PAvw5v8AWLtJ7KKaK3VjJLvcSgA/LnORjBUgAj+EHg5K+yt8DI5DbCeISIGQ/uuQTmNgeOFAwp6jPpjmvTvA"
    "Xhu00WCKZ3t8IV2RRF9xwwJG1skYB+UcYIwc8g/1bgc7o4XAydJJKK19LX6eSv6H8TZjxdRp5zKjho3blr5d"
    "P6W6+Vj/0O00/wCE9npNq2nzQywLEV89YnJJkxkAbmGFy0pALn7+QOoBXoOgeJbC0WXMNyxlVX+zR243rgsM"
    "7MHAGNpwcDABxxkr+VeK+Icz4lzrEZlO9pS93yitI6N9rX7u76n6HluZ5i8JTcaben91fnFsxPhR4AhtrlGe"
    "3t2jmk+xPCWLKXKGTd8yngAseQeeMAFifRdW0+ysbWa5h0+3jNvbM5SMkbgGILFiDlt6O3I5yNxOTRRX6blf"
    "7zFR53fW33u35Hw+OxmIllq5pt3VtddOVO33n//R7fxh4vtNL86a3juoLDdvAgcRsX3H5tuTjDbz97sOmSB5"
    "D4r+Ml5aCV4rSC3kTb5zqgfe0YSUZBPIxnpt3HgjBwCivvMypxpcFY2tBWk401fynOEZL5qTT9T8OyLCUJ8Q"
    "Rco/af5mTovji51aF7hyZUbaQWGxz2ySpz2zjJ5JOc0UUV+CQwGFUIr2a+4/0by6hTeEpaW91badF2P/2Q==")
_JPEG_PIXELS_SHA256 = "74240828bdfc4f5bcb509c67330922657c029b57162d374319246cc6760673ef"


def test_host_library_decodes_as_libjpeg_here():
    """The host library built by this machine's g++ decodes a libjpeg-turbo
    file to the pixels Pillow decoded (a machine without Pillow can run it)."""
    import base64
    import hashlib

    from rtnr_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    px = decode_jpeg(base64.b64decode("".join(_JPEG_B64)))
    assert px.shape == (22, 38, 3)
    assert hashlib.sha256(px.tobytes()).hexdigest() == _JPEG_PIXELS_SHA256
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for sub in ("4:4:4", "4:2:0"):
        again = decode_jpeg(encode_jpeg(img, 95, sub))
        assert again.shape == img.shape


def test_host_library_e57_roundtrip_here(tmp_path):
    """The E57 container decoder built by this machine's g++ reads back the
    port's writer: float coordinates bit for bit, 0.1 mm ScaledInteger ones
    within half a step."""
    from rtnr_tpu_torch.data.e57 import read_e57
    from rtnr_tpu_torch.data.e57_write import scan_from_arrays, write_e57
    from rtnr_tpu_torch.scene import Scene

    s = Scene.synthetic(30_000, seed=9, extent=5.0)
    write_e57(tmp_path / "s.e57", [scan_from_arrays(s.points, s.colors, cartesian_scale=0.0)])
    pts, cols = read_e57(tmp_path / "s.e57")
    np.testing.assert_array_equal(pts, s.points)
    np.testing.assert_array_equal(cols, s.colors)
    write_e57(tmp_path / "q.e57", [scan_from_arrays(s.points, s.colors)])
    pts, cols = read_e57(tmp_path / "q.e57")
    assert np.abs(pts - s.points).max() <= 0.5e-4 + 1e-6
    np.testing.assert_array_equal(cols, s.colors)


@pytest.mark.cuda
def test_generate_pairs_from_e57_card_equals_cpu(cuda, tmp_path):
    """Pairs from a scanner file (two embedded photos, ScaledInteger
    coordinates) on the card equal the CPU's bit for bit."""
    from rtnr_tpu_torch.apps.generate_pairs import rotmat_to_quat
    from rtnr_tpu_torch.data.e57_write import E57Image, scan_from_arrays, write_e57
    from rtnr_tpu_torch.data.jpeg import encode_jpeg
    from rtnr_tpu_torch.data.pairs import generate_pairs_from_e57
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=7, extent=4.0)
    W, H = 128, 96
    cam = Camera.from_params(120.0, 120.0, W / 2, H / 2, W, H)
    r = Renderer(scene, device="cpu")
    images = []
    for k in range(2):
        E = np.eye(4)
        E[0, 3], E[2, 3] = 0.3 * k, 6.0
        P = np.linalg.inv(E) @ np.diag([1.0, -1.0, -1.0, 1.0])
        images.append(E57Image(
            jpeg_bytes=encode_jpeg(r.compute_rgbd(cam, E)["rgb"], 95), image_width=W,
            image_height=H, focal_length=0.05, pixel_width=0.05 / 120.0,
            pixel_height=0.05 / 120.0, principal_point_x=W / 2, principal_point_y=H / 2,
            pose=(*rotmat_to_quat(P[:3, :3]), P[0, 3], P[1, 3], P[2, 3])))
    f = tmp_path / "scan.e57"
    write_e57(f, [scan_from_arrays(scene.points, scene.colors)], images)
    got = generate_pairs_from_e57(f, cache_dir=tmp_path / "c", device="cuda")
    want = generate_pairs_from_e57(f, cache_dir=tmp_path / "c", device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("image", "depth", "proj_rgb", "world_to_cam"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=k)
        assert (g.depth < 3e38).mean() > 0.05


# ---- BatchNorm + ReLU of UNetTrain (ops/bn_train.py, csrc/bn_train.cu) ----

# (N, H, W, C): the main path's five layer shapes at 1088x1920, then a narrow
# layer (C % 8 != 0: one channel a thread), a layer wider than a block row
# (two blocks along y) and a batch of two
BN_SHAPES = {"l0": (1, 1088, 1920, 64), "l1": (1, 544, 960, 128), "l2": (1, 272, 480, 256),
             "l3": (1, 136, 240, 512), "bottleneck": (1, 68, 120, 1024),
             "c12": (1, 32, 48, 12), "c2560": (1, 8, 16, 2560), "n2": (2, 64, 96, 64)}


class _Keep:
    """A ``reduce`` that keeps what it is given: the kernels' forward sums,
    then the backward's."""

    def __init__(self):
        self.seen = []

    def __call__(self, v):
        self.seen.append(v.clone())
        return v


def _bn_inputs(cuda, dtype, shape, seed=5, misalign=False):
    n, h, w, c = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    off = torch.randn(c, generator=g, device=cuda) * 0.5
    std = torch.rand(c, generator=g, device=cuda) + 0.5
    flat = torch.empty(n * h * w * c + 1, dtype=dtype, device=cuda)
    x = flat[int(misalign):int(misalign) + n * h * w * c].view(n, h, w, c)
    x.copy_(torch.randn(shape, generator=g, device=cuda) * std + off)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    p = {"scale": torch.rand(c, generator=g, device=cuda) + 0.5,
         "bias": torch.randn(c, generator=g, device=cuda) * 0.3,
         "mean": torch.randn(c, generator=g, device=cuda) * 0.1,
         "var": torch.rand(c, generator=g, device=cuda) + 0.5}
    return x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2), p


def _bn_kernels(x, dy, p, keep=None):
    """One forward and backward on the kernels: (y, dx, dscale, dbias,
    running mean, running var, forward sums, backward sums)."""
    from rtnr_tpu_torch.ops import bn_train as bt

    keep = _Keep() if keep is None else keep
    xr = x.detach().requires_grad_(True)
    scale = p["scale"].clone().requires_grad_(True)
    bias = p["bias"].clone().requires_grad_(True)
    mean, var = p["mean"].clone(), p["var"].clone()
    y = bt.bn_relu_train(xr, scale, bias, mean, var, keep)
    y.backward(dy)
    torch.cuda.synchronize()
    return (y.detach(), xr.grad, scale.grad, bias.grad, mean, var, *keep.seen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(BN_SHAPES))
def test_bn_train_kernels_match_twins(cuda, shape, dtype):
    """The four kernels against their plain twins (``chip_smoke.bn_ok``):
    given the kernels' own sums, the output, the running statistics,
    dscale, dbias and dx are the twins' bits (the same ops in the same
    order); the sums themselves are f32 sums in the kernels' order, held to
    f64 sums within 2e-5 of the sums of magnitudes. The outputs keep x's
    dtype and shape; two identical calls give identical bits."""
    x, dy, p = _bn_inputs(cuda, dtype, BN_SHAPES[shape], misalign=shape in ("c12", "n2"))
    assert bn_ok(x, dy, p["scale"], p["bias"], p["mean"], p["var"])
    got = _bn_kernels(x, dy, p)
    y, dx = got[:2]
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    again = _bn_kernels(x, dy, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bn_train_step_runs_18_fused_layers_and_matches_the_plain_step(cuda, monkeypatch):
    """One bf16 ``make_train_step`` step of the full-width net: 18 forward
    and 18 backward calls on the kernels and ``bn.fused`` 18 in the step's
    record; against the same step with the plain layer on the card, the loss
    and the gradient norm within the benchmark's training limits (loss_gap,
    grad_gap of rtnr_bench/configs/room5m-train-1080p.json)."""
    import json
    from pathlib import Path

    from rtnr_tpu_torch.models import unet as um
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops import bn_train as bt
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt
    from rtnr_tpu_torch.utils import trace

    limits = json.loads((Path(__file__).resolve().parents[1] / "rtnr_bench" / "configs"
                         / "room5m-train-1080p.json").read_text())["limits"]
    W, H = 320, 192
    scene = Scene.synthetic(200_000, seed=3, extent=6.0)
    pts, cols, valid = (torch.from_numpy(a).to(cuda)
                        for a in scene.sorted_by_block().device_arrays(64))
    E = np.eye(4)
    E[2, 3] = 8.0
    M = torch.from_numpy(Camera.from_params(200.0, 200.0, W / 2, H / 2, W, H)
                         .cam_proj(E).astype(np.float32)).to(cuda)[None]
    targets = torch.rand((1, H, W, 3), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    variables = init_unet_numpy(2, (64, 128, 256, 512))
    step = tt.make_train_step(width=W, height=H)
    out = {}
    for mode in ("fused", "plain"):
        if mode == "plain":
            monkeypatch.setattr(um, "bn_relu_train", bt.bn_relu_train_plain)
        state = tt.create_train_state(variables, dtype=torch.bfloat16, device="cuda")
        n0, b0 = bt.bn_relu_train.launches, bt.bn_relu_train.backward_launches
        _, m = step(state, pts, cols, valid, M, targets)
        out[mode] = {k: float(v) for k, v in m.items()}
        out[mode]["launches"] = (bt.bn_relu_train.launches - n0,
                                 bt.bn_relu_train.backward_launches - b0)
        out[mode]["counter"] = trace.records(1)[0]["counters"].get("bn.fused")
    assert out["fused"]["launches"] == (18, 18) and out["fused"]["counter"] == 18
    assert out["plain"]["launches"] == (0, 0) and out["plain"]["counter"] is None
    for key, limit in (("loss", limits["loss_gap"]), ("grad_norm", limits["grad_gap"])):
        gap = abs(out["fused"][key] - out["plain"][key]) / abs(out["plain"][key])
        assert gap <= limit, (key, out)


class _Rank(_Keep):
    """The ``reduce`` of rank ``r`` of two, faked in one process: what the
    rank is given, added in rank order to the other rank's vector of the same
    call (forward, then backward) kept by an earlier pass, as ``psum`` adds
    the ranks' parts; an identity where that pass has nothing yet."""

    def __init__(self, r, other):
        super().__init__()
        self.r, self.other = r, other

    def __call__(self, v):
        k = len(self.seen)
        super().__call__(v)
        if k >= len(self.other):
            return v
        return v + self.other[k] if self.r == 0 else self.other[k] + v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_train_two_ranks_of_one_frame_equal_one_rank_of_two(cuda, dtype):
    """No block crosses a frame and the frames' sums add in order, so two
    ranks of one frame each (their vectors summed in rank order) give one
    rank's bits for the batch of both: sums, output, running statistics and
    dx; dscale and dbias are each rank's part, summed after."""
    x, dy, p = _bn_inputs(cuda, dtype, (2, 64, 96, 128))
    whole = _bn_kernels(x, dy, p)
    parts = lambda r: (x[r:r + 1], dy[r:r + 1], p)
    tots = [_bn_kernels(*parts(r))[6] for r in (0, 1)]  # each rank's own forward sums
    sums = [_bn_kernels(*parts(r), keep=_Rank(r, [tots[1 - r]]))[7] for r in (0, 1)]
    ranks = [_bn_kernels(*parts(r), keep=_Rank(r, [tots[1 - r], sums[1 - r]])) for r in (0, 1)]
    y, dx = (torch.cat([rk[i] for rk in ranks]) for i in (0, 1))
    assert torch.equal(y, whole[0]) and torch.equal(dx, whole[1])
    for r, rk in enumerate(ranks):
        assert torch.equal(rk[4], whole[4]) and torch.equal(rk[5], whole[5])
        assert torch.equal(rk[6], tots[r])  # the rank's own sums went in
    assert torch.equal(tots[0] + tots[1], whole[6]) and torch.equal(sums[0] + sums[1], whole[7])
    # dbias is each rank's sum, summed after as the trainer sums gradients: the
    # same bits; dscale = sum * rstd, taken on each rank's part before the
    # sum: within a few f32 roundings of the parts' magnitudes
    assert torch.equal(ranks[0][3] + ranks[1][3], whole[3])
    ds = [rk[2] for rk in ranks]
    assert bool(((ds[0] + ds[1] - whole[2]).abs() <= 1e-6 * (ds[0].abs() + ds[1].abs())).all())


# ---- the depth prefilter on csrc/prefilter.cu (ops/prefilter.filter_frame) ----

_FLT_MAX = np.float32(3.4028234663852886e38)


def _pf_frame(cuda, h, w, scene, seed=21):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    if scene == "empty":
        d[:] = _FLT_MAX
    elif scene == "saturated":  # FLT_MAX neighbourhoods: inf and NaN Laplacians
        d[rng.random((h, w)) < 0.85] = _FLT_MAX
        d[: h // 2, : w // 3] = _FLT_MAX
    else:
        d[rng.random((h, w)) < 0.3] = _FLT_MAX
        d[h // 3:, : w // 4] = np.float32(12.0)  # a flat wall: kept pixels, edges round it
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return torch.from_numpy(d).to(cuda), torch.from_numpy(rgb).to(cuda)


def _pf_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert same_bits((got[k],), (want[k],)), k


@pytest.mark.cuda
@pytest.mark.parametrize("hw,levels,scene", [
    ((1080, 1920), 4, "random"), ((1080, 1920), 4, "saturated"), ((1088, 1920), 4, "empty"),
    *[((48, 80), lv, s) for lv in (1, 2, 3, 4) for s in ("random", "saturated", "empty")],
    ((30, 45), 4, "random"), ((16, 16), 4, "saturated"), ((128, 192), 6, "random")])
def test_prefilter_kernels_match_plain_path(cuda, hw, levels, scene):
    """rtnr_prefilter against pad_to_pyramid + depth_prefilter on the card
    and against the twins, bit for bit; two calls equal; one launch and one
    ``prefilter.fused`` a call."""
    from rtnr_tpu_torch.ops import prefilter as tp
    from rtnr_tpu_torch.utils import trace

    d, rgb = _pf_frame(cuda, *hw, scene)
    n = tp.filter_frame.launches
    with trace.span("frame", root=True, device=cuda):
        got = tp.filter_frame(d, rgb, levels=levels)
    again = tp.filter_frame(d, rgb, levels=levels)
    assert tp.filter_frame.launches == n + 2
    assert trace.records()[-1]["counters"]["prefilter.fused"] == 1
    want = tp.depth_prefilter(*tp.pad_to_pyramid(d, rgb, levels), levels=levels)
    _pf_same(got, want)
    _pf_same(again, want)
    _pf_same(tp.prefilter_plain(d, rgb, levels=levels), want)
    if scene == "empty":
        assert not bool(got["mask"].any())
        assert float(got["depth_min"]) == np.inf and float(got["depth_max"]) == -np.inf
    else:
        assert bool(got["mask"].any())


@pytest.mark.cuda
def test_prefilter_kernels_refuse_what_they_do_not_take(cuda):
    from rtnr_tpu_torch.ops import prefilter as tp

    d, rgb = _pf_frame(cuda, 32, 32, "random")
    for args, kw in (((d, rgb.float()), {}), ((d.double(), rgb), {}), ((d, rgb), {"levels": 7}),
                     ((d, rgb[:, :, :2]), {})):
        with pytest.raises(ValueError, match="filter_frame"):
            tp.filter_frame(*args, **kw)


@pytest.mark.cuda
def test_renderer_and_sharded_render_prefilter_on_the_kernels(cuda):
    """Renderer.compute_filtered_rgbd and render_filtered_sharded (the
    training step's render) run the kernels once a frame, and their outputs
    equal the plain path's on their own raw frames."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.ops import prefilter as tp
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.parallel.render import render_filtered_sharded
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=5, extent=6.0)
    w, h = 90, 60  # pads to 96 x 64
    cam = Camera.from_params(60.0, 60.0, w / 2, h / 2, w, h)
    E = np.eye(4)
    E[2, 3] = 8.0
    r = Renderer(scene, RenderConfig(), device="cuda")
    n = tp.filter_frame.launches
    out = r.compute_filtered_rgbd(cam, E)
    assert tp.filter_frame.launches == n + 1
    raw_d, raw_c = (torch.from_numpy(out[k]).to(cuda) for k in ("raw_depth", "raw_rgb"))
    want = tp.depth_prefilter(*tp.pad_to_pyramid(raw_d, raw_c, 4), levels=4)
    assert np.array_equal(out["unet_input"].view(np.int32),
                          want["unet_input"].cpu().numpy().view(np.int32))
    assert np.array_equal(out["depth"], want["filtered_depth"][:h, :w].cpu().numpy())
    assert np.array_equal(out["rgb"], want["filtered_rgb"][:h, :w].cpu().numpy())
    assert np.array_equal(out["mask"], want["mask"][:h, :w].cpu().numpy())
    assert out["mask"].any()

    E2 = E.copy()
    E2[0, 3] = 0.3
    Ms = torch.stack([r._cam_proj(cam, E), r._cam_proj(cam, E2)])
    n = tp.filter_frame.launches
    got = render_filtered_sharded(r.points, r.colors, r.valid, Ms, make_mesh((1, 1)), width=w,
                                  height=h)
    assert tp.filter_frame.launches == n + 2
    for f in range(2):
        want = tp.depth_prefilter(*tp.pad_to_pyramid(got["raw_depth"][f], got["raw_rgb"][f], 4),
                                  levels=4)
        assert torch.equal(got["unet_input"][f], want["unet_input"])
        assert torch.equal(got["depth"][f], want["filtered_depth"][:h, :w])
        assert torch.equal(got["rgb"][f], want["filtered_rgb"][:h, :w])
        assert torch.equal(got["mask"][f], want["mask"][:h, :w])


# ---------------------------------------------------------------------------
# the full-width net and the paths at the benchmark's shapes: 1920x1080,
# padded to 1088x1920, U-Net [64,128,256,512] with seeded weights
# ---------------------------------------------------------------------------

FULL = (64, 128, 256, 512)
_FRAME = dict(width=1920, height=1080)


@pytest.fixture(scope="module")
def full():
    """A seeded 5M-point scene at 1080p (the steps cell's size: the U-Net's
    input, and so its budgets and the diff images, depend on how dense the
    frame is), the bf16 ("off"), static and dyn Renderers of the full-width
    net (static calibrated at the pose), and the U-Net inputs of the pose
    and of a second pose away from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import types

    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer, render_filtered
    from rtnr_tpu_torch.scene import Scene

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = Scene.synthetic(PAR_POINTS, seed=0, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, 960.0, 540.0, 1920, 1080)
    E, E2 = np.eye(4), np.eye(4)
    E[2, 3] = 12.0
    E2[0, 3], E2[1, 3], E2[2, 3] = 1.5, -0.5, 9.0
    v = init_unet_numpy(0, FULL)
    r = {m: Renderer(scene, RenderConfig(unet_int8=m), v, device="cuda")
         for m in ("off", "static", "dyn")}
    r["static"].calibrate(cam, E)
    xs = [render_filtered(r["off"].points, r["off"].colors, r["off"].valid,
                          r["off"]._cam_proj(cam, e), **_FRAME)["unet_input"][None]
          for e in (E, E2)]
    return types.SimpleNamespace(scene=scene, cam=cam, E=E, variables=v, r=r, x=xs[0], x2=xs[1])


_CONV_COUNTERS = ("conv3x3", "convt2x2", "conv3x3_wgmma", "convt2x2_wgmma", "conv3x3_up",
                  "conv3x3_in", "conv3x3_i8out", "conv3x3_static", "conv3x3_dyn",
                  "convt2x2_static", "conv3x3_dyn_wgmma", "convt2x2_static_wgmma",
                  "conv3x3_static_wgmma")
# a full-width frame's launches of each counter (absent: 0). conv3x3 / convt2x2 /
# conv3x3_static / conv3x3_dyn / convt2x2_static / conv3x3_i8out count every
# call of their mode, on conv.cu or not; each equal to its routed kernels'
# counts (conv_sm90.cu, conv_i8_sm90.cu, conv_in_sm90.cu) leaves conv.cu none
_ROUTES = {
    "bf16": dict(conv3x3=18, conv3x3_wgmma=17, conv3x3_in=1, convt2x2=4, convt2x2_wgmma=4),
    "static": dict(conv3x3_static=17, conv3x3_static_wgmma=17, conv3x3_in=1, conv3x3_i8out=1,
                   convt2x2_static=4, convt2x2_static_wgmma=4),
    "dyn": dict(conv3x3=8, conv3x3_wgmma=7, conv3x3_in=1, conv3x3_dyn=10, conv3x3_dyn_wgmma=10,
                convt2x2=4, convt2x2_wgmma=4),
    "bf16_fuse_up": dict(conv3x3=16, conv3x3_wgmma=15, conv3x3_in=1, conv3x3_up=2, convt2x2=2,
                         convt2x2_wgmma=2),
    "dyn_fuse_up": dict(conv3x3=6, conv3x3_wgmma=5, conv3x3_in=1, conv3x3_dyn=10,
                        conv3x3_dyn_wgmma=10, conv3x3_up=2, convt2x2=2, convt2x2_wgmma=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_ROUTES))
def test_full_width_frame_routes(cuda, full, mode, monkeypatch, tmp_path):
    """One 1080p frame of the full-width net in each serving mode (bf16,
    static, dyn; RTNR_FUSE_UP=1 in bf16 and dyn): every conv counter as
    ``_ROUTES`` has it, so no kernel of conv.cu; one rtnr_resolve4 and no
    K1 or K2; one prefilter call. Its ``trace.capture`` holds one
    ``resolve4_tile`` and no kernel of conv.cu (gemm, max-pool, head, dyn
    scales), K1 or K2."""
    import json
    import re

    from rtnr_tpu_torch.ops import prefilter as tp
    from rtnr_tpu_torch.utils import trace

    base = mode.split("_")[0]
    if mode.endswith("fuse_up"):
        monkeypatch.setenv("RTNR_FUSE_UP", "1")
    r = full.r["off" if base == "bf16" else base]
    r.compute_full(full.cam, full.E)
    counters = {k: getattr(cv, k) for k in _CONV_COUNTERS}
    counters.update(resolve4=rr.raster_images_v4, winners=rr.winners, expand=rr.expand_winners,
                    prefilter=tp.filter_frame)
    before = {k: c.launches for k, c in counters.items()}
    with trace.capture(str(tmp_path)):
        out = r.compute_full(full.cam, full.E)
        torch.cuda.synchronize()
    got = {k: c.launches - before[k] for k, c in counters.items()}
    assert got == {**{k: 0 for k in counters}, **_ROUTES[mode], "resolve4": 1, "prefilter": 1}
    assert np.isfinite(out["rgb_f"]).all()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("resolve4_tile" in n for n in names) == 1
    old = re.compile(r"\bgemm<\d, \d>|maxpool2<|head1x1_bf16|dyn_scales|winners_(count|scan|write)"
                     r"|expand_tile")
    assert not [n for n in names if old.search(n)]


def _budget(y, ref, big, small):
    """Max and mean of |y - ref| within ``big`` / ``small`` of the scale."""
    d = (y.float() - ref.float()).abs()
    return float(d.max()) <= big and float(d.mean()) <= small


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "bf16_fuse_up", "static", "dyn"])
def test_full_width_unet_within_its_budgets(cuda, full, mode, monkeypatch):
    """The full-width net at 1088x1920 on a rendered U-Net input: bf16 (also
    with RTNR_FUSE_UP=1) within max 5e-2 / mean 5e-3 x max(1, max|twin|) of
    its f32 twin net; static (21 calibrated scales) and dyn int8 within max
    0.10 / mean 0.02 x max|bf16| of the bf16 net (PARITY.md's budgets),
    static also at a second pose away from its calibration view."""
    bf16 = full.r["off"].unet
    with torch.no_grad():
        if mode.startswith("bf16"):
            if mode.endswith("fuse_up"):
                monkeypatch.setenv("RTNR_FUSE_UP", "1")
            ref = bf16.forward_plain(full.x, torch.float32)
            s = max(1.0, float(ref.abs().max()))
            assert _budget(bf16(full.x), ref, 5e-2 * s, 5e-3 * s)
            return
        r = full.r[mode]
        if mode == "static":
            assert len(r.act_scales) == 21
        for x in ((full.x, full.x2) if mode == "static" else (full.x,)):
            yb = bf16(x)
            s = float(yb.float().abs().max())
            assert _budget(r.unet(x, act_scales=r.act_scales), yb, 0.10 * s, 0.02 * s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "static", "dyn"])
def test_full_width_unet_calls_match_their_twins(cuda, full, mode):
    """Each conv call of the full-width net at the frame's shapes, on the
    net's own activations, against its prepared twin (``chip_smoke.conv_ok``
    and ``convt_ok``): the int8 calls bit for bit (the fused int8 pool
    included), the bf16 calls within 2 bf16 ulp of the twin's magnitude (the
    fused pool exactly the max of the conv), the int8-out input conv within
    one code on at most 0.1% of its elements; the head within 2 bf16 ulp of
    its own reference."""
    net = full.r["off" if mode == "bf16" else mode].unet
    p = net.prepare() if mode == "bf16" else net.prepare_int8(full.r[mode].act_scales)
    hd = p["final_conv"]
    calls = []

    def conv(xs, name, pool=False, head=False):
        calls.append((name, list(xs), pool, head))
        return cv.conv3x3_prepared(xs, p[name], relu=True, pool=pool, head=hd if head else None)

    def convt(h, name):
        calls.append((name, h, None, False))
        return cv.convt2x2_prepared(h, p[name])

    with torch.no_grad():
        net._run(full.x.to(torch.bfloat16).contiguous(), conv, convt)
        assert len(calls) == 22
        for name, xin, pool, head in calls:
            if pool is None:
                assert convt_ok(xin, p[name]), name
            else:
                assert conv_ok(xin, p[name], pool, hd if head else None), name


@pytest.mark.cuda
def test_int8_gate_on_card_at_full_width(cuda, full):
    """Off JAX's phase shapes the full-width int8 nets run exact bf16 on the
    kernels: at 960x720 (720 % 64 != 0) the static and dyn Renderers give the
    bf16 frame bit for bit, launch no int8 kernel, and the static one does
    not calibrate; at the strip shape of a 4-strip 1080p frame (272 + 2 x
    32 rows) the static net equals the bf16 net, which stays within the
    bf16 budget of its f32 twin."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer

    cam = Camera.from_params(600.0, 600.0, 480.0, 360.0, 960, 720)
    rs = {m: Renderer(full.scene, RenderConfig(unet_int8=m), full.variables, device="cuda")
          for m in ("off", "static", "dyn")}
    ref = rs["off"].compute_full(cam, full.E)
    int8 = [getattr(cv, k) for k in ("conv3x3_i8out", "conv3x3_static", "conv3x3_dyn",
                                     "convt2x2_static", "conv3x3_dyn_wgmma",
                                     "convt2x2_static_wgmma", "conv3x3_static_wgmma")]
    for m in ("static", "dyn"):
        before = [c.launches for c in int8]
        out = rs[m].compute_full(cam, full.E)
        assert [c.launches for c in int8] == before, m
        for k in ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb"):
            assert np.array_equal(out[k], ref[k]), (m, k)
    assert rs["static"].act_scales is None
    x = full.x[:, :1088 // 4 + 2 * 32].contiguous()
    bf16, st = full.r["off"].unet, full.r["static"]
    n = cv.conv3x3_static_wgmma.launches
    with torch.no_grad():
        ys = bf16(x)
        assert torch.equal(st.unet(x, act_scales=st.act_scales), ys)
        ref = bf16.forward_plain(x, torch.float32)
    assert cv.conv3x3_static_wgmma.launches == n
    s = max(1.0, float(ref.abs().max()))
    assert _budget(ys, ref, 5e-2 * s, 5e-3 * s)


@pytest.mark.cuda
def test_renderer_on_card_matches_cpu(cuda):
    """A small bf16 render on the card against the same render on the CPU
    (whose plain twins the CPU tests hold against the JAX package): raw,
    mask and depth bit for bit, rgb_f within max 5e-2 / mean 5e-3 of the
    range."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(20_000, seed=3, extent=6.0)
    cam = Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48)
    E = np.eye(4)
    E[2, 3] = 8.0
    cfg, v = RenderConfig(unet_features=(16, 32)), init_unet_numpy(1, (16, 32))
    gpu, cpu = (Renderer(scene, cfg, v, device=d).compute_full(cam, E) for d in ("cuda", "cpu"))
    for k in ("raw_rgb", "raw_depth", "mask", "depth"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    s = max(1.0, float(np.abs(cpu["rgb_f"]).max()))
    assert _budget(torch.from_numpy(gpu["rgb_f"]), torch.from_numpy(cpu["rgb_f"]), 5e-2 * s,
                   5e-3 * s)


@pytest.mark.cuda
def test_culled_frame_equals_unculled_on_card(cuda, full):
    """With the camera inside the cloud, ``cull_budget="auto"`` keeps part
    of the scene and gives the unculled frame bit for bit."""
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.pipeline import Renderer

    Ec = np.eye(4)
    Ec[2, 3] = 2.0
    culled = Renderer(full.scene, RenderConfig(), full.variables, cull_budget="auto",
                      device="cuda")
    a, b = full.r["off"].compute_full(full.cam, Ec), culled.compute_full(full.cam, Ec)
    for k in ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb"):
        assert np.array_equal(a[k], b[k]), k
    cache = culled._cull_cache
    assert not cache["overflowed"] and 0 < cache["n_kept"] < full.scene.n_points


@pytest.mark.cuda
def test_diff_raster_images_equal_the_serving_images_on_card(cuda, full):
    """At 1080p the differentiable resolve's count, depth and sums equal the
    serving resolve's integer images exactly (integer colours: every f32 sum
    is exact)."""
    from rtnr_tpu_torch.config import RenderConfig

    r, hw, band = full.r["off"], 1920 * 1080, RenderConfig().depth_band
    M = r._cam_proj(full.cam, full.E)
    sd, _ = tr.project_and_sort_diff(r.points, r.colors, M, valid=r.valid, **_FRAME)
    sums_f, cnt_f, depth_f = rr.raster_images_diff(sd, hw, band)
    sums_i, cnt_i, depth_i = rr.raster_images_v4(
        tr.project_and_sort(r.points, r.colors, M, valid=r.valid, **_FRAME), hw, band)
    assert int(cnt_i.max()) > 1
    assert torch.equal(cnt_f, cnt_i.float()) and torch.equal(sums_f, sums_i.float())
    assert torch.equal(depth_f.view(torch.int32), depth_i.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train_step", "scene_step"])
def test_train_steps_at_full_width_on_card(cuda, full, kind):
    """One bf16 step of each train step at 1080p, the full-width net, the
    scene's own render as its target: the train step launches rtnr_resolve4
    and the prefilter once and no K1 or K2, the scene step rtnr_resolve_diff
    once and no K5, K2 or prefilter kernel; each runs its 18 BatchNorm
    layers on the fused kernels, ends with a finite loss and moves the batch
    statistics; the scene step's pose and colour gradients are not zero and
    it moves the colours and the camera matrices."""
    from rtnr_tpu_torch.ops import bn_train as bt
    from rtnr_tpu_torch.ops import prefilter as tp
    from rtnr_tpu_torch.pipeline import render_rgbd
    from rtnr_tpu_torch.train import trainer as tt

    r = full.r["off"]
    M = r._cam_proj(full.cam, full.E)
    targets = render_rgbd(r.points, r.colors, r.valid, M, **_FRAME)["rgb"][None].float() / 255.0
    counters = dict(resolve4=rr.raster_images_v4, resolve_diff=rr.raster_images_diff,
                    winners=rr.winners, winners_f32=rr.winners_f32, expand=rr.expand_winners,
                    prefilter=tp.filter_frame, bn=bt.bn_relu_train)
    before = {k: c.launches for k, c in counters.items()}
    if kind == "train_step":
        state = tt.create_train_state(full.variables, dtype=torch.bfloat16, device="cuda")
        step = tt.make_train_step(**_FRAME)
        args = (r.points, r.colors, r.valid, M[None], targets)
        want = dict(resolve4=1, prefilter=1)
    else:
        state = tt.create_scene_train_state(full.variables, r.colors, M[None],
                                            dtype=torch.bfloat16, device="cuda")
        cols0, cams0 = state.colors.detach().clone(), state.cam_projs.detach().clone()
        step = tt.make_scene_train_step(**_FRAME)
        args = (r.points, r.valid, targets)
        want = dict(resolve_diff=1)
    stats0 = state.model.param("down0/bn0/mean").clone()
    state, m = step(state, *args)
    torch.cuda.synchronize()
    got = {k: c.launches - before[k] for k, c in counters.items()}
    assert got == {**{k: 0 for k in counters}, **want, "bn": 18}
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(stats0, state.model.param("down0/bn0/mean"))
    if kind == "scene_step":
        assert float(m["pose_grad_norm"]) > 0 and float(m["color_grad_norm"]) > 0
        assert not torch.equal(cols0, state.colors.detach())
        assert not torch.equal(cams0, state.cam_projs.detach())


@pytest.mark.cuda
def test_small_scene_step_on_card_matches_cpu(cuda):
    """One scene step at 32x32, features (8, 16), f32 (TF32 off), on the card
    against the same step on the CPU (whose plain twins the CPU tests hold
    against the JAX package): the loss and the gradient norms within rtol
    1e-3."""
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt

    pts, cols, valid = Scene.synthetic(8192, seed=0, extent=6.0).sorted_by_block() \
        .device_arrays(64)
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
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        _, m = step(st, t(pts), t(valid), t(targets))
        out[dev] = {k: float(v) for k, v in m.items()}
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-3 * abs(v), (k, out)


def _train_demo_scene():
    """The JAX package's scripts/train_demo_r5.py scene: 400,000 points on a
    back wall, a floor and two side walls, coloured per wall with seeded
    noise (seed 7): (points f32, colours u8)."""
    rng = np.random.default_rng(7)
    walls, cols = [], []
    m = 100_000
    for k in range(4):
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


@pytest.mark.cuda
def test_train_cli_loss_falls_on_card(cuda, tmp_path, capsys):
    """The training CLI on the card as the JAX package's
    scripts/train_demo_r5.py runs it: the demo scene as PLY, a 16-pose TUM
    trajectory, a 640x352 calibration, 150 self-supervised steps at lr 2e-4
    with the full-width bf16 net from ``init_unet_numpy(0)``: the last
    logged loss is below the first, every step runs 18 fused BatchNorm
    layers, and the checkpoint renders pose 8 nearer its target (L1) than
    the untrained net."""
    import json

    from rtnr_tpu_torch.apps.train_unet import main
    from rtnr_tpu_torch.camera import Trajectory
    from rtnr_tpu_torch.config import RenderConfig
    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops import bn_train as bt
    from rtnr_tpu_torch.pipeline import Renderer
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.utils.checkpoint import load_unet_variables

    steps, w, h, fx = 150, 640, 352, 420.0
    ply, traj, calib, ckpt = (str(tmp_path / f) for f in ("s.ply", "t.txt", "c.txt", "u.msgpack"))
    write_ply(ply, *_train_demo_scene())
    (tmp_path / "t.txt").write_text("".join(
        f"{i:.1f} {-1.0 + 2.0 * i / 15:.4f} {0.2:.4f} {-2.0 - i / 15:.4f} 0 0 0 1\n"
        for i in range(16)))
    (tmp_path / "c.txt").write_text(f"{w} {h}\n{fx} 0 {w / 2}\n0 {fx} {h / 2}\n0 0 1\n"
                                    "0 0 0 0 0\n0\n")
    n = bt.bn_relu_train.launches
    assert main([ply, traj, calib, "--self-supervised", "--steps", str(steps), "--lr", "2e-4",
                 "-o", ckpt, "--log-every", "10"], device="cuda") == 0
    assert bt.bn_relu_train.launches - n == 18 * steps
    logs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert logs[-1]["step"] == steps - 1 and logs[-1]["loss"] < logs[0]["loss"], logs
    cam, E = Camera.load_calibration(calib), Trajectory.load(traj).world_to_cam(8)
    scene, target, l1 = Scene.from_file(ply), None, {}
    for tag, v in (("untrained", init_unet_numpy(0, FULL)), ("trained", load_unet_variables(ckpt))):
        r = Renderer(scene, RenderConfig(unet_int8="off"), v, device="cuda")
        if target is None:
            target = r.compute_rgbd(cam, E)["rgb"].astype(np.float32) / 255.0
        l1[tag] = float(np.abs(r.compute_full(cam, E)["rgb_f"] - target).mean())
    assert l1["trained"] < l1["untrained"], l1


# ---------------------------------------------------------------------------
# the multi-rank paths on ranks sharing the card (gloo; one NCCL rank), each
# case bit for bit against the one-device frames of the same poses
# ---------------------------------------------------------------------------

# the ranks import this module from its directory: ``tests`` may name another package there
_HERE = str(__import__("pathlib").Path(__file__).resolve().parent)
PAR_POINTS = 5_000_000
PAR_POSES = 8  # frames of render_full_batch (two a rank on four ranks)
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


def _par_counters():
    from rtnr_tpu_torch.ops import bn_train

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


def _par_read():
    return {k: getattr(fn, attr) for k, (fn, attr) in _par_counters().items()}


def _par_poses():
    """PAR_POSES camera poses 12 m out, moved sideways."""
    out = []
    for k in range(PAR_POSES):
        E = np.eye(4)
        E[0, 3], E[1, 3], E[2, 3] = 0.25 * k - 1.0, 0.1 * (k % 3), 12.0 - 0.2 * k
        out.append(E)
    return out


def _par_rank_cases(nccl: bool = False):
    """One rank of the multi-rank cases (every rank runs it; ``nccl``: one
    rank on NCCL, every mesh of size 1, then NCCL's collectives). Each case
    computes its one-device reference, runs once uncounted, then counts the
    launches of one sharded call and holds its outputs to the reference bit
    for bit (the strip U-Net's ``rgb_f`` within JAX's seam bounds). Raises
    on a mismatch."""
    import torch.distributed as dist

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
    W, H = _FRAME["width"], _FRAME["height"]
    n, backend = dist.get_world_size(), dist.get_backend()  # every mesh spans the world
    scene = Scene.synthetic(PAR_POINTS, seed=0, extent=10.0)
    cam = Camera.from_params(1100.0, 1100.0, W / 2, H / 2, W, H)
    variables = init_unet_numpy(0, FULL)
    bf16 = Renderer(scene, RenderConfig(), variables, device="cuda")
    static = Renderer(scene, RenderConfig(unet_int8="static"), variables, device="cuda")
    poses = _par_poses()
    Ms = torch.stack([bf16._cam_proj(cam, E) for E in poses])
    static.calibrate(cam, poses[0])
    pts, cols, valid = bf16.points, bf16.colors, bf16.valid

    def case(run, check):
        run()
        torch.cuda.synchronize()
        dist.barrier()
        before = _par_read()
        out = run()
        torch.cuda.synchronize()
        check(out, {k: v - before[k] for k, v in _par_read().items()})

    def need(launches, **want):
        for k, v in want.items():
            if launches[k] != v:
                raise AssertionError(f"{k} launched {launches[k]} times, not {v}")

    def same(got, want):
        g = got.view(torch.int32) if got.dtype == torch.float32 else got
        w = want.view(torch.int32) if want.dtype == torch.float32 else want
        return g.shape == w.shape and bool(torch.equal(g, w))

    # 1. one frame, the scene over the points axis: (1, n)
    mesh = make_mesh((1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")  # noqa: E731
    ref_rgb, ref_depth = rasterize(pts, cols, Ms[0], width=W, height=H, valid=valid)

    def check_point(out, launches):
        if not (same(out[0], ref_rgb) and same(out[1], ref_depth)):
            raise AssertionError("rasterize_point_sharded differs from rasterize")
        two = n > 1  # pass 1, then the band-reference pass
        need(launches, resolve4=1 + two, resolve4_ref=int(two), winners=0, expand=0)

    case(lambda: rasterize_point_sharded(blk(pts), blk(cols), blk(valid), Ms[0], mesh, width=W,
                                         height=H), check_point)

    # 2. render_filtered_sharded on (2, 2) (n == 1: (1, 1)), two frames
    mesh = make_mesh((2, 2) if n == 4 else (1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")  # noqa: E731
    nb = mesh.shape["batch"]
    mine = list(range(2))[mesh.axis_index("batch") * (2 // nb):][:2 // nb]
    refs = [render_filtered(pts, cols, valid, Ms[f], width=W, height=H) for f in mine]

    def check_filtered(out, launches):
        for j, r in enumerate(refs):
            for k in ("raw_rgb", "raw_depth", "rgb", "depth", "mask", "unet_input"):
                if not same(out[k][j], r[k]):
                    raise AssertionError(f"render_filtered_sharded {k} differs (frame {mine[j]})")
        two = mesh.shape["points"] > 1
        need(launches, resolve4=len(mine) * (1 + two), resolve4_ref=len(mine) * two)

    case(lambda: render_filtered_sharded(blk(pts), blk(cols), blk(valid), Ms[:2], mesh, width=W,
                                         height=H), check_filtered)
    del refs

    # 3. render_full_batch on (n, 1): PAR_POSES frames, bf16 and static int8
    mesh = make_mesh((n, 1))
    fl = PAR_POSES // n
    mine = list(range(mesh.axis_index("batch") * fl, (mesh.axis_index("batch") + 1) * fl))
    for label, r in (("bf16", bf16), ("static", static)):
        refs = [render_full(pts, cols, valid, Ms[f], r.unet, width=W, height=H,
                            act_scales=r.act_scales)["rgb_f"] for f in mine]

        def check_full(out, launches, refs=refs, label=label):
            for j, y in enumerate(refs):
                if not same(out["rgb_f"][j], y):
                    raise AssertionError(f"render_full_batch ({label}) rgb_f differs "
                                         f"(frame {mine[j]})")
            if label == "bf16":
                need(launches, resolve4=fl, resolve4_ref=0, conv3x3_wgmma=17 * fl,
                     convt2x2_wgmma=4 * fl, conv3x3_in=fl, conv3x3_static_wgmma=0)
            else:
                need(launches, resolve4=fl, conv3x3_static_wgmma=17 * fl,
                     convt2x2_static_wgmma=4 * fl, conv3x3_in=fl, conv3x3_wgmma=0)
            g = C.gather_frames(out["rgb_unet"], mesh)
            if tuple(g.shape) != (PAR_POSES, H, W, 3):
                raise AssertionError(f"gather_frames gave {tuple(g.shape)}")

        case(lambda r=r: render_full_batch(pts, cols, valid, Ms, mesh, r.unet, width=W, height=H,
                                           act_scales=r.act_scales), check_full)
        del refs
    torch.cuda.empty_cache()

    # 4. row strips with the per-strip block culling: (n,) tiles
    mesh = make_mesh((n,), ("tiles",))
    index = build_block_index(scene, pad_to_multiple=1024, device=pts.device)

    def check_tiles(out, launches):
        if not (same(out[0], ref_rgb) and same(out[1], ref_depth)):
            raise AssertionError("rasterize_tile_sharded differs from rasterize")
        need(launches, resolve4=1, resolve4_ref=0)

    case(lambda: rasterize_tile_sharded(pts, cols, valid, Ms[0], mesh, width=W, height=H,
                                        block_index=index), check_tiles)
    del index

    # 5. the whole pipeline on strips at the pyramid height (1088 rows)
    hp = 1088
    one = render_full(pts, cols, valid, Ms[0], bf16.unet, width=W, height=hp)
    mid = render_filtered(pts, cols, valid, Ms[0], width=W, height=hp)["unet_input"]

    def check_strips(out, launches):
        for k in ("raw_rgb", "raw_depth"):
            if not same(out[k], one[k]):
                raise AssertionError(f"render_full_tile_sharded {k} differs")
        if not same(out["unet_input"], mid):
            raise AssertionError("render_full_tile_sharded core unet_input differs")
        need(launches, resolve4=1, conv3x3_in=1, conv3x3_wgmma=17, convt2x2_wgmma=4)
        # away from the image's outer rows, JAX's seam bounds (tests/test_tiles.py:
        # mean 2e-3, max 0.15). At those rows the zeroed overlap rows of the first
        # and last strips are not the one-card net's padding: JAX's strips leave
        # the bounds there too, and the port's equal JAX's on the border strips
        # (tests/test_torch_tiles.py, random-BatchNorm weights)
        d = (out["rgb_f"] - one["rgb_f"]).abs()[STRIP_EDGE:hp - STRIP_EDGE]
        rgb8 = (out["rgb_unet"].float() - one["rgb"].float()).abs()
        if not (float(d.mean()) < 2e-3 and float(d.max()) < 0.15 and float(rgb8.mean()) <= 1.0):
            raise AssertionError(f"the strip U-Net's frame: rgb_f inner mean {float(d.mean())}, "
                                 f"max {float(d.max())}; uint8 mean {float(rgb8.mean())}")

    case(lambda: render_full_tile_sharded(pts, cols, valid, Ms[0], mesh, bf16.unet, width=W,
                                          height=hp, halo=TILE_HALO, unet_halo=TILE_UNET_HALO),
         check_strips)
    del one, mid
    torch.cuda.empty_cache()

    # 6. the differentiable forward on (1, n), integer colours: bit for bit
    mesh = make_mesh((1, n))
    blk = lambda a: C.shard_rows(a, mesh, "points")  # noqa: E731
    colsf = cols.float()
    ref = rasterize_diff_sorted(pts, colsf, Ms[0], width=W, height=H, valid=valid)
    c_blk = blk(colsf).clone().requires_grad_(True)

    def check_diff(out, launches):
        for k in ("rgb", "depth", "count", "mask"):
            if not same(getattr(out, k).detach(), getattr(ref, k).detach()):
                raise AssertionError(f"rasterize_diff_point_sharded {k} differs")
        two = n > 1
        need(launches, resolve_diff=1 + two, resolve_diff_ref=int(two))
        loss = torch.sum(out.rgb * 1e-3) + 1e-6 * torch.sum(torch.where(out.mask, out.depth, 0.0))
        loss.backward()
        if not bool(torch.isfinite(c_blk.grad).all()) or float(c_blk.grad.abs().sum()) == 0:
            raise AssertionError("rasterize_diff_point_sharded colour gradients")

    case(lambda: rasterize_diff_point_sharded(blk(pts), c_blk, Ms[0], mesh, width=W, height=H,
                                              valid=blk(valid)), check_diff)

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
    return backend


def _par_train_ranks(steps: int):
    """Scene-train steps on a (2, 1) mesh, one 1080p frame a rank: ``steps``
    with the bf16 U-Net, then one with the f32 U-Net (TF32 off); rank 0
    first runs the same steps on one rank with both frames. Returns the
    metrics, a digest of the parameters after each step and the fused
    BatchNorm layers of the two-rank steps."""
    import hashlib

    import torch.distributed as dist

    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.ops import bn_train
    from rtnr_tpu_torch.ops.raster import rasterize
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.scene import Scene
    from rtnr_tpu_torch.train import trainer as tt

    W, H = _FRAME["width"], _FRAME["height"]
    rank = dist.get_rank()
    cam = Camera.from_params(1100.0, 1100.0, W / 2, H / 2, W, H)
    dev = torch.device("cuda", torch.cuda.current_device())
    pts, cols, valid = (torch.from_numpy(a).to(dev) for a in Scene.synthetic(
        PAR_POINTS, seed=0, extent=10.0).sorted_by_block().device_arrays(1024))
    Ms = torch.stack([torch.from_numpy(cam.cam_proj(E).astype(np.float32)).to(dev)
                      for E in _par_poses()[:2]])
    targets = torch.stack([rasterize(pts, cols, M, width=W, height=H, valid=valid)[0].float()
                           / 255.0 for M in Ms])
    variables = init_unet_numpy(0, FULL)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(mesh, dtype=torch.bfloat16, n_steps=steps):
        state = tt.create_scene_train_state(variables, cols.float().cpu().numpy(),
                                            Ms.cpu().numpy(), dtype=dtype, learning_rate=1e-4)
        step = tt.make_scene_train_step(width=W, height=H, mesh=mesh)
        out = []
        for _ in range(n_steps):
            state, m = step(state, pts, valid, targets)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for p in state.model.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
            out.append({"params": h.hexdigest(), **{k: float(v) for k, v in m.items()}})
        del state
        torch.cuda.empty_cache()
        return out

    res = {"rank": rank}
    if rank == 0:
        res["one_rank"] = run(None)
    dist.barrier()
    n = bn_train.bn_relu_train.launches
    res["two_ranks"] = run(make_mesh((2, 1)))
    res["bn_layers"] = bn_train.bn_relu_train.launches - n
    if rank == 0:
        res["one_rank_f32"] = run(None, torch.float32, 1)
    dist.barrier()
    res["two_ranks_f32"] = run(make_mesh((2, 1)), torch.float32, 1)
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("world, backend", [(4, "gloo"), (1, "nccl")])
def test_parallel_cases_on_ranks_sharing_the_card(cuda, world, backend):
    """``_par_rank_cases`` at the benchmark's frame (5M points, the
    full-width net) on four gloo ranks sharing the card (the backend rule's
    choice there) and on one NCCL rank: the point-sharded raster on (1, n),
    ``render_filtered_sharded`` on (2, 2), ``render_full_batch`` on (n, 1)
    over 8 poses in bf16 and static int8, ``rasterize_tile_sharded`` with
    per-strip culling, ``render_full_tile_sharded`` at 1088 rows and the
    point-sharded differentiable forward, each against one device."""
    from rtnr_tpu_torch.parallel.launch import run_ranks

    res = run_ranks("test_torch_cuda:_par_rank_cases", world, {"nccl": backend == "nccl"},
                    device="cuda", threads=2, extra_path=[_HERE], timeout=900)
    assert res == [backend] * world


@pytest.mark.cuda
def test_scene_train_steps_on_two_ranks_match_one_rank(cuda):
    """Two gloo ranks sharing the card, one 1080p frame each, against one
    rank stepping both frames: step 0's gradient norms within
    ``PAR_GRAD_RTOL`` in bf16 and in f32, the parameters equal on both ranks
    after every step, the losses within 1e-2, 18 fused BatchNorm layers a
    step on each rank."""
    from rtnr_tpu_torch.parallel.launch import run_ranks

    res = run_ranks("test_torch_cuda:_par_train_ranks", 2, {"steps": PAR_TRAIN_STEPS},
                    device="cuda", threads=2, extra_path=[_HERE], timeout=900)
    one, two = res[0]["one_rank"], [r["two_ranks"] for r in res]
    # step 0 is where the merge of the U-Net's, the colours' and the poses'
    # gradients shows before any update moves the two runs apart
    for dt, a, b in (("bfloat16", two[0][0], one[0]),
                     ("float32", res[0]["two_ranks_f32"][0], res[0]["one_rank_f32"][0])):
        for k, rtol in PAR_GRAD_RTOL[dt].items():
            assert abs(a[k] - b[k]) <= rtol * abs(b[k]), (dt, k, a[k], b[k])
    assert [r["bn_layers"] for r in res] == [18 * PAR_TRAIN_STEPS] * 2
    assert res[0]["two_ranks_f32"][0]["params"] == res[1]["two_ranks_f32"][0]["params"]
    for s in range(PAR_TRAIN_STEPS):
        assert two[0][s]["params"] == two[1][s]["params"], s
        assert abs(two[0][s]["loss"] - one[s]["loss"]) <= 1e-2 * abs(one[s]["loss"]), s
