"""The port's depth prefilter (rtnr_tpu_torch.ops.prefilter) and
render_filtered against the JAX package, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops import prefilter as jp
from rtnr_tpu.pipeline import render_filtered as j_render_filtered
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.ops import prefilter as tp
from rtnr_tpu_torch.pipeline import pad_to_pyramid, pyramid_pad_shape, render_filtered
from rtnr_tpu_torch.scene import Scene

FLT_MAX = np.float32(3.4028234663852886e38)


def make_depth(h, w, seed, empty_frac=0.3):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 20.0, size=(h, w)).astype(np.float32)
    d[rng.random((h, w)) < empty_frac] = FLT_MAX
    return d


def wall_depth(h, w, seed):
    """Dense near wall at z=5 with sparse far-wall leak-through at z=20."""
    rng = np.random.default_rng(seed)
    d = np.full((h, w), FLT_MAX, np.float32)
    near = rng.random((h, w)) < 0.7
    d[near] = rng.uniform(4.9, 5.1, near.sum()).astype(np.float32)
    far = ~near & (rng.random((h, w)) < 0.5)
    d[far] = rng.uniform(19.5, 20.5, far.sum()).astype(np.float32)
    d[:, : w // 4] = np.where(rng.random((h, w // 4)) < 0.2, FLT_MAX, np.float32(12.0))
    return d


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_min_pool2_and_laplacian_bitexact(seed):
    d = make_depth(16, 16, seed, empty_frac=0.4)
    _eq(tp.min_pool2(torch.from_numpy(d)), jp.min_pool2(jnp.asarray(d)))
    _eq(tp.laplacian_edge_mask(torch.from_numpy(d), 0.03),
        jp.laplacian_edge_mask(jnp.asarray(d), 0.03))


@pytest.mark.parametrize("seed", [0, 1])
def test_compare_levels_and_bilinear_bitexact(seed):
    rng = np.random.default_rng(seed)
    low = make_depth(8, 8, seed)
    high = make_depth(16, 16, seed + 10)
    grad = rng.random((8, 8)) < 0.5
    _eq(tp.compare_levels(torch.from_numpy(low), torch.from_numpy(high),
                          torch.from_numpy(grad), 1.025),
        jp.compare_levels(jnp.asarray(low), jnp.asarray(high), jnp.asarray(grad), 1.025))
    low = rng.uniform(1.0, 20.0, (8, 8)).astype(np.float32)
    _eq(tp.bilinear_up2(torch.from_numpy(low), (16, 16)),
        jp.bilinear_up2(jnp.asarray(low), (16, 16)))


@pytest.mark.parametrize("scene", ["random", "wall"])
@pytest.mark.parametrize("shape", [(32, 32), (64, 48)])
def test_depth_prefilter_bitexact(scene, shape):
    h, w = shape
    d = make_depth(h, w, 3) if scene == "random" else wall_depth(h, w, 4)
    rgb = np.random.default_rng(5).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = jp.depth_prefilter(jnp.asarray(d), jnp.asarray(rgb), levels=4)
    got = tp.depth_prefilter(torch.from_numpy(d), torch.from_numpy(rgb), levels=4)
    for k in ("unet_input", "filtered_depth", "filtered_rgb", "mask", "depth_min", "depth_max"):
        _eq(got[k], want[k])
    if scene == "wall":  # the filter keeps the wall and drops far leak-through
        m = got["mask"].numpy()
        assert m[d < 6].mean() > 0.5 and m[(d > 19) & (d < 21)].mean() < 0.5


def test_pad_to_pyramid_values():
    d = torch.ones((30, 30))
    rgb = torch.ones((30, 30, 3), dtype=torch.uint8)
    dp, cp = pad_to_pyramid(d, rgb, 4)
    assert dp.shape == (32, 32) and cp.shape == (32, 32, 3)
    assert float(dp[31, 31]) == float(FLT_MAX) and int(cp[31, 31, 0]) == 0
    assert pyramid_pad_shape(1440, 1440, 4) == (1440, 1440)  # no phase-row padding
    assert pyramid_pad_shape(1080, 1920, 4) == (1088, 1920)


@pytest.mark.parametrize("wh", [(64, 48), (40, 60)])
def test_render_filtered_bitexact(wh):
    """End to end raster + prefilter; 40x60 takes the padding path."""
    w, h = wh
    scene = Scene.synthetic(20_000, seed=1, extent=6.0)
    pts, cols, valid = scene.sorted_by_block().device_arrays(1024)
    cam = Camera.from_params(50.0, 50.0, w / 2, h / 2, w, h)
    E = np.eye(4)
    E[2, 3] = 8.0
    M = cam.cam_proj(E).astype(np.float32)
    want = j_render_filtered(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                             jnp.asarray(M), width=w, height=h)
    got = render_filtered(torch.from_numpy(pts), torch.from_numpy(cols),
                          torch.from_numpy(valid), torch.from_numpy(M), width=w, height=h)
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k])


# ---- filter_frame, the kernels' plain twins and the dispatch ----

def saturated_depth(h, w, seed):
    """Mostly empty: FLT_MAX neighbourhoods overflow the Laplacian to inf and NaN."""
    d = make_depth(h, w, seed, empty_frac=0.85)
    d[: h // 2, : w // 3] = FLT_MAX
    return d


def threshold_depth(h, w, seed):
    """A flat surface (no edges) at c with, in every 2x2 block, pixels at
    exactly c * f32(1.025) (kept) and one f32 step above it (rejected)."""
    rng = np.random.default_rng(seed)
    c = np.float32(7.3)
    t = c * np.float32(1.025)
    d = np.where(rng.random((h, w)) < 0.5, t, np.nextafter(t, np.float32(np.inf)))
    d = d.astype(np.float32)
    d[0::2, 0::2] = c  # the min of every block, so every level reads c
    return d


SCENES = {"random": lambda h, w: make_depth(h, w, 3), "wall": lambda h, w: wall_depth(h, w, 4),
          "empty": lambda h, w: np.full((h, w), FLT_MAX, np.float32),
          "saturated": lambda h, w: saturated_depth(h, w, 6),
          "threshold": lambda h, w: threshold_depth(h, w, 7)}


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().contiguous().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("shape", [(32, 48), (30, 45)])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("scene", list(SCENES))
def test_prefilter_twins_compose_to_depth_prefilter(scene, levels, shape):
    """pyramid_plain, level_pass_plain and pack_plain, composed as the C
    entry launches the kernels, equal pad_to_pyramid + depth_prefilter bit
    for bit (30x45 pads on the fly)."""
    h, w = shape
    d = torch.from_numpy(SCENES[scene](h, w))
    rgb = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (h, w, 3), dtype=np.uint8))
    want = tp.depth_prefilter(*pad_to_pyramid(d, rgb, levels), levels=levels)
    got = tp.prefilter_plain(d, rgb, levels=levels)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    mask = got["mask"].numpy()
    if scene == "empty":
        assert not mask.any()
        assert float(got["depth_min"]) == np.inf and float(got["depth_max"]) == -np.inf
    if scene == "saturated":  # the finest coarse level's Laplacian holds NaN and inf sums
        lv1 = tp.pyramid_plain(d, levels)[0][0]
        s = sum(torch.roll(lv1, (-dy, -dx), (0, 1)) * tap for dy, dx, tap in tp._LAPLACE_TAPS)
        assert torch.isnan(s).any() and torch.isinf(s).any()
    if scene == "threshold":  # at the threshold kept, one step above rejected
        raw = d.numpy()
        t = np.float32(7.3) * np.float32(1.025)
        assert mask[:h, :w][raw == t].all() and not mask[:h, :w][raw > t].any()


def test_pyramid_plain_min_max_through_order_keys():
    """The kernels' key arithmetic: exact min and max over occupied pixels,
    negative and zero depths included, the FLT_MAX seed skipped."""
    d = np.array([[FLT_MAX, -2.5, 0.0, 3.0], [7.0, FLT_MAX, -0.125, 1e30]], np.float32)
    _, dmin, dmax = tp.pyramid_plain(torch.from_numpy(d), 1)
    assert float(dmin) == -2.5 and float(dmax) == np.float32(1e30)


def test_filter_frame_plain_paths_count_nothing():
    """CPU tensors, strip arguments and inputs that require a gradient take
    the plain path: depth_prefilter's outputs, no launch, no record counter."""
    from rtnr_tpu_torch.utils import trace

    h, w = 30, 45
    d = torch.from_numpy(make_depth(h, w, 8))
    rgb = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (h, w, 3), dtype=np.uint8))
    dp, cp = pad_to_pyramid(d, rgb, 4)
    mm = (torch.tensor(1.5), torch.tensor(19.0))
    before = tp.filter_frame.launches
    with trace.span("frame", root=True):
        full = tp.filter_frame(d, rgb, levels=4)
        strip = tp.filter_frame(dp, cp, levels=4, row_offset=-16, total_h=64, minmax=mm)
        rgb_g = rgb.to(torch.float32).requires_grad_(True)
        diff = tp.filter_frame(d, rgb_g, levels=4)
    assert "prefilter.fused" not in trace.records()[-1]["counters"]
    assert tp.filter_frame.launches == before
    want = tp.depth_prefilter(dp, cp, levels=4)
    want_strip = tp.depth_prefilter(dp, cp, levels=4, row_offset=-16, total_h=64, minmax=mm)
    for k in want:
        _eq(full[k], want[k].numpy())
        _eq(strip[k], want_strip[k].numpy())
    _eq(diff["unet_input"].detach(), want["unet_input"].numpy())
    diff["unet_input"].sum().backward()
    assert rgb_g.grad is not None and float(rgb_g.grad.abs().sum()) > 0


def test_filter_frame_raises_off_its_two_paths():
    """A frame neither on the CPU, in strip mode, nor requiring a gradient
    must be a CUDA frame the kernels take: anything else raises."""
    with pytest.raises(ValueError, match="filter_frame"):
        tp.filter_frame(torch.empty((32, 32), device="meta"),
                        torch.empty((32, 32, 3), dtype=torch.uint8, device="meta"))
