"""The port's differentiable raster (rtnr_tpu_torch.ops.raster_diff, K5 and
K2 float sums on their plain twins) against the JAX package: forward bit for
bit on integer colours (scatter form, sort form and the compact form in
Pallas interpret mode), float colour sums against an f64 numpy oracle,
gradients against jax.grad, a pose finite-difference check through the
prefilter, and the prefilter's own gradients. Inputs come from numpy seeds,
at <= 16k points, where every f32 prefix of the JAX forward is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtnr_tpu.ops import prefilter as jp
from rtnr_tpu.ops import raster as jr
from rtnr_tpu.ops import raster_diff as jd
from rtnr_tpu.ops.pipeline_diff import render_filtered_diff as j_render_filtered_diff
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.models.convert import init_unet_numpy, train_state_from_flax
from rtnr_tpu_torch.ops import prefilter as tp
from rtnr_tpu_torch.ops import raster_diff as td
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops.pipeline_diff import render_filtered_diff, render_full_diff
from rtnr_tpu_torch.ops.raster import project_and_sort_diff
from rtnr_tpu_torch.pipeline import pad_to_pyramid

W, H = 48, 32
FIELDS = ("rgb", "depth", "count", "mask")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(n, seed, integer=True):
    """Dense cloud (long segments, many in-band points per pixel) plus a
    few culled points; 10% masked out."""
    rng = np.random.default_rng(seed)
    px, py = rng.integers(0, W, n), rng.integers(0, H // 2, n)
    # half the points in a 4 cm shell, so most pixels sum several in band
    z = np.where(rng.random(n) < 0.5, rng.uniform(4.0, 4.04, n), rng.uniform(2.0, 8.0, n))
    pts = np.stack([(px - W / 2) * z / 40.0, (py - H / 2) * z / 40.0, z], 1)
    pts[: n // 50, 2] = -1.0  # behind the camera
    cols = (rng.integers(0, 256, (n, 3)) if integer else rng.uniform(0, 255, (n, 3)))
    M = Camera.from_params(40.0, 40.0, W / 2, H / 2, W, H).cam_proj(np.eye(4))
    valid = rng.random(n) < 0.9
    return pts.astype(np.float32), cols.astype(np.float32), M.astype(np.float32), valid


def _loss_weights(seed):
    return np.random.default_rng(seed).normal(size=(H, W, 3)).astype(np.float32)


def _jax_run(fn, pts, cols, M, valid, g_rgb):
    """Forward and grads of sum(rgb*w) + 1e-6*sum(where(mask, depth, 0))."""
    args = (jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M))

    def loss(p, c, m):
        o = fn(p, c, m, width=W, height=H, valid=jnp.asarray(valid))
        return jnp.sum(o.rgb * g_rgb) + 1e-6 * jnp.sum(jnp.where(o.mask, o.depth, 0.0)), o

    # jitted: the interpret-mode forward runs far faster compiled than eager
    run = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    (_, out), grads = run(*args)
    return jax.tree.map(np.asarray, out), [np.asarray(g) for g in grads]


def _port_run(pts, cols, M, valid, g_rgb):
    P, C, MM = (_t(a).requires_grad_(True) for a in (pts, cols, M))
    o = td.rasterize_diff(P, C, MM, width=W, height=H, valid=_t(valid))
    loss = torch.sum(o.rgb * _t(g_rgb)) + 1e-6 * torch.sum(torch.where(o.mask, o.depth, 0.0))
    loss.backward()
    return o, [P.grad.numpy(), C.grad.numpy(), MM.grad.numpy()]


@pytest.fixture(scope="module")
def int_case():
    pts, cols, M, valid = _case(12_000, seed=1)
    g = _loss_weights(2)
    return (pts, cols, M, valid, g), _port_run(pts, cols, M, valid, g)


def _assert_forward_equal(got: td.DiffRaster, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(), getattr(want, f),
                                      err_msg=f)


def _assert_grads(got, want):
    """Colours exact; points and cam_proj rtol 1e-5 (``gz @ pts`` sums in
    another order)."""
    gp, gc, gm = got
    np.testing.assert_array_equal(gc, want[1])
    np.testing.assert_allclose(gp, want[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(gm, want[2], rtol=1e-5, atol=1e-5 * np.abs(want[2]).max())


def test_forward_and_grads_bitexact_vs_jax_scatter_form(int_case):
    """Against JAX ``rasterize_diff`` (scatter form, plain autodiff)."""
    (pts, cols, M, valid, g), (out, grads) = int_case
    want, wgrads = _jax_run(jd.rasterize_diff, pts, cols, M, valid, g)
    _assert_forward_equal(out, want)
    assert int(out.count.sum()) > 1.3 * int(out.mask.sum())  # several points a pixel
    # the scatter form's colour gradient runs through a reverse cumsum, so
    # it is exact only up to f32 rounding there
    np.testing.assert_allclose(grads[1], wgrads[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(grads[0], wgrads[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("fwd", ["sort", "compact_interpret"])
def test_forward_and_grads_bitexact_vs_jax_sorted(int_case, fwd, monkeypatch):
    """Against JAX ``rasterize_diff_sorted`` (custom VJP) on its carrier sort
    forward and on its compact forward (K5 + float-sums K2 in interpret
    mode)."""
    monkeypatch.setenv("RTNR_DIFF_FWD", fwd)
    (pts, cols, M, valid, g), (out, grads) = int_case
    want, wgrads = _jax_run(jd.rasterize_diff_sorted, pts, cols, M, valid, g)
    _assert_forward_equal(out, want)
    _assert_grads(grads, wgrads)


def test_float_colour_sums_vs_f64_oracle():
    """Float colours: K5's per-pixel sums are the f64 sums rounded once to
    f32 (within 1 f32 ulp of a numpy f64 oracle, whose summation order
    differs); counts and head depths exact."""
    pts, cols, M, valid = _case(16_000, seed=3, integer=False)
    hw = W * H
    u, v, z = (np.asarray(a) for a in jr.project_points(jnp.asarray(pts), jnp.asarray(M)))
    ok = valid & (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pix = np.where(ok, v * W + u, hw)
    head = np.full(hw + 1, np.inf, np.float32)
    np.minimum.at(head, pix[ok], z[ok])
    in_band = ok & ~(z > head[pix] + np.float32(0.02))
    sums = np.zeros((hw, 4), np.float64)
    np.add.at(sums, pix[in_band], np.concatenate([cols, np.ones((len(cols), 1))], 1)[in_band])

    sd, _ = project_and_sort_diff(_t(pts), _t(cols), _t(M), width=W, height=H, valid=_t(valid))
    wimg, total = rr.winners_f32(sd, hw, 0.02)
    got_s, got_c, got_d = rr.expand_winners(wimg, total, hw, float_sums=True)
    want = sums.astype(np.float32)
    np.testing.assert_array_equal(got_c.numpy(), want[:, 3])
    ulp = np.spacing(np.abs(want[:, :3]))
    assert np.all(np.abs(got_s.numpy() - want[:, :3]) <= ulp)
    np.testing.assert_array_equal(got_d.numpy()[sums[:, 3] > 0], head[:hw][sums[:, 3] > 0])
    assert np.all(got_d.numpy()[sums[:, 3] == 0] == np.float32(3.4028235e38))


def test_k5_and_float_expand_twins_on_cpu_count_no_launch():
    pts, cols, M, valid = _case(500, seed=4, integer=False)
    sd, _ = project_and_sort_diff(_t(pts), _t(cols), _t(M), width=W, height=H)
    before = (rr.winners_f32.launches, rr.expand_winners.launches)
    wimg, total = rr.winners_f32(sd, W * H, 0.02)
    sums, cnt, _ = rr.expand_winners(wimg, total, W * H, float_sums=True)
    assert (rr.winners_f32.launches, rr.expand_winners.launches) == before
    assert sums.dtype == cnt.dtype == torch.float32
    ref = rr.winners_f32_plain(sd, W * H, 0.02)
    assert torch.equal(wimg, ref[0]) and torch.equal(total, ref[1])
    with pytest.raises(ValueError):
        rr.expand_winners(wimg, total, W * H, packed_out=True, float_sums=True)


def _pixel_centre_points(cam, n, seed):
    rng = np.random.default_rng(seed)
    us, vs = rng.choice(cam.width, size=n), rng.choice(cam.height, size=n)
    zs = rng.uniform(4.0, 8.0, size=n)
    pts = np.stack([(us - cam.K[0, 2]) * zs / cam.K[0, 0],
                    (vs - cam.K[1, 2]) * zs / cam.K[1, 1], zs], 1).astype(np.float32)
    return pts, rng.uniform(0, 255, size=(n, 3)).astype(np.float32)


def test_pose_gradient_fd_through_prefilter():
    """Port of tests/test_train.py::test_scene_step_pose_gradient_fd on one
    device: d(loss)/d(cam_proj) through raster -> prefilter's normalised
    depth against central differences, points at pixel centres so the
    perturbation cannot flip a pixel assignment."""
    cam = Camera.from_params(30.0, 30.0, 16.0, 16.0, 32, 32)
    pts, cols = _pixel_centre_points(cam, 64, seed=11)
    Es = [np.eye(4), np.eye(4)]
    Es[1][2, 3] = 0.1
    cams = np.stack([cam.cam_proj(E) for E in Es]).astype(np.float32)

    def loss_of_cams(c):
        total = 0.0
        for f in range(2):
            out = td.rasterize_diff(_t(pts), _t(cols), c[f], width=32, height=32)
            dpad, cpad = pad_to_pyramid(out.depth, out.rgb, 3)
            x = tp.depth_prefilter(dpad, cpad, levels=3)["unet_input"]
            total = total + torch.sum(torch.where(x[..., 4] > -1.0, x[..., 4], 0.0) ** 2)
        return total

    c = _t(cams).requires_grad_(True)
    loss_of_cams(c).backward()
    eps = 3e-4
    for (f, i, j) in [(0, 2, 0), (1, 2, 1)]:
        cp = cams.astype(np.float64).copy()
        cp[f, i, j] += eps
        lp = float(loss_of_cams(_t(cp.astype(np.float32))))
        cp[f, i, j] -= 2 * eps
        lm = float(loss_of_cams(_t(cp.astype(np.float32))))
        fd = (lp - lm) / (2 * eps)
        assert float(c.grad[f, i, j]) == pytest.approx(fd, rel=0.05, abs=5e-3), (f, i, j, fd)


def test_prefilter_gradient_vs_jax():
    """jax.grad of depth_prefilter against torch autograd on a 32x32
    depth/rgb pair, with an exact tie at the global min depth (both split
    the min's gradient evenly between tied pixels)."""
    rng = np.random.default_rng(7)
    d = rng.uniform(4.0, 9.0, (32, 32)).astype(np.float32)
    d[rng.random((32, 32)) < 0.2] = np.float32(3.4028235e38)
    d[3, 5] = d[20, 11] = np.float32(3.5)
    rgb = rng.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(32, 32, 5)).astype(np.float32)

    def jloss(dd, cc):
        return jnp.sum(jp.depth_prefilter(dd, cc, levels=4)["unet_input"] * w)

    gd, gc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(d), jnp.asarray(rgb))
    D, C = _t(d).requires_grad_(True), _t(rgb).requires_grad_(True)
    torch.sum(tp.depth_prefilter(D, C, levels=4)["unet_input"] * _t(w)).backward()
    np.testing.assert_array_equal(C.grad.numpy(), np.asarray(gc))
    gd = np.asarray(gd)
    np.testing.assert_allclose(D.grad.numpy(), gd, rtol=1e-5, atol=1e-6 * np.abs(gd).max())


def test_render_filtered_diff_vs_jax_and_full_diff_grads():
    """render_filtered_diff against JAX's (forward bit-exact, pose gradient
    of the depth channel), and render_full_diff's gradients reach the
    points, colours, camera and U-Net (tests/test_pipeline_diff.py)."""
    cam = Camera.from_params(30.0, 30.0, 16.0, 16.0, 32, 32)
    pts, cols = _pixel_centre_points(cam, 80, seed=2)
    cols = np.round(cols)  # integer colours: the JAX scatter form is exact too
    M = cam.cam_proj(np.eye(4)).astype(np.float32)

    def jl(m):
        out = j_render_filtered_diff(jnp.asarray(pts), jnp.asarray(cols), m, width=32,
                                     height=32, levels=3)
        return jnp.sum(out["unet_input"][..., 4] ** 2), out

    (_, want), jg = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(M))
    Mt = _t(M).requires_grad_(True)
    got = render_filtered_diff(_t(pts), _t(cols), Mt, width=32, height=32, levels=3)
    torch.sum(got["unet_input"][..., 4] ** 2).backward()
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(Mt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()))

    net = train_state_from_flax(init_unet_numpy(0, (4, 8))).eval()
    P, C, M2 = (_t(a).requires_grad_(True) for a in (pts, cols, M))
    y = render_full_diff(P, C, M2, net, width=32, height=32, levels=3)
    assert y.shape == (32, 32, 3)
    torch.mean(y ** 2).backward()
    for g in [P.grad, C.grad, M2.grad] + [p.grad for p in net.parameters()]:
        assert g is not None and bool(torch.isfinite(g).all())
    assert all(float(g.abs().sum()) > 0 for g in (P.grad, C.grad, M2.grad))
    assert any(float(p.grad.abs().sum()) > 0 for p in net.parameters())
