"""The int8 serving path of the port's pipeline: render_full with a static
int8 U-Net against the JAX package's at JAX's own scales, the Renderer's
lazy calibration and modes on the CPU (pyramid_levels = len(features),
where JAX's Renderer quantises), and the trajectory-drift test of
tests/test_unet_split.py:167 through the port's Renderer(device="cpu")."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtnr_tpu.models.fold_bn import fold_batchnorm as j_fold
from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.models.unet import calibrate_act_scales as j_calibrate
from rtnr_tpu.models.unet import init_unet as j_init_unet
from rtnr_tpu.pipeline import render_filtered as j_render_filtered
from rtnr_tpu.pipeline import render_full as j_render_full
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.unet import UNet
from rtnr_tpu_torch.pipeline import Renderer, render_full
from rtnr_tpu_torch.scene import Scene

FEAT = (16, 32)
W, H = 32, 16
# int8 applies only where the pyramid levels equal the net's (JAX's phase path)
LEVELS = len(FEAT)


def _pose(cam, zdist, xshift, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    E = np.eye(4)
    E[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    E[0, 3] = xshift
    E[2, 3] = zdist
    return E


def test_render_full_static_matches_jax(monkeypatch):
    """Raster, mask and depth bit for bit; rgb_f within max 0.05 / mean 0.01
    of the range against JAX's static net at JAX's scales."""
    monkeypatch.setenv("RTNR_SPLIT_FORCE", "1")
    scene = Scene.synthetic(5000, seed=0, extent=3.0)
    pts, cols, valid = scene.device_arrays()
    cam = Camera.from_params(20.0, 20.0, W / 2, H / 2, W, H)
    E = np.eye(4)
    E[2, 3] = 6.0
    M = cam.cam_proj(E).astype(np.float32)
    raw = init_unet_numpy(0, FEAT)
    folded = j_fold(raw)
    jbase = JUNet(features=FEAT, dtype=jnp.bfloat16, fold_bn=True, skip_concat="split",
                  conv_impl="pallas")
    jargs = (jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), jnp.asarray(M))
    mid = j_render_filtered(*jargs, width=W, height=H, levels=len(FEAT))
    scales = j_calibrate(jbase, folded, mid["unet_input"][None].astype(jnp.bfloat16))
    want = j_render_full(*jargs, jbase.clone(quant_int8=True, quant_min_f=1), folded, width=W,
                         height=H, levels=len(FEAT), act_scales=scales)
    net = UNet(from_flax_variables(raw), features=FEAT, quant_int8=True, quant_min_f=1)
    tscales = {k: torch.tensor(np.asarray(v)) for k, v in scales.items()}
    targs = [torch.from_numpy(a) for a in (pts, cols, valid, M)]
    got = render_full(*targs, net, width=W, height=H, levels=len(FEAT), act_scales=tscales)
    for k in ("mask", "depth", "raw_rgb", "raw_depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    a, b = got["rgb_f"].numpy(), np.asarray(want["rgb_f"], np.float32)
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= 0.05 * scale and np.abs(a - b).mean() <= 0.01 * scale


@pytest.fixture(scope="module")
def small():
    scene = Scene.synthetic(8000, seed=3, extent=3.0)
    cam = Camera.from_params(20.0, 20.0, W / 2, H / 2, W, H)
    return scene, cam, init_unet_numpy(0, FEAT)


def test_renderer_int8_modes_on_cpu(small):
    scene, cam, raw = small
    E = _pose(cam, 8.0, 0.0, 0.0)
    exact = Renderer(scene, RenderConfig(unet_features=FEAT, pyramid_levels=LEVELS), raw,
                     device="cpu")
    ref = exact.compute_full(cam, E)
    for mode in ("static", "dyn"):
        r = Renderer(scene, RenderConfig(unet_features=FEAT, pyramid_levels=LEVELS, unet_int8=mode),
                     raw, device="cpu")
        r.unet.quant_min_f = 1  # cover every level at these widths
        assert r.unet.quant_int8 and r.act_scales is None
        out = r.compute_full(cam, E)
        assert r.last_timings.unet_ms > 0
        if mode == "static":
            assert len(r.act_scales) == 11
            assert all(v.dim() == 0 and v.device.type == "cpu" for v in r.act_scales.values())
            assert r.calibrate(cam, E) is r.act_scales  # once
        else:
            assert r.act_scales is None
        for k in ("raw_rgb", "raw_depth", "mask", "depth"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        scale = max(np.abs(ref["rgb_f"]).max(), 1e-6)
        d = np.abs(out["rgb_f"] - ref["rgb_f"])
        assert d.max() <= 0.10 * scale and d.mean() <= 0.02 * scale, (mode, d.max(), d.mean())
        assert np.abs(out["rgb_f"] - ref["rgb_f"]).max() > 0  # the int8 net ran


def test_static_int8_calibration_survives_trajectory(small):
    """Calibrate on pose 0 (lazily, in the first compute_full), then render
    12 poses from far to inside the cloud with lateral shifts and yaw: the
    static-int8 frame stays within the budget of the exact one at every
    pose (max 0.12, mean 0.02 of the range, as the JAX test). Its net, its
    pyramid levels (= len(features), where int8 applies) and its weights
    (JAX's own ``init_unet`` at PRNGKey(0)) are the JAX test's."""
    scene, cam, _ = small
    with jax.default_device(jax.devices("cpu")[0]):
        _, jraw = j_init_unet(jax.random.PRNGKey(0), H, W, features=FEAT)
    raw = jax.tree_util.tree_map(np.asarray, jraw)
    exact = Renderer(scene, RenderConfig(unet_features=FEAT, pyramid_levels=LEVELS), raw,
                     device="cpu")
    static = Renderer(scene, RenderConfig(unet_features=FEAT, pyramid_levels=LEVELS,
                                          unet_int8="static"), raw, device="cpu")
    static.unet.quant_min_f = 1
    trajectory = [_pose(cam, 8.0, 0.0, 0.0)]
    for k in range(1, 12):
        trajectory.append(_pose(cam, 8.0 - 0.55 * k, 0.3 * (k % 3 - 1), 0.06 * (k % 4 - 1.5)))
    scales = None
    for i, E in enumerate(trajectory):
        ya = exact.compute_full(cam, E)["rgb_f"]
        yq = static.compute_full(cam, E)["rgb_f"]
        scales = scales or static.act_scales
        assert static.act_scales is scales  # calibrated once, on pose 0
        scale = max(np.abs(ya).max(), 1e-6)
        assert np.abs(ya - yq).max() <= 0.12 * scale, f"pose {i} max err"
        assert np.abs(ya - yq).mean() <= 0.02 * scale, f"pose {i} mean err"
