"""The port's pipeline (rtnr_tpu_torch.pipeline) against the JAX package's:
render_full against JAX render_full on its phase path (RTNR_SPLIT_FORCE=1)
at the shape of tests/test_unet_split.py:40-79, and Renderer on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.models.fold_bn import fold_batchnorm as j_fold
from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.pipeline import Renderer as JRenderer
from rtnr_tpu.pipeline import render_full as j_render_full
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.unet import UNet
from rtnr_tpu_torch.pipeline import FrameTimings, Renderer, render_full
from rtnr_tpu_torch.scene import Scene
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

FEAT = (16, 32)


def test_render_full_matches_jax_phase_path(monkeypatch):
    monkeypatch.setenv("RTNR_SPLIT_FORCE", "1")
    W, H = 32, 16
    scene = Scene.synthetic(5000, seed=0, extent=3.0)
    pts, cols, valid = scene.device_arrays()
    cam = Camera.from_params(20.0, 20.0, W / 2, H / 2, W, H)
    E = np.eye(4)
    E[2, 3] = 6.0
    M = cam.cam_proj(E).astype(np.float32)
    raw = init_unet_numpy(0, FEAT)
    junet = JUNet(features=FEAT, dtype=jnp.bfloat16, fold_bn=True, skip_concat="split",
                  conv_impl="pallas")
    want = j_render_full(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                         jnp.asarray(M), junet, j_fold(raw), width=W, height=H,
                         levels=len(FEAT))
    net = UNet(from_flax_variables(raw), features=FEAT)
    got = render_full(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(valid),
                      torch.from_numpy(M), net, width=W, height=H, levels=len(FEAT))
    assert set(got) == set(want)
    for k in ("mask", "depth", "raw_rgb", "raw_depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["rgb_f"].numpy(), np.asarray(want["rgb_f"], np.float32),
                               rtol=5e-2, atol=5e-2)
    assert got["rgb"].dtype == torch.uint8 and got["rgb"].shape == (H, W, 3)


@pytest.fixture(scope="module")
def small_setup():
    scene = Scene.synthetic(30_000, seed=0, extent=8.0)
    cam = Camera.from_params(60.0, 60.0, 32.0, 24.0, 64, 48)
    E = np.eye(4)
    E[2, 3] = 10.0
    return scene, cam, E


def test_renderer_cpu_end_to_end(small_setup):
    scene, cam, E = small_setup
    from rtnr_tpu.scene import Scene as JScene

    jscene = JScene.synthetic(30_000, seed=0, extent=8.0)
    cfg = RenderConfig(unet_features=FEAT)
    raw = init_unet_numpy(2, FEAT)
    r = Renderer(scene, cfg, raw, device="cpu")
    jr = JRenderer(jscene)
    rgbd, jrgbd = r.compute_rgbd(cam, E), jr.compute_rgbd(cam, E)
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(rgbd[k], jrgbd[k])
    filt, jfilt = r.compute_filtered_rgbd(cam, E), jr.compute_filtered_rgbd(cam, E)
    for k in jfilt:
        np.testing.assert_array_equal(filt[k], jfilt[k], err_msg=k)
    out = r.compute_full(cam, E)
    assert out["rgb"].shape == (48, 64, 3) and out["rgb"].dtype == np.uint8
    assert np.isfinite(out["rgb_f"]).all()
    np.testing.assert_array_equal(
        out["rgb"], np.clip(np.rint(out["rgb_f"] * 255.0), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(out["raw_depth"], jrgbd["depth"])
    t = r.last_timings
    assert isinstance(t, FrameTimings) and t.projection_ms > 0 and t.unet_ms > 0
    assert "projection[" in str(t) and "unet[" in str(t)
    # the f32 reference net through the same Renderer
    out32 = Renderer(scene, RenderConfig(unet_features=FEAT, unet_dtype="f32"), raw,
                     device="cpu").compute_full(cam, E)
    assert np.abs(out32["rgb_f"] - out["rgb_f"]).max() < 5e-2 * max(1.0, np.abs(out32["rgb_f"]).max())


def test_renderer_defaults_to_the_card_and_raises_without_it(small_setup):
    scene, _, _ = small_setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene)


def test_renderer_refuses_what_is_not_ported(small_setup):
    """Everything the JAX Renderer takes is ported (int8, culling, f32);
    what still raises is what JAX refuses too."""
    scene, cam, E = small_setup
    with pytest.raises(ValueError, match="unet_int8"):
        Renderer(scene, RenderConfig(unet_int8="fp8"), device="cpu")
    with pytest.raises(ValueError, match="unet_dtype"):
        Renderer(scene, RenderConfig(unet_dtype="f16"), device="cpu")
    with pytest.raises(RuntimeError, match="No U-Net"):
        Renderer(scene, device="cpu").compute_full(cam, E)
    Renderer(scene, RenderConfig(unet_int8="static"), cull_budget="auto", device="cpu")


def test_renderer_f32_net_ignores_unet_int8(small_setup):
    """unet_dtype='f32' with unet_int8='static' renders the f32 net (no
    calibration), as the JAX package's f32 net ignores int8."""
    scene, cam, E = small_setup
    raw = init_unet_numpy(2, FEAT)
    r = Renderer(scene, RenderConfig(unet_features=FEAT, unet_dtype="f32", unet_int8="static"),
                 raw, device="cpu")
    out = r.compute_full(cam, E)
    assert r.act_scales is None and not r.unet.quant_int8
    want = Renderer(scene, RenderConfig(unet_features=FEAT, unet_dtype="f32"), raw,
                    device="cpu").compute_full(cam, E)
    for k in want:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def test_timings_switch_changes_no_output(small_setup):
    """The JAX Renderer's ``timings=`` and ``RenderConfig.stage_timing``:
    accepted, and the outputs are the same bits with them on or off."""
    scene, cam, E = small_setup
    raw = init_unet_numpy(2, FEAT)
    r = Renderer(scene, RenderConfig(unet_features=FEAT), raw, device="cpu")
    rt = Renderer(scene, RenderConfig(unet_features=FEAT, stage_timing=True), raw, device="cpu")
    for name in ("compute_full", "compute_filtered_rgbd", "compute_full_tensors"):
        want = getattr(r, name)(cam, E)
        for got in (getattr(r, name)(cam, E, timings=True),
                    getattr(r, name)(cam, E, timings=False), getattr(rt, name)(cam, E)):
            assert set(got) == set(want)
            for k in want:
                a, b = got[k], want[k]
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), (name, k)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")
        t = r.last_timings
        assert t.projection_ms > 0 and t.filter_ms > 0
        assert (t.unet_ms > 0) == (name != "compute_filtered_rgbd")


@pytest.mark.parametrize("kw", [{}, dict(stage_timing=True, unet_int8="static"),
                                dict(unet_features=(16, 32), pyramid_levels=2, depth_band=0.05,
                                     unet_dtype="f32", unet_in_channels=5,
                                     unet_out_channels=3)])
def test_render_config_json_is_jax(kw):
    from rtnr_tpu.config import RenderConfig as JConfig

    c, jc = RenderConfig(**kw), JConfig(**kw)
    assert c.to_json() == jc.to_json()
    assert RenderConfig.from_json(jc.to_json()) == c
    assert JConfig.from_json(c.to_json()) == jc
    assert [f.name for f in dataclasses.fields(RenderConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
