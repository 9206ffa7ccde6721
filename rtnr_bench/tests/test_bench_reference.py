"""The plain reference against the port's CPU path at a tiny size, outputs
only: the raster and the prefilter bit for bit, the static int8 U-Net's
scales and frames, and one training step."""

import numpy as np
import pytest
import torch

from rtnr_bench import scenes, weights
from rtnr_bench.reference import render as ref
from rtnr_bench.reference.train import RefTrainer, flatten
from rtnr_bench.reference.unet import RefUNet
from rtnr_bench.traffic.room_poses import extrinsics

W, H, LEVELS, FEATURES = 64, 32, 2, (8, 16)
RC = {"depth_band": 0.02, "pyramid_levels": LEVELS, "filter_strength": 1.025,
      "gradient_filter": 0.03}


@pytest.fixture(scope="module")
def view():
    from rtnr_tpu_torch.camera import Camera

    spec = {"grid": [1, 1], "room_size": [6.0, 4.0, 3.0], "points_per_room": 30000,
            "n_clusters": 6, "noise_m": 0.01, "blob_sigma_m": 0.25}
    pts, cols = scenes.make_scene(spec, 11, "cpu")
    cam = Camera.from_params(40.0, 40.0, 32.0, 16.0, W, H)
    E = extrinsics(np.array([0.5, -0.3, 0.1]), 0.7, 0.1)
    return pts, cols, cam, E


def test_raster_and_prefilter_bit_for_bit(view):
    from rtnr_tpu_torch.ops.prefilter import depth_prefilter
    from rtnr_tpu_torch.ops.raster import rasterize
    from rtnr_tpu_torch.pipeline import pad_to_pyramid

    pts, cols, cam, E = view
    M = ref.cam_proj(cam.K, E)
    assert np.array_equal(M, cam.cam_proj(E))
    rgb, depth = rasterize(pts, cols.to(torch.float32), torch.from_numpy(M.astype(np.float32)),
                           width=W, height=H)
    r = ref.render_input(pts, cols, M, W, H, RC)
    assert torch.equal(rgb, r["raw_rgb"]) and torch.equal(depth, r["raw_depth"])
    assert int((depth < 3e38).sum()) > W * H // 4, "the view sees the room"
    pf = depth_prefilter(*pad_to_pyramid(depth, rgb, LEVELS), levels=LEVELS)
    assert torch.equal(pf["unet_input"], r["unet_input"])
    assert torch.equal(pf["mask"][:H, :W], r["mask"])
    assert torch.equal(pf["filtered_depth"][:H, :W], r["depth"])


def test_static_int8_unet(view):
    from rtnr_tpu_torch.models.convert import from_flax_variables
    from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales

    pts, cols, cam, E = view
    x = ref.render_input(pts, cols, ref.cam_proj(cam.K, E), W, H, RC)["unet_input"]
    variables = weights.unet_variables(4, FEATURES, "cpu")
    net = UNet(from_flax_variables(variables), features=FEATURES, quant_int8=True)
    scales = calibrate_act_scales(net, x[None])
    r = RefUNet(variables, FEATURES, "cpu")
    s = r.calibrate(x)
    assert set(s) == set(scales)
    for k in s:
        assert float(s[k]) == pytest.approx(float(scales[k]), rel=2 ** -8), k
    net.prepare_int8(scales)
    y = net(x[None], act_scales=scales, levels=LEVELS)[0].to(torch.float32)
    y_ref = r.forward(x, {k: v.reshape(()) for k, v in scales.items()})
    assert torch.equal(y, y_ref)
    # the int4 control is far from it
    y4 = RefUNet(variables, FEATURES, "cpu", qmax=7)
    y4 = y4.forward(x, y4.calibrate(x))
    assert float((y4 - y).abs().max()) > 0.1


def test_training_step_against_the_port_in_f32(view):
    import rtnr_tpu_torch.train.trainer as tt

    pts, cols, cam, E = view
    variables = weights.unet_variables(8, FEATURES, "cpu")
    state = tt.create_train_state(variables, features=FEATURES, dtype=torch.float32,
                                  device="cpu")
    step = tt.make_train_step(width=W, height=H, levels=LEVELS)
    M = torch.from_numpy(cam.cam_proj(E).astype(np.float32))[None]
    target = torch.rand((1, H, W, 3), generator=torch.Generator().manual_seed(3))
    state, met = step(state, pts, cols.to(torch.float32), torch.ones(len(pts), dtype=torch.bool),
                      M, target)
    r = RefTrainer(variables, FEATURES, "cpu", 1e-4)
    x = ref.render_input(pts, cols, ref.cam_proj(cam.K, E), W, H, RC)["unet_input"][None]
    loss, _, _ = r.step(x, target)
    assert float(met["loss"]) == pytest.approx(loss, rel=1e-5)
    got = {k.replace("__", "/"): p.detach() for k, p in state.model.named_parameters()}
    for k, p in r.params.items():
        assert torch.allclose(got[k], p.detach(), atol=2e-6, rtol=0), k
    stats = {k.replace("__", "/"): b for k, b in state.model.named_buffers()}
    for k, b in r.stats.items():
        assert torch.allclose(stats[k], b, atol=1e-5, rtol=1e-5), k
    assert set(flatten(variables["params"])) == set(got)
