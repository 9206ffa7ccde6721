"""The int8 U-Net only where the JAX package quantises: its phase path,
taken when the pyramid levels equal ``len(features)`` and the padded frame
passes the shape terms of ``phase_input_ok`` (``rtnr_tpu/models/unet.py:
210-228``, ``rtnr_tpu/pipeline.py:163-167, 453-461``). Elsewhere JAX runs
its XLA path, exact bf16, and so does the port.

Toy widths (8, 16), n = 2: a 24-row frame fails ``H % 16``, a 32-row one
passes. No interpret-mode call: the JAX reference here is the XLA path.
Tolerance against JAX: rtol/atol 5e-2, as tests/test_torch_pipeline.py
(bf16 nets, sums in another order)."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.models.fold_bn import fold_batchnorm as j_fold
from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.models.unet import phase_input_ok
from rtnr_tpu.pipeline import pyramid_pad_shape as j_pad_shape
from rtnr_tpu.pipeline import render_full as j_render_full
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales
from rtnr_tpu_torch.pipeline import Renderer, pyramid_pad_shape, render_full
from rtnr_tpu_torch.scene import Scene

FEAT = (8, 16)
W = 32
H_OFF, H_ON = 24, 32  # outside / inside the shape terms at n = 2


@pytest.fixture(scope="module")
def raw():
    return init_unet_numpy(0, FEAT)


def _net(raw, **kw):
    return UNet(from_flax_variables(raw), features=FEAT, quant_min_f=1, **kw)


def _x(h, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((1, h, W, 5))
                            .astype(np.float32))


# the JAX package's bench.py frames (width, height) at the full-width net:
# 1920x1080 quantises; the reference's export shapes 960x720 and 1440x1440 do not
BENCH_FRAMES = {(1920, 1080): True, (960, 720): False, (1440, 1440): False, (1024, 768): None,
                (2048, 1088): None}
_GATE_CASES = [pytest.param(f, None, id=f"features{i}")
               for i, f in enumerate([(8, 16), (16, 32), (64, 128, 256, 512), (12, 24)])] + [
    pytest.param((64, 128, 256, 512), wh, id=f"{wh[0]}x{wh[1]}") for wh in BENCH_FRAMES]


@pytest.mark.parametrize("features, frame", _GATE_CASES)
def test_shape_gate_is_jax_phase_input_ok(features, frame):
    """``int8_applies`` equals ``phase_input_ok``'s shape terms (its
    backend term forced) over a grid of padded shapes, or at one of
    ``bench.py``'s frames padded by each package's ``pyramid_pad_shape``."""
    jnet = JUNet(features=features, dtype=jnp.bfloat16, fold_bn=True, conv_impl="pallas")
    net = types.SimpleNamespace(features=tuple(features))  # the gate reads only the widths
    n = len(features)
    if frame is None:
        m = 1 << n
        for h in range(m, 1536 + m, m):
            for w in (m, 3 * m, 120 * m, 128 * m, 129 * m, 136 * m):
                assert UNet.int8_applies(net, h, w) == phase_input_ok(jnet, h, w, force=True), \
                    (h, w)
        return
    w, h = frame
    applies = UNet.int8_applies(net, *pyramid_pad_shape(h, w, n))
    assert applies == phase_input_ok(jnet, *j_pad_shape(h, w, n), force=True)
    if BENCH_FRAMES[frame] is not None:
        assert applies == BENCH_FRAMES[frame]


def test_unet_int8_is_exact_bf16_off_the_shape_terms(raw):
    """At 24 rows the static and dyn nets equal the bf16 net bit for bit
    (kernel path and twin); at 32 rows they quantise."""
    bf16 = _net(raw)
    static, dyn = _net(raw, quant_int8=True), _net(raw, quant_int8=True)
    for h, quantises in ((H_OFF, False), (H_ON, True)):
        x = _x(h)
        assert static.int8_applies(h, W) == quantises
        want = bf16(x)
        scales = calibrate_act_scales(bf16, x)
        for net, kw in ((static, dict(act_scales=scales)), (dyn, {})):
            got = net(x, **kw)
            assert torch.equal(net.forward_plain(x, **kw), got)
            assert torch.equal(got, want) != quantises, (h, kw.keys())
        # the levels clause: a caller pyramid that is not the net's runs bf16
        assert torch.equal(dyn(x, levels=len(FEAT) + 1), want)
        assert torch.equal(static(x, act_scales=scales, levels=len(FEAT) + 1), want)


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic(8000, seed=3, extent=3.0)


def _frame(scene, raw, h, **cfg):
    cam = Camera.from_params(20.0, 20.0, W / 2, h / 2, W, h)
    E = np.eye(4)
    E[2, 3] = 6.0
    r = Renderer(scene, RenderConfig(unet_features=FEAT, **cfg), raw, device="cpu")
    if r.unet.quant_int8:
        r.unet.quant_min_f = 1
    return r, r.compute_full(cam, E)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in ("rgb_f", "rgb", "mask", "depth"))


def test_static_renderer_skips_calibration_off_the_shape_terms(scene, raw):
    """A static Renderer at 24 rows keeps ``act_scales`` None and gives the
    bf16 Renderer's frame; a later view at 32 rows still calibrates lazily
    and quantises; a dyn Renderer likewise."""
    for mode in ("static", "dyn"):
        r, got = _frame(scene, raw, H_OFF, pyramid_levels=2, unet_int8=mode)
        _, want = _frame(scene, raw, H_OFF, pyramid_levels=2)
        assert r.act_scales is None and _same(got, want), mode
    cam = Camera.from_params(20.0, 20.0, W / 2, H_ON / 2, W, H_ON)
    E = np.eye(4)
    E[2, 3] = 6.0
    on = r.compute_full(cam, E)  # r: the dyn Renderer
    _, want_on = _frame(scene, raw, H_ON, pyramid_levels=2)
    assert not np.array_equal(on["rgb_f"], want_on["rgb_f"])
    static, _ = _frame(scene, raw, H_OFF, pyramid_levels=2, unet_int8="static")
    static_on = static.compute_full(cam, E)
    assert static.act_scales is not None and len(static.act_scales) == 11
    assert not np.array_equal(static_on["rgb_f"], want_on["rgb_f"])


@pytest.mark.parametrize("mode", ["static", "dyn"])
def test_renderer_levels_not_the_nets_run_bf16(scene, raw, mode):
    """With pyramid_levels (4) != len(features) (2) at a frame that passes
    the shape terms, int8 does not apply: no scales, and a static Renderer
    whose calibration was skipped does not fall into dyn."""
    r, got = _frame(scene, raw, H_ON, pyramid_levels=4, unet_int8=mode)
    _, want = _frame(scene, raw, H_ON, pyramid_levels=4)
    assert r.unet.int8_applies(H_ON, W) and r.act_scales is None
    assert r.calibrate(Camera.from_params(20.0, 20.0, W / 2, H_ON / 2, W, H_ON),
                       np.eye(4)) is None
    assert _same(got, want)
    # the same net at the same frame quantises when the levels match
    _, q = _frame(scene, raw, H_ON, pyramid_levels=2, unet_int8=mode)
    _, ref = _frame(scene, raw, H_ON, pyramid_levels=2)
    assert not np.array_equal(q["rgb_f"], ref["rgb_f"])


def test_render_full_int8_off_the_shape_terms_matches_jax_xla_path(monkeypatch, scene, raw):
    """JAX render_full with a quant_int8 net at 24 rows (no RTNR_SPLIT_FORCE)
    takes its XLA path, exact bf16; the port's int8 render_full equals its
    bf16 one there, and JAX's within the bf16 tolerance."""
    monkeypatch.delenv("RTNR_SPLIT_FORCE", raising=False)
    pts, cols, valid = scene.device_arrays()
    cam = Camera.from_params(20.0, 20.0, W / 2, H_OFF / 2, W, H_OFF)
    E = np.eye(4)
    E[2, 3] = 6.0
    M = cam.cam_proj(E).astype(np.float32)
    jnet = JUNet(features=FEAT, dtype=jnp.bfloat16, fold_bn=True, skip_concat="split",
                 conv_impl="pallas", quant_int8=True, quant_min_f=1)
    want = j_render_full(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                         jnp.asarray(M), jnet, j_fold(raw), width=W, height=H_OFF,
                         levels=len(FEAT))
    targs = [torch.from_numpy(a) for a in (pts, cols, valid, M)]
    got = render_full(*targs, _net(raw, quant_int8=True), width=W, height=H_OFF,
                      levels=len(FEAT))
    exact = render_full(*targs, _net(raw), width=W, height=H_OFF, levels=len(FEAT))
    assert torch.equal(got["rgb_f"], exact["rgb_f"])
    for k in ("mask", "depth", "raw_rgb", "raw_depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["rgb_f"].numpy(), np.asarray(want["rgb_f"], np.float32),
                               rtol=5e-2, atol=5e-2)
