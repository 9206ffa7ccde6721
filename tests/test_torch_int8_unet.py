"""The port's int8 U-Net (static and dyn topologies, calibrate_act_scales)
against the JAX package's phase path in interpret mode (RTNR_SPLIT_FORCE=1),
features (16, 32) at 16x32 with quant_min_f=1, as tests/test_unet_split.py
runs it. The JAX references are computed once for the module.

Tolerances, each as a share of the exact output's range:
- static against JAX static at JAX's own scales: max 0.05, mean 0.01. Every
  static conv gives JAX's codes from the same codes (test_torch_int8_conv),
  so only the bf16 input conv's f32 accumulation order can flip a code;
- dyn against JAX dyn: max 0.10, mean 0.02 (the scale groups differ by
  design: output pixel here, lane over a row window on the TPU);
- either against the exact path: max 0.10, mean 0.02
  (tests/test_unet_split.py:130-135)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.models.fold_bn import fold_batchnorm as j_fold
from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.models.unet import calibrate_act_scales as j_calibrate
from rtnr_tpu.ops.conv_phase import conv3x3_phase, from_phase, to_phase
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales
from rtnr_tpu_torch.ops import conv as cv

FEAT = (16, 32)
H, W = 16, 32


def _keys(n):
    """The calibration keys of an n-level net (unet.py:318-332, 690-692)."""
    ks = [f"down{i}/c{j}" for i in range(n) for j in (0, 1)] + ["bottleneck/c0", "bottleneck/c1"]
    for i in range(n):
        ks += [f"u{i}t", f"updc{i}/c0"] + ([f"updc{i}/c1"] if i < n - 1 else [])
    return set(ks)


@pytest.fixture(scope="module")
def ref():
    raw = init_unet_numpy(0, FEAT)
    x = np.random.default_rng(1).standard_normal((1, H, W, 5)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    folded = j_fold(raw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTNR_SPLIT_FORCE", "1")
        base = JUNet(features=FEAT, dtype=jnp.bfloat16, fold_bn=True, skip_concat="split",
                     conv_impl="pallas")
        qnet = base.clone(quant_int8=True, quant_min_f=1)
        exact = np.asarray(base.apply(folded, xj), np.float32)
        scales = j_calibrate(base, folded, xj)
        static = np.asarray(qnet.apply(folded, xj, act_scales=scales), np.float32)
        dyn = np.asarray(qnet.apply(folded, xj), np.float32)
    return dict(raw=raw, x=x, folded=folded, exact=exact, static=static, dyn=dyn,
                scales={k: np.asarray(v) for k, v in scales.items()})


def _net(raw, **kw):
    return UNet(from_flax_variables(raw), features=FEAT, **kw)


def _within(got, want, scale, mx, mean):
    d = np.abs(got - want)
    assert d.max() <= mx * scale, (d.max(), scale)
    assert d.mean() <= mean * scale, (d.mean(), scale)


def test_calibrate_act_scales_matches_jax(ref):
    got = calibrate_act_scales(_net(ref["raw"]), torch.from_numpy(ref["x"]))
    assert set(got) == set(ref["scales"]) == _keys(len(FEAT))
    assert len(got) == 11
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), float(ref["scales"][k]), rtol=1e-2, err_msg=k)


def test_calibrate_act_scales_full_width_keys():
    feat = (64, 128, 256, 512)
    net = UNet(from_flax_variables(init_unet_numpy(0, feat)), features=feat)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 5),
                                                                   dtype=np.float32))
    got = calibrate_act_scales(net, x)
    assert set(got) == _keys(4) and len(got) == 21
    assert all(float(v) > 0 for v in got.values())


def test_static_net_matches_jax_static(ref):
    scales = {k: torch.tensor(v) for k, v in ref["scales"].items()}
    net = _net(ref["raw"], quant_int8=True, quant_min_f=1)
    y = net(torch.from_numpy(ref["x"]), act_scales=scales)
    assert y.dtype == torch.bfloat16 and y.shape == (1, H, W, 3)
    got = y.float().numpy()
    scale = max(np.abs(ref["exact"]).max(), 1e-6)
    _within(got, ref["static"], scale, 0.05, 0.01)
    _within(got, ref["exact"], scale, 0.10, 0.02)
    # the plain twin net is the same function
    twin = net.forward_plain(torch.from_numpy(ref["x"]), act_scales=scales)
    assert torch.equal(twin, y)


def test_static_input_conv_codes_match_jax(ref):
    """The share of equal int8 codes after down0/conv0 (the bf16 conv with
    int8 output, whose f32 sums may round differently)."""
    P = 1 << len(FEAT)
    p = ref["folded"]["params"]["down0"]["conv0"]
    s = ref["scales"]["down0/c0"]
    xj = to_phase(jnp.asarray(ref["x"]).astype(jnp.bfloat16), P)
    (jy,) = conv3x3_phase([xj], jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]), h=H, w=W,
                          P=P, relu=True, interpret=True, out_scale=jnp.asarray(s))
    want = np.asarray(from_phase(jy, H, W, FEAT[0], P))
    (got,) = cv.conv3x3([torch.from_numpy(ref["x"]).to(torch.bfloat16)], p["kernel"], p["bias"],
                        relu=True, out_scale=torch.tensor(s))
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    print(f"down0/conv0 int8 codes equal to JAX's: {(d == 0).mean():.6f} of {d.size}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_dyn_net_matches_jax_dyn(ref):
    net = _net(ref["raw"], quant_int8=True, quant_min_f=1)
    y = net(torch.from_numpy(ref["x"]))
    got = y.float().numpy()
    scale = max(np.abs(ref["exact"]).max(), 1e-6)
    _within(got, ref["dyn"], scale, 0.10, 0.02)
    _within(got, ref["exact"], scale, 0.10, 0.02)
    assert torch.equal(net.forward_plain(torch.from_numpy(ref["x"])), y)


def test_int8_plans_follow_the_jax_topology():
    net = UNet(from_flax_variables(init_unet_numpy(0, (64, 128, 256, 512))),
               features=(64, 128, 256, 512), quant_int8=True)
    dyn = {k for k, v in net.int8_plan().items() if v.get("quant") == "dyn"}
    # quant_min_f=256: the two deep levels, the bottleneck, and the decoder
    # levels at 512 and 256 features; never the level-0 conv0 or a ConvT
    assert dyn == {"down2/conv0", "down2/conv1", "down3/conv0", "down3/conv1",
                   "bottleneck/conv0", "bottleneck/conv1", "updc0/conv0", "updc0/conv1",
                   "updc1/conv0", "updc1/conv1"}
    scales = {k: torch.tensor(0.1) for k in _keys(4)}
    plan = net.int8_plan(scales)
    assert plan["down0/conv0"].get("quant", "") == "" and "out_scale" in plan["down0/conv0"]
    assert plan["updc3/conv1"]["out_scale"] is None
    assert plan["up2"]["in_scale"] is scales["updc1/c1"]
    assert plan["updc1/conv0"]["in_scales"] == (scales["down2/c1"], scales["u1t"])
    assert all(v["quant"] == "static" for k, v in plan.items() if k != "down0/conv0")
