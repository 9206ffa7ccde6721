"""The port's U-Net against the JAX package's: weight conversion, the f32
net against UNet.apply (XLA path, 1e-4, PARITY.md's conversion budget) and
the bf16 net against the phase path in interpret mode (max 5e-2 / mean
5e-3, as tests/test_unet_split.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtnr_tpu.models.fold_bn import fold_batchnorm as j_fold
from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.models.fold_bn import fold_batchnorm
from rtnr_tpu_torch.models.unet import UNet, calibrate_act_scales
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

FEAT = (16, 32)
H, W = 16, 32


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def raw_vars():
    return init_unet_numpy(0, FEAT)


@pytest.fixture(scope="module")
def x_in():
    return np.random.default_rng(1).standard_normal((1, H, W, 5)).astype(np.float32)


def test_fold_batchnorm_matches_jax(raw_vars):
    a = fold_batchnorm(raw_vars)["params"]
    b = _np_tree(j_fold(raw_vars))["params"]
    for blk in a:
        for name in a[blk]:
            for leaf in a[blk][name] if isinstance(a[blk][name], dict) else ():
                np.testing.assert_array_equal(a[blk][name][leaf], b[blk][name][leaf])


def test_from_flax_variables_raw_and_folded_agree(raw_vars):
    s_raw = from_flax_variables(raw_vars)
    s_fold = from_flax_variables(_np_tree(j_fold(raw_vars)))
    assert set(s_raw) == set(s_fold)
    for k in s_raw:
        np.testing.assert_array_equal(s_raw[k], s_fold[k])
    assert s_raw["updc0/conv0/kernel"].shape == (3, 3, 2 * FEAT[-1], FEAT[-1])
    assert s_raw["up0/kernel"].shape == (2, 2, 2 * FEAT[-1], FEAT[-1])
    assert s_raw["final_conv/kernel"].shape == (1, 1, FEAT[0], 3)
    with pytest.raises(ValueError):  # raw kernels without batch_stats cannot fold
        from_flax_variables({"params": raw_vars["params"]})


def test_flax_variable_tree_converts():
    """A variable tree shaped by the JAX package's own UNet.init (names and
    shapes, via eval_shape) converts and runs."""
    shapes = jax.eval_shape(
        JUNet(features=FEAT).init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 5)))
    rng = np.random.default_rng(3)
    v = jax.tree.map(lambda s: rng.uniform(0.5, 1.0, s.shape).astype(np.float32), shapes)
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    net = UNet(from_flax_variables(v), features=FEAT)
    y = net.forward_plain(torch.zeros((1, H, W, 5)))
    assert y.shape == (1, H, W, 3) and bool(torch.isfinite(y).all())


def test_f32_net_matches_jax_xla(raw_vars, x_in):
    jnet = JUNet(features=FEAT, dtype=jnp.float32, fold_bn=True, conv_impl="xla")
    want = np.asarray(jnet.apply(j_fold(raw_vars), jnp.asarray(x_in)))
    net = UNet(from_flax_variables(raw_vars), features=FEAT)
    got = net.forward_plain(torch.from_numpy(x_in), torch.float32).numpy()
    assert got.shape == want.shape == (1, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_net_matches_jax_phase_path(raw_vars, x_in, monkeypatch):
    monkeypatch.setenv("RTNR_SPLIT_FORCE", "1")
    jnet = JUNet(features=FEAT, dtype=jnp.bfloat16, fold_bn=True, skip_concat="split",
                 conv_impl="pallas")
    want = np.asarray(jnet.apply(j_fold(raw_vars), jnp.asarray(x_in).astype(jnp.bfloat16)),
                      np.float32)
    net = UNet(from_flax_variables(raw_vars), features=FEAT)
    got = net(torch.from_numpy(x_in))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert np.abs(got - want).mean() < 5e-3
    # the kernel-path forward on CPU is its bf16 twin net, exactly
    twin = net.forward_plain(torch.from_numpy(x_in), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, twin)


def test_unet_rejects_unpadded_input(raw_vars):
    net = UNet(from_flax_variables(raw_vars), features=FEAT)
    with pytest.raises(ValueError):
        net(torch.zeros((1, H + 2, W, 5)))


@pytest.fixture(scope="module")
def x_batch():
    return np.random.default_rng(4).standard_normal((2, H, W, 5)).astype(np.float32)


@pytest.mark.parametrize("path", ["forward", "plain_bf16", "plain_f32", "static", "dyn"])
def test_batch_equals_single_frames(raw_vars, x_batch, path):
    """A batch of 2 gives the two single-frame outputs bit for bit on every
    path (the frames run one by one on the same prepared weights)."""
    quant = path in ("static", "dyn")
    net = UNet(from_flax_variables(raw_vars), features=FEAT, quant_int8=quant)
    x = torch.from_numpy(x_batch)
    scales = None
    if path == "static":
        scales = calibrate_act_scales(UNet(from_flax_variables(raw_vars), features=FEAT), x)
    if path == "dyn":
        net.quant_min_f = 1  # quantise every level at toy widths
    fn = {"forward": lambda t: net(t), "plain_bf16": lambda t: net.forward_plain(t, torch.bfloat16),
          "plain_f32": lambda t: net.forward_plain(t, torch.float32),
          "static": lambda t: net(t, act_scales=scales),
          "dyn": lambda t: net(t)}[path]
    got = fn(x)
    assert got.shape == (2, H, W, 3)
    for i in range(2):
        assert torch.equal(got[i:i + 1], fn(x[i:i + 1])), i
    if quant:  # the int8 twins of the same topology
        twin = net.forward_plain(x, act_scales=scales)
        assert torch.equal(got, twin)


def test_batch_matches_jax_xla(raw_vars, x_batch):
    """The f32 net on a batch of 2 against JAX's ``UNet.apply`` on the same
    batch (one jitted call), within the conversion budget."""
    jnet = JUNet(features=FEAT, dtype=jnp.float32, fold_bn=True, conv_impl="xla")
    want = np.asarray(jax.jit(jnet.apply)(j_fold(raw_vars), jnp.asarray(x_batch)))
    got = UNet(from_flax_variables(raw_vars), features=FEAT).forward_plain(
        torch.from_numpy(x_batch), torch.float32).numpy()
    assert got.shape == want.shape == (2, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_calibration_over_a_batch_takes_each_layers_max(raw_vars, x_batch):
    net = UNet(from_flax_variables(raw_vars), features=FEAT)
    x = torch.from_numpy(x_batch)
    both = calibrate_act_scales(net, x)
    one, two = (calibrate_act_scales(net, x[i:i + 1]) for i in range(2))
    assert set(both) == set(one) == set(two) and len(both) == 3 * len(FEAT) + 2 + 2 * len(FEAT) - 1
    for k in both:
        assert torch.equal(both[k], torch.maximum(one[k], two[k])), k
    with pytest.raises(ValueError):
        net(torch.zeros((0, H, W, 5)))
