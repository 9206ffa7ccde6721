"""The port's training path (UNetTrain, the weight converters and
train/trainer.py) against the JAX package in f32 on a one-device mesh, plus
ports of tests/test_train.py. Weights and inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rtnr_tpu.models.unet import UNet as JUNet
from rtnr_tpu.parallel.mesh import make_mesh
from rtnr_tpu.train import trainer as jt
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.models.convert import (
    from_flax_variables,
    init_unet_numpy,
    to_flax_variables,
    train_state_from_flax,
)
from rtnr_tpu_torch.models.unet import UNet
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.train import trainer as tt

FEAT = (8, 16)
W = H = 32
LEVELS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def raw():
    return init_unet_numpy(0, FEAT)


@pytest.fixture(scope="module")
def x_in():
    return np.random.default_rng(1).standard_normal((2, 16, 32, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def junet():
    return JUNet(features=FEAT, dtype=jnp.float32)


@pytest.fixture(scope="module")
def japply(junet):
    """JAX UNet.apply in eval mode, compiled once per input shape."""
    return jax.jit(junet.apply)


def test_unet_train_eval_mode_matches_jax(raw, x_in, japply):
    want = np.asarray(japply(raw, jnp.asarray(x_in)))
    with torch.no_grad():
        got = train_state_from_flax(raw).eval()(_t(x_in)).numpy()
    assert got.shape == want.shape == (2, 16, 32, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unet_train_mode_output_stats_and_grads_match_jax(raw, x_in, junet):
    """Train mode: output (1e-5 of |ref|max), the updated batch_stats (1e-6)
    and every parameter gradient of sum(y * w) (rtol 1e-4)."""
    w = np.random.default_rng(2).standard_normal((2, 16, 32, 3)).astype(np.float32)

    def jloss(params):
        y, mut = junet.apply({"params": params, "batch_stats": raw["batch_stats"]},
                             jnp.asarray(x_in), train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (want, want_stats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        raw["params"])
    model = train_state_from_flax(raw).train()
    y = model(_t(x_in))
    torch.sum(y * _t(w)).backward()
    want = np.asarray(want)
    assert np.abs(y.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got = to_flax_variables(model)
    for path, v in _leaves(_tree_np(want_stats)):
        g = got["batch_stats"]
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    grads = {k.replace("__", "/"): p.grad.numpy() for k, p in model.named_parameters()}
    checked = 0
    for path, v in _leaves(_tree_np(jgrads)):
        key = "/".join(k.key for k in path)
        np.testing.assert_allclose(grads[key], v, rtol=1e-4, atol=1e-4 * np.abs(v).max(),
                                   err_msg=key)
        checked += 1
    assert checked == len(grads)


def test_weight_round_trip_and_port_trained_model_serves(x_in, japply):
    """JAX init variables survive train_state_from_flax -> to_flax_variables
    exactly; a model trained in the port folds into the serving UNet, which
    agrees with JAX UNet.apply on the same variables (eval mode)."""
    # JAX UNet.init as init_unet runs it, compiled (op by op it takes ~20 s)
    v = _tree_np(jax.jit(JUNet(features=FEAT).init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 16, 32, 5), jnp.float32)))
    back = to_flax_variables(train_state_from_flax(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for (pa, a), (pb, b) in zip(_leaves(back), _leaves(v)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)

    state = tt.create_train_state(init_unet_numpy(3, FEAT), learning_rate=1e-2, device="cpu")
    for _ in range(2):
        state.optimizer.zero_grad()
        torch.mean(state.model.train()(_t(x_in)) ** 2).backward()
        state.optimizer.step()
    trained = to_flax_variables(state.model)
    x1 = x_in[:1]
    want = np.asarray(japply(trained, jnp.asarray(x1)))
    got = UNet(from_flax_variables(trained), features=FEAT).forward_plain(_t(x1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_l1_loss_masked():
    pred = torch.ones((1, 4, 4, 3))
    target = torch.zeros((1, 4, 4, 3))
    mask = torch.zeros((1, 4, 4))
    mask[0, 0, 0] = 1.0
    assert float(tt.l1_loss(pred, target, mask)) == pytest.approx(1.0, abs=1e-5)
    assert float(tt.l1_loss(pred, target)) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def scene_setup():
    """tests/test_train.py's setup: 8192 points, 4 frames at 32x32."""
    scene = Scene.synthetic(8192, seed=0, extent=6.0)
    pts, cols, valid = scene.sorted_by_block().device_arrays(pad_to_multiple=64)
    cam = Camera.from_params(30, 30, 16, 16, W, H)
    Es = []
    for i in range(4):
        E = np.eye(4)
        E[2, 3] = 8.0 + 0.2 * i
        Es.append(cam.cam_proj(E))
    cams = np.stack(Es).astype(np.float32)
    targets = np.random.default_rng(4).uniform(0, 1, (4, H, W, 3)).astype(np.float32)
    return pts, cols, valid, cams, targets


def _mesh():
    return make_mesh((1, 1), devices=jax.devices()[:1])


def test_train_step_matches_jax(raw, scene_setup):
    """Three steps of make_train_step against JAX's: loss per step (rtol
    1e-4); updated parameters where the last gradient is clear of zero
    (Adam's first steps move each parameter by about lr * sign(g), so a
    near-zero gradient may take either sign in the two frameworks)."""
    pts, cols, valid, cams, targets = scene_setup
    lr = 1e-3
    junet = JUNet(features=FEAT, dtype=jnp.float32)
    jstate, tx = jt.create_train_state(junet, raw, learning_rate=lr)
    jstep = jt.make_train_step(junet, tx, _mesh(), width=W, height=H, levels=LEVELS)
    state = tt.create_train_state(raw, features=FEAT, learning_rate=lr, device="cpu")
    step = tt.make_train_step(width=W, height=H, levels=LEVELS)
    jargs = [jnp.asarray(a) for a in (pts, cols, valid, cams, targets)]
    targs = [_t(a) for a in (pts, cols, valid, cams, targets)]
    for i in range(3):
        jstate, jm = jstep(jstate, *jargs)
        state, m = step(state, *targs)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4), i
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-3), i
    assert state.step == 3
    got = {k.replace("__", "/"): p for k, p in state.model.named_parameters()}
    for path, v in _leaves(_tree_np(jstate.params)):
        key = "/".join(k.key for k in path)
        p = got[key]
        clear = p.grad.abs().numpy() > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[clear], v[clear], rtol=0, atol=2 * lr,
                                   err_msg=key)


def test_loss_decreases(raw, scene_setup):
    pts, cols, valid, cams, _ = scene_setup
    state = tt.create_train_state(raw, learning_rate=3e-3, device="cpu")
    step = tt.make_train_step(width=W, height=H, levels=LEVELS)
    targets = torch.full((4, H, W, 3), 0.5)
    losses = []
    for _ in range(8):
        state, m = step(state, _t(pts), _t(cols), _t(valid), _t(cams), targets)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 8
    assert np.isfinite(losses).all()


def test_batch_stats_updated(raw, scene_setup):
    pts, cols, valid, cams, _ = scene_setup
    state = tt.create_train_state(raw, device="cpu")
    before = state.model.param("down0/bn0/mean").clone()
    step = tt.make_train_step(width=W, height=H, levels=LEVELS)
    step(state, _t(pts), _t(cols), _t(valid), _t(cams), torch.zeros((4, H, W, 3)))
    assert not torch.allclose(before, state.model.param("down0/bn0/mean"))


def test_train_state_defaults_to_the_card(raw):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.create_train_state(raw)


@pytest.fixture(scope="module")
def scene_step_result(raw, scene_setup):
    pts, cols, valid, cams, targets = scene_setup
    before = (cols.copy(), cams.copy())
    state = tt.create_scene_train_state(raw, cols, cams, learning_rate=1e-3, device="cpu")
    step = tt.make_scene_train_step(width=W, height=H, levels=LEVELS)
    state, metrics = step(state, _t(pts), _t(valid), _t(targets))
    return state, metrics, before


def test_scene_step_runs_and_moves_scene(scene_setup, scene_step_result):
    state, metrics, (cols0, cams0) = scene_step_result
    # the state's leaves are its own: the caller's arrays did not move
    np.testing.assert_array_equal(scene_setup[1], cols0)
    np.testing.assert_array_equal(scene_setup[3], cams0)
    cols0, cams0 = _t(cols0), _t(cams0)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["pose_grad_norm"]) > 0.0
    assert float(metrics["color_grad_norm"]) > 0.0
    assert not torch.allclose(state.colors.detach(), cols0)
    assert not torch.allclose(state.cam_projs.detach(), cams0)
    assert state.step == 1


def test_scene_step_matches_jax(raw, scene_setup, scene_step_result):
    """One scene fine-tune step against JAX's make_scene_train_step: loss
    and the three gradient norms (rtol 1e-3)."""
    pts, cols, valid, cams, targets = scene_setup
    _, metrics, _ = scene_step_result
    junet = JUNet(features=FEAT, dtype=jnp.float32)
    tx = optax.adam(1e-3)
    leaves = (raw["params"], jnp.asarray(cols), jnp.asarray(cams))
    jstate = jt.SceneTrainState(params=leaves[0], batch_stats=raw["batch_stats"],
                                colors=leaves[1], cam_projs=leaves[2], opt_state=tx.init(leaves))
    jstep = jt.make_scene_train_step(junet, tx, _mesh(), width=W, height=H, levels=LEVELS)
    _, jm = jstep(jstate, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(targets))
    for k in ("loss", "grad_norm", "color_grad_norm", "pose_grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-3), k
