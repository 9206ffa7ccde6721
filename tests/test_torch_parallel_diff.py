"""The port's point-sharded differentiable raster (rtnr_tpu_torch.parallel.
diff) and multi-rank training on four gloo ranks on the CPU, against the
JAX package (rtnr_tpu.parallel.diff on four virtual CPU devices, and its
unsharded rasterize_diff_sorted) at the JAX tests' sizes and tolerances
(tests/test_parallel_diff.py): the forward (and bit for bit against the
port's one-rank forward on integer colours), the gradients, depth ownership
by exactly one rank, the pose gradient against finite differences, the
batched (2, 2) form; then a make_train_step and a make_scene_train_step on a
(2, 2) mesh against one rank with the same global batch of two frames, the
parameters equal on every rank.

The ranks are spawned once for the module and run ``_rank_cases`` (no JAX)
while this process computes the JAX references."""

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.camera import Camera

RANKS = 4
TRAIN_W = TRAIN_H = 32
TRAIN_LEVELS = 2
FEATURES = (4, 8)
STEPS = 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_case(n=2048, w=32, h=32, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(3, 9, n)],
                   axis=1).astype(np.float32)
    cols = rng.uniform(0, 255, size=(n, 3)).astype(np.float32)
    cam = Camera.from_params(30.0, 30.0, w / 2, h / 2, w, h)
    return pts, cols, cam.cam_proj(np.eye(4)).astype(np.float32), cam


def _cotangents(cam):
    rng = np.random.default_rng(3)
    return (rng.normal(size=(cam.height, cam.width, 3)).astype(np.float32),
            rng.normal(size=(cam.height, cam.width)).astype(np.float32))


def _tie_case():
    """8 points on the centre pixel, two a rank; the exact minimum 2.0 sits
    at index 1 (rank 0) and index 5 (rank 2)."""
    cam = Camera.from_params(10, 10, 4, 4, 8, 8)
    zs = [5.0, 2.0, 5.0, 5.0, 5.0, 2.0, 5.0, 5.0]
    return (np.array([[0, 0, z] for z in zs], np.float32), np.full((8, 3), 100.0, np.float32),
            cam.cam_proj(np.eye(4)).astype(np.float32))


def _pose_case():
    """Points at exact pixel centres, so a pose step cannot move them across
    a pixel (the JAX test's construction)."""
    cam = Camera.from_params(30.0, 30.0, 16.0, 16.0, 32, 32)
    rng = np.random.default_rng(4)
    us, vs = rng.choice(32, size=64), rng.choice(32, size=64)
    zs = rng.uniform(4.0, 8.0, size=64)
    pts = np.stack([(us - 16.0) * zs / 30.0, (vs - 16.0) * zs / 30.0, zs],
                   axis=1).astype(np.float32)
    return pts, rng.uniform(0, 255, size=(64, 3)).astype(np.float32), cam


def _batch_case():
    pts, cols, M, cam = make_case(n=1024, seed=5)
    M2 = M.copy()
    M2[0, 3] += 1.5
    g = np.random.default_rng(6).normal(size=(2, cam.height, cam.width, 3)).astype(np.float32)
    return pts, cols, np.stack([M, M2]), cam, g


def _train_case():
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.scene import Scene

    scene = Scene.synthetic(8000, seed=3, extent=4.0)
    pts, cols, valid = scene.sorted_by_block().device_arrays(64)
    cam = Camera.from_params(28.0, 28.0, TRAIN_W / 2, TRAIN_H / 2, TRAIN_W, TRAIN_H)
    Ms = []
    for dx in (0.0, 0.7):
        E = np.eye(4)
        E[0, 3], E[2, 3] = dx, 7.0
        Ms.append(cam.cam_proj(E).astype(np.float32))
    targets = np.random.default_rng(8).uniform(0, 1, (2, TRAIN_H, TRAIN_W, 3)).astype(
        np.float32)
    return pts, cols, valid, np.stack(Ms), targets, init_unet_numpy(2, FEATURES)


def _train(mesh=None, scene_step=False):
    """Steps of a train step (STEPS) or a scene step (one) on the train case;
    returns the metrics of each step and the final parameters (and leaves,
    and the last step's leaf gradients)."""
    from rtnr_tpu_torch.parallel.collectives import shard_rows
    from rtnr_tpu_torch.train import trainer as tt

    pts, cols, valid, Ms, targets, variables = _train_case()
    blk = (lambda a: _t(a)) if mesh is None else (lambda a: _t(shard_rows(a, mesh, "points")))
    kw = dict(width=TRAIN_W, height=TRAIN_H, levels=TRAIN_LEVELS, mesh=mesh)
    if scene_step:
        state = tt.create_scene_train_state(variables, blk(cols).float().numpy(), Ms,
                                            features=FEATURES, learning_rate=1e-3, device="cpu")
        step = tt.make_scene_train_step(**kw)
        run = lambda s: step(s, blk(pts), blk(valid), _t(targets))
    else:
        state = tt.create_train_state(variables, features=FEATURES, learning_rate=1e-3,
                                      device="cpu")
        step = tt.make_train_step(**kw)
        run = lambda s: step(s, blk(pts), blk(cols), blk(valid), _t(Ms), _t(targets))
    metrics = []
    for _ in range(1 if scene_step else STEPS):
        state, m = run(state)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics,
           "params": {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}}
    if scene_step:
        for k in ("colors", "cam_projs"):
            out[k] = getattr(state, k).detach().numpy().copy()
            out[k + "_grad"] = getattr(state, k).grad.numpy().copy()
    return out


def _rank_cases():
    from rtnr_tpu_torch.parallel.collectives import shard_rows
    from rtnr_tpu_torch.parallel.diff import (
        rasterize_diff_point_sharded,
        rasterize_diff_sharded_batch,
    )
    from rtnr_tpu_torch.parallel.mesh import make_mesh

    npy = lambda x: x.detach().numpy()
    out = {}
    mesh = make_mesh((1, RANKS))
    blk = lambda a: _t(shard_rows(a, mesh, "points"))

    pts, cols, M, cam = make_case()
    kw = dict(width=cam.width, height=cam.height)
    o = rasterize_diff_point_sharded(blk(pts), blk(cols), _t(M), mesh, **kw)
    out["fwd"] = {k: npy(getattr(o, k)) for k in o._fields}
    o = rasterize_diff_point_sharded(blk(pts), blk(np.round(cols)), _t(M), mesh, **kw)
    out["fwd_int"] = {k: npy(getattr(o, k)) for k in o._fields}

    pts, cols, M, cam = make_case(n=1024, seed=2)
    g_rgb, g_dep = (_t(a) for a in _cotangents(cam))
    p, c, m = (blk(pts).requires_grad_(True), blk(cols).requires_grad_(True),
               _t(M).requires_grad_(True))
    o = rasterize_diff_point_sharded(p, c, m, mesh, width=cam.width, height=cam.height)
    (torch.sum(o.rgb * g_rgb) + torch.sum(torch.where(o.mask, o.depth, 0.0) * g_dep)).backward()
    out["grads"] = (npy(p.grad), npy(c.grad), npy(m.grad))

    tp, tc, tM = _tie_case()
    p = blk(tp).requires_grad_(True)
    o = rasterize_diff_point_sharded(p, blk(tc), _t(tM), mesh, width=8, height=8)
    torch.sum(torch.where(o.mask, o.depth, 0.0)).backward()
    out["tie"] = npy(p.grad)

    pp, pc, pcam = _pose_case()
    E = np.eye(4, dtype=np.float32)

    def loss_M(Mv):
        o = rasterize_diff_point_sharded(blk(pp), blk(pc), Mv, mesh, width=32, height=32)
        return torch.mean(torch.where(o.mask, o.depth, 0.0))

    Mv = _t(pcam.cam_proj(E).astype(np.float32)).requires_grad_(True)
    loss_M(Mv).backward()
    fd = []
    for tz in (1e-3, -1e-3):
        E2 = E.copy()
        E2[2, 3] = tz
        with torch.no_grad():
            fd.append(float(loss_M(_t(pcam.cam_proj(E2).astype(np.float32)))))
    out["pose"] = (npy(Mv.grad), fd)

    mesh = make_mesh((2, 2))
    blk = lambda a: _t(shard_rows(a, mesh, "points"))
    pts, cols, Ms, cam, g = _batch_case()
    c = blk(cols).requires_grad_(True)
    o = rasterize_diff_sharded_batch(blk(pts), c, _t(Ms), mesh, width=cam.width,
                                     height=cam.height)
    b = mesh.axis_index("batch")
    torch.sum(o.rgb * _t(g[b:b + 1])).backward()
    out["batch"] = {"depth": npy(o.depth), "rgb": npy(o.rgb), "g_cols": npy(c.grad)}

    out["train"] = _train(mesh)
    out["scene"] = _train(mesh, scene_step=True)
    return out


@pytest.fixture(scope="module")
def ranks():
    import pathlib

    from rtnr_tpu_torch.parallel.launch import start_ranks

    root = pathlib.Path(__file__).resolve().parents[1]
    procs = start_ranks("tests.test_torch_parallel_diff:_rank_cases", RANKS, device="cpu",
                        extra_path=[str(root)], timeout=400)
    import jax
    import jax.numpy as jnp

    from rtnr_tpu.ops.raster_diff import rasterize_diff_sorted as jdiff
    from rtnr_tpu.parallel.diff import rasterize_diff_point_sharded as jsharded
    from rtnr_tpu.parallel.mesh import make_mesh as jmesh

    ref = {}
    pts, cols, M, cam = make_case()
    # jitted: shard_map bodies run op by op otherwise
    jsh = jax.jit(jsharded, static_argnames=("mesh", "width", "height"))
    ref["fwd"] = jsh(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                     jmesh((1, RANKS), devices=jax.devices()[:RANKS]), width=cam.width,
                     height=cam.height)._asdict()

    pts, cols, M, cam = make_case(n=1024, seed=2)
    g_rgb, g_dep = (jnp.asarray(a) for a in _cotangents(cam))

    def loss(p, c, m):
        o = jdiff(p, c, m, width=cam.width, height=cam.height)
        return jnp.sum(o.rgb * g_rgb) + jnp.sum(jnp.where(o.mask, o.depth, 0.0) * g_dep)

    ref["grads"] = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M))

    pts, cols, Ms, cam, g = _batch_case()
    one = jax.jit(lambda c, m: jdiff(jnp.asarray(pts), c, m, width=cam.width,
                                     height=cam.height))
    ref["batch"] = [one(jnp.asarray(cols), jnp.asarray(m))._asdict() for m in Ms]

    def loss_1(c):
        return sum(jnp.sum(jdiff(jnp.asarray(pts), c, jnp.asarray(Ms[f]), width=cam.width,
                                 height=cam.height).rgb * g[f]) for f in range(2))

    ref["batch_g_cols"] = jax.jit(jax.grad(loss_1))(jnp.asarray(cols))
    ref = jax.tree.map(np.asarray, ref)
    ref["train"] = _train()
    ref["scene"] = _train(scene_step=True)
    return procs.wait(), ref


def test_forward_matches_jax_and_one_rank(ranks):
    from rtnr_tpu_torch.ops.raster_diff import rasterize_diff_sorted

    res, ref = ranks
    pts, cols, M, cam = make_case()
    one = rasterize_diff_sorted(_t(pts), _t(np.round(cols)), _t(M), width=cam.width,
                                height=cam.height)
    for out in res:
        for k in ("depth", "count", "mask"):
            np.testing.assert_array_equal(out["fwd"][k], ref["fwd"][k], err_msg=k)
        # f32 sums add in another order across shards
        np.testing.assert_allclose(out["fwd"]["rgb"], ref["fwd"]["rgb"], atol=0.05)
        # integer colours: every sum is exact, so the merge equals one rank's
        for k in one._fields:
            np.testing.assert_array_equal(out["fwd_int"][k], getattr(one, k).numpy(), err_msg=k)


def test_gradients_match_unsharded_jax(ranks):
    res, ref = ranks
    g_pts = np.concatenate([out["grads"][0] for out in res])
    g_cols = np.concatenate([out["grads"][1] for out in res])
    for got, want, name, tol in zip((g_pts, g_cols, res[0]["grads"][2]), ref["grads"],
                                    ("points", "colors", "cam_proj"), (1e-4, 1e-5, 2e-3)):
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)
    for out in res[1:]:  # the camera gradient is merged on every rank
        np.testing.assert_array_equal(out["grads"][2], res[0]["grads"][2])


def test_depth_gradient_owned_by_exactly_one_rank(ranks):
    res, _ = ranks
    g = np.concatenate([out["tie"] for out in res])
    receivers = [i for i in (1, 5) if abs(g[i, 2] - 1.0) < 1e-6]
    assert len(receivers) == 1, g[:, 2]
    others = [i for i in range(8) if i not in receivers]
    assert np.allclose(g[others, 2], 0.0), g[:, 2]


def test_pose_gradient_fd_on_ranks(ranks):
    from rtnr_tpu_torch.ops.raster_diff import camera_pose_gradients

    res, _ = ranks
    _, _, cam = _pose_case()
    for out in res:
        dM, (lp, lm) = out["pose"]
        dE = camera_pose_gradients(_t(dM), _t(cam.intrinsics4().astype(np.float32))).numpy()
        fd = (lp - lm) / 2e-3
        np.testing.assert_allclose(fd, float(dE[2, 3]), rtol=5e-2, atol=1e-4)
        assert abs(float(dE[2, 3])) > 0


def test_batched_matches_per_frame(ranks):
    """(batch=2, points=2): each rank's frame equals JAX's per-frame
    unsharded raster, and the colour gradients sum over both frames."""
    res, ref = ranks
    for r, out in enumerate(res):
        f = r // 2
        assert out["batch"]["rgb"].shape == (1, 32, 32, 3)
        np.testing.assert_array_equal(out["batch"]["depth"][0], ref["batch"][f]["depth"])
        np.testing.assert_allclose(out["batch"]["rgb"][0], ref["batch"][f]["rgb"], atol=0.05)
    g = np.concatenate([res[0]["batch"]["g_cols"], res[1]["batch"]["g_cols"]])
    np.testing.assert_allclose(g, ref["batch_g_cols"], atol=1e-5)
    np.testing.assert_array_equal(res[2]["batch"]["g_cols"], res[0]["batch"]["g_cols"])


@pytest.mark.parametrize("kind", ["train", "scene"])
def test_two_rank_batch_step_matches_one_rank(ranks, kind):
    """Two frames over the batch axis of a (2, 2) mesh (points split too)
    against one rank stepping both: the losses and the parameters after
    each step agree to f32 summation order, and every rank holds the same
    parameters bit for bit.

    The scene step is held for one step, and its camera matrices by their
    gradient: two of each matrix's entries have gradients at the rounding
    level of a sum that cancels (~1e-8), whose sign the summation order
    decides, and Adam's first step moves such an entry by about the
    learning rate whatever its size."""
    res, ref = ranks
    one = ref[kind]
    res = [out[kind] for out in res]
    for out in res:
        for got, want in zip(out["metrics"], one["metrics"]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        for k, v in one["params"].items():
            np.testing.assert_allclose(out["params"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(out["params"][k], res[0]["params"][k], err_msg=k)
    if kind == "scene":
        for k in ("colors", "colors_grad"):
            np.testing.assert_allclose(np.concatenate([res[0][k], res[1][k]]), one[k],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        for out in res:
            np.testing.assert_allclose(out["cam_projs_grad"], one["cam_projs_grad"], rtol=1e-3,
                                       atol=1e-6)
            np.testing.assert_array_equal(out["cam_projs"], res[0]["cam_projs"])
