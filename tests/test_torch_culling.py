"""Frustum culling of the port (ops/culling.py, Renderer(cull_budget=...))
against the JAX package's, the nine cases of tests/test_culling.py: masks
equal to JAX's on the same scene and poses, kept rows of the compaction
equal to JAX's, and every culled render bit for bit the unculled one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops import culling as jc
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import init_unet_numpy
from rtnr_tpu_torch.ops import culling as tc
from rtnr_tpu_torch.ops.raster import rasterize
from rtnr_tpu_torch.pipeline import Renderer
from rtnr_tpu_torch.scene import Scene


@pytest.fixture(scope="module")
def setup():
    # points spread widely so many blocks fall outside a narrow frustum
    scene = Scene.synthetic(30_000, seed=0, extent=40.0)
    jscene = JScene.synthetic(30_000, seed=0, extent=40.0)
    cam = Camera.from_params(100, 100, 32, 32, 64, 64)
    E = np.eye(4)
    E[2, 3] = 25.0
    pts, cols, valid = scene.sorted_by_block().device_arrays(8)
    M = cam.cam_proj(E).astype(np.float32)
    return scene, jscene, cam, pts, cols, valid, M


def _room(n, seed):
    """The JAX package's room-scan scene, as the port's Scene."""
    js = JScene.synthetic_room(n, seed=seed)
    return Scene.from_arrays(js.points, js.colors)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_visible_blocks_conservative_and_equal_to_jax(setup):
    scene, jscene, cam, _, _, _, M = setup
    idx = tc.build_block_index(scene, pad_to_multiple=8)
    jidx = jc.build_block_index(jscene, pad_to_multiple=8)
    np.testing.assert_array_equal(idx.corners.numpy(), np.asarray(jidx.corners))
    np.testing.assert_array_equal(idx.point_block.numpy(), np.asarray(jidx.point_block))
    vis = tc.visible_blocks(idx.corners, _t(M), cam.width, cam.height)
    np.testing.assert_array_equal(
        vis.numpy(), np.asarray(jc.visible_blocks(jidx.corners, jnp.asarray(M), cam.width,
                                                  cam.height)))
    # narrow frustum over a wide scene: a solid fraction must be culled
    frac = float(vis.float().mean())
    assert 0.0 < frac < 0.9


@pytest.mark.parametrize("margin,inflate", [(1.0, 0.0), (96.0, 0.5)])
def test_cull_points_equal_to_jax_and_render_identical(setup, margin, inflate):
    scene, jscene, cam, pts, cols, valid, M = setup
    idx = tc.build_block_index(scene, pad_to_multiple=8)
    keep = tc.cull_points(idx, _t(M), _t(valid), width=cam.width, height=cam.height,
                          margin=margin, inflate_m=inflate)
    jkeep = jc.cull_points(jc.build_block_index(jscene, pad_to_multiple=8), jnp.asarray(M),
                           jnp.asarray(valid), width=cam.width, height=cam.height,
                           margin=margin, inflate_m=inflate)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    base = rasterize(_t(pts), _t(cols), _t(M), width=cam.width, height=cam.height,
                     valid=_t(valid))
    culled = rasterize(_t(pts), _t(cols), _t(M), width=cam.width, height=cam.height,
                       valid=keep)
    for a, b in zip(base, culled):
        assert torch.equal(a, b)


def test_compacted_render_identical_and_rows_equal_to_jax(setup):
    scene, _, cam, pts, cols, valid, M = setup
    idx = tc.build_block_index(scene, pad_to_multiple=8)
    keep = tc.cull_points(idx, _t(M), _t(valid), width=cam.width, height=cam.height)
    k = int(keep.sum())
    budget = ((k + 1023) // 1024) * 1024
    cpts, ccols, cvalid = tc.compact_points(_t(pts), _t(cols), keep, budget)
    jp, jcol, jv = jc.compact_points(jnp.asarray(pts), jnp.asarray(cols),
                                     jnp.asarray(keep.numpy()), budget)
    np.testing.assert_array_equal(cvalid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(cpts.numpy()[:k], np.asarray(jp)[:k])
    np.testing.assert_array_equal(ccols.numpy()[:k], np.asarray(jcol)[:k])
    assert not cpts[k:].any()  # unused rows are zero (and invalid)
    base = rasterize(_t(pts), _t(cols), _t(M), width=cam.width, height=cam.height,
                     valid=_t(valid))
    got = rasterize(cpts, ccols, _t(M), width=cam.width, height=cam.height, valid=cvalid)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


def test_compact_overflow_drops(setup):
    _, _, _, pts, cols, valid, _ = setup
    _, _, cvalid = tc.compact_points(_t(pts), _t(cols), _t(valid), 100)
    assert int(cvalid.sum()) == 100  # clipped at budget


def test_compact_points_is_stable_and_equal_to_jax():
    """The compaction keeps exactly the masked points, in order, as JAX's
    placement sort does; overflow drops the tail."""
    rng = np.random.default_rng(5)
    n = 1000
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    keep = rng.random(n) < 0.3
    k = int(keep.sum())
    for budget in (512, 100):
        out_p, out_c, out_v = tc.compact_points(_t(pts), _t(cols), _t(keep), budget)
        jp, jcol, jv = jc.compact_points(jnp.asarray(pts), jnp.asarray(cols),
                                         jnp.asarray(keep), budget)
        m = min(k, budget)
        assert int(out_v.sum()) == m and out_c.dtype == torch.uint8
        np.testing.assert_array_equal(out_v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(out_p.numpy()[:m], pts[keep][:m])
        np.testing.assert_array_equal(out_c.numpy()[:m], cols[keep][:m])
        np.testing.assert_array_equal(out_p.numpy()[:m], np.asarray(jp)[:m])
        np.testing.assert_array_equal(out_c.numpy()[:m], np.asarray(jcol)[:m])


def test_renderer_culled_equals_full_room():
    """A camera inside a room sees a strict subset of blocks; the culled
    render equals the full one bit for bit, through compute_full too."""
    scene = _room(60_000, 3)
    cam = Camera.from_params(80.0, 80.0, 48, 32, 96, 64)
    E = np.eye(4)
    E[2, 3] = 4.0
    E[0, 3] = 1.0
    cfg = RenderConfig(unet_features=(16, 32))
    v = init_unet_numpy(0, cfg.unet_features)
    full = Renderer(scene, cfg, v, device="cpu")
    culled = Renderer(scene, cfg, v, cull_budget=60_000, device="cpu")
    a, b = full.compute_rgbd(cam, E), culled.compute_rgbd(cam, E)
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    assert culled._cull_cache["n_kept"] < scene.n_points
    fa, fb = full.compute_full(cam, E), culled.compute_full(cam, E)
    for key in ("raw_rgb", "raw_depth", "depth", "mask", "rgb_f", "rgb"):
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_renderer_cull_cache_reuse_and_invalidation():
    """Within the inflate radius the compaction is reused (and stays exact);
    beyond it, it recomputes."""
    scene = _room(40_000, 4)
    cam = Camera.from_params(80.0, 80.0, 48, 32, 96, 64)
    full = Renderer(scene, device="cpu")
    culled = Renderer(scene, cull_budget=40_000, cull_inflate_m=0.5, device="cpu")
    E = np.eye(4)
    E[2, 3] = 3.5
    culled.compute_rgbd(cam, E)
    cache0 = culled._cull_cache
    E2 = E.copy()
    E2[0, 3] += 0.2  # camera center moves 0.2 m < 0.5 m: reuse
    a, b = full.compute_rgbd(cam, E2), culled.compute_rgbd(cam, E2)
    assert culled._cull_cache is cache0
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    E3 = E.copy()
    E3[0, 3] += 2.0  # beyond it: recompute, still exact
    a, b = full.compute_rgbd(cam, E3), culled.compute_rgbd(cam, E3)
    assert culled._cull_cache is not cache0
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["rgb"], b["rgb"])


def test_renderer_overflow_falls_back_to_full_cloud():
    """A fixed budget smaller than the view's kept count must not drop
    points: the renderer renders the full cloud for that region."""
    scene = _room(40_000, 6)
    cam = Camera.from_params(80.0, 80.0, 48, 32, 96, 64)
    E = np.eye(4)
    E[2, 3] = 3.5
    full = Renderer(scene, device="cpu")
    tiny = Renderer(scene, cull_budget=64, device="cpu")  # guaranteed overflow
    a, b = full.compute_rgbd(cam, E), tiny.compute_rgbd(cam, E)
    assert tiny._cull_cache["overflowed"] and tiny._cull_cache["n_kept"] > 64
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    cache0 = tiny._cull_cache
    tiny.compute_rgbd(cam, E)
    assert tiny._cull_cache is cache0  # the fallback is cached like a compaction


def test_renderer_auto_budget():
    """cull_budget='auto' sizes the budget from the first view's kept count
    (1.5x, padded), grows it on overflow, and stays bit-exact."""
    scene = _room(40_000, 7)
    cam = Camera.from_params(80.0, 80.0, 48, 32, 96, 64)
    E = np.eye(4)
    E[2, 3] = 3.5
    full = Renderer(scene, device="cpu")
    auto = Renderer(scene, cull_budget="auto", pad_points_to=1024, device="cpu")
    a, b = full.compute_rgbd(cam, E), auto.compute_rgbd(cam, E)
    n_kept = auto._cull_cache["n_kept"]
    assert not auto._cull_cache["overflowed"]
    assert n_kept <= auto.cull_budget <= max(-(-int(1.5 * n_kept) // 1024) * 1024, 1024)
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    # a view that keeps more than the budget grows it instead of falling back
    auto.cull_budget = 1024
    E4 = E.copy()
    E4[2, 3] = 9.0
    a, b = full.compute_rgbd(cam, E4), auto.compute_rgbd(cam, E4)
    assert not auto._cull_cache["overflowed"] and auto.cull_budget >= auto._cull_cache["n_kept"]
    np.testing.assert_array_equal(a["depth"], b["depth"])
