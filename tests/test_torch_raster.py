"""The port's raster (rtnr_tpu_torch.ops.raster / raster_resolve4) against the
JAX package, bit for bit: projection, the carrier path's rasterize, the
numpy oracle, and raster_images_pallas4 in interpret mode (called as
tests/test_raster_pallas4.py calls it). Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtnr_tpu.camera import Camera as JCamera
from rtnr_tpu.ops import raster as jr
from rtnr_tpu.ops.raster_pallas4 import raster_images_pallas4
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.ops import raster as tr
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.scene import Scene
from tests.oracle import oracle_rasterize

# The interpret-mode reference, jitted: every call below uses the same stream
# length, image and partition sizes, so each output form compiles once.
_N, _W, _H = 6000, 48, 32
_PALLAS4 = dict(part_size=2048, sub_chunk=256, expand_part=512, expand_sub=512, interpret=True)
_pallas4 = jax.jit(raster_images_pallas4, static_argnums=(1, 2),
                   static_argnames=("packed_out",) + tuple(_PALLAS4))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_camera_and_scene_copies_match():
    from rtnr_tpu.scene import Scene as JScene

    E = np.eye(4)
    E[2, 3] = 12.0
    np.testing.assert_array_equal(
        Camera.from_params(1100, 1100, 960, 540, 1920, 1080).cam_proj(E),
        JCamera.from_params(1100, 1100, 960, 540, 1920, 1080).cam_proj(E),
    )
    a = Scene.synthetic(3000, seed=4, extent=5.0).sorted_by_block().device_arrays(1024)
    b = JScene.synthetic(3000, seed=4, extent=5.0).sorted_by_block().device_arrays(1024)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.array_equal(Scene.synthetic(3000, seed=4, extent=5.0).block_keys,
                          JScene.synthetic(3000, seed=4, extent=5.0).block_keys)


def test_project_points_bitexact_1m_bench_camera():
    """1M points at the bench camera: a matmul-ordered projection moves
    points across .5 pixel boundaries; the port's explicit order does not."""
    pts = Scene.synthetic(1_000_000, seed=0, extent=10.0).points
    cam = Camera.from_params(1100.0, 1100.0, 960.0, 540.0, 1920, 1080)
    E = np.eye(4)
    E[2, 3] = 12.0
    M = cam.cam_proj(E).astype(np.float32)
    u, v, z = jr.project_points(jnp.asarray(pts), jnp.asarray(M))
    tu, tv, tz = tr.project_points(_t(pts), _t(M))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))


def _cloud(n, w, h, seed, dense=False):
    rng = np.random.default_rng(seed)
    if dense:
        px = rng.integers(0, w, n)
        py = rng.integers(0, h // 4, n)
        z = rng.uniform(2.0, 8.0, n)
        pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1)
    else:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(2, 8, n)], 1)
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    return pts.astype(np.float32), cols, _cam_proj(w, h)


def _cam_proj(w, h):
    return Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4)).astype(np.float32)


@pytest.mark.parametrize("dense", [False, True])
def test_rasterize_bitexact_vs_jax_and_oracle(dense):
    w, h = 48, 32
    pts, cols, M = _cloud(6000, w, h, seed=5, dense=dense)
    valid = np.random.default_rng(6).random(len(pts)) < 0.9
    rgb_j, d_j = jr.rasterize(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                              width=w, height=h, valid=jnp.asarray(valid))
    rgb_t, d_t = tr.rasterize(_t(pts), _t(cols), _t(M), width=w, height=h, valid=_t(valid))
    np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    rgb_o, d_o = oracle_rasterize(pts, cols.astype(np.uint8), M, w, h, valid=valid)
    np.testing.assert_array_equal(rgb_t.numpy(), rgb_o)
    np.testing.assert_array_equal(d_t.numpy(), d_o)


def test_rasterize_packed_bitexact_vs_jax():
    w, h = 48, 32
    pts, cols, M = _cloud(6000, w, h, seed=7, dense=True)
    pk_j, d_j = jr.rasterize_packed(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                                    width=w, height=h)
    pk_t, d_t = tr.rasterize_packed(_t(pts), _t(cols), _t(M), width=w, height=h)
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(tr.unpack_rgb8(pk_t).numpy(),
                                  np.asarray(jr.unpack_rgb8(pk_j)))
    dmin, dmax = tr.depth_min_max(d_t)
    jmin, jmax = jr.depth_min_max(d_j)
    assert float(dmin) == float(jmin) and float(dmax) == float(jmax)


def _both_streams(pts, cols, M, w, h):
    sp_j = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                               width=w, height=h, carriers=False)
    sp_t = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=w, height=h)
    return sp_j, sp_t


def _assert_images_equal(got, want):
    assert len(got) == len(want)
    for g, x in zip(got, want):
        x = np.asarray(x)
        g = g.numpy()
        if x.dtype == np.float32:  # compare depth bit patterns
            g, x = g.view(np.int32), x.view(np.int32)
        np.testing.assert_array_equal(g, x)


def _pallas4_vs_port(pts, cols, M, packed_out=False):
    """Both resolves on one stream of _N points in the _W x _H image."""
    sp_j, sp_t = _both_streams(pts, cols, M, _W, _H)
    np.testing.assert_array_equal(sp_t.pix.numpy(), np.asarray(sp_j.pix))
    want = _pallas4(sp_j, _W * _H, 0.02, packed_out=packed_out, **_PALLAS4)
    got = rr.raster_images_v4(sp_t, _W * _H, 0.02, packed_out=packed_out)
    _assert_images_equal(got, want)
    return got


def _behind_camera(pts, cols):
    """Pad the cloud to _N points with culled ones (behind the camera)."""
    k = _N - len(pts)
    pad = np.tile(np.float32([[0.0, 0.0, -5.0]]), (k, 1))
    return np.concatenate([pts, pad]), np.concatenate([cols, np.full((k, 3), 7, np.float32)])


@pytest.mark.parametrize("packed_out", [False, True])
def test_raster_images_v4_bitexact_vs_pallas4_interpret(packed_out):
    _pallas4_vs_port(*_cloud(_N, _W, _H, seed=1, dense=True), packed_out=packed_out)


@pytest.mark.parametrize("dense", [False, True])
def test_raster_images_v4_bitexact_vs_carrier_path(dense):
    """Against the JAX package's carrier-path resolve (raster_images), which
    tests/test_raster_pallas4.py holds raster_images_pallas4 to."""
    w, h = 48, 32
    pts, cols, M = _cloud(6000, w, h, seed=2, dense=dense)
    sp_c = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                               width=w, height=h)
    want = jr.raster_images(sp_c, w * h, 0.02)
    sp_t = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=w, height=h)
    _assert_images_equal(rr.raster_images_v4(sp_t, w * h, 0.02), want)
    packed, depth = rr.raster_images_v4(sp_t, w * h, 0.02, packed_out=True)
    rgb = np.asarray(jr.resolve_uint8(want[0], want[1]))
    np.testing.assert_array_equal(tr.unpack_rgb8(packed).numpy(), rgb)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want[2]))


def test_raster_images_v4_band_on_one_pixel():
    """5,000 points on one pixel within one 2 cm band (one long segment,
    across the reference's partitions)."""
    n = 5000
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(2.0, 2.019, n)).astype(np.float32)
    pts = np.stack([np.zeros(n), np.zeros(n), z], 1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    got = _pallas4_vs_port(*_behind_camera(pts, cols), _cam_proj(_W, _H))
    assert int(got[1].max()) == n


def test_raster_images_v4_empty_scene():
    pts, cols = _behind_camera(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    got = _pallas4_vs_port(pts, cols, _cam_proj(_W, _H))
    assert int(got[1].sum()) == 0
    np.testing.assert_array_equal(got[2].numpy(), np.full(_W * _H, np.float32(3.4028235e38)))


def test_resolve_wrappers_take_the_twin_only_on_cpu():
    """CPU tensors run the plain twins and count no kernel launch."""
    w, h = 16, 8
    pts, cols, M = _cloud(500, w, h, seed=9)
    sp = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=w, height=h)
    counts = lambda: (rr.winners.launches, rr.expand_winners.launches,
                      rr.raster_images_v4.launches)
    before = counts()
    wimg, total = rr.winners(sp, w * h, 0.02)
    rr.expand_winners(wimg, total, w * h, packed_out=True)
    rr.raster_images_v4(sp, w * h, 0.02, packed_out=True)
    assert counts() == before
    ref = rr.winners_plain(sp, w * h, 0.02)
    assert torch.equal(wimg, ref[0]) and torch.equal(total, ref[1])
