"""The port's row-strip tiles (rtnr_tpu_torch.parallel.tiles) on four gloo
ranks on the CPU against the JAX package's rtnr_tpu.parallel.tiles on four
virtual CPU devices, at the JAX tests' sizes: tiles (4,) and tiles x points
(2, 2) bit for bit, the per-strip block-culled candidates, and the whole
strip pipeline against JAX's with its real U-Net (the raster bit for bit,
the U-Net output within f32 tolerance on the strips, the image border
among them, whose input jitted JAX computes bit for bit) and against the
one-card frame; plus, without ranks, the strip
projection, ``project_and_sort(row_offset=)`` and the strip-mode prefilter
against JAX.

The ranks are spawned once for the module and run ``_rank_cases`` (no JAX)
while this process computes the JAX references."""

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.scene import Scene

RANKS = 4
FULL_W, FULL_H, FULL_LEVELS = 64, 256, 3
FEATURES = (8, 16, 32)
HALO, UNET_HALO = 48, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case_arrays():
    scene = Scene.synthetic(30_000, seed=0, extent=8.0)
    cam = Camera.from_params(60, 60, 32, 32, 64, 64)
    E = np.eye(4)
    E[2, 3] = 10.0
    pts, cols, valid = scene.sorted_by_block().device_arrays(pad_to_multiple=8 * 8)
    return pts, cols, valid, cam.cam_proj(E).astype(np.float32)


def _room():
    scene = Scene.synthetic_room(40_000, seed=9)
    cam = Camera.from_params(80.0, 80.0, 32, 32, 64, 64)
    E = np.eye(4)
    E[2, 3] = 3.0
    return scene, cam.cam_proj(E).astype(np.float32)


def _full_case():
    scene = Scene.synthetic(60_000, seed=2, extent=6.0)
    cam = Camera.from_params(60.0, 60.0, FULL_W / 2, FULL_H / 2, FULL_W, FULL_H)
    E = np.eye(4)
    E[2, 3] = 8.0
    pts, cols, valid = scene.sorted_by_block().device_arrays(16)
    return pts, cols, valid, cam.cam_proj(E).astype(np.float32)


class _F32Net:
    """The port's f32 twin net (``UNet.forward_plain``) behind the serving
    net's call signature: the JAX test's U-Net is f32."""

    def __init__(self, raw_variables):
        from rtnr_tpu_torch.models.convert import from_flax_variables
        from rtnr_tpu_torch.models.unet import UNet

        self.net = UNet(from_flax_variables(raw_variables), features=FEATURES)

    def __call__(self, x, act_scales=None, levels=None):
        return self.net.forward_plain(x, torch.float32)


def _jax_unet_variables():
    """The JAX test's weights (``init_unet(PRNGKey(1), ...)``'s init, jitted:
    op by op it takes ~30 s), as numpy."""
    import jax
    import jax.numpy as jnp

    from rtnr_tpu.models.unet import UNet as JUNet

    x = jnp.zeros((1, FULL_H, FULL_W, 5), jnp.float32)
    raw = jax.jit(JUNet(features=FEATURES, dtype=jnp.float32).init)(jax.random.PRNGKey(1), x)
    return jax.tree.map(np.asarray, jax.device_get(dict(raw)))


def _unet_weights():
    """The strip U-Net's two weight sets, raw Flax variables: JAX's own
    init (the JAX test's) and the port's seeded random weights (random
    BatchNorm statistics, as chip_smoke's nets)."""
    from rtnr_tpu_torch.models.convert import init_unet_numpy

    return {"jax_init": _jax_unet_variables(), "seeded": init_unet_numpy(3, FEATURES)}


def _rank_cases(unet_variables):
    from rtnr_tpu_torch.ops.culling import build_block_index
    from rtnr_tpu_torch.parallel.collectives import shard_rows
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.parallel.tiles import rasterize_tile_sharded, render_full_tile_sharded

    npy = lambda x: x.detach().cpu().numpy()
    out = {}
    pts, cols, valid, M = (_t(a) for a in _case_arrays())
    mesh = make_mesh((RANKS,), ("tiles",))
    out["tiles"] = [npy(x) for x in rasterize_tile_sharded(pts, cols, valid, M, mesh,
                                                           width=64, height=64)]
    mesh2 = make_mesh((2, 2), ("tiles", "points"))
    blk = lambda a: shard_rows(a, mesh2, "points")
    out["tiles_points"] = [npy(x) for x in rasterize_tile_sharded(
        blk(pts), blk(cols), blk(valid), M, mesh2, width=64, height=64, points_axis="points")]

    scene, Mr = _room()
    p, c, v = (_t(a) for a in scene.sorted_by_block().device_arrays(8))
    index = build_block_index(scene, pad_to_multiple=8)
    out["culled"] = [npy(x) for x in rasterize_tile_sharded(
        p, c, v, _t(Mr), mesh, width=64, height=64, block_index=index,
        tile_budget=p.shape[0])]

    p, c, v, Mf = (_t(a) for a in _full_case())
    for name, raw in unet_variables.items():
        full = render_full_tile_sharded(p, c, v, Mf, mesh, _F32Net(raw), width=FULL_W,
                                        height=FULL_H, levels=FULL_LEVELS, halo=HALO,
                                        unet_halo=UNET_HALO)
        out[f"full_{name}"] = {k: npy(x) for k, x in full.items()}
    return out


def _jax_prefilter(depth, rgb, **kw):
    """JAX's prefilter of numpy images, op by op (``jax.disable_jit``), with
    the rgb channels as ``rgb * f32(1/255)``.

    Under ``jit`` XLA's CPU backend contracts the Laplacian's multiply-adds
    into FMAs, which turns some FLT_MAX-saturated sums from NaN into inf (on
    this 64x256 frame at levels 3: 114 coarse edge pixels, 2 final mask
    pixels); the port keeps the op-by-op f32 order, which JAX computes
    without ``jit``. Op by op, JAX divides ``rgb / 255.0``, which ``jit``
    folds into the multiply by the f32 reciprocal that the port mirrors
    (``ops/prefilter.py``)."""
    import jax
    import jax.numpy as jnp

    from rtnr_tpu.ops.prefilter import depth_prefilter as jpf

    with jax.disable_jit():
        out = {k: np.asarray(v) for k, v in jpf(jnp.asarray(depth), jnp.asarray(rgb),
                                                 **kw).items()}
    keep = out["mask"][..., None]
    ch = np.where(keep, rgb.astype(np.float32) * np.float32(1.0 / 255.0), np.float32(0.0))
    out["unet_input"] = np.concatenate([ch, out["unet_input"][..., 3:]], -1)
    return out


@pytest.fixture(scope="module")
def ranks():
    import pathlib

    from rtnr_tpu_torch.parallel.launch import start_ranks

    root = pathlib.Path(__file__).resolve().parents[1]
    variables = _unet_weights()
    procs = start_ranks("tests.test_torch_tiles:_rank_cases", RANKS,
                        {"unet_variables": variables}, device="cpu", extra_path=[str(root)],
                        timeout=400)
    import jax
    import jax.numpy as jnp

    from rtnr_tpu.models.fold_bn import fold_batchnorm
    from rtnr_tpu.models.unet import UNet as JUNet
    from rtnr_tpu.ops.culling import build_block_index as jindex
    from rtnr_tpu.parallel.mesh import make_mesh as jmesh
    from rtnr_tpu.parallel.tiles import rasterize_tile_sharded, render_full_tile_sharded
    from rtnr_tpu.scene import Scene as JScene

    devs = jax.devices()[:RANKS]
    # jitted: shard_map bodies run op by op otherwise
    tiles = jax.jit(rasterize_tile_sharded, static_argnames=(
        "mesh", "width", "height", "points_axis", "tile_budget"))
    pts, cols, valid, M = (jnp.asarray(a) for a in _case_arrays())
    ref = {"tiles": tiles(pts, cols, valid, M, jmesh((RANKS,), ("tiles",), devices=devs),
                          width=64, height=64),
           "tiles_points": tiles(pts, cols, valid, M,
                                 jmesh((2, 2), ("tiles", "points"), devices=devs), width=64,
                                 height=64, points_axis="points")}
    _, Mr = _room()
    jscene = JScene.synthetic_room(40_000, seed=9)
    p, c, v = (jnp.asarray(a) for a in jscene.sorted_by_block().device_arrays(8))
    ref["culled"] = tiles(p, c, v, jnp.asarray(Mr), jmesh((RANKS,), ("tiles",), devices=devs),
                          width=64, height=64, block_index=jindex(jscene, pad_to_multiple=8),
                          tile_budget=int(p.shape[0]))
    full = jax.jit(render_full_tile_sharded, static_argnames=(
        "mesh", "unet", "width", "height", "levels", "halo", "unet_halo"))
    p, c, v, Mf = (jnp.asarray(a) for a in _full_case())
    # JAX's strip pipeline with its real U-Net (the JAX test's: f32, folded
    # BatchNorm) on each weight set
    junet = JUNet(features=FEATURES, dtype=jnp.float32, fold_bn=True)
    for name, raw in variables.items():
        ref[f"full_{name}"] = full(p, c, v, Mf, jmesh((RANKS,), ("tiles",), devices=devs),
                                   junet, fold_batchnorm(raw), width=FULL_W, height=FULL_H,
                                   levels=FULL_LEVELS, halo=HALO, unet_halo=UNET_HALO)
    ref = jax.tree.map(np.asarray, ref)
    ref["unet_variables"] = variables
    return procs.wait(), ref


def test_strip_projection_and_row_offset_match_jax():
    """strip_projection's f32 bits; project_and_sort's strip rows (the full
    image's minus the offset) equal JAX's row_offset stream and the full
    stream's rows."""
    import jax.numpy as jnp

    from rtnr_tpu.ops import raster as jr
    from rtnr_tpu.parallel.tiles import strip_projection as jstrip
    from rtnr_tpu_torch.ops import raster as tr
    from rtnr_tpu_torch.parallel.tiles import strip_projection

    pts, cols, valid, M = _case_arrays()
    for t in (0, 2, 3):
        np.testing.assert_array_equal(strip_projection(_t(M), t, 16).numpy(),
                                      np.asarray(jstrip(jnp.asarray(M), jnp.int32(t), 16)))
    u, v, z = tr.project_points(_t(pts), _t(M))
    u2, v2, z2 = tr.project_points(_t(pts), strip_projection(_t(M), 2, 16))
    ok = z.numpy() > 0
    np.testing.assert_array_equal(u.numpy(), u2.numpy())
    np.testing.assert_array_equal(z.numpy(), z2.numpy())
    np.testing.assert_array_equal(v.numpy()[ok] - 32, v2.numpy()[ok])
    sp = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=64, height=16, valid=_t(valid),
                             row_offset=32)
    jsp = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M), width=64,
                              height=16, valid=jnp.asarray(valid), carriers=False,
                              row_offset=jnp.int32(32))
    np.testing.assert_array_equal(sp.pix.numpy(), np.asarray(jsp.pix))
    np.testing.assert_array_equal(sp.zbits.view(torch.float32).numpy(), np.asarray(jsp.z))
    full = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=64, height=64, valid=_t(valid))
    rows = full.pix.numpy()
    in_strip = (rows >= 32 * 64) & (rows < 48 * 64)
    np.testing.assert_array_equal(np.sort(sp.pix.numpy()[sp.pix.numpy() < 1024]),
                                  np.sort(rows[in_strip] - 32 * 64))


@pytest.mark.parametrize("t", [0, 1, 3])
def test_strip_prefilter_matches_jax_and_the_full_image(t):
    """The strip-mode prefilter on a halo-extended strip (rows [t*64 - 48,
    t*64 + 112) of a 256-row frame, filler beyond the image) against JAX's
    (``_jax_prefilter``), bit for bit, and its core rows against the
    full-image prefilter's."""
    import jax.numpy as jnp

    from rtnr_tpu_torch.config import DEPTH_EMPTY
    from rtnr_tpu_torch.ops.prefilter import depth_prefilter
    from rtnr_tpu_torch.ops.raster import depth_min_max, rasterize

    pts, cols, valid, M = (_t(a) for a in _full_case())
    rgb, depth = rasterize(pts, cols, M, width=FULL_W, height=FULL_H, valid=valid)
    strip_h, lv = 64, FULL_LEVELS
    g0 = t * strip_h - HALO
    dpad = torch.full((FULL_H + 2 * HALO, FULL_W), DEPTH_EMPTY)
    cpad = torch.zeros((FULL_H + 2 * HALO, FULL_W, 3), dtype=torch.uint8)
    dpad[HALO:HALO + FULL_H], cpad[HALO:HALO + FULL_H] = depth, rgb
    ext_d = dpad[g0 + HALO:g0 + HALO + strip_h + 2 * HALO]
    ext_c = cpad[g0 + HALO:g0 + HALO + strip_h + 2 * HALO]
    mm = depth_min_max(depth.reshape(-1))
    got = depth_prefilter(ext_d, ext_c, levels=lv, row_offset=g0, total_h=FULL_H, minmax=mm)
    want = _jax_prefilter(ext_d.numpy(), ext_c.numpy(), levels=lv, row_offset=jnp.int32(g0),
                          total_h=FULL_H,
                          minmax=(jnp.float32(mm[0].item()), jnp.float32(mm[1].item())))
    for k in ("unet_input", "filtered_depth", "filtered_rgb", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    full = depth_prefilter(depth, rgb, levels=lv)
    np.testing.assert_array_equal(got["unet_input"][HALO:HALO + strip_h].numpy(),
                                  full["unet_input"][t * strip_h:(t + 1) * strip_h].numpy())


def test_tiles_match_jax_and_one_device(ranks):
    from rtnr_tpu_torch.ops.raster import rasterize

    res, ref = ranks
    pts, cols, valid, M = (_t(a) for a in _case_arrays())
    rgb1, d1 = rasterize(pts, cols, M, width=64, height=64, valid=valid)
    for out in res:
        for case in ("tiles", "tiles_points"):
            for got, want in zip(out[case][:2], ref[case][:2]):
                np.testing.assert_array_equal(got, want, err_msg=case)
            np.testing.assert_array_equal(out[case][0], rgb1.numpy(), err_msg=case)
            np.testing.assert_array_equal(out[case][1], d1.numpy(), err_msg=case)
        np.testing.assert_array_equal(out["tiles"][2], ref["tiles"][2])


def test_tiles_candidate_gather_matches_jax_and_reduces(ranks):
    from rtnr_tpu_torch.ops.raster import rasterize

    res, ref = ranks
    scene, Mr = _room()
    p, c, v = (_t(a) for a in scene.sorted_by_block().device_arrays(8))
    rgb1, d1 = rasterize(p, c, _t(Mr), width=64, height=64, valid=v)
    n_valid = int(v.sum())
    for out in res:
        rgb, depth, cand = out["culled"]
        np.testing.assert_array_equal(rgb, rgb1.numpy())
        np.testing.assert_array_equal(depth, d1.numpy())
        for got, want in zip(out["culled"], ref["culled"]):
            np.testing.assert_array_equal(got, want)
        assert cand.shape == (RANKS,) and (cand < n_valid).all(), cand
        assert cand.sum() < 3 * n_valid


@pytest.mark.parametrize("weights", ["jax_init", "seeded"])
def test_render_full_tile_sharded_matches_jax_and_one_device(ranks, weights):
    """Against JAX's ``render_full_tile_sharded`` with its real f32 U-Net on
    the same weights: the raster bit for bit; the core U-Net input bit for
    bit but at the pixels where jitted XLA:CPU contracts the prefilter's
    Laplacian into FMAs (two on this frame, in strips 1 and 2;
    ``_jax_prefilter``, ROADMAP C13: the port equals JAX's op-by-op
    prefilter, ``test_strip_prefilter_matches_jax_and_the_full_image``);
    and ``rgb_f`` within the f32 tolerance of the port's U-Net tests (atol
    1e-4) on every row of each strip whose U-Net input (core + unet_halo
    rows) JAX computed bit for bit, which must include the first and the
    last strip, the image border. Then the one-card pipeline: raster and
    core U-Net input bit for bit; ``rgb_f`` within the JAX test's seam
    bounds (overlap-and-discard at unet_halo=16) on JAX's weights, which is
    what that test holds. With the seeded weights (random BatchNorm shifts)
    the strips miss those bounds at the image's first and last rows, where
    they still equal JAX's strips: the zeroed overlap rows beyond the image
    are JAX's algorithm, not the one-card net's padding."""
    from rtnr_tpu_torch.pipeline import render_filtered, render_full

    res, ref = ranks
    want = ref[f"full_{weights}"]
    strip_h = FULL_H // RANKS
    pts, cols, valid, M = (_t(a) for a in _full_case())
    kw = dict(width=FULL_W, height=FULL_H, levels=FULL_LEVELS)
    one = render_full(pts, cols, valid, M, _F32Net(ref["unet_variables"][weights]), **kw)
    mid = render_filtered(pts, cols, valid, M, **kw)
    for out in res:
        full = out[f"full_{weights}"]
        for k in ("raw_rgb", "raw_depth"):
            np.testing.assert_array_equal(full[k], want[k], err_msg=k)
        same_px = np.all(full["unet_input"] == want["unet_input"], axis=-1)
        assert np.count_nonzero(~same_px) <= 2, np.argwhere(~same_px)
        same_row = same_px.all(axis=1)
        clean = [t for t in range(RANKS)
                 if same_row[max(t * strip_h - UNET_HALO, 0):(t + 1) * strip_h + UNET_HALO].all()]
        assert clean[0] == 0 and clean[-1] == RANKS - 1, clean
        for t in clean:
            rows = slice(t * strip_h, (t + 1) * strip_h)
            np.testing.assert_allclose(full["rgb_f"][rows], want["rgb_f"][rows], rtol=0,
                                       atol=1e-4, err_msg=f"strip {t}")
            d8 = np.abs(full["rgb_unet"][rows].astype(np.int32)
                        - want["rgb_unet"][rows].astype(np.int32))
            assert d8.max() <= 1, (t, d8.max())
        assert full["rgb_unet"].shape == (FULL_H, FULL_W, 3)
        np.testing.assert_array_equal(full["raw_rgb"], one["raw_rgb"].numpy())
        np.testing.assert_array_equal(full["raw_depth"], one["raw_depth"].numpy())
        np.testing.assert_array_equal(full["unet_input"], mid["unet_input"].numpy())
        if weights == "jax_init":
            d = np.abs(full["rgb_f"] - one["rgb_f"].numpy())
            assert d.mean() < 2e-3 and d.max() < 0.15, (d.mean(), d.max())
