"""The port's alternative raster resolvers and the rest of ops/raster.py
against the JAX package: the carrier and pixel-only streams (tie-
insensitive), the carrier-stream helpers, raster_images_partitioned and
rasterize_scatter bit for bit, the carrier kernel's twin against
raster_images_pallas / _pallas2 / _pallas3 and K6's twin (+ K2) against
raster_images_pallas5 in interpret mode, and rasterize / rasterize_packed
under every RTNR_RESOLVE value. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtnr_tpu.ops import raster as jr
from rtnr_tpu.ops.raster_pallas import raster_images_pallas
from rtnr_tpu.ops.raster_pallas2 import raster_images_pallas2
from rtnr_tpu.ops.raster_pallas3 import raster_images_pallas3
from rtnr_tpu.ops.raster_pallas5 import raster_images_pallas5
from rtnr_tpu.ops.raster_partitioned import raster_images_partitioned as j_partitioned
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.ops import raster as tr
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops import raster_resolve5 as r5
from rtnr_tpu_torch.ops import raster_resolve_carriers as rc
from rtnr_tpu_torch.ops.raster_partitioned import raster_images_partitioned
from tests.test_foils import make_sp
from tests.test_raster_pallas5 import make_sp_nk1

W, H = 48, 32
HW = W * H
_FOIL = dict(part_size=1024, sub_chunk=128, interpret=True)
_PALLAS5 = dict(part_size=1024, sub_chunk=128, expand_part=512, expand_sub=128, interpret=True)
_pallas5 = jax.jit(raster_images_pallas5, static_argnums=(1, 2), static_argnames=tuple(_PALLAS5))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(n, seed, dense=True, black=0):
    """Points, float colours (the first ``black`` black), valid mask, M."""
    rng = np.random.default_rng(seed)
    if dense:
        px, py = rng.integers(0, W, n), rng.integers(0, H // 4, n)
        z = rng.uniform(2.0, 8.0, n)
        pts = np.stack([(px - W / 2) * z / 40.0, (py - H / 2) * z / 40.0, z], 1)
    else:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(2, 8, n)], 1)
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    cols[:black] = 0.0
    valid = rng.random(n) < 0.9
    M = Camera.from_params(40.0, 40.0, W / 2, H / 2, W, H).cam_proj(np.eye(4)).astype(np.float32)
    return pts.astype(np.float32), cols, valid, M


def _port_stream(sp, carriers=True):
    """The port's SortedPoints holding a JAX stream element for element."""
    rgb = np.asarray(sp.rgb)
    packed = rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16)
    if carriers:
        packed = packed | (np.asarray(sp.is_real).astype(np.int32) << 24)
    return tr.SortedPoints(_t(np.asarray(sp.pix)), _t(np.asarray(sp.z).view(np.int32)),
                           _t(packed.astype(np.int32)))


def _eq(got, want):
    """Bit-exact equality of two arrays, torch or JAX (floats as bits)."""
    g, x = np.asarray(got), np.asarray(want)
    if x.dtype == np.float32:
        g, x = g.view(np.int32), x.view(np.int32)
    np.testing.assert_array_equal(g, x)


def _images_eq(got, want):
    assert len(got) == len(want)
    for g, x in zip(got, want):
        _eq(g, x)


@pytest.mark.parametrize("carriers,depth_key", [(True, True), (True, False), (False, False)])
def test_streams_match_jax(carriers, depth_key):
    """pix (and with the depth key, z bits) as sequences; the payload as a
    multiset per key (the unstable sorts may order equal keys apart)."""
    pts, cols, valid, M = _cloud(6000, seed=3, black=40)
    sp_j = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M), width=W,
                               height=H, valid=jnp.asarray(valid), carriers=carriers,
                               depth_key=depth_key)
    sp_t = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=W, height=H, valid=_t(valid),
                               carriers=carriers, depth_key=depth_key)
    want = _port_stream(sp_j, carriers)
    assert sp_t.pix.numel() == 6000 + (HW if carriers else 0)
    _eq(sp_t.pix, want.pix.numpy())
    if depth_key:
        _eq(sp_t.zbits, want.zbits.numpy())
    rows = lambda s: np.stack([x.numpy() for x in s], 1)
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(key(rows(sp_t)), key(rows(want)))
    if carriers:  # every real point flagged, black ones included; carriers not
        assert int(tr.is_real(sp_t).sum()) == 6000


def _carrier_streams(n, seed, dense):
    pts, cols, valid, M = _cloud(n, seed, dense, black=25)
    sp_j = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M), width=W,
                               height=H, valid=jnp.asarray(valid))
    return (pts, cols, valid, M), sp_j, _port_stream(sp_j)


@pytest.mark.parametrize("dense", [False, True])
def test_carrier_helpers_bitexact_vs_jax(dense):
    """band_winners (every element), raster_images, raster_images_partitioned,
    min_depth_image, accumulate_sums without a min-depth image,
    segment_broadcast_head and gather_images_sorted on one carrier stream;
    raster_images on the port's own stream too."""
    (pts, cols, valid, M), sp_j, sp_t = _carrier_streams(6000, 5, dense)
    be_j, s4_j, zh_j = jr.band_winners(sp_j, 0.02)
    be_t, s4_t, zh_t = tr.band_winners(sp_t, HW, 0.02)
    _eq(be_t, be_j)
    _eq(s4_t, s4_j)
    _eq(zh_t, zh_j)
    want = jr.raster_images(sp_j, HW, 0.02)
    _images_eq(tr.raster_images(sp_t, HW, 0.02), want)
    _images_eq(raster_images_partitioned(sp_t, HW, 0.02), want)
    _images_eq(j_partitioned(sp_j, HW, 0.02, part_size=1024), want)
    own = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=W, height=H, valid=_t(valid),
                              carriers=True)
    _images_eq(tr.raster_images(own, HW, 0.02), want)
    _eq(tr.min_depth_image(sp_t, HW), jr.min_depth_image(sp_j, HW))
    _eq(tr.accumulate_sums(sp_t, None, HW, 0.02), jr.accumulate_sums(sp_j, None, HW, 0.02))
    vals = np.arange(sp_t.pix.numel(), dtype=np.int32) * 7
    _eq(tr.segment_broadcast_head(_t(vals), _t(np.asarray(sp_j.is_head))),
        jr.segment_broadcast_head(jnp.asarray(vals), sp_j.is_head))
    depth, cnt = want[2], want[1]
    got = tr.gather_images_sorted((_t(np.asarray(depth)), _t(np.asarray(cnt))), sp_t.pix, HW)
    ref = jr.gather_images_sorted((depth, cnt), sp_j.pix, HW)
    _images_eq(got, ref)


def test_accumulate_sums_with_global_min_depth():
    """The sharded form: one shard's carrier stream accumulates against the
    min-depth image of two shards (pixels whose local band is then empty
    get zero rows)."""
    (pts, cols, valid, M), sp_j, sp_t = _carrier_streams(6000, 5, True)
    _, other_j, _ = _carrier_streams(6000, 8, True)
    mind = jnp.minimum(jr.min_depth_image(sp_j, HW), jr.min_depth_image(other_j, HW))
    want = jr.accumulate_sums(sp_j, mind, HW, 0.02)
    local = jr.accumulate_sums(sp_j, None, HW, 0.02)
    assert 0 < int(np.asarray(want)[:, 3].sum()) < int(np.asarray(local)[:, 3].sum())
    _eq(tr.accumulate_sums(sp_t, _t(np.asarray(mind)), HW, 0.02), want)
    own = tr.project_and_sort(_t(pts), _t(cols), _t(M), width=W, height=H, valid=_t(valid),
                              carriers=True)
    _eq(tr.accumulate_sums(own, _t(np.asarray(mind)), HW, 0.02), want)


def test_black_point_at_flt_max_is_real():
    """Only the real flag tells a carrier from a black point at FLT_MAX:
    pixel 0 holds one, pixel 1 only its carrier, pixel 2 a point and a
    point past its band."""
    fmax = 0x7F7FFFFF
    z2 = np.float32([3.0, 3.5]).view(np.int32)
    pix = np.int32([0, 0, 1, 2, 2, 2, 3])
    zb = np.int32([fmax, fmax, fmax, z2[0], z2[1], fmax, fmax])
    real = 1 << 24
    packed = np.int32([real, 0, 0, real | 10 | 20 << 8, real | 255, 0, 0])
    sp = tr.SortedPoints(_t(pix), _t(zb), _t(packed))
    sums, cnt, depth = rc.resolve_carriers(sp, 4, 0.02)
    np.testing.assert_array_equal(cnt.numpy(), [1, 0, 1, 0])
    np.testing.assert_array_equal(sums.numpy(), [[0, 0, 0], [0, 0, 0], [10, 20, 0], [0, 0, 0]])
    np.testing.assert_array_equal(depth.view(torch.int32).numpy(), [fmax, fmax, z2[0], fmax])
    np.testing.assert_array_equal(tr.accumulate_sums(sp, None, 4, 0.02)[:, 3].numpy(), [1, 0, 1, 0])


@pytest.mark.parametrize("dense", [False, True])
def test_rasterize_scatter_bitexact_vs_jax_and_rasterize(dense):
    pts, cols, valid, M = _cloud(6000, seed=11, dense=dense, black=20)
    args_j = (jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M))
    args_t = (_t(pts), _t(cols), _t(M))
    rgb_j, d_j = jr.rasterize_scatter(*args_j, width=W, height=H, valid=jnp.asarray(valid))
    rgb_t, d_t = tr.rasterize_scatter(*args_t, width=W, height=H, valid=_t(valid))
    _eq(rgb_t, rgb_j)
    _eq(d_t, d_j)
    rgb_s, d_s = tr.rasterize(*args_t, width=W, height=H, valid=_t(valid))
    assert torch.equal(rgb_s, rgb_t) and torch.equal(d_s.view(torch.int32), d_t.view(torch.int32))


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_carrier_twin_bitexact_vs_pallas_foils(version):
    """The carrier kernel's twin (and the names v1-v3, which run it on the
    CPU) against the three TPU carrier resolvers in interpret mode."""
    fn = {"v1": raster_images_pallas, "v2": raster_images_pallas2,
          "v3": raster_images_pallas3}[version]
    sp_j, hw = make_sp(6000, 48, 32, seed=1, dense=True)
    want = fn(sp_j, hw, 0.02, **_FOIL)
    sp_t = _port_stream(sp_j)
    _images_eq(rc.resolve_carriers_plain(sp_t, hw, 0.02), want)
    before = rc.resolve_carriers.launches
    _images_eq(getattr(rc, f"raster_images_{version}")(sp_t, hw, 0.02), want)
    assert rc.resolve_carriers.launches == before


def _v5_case(case):
    """The JAX pixel-only stream of each K6 case, all of 6,000 elements in
    the 48x32 image, so that the interpret-mode kernel compiles once. The
    one-pixel cases put 1,500 points (two TPU parts, a partial band) or
    5,000 (beyond the one-part lookback) on one pixel in unsorted depth;
    behind-camera points fill the rest."""
    if case == "dense":
        return make_sp_nk1(6000, W, H, seed=1, dense=True)
    n = 0 if case == "empty" else int(case)
    rng = np.random.default_rng(2)
    z = rng.uniform(2.0, 2.3 if n == 1500 else 2.019, n)
    pts = np.concatenate([np.stack([np.zeros(n), np.zeros(n), z], 1),
                          np.tile([[0.0, 0.0, -5.0]], (6000 - n, 1))]).astype(np.float32)
    cols = rng.integers(0, 256, (6000, 3), dtype=np.uint8)
    M = Camera.from_params(40.0, 40.0, W / 2, H / 2, W, H).cam_proj(np.eye(4))
    return jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols),
                               jnp.asarray(M, jnp.float32), width=W, height=H,
                               carriers=False, depth_key=False)


@pytest.mark.parametrize("case", ["dense", "1500", "5000", "empty"])
def test_winners5_twin_bitexact_vs_pallas5(case):
    """K6's twin + K2 against raster_images_pallas5 in interpret mode (the
    JAX kernel takes its re-sort fallback on the 5,000-point pixel; the
    port needs none), in both output forms."""
    sp_j, hw = _v5_case(case), HW
    want = _pallas5(sp_j, hw, 0.02, **_PALLAS5)
    sp_t = _port_stream(sp_j, carriers=False)
    before = r5.winners5.launches
    got = r5.raster_images_v5(sp_t, hw, 0.02)
    _images_eq(got, want)
    packed, depth = r5.raster_images_v5(sp_t, hw, 0.02, packed_out=True)
    rgb = np.asarray(jr.resolve_uint8(want[0], want[1]))
    np.testing.assert_array_equal(tr.unpack_rgb8(packed).numpy(), rgb)
    _eq(depth, want[2])
    assert r5.winners5.launches == before
    wimg, total = r5.winners5(sp_t, hw, 0.02)
    ref = r5.winners5_plain(sp_t, hw, 0.02)
    assert torch.equal(wimg, ref[0]) and torch.equal(total, ref[1])
    if case in ("5000", "empty"):  # every point in one band / none in frame
        assert int(got[1].max()) == (5000 if case == "5000" else 0)


@pytest.mark.parametrize("mode", ["v4", "v5", "v3", "v2"])
def test_rasterize_under_each_resolve_matches_jax(mode, monkeypatch):
    """rasterize / rasterize_packed under RTNR_RESOLVE equal JAX's (which on
    the CPU takes its carrier path whatever the value) and the v4 result."""
    pts, cols, valid, M = _cloud(6000, seed=13, black=15)
    args_j = (jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M))
    kw = dict(width=W, height=H)
    rgb_j, d_j = jr.rasterize(*args_j, valid=jnp.asarray(valid), **kw)
    pk_j, dp_j = jr.rasterize_packed(*args_j, valid=jnp.asarray(valid), **kw)
    args_t = (_t(pts), _t(cols), _t(M))
    monkeypatch.setenv("RTNR_RESOLVE", mode)
    counts = lambda: (rr.winners.launches, r5.winners5.launches, rc.resolve_carriers.launches)
    before = counts()
    rgb_t, d_t = tr.rasterize(*args_t, valid=_t(valid), **kw)
    pk_t, dp_t = tr.rasterize_packed(*args_t, valid=_t(valid), **kw)
    assert counts() == before  # CPU tensors: the twins, no launch
    _eq(rgb_t, rgb_j)
    _eq(d_t, d_j)
    _eq(pk_t, pk_j)
    _eq(dp_t, dp_j)
    monkeypatch.setenv("RTNR_RESOLVE", "v4")
    rgb_4, _ = tr.rasterize(*args_t, valid=_t(valid), **kw)
    assert torch.equal(rgb_4, rgb_t)
