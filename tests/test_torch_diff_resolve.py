"""The differentiable forward's resolve on the card as one kernel
(``rtnr_resolve_diff``: K5 and K2 ``float_sums`` in one tile kernel), the
parts the CPU reaches: ``raster_images_diff`` (its plain twin here) against
the old composition ``expand_winners(*winners_f32(...), float_sums=True)``
on integer and non-integer colours, the port's forward against the JAX
package's non-Pallas ``rasterize_diff`` on integer colours (where JAX's f32
prefixes are exact), and a numpy mirror of the kernel's tile schedule
(``csrc/raster_resolve.cu``: the warp's lower-bound search, the aligned-down
window start, chunks of per-thread element groups, head marking with the
previous element, each head's f64 walk of its band prefix in stream order,
rounded once to f32, written into its pixel's tile column, and the tile's
store) held bit for bit against the twin on the streams where such a kernel
goes wrong. Torch only on one thread."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops import raster_diff as jd
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.ops import raster_diff as td
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops.raster import SortedDiff
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)
from tests.test_torch_resolve4 import (CHUNK, ELEMS, INT_MAX, P, _outputs, _tile_store,
                                       warp_lower_bound)

BAND = 0.02


# ---- the mirror ----

def mirror_resolve_diff(sd: SortedDiff, hw, band=BAND, p=P, chunk=CHUNK, elems=ELEMS):
    """``resolve_diff_window`` over every tile, ``chunk // elems`` threads a
    block: per chunk each thread marks its heads against the previous
    element, then each head walks its band prefix from the stream in f64
    (numpy's float64 adds round to nearest, as ``__dadd_rn``) and writes its
    tile column, f32 bit patterns of each sum rounded once."""
    pix, zb = (t.numpy().astype(np.int64) for t in sd[:2])
    rgb = sd.rgb.numpy()
    n = pix.size
    f32band = np.float32(band)
    outs = _outputs(hw, False)
    threads = chunk // elems
    for q0 in range(0, hw, p):
        q1 = min(q0 + p, hw)
        s, e = warp_lower_bound(pix, n, q0), warp_lower_bound(pix, n, q1)
        tile = np.zeros((5, p), np.int64)
        tile[4] = 0x7F7FFFFF  # FLT_MAX: a pixel no head reaches
        for c in range(s & ~3, e, chunk):
            for t in range(threads):
                base = c + elems * t
                # the shuffle from the lane before is element base - 1, as is lane 0's load
                prev = int(pix[base - 1]) if 0 < base <= n else -1
                for i in range(base, base + elems):
                    pi = int(pix[i]) if i < n else INT_MAX
                    if q0 <= pi < q1 and pi != prev:
                        lim = np.float32(np.int32(zb[i]).view(np.float32)) + f32band
                        acc = [np.float64(0.0)] * 4
                        k = i
                        while (k < n and pix[k] == pi
                               and not np.int32(zb[k]).view(np.float32) > lim):
                            lanes = (rgb[k, 0], rgb[k, 1], rgb[k, 2], np.float32(1.0))
                            acc = [a + np.float64(v) for a, v in zip(acc, lanes)]
                            k += 1
                        for row in range(4):
                            tile[row, pi - q0] = np.float32(acc[row]).view(np.int32)
                        tile[4, pi - q0] = zb[i]
                    prev = pi
        _tile_store(tile, q0, q1, outs, False)
    as_f32 = lambda a: torch.from_numpy(a.astype(np.int32)).view(torch.float32)
    return as_f32(outs["out0"]), as_f32(outs["count"]), as_f32(outs["depth"])


# ---- streams ----

def _stream(pix, z, cols, hw):
    """The differentiable forward's stream from numpy: pixels >= hw are
    culled (sentinel hw, +inf depth); sorted by (pixel, depth bits)."""
    pix = np.asarray(pix, np.int64)
    ok = pix < hw
    pix = np.where(ok, pix, hw).astype(np.int32)
    zb = np.where(ok, np.asarray(z, np.float32), np.float32(np.inf)).view(np.int32)
    order = np.lexsort((zb, pix))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[order]))
    return SortedDiff(pix=t(pix), zbits=t(zb), rgb=t(np.asarray(cols, np.float32)))


def _colours(rng, n, integer):
    """0..255 integers, or colours as Adam leaves them: any range, fractional."""
    if integer:
        return rng.integers(0, 256, (n, 3)).astype(np.float32)
    return rng.uniform(-40.0, 300.0, (n, 3)).astype(np.float32)


def _streams(integer):
    rng = np.random.default_rng(60 if integer else 61)
    hw = 64 * 48
    hw_odd = 4 * P + 13
    n = 9000
    # half the points in a 4 cm shell: several in-band points a pixel
    shell = lambda m: np.where(rng.random(m) < 0.5, rng.uniform(4.0, 4.04, m),
                               rng.uniform(2.0, 8.0, m))
    cols = lambda m: _colours(rng, m, integer)
    one = 3000
    z_inf = shell(n)
    z_inf[rng.random(n) < 0.2] = np.inf  # at or beyond DEPTH_EMPTY: +inf, sorted last
    return {
        "dense": (_stream(rng.integers(0, hw, n), shell(n), cols(n), hw), hw),
        # one pixel of 3,000 points in a partial band: a walk across many chunks
        "one_pixel_3000": (_stream(np.r_[np.full(one, P + 7), rng.integers(0, hw, 700)],
                                   np.r_[rng.uniform(2.0, 2.03, one), shell(700)],
                                   cols(one + 700), hw), hw),
        "inf_depths": (_stream(rng.integers(0, hw // 4, n), z_inf, cols(n), hw), hw),
        "culled": (_stream(rng.integers(0, 2 * hw, n), shell(n), cols(n), hw), hw),
        "all_culled": (_stream(np.full(700, hw), shell(700), cols(700), hw), hw),
        "empty_frame": (_stream(np.zeros(0), np.zeros(0), np.zeros((0, 3)), P + 5), P + 5),
        "hw_not_multiple_of_p": (_stream(rng.integers(0, hw_odd + 40, n), shell(n), cols(n),
                                         hw_odd), hw_odd),
    }


_STREAMS = {True: _streams(True), False: _streams(False)}
_CASES = [(name, integer) for integer in (True, False) for name in sorted(_STREAMS[integer])]


def _same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# ---- the wrapper against the old composition ----

@pytest.mark.parametrize("name,integer", _CASES)
def test_resolve_diff_equals_the_old_composition(name, integer):
    sd, hw = _STREAMS[integer][name]
    wimg, total = rr.winners_f32(sd, hw, BAND)
    want = rr.expand_winners(wimg, total, hw, float_sums=True)
    _same(rr.raster_images_diff(sd, hw, BAND), want)
    if not integer and name == "dense":
        sums = want[0]
        assert bool((sums != torch.round(sums)).any())  # the sums are not integers


# ---- the mirror against the twin ----

@pytest.mark.parametrize("name,integer", _CASES)
def test_mirror_resolve_diff_equals_the_twin(name, integer):
    sd, hw = _STREAMS[integer][name]
    _same(mirror_resolve_diff(sd, hw), rr.raster_images_diff_plain(sd, hw, BAND))


@pytest.mark.parametrize("p,chunk,elems", [(64, 32, 4), (96, 64, 8), (4096, 1024, 4)])
def test_mirror_resolve_diff_small_tiles(p, chunk, elems):
    """Many tiles and chunks a tile and windows that start at any element;
    also 8 elements a thread and a tile larger than the frame."""
    for integer in (True, False):
        sd, hw = _STREAMS[integer]["hw_not_multiple_of_p"]
        _same(mirror_resolve_diff(sd, hw, p=p, chunk=chunk, elems=elems),
              rr.raster_images_diff_plain(sd, hw, BAND))


def test_long_segment_is_exact():
    sd, hw = _STREAMS[False]["one_pixel_3000"]
    sums, count, depth = rr.raster_images_diff(sd, hw, BAND)
    seg = sd.pix == P + 7
    z = sd.zbits[seg].view(torch.float32)
    inb = ~(z > z[0] + torch.tensor(BAND))
    assert float(count[P + 7]) == int(inb.sum()) > 2 * CHUNK and float(depth[P + 7]) == z[0]
    want = np.float32(np.cumsum(sd.rgb[seg][inb].numpy().astype(np.float64), 0)[-1])
    np.testing.assert_array_equal(sums[P + 7].numpy(), want)


# ---- the forward against the JAX package ----

def _cloud(case):
    """Integer colours; points behind the camera, masked out, beyond
    DEPTH_EMPTY, or all on one pixel, per case: (pts, cols, M, valid, w, h)."""
    rng = np.random.default_rng(70)
    w, h, n = (41, 50, 6000) if case == "hw_not_multiple_of_p" else (64, 48, 6000)
    px, py = rng.integers(0, w, n), rng.integers(0, h // 2, n)
    z = np.where(rng.random(n) < 0.5, rng.uniform(4.0, 4.04, n), rng.uniform(2.0, 8.0, n))
    if case == "one_pixel_3000":
        px[:3000], py[:3000], z[:3000] = w // 2, h // 2, rng.uniform(2.0, 2.03, 3000)
    pts = np.stack([(px - w / 2) * z / 40.0, (py - h / 2) * z / 40.0, z], 1)
    pts[: n // 50, 2] = -1.0  # behind the camera
    if case == "inf_depths":
        pts[n // 2: n // 2 + 300] = [0.0, 0.0, 3.3e38]  # on the centre pixel, beyond DEPTH_EMPTY
    valid = rng.random(n) < 0.9
    if case == "empty_frame":
        valid[:] = False
    cols = rng.integers(0, 256, (n, 3)).astype(np.float32)
    M = Camera.from_params(40.0, 40.0, w / 2, h / 2, w, h).cam_proj(np.eye(4))
    return pts.astype(np.float32), cols, M.astype(np.float32), valid, w, h


@pytest.mark.parametrize("case", ["dense", "one_pixel_3000", "inf_depths", "empty_frame",
                                  "hw_not_multiple_of_p"])
def test_forward_equals_jax_rasterize_diff(case):
    pts, cols, M, valid, w, h = _cloud(case)
    want = jd.rasterize_diff(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M), width=w,
                             height=h, valid=jnp.asarray(valid))
    t = torch.from_numpy
    got = td.rasterize_diff_sorted(t(pts), t(cols), t(M), width=w, height=h, valid=t(valid))
    for f in ("rgb", "depth", "count", "mask"):
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if case == "one_pixel_3000":
        assert int(got.count.max()) > 1000
    if case == "empty_frame":
        assert not bool(got.mask.any())


def test_diff_forward_calls_the_new_wrapper_once(monkeypatch):
    """``_DiffCore.forward`` goes through ``raster_images_diff`` once a
    frame and through neither K5 nor K2; on the CPU nothing is launched."""
    calls = []
    real = rr.raster_images_diff

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(td, "raster_images_diff", counted)
    before = (rr.raster_images_diff.launches, rr.winners_f32.launches,
              rr.expand_winners.launches)
    pts, cols, M, valid, w, h = _cloud("dense")
    t = torch.from_numpy
    td.rasterize_diff_sorted(t(pts), t(cols), t(M), width=w, height=h, valid=t(valid))
    assert len(calls) == 1
    assert (rr.raster_images_diff.launches, rr.winners_f32.launches,
            rr.expand_winners.launches) == before


def test_wrapper_refuses_other_devices_and_bad_streams():
    sd, hw = _STREAMS[True]["dense"]
    with pytest.raises(ValueError, match="unsupported device"):
        rr.raster_images_diff(SortedDiff(*(x.to("meta") for x in sd)), hw, BAND)
    with pytest.raises(ValueError, match="rgb"):
        rr.raster_images_diff(SortedDiff(sd.pix, sd.zbits, sd.rgb.double()), hw, BAND)


def test_kernel_source_has_no_atomics_and_the_tile_constants():
    """The mirror's constants are csrc/raster_resolve.cu's, and the diff
    window writes its tile without atomics (one head a pixel)."""
    from rtnr_tpu_torch import _build

    src = (_build.SRC_DIR / "raster_resolve.cu").read_text()
    define = lambda name: int(src.split(f"#define {name} ")[1].split()[0], 0)
    assert define("TILE_P") == P and define("TILE_ELEMS") == ELEMS
    assert CHUNK == ELEMS * define("TILE_THREADS")
    window = src.split("resolve_diff_window(")[1].split("\n}\n")[0]
    assert "atomic" not in window and "walk_band(" in window and "write_column(" in window
    walk = src.split("void walk_band(")[1].split("\n}\n")[0]
    assert walk.count("__dadd_rn") == 4 and "break" in walk
    assert "__double2float_rn" in src.split("void write_column(")[1].split("\n}\n")[0]
    kernel = src.split("resolve_diff_tile(")[1].split("\n}\n")[0]
    assert "tile_init(tile)" in kernel and "tile_store<false>" in kernel
