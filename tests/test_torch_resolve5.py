"""The v5 resolve on the card as one kernel (``rtnr_resolve5``: K6 and K2 in
one tile kernel), the parts the CPU reaches: its plain twin
``raster_images_v5_plain`` against the JAX package's ``raster_images_pallas5``
in interpret mode (``test_torch_raster_resolvers.py``'s jitted reference at
its 6,000-element shape) and against the v4 twin on the same points, and a
numpy mirror of the kernel's tile schedule (``csrc/raster_resolve.cu``: the
warp's lower-bound search, the aligned-down window start, chunks of
per-thread element groups, pass A's per-run ``atomicMin`` of the depth bits
over the whole window, then pass B's band test against the final minimum
and the in-band runs added into the tile, the tile's store with the empty
depth restored) held bit for bit against the twin on projected streams and
on the streams where such a kernel goes wrong."""

import numpy as np
import pytest
import torch

from rtnr_tpu.ops import raster as jr
from rtnr_tpu_torch.ops import raster as tr
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops import raster_resolve5 as r5
from rtnr_tpu_torch.ops.raster import SortedPoints
from tests.test_torch_raster import _cloud
from tests.test_torch_raster_resolvers import (HW, _PALLAS5, _images_eq, _pallas5,
                                               _port_stream, _v5_case)
from tests.test_torch_resolve4 import (CHUNK, ELEMS, FLT_MAX_BITS, INT_MAX, P, _images,
                                       _outputs, _same, _tile_store, warp_lower_bound)

BAND = 0.02


# ---- the mirror ----

def mirror_resolve5(sp: SortedPoints, hw, band=BAND, packed_out=False, p=P, chunk=CHUNK,
                    elems=ELEMS):
    """``resolve5_window`` over every tile, ``chunk // elems`` threads a
    block: pass A over every chunk of the window, then pass B over them
    again. The tiles' order does not enter."""
    pix, zb, pk = (t.numpy().astype(np.int64) for t in sp)
    n = pix.size
    f32band = np.float32(band)
    outs = _outputs(hw, packed_out)
    threads = chunk // elems

    def groups(c):
        idx = c + np.arange(chunk)  # thread t holds elements c + elems * t ...
        inside = idx < n
        at = np.minimum(idx, max(n - 1, 0))
        take = lambda a, fill: np.where(inside, a[at] if n else 0, fill).reshape(threads, elems)
        return take(pix, INT_MAX), take(zb, 0), take(pk, 0)

    for q0 in range(0, hw, p):
        q1 = min(q0 + p, hw)
        s, e = warp_lower_bound(pix, n, q0), warp_lower_bound(pix, n, q1)
        tile = np.zeros((5, p), np.int64)
        tile[4] = INT_MAX  # MIN_EMPTY
        c0 = s & ~3
        # pass A: each thread's runs of one pixel take their minimum, then atomicMin
        for c in range(c0, e, chunk):
            gp, gz, _ = groups(c)
            cur = np.full(threads, -1, np.int64)
            zmin = np.full(threads, INT_MAX, np.int64)

            def flush_min(m):
                np.minimum.at(tile[4], cur[m] - q0, zmin[m])

            for j in range(elems):
                v = (gp[:, j] >= q0) & (gp[:, j] < q1)
                new = v & (gp[:, j] != cur)
                flush_min(new & (cur >= 0))
                zmin = np.where(new, gz[:, j], np.where(v, np.minimum(zmin, gz[:, j]), zmin))
                cur = np.where(new, gp[:, j], cur)
            flush_min(cur >= 0)
        # pass B, after the barrier: the band against the final minimum
        for c in range(c0, e, chunk):
            gp, gz, gk = groups(c)
            cur = np.full(threads, -1, np.int64)
            acc = np.zeros((4, threads), np.int64)
            lim = np.zeros(threads, np.float32)

            def flush(m):
                for row in range(4):
                    np.add.at(tile[row], cur[m] - q0, acc[row, m])

            for j in range(elems):
                v = (gp[:, j] >= q0) & (gp[:, j] < q1)
                new = v & (gp[:, j] != cur)
                flush(new & (acc[3] > 0))
                cur = np.where(new, gp[:, j], cur)
                zref = tile[4, np.clip(cur - q0, 0, p - 1)].astype(np.int32).view(np.float32)
                lim = np.where(new, zref + f32band, lim).astype(np.float32)
                acc[:, new] = 0
                z = gz[:, j].astype(np.int32).view(np.float32)
                inb = v & ~(z > lim)
                k = gk[:, j]
                acc += np.stack([k & 255, (k >> 8) & 255, (k >> 16) & 255,
                                 np.ones_like(k)]) * inb
            flush(acc[3] > 0)
        tile[4] = np.where(tile[4] == INT_MAX, FLT_MAX_BITS, tile[4])  # tile_store<_, true>
        _tile_store(tile, q0, q1, outs, packed_out)
    return _images(outs, packed_out)


# ---- streams ----

def _stream5(pix, z, cols, hw):
    """A carrier-free stream sorted by pixel id alone, the given order kept
    inside a pixel: pixels >= hw are culled (sentinel hw, +inf depth)."""
    pix = np.asarray(pix, np.int64)
    z = np.asarray(z, np.float32)
    ok = pix < hw
    pix = np.where(ok, pix, hw).astype(np.int32)
    zb = np.where(ok, z, np.float32(np.inf)).astype(np.float32).view(np.int32)
    cols = np.asarray(cols, np.int64)
    packed = (cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)).astype(np.int32)
    order = np.argsort(pix, kind="stable")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[order]))
    return SortedPoints(pix=t(pix), zbits=t(zb), packed=t(packed))


def _streams():
    rng = np.random.default_rng(50)
    one = 5000
    hw_odd = 3 * P + 517
    # short segments in descending depth: each pixel's minimum is its last element
    desc_pix = np.repeat(rng.choice(2 * P, 300, replace=False), 7)
    desc_z = np.tile(np.linspace(2.05, 2.0, 7), 300)
    return {
        # one pixel, 5,000 points in unsorted depth, a partial band: the
        # segment crosses many chunks in both passes
        "one_pixel_5000": (_stream5(np.r_[np.full(one, P + 7), rng.integers(0, 2 * P, 700)],
                                    rng.uniform(2.0, 2.3, one + 700),
                                    rng.integers(0, 256, (one + 700, 3)), 2 * P), 2 * P),
        # the 5,000-point segment's minimum is its last element
        "one_pixel_min_last": (_stream5(np.full(one, 100), np.r_[rng.uniform(2.015, 2.3, one - 1),
                                                                 2.0],
                                        rng.integers(0, 256, (one, 3)), P), P),
        "min_last_short": (_stream5(desc_pix, desc_z, rng.integers(0, 256, (2100, 3)), 2 * P),
                           2 * P),
        "all_culled": (_stream5(rng.choice([2 * P, 5 * P], 700), rng.uniform(2, 3, 700),
                                rng.integers(0, 256, (700, 3)), 2 * P), 2 * P),
        "empty_frame": (_stream5(np.zeros(0), np.zeros(0), np.zeros((0, 3)), P + 5), P + 5),
        "hw_not_multiple_of_p": (_stream5(rng.integers(0, hw_odd + 40, 9000),
                                          rng.uniform(2.0, 2.05, 9000),
                                          rng.integers(0, 256, (9000, 3)), hw_odd), hw_odd),
    }


_STREAMS = _streams()


def _v4_of(sp: SortedPoints) -> SortedPoints:
    """The same elements sorted by (pixel, depth bits), for the v4 twin."""
    order = np.lexsort((sp.zbits.numpy(), sp.pix.numpy()))
    return SortedPoints(*(torch.from_numpy(np.ascontiguousarray(t.numpy()[order])) for t in sp))


def _projected(w, h, n, seed, dense):
    pts, cols, M = _cloud(n, w, h, seed=seed, dense=dense)
    return tr.project_and_sort(torch.from_numpy(pts), torch.from_numpy(cols),
                               torch.from_numpy(M), width=w, height=h, depth_key=False)


# ---- the twin against JAX and against v4 ----

def test_twin_bitexact_vs_pallas5_interpret():
    """The fused twin against raster_images_pallas5 (interpret mode, the
    jitted 6,000-element shape) on a dense cloud, in both forms."""
    sp_j = _v5_case("dense")
    want = _pallas5(sp_j, HW, BAND, **_PALLAS5)
    sp_t = _port_stream(sp_j, carriers=False)
    _images_eq(r5.raster_images_v5_plain(sp_t, HW, BAND), want)
    packed, depth = r5.raster_images_v5_plain(sp_t, HW, BAND, packed_out=True)
    np.testing.assert_array_equal(tr.unpack_rgb8(packed).numpy(),
                                  np.asarray(jr.resolve_uint8(want[0], want[1])))
    assert torch.equal(depth.view(torch.int32),
                       torch.from_numpy(np.array(want[2])).view(torch.int32))


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("packed_out", [False, True])
def test_twin_equals_the_v4_twin(name, packed_out):
    sp, hw = _STREAMS[name]
    _same(r5.raster_images_v5_plain(sp, hw, BAND, packed_out),
          rr.raster_images_v4_plain(_v4_of(sp), hw, BAND, packed_out))


# ---- the mirror against the twin ----

@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("packed_out", [False, True])
def test_mirror_resolve5_equals_the_twin(name, packed_out):
    sp, hw = _STREAMS[name]
    _same(mirror_resolve5(sp, hw, packed_out=packed_out),
          r5.raster_images_v5_plain(sp, hw, BAND, packed_out))


def test_the_long_segment_crosses_chunks_and_its_minimum_is_last():
    sp, hw = _STREAMS["one_pixel_min_last"]
    n = sp.pix.numel()
    assert n > 8 * CHUNK and int(sp.zbits[-1]) == int(sp.zbits.min())
    _, count, depth = mirror_resolve5(sp, hw)
    assert float(depth[100]) == np.float32(2.0)
    want = int((sp.zbits.view(torch.float32) <= torch.tensor(2.0) + torch.tensor(BAND)).sum())
    assert int(count[100]) == want and int(count.sum()) == want


@pytest.mark.parametrize("p,chunk,elems", [(64, 32, 4), (128, 64, 4), (96, 64, 8),
                                           (2048, 1024, 4)])
@pytest.mark.parametrize("dense", [False, True])
def test_mirror_resolve5_small_tiles_on_projected_streams(p, chunk, elems, dense):
    """Many tiles and chunks a tile and windows that start at any element;
    also 8 elements a thread and a tile larger than the frame."""
    w, h = 40, 26  # hw = 1040, a multiple of none of the tile sizes
    sp = _projected(w, h, 4000, 11, dense)
    for packed_out in (False, True):
        _same(mirror_resolve5(sp, w * h, packed_out=packed_out, p=p, chunk=chunk, elems=elems),
              r5.raster_images_v5_plain(sp, w * h, BAND, packed_out))


def test_tile_constants_match_the_source():
    """The mirror's tile constants and its empty depth are
    csrc/raster_resolve.cu's, and rtnr_resolve5 stores with the minimum row."""
    from rtnr_tpu_torch import _build

    src = (_build.SRC_DIR / "raster_resolve.cu").read_text()
    define = lambda name: int(src.split(f"#define {name} ")[1].split()[0], 0)
    assert define("TILE_P") == P and define("TILE_ELEMS") == ELEMS
    assert define("TILES_PER_BLOCK") == rr.TILES_PER_BLOCK
    assert CHUNK == ELEMS * define("TILE_THREADS")
    assert define("MIN_EMPTY") == INT_MAX and define("FLT_MAX_BITS") == FLT_MAX_BITS
    kernel = src.split("resolve5_tile(")[1].split("\n}\n")[0]
    assert "tile_init(tile, MIN_EMPTY)" in kernel and "tile_store<PACKED, true>" in kernel


def test_v5_wrapper_takes_the_twin_only_on_cpu():
    sp, hw = _STREAMS["hw_not_multiple_of_p"]
    before = (r5.raster_images_v5.launches, r5.winners5.launches, rr.expand_winners.launches)
    for packed_out in (False, True):
        _same(r5.raster_images_v5(sp, hw, BAND, packed_out=packed_out),
              r5.raster_images_v5_plain(sp, hw, BAND, packed_out))
    assert (r5.raster_images_v5.launches, r5.winners5.launches,
            rr.expand_winners.launches) == before
