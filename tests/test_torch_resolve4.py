"""The v4 resolve on the card as one kernel (``rtnr_resolve4``) and K2's tile
kernel (``rtnr_expand``), the parts the CPU reaches: the plain twin
``raster_images_v4_plain`` against the JAX package's ``raster_images_pallas4``
in interpret mode (``test_torch_raster.py``'s jitted reference, one shape),
and a numpy mirror of the kernels' tile and window arithmetic
(``csrc/raster_resolve.cu``: the warp's 33-ary lower-bound search, the
aligned-down window start, chunks of per-thread element groups, head marking
with the previous element, the in-band runs added into the tile across
chunks, the tile's defaults and its store) held bit for bit against the
twins on the streams where such a kernel goes wrong."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops import raster as jr
from rtnr_tpu_torch.ops import raster as tr
from rtnr_tpu_torch.ops import raster_resolve4 as rr
from rtnr_tpu_torch.ops.raster import SortedDiff, SortedPoints
from tests.test_torch_raster import _H, _N, _PALLAS4, _W, _assert_images_equal, _cloud, _pallas4

BAND = 0.02
FLT_MAX_BITS = 0x7F7FFFFF
INT_MAX = 0x7FFFFFFF
P, ELEMS, CHUNK = rr.TILE_P, rr.TILE_ELEMS, rr.TILE_CHUNK


# ---- the mirror ----

def warp_lower_bound(a: np.ndarray, n: int, v: int) -> int:
    """``warp_lower_bound``: 32 probes a step over [lo, hi), then one last
    ballot over at most 32 elements."""
    lo, hi = 0, n
    while hi - lo > 32:
        pos = [lo + ((hi - lo) * (lane + 1)) // 33 for lane in range(32)]
        ge = [int(a[q]) >= v for q in pos]
        if not any(ge):
            lo = pos[31] + 1
        else:
            f = ge.index(True)
            hi = pos[f]
            if f > 0:
                lo = pos[f - 1] + 1
    for lane in range(32):
        if lo + lane < hi and int(a[lo + lane]) >= v:
            return lo + lane
    return hi


def _new_tile(p):
    tile = np.zeros((5, p), np.int64)
    tile[4] = FLT_MAX_BITS
    return tile


def _tile_store(tile, q0, q1, outs, packed_out):
    """``tile_store``: the tile's pixels [q0, q1) into the output images."""
    r, g, b, c, d = (tile[i, : q1 - q0] for i in range(5))
    outs["depth"][q0:q1] = d
    if packed_out:
        cp = np.maximum(c, 1)
        outs["out0"][q0:q1] = np.where(c > 0, (r // cp) | ((g // cp) << 8) | ((b // cp) << 16), 0)
    else:
        outs["out0"][q0:q1] = np.stack([r, g, b], 1)
        outs["count"][q0:q1] = c


def _outputs(hw, packed_out):
    return {"out0": np.zeros((hw,) if packed_out else (hw, 3), np.int64),
            "count": np.zeros(hw, np.int64), "depth": np.zeros(hw, np.int64)}


def _images(outs, packed_out, float_sums=False):
    depth = torch.from_numpy(outs["depth"].astype(np.int32)).view(torch.float32)
    out0 = torch.from_numpy(outs["out0"].astype(np.int32))
    if packed_out:
        return out0, depth
    count = torch.from_numpy(outs["count"].astype(np.int32))
    if float_sums:
        return out0.view(torch.float32), count.view(torch.float32), depth
    return out0, count, depth


def mirror_resolve4(sp: SortedPoints, hw, band=BAND, packed_out=False, p=P, chunk=CHUNK,
                    elems=ELEMS):
    """``resolve4_window`` over every tile, ``chunk // elems`` threads a
    block. A block resolves TILES_PER_BLOCK tiles in turn, each from its
    own window and defaults, so the tiles' order does not enter."""
    pix, zb, pk = (t.numpy().astype(np.int64) for t in sp)
    n = pix.size
    f32band = np.float32(band)
    outs = _outputs(hw, packed_out)
    threads = chunk // elems
    for q0 in range(0, hw, p):
        q1 = min(q0 + p, hw)
        s, e = warp_lower_bound(pix, n, q0), warp_lower_bound(pix, n, q1)
        tile = _new_tile(p)
        c = s & ~3
        while c < e:
            idx = c + np.arange(chunk)  # thread t holds elements c + elems * t ...
            inside = idx < n
            at = np.minimum(idx, max(n - 1, 0))
            gp = np.where(inside, pix[at] if n else 0, INT_MAX).reshape(threads, elems)
            gz = np.where(inside, zb[at] if n else 0, 0).reshape(threads, elems)
            gk = np.where(inside, pk[at] if n else 0, 0).reshape(threads, elems)
            # the previous element: the shuffle from the lane before, or a load at lane 0
            prev = np.empty(threads, np.int64)
            prev[1:] = gp[:-1, elems - 1]
            lane0 = np.arange(threads) % 32 == 0
            base = c + elems * np.arange(threads)
            first = np.where((base > 0) & (base <= n), pix[np.clip(base - 1, 0, max(n - 1, 0))]
                             if n else -1, -1)
            prev[lane0] = first[lane0]
            # pass A: heads write their depth bits
            pp = prev.copy()
            for j in range(elems):
                head = (gp[:, j] >= q0) & (gp[:, j] < q1) & (gp[:, j] != pp)
                tile[4, gp[head, j] - q0] = gz[head, j]
                pp = gp[:, j]
            # pass B: in-band runs, merged per pixel within a thread, added into the tile
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
                head_z = tile[4, np.clip(cur - q0, 0, p - 1)].astype(np.int32).view(np.float32)
                lim = np.where(new, head_z + f32band, lim).astype(np.float32)
                acc[:, new] = 0
                z = gz[:, j].astype(np.int32).view(np.float32)
                inb = v & ~(z > lim)
                k = gk[:, j]
                acc += np.stack([k & 255, (k >> 8) & 255, (k >> 16) & 255,
                                 np.ones_like(k)]) * inb
            flush(acc[3] > 0)
            c += chunk
        _tile_store(tile, q0, q1, outs, packed_out)
    return _images(outs, packed_out)


def mirror_expand(wimg: torch.Tensor, total: torch.Tensor, hw, packed_out=False,
                  float_sums=False, p=P):
    """``expand_tile``: the window of the winner pixel row, its rows
    scattered into the tile, the tile stored."""
    w = wimg.numpy().astype(np.int64)
    t = int(total[0])
    wpix = w[5]
    outs = _outputs(hw, packed_out)
    for q0 in range(0, hw, p):
        q1 = min(q0 + p, hw)
        s, e = warp_lower_bound(wpix, t, q0), warp_lower_bound(wpix, t, q1)
        tile = _new_tile(p)
        tile[:, wpix[s:e] - q0] = w[:5, s:e]
        _tile_store(tile, q0, q1, outs, packed_out)
    return _images(outs, packed_out, float_sums)


# ---- streams ----

def _stream(pix, z, cols, hw):
    """A carrier-free stream sorted by (pixel, depth bits): pixels >= hw are
    culled (sentinel hw, +inf depth)."""
    pix = np.asarray(pix, np.int64)
    z = np.asarray(z, np.float32)
    ok = pix < hw
    pix = np.where(ok, pix, hw).astype(np.int32)
    zb = np.where(ok, z, np.float32(np.inf)).astype(np.float32).view(np.int32)
    cols = np.asarray(cols, np.int64)
    packed = (cols[:, 0] | (cols[:, 1] << 8) | (cols[:, 2] << 16)).astype(np.int32)
    order = np.lexsort((zb, pix))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[order]))
    return SortedPoints(pix=t(pix), zbits=t(zb), packed=t(packed))


def _rand_stream(n, hw, seed, pixels=None, zlo=2.0, zhi=2.1):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, hw, n) if pixels is None else rng.choice(pixels, n)
    return _stream(pix, rng.uniform(zlo, zhi, n), rng.integers(0, 256, (n, 3)), hw)


def _streams():
    hw_odd = 3 * P + 517  # not a multiple of P
    rng = np.random.default_rng(40)
    one = 5000
    return {
        # tile 1 of 3 holds no point; tiles 0 and 2 do
        "empty_tile": (_rand_stream(3000, 3 * P, 1, pixels=np.r_[np.arange(0, P, 3),
                                                                  np.arange(2 * P, 3 * P, 5)]),
                       3 * P),
        # one pixel, 5,000 points inside one band: the segment crosses chunks
        "one_pixel_5000": (_stream(np.full(one, P + 7), np.sort(rng.uniform(2.0, 2.019, one)),
                                   rng.integers(0, 256, (one, 3)), 2 * P), 2 * P),
        # one pixel, 5,000 points, a partial band, next to short segments
        "one_pixel_partial": (_stream(np.r_[np.full(one, 100), rng.integers(0, 2 * P, 900)],
                                      rng.uniform(2.0, 2.3, one + 900),
                                      rng.integers(0, 256, (one + 900, 3)), 2 * P), 2 * P),
        "all_culled": (_rand_stream(700, 2 * P, 2, pixels=np.array([2 * P, 5 * P])), 2 * P),
        "hw_not_multiple_of_p": (_rand_stream(9000, hw_odd, 3, zhi=2.05), hw_odd),
        # the last covered pixel is hw - 1, with culled points after it
        "last_pixel_covered": (_stream(np.r_[rng.integers(0, hw_odd, 2000), np.full(40, hw_odd - 1),
                                             np.full(30, hw_odd + 3)],
                                       rng.uniform(2.0, 2.04, 2070),
                                       rng.integers(0, 256, (2070, 3)), hw_odd), hw_odd),
        "empty_stream": (_stream(np.zeros(0), np.zeros(0), np.zeros((0, 3)), P + 5), P + 5),
    }


_STREAMS = _streams()


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        w = w.view(torch.int32) if w.dtype == torch.float32 else w
        assert g.shape == w.shape and torch.equal(g, w)


# ---- the twin against JAX ----

@pytest.mark.parametrize("packed_out", [False, True])
def test_twin_bitexact_vs_pallas4_interpret(packed_out):
    pts, cols, M = _cloud(_N, _W, _H, seed=3, dense=True)
    sp_j = jr.project_and_sort(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(M),
                               width=_W, height=_H, carriers=False)
    sp_t = tr.project_and_sort(torch.from_numpy(pts), torch.from_numpy(cols),
                               torch.from_numpy(M), width=_W, height=_H)
    want = _pallas4(sp_j, _W * _H, BAND, packed_out=packed_out, **_PALLAS4)
    _assert_images_equal(rr.raster_images_v4_plain(sp_t, _W * _H, BAND, packed_out), want)


# ---- the mirror against the twins ----

@pytest.mark.parametrize("a", [
    np.zeros(0, np.int64), np.array([5]), np.arange(31), np.arange(32), np.arange(33),
    np.repeat(np.arange(40), 3), np.sort(np.random.default_rng(0).integers(0, 100, 5000)),
    np.r_[np.zeros(20000, np.int64), np.full(3, 9)],
])
def test_warp_lower_bound_is_searchsorted(a):
    for v in sorted({-1, 0, 1, 5, 9, 10, 31, 33, 40, 99, 100, 101} | set(a[::97].tolist())):
        assert warp_lower_bound(a, a.size, v) == int(np.searchsorted(a, v, side="left"))


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("packed_out", [False, True])
def test_mirror_resolve4_equals_the_twin(name, packed_out):
    sp, hw = _STREAMS[name]
    _same(mirror_resolve4(sp, hw, packed_out=packed_out),
          rr.raster_images_v4_plain(sp, hw, BAND, packed_out))


def test_the_long_segment_is_in_band_and_crosses_chunks():
    sp, hw = _STREAMS["one_pixel_5000"]
    s = warp_lower_bound(sp.pix.numpy(), sp.pix.numel(), P)
    e = warp_lower_bound(sp.pix.numpy(), sp.pix.numel(), 2 * P)
    assert (e - s) > 4 * CHUNK
    _, count, _ = mirror_resolve4(sp, hw)
    assert int(count[P + 7]) == 5000 and int(count.sum()) == 5000


@pytest.mark.parametrize("p,chunk,elems", [(64, 32, 4), (128, 64, 4), (256, 1024, 4),
                                           (96, 64, 8), (2048, 1024, 4)])
@pytest.mark.parametrize("dense", [False, True])
def test_mirror_resolve4_small_tiles_on_projected_streams(p, chunk, elems, dense):
    """Many tiles and chunks a tile, windows that start at any element; also
    8 elements a thread and the tile sizes of the sweeps."""
    w, h = 40, 26  # hw = 1040, a multiple of none of the tile sizes
    pts, cols, M = _cloud(4000, w, h, seed=11, dense=dense)
    sp = tr.project_and_sort(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(M),
                             width=w, height=h)
    for packed_out in (False, True):
        _same(mirror_resolve4(sp, w * h, packed_out=packed_out, p=p, chunk=chunk, elems=elems),
              rr.raster_images_v4_plain(sp, w * h, BAND, packed_out))


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("form", ["packed", "sums", "float_sums"])
def test_mirror_expand_equals_the_twin(name, form):
    sp, hw = _STREAMS[name]
    packed_out = form == "packed"
    if form == "float_sums":
        n = sp.pix.numel()
        rgb = torch.stack([(sp.packed >> s) & 255 for s in (0, 8, 16)], 1).float()
        rgb = rgb + torch.from_numpy(np.random.default_rng(n).uniform(0, 1, (n, 3))
                                     .astype(np.float32))
        wimg, total = rr.winners_f32_plain(SortedDiff(sp.pix, sp.zbits, rgb.contiguous()), hw,
                                           BAND)
    else:
        wimg, total = rr.winners_plain(sp, hw, BAND)
    _same(mirror_expand(wimg, total, hw, packed_out, form == "float_sums"),
          rr.expand_plain(wimg, total, hw, packed_out, form == "float_sums"))


@pytest.mark.parametrize("p", [64, 96])
def test_mirror_expand_small_tiles(p):
    w, h = 40, 26
    pts, cols, M = _cloud(3000, w, h, seed=12, dense=True)
    sp = tr.project_and_sort(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(M),
                             width=w, height=h)
    wimg, total = rr.winners_plain(sp, w * h, BAND)
    for packed_out in (False, True):
        _same(mirror_expand(wimg, total, w * h, packed_out, p=p),
              rr.expand_plain(wimg, total, w * h, packed_out))


def test_tile_constants_match_the_source():
    """The module's tile constants mirror csrc/raster_resolve.cu's defines."""
    from rtnr_tpu_torch import _build

    src = (_build.SRC_DIR / "raster_resolve.cu").read_text()
    define = lambda name: int(src.split(f"#define {name} ")[1].split()[0])
    assert define("TILE_P") == P and define("TILE_ELEMS") == ELEMS
    assert define("TILES_PER_BLOCK") == rr.TILES_PER_BLOCK
    assert "#define TILE_CHUNK (TILE_THREADS * TILE_ELEMS)" in src
    threads = define("TILE_THREADS")
    assert CHUNK == ELEMS * threads and P % 4 == 0 and ELEMS % 4 == 0
    assert threads % 32 == 0 and rr.TILES_PER_BLOCK + 1 <= threads // 32


def test_v4_wrapper_takes_the_twin_only_on_cpu():
    sp, hw = _STREAMS["hw_not_multiple_of_p"]
    before = (rr.raster_images_v4.launches, rr.winners.launches, rr.expand_winners.launches)
    for packed_out in (False, True):
        _same(rr.raster_images_v4(sp, hw, BAND, packed_out=packed_out),
              rr.raster_images_v4_plain(sp, hw, BAND, packed_out))
    assert (rr.raster_images_v4.launches, rr.winners.launches,
            rr.expand_winners.launches) == before
